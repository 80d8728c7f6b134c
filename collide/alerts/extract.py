"""Device-side alert extraction: threshold, priority bucketing, fixed top-k.

Replaces the Python heapq alert plumbing of the reference
(warning_system.py:48-549) on the hot path: risks below RISK_LEVEL_LOW are
dropped (warning_system.py:273-274), priorities follow the CRITICAL/HIGH/
MEDIUM/LOW rules (warning_system.py:287-311), and instead of an unbounded
priority queue we keep a static scene-level top-A, sorted by
(priority, risk) descending — all on device, no host sync.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from collide.core.config import SystemConfig
from collide.core.state import ObjectState
from collide.detect.pipeline import PairRisks

PRIORITY_LOW, PRIORITY_MEDIUM, PRIORITY_HIGH, PRIORITY_CRITICAL = 0, 1, 2, 3


@partial(jax.tree_util.register_dataclass,
         data_fields=["vehicle_oid", "other_oid", "risk", "ttc", "distance",
                      "rel_speed", "priority", "col_pos", "valid", "count"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class AlertBatch:
    """Scene-level alert buffer, fixed shape [A]. Sorted by
    (priority, risk) descending; `count` alerts are valid."""
    vehicle_oid: jax.Array   # [A] int32
    other_oid: jax.Array     # [A] int32
    risk: jax.Array          # [A] f32
    ttc: jax.Array           # [A] f32
    distance: jax.Array      # [A] f32
    rel_speed: jax.Array     # [A] f32
    priority: jax.Array      # [A] int32 0..3
    col_pos: jax.Array       # [A, 3] f32
    valid: jax.Array         # [A] bool
    count: jax.Array         # [] int32


def compute_priority(risk: jax.Array, ttc: jax.Array,
                     cfg: SystemConfig) -> jax.Array:
    """Priority rules, reference warning_system.py:287-311."""
    a = cfg.alerts
    crit = (risk >= a.risk_high) & (ttc < a.ttc_critical)
    high = (risk >= a.risk_high) | (ttc < a.ttc_high)
    med = risk >= a.risk_medium
    return jnp.where(crit, PRIORITY_CRITICAL,
                     jnp.where(high, PRIORITY_HIGH,
                               jnp.where(med, PRIORITY_MEDIUM, PRIORITY_LOW))
                     ).astype(jnp.int32)


def extract_alerts(state: ObjectState, pairs: PairRisks,
                   cfg: SystemConfig,
                   query_mask: jax.Array | None = None) -> AlertBatch:
    """query_mask (optional [N] bool): restrict alert emission to these rows
    — used by the sharded step to emit only for shard-owned objects (halo
    rows compute risks but their owner shard emits them)."""
    a = cfg.alerts
    n, k = pairs.risk.shape

    keep = pairs.valid & (pairs.risk >= a.risk_low)   # warning_system.py:273
    # Deduplicate unordered pairs: each (i, j) risk is detected from both
    # ends with identical values (the math is symmetric); keep only
    # oid_i < oid_j so the scene buffer isn't half duplicates. Under
    # sharding this also picks exactly one emitting shard for cross-boundary
    # pairs (each shard owns one endpoint).
    keep &= state.oid[:, None] < state.oid[pairs.other]
    if query_mask is not None:
        keep &= query_mask[:, None]

    prio = compute_priority(pairs.risk, pairs.ttc, cfg)
    # rank key: priority major, risk minor — matches the reference heap
    # ordering (priority, recency); within a step recency is meaningless, so
    # risk breaks ties.
    key = jnp.where(keep, prio.astype(jnp.float32) * 2.0 + pairs.risk, -1.0)

    flat_key = key.reshape(-1)
    top_key, top_idx = jax.lax.top_k(flat_key, a.max_scene_alerts)
    valid = top_key >= 0.0

    row = top_idx // k
    flat = lambda x: x.reshape(n * k, *x.shape[2:])[top_idx]
    other = flat(pairs.other)
    return AlertBatch(
        vehicle_oid=jnp.where(valid, state.oid[row], -1),
        other_oid=jnp.where(valid, state.oid[other], -1),
        risk=jnp.where(valid, flat(pairs.risk), 0.0),
        ttc=jnp.where(valid, flat(pairs.ttc), jnp.inf),
        distance=jnp.where(valid, flat(pairs.distance), jnp.inf),
        rel_speed=jnp.where(valid, flat(pairs.rel_speed), 0.0),
        priority=jnp.where(valid, flat(prio), 0),
        col_pos=flat(pairs.col_pos),
        valid=valid,
        count=jnp.sum(valid, dtype=jnp.int32),
    )
