"""The engine: one jitted step = the whole reference hot path.

What the reference spreads over broker dispatch + compute-node sweeps +
detector + warning system (SURVEY.md §3.3/§3.5: EarlyWarningSystem 2 Hz loop
-> per-vehicle 4-stage detection -> AlertManager heapq) collapses here into a
single XLA program:

    integrate -> build grid (sort) -> broad phase (stencil gather)
              -> narrow phase (4-stage) -> alert top-k

No host round-trips inside the step; state stays in device memory between
steps.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from collide.core.config import SystemConfig
from collide.core.state import ObjectState
from collide.index.grid import build_grid
from collide.detect.pipeline import detect_pairs, detect_rows, PairRisks
from collide.alerts.extract import extract_alerts, AlertBatch
from collide.sim.integrator import integrate


@partial(jax.tree_util.register_dataclass,
         data_fields=["alerts", "num_pairs_checked", "num_risks",
                      "max_risk", "num_alive", "overflow",
                      "alert_overflow"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class StepOutput:
    alerts: AlertBatch
    num_pairs_checked: jax.Array   # [] int32 — candidate pairs that passed
                                   # stage 1 (alive, non-self, within search
                                   # radius); same definition on the flat
                                   # and chunked paths
    num_risks: jax.Array           # [] int32 — stage-4 risks produced
    max_risk: jax.Array            # [] f32
    num_alive: jax.Array           # [] int32
    overflow: jax.Array            # [] int32 — broad-phase capacity overflow
                                   # (cell/window slots beyond static caps;
                                   # 0 means every candidate was examined)
    alert_overflow: jax.Array      # [] int32 — precise-mode stage-2
                                   # survivors beyond the static survivor
                                   # cap; 0 means the alert list is
                                   # provably complete


def detect_only(state: ObjectState, cfg: SystemConfig) -> PairRisks:
    """Index build + 4-stage detection, no physics. The `detect_collisions`
    analog (collision_detection.py:110-193) for an externally-updated fleet."""
    index = build_grid(state.pos, state.alive, cfg)
    return detect_pairs(state, index, cfg)


def grid_overflow(index, cfg: SystemConfig) -> jax.Array:
    """Objects beyond cell_capacity in their bucket (dropped from THAT
    cell's candidate lists) — the XLA broad phase's capacity counter."""
    sizes = index.starts[1:cfg.num_cells + 1] - index.starts[:cfg.num_cells]
    return jnp.sum(jnp.maximum(sizes - cfg.grid.cell_capacity, 0))


def detect_and_alerts(state: ObjectState, cfg: SystemConfig) -> StepOutput:
    """The non-physics tail of a step: full index rebuild + detection +
    alert extraction + stats. Shared by `step` and the scenario steps
    (sim/scenario.py), which differ only in their integrator."""
    index = build_grid(state.pos, state.alive, cfg)
    pairs = detect_pairs(state, index, cfg)
    alerts = extract_alerts(state, pairs, cfg)
    return StepOutput(
        alerts=alerts,
        num_pairs_checked=pairs.num_checked,
        num_risks=jnp.sum(pairs.valid, dtype=jnp.int32),
        max_risk=jnp.max(pairs.risk),
        num_alive=jnp.sum(state.alive, dtype=jnp.int32),
        overflow=grid_overflow(index, cfg).astype(jnp.int32),
        alert_overflow=pairs.survivor_overflow,
    )


def step(state: ObjectState, key: jax.Array,
         cfg: SystemConfig) -> tuple[ObjectState, StepOutput]:
    """One full scene step (the benchmark 'request' unit,
    optimized_performance_test.py:850-981): physics + full index rebuild +
    detection + prediction + alert extraction."""
    state = integrate(state, key, cfg)
    return state, detect_and_alerts(state, cfg)


def _chunked_detect_extract(state: ObjectState, cfg: SystemConfig,
                            chunk: int):
    """Detection + alert extraction mapped over row blocks of size `chunk`.

    For large fleets the flat path materializes [N, K] pair arrays in
    device memory (1M x 432 candidates x f32 ~ 1.7 GB per array); mapping
    blocks keeps the working set at [chunk, K] while the grid build stays
    global. Per-block top-k feeds a global top-k, so results match the
    flat path whenever no single block exceeds max_scene_alerts qualifying
    alerts."""
    from collide.alerts.extract import compute_priority

    a = cfg.alerts
    n = state.n
    nblocks = -(-n // chunk)
    index = build_grid(state.pos, state.alive, cfg)

    def block(b):
        rows = b * chunk + jnp.arange(chunk, dtype=jnp.int32)
        in_range = rows < n
        rows = jnp.minimum(rows, n - 1)
        pairs = detect_rows(state, index, cfg, rows, row_valid=in_range)
        keep = (pairs.valid & (pairs.risk >= a.risk_low)
                & (state.oid[rows][:, None] < state.oid[pairs.other])
                & in_range[:, None])
        prio = compute_priority(pairs.risk, pairs.ttc, cfg)
        key = jnp.where(keep, prio.astype(jnp.float32) * 2.0 + pairs.risk,
                        -1.0)
        k = key.shape[1]
        top_key, top_i = jax.lax.top_k(key.reshape(-1), a.max_scene_alerts)
        r, s = top_i // k, top_i
        flat = lambda x: x.reshape(chunk * k, *x.shape[2:])[s]
        other = flat(pairs.other)
        blk = dict(
            key=top_key,
            vehicle_oid=state.oid[rows][r],
            other_oid=state.oid[other],
            risk=flat(pairs.risk), ttc=flat(pairs.ttc),
            distance=flat(pairs.distance), rel_speed=flat(pairs.rel_speed),
            priority=flat(prio), col_pos=flat(pairs.col_pos))
        n_risks = jnp.sum(pairs.valid & in_range[:, None], dtype=jnp.int32)
        max_risk = jnp.max(jnp.where(in_range[:, None], pairs.risk, 0.0))
        return (blk, n_risks, max_risk, pairs.survivor_overflow,
                pairs.num_checked)

    blks, n_risks, max_risk, surv_oflow, n_checked = jax.lax.map(
        block, jnp.arange(nblocks, dtype=jnp.int32))

    flat = {f: v.reshape(nblocks * a.max_scene_alerts, *v.shape[2:])
            for f, v in blks.items()}
    top_key, top_i = jax.lax.top_k(flat["key"], a.max_scene_alerts)
    valid = top_key >= 0.0
    g = lambda f: flat[f][top_i]
    alerts = AlertBatch(
        vehicle_oid=jnp.where(valid, g("vehicle_oid"), -1),
        other_oid=jnp.where(valid, g("other_oid"), -1),
        risk=jnp.where(valid, g("risk"), 0.0),
        ttc=jnp.where(valid, g("ttc"), jnp.inf),
        distance=jnp.where(valid, g("distance"), jnp.inf),
        rel_speed=jnp.where(valid, g("rel_speed"), 0.0),
        priority=jnp.where(valid, g("priority"), 0),
        col_pos=g("col_pos"),
        valid=valid,
        count=jnp.sum(valid, dtype=jnp.int32),
    )
    return (alerts, jnp.sum(n_risks), jnp.max(max_risk),
            grid_overflow(index, cfg).astype(jnp.int32),
            jnp.sum(surv_oflow).astype(jnp.int32),
            jnp.sum(n_checked).astype(jnp.int32))


def step_chunked(state: ObjectState, key: jax.Array, cfg: SystemConfig,
                 chunk: int) -> tuple[ObjectState, StepOutput]:
    """Large-N step: identical semantics to `step`, blocked detection."""
    state = integrate(state, key, cfg)
    alerts, n_risks, max_risk, oflow, aoflow, n_checked = \
        _chunked_detect_extract(state, cfg, chunk)
    out = StepOutput(
        alerts=alerts,
        num_pairs_checked=n_checked,
        num_risks=n_risks, max_risk=max_risk,
        num_alive=jnp.sum(state.alive, dtype=jnp.int32),
        overflow=oflow,
        alert_overflow=aoflow,
    )
    return state, out


def chunk_for(cfg: SystemConfig, budget_bytes: float = 16e9,
              bytes_per_pair: int = 64) -> int | None:
    """Row-block size for `make_step(chunk_size=)`: None when the flat
    step's [N, K] working set fits `budget_bytes`, else the largest power of
    two whose [chunk, K] block does. bytes_per_pair is the compiled step's
    temporary memory per candidate pair (45-50 B measured on an H100 at
    100k-2D precise and 1M-3D fast, via compiled.memory_analysis()),
    rounded up."""
    per_row = cfg.max_candidates * bytes_per_pair
    if cfg.num_objects * per_row <= budget_bytes:
        return None
    chunk = 1
    while chunk * 2 * per_row <= budget_bytes:
        chunk *= 2
    return chunk


def _step_fn(cfg: SystemConfig, chunk_size: int | None):
    """The per-step body: flat, or blocked over `chunk_size` rows."""
    if chunk_size:
        return partial(step_chunked, cfg=cfg, chunk=chunk_size)
    return partial(step, cfg=cfg)


def make_step(cfg: SystemConfig, donate: bool = True,
              chunk_size: int | None = None):
    """Compile `step` with the config baked in (static). Donates the input
    state so device memory is reused in place. chunk_size selects the
    blocked large-N variant (same semantics, [chunk, K] working set)."""
    return jax.jit(_step_fn(cfg, chunk_size),
                   donate_argnums=(0,) if donate else ())


def make_burst_step(cfg: SystemConfig, n: int, donate: bool = True,
                    chunk_size: int | None = None):
    """Compile an n-step BURST: one dispatch advances physics + detection
    n times via lax.scan over the same per-step body make_step compiles,
    reproducing Scene.step's key schedule exactly (key, sub = split(key)
    before every step), so burst(n) computes the same trajectory as n
    single steps.

    Per-burst instead of per-step host sync means dispatch and sync
    overhead is amortized n x: the difference between the serving-latency
    view and the device-rate view. The production analog of bench.py's
    scan-chunk methodology, exposed as an API.

    Returns a jitted (state, key) -> (state, key', out, risks_per_step):
    `out` is the FINAL step's StepOutput with overflow / alert_overflow
    replaced by the burst-wide MAX (completeness certificates and Scene's
    self-healing judge the worst step, not just the last);
    `risks_per_step` is [n] i32. Intermediate alert LISTS are not
    materialized — callers that must feed every step's alerts to the
    AlertManager need make_step.
    """
    if n < 1:
        raise ValueError(f"burst length must be >= 1, got {n}")
    fn = _step_fn(cfg, chunk_size)

    def burst(state: ObjectState, key: jax.Array):
        def body(carry, _):
            st, k, of, ao = carry
            k, sub = jax.random.split(k)
            st, out = fn(st, sub)
            return (st, k, jnp.maximum(of, out.overflow),
                    jnp.maximum(ao, out.alert_overflow)), out.num_risks
        z = jnp.int32(0)
        (state, key, of, ao), risks = jax.lax.scan(
            body, (state, key, z, z), None, length=n - 1)
        # last step runs outside the scan so its full StepOutput (alert
        # list included) is materialized exactly once
        key, sub = jax.random.split(key)
        state, out = fn(state, sub)
        out = dataclasses.replace(
            out, overflow=jnp.maximum(of, out.overflow),
            alert_overflow=jnp.maximum(ao, out.alert_overflow))
        risks = jnp.concatenate([risks, out.num_risks[None]])
        return state, key, out, risks

    return jax.jit(burst, donate_argnums=(0,) if donate else ())


def make_detect(cfg: SystemConfig):
    return jax.jit(partial(detect_only, cfg=cfg))
