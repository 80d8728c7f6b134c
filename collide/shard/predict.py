"""Trajectory prediction on the device mesh.

The reference ran `predict_collisions` for every vehicle on every node as
THE production loop (warning_system.py:695-714, collision_detection.py:
789-846); its per-node spatial indexes only saw local vehicles, so
cross-boundary predictions were silently impossible. Here each shard runs
the canonical prediction over its owned objects plus a halo band WIDENED
by the fleet's maximum predicted displacement: a query object's
class-predicted position can wander up to max_speed * o_max +
0.5 * accel_range * o_max^2 from its current slab, and the reference's
stage-1 filter compares that predicted position against candidates'
CURRENT positions — so a band of (halo_width + displacement bound) makes
per-shard prediction EXACTLY equal to the single-device
`predict_collisions` for owned objects (tests/test_sharded_predict.py).

Histories ride with ownership: only QUERY objects need trajectory classes
(candidates advance const-accel regardless, reference :808-812), so halo
mirrors get empty histories and nothing is exchanged beyond the state
band.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from collide.core.config import SystemConfig
from collide.core.state import ObjectState
from collide.detect.predict import (TrajectoryHistory,
                                    predict_collisions)
from collide.index.grid import build_grid
from collide.shard.halo import halo_exchange_hops, extend_with_halo
from collide.shard.step import (_shard_coords, _state_spec_axes,
                                equal_boundaries, shard_slots)


def predict_reach(cfg: SystemConfig, horizon: float, step: float) -> float:
    """Halo band width covering prediction: detection halo + the config
    bound on class-predicted displacement at the last offset."""
    o_max = max(0.0, horizon - step)
    disp = cfg.sim.max_speed * o_max + 0.5 * cfg.sim.accel_range * o_max ** 2
    return cfg.shard.halo_width + disp


def predict_hops(cfg: SystemConfig, reach: float, dim: int) -> int:
    """ppermute hops per side needed for a `reach`-wide visibility band on
    world axis `dim`, from the equal-slab width (clamped to d-1: beyond
    that the chain already spans the whole axis). Callers moving walls
    dynamically must keep every slab >= reach / hops wide."""
    d = (cfg.shard.num_shards, cfg.shard.num_shards_y,
         cfg.shard.num_shards_z)[dim]
    if d <= 1:
        return 1
    import math
    slab = (cfg.world.hi[dim] - cfg.world.lo[dim]) / d
    return min(d - 1, max(1, math.ceil(reach / slab)))


def _local_predict(state: ObjectState, hist: TrajectoryHistory,
                   bx: jax.Array, by: jax.Array, bz: jax.Array,
                   cfg: SystemConfig,
                   horizon: float, step: float, sub_window: float,
                   merge_k: int, width: float, capacity: int,
                   hops_x: int = 1, hops_y: int = 1, hops_z: int = 1):
    sx, sy, sz = _shard_coords(cfg)
    bufx, valx, dropx = halo_exchange_hops(state, cfg, sx, bx, dim=0,
                                           width=width, capacity=capacity,
                                           hops=hops_x)
    ext = extend_with_halo(state, bufx, valx)
    dropped = dropx
    if cfg.shard.num_shards_y > 1:
        bufy, valy, dropy = halo_exchange_hops(ext, cfg, sy, by, dim=1,
                                               width=width,
                                               capacity=capacity,
                                               hops=hops_y)
        ext = extend_with_halo(ext, bufy, valy)
        dropped = dropped + dropy
    if cfg.shard.num_shards_z > 1:
        bufz, valz, dropz = halo_exchange_hops(ext, cfg, sz, bz, dim=2,
                                               width=width,
                                               capacity=capacity,
                                               hops=hops_z)
        ext = extend_with_halo(ext, bufz, valz)
        dropped = dropped + dropz

    # halo mirrors need no history: they are candidates only (class drives
    # the QUERY advance; candidates move const-accel, reference :808-812)
    n_halo = ext.n - state.n
    hext = TrajectoryHistory(
        pos=jnp.concatenate([hist.pos, jnp.zeros(
            (n_halo,) + hist.pos.shape[1:], hist.pos.dtype)]),
        t=jnp.concatenate([hist.t, jnp.full(
            (n_halo, hist.t.shape[1]), -jnp.inf, hist.t.dtype)]),
        count=jnp.concatenate([hist.count,
                               jnp.zeros((n_halo,), hist.count.dtype)]),
        head=jnp.concatenate([hist.head,
                              jnp.zeros((n_halo,), hist.head.dtype)]))

    index = build_grid(ext.pos, ext.alive, cfg)
    other_i, valid, risk, ttc, dist = predict_collisions(
        ext, hext, index, cfg, horizon=horizon, step=step,
        sub_window=sub_window, merge_k=merge_k)

    # own rows only; candidate indices (into ext) -> global oids
    n_own = state.n
    own = (jnp.arange(ext.n) < n_own)[:, None]
    valid = valid & own
    other_oid = jnp.where(valid, ext.oid[jnp.clip(other_i, 0, ext.n - 1)],
                          -1)
    take = lambda a: a[:n_own]
    # grid bucket truncation (objects beyond cell_capacity dropped from
    # their bucket's gather) — counted, never silent
    from collide.engine import grid_overflow
    goflow = grid_overflow(index, cfg).astype(jnp.int32)
    return (take(other_oid), take(valid), take(risk), take(ttc),
            take(dist), dropped.reshape(1), goflow.reshape(1))


def make_sharded_predict(cfg: SystemConfig, mesh: Mesh,
                         horizon: float = 10.0, step: float = 0.5,
                         sub_window: float = 1.0, merge_k: int = 32,
                         halo_capacity: int | None = None,
                         hops: int | None = None):
    """Compile per-shard trajectory prediction over the mesh: the canonical
    gather path per shard. Returns predict(state_sharded, hist_sharded,
    boundaries=None, boundaries_y=None) -> (other_oid [D*slots, merge_k]
    i32, valid, risk, ttc, dist, dropped [D], grid_overflow [D]) — the
    merged per-object predicted risks of every OWNED object, equal to
    single-device
    `predict_collisions` for fleets whose per-band population fits
    `halo_capacity` (halo overflow is counted in `dropped`, grid bucket
    truncation beyond cell_capacity in `grid_overflow` — never silent).

    Bands wider than one slab ride a MULTI-HOP ppermute chain
    (halo_exchange_hops, ROADMAP #6): hops = ceil(reach / slab width) per
    axis, computed from the equal-slab width. Callers moving walls
    dynamically must keep every slab at least `predict_reach / hops`
    wide (pass `hops` explicitly to budget for narrower dynamic slabs)."""
    reach = predict_reach(cfg, horizon, step)
    if hops is None:
        hops_x = predict_hops(cfg, reach, 0)
        hops_y = predict_hops(cfg, reach, 1)
        hops_z = predict_hops(cfg, reach, 2)
    else:
        hops_x = hops_y = hops_z = hops
    if halo_capacity is None:
        scale = -(-int(reach) // max(1, int(cfg.shard.halo_width)))
        # per-hop buffers each carry at most one slab's worth of the band
        halo_capacity = cfg.shard.halo_capacity * max(
            1, -(-scale // max(1, max(hops_x, hops_y, hops_z))))

    sdim = _state_spec_axes(cfg)
    spec_state = ObjectState(
        pos=P(sdim), vel=P(sdim), acc=P(sdim), heading=P(sdim), size=P(sdim),
        otype=P(sdim), alive=P(sdim), oid=P(sdim))
    spec_hist = TrajectoryHistory(pos=P(sdim), t=P(sdim), count=P(sdim),
                                  head=P(sdim))
    body = partial(_local_predict, cfg=cfg, horizon=horizon, step=step,
                   sub_window=sub_window, merge_k=merge_k,
                   width=reach, capacity=halo_capacity,
                   hops_x=hops_x, hops_y=hops_y, hops_z=hops_z)
    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(spec_state, spec_hist, P(), P(), P()),
        out_specs=tuple([P(sdim)] * 7),
    )
    jf = jax.jit(f)
    default_bx = equal_boundaries(cfg, 0)
    default_by = equal_boundaries(cfg, 1)
    default_bz = equal_boundaries(cfg, 2)

    def predict(state, hist, boundaries=None, boundaries_y=None,
                boundaries_z=None):
        return jf(state, hist,
                  default_bx if boundaries is None else boundaries,
                  default_by if boundaries_y is None else boundaries_y,
                  default_bz if boundaries_z is None else boundaries_z)

    return predict


def distribute_history(hist_global: TrajectoryHistory, cfg: SystemConfig,
                       mesh: Mesh, state_global: ObjectState,
                       boundaries=None, boundaries_y=None,
                       boundaries_z=None) -> TrajectoryHistory:
    """Host-side: scatter a global fleet's trajectory history into the same
    per-shard slots `distribute_state` assigns its objects (bootstrap /
    checkpoint-restore path)."""
    import numpy as np
    from collide.shard.step import _shard_of
    from jax.sharding import NamedSharding

    d = cfg.shard.total_shards
    slots = shard_slots(cfg)
    pos = np.asarray(state_global.pos)
    alive = np.asarray(state_global.alive)
    shard_of = _shard_of(pos, cfg, boundaries, boundaries_y, boundaries_z)
    h = hist_global.capacity
    out = {
        "pos": np.zeros((d * slots, h, 3), np.float32),
        "t": np.full((d * slots, h), -np.inf, np.float32),
        "count": np.zeros((d * slots,), np.int32),
        "head": np.zeros((d * slots,), np.int32),
    }
    for sh in range(d):
        idx = np.flatnonzero((shard_of == sh) & alive)
        dst = sh * slots + np.arange(len(idx))
        for f in out:
            out[f][dst] = np.asarray(getattr(hist_global, f))[idx]
    sharding = NamedSharding(mesh, P(_state_spec_axes(cfg)))
    put = lambda v: jax.device_put(jnp.asarray(v), sharding)
    return TrajectoryHistory(**{f: put(v) for f, v in out.items()})
