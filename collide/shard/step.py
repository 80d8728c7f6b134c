"""The sharded step: `shard_map` over a 1D spatial device mesh.

This is the device-mesh realization of the reference's entire distributed
platform (SURVEY.md §2.10/§2.11): geographic sharding (data_sharding.py),
the message broker (messaging.py), compute nodes (compute_node.py) and the
scheduler (scheduler.py) collapse into one SPMD program — each device owns a
world slab, exchanges halos/migrants with slab neighbors via ppermute,
detects locally, and contributes per-shard alert top-k. Global stats ride a
psum.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from collide.core.config import SystemConfig
from collide.core.state import ObjectState
from collide.index.grid import build_grid
from collide.detect.pipeline import detect_pairs
from collide.alerts.extract import extract_alerts, AlertBatch
from collide.sim.integrator import integrate
from collide.shard.halo import (migrate, halo_exchange, extend_with_halo,
                                slab_bounds)
from collide.engine import StepOutput


def shard_slots(cfg: SystemConfig) -> int:
    """Per-shard slot capacity: even split x headroom, padded to 8."""
    d = cfg.shard.total_shards
    base = -(-cfg.num_objects // d)
    slots = int(base * cfg.shard.slot_headroom)
    return -(-slots // 8) * 8


def make_mesh(cfg: SystemConfig, devices=None) -> Mesh:
    """1D x-slab mesh, or — when ShardConfig.num_shards_y > 1 — a 2D
    (x, y) device grid (the reference's octree-region tiling analog,
    spatial_index.py:716-769). Device (i, j) owns tile
    [x_walls[i], x_walls[i+1]) x [y_walls[j], y_walls[j+1])."""
    import numpy as np
    dx = cfg.shard.num_shards
    dy = cfg.shard.num_shards_y
    dz = cfg.shard.num_shards_z
    d = dx * dy * dz
    if devices is None:
        devices = jax.devices()[:d]
    assert len(devices) == d, f"need {d} devices, have {len(devices)}"
    assert cfg.shard.halo_width >= cfg.detect.search_radius, \
        "halo must cover the detection search radius"
    step_reach = cfg.sim.max_speed * cfg.sim.dt
    assert step_reach < (cfg.world.hi[0] - cfg.world.lo[0]) / dx, \
        "objects could cross more than one x-slab per step"
    if dy > 1:
        assert step_reach < (cfg.world.hi[1] - cfg.world.lo[1]) / dy, \
            "objects could cross more than one y-slab per step"
    if dz > 1:
        assert step_reach < (cfg.world.hi[2] - cfg.world.lo[2]) / dz, \
            "objects could cross more than one z-slab per step"
    names = [cfg.shard.axis_name]
    shape = [dx]
    if dy > 1 or dz > 1:
        names.append(cfg.shard.axis_name_y)
        shape.append(dy)
    if dz > 1:
        names.append(cfg.shard.axis_name_z)
        shape.append(dz)
    if len(names) == 1:
        return Mesh(np.asarray(devices), (names[0],))
    return Mesh(np.asarray(devices).reshape(*shape), tuple(names))


def _mesh_axes(cfg: SystemConfig):
    """Mesh axis names to psum over: (x,), (x, y), or (x, y, z)."""
    ax = [cfg.shard.axis_name]
    if cfg.shard.num_shards_y > 1 or cfg.shard.num_shards_z > 1:
        ax.append(cfg.shard.axis_name_y)
    if cfg.shard.num_shards_z > 1:
        ax.append(cfg.shard.axis_name_z)
    return tuple(ax)


def _halo_extend(state: ObjectState, cfg: SystemConfig,
                 sx: jax.Array, sy: jax.Array, sz: jax.Array,
                 bx: jax.Array, by: jax.Array, bz: jax.Array):
    """The (up to) three-phase halo: mirror x bands, then — on a 2D/3D
    grid — mirror y bands of the x-EXTENDED state, then z bands of the
    xy-extended state, so edge/corner neighborhoods arrive in <= 3 hops.
    Returns (ext_state, dropped)."""
    bufx, valx, dropx = halo_exchange(state, cfg, sx, bx, dim=0)
    ext = extend_with_halo(state, bufx, valx)
    dropped = dropx
    if cfg.shard.num_shards_y > 1:
        bufy, valy, dropy = halo_exchange(ext, cfg, sy, by, dim=1)
        ext = extend_with_halo(ext, bufy, valy)
        dropped = dropped + dropy
    if cfg.shard.num_shards_z > 1:
        bufz, valz, dropz = halo_exchange(ext, cfg, sz, bz, dim=2)
        ext = extend_with_halo(ext, bufz, valz)
        dropped = dropped + dropz
    return ext, dropped


def _detect_tail_xla(state: ObjectState, cfg: SystemConfig,
                     sx: jax.Array, sy: jax.Array, sz: jax.Array,
                     bx: jax.Array, by: jax.Array,
                     bz: jax.Array) -> StepOutput:
    """Halo exchange + XLA detection over owned + halo rows; alerts
    emitted only for owned rows; stats psum-reduced."""
    ax = _mesh_axes(cfg)
    ext, halo_dropped = _halo_extend(state, cfg, sx, sy, sz, bx, by, bz)
    index = build_grid(ext.pos, ext.alive, cfg)
    pairs = detect_pairs(ext, index, cfg)
    n_own = state.n
    own_mask = jnp.arange(ext.n) < n_own
    alerts = extract_alerts(ext, pairs, cfg, query_mask=own_mask)

    own_valid = pairs.valid & own_mask[:, None]
    # per-shard alert count becomes a [1] vector so shard_map can
    # concatenate it to a global [D] vector
    alerts = dataclasses.replace(alerts, count=alerts.count.reshape(1))
    from collide.engine import grid_overflow
    return StepOutput(
        alerts=alerts,
        num_pairs_checked=jax.lax.psum(pairs.num_checked, ax),
        num_risks=jax.lax.psum(
            jnp.sum(own_valid, dtype=jnp.int32), ax),
        max_risk=jax.lax.pmax(jnp.max(pairs.risk), ax),
        num_alive=jax.lax.psum(jnp.sum(state.alive, dtype=jnp.int32), ax),
        overflow=jax.lax.psum(
            grid_overflow(index, cfg).astype(jnp.int32), ax),
        alert_overflow=jax.lax.psum(pairs.survivor_overflow, ax),
    ), halo_dropped


def _shard_coords(cfg: SystemConfig):
    """(sx, sy, sz) mesh coordinates of this device (0 on absent axes)."""
    sx = jax.lax.axis_index(cfg.shard.axis_name)
    if cfg.shard.num_shards_y > 1 or cfg.shard.num_shards_z > 1:
        sy = jax.lax.axis_index(cfg.shard.axis_name_y)
    else:
        sy = jnp.int32(0)
    if cfg.shard.num_shards_z > 1:
        sz = jax.lax.axis_index(cfg.shard.axis_name_z)
    else:
        sz = jnp.int32(0)
    return sx, sy, sz


def _migrate_phases(state, cfg, sx, sy, sz, bx, by, bz, extra=None):
    """x-phase migration, then the y and z phases on 2D/3D grids (an
    edge/corner-crossing object reaches its diagonal neighbor in 2-3
    hops)."""
    if extra is None:
        state, dropped = migrate(state, cfg, sx, bx, dim=0)
        if cfg.shard.num_shards_y > 1:
            state, dy_ = migrate(state, cfg, sy, by, dim=1)
            dropped = dropped + dy_
        if cfg.shard.num_shards_z > 1:
            state, dz_ = migrate(state, cfg, sz, bz, dim=2)
            dropped = dropped + dz_
        return state, dropped
    state, extra, dropped = migrate(state, cfg, sx, bx, extra=extra, dim=0)
    if cfg.shard.num_shards_y > 1:
        state, extra, dy_ = migrate(state, cfg, sy, by, extra=extra, dim=1)
        dropped = dropped + dy_
    if cfg.shard.num_shards_z > 1:
        state, extra, dz_ = migrate(state, cfg, sz, bz, extra=extra, dim=2)
        dropped = dropped + dz_
    return state, extra, dropped


def _hist_extra(hist):
    """Trajectory-history arrays as migration `extra` fields (histories
    travel WITH their object across walls — shard/predict.py)."""
    return {"hpos": hist.pos, "ht": hist.t,
            "hcount": hist.count, "hhead": hist.head}


def _hist_from_extra(extra):
    from collide.detect.predict import TrajectoryHistory
    return TrajectoryHistory(pos=extra["hpos"], t=extra["ht"],
                             count=extra["hcount"], head=extra["hhead"])


def _local_step(state: ObjectState, key: jax.Array, bx: jax.Array,
                by: jax.Array, bz: jax.Array, cfg: SystemConfig,
                hist=None):
    """Per-shard body. state/key are the LOCAL shard ([slots] arrays);
    bx/by/bz are the replicated [Dx+1]/[Dy+1]/[Dz+1] slab-wall arrays
    (dynamic re-tiling, shard/balance.py). With `hist`, trajectory
    histories migrate alongside their objects."""
    sx, sy, sz = _shard_coords(cfg)
    key = jax.random.fold_in(
        key, (sx * cfg.shard.num_shards_y + sy) * cfg.shard.num_shards_z
        + sz)

    # physics on owned objects
    state = integrate(state, key, cfg)

    # migration: ownership follows position
    if hist is None:
        state, mig_dropped = _migrate_phases(state, cfg, sx, sy, sz,
                                             bx, by, bz)
    else:
        state, extra, mig_dropped = _migrate_phases(
            state, cfg, sx, sy, sz, bx, by, bz, extra=_hist_extra(hist))
        hist = _hist_from_extra(extra)

    out, halo_dropped = _detect_tail_xla(state, cfg, sx, sy, sz, bx, by, bz)
    dropped = mig_dropped.reshape(1) + halo_dropped.reshape(1)
    if hist is None:
        return state, out, dropped
    return state, hist, out, dropped


def _local_step_scenario(state: ObjectState, scen, key: jax.Array,
                         bx: jax.Array, by: jax.Array, bz: jax.Array,
                         cfg: SystemConfig, roads, cities):
    """Per-shard body with device movement modes (sim/scenario.py):
    scenario physics -> migration that CARRIES the per-object scenario
    state (mode/road/target) with each migrating object -> halo ->
    detection tail."""
    from collide.sim.scenario import scenario_integrate, ScenarioState

    sx, sy, sz = _shard_coords(cfg)
    key = jax.random.fold_in(
        key, (sx * cfg.shard.num_shards_y + sy) * cfg.shard.num_shards_z
        + sz)
    state, scen = scenario_integrate(state, scen, key, cfg, roads, cities)
    extra = {"mode": scen.mode, "road": scen.road,
             "target": scen.target, "target_ok": scen.target_ok}
    state, extra, mig_dropped = _migrate_phases(state, cfg, sx, sy, sz,
                                                bx, by, bz, extra=extra)
    scen = ScenarioState(**extra)
    out, halo_dropped = _detect_tail_xla(state, cfg, sx, sy, sz, bx, by, bz)
    return state, scen, out, mig_dropped.reshape(1) + halo_dropped.reshape(1)


def equal_boundaries(cfg: SystemConfig, dim: int = 0):
    """Default [D+1] slab walls along world axis `dim`: equal slabs."""
    import numpy as np
    d = (cfg.shard.num_shards, cfg.shard.num_shards_y,
         cfg.shard.num_shards_z)[dim]
    return jnp.asarray(np.linspace(cfg.world.lo[dim], cfg.world.hi[dim],
                                   d + 1), jnp.float32)


def check_boundaries(cfg: SystemConfig, boundaries, dim: int = 0) -> None:
    """Host-side validity check for dynamic slab walls along world axis
    `dim`: monotone, pinned to world bounds, and wide enough that (a) the
    halo band covers the search radius and (b) no object can cross more
    than one slab per step."""
    import numpy as np
    b = np.asarray(boundaries)
    d = (cfg.shard.num_shards, cfg.shard.num_shards_y,
         cfg.shard.num_shards_z)[dim]
    assert b.shape == (d + 1,)
    assert abs(b[0] - cfg.world.lo[dim]) < 1e-3
    assert abs(b[-1] - cfg.world.hi[dim]) < 1e-3
    min_w = float(np.diff(b).min())
    need = max(cfg.shard.halo_width, cfg.sim.max_speed * cfg.sim.dt)
    assert min_w >= need, (
        f"axis-{dim} slab width {min_w:.1f} < required {need:.1f} "
        f"(halo_width / max_speed*dt)")


def _state_spec_axes(cfg: SystemConfig):
    """PartitionSpec leading-dim entry: the x axis alone on a 1D mesh,
    (x, y) on the 2D grid, (x, y, z) on the 3D grid (device (i, j, k)
    owns block (i*Dy + j)*Dz + k — the same linear order
    distribute_state writes)."""
    if cfg.shard.num_shards_z > 1:
        return (cfg.shard.axis_name, cfg.shard.axis_name_y,
                cfg.shard.axis_name_z)
    if cfg.shard.num_shards_y > 1:
        return (cfg.shard.axis_name, cfg.shard.axis_name_y)
    return cfg.shard.axis_name


def _fold_burst(ys, out, dropped, nb):
    """Fold the scanned (risks, overflow, alert_overflow, dropped) of the
    first nb-1 burst steps into the final step's output: certificates take
    the burst-wide MAX, halo drops sum, per-step risks stack to [nb]."""
    risks, ofs, aos, drs = ys
    if nb > 1:
        out = dataclasses.replace(
            out, overflow=jnp.maximum(jnp.max(ofs), out.overflow),
            alert_overflow=jnp.maximum(jnp.max(aos), out.alert_overflow))
        dropped = jnp.sum(drs, axis=0) + dropped
    risks = jnp.concatenate([risks, out.num_risks[None]])
    return out, dropped, risks


def make_sharded_step(cfg: SystemConfig, mesh: Mesh, donate: bool = True,
                      with_history: bool = False,
                      burst_n: int | None = None):
    """Compile the SPMD step. State layout: every array's leading dim is
    num_shards * shard_slots(cfg), sharded along the mesh axis; each shard
    owns the slots of its slab.

    The returned callable is step(state, key, boundaries=None,
    boundaries_y=None): boundaries / boundaries_y are optional [Dx+1] /
    [Dy+1] slab-wall arrays (see shard/balance.py re-tiling); None uses
    equal slabs. On a 1D mesh boundaries_y is ignored.

    with_history=True: the callable becomes step(state, hist, key,
    boundaries=None, boundaries_y=None) -> (state, hist, out, dropped) —
    the TrajectoryHistory migrates with its objects across walls so the
    sharded predict path (shard/predict.py) stays classification-correct
    after migration.

    burst_n=n: ONE dispatch advances n steps (lax.scan over the same
    shard_map'd body, identical key schedule to n single calls — see
    engine.make_burst_step). The callable becomes step(state[, hist],
    key, boundaries...) -> (state[, hist], key', out, dropped_total,
    risks_per_step[n]); out is the final step's output with overflow /
    alert_overflow replaced by the burst-wide max, dropped_total sums the
    per-step per-shard halo-drop counters. Boundaries are fixed for the
    whole burst (rebalances happen between bursts)."""
    sdim = _state_spec_axes(cfg)
    spec_state = ObjectState(
        pos=P(sdim), vel=P(sdim), acc=P(sdim), heading=P(sdim), size=P(sdim),
        otype=P(sdim), alive=P(sdim), oid=P(sdim))
    spec_alerts = AlertBatch(
        vehicle_oid=P(sdim), other_oid=P(sdim), risk=P(sdim), ttc=P(sdim),
        distance=P(sdim), rel_speed=P(sdim), priority=P(sdim),
        col_pos=P(sdim), valid=P(sdim), count=P(sdim))
    # psum/pmax-reduced scalars are replicated across the mesh -> P()
    spec_out = StepOutput(alerts=spec_alerts, num_pairs_checked=P(),
                          num_risks=P(), max_risk=P(), num_alive=P(),
                          overflow=P(), alert_overflow=P())

    body = partial(_local_step, cfg=cfg)
    default_bx = equal_boundaries(cfg, 0)
    default_by = equal_boundaries(cfg, 1)
    default_bz = equal_boundaries(cfg, 2)

    if with_history:
        from collide.detect.predict import TrajectoryHistory
        spec_hist = TrajectoryHistory(pos=P(sdim), t=P(sdim),
                                      count=P(sdim), head=P(sdim))

        def body_h(state, hist, key, bx, by, bz):
            return body(state, key, bx, by, bz, hist=hist)

        f = jax.shard_map(
            body_h, mesh=mesh,
            in_specs=(spec_state, spec_hist, P(), P(), P(), P()),
            out_specs=(spec_state, spec_hist, spec_out, P(sdim)),
        )
        if burst_n is not None:
            nb = int(burst_n)

            def burst_h(state, hist, key, bx, by, bz):
                def sbody(carry, _):
                    st, hi, k = carry
                    k, sub = jax.random.split(k)
                    st, hi, out, dropped = f(st, hi, sub, bx, by, bz)
                    return (st, hi, k), (out.num_risks, out.overflow,
                                         out.alert_overflow, dropped)
                (state, hist, key), ys = jax.lax.scan(
                    sbody, (state, hist, key), None, length=nb - 1)
                key, sub = jax.random.split(key)
                state, hist, out, dropped = f(state, hist, sub, bx, by, bz)
                out, dropped, risks = _fold_burst(ys, out, dropped, nb)
                return state, hist, key, out, dropped, risks

            jb = jax.jit(burst_h, donate_argnums=(0, 1) if donate else ())

            def step_bh(state, hist, key, boundaries=None,
                        boundaries_y=None, boundaries_z=None):
                return jb(state, hist, key,
                          default_bx if boundaries is None else boundaries,
                          default_by if boundaries_y is None else boundaries_y,
                          default_bz if boundaries_z is None else boundaries_z)

            return step_bh

        jf = jax.jit(f, donate_argnums=(0, 1) if donate else ())

        def step_h(state, hist, key, boundaries=None, boundaries_y=None,
                   boundaries_z=None):
            return jf(state, hist, key,
                      default_bx if boundaries is None else boundaries,
                      default_by if boundaries_y is None else boundaries_y,
                      default_bz if boundaries_z is None else boundaries_z)

        return step_h

    f = jax.shard_map(
        body, mesh=mesh,
        # key + boundaries replicated (key folded per shard in the body)
        in_specs=(spec_state, P(), P(), P(), P()),
        out_specs=(spec_state, spec_out, P(sdim)),
    )

    if burst_n is not None:
        nb = int(burst_n)

        def burst(state, key, bx, by, bz):
            def sbody(carry, _):
                st, k = carry
                k, sub = jax.random.split(k)
                st, out, dropped = f(st, sub, bx, by, bz)
                return (st, k), (out.num_risks, out.overflow,
                                 out.alert_overflow, dropped)
            (state, key), ys = jax.lax.scan(
                sbody, (state, key), None, length=nb - 1)
            key, sub = jax.random.split(key)
            state, out, dropped = f(state, sub, bx, by, bz)
            out, dropped, risks = _fold_burst(ys, out, dropped, nb)
            return state, key, out, dropped, risks

        jb = jax.jit(burst, donate_argnums=(0,) if donate else ())

        def step_b(state, key, boundaries=None, boundaries_y=None,
                   boundaries_z=None):
            return jb(state, key,
                      default_bx if boundaries is None else boundaries,
                      default_by if boundaries_y is None else boundaries_y,
                      default_bz if boundaries_z is None else boundaries_z)

        return step_b

    jf = jax.jit(f, donate_argnums=(0,) if donate else ())

    def step(state, key, boundaries=None, boundaries_y=None,
             boundaries_z=None):
        return jf(state, key,
                  default_bx if boundaries is None else boundaries,
                  default_by if boundaries_y is None else boundaries_y,
                  default_bz if boundaries_z is None else boundaries_z)

    return step


def make_sharded_detect(cfg: SystemConfig, mesh: Mesh):
    """Detection WITHOUT physics over the mesh (the EarlyWarningSystem
    pattern for externally-driven fleets: ingest -> flush -> detect).
    Ingest places objects in their owner shards, so only the halo exchange
    + XLA detection tail run. Returns detect(state, boundaries=None,
    boundaries_y=None) -> (StepOutput, dropped [D])."""
    sdim = _state_spec_axes(cfg)
    spec_state = ObjectState(
        pos=P(sdim), vel=P(sdim), acc=P(sdim), heading=P(sdim), size=P(sdim),
        otype=P(sdim), alive=P(sdim), oid=P(sdim))
    spec_alerts = AlertBatch(
        vehicle_oid=P(sdim), other_oid=P(sdim), risk=P(sdim), ttc=P(sdim),
        distance=P(sdim), rel_speed=P(sdim), priority=P(sdim),
        col_pos=P(sdim), valid=P(sdim), count=P(sdim))
    spec_out = StepOutput(alerts=spec_alerts, num_pairs_checked=P(),
                          num_risks=P(), max_risk=P(), num_alive=P(),
                          overflow=P(), alert_overflow=P())

    def body(state, bx, by, bz):
        sx, sy, sz = _shard_coords(cfg)
        out, halo_dropped = _detect_tail_xla(state, cfg, sx, sy, sz,
                                             bx, by, bz)
        return out, halo_dropped.reshape(1)

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(spec_state, P(), P(), P()),
        out_specs=(spec_out, P(sdim)),
    )
    jf = jax.jit(f)
    default_bx = equal_boundaries(cfg, 0)
    default_by = equal_boundaries(cfg, 1)
    default_bz = equal_boundaries(cfg, 2)

    def detect(state, boundaries=None, boundaries_y=None,
               boundaries_z=None):
        return jf(state,
                  default_bx if boundaries is None else boundaries,
                  default_by if boundaries_y is None else boundaries_y,
                  default_bz if boundaries_z is None else boundaries_z)

    return detect


def make_sharded_scenario_step(cfg: SystemConfig, mesh: Mesh, roads, cities,
                               donate: bool = True):
    """Sharded step with device movement modes: per-object scenario state
    (mode/road/target) is sharded alongside the fleet and MIGRATES with
    objects across slab walls; road/city tables are replicated. Returned
    callable: step(state, scen, key, boundaries=None, boundaries_y=None) ->
    (state, scen, StepOutput, dropped[D])."""
    from collide.sim.scenario import ScenarioState

    sdim = _state_spec_axes(cfg)
    spec_state = ObjectState(
        pos=P(sdim), vel=P(sdim), acc=P(sdim), heading=P(sdim), size=P(sdim),
        otype=P(sdim), alive=P(sdim), oid=P(sdim))
    spec_scen = ScenarioState(mode=P(sdim), road=P(sdim), target=P(sdim),
                              target_ok=P(sdim))
    spec_alerts = AlertBatch(
        vehicle_oid=P(sdim), other_oid=P(sdim), risk=P(sdim), ttc=P(sdim),
        distance=P(sdim), rel_speed=P(sdim), priority=P(sdim),
        col_pos=P(sdim), valid=P(sdim), count=P(sdim))
    spec_out = StepOutput(alerts=spec_alerts, num_pairs_checked=P(),
                          num_risks=P(), max_risk=P(), num_alive=P(),
                          overflow=P(), alert_overflow=P())
    spec_tables = jax.tree.map(lambda _: P(), (roads, cities))

    body = partial(_local_step_scenario, cfg=cfg)

    def wrapped(state, scen, key, bx, by, bz, roads_, cities_):
        return body(state, scen, key, bx, by, bz, roads=roads_,
                    cities=cities_)

    f = jax.shard_map(
        wrapped, mesh=mesh,
        in_specs=(spec_state, spec_scen, P(), P(), P(), P()) + spec_tables,
        out_specs=(spec_state, spec_scen, spec_out, P(sdim)),
    )
    jf = jax.jit(f, donate_argnums=(0, 1) if donate else ())
    default_bx = equal_boundaries(cfg, 0)
    default_by = equal_boundaries(cfg, 1)
    default_bz = equal_boundaries(cfg, 2)

    def step(state, scen, key, boundaries=None, boundaries_y=None,
             boundaries_z=None):
        return jf(state, scen, key,
                  default_bx if boundaries is None else boundaries,
                  default_by if boundaries_y is None else boundaries_y,
                  default_bz if boundaries_z is None else boundaries_z,
                  roads, cities)

    return step


def _local_apply_updates(state: ObjectState, upd: dict,
                         bx: jax.Array, by: jax.Array, bz: jax.Array,
                         cfg: SystemConfig):
    """Per-shard body for sharded ingest: apply a replicated batch of
    location updates (SORTED by oid, -1-padded) to whichever shard owns
    each update's position. Existing copies update in place; copies now
    owned by a different shard are killed there; new/migrated objects
    insert into free slots. Returns (state, dropped)."""
    sx, sy, sz = _shard_coords(cfg)
    dx = cfg.shard.num_shards
    dy = cfg.shard.num_shards_y
    dz = cfg.shard.num_shards_z
    b_oid = upd["oid"]                               # [B] i32 sorted, -1 pad
    bsz = b_oid.shape[0]
    is_mine = (jnp.clip(jnp.searchsorted(bx, upd["pos"][:, 0],
                                         side="right") - 1, 0, dx - 1) == sx)
    if dy > 1:
        is_mine &= (jnp.clip(jnp.searchsorted(by, upd["pos"][:, 1],
                                              side="right") - 1,
                             0, dy - 1) == sy)
    if dz > 1:
        is_mine &= (jnp.clip(jnp.searchsorted(bz, upd["pos"][:, 2],
                                              side="right") - 1,
                             0, dz - 1) == sz)
    valid_upd = b_oid >= 0
    mine = valid_upd & is_mine

    # match local slots against the batch. The batch's REAL oids are
    # ascending but the -1 padding sits at the tail, which would break the
    # binary search (r2 bug: existing objects never matched, so a
    # cross-shard update duplicated the object instead of moving it —
    # caught by tests/test_mesh2d.py::test_mesh2d_sharded_ingest); send
    # padding to +inf for the search.
    b_key = jnp.where(b_oid >= 0, b_oid, jnp.iinfo(jnp.int32).max)
    pos_in_b = jnp.clip(jnp.searchsorted(b_key, state.oid), 0, bsz - 1)
    found = state.alive & (b_oid[pos_in_b] == state.oid)

    # 1) in-place update of slots whose oid is in the batch and stays mine
    upd_here = found & is_mine[pos_in_b]
    fields = ("pos", "vel", "acc", "heading", "size", "otype")
    new_fields = {}
    for f in fields:
        cur = getattr(state, f)
        new = upd[f][pos_in_b]
        m = upd_here.reshape((-1,) + (1,) * (cur.ndim - 1))
        new_fields[f] = jnp.where(m, new, cur)
    # 2) kill copies that moved to another shard via this ingest
    alive = state.alive & ~(found & ~is_mine[pos_in_b])
    state = state.replace(alive=alive, **new_fields)

    # 3) insert entries owned here but not present in any local slot
    present = jnp.zeros(bsz, bool).at[
        jnp.where(found, pos_in_b, bsz)].set(True, mode="drop")
    ins = mine & ~present
    rank = jnp.cumsum(ins.astype(jnp.int32)) - 1
    free = jnp.argsort(state.alive)[:bsz]            # dead slots first
    n_free = jnp.sum(~state.alive, dtype=jnp.int32)
    can = ins & (rank < n_free) & (rank < bsz)
    slot = free[jnp.clip(rank, 0, bsz - 1)]
    tgt = jnp.where(can, slot, state.n)              # n = dropped sentinel
    ins_fields = {}
    for f in fields:
        cur = getattr(state, f)
        ins_fields[f] = cur.at[tgt].set(upd[f], mode="drop")
    oid_new = state.oid.at[tgt].set(b_oid, mode="drop")
    alive_new = state.alive.at[tgt].set(True, mode="drop")
    state = state.replace(oid=oid_new, alive=alive_new, **ins_fields)
    dropped = jnp.sum(ins & ~can, dtype=jnp.int32)
    return state, dropped.reshape(1)


def make_sharded_ingest(cfg: SystemConfig, mesh: Mesh):
    """Compile the sharded per-vehicle ingest: apply(state, upd,
    boundaries=None) -> (state, dropped [D]). `upd` is a dict of
    oid-SORTED, -1-padded host arrays (oid [B] i32, pos [B,3], vel, acc,
    heading, size, otype). The reference's POST /vehicles/location path
    for mesh fleets — the broker hop becomes one replicated batch + a
    per-shard scatter."""
    sdim = _state_spec_axes(cfg)
    spec_state = ObjectState(
        pos=P(sdim), vel=P(sdim), acc=P(sdim), heading=P(sdim), size=P(sdim),
        otype=P(sdim), alive=P(sdim), oid=P(sdim))
    spec_upd = {f: P() for f in ("oid", "pos", "vel", "acc", "heading",
                                 "size", "otype")}
    f = jax.shard_map(
        partial(_local_apply_updates, cfg=cfg), mesh=mesh,
        in_specs=(spec_state, spec_upd, P(), P(), P()),
        out_specs=(spec_state, P(sdim)),
    )
    jf = jax.jit(f, donate_argnums=(0,))
    default_bx = equal_boundaries(cfg, 0)
    default_by = equal_boundaries(cfg, 1)
    default_bz = equal_boundaries(cfg, 2)

    def apply(state, upd, boundaries=None, boundaries_y=None,
              boundaries_z=None):
        return jf(state, upd,
                  default_bx if boundaries is None else boundaries,
                  default_by if boundaries_y is None else boundaries_y,
                  default_bz if boundaries_z is None else boundaries_z)

    return apply


def _shard_of(pos, cfg: SystemConfig, boundaries=None, boundaries_y=None,
              boundaries_z=None):
    """[N] linear shard index ((ix * Dy + iy) * Dz + iz) of each position
    (host-side)."""
    import numpy as np
    dx = cfg.shard.num_shards
    dy = cfg.shard.num_shards_y
    dz = cfg.shard.num_shards_z

    def along(dim, d, b):
        if b is None:
            lo = cfg.world.lo[dim]
            w = (cfg.world.hi[dim] - cfg.world.lo[dim]) / d
            return np.clip(((pos[:, dim] - lo) // w).astype(int), 0, d - 1)
        return np.clip(np.searchsorted(np.asarray(b), pos[:, dim],
                                       side="right") - 1, 0, d - 1)

    ix = along(0, dx, boundaries)
    if dy == 1 and dz == 1:
        return ix
    lin = ix * dy + along(1, dy, boundaries_y)
    if dz == 1:
        return lin
    return lin * dz + along(2, dz, boundaries_z)


def distribute_state(state_global: ObjectState, cfg: SystemConfig,
                     mesh: Mesh, boundaries=None, boundaries_y=None,
                     boundaries_z=None, extra=None):
    """Host-side: scatter a globally-generated fleet into per-shard slots by
    slab/tile (equal walls, or the given [Dx+1]/[Dy+1] dynamic ones).
    Returns the mesh-sharded state ([D * slots] leading dim, D = total
    shards in x-major order) — plus the identically distributed `extra`
    dict (e.g. scenario arrays) when given.

    (This is ingest/bootstrap, not the hot path — plain numpy.)"""
    import numpy as np
    d = cfg.shard.total_shards
    slots = shard_slots(cfg)

    pos = np.asarray(state_global.pos)
    alive = np.asarray(state_global.alive)
    shard_of = _shard_of(pos, cfg, boundaries, boundaries_y, boundaries_z)

    fields = {f: np.asarray(getattr(state_global, f))
              for f in ("pos", "vel", "acc", "heading", "size", "otype",
                        "alive", "oid")}
    xfields = {("x:" + f): np.asarray(v) for f, v in (extra or {}).items()}
    out = {f: np.zeros((d * slots,) + v.shape[1:], v.dtype)
           for f, v in {**fields, **xfields}.items()}
    out["oid"][:] = -1
    for sh in range(d):
        idx = np.flatnonzero((shard_of == sh) & alive)
        if len(idx) > slots:
            raise ValueError(
                f"shard {sh} overflow: {len(idx)} objects > {slots} slots; "
                f"raise ShardConfig.slot_headroom")
        dst = sh * slots + np.arange(len(idx))
        for f in fields:
            out[f][dst] = fields[f][idx]
        for f, v in xfields.items():
            out[f][dst] = v[idx]
        out["alive"][sh * slots:(sh + 1) * slots][len(idx):] = False

    from jax.sharding import NamedSharding
    sharding = NamedSharding(mesh, P(_state_spec_axes(cfg)))
    put = lambda v: jax.device_put(jnp.asarray(v), sharding)
    arrs = {f: put(v) for f, v in out.items() if not f.startswith("x:")}
    arrs["alive"] = arrs["alive"].astype(bool)
    state = ObjectState(**arrs)
    if extra is None:
        return state
    return state, {f: put(out["x:" + f]) for f in extra}


def collect_state(state_sharded: ObjectState) -> ObjectState:
    """Host-side: gather the sharded state to one addressable array set."""
    return jax.tree.map(lambda x: jnp.asarray(jax.device_get(x)),
                        state_sharded)
