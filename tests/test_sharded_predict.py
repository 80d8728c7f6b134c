"""Prediction on the mesh: per-shard
predict_collisions over a displacement-widened halo band must equal the
single-device canonical prediction, histories must migrate with their
objects, and ShardedScene.record/predict must ride it end-to-end."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import collide as tc
from collide.core.config import (ShardConfig, SimConfig, WorldConfig,
                                 GridConfig, DetectionConfig, AlertConfig)
from collide.core.state import state_from_numpy
from collide.sim import generate_fleet
from collide.detect.predict import (empty_history, update_history,
                                    predict_collisions)
from collide.index.grid import build_grid
from collide.shard import make_mesh, make_sharded_step, distribute_state
from collide.shard.predict import (make_sharded_predict,
                                   distribute_history, predict_reach)


def base_cfg(n=300, shards=8, dy=1, dz=1):
    world = (WorldConfig(hi=(4000.0, 4000.0, 800.0)) if dz > 1
             else WorldConfig())
    return tc.SystemConfig(
        num_objects=n,
        world=world,
        sim=SimConfig(accel_change_prob=0.0),
        alerts=AlertConfig(max_scene_alerts=512),
        shard=ShardConfig(num_shards=shards, num_shards_y=dy,
                          num_shards_z=dz),
    )


def fleet_with_history(cfg, key=0, ticks=3):
    """A moving fleet + a consistent global trajectory history (positions
    rolled back so the final state is `state`)."""
    state = generate_fleet(jax.random.key(key), cfg)
    hist = empty_history(state.n)
    dt = cfg.sim.dt
    for i in range(ticks):
        t = (i + 1) * dt
        past = state.replace(
            pos=state.pos - state.vel * (ticks - 1 - i) * dt)
        hist = update_history(hist, past, t)
    return state, hist


def predict_map(other, valid, risk, ttc, oids):
    """{(own_oid, other_oid) -> (risk, ttc)} from merged predict arrays."""
    out = {}
    o = np.asarray(other)
    v = np.asarray(valid)
    r = np.asarray(risk)
    t = np.asarray(ttc)
    oidv = np.asarray(oids)
    for i in range(o.shape[0]):
        for j in range(o.shape[1]):
            if v[i, j]:
                out[(int(oidv[i]), int(o[i, j]))] = (float(r[i, j]),
                                                     float(t[i, j]))
    return out


@pytest.mark.parametrize("dy,dz", [(1, 1), (2, 1), (1, 2)])
def test_sharded_predict_matches_single_device(dy, dz):
    shards = 8 // (dy * dz)
    cfg = base_cfg(shards=shards, dy=dy, dz=dz)
    state, hist = fleet_with_history(cfg)
    if dz > 1:
        # straddle the z wall within +-12 m: pairs stay detectable AND
        # the z halo genuinely carries cross-wall prediction candidates
        state = state.replace(pos=state.pos.at[:, 2].set(
            400.0 + 12.0 * jnp.sin(state.oid.astype(jnp.float32))))

    # single device: candidate indices == positions in state; map to oids
    index = build_grid(state.pos, state.alive, cfg)
    o1, v1, r1, t1, d1 = jax.jit(
        lambda s, h: predict_collisions(s, h, build_grid(s.pos, s.alive,
                                                         cfg), cfg))(
        state, hist)
    oid1 = np.asarray(state.oid)
    single = predict_map(np.asarray(state.oid)[np.asarray(o1)], v1, r1, t1,
                         oid1)

    mesh = make_mesh(cfg)
    st = distribute_state(state, cfg, mesh)
    hs = distribute_history(hist, cfg, mesh, state)
    pfn = make_sharded_predict(cfg, mesh)
    o8, v8, r8, t8, d8, dropped, goflow = pfn(st, hs)
    assert int(np.asarray(dropped).sum()) == 0
    assert int(np.asarray(goflow).sum()) == 0
    sharded = predict_map(o8, v8, r8, t8, st.oid)

    assert single, "fleet too tame: no predicted risks, test vacuous"
    assert set(sharded) == set(single)
    for k in single:
        np.testing.assert_allclose(sharded[k], single[k],
                                   rtol=1e-5, atol=1e-5)


def test_predict_reach_covers_displacement():
    cfg = base_cfg()
    reach = predict_reach(cfg, horizon=10.0, step=0.5)
    # 30 m/s * 9.5 s + 0.5 * 1 * 9.5^2 + 100 halo = 430.1
    assert abs(reach - (100.0 + 30.0 * 9.5 + 0.5 * 9.5 ** 2)) < 1e-6


def test_history_migrates_with_objects():
    """Objects crossing slab walls keep their trajectory rings (the
    with_history step carries them as migration extras)."""
    cfg = base_cfg(n=16, shards=8)
    d = cfg.shard.num_shards
    w = (cfg.world.hi[0] - cfg.world.lo[0]) / d
    boundary = cfg.world.lo[0] + 4 * w
    n = cfg.num_objects
    pos = np.zeros((n, 3), np.float32)
    vel = np.zeros((n, 3), np.float32)
    for i in range(n):
        pos[i] = [(i % d) * w + 300.0 + 10 * i, 5000.0, 0.0]
    # object 0 sits just left of the wall, moving right fast
    pos[0] = [boundary - 1.0, 5000.0, 0.0]
    vel[0] = [20.0, 0.0, 0.0]
    fleet = state_from_numpy(pos, vel, np.zeros((n, 3), np.float32),
                             np.zeros(n, np.float32),
                             np.full(n, 2.0, np.float32),
                             np.zeros(n, np.int32))
    hist = empty_history(fleet.n)
    hist = update_history(hist, fleet, 0.1)
    hist = update_history(hist, fleet, 0.2)

    mesh = make_mesh(cfg)
    st = distribute_state(fleet, cfg, mesh)
    hs = distribute_history(hist, cfg, mesh, fleet)
    stepf = make_sharded_step(cfg, mesh, donate=False, with_history=True)
    st, hs, out, dropped = stepf(st, hs, jax.random.key(0))
    assert int(np.asarray(dropped).sum()) == 0

    alive = np.asarray(st.alive)
    oids = np.asarray(st.oid)
    counts = np.asarray(hs.count)
    slots = st.alive.shape[0] // d
    where0 = np.flatnonzero(alive & (oids == 0))
    assert len(where0) == 1
    # it crossed into shard 4 and kept its 2 recorded samples
    assert where0[0] // slots == 4
    assert counts[where0[0]] == 2
    # every alive object still has its history
    assert (counts[alive] == 2).all()


def test_sharded_scene_predict_end_to_end():
    from collide.api import ShardedScene

    cfg = base_cfg(n=200, shards=8)
    fleet = generate_fleet(jax.random.key(3), cfg)
    sc = ShardedScene(cfg, fleet=fleet, auto_rebalance=False)
    for _ in range(3):
        sc.step()
        sc.record_trajectories()
    risks = sc.predict()
    assert risks, "no predicted risks from a 200-object fleet"
    for r in risks:
        assert r.is_predicted
        assert 0.0 <= r.risk_level <= 1.0
    # predicted alerts reached the alert manager
    st = sc.alert_manager.get_stats()
    assert st["created"] + st["updated"] >= 1


def test_history_redistributes_on_rebalance():
    """A rebalance moves objects to new slots; their trajectory rings must
    move with them (ShardedScene._redistribute_hist) or predict would
    classify with other objects' histories."""
    from collide.api import ShardedScene
    from collide.core.state import state_from_numpy

    n = 200
    rng = np.random.default_rng(0)
    pos = np.stack([np.concatenate([rng.uniform(0, 1000, int(0.8 * n)),
                                    rng.uniform(0, 10_000, n - int(0.8 * n))]),
                    rng.uniform(0, 10_000, n),
                    np.zeros(n)], axis=1).astype(np.float32)
    vel = rng.normal(0, 5, (n, 3)).astype(np.float32)
    vel[:, 2] = 0
    fleet = state_from_numpy(pos, vel, np.zeros((n, 3), np.float32),
                             np.zeros(n, np.float32),
                             np.full(n, 2.0, np.float32),
                             np.zeros(n, np.int32))
    cfg = base_cfg(n=n, shards=8).replace(
        shard=tc.SystemConfig().shard.__class__(
            num_shards=8, slot_headroom=9.0))
    sc = ShardedScene(cfg, fleet=fleet, auto_rebalance=True)
    sc.record_trajectories()
    sc.record_trajectories()

    # force the rebalance path exactly as step() runs it
    old_state = sc.state
    (sc.state, sc.boundaries, sc.boundaries_y,
     sc.boundaries_z) = sc.balancer.rebalance(
        old_state, sc.mesh)
    sc._traj = sc._redistribute_hist(old_state)

    host = sc.collect()
    alive = np.asarray(host.alive)
    hpos = np.asarray(jax.device_get(sc._traj.pos))
    hcount = np.asarray(jax.device_get(sc._traj.count))
    hhead = np.asarray(jax.device_get(sc._traj.head))
    # every alive slot kept its 2 samples, and the LAST recorded sample is
    # that same object's position (rebalance moves slots, not objects)
    assert (hcount[alive] == 2).all()
    spos = np.asarray(host.pos)
    for slot in np.flatnonzero(alive)[:50]:
        last = hpos[slot, (hhead[slot] - 1) % sc._traj.capacity]
        np.testing.assert_allclose(last, spos[slot], atol=1e-4)
    # and predict still runs end-to-end on the redistributed rings
    risks = sc.predict()
    assert isinstance(risks, list)


def test_halo_exchange_hops_visibility():
    """Multi-hop halo (ROADMAP #6): a band wider than one slab is mirrored
    exactly — every shard sees precisely the alive objects within `width`
    of its slab, delivered over a 3-hop ppermute chain."""
    from jax.sharding import PartitionSpec as P
    from collide.core.state import ObjectState
    from collide.shard.halo import halo_exchange_hops
    from collide.shard.step import (_shard_coords, _state_spec_axes,
                                    equal_boundaries, shard_slots)

    cfg = base_cfg(n=40, shards=8).replace(world=WorldConfig(
        hi=(4000.0, 4000.0, 0.0)))
    width, hops = 1200.0, 3          # 2.4 x 500 m slabs -> 3 hops
    n = cfg.num_objects
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = 50.0 + 100.0 * np.arange(n)     # one per 100 m across x
    pos[:, 1] = 2000.0
    fleet = state_from_numpy(pos, np.zeros_like(pos), np.zeros_like(pos),
                             np.zeros(n, np.float32),
                             np.full(n, 2.0, np.float32),
                             np.zeros(n, np.int32))
    mesh = make_mesh(cfg)
    st = distribute_state(fleet, cfg, mesh)

    def body(state, b):
        sx, _, _ = _shard_coords(cfg)
        buf, valid, dropped = halo_exchange_hops(
            state, cfg, sx, b, dim=0, width=width, capacity=16, hops=hops)
        return jnp.where(valid, buf["oid"], -1), dropped.reshape(1)

    sdim = _state_spec_axes(cfg)
    spec_state = ObjectState(
        pos=P(sdim), vel=P(sdim), acc=P(sdim), heading=P(sdim),
        size=P(sdim), otype=P(sdim), alive=P(sdim), oid=P(sdim))
    f = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(spec_state, P()),
        out_specs=(P(sdim), P(sdim)), check_vma=False))
    oids, dropped = f(st, equal_boundaries(cfg, 0))
    assert int(np.asarray(dropped).sum()) == 0

    d = cfg.shard.num_shards
    slab = (cfg.world.hi[0] - cfg.world.lo[0]) / d
    rows_per = np.asarray(oids).shape[0] // d
    for sh in range(d):
        got = set(np.asarray(oids)[sh * rows_per:(sh + 1) * rows_per])
        got.discard(-1)
        lo, hi = sh * slab, (sh + 1) * slab
        want = {int(o) for o, x in zip(fleet.oid, pos[:, 0])
                if (lo - width <= x < lo) or (hi <= x < hi + width)}
        assert got == want, f"shard {sh}: {sorted(got)} != {sorted(want)}"


def test_sharded_predict_multihop_matches_single_device():
    """A prediction horizon whose displacement bound spans TWO slabs: the
    multi-hop chain delivers the far candidates and per-shard prediction
    stays exactly equal to single-device — including a crafted pair whose
    query (shard 0) meets a candidate owned by shard 2."""
    from collide.shard.predict import predict_hops

    n = 42
    cfg = base_cfg(n=n, shards=8).replace(world=WorldConfig(
        hi=(4000.0, 4000.0, 0.0)))
    horizon, step = 20.0, 2.0        # o_max 18 -> reach 802 m > 500 m slab
    reach = predict_reach(cfg, horizon, step)
    assert predict_hops(cfg, reach, 0) == 2

    pos = np.zeros((n, 3), np.float32)
    vel = np.zeros((n, 3), np.float32)
    # spread background objects (no pairs among themselves: 95 m+ apart in y)
    pos[2:, 0] = 80.0 + 93.0 * np.arange(n - 2)
    pos[2:, 1] = 300.0 + 83.0 * np.arange(n - 2)
    # query: right edge of shard 0, heading right at 30 m/s
    pos[0] = [495.0, 2000.0, 0.0]
    vel[0] = [30.0, 0.0, 0.0]
    # candidate: stationary where the query lands at offset 18 s — shard 2
    pos[1] = [495.0 + 30.0 * 18.0, 2000.0, 0.0]
    fleet = state_from_numpy(pos, vel, np.zeros((n, 3), np.float32),
                             np.zeros(n, np.float32),
                             np.full(n, 2.0, np.float32),
                             np.zeros(n, np.int32))
    hist = empty_history(fleet.n)
    dt = cfg.sim.dt
    for i in range(3):
        past = fleet.replace(pos=fleet.pos - fleet.vel * (2 - i) * dt)
        hist = update_history(hist, past, (i + 1) * dt)

    o1, v1, r1, t1, d1 = jax.jit(
        lambda s, h: predict_collisions(
            s, h, build_grid(s.pos, s.alive, cfg), cfg,
            horizon=horizon, step=step))(fleet, hist)
    single = predict_map(np.asarray(fleet.oid)[np.asarray(o1)], v1, r1, t1,
                         fleet.oid)
    assert (0, 1) in single, "crafted cross-2-slab pair missing upstream"

    mesh = make_mesh(cfg)
    st = distribute_state(fleet, cfg, mesh)
    hs = distribute_history(hist, cfg, mesh, fleet)
    pfn = make_sharded_predict(cfg, mesh, horizon=horizon, step=step)
    o8, v8, r8, t8, d8, dropped, goflow = pfn(st, hs)
    assert int(np.asarray(dropped).sum()) == 0
    assert int(np.asarray(goflow).sum()) == 0
    sharded = predict_map(o8, v8, r8, t8, st.oid)

    assert set(sharded) == set(single)
    for k in single:
        np.testing.assert_allclose(sharded[k], single[k],
                                   rtol=1e-5, atol=1e-5)

    # and the single-hop chain provably CANNOT see that pair
    pfn1 = make_sharded_predict(cfg, mesh, horizon=horizon, step=step,
                                hops=1)
    o8b, v8b, r8b, t8b, _, _, _ = pfn1(st, hs)
    assert (0, 1) not in predict_map(o8b, v8b, r8b, t8b, st.oid)


def test_sharded_predict_multihop_2d_mesh():
    """Multi-hop on the (x, y) tile grid: a crafted pair two Y-slabs apart
    rides the y-phase forwarding chain (which re-mirrors the x-extended
    state); per-shard prediction equals single-device exactly."""
    from collide.shard.predict import predict_hops

    n = 24
    cfg = base_cfg(n=n, shards=2, dy=4).replace(world=WorldConfig(
        hi=(2000.0, 2400.0, 0.0)))
    horizon, step = 24.0, 2.0       # o_max 22 -> reach 1002 m; y slab 600
    reach = predict_reach(cfg, horizon, step)
    assert predict_hops(cfg, reach, 0) == 1      # x: clamped to d-1
    assert predict_hops(cfg, reach, 1) == 2

    pos = np.zeros((n, 3), np.float32)
    vel = np.zeros((n, 3), np.float32)
    pos[2:, 0] = 60.0 + 85.0 * np.arange(n - 2)
    pos[2:, 1] = np.tile([150.0, 800.0], (n - 2 + 1) // 2)[:n - 2]
    pos[2:, 0] %= 2000.0
    # query: top edge of y-slab 0, heading +y at 30 m/s (const-vel class)
    pos[0] = [1000.0, 595.0, 0.0]
    vel[0] = [0.0, 30.0, 0.0]
    # candidate: stationary where the query lands at offset 22 s — y-slab 2
    pos[1] = [1000.0, 595.0 + 30.0 * 22.0, 0.0]
    fleet = state_from_numpy(pos, vel, np.zeros((n, 3), np.float32),
                             np.zeros(n, np.float32),
                             np.full(n, 2.0, np.float32),
                             np.zeros(n, np.int32))
    hist = empty_history(fleet.n)
    dt = cfg.sim.dt
    for i in range(3):
        past = fleet.replace(pos=fleet.pos - fleet.vel * (2 - i) * dt)
        hist = update_history(hist, past, (i + 1) * dt)

    o1, v1, r1, t1, d1 = jax.jit(
        lambda s, h: predict_collisions(
            s, h, build_grid(s.pos, s.alive, cfg), cfg,
            horizon=horizon, step=step))(fleet, hist)
    single = predict_map(np.asarray(fleet.oid)[np.asarray(o1)], v1, r1, t1,
                         fleet.oid)
    assert (0, 1) in single, "crafted cross-2-y-slab pair missing upstream"

    mesh = make_mesh(cfg)
    st = distribute_state(fleet, cfg, mesh)
    hs = distribute_history(hist, cfg, mesh, fleet)
    pfn = make_sharded_predict(cfg, mesh, horizon=horizon, step=step)
    o8, v8, r8, t8, d8, dropped, goflow = pfn(st, hs)
    assert int(np.asarray(dropped).sum()) == 0
    assert int(np.asarray(goflow).sum()) == 0
    sharded = predict_map(o8, v8, r8, t8, st.oid)

    assert set(sharded) == set(single)
    for k in single:
        np.testing.assert_allclose(sharded[k], single[k],
                                   rtol=1e-5, atol=1e-5)


