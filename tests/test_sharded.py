"""Sharded (8-device mesh) vs single-device parity, migration conservation,
and halo correctness — the multi-device correctness layer (SURVEY.md §4).
Runs on the virtual 8-device CPU mesh from conftest."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.slow

import collide as tc
from collide.core.config import (ShardConfig, SimConfig, WorldConfig,
                                 GridConfig, AlertConfig)
from collide.sim import generate_fleet
from collide.shard import (make_mesh, make_sharded_step,
                           distribute_state, shard_slots)
from collide.engine import make_step


def base_cfg(n=800, shards=8, deterministic=True):
    sim = SimConfig(accel_change_prob=0.0) if deterministic else SimConfig()
    return tc.SystemConfig(
        num_objects=n,
        sim=sim,
        alerts=AlertConfig(max_scene_alerts=512),
        shard=ShardConfig(num_shards=shards),
    )


def alerts_set(batch):
    """{(veh, other) -> (risk, ttc)} from an AlertBatch (any leading shape)."""
    v = np.asarray(batch.valid).ravel()
    vo = np.asarray(batch.vehicle_oid).ravel()[v]
    oo = np.asarray(batch.other_oid).ravel()[v]
    r = np.asarray(batch.risk).ravel()[v]
    t = np.asarray(batch.ttc).ravel()[v]
    out = {}
    for a, b, rr, tt in zip(vo, oo, r, t):
        key = (int(a), int(b))
        assert key not in out, f"duplicate alert {key}"
        out[key] = (float(rr), float(tt))
    return out


def test_sharded_matches_single_device():
    """Same fleet, deterministic physics: the sharded step must produce the
    same risk count and the same alert set as the single-device step."""
    cfg = base_cfg()
    fleet = generate_fleet(jax.random.key(0), cfg)
    key = jax.random.key(1)

    # single device
    s1, out1 = make_step(cfg, donate=False)(fleet, key)

    # 8-shard mesh
    mesh = make_mesh(cfg)
    st = distribute_state(fleet, cfg, mesh)
    s8, out8, dropped = make_sharded_step(cfg, mesh, donate=False)(st, key)

    assert int(out8.num_alive) == int(out1.num_alive) == cfg.num_objects
    assert np.asarray(dropped).sum() == 0
    assert int(out8.num_risks) == int(out1.num_risks)

    a1, a8 = alerts_set(out1.alerts), alerts_set(out8.alerts)
    assert set(a1) == set(a8), (
        f"single-only: {set(a1) - set(a8)}, shard-only: {set(a8) - set(a1)}")
    for k in a1:
        np.testing.assert_allclose(a1[k], a8[k], rtol=1e-5, atol=1e-5)
    # positions agree too (same integrator on both paths)
    pos8 = np.asarray(s8.pos)
    oid8 = np.asarray(s8.oid)
    alive8 = np.asarray(s8.alive)
    pos1 = np.asarray(s1.pos)
    for i in np.flatnonzero(alive8)[:100]:
        np.testing.assert_allclose(pos8[i], pos1[oid8[i]], atol=1e-4)


def test_migration_conserves_objects():
    """Objects bouncing around for many steps: none lost, none duplicated."""
    cfg = base_cfg(n=400, deterministic=False)
    mesh = make_mesh(cfg)
    fleet = generate_fleet(jax.random.key(7), cfg)
    st = distribute_state(fleet, cfg, mesh)
    stepf = make_sharded_step(cfg, mesh, donate=False)
    total_dropped = 0
    for i in range(30):
        st, out, dropped = stepf(st, jax.random.key(100 + i))
        total_dropped += int(np.asarray(dropped).sum())
    assert total_dropped == 0
    assert int(out.num_alive) == cfg.num_objects
    # every oid present exactly once among alive slots
    alive = np.asarray(st.alive)
    oids = np.asarray(st.oid)[alive]
    assert len(oids) == cfg.num_objects
    assert len(set(oids.tolist())) == cfg.num_objects


def test_objects_stay_in_their_slab():
    """After migration, every alive object's x is inside its shard's slab."""
    cfg = base_cfg(n=400, deterministic=False)
    mesh = make_mesh(cfg)
    fleet = generate_fleet(jax.random.key(3), cfg)
    st = distribute_state(fleet, cfg, mesh)
    stepf = make_sharded_step(cfg, mesh, donate=False)
    for i in range(10):
        st, out, dropped = stepf(st, jax.random.key(200 + i))
    slots = shard_slots(cfg)
    d = cfg.shard.num_shards
    w = (cfg.world.hi[0] - cfg.world.lo[0]) / d
    pos = np.asarray(st.pos)
    alive = np.asarray(st.alive)
    for sh in range(d):
        seg = slice(sh * slots, (sh + 1) * slots)
        x = pos[seg][alive[seg], 0]
        lo = cfg.world.lo[0] + sh * w
        hi = lo + w
        # edge slabs also hold world-boundary bounces
        lo_ok = lo if sh > 0 else cfg.world.lo[0] - 1e-3
        hi_ok = hi if sh < d - 1 else cfg.world.hi[0] + 1e-3
        assert (x >= lo_ok - 1e-3).all() and (x <= hi_ok + 1e-3).all(), \
            f"shard {sh}: x range [{x.min()}, {x.max()}] outside [{lo}, {hi})"


def test_cross_boundary_pair_detected_via_halo():
    """Two converging objects on opposite sides of a slab boundary must be
    detected — the exact case the reference could never handle
    (compute_node.py:343-368, SURVEY.md §2.10 halo row)."""
    cfg = base_cfg(n=8, shards=8).replace(
        sim=SimConfig(accel_change_prob=0.0))
    d = cfg.shard.num_shards
    w = (cfg.world.hi[0] - cfg.world.lo[0]) / d   # 1250 m slabs
    boundary = cfg.world.lo[0] + 4 * w            # between shards 3 and 4

    n = cfg.num_objects
    pos = np.full((n, 3), 0.0, np.float32)
    # park unused objects far away in distinct corners
    for i in range(n):
        pos[i] = [50.0 + 10 * i, 9000.0, 0.0]
    vel = np.zeros((n, 3), np.float32)
    # the converging pair straddles the boundary, 80 m apart
    pos[0] = [boundary - 40.0, 5000.0, 0.0]
    pos[1] = [boundary + 40.0, 5000.0, 0.0]
    vel[0] = [10.0, 0.0, 0.0]
    vel[1] = [-10.0, 0.0, 0.0]
    heading = np.zeros(n, np.float32)
    heading[1] = np.pi
    size = np.full(n, 2.0, np.float32)
    otype = np.zeros(n, np.int32)
    acc = np.zeros((n, 3), np.float32)

    from collide.core.state import state_from_numpy
    fleet = state_from_numpy(pos, vel, acc, heading, size, otype)
    mesh = make_mesh(cfg)
    st = distribute_state(fleet, cfg, mesh)
    st, out, dropped = make_sharded_step(cfg, mesh, donate=False)(
        st, jax.random.key(0))
    al = alerts_set(out.alerts)
    assert (0, 1) in al, f"cross-boundary pair missed; alerts={al}"
    risk, ttc = al[(0, 1)]
    # 80 m apart closing at 20 m/s, safe=7 m -> first sample 3.7 s
    # (one dt=0.1 step of physics already happened: 78 m -> 3.6 s)
    assert abs(ttc - 3.6) < 0.11, ttc


def test_sharded_scene_facade(tmp_path):
    """ShardedScene: step/alerts/stats/checkpoint-failover on the 8-dev mesh
    (the multi-node deployment facade; checkpointed failover = BASELINE
    config 5's reliability story)."""
    from collide.api import ShardedScene

    cfg = base_cfg(n=400, deterministic=False)
    fleet = generate_fleet(jax.random.key(11), cfg)
    sc = ShardedScene(cfg, fleet=fleet, checkpoint_dir=str(tmp_path))

    out = sc.step(3)
    st = sc.stats()
    assert st["num_alive"] == 400
    assert st["dropped_total"] == 0
    assert len(st["shard_occupancy"]) == 8
    assert st["step_count"] == 3

    path = sc.save_checkpoint()
    sc.step(5)
    pos_after = np.asarray(collect_state_pos(sc))
    assert sc.step_count == 8

    # failover: restore the snapshot, fleet intact, step counter rewound
    sc.restore_checkpoint()
    assert sc.step_count == 3
    assert sc.stats()["num_alive"] == 400
    assert not np.allclose(np.asarray(collect_state_pos(sc)), pos_after)
    # and the restored fleet still steps
    sc.step(1)
    assert sc.stats()["num_alive"] == 400


def collect_state_pos(sc):
    host = sc.collect()
    alive = np.asarray(host.alive)
    order = np.argsort(np.asarray(host.oid)[alive])
    return np.asarray(host.pos)[alive][order]


