"""Dynamic slab boundaries + load rebalancing.

The reference rebalanced by splitting hot regions / merging cold ones and
migrating shards between nodes (spatial_index.py:585-679,
data_sharding.py:513-564). The mesh equivalent moves the slab WALLS:
quantile boundaries put ~equal object counts on every device, and the
sharded step consumes the [D+1] wall array directly. Acceptance (from the
round-1 verdict): an 80/20 x-skewed fleet that overflows equal slabs at
slot_headroom=1.3 runs after rebalance with dropped_total == 0 and
max/mean occupancy < 1.2."""
import numpy as np
import jax
import pytest

import collide as tc
from collide.core.config import (ShardConfig, SimConfig, WorldConfig,
                                 AlertConfig)
from collide.core.state import state_from_numpy
from collide.sim import generate_fleet
from collide.shard import (make_mesh, make_sharded_step,
                           distribute_state, shard_slots,
                           quantile_boundaries, equal_boundaries,
                           check_boundaries, LoadBalancer,
                           shard_occupancy, imbalance)
from collide.engine import make_step


def skewed_fleet(n, world_x, world_y, dense_frac=0.8, dense_hi=0.1,
                 seed=0):
    """dense_frac of the fleet packed into the first dense_hi of x."""
    rng = np.random.default_rng(seed)
    n_dense = int(n * dense_frac)
    x = np.concatenate([
        rng.uniform(0, world_x * dense_hi, n_dense),
        rng.uniform(0, world_x, n - n_dense)])
    pos = np.stack([x, rng.uniform(0, world_y, n), np.zeros(n)], axis=1)
    speed = rng.uniform(5, 20, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    vel = np.stack([speed * np.cos(ang), speed * np.sin(ang),
                    np.zeros(n)], axis=1)
    return state_from_numpy(pos.astype(np.float32), vel.astype(np.float32),
                            np.zeros((n, 3), np.float32),
                            ang.astype(np.float32),
                            np.full(n, 2.0, np.float32),
                            rng.integers(0, 4, n).astype(np.int32))


def skew_cfg(n=800, shards=8, headroom=1.3):
    return tc.SystemConfig(
        num_objects=n,
        sim=SimConfig(accel_change_prob=0.0),
        alerts=AlertConfig(max_scene_alerts=512),
        shard=ShardConfig(num_shards=shards, slot_headroom=headroom,
                          halo_capacity=512, migrate_capacity=128),
    )


def test_skewed_fleet_overflows_equal_slabs():
    cfg = skew_cfg()
    fleet = skewed_fleet(800, 10_000.0, 10_000.0)
    mesh = make_mesh(cfg)
    with pytest.raises(ValueError, match="overflow"):
        distribute_state(fleet, cfg, mesh)


def test_quantile_boundaries_carry_the_skew():
    """Acceptance: same fleet + quantile walls -> fits at
    headroom 1.3, 20 steps with dropped == 0, occupancy max/mean < 1.2."""
    cfg = skew_cfg()
    fleet = skewed_fleet(800, 10_000.0, 10_000.0)
    mesh = make_mesh(cfg)
    slots = shard_slots(cfg)

    x = np.asarray(fleet.pos)[:, 0]
    b = quantile_boundaries(x, cfg.shard.num_shards,
                            cfg.world.lo[0], cfg.world.hi[0],
                            min_width=110.0)
    check_boundaries(cfg, b)
    st = distribute_state(fleet, cfg, mesh, boundaries=b)
    occ = shard_occupancy(st, cfg, slots)
    assert imbalance(occ) < 1.2

    stepf = make_sharded_step(cfg, mesh, donate=False)
    bj = np.asarray(b, np.float32)
    dropped_total = 0
    for i in range(20):
        st, out, dropped = stepf(st, jax.random.key(100 + i), bj)
        dropped_total += int(np.asarray(dropped).sum())
    assert dropped_total == 0
    assert int(out.num_alive) == cfg.num_objects
    occ = shard_occupancy(st, cfg, slots)
    assert imbalance(occ) < 1.2
    # no oid lost or duplicated across 20 steps of wall-relative migration
    alive = np.asarray(st.alive)
    oids = np.asarray(st.oid)[alive]
    assert len(set(oids.tolist())) == cfg.num_objects


def test_dynamic_walls_match_single_device():
    """Detection semantics are wall-independent: sharded step under
    quantile walls produces the same risks/alerts as single-device."""
    cfg = skew_cfg()
    fleet = skewed_fleet(800, 10_000.0, 10_000.0, seed=3)
    key = jax.random.key(1)
    s1, out1 = make_step(cfg, donate=False)(fleet, key)

    mesh = make_mesh(cfg)
    b = quantile_boundaries(np.asarray(fleet.pos)[:, 0],
                            cfg.shard.num_shards,
                            cfg.world.lo[0], cfg.world.hi[0], 110.0)
    st = distribute_state(fleet, cfg, mesh, boundaries=b)
    s8, out8, dropped = make_sharded_step(cfg, mesh, donate=False)(
        st, key, np.asarray(b, np.float32))

    assert np.asarray(dropped).sum() == 0
    assert int(out8.num_risks) == int(out1.num_risks)

    def aset(out):
        v = np.asarray(out.alerts.valid).ravel()
        return {(int(a), int(b_)) for a, b_ in zip(
            np.asarray(out.alerts.vehicle_oid).ravel()[v],
            np.asarray(out.alerts.other_oid).ravel()[v])}
    assert aset(out1) == aset(out8)


def test_load_balancer_moves_walls():
    """End-to-end: a fleet that FITS equal slabs but is imbalanced trips
    should_rebalance; rebalance() returns walls that equalize occupancy,
    and the step keeps running clean under them."""
    cfg = skew_cfg(headroom=4.0)
    fleet = skewed_fleet(800, 10_000.0, 10_000.0, dense_frac=0.6,
                         dense_hi=0.25, seed=5)
    mesh = make_mesh(cfg)
    slots = shard_slots(cfg)
    st = distribute_state(fleet, cfg, mesh)
    assert imbalance(shard_occupancy(st, cfg, slots)) > 1.2

    bal = LoadBalancer(cfg, slots, check_every=1)
    assert bal.should_rebalance(st)
    st, b, _, _ = bal.rebalance(st, mesh)
    occ = shard_occupancy(st, cfg, slots)
    assert imbalance(occ) < 1.2
    assert bal.stats["rebalances"] == 1
    # walls actually moved off the equal grid
    assert not np.allclose(b, np.asarray(equal_boundaries(cfg)))

    stepf = make_sharded_step(cfg, mesh, donate=False)
    bj = np.asarray(b, np.float32)
    for i in range(5):
        st, out, dropped = stepf(st, jax.random.key(200 + i), bj)
        assert int(np.asarray(dropped).sum()) == 0
    assert int(out.num_alive) == cfg.num_objects


def test_clamped_rebalance_backs_off_and_2d_mesh_escapes():
    """A fleet crammed into ONE dense x-column thinner
    than the minimum slab width cannot be balanced by 1D walls — the
    LoadBalancer must clamp, back off (no rebalance thrash) and keep the
    imbalance visible; the SAME fleet balances on a 2D (x, y) tiling whose
    y-quantile walls split the column."""
    rng = np.random.default_rng(3)
    n = 800
    pos = np.stack([rng.uniform(4000.0, 4120.0, n),     # 120 m column
                    rng.uniform(0.0, 10_000.0, n),
                    np.zeros(n)], axis=1).astype(np.float32)
    fleet = state_from_numpy(pos, np.zeros((n, 3), np.float32),
                             np.zeros((n, 3), np.float32),
                             np.zeros(n, np.float32),
                             np.full(n, 2.0, np.float32),
                             np.arange(n, dtype=np.int32))

    cfg1 = skew_cfg(headroom=8.0)
    mesh1 = make_mesh(cfg1)
    slots1 = shard_slots(cfg1)
    st1 = distribute_state(fleet, cfg1, mesh1)
    bal = LoadBalancer(cfg1, slots1, check_every=1)
    assert bal.should_rebalance(st1)
    st1, bx, _, _ = bal.rebalance(st1, mesh1)
    occ = shard_occupancy(st1, cfg1, slots1)
    # min_slab_width clamps every wall: one shard still owns ~everything
    assert imbalance(occ) > 4.0
    assert (np.diff(np.asarray(bx)) >= bal.min_slab_width() - 1e-6).all()
    # and the balancer BACKS OFF instead of thrashing
    assert bal.should_rebalance(st1) is False
    assert bal.stats["backoffs"] == 1

    # escape hatch: 2D tiling — y walls split the dense column
    cfg2 = skew_cfg(shards=2, headroom=4.0).replace(
        shard=ShardConfig(num_shards=2, num_shards_y=4,
                          slot_headroom=4.0, halo_capacity=512,
                          migrate_capacity=128))
    mesh2 = make_mesh(cfg2)
    slots2 = shard_slots(cfg2)
    st2 = distribute_state(fleet, cfg2, mesh2)
    bal2 = LoadBalancer(cfg2, slots2, check_every=1)
    assert bal2.should_rebalance(st2)
    st2, bx2, by2, _ = bal2.rebalance(st2, mesh2)
    assert imbalance(shard_occupancy(st2, cfg2, slots2)) < 1.3
