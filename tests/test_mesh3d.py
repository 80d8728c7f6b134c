"""3D (x, y, z) device-grid sharding: parity with single device (alerts
set-equal), 3D-corner halo coverage (all three mirror phases), three-phase
migration conservation, per-axis dynamic walls including z, z-skew
balancing that x/y walls cannot express. The z axis serves deep-z worlds
(stacked
aviation layers) whose density skews vertically — z quantile walls
balance what x/y walls cannot. Runs on the virtual 8-device CPU mesh
(2x2x2)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import collide as tc
from collide.core.config import (ShardConfig, SimConfig, WorldConfig,
                                 GridConfig, DetectionConfig,
                                 AlertConfig)
from collide.core.state import state_from_numpy
from collide.sim import generate_fleet
from collide.shard import (make_mesh, make_sharded_step,
                           distribute_state, shard_slots,
                           check_boundaries, LoadBalancer,
                           shard_occupancy, imbalance)
from collide.engine import make_step


def cfg3d_mesh(n=500, dx=2, dy=2, dz=2, deterministic=True, headroom=2.0):
    sim = SimConfig(accel_change_prob=0.0) if deterministic else SimConfig()
    return tc.SystemConfig(
        num_objects=n,
        world=WorldConfig(hi=(4000.0, 4000.0, 800.0)),
        grid=GridConfig(cell_size=100.0, cell_capacity=64),
        sim=sim,
        alerts=AlertConfig(max_scene_alerts=512),
        shard=ShardConfig(num_shards=dx, num_shards_y=dy, num_shards_z=dz,
                          slot_headroom=headroom),
    )


def fleet3d(cfg, key=0):
    fleet = generate_fleet(jax.random.key(key), cfg, distribution="uniform")
    return fleet.replace(pos=fleet.pos.at[:, 2].set(
        jax.random.uniform(jax.random.key(key + 1), (fleet.n,))
        * cfg.world.hi[2]))


def alerts_set(batch):
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


def test_mesh3d_matches_single_device():
    """2x2x2 grid, deterministic physics: same risks and alert set as the
    single-device step."""
    cfg = cfg3d_mesh()
    fleet = fleet3d(cfg)
    key = jax.random.key(1)

    s1, out1 = make_step(cfg, donate=False)(fleet, key)
    mesh = make_mesh(cfg)
    assert mesh.devices.shape == (2, 2, 2)
    st = distribute_state(fleet, cfg, mesh)
    s8, out8, dropped = make_sharded_step(cfg, mesh, donate=False)(st, key)

    assert int(np.asarray(dropped).sum()) == 0
    assert int(out8.num_alive) == int(out1.num_alive) == cfg.num_objects
    assert int(out8.num_risks) == int(out1.num_risks)
    a1, a8 = alerts_set(out1.alerts), alerts_set(out8.alerts)
    assert set(a1) == set(a8), (
        f"single-only: {set(a1) - set(a8)}, mesh-only: {set(a8) - set(a1)}")
    for k in a1:
        np.testing.assert_allclose(a1[k], a8[k], rtol=1e-5, atol=1e-5)


def test_mesh3d_corner_pair_detected():
    """Two converging objects on opposite sides of the (x, y, z) CORNER
    shared by all 8 tiles: only the full three-phase halo (z pass
    re-mirroring the xy-extended state) can see this pair."""
    cfg = cfg3d_mesh(n=8)
    cx, cy, cz = 2000.0, 2000.0, 400.0
    n = cfg.num_objects
    pos = np.zeros((n, 3), np.float32)
    vel = np.zeros((n, 3), np.float32)
    for i in range(n):
        pos[i] = [100.0 + 10 * i, 100.0, 50.0]
    # 3D-diagonal pair ~14 m on each side of the corner (48.5 m apart,
    # inside the 50 m search radius), converging
    pos[0] = [cx - 14.0, cy - 14.0, cz - 14.0]
    pos[1] = [cx + 14.0, cy + 14.0, cz + 14.0]
    vel[0] = [4.0, 4.0, 4.0]
    vel[1] = [-4.0, -4.0, -4.0]
    fleet = state_from_numpy(pos, vel, np.zeros((n, 3), np.float32),
                             np.zeros(n, np.float32),
                             np.full(n, 2.0, np.float32),
                             np.zeros(n, np.int32))
    mesh = make_mesh(cfg)
    st = distribute_state(fleet, cfg, mesh)
    st, out, dropped = make_sharded_step(cfg, mesh, donate=False)(
        st, jax.random.key(0))
    al = alerts_set(out.alerts)
    assert (0, 1) in al, f"3D corner pair missed; alerts={al}"
    _, o1 = make_step(cfg, donate=False)(fleet, jax.random.key(0))
    a1 = alerts_set(o1.alerts)
    np.testing.assert_allclose(al[(0, 1)], a1[(0, 1)], rtol=1e-5, atol=1e-5)


def test_mesh3d_migration_conserves_objects():
    """Fast fleet bouncing for 25 steps on the 2x2x2 grid: nothing lost or
    duplicated, including 3D-corner crossings (three-hop migration), and
    every survivor sits inside its tile."""
    cfg = cfg3d_mesh(n=300, deterministic=False)
    mesh = make_mesh(cfg)
    fleet = fleet3d(cfg, key=7)
    st = distribute_state(fleet, cfg, mesh)
    stepf = make_sharded_step(cfg, mesh, donate=False)
    total_dropped = 0
    for i in range(25):
        st, out, dropped = stepf(st, jax.random.key(100 + i))
        total_dropped += int(np.asarray(dropped).sum())
    assert total_dropped == 0
    assert int(out.num_alive) == cfg.num_objects
    alive = np.asarray(st.alive)
    oids = np.asarray(st.oid)[alive]
    assert len(oids) == cfg.num_objects
    assert len(set(oids.tolist())) == cfg.num_objects
    slots = shard_slots(cfg)
    dx, dy, dz = (cfg.shard.num_shards, cfg.shard.num_shards_y,
                  cfg.shard.num_shards_z)
    w = [(cfg.world.hi[d] - cfg.world.lo[d]) / k
         for d, k in ((0, dx), (1, dy), (2, dz))]
    pos = np.asarray(st.pos)
    for ix in range(dx):
        for iy in range(dy):
            for iz in range(dz):
                sh = (ix * dy + iy) * dz + iz
                seg = slice(sh * slots, (sh + 1) * slots)
                p = pos[seg][alive[seg]]
                if len(p) == 0:
                    continue
                for d, i_ in ((0, ix), (1, iy), (2, iz)):
                    lo = cfg.world.lo[d] + i_ * w[d]
                    assert (p[:, d] >= lo - 1e-3).all()
                    assert (p[:, d] <= lo + w[d] + 1e-3).all()


def test_mesh3d_dynamic_walls_parity():
    """Moved walls on ALL THREE axes: the step under skewed walls still
    matches single device."""
    cfg = cfg3d_mesh(headroom=3.5)
    fleet = fleet3d(cfg, key=3)
    key = jax.random.key(4)
    bx = np.array([0.0, 1500.0, 4000.0], np.float32)
    by = np.array([0.0, 2600.0, 4000.0], np.float32)
    bz = np.array([0.0, 250.0, 800.0], np.float32)
    check_boundaries(cfg, bx, dim=0)
    check_boundaries(cfg, by, dim=1)
    check_boundaries(cfg, bz, dim=2)

    _, out1 = make_step(cfg, donate=False)(fleet, key)
    mesh = make_mesh(cfg)
    st = distribute_state(fleet, cfg, mesh, boundaries=bx, boundaries_y=by,
                          boundaries_z=bz)
    _, out8, dropped = make_sharded_step(cfg, mesh, donate=False)(
        st, key, bx, by, bz)
    assert int(np.asarray(dropped).sum()) == 0
    assert int(out8.num_risks) == int(out1.num_risks)
    assert set(alerts_set(out1.alerts)) == set(alerts_set(out8.alerts))


def test_mesh3d_z_skew_balances_where_xy_walls_cannot():
    """A fleet uniform in x/y but crammed into a thin z layer (the dense-
    airspace-floor case): x/y quantile walls cannot balance it, the z
    walls can."""
    cfg = cfg3d_mesh(n=600, dx=2, dy=1, dz=4, headroom=4.0)
    rng = np.random.default_rng(0)
    n = cfg.num_objects
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = rng.uniform(0, 4000, n)
    pos[:, 1] = rng.uniform(0, 4000, n)
    # dense band wide enough that quantile walls are NOT clamped by the
    # 100 m min slab width (a thinner band hits the documented clamp
    # limitation — see the x-axis clamped-rebalance test)
    n_dense = int(0.85 * n)
    pos[:n_dense, 2] = rng.uniform(0, 400, n_dense)     # bottom half of z
    pos[n_dense:, 2] = rng.uniform(400, 800, n - n_dense)
    fleet = state_from_numpy(pos,
                             rng.normal(0, 5, (n, 3)).astype(np.float32),
                             np.zeros((n, 3), np.float32),
                             np.zeros(n, np.float32),
                             np.full(n, 2.0, np.float32),
                             np.zeros(n, np.int32))
    mesh = make_mesh(cfg)
    slots = shard_slots(cfg)
    st = distribute_state(fleet, cfg, mesh)
    occ = shard_occupancy(st, cfg, slots)
    assert imbalance(occ) > 1.5          # z-skew overloads the floor tiles

    bal = LoadBalancer(cfg, slots, check_every=1)
    assert bal.should_rebalance(st)
    st2, bx, by, bz = bal.rebalance(st, mesh)
    occ2 = shard_occupancy(st2, cfg, slots)
    assert imbalance(occ2) < 1.25
    assert bz is not None
    assert bz[1] < 250.0                 # z walls moved into the floor band
    stepf = make_sharded_step(cfg, mesh, donate=False)
    st2, out, dropped = stepf(st2, jax.random.key(9),
                              jnp.asarray(bx, jnp.float32),
                              None,
                              jnp.asarray(bz, jnp.float32))
    assert int(np.asarray(dropped).sum()) == 0
    assert int(out.num_alive) == n
