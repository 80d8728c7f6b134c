"""Device-side movement modes (sim/scenario.py) vs the host simulator
(sim/traffic.py). With randomness silenced on both sides
(host rng stubbed, device accel_change_prob=0) the dynamics are
deterministic, so host and device trajectories must agree to float
tolerance for every mode."""
import numpy as np
import jax
import pytest

import collide as tc
from collide.core.config import (WorldConfig, GridConfig, SimConfig,
                                 DetectionConfig, AlertConfig)
from collide.core.types import Position
from collide.sim.traffic import TrafficMap, VehicleSimulator
from collide.sim.scenario import (build_road_table, build_city_table,
                                  scenario_from_simulator,
                                  scenario_integrate, init_scenario,
                                  make_scenario_step)

DT = 0.1


def small_cfg(world=500.0, n=None):
    return tc.SystemConfig(
        num_objects=n or 20,
        world=WorldConfig(hi=(world, world, 0.0)),
        sim=SimConfig(accel_change_prob=0.0),   # device jitter off
        grid=GridConfig(cell_size=100.0, cell_capacity=64),
        detect=DetectionConfig(mode="fast"),
        alerts=AlertConfig(max_scene_alerts=64))


def silence(sim):
    """Stop the host's stochastic branches: jitter never triggers and
    retargeting never picks the city branch."""
    sim.rng.random = lambda: 0.99
    sim.traffic_map.rng.random = lambda: 0.5


def host_positions(sim, order):
    return np.array([[sim.vehicles[v].position.x,
                      sim.vehicles[v].position.y] for v in order])


def run_device(state, scen, cfg, roads, cities, steps):
    key = jax.random.key(0)
    for i in range(steps):
        state, scen = scenario_integrate(state, scen,
                                         jax.random.fold_in(key, i),
                                         cfg, roads, cities)
    return state, scen


@pytest.mark.parametrize("mode", ["random", "road_constrained",
                                  "destination_oriented"])
def test_device_matches_host(mode):
    tmap = TrafficMap(seed=3).generate_grid_map(5, 5, 100.0)
    sim = VehicleSimulator(tmap, num_vehicles=20, movement_mode=mode, seed=7)
    sim.initialize_vehicles()
    order = sorted(sim.vehicles)

    if mode == "destination_oriented":
        # fixed far targets so no re-target happens inside the horizon
        for vid in order:
            sim.vehicle_targets[vid] = Position(450.0, 450.0, 0.0)
        silence(sim)
    elif mode == "road_constrained":
        # one real step assigns roads + snaps onto them (host lazy-init),
        # then silence the rng before the comparison window
        sim.update_vehicles(DT)
        silence(sim)
    else:
        silence(sim)

    cfg = small_cfg()
    roads, road_idx = build_road_table(tmap)
    cities = build_city_table(tmap)
    state, scen = scenario_from_simulator(sim, road_idx, order=order)

    steps = 10
    for _ in range(steps):
        sim.update_vehicles(DT)
    state, scen = run_device(state, scen, cfg, roads, cities, steps)

    want = host_positions(sim, order)
    got = np.asarray(state.pos)[:, :2]

    if mode == "road_constrained":
        # exclude vehicles that could hit a segment end inside the window
        # (host picks the next road with its own rng; the device pick is
        # independent — same distribution, different draw)
        keep = []
        for i, vid in enumerate(order):
            rid = sim.vehicle_roads.get(vid)
            r = tmap.roads.get(rid)
            if r is None:
                continue
            dx, dy = r.direction()
            v = sim.vehicles[vid]
            along = ((v.position.x - r.start.x) * dx
                     + (v.position.y - r.start.y) * dy)
            if 5.0 < along < r.length - 20.0 and scen.road[i] == \
                    road_idx.get(rid, -2):
                keep.append(i)
        assert len(keep) >= 8, f"too few comparable vehicles: {len(keep)}"
        np.testing.assert_allclose(got[keep], want[keep], atol=1e-2)
    else:
        np.testing.assert_allclose(got, want, atol=1e-2)


def test_road_mode_stays_on_roads():
    """Long device-only run: every road-mode vehicle stays on its road's
    line (the reference's off-road drift bug, fixed in the host simulator,
    must not reappear on device)."""
    tmap = TrafficMap(seed=1).generate_grid_map(5, 5, 100.0)
    cfg = small_cfg(n=64)
    cfg = cfg.replace(sim=SimConfig(accel_change_prob=0.1))
    roads, road_idx = build_road_table(tmap)
    cities = build_city_table(tmap)
    from collide.sim import generate_fleet
    state = generate_fleet(jax.random.key(0), cfg)
    scen = init_scenario(64, "road_constrained", roads, jax.random.key(1))
    # snap onto assigned roads first (mirror of the host's lazy init)
    ridx = np.asarray(scen.road)
    s = np.asarray(roads.start)[ridx]
    d = np.asarray(roads.dirn)[ridx]
    ln = np.asarray(roads.length)[ridx]
    pos = np.asarray(state.pos).copy()
    pos[:, :2] = s + 0.5 * ln[:, None] * d
    import jax.numpy as jnp
    state = state.replace(pos=jnp.asarray(pos))

    state, scen = run_device(state, scen, cfg, roads, cities, steps=50)
    p = np.asarray(state.pos)[:, :2]
    ridx = np.asarray(scen.road)
    s = np.asarray(roads.start)[ridx]
    d = np.asarray(roads.dirn)[ridx]
    off = (p - s) - (((p - s) * d).sum(1, keepdims=True)) * d
    assert np.abs(off).max() < 1e-2, "vehicle drifted off its road line"
    # and they actually moved
    assert np.abs(p - pos[:, :2]).max() > 1.0


def test_scenario_step_full_pipeline():
    """make_scenario_step: movement modes + detection + alerts in ONE
    jitted program equal the two halves run separately (scenario physics,
    then the engine's detection/alert tail)."""
    tmap = TrafficMap(seed=2).generate_grid_map(5, 5, 100.0)
    cfg = small_cfg(n=200)
    roads, _ = build_road_table(tmap)
    cities = build_city_table(tmap)
    from collide.sim import generate_fleet
    state = generate_fleet(jax.random.key(3), cfg)
    scen = init_scenario(200, "road_constrained", roads, jax.random.key(4))

    from collide.engine import detect_and_alerts
    from collide.sim.scenario import scenario_integrate
    sx = make_scenario_step(cfg, roads, cities, donate=False)
    st1, sc1, o1 = sx(state, scen, jax.random.key(5))
    st2, sc2 = jax.jit(lambda s, c, k: scenario_integrate(
        s, c, k, cfg, roads, cities))(state, scen, jax.random.key(5))
    o2 = jax.jit(lambda s: detect_and_alerts(s, cfg))(st2)
    assert int(o1.num_alive) == int(o2.num_alive) == 200
    assert int(o1.num_risks) == int(o2.num_risks) > 0
    assert int(o1.num_pairs_checked) == int(o2.num_pairs_checked)
    np.testing.assert_allclose(np.asarray(st1.pos), np.asarray(st2.pos),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(sc1.road),
                                  np.asarray(sc2.road))


@pytest.mark.parametrize("grid_shape", [(8, 1), (4, 2)])
def test_sharded_scenario_matches_single_device(grid_shape):
    """Movement modes inside shard_map: the per-object scenario state
    (road assignment) migrates with objects across slab walls — on the 1D
    slab mesh AND the 2D tile grid — and the sharded scenario step matches
    the single-device one exactly under deterministic dynamics."""
    from collide.core.config import ShardConfig
    from collide.shard import (make_mesh, make_sharded_scenario_step,
                               distribute_state, collect_state)
    import jax.numpy as jnp

    tmap = TrafficMap(seed=4).generate_grid_map(100, 100, 100.0)  # 10 km
    n = 400
    cfg = tc.SystemConfig(
        num_objects=n,
        world=WorldConfig(hi=(10000.0, 10000.0, 0.0)),
        sim=SimConfig(accel_change_prob=0.0),
        grid=GridConfig(cell_size=100.0, cell_capacity=64),
        detect=DetectionConfig(mode="fast"),
        alerts=AlertConfig(max_scene_alerts=256),
        shard=ShardConfig(num_shards=grid_shape[0],
                          num_shards_y=grid_shape[1], halo_capacity=256,
                          migrate_capacity=128))
    roads, _ = build_road_table(tmap)
    cities = build_city_table(tmap)
    from collide.sim import generate_fleet
    fleet = generate_fleet(jax.random.key(0), cfg)
    scen = init_scenario(n, "road_constrained", roads, jax.random.key(1))
    # snap onto roads away from the ends so no (randomized) road switch
    # happens in-horizon; random fraction so x stays spread over shards
    ridx = np.asarray(scen.road)
    s = np.asarray(roads.start)[ridx]
    d = np.asarray(roads.dirn)[ridx]
    ln = np.asarray(roads.length)[ridx]
    frac = np.random.default_rng(2).uniform(0.1, 0.9, n)
    pos = np.asarray(fleet.pos).copy()
    pos[:, :2] = s + (frac * ln)[:, None] * d
    fleet = fleet.replace(pos=jnp.asarray(pos))

    # single device
    st1, sc1 = fleet, scen
    step1 = make_scenario_step(cfg, roads, cities, donate=False)
    for i in range(5):
        st1, sc1, out1 = step1(st1, sc1, jax.random.key(100 + i))

    # sharded
    mesh = make_mesh(cfg)
    extra = {"mode": np.asarray(scen.mode), "road": np.asarray(scen.road),
             "target": np.asarray(scen.target),
             "target_ok": np.asarray(scen.target_ok)}
    st8, ex8 = distribute_state(fleet, cfg, mesh, extra=extra)
    from collide.sim.scenario import ScenarioState
    sc8 = ScenarioState(**ex8)
    step8 = make_sharded_scenario_step(cfg, mesh, roads, cities,
                                       donate=False)
    total_dropped = 0
    for i in range(5):
        st8, sc8, out8, dropped = step8(st8, sc8, jax.random.key(100 + i))
        total_dropped += int(np.asarray(dropped).sum())
    assert total_dropped == 0
    assert int(out8.num_alive) == n
    assert int(out8.num_risks) == int(out1.num_risks)

    # positions AND migrated scenario state agree by oid
    host = collect_state(st8)
    alive = np.asarray(host.alive)
    oid8 = np.asarray(host.oid)[alive]
    pos8 = np.asarray(host.pos)[alive]
    road8 = np.asarray(jax.device_get(sc8.road))[alive]
    pos1 = np.asarray(st1.pos)
    road1 = np.asarray(sc1.road)
    assert len(oid8) == n
    for j in np.argsort(oid8)[:100]:
        o = oid8[j]
        np.testing.assert_allclose(pos8[j], pos1[o], atol=1e-3)
        assert road8[j] == road1[o], f"road state lost in migration (oid {o})"
