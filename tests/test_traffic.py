"""Traffic simulator + load-balancer planning + state-transfer/recovery
(reference vehicle_simulator.py, data_sharding.py rebalance,
disaster_recovery.py transfer/coordinator)."""
import asyncio
import math

import numpy as np
import pytest

import collide as tc
from collide.core.config import ShardConfig, SimConfig, WorldConfig
from collide.sim.traffic import TrafficMap, VehicleSimulator, scene_sink
from collide.runtime.messaging import MessageBroker
from collide.runtime.reliability import (StateTransferManager,
                                         RecoveryCoordinator)


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def test_grid_map_structure():
    m = TrafficMap(seed=1).generate_grid_map(4, 3, cell_size=100.0)
    assert m.size == (400.0, 300.0)
    assert len([r for r in m.roads if r.startswith("h-")]) == 4
    assert len([r for r in m.roads if r.startswith("v-")]) == 5
    assert len(m.intersections) == 5 * 4
    assert 1 <= len(m.cities) <= 5
    assert all(r.speed_limit == 13.9 for r in m.roads.values())
    # connectivity: every road reaches a neighbor
    assert all(m.road_connections[r] for r in m.roads)


@pytest.mark.parametrize("mode", ["random", "road_constrained",
                                  "destination_oriented"])
def test_movement_modes_stay_in_bounds(mode):
    m = TrafficMap(seed=2).generate_grid_map(5, 5, cell_size=200.0)
    sim = VehicleSimulator(m, num_vehicles=30, movement_mode=mode, seed=3)
    sim.initialize_vehicles()
    for _ in range(50):
        sim.update_vehicles(0.5)
    w, h = m.size
    eps = 1.0
    for v in sim.vehicles.values():
        assert -eps <= v.position.x <= w + eps
        assert -eps <= v.position.y <= h + eps
        speed = math.hypot(v.velocity.x, v.velocity.y)
        assert speed <= sim.MAX_SPEED + 1e-6


def test_city_centered_distribution_skews():
    m = TrafficMap(seed=4).generate_grid_map(10, 10, cell_size=1000.0)
    sim = VehicleSimulator(m, num_vehicles=500,
                           distribution="city_centered", seed=5)
    sim.initialize_vehicles()
    in_city = 0
    for v in sim.vehicles.values():
        for c in m.cities.values():
            if v.position.distance_to(c.center) <= c.radius:
                in_city += 1
                break
    # 80% of placements are city draws (radius-bounded)
    assert in_city > 0.5 * 500


def test_road_constrained_rides_roads():
    m = TrafficMap(seed=6).generate_grid_map(4, 4, cell_size=250.0)
    sim = VehicleSimulator(m, num_vehicles=20,
                           movement_mode="road_constrained", seed=7)
    sim.initialize_vehicles()
    for _ in range(30):
        sim.update_vehicles(0.5)
    # every assigned vehicle sits near its road's line segment
    off_road = 0
    for vid, rid in sim.vehicle_roads.items():
        v = sim.vehicles[vid]
        r = m.roads[rid]
        dx, dy = r.direction()
        px = v.position.x - r.start.x
        py = v.position.y - r.start.y
        along = px * dx + py * dy
        perp = abs(-px * dy + py * dx)
        if perp > 5.0:
            off_road += 1
    assert off_road == 0


def test_simulator_scene_sink_roundtrip():
    cfg = tc.SystemConfig(num_objects=64,
                          world=WorldConfig(hi=(1000.0, 1000.0, 0.0)))
    from collide.api import Scene
    sc = Scene(cfg)
    m = TrafficMap(seed=8).generate_grid_map(2, 2, cell_size=500.0)
    sim = VehicleSimulator(m, num_vehicles=10, seed=9)
    sim.initialize_vehicles()
    sim.run(1.0, dt=0.5, sink=scene_sink(sc, sim))
    sc.flush()
    assert sc.stats()["num_alive"] == 10


def test_load_balancer_occupancy_and_rebalance():
    import jax
    from collide.sim import generate_fleet
    from collide.shard import (make_mesh, distribute_state, shard_slots,
                               LoadBalancer, shard_occupancy, imbalance)
    cfg = tc.SystemConfig(num_objects=400,
                          shard=ShardConfig(num_shards=8, slot_headroom=6.0),
                          sim=SimConfig(accel_change_prob=0.0))
    mesh = make_mesh(cfg)
    # skewed fleet: everything in the left quarter of the world
    fleet = generate_fleet(jax.random.key(0), cfg, distribution="uniform")
    import jax.numpy as jnp
    fleet = fleet.replace(pos=fleet.pos.at[:, 0].multiply(0.25))
    st = distribute_state(fleet, cfg, mesh)
    slots = shard_slots(cfg)
    occ = shard_occupancy(st, cfg, slots)
    assert occ.sum() == 400
    assert imbalance(occ) > 1.2          # heavily skewed

    lb = LoadBalancer(cfg, slots, check_every=1)
    assert lb.should_rebalance(st)
    st2, boundaries, _, _ = lb.rebalance(st, mesh)
    occ2 = shard_occupancy(st2, cfg, slots)
    assert occ2.sum() == 400             # conservation
    assert imbalance(occ2) < 1.2         # walls moved into the dense zone
    assert lb.stats["rebalances"] == 1


def test_quantile_boundaries_balance_counts():
    from collide.shard import quantile_boundaries
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(0, 100, 900),
                        rng.uniform(100, 1000, 100)])
    b = quantile_boundaries(x, 4, 0.0, 1000.0, min_width=10.0)
    assert b[0] == 0.0 and b[-1] == 1000.0
    counts = np.histogram(x, bins=b)[0]
    assert counts.max() <= 2.0 * counts.mean()   # far better than 900/4-skew
    assert (np.diff(b) >= 10.0 - 1e-6).all()


def test_state_transfer_between_nodes():
    async def go():
        broker = MessageBroker()
        await broker.start()
        a = StateTransferManager(broker, "node-a")
        b = StateTransferManager(broker, "node-b")
        box_a = {"v": 41}
        box_b = {"v": 0}
        a.register_provider("box", lambda: box_a, lambda s: box_a.update(s))
        b.register_provider("box", lambda: box_b, lambda s: box_b.update(s))
        got = await b.request_state("box", from_node="node-a", timeout=2.0)
        await broker.stop()
        return got, box_b
    got, box_b = run(go())
    assert got == {"v": 41} and box_b == {"v": 41}


def test_recovery_coordinator_executes_and_reports():
    async def go():
        broker = MessageBroker()
        await broker.start()
        co = RecoveryCoordinator(broker, "node-a")
        done = []
        co.register_handler("restore", lambda payload: done.append(payload))
        rid = await co.initiate_recovery("restore", {"step": 7})
        await asyncio.sleep(0.2)
        bad = await co.initiate_recovery("restore",
                                         {"boom": True})
        co.register_handler("explode",
                            lambda p: (_ for _ in ()).throw(ValueError("x")))
        rid2 = await co.initiate_recovery("explode")
        await asyncio.sleep(0.2)
        await broker.stop()
        return done, co.recoveries.get(rid), co.recoveries.get(rid2)
    done, st1, st2 = run(go())
    assert done and done[0] == {"step": 7}
    assert st1 == "completed"
    assert st2 == "failed"
