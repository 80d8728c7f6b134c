"""The service surface over a MESH: ShardedScene serves the same
RouteTable the single-device Scene does (ingest/locations/history/risks/
grids/alerts/detect/fault-injection), and CollisionSystem builds it when
the config asks for shards — the reference's 'distributed deployment'
story with the identical REST semantics."""
import numpy as np
import jax
import pytest

import collide as tc
from collide.core.config import ShardConfig, SimConfig, AlertConfig
from collide.core.types import LocationData, Position, Vector
from collide.api.sharded_scene import ShardedScene
from collide.api.routes import RouteTable


def make_scene(n=64, dx=4, dy=2):
    cfg = tc.SystemConfig(
        num_objects=n,
        sim=SimConfig(accel_change_prob=0.0),
        alerts=AlertConfig(max_scene_alerts=128),
        shard=ShardConfig(num_shards=dx, num_shards_y=dy))
    return ShardedScene(cfg, auto_rebalance=False)


def test_sharded_scene_route_surface():
    sc = make_scene()
    routes = RouteTable(sc)

    # ingest a converging pair via the ROUTE core (POST /vehicles/location)
    for vid, x, vx, heading in (("carA", 3100.0, 10.0, 0.0),
                                ("carB", 3180.0, -10.0, float(np.pi))):
        code, body = routes.handle("POST", "/vehicles/location", {
            "vehicle_id": vid,
            "position": {"x": x, "y": 500.0},
            "velocity": {"x": vx},
            "heading": heading}, {})
        assert code == 200, body

    # detection WITHOUT physics over the mesh (EarlyWarningSystem pattern)
    batch = sc.detect()
    # device batch dedups to i<j (DEVIATIONS #7); host manager re-expands
    assert int(np.asarray(batch.count).sum()) >= 1   # count is per-shard

    # GET /vehicles/{id}/location + /history
    code, body = routes.handle("GET", "/vehicles/carA/location", None, {})
    assert code == 200 and abs(
        body["data"]["position"]["x"] - 3100.0) < 1e-3
    code, body = routes.handle("GET", "/vehicles/carA/history", None, {})
    assert code == 200 and len(body["data"]) == 1

    # GET /vehicles/{id}/risks — the pair must be visible
    code, body = routes.handle("GET", "/vehicles/carA/risks", None, {})
    assert code == 200 and len(body["data"]) >= 1
    assert body["data"][0]["other_vehicle_id"] == "carB"

    # GET /alerts
    code, body = routes.handle("GET", "/alerts", None, {})
    assert code == 200 and len(body["data"]) >= 1

    # grid membership (GET /grids/{x}_{y}/vehicles)
    gx = int(3100.0 // sc.cfg.grid.cell_size)
    gy = int(500.0 // sc.cfg.grid.cell_size)
    code, body = routes.handle("GET", f"/grids/{gx}_{gy}/vehicles", None, {})
    assert code == 200 and "carA" in body["data"]

    # fault injection: drop half the fleet, sharding preserved
    code, body = routes.handle("POST", "/api/admin/inject-failure",
                               {"type": "drop_objects", "fraction": 0.5}, {})
    assert code == 200
    assert sc.stats()["num_alive"] == 1


def test_collision_system_builds_sharded_scene():
    from collide.system import CollisionSystem

    cfg = tc.SystemConfig(
        num_objects=32,
        sim=SimConfig(accel_change_prob=0.0),
        shard=ShardConfig(num_shards=8))
    sysm = CollisionSystem(cfg)
    assert isinstance(sysm.scene, ShardedScene)
    assert sysm.scene.ingested_count == 0
    sysm.scene.ingest(LocationData("v1", Position(100.0, 100.0, 0.0),
                                   Vector(5.0, 0, 0)))
    assert sysm.scene.ingested_count == 1
    sysm.scene.detect()       # boots the empty->ingested path end-to-end
    assert sysm.scene.stats()["num_alive"] == 1


def test_sharded_scene_route_surface_3d_mesh():
    """The same route surface over a 3D (x, y, z) device grid: ingest a
    converging pair that straddles the z wall, detect over the mesh, and
    read the risk back — the z-phase halo must carry the cross-wall
    candidate."""
    from collide.core.config import WorldConfig, GridConfig
    cfg = tc.SystemConfig(
        num_objects=64,
        world=WorldConfig(hi=(2000.0, 2000.0, 400.0)),
        grid=GridConfig(cell_size=100.0),
        sim=SimConfig(accel_change_prob=0.0),
        alerts=AlertConfig(max_scene_alerts=128),
        shard=ShardConfig(num_shards=2, num_shards_y=2, num_shards_z=2))
    sc = ShardedScene(cfg, auto_rebalance=False)
    routes = RouteTable(sc)
    # the pair straddles the z wall at 200 m, 30 m apart, converging in z
    # fast enough to clear risk_low (a slow vertical approach has zero
    # angle factor, so +-3 m/s scores ~0.27 — risks but no alert)
    for vid, z, vz in (("droneA", 185.0, 8.0), ("droneB", 215.0, -8.0)):
        code, body = routes.handle("POST", "/vehicles/location", {
            "vehicle_id": vid,
            "position": {"x": 500.0, "y": 500.0, "z": z},
            "velocity": {"z": vz},
            "heading": 0.0}, {})
        assert code == 200, body
    batch = sc.detect()
    assert int(np.asarray(batch.count).sum()) >= 1
    code, body = routes.handle("GET", "/vehicles/droneA/risks", None, {})
    assert code == 200 and len(body["data"]) >= 1
    assert body["data"][0]["other_vehicle_id"] == "droneB"
