"""Scene API + REST surface + system integration (reference api.py surface,
collision_system.py integration — SURVEY.md §2.8/§2.9)."""
import asyncio

import numpy as np
import pytest

import collide as tc
from collide.core.config import WorldConfig
from collide.core.types import LocationData, Position, Vector
from collide.api import Scene


def small_scene(tmp_path=None, n=64):
    cfg = tc.SystemConfig(num_objects=n,
                          world=WorldConfig(hi=(500.0, 500.0, 0.0)))
    return Scene(cfg, checkpoint_dir=str(tmp_path) if tmp_path else None)


def converging(scene):
    scene.ingest(LocationData("carA", Position(100, 100, 0), Vector(10, 0, 0)))
    scene.ingest(LocationData("carB", Position(180, 100, 0), Vector(-10, 0, 0),
                              heading=np.pi))


def test_scene_ingest_detect_alerts(tmp_path):
    sc = small_scene(tmp_path)
    converging(sc)
    sc.detect()
    alerts = sc.alerts()
    assert len(alerts) == 1
    a = alerts[0]
    assert {a.vehicle_id, a.other_vehicle_id} == {"carA", "carB"}
    assert abs(a.time_to_collision - 3.7) < 1e-3      # (80-7)/20 -> 3.7 lattice
    assert a.priority == 2                             # ttc < 5 -> HIGH
    assert "carB" in a.message or "carA" in a.message


def test_scene_update_not_duplicate(tmp_path):
    """Re-ingesting the same vehicle updates its slot, not a new object."""
    sc = small_scene(tmp_path)
    converging(sc)
    sc.detect()
    sc.ingest(LocationData("carA", Position(110, 100, 0), Vector(10, 0, 0)))
    sc.flush()
    assert sc.stats()["num_alive"] == 2
    # alert got updated, not duplicated
    sc.detect()
    assert len(sc.alerts()) == 1
    assert sc.alerts()[0].time_to_collision < 3.7


def test_scene_query_and_history(tmp_path):
    sc = small_scene(tmp_path)
    converging(sc)
    sc.flush()
    ids = sc.query_radius((100, 100, 0), 100.0)
    assert set(ids) == {"carA", "carB"}
    assert sc.get_location("carA").position.x == 100
    sc.ingest(LocationData("carA", Position(105, 100, 0), Vector(10, 0, 0)))
    assert len(sc.get_history("carA")) == 2


def test_scene_checkpoint_resume(tmp_path):
    sc = small_scene(tmp_path)
    converging(sc)
    sc.flush()
    sc.save_checkpoint()
    sc.step(5)
    pos_after = np.asarray(sc.state.pos).copy()
    sc.restore_checkpoint()
    assert sc.step_count == 0
    assert sc.stats()["num_alive"] == 2
    assert not np.allclose(np.asarray(sc.state.pos), pos_after)
    assert sc._id_to_slot == {"carA": 0, "carB": 1}   # identity restored


def test_scene_capacity_guard():
    """Capacity exhaustion drops the excess report (logged) instead of
    poisoning the pending queue for every later flush."""
    sc = small_scene(n=2)
    converging(sc)
    sc.flush()
    sc.ingest(LocationData("carC", Position(1, 1, 0), Vector()))
    sc.flush()                                  # no raise
    assert sc.stats()["num_alive"] == 2         # carC dropped
    # the scene keeps working afterwards
    sc.ingest(LocationData("carA", Position(105, 100, 0), Vector(10, 0, 0)))
    sc.flush()
    assert sc.stats()["num_alive"] == 2


def test_rest_endpoints():
    """Drive the FastAPI app in-process via TestClient."""
    fastapi = pytest.importorskip("fastapi")
    from fastapi.testclient import TestClient
    from collide.api.rest import create_app

    sc = small_scene()
    app = create_app(sc)
    client = TestClient(app)

    assert client.get("/health").json()["success"]

    loc = {"vehicle_id": "carA", "position": {"x": 100, "y": 100, "z": 0},
           "velocity": {"x": 10, "y": 0, "z": 0}}
    loc2 = {"vehicle_id": "carB", "position": {"x": 180, "y": 100, "z": 0},
            "velocity": {"x": -10, "y": 0, "z": 0}, "heading": 3.14159}
    assert client.post("/vehicles/location", json=loc).json()["success"]
    assert client.post("/vehicles/location", json=loc2).json()["success"]

    assert client.post("/detect", json={}).json()["data"]["num_alerts"] == 1
    alerts = client.get("/alerts").json()["data"]
    assert len(alerts) == 1
    aid = alerts[0]["id"]
    assert client.post(f"/alerts/{aid}/acknowledge").json()["success"]

    r = client.get("/vehicles/carA/location").json()
    assert r["success"] and r["data"]["position"]["x"] == 100.0
    assert client.get("/vehicles/carA/history").json()["success"]
    assert client.get("/vehicles/nope/location").json()["success"] is False

    # grid query: carA at (100,100) -> cell 1_1 for 100 m cells
    r = client.get("/grids/1_1/vehicles").json()
    assert "carA" in r["data"]
    assert client.get("/grids/zzz/vehicles").json()["success"] is False

    s = client.get("/stats").json()["data"]
    assert s["num_alive"] == 2

    r = client.post("/api/admin/inject-failure",
                    json={"type": "drop_objects", "fraction": 0.5}).json()
    assert r["data"]["killed"] == 1
    assert client.get("/stats").json()["data"]["num_alive"] == 1


def test_stdlib_http_server():
    """Drive the dependency-free HTTP server over a real socket."""
    import json
    import urllib.request
    from collide.api.stdlib_server import SceneHTTPServer

    sc = small_scene()
    srv = SceneHTTPServer(sc, port=0)
    port = srv.start()
    base = f"http://127.0.0.1:{port}"

    def call(method, path, body=None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(base + path, data=data, method=method,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        code, r = call("GET", "/health")
        assert code == 200 and r["success"]
        call("POST", "/vehicles/location",
             {"vehicle_id": "carA", "position": {"x": 100, "y": 100},
              "velocity": {"x": 10}})
        call("POST", "/vehicles/location",
             {"vehicle_id": "carB", "position": {"x": 180, "y": 100},
              "velocity": {"x": -10}, "heading": 3.14159})
        code, r = call("POST", "/detect", {})
        assert r["data"]["num_alerts"] == 1
        code, r = call("GET", "/alerts")
        assert len(r["data"]) == 1
        aid = r["data"][0]["id"]
        code, r = call("POST", f"/alerts/{aid}/acknowledge", {})
        assert r["success"]
        code, r = call("GET", "/vehicles/carA/location")
        assert r["data"]["position"]["x"] == 100.0
        code, r = call("GET", "/vehicles/nope/location")
        assert code == 404 and not r["success"]
        code, r = call("POST", "/vehicles/location", {"bogus": True})
        assert code == 400
        code, r = call("GET", "/stats")
        assert r["data"]["num_alive"] == 2
    finally:
        srv.stop()


def test_collision_system_integration(tmp_path):
    """Boot the full system, ingest, let the loops run, read stats, stop.
    (The reference's equivalent module could not even import — SURVEY.md
    §2.9.)"""
    from collide.system import CollisionSystem

    async def go():
        sys_ = CollisionSystem(
            tc.SystemConfig(num_objects=32,
                            world=WorldConfig(hi=(500.0, 500.0, 0.0))),
            node_id="it-node",
            checkpoint_dir=str(tmp_path),
            detection_hz=20.0)
        await sys_.start()
        sys_.scene.ingest(LocationData("carA", Position(100, 100, 0),
                                       Vector(10, 0, 0)))
        sys_.scene.ingest(LocationData("carB", Position(180, 100, 0),
                                       Vector(-10, 0, 0), heading=np.pi))
        # first sweep includes jit compile — poll instead of a fixed sleep
        for _ in range(600):
            if sys_.scene.alert_manager.stats["created"] > 0:
                break
            await asyncio.sleep(0.1)
        # single-node election also needs scheduler time under a loaded
        # box (flaked twice at 13-min-suite load); poll it too
        for _ in range(300):
            if sys_.election.is_current_leader():
                break
            await asyncio.sleep(0.1)
        stats = sys_.get_stats()
        alerts = sys_.scene.alerts()
        await sys_.stop()
        return stats, alerts

    stats, alerts = asyncio.new_event_loop().run_until_complete(go())
    assert stats["scene"]["num_alive"] == 2
    assert stats["is_leader"]                      # single-node -> leader
    assert len(alerts) == 1
    assert stats["broker"]["published"] > 0        # alert egress flowed


def test_api_client_roundtrip():
    """ApiClient (stdlib fallback) against the stdlib server over a real
    socket — the reference ApiClient surface (api.py:394-598)."""
    from collide.api.rest import ApiClient
    from collide.api.stdlib_server import SceneHTTPServer

    sc = small_scene()
    srv = SceneHTTPServer(sc, port=0)
    port = srv.start()
    client = ApiClient(f"http://127.0.0.1:{port}")

    async def go():
        assert (await client.health())["success"]
        r = await client.update_location(
            {"vehicle_id": "carA", "position": {"x": 100, "y": 100},
             "velocity": {"x": 10}})
        assert r["success"]
        await client.update_location(
            {"vehicle_id": "carB", "position": {"x": 180, "y": 100},
             "velocity": {"x": -10}, "heading": 3.14159})
        loc = await client.get_location("carA")
        assert loc["data"]["position"]["x"] == 100.0
        assert (await client.get_history("carA"))["success"]
        al = await client.alerts()
        stats = await client.stats()
        assert stats["data"]["num_alive"] in (0, 2)   # pre/post flush
        return True

    try:
        assert asyncio.new_event_loop().run_until_complete(go())
    finally:
        srv.stop()


def test_route_core_grid_boundary_exact():
    """Exact cell membership for an object just across the
    cell boundary. The round-1 FastAPI handler used a circumradius
    query_radius(center, cs*0.7071) which INCLUDED neighbor-cell residents;
    the shared route core must not."""
    from collide.api.routes import RouteTable

    sc = small_scene()
    # 100 m cells: carA in cell (1,1), carB 2 m away but in cell (2,1)
    sc.ingest(LocationData("carA", Position(199.0, 150.0, 0), Vector()))
    sc.ingest(LocationData("carB", Position(201.0, 150.0, 0), Vector()))
    routes = RouteTable(sc)

    code, r = routes.handle("GET", "/grids/1_1/vehicles", None, {})
    assert code == 200 and r["data"] == ["carA"]
    code, r = routes.handle("GET", "/grids/2_1/vehicles", None, {})
    assert code == 200 and r["data"] == ["carB"]
    # and it agrees with the Scene's own exact membership
    assert r["data"] == sc.grid_vehicles(2, 1)
    code, r = routes.handle("GET", "/grids/zzz/vehicles", None, {})
    assert code == 400


def test_stdlib_server_uses_shared_route_core():
    """Both transports serve the SAME handlers by construction: the stdlib
    server delegates to api/routes.RouteTable (and so does the FastAPI app),
    so the round-1 divergence class is structurally gone."""
    from collide.api.routes import RouteTable
    from collide.api.stdlib_server import SceneHTTPServer

    sc = small_scene()
    srv = SceneHTTPServer(sc, port=0)
    assert isinstance(srv.routes, RouteTable)
    sc.ingest(LocationData("carA", Position(110.0, 110.0, 0), Vector()))
    for method, path in [("GET", "/health"), ("GET", "/stats"),
                         ("GET", "/grids/1_1/vehicles"),
                         ("GET", "/vehicles/carA/location"),
                         ("GET", "/api/collision/metrics")]:
        code_s, body_s = srv.handle(method, path, None, {})
        code_r, body_r = srv.routes.handle(method, path, None, {})
        assert code_s == code_r
        assert body_s.keys() == body_r.keys()


def test_fault_injection_reference_surface():
    """The reference FailureInjector's full client surface
    (load_generator.py:748-865) round-trips against the stdlib server:
    node_failure, network_partition, high_load, slow_response, plus the
    separate POST /api/admin/reset-failures endpoint."""
    import json
    import time as _t
    import urllib.request

    sc = small_scene()
    from collide.api.stdlib_server import SceneHTTPServer
    srv = SceneHTTPServer(sc, port=0)
    port = srv.start()
    base = f"http://127.0.0.1:{port}"

    def post(path, body=None):
        req = urllib.request.Request(
            base + path, method="POST",
            data=json.dumps(body or {}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())

    def get(path):
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return json.loads(r.read())

    try:
        inj = "/api/admin/inject-failure"
        assert post(inj, {"type": "node_failure", "node_id": "n1"})[0] == 200
        assert post(inj, {"type": "network_partition",
                          "node_ids": ["n2", "n3"]})[0] == 200
        assert post(inj, {"type": "high_load", "duration": 1})[0] == 200
        st = get("/stats")["data"]["faults"]
        assert st["partitioned_nodes"] == ["n2", "n3"]
        assert st["injected_total"] == 3

        # slow_response measurably delays requests
        assert post(inj, {"type": "slow_response", "latency": 150,
                          "duration": 5})[0] == 200
        t0 = _t.time()
        get("/health")
        assert _t.time() - t0 >= 0.12

        # the reference's separate reset endpoint
        assert post("/api/admin/reset-failures")[0] == 200
        t0 = _t.time()
        get("/health")
        assert _t.time() - t0 < 0.1
        assert get("/stats")["data"]["faults"]["partitioned_nodes"] == []
    finally:
        srv.stop()


def test_scene_xla_bucket_overflow_self_heals():
    """Counted grid-bucket overflow (objects beyond cell_capacity dropped from their bucket's
    candidate gather) doubles cell_capacity and recompiles, with zero
    manual tuning — within a few steps the overflow counter returns to 0."""
    import numpy as np
    from collide.core.state import state_from_numpy
    from collide.core.config import (GridConfig, DetectionConfig,
                                     AlertConfig, SimConfig)

    n = 300
    cfg = tc.SystemConfig(
        num_objects=n, world=WorldConfig(hi=(1000.0, 1000.0, 0.0)),
        grid=GridConfig(cell_size=100.0, cell_capacity=4),   # far too small
        detect=DetectionConfig(mode="fast"),
        sim=SimConfig(accel_change_prob=0.0),
        alerts=AlertConfig(max_scene_alerts=64))
    rng = np.random.default_rng(3)
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = rng.uniform(400, 500, n)    # one dense cell
    pos[:, 1] = rng.uniform(400, 500, n)
    st = state_from_numpy(pos, np.zeros((n, 3), np.float32),
                          np.zeros((n, 3), np.float32),
                          np.zeros(n, np.float32),
                          np.full(n, 2.0, np.float32),
                          np.zeros(n, np.int32))
    sc = Scene(cfg)
    sc.adopt_fleet(st)
    out = sc.step()
    assert int(out.overflow) > 0
    assert sc.regrows >= 1          # the bucket heal fired
    for _ in range(8):
        out = sc.step()
        if int(out.overflow) == 0:
            break
    assert int(out.overflow) == 0
    assert sc.cfg.grid.cell_capacity > 4


def test_scene_survivor_overflow_self_heals():
    """Precise-mode stage-2 survivors beyond the static survivor cap are
    counted (alert_overflow) and self-heal: the cap doubles and the step
    recompiles until the certificate is 0 — and the healed step's alert
    list equals an ample-cap run's on the same fleet and key."""
    import jax
    import numpy as np
    from collide.core.config import (DetectionConfig, AlertConfig,
                                     SimConfig)
    from collide.sim import generate_fleet

    cfg = tc.SystemConfig(
        num_objects=400, world=WorldConfig(hi=(1500.0, 1500.0, 0.0)),
        detect=DetectionConfig(mode="precise", precise_survivor_cap=16),
        sim=SimConfig(accel_change_prob=0.0),
        alerts=AlertConfig(max_scene_alerts=1024))
    sc = Scene(cfg, state=generate_fleet(jax.random.key(4), cfg))
    out = sc.step()
    assert int(out.alert_overflow) > 0
    for _ in range(8):
        out = sc.step()
        if int(out.alert_overflow) == 0:
            break
    assert int(out.alert_overflow) == 0 and sc.regrows >= 1
    assert sc.cfg.survivor_cap > 16

    ample = cfg.replace(detect=DetectionConfig(mode="precise"))
    ref = Scene(ample, state=generate_fleet(jax.random.key(4), ample))
    for _ in range(sc.step_count):
        want = ref.step()

    def pairs(o):
        v = np.asarray(o.alerts.valid)
        return set(zip(np.asarray(o.alerts.vehicle_oid)[v].tolist(),
                       np.asarray(o.alerts.other_oid)[v].tolist()))
    assert pairs(out) == pairs(want) and pairs(out)


def test_scene_step_zero_rejected():
    """step(0) is a caller error; the route core turns it into HTTP 400."""
    from collide.api.routes import RouteTable

    sc = small_scene()
    with pytest.raises(ValueError):
        sc.step(0)
    rt = RouteTable(sc)
    status, body = rt.handle("POST", "/step", {"steps": 0}, {})
    assert status == 400
