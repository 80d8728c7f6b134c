"""step_pipelined: one-behind serving (dispatch step n, consume step n-1
while the device works). Outputs are bit-identical to step() — same
compiled program, same key schedule — every step's alerts reach the
AlertManager (one step late), and the capacity self-heal fires once per
capacity generation even with two in-flight outputs of the same
undersized program."""
import numpy as np
import pytest
import jax

import collide as tc
from collide.core.config import (WorldConfig, GridConfig,
                                 DetectionConfig, SimConfig)
from collide.core.state import state_from_numpy
from collide.sim import generate_fleet


def mk_cfg(n=400):
    return tc.SystemConfig(
        num_objects=n, world=WorldConfig(hi=(2000.0, 2000.0, 0.0)),
        grid=GridConfig(cell_size=100.0),
        detect=DetectionConfig(mode="fast"))


def pset(out):
    v = np.asarray(out.alerts.valid).ravel()
    a = np.asarray(out.alerts.vehicle_oid).ravel()[v]
    b = np.asarray(out.alerts.other_oid).ravel()[v]
    return {(int(x), int(y)) for x, y in zip(a, b)}


def test_pipelined_matches_step_sequence():
    from collide.api import Scene
    cfg = mk_cfg()
    sc_a = Scene(cfg, state=generate_fleet(jax.random.key(3), cfg))
    sc_b = Scene(cfg, state=generate_fleet(jax.random.key(3), cfg))
    outs_a = [sc_a.step() for _ in range(5)]
    outs_b = [sc_b.step_pipelined() for _ in range(5)]
    outs_b.append(sc_b.pipeline_drain())
    assert outs_b[0] is None                    # nothing pending yet
    assert sc_a.step_count == sc_b.step_count == 5
    for oa, ob in zip(outs_a, outs_b[1:]):
        assert int(oa.num_risks) == int(ob.num_risks)
        assert pset(oa) == pset(ob)
    # every step's alerts reached the manager: identical lifecycle state
    assert sc_a.alert_manager.get_stats() == sc_b.alert_manager.get_stats()
    # drained pipeline: a second drain is a no-op
    assert sc_b.pipeline_drain() is None


def test_pipelined_regrows_once_per_capacity_generation():
    """Two in-flight outputs produced by the same undersized grid buckets
    must trigger ONE regrow (the guard compares the capacity at dispatch),
    not double cell_capacity twice."""
    from collide.api import Scene
    n = 24
    cfg = mk_cfg(n)
    rng = np.random.default_rng(0)
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = 510.0 + rng.uniform(0, 80, n)   # all in ~one cell
    pos[:, 1] = 510.0 + rng.uniform(0, 80, n)
    fleet = state_from_numpy(pos, np.zeros((n, 3), np.float32),
                             np.zeros((n, 3), np.float32),
                             np.zeros(n, np.float32),
                             np.full(n, 2.0, np.float32),
                             np.zeros(n, np.int32))
    sc = Scene(cfg, state=fleet)                # 24 in one 16-slot bucket
    assert sc.step_pipelined() is None          # s1 dispatched @16
    o1 = sc.step_pipelined()                    # s2 dispatched @16; s1 consumed
    assert int(o1.overflow) > 0
    assert sc.cfg.grid.cell_capacity == 32      # one doubling
    o2 = sc.pipeline_drain()                    # s2 consumed: same generation
    assert int(o2.overflow) > 0
    assert sc.cfg.grid.cell_capacity == 32      # guard skipped the re-double
    out = sc.step()                             # first step @32: complete
    assert int(out.overflow) == 0


def test_sharded_pipelined_matches_step_sequence():
    """ShardedScene.step_pipelined == one-behind of ShardedScene.step on
    the 4-shard mesh: same risks, same alert lifecycle, same drop
    accounting."""
    from collide.api import ShardedScene
    from collide.core.config import ShardConfig
    cfg = mk_cfg(256).replace(shard=ShardConfig(num_shards=4))
    a = ShardedScene(cfg, fleet=generate_fleet(jax.random.key(7), cfg),
                     auto_rebalance=False)
    b = ShardedScene(cfg, fleet=generate_fleet(jax.random.key(7), cfg),
                     auto_rebalance=False)
    outs_a = [a.step() for _ in range(4)]
    outs_b = [b.step_pipelined() for _ in range(4)]
    outs_b.append(b.pipeline_drain())
    assert outs_b[0] is None
    for oa, ob in zip(outs_a, outs_b[1:]):
        assert int(oa.num_risks) == int(ob.num_risks)
    assert a.alert_manager.get_stats() == b.alert_manager.get_stats()
    assert a.dropped_total == b.dropped_total
    assert a.step_count == b.step_count == 4


def test_rest_step_route_over_sharded_scene():
    """POST /step and /detect must serve ShardedScene outputs, whose
    alerts.count / max_risk are PER-SHARD arrays (latent until now: the
    route scalar-converted them and raised on any mesh-backed service;
    found by an end-to-end drive, fixed with np reductions). Covers
    pipelined=true on the mesh too."""
    from collide.api import ShardedScene
    from collide.api.routes import RouteTable
    from collide.core.config import ShardConfig
    cfg = mk_cfg(256).replace(shard=ShardConfig(num_shards=4))
    sc = ShardedScene(cfg, fleet=generate_fleet(jax.random.key(7), cfg),
                      auto_rebalance=False)
    routes = RouteTable(sc)
    code, r = routes.handle("POST", "/step", {}, {})
    assert code == 200 and r["data"]["num_alerts"] >= 0
    assert isinstance(r["data"]["max_risk"], float)
    code, r = routes.handle("POST", "/detect", {}, {})
    assert code == 200 and r["data"]["num_alerts"] >= 0
    code, r = routes.handle("POST", "/step", {"pipelined": True}, {})
    assert code == 200          # mesh scenes support pipelined serving
    sc.pipeline_drain()


def test_rest_step_route_pipelined_param():
    """POST /step {'pipelined': true} rides Scene.step_pipelined through
    the shared route core: the first call reports pending (nothing
    consumed yet), later calls describe the one-behind step."""
    from collide.api import Scene
    from collide.api.routes import RouteTable

    cfg = mk_cfg(64)
    sc = Scene(cfg, state=generate_fleet(jax.random.key(2), cfg))
    routes = RouteTable(sc)
    code, r = routes.handle("POST", "/step", {"pipelined": True}, {})
    assert code == 200 and r["data"]["pipelined_pending"] is True
    assert r["data"]["step_count"] == 1
    code, r = routes.handle("POST", "/step", {"steps": 2,
                                              "pipelined": True}, {})
    assert code == 200 and r["data"]["step_count"] == 3
    assert "num_risks" in r["data"]                # one-behind output
    assert sc.pipeline_drain() is not None         # step 3 still pending


def test_mixing_modes_drains_first():
    from collide.api import Scene
    cfg = mk_cfg(128)
    sc = Scene(cfg, state=generate_fleet(jax.random.key(1), cfg))
    assert sc.step_pipelined() is None
    assert sc._pipe is not None
    sc.step()                                   # drains s1, then steps s2
    assert sc._pipe is None
    assert sc.step_count == 2
    sc.step_pipelined()
    assert sc.detect() is not None              # detect() also drains
    assert sc._pipe is None
