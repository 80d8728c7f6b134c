"""Trajectory prediction model (reference CollisionPredictionModel,
collision_detection.py:525-877) + Scene integration."""
import numpy as np
import jax
import jax.numpy as jnp

import collide as tc
from collide.core.config import WorldConfig
from collide.core.state import state_from_numpy
from collide.core.types import LocationData, Position, Vector
from collide.detect import (empty_history, update_history,
                            classify_trajectories, needs_fallback,
                            predict_collisions)
from collide.index.grid import build_grid
from collide.api import Scene


def test_classification_matches_reference_classes():
    """stationary / constant_velocity / accelerating via 0.1 thresholds
    (reference :695-711)."""
    n = 3
    pos = np.array([[100, 100, 0], [200, 200, 0], [300, 300, 0]], np.float32)
    vel = np.array([[0, 0, 0], [10, 0, 0], [5, 0, 0]], np.float32)
    acc = np.array([[0, 0, 0], [0, 0, 0], [1, 0, 0]], np.float32)
    st = state_from_numpy(pos, vel, acc, np.zeros(n, np.float32),
                          np.full(n, 2.0, np.float32), np.zeros(n, np.int32))
    hist = empty_history(n)
    assert np.asarray(needs_fallback(hist)).all()
    for k in range(5):
        t = k * 0.5
        p = pos + vel * t + 0.5 * acc * t * t
        hist = update_history(hist, st.replace(pos=jnp.asarray(p)), t)
    assert not np.asarray(needs_fallback(hist)).any()
    assert np.asarray(classify_trajectories(hist)).tolist() == [0, 1, 2]


def test_predicted_catchup_pair():
    """A chaser catching a slow leader is predicted before plain detection
    would fire with high risk."""
    pos = np.array([[0, 0, 0], [60, 0, 0]], np.float32)
    vel = np.array([[10, 0, 0], [0.2, 0, 0]], np.float32)
    acc = np.zeros((2, 3), np.float32)
    st = state_from_numpy(pos, vel, acc, np.zeros(2, np.float32),
                          np.full(2, 2.0, np.float32), np.zeros(2, np.int32))
    cfg = tc.SystemConfig(num_objects=2,
                          world=WorldConfig(hi=(500.0, 500.0, 0.0)))
    hist = empty_history(2)
    for k in range(4):
        t = k * 0.5
        hist = update_history(
            hist, st.replace(pos=jnp.asarray(pos + vel * t)), t)
    index = build_grid(st.pos, st.alive, cfg)
    other, valid, risk, ttc, dist = predict_collisions(st, hist, index, cfg)
    v = np.asarray(valid)
    assert v[0].any() and v[1].any()
    r0 = np.asarray(risk)[0][v[0]]
    t0 = np.asarray(ttc)[0][v[0]]
    assert r0.max() > 0.3
    # closing 9.8 m/s from 60 m, safe 7 m -> ~5.4 s, quantized coarser
    assert 3.0 < t0.min() < 7.0


def test_scene_predict_feeds_alert_manager():
    cfg = tc.SystemConfig(num_objects=16,
                          world=WorldConfig(hi=(500.0, 500.0, 0.0)))
    sc = Scene(cfg)
    for k in range(4):
        t = k * 0.5
        sc.ingest(LocationData("chaser", Position(10 * t, 100, 0),
                               Vector(10, 0, 0)))
        sc.ingest(LocationData("slowpoke", Position(60 + 0.2 * t, 100, 0),
                               Vector(0.2, 0, 0)))
        sc.record_trajectories(dt=0.5)
    risks = sc.predict()
    assert risks and all(r.is_predicted for r in risks)
    pairs = {(r.vehicle_id, r.other_vehicle_id) for r in risks}
    assert ("chaser", "slowpoke") in pairs
    assert sc.alert_manager.get_stats()["active"] >= 1


def test_predict_merge_keeps_max_risk_per_pair():
    """The per-pair merge keeps one entry with the max risk
    (reference _merge_collision_risks, :848-865)."""
    pos = np.array([[0, 0, 0], [40, 0, 0]], np.float32)
    vel = np.array([[10, 0, 0], [1.0, 0, 0]], np.float32)
    acc = np.zeros((2, 3), np.float32)
    st = state_from_numpy(pos, vel, acc, np.zeros(2, np.float32),
                          np.full(2, 2.0, np.float32), np.zeros(2, np.int32))
    cfg = tc.SystemConfig(num_objects=2,
                          world=WorldConfig(hi=(500.0, 500.0, 0.0)))
    hist = empty_history(2)
    for k in range(3):
        t = k * 0.5
        hist = update_history(
            hist, st.replace(pos=jnp.asarray(pos + vel * t)), t)
    index = build_grid(st.pos, st.alive, cfg)
    other, valid, risk, ttc, dist = predict_collisions(st, hist, index, cfg)
    v = np.asarray(valid)[0]
    o = np.asarray(other)[0][v]
    # pair (0 -> 1) appears exactly once despite hits at many offsets
    assert (o == 1).sum() == 1


def test_scene_xla_predict_bucket_overflow_self_heals():
    """A predict-ONLY workload (record + predict, no step) on the XLA
    backend self-heals counted grid-bucket truncation: the overflowing
    call doubles cell_capacity and recompiles, and the healed call's
    risk set equals a generously-capacitied oracle Scene's."""
    from collide.core.config import (GridConfig, DetectionConfig,
                                     AlertConfig, SimConfig)

    n = 200
    rng = np.random.default_rng(7)
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = rng.uniform(420, 480, n)        # one dense cell
    pos[:, 1] = rng.uniform(420, 480, n)
    vel = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    vel[:, 2] = 0.0
    st = state_from_numpy(pos, vel, np.zeros((n, 3), np.float32),
                          np.zeros(n, np.float32),
                          np.full(n, 2.0, np.float32),
                          np.zeros(n, np.int32))

    def build(cap):
        cfg = tc.SystemConfig(
            num_objects=n, world=WorldConfig(hi=(1000.0, 1000.0, 0.0)),
            grid=GridConfig(cell_size=100.0, cell_capacity=cap),
            detect=DetectionConfig(mode="fast"),
            sim=SimConfig(accel_change_prob=0.0),
            alerts=AlertConfig(max_scene_alerts=512))
        sc = Scene(cfg)
        sc.adopt_fleet(st)
        for k in range(4):
            sc.record_trajectories(dt=0.5)
        return sc

    sc = build(4)                               # far too small
    sc.predict()                                # overflowing call: heals
    assert sc.regrows >= 1               # _grow_buckets fired
    for _ in range(6):                          # converge without tuning
        grown = sc.cfg.grid.cell_capacity
        risks = sc.predict()
        if sc.cfg.grid.cell_capacity == grown:
            break
    assert sc.cfg.grid.cell_capacity > 4
    oracle = build(n)                           # can never overflow
    want = {(r.vehicle_id, r.other_vehicle_id) for r in oracle.predict()}
    got = {(r.vehicle_id, r.other_vehicle_id) for r in risks}
    assert got == want


def test_scene_xla_predict_heal_oom_fallback():
    """When a fleet-exact capacity heal produces a program too big for
    device memory (JaxRuntimeError at execute), predict reverts to the
    last capacity that ran, records the ceiling so the heal is not
    re-attempted at that density, and still returns results (truncation
    stays counted). Simulated by planting a raising program in the
    predict cache with a heal in flight."""
    import jax as _jax
    from collide.core.config import GridConfig

    cfg = tc.SystemConfig(num_objects=8,
                          world=WorldConfig(hi=(500.0, 500.0, 0.0)),
                          grid=GridConfig(cell_size=100.0, cell_capacity=32))
    sc = Scene(cfg)
    for k in range(4):
        t = k * 0.5
        sc.ingest(LocationData("a", Position(10 * t, 100, 0),
                               Vector(10, 0, 0)))
        sc.ingest(LocationData("b", Position(60 + 0.2 * t, 100, 0),
                               Vector(0.2, 0, 0)))
        sc.record_trajectories(dt=0.5)

    def boom(*a, **k):
        raise _jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: hbm")

    sc._predict_cache[(10.0, 0.5)] = boom      # the "healed" program
    sc._predict_cap_prev = 8                   # heal was from capacity 8
    risks = sc.predict()
    assert sc.cfg.grid.cell_capacity == 8      # reverted
    assert sc._predict_heal_ceiling == 32      # remembered
    assert sc._predict_cap_prev is None
    pairs = {(r.vehicle_id, r.other_vehicle_id) for r in risks}
    assert ("a", "b") in pairs                 # retry produced results
