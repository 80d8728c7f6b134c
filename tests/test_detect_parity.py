"""Golden parity: the vectorized 4-stage pipeline vs the NumPy oracle
(literal reference math, collision_detection.py:110-513)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from collide import SystemConfig, make_detect
from collide.core.config import WorldConfig, GridConfig, DetectionConfig
from collide.core.state import state_from_numpy
from tests.oracle import oracle_detect_all


def make_fleet(rng, n=120, world=1000.0, speed=15.0, with_accel=True):
    pos = rng.uniform(0, world, (n, 3)).astype(np.float32)
    pos[:, 2] = 0.0
    heading = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    spd = rng.uniform(5, speed, n).astype(np.float32)
    vel = np.stack([spd * np.cos(heading), spd * np.sin(heading),
                    np.zeros(n)], -1).astype(np.float32)
    acc = (rng.uniform(-1, 1, (n, 3)).astype(np.float32)
           if with_accel else np.zeros((n, 3), np.float32))
    acc[:, 2] = 0.0
    otype = rng.integers(0, 4, n).astype(np.int32)
    size = np.array([2.0, 4.0, 5.0, 1.0], np.float32)[otype]
    return pos, vel, acc, heading, size, otype


def small_cfg(n, world=1000.0, mode="precise", cap=64, convention="physical"):
    return SystemConfig(
        num_objects=n,
        world=WorldConfig(hi=(world, world, 0.0)),
        grid=GridConfig(cell_size=100.0, cell_capacity=cap),
        detect=DetectionConfig(mode=mode, convention=convention),
    )


def run_pipeline(cfg, pos, vel, acc, heading, size, otype):
    state = state_from_numpy(pos, vel, acc, heading, size, otype)
    pairs = make_detect(cfg)(state)
    found = {}
    o = np.asarray(pairs.other)
    v = np.asarray(pairs.valid)
    r = np.asarray(pairs.risk)
    t = np.asarray(pairs.ttc)
    d = np.asarray(pairs.distance)
    n, k = v.shape
    for i in range(n):
        for s in range(k):
            if v[i, s]:
                key = (i, int(o[i, s]))
                assert key not in found, f"duplicate candidate pair {key}"
                found[key] = (float(r[i, s]), float(t[i, s]), float(d[i, s]))
    return found


@pytest.mark.parametrize("with_accel", [False, True])
@pytest.mark.parametrize("convention", ["physical", "reference"])
def test_parity_vs_oracle(rng, with_accel, convention):
    pos, vel, acc, heading, size, otype = make_fleet(
        rng, n=120, with_accel=with_accel)
    cfg = small_cfg(120, convention=convention)
    got = run_pipeline(cfg, pos, vel, acc, heading, size, otype)
    want = oracle_detect_all(pos, vel, acc, size, heading, otype,
                             convention=convention)

    # Pair sets must match except right at filter boundaries (f32 ordering).
    only_got = set(got) - set(want)
    only_want = set(want) - set(got)
    assert not only_got, f"pipeline found extra pairs: {only_got}"
    assert not only_want, f"pipeline missed pairs: {only_want}"

    for key, (r0, t0, d0) in want.items():
        r1, t1, d1 = got[key]
        assert abs(t1 - t0) < 1e-5, (key, t0, t1)       # same sample lattice
        assert abs(r1 - r0) < 2e-3, (key, r0, r1)
        assert abs(d1 - d0) < 1e-2, (key, d0, d1)


def test_parity_symmetric_pairs(rng):
    """Risk math is symmetric: (i,j) and (j,i) produce identical values."""
    pos, vel, acc, heading, size, otype = make_fleet(rng, n=80)
    cfg = small_cfg(80)
    got = run_pipeline(cfg, pos, vel, acc, heading, size, otype)
    for (i, j), (r, t, d) in got.items():
        assert (j, i) in got
        r2, t2, d2 = got[(j, i)]
        assert abs(r - r2) < 1e-6 and abs(t - t2) < 1e-6


def test_no_self_pairs(rng):
    pos, vel, acc, heading, size, otype = make_fleet(rng, n=60)
    cfg = small_cfg(60)
    got = run_pipeline(cfg, pos, vel, acc, heading, size, otype)
    assert all(i != j for i, j in got)


def test_fast_mode_matches_precise_at_zero_accel(rng):
    """'fast' (closed-form) and 'precise' (sampled) agree when accel = 0."""
    pos, vel, acc, heading, size, otype = make_fleet(
        rng, n=150, with_accel=False)
    got_p = run_pipeline(small_cfg(150, mode="precise"),
                         pos, vel, acc, heading, size, otype)
    got_f = run_pipeline(small_cfg(150, mode="fast"),
                         pos, vel, acc, heading, size, otype)
    assert set(got_p) == set(got_f)
    for key in got_p:
        rp, tp, dp = got_p[key]
        rf, tf, df = got_f[key]
        assert abs(tp - tf) < 1e-3, (key, tp, tf)
        assert abs(rp - rf) < 5e-3, (key, rp, rf)


def test_head_on_collision_detected():
    """Two cars driving at each other at 10 m/s from 100 m apart must alert
    with TTC ~ (100 - safe)/20."""
    pos = np.array([[0, 0, 0], [100, 0, 0]], np.float32)
    vel = np.array([[10, 0, 0], [-10, 0, 0]], np.float32)
    acc = np.zeros((2, 3), np.float32)
    heading = np.array([0.0, np.pi], np.float32)
    size = np.array([2.0, 2.0], np.float32)
    otype = np.zeros(2, np.int32)
    cfg = small_cfg(2, world=200.0)
    got = run_pipeline(cfg, pos, vel, acc, heading, size, otype)
    assert (0, 1) in got and (1, 0) in got
    r, t, d = got[(0, 1)]
    # safe = (2+2)/2 + 5 = 7 m; crossing at (100-7)/20 = 4.65 s -> sample 4.7
    assert abs(t - 4.7) < 1e-5
    assert r > 0.3


def test_diverging_pair_ignored():
    pos = np.array([[0, 0, 0], [20, 0, 0]], np.float32)
    vel = np.array([[-10, 0, 0], [10, 0, 0]], np.float32)
    acc = np.zeros((2, 3), np.float32)
    cfg = small_cfg(2, world=200.0)
    got = run_pipeline(cfg, pos, vel, acc, np.zeros(2, np.float32),
                       np.full(2, 2.0, np.float32), np.zeros(2, np.int32))
    assert not got


def test_stationary_overlapping_pair_ignored():
    """rel_speed < 0.1 is filtered even if currently overlapping
    (reference stage-2 semantics, collision_detection.py:267-269)."""
    pos = np.array([[0, 0, 0], [1, 0, 0]], np.float32)
    vel = np.zeros((2, 3), np.float32)
    acc = np.zeros((2, 3), np.float32)
    cfg = small_cfg(2, world=200.0)
    got = run_pipeline(cfg, pos, vel, acc, np.zeros(2, np.float32),
                       np.full(2, 2.0, np.float32), np.zeros(2, np.int32))
    assert not got


def test_parity_city_skew_fleet():
    """Golden parity on the reference's own 80/20 city-skew distribution
    (optimized_performance_test.py:92-104) — the dense-city case SURVEY.md
    flags as the broad-phase capacity hazard."""
    import jax
    from collide.sim import generate_fleet

    cfg = SystemConfig(
        num_objects=300,
        world=WorldConfig(hi=(10000.0, 10000.0, 0.0)),
        grid=GridConfig(cell_size=100.0, cell_capacity=64),
        detect=DetectionConfig(mode="precise"),
    )
    st = generate_fleet(jax.random.key(42), cfg, distribution="city_skew")
    import numpy as np
    pos = np.asarray(st.pos)
    vel = np.asarray(st.vel)
    acc = np.asarray(st.acc)
    heading = np.asarray(st.heading)
    size = np.asarray(st.size)
    otype = np.asarray(st.otype)

    got = run_pipeline(cfg, pos, vel, acc, heading, size, otype)
    want = oracle_detect_all(pos, vel, acc, size, heading, otype)
    assert set(got) == set(want), (
        f"missing {set(want) - set(got)}, extra {set(got) - set(want)}")
    for key, (r0, t0, d0) in want.items():
        r1, t1, d1 = got[key]
        assert abs(t1 - t0) < 1e-5 and abs(r1 - r0) < 2e-3


def test_golden_alert_snapshot():
    """Frozen alert output for the 1000-vehicle city-skew scene (generated
    from the oracle-verified implementation; guards refactors across
    rounds). Regenerate deliberately if semantics change on purpose."""
    import json
    import os
    import jax
    from collide.core.config import AlertConfig
    from collide.sim import generate_fleet
    from collide import make_step

    path = os.path.join(os.path.dirname(__file__), "golden",
                        "alerts_1000_cityskew.json")
    with open(path) as f:
        golden = json.load(f)

    cfg = SystemConfig(num_objects=1000,
                       detect=DetectionConfig(mode="precise"),
                       alerts=AlertConfig(max_scene_alerts=256))
    st = generate_fleet(jax.random.key(42), cfg)
    _, out = make_step(cfg, donate=False)(st, jax.random.key(7))
    assert int(out.num_risks) == golden["num_risks"]
    v = np.asarray(out.alerts.valid)
    got = sorted(
        ({"vehicle": int(a), "other": int(b),
          "risk": round(float(r), 5), "ttc": round(float(t), 4),
          "priority": int(p)}
         for a, b, r, t, p in zip(
             np.asarray(out.alerts.vehicle_oid)[v],
             np.asarray(out.alerts.other_oid)[v],
             np.asarray(out.alerts.risk)[v],
             np.asarray(out.alerts.ttc)[v],
             np.asarray(out.alerts.priority)[v])),
        key=lambda x: (x["vehicle"], x["other"]))
    want = golden["alerts"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["vehicle"] == w["vehicle"] and g["other"] == w["other"]
        assert abs(g["risk"] - w["risk"]) < 1e-4
        assert abs(g["ttc"] - w["ttc"]) < 1e-3
        assert g["priority"] == w["priority"]
