"""Alert extraction: thresholds, priority rules, top-k ordering
(reference warning_system.py:18-27, 273-274, 287-311)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from collide import SystemConfig, make_step
from collide.core.config import (WorldConfig, GridConfig,
                                 DetectionConfig, AlertConfig)
from collide.core.state import state_from_numpy
from collide.engine import make_detect
from collide.alerts.extract import extract_alerts, compute_priority
from tests.oracle import oracle_priority


def test_priority_rules_match_oracle():
    cfg = SystemConfig()
    risks = jnp.asarray(np.linspace(0, 1, 21), jnp.float32)
    ttcs = jnp.asarray([0.0, 1.0, 2.9, 3.0, 4.9, 5.0, 7.0, 10.0], jnp.float32)
    r, t = jnp.meshgrid(risks, ttcs)
    got = np.asarray(compute_priority(r.ravel(), t.ravel(), cfg))
    want = [oracle_priority(float(a), float(b))
            for a, b in zip(np.asarray(r).ravel(), np.asarray(t).ravel())]
    assert got.tolist() == want


def _converging_fleet(n_pairs):
    """n_pairs head-on pairs, spaced far apart, with varied closing speeds
    so risks differ."""
    n = 2 * n_pairs
    pos = np.zeros((n, 3), np.float32)
    vel = np.zeros((n, 3), np.float32)
    heading = np.zeros(n, np.float32)
    for p in range(n_pairs):
        y = 200.0 + 500.0 * p
        speed = 5.0 + 2.0 * p
        pos[2 * p] = [100.0, y, 0.0]
        pos[2 * p + 1] = [180.0, y, 0.0]
        vel[2 * p] = [speed, 0, 0]
        vel[2 * p + 1] = [-speed, 0, 0]
        heading[2 * p + 1] = np.pi
    size = np.full(n, 2.0, np.float32)
    otype = np.zeros(n, np.int32)
    acc = np.zeros((n, 3), np.float32)
    return pos, vel, acc, heading, size, otype


def test_alert_extraction_end_to_end():
    n_pairs = 6
    pos, vel, acc, heading, size, otype = _converging_fleet(n_pairs)
    n = len(pos)
    world = 4000.0
    cfg = SystemConfig(
        num_objects=n,
        world=WorldConfig(hi=(world, world, 0.0)),
        grid=GridConfig(cell_size=100.0, cell_capacity=16),
        alerts=AlertConfig(max_scene_alerts=32),
    )
    state = state_from_numpy(pos, vel, acc, heading, size, otype)
    pairs = make_detect(cfg)(state)
    alerts = jax.jit(lambda s, p: extract_alerts(s, p, cfg))(state, pairs)

    count = int(alerts.count)
    valid = np.asarray(alerts.valid)
    assert count == valid.sum()
    risks = np.asarray(alerts.risk)[:count]
    prios = np.asarray(alerts.priority)[:count]
    ttcs = np.asarray(alerts.ttc)[:count]

    # every alert >= low threshold
    assert (risks >= cfg.alerts.risk_low - 1e-6).all()
    # sorted by (priority, risk) descending
    keys = prios * 2.0 + risks
    assert (np.diff(keys) <= 1e-6).all()
    # priorities consistent with the rules
    for r, t, p in zip(risks, ttcs, prios):
        assert p == oracle_priority(float(r), float(t))
    # pair-deduplicated: each unordered pair appears once
    seen = set()
    vo = np.asarray(alerts.vehicle_oid)[:count]
    oo = np.asarray(alerts.other_oid)[:count]
    for a, b in zip(vo, oo):
        assert a < b
        assert (a, b) not in seen
        seen.add((a, b))
    # the fast closers must alert
    assert count >= 1


def test_scene_topk_truncates_lowest():
    n_pairs = 6
    pos, vel, acc, heading, size, otype = _converging_fleet(n_pairs)
    n = len(pos)
    cfg_big = SystemConfig(
        num_objects=n, world=WorldConfig(hi=(4000.0, 4000.0, 0.0)),
        alerts=AlertConfig(max_scene_alerts=32))
    cfg_small = cfg_big.replace(alerts=AlertConfig(max_scene_alerts=2))
    state = state_from_numpy(pos, vel, acc, heading, size, otype)
    pa = make_detect(cfg_big)(state)
    big = jax.jit(lambda s, p: extract_alerts(s, p, cfg_big))(state, pa)
    small = jax.jit(lambda s, p: extract_alerts(s, p, cfg_small))(state, pa)
    nb, ns = int(big.count), int(small.count)
    if nb >= 2:
        assert ns == 2
        np.testing.assert_allclose(np.asarray(small.risk)[:2],
                                   np.asarray(big.risk)[:2], rtol=1e-6)


def test_upsert_priority_change_lazy_requeue():
    """Priority changes re-queue LAZILY (duplicate heap entries +
    periodic compaction) instead of rebuilding the heap per update — the
    old O(queue) rebuild made 100k-fleet serving seconds-per-step. pump()
    must still deliver each alert exactly once per tick, with the LAST
    priority, and the queue stays bounded between pumps."""
    import asyncio
    import collide as tc
    from collide.alerts.manager import AlertManager

    m = AlertManager(tc.SystemConfig(num_objects=10))
    for i in range(100):
        m._upsert(f"v{i}", f"o{i}", 0.65, 6.0, 10.0, 1)
    for _ in range(5):                       # 1000 priority flips
        for i in range(100):
            m._upsert(f"v{i}", f"o{i}", 0.85, 2.0, 5.0, 3)
            m._upsert(f"v{i}", f"o{i}", 0.65, 6.0, 10.0, 1)
    assert len(m.alerts) == 100
    assert len(m._queue) <= 2 * len(m.alerts) + 64   # compaction bound
    sent = asyncio.run(m.pump())
    assert len(sent) == 100                  # once per alert, not per dupe
    assert len({a.id for a in sent}) == 100
    assert all(a.priority == 1 for a in sent)        # last update wins
    assert len(m._queue) == 100              # unique after the pump


def _synthetic_pairs(rng, n, k, qual_frac):
    """Random PairRisks + matching state for extract_alerts input."""
    from collide.detect.pipeline import PairRisks

    other = rng.integers(0, n, (n, k)).astype(np.int32)
    valid = rng.random((n, k)) < qual_frac
    risk = rng.random((n, k)).astype(np.float32)
    ttc = rng.uniform(0.5, 12.0, (n, k)).astype(np.float32)
    pairs = PairRisks(
        other=jnp.asarray(other), valid=jnp.asarray(valid),
        risk=jnp.asarray(risk),
        ttc=jnp.where(jnp.asarray(valid), jnp.asarray(ttc), jnp.inf),
        distance=jnp.asarray(rng.uniform(1, 20, (n, k)).astype(np.float32)),
        rel_speed=jnp.asarray(rng.uniform(0, 30, (n, k)).astype(np.float32)),
        col_pos=jnp.asarray(rng.normal(0, 100, (n, k, 3)).astype(np.float32)),
        survivor_overflow=jnp.asarray(0, jnp.int32),
        num_checked=jnp.asarray(n * k, jnp.int32))
    st = state_from_numpy(
        np.zeros((n, 3)), np.zeros((n, 3)), np.zeros((n, 3)),
        np.zeros(n), np.full(n, 2.0), np.zeros(n, np.int32))
    return pairs, st


@pytest.mark.parametrize("qual_frac", [0.02, 0.9])
def test_extract_alerts_matches_numpy_full_sort(qual_frac):
    """extract_alerts must select exactly the pairs a literal NumPy full
    sort over all n*k keys selects, in the same (priority, risk) order —
    at sparse and dense qualifying fractions (the dense case pushed a
    tried-and-reverted compaction fast path past its buffer; keeping both
    pins any future selection restructure to the exact semantics)."""
    rng = np.random.default_rng(7)
    # dense case: qualifying count > 2048 (a plausible compaction buffer)
    n, k = 300, (48 if qual_frac > 0.5 else 16)
    cfg = SystemConfig(num_objects=n,
                       alerts=AlertConfig(max_scene_alerts=1024))
    pairs, st = _synthetic_pairs(rng, n, k, qual_frac)
    got = jax.jit(lambda s, p: extract_alerts(s, p, cfg))(st, pairs)

    # NumPy reference: the literal full-sort selection
    a = cfg.alerts
    keep = (np.asarray(pairs.valid)
            & (np.asarray(pairs.risk) >= a.risk_low))
    oid = np.arange(n)
    keep &= oid[:, None] < oid[np.asarray(pairs.other)]
    if qual_frac > 0.5:
        assert keep.sum() > 2048
    prio = np.asarray(compute_priority(pairs.risk, pairs.ttc, cfg))
    key = np.where(keep, prio * 2.0 + np.asarray(pairs.risk), -1.0).ravel()
    order = np.lexsort((np.arange(key.size), -key))[:a.max_scene_alerts]
    want_valid = key[order] >= 0.0
    n_want = int(want_valid.sum())

    assert int(got.count) == n_want
    gv = np.asarray(got.valid)
    assert gv[:n_want].all() and not gv[n_want:].any()
    np.testing.assert_array_equal(
        np.asarray(got.vehicle_oid)[:n_want], order[:n_want] // k)
    np.testing.assert_array_equal(
        np.asarray(got.other_oid)[:n_want],
        np.asarray(pairs.other).ravel()[order[:n_want]])
    np.testing.assert_allclose(
        np.asarray(got.risk)[:n_want],
        np.asarray(pairs.risk).ravel()[order[:n_want]], rtol=0, atol=0)
