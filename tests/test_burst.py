"""Burst stepping: ONE device dispatch advancing n steps (lax.scan over
the per-step program) must compute exactly what n single steps compute —
same trajectory (identical key schedule), same final alert set, and
counter certificates folded as the burst-wide worst step.

This is the production surface of the bench's device-rate methodology
(engine.make_burst_step / Scene.step_burst / ShardedScene.step_burst
amortize per-call dispatch and sync n x)."""
import numpy as np
import jax

import collide as tc
from collide.core.config import (AlertConfig, DetectionConfig,
                                 GridConfig, ShardConfig, SimConfig,
                                 WorldConfig)
from collide.sim import generate_fleet
from collide.api import Scene
from collide.api.sharded_scene import ShardedScene
from collide.engine import make_step, make_burst_step


def _cfg(n=256, **kw):
    kw.setdefault("alerts", AlertConfig(max_scene_alerts=128))
    return tc.SystemConfig(num_objects=n, **kw)


def _state_eq(a, b):
    for f in ("pos", "vel", "acc", "heading", "size", "otype", "alive",
              "oid"):
        av, bv = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert np.array_equal(av, bv), f"state field {f} diverged"


def _alerts_set(batch):
    v = np.asarray(batch.valid).ravel()
    return {(int(a), int(b)): (float(r), float(t)) for a, b, r, t in zip(
        np.asarray(batch.vehicle_oid).ravel()[v],
        np.asarray(batch.other_oid).ravel()[v],
        np.asarray(batch.risk).ravel()[v],
        np.asarray(batch.ttc).ravel()[v])}


def test_engine_burst_matches_singles():
    """make_burst_step(n) == n make_step calls with the Scene key
    schedule: identical final state, per-step risk counts, alert set."""
    cfg = _cfg()
    state = generate_fleet(jax.random.key(0), cfg)
    stepf = make_step(cfg, donate=False)

    key = jax.random.key(7)
    s_ref, risks_ref, out_ref = state, [], None
    for _ in range(5):
        key, sub = jax.random.split(key)
        s_ref, out_ref = stepf(s_ref, sub)
        risks_ref.append(int(out_ref.num_risks))

    burst = make_burst_step(cfg, 5, donate=False)
    s_b, key_b, out_b, risks_b = burst(state, jax.random.key(7))

    _state_eq(s_ref, s_b)
    assert np.array_equal(np.asarray(jax.random.key_data(key_b)),
                          np.asarray(jax.random.key_data(key)))
    assert list(np.asarray(risks_b)) == risks_ref
    assert _alerts_set(out_b.alerts) == _alerts_set(out_ref.alerts)
    assert int(out_b.num_alive) == int(out_ref.num_alive)


def test_engine_burst_counters_fold_worst_step():
    """overflow / alert_overflow on the burst output are the MAX across
    the burst's steps, not the final step's value."""
    # 4-slot buckets and a 32-pair survivor cap on a city-skew fleet:
    # both counters fire on (at least) some steps; the burst must report
    # the max of the per-step values
    cfg = _cfg(n=128, alerts=AlertConfig(max_scene_alerts=64),
               world=WorldConfig(hi=(1000.0, 1000.0, 0.0)),
               grid=GridConfig(cell_capacity=4),
               detect=DetectionConfig(mode="precise",
                                      precise_survivor_cap=32))
    state = generate_fleet(jax.random.key(3), cfg)
    stepf = make_step(cfg, donate=False)

    key = jax.random.key(11)
    s, worst_of, worst_ao = state, 0, 0
    for _ in range(4):
        key, sub = jax.random.split(key)
        s, out = stepf(s, sub)
        worst_of = max(worst_of, int(out.overflow))
        worst_ao = max(worst_ao, int(out.alert_overflow))

    burst = make_burst_step(cfg, 4, donate=False)
    _, _, out_b, _ = burst(state, jax.random.key(11))
    assert worst_of > 0 and worst_ao > 0
    assert int(out_b.overflow) == worst_of
    assert int(out_b.alert_overflow) == worst_ao


def test_scene_step_burst():
    """Scene.step_burst(n) advances the scene exactly like n step()
    calls: same state, same AlertManager contents from the final step,
    same step_count; burst length 1 delegates to step()."""
    cfg = _cfg()
    # independent buffer copies: Scene steps DONATE their state, so two
    # scenes must not alias one fleet
    a = Scene(cfg, state=generate_fleet(jax.random.key(1), cfg))
    b = Scene(cfg, state=generate_fleet(jax.random.key(1), cfg))

    out_a = a.step(6)
    out_b = b.step_burst(6)

    _state_eq(a.state, b.state)
    assert a.step_count == b.step_count == 6
    assert _alerts_set(out_a.alerts) == _alerts_set(out_b.alerts)
    assert b.last_burst_risks.shape == (6,)
    assert int(out_a.num_risks) == int(b.last_burst_risks[-1])
    # the same key schedule leaves both scenes at the same PRNG state:
    # one more single step on each must still agree
    out_a2, out_b2 = a.step(), b.step_burst(1)
    assert _alerts_set(out_a2.alerts) == _alerts_set(out_b2.alerts)
    _state_eq(a.state, b.state)


def test_scene_burst_cache_invalidated_on_regrow():
    """A capacity heal rebuilds the step program; a cached burst for the
    old capacity must not survive (it would silently keep the old
    cell_capacity)."""
    cfg = _cfg(n=128, alerts=AlertConfig(max_scene_alerts=64),
               world=WorldConfig(hi=(1000.0, 1000.0, 0.0)),
               grid=GridConfig(cell_capacity=4))
    fleet = generate_fleet(jax.random.key(3), cfg)
    sc = Scene(cfg, state=fleet)
    sc.step_burst(2)
    assert sc.regrows and sc._burst_cache == {}
    # a follow-up burst compiles against the CURRENT (healed) program
    out = sc.step_burst(2)
    assert sc._burst_cache and int(out.num_alive) == 128


def test_rest_step_route_burst_param():
    """POST /step {'burst': true} rides Scene.step_burst through the
    shared route core (both transports inherit it)."""
    from collide.api.routes import RouteTable

    cfg = _cfg(n=64)
    sc = Scene(cfg, state=generate_fleet(jax.random.key(2), cfg))
    routes = RouteTable(sc)
    code, r = routes.handle("POST", "/step", {"steps": 3, "burst": True}, {})
    assert code == 200 and r["data"]["step_count"] == 3
    assert sc.last_burst_risks.shape == (3,)
    code, r = routes.handle("POST", "/step", {"steps": 2}, {})
    assert code == 200 and r["data"]["step_count"] == 5


def test_sharded_scene_step_burst():
    """ShardedScene.step_burst == n single sharded steps on the 8-device
    CPU mesh (deterministic physics), including migration bookkeeping."""
    cfg = tc.SystemConfig(
        num_objects=512, sim=SimConfig(accel_change_prob=0.0),
        alerts=AlertConfig(max_scene_alerts=256),
        shard=ShardConfig(num_shards=4))
    fleet = generate_fleet(jax.random.key(0), cfg)
    a = ShardedScene(cfg, fleet=fleet, auto_rebalance=False)
    b = ShardedScene(cfg, fleet=fleet, auto_rebalance=False)

    out_a = a.step(5)
    out_b = b.step_burst(5)

    assert int(out_a.num_alive) == int(out_b.num_alive)
    assert int(out_a.num_risks) == int(out_b.num_risks)
    assert a.dropped_total == b.dropped_total
    assert _alerts_set(out_a.alerts) == _alerts_set(out_b.alerts)
    ca, cb = a.collect(), b.collect()
    # collect() packs by oid order, so field-wise equality is meaningful
    _state_eq(ca, cb)
    assert b.last_burst_risks.shape == (5,)
