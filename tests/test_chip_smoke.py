"""chip_smoke.py on the CPU: the GPU requirement, the phase selection, and
every phase function run at tiny sizes on the CPU backend (the GPU runs
them at full size through `python chip_smoke.py`)."""
import json

import jax
import numpy as np
import pytest

import chip_smoke as cs
import collide as tc
from collide.core.config import WorldConfig
from collide.core.state import state_from_numpy


def test_device_phase_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.phase_device(jax.devices())


def test_main_exits_without_result_on_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert "no GPU" in str(e.value.code)
    assert '"ok"' not in capsys.readouterr().out


def _fake_phases(monkeypatch, count):
    calls = []
    monkeypatch.setattr(cs, "phase_device", lambda: {
        "platform": "gpu", "kind": "stub", "count": count})
    for name in ("phase_service", "phase_parity", "phase_scale",
                 "phase_sharded"):
        monkeypatch.setattr(cs, name, lambda *a, _n=name, **k:
                            calls.append(_n))
    return calls


def test_multi_runs_only_the_sharded_phase(monkeypatch, capsys):
    calls = _fake_phases(monkeypatch, 4)
    assert cs.main(["--multi", "4"]) == 0
    assert calls == ["phase_sharded"]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "stub", "count": 4}}


def test_default_runs_the_single_card_phases(monkeypatch, capsys):
    calls = _fake_phases(monkeypatch, 1)
    assert cs.main([]) == 0
    assert calls == ["phase_service", "phase_parity", "phase_scale"]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["device"]["count"] == 1


def test_multi_refuses_too_few_devices(monkeypatch):
    calls = _fake_phases(monkeypatch, 1)
    with pytest.raises(SystemExit, match="needs 4 GPUs"):
        cs.main(["--multi", "4"])
    assert calls == []


def test_service_phase_tiny():
    res = cs.phase_service(num_vehicles=400, n_updates=8)
    assert res["alerts"] > 0 and res["steps"] >= 3


def test_parity_oracle_tiny():
    res = cs.parity_oracle(n=300, device=jax.devices()[0],
                           cpu=jax.devices()[1])
    assert res["precise"]["pairs"] > 0 and res["fast"]["pairs"] > 0


def test_parity_backends_tiny():
    res = cs.parity_backends(n=3000, device=jax.devices()[0],
                             cpu=jax.devices()[1], world=2500.0)
    assert res["pairs"] > 0


def test_parity_head_on():
    assert abs(cs.parity_head_on(jax.devices()[0]) - 4.7) < 1e-5


def test_scale_phase_tiny():
    a, b = cs.scale_configs()
    a = a.replace(num_objects=1500, world=WorldConfig(hi=(1200., 1200., 0.)))
    b = b.replace(num_objects=6000, world=WorldConfig(hi=(1000., 1000.,
                                                          500.)))
    res = cs.phase_scale((a, b), steps=2, predict_n=1500, budget_bytes=1e8)
    assert res["1m_3d_fast"]["chunk"] is not None     # chunked step ran
    assert res["100k_2d_precise"]["chunk"] is None
    assert res["predict"]["risks"] >= 0


def test_sharded_phase_on_four_cpu_devices():
    res = cs.phase_sharded(jax.devices()[:4], n=6000, world=3800.0)
    assert res["x4"]["risks"] == res["2x2"]["risks"] > 0


def test_chunk_for():
    """Flat when the [N, K] working set fits the budget, else the largest
    power-of-two row block that fits."""
    from collide.engine import chunk_for
    cfg = tc.SystemConfig(num_objects=1000)
    assert chunk_for(cfg, budget_bytes=1e12) is None
    c = chunk_for(cfg.replace(num_objects=1_000_000), budget_bytes=1e9)
    assert c & (c - 1) == 0
    per_row = cfg.max_candidates * 64
    assert c * per_row <= 1e9 < 2 * c * per_row


def test_size_capacity_covers_the_trajectory():
    """Capacity sized over the replayed physics covers every stepped
    state, so the timed steps certify overflow == 0."""
    from collide.engine import make_step
    from collide.kernels.tune import suggest_cell_capacity
    from collide.sim import generate_fleet
    cfg = tc.SystemConfig(num_objects=800,
                          world=WorldConfig(hi=(1500., 1500., 0.)))
    fleet = generate_fleet(jax.random.key(0), cfg)
    keys = [jax.random.key(k) for k in (1, 2, 3)]
    cap = cs.size_capacity(cfg, fleet, keys)
    assert cap >= suggest_cell_capacity(fleet, cfg)
    stepf = make_step(cs._with_capacity(cfg, cap), donate=False)
    st = fleet
    for k in keys:
        st, out = stepf(st, k)
        assert int(out.overflow) == 0


def _two_cars(x1, v=10.0):
    return state_from_numpy(
        np.array([[0, 0, 0], [x1, 0, 0]], np.float32),
        np.array([[v, 0, 0], [-v, 0, 0]], np.float32),
        np.zeros((2, 3), np.float32), np.zeros(2, np.float32),
        np.full(2, 2.0, np.float32), np.zeros(2, np.int32))


def test_near_threshold_flags_a_sample_edge():
    """Two cars whose gap meets the 7 m safe distance exactly on a 0.1 s
    sample sit on a threshold; a gap between samples does not."""
    cfg = tc.SystemConfig(num_objects=2,
                          world=WorldConfig(hi=(200., 200., 0.)))
    edge = cs.near_threshold(_two_cars(7.0 + 20.0 * 4.0), {(0, 1)}, cfg)
    clear = cs.near_threshold(_two_cars(7.0 + 20.0 * 3.95), {(0, 1)}, cfg)
    assert edge == {(0, 1)} and clear == set()


def test_compare_pairs_rejects_mismatches():
    cfg = tc.SystemConfig(num_objects=2,
                          world=WorldConfig(hi=(200., 200., 0.)))
    st = _two_cars(7.0 + 20.0 * 3.95)
    want = {(0, 1): (0.5, 4.0, 6.0)}
    cs.compare_pairs("same", dict(want), want, st, cfg)
    with pytest.raises(AssertionError, match="risk"):
        cs.compare_pairs("risk", {(0, 1): (0.51, 4.0, 6.0)}, want, st, cfg)
    with pytest.raises(AssertionError, match="pair sets differ"):
        cs.compare_pairs("set", {}, want, st, cfg)
