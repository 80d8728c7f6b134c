"""Load/fault/monitor tooling breadth:
kafka/redis load targets (gated), the FailureInjector client class
round-tripping against a live server, and PNG chart artifacts."""
import json
import os
import urllib.request

import pytest

import collide as tc
from collide.core.config import WorldConfig
from collide.api import Scene
from collide.api.stdlib_server import SceneHTTPServer
from collide.bench.load_generator import (LoadGenerator, LoadTestResult,
                                          FailureInjector,
                                          PerformanceAnalyzer,
                                          save_latency_charts)
from collide.bench.monitor import PerformanceMonitor


def small_scene():
    cfg = tc.SystemConfig(num_objects=64,
                          world=WorldConfig(hi=(500.0, 500.0, 0.0)))
    return Scene(cfg)


def test_kafka_redis_targets_are_gated():
    """The reference drove kafka/redis targets whose services it never
    provisioned; ours accepts the same target types and fails loudly with
    guidance when the client library is missing (it is, here)."""
    for ttype in ("kafka", "redis"):
        with pytest.raises(ImportError, match="not installed"):
            LoadGenerator(target_type=ttype)


def test_scene_target_load_test():
    gen = LoadGenerator(scene=small_scene())
    res = gen.run_load_test(target_tps=200, duration=0.5, num_vehicles=32)
    assert res.requests > 10 and res.errors == 0
    assert res.error_rate == 0.0


def test_failure_injector_client_roundtrip():
    """The client class drives every reference fault type against the live
    stdlib server (client side of load_generator.py:748-865)."""
    sc = small_scene()
    srv = SceneHTTPServer(sc, port=0)
    port = srv.start()
    try:
        inj = FailureInjector(f"http://127.0.0.1:{port}")
        assert inj.inject_node_failure("n1")["success"]
        assert inj.inject_network_partition(["n2"])["success"]
        assert inj.inject_high_load(duration=1)["success"]
        assert inj.inject_slow_response(latency=50, duration=1)["success"]
        assert inj.reset_failures()["success"]
        # drop_objects actually kills fleet members
        sc.ingest_batch_flush() if hasattr(sc, "ingest_batch_flush") else None
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/stats", timeout=10) as r:
            before = json.loads(r.read())["data"]["num_alive"]
        if before:
            killed = inj.inject_object_loss(0.5)["data"]["killed"]
            assert killed == before // 2
    finally:
        srv.stop()


def test_chart_artifacts(tmp_path):
    """PNG charts: latency histogram/timeline, cross-run comparison, and
    monitor time-series — the artifact class the reference emitted
    (load_generator.py:412-471, performance_monitor.py:591-844)."""
    pytest.importorskip("matplotlib")
    lats = [float(5 + (i % 7)) for i in range(300)]
    base = str(tmp_path / "run1")
    paths = save_latency_charts(lats, base)
    assert len(paths) == 2
    for p in paths:
        assert os.path.getsize(p) > 5_000      # a real PNG, not a stub

    cpath = PerformanceAnalyzer.comparison_chart(
        {"baseline": lats, "device": [x / 10 for x in lats]},
        str(tmp_path / "cmp.png"))
    assert cpath and os.path.getsize(cpath) > 5_000

    mon = PerformanceMonitor(target=None, interval=0.01,
                             output_dir=str(tmp_path))
    for _ in range(5):
        mon.sample_once()
    csv = mon.save()
    pngs = [f for f in os.listdir(tmp_path) if f.endswith(".png")
            and f.startswith("monitor_")]
    assert os.path.exists(csv) and pngs


def test_load_generator_save_results_includes_charts(tmp_path):
    pytest.importorskip("matplotlib")
    gen = LoadGenerator(scene=small_scene())
    res = gen.run_load_test(target_tps=200, duration=0.3, num_vehicles=16)
    base = gen.save_results(res, output_dir=str(tmp_path))
    assert os.path.exists(base + "_latencies.csv")
    assert os.path.exists(base + "_summary.json")
    assert os.path.exists(base + "_latency_hist.png")


def test_harness_profile_dir(tmp_path):
    """run_test(profile_dir=...) captures a jax.profiler trace of the
    measured window; a trace that cannot start fails the
    run instead of degrading silently."""
    import collide as tc
    from collide.bench.harness import PerformanceTester
    from collide.core.config import WorldConfig

    cfg = tc.SystemConfig(num_objects=64,
                          world=WorldConfig(hi=(500.0, 500.0, 0.0)))
    t = PerformanceTester(cfg, output_dir=str(tmp_path / "out"))
    m = t.run_test(50, 0.5, save=False, profile_dir=str(tmp_path / "prof"))
    assert t.request_count > 0
    import glob
    assert glob.glob(str(tmp_path / "prof" / "plugins" / "profile" / "*"
                         / "*.xplane.pb"))
