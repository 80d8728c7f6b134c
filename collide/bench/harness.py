"""Performance-test harness with reference-compatible artifacts.

The step-loop tester shape of the reference's measured harness
(optimized_performance_test.py:793-1149): each "request" is one full scene
step (physics + index rebuild + detection + prediction); latencies and
rolling metrics are captured and written as

    <out>/perf_test_<N>vehicles_<TPS>tps_<D>s_<stamp>_latencies.csv
    <out>/..._metrics.csv      (same columns as the reference, :1052-1056)
    <out>/..._summary.txt      (same fields; English labels)

so runs are directly comparable against the reference's `results/`
artifacts (SURVEY.md §6). The TTC here is deterministic kinematics, not the
reference's random draw — matched on shape, not on dice (DEVIATIONS.md #2).
"""
from __future__ import annotations

import dataclasses
import os
import time
from datetime import datetime
from typing import List, Optional

import jax
import numpy as np

from collide.core.config import SystemConfig
from collide.core.utils import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass
class PerformanceMetrics:
    """reference optimized_performance_test.py:39-51"""
    throughput: float = 0.0
    avg_latency: float = 0.0
    p95_latency: float = 0.0
    p99_latency: float = 0.0
    max_latency: float = 0.0
    error_rate: float = 0.0
    cpu_usage: float = 0.0
    memory_usage: float = 0.0
    timestamp: float = dataclasses.field(default_factory=time.time)


def _percentile(sorted_vals: List[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(p * len(sorted_vals)))
    return sorted_vals[i]


class PerformanceTester:
    """Step-loop tester (reference OptimizedPerformanceTester,
    optimized_performance_test.py:793-981)."""

    def __init__(self, cfg: SystemConfig, output_dir: str = "results",
                 distribution: str = "city_skew"):
        self.cfg = cfg
        self.output_dir = output_dir
        self.distribution = distribution
        self.latencies: List[float] = []
        self.metrics_history: List[PerformanceMetrics] = []
        self.request_count = 0
        self.error_count = 0
        self.total_risks = 0
        self.start_time = 0.0
        self.end_time = 0.0

    def _cpu_mem(self):
        try:
            import psutil
            return (psutil.cpu_percent(interval=None),
                    psutil.virtual_memory().percent)
        except ImportError:
            return 0.0, 0.0

    def _calculate_metrics(self) -> PerformanceMetrics:
        lat = sorted(self.latencies)
        dur = max(self.end_time - self.start_time, 1e-9)
        cpu, mem = self._cpu_mem()
        return PerformanceMetrics(
            throughput=self.request_count / dur,
            avg_latency=float(np.mean(lat)) if lat else 0.0,
            p95_latency=_percentile(lat, 0.95),
            p99_latency=_percentile(lat, 0.99),
            max_latency=lat[-1] if lat else 0.0,
            error_rate=(self.error_count / self.request_count * 100
                        if self.request_count else 0.0),
            cpu_usage=cpu, memory_usage=mem)

    def run_test(self, target_tps: int, duration: float,
                 save: bool = True,
                 profile_dir: str | None = None) -> PerformanceMetrics:
        """Open-loop step loop at target_tps for `duration` seconds
        (reference :850-981: per-request = one full-scene step; metrics
        snapshot every 10 requests).

        profile_dir: capture a jax.profiler trace of the measured window,
        viewable with TensorBoard/XProf/Perfetto. A trace that fails to
        start or stop fails the run."""
        import contextlib
        import collide as tc
        from collide.sim import generate_fleet

        state = generate_fleet(jax.random.key(0), self.cfg,
                               distribution=self.distribution)
        stepf = tc.make_step(self.cfg, donate=True)
        # compile outside the measured window
        state, out = stepf(state, jax.random.key(1))
        int(np.asarray(out.num_risks))

        prof = contextlib.nullcontext()
        if profile_dir:
            prof = jax.profiler.trace(profile_dir, create_perfetto_trace=True)

        interval = 1.0 / target_tps if target_tps > 0 else 0.0
        self.start_time = time.perf_counter()
        deadline = self.start_time + duration
        i = 0
        with prof:
            while time.perf_counter() < deadline:
                t0 = time.perf_counter()
                try:
                    state, out = stepf(state, jax.random.key(2 + i))
                    self.total_risks += int(np.asarray(out.num_risks))
                except Exception as e:  # noqa: BLE001
                    self.error_count += 1
                    logger.error("step error: %s", e)
                self.latencies.append((time.perf_counter() - t0) * 1e3)
                self.request_count += 1
                i += 1
                if self.request_count % 10 == 0:
                    self.end_time = time.perf_counter()
                    self.metrics_history.append(self._calculate_metrics())
                sleep = interval - (time.perf_counter() - t0)
                if sleep > 0:
                    time.sleep(sleep)
        self.end_time = time.perf_counter()
        final = self._calculate_metrics()
        if save:
            self.save_results(target_tps, int(duration))
        return final

    def save_results(self, target_tps: int, duration: int) -> str:
        """Reference artifact triplet (optimized_performance_test.py:
        1033-1088)."""
        os.makedirs(self.output_dir, exist_ok=True)
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        base = os.path.join(
            self.output_dir,
            f"perf_test_{self.cfg.num_objects}vehicles_{target_tps}tps_"
            f"{duration}s_{stamp}")

        with open(base + "_latencies.csv", "w") as f:
            f.write("latency_ms\n")
            for v in self.latencies:
                f.write(f"{v}\n")

        with open(base + "_metrics.csv", "w") as f:
            f.write("timestamp,throughput,avg_latency,p95_latency,"
                    "p99_latency,max_latency,error_rate,cpu_usage,"
                    "memory_usage\n")
            for m in self.metrics_history:
                f.write(f"{m.timestamp},{m.throughput},{m.avg_latency},"
                        f"{m.p95_latency},{m.p99_latency},{m.max_latency},"
                        f"{m.error_rate},{m.cpu_usage},{m.memory_usage}\n")

        fm = self._calculate_metrics()
        w = self.cfg.world
        with open(base + "_summary.txt", "w") as f:
            f.write("Performance test summary (collide)\n")
            f.write("================\n\n")
            f.write("Test configuration:\n")
            f.write(f"  Vehicles: {self.cfg.num_objects}\n")
            f.write(f"  Target TPS: {target_tps}\n")
            f.write(f"  Duration: {duration}s\n")
            f.write(f"  Map size: ({w.hi[0] - w.lo[0]:.0f}, "
                    f"{w.hi[1] - w.lo[1]:.0f})\n")
            f.write(f"  Device: {jax.devices()[0].device_kind} / "
                    f"{self.cfg.detect.mode} mode\n\n")
            f.write("Results:\n")
            f.write(f"  Total requests: {self.request_count}\n")
            f.write(f"  Total errors: {self.error_count}\n")
            f.write(f"  Error rate: {fm.error_rate:.2f}%\n")
            f.write(f"  Actual duration: "
                    f"{self.end_time - self.start_time:.2f}s\n")
            f.write(f"  Throughput: {fm.throughput:.2f} req/s\n\n")
            f.write("Latency (ms):\n")
            f.write(f"  Average: {fm.avg_latency:.2f}\n")
            f.write(f"  P95: {fm.p95_latency:.2f}\n")
            f.write(f"  P99: {fm.p99_latency:.2f}\n")
            f.write(f"  Max: {fm.max_latency:.2f}\n\n")
            f.write("Resources:\n")
            f.write(f"  CPU: {fm.cpu_usage:.2f}%\n")
            f.write(f"  Memory: {fm.memory_usage:.2f}%\n")
            f.write(f"\nTotal risks detected: {self.total_risks}\n")
        logger.info("results saved to %s_*", base)
        return base


def main(argv=None):
    """CLI mirroring the reference tester (optimized_performance_test.py:
    1152-1194)."""
    import argparse
    import collide as tc
    from collide.core.config import DetectionConfig

    ap = argparse.ArgumentParser(description="collide perf test")
    ap.add_argument("--vehicles", type=int, default=1000)
    ap.add_argument("--tps", type=int, default=1000)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--output-dir", default="results")
    ap.add_argument("--mode", default="precise", choices=["precise", "fast"])
    ap.add_argument("--distribution", default="city_skew",
                    choices=["city_skew", "uniform"])
    ap.add_argument("--profile-dir", default=None,
                    help="capture a jax.profiler trace of the measured "
                         "window into this directory")
    args = ap.parse_args(argv)

    cfg = tc.SystemConfig(num_objects=args.vehicles,
                          detect=DetectionConfig(mode=args.mode))
    tester = PerformanceTester(cfg, output_dir=args.output_dir,
                               distribution=args.distribution)
    m = tester.run_test(args.tps, args.duration,
                        profile_dir=args.profile_dir)
    print(f"throughput={m.throughput:.2f} req/s avg={m.avg_latency:.2f} ms "
          f"p95={m.p95_latency:.2f} p99={m.p99_latency:.2f} "
          f"max={m.max_latency:.2f} err={m.error_rate:.2f}%")


if __name__ == "__main__":
    main()
