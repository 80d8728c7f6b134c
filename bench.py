"""Benchmark: full-scene steps/s on the reference's headline config.

Reference baseline (BASELINE.md): the optimized CPU harness at 1000 vehicles
achieved 9.44 full-scene steps/s (avg 99.32 ms, p99 314.57 ms); each step =
physics update + full index rebuild + collision detection + TTC prediction
for the whole fleet (optimized_performance_test.py:850-981). This bench runs
the identical workload shape as one jitted step and reports steps/s with
vs_baseline = ours / 9.44.

Headline: 1000 vehicles, precise (reference-parity) 4-stage detection. The
completeness certificate (overflow == alert_overflow == 0) is folded over
every timed step. Extra fields: fast mode at 1000, per-step serving
latency, the Scene surface (plain and pipelined), and with --full the
100k-2D and 1M-3D configs (BASELINE.json configs 3-4, the 1M rows on the
chunked large-N step) plus trajectory prediction at 100k.

Needs a GPU: the run fails when JAX finds none. Prints ONE JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np

from collide.core.utils import enable_compile_cache

BASELINE_STEPS_PER_S = 9.44          # results/optimized_perf_test_1000vehicles…
BASELINE_AVG_MS = 99.32
BASELINE_P99_MS = 314.57


def _consume(out):
    """Fold EVERY StepOutput field into one f32 scalar. Scan-chunked
    timing bodies must return this (not just num_risks): jit DCEs any
    unconsumed output, and a body that only keeps num_risks silently
    drops stage 4 + alert extraction from the timed program. The bench
    claims the FULL step, so it must compute the full step."""
    a = out.alerts
    v = a.valid
    s = lambda x: jnp.sum(jnp.where(v, x, 0).astype(jnp.float32))
    return (out.num_pairs_checked.astype(jnp.float32) + out.num_risks
            + out.max_risk + out.num_alive + out.overflow
            + out.alert_overflow + a.count
            + s(a.vehicle_oid) + s(a.other_oid) + s(a.risk) + s(a.ttc)
            + s(a.distance) + s(a.rel_speed) + s(a.priority)
            + jnp.sum(jnp.where(v[:, None], a.col_pos, 0.0)))


def require_gpu() -> None:
    """A device measurement with no GPU behind it is refused, not faked."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found platform {d.platform!r} "
                         f"({d.device_kind}); this measurement needs a GPU")


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` as it prints them, one
    line per card: a card below its maximum limit runs slower under load,
    so every device number is reported beside it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def bench_scan(cfg, steps, chunk, key0=0, distribution="city_skew",
               chunk_size=None):
    """Device-rate steps/s via scan-batched chunks (`chunk` steps per
    dispatch, every output consumed). Returns (steps_per_s, avg_ms,
    worst_chunk_ms, total_risks, worst_overflow, worst_alert_overflow):
    the worst counters fold over EVERY timed step, so both 0 certify the
    whole run's alert lists complete."""
    from collide.engine import make_step
    from collide.sim import generate_fleet

    state = generate_fleet(jax.random.key(key0), cfg,
                           distribution=distribution)
    stepf = make_step(cfg, donate=False, chunk_size=chunk_size)

    def chunk_fn(state, key):
        keys = jax.random.split(key, chunk)

        def body(st, k):
            st, out = stepf(st, k)
            return st, (out.num_risks, _consume(out), out.overflow,
                        out.alert_overflow)

        state, (risks, cks, ofs, aos) = jax.lax.scan(body, state, keys)
        return state, jnp.stack([jnp.sum(risks).astype(jnp.float32),
                                 jnp.sum(cks),
                                 jnp.max(ofs).astype(jnp.float32),
                                 jnp.max(aos).astype(jnp.float32)])

    run = jax.jit(chunk_fn, donate_argnums=(0,))
    state, probe = run(state, jax.random.key(1))
    jax.block_until_ready(probe)                    # compile outside timing

    n_chunks = max(1, steps // chunk)
    chunk_ms, total_risks, worst_of, worst_ao = [], 0, 0, 0
    for i in range(n_chunks):
        t0 = time.perf_counter()
        state, probe = run(state, jax.random.key(2 + i))
        jax.block_until_ready(probe)
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        v = np.asarray(probe)
        total_risks += int(v[0])
        worst_of, worst_ao = max(worst_of, int(v[2])), max(worst_ao, int(v[3]))
    total_ms = sum(chunk_ms)
    done = n_chunks * chunk
    return (done / (total_ms / 1e3), total_ms / done,
            max(chunk_ms) / chunk, total_risks, worst_of, worst_ao)


def scale_configs():
    """(100k-2D, 1M-3D) in fast mode, cell_capacity not yet sized:
    BASELINE.json configs 3 and 4 — 100,000 objects in the 10 km 2D world
    (100 m cells), 1,000,000 drones in 10 x 10 x 0.5 km (50 m cells, 50 m
    search radius)."""
    import collide as tc
    from collide.core.config import (WorldConfig, GridConfig,
                                     DetectionConfig, AlertConfig)
    cfg100k = tc.SystemConfig(
        num_objects=100_000, world=WorldConfig(hi=(10000., 10000., 0.)),
        grid=GridConfig(cell_size=100.0),
        detect=DetectionConfig(mode="fast"),
        alerts=AlertConfig(max_scene_alerts=1024))
    cfg1m = tc.SystemConfig(
        num_objects=1_000_000,
        world=WorldConfig(hi=(10000., 10000., 500.)),
        grid=GridConfig(cell_size=50.0),
        detect=DetectionConfig(mode="fast", search_radius=50.0),
        alerts=AlertConfig(max_scene_alerts=4096))
    return cfg100k, cfg1m


def precise(cfg):
    """cfg in precise detection mode, every other detection field kept."""
    import dataclasses
    return cfg.replace(detect=dataclasses.replace(cfg.detect, mode="precise"))


def sized(cfg, distribution="uniform", key0=0):
    """cfg with cell_capacity sized fleet-exact for the bench fleet (set-up,
    not timed; kernels/tune.suggest_cell_capacity)."""
    import dataclasses
    from collide.kernels.tune import suggest_cell_capacity
    from collide.sim import generate_fleet
    st = generate_fleet(jax.random.key(key0), cfg, distribution=distribution)
    cap = suggest_cell_capacity(st, cfg, margin=4)
    return cfg.replace(grid=dataclasses.replace(cfg.grid, cell_capacity=cap))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--full", action="store_true",
                    help="also run the 100k-2D and 1M-3D configs and "
                         "prediction at 100k")
    args = ap.parse_args()
    require_gpu()
    enable_compile_cache()

    import collide as tc
    from collide.core.config import DetectionConfig
    from collide.engine import chunk_for, make_step
    from collide.sim import generate_fleet

    # headline: the reference's own 1000-vehicle config, parity (precise)
    cfg_p = tc.SystemConfig(num_objects=1000,
                            detect=DetectionConfig(mode="precise"))
    sps, avg_ms, worst_ms, risks, of_p, ao_p = bench_scan(
        cfg_p, args.steps, args.chunk)
    cfg_f = tc.SystemConfig(num_objects=1000,
                            detect=DetectionConfig(mode="fast"))
    sps_fast, avg_fast, _, _, of_f, ao_f = bench_scan(
        cfg_f, args.steps, args.chunk)

    # per-step serving latency: each step individually dispatched + synced
    stepf = make_step(cfg_p)
    st = generate_fleet(jax.random.key(9), cfg_p)
    st, out = stepf(st, jax.random.key(10))
    jax.block_until_ready(out)
    lat = []
    for i in range(100):
        t0 = time.perf_counter()
        st, out = stepf(st, jax.random.key(11 + i))
        jax.block_until_ready(out)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()

    # Scene-surface serving: the FULL public path per call (alert
    # lifecycle processing, counters, one batched fetch); pipelined =
    # one-behind consumption overlapping host work with the device step
    from collide.api import Scene

    def scene_serving(pipelined: bool, n=60):
        sc = Scene(cfg_p, state=generate_fleet(jax.random.key(12), cfg_p))
        (sc.step_pipelined() if pipelined else sc.step())   # warm
        ls = []
        for _ in range(n):
            t0 = time.perf_counter()
            sc.step_pipelined() if pipelined else sc.step()
            ls.append((time.perf_counter() - t0) * 1e3)
        if pipelined:
            sc.pipeline_drain()
        ls.sort()
        return sum(ls) / len(ls), ls[int(0.95 * len(ls))]

    scene_avg, scene_p95 = scene_serving(False)
    pipe_avg, pipe_p95 = scene_serving(True)

    extra = {}
    if args.full:
        cfg100k, cfg1m = (sized(c) for c in scale_configs())
        rows = (("100k_2d", cfg100k, None),
                ("100k_2d_precise", precise(cfg100k), None),
                ("1m_3d", cfg1m, chunk_for(cfg1m)),
                ("1m_3d_precise", precise(cfg1m), chunk_for(cfg1m)))
        for tag, cfg, chunk_size in rows:
            _, a, _, _, wof, wao = bench_scan(
                cfg, steps=12, chunk=4, distribution="uniform",
                chunk_size=chunk_size)
            extra[f"{tag}_avg_ms"] = a
            extra[f"{tag}_overflow"] = wof
            extra[f"{tag}_aoflow"] = wao
            extra[f"{tag}_cell_capacity"] = cfg.grid.cell_capacity
            extra[f"{tag}_chunk_size"] = chunk_size

        # prediction at 100k through the public Scene surface: trajectory
        # ring ticks + one device-compacted predict (grid + 20-offset
        # re-detection + top-k merge). auto_heal=False keeps the gather
        # path at its configured capacity; its bucket truncation stays
        # counted (predict_100k_overflow)
        sc = Scene(cfg100k, state=generate_fleet(jax.random.key(5), cfg100k),
                   auto_heal=False)
        for _ in range(3):
            sc.record_trajectories()
        sc.predict()                               # compile + warm
        best, pred_risks = 1e30, []
        for _ in range(3):
            t0 = time.perf_counter()
            pred_risks = sc.predict()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        extra["predict_100k_ms"] = best
        extra["predict_100k_risks"] = len(pred_risks)
        extra["predict_100k_overflow"] = sc.last_predict_overflow

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "full-scene steps/s (1000 vehicles, precise 4-stage "
                  f"detection, {dev.device_kind})",
        "value": sps,
        "unit": "steps/s",
        "vs_baseline": sps / BASELINE_STEPS_PER_S,
        "certified_complete": of_p == 0 and ao_p == 0,
        "avg_step_ms": avg_ms,
        "worst_chunk_step_ms": worst_ms,
        # SERVING view: one dispatch + sync per step
        "serving_avg_ms": sum(lat) / len(lat),
        "per_step_p95_ms": lat[94],
        "per_step_p99_ms": lat[98],
        "p99_vs_baseline": BASELINE_P99_MS / lat[98],
        # full public Scene surface per call (alerts processed), one
        # batched fetch; _pipelined overlaps host work with the device
        "serving_scene_avg_ms": scene_avg,
        "serving_scene_p95_ms": scene_p95,
        "serving_scene_pipelined_avg_ms": pipe_avg,
        "serving_scene_pipelined_p95_ms": pipe_p95,
        "fast_mode_steps_per_s": sps_fast,
        "fast_mode_avg_ms": avg_fast,
        "fast_mode_certified_complete": of_f == 0 and ao_f == 0,
        "baseline_steps_per_s": BASELINE_STEPS_PER_S,
        "baseline_avg_ms": BASELINE_AVG_MS,
        "baseline_p99_ms": BASELINE_P99_MS,
        "steps": args.steps,
        "total_risks": risks,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()),
                   "nvidia_smi": card_name_and_power_limit()},
        **extra,
    }))


if __name__ == "__main__":
    main()
