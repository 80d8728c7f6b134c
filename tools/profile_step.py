"""Trace the XLA step on the GPU and reduce the trace to per-op device time.

Method: jit a scan chunk of `--steps` full steps (every StepOutput field
consumed, bench._consume), warm it, then trace ONE dispatch with
jax.profiler and read the resulting .xplane.pb with
jax.profiler.ProfileData. Device planes are the `/device:GPU:<n>` ones; on
each, an "XLA Ops" line (one event per executed HLO op) is used when
present, else the stream lines, whose events are the launched kernels
(fusions, library sorts, copies).
Reported: device busy time (union of op intervals), the window span, and
the top ops by summed duration, all per step.

Writes <out-dir>/profile_<config>.json (the raw trace stays under
--trace-dir) and prints a table + one JSON line.

Usage: python tools/profile_step.py [--config 1m|100k] [--steps 3]
                                    [--out-dir chiprun_out]
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from collide.core.utils import enable_compile_cache

OPS_LINE = "XLA Ops"
SKIP_LINES = ("XLA Modules", "Steps", "Source code", "Framework")


def build_cfg(which: str):
    """The 1M-3D and 100k-2D configs of bench.py --full, sized fleet-exact.
    Returns (cfg, chunk_size for engine.make_step)."""
    from bench import scale_configs, sized
    from collide.engine import chunk_for
    cfg = sized(dict(zip(("100k", "1m"), scale_configs()))[which])
    return cfg, chunk_for(cfg)


def trace_once(cfg, chunk_size, steps: int, trace_dir: str):
    """Warm the scan chunk, time one dispatch, trace the next one.
    Returns (steady host ms/step, worst overflow, worst alert_overflow)."""
    from bench import _consume
    from collide.engine import make_step
    from collide.sim import generate_fleet

    state = generate_fleet(jax.random.key(0), cfg, distribution="uniform")
    stepf = make_step(cfg, donate=False, chunk_size=chunk_size)

    def chunk_fn(state, key):
        keys = jax.random.split(key, steps)

        def body(st, k):
            st, out = stepf(st, k)
            return st, (_consume(out), out.overflow, out.alert_overflow)

        state, (cks, ofs, aos) = jax.lax.scan(body, state, keys)
        return state, jnp.stack([jnp.sum(cks),
                                 jnp.max(ofs).astype(jnp.float32),
                                 jnp.max(aos).astype(jnp.float32)])

    run = jax.jit(chunk_fn, donate_argnums=(0,))
    t0 = time.perf_counter()
    state, probe = run(state, jax.random.key(1))
    jax.block_until_ready(probe)
    print(f"# compile+first dispatch {time.perf_counter() - t0:.3f} s",
          flush=True)
    t0 = time.perf_counter()
    state, probe = run(state, jax.random.key(2))
    jax.block_until_ready(probe)
    steady = (time.perf_counter() - t0) / steps * 1e3
    with jax.profiler.trace(trace_dir):
        state, probe = run(state, jax.random.key(3))
        jax.block_until_ready(probe)
    v = [float(x) for x in probe]
    return steady, int(v[1]), int(v[2])


def device_events(planes):
    """[(line name, op name, start ns, duration ns)] of the GPU device
    planes. `planes` is ProfileData.planes or any objects with the same
    name / lines / events shape (the reduction is tested on such stubs)."""
    out = []
    for plane in planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        chosen = [l for l in lines if l.name == OPS_LINE]
        if not chosen:
            chosen = [l for l in lines if l.name not in SKIP_LINES]
        for line in chosen:
            for e in line.events:
                out.append((line.name, e.name, float(e.start_ns),
                            float(e.duration_ns)))
    return out


def reduce_events(events):
    """Per-op summed duration, device busy time (union of intervals) and
    window span, all in ns."""
    by_op = collections.Counter()
    spans = []
    for _, name, start, dur in events:
        by_op[name] += dur
        spans.append((start, start + dur))
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    return by_op, busy, span


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="1m", choices=["1m", "100k"])
    ap.add_argument("--steps", type=int, default=3,
                    help="steps per traced dispatch")
    ap.add_argument("--out-dir", default="chiprun_out")
    ap.add_argument("--trace-dir", default=os.path.join(
        tempfile.gettempdir(), "collide_trace"))
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("no GPU: the device-track reduction reads GPU "
                         "planes")
    enable_compile_cache()

    from bench import card_name_and_power_limit
    smi = card_name_and_power_limit()
    print(f"# {smi}")
    cfg, chunk_size = build_cfg(args.config)
    tdir = os.path.join(args.trace_dir, args.config)
    steady, wof, wao = trace_once(cfg, chunk_size, args.steps, tdir)
    from jax.profiler import ProfileData
    paths = sorted(glob.glob(os.path.join(
        tdir, "plugins", "profile", "*", "*.xplane.pb")))
    assert paths, f"no xplane trace under {tdir}"
    pd = ProfileData.from_file(paths[-1])
    for plane in pd.planes:
        if plane.name.startswith("/device:GPU"):
            print(f"# plane {plane.name}: lines "
                  f"{[l.name for l in plane.lines]}")
    by_op, busy, span = reduce_events(device_events(pd.planes))

    n = args.steps
    rows = by_op.most_common(args.top)
    print(f"\n# {args.config}: {n} steps/dispatch, chunk_size={chunk_size}, "
          f"cell_capacity={cfg.grid.cell_capacity}")
    print(f"# device busy {busy / 1e6 / n:.3f} ms/step, span "
          f"{span / 1e6 / n:.3f} ms/step, host steady {steady:.3f} ms/step")
    for name, ns in rows:
        print(f"{ns / 1e6 / n:10.4f} ms/step  {name[:100]}")
    out = {
        "config": args.config, "steps": n, "chunk_size": chunk_size,
        "cell_capacity": cfg.grid.cell_capacity,
        "device": jax.devices()[0].device_kind,
        "nvidia_smi": smi,
        "steady_host_ms_per_step": steady,
        "device_busy_ms_per_step": busy / 1e6 / n,
        "device_span_ms_per_step": span / 1e6 / n,
        "overflow": wof, "alert_overflow": wao,
        # [name, ms/step] pairs: long kernel names may share a prefix
        "top_ops_ms_per_step": [[name, ns / 1e6 / n] for name, ns in rows],
    }
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, f"profile_{args.config}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in (
        "config", "device", "device_busy_ms_per_step",
        "device_span_ms_per_step", "steady_host_ms_per_step")}))
    print(f"# wrote {path}")


if __name__ == "__main__":
    main()
