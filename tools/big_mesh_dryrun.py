"""Big virtual-mesh execution evidence.

Runs the FULL sharded step on a 16- or 64-device virtual CPU mesh at
meaningful N (default 64k objects — real-ish density, not the 16/device
toy shapes of `__graft_entry__.dryrun_multichip`) and asserts the two things that make the multi-chip story credible without
multi-chip hardware:

  * conservation — every object accounted for after halo exchange +
    migration across the device grid (dropped == 0, num_alive == N);
  * parity — risk count and (when the scene alert budget holds them all)
    the exact unordered alert set match the single-device step on the SAME
    fleet with the SAME key (deterministic physics).

Timings journaled per run: first-call wall (compile, dominated by per-shard
program build) and steady-state step wall. Results land as one JSON line
per run.

Reference anchor: the reference's shard aspiration is
`data_sharding.py:22-88` (geographic hash rings it never executed at
scale); this tool executes the mesh program for real.

Usage (self-bootstraps the virtual CPU mesh like dryrun_multichip):
    python tools/big_mesh_dryrun.py --devices 16 --grid 8x2 --n 65536
    python tools/big_mesh_dryrun.py --devices 64 --grid 8x8 --n 65536
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _bootstrap(n_devices: int) -> bool:
    """Re-exec with an n_devices virtual CPU mesh if needed (same recipe
    as __graft_entry__.dryrun_multichip)."""
    import jax

    if len(jax.devices()) >= n_devices and \
            jax.devices()[0].platform == "cpu":
        return False
    env = dict(os.environ)
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags += f" --xla_force_host_platform_device_count={n_devices}"
    env["XLA_FLAGS"] = flags.strip()
    env["JAX_PLATFORMS"] = "cpu"
    bootstrap = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
                 f"import runpy, sys; sys.argv={sys.argv!r}; "
                 f"runpy.run_path({os.path.abspath(__file__)!r}, "
                 "run_name='__main__')")
    proc = __import__("subprocess").run(
        [sys.executable, "-c", bootstrap], env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if proc.returncode != 0:
        raise SystemExit(proc.returncode)
    return True


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=16)
    ap.add_argument("--grid", default="8x2",
                    help="device grid dx x dy (product == devices)")
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=2,
                    help="steady-state steps to time after compile")
    ap.add_argument("--skip-single", action="store_true",
                    help="skip the single-device parity run (timing only)")
    args = ap.parse_args()
    if _bootstrap(args.devices):
        return

    import jax
    import numpy as np

    import collide as tc
    from collide.core.config import (ShardConfig, SimConfig, WorldConfig,
                                     GridConfig, DetectionConfig,
                                     AlertConfig)
    from collide.sim import generate_fleet
    from collide.shard import make_mesh, make_sharded_step, \
        distribute_state
    from collide.engine import make_step

    dx, dy = (int(v) for v in args.grid.split("x"))
    assert dx * dy == args.devices, "grid must tile the device count"
    # 100k-bench-shaped world: 10 km^2, 100 m cells, uniform fleet.
    # Scene alert budget sized to hold EVERY qualifying alert so the
    # sharded-vs-single alert sets are comparable exactly (no top-k
    # boundary ties); overflow stays counted if density outruns it.
    # cell_capacity 64: the default 16 counted 9 bucket truncations at 64k;
    # the comparison needs a provably complete reference, certified below
    # by overflow == 0 on both sides.
    cfg = tc.SystemConfig(
        num_objects=args.n,
        world=WorldConfig(hi=(10000.0, 10000.0, 0.0)),
        grid=GridConfig(cell_size=100.0, cell_capacity=64),
        detect=DetectionConfig(mode="fast"),
        sim=SimConfig(accel_change_prob=0.0),
        alerts=AlertConfig(max_scene_alerts=32768),
        shard=ShardConfig(num_shards=dx, num_shards_y=dy,
                          halo_capacity=1024, migrate_capacity=256),
    )
    fleet = generate_fleet(jax.random.key(0), cfg, distribution="uniform")
    key = jax.random.key(1)
    mesh = make_mesh(cfg)
    st = distribute_state(fleet, cfg, mesh)
    stepf = make_sharded_step(cfg, mesh, donate=False)

    t0 = time.perf_counter()
    s2, out, dropped = jax.block_until_ready(stepf(st, key))
    compile_s = time.perf_counter() - t0
    step_ms = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        _, out_i, _ = jax.block_until_ready(stepf(st, key))
        step_ms.append((time.perf_counter() - t0) * 1e3)

    alive = int(out.num_alive)
    drop = int(np.asarray(dropped).sum())
    res = {
        "devices": args.devices, "grid": args.grid, "n": args.n,
        "compile_s": round(compile_s, 1),
        "step_ms": round(min(step_ms), 1),
        "risks": int(out.num_risks),
        "alive": alive, "dropped": drop,
        "overflow": int(out.overflow),
        "alert_overflow": int(out.alert_overflow),
        "conserved": alive == args.n and drop == 0,
    }
    assert res["conserved"], f"conservation failed: {res}"
    assert res["overflow"] == 0, f"sharded candidate truncation: {res}"

    if not args.skip_single:
        s1, out1 = make_step(cfg, donate=False)(fleet, key)
        res["risks_single"] = int(out1.num_risks)
        res["single_overflow"] = int(out1.overflow)
        assert res["single_overflow"] == 0, (
            f"single-device reference truncated its candidates: {res}")
        res["risk_parity"] = res["risks"] == res["risks_single"]
        if int(out1.alert_overflow) == 0 and res["alert_overflow"] == 0:
            def aset(o):
                v = np.asarray(o.alerts.valid).ravel()
                return set(zip(
                    np.asarray(o.alerts.vehicle_oid).ravel()[v].tolist(),
                    np.asarray(o.alerts.other_oid).ravel()[v].tolist()))
            a1, a2 = aset(out1), aset(out)
            res["alert_set_equal"] = a1 == a2
            if a1 != a2:
                pos = np.asarray(fleet.pos)
                for tag, diff in (("single-only", a1 - a2),
                                  ("shard-only", a2 - a1)):
                    for p in sorted(diff)[:8]:
                        va, vb = p
                        print(f"# {tag} pair {p}: "
                              f"pos_a={pos[va] if 0 <= va < args.n else '?'} "
                              f"pos_b={pos[vb] if 0 <= vb < args.n else '?'}",
                              file=sys.stderr)
            assert a1 == a2, (f"alert sets differ: single-only "
                              f"{len(a1 - a2)}, shard-only {len(a2 - a1)}")
        assert res["risk_parity"], res

    print(json.dumps(res))


if __name__ == "__main__":
    main()
