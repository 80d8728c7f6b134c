"""Smoke test on NVIDIA GPUs: the main path end to end, through the entry
points a user calls, at the sizes users run.

One process holds the card and every phase runs inside it:

  device   require a GPU (no CPU fallback); print its kind, the device
           count and `nvidia-smi` name + power limit
  service  the reference's served deployment (src/test/benchmark.sh): a
           10,000-vehicle city-skew fleet in precise mode behind
           system.CollisionSystem + the stdlib REST server on an ephemeral
           port — location updates, /step plain, burst and pipelined,
           /alerts, /stats over HTTP
  scale    BASELINE configs 3 and 4 on the XLA step: 100k-2D precise (flat)
           and 1M-3D fast (chunked large-N step), capacities sized
           fleet-exact during set-up; Scene.predict at 100k
  parity   the GPU against the plain references: (a) the NumPy oracle of
           the reference math (tests/oracle.py) on the 1,000-vehicle
           city-skew fleet, both detection modes; (b) a 100k-2D fast step
           against the CPU backend of this process; (c) the head-on probe

`--multi 4` runs only the sharded path on four cards (a 4-slab x mesh and a
2x2 (x, y) mesh over a 1M-object 2D fleet) and the one-card step it is
compared with.

Every phase checks its own results and raises on a failure, so the script
exits non-zero and prints no result line. The last line of stdout is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.

Usage: python chip_smoke.py [--multi 4]
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np

from collide.core.utils import enable_compile_cache
from collide.engine import chunk_for

# Tolerances of the GPU-vs-reference comparisons (see CHANGES.md / PERF.md).
# The pipeline is f32 elementwise math with no matrix product, so results
# differ from the CPU only by FMA contraction and the GPU's transcendental
# implementations — a few ulps. A position near the far edge of a 10 km
# world is resolved to one f32 ulp (~1e-3 m), which bounds how closely two
# derivations of a distance can agree, so distances carry that absolute
# term beside the relative one, and risk inherits it through
# 0.3 * distance / safe (safe >= 6 m).
RTOL = 1e-5                # relative, ttc and distance
RISK_ATOL = 1e-5           # absolute, risk in [0, 1]
ULPS = 4                   # f32 ulps of the world extent, distance terms
EDGE_T = 1e-4              # near-threshold band: t* (s), rel speed (m/s)


def _log(msg: str) -> None:
    print(msg, flush=True)


def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


def _ulp(cfg) -> float:
    return float(np.spacing(np.float32(max(cfg.world.extent))))


# ---------------------------------------------------------------- device

def phase_device(devices=None) -> dict:
    """Require a GPU; print what JAX and nvidia-smi report. Raises
    RuntimeError when JAX finds no GPU — there is no CPU fallback."""
    devs = list(devices if devices is not None else jax.devices())
    d = devs[0]
    if d.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX found platform {d.platform!r} "
                           f"({d.device_kind}); chip_smoke needs a GPU")
    from bench import card_name_and_power_limit
    smi = card_name_and_power_limit()
    _log(f"[device] platform={d.platform} kind={d.device_kind} "
         f"count={len(devs)} jax={jax.__version__}")
    _log("[device] nvidia-smi --query-gpu=name,power.limit:")
    _log(smi)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def _peak_bytes(device) -> int:
    stats = device.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


# --------------------------------------------------------------- service

def _http(base: str, method: str, path: str, body=None):
    """One request; returns (status, payload, ms). A non-2xx status raises
    urllib.error.HTTPError, which fails the phase."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=900) as r:
        payload = json.loads(r.read())
        code = r.status
    return code, payload, _ms(t0)


def phase_service(num_vehicles: int = 10_000, n_updates: int = 100,
                  seed: int = 0, max_heal_steps: int = 6) -> dict:
    """The served deployment end to end over HTTP. Returns the counters it
    asserted on."""
    import collide as tc
    from collide.api.stdlib_server import SceneHTTPServer
    from collide.core.config import DetectionConfig
    from collide.sim import generate_fleet
    from collide.system import CollisionSystem

    cfg = tc.SystemConfig(num_objects=num_vehicles,
                          detect=DetectionConfig(mode="precise"))
    fleet = generate_fleet(jax.random.key(seed), cfg,
                           distribution="city_skew")
    rng = np.random.default_rng(seed)
    pos = np.asarray(fleet.pos)
    result = {}

    async def run():
        system = CollisionSystem(cfg, node_id="smoke", detection_hz=2.0,
                                 checkpoint_every_s=0)
        await system.start()
        server = SceneHTTPServer(system.scene, port=0,
                                 scheduler=system.scheduler)
        base = f"http://127.0.0.1:{server.start()}"
        loop = asyncio.get_running_loop()

        async def call(method, path, body=None):
            code, payload, ms = await loop.run_in_executor(
                None, _http, base, method, path, body)
            assert code == 200 and payload["success"], (path, payload)
            return payload["data"], ms

        try:
            system.scene.adopt_fleet(
                fleet, ids=[f"v{i}" for i in range(num_vehicles)])
            lat = []
            for i in rng.choice(num_vehicles, n_updates, replace=False):
                p = pos[i]
                _, ms = await call("POST", "/vehicles/location", {
                    "vehicle_id": f"v{i}",
                    "position": {"x": float(p[0]), "y": float(p[1]),
                                 "z": 0.0},
                    "velocity": {"x": 10.0, "y": 0.0, "z": 0.0},
                    "heading": 0.0})
                lat.append(ms)
            lat.sort()
            _log(f"[service] {n_updates} POST /vehicles/location: "
                 f"p50={lat[len(lat) // 2]:.3f} ms "
                 f"max={lat[-1]:.3f} ms (all 200)")

            # plain steps until the self-heals have sized the capacities
            for k in range(max_heal_steps):
                data, ms = await call("POST", "/step", {"steps": 1})
                _log(f"[service] POST /step #{k + 1}: {ms:.3f} ms "
                     f"risks={data['num_risks']} "
                     f"alerts={data['num_alerts']} "
                     f"overflow={data['overflow']} "
                     f"alert_overflow={data['alert_overflow']}")
                if data["overflow"] == 0 and data["alert_overflow"] == 0:
                    break
            assert data["overflow"] == 0 and data["alert_overflow"] == 0, \
                f"certificates still nonzero after {max_heal_steps} steps"
            result["regrows"] = system.scene.regrows
            result["cell_capacity"] = system.scene.cfg.grid.cell_capacity
            # the same call once the healed program is compiled
            for k in range(3):
                data, ms = await call("POST", "/step", {"steps": 1})
                _log(f"[service] POST /step (compiled) #{k + 1}: "
                     f"{ms:.3f} ms risks={data['num_risks']} "
                     f"overflow={data['overflow']} "
                     f"alert_overflow={data['alert_overflow']}")
                assert data["overflow"] == 0 and data["alert_overflow"] == 0

            data, ms = await call("POST", "/step",
                                  {"steps": 4, "burst": True})
            _log(f"[service] POST /step burst(4): {ms:.3f} ms "
                 f"risks={data['num_risks']} overflow={data['overflow']} "
                 f"alert_overflow={data['alert_overflow']}")
            assert data["overflow"] == 0 and data["alert_overflow"] == 0
            # one-behind serving: a response describes the previous step;
            # it reports pending when nothing was left to consume (the
            # first call, or the 2 Hz detection loop drained it first)
            for k in range(6):
                data, ms = await call("POST", "/step", {"pipelined": True})
                _log(f"[service] POST /step pipelined #{k + 1}: "
                     f"{ms:.3f} ms {data}")
                if not data.get("pipelined_pending"):
                    break
            assert data["overflow"] == 0 and data["alert_overflow"] == 0
            alerts, ms = await call("GET", "/alerts")
            _log(f"[service] GET /alerts: {ms:.3f} ms, {len(alerts)} alerts")
            assert alerts, "the alert list is empty"
            stats, ms = await call("GET", "/stats")
            _log(f"[service] GET /stats: {ms:.3f} ms num_alive="
                 f"{stats['num_alive']} steps={stats['step_count']} "
                 f"regrows={stats['regrows']} "
                 f"cell_capacity={stats['config']['cell_capacity']}")
            assert stats["num_alive"] == num_vehicles
            result.update(alerts=len(alerts), steps=stats["step_count"])
        finally:
            server.stop()
            await system.stop()

    asyncio.run(run())
    return result


# ----------------------------------------------------------------- scale

def size_capacity(cfg, fleet, keys, margin: int = 2) -> int:
    """Fleet-exact cell_capacity over the run's own trajectory: physics is
    replayed for `keys` and each state is sized by
    kernels/tune.suggest_cell_capacity (set-up, not timed)."""
    from collide.kernels.tune import suggest_cell_capacity
    from collide.sim.integrator import integrate
    adv = jax.jit(lambda s, k: integrate(s, k, cfg))
    cap, st = 0, fleet
    for k in keys:
        st = adv(st, k)
        cap = max(cap, suggest_cell_capacity(st, cfg, margin=margin))
    return cap


def run_scale(tag: str, cfg, fleet, chunk_size, steps: int = 3) -> dict:
    """Warm + `steps` timed steps of the public make_step program with every
    output consumed (bench._consume); asserts conservation and both
    completeness certificates on every step."""
    from bench import _consume
    from collide.engine import make_step

    stepf = make_step(cfg, donate=False, chunk_size=chunk_size)

    def one(st, k):
        st, out = stepf(st, k)
        return st, _consume(out), jnp.stack(
            [out.num_alive, out.overflow, out.alert_overflow,
             out.num_risks])

    run = jax.jit(one, donate_argnums=(0,))
    t0 = time.perf_counter()
    compiled = run.lower(fleet, jax.random.key(1)).compile()
    mem = compiled.memory_analysis()
    compile_ms = _ms(t0)
    temp = getattr(mem, "temp_size_in_bytes", -1)
    st, c, ctr = compiled(fleet, jax.random.key(1))       # warm
    jax.block_until_ready((st, c, ctr))
    times, risks = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        st, c, ctr = compiled(st, jax.random.key(2 + i))
        jax.block_until_ready((st, c, ctr))
        times.append(_ms(t0))
        alive, of, ao, nr = (int(v) for v in np.asarray(ctr))
        assert alive == cfg.num_objects, (tag, "num_alive", alive)
        assert of == 0 and ao == 0, (tag, "overflow", of, ao)
        assert np.isfinite(float(c)), (tag, "non-finite output")
        risks.append(nr)
    peak = _peak_bytes(jax.devices()[0])
    _log(f"[scale] {tag}: N={cfg.num_objects} "
         f"cell_capacity={cfg.grid.cell_capacity} K={cfg.max_candidates} "
         f"chunk={chunk_size} compile={compile_ms:.1f} ms "
         f"step_ms={['%.3f' % t for t in times]} "
         f"mean={sum(times) / len(times):.3f} ms risks={risks} "
         f"overflow=0 alert_overflow=0 temp_bytes={temp} "
         f"process_peak_bytes={peak}")
    return {"ms": times, "risks": risks, "peak_bytes": peak,
            "chunk": chunk_size, "cell_capacity": cfg.grid.cell_capacity}


def scale_configs():
    """(100k-2D precise, 1M-3D fast): BASELINE.json configs 3 and 4 as
    bench.py --full runs them."""
    from bench import precise, scale_configs as bench_configs
    cfg100k, cfg1m = bench_configs()
    return precise(cfg100k), cfg1m


def _with_capacity(cfg, cap):
    return cfg.replace(grid=dataclasses.replace(cfg.grid, cell_capacity=cap))


def phase_scale(configs=None, steps: int = 3, predict_n: int = 100_000,
                budget_bytes: float = 16e9) -> dict:
    from collide.api import Scene
    from collide.sim import generate_fleet

    out = {}
    keys = [jax.random.key(1 + i) for i in range(steps + 1)]
    for tag, cfg in zip(("100k_2d_precise", "1m_3d_fast"),
                        configs or scale_configs()):
        fleet = generate_fleet(jax.random.key(0), cfg,
                               distribution="uniform")
        cfg = _with_capacity(cfg, size_capacity(cfg, fleet, keys))
        out[tag] = run_scale(tag, cfg, fleet, chunk_for(cfg, budget_bytes),
                             steps)
        del fleet

    # trajectory prediction through the public Scene surface, as
    # bench.py --full runs it: fast-mode 100k city-skew fleet, the gather
    # path at its configured capacity (auto_heal=False), truncation counted
    from bench import scale_configs as bench_configs
    cfg = bench_configs()[0].replace(num_objects=predict_n)
    sc = Scene(cfg, state=generate_fleet(jax.random.key(5), cfg),
               auto_heal=False)
    for _ in range(3):
        sc.record_trajectories()
    t0 = time.perf_counter()
    sc.predict()
    first = _ms(t0)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        risks = sc.predict()
        times.append(_ms(t0))
    _log(f"[scale] predict N={predict_n}: first call (compile) "
         f"{first:.1f} ms, then {['%.3f' % t for t in times]} ms, "
         f"{len(risks)} predicted risks, overflow counter "
         f"{sc.last_predict_overflow} (cell_capacity "
         f"{sc.cfg.grid.cell_capacity}, auto_heal off)")
    out["predict"] = {"ms": times, "risks": len(risks),
                      "overflow": sc.last_predict_overflow}
    return out


# ---------------------------------------------------------------- parity

def near_threshold(st, pairs, cfg, values=None,
                   risk_band: float = RISK_ATOL) -> set:
    """Pairs whose CPU-side quantities sit within tolerance of a threshold
    the pipeline branches on, where two correct f32 evaluations may fall on
    different sides: the search radius, the stage-2 rel-speed floor, t* at
    0 or the window, the closest distance or any 0.1 s stage-3 sample
    against the safe distance (this also covers the priority ttc edges:
    ttc is the sample lattice value k * dt on every backend, so it moves
    only when the first-hit sample does), and — from `values`
    {(i, j): risk} — risk within `risk_band` of risk_low / medium / high.
    Evaluated in float64 on host arrays."""
    det, al = cfg.detect, cfg.alerts
    tol_d = ULPS * _ulp(cfg)
    pos, vel, acc, size = (np.asarray(getattr(st, f), np.float64)
                           for f in ("pos", "vel", "acc", "size"))
    out = set()
    if not pairs:
        return out
    ij = np.asarray(sorted(pairs), np.int64)
    i, j = ij[:, 0], ij[:, 1]
    p = pos[j] - pos[i]
    v = vel[j] - vel[i]
    a = acc[j] - acc[i]
    safe = (size[i] + size[j]) / 2 + det.safe_distance_base
    rs = np.linalg.norm(v, axis=1)
    t_star = -np.sum(p * v, axis=1) / np.where(rs > 0, rs * rs, 1.0)
    dist_at = lambda t, aa: np.linalg.norm(
        p + v * t[:, None] + 0.5 * aa * (t * t)[:, None], axis=1)
    near = np.abs(np.linalg.norm(p, axis=1) - det.search_radius) <= tol_d
    near |= np.abs(rs - det.min_relative_speed) <= EDGE_T
    near |= (np.abs(t_star) <= EDGE_T) | \
        (np.abs(t_star - det.time_window) <= EDGE_T)
    near |= np.abs(dist_at(t_star, a) - safe) <= tol_d
    for k in range(det.num_time_steps):
        t = np.full(len(ij), np.float32(k) * np.float32(det.time_step),
                    np.float64)
        near |= np.abs(dist_at(t, a) - safe) <= tol_d
        near |= np.abs(dist_at(t, 0.0) - safe) <= tol_d   # fast mode
    for n_, (ii, jj) in zip(near, ij):
        key = (int(ii), int(jj))
        if n_:
            out.add(key)
        elif values and key in values:
            r = values[key]
            if min(abs(r - al.risk_low), abs(r - al.risk_medium),
                   abs(r - al.risk_high)) <= risk_band:
                out.add(key)
    return out


def compare_pairs(tag, got: dict, want: dict, st, cfg,
                  risk_atol: float | None = None) -> dict:
    """got/want: {(i, j): (risk, ttc, distance)}. Pair sets must be equal
    and values within tolerance, except for near-threshold pairs, which are
    counted and excluded. Raises AssertionError on a mismatch."""
    tol_d = ULPS * _ulp(cfg)
    # risk inherits the distance term through 0.3 * distance / safe
    risk_atol = (RISK_ATOL + 0.3 * tol_d / 6.0 if risk_atol is None
                 else risk_atol)
    values = {k: v[0] for k, v in want.items()}
    values.update({k: v[0] for k, v in got.items() if k not in values})
    near = near_threshold(st, set(got) | set(want), cfg, values, risk_atol)
    only_got = set(got) - set(want) - near
    only_want = set(want) - set(got) - near
    assert not only_got and not only_want, (
        tag, "pair sets differ", sorted(only_got)[:8], sorted(only_want)[:8])
    worst = [0.0, 0.0, 0.0]
    for key in (set(got) & set(want)) - near:
        (r1, t1, d1), (r0, t0, d0) = got[key], want[key]
        dr, dt, dd = abs(r1 - r0), abs(t1 - t0), abs(d1 - d0)
        assert dr <= risk_atol, (tag, key, "risk", r0, r1)
        assert dt <= RTOL * abs(t0) + 1e-6, (tag, key, "ttc", t0, t1)
        assert dd <= RTOL * abs(d0) + tol_d, (tag, key, "distance", d0, d1)
        worst = [max(worst[0], dr), max(worst[1], dt), max(worst[2], dd)]
    _log(f"[parity] {tag}: {len(want)} reference pairs, {len(got)} device "
         f"pairs, near-threshold {len(near)} (excluded), max |d risk| "
         f"{worst[0]:.3e} |d ttc| {worst[1]:.3e} s |d distance| "
         f"{worst[2]:.3e} m; tolerances risk {risk_atol:.1e}, ttc "
         f"{RTOL:.0e} rel, distance {RTOL:.0e} rel + {tol_d:.1e} m")
    return {"pairs": len(want), "near": len(near), "max_diff": worst}


def _pair_table(pairs) -> dict:
    """PairRisks -> {(i, j): (risk, ttc, distance)} on the host."""
    o, v, r, t, d = (np.asarray(x) for x in (
        pairs.other, pairs.valid, pairs.risk, pairs.ttc, pairs.distance))
    rows, cols = np.nonzero(v)
    return {(int(i), int(o[i, s])): (float(r[i, s]), float(t[i, s]),
                                     float(d[i, s]))
            for i, s in zip(rows, cols)}


def oracle_pairs(st, cfg) -> dict:
    """The NumPy oracle (tests/oracle.py, the literal reference stage math)
    over every ordered pair within the search radius (+1 m slack; the
    oracle applies the exact radius itself)."""
    import importlib.util
    import os
    # loaded by path: another installed package may own the name `tests`
    spec = importlib.util.spec_from_file_location(
        "collide_reference_oracle", os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tests", "oracle.py"))
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    oracle_detect_pair = oracle.oracle_detect_pair
    pos, vel, acc, size, heading, otype = (
        np.asarray(getattr(st, f)) for f in
        ("pos", "vel", "acc", "size", "heading", "otype"))
    det = cfg.detect
    d2 = ((pos[:, None, :].astype(np.float64) - pos[None, :, :]) ** 2).sum(-1)
    cand = np.argwhere(d2 <= (det.search_radius + 1.0) ** 2)
    out = {}
    for i, j in cand:
        if i == j:
            continue
        r = oracle_detect_pair(
            pos[i], vel[i], acc[i], size[i], heading[i], otype[i],
            pos[j], vel[j], acc[j], size[j], heading[j], otype[j],
            search_radius=det.search_radius, time_window=det.time_window,
            time_step=det.time_step, safe_base=det.safe_distance_base,
            max_warning_time=det.max_warning_time,
            max_rel_speed=det.max_relative_speed)
        if r is not None:
            out[(int(i), int(j))] = r
    return out


def parity_oracle(n: int = 1000, device=None, cpu=None, seed: int = 42):
    """(a) make_detect on `device` against the NumPy oracle on the host —
    and against the same program on the CPU backend — for the city-skew
    fleet, in both detection modes."""
    import collide as tc
    from collide.core.config import DetectionConfig
    from collide.engine import make_detect
    from collide.kernels.tune import suggest_cell_capacity
    from collide.sim import generate_fleet

    device = device or jax.devices()[0]
    cpu = cpu or jax.devices("cpu")[0]
    cfg = tc.SystemConfig(num_objects=n)
    st = jax.device_get(generate_fleet(jax.random.key(seed), cfg))
    cfg = _with_capacity(cfg, suggest_cell_capacity(st, cfg))
    t0 = time.perf_counter()
    want = oracle_pairs(st, cfg)
    _log(f"[parity] oracle: {n} city-skew vehicles, {len(want)} pairs in "
         f"{_ms(t0):.1f} ms (host NumPy)")
    res = {}
    for mode in ("precise", "fast"):
        c = cfg.replace(detect=DetectionConfig(mode=mode))
        det = make_detect(c)
        got = _pair_table(det(jax.device_put(st, device)))
        cpu_got = _pair_table(det(jax.device_put(st, cpu)))
        res[mode] = compare_pairs(f"(a) {mode} device vs oracle", got, want,
                                  st, c)
        compare_pairs(f"(a) {mode} device vs cpu backend", got, cpu_got,
                      st, c)
    return res


def _alert_table(out) -> dict:
    """Unordered alert pairs -> (risk, ttc, distance)."""
    a = jax.device_get(out.alerts)
    v = np.asarray(a.valid)
    return {(min(int(x), int(y)), max(int(x), int(y))):
            (float(r), float(t), float(d))
            for x, y, r, t, d in zip(
                np.asarray(a.vehicle_oid)[v], np.asarray(a.other_oid)[v],
                np.asarray(a.risk)[v], np.asarray(a.ttc)[v],
                np.asarray(a.distance)[v])}


def parity_backends(n: int = 100_000, device=None, cpu=None,
                    seed: int = 3, world: float = 10_000.0):
    """(b) one 100k-2D fast step on `device` against the same step, state
    and key on the CPU backend (jax.random bits do not depend on the
    backend)."""
    import collide as tc
    from collide.core.config import (AlertConfig, DetectionConfig,
                                     GridConfig, WorldConfig)
    from collide.engine import make_step
    from collide.sim import generate_fleet

    device = device or jax.devices()[0]
    cpu = cpu or jax.devices("cpu")[0]
    cfg = tc.SystemConfig(
        num_objects=n, world=WorldConfig(hi=(world, world, 0.)),
        grid=GridConfig(cell_size=100.0),
        detect=DetectionConfig(mode="fast"),
        alerts=AlertConfig(max_scene_alerts=min(1 << 17, 8 * n)))
    fleet = jax.device_get(generate_fleet(jax.random.key(seed), cfg,
                                          distribution="uniform"))
    key = jax.random.key(seed + 1)
    cfg = _with_capacity(cfg, size_capacity(cfg, fleet, [key]))
    stepf = make_step(cfg, donate=False)
    t0 = time.perf_counter()
    st_g, out_g = jax.device_get(stepf(jax.device_put(fleet, device),
                                       jax.device_put(key, device)))
    ms_g = _ms(t0)
    t0 = time.perf_counter()
    st_c, out_c = jax.device_get(stepf(jax.device_put(fleet, cpu),
                                       jax.device_put(key, cpu)))
    ms_c = _ms(t0)
    for o in (out_g, out_c):
        assert int(o.overflow) == 0 and int(o.alert_overflow) == 0
        assert int(o.alerts.count) < cfg.alerts.max_scene_alerts, \
            "alert budget bound: raise max_scene_alerts for the compare"
    dpos = np.abs(np.asarray(st_g.pos, np.float64) - np.asarray(st_c.pos))
    _log(f"[parity] (b) {n} fast step: device {ms_g:.1f} ms, cpu backend "
         f"{ms_c:.1f} ms (both incl. compile); max |d pos| after physics "
         f"{dpos.max():.3e} m ({dpos.max() / _ulp(cfg):.2f} world ulps); "
         f"risks {int(out_g.num_risks)} vs {int(out_c.num_risks)}, pairs "
         f"checked {int(out_g.num_pairs_checked)} vs "
         f"{int(out_c.num_pairs_checked)}")
    res = compare_pairs("(b) step alerts device vs cpu backend",
                        _alert_table(out_g), _alert_table(out_c), st_c, cfg)
    # per-direction counts may differ only by near-threshold pairs (each
    # unordered alert pair stands for both directions)
    assert abs(int(out_g.num_risks) - int(out_c.num_risks)) <= \
        2 * res["near"], "risk counts differ beyond near-threshold pairs"
    return res


def parity_head_on(device=None) -> float:
    """(c) two cars 100 m apart closing at 20 m/s: safe distance 7 m is
    first reached on the 4.70 s sample."""
    import collide as tc
    from collide.core.config import WorldConfig
    from collide.core.state import state_from_numpy
    from collide.engine import make_detect

    st = state_from_numpy(
        np.array([[0, 0, 0], [100, 0, 0]], np.float32),
        np.array([[10, 0, 0], [-10, 0, 0]], np.float32),
        np.zeros((2, 3), np.float32), np.array([0, np.pi], np.float32),
        np.full(2, 2.0, np.float32), np.zeros(2, np.int32))
    cfg = tc.SystemConfig(num_objects=2,
                          world=WorldConfig(hi=(200., 200., 0.)))
    ttc = float(make_detect(cfg)(
        jax.device_put(st, device or jax.devices()[0])).ttc.min())
    _log(f"[parity] (c) head-on probe ttc = {ttc:.6f} s (want 4.70)")
    assert abs(ttc - 4.7) < 1e-5, ttc
    return ttc


def phase_parity(n_oracle: int = 1000, n_backend: int = 100_000,
                 device=None, cpu=None) -> dict:
    return {"oracle": parity_oracle(n_oracle, device, cpu),
            "backends": parity_backends(n_backend, device, cpu),
            "head_on": parity_head_on(device)}


# --------------------------------------------------------------- sharded

def sharded_config(n: int, world: float):
    """The 1M-object 2D fleet of the sharded phase: uniform over a
    `world`-metre square (50 km at 1M: ~4 objects per 100 m cell). Physics
    without random acceleration changes, so the per-shard key folding
    cannot change trajectories and the one-card step is an exact
    reference."""
    import collide as tc
    from collide.core.config import (AlertConfig, DetectionConfig,
                                     GridConfig, ShardConfig, SimConfig,
                                     WorldConfig)
    return tc.SystemConfig(
        num_objects=n, world=WorldConfig(hi=(world, world, 0.)),
        grid=GridConfig(cell_size=100.0),
        detect=DetectionConfig(mode="fast"),
        sim=SimConfig(accel_change_prob=0.0),
        alerts=AlertConfig(max_scene_alerts=1 << 18),
        shard=ShardConfig(halo_capacity=8192, migrate_capacity=1024))


def phase_sharded(devices=None, n: int = 1_000_000,
                  world: float = 50_000.0, seed: int = 0) -> dict:
    """make_sharded_step on a 4-slab x mesh and a 2x2 (x, y) mesh against
    make_step on one card: same fleet and key, num_risks and unordered
    alert sets equal; every card's memory used."""
    from collide.engine import make_step
    from collide.shard import distribute_state, make_mesh, make_sharded_step
    from collide.sim import generate_fleet

    devices = list(devices or jax.devices()[:4])
    assert len(devices) == 4, f"--multi 4 needs 4 devices, have {devices}"
    cfg = sharded_config(n, world)
    fleet = jax.device_get(generate_fleet(jax.random.key(seed), cfg,
                                          distribution="uniform"))
    key = jax.random.key(seed + 1)
    cfg = _with_capacity(cfg, size_capacity(cfg, fleet, [key]))

    t0 = time.perf_counter()
    _, ref = make_step(cfg, donate=False, chunk_size=chunk_for(cfg))(
        jax.device_put(fleet, devices[0]), jax.device_put(key, devices[0]))
    ref = jax.device_get(ref)
    _log(f"[sharded] one card: N={n} risks={int(ref.num_risks)} "
         f"alerts={int(ref.alerts.count)} overflow={int(ref.overflow)} "
         f"({_ms(t0):.1f} ms incl. compile)")
    assert int(ref.overflow) == 0 and int(ref.alert_overflow) == 0
    assert int(ref.alerts.count) < cfg.alerts.max_scene_alerts
    want = set(_alert_table(ref))
    res = {}
    for name, dx, dy in (("x4", 4, 1), ("2x2", 2, 2)):
        c = cfg.replace(shard=dataclasses.replace(
            cfg.shard, num_shards=dx, num_shards_y=dy))
        mesh = make_mesh(c, devices)
        st = distribute_state(fleet, c, mesh)
        stepf = make_sharded_step(c, mesh, donate=False)
        t0 = time.perf_counter()
        st2, out, dropped = jax.block_until_ready(stepf(st, key))
        first = _ms(t0)
        t0 = time.perf_counter()
        jax.block_until_ready(stepf(st, key))
        steady = _ms(t0)
        out = jax.device_get(out)
        drop = int(np.asarray(dropped).sum())
        got = set(_alert_table(out))
        per_dev = [_peak_bytes(d) for d in devices]
        shard_bytes = [sum(s.data.nbytes for s in st2.pos.addressable_shards
                           if s.device == d) for d in devices]
        _log(f"[sharded] {name} mesh: risks={int(out.num_risks)} alerts="
             f"{len(got)} dropped={drop} overflow={int(out.overflow)} "
             f"first={first:.1f} ms steady={steady:.3f} ms "
             f"pos_bytes_per_device={shard_bytes} "
             f"peak_bytes_per_device={per_dev}")
        assert drop == 0 and int(out.overflow) == 0
        assert int(out.num_alive) == n
        assert int(out.num_risks) == int(ref.num_risks), (name, "num_risks")
        assert got == want, (name, "alert sets differ",
                             len(got - want), len(want - got))
        assert all(b > 0 for b in shard_bytes), (name, "idle device")
        res[name] = {"risks": int(out.num_risks), "alerts": len(got),
                     "steady_ms": steady, "peak_bytes": per_dev}
    return res


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", type=int, choices=(4,), default=None,
                    help="run only the sharded path on this many cards")
    args = ap.parse_args(argv)
    if not __debug__:
        raise SystemExit("chip_smoke: the phases check their results with "
                         "assert; run without -O")
    enable_compile_cache()
    try:
        dev = phase_device()
    except RuntimeError as e:
        raise SystemExit(f"chip_smoke: {e}")
    t0 = time.perf_counter()
    if args.multi:
        if dev["count"] < args.multi:
            raise SystemExit(f"chip_smoke: --multi {args.multi} needs "
                             f"{args.multi} GPUs, JAX found {dev['count']}")
        phase_sharded(jax.devices()[:args.multi])
    else:
        phase_service()
        phase_parity()
        phase_scale()
    _log(f"[done] all phases passed in {_ms(t0) / 1e3:.1f} s")
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
