"""Device-side movement modes: the VehicleSimulator scenario semantics
(sim/traffic.py, reference vehicle_simulator.py:436-719) vectorized so
road-constrained / destination-oriented fleets run at 100k+ on the device
instead of through per-vehicle host ingest.

Design:
  * the TrafficMap compiles to SoA tables (RoadTable / CityTable) gathered
    per object inside the jitted step;
  * per-object scenario state (mode, current road, destination target)
    rides in a ScenarioState pytree next to ObjectState;
  * `scenario_integrate` computes all three mode updates vectorized and
    selects per object by mode code — 3x the integrator math, which is
    noise next to detection;
  * detection/alerts reuse the engine tail (engine.detect_and_alerts) so
    scenario steps get the identical hot path, in either detection mode.

Semantics follow sim/traffic.py (which the parity tests pin host-vs-device):
random = accel jitter + soft 0.5 bounce (:245-266); road = project/advance/
switch-at-end (:267-324); destination = steer at 2 m/s^2, arrive < 20 m,
re-target 70% city-biased (:325-355). Deviations (documented): randomness
is counter-based jax.random, not Python Random, and the next road at a
segment end is a per-(road, step) pseudo-random pick among connections via
a fixed connection table instead of the host's stateful rng.choice.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from collide.core.config import SystemConfig
from collide.core.state import ObjectState
from collide.sim.traffic import TrafficMap, VehicleSimulator

MODE_RANDOM, MODE_ROAD, MODE_DEST = 0, 1, 2
_MODE_CODES = {"random": MODE_RANDOM, "road_constrained": MODE_ROAD,
               "destination_oriented": MODE_DEST}
_MAX_CONN = 4     # connection slots per road (grid maps have <= 4)


@partial(jax.tree_util.register_dataclass,
         data_fields=["start", "dirn", "length", "speed", "conn", "n_conn"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class RoadTable:
    """SoA road network. conn[R, _MAX_CONN] int32 lists connected road ids
    (-1 padding); n_conn[R] counts them."""
    start: jax.Array    # [R, 2] f32
    dirn: jax.Array     # [R, 2] f32 unit direction
    length: jax.Array   # [R] f32
    speed: jax.Array    # [R] f32 speed limit
    conn: jax.Array     # [R, _MAX_CONN] i32
    n_conn: jax.Array   # [R] i32


@partial(jax.tree_util.register_dataclass,
         data_fields=["center", "radius"], meta_fields=[])
@dataclasses.dataclass(frozen=True)
class CityTable:
    center: jax.Array   # [C, 2] f32
    radius: jax.Array   # [C] f32


@partial(jax.tree_util.register_dataclass,
         data_fields=["mode", "road", "target", "target_ok"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class ScenarioState:
    mode: jax.Array       # [N] i32 MODE_*
    road: jax.Array       # [N] i32 current road (-1 = none)
    target: jax.Array     # [N, 2] f32 destination
    target_ok: jax.Array  # [N] bool target valid

    def replace(self, **kw) -> "ScenarioState":
        return dataclasses.replace(self, **kw)


def build_road_table(tmap: TrafficMap) -> Tuple[RoadTable, dict]:
    """Compile a TrafficMap's roads to arrays. Returns (table,
    road_id -> index map). Connections keep only existing roads (the
    reference's grid generator links a phantom edge road —
    vehicle_simulator.py:256-258)."""
    rids = sorted(tmap.roads)
    idx = {rid: i for i, rid in enumerate(rids)}
    r = len(rids)
    start = np.zeros((max(r, 1), 2), np.float32)
    dirn = np.zeros((max(r, 1), 2), np.float32)
    dirn[:, 0] = 1.0
    length = np.ones(max(r, 1), np.float32)
    speed = np.full(max(r, 1), 13.9, np.float32)
    conn = np.full((max(r, 1), _MAX_CONN), -1, np.int32)
    n_conn = np.zeros(max(r, 1), np.int32)
    for rid in rids:
        i = idx[rid]
        road = tmap.roads[rid]
        start[i] = (road.start.x, road.start.y)
        d = road.direction()
        dirn[i] = d
        length[i] = max(road.length, 0.1)
        speed[i] = road.speed_limit
        cs = [idx[c] for c in sorted(set(tmap.road_connections.get(rid, [])))
              if c in idx][: _MAX_CONN]
        conn[i, :len(cs)] = cs
        n_conn[i] = len(cs)
    return RoadTable(jnp.asarray(start), jnp.asarray(dirn),
                     jnp.asarray(length), jnp.asarray(speed),
                     jnp.asarray(conn), jnp.asarray(n_conn)), idx


def build_city_table(tmap: TrafficMap) -> CityTable:
    cs = sorted(tmap.cities)
    if not cs:
        return CityTable(jnp.zeros((1, 2), jnp.float32),
                         jnp.zeros(1, jnp.float32))
    center = np.array([(tmap.cities[c].center.x, tmap.cities[c].center.y)
                       for c in cs], np.float32)
    radius = np.array([tmap.cities[c].radius for c in cs], np.float32)
    return CityTable(jnp.asarray(center), jnp.asarray(radius))


def init_scenario(n: int, mode: str = "road_constrained",
                  roads: Optional[RoadTable] = None,
                  key: Optional[jax.Array] = None) -> ScenarioState:
    """Fresh scenario state: every object in `mode`; road mode gets a
    random road assignment."""
    code = _MODE_CODES[mode]
    road = jnp.full(n, -1, jnp.int32)
    if code == MODE_ROAD:
        assert roads is not None and key is not None
        road = jax.random.randint(key, (n,), 0, roads.length.shape[0],
                                  jnp.int32)
    return ScenarioState(
        mode=jnp.full(n, code, jnp.int32), road=road,
        target=jnp.zeros((n, 2), jnp.float32),
        target_ok=jnp.zeros(n, bool))


def scenario_from_simulator(sim: VehicleSimulator, road_idx: dict,
                            order=None) -> Tuple[ObjectState, ScenarioState]:
    """Lift a host VehicleSimulator's exact fleet + scenario bookkeeping to
    device state (used by the host/device parity tests and by migration of
    host scenarios onto the engine)."""
    from collide.core.state import state_from_numpy

    vids = order or sorted(sim.vehicles)
    n = len(vids)
    pos = np.zeros((n, 3), np.float32)
    vel = np.zeros((n, 3), np.float32)
    acc = np.zeros((n, 3), np.float32)
    heading = np.zeros(n, np.float32)
    size = np.zeros(n, np.float32)
    mode = np.zeros(n, np.int32)
    road = np.full(n, -1, np.int32)
    target = np.zeros((n, 2), np.float32)
    target_ok = np.zeros(n, bool)
    for i, vid in enumerate(vids):
        v = sim.vehicles[vid]
        pos[i] = (v.position.x, v.position.y, 0.0)
        vel[i] = (v.velocity.x, v.velocity.y, 0.0)
        acc[i] = (v.acceleration.x, v.acceleration.y, 0.0)
        heading[i] = v.heading
        size[i] = v.size
        mode[i] = _MODE_CODES[sim.vehicle_modes.get(vid, "random")]
        rid = sim.vehicle_roads.get(vid)
        if rid in road_idx:
            road[i] = road_idx[rid]
        t = sim.vehicle_targets.get(vid)
        if t is not None:
            target[i] = (t.x, t.y)
            target_ok[i] = True
    state = state_from_numpy(pos, vel, acc, heading, size,
                             np.zeros(n, np.int32))
    scen = ScenarioState(mode=jnp.asarray(mode), road=jnp.asarray(road),
                         target=jnp.asarray(target),
                         target_ok=jnp.asarray(target_ok))
    return state, scen


def scenario_integrate(state: ObjectState, scen: ScenarioState,
                       key: jax.Array, cfg: SystemConfig,
                       roads: RoadTable, cities: CityTable
                       ) -> Tuple[ObjectState, ScenarioState]:
    """One physics step under per-object movement modes (2D scenarios)."""
    sim = cfg.sim
    dt = sim.dt
    n = state.n
    w = cfg.world.hi[0] - cfg.world.lo[0]
    h = cfg.world.hi[1] - cfg.world.lo[1]
    lo_x, lo_y = cfg.world.lo[0], cfg.world.lo[1]
    hi_x, hi_y = cfg.world.hi[0], cfg.world.hi[1]
    px, py = state.pos[:, 0], state.pos[:, 1]
    vx, vy = state.vel[:, 0], state.vel[:, 1]
    ax, ay = state.acc[:, 0], state.acc[:, 1]

    ks = jax.random.split(key, 10)
    jit_draw = jax.random.uniform(ks[0], (n,))
    jit_val = jax.random.uniform(ks[1], (n,), minval=-sim.accel_range,
                                 maxval=sim.accel_range)
    jitter = jit_draw < sim.accel_change_prob

    def cap(vx_, vy_, limit):
        sp = jnp.sqrt(vx_ * vx_ + vy_ * vy_)
        sc = jnp.where(sp > limit, limit / jnp.maximum(sp, 1e-9), 1.0)
        return vx_ * sc, vy_ * sc, jnp.minimum(sp, limit)

    # ---- mode 0: random (traffic.py:245-266 — soft 0.5 bounce) ----
    jy = jax.random.uniform(ks[2], (n,), minval=-sim.accel_range,
                            maxval=sim.accel_range)
    r_ax = jnp.where(jitter, jit_val, ax)
    r_ay = jnp.where(jitter, jy, ay)
    r_vx, r_vy = vx + r_ax * dt, vy + r_ay * dt
    r_vx, r_vy, r_sp = cap(r_vx, r_vy, sim.max_speed)
    r_px, r_py = px + r_vx * dt, py + r_vy * dt
    r_head = jnp.where(r_sp > sim.min_heading_speed,
                       jnp.arctan2(r_vy, r_vx), state.heading)
    under_x, over_x = r_px < lo_x, r_px > hi_x
    under_y, over_y = r_py < lo_y, r_py > hi_y
    r_vx = jnp.where(under_x | over_x, -r_vx * 0.5, r_vx)
    r_vy = jnp.where(under_y | over_y, -r_vy * 0.5, r_vy)
    r_px = jnp.clip(r_px, lo_x, hi_x)
    r_py = jnp.clip(r_py, lo_y, hi_y)

    # ---- mode 1: road-constrained (traffic.py:267-324) ----
    rid = jnp.clip(scen.road, 0, roads.length.shape[0] - 1)
    on_road = scen.road >= 0
    sx, sy = roads.start[rid, 0], roads.start[rid, 1]
    dx, dy = roads.dirn[rid, 0], roads.dirn[rid, 1]
    rlen = roads.length[rid]
    rlim = roads.speed[rid]
    along = (px - sx) * dx + (py - sy) * dy
    at_end = along >= rlen
    at_start = along < 0.0

    # next road: pseudo-random among this road's connections
    pick = jax.random.randint(ks[3], (n,), 0, _MAX_CONN)
    pick = jnp.minimum(pick, jnp.maximum(roads.n_conn[rid] - 1, 0))
    nxt = roads.conn[rid, pick]
    has_next = (roads.n_conn[rid] > 0) & (nxt >= 0)
    nclip = jnp.clip(nxt, 0, roads.length.shape[0] - 1)
    speed_now = jnp.sqrt(vx * vx + vy * vy)
    nx_dx, nx_dy = roads.dirn[nclip, 0], roads.dirn[nclip, 1]

    # in-segment advance
    a_mag = jnp.where(jitter, jit_val, ax * dx + ay * dy)
    g_ax, g_ay = a_mag * dx, a_mag * dy
    g_vx, g_vy = vx + g_ax * dt, vy + g_ay * dt
    g_vx, g_vy, g_sp = cap(g_vx, g_vy, rlim)
    wrong_way = g_vx * dx + g_vy * dy < 0.0
    g_vx = jnp.where(wrong_way, g_sp * dx, g_vx)
    g_vy = jnp.where(wrong_way, g_sp * dy, g_vy)
    # advance then re-project onto the road line (traffic.py:316-323)
    g_along = (px + g_vx * dt - sx) * dx + (py + g_vy * dt - sy) * dy
    g_px = sx + g_along * dx
    g_py = sy + g_along * dy

    # select the three road sub-cases
    d_px = jnp.where(at_end, jnp.where(has_next, roads.start[nclip, 0],
                                       sx + rlen * dx),
                     jnp.where(at_start, sx, g_px))
    d_py = jnp.where(at_end, jnp.where(has_next, roads.start[nclip, 1],
                                       sy + rlen * dy),
                     jnp.where(at_start, sy, g_py))
    d_vx = jnp.where(at_end, jnp.where(has_next, speed_now * nx_dx, -vx),
                     jnp.where(at_start, -vx, g_vx))
    d_vy = jnp.where(at_end, jnp.where(has_next, speed_now * nx_dy, -vy),
                     jnp.where(at_start, -vy, g_vy))
    d_ax = jnp.where(at_end | at_start, ax, g_ax)
    d_ay = jnp.where(at_end | at_start, ay, g_ay)
    d_rid = jnp.where(at_end & has_next, nxt, scen.road)
    d_head = jnp.arctan2(d_vy, d_vx)
    # a roadless object behaves like mode 0 (host falls back to random,
    # traffic.py:271-274)
    rd_px = jnp.where(on_road, d_px, r_px)
    rd_py = jnp.where(on_road, d_py, r_py)
    rd_vx = jnp.where(on_road, d_vx, r_vx)
    rd_vy = jnp.where(on_road, d_vy, r_vy)
    rd_ax = jnp.where(on_road, d_ax, r_ax)
    rd_ay = jnp.where(on_road, d_ay, r_ay)
    rd_head = jnp.where(on_road, d_head, r_head)

    # ---- mode 2: destination-oriented (traffic.py:325-355) ----
    # (re)target: 70% city-biased
    want_city = jax.random.uniform(ks[4], (n,)) < 0.7
    ci = jax.random.randint(ks[5], (n,), 0, cities.radius.shape[0])
    rr = jax.random.uniform(ks[6], (n,)) * cities.radius[ci]
    th = jax.random.uniform(ks[7], (n,)) * (2.0 * jnp.pi)
    city_tx = cities.center[ci, 0] + rr * jnp.cos(th)
    city_ty = cities.center[ci, 1] + rr * jnp.sin(th)
    unif_tx = lo_x + jax.random.uniform(ks[8], (n,)) * w
    unif_ty = lo_y + jax.random.uniform(ks[9], (n,)) * h
    new_tx = jnp.where(want_city, city_tx, unif_tx)
    new_ty = jnp.where(want_city, city_ty, unif_ty)
    tx = jnp.where(scen.target_ok, scen.target[:, 0], new_tx)
    ty = jnp.where(scen.target_ok, scen.target[:, 1], new_ty)
    ddx, ddy = tx - px, ty - py
    dist = jnp.sqrt(ddx * ddx + ddy * ddy)
    arrived = dist < 20.0
    ux, uy = ddx / jnp.maximum(dist, 1e-6), ddy / jnp.maximum(dist, 1e-6)
    t_ax, t_ay = ux * 2.0, uy * 2.0
    t_vx, t_vy = vx + t_ax * dt, vy + t_ay * dt
    t_vx, t_vy, _ = cap(t_vx, t_vy, sim.max_speed)
    t_px = jnp.clip(px + t_vx * dt, lo_x, hi_x)
    t_py = jnp.clip(py + t_vy * dt, lo_y, hi_y)
    t_head = jnp.arctan2(t_vy, t_vx)
    # arrival: host deletes the target and skips physics this step
    t_px = jnp.where(arrived, px, t_px)
    t_py = jnp.where(arrived, py, t_py)
    t_vx = jnp.where(arrived, vx, t_vx)
    t_vy = jnp.where(arrived, vy, t_vy)
    t_ax2 = jnp.where(arrived, ax, t_ax)
    t_ay2 = jnp.where(arrived, ay, t_ay)
    t_head = jnp.where(arrived, state.heading, t_head)
    new_target_ok = ~arrived
    new_target = jnp.stack([tx, ty], axis=1)

    # ---- select by mode ----
    m = scen.mode

    def sel(r_, d_, t_):
        return jnp.where(m == MODE_ROAD, d_,
                         jnp.where(m == MODE_DEST, t_, r_))

    npx = sel(r_px, rd_px, t_px)
    npy = sel(r_py, rd_py, t_py)
    nvx = sel(r_vx, rd_vx, t_vx)
    nvy = sel(r_vy, rd_vy, t_vy)
    nax = sel(r_ax, rd_ax, t_ax2)
    nay = sel(r_ay, rd_ay, t_ay2)
    nhead = sel(r_head, rd_head, t_head)

    alive = state.alive
    a1 = alive[:, None]
    pos = jnp.where(a1, jnp.stack([npx, npy, state.pos[:, 2]], axis=1),
                    state.pos)
    vel = jnp.where(a1, jnp.stack([nvx, nvy, state.vel[:, 2]], axis=1),
                    state.vel)
    acc = jnp.where(a1, jnp.stack([nax, nay, state.acc[:, 2]], axis=1),
                    state.acc)
    heading = jnp.where(alive, nhead, state.heading)
    scen2 = scen.replace(
        road=jnp.where(alive & (m == MODE_ROAD), d_rid, scen.road),
        target=jnp.where((alive & (m == MODE_DEST))[:, None],
                         new_target, scen.target),
        target_ok=jnp.where(alive & (m == MODE_DEST), new_target_ok,
                            scen.target_ok))
    return state.replace(pos=pos, vel=vel, acc=acc, heading=heading), scen2


def make_scenario_step(cfg: SystemConfig, roads: RoadTable,
                       cities: CityTable, donate: bool = True):
    """Compile a full scenario step: movement-mode physics + the engine's
    detection/alert tail (same hot path as make_step)."""
    from collide.engine import detect_and_alerts

    def fn(state, scen, key):
        state, scen = scenario_integrate(state, scen, key, cfg, roads,
                                         cities)
        return state, scen, detect_and_alerts(state, cfg)

    return jax.jit(fn, donate_argnums=(0, 1) if donate else ())
