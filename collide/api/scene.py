"""Scene: the user-facing state API.

Mirrors the reference's REST semantics (api.py:147-380 — ingest a location,
read locations/history, read risks, spatial queries) as a Python class
around the device-resident fleet:

    scene.ingest([...])         <- POST /vehicles/location
    scene.step(n)               <- the EarlyWarningSystem detection loop
    scene.get_location(id)      <- GET /vehicles/{id}/location
    scene.get_history(id)       <- GET /vehicles/{id}/history
    scene.get_vehicle_risks(id) <- GET /vehicles/{id}/risks
    scene.query_radius(p, r)    <- GET /grids/{id}/vehicles (generalized)
    scene.alerts(...)           <- the alerts topic / callbacks
    scene.stats()               <- aggregate get_stats trees

Host <-> device traffic is batched: ingests buffer on the host and apply in
one scatter per step; queries run as one jitted gather.
"""
from __future__ import annotations

import threading
import time
from functools import partial
from typing import Any, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from collide.core.config import SystemConfig, VEHICLE_TYPES
from collide.core.state import ObjectState, empty_state
from collide.core.types import Alert, CollisionRisk, LocationData, Position
from collide.core.utils import Timer, get_logger
from collide.engine import make_step, make_detect
from collide.index.grid import build_grid, query_radius as _query_radius
from collide.alerts.manager import AlertManager
from collide.ckpt.checkpoint import CheckpointManager

logger = get_logger(__name__)

_TYPE_INDEX = {t: i for i, t in enumerate(VEHICLE_TYPES)}


def _pad_len(n: int) -> int:
    """Bucket ingest batches to powers of two (min 16) to bound recompiles."""
    p = 16
    while p < n:
        p *= 2
    return p


@partial(jax.jit, static_argnums=(), donate_argnums=(0,))
def _apply_updates(state: ObjectState, slot: jax.Array, pos: jax.Array,
                   vel: jax.Array, acc: jax.Array, heading: jax.Array,
                   size: jax.Array, otype: jax.Array,
                   valid: jax.Array) -> ObjectState:
    """Scatter a padded batch of updates into fleet slots. Padding rows get
    an out-of-bounds slot and are dropped by the scatter — masked writes to
    a shared dummy slot would race with real writes to that slot."""
    n = state.alive.shape[0]
    slot = jnp.where(valid, slot, n)

    def upd(arr, new):
        return arr.at[slot].set(new, mode="drop")

    alive = state.alive.at[slot].set(True, mode="drop")
    return state.replace(
        pos=upd(state.pos, pos), vel=upd(state.vel, vel),
        acc=upd(state.acc, acc), heading=upd(state.heading, heading),
        size=upd(state.size, size), otype=upd(state.otype, otype),
        alive=alive)


def _predict_device(state, traj, cfg, horizon, step, r_cap):
    """Device half of Scene.predict as one jittable program: grid build +
    trajectory prediction (detect/predict.py) + top-r_cap compaction of the
    [N, merge_k] risk matrix — nothing bigger than r_cap crosses to host
    The overflow slot carries grid bucket truncation
    (engine.grid_overflow): candidates beyond cell_capacity are dropped
    from their bucket's gather, so a nonzero count means the predicted-risk
    list may be missing pairs (counted, never silent — the same contract as
    StepOutput.overflow on the detect path)."""
    from collide.detect.predict import predict_collisions
    from collide.engine import grid_overflow
    a = cfg.alerts
    index = build_grid(state.pos, state.alive, cfg)
    other, valid, risk, ttc, dist = predict_collisions(
        state, traj, index, cfg, horizon=horizon, step=step)
    n, k = risk.shape
    keep = valid & (risk >= a.risk_low)
    keyv = jnp.where(keep, risk, -1.0).reshape(-1)
    top_r, top_i = jax.lax.top_k(keyv, min(r_cap, keyv.size))
    rows = top_i // k
    sel = lambda x: x.reshape(-1)[top_i]
    return (top_r, state.oid[rows], state.oid[sel(other)], sel(ttc),
            sel(dist), jnp.sum(keep, dtype=jnp.int32),
            grid_overflow(index, cfg).astype(jnp.int32))


class Scene:
    """Single-device scene (mesh-sharded fleets: api/sharded_scene.py)."""

    def __init__(self, cfg: SystemConfig,
                 state: Optional[ObjectState] = None,
                 checkpoint_dir: Optional[str] = None,
                 broker=None,
                 chunk_size: Optional[int] = None,
                 auto_heal: bool = True,
                 auto_retune_every: int = 0):
        """chunk_size selects the blocked large-N step (engine.make_step).

        auto_heal: counted capacity overflow self-heals between steps —
        grid-bucket overflow (out.overflow) doubles cell_capacity and
        precise-mode survivor overflow (out.alert_overflow) doubles the
        survivor cap, each followed by a recompile, so the NEXT step is
        provably complete again: the adaptive-resolution analog of the
        reference's density-driven grid splits (spatial_index.py:139-160),
        done by resizing the compiled program instead of the grid.

        auto_retune_every=K (0 = off) additionally runs retune() every K
        steps — the periodic-readjustment analog of the reference's 10 s
        adjust_grid_resolution timer (spatial_index.py:40,302-336),
        covering the SHRINK direction the heal never takes."""
        self.cfg = cfg
        fresh = state is None
        self.state = state if state is not None else empty_state(cfg.num_objects)
        self._chunk_size = chunk_size
        self._auto_heal = auto_heal
        self.regrows = 0              # times a self-heal resized capacity
        self.retunes = 0              # times retune() recompiled
        self._auto_retune = int(auto_retune_every)
        self._last_retune = 0
        self._step = make_step(cfg, donate=True, chunk_size=chunk_size)
        self._detect = make_detect(cfg)
        from collide.alerts.extract import extract_alerts as _ea
        self._extract = jax.jit(partial(_ea, cfg=cfg))
        self.alert_manager = AlertManager(cfg, broker=broker)
        self.ckpt = (CheckpointManager(checkpoint_dir)
                     if checkpoint_dir else None)
        self.step_count = 0
        self._key = jax.random.key(0)
        self._id_to_slot: Dict[str, int] = {}
        self._slot_to_id: Dict[int, str] = {}
        self._history: Dict[str, List[LocationData]] = {}
        self._pending: List[LocationData] = []
        self._pending_meta: List[tuple] = []
        self.stats_timing = {"steps": 0, "total_ms": 0.0, "max_ms": 0.0}
        # All device-touching methods serialize on this lock: the step/detect
        # paths DONATE state buffers, so a concurrent reader (REST stats/
        # query thread) would race a deallocation — observed as a wedged
        # CPU-backend stream under the threaded HTTP server.
        self._device_lock = threading.RLock()
        # a fresh fleet is all-dead by construction: skip the device read so
        # service boot doesn't wait on first backend contact (the first
        # flush/step pays it instead)
        self._num_alive = (0 if fresh
                           else int(np.asarray(jnp.sum(self.state.alive))))
        self._traj = None          # TrajectoryHistory, created on first use
        self._traj_clock = 0.0
        self._predict_cache = {}   # (horizon, step) -> compiled program
        self._burst_cache: Dict[int, Any] = {}   # n -> compiled burst step
        self._pipe = None   # pending step_pipelined output:
                            # (out, capacity generation at dispatch)
        self._predict_cap_prev = None     # capacity before a predict heal
        self._predict_heal_ceiling = None  # first capacity that OOM'd
        self.last_predict_overflow = 0    # bucket truncation, last predict

    # ---- identity ----

    def _slot_for(self, vehicle_id: str) -> int:
        if vehicle_id in self._id_to_slot:
            return self._id_to_slot[vehicle_id]
        slot = len(self._id_to_slot)
        if slot >= self.state.n:
            raise ValueError(
                f"fleet capacity {self.state.n} exhausted; raise "
                f"SystemConfig.num_objects")
        self._id_to_slot[vehicle_id] = slot
        self._slot_to_id[slot] = vehicle_id
        return slot

    def vehicle_id_of(self, oid: int) -> str:
        return self._slot_to_id.get(int(oid), str(int(oid)))

    @property
    def ingested_count(self) -> int:
        """Vehicles known via per-vehicle ingest (service loops poll it)."""
        return len(self._id_to_slot)

    # ---- ingest (POST /vehicles/location analog) ----

    def ingest(self, location: LocationData, size: float = 2.0,
               vtype: str = "car") -> None:
        """Buffer one location report; applied on the next step()/flush()."""
        with self._device_lock:     # _flush_locked iterates+clears _pending
            self._pending.append(location)
            self._pending_meta.append((size, _TYPE_INDEX.get(vtype, 0)))
        hist = self._history.setdefault(location.vehicle_id, [])
        hist.append(location)
        del hist[:-10]                      # last-10 (storage.py:156-191)

    def flush(self) -> int:
        """Apply buffered ingests to the device in one scatter."""
        with self._device_lock:
            return self._flush_locked()

    def _flush_locked(self) -> int:
        if not self._pending:
            return 0
        n = len(self._pending)
        p = _pad_len(n)
        slot = np.zeros(p, np.int32)
        pos = np.zeros((p, 3), np.float32)
        vel = np.zeros((p, 3), np.float32)
        acc = np.zeros((p, 3), np.float32)
        heading = np.zeros(p, np.float32)
        size = np.full(p, 2.0, np.float32)
        otype = np.zeros(p, np.int32)
        valid = np.zeros(p, bool)
        dropped = 0
        for i, (loc, (sz, ot)) in enumerate(
                zip(self._pending, self._pending_meta)):
            try:
                slot[i] = self._slot_for(loc.vehicle_id)
            except ValueError:
                # fleet capacity exhausted: drop THIS report and keep going —
                # a raise here would leave _pending uncleared and poison
                # every later flush/step/detect
                dropped += 1
                continue
            pos[i] = loc.position.to_tuple()
            vel[i] = (loc.velocity.x, loc.velocity.y, loc.velocity.z)
            acc[i] = (loc.acceleration.x, loc.acceleration.y,
                      loc.acceleration.z)
            heading[i] = loc.heading
            size[i], otype[i] = sz, ot
            valid[i] = True
        if dropped:
            logger.error(
                "dropped %d location reports: fleet capacity %d exhausted "
                "(raise SystemConfig.num_objects)", dropped, self.state.n)
        if not self.cfg.world.is_3d:
            # 2D-world contract: z/vz/az are exactly 0 (see conform_fleet)
            pos[:, 2] = 0.0
            vel[:, 2] = 0.0
            acc[:, 2] = 0.0
        self.state = _apply_updates(
            self.state, jnp.asarray(slot), jnp.asarray(pos),
            jnp.asarray(vel), jnp.asarray(acc), jnp.asarray(heading),
            jnp.asarray(size), jnp.asarray(otype), jnp.asarray(valid))
        self._pending.clear()
        self._pending_meta.clear()
        self._num_alive = int(np.asarray(jnp.sum(self.state.alive)))
        return n

    def adopt_fleet(self, state: ObjectState,
                    ids: Optional[Sequence[str]] = None) -> None:
        """Replace the fleet wholesale (e.g. from a generator or restore).
        The fleet is conformed to the config's contracts (2D worlds zero
        z components; narrow-oid range validated) — core.state.conform_fleet."""
        from collide.core.state import conform_fleet
        state = conform_fleet(state, self.cfg)
        with self._device_lock:
            # a pending step_pipelined output belongs to the OLD fleet:
            # consume it now (alerts in order, counters against the old
            # capacity generation) so the next step/drain doesn't feed
            # pre-adoption alerts or overwrite _num_alive with stale data
            self._drain_locked()
            self.state = state
            self._num_alive = int(np.asarray(jnp.sum(state.alive)))
            self._id_to_slot.clear()
            self._slot_to_id.clear()
            if ids is not None:
                for slot, vid in enumerate(ids):
                    self._id_to_slot[vid] = slot
                    self._slot_to_id[slot] = vid

    # ---- stepping / detection ----

    def step(self, n: int = 1) -> Any:
        """Advance physics + detection n steps; feeds the AlertManager.
        n must be >= 1 (RouteTable turns n < 1 into HTTP 400)."""
        if n < 1:
            raise ValueError(f"step count must be >= 1, got {n}")
        with self._device_lock:
            return self._step_locked(n)

    def _step_locked(self, n: int) -> Any:
        self._drain_locked()
        self._flush_locked()
        out = None
        for i in range(n):
            self._key, sub = jax.random.split(self._key)
            last = i == n - 1
            with Timer() as t:
                self.state, out = self._step(self.state, sub)
                # one batched fetch syncs the step AND lands everything
                # the host consumes (per-field fetches would each pay a
                # device->host round trip)
                if last:
                    of, ao, alive, alerts = self._fetch_host_view(out)
                else:
                    of, ao = (int(v) for v in jax.device_get(
                        (out.overflow, out.alert_overflow)))
            self.step_count += 1
            self.stats_timing["steps"] += 1
            self.stats_timing["total_ms"] += t.elapsed_ms
            self.stats_timing["max_ms"] = max(self.stats_timing["max_ms"],
                                              t.elapsed_ms)
            self._heal(of, ao)
        self._maybe_auto_retune()
        self._num_alive = alive
        self.alert_manager.process_batch(alerts, resolver=self.vehicle_id_of)
        return out

    def step_burst(self, n: int) -> Any:
        """Advance n steps in ONE device dispatch (engine.make_burst_step:
        a lax.scan over the per-step program, identical key schedule to n
        step() calls). Host sync and dispatch overhead are paid once per
        burst, so sustained throughput approaches the device rate.

        Trade-off: only the FINAL step's alert list reaches the
        AlertManager (intermediate lists are never materialized);
        overflow / alert_overflow on the returned output are the MAX over
        the burst, so completeness certificates and auto-regrow still see
        the worst step. Use step() when every step's alerts matter (e.g.
        alert lifecycle resend/expiry at sub-burst granularity)."""
        if n <= 1:
            return self.step(n)
        with self._device_lock:
            self._drain_locked()
            self._flush_locked()
            fn = self._burst_cache.get(n)
            if fn is None:
                from collide.engine import make_burst_step
                fn = make_burst_step(self.cfg, n, donate=True,
                                     chunk_size=self._chunk_size)
                self._burst_cache[n] = fn
            with Timer() as t:
                self.state, self._key, out, risks = fn(self.state, self._key)
                # one batched fetch: sync + counters + alerts + per-step
                # risk counts
                of, ao, alive, alerts, risks_np = jax.device_get(
                    (out.overflow, out.alert_overflow, out.num_alive,
                     out.alerts, risks))
                of, ao, alive = int(of), int(ao), int(alive)
            self.step_count += n
            self.stats_timing["steps"] += n
            self.stats_timing["total_ms"] += t.elapsed_ms
            # per-step cost of this burst (the burst IS one device call)
            self.stats_timing["max_ms"] = max(self.stats_timing["max_ms"],
                                              t.elapsed_ms / n)
            self.last_burst_risks = np.asarray(risks_np)
            self._heal(of, ao)
            self._maybe_auto_retune()
            self._num_alive = alive
            self.alert_manager.process_batch(alerts,
                                             resolver=self.vehicle_id_of)
            return out

    def step_pipelined(self) -> Optional[Any]:
        """One-behind serving step: dispatch THIS step asynchronously, then
        consume the PREVIOUS pipelined step's output (alerts to the
        AlertManager, overflow counters to auto-regrow) while the device
        works on the new one. Returns the previous StepOutput — None on
        the first call; call pipeline_drain() when stopping to consume the
        final pending output.

        Per-call serving latency approaches max(host work + dispatch,
        device step time) instead of their sum: the device step leaves the
        critical path whenever the host side (alert processing + dispatch)
        is the slower stage. Unlike step_burst, EVERY step's
        alert list reaches the AlertManager and ingests apply between
        steps — the trade is one step of alert latency. The produced
        states/alerts are bit-identical to step() (same program, same key
        schedule; tests/test_step_pipelined.py). step()/step_burst()/
        detect() drain the pipeline first, so mixing modes keeps alert
        order intact. Auto-regrow decisions are guarded by the capacity
        generation at dispatch time, so two in-flight outputs from the
        same undersized program regrow ONCE, not twice."""
        with self._device_lock:
            self._flush_locked()
            self._key, sub = jax.random.split(self._key)
            with Timer() as t:
                self.state, out = self._step(self.state, sub)
                # no sync here: the dispatch is asynchronous by design
                pending, self._pipe = self._pipe, (out, self._capacity_gen())
                # start the device->host copy of THIS output now: it
                # queues behind the step just dispatched and lands during
                # the inter-call gap, so the NEXT call's fetch finds the
                # bytes already host-side instead of serializing behind the
                # new step's execution
                self._prefetch_host_view(out)
                prev = None
                if pending is not None:
                    prev = pending[0]
                    self._consume_out(*pending)   # forces prev's fetch
            self.step_count += 1
            self.stats_timing["steps"] += 1
            self.stats_timing["total_ms"] += t.elapsed_ms
            self.stats_timing["max_ms"] = max(self.stats_timing["max_ms"],
                                              t.elapsed_ms)
            self._maybe_auto_retune()
            return prev

    def pipeline_drain(self) -> Optional[Any]:
        """Consume a pending step_pipelined output, if any (returns it)."""
        with self._device_lock:
            return self._drain_locked()

    def _drain_locked(self) -> Optional[Any]:
        if self._pipe is None:
            return None
        pending, self._pipe = self._pipe, None
        self._consume_out(*pending)
        return pending[0]

    def _capacity_gen(self) -> tuple:
        """The capacity generation: changes whenever a heal recompiles."""
        return (self.cfg.survivor_cap, self.cfg.grid.cell_capacity)

    def _prefetch_host_view(self, out) -> None:
        """Kick off non-blocking device->host copies of everything
        `_fetch_host_view` will read later. Safe no-op on backends without
        async host transfers (the later device_get just does the work)."""
        import jax.tree_util as jtu
        for leaf in jtu.tree_leaves((out.overflow, out.alert_overflow,
                                     out.num_alive, out.alerts)):
            try:
                leaf.copy_to_host_async()
            except Exception:        # platform without async copies
                return

    def _fetch_host_view(self, out):
        """ONE device->host transfer for everything the host consumes from
        a StepOutput: the regrow counters, num_alive and the alert batch
        (each separate int()/np.asarray fetch would pay its own round
        trip)."""
        of, ao, alive, alerts = jax.device_get(
            (out.overflow, out.alert_overflow, out.num_alive, out.alerts))
        return int(of), int(ao), int(alive), alerts

    def _consume_out(self, out, km_at) -> None:
        """Process one step's output: self-heal on its counters (only if
        the capacity that produced it is still current — a later output of
        the same undersized program must not double the capacity twice)
        and feed its alerts to the AlertManager."""
        of, ao, alive, alerts = self._fetch_host_view(out)
        if self._capacity_gen() == km_at:
            self._heal(of, ao)
        self._num_alive = alive
        self.alert_manager.process_batch(alerts,
                                         resolver=self.vehicle_id_of)

    def _heal(self, overflow: int, alert_overflow: int) -> None:
        """Counted capacity overflow -> grow the capacity and recompile, so
        the NEXT step's detection is provably complete again (the
        overflowing step's misses were counted, never silent):

          * grid-bucket truncation (objects beyond GridConfig.cell_capacity
            dropped from their bucket's candidate gather) doubles
            cell_capacity;
          * precise-mode survivor overflow (stage-2 survivors beyond the
            static survivor cap skipped the stage-3 sweep) doubles
            precise_survivor_cap."""
        if not self._auto_heal:
            return
        if overflow > 0:
            self.regrows += 1
            logger.warning(
                "grid-bucket overflow (%d objects beyond cell_capacity): "
                "growing cell_capacity to %d and recompiling", overflow,
                self.cfg.grid.cell_capacity * 2)
            self._set_cell_capacity(self.cfg.grid.cell_capacity * 2)
        if alert_overflow > 0:
            import dataclasses as _dc
            cap = 2 * self.cfg.survivor_cap
            self.regrows += 1
            logger.warning(
                "stage-2 survivor overflow (%d beyond the survivor cap): "
                "growing precise_survivor_cap to %d and recompiling",
                alert_overflow, cap)
            self.cfg = self.cfg.replace(detect=_dc.replace(
                self.cfg.detect, precise_survivor_cap=cap))
            self._recompile()

    def _set_cell_capacity(self, cap: int) -> None:
        """Recompile every cfg-bound program at a new gather-bucket
        capacity (shared by the step path's doubling heal and the predict
        path's fleet-exact heal)."""
        import dataclasses as _dc
        self.cfg = self.cfg.replace(
            grid=_dc.replace(self.cfg.grid, cell_capacity=cap))
        self._recompile()

    def _recompile(self) -> None:
        """Rebuild every cfg-bound program after a capacity change."""
        self._step = make_step(self.cfg, donate=True,
                               chunk_size=self._chunk_size)
        self._detect = make_detect(self.cfg)
        self._burst_cache.clear()
        self._predict_cache.clear()

    def retune(self) -> bool:
        """Re-derive the compiled program's static capacities from the LIVE
        fleet and recompile when the need moved — the runtime analog of the
        reference's density-driven grid-resolution adjustment
        (spatial_index.py:139-160, 302-412: a 10 s timer that SPLIT dense
        cells and MERGED sparse ones). The knob is the gather-bucket
        capacity (GridConfig.cell_capacity), sized to the live densest cell
        (kernels/tune.suggest_cell_capacity) so detect()/predict() report
        grid_overflow == 0 — in BOTH directions, where the overflow heal
        only ever grows.

        Cell SIZE intentionally stays fixed: max(cell_size, search_radius)
        is the smallest legal cell for the 1-cell stencil, so the adaptive
        dimension is CAPACITY, not resolution. Shrinks use 2x hysteresis so
        density jitter never thrashes recompiles.

        Returns True if anything recompiled. Scene(auto_retune_every=K)
        runs this every K steps. Growing only moves completeness counters
        toward 0; SHRINKING trades completeness margin for memory — if
        density rises again between retune ticks, steps can report counted
        bucket overflow (never silent) until the heal or the next retune
        re-sizes the program."""
        with self._device_lock:
            return self._retune_locked()

    def _retune_locked(self) -> bool:
        from collide.kernels.tune import suggest_cell_capacity
        need = suggest_cell_capacity(self.state, self.cfg)
        cur = self.cfg.grid.cell_capacity
        if not (need > cur or 2 * need <= cur):
            return False
        self._set_cell_capacity(need)
        self.retunes += 1
        logger.info("retune: cell_capacity %d -> %d (recompiled)", cur, need)
        return True

    def _maybe_auto_retune(self) -> None:
        if (self._auto_retune
                and self.step_count - self._last_retune >= self._auto_retune):
            self._last_retune = self.step_count
            self._retune_locked()

    def detect(self) -> Any:
        """Detection only, no physics (externally-driven fleets: ingest ->
        flush -> detect, the EarlyWarningSystem pattern)."""
        with self._device_lock:
            return self._detect_locked()

    def record_trajectories(self, dt: Optional[float] = None) -> None:
        """Append current positions to the trajectory history ring (the
        CollisionPredictionModel.update_trajectory analog,
        collision_detection.py:553-570). Call once per external tick when
        using predict()."""
        from collide.detect.predict import empty_history, update_history
        with self._device_lock:
            self._flush_locked()
            if self._traj is None:
                self._traj = empty_history(self.state.n)
                # one program per tick instead of eager per-op dispatch;
                # the old ring is donated
                self._upd_hist = jax.jit(update_history, donate_argnums=(0,))
            self._traj_clock += dt if dt is not None else self.cfg.sim.dt
            self._traj = self._upd_hist(self._traj, self.state,
                                        self._traj_clock)

    def predict(self, horizon: float = 10.0, step: float = 0.5) -> List[CollisionRisk]:
        """Trajectory-based future-collision prediction (the
        CollisionPredictionModel.predict_collisions analog,
        collision_detection.py:572-621): classifies each object's recorded
        trajectory and re-detects along its class-predicted path. Returns
        is_predicted CollisionRisks and feeds them to the AlertManager.
        Requires >= 2 record_trajectories() calls; objects with less history
        are covered by the plain detect() path (reference :590-592)."""
        a = self.cfg.alerts
        with self._device_lock:
            self._flush_locked()
            if self._traj is None:
                return []
            r_cap = min(a.max_scene_alerts,
                        self.state.n * 32)        # merge_k = 32 (predict.py)
            key2 = (float(horizon), float(step))

            # ONE compiled program for grid + prediction + device
            # compaction instead of eager per-op dispatch
            def build_fn():
                fn = self._predict_cache.get(key2)
                if fn is None:
                    fn = jax.jit(partial(_predict_device, cfg=self.cfg,
                                         horizon=key2[0], step=key2[1],
                                         r_cap=r_cap))
                    self._predict_cache[key2] = fn
                return fn

            try:
                fetched = jax.device_get(build_fn()(self.state, self._traj))
                self._predict_cap_prev = None      # healed program fits
            except jax.errors.JaxRuntimeError:
                # a bucket-capacity self-heal (below, last call) produced a
                # program too big for device memory — the gather path's
                # footprint is linear in cell_capacity. Revert to the last
                # capacity that ran, remember the ceiling so the heal isn't
                # re-attempted every call, and retry once; the truncation
                # stays counted (never silent).
                prev = self._predict_cap_prev
                if prev is None:
                    raise
                failed = self.cfg.grid.cell_capacity
                self._predict_heal_ceiling = failed
                self._predict_cap_prev = None
                logger.warning(
                    "predict: fleet-exact healed cell_capacity %d does not "
                    "fit device memory; reverting to %d — grid-bucket "
                    "truncation stays counted", failed, prev)
                self._set_cell_capacity(prev)
                fetched = jax.device_get(build_fn()(self.state, self._traj))
        top_r, voids, ooids, t_sel, d_sel, total, pred_oflow = fetched
        self.last_predict_overflow = int(pred_oflow)
        if int(pred_oflow) > 0:
            # overflow = grid bucket truncation (objects beyond
            # cell_capacity dropped from their bucket's candidate list).
            # Counted, never silent — and self-healing, so a predict-only
            # workload heals without a step ever running.
            # Unlike the step path's doubling, the heal goes
            # fleet-exact in ONE recompile (overflow counts here can be
            # ~N/2 on skewed fleets — doubling would thrash), and it is
            # memory-guarded: the gather footprint is linear in capacity,
            # so a heal that OOMs (caught above) sets a ceiling and the
            # truncation stays counted instead of retrying forever.
            from collide.kernels.tune import suggest_cell_capacity
            cur = self.cfg.grid.cell_capacity
            need = suggest_cell_capacity(self.state, self.cfg)
            ceil = self._predict_heal_ceiling
            if not self._auto_heal:
                logger.warning(
                    "predict: %d objects overflow their grid buckets "
                    "(auto-heal disabled) — the predicted-risk list may "
                    "be missing pairs; fleet-exact cell_capacity is %d",
                    int(pred_oflow), need)
            elif need <= cur:
                logger.warning(
                    "predict: %d objects overflow their grid buckets but "
                    "the live fleet already fits cell_capacity %d — "
                    "density drifted during the call; the next predict is "
                    "complete", int(pred_oflow), cur)
            elif ceil is not None and need >= ceil:
                logger.warning(
                    "predict: %d objects overflow their grid buckets; the "
                    "fleet-exact capacity %d already failed to fit device "
                    "memory (ceiling %d) — predicted list stays "
                    "overflow-flagged", int(pred_oflow), need, ceil)
            else:
                self._predict_cap_prev = cur
                self.regrows += 1
                logger.warning(
                    "predict: %d objects overflow their grid buckets — "
                    "growing cell_capacity to the fleet-exact %d and "
                    "recompiling for the next call", int(pred_oflow), need)
                self._set_cell_capacity(need)
        if int(total) > r_cap:
            logger.warning(
                "predict: %d predicted risks exceed the %d-slot scene "
                "budget; lowest-risk ones are not surfaced "
                "(raise AlertConfig.max_scene_alerts)", int(total), r_cap)
        out = []
        for j in range(r_cap):
            if top_r[j] < 0.0:
                break
            out.append(CollisionRisk.new(
                vehicle_id=self.vehicle_id_of(int(voids[j])),
                other_vehicle_id=self.vehicle_id_of(int(ooids[j])),
                risk_level=float(top_r[j]),
                time_to_collision=float(t_sel[j]),
                distance=float(d_sel[j]),
                is_predicted=True))
        self.alert_manager.process_collision_risks(out)
        return out

    def _detect_locked(self) -> Any:
        self._drain_locked()
        self._flush_locked()
        with Timer() as t:
            pairs = self._detect(self.state)
            batch = self._extract(self.state, pairs)
            # one batched fetch: real sync + everything the host reads
            batch = jax.device_get(batch)
        self.stats_timing["steps"] += 1
        self.stats_timing["total_ms"] += t.elapsed_ms
        self.stats_timing["max_ms"] = max(self.stats_timing["max_ms"],
                                          t.elapsed_ms)
        self.alert_manager.process_batch(batch, resolver=self.vehicle_id_of)
        return batch

    # ---- queries ----

    def get_location(self, vehicle_id: str) -> Optional[LocationData]:
        hist = self._history.get(vehicle_id)
        return hist[-1] if hist else None

    def get_history(self, vehicle_id: str) -> List[LocationData]:
        return list(self._history.get(vehicle_id, []))

    def get_vehicle_risks(self, vehicle_id: str) -> List[CollisionRisk]:
        out = []
        for a in self.alert_manager.get_vehicle_alerts(vehicle_id):
            out.append(CollisionRisk(
                id=a.id, vehicle_id=a.vehicle_id,
                other_vehicle_id=a.other_vehicle_id,
                risk_level=a.risk_level,
                time_to_collision=a.time_to_collision,
                distance=float("nan"), timestamp=a.timestamp))
        return out

    def drop_fraction(self, fraction: float) -> int:
        """Fault injection: kill `fraction` of the alive fleet (the
        /admin/inject-failure drop_objects path). Returns the kill count."""
        with self._device_lock:
            alive = np.asarray(self.state.alive).copy()
            idx = np.flatnonzero(alive)
            kill = idx[:int(len(idx) * fraction)]
            alive[kill] = False
            self.state = self.state.replace(alive=jnp.asarray(alive))
            self._num_alive = int(alive.sum())
        return int(len(kill))

    def query_radius(self, center, radius: float) -> List[str]:
        """Vehicle ids within `radius` of `center` (alive only)."""
        if isinstance(center, Position):
            center = center.to_tuple()
        with self._device_lock:
            self._flush_locked()
            q = jnp.asarray([center], jnp.float32)
            index = build_grid(self.state.pos, self.state.alive, self.cfg)
            cand, ok = _query_radius(index, self.state.pos, self.state.alive,
                                     q, radius, self.cfg)
            cand, ok = np.asarray(cand[0]), np.asarray(ok[0])
            oids = np.asarray(self.state.oid)
        return [self.vehicle_id_of(oids[c]) for c in cand[ok]]

    def grid_vehicles(self, cx: int, cy: int, cz: int = 0) -> List[str]:
        """Vehicle ids whose CURRENT device position falls in grid cell
        (cx, cy, cz) — exact membership (the GET /grids/{id}/vehicles
        semantics; a radius query would also return neighbors)."""
        from collide.index.grid import cell_coords
        with self._device_lock:
            self._flush_locked()
            c3 = np.asarray(cell_coords(self.state.pos, self.cfg))
            alive = np.asarray(self.state.alive)
            oids = np.asarray(self.state.oid)
        hit = alive & (c3[:, 0] == cx) & (c3[:, 1] == cy) & (c3[:, 2] == cz)
        return [self.vehicle_id_of(o) for o in oids[hit]]

    def alerts(self, min_risk: float = 0.0,
               vehicle_id: Optional[str] = None) -> List[Alert]:
        src = (self.alert_manager.get_vehicle_alerts(vehicle_id)
               if vehicle_id else list(self.alert_manager.alerts.values()))
        out = [a for a in src if a.risk_level >= min_risk]
        return sorted(out, key=lambda a: (-a.priority, -a.risk_level))

    # ---- reliability ----

    def save_checkpoint(self, metadata: Optional[dict] = None) -> str:
        assert self.ckpt is not None, "Scene built without checkpoint_dir"
        return self.ckpt.save(self.state, self.step_count,
                              metadata={"ids": self._id_to_slot,
                                        **(metadata or {})})

    def save_checkpoint_async(self, metadata: Optional[dict] = None):
        """Non-blocking snapshot: the step loop stalls only for a cheap
        device-side copy; transfer + compression overlap stepping
        (ckpt.CheckpointManager.save_async). Join/raise via
        self.ckpt.wait_async()."""
        assert self.ckpt is not None, "Scene built without checkpoint_dir"
        with self._device_lock:
            return self.ckpt.save_async(
                self.state, self.step_count,
                metadata={"ids": self._id_to_slot, **(metadata or {})},
                transfer_lock=self._device_lock)

    def restore_checkpoint(self, step: Optional[int] = None) -> int:
        assert self.ckpt is not None, "Scene built without checkpoint_dir"
        with self._device_lock:
            self._drain_locked()   # pre-restore pipelined alerts, in order
        state, meta = self.ckpt.restore(step)
        self.state = state
        self._num_alive = int(np.asarray(jnp.sum(state.alive)))
        self.step_count = meta["step"]
        ids = meta.get("metadata", {}).get("ids") or {}
        self._id_to_slot = {k: int(v) for k, v in ids.items()}
        self._slot_to_id = {v: k for k, v in self._id_to_slot.items()}
        return self.step_count

    # ---- stats (get_stats tree, collision_system.py:611-629 analog) ----

    def stats(self) -> Dict[str, Any]:
        # device-free: num_alive is tracked at each flush/step/restore so
        # REST monitors never contend with the step loop for the device
        alive = self._num_alive
        s = self.stats_timing
        return {
            "step_count": self.step_count,
            "num_alive": alive,
            "capacity": self.state.n,
            "avg_step_ms": (s["total_ms"] / s["steps"]) if s["steps"] else 0.0,
            "max_step_ms": s["max_ms"],
            "alerts": self.alert_manager.get_stats(),
            "checkpoints": self.ckpt.stats if self.ckpt else None,
            "regrows": self.regrows,
            "retunes": self.retunes,
            "config": {"num_objects": self.cfg.num_objects,
                       "cell_size": self.cfg.grid.cell_size,
                       "cell_capacity": self.cfg.grid.cell_capacity,
                       "mode": self.cfg.detect.mode},
        }
