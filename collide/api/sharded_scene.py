"""ShardedScene: the Scene API over a multi-device mesh.

Gives mesh-sharded fleets the same surface as api/scene.py — step, alerts,
stats, checkpoint/restore — on top of shard/step.py's SPMD program (slab
ownership, ppermute halo + migration). This is the multi-node deployment
facade the reference assembled from broker+scheduler+compute-nodes+shard-
manager (SURVEY.md §3.1); here it is one object wrapping one compiled step.

Occupancy telemetry and rebalancing ride shard/balance.LoadBalancer;
checkpoints collect to host and restore through the same slab
redistribution, which doubles as the failover story (BASELINE config 5:
halo exchange + checkpointed failover).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import jax
import numpy as np

from collide.core.config import SystemConfig
from collide.core.state import ObjectState
from collide.core.types import Alert
from collide.core.utils import Timer, get_logger
from collide.alerts.manager import AlertManager
from collide.ckpt.checkpoint import CheckpointManager
from collide.shard.step import (make_mesh, make_sharded_step,
                                make_sharded_ingest,
                                distribute_state, collect_state,
                                shard_slots)
from collide.shard.balance import LoadBalancer, shard_occupancy

logger = get_logger(__name__)


class ShardedScene:
    """Mesh-sharded fleet with the Scene surface (step/alerts/stats/ckpt).

    Fleets enter in bulk via `adopt_fleet` (generator / checkpoint /
    collected host state) AND per-vehicle via `ingest`/`flush` (the
    reference's POST /vehicles/location path): buffered reports apply in
    one replicated batch + per-shard scatter — update-in-place, ownership
    migration across slab walls, free-slot insertion, overflow counted."""

    def __init__(self, cfg: SystemConfig,
                 fleet: Optional[ObjectState] = None,
                 devices=None,
                 checkpoint_dir: Optional[str] = None,
                 auto_rebalance: bool = True,
                 broker=None):
        assert cfg.shard.total_shards > 1, "use Scene for a single device"
        self.cfg = cfg
        self.mesh = make_mesh(cfg, devices)
        self.slots = shard_slots(cfg)
        self._step = make_sharded_step(cfg, self.mesh, donate=True)
        self._step_h = None           # history-carrying step (lazy)
        self._burst_cache = {}        # (n, with_history) -> compiled burst
        self._pipe = None             # pending step_pipelined output:
                                      # (out, dropped)
        self._traj = None             # sharded TrajectoryHistory
        self._traj_clock = 0.0
        self._predict_cache = {}      # (horizon, step) -> compiled fns
        self._apply = make_sharded_ingest(cfg, self.mesh)
        self._detect = None           # lazy make_sharded_detect program
        self._pending: Dict[int, tuple] = {}      # oid -> update tuple
        self._id_to_oid: Dict[str, int] = {}
        self._oid_to_id: Dict[int, str] = {}
        self._history: Dict[str, list] = {}       # vid -> last-10 reports
        self.alert_manager = AlertManager(cfg, broker=broker)
        self.ckpt = (CheckpointManager(checkpoint_dir)
                     if checkpoint_dir else None)
        self.balancer = (LoadBalancer(cfg, self.slots)
                         if auto_rebalance else None)
        self.step_count = 0
        self.dropped_total = 0
        self.boundaries = None        # [Dx+1] dynamic slab walls (None=equal)
        self.boundaries_y = None      # [Dy+1] walls of the 2D tiling
        self.boundaries_z = None      # [Dz+1] walls of the 3D tiling
        self._key = jax.random.key(0)
        self._lock = threading.RLock()
        self.stats_timing = {"steps": 0, "total_ms": 0.0, "max_ms": 0.0}
        self.state: Optional[ObjectState] = None
        if fleet is not None:
            self.adopt_fleet(fleet)

    # ---- fleet management ----

    def adopt_fleet(self, fleet: ObjectState) -> None:
        """Distribute a host/global fleet across the mesh by slab/tile.
        The fleet is conformed to the config's contracts first (2D worlds
        zero z components; narrow-oid range validated)."""
        from collide.core.state import conform_fleet
        fleet = conform_fleet(fleet, self.cfg)
        with self._lock:
            # consume a pending step_pipelined output of the OLD fleet
            # first (alerts in order; counters against the old capacity
            # generation) — mirrors Scene.adopt_fleet
            self._drain_locked()
            self.state = distribute_state(
                fleet, self.cfg, self.mesh, boundaries=self.boundaries,
                boundaries_y=self.boundaries_y,
                boundaries_z=self.boundaries_z)

    def collect(self) -> ObjectState:
        """Gather the sharded fleet to one addressable host state."""
        with self._lock:
            return collect_state(self.state)

    # ---- per-vehicle ingest (POST /vehicles/location analog) ----

    _TYPE_INDEX = {"car": 0, "truck": 1, "bus": 2, "motorcycle": 3}

    def ingest(self, location, size: float = 2.0,
               vtype: str = "car") -> None:
        """Buffer one location report; applied on the next flush()/step()."""
        vid = location.vehicle_id
        with self._lock:
            oid = self._id_to_oid.get(vid)
            if oid is None:
                oid = len(self._id_to_oid)
                if oid >= self.cfg.num_objects:
                    raise ValueError(
                        f"fleet capacity {self.cfg.num_objects} exhausted")
                self._id_to_oid[vid] = oid
                self._oid_to_id[oid] = vid
            p, v, a = location.position, location.velocity, \
                location.acceleration
            self._pending[oid] = (
                (p.x, p.y, p.z), (v.x, v.y, v.z), (a.x, a.y, a.z),
                location.heading, size,
                self._TYPE_INDEX.get(vtype, 0))
            hist = self._history.setdefault(vid, [])
            hist.append(location)
            del hist[:-10]             # last-10 (reference storage.py:156)

    def flush(self) -> int:
        """Apply buffered reports in one sharded scatter; returns how many
        applied (overflowed inserts count into dropped_total)."""
        with self._lock:
            return self._flush_locked()

    def _flush_locked(self) -> int:
        if not self._pending:
            return 0
        if self.state is None:
            from collide.core.state import empty_state
            self.state = distribute_state(
                empty_state(self.cfg.num_objects), self.cfg, self.mesh,
                boundaries=self.boundaries, boundaries_y=self.boundaries_y,
                boundaries_z=self.boundaries_z)
        oids = sorted(self._pending)
        nb = len(oids)
        b = 16
        while b < nb:
            b *= 2
        upd = {"oid": np.full(b, -1, np.int32),
               "pos": np.zeros((b, 3), np.float32),
               "vel": np.zeros((b, 3), np.float32),
               "acc": np.zeros((b, 3), np.float32),
               "heading": np.zeros(b, np.float32),
               "size": np.full(b, 2.0, np.float32),
               "otype": np.zeros(b, np.int32)}
        for i, oid in enumerate(oids):
            pos, vel, acc, heading, size, otype = self._pending[oid]
            upd["oid"][i] = oid
            upd["pos"][i] = pos
            upd["vel"][i] = vel
            upd["acc"][i] = acc
            upd["heading"][i] = heading
            upd["size"][i] = size
            upd["otype"][i] = otype
        self._pending.clear()
        if not self.cfg.world.is_3d:
            # 2D-world contract: z/vz/az are exactly 0 (see conform_fleet)
            upd["pos"][:, 2] = 0.0
            upd["vel"][:, 2] = 0.0
            upd["acc"][:, 2] = 0.0
        self.state, dropped = self._apply(self.state, upd, self.boundaries,
                                          self.boundaries_y,
                                          self.boundaries_z)
        self.dropped_total += int(np.asarray(dropped).sum())
        return nb

    def vehicle_id_of(self, oid: int) -> str:
        return self._oid_to_id.get(int(oid), str(int(oid)))

    @property
    def ingested_count(self) -> int:
        """Vehicles known via per-vehicle ingest (service loops poll it)."""
        return len(self._id_to_oid)

    def _ensure_state(self) -> None:
        if self.state is None:
            from collide.core.state import empty_state
            self.state = distribute_state(
                empty_state(self.cfg.num_objects), self.cfg, self.mesh,
                boundaries=self.boundaries, boundaries_y=self.boundaries_y,
                boundaries_z=self.boundaries_z)

    # ---- stepping ----

    def step(self, n: int = 1) -> Any:
        if n < 1:
            raise ValueError(f"step count must be >= 1, got {n}")
        out = None
        with self._lock:
            self._drain_locked()
            self._flush_locked()
            self._ensure_state()
            for _ in range(n):
                self._key, sub = jax.random.split(self._key)
                with Timer() as t:
                    if self._traj is not None:
                        # history-carrying step: trajectory rings MIGRATE
                        # with their objects across walls
                        if self._step_h is None:
                            self._step_h = make_sharded_step(
                                self.cfg, self.mesh, donate=True,
                                with_history=True)
                        (self.state, self._traj, out,
                         dropped) = self._step_h(
                            self.state, self._traj, sub,
                            self.boundaries, self.boundaries_y,
                            self.boundaries_z)
                    else:
                        self.state, out, dropped = self._step(
                            self.state, sub, self.boundaries,
                            self.boundaries_y, self.boundaries_z)
                    # one batched fetch: real sync + what the host reads
                    # per step
                    dropped_np = jax.device_get(dropped)
                self.step_count += 1
                self.dropped_total += int(np.asarray(dropped_np).sum())
                self.stats_timing["steps"] += 1
                self.stats_timing["total_ms"] += t.elapsed_ms
                self.stats_timing["max_ms"] = max(
                    self.stats_timing["max_ms"], t.elapsed_ms)
                if self.balancer and self.balancer.should_rebalance(self.state):
                    old_state = self.state     # pre-rebalance slot layout
                    (self.state, self.boundaries, self.boundaries_y,
                     self.boundaries_z) = self.balancer.rebalance(
                        old_state, self.mesh)
                    if self._traj is not None:
                        # trajectory rings follow their objects to the
                        # new slots
                        self._traj = self._redistribute_hist(old_state)
            self.alert_manager.process_batch(out.alerts,
                                             resolver=self.vehicle_id_of)
        return out

    def step_burst(self, n: int) -> Any:
        """Advance n steps in ONE device dispatch (make_sharded_step with
        burst_n: a lax.scan over the SPMD step, identical key schedule to
        n step() calls). Dispatch/sync overhead is paid once per burst —
        the production analog of the device-rate view. Boundaries stay
        fixed for the whole burst; rebalance decisions run once at the
        end. Only the final step's alert list reaches the AlertManager;
        overflow certificates are the burst-wide max (worst step)."""
        if n <= 1:
            return self.step(n)
        with self._lock:
            self._drain_locked()
            self._flush_locked()
            self._ensure_state()
            hist = self._traj is not None
            fn = self._burst_cache.get((n, hist))
            if fn is None:
                fn = make_sharded_step(self.cfg, self.mesh, donate=True,
                                       with_history=hist, burst_n=n)
                self._burst_cache[(n, hist)] = fn
            with Timer() as t:
                if hist:
                    (self.state, self._traj, self._key, out, dropped,
                     risks) = fn(self.state, self._traj, self._key,
                                 self.boundaries, self.boundaries_y,
                                 self.boundaries_z)
                else:
                    self.state, self._key, out, dropped, risks = fn(
                        self.state, self._key, self.boundaries,
                        self.boundaries_y, self.boundaries_z)
                # one batched fetch (real sync; see step())
                dropped_np, risks = jax.device_get((dropped, risks))
            self.step_count += n
            self.dropped_total += int(np.asarray(dropped_np).sum())
            self.stats_timing["steps"] += n
            self.stats_timing["total_ms"] += t.elapsed_ms
            self.stats_timing["max_ms"] = max(self.stats_timing["max_ms"],
                                              t.elapsed_ms / n)
            self.last_burst_risks = np.asarray(risks)
            if self.balancer and self.balancer.should_rebalance(self.state):
                old_state = self.state
                (self.state, self.boundaries, self.boundaries_y,
                 self.boundaries_z) = self.balancer.rebalance(
                    old_state, self.mesh)
                if self._traj is not None:
                    self._traj = self._redistribute_hist(old_state)
            self.alert_manager.process_batch(out.alerts,
                                             resolver=self.vehicle_id_of)
            return out

    def step_pipelined(self) -> Any:
        """One-behind serving on the mesh: dispatch THIS sharded step
        asynchronously, consume the PREVIOUS one's output (alerts, drop
        counters) while the devices work — same semantics
        and guards as Scene.step_pipelined (bit-identical outputs, one
        step of alert latency; step()/step_burst()/detect() drain first).
        The rebalance check stays in the dispatch phase: LoadBalancer
        self-gates occupancy fetches to every `check_every` steps, so the
        periodic sync is the (existing) price of moving walls, not a
        per-call cost."""
        with self._lock:
            self._flush_locked()
            self._ensure_state()
            self._key, sub = jax.random.split(self._key)
            with Timer() as t:
                if self._traj is not None:
                    if self._step_h is None:
                        self._step_h = make_sharded_step(
                            self.cfg, self.mesh, donate=True,
                            with_history=True)
                    (self.state, self._traj, out, dropped) = self._step_h(
                        self.state, self._traj, sub, self.boundaries,
                        self.boundaries_y, self.boundaries_z)
                else:
                    self.state, out, dropped = self._step(
                        self.state, sub, self.boundaries,
                        self.boundaries_y, self.boundaries_z)
                pending, self._pipe = self._pipe, (out, dropped)
                prev = None
                if pending is not None:
                    prev = pending[0]
                    self._consume_out(*pending)
            self.step_count += 1
            self.stats_timing["steps"] += 1
            self.stats_timing["total_ms"] += t.elapsed_ms
            self.stats_timing["max_ms"] = max(self.stats_timing["max_ms"],
                                              t.elapsed_ms)
            if self.balancer and self.balancer.should_rebalance(self.state):
                old_state = self.state
                (self.state, self.boundaries, self.boundaries_y,
                 self.boundaries_z) = self.balancer.rebalance(
                    old_state, self.mesh)
                if self._traj is not None:
                    self._traj = self._redistribute_hist(old_state)
            return prev

    def pipeline_drain(self) -> Any:
        """Consume a pending step_pipelined output, if any (returns it)."""
        with self._lock:
            return self._drain_locked()

    def _drain_locked(self) -> Any:
        if self._pipe is None:
            return None
        pending, self._pipe = self._pipe, None
        self._consume_out(*pending)
        return pending[0]

    def _consume_out(self, out, dropped) -> None:
        """Process one sharded step's output: drop counters and alerts to
        the AlertManager."""
        self.dropped_total += int(np.asarray(jax.device_get(dropped)).sum())
        self.alert_manager.process_batch(out.alerts,
                                         resolver=self.vehicle_id_of)

    def _redistribute_hist(self, old_state: ObjectState):
        """After a rebalance moved objects to new slots, move their
        trajectory rings the same way (host-side, rebalances are rare)."""
        from collide.core.state import state_from_numpy
        from collide.detect.predict import TrajectoryHistory
        from collide.shard.predict import distribute_history

        alive = np.asarray(old_state.alive)
        idx = np.flatnonzero(alive)
        packed = state_from_numpy(
            pos=np.asarray(old_state.pos)[idx],
            vel=np.asarray(old_state.vel)[idx],
            acc=np.asarray(old_state.acc)[idx],
            heading=np.asarray(old_state.heading)[idx],
            size=np.asarray(old_state.size)[idx],
            otype=np.asarray(old_state.otype)[idx],
            oid=np.asarray(old_state.oid)[idx])
        hist_packed = TrajectoryHistory(
            pos=np.asarray(self._traj.pos)[idx],
            t=np.asarray(self._traj.t)[idx],
            count=np.asarray(self._traj.count)[idx],
            head=np.asarray(self._traj.head)[idx])
        return distribute_history(hist_packed, self.cfg, self.mesh, packed,
                                  boundaries=self.boundaries,
                                  boundaries_y=self.boundaries_y,
                                  boundaries_z=self.boundaries_z)

    # ---- trajectory prediction on the mesh ----

    def record_trajectories(self, dt: Optional[float] = None) -> None:
        """Append current positions to the per-object trajectory rings
        (sharded alongside the fleet; they migrate with their objects).
        Call once per external tick when using predict()."""
        from collide.detect.predict import (empty_history,
                                            update_history)
        from jax.sharding import NamedSharding, PartitionSpec as P
        from collide.shard.step import _state_spec_axes

        with self._lock:
            self._flush_locked()
            self._ensure_state()
            if self._traj is None:
                sharding = NamedSharding(self.mesh,
                                         P(_state_spec_axes(self.cfg)))
                self._traj = jax.device_put(
                    empty_history(self.state.alive.shape[0]), sharding)
                self._upd_hist = jax.jit(update_history, donate_argnums=(0,))
            self._traj_clock += dt if dt is not None else self.cfg.sim.dt
            self._traj = self._upd_hist(self._traj, self.state,
                                        self._traj_clock)

    def predict(self, horizon: float = 10.0, step: float = 0.5):
        """Trajectory prediction across the WHOLE mesh: each shard predicts
        its owned objects against a halo band widened by the maximum
        predicted displacement (shard/predict.py) — results equal the
        single-device `predict_collisions` (tests/test_sharded_predict.py).
        Returns is_predicted CollisionRisks and feeds the AlertManager.

        The reference ran this per node WITHOUT cross-node visibility
        (warning_system.py:695-714 + compute_node.py:343-368); the widened
        halo is what makes the distributed version actually correct."""
        from collide.core.types import CollisionRisk
        from collide.shard.predict import make_sharded_predict
        import jax.numpy as jnp

        a = self.cfg.alerts
        with self._lock:
            self._flush_locked()
            if self._traj is None:
                return []
            key2 = (float(horizon), float(step))
            fns = self._predict_cache.get(key2)
            if fns is None:
                pfn = make_sharded_predict(self.cfg, self.mesh,
                                           horizon=key2[0], step=key2[1])
                r_cap = int(min(a.max_scene_alerts,
                                self.state.alive.shape[0] * 32))

                def compact(state, hist, bx, by, bz):
                    other, valid, risk, ttc, dist, dropped, oflow = pfn(
                        state, hist, bx, by, bz)
                    keep = valid & (risk >= a.risk_low)
                    keyv = jnp.where(keep, risk, -1.0).reshape(-1)
                    top_r, top_i = jax.lax.top_k(keyv,
                                                 min(r_cap, keyv.size))
                    kk = risk.shape[1]
                    rows = top_i // kk
                    sel = lambda x: x.reshape(-1)[top_i]
                    return (top_r, state.oid[rows], sel(other), sel(ttc),
                            sel(dist), jnp.sum(keep, dtype=jnp.int32),
                            jnp.sum(dropped), jnp.sum(oflow))

                fns = (jax.jit(compact), r_cap)
                self._predict_cache[key2] = fns
            fn, r_cap = fns
            fetched = jax.device_get(fn(self.state, self._traj,
                                        self.boundaries,
                                        self.boundaries_y,
                                        self.boundaries_z))
        top_r, voids, ooids, t_sel, d_sel, total, dropped, oflow = fetched
        if int(oflow) > 0:
            logger.warning(
                "sharded predict: %d objects beyond cell_capacity were "
                "dropped from their grid buckets — raise cell_capacity; "
                "the list may be missing pairs (counted, never silent)",
                int(oflow))
        if int(dropped) > 0:
            logger.warning(
                "sharded predict: %d halo-band objects beyond capacity "
                "were dropped from candidate visibility this call",
                int(dropped))
        if int(total) > r_cap:
            logger.warning(
                "sharded predict: %d predicted risks exceed the %d-slot "
                "scene budget (raise AlertConfig.max_scene_alerts)",
                int(total), r_cap)
        out = []
        for j in range(len(top_r)):
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

    # ---- queries ----

    def alerts(self, min_risk: float = 0.0,
               vehicle_id: Optional[str] = None) -> List[Alert]:
        src = (self.alert_manager.get_vehicle_alerts(vehicle_id)
               if vehicle_id else list(self.alert_manager.alerts.values()))
        return sorted((a for a in src if a.risk_level >= min_risk),
                      key=lambda a: (-a.priority, -a.risk_level))

    def detect(self) -> Any:
        """Detection only, no physics — the EarlyWarningSystem pattern for
        externally-driven fleets (ingest -> flush -> detect), over the
        mesh (halo exchange + XLA tail; make_sharded_detect)."""
        from collide.shard.step import make_sharded_detect
        with self._lock:
            self._drain_locked()
            self._flush_locked()
            self._ensure_state()
            if self._detect is None:
                self._detect = make_sharded_detect(self.cfg, self.mesh)
            with Timer() as t:
                out, dropped = self._detect(self.state, self.boundaries,
                                            self.boundaries_y,
                                            self.boundaries_z)
                jax.block_until_ready(out.num_risks)
            self.dropped_total += int(np.asarray(dropped).sum())
            self.stats_timing["steps"] += 1
            self.stats_timing["total_ms"] += t.elapsed_ms
            self.stats_timing["max_ms"] = max(self.stats_timing["max_ms"],
                                              t.elapsed_ms)
            self.alert_manager.process_batch(out.alerts,
                                             resolver=self.vehicle_id_of)
        return out.alerts

    # ---- host-side vehicle views (reference storage.py semantics) ----

    def get_location(self, vehicle_id: str):
        hist = self._history.get(vehicle_id)
        return hist[-1] if hist else None

    def get_history(self, vehicle_id: str) -> list:
        return list(self._history.get(vehicle_id, []))

    def get_vehicle_risks(self, vehicle_id: str) -> list:
        from collide.core.types import CollisionRisk
        out = []
        for a in self.alert_manager.get_vehicle_alerts(vehicle_id):
            out.append(CollisionRisk(
                id=a.id, vehicle_id=a.vehicle_id,
                other_vehicle_id=a.other_vehicle_id,
                risk_level=a.risk_level,
                time_to_collision=a.time_to_collision,
                distance=float("nan"), timestamp=a.timestamp))
        return out

    def grid_vehicles(self, cx: int, cy: int, cz: int = 0) -> list:
        """Vehicle ids whose current position falls in grid cell
        (cx, cy, cz) — GET /grids/{id}/vehicles semantics, collected from
        the mesh."""
        from collide.index.grid import cell_coords
        with self._lock:
            self._flush_locked()
            host = collect_state(self.state)
        c3 = np.asarray(cell_coords(host.pos, self.cfg))
        alive = np.asarray(host.alive)
        oids = np.asarray(host.oid)
        hit = alive & (c3[:, 0] == cx) & (c3[:, 1] == cy) & (c3[:, 2] == cz)
        return [self.vehicle_id_of(o) for o in oids[hit]]

    def drop_fraction(self, fraction: float) -> int:
        """Fault injection: kill `fraction` of the alive fleet across the
        mesh (sharding-preserving). Returns the kill count."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        from collide.shard.step import _state_spec_axes
        import jax.numpy as jnp

        with self._lock:
            alive = np.asarray(jax.device_get(self.state.alive)).copy()
            idx = np.flatnonzero(alive)
            kill = idx[:int(len(idx) * fraction)]
            alive[kill] = False
            sharding = NamedSharding(self.mesh,
                                     P(_state_spec_axes(self.cfg)))
            self.state = self.state.replace(
                alive=jax.device_put(jnp.asarray(alive), sharding))
        return int(len(kill))

    def occupancy(self) -> np.ndarray:
        with self._lock:
            if self.state is None:
                return np.zeros(self.cfg.shard.total_shards, int)
            return shard_occupancy(self.state, self.cfg, self.slots)

    def stats(self) -> Dict[str, Any]:
        occ = self.occupancy()
        s = self.stats_timing
        return {
            "step_count": self.step_count,
            "num_alive": int(occ.sum()),
            "num_shards": self.cfg.shard.num_shards,
            "num_shards_y": self.cfg.shard.num_shards_y,
            "shard_occupancy": occ.tolist(),
            "slots_per_shard": self.slots,
            "dropped_total": self.dropped_total,
            "avg_step_ms": (s["total_ms"] / s["steps"]) if s["steps"] else 0.0,
            "max_step_ms": s["max_ms"],
            "alerts": self.alert_manager.get_stats(),
            "rebalances": (self.balancer.stats["rebalances"]
                           if self.balancer else 0),
        }

    # ---- reliability (checkpointed failover, BASELINE config 5) ----

    def save_checkpoint(self, metadata: Optional[dict] = None) -> str:
        assert self.ckpt is not None
        with self._lock:
            host = collect_state(self.state)
        return self.ckpt.save(host, self.step_count, metadata=metadata)

    def save_checkpoint_async(self, metadata: Optional[dict] = None):
        """Non-blocking snapshot of the SHARDED fleet: a device-side copy
        (sharding-preserving) pins the bits synchronously; the cross-shard
        gather + compression run on a background thread while the mesh
        keeps stepping. Join/raise via
        self.ckpt.wait_async()."""
        assert self.ckpt is not None
        with self._lock:
            return self.ckpt.save_async(self.state, self.step_count,
                                        metadata=metadata,
                                        transfer_lock=self._lock)

    def restore_checkpoint(self, step: Optional[int] = None) -> int:
        """Failover: reload the latest snapshot and redistribute it across
        whatever devices the mesh has now."""
        assert self.ckpt is not None
        host, meta = self.ckpt.restore(step)
        with self._lock:
            # drop dead/padding slots before redistribution
            alive = np.asarray(host.alive)
            idx = np.flatnonzero(alive)
            from collide.core.state import state_from_numpy
            packed = state_from_numpy(
                pos=np.asarray(host.pos)[idx],
                vel=np.asarray(host.vel)[idx],
                acc=np.asarray(host.acc)[idx],
                heading=np.asarray(host.heading)[idx],
                size=np.asarray(host.size)[idx],
                otype=np.asarray(host.otype)[idx],
                oid=np.asarray(host.oid)[idx])
            self.state = distribute_state(
                packed, self.cfg, self.mesh, boundaries=self.boundaries,
                boundaries_y=self.boundaries_y,
                boundaries_z=self.boundaries_z)
            self.step_count = meta["step"]
        return self.step_count
