"""Trajectory-based collision prediction — the CollisionPredictionModel
analog (reference collision_detection.py:525-877), vectorized.

Reference semantics, restated array-wise:
  * per-object trajectory history (<=100 points, :538-539) -> here a fixed
    ring buffer [N, H] on device;
  * classify each trajectory from history-derived average speed/accel with
    0.1 thresholds: stationary / constant_velocity / accelerating
    (:623-711); objects with <2 history samples fall back to the plain
    4-stage detector (:590-592) — callers run `detect_pairs` for those rows
    (see `needs_fallback`);
  * predict future positions at t = 0, step, ..., horizon-step using the
    object's CURRENT velocity/acceleration per class (:713-763) — history
    shapes only the classification, exactly like the reference;
  * at each predicted point: spatial-filter against the CURRENT index
    (quirk kept: the reference queries today's index with tomorrow's
    position, :800-803), predict neighbors to the same offset, run precise
    detection with a 1 s sub-window + risk scoring (:789-846,
    is_predicted=True, ttc = sub-time + offset);
  * merge per unordered pair keeping max risk (:848-865).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from collide.core.config import SystemConfig
from collide.core.state import ObjectState
from collide.index.grid import GridIndex, gather_candidates, cell_coords
from collide.detect.pipeline import (_pair_safe_distance, _dist_at_time,
                                     _precise_sweep, _risk_score)

CLASS_STATIONARY, CLASS_CONST_VEL, CLASS_ACCEL = 0, 1, 2


@partial(jax.tree_util.register_dataclass,
         data_fields=["pos", "t", "count", "head"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class TrajectoryHistory:
    """Ring buffer of past positions. pos [N, H, 3], t [N, H] (seconds),
    count [N] valid samples, head [N] next write slot."""
    pos: jax.Array
    t: jax.Array
    count: jax.Array
    head: jax.Array

    @property
    def capacity(self) -> int:
        return self.pos.shape[1]


def empty_history(n: int, capacity: int = 16) -> TrajectoryHistory:
    """capacity=16 (not the reference's 100): classification only needs the
    recent window; 100 points of f32[3] per object is wasted device memory."""
    return TrajectoryHistory(
        pos=jnp.zeros((n, capacity, 3), jnp.float32),
        t=jnp.full((n, capacity), -jnp.inf, jnp.float32),
        count=jnp.zeros((n,), jnp.int32),
        head=jnp.zeros((n,), jnp.int32),
    )


def update_history(hist: TrajectoryHistory, state: ObjectState,
                   timestamp: jax.Array) -> TrajectoryHistory:
    """Append the fleet's current positions (one write per object).
    Reference: update_trajectory (collision_detection.py:553-570)."""
    n, h = hist.t.shape
    rows = jnp.arange(n)
    ts = jnp.broadcast_to(jnp.asarray(timestamp, jnp.float32), (n,))
    pos = hist.pos.at[rows, hist.head].set(
        jnp.where(state.alive[:, None], state.pos, hist.pos[rows, hist.head]))
    t = hist.t.at[rows, hist.head].set(
        jnp.where(state.alive, ts, hist.t[rows, hist.head]))
    head = jnp.where(state.alive, (hist.head + 1) % h, hist.head)
    count = jnp.where(state.alive, jnp.minimum(hist.count + 1, h), hist.count)
    return TrajectoryHistory(pos=pos, t=t, count=count, head=head)


def _chronological(hist: TrajectoryHistory):
    """Unroll rings into time order: returns (pos [N,H,3], t [N,H],
    valid [N,H]) with oldest first."""
    n, h = hist.t.shape
    slots = jnp.arange(h)
    # oldest sample sits at `head` when the ring is full, else at 0
    start = jnp.where(hist.count >= h, hist.head, 0)
    order = (start[:, None] + slots[None, :]) % h           # [N, H]
    rows = jnp.arange(n)[:, None]
    pos = hist.pos[rows, order]
    t = hist.t[rows, order]
    valid = slots[None, :] < hist.count[:, None]
    return pos, t, valid


def classify_trajectories(hist: TrajectoryHistory) -> jax.Array:
    """[N] int32 trajectory class from history-averaged speed/accel
    (reference _analyze_trajectory_pattern, collision_detection.py:623-711)."""
    pos, t, valid = _chronological(hist)
    dt = t[:, 1:] - t[:, :-1]                               # [N, H-1]
    vpair = valid[:, 1:] & valid[:, :-1] & (dt > 0)
    dt_safe = jnp.where(vpair, dt, 1.0)
    vel = (pos[:, 1:] - pos[:, :-1]) / dt_safe[..., None]
    vel = jnp.where(vpair[..., None], vel, 0.0)

    nv = jnp.sum(vpair, axis=1)
    avg_vel = jnp.sum(vel, axis=1) / jnp.maximum(nv, 1)[:, None]

    dtv = t[:, 2:] - t[:, 1:-1]
    apair = vpair[:, 1:] & vpair[:, :-1] & (dtv > 0)
    dtv_safe = jnp.where(apair, dtv, 1.0)
    acc = (vel[:, 1:] - vel[:, :-1]) / dtv_safe[..., None]
    acc = jnp.where(apair[..., None], acc, 0.0)
    na = jnp.sum(apair, axis=1)
    avg_acc = jnp.sum(acc, axis=1) / jnp.maximum(na, 1)[:, None]

    speed = jnp.linalg.norm(avg_vel, axis=-1)
    accel = jnp.linalg.norm(avg_acc, axis=-1)
    cls = jnp.where(speed < 0.1, CLASS_STATIONARY,
                    jnp.where(accel < 0.1, CLASS_CONST_VEL, CLASS_ACCEL))
    # no velocity pairs at all -> stationary (reference :695-696)
    return jnp.where(nv == 0, CLASS_STATIONARY, cls).astype(jnp.int32)


def needs_fallback(hist: TrajectoryHistory) -> jax.Array:
    """[N] bool: <2 samples -> caller should use plain detect_pairs for
    these rows (reference :590-592)."""
    return hist.count < 2


def _predicted_position(state: ObjectState, cls: jax.Array,
                        t: jax.Array) -> jax.Array:
    """Class-dependent future position at offset t (scalar).
    Reference _predict_future_trajectory (collision_detection.py:713-763)."""
    p_stat = state.pos
    p_cv = state.pos + state.vel * t
    p_acc = p_cv + 0.5 * state.acc * t * t
    c = cls[:, None]
    return jnp.where(c == CLASS_STATIONARY, p_stat,
                     jnp.where(c == CLASS_CONST_VEL, p_cv, p_acc))


def predict_collisions(state: ObjectState, hist: TrajectoryHistory,
                       index: GridIndex, cfg: SystemConfig,
                       horizon: float = 10.0, step: float = 0.5,
                       sub_window: float = 1.0, merge_k: int = 32,
                       ) -> Tuple[jax.Array, jax.Array, jax.Array,
                                  jax.Array, jax.Array]:
    """Predicted risks, merged per pair keeping max risk.

    Returns (other [N, merge_k], valid, risk, ttc, distance). Device cost is
    ~(horizon/step) detection passes; meant for the canonical/alerting path,
    not the 1M-object benchmark loop."""
    det = cfg.detect
    n = state.n
    cls = classify_trajectories(hist)
    offsets = jnp.arange(0.0, horizon, step, dtype=jnp.float32)
    sub_det = dataclasses.replace(det, time_window=sub_window)

    def at_offset(offset):
        # vehicle i at its class-predicted position; spatial filter uses the
        # CURRENT grid (reference quirk, :800-803)
        pred_pos = _predicted_position(state, cls, offset)
        qc = cell_coords(pred_pos, cfg)
        cand, ok = gather_candidates(index, qc, cfg)        # [N, K]
        self_idx = jnp.arange(n, dtype=jnp.int32)[:, None]
        ok &= (cand != self_idx) & state.alive[cand] & state.alive[:, None]

        # neighbors advanced to the same offset with const-accel kinematics
        # (reference _detect_at_position :808-812)
        o_pos = (state.pos[cand] + state.vel[cand] * offset
                 + 0.5 * state.acc[cand] * offset * offset)
        d_now = jnp.linalg.norm(o_pos - pred_pos[:, None, :], axis=-1)
        # the reference filters on CURRENT index distance; the gather stencil
        # already bounds it — keep the exact-radius filter on the pair used
        ok &= jnp.linalg.norm(state.pos[cand] - pred_pos[:, None, :],
                              axis=-1) <= det.search_radius

        safe = _pair_safe_distance(state.size[:, None], state.size[cand], det)
        sep_pos = o_pos - pred_pos[:, None, :]
        sep_vel = state.vel[cand] - state.vel[:, None, :]
        sep_acc = state.acc[cand] - state.acc[:, None, :]
        hit, t_hit, d_hit = _precise_sweep(sep_pos, sep_vel, sep_acc,
                                           safe, sub_det)
        hit &= ok
        rel_speed = jnp.linalg.norm(sep_vel, axis=-1)
        risk = _risk_score(jnp.where(hit, d_hit, 0.0),
                           jnp.where(hit, t_hit, 0.0),
                           rel_speed, state.heading[:, None],
                           state.heading[cand], state.otype[:, None],
                           state.otype[cand], safe, det)
        risk = jnp.where(hit, risk, 0.0)
        ttc = jnp.where(hit, t_hit + offset, jnp.inf)
        return cand, hit, risk, ttc, jnp.where(hit, d_hit, jnp.inf)

    cand, hit, risk, ttc, dist = jax.lax.map(at_offset, offsets)
    # [P, N, K] -> [N, P*K]
    swap = lambda x: jnp.swapaxes(x, 0, 1).reshape(n, -1)
    cand, hit, risk, ttc, dist = map(swap, (cand, hit, risk, ttc, dist))
    return merge_pair_risks(cand, hit, risk, ttc, dist, merge_k)


def merge_pair_risks(cand, hit, risk, ttc, dist, merge_k: int):
    """Top merge_k by risk per object, then dedup by other-id keeping the
    max-risk occurrence (reference _merge_collision_risks,
    collision_detection.py:848-865). Inputs are [N, M] per-object candidate
    records."""
    n = cand.shape[0]
    if cand.shape[1] < merge_k:
        # fewer candidate columns than the merge width (e.g. a short predict
        # horizon spanning few offsets): pad with invalid entries so the
        # [N, merge_k] output contract holds
        pad = merge_k - cand.shape[1]
        padf = lambda a, v: jnp.pad(a, ((0, 0), (0, pad)), constant_values=v)
        cand = padf(cand, 0)
        hit = padf(hit, False)
        risk, ttc, dist = padf(risk, 0.0), padf(ttc, jnp.inf), padf(dist, jnp.inf)
    top_risk, top_i = jax.lax.top_k(jnp.where(hit, risk, -1.0), merge_k)
    rows = jnp.arange(n)[:, None]
    top_other = cand[rows, top_i]
    top_valid = top_risk >= 0.0
    srt = jnp.argsort(jnp.where(top_valid, top_other, jnp.iinfo(jnp.int32).max),
                      axis=1, stable=True)
    o_s = jnp.take_along_axis(top_other, srt, 1)
    dup = jnp.concatenate(
        [jnp.zeros((n, 1), bool), o_s[:, 1:] == o_s[:, :-1]], axis=1)
    # risks within equal-other runs are NOT risk-sorted after the id sort;
    # take the max risk within each run instead of "first"
    r_s = jnp.take_along_axis(top_risk, srt, 1)
    t_s = jnp.take_along_axis(ttc[rows, top_i], srt, 1)
    d_s = jnp.take_along_axis(dist[rows, top_i], srt, 1)
    v_s = jnp.take_along_axis(top_valid, srt, 1)

    # Segment-max over runs of equal other-id: scatter-max risk per run,
    # then pick the (first) max-risk member's ttc/dist for the run, and
    # emit one entry per run at its first position.
    run_id = jnp.cumsum(~dup, axis=1) - 1                    # [N, merge_k]
    neg = jnp.where(v_s, r_s, -1.0)
    run_max = jax.vmap(
        lambda rid, val: jnp.full(merge_k, -1.0).at[rid].max(val)
    )(run_id, neg)                                           # [N, merge_k]
    rmax_here = jnp.take_along_axis(run_max, run_id, 1)

    first_of_run = ~dup
    valid_out = first_of_run & (rmax_here >= 0.0)
    risk_out = jnp.where(valid_out, rmax_here, 0.0)

    pos_in_row = jnp.broadcast_to(jnp.arange(merge_k)[None, :], v_s.shape)
    best_pos = jnp.where(v_s & (neg >= rmax_here), pos_in_row, merge_k)
    run_best_pos = jax.vmap(
        lambda rid, bp: jnp.full(merge_k, merge_k).at[rid].min(bp)
    )(run_id, best_pos)
    sel = jnp.clip(jnp.take_along_axis(run_best_pos, run_id, 1),
                   0, merge_k - 1)
    ttc_out = jnp.where(valid_out, jnp.take_along_axis(t_s, sel, 1), jnp.inf)
    dist_out = jnp.where(valid_out, jnp.take_along_axis(d_s, sel, 1), jnp.inf)
    other_out = jnp.where(valid_out, o_s, 0)
    return other_out, valid_out, risk_out, ttc_out, dist_out
