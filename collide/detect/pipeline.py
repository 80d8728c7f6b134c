"""Canonical 4-stage collision-detection pipeline, vectorized over all
objects x candidates in one XLA program.

Semantics match the reference's canonical detector
(collision_detection.py:110-389 — the pipeline SURVEY.md §0.4 designates for
alert parity), restated array-wise:

  stage 1  spatial filter: grid-stencil candidates, exact radius, no self
           (collision_detection.py:208-227)
  stage 2  temporal filter: rel-speed floor, closest-approach time
           t* = -dot(rel_pos, rel_vel)/|rel_vel|^2, window clip, closest
           distance vs pair safe distance (collision_detection.py:229-294)
  stage 3  precise detection: sample t = 0, dt, ..., window-dt under
           constant-acceleration kinematics, first sample with
           dist <= safe is the collision (collision_detection.py:296-342);
           'fast' mode replaces the sweep with the closed-form
           constant-velocity first crossing (quadratic root)
  stage 4  weighted risk scoring (collision_detection.py:344-389)

The reference ran this per vehicle in Python at ~ms each (50 ms SLO,
collision_detection.py:187-189); here the whole fleet is one fused program.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from collide.core.config import SystemConfig
from collide.core.state import ObjectState
from collide.index.grid import GridIndex, gather_candidates


@partial(jax.tree_util.register_dataclass,
         data_fields=["other", "valid", "risk", "ttc", "distance",
                      "rel_speed", "col_pos", "survivor_overflow",
                      "num_checked"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class PairRisks:
    """Per-object candidate risk table, fixed shape [N, K].

    valid=True rows carry a detected collision risk; everything else is
    padding (risk=0, ttc=inf). survivor_overflow counts stage-2 survivors
    beyond precise_survivor_cap whose stage-3 sweep was skipped (0 in fast
    mode and whenever the cap holds). num_checked counts candidate pairs
    that passed stage 1 (alive, non-self, within search radius)."""
    other: jax.Array      # [N, K] int32 other-object index
    valid: jax.Array      # [N, K] bool
    risk: jax.Array       # [N, K] f32 in [0, 1]
    ttc: jax.Array        # [N, K] f32 seconds (inf when invalid)
    distance: jax.Array   # [N, K] f32 distance at collision time
    rel_speed: jax.Array  # [N, K] f32
    col_pos: jax.Array    # [N, K, 3] f32 midpoint at collision time
    survivor_overflow: jax.Array   # [] int32
    num_checked: jax.Array         # [] int32


def _pair_safe_distance(size_i, size_j, det):
    # reference collision_detection.py:484-496
    return (size_i + size_j) * 0.5 + det.safe_distance_base


def _dist_at_time(rel_pos, rel_vel, rel_acc, t):
    """|rel_pos + rel_vel t + 0.5 rel_acc t^2| (constant-accel kinematics,
    reference collision_detection.py:433-466)."""
    d = rel_pos + rel_vel * t[..., None] + 0.5 * rel_acc * jnp.square(t)[..., None]
    return jnp.linalg.norm(d, axis=-1)


def _precise_sweep(rel_pos, rel_vel, rel_acc, safe, det):
    """Stage-3 sampled sweep. Returns (hit, t_hit, dist_hit).

    Scans t = 0, dt, ..., (T-1) dt and keeps the FIRST sample with
    dist <= safe, like the reference's early-return loop
    (collision_detection.py:317-341).

    The time axis is evaluated in vectorized chunks of C samples per loop
    iteration rather than one fori_loop step per sample: XLA loops run
    every iteration regardless (no early exit), so the per-sample loop was
    pure launch overhead — ~2 ms of the 1k headline step and ~10 tiny
    kernels per predict refine offset. Each sample's t is the identical
    f32(k) * dt lattice value and the first-hit selection is positional,
    so results are bit-identical to the per-sample loop."""
    T = det.num_time_steps
    dt = det.time_step
    p = int(np.prod(rel_pos.shape[:-1], dtype=np.int64))
    # chunk so the [C, ...] distance temp stays ~<= 32M elements
    C = max(1, min(T, int(32e6 // max(1, p))))
    n_chunks = -(-T // C)
    lead = (slice(None),) + (None,) * max(0, rel_pos.ndim - 1)
    ks = jnp.arange(C, dtype=jnp.int32)

    def chunk(k0, carry):
        hit, t_hit, d_hit = carry
        k = k0 + ks                                     # [C]
        t = k.astype(jnp.float32) * dt                  # f32(k) * dt lattice
        tb = jnp.broadcast_to(t[lead], (C,) + rel_pos.shape[:-1])
        d = _dist_at_time(rel_pos[None], rel_vel[None], rel_acc[None], tb)
        inside = (d <= safe[None]) & (k < T)[lead]      # [C, ...]
        # first-inside sample via a one-hot cumsum mask — elementwise ops
        # only; argmax + take_along_axis lowered to a gather that cost
        # ~25% of the 100k predict pass
        csum = jnp.cumsum(inside.astype(jnp.int32), axis=0)
        newh = inside & (csum == 1)                     # one-hot per element
        has = csum[-1] > 0
        # one-hot sum == the selected sample's exact value (adding +0.0
        # leaves f32 values unchanged)
        t_c = jnp.sum(jnp.where(newh, tb, 0.0), axis=0)
        d_c = jnp.sum(jnp.where(newh, d, 0.0), axis=0)
        new_hit = (~hit) & has
        t_hit = jnp.where(new_hit, t_c, t_hit)
        d_hit = jnp.where(new_hit, d_c, d_hit)
        return (hit | new_hit, t_hit, d_hit)

    # derive the init carry from `safe` so it inherits shard_map's varying
    # manual axes (a plain jnp.zeros const would fail the VMA check)
    hit0 = safe < 0.0
    inf = jnp.where(safe < 0.0, 0.0, jnp.inf)
    carry = (hit0, inf, inf)
    if n_chunks <= 2:
        for i in range(n_chunks):                       # unrolled
            carry = chunk(jnp.int32(i * C), carry)
        return carry
    return jax.lax.fori_loop(
        0, n_chunks, lambda i, c: chunk(i * C, c), carry)


def _fast_first_crossing(rel_pos, rel_vel, safe, det):
    """Closed-form constant-velocity first time with dist <= safe:
    solve |p + v t|^2 = safe^2. Quantized to the stage-3 sampling lattice
    (ceil to a multiple of dt, so 'fast' and 'precise' agree for
    zero-acceleration fleets)."""
    a = jnp.sum(rel_vel * rel_vel, axis=-1)
    b = 2.0 * jnp.sum(rel_pos * rel_vel, axis=-1)
    c = jnp.sum(rel_pos * rel_pos, axis=-1) - safe * safe
    disc = b * b - 4.0 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    a_safe = jnp.where(a > 1e-12, a, 1.0)
    t_enter = (-b - sq) / (2.0 * a_safe)
    t_exit = (-b + sq) / (2.0 * a_safe)
    already_inside = c <= 0.0
    t_first = jnp.where(already_inside, 0.0, jnp.maximum(t_enter, 0.0))
    # snap up to the sampling lattice (first SAMPLE inside, as stage 3 sees it)
    dt = det.time_step
    t_snap = jnp.ceil(t_first / dt - 1e-6) * dt
    # the snapped sample must still be inside the crossing interval
    inside_at_snap = already_inside | ((t_snap >= t_enter - 1e-6) &
                                       (t_snap <= t_exit + 1e-6))
    hit = ((disc >= 0.0) | already_inside) & (a > 1e-12) & inside_at_snap & \
          (t_snap <= det.time_window - dt + 1e-6)
    hit = hit | (already_inside & (a <= 1e-12))
    t_hit = jnp.where(already_inside, 0.0, t_snap)
    zero_acc = jnp.zeros_like(rel_pos)
    d_hit = _dist_at_time(rel_pos, rel_vel, zero_acc, t_hit)
    return hit, jnp.where(hit, t_hit, jnp.inf), jnp.where(hit, d_hit, jnp.inf)


def _angle_factor(heading_i, heading_j, det):
    """sin(|hi - hj|): literal, or via the angle-difference identity
    (DetectionConfig.angle_form='product')."""
    if det.angle_form == "product":
        sd = (jnp.sin(heading_i) * jnp.cos(heading_j)
              - jnp.cos(heading_i) * jnp.sin(heading_j))
        return jnp.where(heading_i >= heading_j, sd, -sd)
    return jnp.sin(jnp.abs(heading_i - heading_j))


def _risk_score(dist_hit, t_hit, rel_speed, heading_i, heading_j,
                type_i, type_j, safe, det):
    """Stage-4 weighted risk (collision_detection.py:344-389, 498-513)."""
    distance_factor = 1.0 - dist_hit / safe
    time_factor = 1.0 - jnp.minimum(1.0, t_hit / det.max_warning_time)
    speed_factor = jnp.minimum(1.0, rel_speed / det.max_relative_speed)
    angle_factor = _angle_factor(heading_i, heading_j, det)
    type_factor = jnp.where(type_i == type_j, det.same_type_factor,
                            det.diff_type_factor)
    risk = (det.weight_distance * distance_factor
            + det.weight_time * time_factor
            + det.weight_speed * speed_factor
            + det.weight_angle * angle_factor
            + det.weight_type * type_factor)
    return jnp.clip(risk, 0.0, 1.0)


def detect_pairs(state: ObjectState, index: GridIndex,
                 cfg: SystemConfig) -> PairRisks:
    """Run stages 1-4 for every alive object against its grid candidates."""
    return detect_rows(state, index, cfg,
                       jnp.arange(state.n, dtype=jnp.int32))


def detect_rows(state: ObjectState, index: GridIndex, cfg: SystemConfig,
                rows: jax.Array,
                row_valid: jax.Array | None = None) -> PairRisks:
    """Stages 1-4 for the query objects `rows` ([Q] int32) against the whole
    indexed fleet. `detect_pairs` is rows = arange(N); the chunked large-N
    path maps this over row blocks so [Q, K] intermediates stay small
    (passing `row_valid` to mask its duplicated tail rows out of the
    stage-1 counter)."""
    det = cfg.detect

    # ---- stage 1: spatial filtering ----
    cand, cand_ok = gather_candidates(index, index.cell3[rows], cfg)  # [Q, K]
    cand_ok &= (cand != rows[:, None])

    # Pack the per-object fields into one [N, 13] matrix and do ONE row
    # gather per side instead of ~10 per-field gathers — gathers, not the
    # pair math, dominate this path (probe: stages 1-2 were 3.1 ms of the
    # 1k step). Values are the same f32 numbers (otype/alive casts are
    # exact), so results are unchanged.
    fmat = jnp.concatenate(
        [state.pos, state.vel, state.acc, state.size[:, None],
         state.heading[:, None], state.otype.astype(jnp.float32)[:, None],
         state.alive.astype(jnp.float32)[:, None]], axis=1)   # [N, 13]
    fo = fmat[rows][:, None, :]            # [Q, 1, 13]
    fc = fmat[cand]                        # [Q, K, 13]

    cand_ok &= (fc[..., 12] > 0.5) & (fo[..., 12] > 0.5)
    if row_valid is not None:
        cand_ok &= row_valid[:, None]

    pos_i = fo[..., 0:3]                   # [Q, 1, 3]
    pos_j = fc[..., 0:3]                   # [Q, K, 3]
    cur_dist = jnp.linalg.norm(pos_j - pos_i, axis=-1)
    cand_ok &= cur_dist <= det.search_radius

    # ---- stage 2: temporal filtering ----
    vel_i = fo[..., 3:6]
    vel_j = fc[..., 3:6]
    acc_i = fo[..., 6:9]
    acc_j = fc[..., 6:9]
    rel_vel = vel_i - vel_j                # vehicle minus other (ref :252-257)
    rel_pos = pos_j - pos_i                # other minus vehicle (ref :259-264)
    rel_speed = jnp.linalg.norm(rel_vel, axis=-1)

    safe = _pair_safe_distance(fo[..., 9], fc[..., 9], det)

    # Closest-approach time of the separation s(t) = rel_pos + (v_j - v_i) t.
    # 'physical': t* = -dot(rel_pos, v_j - v_i)/|rel|^2 (correct).
    # 'reference': t* = -dot(rel_pos, v_i - v_j)/|rel|^2 — the reference's
    # sign bug (collision_detection.py:271-277), kept for parity testing.
    sep_vel_2 = vel_j - vel_i
    conv = 1.0 if det.convention == "physical" else -1.0
    dot = conv * jnp.sum(rel_pos * sep_vel_2, axis=-1)
    rs2 = jnp.where(rel_speed > 0, rel_speed * rel_speed, 1.0)
    t_star = -dot / rs2
    closest_dist = _dist_at_time(rel_pos, sep_vel_2, acc_j - acc_i, t_star)
    pass2 = (cand_ok
             & (rel_speed >= det.min_relative_speed)
             & (t_star >= 0.0)
             & (t_star <= det.time_window)
             & (closest_dist <= safe))

    # ---- stage 3: precise detection ----
    sep_pos = rel_pos                       # p_j - p_i
    sep_vel = sep_vel_2
    sep_acc = acc_j - acc_i
    surv_overflow = jnp.asarray(0, jnp.int32)
    if det.mode == "fast":
        hit, t_hit, d_hit = _fast_first_crossing(sep_pos, sep_vel, safe, det)
        hit &= pass2
    else:
        # The sampled sweep only applies to stage-2 survivors (the reference
        # reaches stage 3 through stage 2, :143-151) — compact them and run
        # the T-step loop on [cap] pairs instead of [Q, K].
        q, k = pass2.shape
        cap = min(cfg.survivor_cap, q * k)
        flat2 = pass2.reshape(-1)
        surv_overflow = jnp.maximum(
            jnp.sum(flat2, dtype=jnp.int32) - cap, 0)
        _, surv_idx = jax.lax.top_k(flat2.astype(jnp.int32), cap)
        surv_ok = flat2[surv_idx]
        g = lambda a: a.reshape(q * k, *a.shape[2:])[surv_idx]
        s_hit, s_t, s_d = _precise_sweep(g(sep_pos), g(sep_vel), g(sep_acc),
                                         g(safe), det)
        s_hit &= surv_ok
        shape = pass2.shape
        hit = jnp.zeros(q * k, bool).at[surv_idx].set(
            s_hit, mode="drop").reshape(shape)
        t_hit = jnp.full(q * k, jnp.inf).at[surv_idx].set(
            jnp.where(s_hit, s_t, jnp.inf), mode="drop").reshape(shape)
        d_hit = jnp.full(q * k, jnp.inf).at[surv_idx].set(
            jnp.where(s_hit, s_d, jnp.inf), mode="drop").reshape(shape)

    # collision position = midpoint of the two predicted positions (ref :331)
    t_h = jnp.where(hit, t_hit, 0.0)[..., None]
    fut_i = pos_i + vel_i * t_h + 0.5 * acc_i * t_h * t_h
    fut_j = pos_j + vel_j * t_h + 0.5 * acc_j * t_h * t_h
    col_pos = 0.5 * (fut_i + fut_j)

    # ---- stage 4: risk assessment ----
    risk = _risk_score(jnp.where(hit, d_hit, 0.0), jnp.where(hit, t_hit, 0.0),
                       rel_speed, fo[..., 10], fc[..., 10],
                       fo[..., 11], fc[..., 11], safe, det)
    risk = jnp.where(hit, risk, 0.0)

    return PairRisks(
        other=cand, valid=hit, risk=risk,
        ttc=jnp.where(hit, t_hit, jnp.inf),
        distance=jnp.where(hit, d_hit, jnp.inf),
        rel_speed=jnp.where(hit, rel_speed, 0.0),
        col_pos=col_pos,
        survivor_overflow=surv_overflow,
        num_checked=jnp.sum(cand_ok, dtype=jnp.int32),
    )
