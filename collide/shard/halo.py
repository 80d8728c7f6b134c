"""Halo exchange + object migration between mesh neighbours — the
communication backend.

What the reference does with an asyncio message broker, shard-management
topics and node reassignment callbacks (messaging.py:70-182,
data_sharding.py:231-371 — SURVEY.md §2.11) becomes two `ppermute`s between
slab neighbors inside the jitted step:

  * migration — objects whose x crossed the slab boundary move wholesale to
    the neighbor shard (the ShardManager.get_shard_for_vehicle analog,
    data_sharding.py:172-201, without stickiness: ownership IS position);
  * halo — a boundary band of width >= search_radius is mirrored to the
    neighbor so cross-boundary pairs are detected (the problem the
    reference never solved: per-node spatial indexes only saw local
    vehicles, compute_node.py:343-368).

All buffers are static-size; overflow drops the objects farthest from the
boundary and is reported in step stats.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from collide.core.config import SystemConfig
from collide.core.state import ObjectState

# fields exchanged between shards (everything narrow-phase needs)
_XCHG_FIELDS = ("pos", "vel", "acc", "heading", "size", "otype", "oid")


def axis_shards(cfg: SystemConfig, dim: int) -> Tuple[int, str]:
    """(device count, mesh axis name) of world axis `dim` (0 = x slabs,
    1 = y slabs of the 2D tiling, 2 = z slabs of the 3D tiling)."""
    if dim == 0:
        return cfg.shard.num_shards, cfg.shard.axis_name
    if dim == 1:
        return cfg.shard.num_shards_y, cfg.shard.axis_name_y
    assert dim == 2
    return cfg.shard.num_shards_z, cfg.shard.axis_name_z


def slab_bounds(cfg: SystemConfig, shard_idx: jax.Array,
                boundaries: jax.Array | None = None,
                dim: int = 0) -> Tuple[jax.Array, jax.Array]:
    """[lo, hi) of this shard's slab along world axis `dim`.

    boundaries: optional [D+1] f32 wall positions (replicated inside the
    step) — the dynamic re-tiling the reference did with region split/merge
    (spatial_index.py:585-679). None = equal slabs."""
    if boundaries is None:
        d, _ = axis_shards(cfg, dim)
        lo = cfg.world.lo[dim]
        width = (cfg.world.hi[dim] - cfg.world.lo[dim]) / d
        slab_lo = lo + width * shard_idx.astype(jnp.float32)
        return slab_lo, slab_lo + width
    slab_lo = boundaries[shard_idx]
    slab_hi = boundaries[shard_idx + 1]
    return slab_lo, slab_hi


def pack(state: ObjectState, mask: jax.Array, capacity: int,
         boundary: jax.Array, extra=None, dim: int = 0):
    """Compact up to `capacity` masked objects into a send buffer.

    When more than `capacity` objects match, those CLOSEST to the boundary
    (along world axis `dim`) win (they matter most for detection). Returns
    (buffer dict, valid [cap], dropped count). `extra` (optional dict
    name -> [N,...] array) rides along under 'x:'-prefixed keys — used by
    the scenario step to migrate per-object mode/road/target state with
    the object."""
    # rank: masked objects first, nearest the boundary first
    d = jnp.abs(state.pos[:, dim] - boundary)
    key = jnp.where(mask, d, jnp.inf)
    idx = jnp.argsort(key)[:capacity]
    valid = mask[idx]
    buf = {f: getattr(state, f)[idx] for f in _XCHG_FIELDS}
    if extra:
        for f, a in extra.items():
            buf["x:" + f] = a[idx]
    dropped = jnp.sum(mask, dtype=jnp.int32) - jnp.sum(valid, dtype=jnp.int32)
    return buf, valid, dropped


def _ppermute(tree, axis_name: str, perm):
    return jax.tree.map(lambda x: jax.lax.ppermute(x, axis_name, perm), tree)


def exchange_neighbors(buf_l, valid_l, buf_r, valid_r, cfg: SystemConfig,
                       dim: int = 0):
    """Send (buf_l, valid_l) to the lower slab neighbor and (buf_r, valid_r)
    to the upper, along world axis `dim`'s mesh axis; returns what arrived
    ((from_upper), (from_lower)). Edge shards receive zeros (valid=False).
    On a 2D mesh, devices sharing the other coordinate exchange
    independently (ppermute permutes along ONE named axis)."""
    d, ax = axis_shards(cfg, dim)
    to_left = [(i, i - 1) for i in range(1, d)]
    to_right = [(i, i + 1) for i in range(d - 1)]
    in_from_right = _ppermute((buf_l, valid_l), ax, to_left)
    in_from_left = _ppermute((buf_r, valid_r), ax, to_right)
    return in_from_right, in_from_left


def kill(state: ObjectState, mask: jax.Array) -> ObjectState:
    return state.replace(alive=state.alive & ~mask)


def place(state: ObjectState, buf, valid: jax.Array, extra=None):
    """Scatter arriving objects into dead slots. Returns (state, dropped
    count for arrivals that found no free slot) — plus the updated extra
    dict when `extra` is given (its 'x:'-prefixed fields in `buf` land in
    the same slots)."""
    cap = valid.shape[0]
    # free slots first (stable argsort of alive: False < True)
    slots = jnp.argsort(state.alive)[:cap]
    can = (~state.alive[slots]) & valid

    def scatter(arr, new):
        cur = arr[slots]
        mask = can.reshape((cap,) + (1,) * (new.ndim - 1))
        return arr.at[slots].set(jnp.where(mask, new, cur))

    upd = {f: scatter(getattr(state, f), buf[f]) for f in _XCHG_FIELDS}
    alive = state.alive.at[slots].set(state.alive[slots] | can)
    dropped = jnp.sum(valid, dtype=jnp.int32) - jnp.sum(can, dtype=jnp.int32)
    new_state = state.replace(alive=alive, **upd)
    if extra is None:
        return new_state, dropped
    new_extra = {f: scatter(a, buf["x:" + f]) for f, a in extra.items()}
    return new_state, new_extra, dropped


def migrate(state: ObjectState, cfg: SystemConfig,
            shard_idx: jax.Array,
            boundaries: jax.Array | None = None,
            extra=None, dim: int = 0):
    """Move objects whose `dim`-coordinate left the local slab to the
    neighbor shard along that axis. Objects can only cross one slab per
    step when max_speed * dt < min slab width (checked statically at mesh
    build for equal slabs; enforced via min_width at rebalance for dynamic
    ones). On a 2D tiling this runs twice — x phase then y phase — so a
    corner-crossing object reaches its diagonal neighbor in two hops
    within the same step.

    Returns (state, dropped) — or (state, extra, dropped) when `extra`
    per-object arrays (e.g. scenario mode/road/target) migrate along."""
    slab_lo, slab_hi = slab_bounds(cfg, shard_idx, boundaries, dim)
    d, _ = axis_shards(cfg, dim)
    m = cfg.shard.migrate_capacity

    c = state.pos[:, dim]
    go_l = state.alive & (c < slab_lo) & (shard_idx > 0)
    go_r = state.alive & (c >= slab_hi) & (shard_idx < d - 1)

    buf_l, val_l, drop_l = pack(state, go_l, m, slab_lo, extra=extra, dim=dim)
    buf_r, val_r, drop_r = pack(state, go_r, m, slab_hi, extra=extra, dim=dim)
    # emigrants leave regardless; a dropped emigrant is lost (counted)
    state = kill(state, go_l | go_r)

    (in_r, inval_r), (in_l, inval_l) = exchange_neighbors(
        buf_l, val_l, buf_r, val_r, cfg, dim)
    if extra is None:
        state, drop_pl = place(state, in_l, inval_l)
        state, drop_pr = place(state, in_r, inval_r)
        return state, drop_l + drop_r + drop_pl + drop_pr
    state, extra, drop_pl = place(state, in_l, inval_l, extra=extra)
    state, extra, drop_pr = place(state, in_r, inval_r, extra=extra)
    return state, extra, drop_l + drop_r + drop_pl + drop_pr


def halo_exchange(state: ObjectState, cfg: SystemConfig,
                  shard_idx: jax.Array,
                  boundaries: jax.Array | None = None,
                  dim: int = 0, width: float | None = None,
                  capacity: int | None = None):
    """Mirror boundary bands to slab neighbors along world axis `dim`.

    Returns (halo_buf, halo_valid, dropped): the 2*halo_capacity foreign
    objects visible to this shard this step. For the 2D tiling's y phase,
    pass the x-EXTENDED state (owned + x halo): re-mirroring the x halo in
    y is what covers corner neighborhoods. width/capacity override the
    ShardConfig band (the sharded PREDICT path widens the band by the
    predicted-displacement bound, shard/predict.py)."""
    slab_lo, slab_hi = slab_bounds(cfg, shard_idx, boundaries, dim)
    d, _ = axis_shards(cfg, dim)
    h = cfg.shard.halo_capacity if capacity is None else capacity
    w = cfg.shard.halo_width if width is None else width

    c = state.pos[:, dim]
    near_l = state.alive & (c < slab_lo + w) & (shard_idx > 0)
    near_r = state.alive & (c >= slab_hi - w) & (shard_idx < d - 1)

    buf_l, val_l, drop_l = pack(state, near_l, h, slab_lo, dim=dim)
    buf_r, val_r, drop_r = pack(state, near_r, h, slab_hi, dim=dim)
    (in_r, inval_r), (in_l, inval_l) = exchange_neighbors(
        buf_l, val_l, buf_r, val_r, cfg, dim)

    halo_buf = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), in_l, in_r)
    halo_valid = jnp.concatenate([inval_l, inval_r])
    return halo_buf, halo_valid, drop_l + drop_r


def halo_exchange_hops(state: ObjectState, cfg: SystemConfig,
                       shard_idx: jax.Array,
                       boundaries: jax.Array | None = None,
                       dim: int = 0, width: float | None = None,
                       capacity: int | None = None, hops: int = 1):
    """Multi-hop halo: mirror bands of width `width` that span up to `hops`
    slab neighbors per side (ROADMAP #6 — lifts the single-hop horizon cap
    on narrow slabs; the sharded PREDICT path needs bands wider than one
    slab when the predicted-displacement bound exceeds the slab width).

    Hop 1 packs each shard's own band exactly like `halo_exchange`; hop
    h > 1 FORWARDS what arrived from h-1 slabs away, re-filtered against
    this shard's own reach predicate (`c < slab_lo + w` leftward,
    `c >= slab_hi - w` rightward). An object owned by shard i±h reaches
    shard i iff it satisfies every intermediate shard's predicate, which
    is monotone in the wall positions — so the chain delivers EXACTLY the
    objects within `width` of this slab, across arbitrary (dynamic) walls,
    provided each slab is at least `width / hops` wide. No duplicates:
    hop h delivers only objects owned h slabs away.

    Returns (halo_buf, halo_valid [2 * hops * capacity], dropped); drops
    can only happen at the initial pack (counted, never silent)."""
    if hops <= 1:
        return halo_exchange(state, cfg, shard_idx, boundaries, dim,
                             width=width, capacity=capacity)
    slab_lo, slab_hi = slab_bounds(cfg, shard_idx, boundaries, dim)
    d, _ = axis_shards(cfg, dim)
    h = cfg.shard.halo_capacity if capacity is None else capacity
    w = cfg.shard.halo_width if width is None else width

    c = state.pos[:, dim]
    near_l = state.alive & (c < slab_lo + w) & (shard_idx > 0)
    near_r = state.alive & (c >= slab_hi - w) & (shard_idx < d - 1)
    buf_l, val_l, drop_l = pack(state, near_l, h, slab_lo, dim=dim)
    buf_r, val_r, drop_r = pack(state, near_r, h, slab_hi, dim=dim)
    dropped = drop_l + drop_r

    bufs, vals = [], []
    for hop in range(hops):
        (in_r, inval_r), (in_l, inval_l) = exchange_neighbors(
            buf_l, val_l, buf_r, val_r, cfg, dim)
        bufs += [in_l, in_r]
        vals += [inval_l, inval_r]
        if hop + 1 < hops:
            # keep leftward flow flowing left, rightward flowing right
            buf_l = in_r
            val_l = inval_r & (in_r["pos"][:, dim] < slab_lo + w)
            buf_r = in_l
            val_r = inval_l & (in_l["pos"][:, dim] >= slab_hi - w)

    halo_buf = jax.tree.map(lambda *a: jnp.concatenate(a), *bufs)
    halo_valid = jnp.concatenate(vals)
    return halo_buf, halo_valid, dropped


def extend_with_halo(state: ObjectState, halo_buf,
                     halo_valid) -> ObjectState:
    """Concatenate owned slots with halo mirrors into one detection-ready
    state. Halo rows are alive (so they appear as candidates) but callers
    must not emit alerts for them (use query_mask)."""
    ext = {}
    for f in _XCHG_FIELDS:
        ext[f] = jnp.concatenate([getattr(state, f), halo_buf[f]])
    alive = jnp.concatenate([state.alive, halo_valid])
    return ObjectState(alive=alive, **ext)
