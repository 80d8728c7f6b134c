"""Sort-based uniform spatial grid — the array-native spatial index.

Replaces the reference's dict-of-sets grids (adaptive multi-level
spatial_index.py:31-432, uniform compute_node.py:20-149 and
optimized_performance_test.py:257-353) with a fully array-based build:

    cell_id = floor((pos - lo) / cell_size)   (clipped to grid dims)
    order   = argsort(flat_cell_id)           (stable; dead objects sort last)
    starts  = searchsorted(sorted_cells, arange(C + 1))

Bucket for cell c is `order[starts[c] : starts[c+1]]`. The index is rebuilt
every step, exactly like the measured harness (optimized_performance_test.py:
885-887) — on an accelerator a full rebuild is a single sort, cheaper than
incremental maintenance. This also fixes the reference's level-visibility bug
(spatial_index.py:240-259 queried only one resolution level and missed
vehicles resident at others — SURVEY.md §2.5): a single-level grid with an
exact radius filter sees everything.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from collide.core.config import SystemConfig


@partial(jax.tree_util.register_dataclass,
         data_fields=["cell3", "flat_cell", "order", "starts"],
         meta_fields=["dims"])
@dataclasses.dataclass(frozen=True)
class GridIndex:
    """cell3:     [N, 3] int32 per-object cell coordinates
    flat_cell: [N] int32 flattened cell id (dead objects get C = sentinel)
    order:     [N] int32 object indices sorted by flat_cell
    starts:    [C + 2] int32 bucket start offsets into `order`
    dims:      (nx, ny, nz) static grid dims
    """
    cell3: jax.Array
    flat_cell: jax.Array
    order: jax.Array
    starts: jax.Array
    dims: Tuple[int, int, int]


def cell_coords(pos: jax.Array, cfg: SystemConfig) -> jax.Array:
    """[*, 3] positions -> [*, 3] int32 cell coords, clipped into the grid."""
    lo = jnp.asarray(cfg.world.lo, jnp.float32)
    nd = jnp.asarray(cfg.grid_dims, jnp.int32)
    c = jnp.floor((pos - lo) / cfg.grid.cell_size).astype(jnp.int32)
    return jnp.clip(c, 0, nd - 1)


def flatten_cells(cell3: jax.Array, cfg: SystemConfig) -> jax.Array:
    nx, ny, _ = cfg.grid_dims
    return cell3[..., 0] + nx * (cell3[..., 1] + ny * cell3[..., 2])


def build_grid(pos: jax.Array, alive: jax.Array, cfg: SystemConfig) -> GridIndex:
    """One sort + one searchsorted; everything static-shaped."""
    num_cells = cfg.num_cells
    c3 = cell_coords(pos, cfg)
    flat = flatten_cells(c3, cfg)
    # Dead objects get sentinel cell C so they sort past every real bucket.
    flat = jnp.where(alive, flat, num_cells)
    order = jnp.argsort(flat).astype(jnp.int32)
    sorted_cells = flat[order]
    # starts[c] = first slot whose cell >= c ; starts has C+2 entries so
    # starts[c+1] is valid for c = C (the dead sentinel bucket).
    starts = bucket_starts(flat, num_cells)
    return GridIndex(cell3=c3, flat_cell=flat, order=order, starts=starts,
                     dims=cfg.grid_dims)


def bucket_starts(flat: jax.Array, num_cells: int) -> jax.Array:
    """[C+2] bucket start offsets: starts[c] = #elements with cell < c
    (== searchsorted(sorted, arange(C+2), 'left')), via scatter-add
    histogram + exclusive cumsum (chosen over searchsorted; not yet
    re-measured on the GPU — ROADMAP S5)."""
    counts = jnp.zeros(num_cells + 2, jnp.int32).at[flat].add(
        1, mode="drop")
    return jnp.concatenate(
        [jnp.zeros(1, jnp.int32),
         jnp.cumsum(counts, dtype=jnp.int32)[:-1]])


def _stencil_offsets(cfg: SystemConfig) -> jax.Array:
    """Static [S, 3] int32 neighbor-cell offsets covering search_radius."""
    w = cfg.stencil_halfwidth
    rng = range(-w, w + 1)
    zrng = rng if cfg.world.is_3d else (0,)
    offs = [(dx, dy, dz) for dz in zrng for dy in rng for dx in rng]
    return jnp.asarray(offs, jnp.int32)


def gather_candidates(index: GridIndex, query_cell3: jax.Array,
                      cfg: SystemConfig) -> Tuple[jax.Array, jax.Array]:
    """Broad-phase candidate gather.

    For each query cell (shape [Q, 3]) visit its static stencil of S neighbor
    cells and take up to `cell_capacity` objects from each bucket.

    Returns (cand_idx [Q, S*cap] int32, cand_valid [Q, S*cap] bool).
    Invalid slots point at object 0 with valid=False; callers must mask.
    """
    nx, ny, nz = index.dims
    nd = jnp.asarray((nx, ny, nz), jnp.int32)
    num_cells = nx * ny * nz
    cap = cfg.grid.cell_capacity
    offs = _stencil_offsets(cfg)                       # [S, 3]

    nb = query_cell3[:, None, :] + offs[None, :, :]    # [Q, S, 3]
    in_bounds = jnp.all((nb >= 0) & (nb < nd), axis=-1)  # [Q, S]
    nbc = jnp.clip(nb, 0, nd - 1)
    nb_flat = nbc[..., 0] + nx * (nbc[..., 1] + ny * nbc[..., 2])  # [Q, S]
    nb_flat = jnp.where(in_bounds, nb_flat, num_cells)  # sentinel: empty bucket

    b0 = index.starts[nb_flat]                          # [Q, S]
    b1 = index.starts[nb_flat + 1]
    slots = b0[..., None] + jnp.arange(cap, dtype=jnp.int32)  # [Q, S, cap]
    valid = slots < b1[..., None]
    n = index.order.shape[0]
    cand = index.order[jnp.clip(slots, 0, n - 1)]       # [Q, S, cap]
    q = query_cell3.shape[0]
    return cand.reshape(q, -1), valid.reshape(q, -1)


def query_radius(index: GridIndex, pos_all: jax.Array, alive: jax.Array,
                 query_pos: jax.Array, radius: float,
                 cfg: SystemConfig) -> Tuple[jax.Array, jax.Array]:
    """Exact radius query (the `get_nearby_vehicles` analog,
    spatial_index.py:229-271): candidates from the stencil, then exact
    distance filter. radius must be <= the stencil coverage
    (stencil_halfwidth * cell_size); asserted statically."""
    assert radius <= cfg.stencil_halfwidth * cfg.grid.cell_size + 1e-6, (
        "query radius exceeds static stencil coverage; widen "
        "DetectionConfig.search_radius or shrink the query")
    qc = cell_coords(query_pos, cfg)
    cand, valid = gather_candidates(index, qc, cfg)
    d = jnp.linalg.norm(pos_all[cand] - query_pos[:, None, :], axis=-1)
    ok = valid & alive[cand] & (d <= radius)
    return cand, ok
