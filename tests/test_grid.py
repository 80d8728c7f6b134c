"""Grid build + radius query vs a brute-force NumPy oracle
(the correctness layer the reference's spatial indexes never had,
SURVEY.md §4; also verifies we fixed the level-visibility bug of
spatial_index.py:240-259 — every in-radius neighbor is found)."""
import numpy as np
import jax
import jax.numpy as jnp

from collide import SystemConfig
from collide.core.config import WorldConfig, GridConfig, DetectionConfig
from collide.index.grid import build_grid, query_radius, cell_coords


def cfg_for(n, world=1000.0, cell=100.0, cap=64):
    return SystemConfig(
        num_objects=n,
        world=WorldConfig(hi=(world, world, 0.0)),
        grid=GridConfig(cell_size=cell, cell_capacity=cap),
        detect=DetectionConfig(search_radius=cell),
    )


def test_bucket_offsets_partition_all_objects(rng):
    n = 500
    cfg = cfg_for(n)
    pos = jnp.asarray(rng.uniform(0, 1000, (n, 3)), jnp.float32)
    pos = pos.at[:, 2].set(0.0)
    alive = jnp.asarray(rng.random(n) > 0.1)
    idx = build_grid(pos, alive, cfg)
    starts = np.asarray(idx.starts)
    # monotone, covers [0, n]
    assert (np.diff(starts) >= 0).all()
    assert starts[0] == 0 and starts[-1] == n
    # alive objects occupy exactly the first sum(alive) sorted slots
    n_alive = int(np.asarray(alive).sum())
    assert starts[cfg.num_cells] == n_alive
    # each alive object is in the bucket of its own cell
    flat = np.asarray(idx.flat_cell)
    order = np.asarray(idx.order)
    for i in np.flatnonzero(np.asarray(alive))[:50]:
        c = flat[i]
        bucket = order[starts[c]:starts[c + 1]]
        assert i in bucket


def test_query_radius_matches_bruteforce(rng):
    n = 400
    cfg = cfg_for(n)
    pos_np = rng.uniform(0, 1000, (n, 3)).astype(np.float32)
    pos_np[:, 2] = 0.0
    alive_np = rng.random(n) > 0.2
    pos, alive = jnp.asarray(pos_np), jnp.asarray(alive_np)
    idx = build_grid(pos, alive, cfg)

    q = jnp.asarray(pos_np[:32])
    cand, ok = query_radius(idx, pos, alive, q, 100.0, cfg)
    cand, ok = np.asarray(cand), np.asarray(ok)
    for qi in range(32):
        got = set(cand[qi][ok[qi]].tolist())
        d = np.linalg.norm(pos_np - pos_np[qi], axis=-1)
        want = set(np.flatnonzero((d <= 100.0) & alive_np).tolist())
        assert got == want, f"query {qi}: missing {want - got}, extra {got - want}"


def test_dense_cell_respects_capacity(rng):
    """Objects beyond cell_capacity in one cell are dropped from that cell's
    candidate list (documented broad-phase bound) — but never crash."""
    n = 100
    cfg = cfg_for(n, cap=8)
    pos = jnp.zeros((n, 3), jnp.float32) + 50.0   # all in one cell
    alive = jnp.ones(n, bool)
    idx = build_grid(pos, alive, cfg)
    cand, ok = query_radius(idx, pos, alive, pos[:4], 100.0, cfg)
    counts = np.asarray(ok).sum(axis=1)
    assert (counts == 8).all()


def test_boundary_objects_found_across_cells(rng):
    """Neighbors straddling a cell boundary are found via the stencil."""
    cfg = cfg_for(2)
    pos = jnp.asarray([[99.0, 50.0, 0.0], [101.0, 50.0, 0.0]], jnp.float32)
    alive = jnp.ones(2, bool)
    idx = build_grid(pos, alive, cfg)
    c3 = np.asarray(cell_coords(pos, cfg))
    assert c3[0, 0] != c3[1, 0]      # genuinely different cells
    cand, ok = query_radius(idx, pos, alive, pos, 100.0, cfg)
    got0 = set(np.asarray(cand)[0][np.asarray(ok)[0]].tolist())
    assert got0 == {0, 1}


def test_dead_objects_invisible(rng):
    cfg = cfg_for(3)
    pos = jnp.asarray([[50, 50, 0], [60, 50, 0], [70, 50, 0]], jnp.float32)
    alive = jnp.asarray([True, False, True])
    idx = build_grid(pos, alive, cfg)
    cand, ok = query_radius(idx, pos, alive, pos[:1], 100.0, cfg)
    got = set(np.asarray(cand)[0][np.asarray(ok)[0]].tolist())
    assert got == {0, 2}


def test_overflow_counter_reported(rng):
    """StepOutput.overflow counts capacity drops instead of hiding them."""
    import jax
    from collide.engine import make_step
    from collide.core.state import state_from_numpy
    n = 64
    cfg = cfg_for(n, cap=8)
    # everyone in one cell -> 64 - 8 = 56 beyond capacity
    pos = np.full((n, 3), 50.0, np.float32)
    st = state_from_numpy(pos, np.zeros((n, 3)), np.zeros((n, 3)),
                          np.zeros(n), np.full(n, 2.0), np.zeros(n, np.int32))
    _, out = make_step(cfg, donate=False)(st, jax.random.key(0))
    assert int(out.overflow) == n - cfg.grid.cell_capacity
    # spread out -> zero overflow
    pos2 = rng.uniform(0, 1000, (n, 3)).astype(np.float32)
    pos2[:, 2] = 0.0
    st2 = state_from_numpy(pos2, np.zeros((n, 3)), np.zeros((n, 3)),
                           np.zeros(n), np.full(n, 2.0),
                           np.zeros(n, np.int32))
    _, out2 = make_step(cfg, donate=False)(st2, jax.random.key(0))
    assert int(out2.overflow) == 0
