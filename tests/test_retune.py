"""Runtime capacity retuning (Scene.retune / auto_retune_every): the
runtime analog of the reference's density-driven grid-resolution
adjustment (spatial_index.py:139-160, 302-412 — a 10 s timer that SPLIT
dense cells and MERGED sparse ones). Here resolution is fixed (cell =
max(cell_size, search_radius) is the smallest legal cell for the 1-cell
stencil), so the adaptive dimension is CAPACITY: the gather buckets,
re-derived from the live fleet in BOTH directions — the counted-overflow
self-heal only ever grows."""
import numpy as np
import jax

import collide as tc
from collide.core.config import (WorldConfig, GridConfig,
                                 DetectionConfig, SimConfig)
from collide.core.state import state_from_numpy
from collide.sim import generate_fleet


def mk_cfg(n=256, cap=16, mode="fast"):
    return tc.SystemConfig(
        num_objects=n, world=WorldConfig(hi=(2000.0, 2000.0, 0.0)),
        grid=GridConfig(cell_size=100.0, cell_capacity=cap),
        detect=DetectionConfig(mode=mode),
        sim=SimConfig(accel_change_prob=0.0))


def fleet_from_pos(pos):
    n = pos.shape[0]
    return state_from_numpy(pos, np.zeros((n, 3), np.float32),
                            np.zeros((n, 3), np.float32),
                            np.zeros(n, np.float32),
                            np.full(n, 2.0, np.float32),
                            np.zeros(n, np.int32))


def clustered_fleet(n, n_dense, lo=500.0, width=60.0, seed=0):
    """n_dense objects crammed into one ~cell-sized patch, rest uniform."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 3), np.float32)
    pos[:n_dense, 0] = rng.uniform(lo, lo + width, n_dense)
    pos[:n_dense, 1] = rng.uniform(lo, lo + width, n_dense)
    pos[n_dense:, 0] = rng.uniform(0.0, 2000.0, n - n_dense)
    pos[n_dense:, 1] = rng.uniform(0.0, 2000.0, n - n_dense)
    return fleet_from_pos(pos)


def sparse_fleet(n, seed=1, n_alive=None):
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = rng.uniform(0.0, 2000.0, n)
    pos[:, 1] = rng.uniform(0.0, 2000.0, n)
    alive = None
    if n_alive is not None:
        alive = np.zeros(n, bool)
        alive[:n_alive] = True
    st = fleet_from_pos(pos)
    if alive is not None:
        import dataclasses
        import jax.numpy as jnp
        st = dataclasses.replace(st, alive=jnp.asarray(alive))
    return st


def test_suggest_cell_capacity_tracks_density():
    from collide.kernels.tune import suggest_cell_capacity
    cfg = mk_cfg(n=256)
    dense = clustered_fleet(256, 80, width=40.0)   # ~80 in one cell's span
    sparse = sparse_fleet(256)
    need_dense = suggest_cell_capacity(dense, cfg)
    need_sparse = suggest_cell_capacity(sparse, cfg)
    assert need_dense > need_sparse
    # the dense patch spans <= 1 cell in each axis, so the densest bucket
    # holds at least half of the 80 clustered objects
    assert need_dense >= 40
    assert need_sparse >= 4


def test_xla_scene_retune_grows_bucket_capacity():
    """Counted gather-bucket overflow (StepOutput.overflow on the XLA
    backend) goes to 0 after retune() resizes cell_capacity to the live
    densest cell."""
    from collide.api import Scene
    cfg = mk_cfg(n=128, cap=4)
    fleet = clustered_fleet(128, 40, width=30.0)
    sc = Scene(cfg, state=fleet)
    out = sc.step()
    assert int(out.overflow) > 0          # 40 objects >> 4-slot buckets
    assert sc.retune() is True
    assert sc.cfg.grid.cell_capacity >= 40
    out2 = sc.step()
    assert int(out2.overflow) == 0
    assert sc.retunes == 1
    assert sc.stats()["config"]["cell_capacity"] == sc.cfg.grid.cell_capacity


def test_xla_scene_retune_shrinks_with_hysteresis():
    from collide.api import Scene
    cfg = mk_cfg(n=256, cap=64)
    sc = Scene(cfg, state=sparse_fleet(256))
    assert sc.retune() is True            # 64 >> live densest bucket
    shrunk = sc.cfg.grid.cell_capacity
    assert shrunk < 64
    # stable point: a second retune on the same fleet is a no-op
    assert sc.retune() is False
    assert sc.cfg.grid.cell_capacity == shrunk
    assert int(sc.step().overflow) == 0   # shrunk capacity still complete


def test_auto_retune_every_runs_on_schedule():
    from collide.api import Scene
    cfg = mk_cfg(n=256, cap=64)
    sc = Scene(cfg, state=sparse_fleet(256),
               auto_retune_every=2)
    sc.step()
    assert sc.retunes == 0                # not due yet
    sc.step()
    assert sc.retunes == 1                # step 2: shrank the 64 buckets
    assert sc.cfg.grid.cell_capacity < 64


def test_service_wires_auto_retune():
    """--auto-retune reaches the Scene through CollisionSystem (and the
    CLI flag maps to the same ctor knob)."""
    from collide.system import CollisionSystem
    sysm = CollisionSystem(mk_cfg(n=64), auto_retune_every=3)
    assert sysm.scene._auto_retune == 3


