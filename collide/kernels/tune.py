"""Host-side capacity sizing from fleet statistics.

The reference adapted grid resolution to density at runtime
(spatial_index.py:139-160, 302-412). This design keeps the compiled program
static and instead (a) counts capacity overflow and regrows between steps
(Scene's bucket self-heal), and (b) here picks the static gather-bucket
capacity RIGHT on the first step from a host-side pass over the actual
fleet.
"""
from __future__ import annotations

import numpy as np

from collide.core.config import SystemConfig


def suggest_cell_capacity(state, cfg: SystemConfig, margin: int = 2) -> int:
    """Exact gather-path bucket capacity for THIS fleet: the maximum
    live-cell occupancy (+ margin), host-side in numpy. The gather path
    (index/grid.gather_candidates) drops objects beyond
    GridConfig.cell_capacity from their bucket's candidate list (counted
    as grid_overflow, never silent); sizing the capacity from the actual
    densest cell makes detect()/predict() complete for the given
    positions without hand-tuning — the runtime analog of the reference's
    density-driven cell splits (spatial_index.py:139-160). Rounded up to a
    multiple of 4 so retune hysteresis doesn't thrash on single-object
    density jitter."""
    nx, ny, nz = cfg.grid_dims
    pos = np.asarray(state.pos)
    alive = np.asarray(state.alive)
    lo = np.asarray(cfg.world.lo, np.float32)
    c3 = np.clip((np.floor((pos - lo) / cfg.grid.cell_size)).astype(int),
                 0, np.asarray((nx, ny, nz)) - 1)
    cid = (c3[:, 0] * ny + c3[:, 1]) * nz + c3[:, 2]
    occ = np.bincount(cid[alive], minlength=1)
    need = int(occ.max(initial=0)) + margin
    return max(4, -(-need // 4) * 4)
