"""Load balancing for the sharded mesh: density-aware re-tiling.

The reference rebalances by gossiping load metrics and migrating shards
between nodes (ShardManager._rebalance_shards data_sharding.py:487-564,
LoadBalancer:591-845, SpatialPartitioner region split/merge
spatial_index.py:585-679). On a device mesh, devices are fixed but slab
BOUNDARIES are not: when density skews (the 80/20 city distribution),
re-tile the world so each device owns an equal share of objects.

Static equal slabs are the default (zero overhead); `LoadBalancer` watches
per-shard occupancy each step (free — it's in the step output) and, past an
imbalance threshold, computes quantile boundaries host-side and
redistributes. Re-tiling costs one gather + scatter (~ms), amortized over
the thousands of steps between rebalances — the same trade the reference
made with its 10 s rebalance loop (data_sharding.py:487-511).

The sharded step consumes a [D+1] slab-wall array (shard/step.py
`step(state, key, boundaries)`), so rebalancing MOVES THE WALLS: quantile
boundaries put ~equal object counts in every slab, clamped to a minimum
width that keeps halo coverage and one-slab-per-step migration sound
(step.check_boundaries). `rebalance()` computes the new walls and
redistributes the fleet under them in one host round-trip.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from collide.core.config import SystemConfig
from collide.core.state import ObjectState
from collide.core.utils import get_logger

logger = get_logger(__name__)


def shard_occupancy(state_sharded: ObjectState, cfg: SystemConfig,
                    slots: int) -> np.ndarray:
    """[D] alive objects per shard (host-side read of the alive mask);
    D = total shards, x-major on the 2D tiling."""
    d = cfg.shard.total_shards
    alive = np.asarray(state_sharded.alive).reshape(d, slots)
    return alive.sum(axis=1)


def imbalance(occ: np.ndarray) -> float:
    """max/mean occupancy ratio (1.0 = perfectly balanced).
    The reference triggered at 1.2x avg (data_sharding.py:513-564)."""
    mean = occ.mean()
    return float(occ.max() / mean) if mean > 0 else 1.0


def quantile_boundaries(x: np.ndarray, d: int,
                        lo: float, hi: float,
                        min_width: float) -> np.ndarray:
    """[d+1] x-boundaries putting ~equal object counts in each slab,
    clamped to a minimum slab width (halo/migration correctness).
    The analog of SpatialPartitioner's split-hottest-region pass
    (spatial_index.py:701-771) done globally in one shot."""
    qs = np.quantile(x, np.linspace(0.0, 1.0, d + 1))
    qs[0], qs[-1] = lo, hi
    for i in range(1, d + 1):
        qs[i] = max(qs[i], qs[i - 1] + min_width)
    qs = np.minimum(qs, hi)
    for i in range(d - 1, 0, -1):
        qs[i] = min(qs[i], qs[i + 1] - min_width)
    return qs


class LoadBalancer:
    """Occupancy watcher + rebalance trigger for a sharded fleet
    (the LoadBalancer/ShardManager-rebalance analog,
    data_sharding.py:591-845)."""

    def __init__(self, cfg: SystemConfig, slots: int,
                 overload_ratio: float = 1.2,
                 check_every: int = 100):
        self.cfg = cfg
        self.slots = slots
        self.overload_ratio = overload_ratio
        self.check_every = check_every
        self._step = 0
        self.stats = {"checks": 0, "rebalances": 0, "backoffs": 0}
        self.last_occupancy: Optional[np.ndarray] = None
        self._post_rebalance_occ: Optional[np.ndarray] = None

    def min_slab_width(self) -> float:
        """Smallest legal slab: halo band must fit and no object may cross
        more than one slab per step."""
        c = self.cfg
        return max(c.shard.halo_width, c.sim.max_speed * c.sim.dt) * 1.01

    def should_rebalance(self, state_sharded: ObjectState) -> bool:
        """Call once per step; inspects occupancy every `check_every`."""
        self._step += 1
        if self._step % self.check_every:
            return False
        self.stats["checks"] += 1
        occ = shard_occupancy(state_sharded, self.cfg, self.slots)
        self.last_occupancy = occ
        # Skew even wall-moving cannot fix (min_width clamps against a
        # single ultra-dense column): if the last rebalance left occupancy
        # essentially unchanged, back off instead of paying a host
        # round-trip every check.
        if (self._post_rebalance_occ is not None
                and np.array_equal(occ, self._post_rebalance_occ)):
            self.stats["backoffs"] += 1
            if occ.max() >= 0.95 * self.slots:
                logger.warning(
                    "shard occupancy %s near slot limit %d and quantile "
                    "walls are clamped by min_slab_width — raise "
                    "ShardConfig.slot_headroom", occ.tolist(), self.slots)
            return False
        # also rebalance when any shard nears slot exhaustion
        near_full = occ.max() >= 0.9 * self.slots
        return near_full or imbalance(occ) > self.overload_ratio

    def rebalance(self, state_sharded: ObjectState, mesh):
        """Collect -> compute quantile slab walls PER AXIS -> redistribute
        under them. Returns (new_state, boundaries_x [Dx+1], boundaries_y
        [Dy+1] or None, boundaries_z [Dz+1] or None); feed all of them to
        every subsequent step call. This is the mesh replacement for
        the reference's region split/merge + shard migration
        (spatial_index.py:585-679, data_sharding.py:513-564); with a
        2D/3D tiling the per-axis quantiles are the octree-split analog —
        a y- or z-skewed fleet that x walls cannot balance gets balanced
        by the y/z walls."""
        from collide.shard.step import (distribute_state,
                                        check_boundaries)
        from collide.core.state import state_from_numpy

        dx = self.cfg.shard.num_shards
        dy = self.cfg.shard.num_shards_y
        dz = self.cfg.shard.num_shards_z
        fields = {f: np.asarray(getattr(state_sharded, f))
                  for f in ("pos", "vel", "acc", "heading", "size",
                            "otype", "alive", "oid")}
        alive_idx = np.flatnonzero(fields["alive"])
        packed = state_from_numpy(
            pos=fields["pos"][alive_idx], vel=fields["vel"][alive_idx],
            acc=fields["acc"][alive_idx],
            heading=fields["heading"][alive_idx],
            size=fields["size"][alive_idx], otype=fields["otype"][alive_idx],
            oid=fields["oid"][alive_idx])
        bx = quantile_boundaries(
            fields["pos"][alive_idx, 0], dx,
            self.cfg.world.lo[0], self.cfg.world.hi[0],
            self.min_slab_width())
        check_boundaries(self.cfg, bx, dim=0)
        by = None
        if dy > 1:
            by = quantile_boundaries(
                fields["pos"][alive_idx, 1], dy,
                self.cfg.world.lo[1], self.cfg.world.hi[1],
                self.min_slab_width())
            check_boundaries(self.cfg, by, dim=1)
        bz = None
        if dz > 1:
            bz = quantile_boundaries(
                fields["pos"][alive_idx, 2], dz,
                self.cfg.world.lo[2], self.cfg.world.hi[2],
                self.min_slab_width())
            check_boundaries(self.cfg, bz, dim=2)
        self.stats["rebalances"] += 1
        logger.info("rebalanced %d objects across %dx%dx%d shards "
                    "(occupancy %s, x walls %s, y walls %s, z walls %s)",
                    len(alive_idx), dx, dy, dz,
                    self.last_occupancy.tolist()
                    if self.last_occupancy is not None else "?",
                    np.round(bx, 1).tolist(),
                    np.round(by, 1).tolist() if by is not None else "-",
                    np.round(bz, 1).tolist() if bz is not None else "-")
        new_state = distribute_state(packed, self.cfg, mesh,
                                     boundaries=bx, boundaries_y=by,
                                     boundaries_z=bz)
        self._post_rebalance_occ = shard_occupancy(new_state, self.cfg,
                                                   self.slots)
        return new_state, bx, by, bz
