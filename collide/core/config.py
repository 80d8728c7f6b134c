"""Frozen configuration tree for the collision-detection framework.

One layered, immutable config replaces the reference's scattered module-level
constants and constructor defaults (reference: collision_detection.py:18-28,
warning_system.py:18-27, compute_node.py:648-672, models.py:67-94). Everything
that shapes a compiled program (grid dims, stencil width, candidate capacity,
time steps) is static here so `jax.jit` traces once.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    """Axis-aligned world bounds. Reference map default is 10 km x 10 km
    (optimized_performance_test.py:56) with z unused; we keep positions 3D."""
    lo: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    hi: Tuple[float, float, float] = (10_000.0, 10_000.0, 0.0)

    @property
    def extent(self) -> Tuple[float, float, float]:
        return tuple(h - l for l, h in zip(self.lo, self.hi))

    @property
    def is_3d(self) -> bool:
        return (self.hi[2] - self.lo[2]) > 0.0


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Sort-based uniform grid (replaces the dict-of-sets adaptive grid,
    reference spatial_index.py:31-432, and the uniform grid of
    optimized_performance_test.py:257-353).

    cell_size should be >= the detection search radius so a 1-cell stencil
    covers it; `stencil_halfwidth` grows automatically otherwise.
    cell_capacity bounds how many objects we gather per cell during the
    broad phase (objects beyond it in a cell are dropped from *that cell's*
    candidate list — size it for worst-case density; the 80/20 city skew in
    the reference generator concentrates objects, see SURVEY.md hard part #1).
    """
    cell_size: float = 100.0
    cell_capacity: int = 16


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    """Canonical 4-stage detection semantics
    (reference collision_detection.py:18-28, 229-389, 484-513)."""
    search_radius: float = 100.0          # stage-1 spatial filter radius (m)
    time_window: float = 10.0             # prediction window (s)
    time_step: float = 0.1                # stage-3 sampling step (s)
    safe_distance_base: float = 5.0       # SAFE_DISTANCE_DEFAULT
    max_warning_time: float = 10.0        # MAX_WARNING_TIME
    max_relative_speed: float = 50.0      # MAX_RELATIVE_SPEED
    min_relative_speed: float = 0.1       # stage-2 rel-speed floor
    weight_distance: float = 0.3
    weight_time: float = 0.3
    weight_speed: float = 0.2
    weight_angle: float = 0.1
    weight_type: float = 0.1
    same_type_factor: float = 0.5
    diff_type_factor: float = 0.8
    # 'precise' = sampled constant-acceleration sweep (reference stage 3,
    # collision_detection.py:296-342). 'fast' = closed-form constant-velocity
    # first-crossing (quadratic) — the speed-of-light path for benchmarks.
    mode: str = "precise"
    # Stage-3 sweep runs only on stage-2 survivors, compacted to this many
    # pairs per detection block (semantically identical: stage 3 is only
    # reachable through stage 2 in the reference, collision_detection.py:
    # 143-151; excess survivors beyond the cap are counted in overflow).
    # None (default) scales with the fleet: max(4096, 2*num_objects) —
    # measured survivor counts run ~1-1.5x num_objects at bench densities
    # (100k: aoflow 0 at 2N, r3), and the sweep+refine cost is linear in
    # this STATIC cap (~0.18 us/slot), so headroom is paid every step.
    # Overflow stays counted; Scene regrows on it.
    precise_survivor_cap: int | None = None
    # Stage-2 closest-approach sign convention. The reference computes
    # t* = -dot(rel_pos, rel_vel)/|rel_vel|^2 with rel_pos = other - vehicle
    # but rel_vel = vehicle - other (collision_detection.py:252-277), which
    # makes t* NEGATIVE for approaching pairs — head-on collisions are
    # filtered out and only already-overlapping separating pairs alert.
    # 'physical' (default) fixes the sign; 'reference' replicates the bug
    # bit-for-bit for parity testing. See DEVIATIONS.md #1.
    convention: str = "physical"
    # Stage-4 angle factor sin(|heading_i - heading_j|): 'product' (default)
    # uses the identity sin(|a-b|) = sign(a-b)*(sin a cos b - cos a sin b);
    # values differ from the literal form only by float rounding (~1e-7,
    # inside every parity tolerance — DEVIATIONS #18). 'direct' evaluates
    # the reference expression literally (collision_detection.py:364-365).
    angle_form: str = "product"

    @property
    def num_time_steps(self) -> int:
        # reference: `for t in range(int(time_window / time_step))` → 0..T-1
        return int(self.time_window / self.time_step)


@dataclasses.dataclass(frozen=True)
class AlertConfig:
    """Alert thresholds and priority rules (reference warning_system.py:18-27,
    287-311) plus fixed-size top-k extraction (XLA needs static shapes)."""
    risk_low: float = 0.3
    risk_medium: float = 0.6
    risk_high: float = 0.8
    ttc_critical: float = 3.0
    ttc_high: float = 5.0
    max_scene_alerts: int = 1024          # scene-level top-k returned per step
    alert_expiry_s: float = 30.0          # host AlertManager expiry
    resend_interval_s: float = 0.5        # unacked re-send interval


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Fleet physics matching the measured harness
    (optimized_performance_test.py:139-198)."""
    dt: float = 0.1
    accel_change_prob: float = 0.1
    accel_range: float = 1.0
    max_speed: float = 30.0
    min_heading_speed: float = 0.1
    speed_min: float = 5.0                # initial speed U(5, 20)
    speed_max: float = 20.0
    city_fraction: float = 0.8            # 80/20 city skew


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """Spatial sharding over a device mesh (replaces data_sharding.py +
    messaging.py — SURVEY.md §2.10/§2.11). The world splits along x into
    `num_shards` equal slabs, one per device. Cross-boundary visibility (the
    halo problem the reference left unsolved, compute_node.py:343-368) is
    handled by ppermute'ing a boundary band of width `halo_width` (must
    cover the detection search radius) to slab neighbors each step; objects
    crossing a slab boundary migrate the same way.

    halo_capacity / migrate_capacity are static buffer sizes (objects per
    step per direction); overflow drops the farthest objects and is counted
    in step stats. slot_headroom scales per-shard slot count above the even
    split so density skew (80/20 cities) doesn't overflow shard storage."""
    num_shards: int = 1
    axis_name: str = "shard"
    halo_width: float = 100.0
    halo_capacity: int = 256
    migrate_capacity: int = 64
    slot_headroom: float = 2.0
    # 2D tiling: num_shards_y > 1 splits the world along y as well, making
    # an (x, y) device grid (the octree-region analog of the reference's
    # SpatialPartitioner, spatial_index.py:716-769). Halo/migration run in
    # two phases (x then y); the y pass re-mirrors the x halo so corner
    # neighborhoods are covered. halo_width applies to both axes.
    num_shards_y: int = 1
    axis_name_y: str = "shard_y"
    # 3D tiling: num_shards_z > 1 additionally splits the world along z,
    # making an (x, y, z) device grid — useful for deep-z worlds (stacked
    # aviation layers) where z-skewed density needs z walls to balance.
    # Halo/migration gain a third phase (x, then
    # y, then z; each later pass re-mirrors the earlier-extended state so
    # edge/corner neighborhoods arrive in <= 3 hops). halo_width applies
    # to every sharded axis.
    num_shards_z: int = 1
    axis_name_z: str = "shard_z"

    @property
    def total_shards(self) -> int:
        return self.num_shards * self.num_shards_y * self.num_shards_z


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    num_objects: int = 1000
    world: WorldConfig = WorldConfig()
    grid: GridConfig = GridConfig()
    detect: DetectionConfig = DetectionConfig()
    alerts: AlertConfig = AlertConfig()
    sim: SimConfig = SimConfig()
    shard: ShardConfig = ShardConfig()

    # ---- static derived quantities (shape the compiled program) ----

    @property
    def grid_dims(self) -> Tuple[int, int, int]:
        ext = self.world.extent
        cs = self.grid.cell_size
        return tuple(max(1, int(math.ceil(e / cs)) if e > 0 else 1) for e in ext)

    @property
    def num_cells(self) -> int:
        nx, ny, nz = self.grid_dims
        return nx * ny * nz

    @property
    def survivor_cap(self) -> int:
        """Static stage-2 survivor compaction capacity (precise mode)."""
        c = self.detect.precise_survivor_cap
        return c if c is not None else max(4096, 2 * self.num_objects)

    @property
    def stencil_halfwidth(self) -> int:
        return max(1, int(math.ceil(self.detect.search_radius / self.grid.cell_size)))

    @property
    def stencil_size(self) -> int:
        w = 2 * self.stencil_halfwidth + 1
        return w * w * (w if self.world.is_3d else 1)

    @property
    def max_candidates(self) -> int:
        """Broad-phase candidate slots per object (static K)."""
        return self.stencil_size * self.grid.cell_capacity

    # ---- (de)serialization (config/flag system, SURVEY.md §5) ----

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "SystemConfig":
        d = json.loads(s)
        return cls(
            num_objects=d.get("num_objects", 1000),
            world=WorldConfig(**{**d.get("world", {}),
                                 **{k: tuple(v) for k, v in d.get("world", {}).items()
                                    if k in ("lo", "hi")}}),
            grid=GridConfig(**d.get("grid", {})),
            detect=DetectionConfig(**d.get("detect", {})),
            alerts=AlertConfig(**d.get("alerts", {})),
            sim=SimConfig(**d.get("sim", {})),
            shard=ShardConfig(**d.get("shard", {})),
        )

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


# Vehicle type table (reference optimized_performance_test.py:69-70,
# vehicle_simulator.py:323-324): car=2.0, truck=4.0, bus=5.0, motorcycle=1.0.
VEHICLE_TYPES = ("car", "truck", "bus", "motorcycle")
VEHICLE_SIZES = (2.0, 4.0, 5.0, 1.0)
