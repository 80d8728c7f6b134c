"""collide: a JAX real-time collision-detection framework.

A ground-up JAX/XLA rebuild of the capabilities of
jectpro7/realtime-collision-detection (see SURVEY.md): large-fleet simulation,
sort-based spatial indexing, 4-stage broad/narrow-phase collision detection
with TTC prediction and weighted risk scoring, prioritized alerts, spatial
sharding over device meshes with halo exchange, and checkpoint-based
reliability.
"""
from collide.core.config import (SystemConfig, WorldConfig, GridConfig,
                                 DetectionConfig, AlertConfig, SimConfig,
                                 ShardConfig, VEHICLE_TYPES, VEHICLE_SIZES)
from collide.core.state import ObjectState, empty_state, state_from_numpy
from collide.engine import step, make_step, make_detect, StepOutput

__version__ = "0.1.0"
