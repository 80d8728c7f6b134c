"""Object state as structure-of-arrays pytrees resident in device memory.

Replaces the reference's per-object Python objects (`Vehicle` dataclasses in
dict caches — compute_node.py:152-212, collision_detection.py:57-61,
optimized_performance_test.py) with fixed-shape arrays so the whole step is
one compiled XLA program.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.tree_util.register_dataclass,
         data_fields=["pos", "vel", "acc", "heading", "size", "otype",
                      "alive", "oid"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class ObjectState:
    """SoA fleet state. All arrays share leading dim N (static).

    pos/vel/acc: [N, 3] float32 (meters, m/s, m/s^2)
    heading:     [N] float32 radians (reference mixes degrees/radians —
                 models.py:50 vs vehicle_simulator.py:375; we standardize on
                 radians, matching the measured harness)
    size:        [N] float32 (vehicle characteristic size, m)
    otype:       [N] int32 index into config.VEHICLE_TYPES
    alive:       [N] bool (dead slots are excluded from indexing/detection)
    oid:         [N] int32 stable external object id
    """
    pos: jax.Array
    vel: jax.Array
    acc: jax.Array
    heading: jax.Array
    size: jax.Array
    otype: jax.Array
    alive: jax.Array
    oid: jax.Array

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    def replace(self, **kw) -> "ObjectState":
        return dataclasses.replace(self, **kw)


def empty_state(n: int) -> ObjectState:
    """All-dead fleet of capacity n. Each field gets its own buffer —
    aliased buffers break donation (f(donate(a), donate(a)))."""
    f3 = lambda: jnp.zeros((n, 3), jnp.float32)
    f1 = lambda: jnp.zeros((n,), jnp.float32)
    return ObjectState(
        pos=f3(), vel=f3(), acc=f3(), heading=f1(), size=f1(),
        otype=jnp.zeros((n,), jnp.int32),
        alive=jnp.zeros((n,), bool),
        oid=jnp.arange(n, dtype=jnp.int32),
    )


def state_from_numpy(pos, vel, acc, heading, size, otype, oid=None,
                     alive=None) -> ObjectState:
    n = pos.shape[0]
    return ObjectState(
        pos=jnp.asarray(pos, jnp.float32),
        vel=jnp.asarray(vel, jnp.float32),
        acc=jnp.asarray(acc, jnp.float32),
        heading=jnp.asarray(heading, jnp.float32),
        size=jnp.asarray(size, jnp.float32),
        otype=jnp.asarray(otype, jnp.int32),
        alive=(jnp.ones((n,), bool) if alive is None
               else jnp.asarray(alive, bool)),
        oid=(jnp.arange(n, dtype=jnp.int32) if oid is None
             else jnp.asarray(oid, jnp.int32)),
    )


def conform_fleet(state: ObjectState, cfg) -> ObjectState:
    """Clamp a fleet to the config's contracts at the HOST entry points
    (Scene/ShardedScene adopt/ingest): a world with zero z-extent treats
    z/vz/az as exactly 0 (such data lies outside the world anyway), so
    zero them."""
    if not cfg.world.is_3d:
        state = state.replace(
            pos=state.pos.at[:, 2].set(0.0),
            vel=state.vel.at[:, 2].set(0.0),
            acc=state.acc.at[:, 2].set(0.0))
    return state
