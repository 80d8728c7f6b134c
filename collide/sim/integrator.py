"""Fleet physics integrator — jitted, vectorized.

Semantics match the measured harness's update loop
(optimized_performance_test.py:139-198): Euler position update, elastic
bounce at world borders, 10%-probability random acceleration redraw in
U(-1, 1) per axis, velocity += accel*dt, 30 m/s horizontal speed cap, and
heading = atan2(vy, vx) when moving. Randomness is counter-based
(jax.random), so steps are reproducible — unlike the reference's global
`random` module.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from collide.core.config import SystemConfig
from collide.core.state import ObjectState


def integrate(state: ObjectState, key: jax.Array,
              cfg: SystemConfig) -> ObjectState:
    sim = cfg.sim
    dt = sim.dt
    lo = jnp.asarray(cfg.world.lo, jnp.float32)
    hi = jnp.asarray(cfg.world.hi, jnp.float32)
    is3d = cfg.world.is_3d

    # position update (harness order: move first, then bounce, then accel)
    pos = state.pos + state.vel * dt

    # elastic bounce per axis; z only participates in 3D worlds
    below, above = pos < lo, pos > hi
    bounce = below | above
    if not is3d:
        bounce = bounce.at[:, 2].set(False)
    pos = jnp.where(below, lo, jnp.where(above, hi, pos))
    vel = jnp.where(bounce, -state.vel, state.vel)

    # random acceleration redraw with prob accel_change_prob
    k1, k2 = jax.random.split(key)
    redraw = jax.random.uniform(k1, (state.n, 1)) < sim.accel_change_prob
    new_acc = jax.random.uniform(k2, (state.n, 3), minval=-sim.accel_range,
                                 maxval=sim.accel_range)
    if not is3d:
        new_acc = new_acc.at[:, 2].set(0.0)
    acc = jnp.where(redraw, new_acc, state.acc)

    # velocity update + speed cap (harness caps horizontal speed only)
    vel = vel + acc * dt
    h_speed = jnp.linalg.norm(vel[:, :2], axis=-1, keepdims=True)
    scale = jnp.where(h_speed > sim.max_speed, sim.max_speed / h_speed, 1.0)
    vel = vel * jnp.concatenate(
        [scale, scale, jnp.ones_like(scale)], axis=-1)

    # heading tracks velocity when moving
    moving = h_speed[:, 0] > sim.min_heading_speed
    heading = jnp.where(moving, jnp.arctan2(vel[:, 1], vel[:, 0]),
                        state.heading)

    # dead slots stay frozen
    alive3 = state.alive[:, None]
    return state.replace(
        pos=jnp.where(alive3, pos, state.pos),
        vel=jnp.where(alive3, vel, state.vel),
        acc=jnp.where(alive3, acc, state.acc),
        heading=jnp.where(state.alive, heading, state.heading),
    )
