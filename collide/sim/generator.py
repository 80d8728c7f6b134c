"""Fleet generators: the reference's skewed traffic distributions, on device.

Matches `VehicleGenerator.initialize_vehicles`
(optimized_performance_test.py:80-136 / performance_test.py:72-107):
4 vehicle types with sizes {car 2, truck 4, bus 5, motorcycle 1}; 80% of
objects clustered in 5 cities (4 corner cities radius 1000 m at the quarter
points + 1 center city radius 2000 m), 20% uniform; initial speed U(5, 20)
at heading U(0, 2pi); zero initial acceleration.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from collide.core.config import SystemConfig, VEHICLE_SIZES
from collide.core.state import ObjectState


def default_cities(cfg: SystemConfig) -> jnp.ndarray:
    """[(x, y, radius)] — reference optimized_performance_test.py:74-79."""
    w = cfg.world.hi[0] - cfg.world.lo[0]
    h = cfg.world.hi[1] - cfg.world.lo[1]
    x0, y0 = cfg.world.lo[0], cfg.world.lo[1]
    return jnp.asarray([
        (x0 + w * 0.25, y0 + h * 0.25, 1000.0),
        (x0 + w * 0.75, y0 + h * 0.25, 1000.0),
        (x0 + w * 0.25, y0 + h * 0.75, 1000.0),
        (x0 + w * 0.75, y0 + h * 0.75, 1000.0),
        (x0 + w * 0.50, y0 + h * 0.50, 2000.0),
    ], jnp.float32)


def generate_fleet(key: jax.Array, cfg: SystemConfig,
                   cities: jnp.ndarray | None = None,
                   distribution: str = "city_skew") -> ObjectState:
    """distribution: 'city_skew' (reference default, 80/20) or 'uniform'."""
    n = cfg.num_objects
    sim = cfg.sim
    lo = jnp.asarray(cfg.world.lo, jnp.float32)
    hi = jnp.asarray(cfg.world.hi, jnp.float32)
    ks = jax.random.split(key, 8)

    # uniform positions
    upos = jax.random.uniform(ks[0], (n, 3), minval=lo, maxval=jnp.maximum(hi, lo + 1e-6))
    if not cfg.world.is_3d:
        upos = upos.at[:, 2].set(0.0)

    if distribution == "city_skew":
        if cities is None:
            cities = default_cities(cfg)
        c_idx = jax.random.randint(ks[1], (n,), 0, cities.shape[0])
        c = cities[c_idx]                                  # [N, 3] x,y,radius
        # r = U(0,1) * radius, theta = U(0, 2pi) — same (non-area-uniform)
        # disk sampling as the reference (:98-101)
        r = jax.random.uniform(ks[2], (n,)) * c[:, 2]
        theta = jax.random.uniform(ks[3], (n,)) * (2.0 * jnp.pi)
        cpos = jnp.stack([c[:, 0] + r * jnp.cos(theta),
                          c[:, 1] + r * jnp.sin(theta),
                          jnp.zeros(n)], axis=-1)
        in_city = jax.random.uniform(ks[4], (n, 1)) < sim.city_fraction
        pos = jnp.where(in_city, cpos, upos)
        pos = jnp.clip(pos, lo, hi)
    else:
        pos = upos

    speed = jax.random.uniform(ks[5], (n,), minval=sim.speed_min,
                               maxval=sim.speed_max)
    heading = jax.random.uniform(ks[6], (n,)) * (2.0 * jnp.pi)
    vel = jnp.stack([speed * jnp.cos(heading), speed * jnp.sin(heading),
                     jnp.zeros(n)], axis=-1)

    otype = jax.random.randint(ks[7], (n,), 0, len(VEHICLE_SIZES))
    size = jnp.asarray(VEHICLE_SIZES, jnp.float32)[otype]

    return ObjectState(
        pos=pos.astype(jnp.float32),
        vel=vel.astype(jnp.float32),
        acc=jnp.zeros((n, 3), jnp.float32),
        heading=heading.astype(jnp.float32),
        size=size,
        otype=otype.astype(jnp.int32),
        alive=jnp.ones((n,), bool),
        oid=jnp.arange(n, dtype=jnp.int32),
    )
