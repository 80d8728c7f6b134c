"""Hand-rolled property-based tests: randomized fleets and configs sweep
geometry edge cases the fixed-seed tests cannot — objects at world bounds,
coincident positions, dead slots, 2D and 3D worlds. Each property is
checked over several seeds (ROADMAP r2 #10)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import collide as tc
from collide.core.config import (WorldConfig, GridConfig,
                                 DetectionConfig, AlertConfig)
from collide.core.state import ObjectState
from collide.engine import make_detect, make_step
from chip_smoke import compare_pairs, oracle_pairs


def random_state(rng, n, world, threed, dead_frac=0.1):
    """Adversarial random fleet: clustered + boundary + coincident objects,
    a sprinkle of dead slots."""
    pos = rng.uniform(0, world, (n, 3)).astype(np.float32)
    # clusters: 30% of objects pile into 3 small patches
    for c in range(3):
        idx = rng.choice(n, n // 10, replace=False)
        center = rng.uniform(0, world, 3)
        pos[idx] = (center + rng.normal(0, 30, (len(idx), 3))).astype(
            np.float32)
    # boundary riders: exactly on the world edges
    edge = rng.choice(n, max(2, n // 20), replace=False)
    pos[edge, rng.integers(0, 2)] = rng.choice(
        [0.0, world], len(edge)).astype(np.float32)
    # coincident twins
    twin = rng.choice(n // 2, max(1, n // 50), replace=False)
    pos[twin + n // 2] = pos[twin]
    pos = np.clip(pos, 0, world)
    pos[:, 2] = np.clip(pos[:, 2], 0, 300.0) if threed else 0.0
    vel = rng.normal(0, 12, (n, 3)).astype(np.float32)
    acc = rng.normal(0, 0.8, (n, 3)).astype(np.float32)
    if not threed:
        vel[:, 2] = 0.0
        acc[:, 2] = 0.0
    alive = rng.uniform(size=n) > dead_frac
    return ObjectState(
        pos=jnp.asarray(pos), vel=jnp.asarray(vel), acc=jnp.asarray(acc),
        heading=jnp.asarray(rng.uniform(0, 2 * np.pi, n).astype(np.float32)),
        size=jnp.asarray(rng.choice([1.0, 2.0, 4.0, 5.0], n).astype(
            np.float32)),
        otype=jnp.asarray(rng.integers(0, 4, n).astype(np.int32)),
        alive=jnp.asarray(alive),
        oid=jnp.arange(n, dtype=jnp.int32))


def cfg_for(world, threed, mode="fast", alerts=512):
    return tc.SystemConfig(
        num_objects=400,
        world=WorldConfig(hi=(world, world, 300.0 if threed else 0.0)),
        grid=GridConfig(cell_size=100.0, cell_capacity=128),
        detect=DetectionConfig(mode=mode),
        alerts=AlertConfig(max_scene_alerts=alerts))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_invariants_random(seed):
    """Symmetry, bounds, and a brute-force stage-1 oracle on adversarial
    random fleets (2D and 3D alternating by seed)."""
    rng = np.random.default_rng(seed)
    threed = bool(seed % 2)
    cfg = cfg_for(1500.0, threed)
    st = random_state(rng, 400, 1500.0, threed)
    pairs = make_detect(cfg)(st)

    valid = np.asarray(pairs.valid)
    other = np.asarray(pairs.other)
    risk = np.asarray(pairs.risk)
    ttc = np.asarray(pairs.ttc)
    alive = np.asarray(st.alive)
    pos = np.asarray(st.pos)

    # bounds
    assert ((risk >= 0.0) & (risk <= 1.0)).all()
    assert (ttc[valid] >= 0.0).all()
    assert (ttc[valid] <= cfg.detect.time_window + 1e-5).all()

    pair_map = {}
    for i in range(400):
        for kk in np.nonzero(valid[i])[0]:
            j = int(other[i, kk])
            assert j != i, "self pair"
            assert alive[i] and alive[j], "dead pair"
            d = float(np.linalg.norm(pos[j] - pos[i]))
            assert d <= cfg.detect.search_radius + 1e-3
            pair_map[(i, j)] = (float(risk[i, kk]), float(ttc[i, kk]))
    # symmetry: each direction present with identical values (the stage
    # math is exactly symmetric under i<->j)
    for (i, j), v in pair_map.items():
        assert (j, i) in pair_map, f"asymmetric pair {(i, j)}"
        np.testing.assert_allclose(pair_map[(j, i)], v, rtol=1e-6)

    # brute-force stage-1 oracle
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    m = (alive[:, None] & alive[None, :]
         & (d2 <= np.float32(cfg.detect.search_radius) ** 2))
    np.fill_diagonal(m, False)
    assert int(pairs.num_checked) == int(m.sum())


def _pair_table(pairs):
    o, v, r, t, d = (np.asarray(x) for x in (
        pairs.other, pairs.valid, pairs.risk, pairs.ttc, pairs.distance))
    return {(int(i), int(o[i, s])): (float(r[i, s]), float(t[i, s]),
                                     float(d[i, s]))
            for i, s in zip(*np.nonzero(v))}


@pytest.mark.parametrize("mode", ["precise", "fast"])
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_xla_matches_oracle_random(seed, mode):
    """The XLA pipeline == the NumPy oracle of the literal reference stage
    math (tests/oracle.py) on adversarial random fleets, 2D and 3D: equal
    pair sets and values within tolerance, outside near-threshold pairs
    (chip_smoke.compare_pairs — the same check the GPU runs). The oracle
    samples constant-acceleration kinematics; fast mode is the
    constant-velocity closed form, so its fleets carry no acceleration."""
    rng = np.random.default_rng(seed)
    threed = bool(seed % 2)
    cfg = cfg_for(1500.0, threed, mode=mode)
    st = random_state(rng, 150, 1500.0, threed)
    if mode == "fast":
        st = st.replace(acc=jnp.zeros_like(st.acc))
    got = _pair_table(make_detect(cfg)(st))
    want = oracle_pairs(st, cfg)
    want = {k: v for k, v in want.items()
            if bool(st.alive[k[0]]) and bool(st.alive[k[1]])}
    assert want, "fleet too sparse to discriminate"
    compare_pairs(f"seed {seed} {mode}", got, want, jax.device_get(st), cfg)


@pytest.mark.parametrize("seed,chunk", [(8, 64), (9, 100), (10, 128),
                                        (11, 37)])
def test_chunked_step_matches_flat_random(seed, chunk):
    """The blocked large-N step (engine.step_chunked, chunk_size=) computes
    exactly what the flat step computes — counters, alert list and values
    — on adversarial random fleets, including chunks that do not divide
    N (the padded tail block is masked out)."""
    rng = np.random.default_rng(seed)
    threed = bool(seed % 2)
    cfg = cfg_for(1500.0, threed, mode="precise" if seed % 2 else "fast",
                  alerts=4096)
    st = random_state(rng, 400, 1500.0, threed)
    key = jax.random.key(seed)
    s1, o1 = make_step(cfg, donate=False)(st, key)
    s2, o2 = make_step(cfg, donate=False, chunk_size=chunk)(st, key)
    np.testing.assert_array_equal(np.asarray(s1.pos), np.asarray(s2.pos))
    for f in ("num_pairs_checked", "num_risks", "num_alive", "overflow",
              "alert_overflow"):
        assert int(getattr(o1, f)) == int(getattr(o2, f)), f
    assert float(o1.max_risk) == float(o2.max_risk)
    assert int(o1.alerts.count) < cfg.alerts.max_scene_alerts

    def alerts(o):
        a = jax.device_get(o.alerts)
        v = np.asarray(a.valid)
        return {(int(x), int(y)): (float(r), float(t), int(p))
                for x, y, r, t, p in zip(a.vehicle_oid[v], a.other_oid[v],
                                         a.risk[v], a.ttc[v], a.priority[v])}
    a1 = alerts(o1)
    assert a1 and a1 == alerts(o2)
