"""Per-vehicle ingest for mesh-sharded fleets (ShardedScene.ingest/flush):
update-in-place, cross-slab ownership migration, free-slot insertion with
counted overflow, and end-to-end detection on ingested vehicles."""
import numpy as np
import jax
import pytest

import collide as tc
from collide.core.config import (ShardConfig, SimConfig, WorldConfig,
                                 AlertConfig)
from collide.core.types import LocationData, Position, Vector
from collide.api.sharded_scene import ShardedScene
from collide.shard import shard_slots


def make_scene(n=64, shards=8, headroom=2.0):
    cfg = tc.SystemConfig(
        num_objects=n,
        sim=SimConfig(accel_change_prob=0.0),
        alerts=AlertConfig(max_scene_alerts=128),
        shard=ShardConfig(num_shards=shards, slot_headroom=headroom))
    return ShardedScene(cfg, auto_rebalance=False)


def shard_of_slot(sc, slot):
    return slot // shard_slots(sc.cfg)


def owner_shard(sc, x):
    d = sc.cfg.shard.num_shards
    w = (sc.cfg.world.hi[0] - sc.cfg.world.lo[0]) / d
    return min(d - 1, int((x - sc.cfg.world.lo[0]) // w))


def host_map(sc):
    """oid -> (slot, x) of alive slots; asserts NO duplicate alive copies
    (the r2 padded-searchsorted bug duplicated objects on cross-shard
    updates and a plain dict hid it)."""
    host = sc.collect()
    alive = np.asarray(host.alive)
    out = {}
    for slot in np.flatnonzero(alive):
        oid = int(np.asarray(host.oid)[slot])
        assert oid not in out, f"duplicate alive copy of oid {oid}"
        out[oid] = (int(slot), float(np.asarray(host.pos)[slot, 0]))
    return out


def test_ingest_inserts_into_owner_shards():
    sc = make_scene()
    rng = np.random.default_rng(0)
    xs = rng.uniform(0, 10_000, 40)
    for i, x in enumerate(xs):
        sc.ingest(LocationData(f"v{i}", Position(x, 5000.0, 0.0),
                               Vector(5.0, 0, 0)))
    assert sc.flush() == 40
    m = host_map(sc)
    assert len(m) == 40
    for i, x in enumerate(xs):
        oid = sc._id_to_oid[f"v{i}"]
        slot, got_x = m[oid]
        assert abs(got_x - x) < 1e-3
        assert shard_of_slot(sc, slot) == owner_shard(sc, x)


def test_ingest_updates_in_place_and_migrates():
    sc = make_scene()
    sc.ingest(LocationData("car", Position(100.0, 100.0, 0.0),
                           Vector(1.0, 0, 0)))
    sc.flush()
    # same-slab update: position changes, still exactly one copy
    sc.ingest(LocationData("car", Position(200.0, 150.0, 0.0),
                           Vector(2.0, 0, 0)))
    sc.flush()
    m = host_map(sc)
    assert len(m) == 1
    oid = sc._id_to_oid["car"]
    assert abs(m[oid][1] - 200.0) < 1e-3
    assert shard_of_slot(sc, m[oid][0]) == 0
    # cross-slab update: ownership migrates, old copy killed
    sc.ingest(LocationData("car", Position(9_900.0, 150.0, 0.0),
                           Vector(2.0, 0, 0)))
    sc.flush()
    m = host_map(sc)
    assert len(m) == 1
    assert shard_of_slot(sc, m[oid][0]) == sc.cfg.shard.num_shards - 1


def test_ingest_overflow_is_counted():
    # 2 shards x tiny slots; cram everything into shard 0's slab
    sc = make_scene(n=16, shards=2, headroom=1.0)
    slots = shard_slots(sc.cfg)
    for i in range(16):
        sc.ingest(LocationData(f"v{i}", Position(10.0 + i, 100.0, 0.0),
                               Vector()))
    sc.flush()
    m = host_map(sc)
    assert len(m) == slots                  # shard 0 filled to capacity
    assert sc.dropped_total == 16 - slots   # the rest counted, not silent


def test_ingested_pair_alerts_end_to_end():
    sc = make_scene()
    # converging head-on pair far from any slab wall
    sc.ingest(LocationData("carA", Position(3100.0, 500.0, 0.0),
                           Vector(10.0, 0, 0)))
    sc.ingest(LocationData("carB", Position(3180.0, 500.0, 0.0),
                           Vector(-10.0, 0, 0), heading=np.pi))
    out = sc.step()
    assert int(out.num_risks) >= 2          # both directions
    alerts = sc.alerts()
    pair = {(a.vehicle_id, a.other_vehicle_id) for a in alerts}
    assert ("carA", "carB") in pair or ("carB", "carA") in pair
