"""Async checkpointing: the snapshot must capture the state
at save time bit-exactly even while stepping (donation) continues, overlap
the transfer with stepping, and surface background failures."""
import os

import numpy as np
import jax
import pytest

import collide as tc
from collide.core.config import ShardConfig, SimConfig
from collide.sim import generate_fleet
from collide.ckpt.checkpoint import CheckpointManager


def state_arrays(state):
    return {f: np.asarray(jax.device_get(getattr(state, f)))
            for f in ("pos", "vel", "acc", "heading", "size", "otype",
                      "alive", "oid")}


def test_scene_async_checkpoint_roundtrip(tmp_path):
    from collide.api import Scene

    cfg = tc.SystemConfig(num_objects=256)
    sc = Scene(cfg, checkpoint_dir=str(tmp_path))
    sc.adopt_fleet(generate_fleet(jax.random.key(0), cfg))
    sc.step(2)
    expected = state_arrays(sc.state)
    at_step = sc.step_count

    t = sc.save_checkpoint_async()
    # keep stepping immediately: donation reuses the live buffers while
    # the background thread drains the device-side snapshot copy
    sc.step(3)
    sc.ckpt.wait_async()
    assert not t.is_alive()
    assert sc.ckpt.stats["async_saves"] == 1

    sc.restore_checkpoint()
    assert sc.step_count == at_step
    got = state_arrays(sc.state)
    for f, v in expected.items():
        np.testing.assert_array_equal(got[f], v), f


def test_sharded_scene_async_checkpoint(tmp_path):
    from collide.api import ShardedScene

    cfg = tc.SystemConfig(
        num_objects=256, sim=SimConfig(),
        shard=ShardConfig(num_shards=8))
    sc = ShardedScene(cfg, fleet=generate_fleet(jax.random.key(1), cfg),
                      checkpoint_dir=str(tmp_path))
    sc.step(2)
    # expected content: alive objects by oid (restore redistributes slots)
    host = sc.collect()
    alive = np.asarray(host.alive)
    order = np.argsort(np.asarray(host.oid)[alive])
    expected_pos = np.asarray(host.pos)[alive][order]
    at_step = sc.step_count

    sc.save_checkpoint_async()
    sc.step(3)
    sc.ckpt.wait_async()

    sc.restore_checkpoint()
    assert sc.step_count == at_step
    host2 = sc.collect()
    alive2 = np.asarray(host2.alive)
    order2 = np.argsort(np.asarray(host2.oid)[alive2])
    np.testing.assert_array_equal(np.asarray(host2.pos)[alive2][order2],
                                  expected_pos)


def test_async_save_failure_surfaces(tmp_path):
    cfg = tc.SystemConfig(num_objects=64)
    state = generate_fleet(jax.random.key(0), cfg)
    ck = CheckpointManager(str(tmp_path))
    # break the directory AFTER construction: a plain file where the
    # checkpoint dir should go makes the background write fail
    ck.directory = str(tmp_path / "not_a_dir")
    with open(ck.directory, "w") as fh:
        fh.write("x")
    ck.save_async(state, 1)
    with pytest.raises(OSError):
        ck.wait_async()


def test_second_async_save_joins_first(tmp_path):
    cfg = tc.SystemConfig(num_objects=64)
    state = generate_fleet(jax.random.key(0), cfg)
    ck = CheckpointManager(str(tmp_path))
    ck.save_async(state, 1)
    ck.save_async(state, 2)        # joins the first before starting
    ck.wait_async()
    assert ck.list_checkpoints() == [1, 2]
    st, meta = ck.restore()
    assert meta["step"] == 2
