"""Behavioral tests for the HA/DR half of the runtime:
LeaderElection, ReplicationManager, StateTransferManager and
RecoveryCoordinator — multi-node over one in-process broker. These are
exactly the classes whose reference versions were never-ran vaporware
(high_availability.py:224-895, disaster_recovery.py:267-752), so each gets
at least one end-to-end behavior check here."""
import asyncio

import numpy as np
import pytest

from collide.runtime.messaging import (MessageBroker, Message,
                                       TOPIC_ELECTION,
                                       TOPIC_REPLICATION)
from collide.runtime.reliability import (LeaderElection,
                                         ReplicationManager,
                                         StateTransferManager,
                                         RecoveryCoordinator,
                                         HeartbeatMonitor,
                                         FailoverManager)


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


async def _wait_for(cond, timeout=8.0, interval=0.05):
    deadline = asyncio.get_running_loop().time() + timeout
    while asyncio.get_running_loop().time() < deadline:
        if cond():
            return True
        await asyncio.sleep(interval)
    return False


# ---- LeaderElection ----

def test_election_converges_to_single_leader_and_steps_down():
    async def go():
        broker = MessageBroker()
        await broker.start()
        ids = ["n0", "n1", "n2"]
        nodes = [LeaderElection(broker, nid, ids,
                                timeout_range=(0.15, 0.35)) for nid in ids]
        lost = []
        for n in nodes:
            n.on_lose_leadership(lambda n=n: lost.append(n.node_id))
        for n in nodes:
            await n.start()

        def one_leader():
            leaders = [n for n in nodes if n.is_current_leader()]
            return len(leaders) == 1 and all(
                m.leader_id == leaders[0].node_id for m in nodes)
        assert await _wait_for(one_leader), (
            f"no convergence: {[(n.node_id, n.role) for n in nodes]}")
        leader = next(n for n in nodes if n.is_current_leader())
        term0 = leader.term

        # a higher-term message forces step-down (reference :504-535)
        await broker.publish(Message(
            topic=TOPIC_ELECTION, key="ghost",
            value={"node_id": "ghost", "term": term0 + 10,
                   "type": "vote_request"}))
        assert await _wait_for(lambda: not leader.is_current_leader())
        assert leader.term == term0 + 10
        assert leader.node_id in lost

        # and the cluster elects a leader again afterwards
        assert await _wait_for(one_leader)
        for n in nodes:
            await n.stop()
        await broker.stop()
    run(go())


# ---- ReplicationManager ----

def test_replication_lww_and_leader_rebroadcast():
    async def go():
        broker = MessageBroker()
        await broker.start()
        a = ReplicationManager(broker, "A", rebroadcast_interval=0.1)
        b = ReplicationManager(broker, "B", rebroadcast_interval=0.1)
        a.is_leader_fn = lambda: True
        await a.start()
        await b.start()

        await a.store_data("k", {"v": 1})
        assert await _wait_for(lambda: b.get_data("k") == {"v": 1})

        # newer write wins everywhere
        await b.store_data("k", {"v": 2})
        assert await _wait_for(lambda: a.get_data("k") == {"v": 2})

        # stale write (old timestamp) must NOT regress the value
        await broker.publish(Message(
            topic=TOPIC_REPLICATION, key="k",
            value={"key": "k", "value": {"v": 0}, "ts": 1.0,
                   "from": "ghost"}))
        await asyncio.sleep(0.1)
        assert a.get_data("k") == {"v": 2}
        assert b.get_data("k") == {"v": 2}

        # a late joiner converges via the leader's rebroadcast loop
        c = ReplicationManager(broker, "C", rebroadcast_interval=0.1)
        await c.start()
        assert await _wait_for(lambda: c.get_data("k") == {"v": 2})

        for m in (a, b, c):
            await m.stop()
        await broker.stop()
    run(go())


# ---- StateTransferManager ----

def test_state_transfer_pull_and_apply():
    async def go():
        broker = MessageBroker()
        await broker.start()
        a = StateTransferManager(broker, "A")
        b = StateTransferManager(broker, "B")

        fleet_a = {"positions": [1, 2, 3], "step": 42}
        applied = {}
        a.register_provider("fleet", lambda: fleet_a,
                            lambda s: None)
        b.register_provider("fleet", lambda: {},
                            lambda s: applied.update(s))

        state = await b.request_state("fleet", from_node="A", timeout=5.0)
        assert state == fleet_a
        assert applied == fleet_a          # apply_state ran on the puller

        # pulling an unknown state times out instead of hanging forever
        with pytest.raises(asyncio.TimeoutError):
            await b.request_state("nope", from_node="A", timeout=0.3)
        await broker.stop()
    run(go())


# ---- RecoveryCoordinator end-to-end (failure -> failover -> restore) ----

def test_recovery_coordinator_end_to_end(tmp_path):
    """The full DR chain the reference aspired to (collision_system.py:
    297-322): heartbeat failure -> failover reassigns the fleet resource ->
    the new owner's recovery handler restores from a checkpoint."""
    import jax
    import collide as tc
    from collide.sim import generate_fleet
    from collide.ckpt.checkpoint import CheckpointManager

    cfg = tc.SystemConfig(num_objects=64)
    fleet = generate_fleet(jax.random.key(0), cfg)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(fleet, step=7)

    async def go():
        broker = MessageBroker()
        await broker.start()

        # node B owns the fleet; node A is the survivor that takes over
        restored = {}
        fo = FailoverManager(broker, "A")
        fo.assign("fleet:main", "B")
        fo.update_node_load("A", 0.1)

        rc_a = RecoveryCoordinator(broker, "A")
        rc_b = RecoveryCoordinator(broker, "B")

        def restore(payload):
            host, meta = ckpt.restore()
            restored["n"] = int(np.asarray(host.alive).sum())
            restored["step"] = meta["step"]
        rc_a.register_handler("restore_fleet", restore)

        hb = HeartbeatMonitor(broker, "A", interval=0.1, max_missed=3)
        failed = []

        async def on_fail(nid):
            failed.append(nid)
            moved = await fo.handle_node_failure(nid, ["A"])
            assert moved == {"fleet:main": "A"}
            await rc_a.initiate_recovery("restore_fleet",
                                         {"from": nid})
        hb.on_node_failure(on_fail)
        await hb.start()
        # B beats once, then goes silent
        await broker.publish(Message(
            topic="node-heartbeats", key="B",
            value={"node_id": "B", "ts": 0}))
        assert await _wait_for(lambda: "B" in failed, timeout=8.0)
        assert await _wait_for(lambda: restored.get("n") == 64)
        assert restored["step"] == 7
        # both coordinators observed the completed recovery status
        assert await _wait_for(lambda: any(
            s == RecoveryCoordinator.COMPLETED
            for s in rc_b.recoveries.values()))

        # a failing handler reports FAILED (not silence)
        def boom(payload):
            raise RuntimeError("disk on fire")
        rc_a.register_handler("bad", boom)
        rid = await rc_b.initiate_recovery("bad")
        assert await _wait_for(
            lambda: rc_b.recoveries.get(rid) ==
            RecoveryCoordinator.FAILED)

        await hb.stop()
        await broker.stop()
    run(go())
