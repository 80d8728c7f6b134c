"""BrokerBridge: the multi-host control plane over real TCP sockets
(runtime/bridge.py, ROADMAP r2 #7). Two in-process brokers stand in for two
hosts; the links are genuine loopback TCP streams, so framing, relaying and
loop protection are exercised for real."""
import asyncio

import pytest

from collide.runtime.messaging import (MessageBroker, Message,
                                       TOPIC_ALERTS, TOPIC_HEARTBEATS)
from collide.runtime.bridge import BrokerBridge, ORIGIN_HEADER
from collide.runtime.reliability import HeartbeatMonitor, LeaderElection


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


async def _wait_for(cond, timeout=10.0, interval=0.05):
    deadline = asyncio.get_running_loop().time() + timeout
    while asyncio.get_running_loop().time() < deadline:
        if cond():
            return True
        await asyncio.sleep(interval)
    return False


async def _pair():
    """Two brokers bridged over loopback TCP: a listens, b dials."""
    ba, bb = MessageBroker(), MessageBroker()
    await ba.start()
    await bb.start()
    bra = BrokerBridge(ba, "host-a", listen=("127.0.0.1", 0))
    await bra.start()
    brb = BrokerBridge(bb, "host-b",
                       peers=[("127.0.0.1", bra.bound_port)])
    await brb.start()
    return ba, bb, bra, brb


async def _teardown(ba, bb, bra, brb):
    await brb.stop()
    await bra.stop()
    await bb.stop()
    await ba.stop()


def test_bridge_relays_and_does_not_echo():
    async def go():
        ba, bb, bra, brb = await _pair()
        got_a, got_b = [], []

        async def on_a(m):
            got_a.append(m)

        async def on_b(m):
            got_b.append(m)

        ba.subscribe(TOPIC_ALERTS, on_a)
        bb.subscribe(TOPIC_ALERTS, on_b)
        await asyncio.sleep(0.2)          # let the dial land

        await ba.publish(Message(topic=TOPIC_ALERTS, value={"n": 1}))
        assert await _wait_for(lambda: len(got_b) >= 1)
        assert got_b[0].value == {"n": 1}
        assert got_b[0].headers[ORIGIN_HEADER] == "host-a"

        await bb.publish(Message(topic=TOPIC_ALERTS, value={"n": 2}))
        assert await _wait_for(
            lambda: any(m.value == {"n": 2} for m in got_a))
        # no echo storm: each side saw exactly its own + one remote
        await asyncio.sleep(0.3)
        assert len(got_a) == 2 and len(got_b) == 2
        assert bra.get_stats()["received"] == 1
        assert brb.get_stats()["received"] == 1
        await _teardown(ba, bb, bra, brb)

    run(go())


def test_heartbeats_cross_the_bridge():
    """A HeartbeatMonitor on host A observes host B's beats through the
    TCP link — the reference's failure-detection story actually running
    across transports (high_availability.py:17-221)."""
    async def go():
        ba, bb, bra, brb = await _pair()
        ha = HeartbeatMonitor(ba, "node-a", interval=0.1, max_missed=3)
        hb = HeartbeatMonitor(bb, "node-b", interval=0.1, max_missed=3)
        await ha.start()
        await hb.start()
        assert await _wait_for(lambda: "node-b" in ha.nodes)
        assert await _wait_for(lambda: "node-a" in hb.nodes)
        # kill B; A must detect the failure over the dead link silence
        await hb.stop()
        assert await _wait_for(
            lambda: ha.status.get("node-b") == HeartbeatMonitor.FAILED,
            timeout=5.0)
        await ha.stop()
        await _teardown(ba, bb, bra, brb)

    run(go())


def test_election_converges_across_bridge():
    """Leader election over two bridged brokers converges to exactly one
    leader — the Raft-lite control plane on a real transport."""
    async def go():
        ba, bb, bra, brb = await _pair()
        ids = ["na", "nb"]
        ea = LeaderElection(ba, "na", ids, timeout_range=(0.2, 0.4))
        eb = LeaderElection(bb, "nb", ids, timeout_range=(0.2, 0.4))
        await ea.start()
        await eb.start()
        assert await _wait_for(
            lambda: sum(e.is_current_leader() for e in (ea, eb)) == 1
            and all(e.leader_id is not None for e in (ea, eb)))
        assert ea.leader_id == eb.leader_id
        await ea.stop()
        await eb.stop()
        await _teardown(ba, bb, bra, brb)

    run(go())


def test_hub_relays_between_spokes():
    """Star topology: two leaves dial a relay hub; a leaf's message reaches
    the other leaf through the hub exactly once."""
    async def go():
        hub_b = MessageBroker()
        await hub_b.start()
        hub = BrokerBridge(hub_b, "hub", listen=("127.0.0.1", 0),
                           relay=True)
        await hub.start()
        leaves = []
        for name in ("l1", "l2"):
            br = MessageBroker()
            await br.start()
            bridge = BrokerBridge(br, name,
                                  peers=[("127.0.0.1", hub.bound_port)])
            await bridge.start()
            leaves.append((br, bridge))
        got = []

        async def on_msg(m):
            got.append(m)

        leaves[1][0].subscribe(TOPIC_ALERTS, on_msg)
        await asyncio.sleep(0.3)
        await leaves[0][0].publish(Message(topic=TOPIC_ALERTS,
                                           value={"x": 9}))
        assert await _wait_for(lambda: len(got) == 1)
        assert got[0].value == {"x": 9}
        await asyncio.sleep(0.3)
        assert len(got) == 1              # exactly once, no relay loop
        for br, bridge in leaves:
            await bridge.stop()
            await br.stop()
        await hub.stop()
        await hub_b.stop()

    run(go())


def test_two_collision_systems_bridged():
    """Two full CollisionSystem nodes (tiny fleets) joined only by the TCP
    bridge: each node's HeartbeatMonitor must see the other, and election
    must agree on one leader — the reference's multi-node deployment story
    (collision_system.py:224-310) on a real transport."""
    from collide.system import CollisionSystem
    import collide as tc
    from collide.core.config import WorldConfig

    async def go():
        cfg = tc.SystemConfig(num_objects=8,
                              world=WorldConfig(hi=(500.0, 500.0, 0.0)))
        a = CollisionSystem(cfg, node_id="ha", detection_hz=0.1,
                            known_nodes=["ha", "hb"],
                            bridge_listen=("127.0.0.1", 0))
        await a.start()
        b = CollisionSystem(cfg, node_id="hb", detection_hz=0.1,
                            known_nodes=["ha", "hb"],
                            bridge_peers=[("127.0.0.1",
                                           a.bridge.bound_port)])
        await b.start()
        ok_hb = await _wait_for(
            lambda: "hb" in a.heartbeat.nodes and "ha" in b.heartbeat.nodes)
        ok_ldr = await _wait_for(
            lambda: a.election.leader_id is not None
            and a.election.leader_id == b.election.leader_id)
        sa, sb = a.get_stats(), b.get_stats()
        await b.stop()
        await a.stop()
        return ok_hb, ok_ldr, sa, sb

    ok_hb, ok_ldr, sa, sb = run(go())
    assert ok_hb, "heartbeats did not cross the bridge"
    assert ok_ldr, "election did not converge across the bridge"
    assert sa["bridge"]["links"] == 1 and sb["bridge"]["links"] == 1
