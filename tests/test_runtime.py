"""Host runtime layers: messaging, storage, scheduler, reliability,
checkpointing, alert lifecycle (the layers SURVEY.md §2.2/2.3/2.6/2.7
inventory)."""
import asyncio
import time

import numpy as np
import pytest

import collide as tc
from collide.core.types import LocationData, Position, Vector, Task, NodeInfo, LoadMetrics
from collide.core.utils import RateLimiter, CircuitBreaker, Timer
from collide.runtime.messaging import (MessageBroker, Message,
                                       MessageProducer, MessageConsumer,
                                       TOPIC_ALERTS)
from collide.runtime.storage import (InMemoryStorage,
                                     VehicleLocationStorage,
                                     CollisionRiskStorage,
                                     GridVehicleStorage)
from collide.runtime.scheduler import Scheduler, TaskWorker
from collide.runtime.reliability import (HeartbeatMonitor,
                                         ThrottlingManager,
                                         AdaptiveThrottling,
                                         FailoverManager)
from collide.ckpt.checkpoint import CheckpointManager, BackupManager
from collide.core.state import state_from_numpy


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


# ---- utils ----

def test_rate_limiter():
    rl = RateLimiter(rate=1000, capacity=5)
    assert sum(rl.allow() for _ in range(10)) == 5     # burst capped

def test_circuit_breaker_opens_and_recovers():
    cb = CircuitBreaker(failure_threshold=2, recovery_timeout=0.05)
    assert cb.allow()
    cb.record_failure(); cb.record_failure()
    assert not cb.allow()                              # OPEN
    time.sleep(0.06)
    assert cb.allow()                                  # HALF_OPEN probe
    cb.record_success()
    assert cb.allow() and cb.state == cb.CLOSED

def test_timer_elapsed_ms_is_property():
    with Timer() as t:
        time.sleep(0.01)
    assert 5 < t.elapsed_ms < 500                      # SURVEY.md §2.9 #17


# ---- messaging ----

def test_broker_pubsub_and_stats():
    async def go():
        broker = MessageBroker(max_queue_size=100)
        await broker.start()
        got = []
        async def cb(msg):
            got.append(msg.value)
        broker.subscribe("topic-a", cb)
        prod = MessageProducer(broker)
        for i in range(5):
            assert await prod.send("topic-a", {"i": i})
        await asyncio.sleep(0.05)
        await broker.stop()
        return got, broker.get_stats()
    got, stats = run(go())
    assert [g["i"] for g in got] == list(range(5))
    assert stats["published"] == 5 and stats["delivered"] == 5

def test_message_serialization_roundtrip():
    m = Message(topic="t", value={"a": 1}, key="k")
    m2 = Message.deserialize(m.serialize())
    assert m2.topic == "t" and m2.value == {"a": 1} and m2.id == m.id


# ---- storage ----

def test_storage_ttl_and_domain_stores():
    async def go():
        s = InMemoryStorage()
        await s.connect()
        await s.set("k", "v", ttl=0.02)
        assert await s.get("k") == "v"
        await asyncio.sleep(0.03)
        assert await s.get("k") is None                # expiry-on-read

        locs = VehicleLocationStorage(s)
        for i in range(15):
            await locs.store_location(LocationData(
                "veh", Position(float(i), 0, 0), Vector()))
        hist = await locs.get_location_history("veh")
        cur = await locs.get_location("veh")
        assert len(hist) == 10 and cur.position.x == 14.0   # last-10

        risks = CollisionRiskStorage(s)
        from collide.core.types import CollisionRisk
        r = CollisionRisk.new("a", "b", risk_level=0.7,
                              time_to_collision=2.0, distance=5.0)
        await risks.store_risk(r)
        assert (await risks.get_risk(r.id)).risk_level == 0.7
        assert len(await risks.get_vehicle_risks("b")) == 1

        grids = GridVehicleStorage(s)
        await grids.add_vehicle_to_grid("g1", "veh")
        assert await grids.get_grid_vehicles("g1") == ["veh"]
        assert await grids.get_vehicle_grid("veh") == "g1"
        await grids.remove_vehicle_from_grid("g1", "veh")
        assert await grids.get_grid_vehicles("g1") == []
    run(go())


# ---- scheduler ----

def test_scheduler_dispatch_and_worker_roundtrip():
    async def go():
        broker = MessageBroker()
        await broker.start()
        sched = Scheduler(broker)
        await sched.start()
        sched.register_node(NodeInfo(node_id="n1", grid_ids=["g7"]))
        sched.register_node(NodeInfo(
            node_id="n2", load=LoadMetrics(cpu_usage=0.9)))
        worker = TaskWorker(broker, "n1")
        results = []
        worker.register_handler("collision_detection",
                                lambda p: {"echo": p["x"]})
        t = Task(task_id="t1", task_type="collision_detection",
                 payload={"x": 42}, grid_id="g7")
        await sched.submit_task(t)
        await asyncio.sleep(0.3)
        stats = sched.get_stats()
        await sched.stop()
        await broker.stop()
        return stats, worker.stats
    stats, wstats = run(go())
    assert stats["dispatched"] == 1
    assert stats["completed"] == 1                     # grid-affine to n1
    assert wstats["handled"] == 1


# ---- reliability ----

def test_heartbeat_failure_detection():
    async def go():
        broker = MessageBroker()
        await broker.start()
        mon = HeartbeatMonitor(broker, "self", interval=0.05, max_missed=3)
        failed = []
        mon.on_node_failure(lambda nid: failed.append(nid))
        await mon.start()
        # other node beats twice then goes silent
        for _ in range(2):
            await broker.publish(Message(
                topic="node-heartbeats",
                value={"node_id": "other", "timestamp": time.time()}))
            await asyncio.sleep(0.05)
        await asyncio.sleep(0.4)
        await mon.stop()
        await broker.stop()
        return failed, mon.status.get("other")
    failed, status = run(go())
    assert failed == ["other"] and status == "failed"

def test_failover_reassigns_to_least_loaded():
    async def go():
        broker = MessageBroker()
        await broker.start()
        fm = FailoverManager(broker, "n1")
        fm.assign("shard:3", "n2")
        fm.update_node_load("n1", 0.9)
        fm.update_node_load("n3", 0.1)
        moved = await fm.handle_node_failure("n2", ["n1", "n3"])
        await broker.stop()
        return moved
    moved = run(go())
    assert moved == {"shard:3": "n3"}

def test_throttling_and_adaptive():
    tm = ThrottlingManager(global_rate=1e9)
    tm.set_endpoint_limit("/x", 1000.0)
    assert tm.allow_request("/x")
    ad = AdaptiveThrottling(tm, load_fn=lambda: 0.95)
    ad.adjust_once()
    assert tm.endpoint_limiters["/x"].rate == pytest.approx(800.0)
    ad.load_fn = lambda: 0.1
    ad.adjust_once()
    assert tm.endpoint_limiters["/x"].rate == pytest.approx(880.0)


# ---- checkpointing ----

def test_checkpoint_roundtrip_and_retention(tmp_path, rng):
    n = 32
    pos = rng.uniform(0, 100, (n, 3)).astype(np.float32)
    st = state_from_numpy(pos, np.zeros((n, 3)), np.zeros((n, 3)),
                          np.zeros(n), np.full(n, 2.0), np.zeros(n, np.int32))
    cm = CheckpointManager(str(tmp_path), keep_last=3)
    for step in range(5):
        cm.save(st, step)
    assert cm.list_checkpoints() == [2, 3, 4]          # keep-last retention
    restored, meta = cm.restore()
    assert meta["step"] == 4
    np.testing.assert_allclose(np.asarray(restored.pos), pos, atol=0)
    restored2, meta2 = cm.restore(step=2)
    assert meta2["step"] == 2

def test_backup_manager_roundtrip(tmp_path):
    bm = BackupManager(str(tmp_path), keep_last=2)
    box = {"v": 1}
    bm.register_source("box", lambda: box, lambda s: box.update(s))
    p1 = bm.create_backup()
    box["v"] = 99
    assert bm.restore_backup() == ["box"]
    assert box["v"] == 1
    for _ in range(3):
        bm.create_backup()
    assert len(bm.list_backups()) == 2


def test_broker_backfills_pre_start_subscriptions():
    """Subscriptions registered before start() must still get a dispatch
    loop (components subscribe in __init__; the system starts the broker
    later)."""
    async def go():
        broker = MessageBroker()
        got = []
        async def cb(msg):
            got.append(msg.value)
        broker.subscribe("early-topic", cb)      # before start()
        await broker.start()
        await broker.publish(Message(topic="early-topic", value={"x": 1}))
        await asyncio.sleep(0.05)
        await broker.stop()
        return got
    assert run(go()) == [{"x": 1}]


def test_collision_system_task_dispatch(tmp_path):
    """A task submitted through the system's scheduler reaches its own
    TaskWorker (the worker subscribes in __init__, pre-start — regression
    for the missing dispatch-loop backfill)."""
    from collide.system import CollisionSystem
    import collide as tc
    from collide.core.config import WorldConfig

    async def go():
        sys_ = CollisionSystem(
            tc.SystemConfig(num_objects=16,
                            world=WorldConfig(hi=(500.0, 500.0, 0.0))),
            node_id="task-node", checkpoint_dir=str(tmp_path),
            detection_hz=0.1)
        await sys_.start()
        await sys_.scheduler.submit_task(Task(
            task_id="t-ckpt", task_type="checkpoint", payload={}))
        for _ in range(200):
            if sys_.scheduler.get_stats()["completed"]:
                break
            await asyncio.sleep(0.1)
        stats = sys_.scheduler.get_stats()
        ckpts = sys_.scene.ckpt.list_checkpoints()
        await sys_.stop()
        return stats, ckpts
    stats, ckpts = run(go())
    assert stats["completed"] == 1
    assert len(ckpts) == 1          # the checkpoint task actually executed
