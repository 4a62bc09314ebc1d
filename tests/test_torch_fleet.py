"""The port's fleet serving lane (``fleet/``) against the JAX package's, on the
CPU.

Where the reference is deterministic the comparison is exact: one scripted
join/sync/ack/leave/tick/``fence_lost`` sequence under an injected clock
gives equal leases, ``assignments()``, ``export_state()`` and tick views in
both packages; a bus directory written by either package reads back equal
in the other; the manual-assignment consumer and the seeded worker-death
plan behave call for call alike; and a 2-worker fleet drain of both
packages over the same weights classifies the same keys with byte-equal
output values (compared as a map from key to value, since workers
interleave). The rest mirrors ``tests/test_fleet.py`` on the port: the bus,
the coordinator's barrier, expiry and fence cases, exact key accounting
across seeded worker deaths (graceful and crash) with per-partition order
kept, global-watermark shedding, the health file and a graceful stop (the
serve CLI's ``--fleet`` is in ``tests/test_torch_serve_cli.py``). Drains run
real threads, so they assert only what
a loaded run still guarantees (exact accounting, a death happened); every
join is bounded. ``tests/test_fleet.py``'s mesh cases are mirrored in
``tests/test_torch_mesh.py``.
"""

import dataclasses
import gc
import json
import random
import threading

import pytest

from fraud_detection_tpu import fleet as jfleet
from fraud_detection_tpu.models.pipeline import synthetic_demo_pipeline
from fraud_detection_tpu.sched import AdaptiveScheduler as JScheduler
from fraud_detection_tpu.sched import SchedulerConfig as JSchedulerConfig
from fraud_detection_tpu.stream import InProcessBroker as JBroker
from fraud_detection_tpu.stream import faults as jfaults
from fraud_detection_tpu_torch import fleet as tfleet
from fraud_detection_tpu_torch.fleet import (Fleet, FleetBus,
                                             FleetCoordinator)
from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
from fraud_detection_tpu_torch.sched import (AdaptiveScheduler,
                                             SchedulerConfig)
from fraud_detection_tpu_torch.stream import InProcessBroker
from fraud_detection_tpu_torch.stream import faults as tfaults
from fraud_detection_tpu_torch.stream.broker import CommitFailedError
from tests.torch_parity import port_featurizer, port_model, warmed

pytestmark = pytest.mark.fleet

N_MSGS = 900


@pytest.fixture(scope="module", autouse=True)
def _frozen_heap():
    """Drains run with lease_ttl 1.0 s. A gen-2 collection over the heap a
    long-lived test worker has piled up stops every thread of the process
    at once (0.7-1.8 s measured in the suite's 6-worker run); landing in a
    drain, it lets the coordinator expire live workers' leases, and their
    batches replay at least once, which breaks exact accounting.
    ``gc.freeze()`` moves that heap out of the collector's reach for this
    module, so a collection during a drain scans only what the drain
    allocates."""
    gc.freeze()
    yield
    gc.unfreeze()


@pytest.fixture(scope="module")
def jpipe():
    return synthetic_demo_pipeline(batch_size=64, n=300, seed=3,
                                   num_features=1024,
                                   corpus_kwargs=dict(hard_fraction=0.0,
                                                      label_noise=0.0))


@pytest.fixture(scope="module")
def pipe(jpipe):
    return warmed(ServingPipeline(port_featurizer(jpipe.featurizer),
                                  port_model(jpipe.model), batch_size=64,
                                  device="cpu"))


def feed(broker, n, topic="in"):
    producer = broker.producer()
    for i in range(n):
        producer.produce(topic,
                         json.dumps({"text": f"hello dialogue {i}",
                                     "id": i}).encode(),
                         key=str(i).encode())


def drain(broker, pipeline, n_workers, *, fleet_cls=Fleet, death_plan=None,
          sched_config=None, dlq_topic=None, batch_size=64, lease_ttl=1.0,
          idle=0.3):
    fleet = fleet_cls.in_process(
        broker, pipeline, "in", "out", n_workers, batch_size=batch_size,
        death_plan=death_plan, sched_config=sched_config,
        dlq_topic=dlq_topic, lease_ttl=lease_ttl,
        heartbeat_interval=0.02, tick_interval=0.02)
    result = fleet.run(idle_timeout=idle, join_timeout=90.0)
    return fleet, result


def out_keys(broker, topics=("out",)):
    keys = []
    for t in topics:
        keys += [m.key for m in broker.messages(t)]
    return keys


def _expect(n=N_MSGS):
    return sorted(str(i).encode() for i in range(n))


def _lease(lease):
    return (lease.worker_id, lease.generation, tuple(lease.partitions),
            tuple(lease.pending), lease.released)


# ---------------------------------------------------------------------------
# bus
# ---------------------------------------------------------------------------

def test_bus_inprocess_publish_read_retract():
    bus = FleetBus()
    bus.publish("w0", {"backlog": 3})
    bus.publish("w1", {"backlog": 5})
    snaps = bus.snapshots()
    assert set(snaps) == {"w0", "w1"}
    assert snaps["w0"]["health"]["backlog"] == 3
    bus.retract("w0")
    assert set(bus.snapshots()) == {"w1"}
    assert bus.fleet_view() is None
    bus.publish_fleet({"global_backlog": 8})
    assert bus.fleet_view()["global_backlog"] == 8


def test_bus_file_backed_crosses_instances(tmp_path):
    a = FleetBus(dir=str(tmp_path))
    b = FleetBus(dir=str(tmp_path))
    a.publish("w0", {"backlog": 7})
    assert b.snapshots()["w0"]["health"]["backlog"] == 7
    a.publish_fleet({"global_backlog": 7, "workers": ["w0"]})
    assert b.fleet_view()["global_backlog"] == 7
    (tmp_path / "worker-bad.json").write_text("{torn")
    assert "bad" not in b.snapshots()
    a.retract("w0")
    assert "w0" not in b.snapshots()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bus_directory_reads_back_equal_across_packages(tmp_path, writer):
    """A bus directory written by either package reads back equal in the
    other: same file names, same JSON."""
    wall = lambda: 123.5  # noqa: E731
    mods = {"port": tfleet, "jax": jfleet}
    src = mods[writer].FleetBus(dir=str(tmp_path), clock=wall)
    src.publish("w0", {"backlog": 7, "engine": {"processed": 3}})
    src.publish("w1", {"backlog": 2, "alerts": {"firing": ["x"]}})
    src.publish_fleet({"generation": 4, "workers": ["w0", "w1"],
                       "global_backlog": 9})
    src.retract("w1")
    other = "jax" if writer == "port" else "port"
    readers = [mods[k].FleetBus(dir=str(tmp_path)) for k in (writer, other)]
    snaps = [r.snapshots() for r in readers]
    views = [r.fleet_view() for r in readers]
    assert snaps[0] == snaps[1] and set(snaps[0]) == {"w0"}
    assert snaps[0]["w0"]["time"] == 123.5
    assert views[0] == views[1] and views[0]["generation"] == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["fleet.json", "worker-w0.json"]


# ---------------------------------------------------------------------------
# coordinator: the port's own cases
# ---------------------------------------------------------------------------

def test_coordinator_sticky_join_leave():
    c = FleetCoordinator(["in"], 4, lease_ttl=30.0)
    l0 = c.join("w0")
    assert set(l0.partitions) == {("in", p) for p in range(4)}
    l1 = c.join("w1")
    l0b = c.sync("w0")
    assert set(l0b.partitions) | set(l1.partitions) | set(l1.pending) == \
        {("in", p) for p in range(4)}
    assert set(l0b.partitions).isdisjoint(set(l1.partitions))
    assert len(l0b.partitions) == 2 and l1.pending
    c.ack("w0")
    l1b = c.sync("w1")
    assert not l1b.pending and len(l1b.partitions) == 2
    assert set(l0b.partitions) <= set(l0.partitions)
    c.leave("w1")
    l0c = c.sync("w0")
    assert set(l0c.partitions) == {("in", p) for p in range(4)}
    assert not l0c.pending


def test_coordinator_lease_expiry_and_zombie_fence():
    clock = [0.0]
    c = FleetCoordinator(["in"], 2, lease_ttl=1.0, clock=lambda: clock[0])
    c.join("w0")
    c.join("w1")
    c.ack("w0")
    assert len(c.sync("w0").partitions) == 1
    clock[0] = 2.0
    l0 = c.sync("w0")
    assert set(l0.partitions) == {("in", 0), ("in", 1)}
    assert c.expirations == 1
    assert c.fence_lost("w1", [("in", 1)]) == [("in", 1)]
    assert c.fence_lost("w0", [("in", 0), ("in", 1)]) == []


def test_coordinator_barrier_survives_consecutive_rebalances():
    c = FleetCoordinator(["in"], 3, lease_ttl=30.0)
    c.join("w0")
    l1 = c.join("w1")
    assert l1.pending
    held = set(l1.pending)
    c.join("w2")
    l1b, l2b = c.sync("w1"), c.sync("w2")
    assert not (held & (set(l1b.partitions) | set(l2b.partitions)))
    for pair in held:
        assert c._pending.get(pair) == "w0"
    c.ack("w0")
    l1c, l2c = c.sync("w1"), c.sync("w2")
    assert not l1c.pending and not l2c.pending
    assert held <= (set(l1c.partitions) | set(l2c.partitions)
                    | set(c.sync("w0").partitions))


def test_coordinator_no_phantom_hold_for_unissued_pair():
    clock = [0.0]
    c = FleetCoordinator(["in"], 2, lease_ttl=1.0, clock=lambda: clock[0])
    c.join("w0")
    c.join("w1")
    c.ack("w0")
    c.sync("w1")
    clock[0] = 0.6
    c.sync("w0")
    clock[0] = 1.3
    c.tick()
    assert c.expirations == 1
    assert not c._pending
    l2 = c.join("w2")
    assert ("in", 1) in l2.partitions
    assert not l2.pending and not c._pending


def test_coordinator_fence_blocks_withheld_target():
    c = FleetCoordinator(["in"], 2, lease_ttl=30.0)
    c.join("w0")
    c.join("w1")
    held = [p for p, h in c._pending.items() if h == "w0"]
    assert len(held) == 1
    pair = held[0]
    assert c.fence_lost("w0", [pair]) == []
    assert c.fence_lost("w1", [pair]) == [pair]
    c.ack("w0")
    assert c.fence_lost("w1", [pair]) == []
    assert c.fence_lost("w0", [pair]) == [pair]


def test_coordinator_tick_aggregates_global_backlog():
    bus = FleetBus()
    c = FleetCoordinator(["in"], 4, bus=bus, lease_ttl=30.0)
    c.join("w0")
    c.join("w1")
    bus.publish("w0", {"backlog": 30, "engine": {"shed": 2, "processed": 10}})
    bus.publish("w1", {"backlog": 10, "engine": {"shed": 1, "processed": 5}})
    bus.publish("ghost", {"backlog": 999})
    view = c.tick()
    assert view["global_backlog"] == 40
    assert view["backlog_per_worker"] == 20.0
    assert view["peak_global_backlog"] == 40
    assert view["shed_total"] == 3 and view["processed_total"] == 15
    assert bus.fleet_view()["global_backlog"] == 40


# ---------------------------------------------------------------------------
# coordinator: the same script in both packages
# ---------------------------------------------------------------------------

def _script(seed, steps=120):
    """A seeded sequence of coordinator calls over five workers, with clock
    steps that let leases expire."""
    rng = random.Random(seed)
    ops = []
    for _ in range(steps):
        w = f"w{rng.randrange(5)}"
        kind = rng.choices(["join", "sync", "ack", "leave", "tick", "fence",
                            "release", "advance"],
                           [3, 5, 3, 1, 2, 2, 1, 2])[0]
        arg = None
        if kind == "fence":
            arg = [("in", p) for p in range(4) if rng.random() < 0.5]
        elif kind == "advance":
            arg = rng.choice([0.1, 0.4, 0.9, 1.6])
        ops.append((kind, w, arg))
    return ops


def _play(mod, ops):
    clock = [0.0]
    bus = mod.FleetBus(clock=lambda: clock[0])
    c = mod.FleetCoordinator(["in"], 4, bus=bus, lease_ttl=1.0,
                             lag_fn=lambda: 17, clock=lambda: clock[0],
                             wall=lambda: 1000.0 + clock[0])
    trail = []
    for kind, w, arg in ops:
        if kind in ("join", "sync", "ack"):
            trail.append((kind, w, _lease(getattr(c, kind)(w))))
            bus.publish(w, {"backlog": len(w) + int(clock[0] * 10),
                            "engine": {"processed": 1, "shed": 0}})
        elif kind == "leave":
            c.leave(w)
            trail.append((kind, w))
        elif kind == "tick":
            trail.append((kind, json.loads(json.dumps(c.tick()))))
        elif kind == "fence":
            trail.append((kind, w, c.fence_lost(w, arg)))
        elif kind == "release":
            trail.append((kind, w, c.request_release(w)))
        else:
            clock[0] = round(clock[0] + arg, 6)
        trail.append(("state", c.assignments(), c.export_state(),
                      c.rebalances, c.expirations, c.committed_lag()))
    return trail


@pytest.mark.parametrize("seed", range(6))
def test_coordinator_script_equals_jax(seed):
    ops = _script(seed)
    port, ref = _play(tfleet, ops), _play(jfleet, ops)
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a == b, f"step {i}: {ops[min(i // 2, len(ops) - 1)]}"


def test_coordinator_restore_state_equals_jax():
    """A successor restoring the same exported snapshot deals the same
    leases in both packages."""
    ops = _script(3)
    states = []
    for mod in (tfleet, jfleet):
        c = mod.FleetCoordinator(["in"], 4, lease_ttl=1.0,
                                 clock=lambda: 0.0)
        for kind, w, _ in ops[:40]:
            if kind in ("join", "sync", "ack"):
                getattr(c, kind)(w)
        states.append(c.export_state())
    assert states[0] == states[1]
    leases = []
    for mod in (tfleet, jfleet):
        c = mod.FleetCoordinator(["in"], 4, lease_ttl=1.0,
                                 clock=lambda: 5.0)
        c.restore_state(json.loads(json.dumps(states[0])))
        leases.append([_lease(c.sync(w)) for w in ("w0", "w1", "w2", "w3")])
    assert leases[0] == leases[1]


# ---------------------------------------------------------------------------
# assigned consumer, death plan, scheduler watermark
# ---------------------------------------------------------------------------

def test_assigned_consumer_resume_and_fence():
    broker = InProcessBroker(num_partitions=2)
    feed(broker, 20)
    c1 = broker.assigned_consumer([("in", 0), ("in", 1)], "g")
    msgs = c1.poll_batch(8, 0.2)
    assert msgs
    offsets = {}
    for m in msgs:
        offsets[(m.topic, m.partition)] = max(
            offsets.get((m.topic, m.partition), 0), m.offset + 1)
    c1.commit_offsets(offsets)
    c1.close()
    c2 = broker.assigned_consumer([("in", 0), ("in", 1)], "g")
    seen = {(m.partition, m.offset) for m in c2.poll_batch(100, 0.2)}
    for (t, p), off in offsets.items():
        assert (p, off - 1) not in seen
        assert all(o >= off for q, o in seen if q == p)
    c3 = broker.assigned_consumer([("in", 0)], "g",
                                  fence=lambda pairs: list(pairs))
    c3.poll_batch(4, 0.2)
    with pytest.raises(CommitFailedError):
        c3.commit_offsets({("in", 0): 99})
    c4 = broker.assigned_consumer([("in", 0)], "g2")
    assert c4.backlog() == sum(1 for m in broker.messages("in")
                               if m.partition == 0)
    with pytest.raises(RuntimeError, match="closed"):
        c1.poll(0.0)


def test_assigned_consumer_and_group_lag_equal_jax():
    """The same calls on both brokers poll the same (partition, offset)
    sequence, commit the same offsets and report the same lag."""
    trails = []
    for broker_cls in (InProcessBroker, JBroker):
        broker = broker_cls(num_partitions=3)
        feed(broker, 60)
        trail = [broker.group_lag("g", ["in"])]
        c = broker.assigned_consumer([("in", 0), ("in", 2)], "g")
        for size in (5, 1, 9, 40):
            got = c.poll_batch(size, 0.05)
            trail.append([(m.partition, m.offset, m.key) for m in got])
            c.commit()
            trail.append((c.committed_offsets(), c.backlog(),
                          broker.group_lag("g", ["in"]),
                          broker.group_lag("g")))
        c.close()
        d = broker.assigned_consumer([("in", 1)], "g",
                                     fence=lambda pairs: [])
        trail.append([(m.partition, m.offset) for m in d.poll_batch(7, 0.05)])
        d.commit_offsets({("in", 1): 3})
        trail.append((sorted(broker._group_offsets.items()),
                      broker.group_lag("g", ["in"])))
        trails.append(trail)
    assert trails[0] == trails[1]


@pytest.mark.parametrize("seed", [5, 9, 42])
def test_worker_death_plan_equals_jax(seed):
    def schedule(faults):
        plan = faults.WorkerDeathPlan(seed=seed, kills=2, min_polls=1,
                                      max_polls=5)
        for w in ("w0", "w1", "w2"):
            plan.arm(w)
        fired = []
        for _ in range(10):
            for w in ("w0", "w1", "w2"):
                try:
                    plan.tick(w)
                except (tfaults.WorkerKilled, jfaults.WorkerKilled) as e:
                    fired.append((e.worker_id, e.mode))
        return fired, plan.report()

    port, ref = schedule(tfaults), schedule(jfaults)
    assert port == ref and len(port[0]) == 2


def test_scheduler_fleet_backlog_raises_local_signal():
    class QuietConsumer:
        def backlog(self):
            return 2

    sources = [lambda: 500.0, lambda: None, lambda: 1 / 0, lambda: 1]
    got = []
    for sched in (AdaptiveScheduler(SchedulerConfig(
                      max_queue=10, shed_policy="reject"), 64),
                  JScheduler(JSchedulerConfig(
                      max_queue=10, shed_policy="reject",
                      cost_aware=False), 64)):
        row = [sched.backlog_of(QuietConsumer())]
        for src in sources:
            sched.fleet_backlog = src
            row.append(sched.backlog_of(QuietConsumer()))
        got.append(row)
    assert got[0] == got[1] == [2, 500, 2, 2, 2]


def test_scheduler_explicit_buckets_pin_the_ladder():
    """``SchedulerConfig.buckets`` (the serve CLI's measured ladder handed
    to every worker) pins the geometry and the governor's floor."""
    port = AdaptiveScheduler(SchedulerConfig(buckets=(16, 64)), 64)
    ref = JScheduler(JSchedulerConfig(buckets=(16, 64)), 64)
    assert port.buckets == ref.buckets == (16, 64)
    assert port.governor.min_budget == ref.governor.min_budget == 16
    assert port.snapshot()["buckets"] == [16, 64]


# ---------------------------------------------------------------------------
# whole-fleet drains
# ---------------------------------------------------------------------------

def test_fleet_two_workers_drain_exact_accounting(pipe):
    broker = InProcessBroker(num_partitions=4)
    feed(broker, N_MSGS)
    fleet, result = drain(broker, pipe, 2, lease_ttl=3.0)
    assert result["processed"] == N_MSGS
    assert sorted(out_keys(broker)) == _expect()
    assert sum(result["per_worker_processed"]) == N_MSGS
    assert result["deaths"] == [] and result["errors"] == []
    assert result["workers"] == 2 and result["rebalances"] >= 1


def test_fleet_drain_equals_jax(jpipe, pipe):
    """Both packages' 2-worker fleets over the same weights: the same key
    set, each key's output value byte-equal."""
    outs = []
    for fleet_cls, broker_cls, pipeline in ((Fleet, InProcessBroker, pipe),
                                            (jfleet.Fleet, JBroker, jpipe)):
        broker = broker_cls(num_partitions=4)
        feed(broker, 600)
        _, result = drain(broker, pipeline, 2, fleet_cls=fleet_cls,
                          lease_ttl=3.0)
        assert result["errors"] == []
        msgs = broker.messages("out")
        assert len(msgs) == 600
        outs.append({m.key: m.value for m in msgs})
    assert outs[0] == outs[1]


def _assert_no_reorder(broker):
    by_key_pos = {m.key: i for i, m in enumerate(broker.messages("out"))}
    for p in range(broker.num_partitions):
        positions = [by_key_pos[m.key] for m in broker.messages("in")
                     if m.partition == p and m.key in by_key_pos]
        assert positions == sorted(positions)


@pytest.mark.parametrize("mode", ["graceful", "crash"])
def test_fleet_worker_kill_zero_loss_zero_dup_no_reorder(pipe, mode):
    broker = InProcessBroker(num_partitions=4)
    feed(broker, N_MSGS)
    plan = tfaults.WorkerDeathPlan(seed=9, kills=1, min_polls=2, max_polls=5,
                                   modes=(mode,))
    fleet, result = drain(broker, pipe, 2, death_plan=plan, lease_ttl=0.8)
    keys = out_keys(broker)
    assert sorted(keys) == _expect(), (
        f"lost={len(set(_expect()) - set(keys))} "
        f"dup={len(keys) - len(set(keys))}")
    _assert_no_reorder(broker)
    assert len(result["deaths"]) == 1
    assert result["deaths"][0]["dead"] == mode
    assert result["death_plan"]["killed"][0]["mode"] == mode
    if mode == "crash":
        assert result["lease_expirations"] >= 1
    survivors = [r for r in result["per_worker"] if r["dead"] is None]
    assert survivors and sum(r["processed"] for r in survivors) > 0


def test_fleet_worker_kill_bit_reproducible(pipe):
    def run():
        broker = InProcessBroker(num_partitions=4)
        feed(broker, 300)
        plan = tfaults.WorkerDeathPlan(seed=21, kills=1, modes=("graceful",))
        _, result = drain(broker, pipe, 2, death_plan=plan)
        assert sorted(out_keys(broker)) == _expect(300)
        return result["death_plan"]["killed"]

    assert run() == run()


def test_fleet_global_shed_exact_accounting(pipe):
    broker = InProcessBroker(num_partitions=4)
    feed(broker, N_MSGS)
    cfg = SchedulerConfig(max_queue=64, shed_policy="reject")
    fleet, result = drain(broker, pipe, 2, sched_config=cfg,
                          dlq_topic="dlq")
    assert result["shed"] > 0
    assert sorted(out_keys(broker, topics=("out", "dlq"))) == _expect()
    assert result["fleet"]["peak_global_backlog"] > 0


def test_fleet_health_file_written_during_run(pipe, tmp_path):
    path = tmp_path / "fleet.json"
    broker = InProcessBroker(num_partitions=4)
    feed(broker, 300)
    fleet = Fleet.in_process(broker, pipe, "in", "out", 2,
                             batch_size=64, lease_ttl=1.0,
                             heartbeat_interval=0.02, tick_interval=0.02,
                             health_file=str(path))
    fleet.run(idle_timeout=0.3, join_timeout=90.0)
    doc = json.loads(path.read_text())
    assert set(doc) == {"time", "fleet", "alerts", "workers"}
    assert doc["alerts"] is None
    assert doc["fleet"]["rebalances"] >= 1


def test_fleet_stop_is_graceful(pipe):
    broker = InProcessBroker(num_partitions=4)
    feed(broker, N_MSGS)
    fleet = Fleet.in_process(broker, pipe, "in", "out", 2,
                             batch_size=32, lease_ttl=1.0,
                             heartbeat_interval=0.02, tick_interval=0.02)
    timer = threading.Timer(0.4, fleet.stop)
    timer.start()
    fleet.run(idle_timeout=5.0, join_timeout=90.0)
    timer.cancel()
    fleet2 = Fleet.in_process(broker, pipe, "in", "out", 2,
                              batch_size=64, lease_ttl=1.0,
                              heartbeat_interval=0.02, tick_interval=0.02)
    fleet2.run(idle_timeout=0.3, join_timeout=90.0)
    assert sorted(out_keys(broker)) == _expect()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("fleet-") and t.is_alive()]


def test_fleet_result_keys_equal_jax(jpipe, pipe):
    """Fleet.run's merged stats carry the reference's keys, and so does the
    fleet view inside them."""
    results = []
    for fleet_cls, broker_cls, pipeline in ((Fleet, InProcessBroker, pipe),
                                            (jfleet.Fleet, JBroker, jpipe)):
        broker = broker_cls(num_partitions=2)
        feed(broker, 100)
        _, result = drain(broker, pipeline, 2, fleet_cls=fleet_cls)
        results.append(result)
    assert set(results[0]) == set(results[1])
    assert set(results[0]["fleet"]) == set(results[1]["fleet"])
    assert set(results[0]["fleet"]["coordinator"]) == \
        set(results[1]["fleet"]["coordinator"])


def test_lease_and_public_names_equal_jax():
    assert tfleet.__all__ == jfleet.__all__
    assert [f.name for f in dataclasses.fields(tfleet.Lease)] == \
        [f.name for f in dataclasses.fields(jfleet.Lease)]
    with pytest.raises(RuntimeError, match="requires confluent_kafka"):
        tfleet.KafkaControlBus()
    with pytest.raises(RuntimeError, match="requires confluent_kafka"):
        jfleet.KafkaControlBus()
