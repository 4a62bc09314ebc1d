"""The port's coordinator succession (``fleet/control.py``) against the JAX
package's, on the CPU.

Stepped by hand on injected clocks, the control lane and the leased role
are held EQUAL to the reference: one scripted run of worker ops, ticks,
seeded coordinator kills and candidate ``step(cid)`` calls gives an equal
``succession_report()`` (handoffs, candidates, terms, control-lane stats)
and an equal control-bus ``export_trace()``, record for record; and a
control lane over a lossy chaos producer at one seed loses the same
records. The rest mirrors ``tests/test_succession.py`` on the port: record
round trips, dedup and loss accounting, lamport-ordered replay, compaction,
the term fence, crash failover after ``role_ttl``, graceful abdication,
consecutive failovers, the zombie incumbent that demotes without
publishing, and a real fleet whose coordinator crashes mid-drain with every
key classified exactly once. The reference's game-day cases are mirrored
in ``tests/test_torch_gameday_fleet.py`` (coordinator_kill, its clean arm,
and the conformance audit of both journals), its model-checker cases in
``tests/test_torch_model_checker.py``; its bench cases wait for the port's
benchmark (ROADMAP Queue 1 item 2).
"""

import json
import random
from dataclasses import replace

import pytest

from fraud_detection_tpu.fleet import control as jcontrol
from fraud_detection_tpu.models.pipeline import synthetic_demo_pipeline
from fraud_detection_tpu.stream import InProcessBroker as JBroker
from fraud_detection_tpu.stream import faults as jfaults
from fraud_detection_tpu_torch.fleet import Fleet, FleetCoordinator
from fraud_detection_tpu_torch.fleet import control as tcontrol
from fraud_detection_tpu_torch.fleet.control import (CANDIDATE_KINDS,
                                                     CONTROL_KINDS,
                                                     WORKER_OPS, ControlBus,
                                                     ControlRecord,
                                                     SuccessionCoordinator,
                                                     TermGate)
from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
from fraud_detection_tpu_torch.stream import InProcessBroker
from fraud_detection_tpu_torch.stream import faults as tfaults
from tests.torch_parity import port_featurizer, port_model, warmed

pytestmark = pytest.mark.fleet

COORDINATOR_BLOCK_SCHEMA = {
    "term": (int,),
    "leader": (str, type(None)),
    "handoffs": (int,),
    "elections": (int,),
    "ticks": (int,),
    "last_tick_age_s": (int, float, type(None)),
    "control": (dict, type(None)),
}


def assert_coordinator_block(block):
    assert set(block) == set(COORDINATOR_BLOCK_SCHEMA)
    for key, types in COORDINATOR_BLOCK_SCHEMA.items():
        assert isinstance(block[key], types), (key, block[key])


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t = round(self.t + dt, 6)


def _json(obj):
    return json.loads(json.dumps(obj))


# ---------------------------------------------------------------------------
# control records, the in-memory wire, the term fence
# ---------------------------------------------------------------------------

def test_control_record_roundtrip_and_rejects_garbage():
    rec = ControlRecord("join", "w1", 4, 2, 17, {"a": 1})
    assert rec.key() == "join:w1"
    assert ControlRecord.from_dict(json.loads(json.dumps(rec.as_dict()))) \
        == rec
    assert ControlRecord.from_dict({"kind": "join"}) is None
    assert ControlRecord.from_dict({"kind": "join", "sender": "w", "seq":
                                    "x", "term": 0, "lamport": 1}) is None
    assert set(WORKER_OPS) < set(CONTROL_KINDS)
    assert set(CANDIDATE_KINDS) < set(CONTROL_KINDS)
    assert (WORKER_OPS, CANDIDATE_KINDS, CONTROL_KINDS) == \
        (jcontrol.WORKER_OPS, jcontrol.CANDIDATE_KINDS,
         jcontrol.CONTROL_KINDS)
    with pytest.raises(ValueError, match="both"):
        ControlBus(producer=object())


def test_in_memory_publish_poll_dedup_and_stats():
    bus = ControlBus()
    recs = [bus.publish("sync", "w0", {"i": i}) for i in range(3)]
    assert [r.seq for r in recs] == [1, 2, 3]
    assert bus.poll() == recs
    bus.retry(recs[1])
    bus.retry(recs[1])
    assert bus.poll() == []
    s = bus.stats()
    assert set(s) == set(jcontrol.ControlBus().stats())
    assert s["published"] == 3 and s["delivered"] == 3
    assert s["duplicates_dropped"] == 2 and s["lost"] == 0
    assert s["journal"] == 3
    assert bus.export_trace() == [r.as_dict() for r in recs]


def test_replay_picks_newest_term_snapshot_and_rejects_stale():
    bus = ControlBus()
    bus.publish("join", "w0", term=1)
    bus.publish("snapshot", "c0", {"state": {"g": 1},
                                   "watermark": bus.lamport()}, term=1)
    bus.publish("sync", "w0", term=1)
    snap2 = bus.publish("snapshot", "c1", {"state": {"g": 2},
                                           "watermark": bus.lamport()},
                        term=2)
    bus.publish("snapshot", "c0", {"state": {"g": "zombie"},
                                   "watermark": bus.lamport()}, term=1)
    op = bus.publish("ack", "w0", term=2)
    bus.poll()
    best, ops = bus.replay()
    assert best == snap2 and ops == [op]
    assert bus.stats()["stale_snapshots_rejected"] == 1


def test_compaction_keeps_snapshot_plus_uncovered_ops():
    bus = ControlBus()
    for i in range(4200):
        bus.publish("sync", f"w{i % 3}")
    bus.publish("snapshot", "c0", {"state": {"g": 9},
                                   "watermark": bus.lamport()}, term=1)
    tail = [bus.publish("ack", f"w{i}") for i in range(3)]
    bus.poll()
    s = bus.stats()
    assert s["compactions"] >= 1 and s["log"] <= 4096
    best, ops = bus.replay()
    assert best.payload["state"] == {"g": 9} and ops == tail


def test_term_gate_cas_and_stale_fence():
    gate = TermGate()
    assert gate.try_advance(1) and not gate.try_advance(1)
    assert gate.try_advance(3)
    assert not gate.accept(2) and gate.accept(3) and gate.accept(4)


@pytest.mark.parametrize("seed", [3, 7, 11])
def test_lossy_control_lane_equals_jax(seed):
    """The control lane over a chaos producer that fails flushes at one
    seed: the same records lost, the same delivery accounting and replay."""
    got = []
    for broker_cls, faults, mod in ((InProcessBroker, tfaults, tcontrol),
                                    (JBroker, jfaults, jcontrol)):
        broker = broker_cls(num_partitions=1)
        plan = faults.FaultPlan(seed=seed, flush_fail_rate=0.4,
                                duplicate_rate=0.1)
        tx = mod.ControlBus(
            producer=faults.ChaosProducer(broker.producer(), plan),
            consumer=broker.consumer(["__fleet_control"], "tx"))
        rx = mod.ControlBus(
            producer=broker.producer(),
            consumer=broker.consumer(["__fleet_control"], "rx"))
        for i in range(60):
            tx.publish(("sync", "ack", "join")[i % 3], f"w{i % 2}")
        rx.poll()
        _, ops = rx.replay()
        got.append((rx.stats(), [r.as_dict() for r in ops],
                    rx.export_trace()))
    assert got[0] == got[1]
    assert got[0][0]["lost"] >= 1


# ---------------------------------------------------------------------------
# the leased role
# ---------------------------------------------------------------------------

def test_bootstrap_leader_and_coordinator_block_schema():
    clock = _Clock()
    sc = SuccessionCoordinator(["in"], 4, candidates=2, clock=clock,
                               wall=clock)
    sc.join("w0")
    clock.advance(0.05)
    block = sc.tick()["coordinator"]
    assert_coordinator_block(block)
    assert block["term"] == 1 and block["leader"] == "c0"
    legacy = FleetCoordinator(["in"], 2)
    legacy.join("w0")
    assert_coordinator_block(legacy.tick()["coordinator"])


def test_crash_failover_reconstructs_state_and_inherits_holds():
    clock = _Clock()
    kill = tfaults.CoordinatorKillSpec(seed=0, kills=1, min_ticks=2,
                                       max_ticks=2, modes=("crash",))
    sc = SuccessionCoordinator(["in"], 2, lease_ttl=60.0, candidates=2,
                               role_ttl=1.0, kill=kill, clock=clock,
                               wall=clock)
    assert len(sc.join("w0").partitions) == 2
    l1 = sc.join("w1")
    assert l1.partitions == () and len(l1.pending) == 1
    moved = tuple(l1.pending[0])
    clock.advance(0.1)
    sc.tick()
    clock.advance(0.1)
    sc.tick()
    assert sc.coordinator is None and sc.leader_id is None
    assert sc.step("c1") is False
    assert {tuple(p) for p in sc.sync("w0").partitions} >= {moved}
    assert sc.fence_lost("w0", [moved]) == []
    assert sc.fence_lost("w1", [moved]) == [moved]
    clock.advance(1.5)
    assert sc.step("c1") is True
    assert sc.term == 2 and sc.leader_id == "c1"
    report = sc.succession_report()
    (handoff,) = report["handoffs"]
    assert handoff["mode"] == "crash" and handoff["failover_s"] >= 1.0
    assert report["candidates"] == {"c0": "dead", "c1": "leading"}
    l1b = sc.sync("w1")
    assert moved in {tuple(p) for p in l1b.pending}
    sc.ack("w0")
    assert moved in {tuple(p) for p in sc.sync("w1").partitions}


def test_graceful_abdication_elects_immediately():
    clock = _Clock()
    kill = tfaults.CoordinatorKillSpec(seed=1, kills=1, min_ticks=1,
                                       max_ticks=1, modes=("graceful",))
    sc = SuccessionCoordinator(["in"], 2, candidates=2, role_ttl=5.0,
                               kill=kill, clock=clock, wall=clock)
    sc.join("w0")
    clock.advance(0.05)
    sc.tick()
    assert sc.coordinator is None and sc.step("c1") is True
    assert sc.succession_report()["handoffs"][0]["mode"] == "graceful"
    assert sc.assignments() == {"w0": [("in", 0), ("in", 1)]}


def test_consecutive_failovers_burn_through_candidates():
    clock = _Clock()
    kill = tfaults.CoordinatorKillSpec(seed=2, kills=2, min_ticks=1,
                                       max_ticks=1, modes=("graceful",))
    sc = SuccessionCoordinator(["in"], 2, candidates=3, role_ttl=5.0,
                               kill=kill, clock=clock, wall=clock)
    sc.join("w0")
    clock.advance(0.05)
    sc.tick()
    assert sc.step("c1") is True and sc.term == 2
    clock.advance(0.05)
    sc.tick()
    assert sc.step("c1") is False and sc.step("c2") is True
    report = sc.succession_report()
    assert report["term"] == 3 and report["leader"] == "c2"
    assert report["candidates"] == {"c0": "dead", "c1": "dead",
                                    "c2": "leading"}


def test_zombie_incumbent_demotes_without_publishing():
    clock = _Clock()
    sc = SuccessionCoordinator(["in"], 2, candidates=2, role_ttl=1.0,
                               clock=clock, wall=clock)
    sc.join("w0")
    clock.advance(0.05)
    sc.tick()
    assert sc.gate.try_advance(sc.gate.current() + 1)
    before = sc.control.stats()["published"]
    sc.tick()
    assert sc.coordinator is None
    assert sc.control.stats()["published"] == before
    clock.advance(1.1)
    assert sc.step("c0") is True and sc.term == 3


def test_succession_validation():
    with pytest.raises(ValueError, match="candidates"):
        SuccessionCoordinator(["in"], 2, candidates=0)
    with pytest.raises(ValueError, match="role_ttl"):
        SuccessionCoordinator(["in"], 2, role_ttl=0.0)


# ---------------------------------------------------------------------------
# one stepped succession run in both packages
# ---------------------------------------------------------------------------

def _succession_run(mod, faults, seed, steps=160):
    rng = random.Random(seed)
    clock = _Clock()
    kill = faults.CoordinatorKillSpec(seed=seed, kills=2, min_ticks=3,
                                      max_ticks=9)
    sc = mod.SuccessionCoordinator(["in"], 4, lease_ttl=2.0, candidates=3,
                                   role_ttl=0.7, kill=kill, clock=clock,
                                   wall=lambda: 500.0 + clock())
    trail = []
    for _ in range(steps):
        kind = rng.choices(["op", "tick", "step", "advance", "fence",
                            "release"], [6, 2, 2, 3, 1, 1])[0]
        w = f"w{rng.randrange(4)}"
        if kind == "op":
            op = rng.choices(["join", "sync", "ack", "leave"],
                             [2, 5, 2, 1])[0]
            lease = getattr(sc, op)(w)
            trail.append((op, w, None if lease is None else (
                lease.generation, tuple(lease.partitions),
                tuple(lease.pending), lease.released)))
        elif kind == "tick":
            trail.append(("tick", _json(sc.tick())))
        elif kind == "step":
            cid = f"c{rng.randrange(3)}"
            trail.append(("step", cid, sc.step(cid)))
        elif kind == "fence":
            pairs = [("in", p) for p in range(4) if rng.random() < 0.5]
            trail.append(("fence", w, sc.fence_lost(w, pairs)))
        elif kind == "release":
            trail.append(("release", w, sc.request_release(w)))
        else:
            clock.advance(rng.choice([0.1, 0.3, 0.8]))
        trail.append(("state", sc.term, sc.leader_id,
                      sc.assignments(), sc.rebalances, sc.expirations))
    return (trail, _json(sc.succession_report()),
            sc.control.export_trace(), kill.report())


@pytest.mark.parametrize("seed", range(4))
def test_stepped_succession_equals_jax(seed):
    port = _succession_run(tcontrol, tfaults, seed)
    ref = _succession_run(jcontrol, jfaults, seed)
    for i, (a, b) in enumerate(zip(port[0], ref[0])):
        assert a == b, f"step {i}"
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3] == ref[3]
    assert port[1]["elections"] >= 1      # the run did fail over


# ---------------------------------------------------------------------------
# a real fleet survives its coordinator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipe():
    jp = synthetic_demo_pipeline(batch_size=64, n=300, seed=3,
                                 num_features=1024,
                                 corpus_kwargs=dict(hard_fraction=0.0,
                                                    label_noise=0.0))
    return warmed(ServingPipeline(port_featurizer(jp.featurizer),
                                  port_model(jp.model), batch_size=64,
                                  device="cpu"))


def test_fleet_survives_coordinator_crash_exactly_once(pipe, tmp_path):
    """Coordinator crash + worker crash mid-drain: a successor takes the
    role and every key is classified exactly once, with the fleet sentinel
    and its flight recorder armed. (Whether the coordinator_absence alert
    fires depends on how much work the interregnum still saw, which the
    load decides, so it is not asserted.)"""
    from fraud_detection_tpu_torch.obs.sentinel import (IncidentRecorder,
                                                        fleet_rule_pack)

    broker = InProcessBroker(num_partitions=4)
    prod = broker.producer()
    for i in range(400):
        prod.produce("in", json.dumps({"text": f"hello dialogue {i}",
                                       "id": i}).encode(),
                     key=str(i).encode())
    kill = tfaults.CoordinatorKillSpec(seed=2, kills=1, min_ticks=2,
                                       max_ticks=4, modes=("crash",))
    fleet = Fleet.in_process(
        broker, pipe, "in", "out", 2, batch_size=64,
        lease_ttl=1.0, heartbeat_interval=0.02, tick_interval=0.02,
        candidates=2, role_ttl=0.8, coordinator_kill=kill,
        death_plan=tfaults.WorkerDeathPlan(seed=4, kills=1, min_polls=2,
                                           max_polls=4, modes=("crash",)),
        sentinel_rules=fleet_rule_pack(backlog_limit=20000.0, fast_s=0.25,
                                       slow_s=1.0, resolve_s=0.2),
        sentinel_recorder=IncidentRecorder(str(tmp_path)))
    out = fleet.run(idle_timeout=2.5, join_timeout=90.0)
    assert sorted(m.key for m in broker.messages("out")) == \
        sorted(str(i).encode() for i in range(400))
    succ = out["succession"]
    assert succ["elections"] >= 1 and succ["term"] >= 2
    assert succ["control"]["lost"] == 0
    assert succ["kill_plan"]["killed"][0]["mode"] == "crash"
    assert set(succ) == {"term", "leader", "candidates", "elections",
                         "handoffs", "control", "trace", "kill_plan"}
    assert out["errors"] == [] and "alerts" in out


def test_fleet_rejects_unsurvivable_kill_budget(pipe):
    broker = InProcessBroker(num_partitions=2)
    with pytest.raises(ValueError, match="survive"):
        Fleet.in_process(broker, pipe, "in", "out", 2, candidates=2,
                         coordinator_kill=replace(
                             tfaults.CoordinatorKillSpec(), kills=2))
