"""The port's supervision and fault injection against the JAX package's, on
the CPU.

``stream/faults.py`` draws from one ``random.Random(seed)`` in call order, so
one seed and one sequence of fault opportunities give the same schedule in
both packages: the plans' decisions, reports and victim picks are held equal
draw for draw. A supervised chaos run (``run_supervised`` over
``ChaosConsumer``/``ChaosProducer``, the mixed plan of
``tests/test_chaos.py``) at seeds 42 and 1234 makes the same broker calls in
the same order as the JAX engine, so the delivered ``(key, value)`` streams
are byte-equal, the DLQ key sets equal, and the restart and injection
counts equal. Both engines end each incarnation after ``idle_timeout`` of
empty polls, timed on ``time.perf_counter()``, and every poll is a fault
opportunity; here both time that window on a clock that advances a fixed
step a read (``_SteppedTime``), so it spans the same polls in both however
loaded the host is. The rest mirrors ``tests/test_chaos.py`` on the port: the
delivery invariants (every key delivered, no commit past a lost output),
reproducibility, poison and corruption routing, trace ids on DLQ records,
full-jitter backoff (the same waits as the JAX supervisor under a seeded
rng), the give-up path, and the health block. The port adds: a fault of the
card is never restarted around, and a failed incarnation stops its
dispatch lane.

Cases of ``tests/test_chaos.py`` tested elsewhere: the circuit breaker ones
are ``explain/circuit.py``'s (ported with the explanation lane, tested in
``tests/test_torch_explain.py``); ``WorkerKilled`` is only raised through
``fleet/``, so the plan is held equal here and its deaths are exercised in
``tests/test_torch_fleet.py``.
"""

import contextlib
import json
import random
import threading
import time

import pytest

from fraud_detection_tpu.models.pipeline import synthetic_demo_pipeline
from fraud_detection_tpu.stream import InProcessBroker as JBroker
from fraud_detection_tpu.stream import StreamingClassifier as JEngine
from fraud_detection_tpu.stream import engine as jengine_mod
from fraud_detection_tpu.stream import faults as jfaults
from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
from fraud_detection_tpu_torch.obs import RowTracer
from fraud_detection_tpu_torch.stream import InProcessBroker, StreamingClassifier
from fraud_detection_tpu_torch.stream import engine as tengine_mod
from fraud_detection_tpu_torch.stream import faults as tfaults
from fraud_detection_tpu_torch.stream.broker import (CommitFailedError,
                                                     TransientBrokerError)
from tests.torch_parity import port_featurizer, port_model


@pytest.fixture(scope="module")
def jpipe():
    return synthetic_demo_pipeline(batch_size=64, n=400, seed=3,
                                   num_features=2048,
                                   corpus_kwargs=dict(hard_fraction=0.0,
                                                      label_noise=0.0))


@pytest.fixture(scope="module")
def pipe(jpipe):
    return ServingPipeline(port_featurizer(jpipe.featurizer),
                           port_model(jpipe.model), batch_size=64,
                           device="cpu")


@pytest.fixture(scope="module")
def dev_pipe(jpipe):
    """The port's device-featurize pipeline (the plain torch scan on the
    CPU), the path the card runs under ``--featurize-device``."""
    return ServingPipeline(port_featurizer(jpipe.featurizer),
                           port_model(jpipe.model), batch_size=64,
                           featurize_device=True, device="cpu")


def _feed(broker, n, topic="in"):
    prod = broker.producer()
    for i in range(n):
        prod.produce(topic,
                     json.dumps({"text": f"chaos message number {i}",
                                 "id": i}).encode(),
                     key=str(i).encode())


def _mixed_plan(faults, seed, max_faults=60):
    """tests/test_chaos.py's mix: lossy flushes, flush crashes, commit
    fences, poll errors, duplicates, corruption, zero-cost latency spikes."""
    return faults.FaultPlan(seed=seed, poll_error_rate=0.08,
                            latency_spike_rate=0.05, latency_spike_sec=0.0,
                            duplicate_rate=0.08, corrupt_rate=0.05,
                            flush_fail_rate=0.08, flush_crash_rate=0.06,
                            commit_fence_rate=0.08, max_faults=max_faults,
                            sleep=lambda s: None)


def _run_chaos(pipeline, plan, n=150, *, port=True, dlq_topic=None,
               dlq_attempts=None, max_restarts=300, group="chaos",
               rowtrace=None, **engine_kw):
    broker_cls, engine_cls, faults, emod = (
        (InProcessBroker, StreamingClassifier, tfaults, tengine_mod) if port
        else (JBroker, JEngine, jfaults, jengine_mod))
    broker = broker_cls(num_partitions=3)
    _feed(broker, n)
    producers = []

    def make_engine():
        cons = faults.ChaosConsumer(broker.consumer(["in"], group), plan)
        prod = faults.ChaosProducer(broker.producer(), plan)
        producers.append(prod)
        return engine_cls(pipeline, cons, prod, "out", batch_size=32,
                          max_wait=0.01, dlq_topic=dlq_topic,
                          dlq_attempts=dlq_attempts, rowtrace=rowtrace,
                          **engine_kw)

    with _stepped_clock(emod):
        stats = emod.run_supervised(make_engine, max_restarts=max_restarts,
                                    backoff=0.0, idle_timeout=0.2,
                                    sleep=lambda s: None)
    return broker, stats, producers


class _SteppedTime:
    """The ``time`` module for one engine module, whose ``perf_counter``
    advances ``STEP`` seconds a read on the thread that drives the run and
    reads the host's clock on any other thread. Each empty poll of the idle
    window reads the clock once, so ``idle_timeout`` spans a fixed number of
    polls (fault opportunities) whatever the host's load. The step is a
    power of two, so the differences the engines compare are exact."""

    STEP = 2.0 ** -7

    def __init__(self):
        self._owner = threading.get_ident()
        self._now = 0.0

    def perf_counter(self):
        if threading.get_ident() != self._owner:
            return time.perf_counter()
        self._now += self.STEP
        return self._now

    def __getattr__(self, name):
        return getattr(time, name)


@contextlib.contextmanager
def _stepped_clock(emod):
    """Run ``emod``'s engines on a ``_SteppedTime`` clock (both packages'
    engines time the idle window on ``time.perf_counter()``)."""
    real = emod.time
    emod.time = _SteppedTime()
    try:
        yield
    finally:
        emod.time = real


def _assert_delivery_invariants(broker, n, group="chaos",
                                extra_topics=("out-dlq",)):
    """Every fed key is in out ∪ DLQ, and no committed offset passes a lost
    output."""
    delivered = {m.key for m in broker.messages("out")}
    for topic in extra_topics:
        delivered |= {m.key for m in broker.messages(topic)}
    want = {str(i).encode() for i in range(n)}
    missing = want - delivered
    assert not missing, f"lost {len(missing)} input keys: {sorted(missing)[:5]}"
    committed = {(t, p): off
                 for (g, t, p), off in broker._group_offsets.items()
                 if g == group}
    for m in broker.messages("in"):
        if m.offset < committed.get((m.topic, m.partition), 0):
            assert m.key in delivered, (
                f"commit advanced past lost output: {m.key!r} "
                f"({m.topic}/{m.partition}@{m.offset})")


# ----------------------------------------------------------------------
# the plan, draw for draw
# ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_fault_plan_decisions_equal_draw_for_draw(seed):
    """One sequence of opportunities (every kind, victim picks between
    them) gives the same decisions, picks and report in both packages,
    including after the budget is spent."""
    plans = [_mixed_plan(f, seed, max_faults=25) for f in (jfaults, tfaults)]
    kinds = [("poll_error", 0.08), ("latency_spike", 0.05),
             ("duplicate", 0.08), ("corrupt", 0.05), ("flush_fail", 0.08),
             ("flush_crash", 0.06), ("commit_fence", 0.08),
             ("reorder", 0.0)]
    seq = random.Random(seed + 1)
    for _ in range(600):
        kind, rate = kinds[seq.randrange(len(kinds))]
        got = [p.fire(kind, rate) for p in plans]
        assert got[0] == got[1]
        if got[0]:
            n = 1 + seq.randrange(40)
            assert plans[0].pick(n) == plans[1].pick(n)
        assert plans[0].spent() == plans[1].spent()
    assert plans[0].report() == plans[1].report()
    assert plans[0].total_injected == plans[1].total_injected == 25


def test_demo_preset_equals_jax_field_for_field():
    j = jfaults.FaultPlan.demo(seed=7, sleep=lambda s: None)
    t = tfaults.FaultPlan.demo(seed=7, sleep=lambda s: None)
    for name in ("seed", "poll_error_rate", "latency_spike_rate",
                 "latency_spike_sec", "duplicate_rate", "corrupt_rate",
                 "flush_fail_rate", "flush_crash_rate", "commit_fence_rate",
                 "reorder_rate", "max_faults"):
        assert getattr(j, name) == getattr(t, name), name
    assert j.max_faults == 40


@pytest.mark.parametrize("seed", [3, 11])
def test_chaos_wrappers_equal_jax(seed):
    """The wrappers over each package's broker: the same polled batches
    (duplicates and corrupted values included), the same flush results and
    lost records, the same fences — call for call."""
    def drive(broker_cls, faults):
        plan = faults.FaultPlan(seed=seed, poll_error_rate=0.1,
                                duplicate_rate=0.3, corrupt_rate=0.3,
                                flush_fail_rate=0.3, flush_crash_rate=0.1,
                                commit_fence_rate=0.2, reorder_rate=0.3,
                                sleep=lambda s: None)
        broker = broker_cls(num_partitions=2)
        _feed(broker, 60)
        cons = plan.consumer(broker.consumer(["in"], "g"))
        prod = plan.producer(broker.producer())
        log = []
        for _ in range(12):
            try:
                msgs = cons.poll_batch(8, 0.01)
            except Exception as e:  # noqa: BLE001 — the injected faults
                log.append(("poll", type(e).__name__))
                continue
            log.append(("poll", [(m.key, m.value, m.partition, m.offset)
                                 for m in msgs]))
            prod.produce_batch("out", [(m.value, m.key) for m in msgs])
            try:
                log.append(("flush", prod.flush()))
            except ConnectionError as e:
                log.append(("flush", str(e)))
            offsets = {}
            for m in msgs:
                key = (m.topic, m.partition)
                offsets[key] = max(offsets.get(key, 0), m.offset + 1)
            try:
                cons.commit_offsets(offsets)
                log.append(("commit", sorted(offsets.items())))
            except Exception as e:  # noqa: BLE001 — the injected fence
                log.append(("commit", type(e).__name__))
        log.append(("lost", prod.lost))
        log.append(("out", [(m.key, m.value) for m in broker.messages("out")]))
        log.append(("report", plan.report()))
        return log

    assert drive(InProcessBroker, tfaults) == drive(JBroker, jfaults)


def test_poll_error_is_a_transient_broker_error():
    plan = tfaults.FaultPlan(seed=0, poll_error_rate=1.0,
                             sleep=lambda s: None)
    cons = plan.consumer(InProcessBroker().consumer(["in"], "g"))
    with pytest.raises(TransientBrokerError):
        cons.poll_batch(4, 0.0)
    plan = tfaults.FaultPlan(seed=0, commit_fence_rate=1.0)
    with pytest.raises(CommitFailedError):
        plan.consumer(InProcessBroker().consumer(["in"], "g")).commit()


@pytest.mark.parametrize("seed", [0, 5])
def test_worker_death_and_coordinator_kill_picks_equal_jax(seed):
    """Victim picks of the whole-worker and coordinator plans, armed and
    ticked in one order, equal the JAX plans' (the fleet drives them)."""
    def drive(faults):
        plan = faults.WorkerDeathPlan(seed=seed, kills=2)
        for w in ("w0", "w1", "w2"):
            plan.arm(w)
        deaths = []
        for _ in range(15):
            for w in ("w0", "w1", "w2"):
                try:
                    plan.tick(w)
                except faults.WorkerKilled as e:
                    deaths.append((e.worker_id, e.mode))
        spec = faults.CoordinatorKillSpec(seed=seed, kills=2, min_ticks=2,
                                          max_ticks=6)
        kills = []
        for i in range(20):
            try:
                spec.tick(f"c{len(kills)}")
            except faults.CoordinatorKilled as e:
                kills.append((e.coordinator_id, e.mode, i))
        return deaths, plan.report(), kills, spec.report()

    assert drive(tfaults) == drive(jfaults)


# ----------------------------------------------------------------------
# the supervised chaos run, against the JAX engine
# ----------------------------------------------------------------------


@pytest.mark.parametrize("seed,n,featurize_device", [
    (42, 150, False), (42, 150, True), (1234, 100, False)])
def test_supervised_chaos_equals_jax(jpipe, pipe, dev_pipe, seed, n,
                                     featurize_device):
    """The mixed plan over each package's engine: the same fault report,
    restart count and stats, byte-equal output streams (keys and values in
    produce order) and equal committed offsets."""
    jplan = _mixed_plan(jfaults, seed)
    jbroker, jstats, jprod = _run_chaos(jpipe, jplan, n, port=False)
    tplan = _mixed_plan(tfaults, seed)
    tbroker, tstats, tprod = _run_chaos(
        dev_pipe if featurize_device else pipe, tplan, n)
    assert tplan.report() == jplan.report()
    assert tstats.restarts == jstats.restarts
    for name in ("processed", "malformed", "batches", "commits_skipped",
                 "rebalanced_commits"):
        assert getattr(tstats, name) == getattr(jstats, name), name
    assert ([(m.key, m.value) for m in tbroker.messages("out")]
            == [(m.key, m.value) for m in jbroker.messages("out")])
    assert ([r[2] for p in tprod for r in p.lost]
            == [r[2] for p in jprod for r in p.lost])
    assert tbroker.committed("chaos") == {
        (t, p): off for (g, t, p), off in jbroker._group_offsets.items()
        if g == "chaos"}
    _assert_delivery_invariants(tbroker, n)


def test_supervised_chaos_with_dlq_equals_jax(jpipe, pipe):
    """Corruption under the DLQ: the same DLQ key set and records (trace
    ids aside: tracing is off) as the JAX engine's."""
    def plan(f):
        return f.FaultPlan(seed=11, corrupt_rate=0.7, flush_fail_rate=0.1,
                           max_faults=12, sleep=lambda s: None)

    jplan, tplan = plan(jfaults), plan(tfaults)
    jb, js, _ = _run_chaos(jpipe, jplan, 100, port=False,
                           dlq_topic="out-dlq", dlq_attempts={},
                           group="corrupt")
    tb, ts, _ = _run_chaos(pipe, tplan, 100, dlq_topic="out-dlq",
                           dlq_attempts={}, group="corrupt")
    assert tplan.report() == jplan.report()
    assert ts.restarts == js.restarts and ts.dead_lettered == js.dead_lettered
    assert ({m.key for m in tb.messages("out-dlq")}
            == {m.key for m in jb.messages("out-dlq")})
    assert ([(m.key, m.value) for m in tb.messages("out-dlq")]
            == [(m.key, m.value) for m in jb.messages("out-dlq")])
    assert ([(m.key, m.value) for m in tb.messages("out")]
            == [(m.key, m.value) for m in jb.messages("out")])


# ----------------------------------------------------------------------
# tests/test_chaos.py's cases, on the port
# ----------------------------------------------------------------------


def test_chaos_invariants_under_seeded_plan(pipe):
    plan = _mixed_plan(tfaults, seed=42)
    broker, stats, producers = _run_chaos(pipe, plan, n=150)
    assert plan.total_injected > 0, "the chaos never bit"
    assert stats.restarts > 0, "no fault killed an incarnation"
    assert sum(len(p.lost) for p in producers) > 0, \
        "no flush fault actually lost outputs"
    _assert_delivery_invariants(broker, 150)


def test_chaos_bit_reproducible_for_fixed_seed(pipe):
    def run():
        broker, _, _ = _run_chaos(pipe, _mixed_plan(tfaults, seed=1234), n=100)
        return [(m.key, m.value) for m in broker.messages("out")]

    assert run() == run()


@pytest.mark.slow
def test_chaos_soak_many_seeds(pipe):
    for seed in (1, 7, 99, 2024):
        plan = tfaults.FaultPlan(seed=seed, poll_error_rate=0.15,
                                 latency_spike_rate=0.1, latency_spike_sec=0.0,
                                 duplicate_rate=0.12, corrupt_rate=0.08,
                                 flush_fail_rate=0.12, flush_crash_rate=0.1,
                                 commit_fence_rate=0.12, max_faults=150,
                                 sleep=lambda s: None)
        broker, _, _ = _run_chaos(pipe, plan, n=300, group=f"soak{seed}")
        assert plan.total_injected > 0
        _assert_delivery_invariants(broker, 300, group=f"soak{seed}")


def test_chaos_poll_errors_alone_are_survivable(pipe):
    plan = tfaults.FaultPlan(seed=3, poll_error_rate=0.25, max_faults=20,
                             sleep=lambda s: None)
    broker, stats, _ = _run_chaos(pipe, plan, n=80, group="pollchaos")
    assert stats.restarts > 0
    _assert_delivery_invariants(broker, 80, group="pollchaos")


def test_dlq_chaos_corruption_lands_in_dlq(pipe):
    plan = tfaults.FaultPlan(seed=11, corrupt_rate=0.7, max_faults=12,
                             sleep=lambda s: None)
    broker, stats, _ = _run_chaos(pipe, plan, n=100, dlq_topic="out-dlq",
                                  dlq_attempts={}, group="corrupt")
    assert plan.injected.get("corrupt", 0) > 0
    assert stats.dead_lettered > 0
    recs = [json.loads(m.value) for m in broker.messages("out-dlq")]
    assert all(r["reason"] == "malformed" for r in recs)
    assert all(r["original"].startswith("\x00chaos:") for r in recs)
    _assert_delivery_invariants(broker, 100, group="corrupt")


def test_dlq_records_carry_trace_ids_under_chaos(pipe):
    """Every DLQ record minted across a supervised chaos run carries its
    row's trace id, which encodes the record's source coordinates and
    joins back to a poll -> terminal chain; span accounting stays exact."""
    plan = tfaults.FaultPlan(seed=11, corrupt_rate=0.5, flush_fail_rate=0.05,
                             commit_fence_rate=0.05, max_faults=20,
                             sleep=lambda s: None)
    tr = RowTracer(worker="w0", sample=1.0, seed=0, capacity=65536)
    broker, stats, _ = _run_chaos(pipe, plan, n=100, dlq_topic="out-dlq",
                                  dlq_attempts={}, group="trace", rowtrace=tr)
    recs = [json.loads(m.value) for m in broker.messages("out-dlq")]
    assert stats.dead_lettered > 0 and recs
    for rec in recs:
        cid = rec["trace"]
        assert cid.split(":")[1:] == [str(rec["source"]["partition"]),
                                      str(rec["source"]["offset"])]
        stages = [s.stage for s in tr.chain(cid)]
        assert "dlq" in stages and "poll" in stages and "deliver" in stages
    snap = tr.snapshot()
    assert snap["spans_begun"] == snap["spans_ended"]
    assert snap["batches_traced"] == snap["batches_closed"]
    _assert_delivery_invariants(broker, 100, group="trace")


def test_dlq_poison_rows_diverted_after_max_attempts(pipe):
    """A row whose batch keeps crashing stops burning restarts: after
    dlq_max_attempts re-deliveries it goes to the DLQ, the tracker shared
    across incarnations."""
    class _Boom:
        def resolve(self):
            raise RuntimeError("scorer crashed on poison row")

    class PoisonPipeline:
        def __init__(self, inner):
            self.inner = inner

        def predict_json_async(self, values, field):
            return None        # pin the decoded-text path

        def predict_async(self, texts):
            pending = self.inner.predict_async(texts)
            return _Boom() if any("POISON" in t for t in texts) else pending

        def __getattr__(self, name):
            return getattr(self.inner, name)

    broker = InProcessBroker(num_partitions=1)
    prod = broker.producer()
    for i in range(10):
        text = "POISON payload" if i == 9 else f"ordinary message {i}"
        prod.produce("in", json.dumps({"text": text}).encode(),
                     key=str(i).encode())
    shared_attempts = {}
    poisoned = PoisonPipeline(pipe)

    def make_engine():
        return StreamingClassifier(
            poisoned, broker.consumer(["in"], "poison"), broker.producer(),
            "out", batch_size=4, max_wait=0.01, dlq_topic="out-dlq",
            dlq_max_attempts=2, dlq_attempts=shared_attempts)

    stats = tengine_mod.run_supervised(make_engine, max_restarts=10,
                                       backoff=0.0, idle_timeout=0.2,
                                       sleep=lambda s: None)
    assert stats.restarts == 2
    recs = {m.key: json.loads(m.value) for m in broker.messages("out-dlq")}
    assert recs[b"9"]["reason"] == "max_attempts_exceeded"
    assert recs[b"9"]["attempts"] == 3
    delivered = {m.key for m in broker.messages("out")} | set(recs)
    assert delivered == {str(i).encode() for i in range(10)}
    assert stats.dead_lettered == len(recs)


# ----------------------------------------------------------------------
# the supervisor
# ----------------------------------------------------------------------


def _sleeps(mod, **kw):
    def dead_engine():
        raise ConnectionError("broker down")

    sleeps = []
    with pytest.raises(ConnectionError):
        mod.run_supervised(dead_engine, max_restarts=6, backoff=0.5,
                           backoff_cap=4.0, sleep=sleeps.append, **kw)
    return sleeps


def test_supervised_backoff_full_jitter_equals_jax():
    """Full jitter under a seeded rng: the same waits as the JAX supervisor,
    each within [0, min(backoff * 2^(n-1), cap)]; jitter=False gives the
    ceilings."""
    ceilings = [min(0.5 * 2 ** k, 4.0) for k in range(6)]
    jittered = _sleeps(tengine_mod, rng=random.Random(7))
    assert jittered == _sleeps(jengine_mod, rng=random.Random(7))
    assert len(jittered) == 6
    assert all(0.0 <= s <= c for s, c in zip(jittered, ceilings))
    assert len(set(jittered)) > 1
    assert _sleeps(tengine_mod, jitter=False) == ceilings


def test_supervised_give_up_attaches_partial_stats():
    def dead_engine():
        raise ConnectionError("broker down")

    with pytest.raises(ConnectionError) as ei:
        tengine_mod.run_supervised(dead_engine, max_restarts=2, backoff=0.0,
                                   sleep=lambda s: None)
    stats = ei.value.supervisor_stats
    assert stats.restarts == 2 and stats.processed == 0


@pytest.mark.parametrize("fault", ["cuda", "kernel"])
def test_device_fault_is_never_restarted(fault):
    """A fault of the card re-raises at once with zero restarts spent; the
    supervisor's restarts are for broker and transport faults."""
    from fraud_detection_tpu_torch.ops._build import KernelError

    calls = []

    def make_engine():
        calls.append(1)
        if fault == "cuda":
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        raise KernelError("featurize_packed did not launch")

    with pytest.raises((RuntimeError, KernelError)) as ei:
        tengine_mod.run_supervised(make_engine, max_restarts=5, backoff=0.0,
                                   sleep=lambda s: None)
    assert len(calls) == 1
    assert ei.value.supervisor_stats.restarts == 0


def test_failed_incarnation_stops_its_dispatch_lane(pipe):
    """Under async dispatch every incarnation killed with batches in flight
    stops its lane thread and commits none of their offsets: after the
    supervised run no dispatch-lane thread is alive, the delivery
    invariants hold and every minted trace closed."""
    before = {t.ident for t in threading.enumerate()}
    plan = _mixed_plan(tfaults, seed=42)
    tr = RowTracer(worker="w0", sample=1.0, seed=0, capacity=65536)
    broker, stats, _ = _run_chaos(pipe, plan, n=150, rowtrace=tr,
                                  async_dispatch=True)
    assert stats.restarts > 0
    leaked = [t for t in threading.enumerate()
              if t.ident not in before and t.name == "dispatch-lane"]
    assert leaked == []
    _assert_delivery_invariants(broker, 150)
    snap = tr.snapshot()
    assert snap["batches_traced"] == snap["batches_closed"]
    assert snap["spans_begun"] == snap["spans_ended"]


def test_flush_crash_closes_the_failed_batch_trace(pipe):
    """A flush that raises kills the incarnation mid-delivery; the failed
    batch's trace still reaches a terminal (an abort)."""
    plan = tfaults.FaultPlan(seed=0, flush_crash_rate=1.0, max_faults=2,
                             sleep=lambda s: None)
    tr = RowTracer(worker="w0", sample=1.0, seed=0)
    broker, stats, _ = _run_chaos(pipe, plan, n=40, rowtrace=tr)
    assert plan.injected == {"flush_crash": 2} and stats.restarts == 2
    snap = tr.snapshot()
    assert snap["batches_traced"] == snap["batches_closed"]
    aborts = [s for s in tr.ring.snapshot() if s.stage == "abort"]
    assert {s.detail for s in aborts} == {"engine_abort"}
    _assert_delivery_invariants(broker, 40)


# ----------------------------------------------------------------------
# the broker surface supervision touches, and health
# ----------------------------------------------------------------------


def test_broker_commit_assignment_and_seek_equal_jax():
    def drive(broker_cls):
        broker = broker_cls(num_partitions=3)
        _feed(broker, 30)
        c1 = broker.consumer(["in"], "g")
        first = [(m.partition, m.offset) for m in c1.poll_batch(10, 0.01)]
        c1.commit()
        c2 = broker.consumer(["in"], "g")      # rebalance: c1 keeps 2 of 3
        owned = (c1.assignment(), c2.assignment())
        group = broker.group_assignment("g")
        c1.poll_batch(5, 0.01)
        c1.seek_to_committed()
        again = [(m.partition, m.offset) for m in c1.poll_batch(5, 0.01)]
        return (first, owned, sorted(group.values()), again,
                sorted(broker._group_offsets.items()))

    assert drive(InProcessBroker) == drive(JBroker)


def test_health_snapshot_fields_and_monotonic_ages(jpipe, pipe):
    class Clock:
        t = 100.0

        def __call__(self):
            return self.t

    def run(broker_cls, engine_cls, p):
        clock = Clock()
        broker = broker_cls(num_partitions=1)
        prod = broker.producer()
        for i in range(8):
            prod.produce("in", json.dumps({"text": f"message {i}"}).encode(),
                         key=str(i).encode())
        prod.produce("in", b"garbage", key=b"bad")
        engine = engine_cls(p, broker.consumer(["in"], "health"),
                            broker.producer(), "out", batch_size=4,
                            max_wait=0.01, dlq_topic="out-dlq", clock=clock)
        h0 = engine.health()
        clock.t = 105.0
        engine.run(max_messages=9, idle_timeout=0.2)
        h1 = engine.health()
        clock.t = 111.5
        return h0, h1, engine.health()

    th0, th1, th2 = run(InProcessBroker, StreamingClassifier, pipe)
    jh0, jh1, _ = run(JBroker, JEngine, jpipe)
    assert set(th1) == set(jh1)
    assert th0["last_batch_age_sec"] is None and th0["uptime_sec"] == 0.0
    assert th1["uptime_sec"] == 5.0 and th1["last_batch_age_sec"] == 0.0
    assert th1["processed"] == 9 and th1["malformed"] == 1
    assert th1["dlq"]["routed"] == {"malformed": 1}
    assert th1["trace"] is None and th1["alerts"] is None
    assert th2["uptime_sec"] == 11.5 and th2["last_batch_age_sec"] == 6.5


def test_health_reports_flush_failure_streak(pipe):
    class FailingProducer:
        def __init__(self, inner):
            self.inner = inner

        def produce_batch(self, *a, **k):
            self.inner.produce_batch(*a, **k)

        def flush(self, timeout=10.0):
            return 2

    broker = InProcessBroker(num_partitions=1)
    broker.producer().produce("in", json.dumps({"text": "hi"}).encode())
    engine = StreamingClassifier(pipe, broker.consumer(["in"], "ffs"),
                                 FailingProducer(broker.producer()), "out",
                                 batch_size=4, max_wait=0.01)
    engine.run(max_messages=1, idle_timeout=0.2)
    h = engine.health()
    assert h["consecutive_flush_failures"] == 1
    assert h["processed"] == 0


# Exact key set of AsyncAnnotationLane.stats() — the health() "annotations"
# block. A module-level dict literal (not inline in the assert) so the
# flightcheck health-schema lint (analysis/health.py, FC301) can cross-check
# the producer against it statically.
ANNOTATION_STATS_SCHEMA = {
    "submitted": (int,),
    "annotated": (int,),
    "dropped": (int,),
    "drop_records": (int,),
    "backend_errors": (int,),
    "queue_depth": (int,),
}


def test_health_annotation_lane_counters(pipe):
    from tests.test_chaos import ANNOTATION_STATS_SCHEMA as JSCHEMA

    assert set(ANNOTATION_STATS_SCHEMA) == set(JSCHEMA)
    broker = InProcessBroker(num_partitions=1)
    _feed(broker, 20)
    engine = StreamingClassifier(
        pipe, broker.consumer(["in"], "hal"), broker.producer(), "out",
        batch_size=8, max_wait=0.01,
        explain_batch_fn=lambda t, l, c: ["a"] * len(t),
        explain_async=True, annotations_producer=broker.producer())
    engine.run(max_messages=20, idle_timeout=0.2)
    engine.close_annotations(timeout=10.0)
    h = engine.health()
    assert h["annotations"] is not None
    assert set(h["annotations"]) == set(ANNOTATION_STATS_SCHEMA)
    for key, types in ANNOTATION_STATS_SCHEMA.items():
        assert isinstance(h["annotations"][key], types), key
    assert h["annotations"]["queue_depth"] == 0
