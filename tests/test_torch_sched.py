"""The port's adaptive scheduler against the JAX package's.

On the same scripted inputs and injected clocks, the token bucket, the
admission controller (every shed policy), the ladders, the governor and the
SLO tracker must decide exactly as the JAX package's do; the dispatch lane
keeps FIFO order and re-raises a lane-side error at its batch's position.
"""

import threading
from dataclasses import dataclass

import numpy as np
import pytest

from fraud_detection_tpu import sched as J
from fraud_detection_tpu.sched import admission as Jadm
from fraud_detection_tpu_torch import sched as T
from fraud_detection_tpu_torch.sched import admission as Tadm


class Clock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@dataclass
class Msg:
    i: int
    timestamp: float = 0.0


def _ids(pairs):
    kept, shed = pairs
    return [m.i for m in kept], [(m.i, r) for m, r in shed]


def test_token_bucket_grants_equal_jax():
    rng = np.random.default_rng(0)
    script = [(float(dt), int(n), bool(g)) for dt, n, g in zip(
        rng.exponential(0.02, 200), rng.integers(0, 120, 200),
        rng.random(200) < 0.7)]
    out = []
    for mod in (J, T):
        clock = Clock()
        bucket = mod.TokenBucket(1000.0, 300.0, clock=clock)
        got = []
        for dt, n, grant in script:
            clock.t += dt
            got.append(bucket.grant(n) if grant else round(bucket.drain(n), 12))
            got.append(round(bucket.available, 9))
        out.append(got)
    assert out[0] == out[1]


def _admission(mod, adm_mod, policy, clock, wall):
    slo = mod.SloTracker(target_p99_ms=50.0 if policy == "adaptive" else None,
                         window_sec=1.0, clock=clock)
    bucket = mod.TokenBucket(500.0, 200.0, clock=clock)
    ctl = adm_mod.AdmissionController(
        policy, max_queue=None if policy == "none" else 300, bucket=bucket,
        slo=slo, wall=wall)
    return ctl, slo


@pytest.mark.parametrize("policy", Jadm.SHED_POLICIES)
def test_admission_decisions_equal_jax(policy):
    assert Tadm.SHED_POLICIES == Jadm.SHED_POLICIES
    rng = np.random.default_rng(1)
    steps = []
    for k in range(60):
        n = int(rng.integers(1, 90))
        ages = rng.exponential(0.02, n) * (3 if k % 7 == 0 else 1)
        lat = rng.exponential(0.03 if k < 30 else 0.01, int(rng.integers(1, 40)))
        steps.append((float(rng.exponential(0.05)), n, ages,
                      int(rng.integers(0, 900)) if k % 5 else None, lat))
    results = []
    for mod, adm_mod in ((J, Jadm), (T, Tadm)):
        clock, wall = Clock(), Clock(1.7e9)
        ctl, slo = _admission(mod, adm_mod, policy, clock, wall)
        got = []
        for dt, n, ages, backlog, lat in steps:
            clock.t += dt
            wall.t += dt
            msgs = [Msg(i, wall.t - a if i % 9 else 0.0)
                    for i, a in enumerate(ages)]
            got.append(_ids(ctl.admit(msgs, backlog)))
            got.append(round(ctl.pending_pause(), 12))
            slo.record(lat)
            snap = ctl.snapshot()
            snap["tokens_available"] = None     # read at a later instant
            got.append(snap)
        results.append(got)
    assert results[0] == results[1]
    if policy != "none":
        assert any(shed for kept, shed in results[1][::3])


def test_ladders_equal_jax():
    for b in (1, 16, 17, 64, 100, 256, 1000, 1024, 4096):
        assert T.default_ladder(b) == J.default_ladder(b)
        assert T.ladder_candidates(b) == J.ladder_candidates(b)
        for f, lv in ((2, 4), (8, 2)):
            assert T.default_ladder(b, f, lv) == J.default_ladder(b, f, lv)
    ladder = T.default_ladder(1024)
    for n in (0, 1, 63, 64, 65, 255, 256, 1023, 1024, 5000):
        assert T.batcher.bucket_for(n, ladder) == \
            J.batcher.bucket_for(n, ladder)
    rng = np.random.default_rng(2)
    for trial in range(40):
        rungs = J.ladder_candidates(int(rng.choice([64, 256, 1024])))
        base = rng.uniform(1e-4, 5e-3)
        costs = {b: base + rng.uniform(0, 2e-6) * b * trial for b in rungs}
        for ratio in (1.1, 1.25, 2.0):
            assert T.cost_aware_ladder(costs, max(rungs), ratio) == \
                J.cost_aware_ladder(costs, max(rungs), ratio)
    with pytest.raises(ValueError):
        T.cost_aware_ladder({}, 64)


def test_governor_advice_equal_jax():
    rng = np.random.default_rng(3)
    out = []
    for mod in (J, T):
        gov = mod.BackpressureGovernor(0.05, min_budget=64)
        got = []
        for _ in range(100):
            gov.observe(int(rng.integers(0, 1024)), float(rng.exponential(0.04)))
            got.append(gov.advise(1024, float(rng.exponential(0.3))))
        got.append(gov.snapshot())
        out.append(got)
        rng = np.random.default_rng(3)
    assert out[0] == out[1]


def test_slo_tracker_equal_jax():
    rng = np.random.default_rng(4)
    script = [(float(rng.uniform(0, 3)), rng.exponential(0.02, int(rng.integers(0, 50))))
              for _ in range(80)]
    out = []
    for mod in (J, T):
        clock = Clock()
        slo = mod.SloTracker(target_p99_ms=40.0, window_sec=5.0, clock=clock)
        got = [slo.p99_ms(), slo.over_target()]
        for dt, lat in script:
            clock.t += dt
            slo.record(lat)
            got += [slo.p99_ms(), slo.over_target(), slo.snapshot()]
        out.append(got)
    assert out[0] == out[1]
    assert T.SloTracker().over_target() is None


_BAD_CONFIGS = [dict(shed_policy="drop"), dict(batch_deadline_ms=0),
                dict(max_queue=0), dict(target_p99_ms=-1), dict(max_rate=0),
                dict(shed_policy="adaptive"), dict(shed_policy="reject"),
                dict(window_sec=0), dict(cost_ratio=1.0)]


@pytest.mark.parametrize("kw", _BAD_CONFIGS)
def test_scheduler_config_refusals_equal_jax(kw):
    with pytest.raises(ValueError) as je:
        J.SchedulerConfig(**kw)
    with pytest.raises(ValueError) as te:
        T.SchedulerConfig(**kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kw", [
    {}, dict(target_p99_ms=300), dict(batch_deadline_ms=5, max_rate=2000.0),
    dict(shed_policy="adaptive", target_p99_ms=80, max_queue=500)])
def test_scheduler_defaults_equal_jax(kw):
    """The game-day knobs (SLO window, cost-aware ladder and its cost
    ratio, token burst, batch-wall bound) default to the JAX config's
    values: a fresh scheduler reports what JAX's reports."""
    jcfg = J.SchedulerConfig(**kw)
    tcfg = T.SchedulerConfig(**kw)
    fields = ("window_sec", "cost_ratio", "cost_aware", "burst",
              "max_batch_sec")
    assert ([getattr(tcfg, f) for f in fields]
            == [getattr(jcfg, f) for f in fields])
    assert tcfg.resolved_max_batch_sec() == jcfg.resolved_max_batch_sec()
    snaps = []
    for mod, cfg in ((J, jcfg), (T, tcfg)):
        sched = mod.AdaptiveScheduler(cfg, 1024, clock=Clock())
        snap = sched.snapshot()
        snap["admission"]["tokens_available"] = None
        snaps.append((snap, sched.admission.bucket and
                      sched.admission.bucket.burst))
    assert snaps[0] == snaps[1]


class _Consumer:
    """Scripted consumer: each poll returns the next scripted slice and
    advances the injected clock by the poll's timeout."""

    def __init__(self, script, clock):
        self.script, self.clock, self.calls = list(script), clock, []

    def poll_batch(self, n, timeout):
        self.calls.append((n, round(timeout, 9)))
        self.clock.t += timeout if not self.script or not self.script[0] else 0.001
        got = self.script.pop(0) if self.script else []
        return got[:n]


def test_dynamic_batcher_collect_equal_jax():
    script = [[1, 2, 3], [], [4], [5, 6, 7, 8], [], [], [9], [10] * 40]
    out = []
    for mod in (J, T):
        clock = Clock()
        consumer = _Consumer(script, clock)
        batcher = mod.DynamicBatcher(20.0, clock=clock)
        got = [list(batcher.collect(consumer, 16, 0.05)) for _ in range(4)]
        out.append((got, consumer.calls))
    assert out[0] == out[1]


def test_dispatch_lane_is_fifo_and_reraises_in_place():
    done = threading.Event()

    def launch(i):
        if i == 3:
            raise KeyError("lane-side failure")
        if i == 0:
            done.wait(2.0)          # the first batch is the slowest
        return i * 10

    lane = T.DispatchLane(launch, depth=2)
    try:
        for i in range(6):
            lane.submit(i)
        done.set()
        assert [lane.next(timeout=5.0) for _ in range(3)] == [0, 10, 20]
        with pytest.raises(KeyError, match="lane-side failure"):
            lane.next(timeout=5.0)
        assert [lane.next(timeout=5.0) for _ in range(2)] == [40, 50]
        assert lane.pending == 0
        stats = lane.stats()
        assert stats["submitted"] == stats["launched"] == 6
        assert stats["max_inflight"] == 6
    finally:
        lane.stop()
    assert not lane._thread.is_alive()
    with pytest.raises(RuntimeError):
        lane.submit(7)


# ---------------------------------------------------------------------------
# health contract (the sched block)
# ---------------------------------------------------------------------------

# Module-level dict literals so flightcheck's health-schema lint
# (analysis/health.py, FC301) checks the producers against them statically:
# the JAX contract tests' schemas, key for key.
SCHED_BLOCK_SCHEMA = {
    "batch_deadline_ms": (type(None), int, float),
    "buckets": (list,),
    "ladder_cost_ms": (type(None), dict),   # measured at prewarm; None before
    "slo": (dict,),
    "admission": (dict,),
    "governor": (dict,),
}

SLO_BLOCK_SCHEMA = {
    "count": (int,),
    "p50_ms": (type(None), int, float),
    "p95_ms": (type(None), int, float),
    "p99_ms": (type(None), int, float),
    "mean_ms": (type(None), int, float),
    "max_ms": (type(None), int, float),
    "target_p99_ms": (type(None), int, float),
    "window_sec": (int, float),
}

ADMISSION_BLOCK_SCHEMA = {
    "policy": (str,),
    "max_queue": (type(None), int),
    "rate_limit": (type(None), int, float),
    "tokens_available": (type(None), int, float),
    "shed_fraction": (int, float),
    "shed": (dict,),
    "backlog": (type(None), int),
}

GOVERNOR_BLOCK_SCHEMA = {
    "max_batch_sec": (type(None), int, float),
    "ewma_batch_ms": (type(None), int, float),
    "ewma_row_us": (type(None), int, float),
    "budget_caps": (int,),
    "paused_sec": (int, float),
}


def _assert_schema(obj, schema, where):
    assert set(obj) == set(schema), (
        f"{where}: keys changed — update the schema test AND the pollers "
        f"(extra: {set(obj) - set(schema)}, missing: {set(schema) - set(obj)})")
    for key, types in schema.items():
        assert isinstance(obj[key], types), (where, key, type(obj[key]))


def test_health_sched_block_contract():
    """The sched block of the port engine's health() has the reference's
    exact key set and types, its SLO, admission and governor blocks too."""
    import json

    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from fraud_detection_tpu_torch.stream import (InProcessBroker,
                                                  StreamingClassifier)
    from tests import test_sched as jtests
    from tests.test_torch_registry import const_model, make_featurizer

    for name in ("SCHED_BLOCK_SCHEMA", "SLO_BLOCK_SCHEMA",
                 "ADMISSION_BLOCK_SCHEMA", "GOVERNOR_BLOCK_SCHEMA"):
        assert set(globals()[name]) == set(getattr(jtests, name)), name
    pipe = ServingPipeline(make_featurizer(), const_model(-8.0),
                           batch_size=32, device="cpu")
    broker = InProcessBroker()
    feeder = broker.producer()
    for i in range(40):
        feeder.produce("in", json.dumps({"text": f"row {i}"}).encode(),
                       key=str(i).encode())
    sched = T.AdaptiveScheduler(
        T.SchedulerConfig(batch_deadline_ms=20.0, shed_policy="reject",
                          max_queue=1000, target_p99_ms=500.0, max_rate=1e6),
        batch_size=32)
    engine = StreamingClassifier(pipe, broker.consumer(["in"], "g"),
                                 broker.producer(), "out", batch_size=32,
                                 max_wait=0.01, scheduler=sched,
                                 dlq_topic="out-dlq")
    engine.run(max_messages=40, idle_timeout=1.0)
    h = engine.health()
    _assert_schema(h["sched"], SCHED_BLOCK_SCHEMA, "sched")
    _assert_schema(h["sched"]["slo"], SLO_BLOCK_SCHEMA, "sched.slo")
    _assert_schema(h["sched"]["admission"], ADMISSION_BLOCK_SCHEMA,
                   "sched.admission")
    _assert_schema(h["sched"]["governor"], GOVERNOR_BLOCK_SCHEMA,
                   "sched.governor")
    assert h["sched"]["slo"]["count"] == 40
    json.dumps(h)
