"""The port's model lifecycle under the streaming engine (``registry/``
hotswap, shadow, promote; the engine's ``shadow=`` hook and ``model`` health
block; the serve CLI's lifecycle flags) on the CPU, against the JAX package.

* The reference's hot-swap tests run on the port: a swap under a running
  engine drops no message and reorders none, and a candidate is warmed
  before it is published to readers.
* The shadow scorer fed the same primary and candidate labels and
  probabilities as the JAX scorer gives the same snapshot: counts and
  histograms exact, PSI, agreement and |dp| within SHADOW_TOL; it never
  blocks the primary.
* ``PromotionPolicy.parse``/``evaluate`` give the JAX decisions (action and
  reasons) on the same snapshots; promotion, rejection and rollback run
  through the controller with the reference's audit trail.
* ``health()["model"]`` has the JAX engine's keys; the serve CLI's
  registry/watch/shadow/promote flow runs, and its flag checks refuse with
  the JAX CLI's messages.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from fraud_detection_tpu.models.pipeline import PredictionBatch as JBatch
from fraud_detection_tpu.registry import PromotionPolicy as JPolicy
from fraud_detection_tpu.registry import ShadowScorer as JShadow
from fraud_detection_tpu.registry import shadow as jshadow
from fraud_detection_tpu_torch.models.pipeline import (PredictionBatch,
                                                       ServingPipeline)
from fraud_detection_tpu_torch.registry import (HotSwapPipeline,
                                                LifecycleController,
                                                ModelRegistry, PromotionPolicy,
                                                ShadowScorer)
from fraud_detection_tpu_torch.registry import shadow as pshadow
from fraud_detection_tpu_torch.stream import (InProcessBroker,
                                              StreamingClassifier)
from tests.test_torch_registry import const_model, make_featurizer

SHADOW_TOL = 1e-6    # PSI, agreement and mean |dp|, port vs JAX

IN_TOPIC = "customer-dialogues-raw"
OUT_TOPIC = "dialogues-classified"


def feed(broker, keys, text="hello this is a perfectly ordinary dialogue"):
    producer = broker.producer()
    for k in keys:
        producer.produce(IN_TOPIC,
                         json.dumps({"text": text, "id": k}).encode(),
                         key=str(k).encode())


def make_engine(broker, pipeline, **kwargs):
    return StreamingClassifier(
        pipeline, broker.consumer([IN_TOPIC], "lifecycle-test"),
        broker.producer(), OUT_TOPIC, max_wait=0.01, **kwargs)


def wait_until(predicate, timeout=20.0, interval=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def cpu_pipe(logit, batch_size=16):
    return ServingPipeline(make_featurizer(), const_model(logit),
                           batch_size=batch_size, device="cpu")


# ---------------------------------------------------------------------------
# hot swap under a running engine
# ---------------------------------------------------------------------------

def test_hot_swap_mid_stream_zero_loss_no_reorder(tmp_path):
    """Stream 300 keyed messages; publish v2 mid-run and swap it in with
    watch semantics while the engine keeps consuming. Every key delivered
    exactly once, per-partition order preserved, frames after the swap
    score with the NEW model, and health() reports the new active version."""
    feat = make_featurizer()
    registry = ModelRegistry(str(tmp_path / "registry"))
    registry.publish(feat, const_model(-8.0))   # v1: everything benign
    _, v1_pipe = registry.load(1, batch_size=32, device="cpu")
    hot = HotSwapPipeline(v1_pipe, version=1)
    controller = LifecycleController(registry, hot, batch_size=32)

    broker = InProcessBroker(num_partitions=3)
    engine = make_engine(broker, hot, batch_size=32)
    phase1 = list(range(150))
    phase2 = list(range(150, 300))
    feed(broker, phase1)

    thread = threading.Thread(
        target=lambda: engine.run(max_messages=300, idle_timeout=20.0),
        daemon=True)
    thread.start()
    assert wait_until(lambda: engine.stats.processed >= 150), \
        "engine never finished phase 1"

    registry.publish(feat, const_model(8.0))    # v2: everything scam
    events = controller.tick()
    assert [e["event"] for e in events] == ["promote"]
    assert hot.active_version == 2 and hot.swaps == 1
    # The candidate loads on the active pipeline's device.
    assert hot.active_pipeline.device == torch.device("cpu")

    feed(broker, phase2)
    thread.join(timeout=30)
    assert not thread.is_alive()
    assert engine.stats.processed == 300

    outs = broker.messages(OUT_TOPIC)
    out_keys = [m.key for m in outs]
    assert len(out_keys) == 300
    assert set(out_keys) == {str(k).encode() for k in range(300)}
    for p in range(3):
        in_order = [m.key for m in broker.messages(IN_TOPIC)
                    if m.partition == p]
        out_order = [m.key for m in outs if m.partition == p]
        assert out_order == in_order

    by_key = {m.key: json.loads(m.value) for m in outs}
    assert all(by_key[str(k).encode()]["prediction"] == 0 for k in phase1)
    assert all(by_key[str(k).encode()]["prediction"] == 1 for k in phase2)

    health = engine.health()
    assert health["model"]["active_version"] == 2
    assert health["model"]["swaps"] == 1
    assert health["model"]["staged_version"] is None
    assert health["model"]["shadow"] is None

    events = registry.read_audit()
    assert [e["event"] for e in events] == ["publish", "publish", "promote"]
    assert events[-1]["version"] == 2 and events[-1]["previous"] == 1


def test_prewarm_runs_before_swap():
    """swap() must score a dummy batch through the candidate BEFORE
    publishing it to readers, and pin it (once per version)."""
    v1, v2 = cpu_pipe(-8.0), cpu_pipe(8.0)
    calls = []
    original = v2.predict

    def spying_predict(texts):
        calls.append((len(texts), hot.active_version))
        return original(texts)

    v2.predict = spying_predict
    hot = HotSwapPipeline(v1, version=1)
    assert hot.swap(v2, version=2) == 1
    assert calls and calls[0][0] > 0, "candidate was not pre-warmed"
    assert calls[0][1] == 1, "candidate was published before its prewarm"
    assert hot.active_version == 2
    assert v2.device_stats.pins == 1
    assert hot.predict_one("anything")[0] == 1


def test_stage_promote_discard_and_ladder():
    hot = HotSwapPipeline(cpu_pipe(-8.0), version=1)
    hot.configure_ladder([16, 4], prewarm=False, costs={4: 0.1, 16: 0.2})
    assert hot.pad_buckets == (4, 16)
    assert hot.active_pipeline.pad_ladder == (4, 16)
    assert hot.ladder_costs == {4: 0.1, 16: 0.2}
    cand = cpu_pipe(8.0)
    hot.stage(cand, version=2)
    assert cand.pad_ladder == (4, 16)     # every candidate adopts the ladder
    assert hot.staged_version == 2 and hot.active_version == 1
    assert hot.promote_staged() == 2
    assert hot.active_version == 2 and hot.staged_version is None
    hot.stage(cpu_pipe(-8.0), version=3)
    assert hot.discard_staged() == 3 and hot.staged_version is None
    with pytest.raises(RuntimeError, match="no staged candidate"):
        hot.promote_staged()
    snap = hot.lifecycle_snapshot()
    assert snap["active_version"] == 2 and snap["swaps"] == 1
    assert snap["last_swap_age_sec"] >= 0.0
    assert hot.batch_size == 16 and hot.device == torch.device("cpu")


def test_scheduler_prewarm_hands_the_ladder_to_hotswap():
    """The adaptive scheduler measures on the active pipeline and the
    HotSwapPipeline keeps ladder and cost table for later candidates."""
    from fraud_detection_tpu_torch.sched import (AdaptiveScheduler,
                                                 SchedulerConfig)

    hot = HotSwapPipeline(cpu_pipe(-8.0, batch_size=64), version=1)
    sched = AdaptiveScheduler(SchedulerConfig(batch_deadline_ms=5.0), 64)
    sched.prewarm(hot)
    assert hot.pad_buckets == tuple(sched.buckets)
    assert set(hot.ladder_costs) == set(sched.ladder_costs)
    cand = cpu_pipe(8.0, batch_size=64)
    hot.stage(cand, version=2)
    assert cand.pad_ladder == hot.pad_buckets


# ---------------------------------------------------------------------------
# shadow scoring
# ---------------------------------------------------------------------------

class FixedCandidate:
    """A candidate whose outputs are given: batch i returns labels[i] and
    probs[i] (the same for the JAX and the port scorer)."""

    def __init__(self, outputs, batch_cls):
        self.outputs = list(outputs)
        self.batch_cls = batch_cls

    def predict(self, texts):
        labels, probs = self.outputs.pop(0)
        return self.batch_cls(np.asarray(labels, np.int32),
                              np.asarray(probs, np.float32))


def _random_batches(seed, n_batches=12, rows=24):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        p_probs = rng.random(rows).astype(np.float32)
        c_probs = np.clip(p_probs + rng.normal(0, 0.2, rows), 0, 1).astype(
            np.float32)
        c_probs[:2] = (0.0, 1.0)                 # the histogram's end bins
        out.append(((p_probs > 0.5).astype(np.int32), p_probs,
                    (c_probs > 0.5).astype(np.int32), c_probs))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shadow_snapshot_equals_jax(seed):
    batches = _random_batches(seed)
    snaps = []
    for scorer_cls, batch_cls in ((JShadow, JBatch),
                                  (ShadowScorer, PredictionBatch)):
        sh = scorer_cls(max_queue=64, window_batches=5)
        try:
            sh.set_candidate(FixedCandidate([(b[2], b[3]) for b in batches],
                                            batch_cls), version=7)
            for p_labels, p_probs, _, _ in batches:
                assert sh.submit(["t"] * len(p_labels), p_labels, p_probs,
                                 raw=False)
            assert sh.drain(20.0)
            snaps.append(sh.snapshot())
        finally:
            sh.close(10.0)
    want, got = snaps
    assert set(got) == set(want) and set(got["window"]) == set(want["window"])
    for key in ("candidate_version", "batches", "rows", "disagreed",
                "dropped", "errors", "sampled_out", "queue_depth", "sample",
                "score_hist_primary", "score_hist_candidate"):
        assert got[key] == want[key], key
    for key in ("agreement_rate", "mean_abs_dp", "flag_rate_primary",
                "flag_rate_candidate", "flag_rate_delta", "psi"):
        assert got[key] == pytest.approx(want[key], abs=SHADOW_TOL), key
    for key in ("batches", "max_batches", "rows"):
        assert got["window"][key] == want["window"][key], key
    for key in ("agreement_rate", "mean_abs_dp", "psi"):
        assert got["window"][key] == pytest.approx(want["window"][key],
                                                   abs=SHADOW_TOL), key


def test_score_histogram_and_psi_equal_jax():
    rng = np.random.default_rng(5)
    probs = np.concatenate([rng.random(500), [0.0, 1.0, 0.05, 0.95, 0.5]])
    for n_bins in (20, 7):
        np.testing.assert_array_equal(
            pshadow.score_histogram(probs, n_bins),
            jshadow.score_histogram(probs, n_bins))
    assert pshadow.score_histogram(np.empty(0)).tolist() == [0.0] * 20
    e, o = rng.integers(0, 50, 20), rng.integers(0, 50, 20)
    assert pshadow.population_stability_index(e, o) == pytest.approx(
        jshadow.population_stability_index(e, o), abs=SHADOW_TOL)
    assert pshadow.population_stability_index(np.zeros(3), o[:3]) == 0.0


class SlowPipeline:
    """Candidate whose scorer is artificially slowed — the overload case
    the bounded queue exists for."""

    def __init__(self, inner, delay=0.25):
        self.inner = inner
        self.delay = delay

    def predict(self, texts):
        time.sleep(self.delay)
        return self.inner.predict(texts)


def test_shadow_never_blocks_primary():
    """With a candidate ~25x slower than a batch, the primary stream must
    finish at its own rate: the shadow queue DROPS what it cannot hold
    (counted in health()), and submit never blocks."""
    hot = HotSwapPipeline(cpu_pipe(-8.0, 32), version=1)
    shadow = ShadowScorer(max_queue=1)
    shadow.set_candidate(SlowPipeline(cpu_pipe(-8.0, 32)), version=2)
    broker = InProcessBroker(num_partitions=3)
    feed(broker, range(320))
    engine = make_engine(broker, hot, batch_size=32, shadow=shadow)
    t0 = time.perf_counter()
    stats = engine.run(max_messages=320, idle_timeout=5.0)
    elapsed = time.perf_counter() - t0
    try:
        assert stats.processed == 320
        assert elapsed < 2.0, f"primary path was blocked ({elapsed:.2f}s)"
        snap = engine.health()["model"]["shadow"]
        assert snap["candidate_version"] == 2
        assert snap["dropped"] > 0, "bounded queue never dropped under overload"
    finally:
        shadow.close(timeout=10.0)


def test_shadow_divergence_errors_and_raw_payloads():
    primary = cpu_pipe(-8.0)
    shadow = ShadowScorer(max_queue=4)
    try:
        shadow.set_candidate(primary, version=2)
        texts = ["ordinary dialogue one", "ordinary dialogue two"]
        payloads = [json.dumps({"text": t}).encode() for t in texts]
        payloads.append(b"not json at all")
        preds = primary.predict(texts + ["padding row"])
        shadow.submit(payloads, preds.labels, preds.probabilities, raw=True)
        assert shadow.drain(10.0)
        snap = shadow.snapshot()
        assert snap["rows"] == 2 and snap["agreement_rate"] == 1.0
        assert snap["psi"] == pytest.approx(0.0, abs=1e-6)

        class Exploding:
            def predict(self, texts):
                raise RuntimeError("candidate broken")

        shadow.set_candidate(Exploding(), version=3)
        shadow.submit(texts, preds.labels[:2], preds.probabilities[:2],
                      raw=False)
        assert shadow.drain(10.0)
        assert shadow.snapshot()["errors"] == 1 and shadow.fault is None
    finally:
        shadow.close(timeout=10.0)


def test_shadow_stops_on_a_device_fault():
    """A fault of the card is not a broken candidate: the worker records it
    and stops instead of counting it and carrying on."""
    from fraud_detection_tpu_torch.ops._build import KernelError

    class Faulting:
        def predict(self, texts):
            raise KernelError("histogram kernel launch failed: cudaError 700")

    shadow = ShadowScorer(max_queue=4)
    try:
        shadow.set_candidate(Faulting(), version=2)
        shadow.submit(["t"], np.zeros(1, np.int32), np.zeros(1), raw=False)
        assert wait_until(lambda: shadow.fault is not None, timeout=10.0)
        assert isinstance(shadow.fault, KernelError)
    finally:
        shadow.close(timeout=2.0)


# ---------------------------------------------------------------------------
# promotion policy
# ---------------------------------------------------------------------------

POLICY_SPEC = ("min_batches=2,min_rows=20,max_disagreement=0.02,"
               "max_psi=0.25,max_flag_rate_delta=0.10")


def _snapshots(seed=0, n=40):
    rng = np.random.default_rng(seed)
    # (the reference formats the agreement rate of any snapshot past the
    # evidence gate, so each such snapshot carries one, as real ones do)
    out = [{"batches": 1, "rows": 500},
           {"batches": 10, "rows": 5, "agreement_rate": 1.0},
           {"batches": 10, "rows": 500, "agreement_rate": 1.0, "psi": 0.0,
            "flag_rate_delta": 0.0},
           {"batches": 10, "rows": 500, "agreement_rate": 0.9, "psi": 0.3,
            "flag_rate_delta": -0.2},
           {"batches": 10, "rows": 500, "agreement_rate": 0.995, "psi": None,
            "flag_rate_delta": None}]
    for _ in range(n):
        out.append({"batches": int(rng.integers(0, 8)),
                    "rows": int(rng.integers(0, 400)),
                    "agreement_rate": float(rng.uniform(0.95, 1.0)),
                    "psi": float(rng.uniform(0.0, 0.4)),
                    "flag_rate_delta": float(rng.uniform(-0.15, 0.15))})
    return out


@pytest.mark.parametrize("spec", [POLICY_SPEC, "", "require_healthy=false",
                                  "min_rows=0,max_psi=0.1"])
def test_policy_decisions_equal_jax(spec):
    jp, pp = JPolicy.parse(spec), PromotionPolicy.parse(spec)
    assert pp.__dict__ == jp.__dict__
    for health in (None, {"consecutive_flush_failures": 0},
                   {"consecutive_flush_failures": 2}):
        for snap in _snapshots():
            want, got = jp.evaluate(snap, health), pp.evaluate(snap, health)
            assert (got.action, got.reasons) == (want.action, want.reasons)
            assert str(got) == str(want)


@pytest.mark.parametrize("spec", ["max_psl=0.5", "min_batches", "min_rows=x"])
def test_policy_parse_errors_equal_jax(spec):
    with pytest.raises(ValueError) as je:
        JPolicy.parse(spec)
    with pytest.raises(ValueError) as pe:
        PromotionPolicy.parse(spec)
    assert str(pe.value) == str(je.value)


def _shadow_rounds(shadow, hot, n_batches=3, n_rows=16):
    texts = ["a perfectly ordinary dialogue about appointments"] * n_rows
    for _ in range(n_batches):
        preds = hot.predict(texts)
        shadow.submit(texts, preds.labels, preds.probabilities, raw=False)
    assert shadow.drain(10.0)


@pytest.mark.parametrize("logit,outcome", [(-8.0, "promote"),
                                           (8.0, "reject")])
def test_policy_promotes_or_rejects_staged_candidate(tmp_path, logit, outcome):
    feat = make_featurizer()
    registry = ModelRegistry(str(tmp_path / "registry"))
    registry.publish(feat, const_model(-8.0))
    _, v1 = registry.load(1, batch_size=16, device="cpu")
    hot = HotSwapPipeline(v1, version=1)
    shadow = ShadowScorer(max_queue=8)
    controller = LifecycleController(registry, hot, shadow=shadow,
                                     policy=PromotionPolicy.parse(POLICY_SPEC),
                                     batch_size=16)
    try:
        registry.publish(feat, const_model(logit))
        assert [e["event"] for e in controller.tick()] == ["stage"]
        assert hot.staged_version == 2 and hot.active_version == 1
        assert shadow.candidate_version == 2
        assert controller.tick() == []      # not enough evidence: wait
        _shadow_rounds(shadow, hot)
        events = controller.tick()
        assert [e["event"] for e in events] == [outcome]
        assert hot.staged_version is None and not shadow.active
        if outcome == "promote":
            assert events[0]["mode"] == "shadow"
            assert events[0]["shadow"]["agreement_rate"] == 1.0
            assert "score_hist_primary" not in events[0]["shadow"]
            assert hot.active_version == 2
        else:
            assert "disagreement" in " ".join(events[0]["reasons"])
            assert hot.active_version == 1
        assert [e["event"] for e in registry.read_audit()] == [
            "publish", "publish", "stage", outcome]
    finally:
        shadow.close(timeout=10.0)


def test_rollback_restores_prior_version(tmp_path):
    feat = make_featurizer()
    registry = ModelRegistry(str(tmp_path / "registry"))
    registry.publish(feat, const_model(-8.0))
    registry.publish(feat, const_model(8.0))
    _, v2 = registry.load(2, batch_size=16, device="cpu")
    hot = HotSwapPipeline(v2, version=2)
    hot.stage(cpu_pipe(8.0), version=3)
    seen = []
    controller = LifecycleController(registry, hot, batch_size=16,
                                     on_transition=seen.append)
    assert hot.predict_one("anything")[0] == 1
    record = controller.rollback(1)
    assert hot.active_version == 1 and hot.staged_version is None
    assert hot.predict_one("anything")[0] == 0
    assert record["event"] == "rollback" and record["previous"] == 2
    assert record["discarded_staged"] == 3
    assert seen == [record] and registry.read_audit()[-1] == record


def test_corrupt_publish_is_audited_and_skipped(tmp_path):
    feat = make_featurizer()
    registry = ModelRegistry(str(tmp_path / "registry"))
    registry.publish(feat, const_model(-8.0))
    _, v1 = registry.load(1, batch_size=16, device="cpu")
    hot = HotSwapPipeline(v1, version=1)
    controller = LifecycleController(registry, hot, batch_size=16)
    mv = registry.publish(feat, const_model(8.0))
    with open(mv.checkpoint_path + "/arrays.npz", "ab") as fh:
        fh.write(b"tamper")
    events = controller.tick()
    assert [e["event"] for e in events] == ["load_failed"]
    assert "bytes" in events[0]["error"] and hot.active_version == 1


def test_watcher_thread_stops_on_a_device_fault(tmp_path):
    """Registry faults are logged and the watcher keeps polling; a fault of
    the card stops it and stays in ``fault``."""
    from fraud_detection_tpu_torch.ops._build import KernelError

    feat = make_featurizer()
    registry = ModelRegistry(str(tmp_path / "registry"))
    registry.publish(feat, const_model(-8.0))
    hot = HotSwapPipeline(cpu_pipe(-8.0), version=1)
    controller = LifecycleController(registry, hot, batch_size=16)
    ticks = []

    def tick():
        ticks.append(1)
        if len(ticks) == 1:
            raise ValueError("a bad manifest")
        raise KernelError("best_splits kernel launch failed: cudaError 700")

    controller.tick = tick
    thread, stop = controller.run_in_thread(interval=0.01)
    thread.join(timeout=10.0)
    stop.set()
    assert not thread.is_alive() and len(ticks) == 2
    assert isinstance(controller.fault, KernelError)


# ---------------------------------------------------------------------------
# health() blocks: the JAX engine's keys
# ---------------------------------------------------------------------------

def _jax_model_block():
    from fraud_detection_tpu.models.pipeline import ServingPipeline as JPipe
    from fraud_detection_tpu.registry import HotSwapPipeline as JHot
    from fraud_detection_tpu.stream import InProcessBroker as JBroker
    from fraud_detection_tpu.stream import StreamingClassifier as JEngine
    from tests.test_registry import const_model as jconst
    from tests.test_registry import make_featurizer as jfeat

    pipe = JPipe(jfeat(), jconst(-8.0), batch_size=16)
    shadow = JShadow(max_queue=4)
    try:
        shadow.set_candidate(JPipe(jfeat(), jconst(-8.0), batch_size=16), 2)
        broker = JBroker()
        feed(broker, range(16))
        engine = JEngine(JHot(pipe, version=1),
                         broker.consumer([IN_TOPIC], "g"), broker.producer(),
                         OUT_TOPIC, batch_size=16, max_wait=0.01,
                         shadow=shadow)
        engine.run(max_messages=16, idle_timeout=2.0)
        assert shadow.drain(10.0)
        return engine.health()
    finally:
        shadow.close(10.0)


def test_health_model_block_has_the_jax_keys():
    want = _jax_model_block()
    shadow = ShadowScorer(max_queue=4)
    try:
        shadow.set_candidate(cpu_pipe(-8.0), version=2)
        broker = InProcessBroker()
        feed(broker, range(16))
        engine = make_engine(broker, HotSwapPipeline(cpu_pipe(-8.0), 1),
                             batch_size=16, shadow=shadow)
        engine.run(max_messages=16, idle_timeout=2.0)
        assert shadow.drain(10.0)
        got = engine.health()
    finally:
        shadow.close(10.0)
    assert set(got["model"]) == set(want["model"])
    assert set(got["model"]["shadow"]) == set(want["model"]["shadow"])
    assert set(got["model"]["shadow"]["window"]) == set(
        want["model"]["shadow"]["window"])
    assert got["model"]["active_version"] == 1
    assert got["model"]["shadow"]["rows"] == want["model"]["shadow"]["rows"] == 16
    assert got["learn"] is None and want["learn"] is None
    json.dumps(got)


def test_health_model_block_none_rules():
    """A plain pipeline has no model block; a shadow without a hot-swap
    holder gets the reference's placeholder versions."""
    broker = InProcessBroker()
    feed(broker, range(16))
    engine = make_engine(broker, cpu_pipe(-8.0), batch_size=16)
    engine.run(max_messages=16, idle_timeout=2.0)
    assert engine.health()["model"] is None
    shadow = ShadowScorer(max_queue=4)
    try:
        engine = make_engine(InProcessBroker(), cpu_pipe(-8.0), batch_size=16,
                             shadow=shadow)
        model = engine.health()["model"]
        assert model["active_version"] is None and model["swaps"] == 0
        assert model["shadow"]["candidate_version"] is None
    finally:
        shadow.close(10.0)


# ---------------------------------------------------------------------------
# serve CLI
# ---------------------------------------------------------------------------

def test_serve_registry_watch_shadow_promote(tmp_path, capsys):
    """Serve v1 from a registry with --watch --shadow --promote-policy while
    an equivalent v2 is already published: the watcher stages it, the
    shadow scores the stream, the policy promotes mid-run, nothing lost."""
    from fraud_detection_tpu_torch.app.serve import main as serve_main

    feat = make_featurizer()
    root = str(tmp_path / "registry")
    registry = ModelRegistry(root)
    registry.publish(feat, const_model(-8.0))
    registry.publish(feat, const_model(-8.0))   # the candidate to adopt

    rc = serve_main(["--device", "cpu", "--registry", root,
                     "--model-version", "1", "--demo", "20000",
                     "--batch-size", "64", "--max-wait", "0.05",
                     "--watch", "--watch-interval", "0.05",
                     "--shadow", "--promote-policy",
                     "min_batches=1,min_rows=32,max_disagreement=0.02"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    stats = json.loads(out[-2])
    assert out[-1] == "classified messages on dialogues-classified: 20000"
    assert stats["processed"] == 20000
    lifecycle = stats["lifecycle"]
    assert [e["event"] for e in lifecycle["events"]] == ["stage", "promote"]
    assert lifecycle["active_version"] == 2 and lifecycle["swaps"] == 1
    assert lifecycle["staged_version"] is None
    assert stats["health"]["model"]["active_version"] == 2
    assert [e["event"] for e in registry.read_audit()] == [
        "publish", "publish", "stage", "promote"]


def _registry_root(tmp_path):
    root = str(tmp_path / "registry")
    ModelRegistry(root).publish(make_featurizer(), const_model(-8.0))
    return root


@pytest.mark.parametrize("argv", [
    ["--demo", "10"],
    ["--model", "synthetic", "--registry", "{root}", "--demo", "10"],
    ["--model", "synthetic", "--demo", "10", "--watch"],
    ["--model", "synthetic", "--demo", "10", "--model-version", "1"],
    ["--registry", "{root}", "--demo", "10", "--shadow"],
    ["--registry", "{root}", "--demo", "10", "--watch",
     "--promote-policy", "min_batches=1"],
    ["--registry", "{root}", "--demo", "10", "--watch", "--shadow",
     "--promote-policy", "bogus_key=1"],
    ["--registry", "{root}", "--demo", "10", "--watch", "--shadow",
     "--promote-policy", "min_batches"],
    ["--registry", "{root}", "--demo", "10", "--watch",
     "--watch-interval", "0"],
    ["--registry", "{root}", "--demo", "10", "--shadow-sample", "0"],
    ["--registry", "{root}", "--demo", "10", "--shadow-sample", "1.5"],
    ["--registry", "{root}", "--demo", "10", "--shadow-queue", "0"],
    ["--registry", "{root}", "--demo", "10", "--int8"],
    ["--registry", "{root}", "--demo", "10", "--featurize-device"],
    ["--model", "synthetic", "--demo", "10", "--learn"],
    ["--registry", "{root}", "--demo", "10", "--watch", "--shadow",
     "--learn"],
    ["--registry", "{root}", "--demo", "10", "--watch", "--shadow",
     "--promote-policy", "min_batches=1", "--learn", "--learn-rounds", "0"],
    ["--registry", "{root}", "--demo", "10", "--watch", "--shadow",
     "--promote-policy", "min_batches=1", "--learn", "--learn-window", "1"],
    ["--registry", "{root}", "--demo", "10", "--watch", "--shadow",
     "--promote-policy", "min_batches=1", "--learn", "--learn-min-rows", "1"],
    ["--registry", "{root}/empty", "--demo", "10"],
    ["--registry", "{root}", "--model-version", "9", "--demo", "10"],
])
def test_lifecycle_flag_validation_equals_jax(tmp_path, argv):
    from fraud_detection_tpu.app.serve import main as jmain
    from fraud_detection_tpu_torch.app.serve import main as tmain

    root = _registry_root(tmp_path)
    argv = [a.replace("{root}", root) for a in argv]
    with pytest.raises(SystemExit) as je:
        jmain(argv)
    with pytest.raises(SystemExit) as te:
        tmain(["--device", "cpu", *argv])
    assert str(te.value) == str(je.value)


def test_registry_serve_on_the_card_without_one_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from fraud_detection_tpu_torch.app.serve import main as tmain

    with pytest.raises(RuntimeError, match="cuda"):
        tmain(["--registry", _registry_root(tmp_path), "--demo", "5"])
