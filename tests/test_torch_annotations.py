"""The port's async annotation lane (``stream/annotations.py``) and the
engine's ``explain_async`` path, on the CPU — the counterpart of
``tests/test_annotations.py``, plus one parity test of the engine: the JAX
engine and the port's, each with ``explain_async=True`` and a canned
backend, over the same seeded messages give equal output frames and equal
annotation records (confidence within the engine tests' 2e-6).
"""

import json
import threading
import time

import pytest

from fraud_detection_tpu_torch.data import generate_corpus
from fraud_detection_tpu_torch.stream import (AsyncAnnotationLane,
                                              InProcessBroker,
                                              StreamingClassifier)

_CONF_TOL = 2e-6


@pytest.fixture(scope="module")
def pipeline():
    from fraud_detection_tpu_torch.models.pipeline import (
        synthetic_demo_pipeline)

    return synthetic_demo_pipeline(batch_size=64, n=400, seed=3,
                                   num_features=2048,
                                   corpus_kwargs=dict(hard_fraction=0.0,
                                                      label_noise=0.0),
                                   device="cpu")


def _lane(broker, fn, **kw):
    return AsyncAnnotationLane(fn, broker.producer(), "annotations", **kw)


def test_lane_annotates_and_keys_records():
    broker = InProcessBroker(num_partitions=2)
    lane = _lane(broker, lambda t, l, c: [f"analysis {x}" for x in l])
    lane.submit([(b"k1", "text one", 1, 0.9), (b"k2", "text two", 2, 0.8)])
    assert lane.close(timeout=10.0)
    recs = broker.messages("annotations")
    assert len(recs) == 2
    by_key = {m.key: json.loads(m.value) for m in recs}
    assert by_key[b"k1"] == {"prediction": 1, "label": "Potential Scam",
                             "confidence": 0.9, "analysis": "analysis 1"}
    assert by_key[b"k2"]["prediction"] == 2
    assert lane.stats() == {"submitted": 2, "annotated": 2, "dropped": 0,
                            "drop_records": 0, "backend_errors": 0,
                            "queue_depth": 0}


def test_lane_bounded_queue_drops_oldest():
    broker = InProcessBroker()
    gate = threading.Event()
    seen = []

    def fn(texts, labels, confs):
        gate.wait(5.0)               # hold the worker so the queue fills
        seen.extend(texts)
        return ["a"] * len(texts)

    lane = _lane(broker, fn, max_queue=4, max_batch=64)
    lane.submit([(None, f"t{i}", 1, 0.5) for i in range(10)])
    gate.set()
    assert lane.close(timeout=10.0)
    s = lane.stats()
    assert s["submitted"] == 10 and s["dropped"] == 6
    assert set(seen) <= {f"t{i}" for i in range(6, 10)}
    drops = [json.loads(m.value) for m in broker.messages("annotations")
             if json.loads(m.value).get("dropped")]
    assert len(drops) == s["drop_records"] == 6
    assert all(d["reason"] == "queue_overflow" and d["analysis"] is None
               for d in drops)


def test_lane_batches_at_max_batch():
    broker = InProcessBroker()
    calls = []
    lane = _lane(broker, lambda t, l, c: (calls.append(len(t)),
                                          ["a"] * len(t))[1],
                 max_batch=3)
    lane.submit([(None, f"t{i}", 1, 0.5) for i in range(7)])
    assert lane.close(timeout=10.0)
    assert sum(calls) == 7
    assert max(calls) <= 3


def test_lane_survives_backend_failure():
    broker = InProcessBroker()
    state = {"n": 0}

    def fn(texts, labels, confs):
        state["n"] += 1
        if state["n"] == 1:
            raise RuntimeError("backend down")
        return ["recovered"] * len(texts)

    lane = _lane(broker, fn)
    lane.submit([(b"k1", "first", 1, 0.5)])
    lane.drain(timeout=10.0)
    lane.submit([(b"k2", "second", 1, 0.5)])
    assert lane.close(timeout=10.0)
    s = lane.stats()
    assert s["backend_errors"] == 1
    assert s["annotated"] == 1
    assert [m.key for m in broker.messages("annotations")] == [b"k2"]


def test_lane_skips_none_analyses():
    broker = InProcessBroker()
    lane = _lane(broker, lambda t, l, c: [None if x == 0 else "flagged"
                                          for x in l])
    lane.submit([(b"a", "benign", 0, 0.1), (b"b", "scam", 1, 0.9)])
    assert lane.close(timeout=10.0)
    assert [m.key for m in broker.messages("annotations")] == [b"b"]
    assert lane.stats()["annotated"] == 1


def test_lane_length_mismatch_is_backend_error():
    broker = InProcessBroker()
    lane = _lane(broker, lambda t, l, c: ["only-one"])
    lane.submit([(None, "t1", 1, 0.5), (None, "t2", 1, 0.5)])
    assert lane.close(timeout=10.0)
    assert lane.stats()["backend_errors"] == 1
    assert broker.messages("annotations") == []


def test_lane_passes_trace_ids_to_hooks_that_accept_them():
    broker = InProcessBroker()
    got = {}

    def fn(texts, labels, confs, cids=None):
        got["cids"] = cids
        return ["a"] * len(texts)

    fn.accepts_cids = True
    lane = _lane(broker, fn)
    lane.submit([(b"k1", "one", 1, 0.5, "w0-1:0:3"), (b"k2", "two", 1, 0.5)])
    assert lane.close(timeout=10.0)
    assert got["cids"] == ["w0-1:0:3", None]


def test_lane_refuses_bad_bounds():
    with pytest.raises(ValueError, match="max_queue/max_batch"):
        _lane(InProcessBroker(), lambda t, l, c: [], max_queue=0)


def _feed(broker, n, seed):
    corpus = generate_corpus(n=n, seed=seed, hard_fraction=0.0,
                             label_noise=0.0)
    producer = broker.producer()
    for i, d in enumerate(corpus):
        producer.produce("customer-dialogues-raw",
                         json.dumps({"text": d.text, "id": i}).encode(),
                         key=str(i).encode())


def test_engine_async_annotations_end_to_end(pipeline):
    """explain_async=True: classified frames ship WITHOUT analysis (and the
    raw-JSON fast path stays in play), flagged rows land on the annotations
    side topic keyed like their sources."""
    broker = InProcessBroker(num_partitions=2)
    _feed(broker, 40, 13)

    def explain_batch(texts, labels, confs):
        assert all(l != 0 for l in labels)     # engine pre-filters flagged
        return [f"async analysis label={l}" for l in labels]

    engine = StreamingClassifier(
        pipeline, broker.consumer(["customer-dialogues-raw"], "grp"),
        broker.producer(), "out", batch_size=16, max_wait=0.01,
        explain_batch_fn=explain_batch, explain_async=True,
        annotations_producer=broker.producer())
    stats = engine.run(max_messages=40, idle_timeout=0.2)
    assert engine.close_annotations(timeout=30.0)

    assert stats.processed == 40
    assert engine._json_fast is True and engine._frames_ok is True
    outs = {m.key: json.loads(m.value) for m in broker.messages("out")}
    assert len(outs) == 40
    assert all("analysis" not in o for o in outs.values())
    flagged = {k for k, o in outs.items() if o["prediction"] != 0}
    assert flagged
    recs = {m.key: json.loads(m.value) for m in
            broker.messages("out-annotations")}
    assert set(recs) == flagged
    for k, r in recs.items():
        assert r["prediction"] == outs[k]["prediction"]
        assert r["confidence"] == outs[k]["confidence"]
        assert r["analysis"] == f"async analysis label={r['prediction']}"
    s = engine.annotation_stats()
    assert s["annotated"] == len(flagged) and s["dropped"] == 0
    assert engine.health()["annotations"] == s


def test_engine_async_requires_batch_fn(pipeline):
    broker = InProcessBroker()
    with pytest.raises(ValueError, match="explain_async"):
        StreamingClassifier(
            pipeline, broker.consumer(["t"], "g"), broker.producer(), "out",
            explain_async=True)


def test_engine_inline_has_no_lane(pipeline):
    broker = InProcessBroker()
    engine = StreamingClassifier(
        pipeline, broker.consumer(["t"], "g"), broker.producer(), "out")
    assert engine.annotation_stats() is None
    assert engine.close_annotations() is True
    h = engine.health()
    assert h["annotations"] is None and h["breaker"] is None \
        and h["explain"] is None


def test_engine_async_slow_backend_never_blocks_classification(pipeline):
    """A backend far slower than the stream must not throttle it."""
    broker = InProcessBroker()
    _feed(broker, 60, 21)

    def slow_explain(texts, labels, confs):
        time.sleep(0.25)                      # "decode" far slower than poll
        return ["slow"] * len(texts)

    engine = StreamingClassifier(
        pipeline, broker.consumer(["customer-dialogues-raw"], "grp"),
        broker.producer(), "out", batch_size=16, max_wait=0.01,
        explain_batch_fn=slow_explain, explain_async=True,
        annotations_producer=broker.producer())
    t0 = time.perf_counter()
    stats = engine.run(max_messages=60, idle_timeout=0.2)
    run_s = time.perf_counter() - t0
    assert stats.processed == 60
    assert len(broker.messages("out")) == 60
    assert engine.annotation_stats()["submitted"] > 0
    assert run_s < 0.9, f"classification waited on the annotator: {run_s:.2f}s"
    engine.close_annotations(timeout=30.0)


def test_engine_async_requires_dedicated_producer(pipeline):
    broker = InProcessBroker()
    with pytest.raises(ValueError, match="annotations_producer"):
        StreamingClassifier(
            pipeline, broker.consumer(["t"], "g"), broker.producer(), "out",
            explain_batch_fn=lambda t, l, c: [None] * len(t),
            explain_async=True)
    shared = broker.producer()
    with pytest.raises(ValueError, match="DEDICATED"):
        StreamingClassifier(
            pipeline, broker.consumer(["t"], "g"), shared, "out",
            explain_batch_fn=lambda t, l, c: [None] * len(t),
            explain_async=True, annotations_producer=shared)


def test_lane_close_bounded_and_honest_with_hung_backend():
    broker = InProcessBroker()
    started = threading.Event()
    release = threading.Event()        # never set during the test: a hang

    def hung_fn(texts, labels, confs):
        started.set()
        release.wait(30.0)
        return ["late"] * len(texts)

    lane = _lane(broker, hung_fn)
    lane.submit([(b"k1", "text", 1, 0.9), (b"k2", "text", 1, 0.8)])
    assert started.wait(5.0)
    t0 = time.perf_counter()
    ok = lane.close(timeout=0.3)
    dt = time.perf_counter() - t0
    assert ok is False
    assert dt < 2.0, f"close() blocked {dt:.1f}s behind a hung backend"
    assert lane._thread.is_alive()
    release.set()
    lane._thread.join(timeout=5.0)
    assert not lane._thread.is_alive()


def test_lane_close_bounded_with_raising_backend_and_backlog():
    broker = InProcessBroker()

    def bad_fn(texts, labels, confs):
        raise ConnectionError("endpoint down")

    lane = _lane(broker, bad_fn, max_batch=4)
    lane.submit([(None, f"t{i}", 1, 0.5) for i in range(12)])
    assert lane.close(timeout=10.0) is True
    assert not lane._thread.is_alive()
    s = lane.stats()
    assert s["queue_depth"] == 0 and s["annotated"] == 0
    assert s["backend_errors"] == 3    # 12 rows / max_batch 4
    assert broker.messages("annotations") == []


def test_lane_drain_deadline_uses_injected_clock():
    broker = InProcessBroker()
    gate = threading.Event()
    fake_now = [0.0]

    def fast_clock():                  # every read jumps a minute forward
        fake_now[0] += 60.0
        return fake_now[0]

    def slow_fn(texts, labels, confs):
        gate.wait(10.0)
        return ["a"] * len(texts)

    lane = AsyncAnnotationLane(slow_fn, broker.producer(), "annotations",
                               clock=fast_clock)
    lane.submit([(b"k", "t", 1, 0.5)])
    t0 = time.perf_counter()
    assert lane.drain(timeout=50.0) is False
    assert time.perf_counter() - t0 < 1.0   # expired via clock, not sleeping
    gate.set()
    lane.close(timeout=10.0)
    lane._thread.join(timeout=5.0)
    assert not lane._thread.is_alive()


def test_lane_close_discards_residual_queue_as_dropped():
    broker = InProcessBroker()
    started = threading.Event()
    release = threading.Event()

    def slow_fn(texts, labels, confs):
        started.set()
        release.wait(30.0)
        return ["late"] * len(texts)

    lane = _lane(broker, slow_fn, max_batch=2)
    lane.submit([(bytes([i]), f"t{i}", 1, 0.5) for i in range(8)])
    assert started.wait(5.0)          # worker holds a 2-row batch
    assert lane.close(timeout=0.3) is False
    s1 = lane.stats()
    assert s1["queue_depth"] == 0
    assert s1["dropped"] == 6
    release.set()
    lane._thread.join(timeout=5.0)
    s2 = lane.stats()
    assert (s2["submitted"], s2["dropped"], s2["queue_depth"]) == (8, 6, 0)


def test_lane_annotated_credit_survives_producer_backlog():
    class BacklogProducer:
        def __init__(self):
            self.sent = []
            self.queue = 0
            self.fail_next = True

        def produce(self, topic, value, key=None):
            self.sent.append((value, key))
            self.queue += 1

        def flush(self):
            if self.fail_next:        # everything stays queued once
                self.fail_next = False
                return self.queue
            self.queue = 0
            return 0

    prod = BacklogProducer()
    lane = AsyncAnnotationLane(lambda t, l, c: ["a"] * len(t), prod, "ann")
    lane.submit([(b"k1", "one", 1, 0.5)])
    lane.drain(timeout=10.0)
    assert lane.stats()["annotated"] == 0
    assert lane.stats()["backend_errors"] == 1
    lane.submit([(b"k2", "two", 1, 0.5)])
    assert lane.close(timeout=10.0)
    assert lane.stats()["annotated"] == 2


def test_lane_close_is_idempotent_and_latching():
    broker = InProcessBroker()
    lane = _lane(broker, lambda t, l, c: ["a"] * len(t))
    lane.submit([(b"k", "text", 1, 0.5)])
    assert lane.close(timeout=10.0)
    assert lane.close(timeout=10.0)
    lane.submit([(b"late", "text", 1, 0.5)])
    assert lane.stats()["submitted"] == 1
    assert [m.key for m in broker.messages("annotations")] == [b"k"]


# ---------------------------------------------------------------------------
# the engine's async path against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("featurize_device", [False, True])
def test_engine_async_equals_jax(featurize_device):
    """The JAX engine and the port's (raw JSON with native frames, or the
    slow path with device featurize), ``explain_async=True`` with a canned
    backend, over the same seeded messages (a malformed one among them):
    equal frames, equal annotation records, equal lane counters."""
    from fraud_detection_tpu.explain import (CannedBackend as JCanned,
                                             make_stream_explain_hook as jhook)
    from fraud_detection_tpu.models.pipeline import (
        synthetic_demo_pipeline as jdemo)
    from fraud_detection_tpu.stream import InProcessBroker as JBroker
    from fraud_detection_tpu.stream import StreamingClassifier as JEngine
    from fraud_detection_tpu_torch.explain import (CannedBackend,
                                                   make_stream_explain_hook)
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from tests.torch_parity import port_featurizer, port_model

    jpipe = jdemo(batch_size=32, n=200, seed=7)
    tpipe = ServingPipeline(port_featurizer(jpipe.featurizer),
                            port_model(jpipe.model), batch_size=32,
                            featurize_device=featurize_device, device="cpu")
    items = [(json.dumps({"text": d.text, "id": i}).encode(),
              f"k{i}".encode())
             for i, d in enumerate(generate_corpus(n=64, seed=5))]
    items[9] = (b"{not json", b"k9")
    replies = ["canned analysis A", "canned analysis B"]

    def run(broker_cls, engine_cls, pipe, hook):
        broker = broker_cls(num_partitions=2)
        broker.producer().produce_batch("in", items)
        engine = engine_cls(pipe, broker.consumer(["in"], "g"),
                            broker.producer(), "out", batch_size=16,
                            max_wait=0.01, explain_batch_fn=hook,
                            explain_async=True,
                            annotations_producer=broker.producer())
        engine.run(max_messages=len(items), idle_timeout=1.0)
        assert engine.close_annotations(timeout=30.0)
        frames = {m.key: json.loads(m.value) for m in broker.messages("out")}
        recs = {m.key: json.loads(m.value)
                for m in broker.messages("out-annotations")}
        return frames, recs, engine.annotation_stats()

    want = run(JBroker, JEngine, jpipe,
               jhook(JCanned(responses=replies), max_tokens=8))
    got = run(InProcessBroker, StreamingClassifier, tpipe,
              make_stream_explain_hook(CannedBackend(responses=replies),
                                       max_tokens=8))
    for g, w in zip(got[:2], want[:2]):
        assert set(g) == set(w)
        for k in w:
            gk, wk = dict(g[k]), dict(w[k])
            if "confidence" in wk:
                assert abs(gk.pop("confidence")
                           - wk.pop("confidence")) <= _CONF_TOL, k
            assert gk == wk, k
    assert got[2] == want[2]
    assert got[1] and all("analysis" not in f for f in got[0].values())
