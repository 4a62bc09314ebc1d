"""The port's engine on its serving fast path against the JAX engine's.

Both packages serve with host featurization, so both take the raw-JSON path
(native bytes-to-rows, no ``json.loads``) and assemble output frames in
C++. The seeded stream holds malformed rows and, in one batch, an
escaped-key row that the native scanner rejects and ``json.loads`` accepts,
which sends that batch down the slow path. Keys, labels, malformed and DLQ
counts and the committed offsets must be exact, confidence within the
engine tests' 2e-6; the port's native frames must be byte-identical to its
Python-template frames, and its ``async_dispatch`` output to its sync
output. Under overload with a shedding scheduler every fed key comes out
once, as a frame or as a DLQ record.
"""

import json
from collections import Counter

import numpy as np
import pytest

from fraud_detection_tpu.data import generate_corpus
from fraud_detection_tpu.models.pipeline import ServingPipeline as JPipe
from fraud_detection_tpu.models.pipeline import synthetic_demo_pipeline
from fraud_detection_tpu.stream import InProcessBroker as JBroker
from fraud_detection_tpu.stream import StreamingClassifier as JEngine
from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
from fraud_detection_tpu_torch.sched import AdaptiveScheduler, SchedulerConfig
from fraud_detection_tpu_torch.stream import InProcessBroker, StreamingClassifier
from tests.torch_parity import port_featurizer, port_model

_CONF_TOL = 2e-6
_ESCAPED = 70      # the escaped-key row's index


def _stream(n=160):
    msgs = [json.dumps({"text": d.text, "id": i}).encode()
            for i, d in enumerate(generate_corpus(n=n, seed=5))]
    msgs[3] = b"{not json"
    msgs[17] = json.dumps({"body": "no text field"}).encode()
    msgs[40] = json.dumps({"text": 42}).encode()
    msgs[55] = b"\xff\xfe"
    msgs[_ESCAPED] = b'{"te\\u0078t": "urgent verify your account now"}'
    msgs[99] = json.dumps({"text": "unicode café \U0001f389 \"q\""},
                          ensure_ascii=False).encode()
    return [(v, f"k{i}".encode()) for i, v in enumerate(msgs)]


@pytest.fixture(scope="module")
def jpipes():
    return {"lr": synthetic_demo_pipeline(batch_size=32, n=200, seed=7),
            "dt": synthetic_demo_pipeline(batch_size=32, n=200, seed=7,
                                          num_features=2048, model="dt")}


def _pipes(jpipes, kind):
    jp = jpipes[kind.split("-")[0]]
    int8 = kind.endswith("int8")
    port = ServingPipeline(port_featurizer(jp.featurizer), port_model(jp.model),
                           batch_size=32, int8=int8, device="cpu")
    ref = JPipe(jp.featurizer, jp.model, batch_size=32, int8=int8) if int8 else jp
    return ref, port


def _run(broker_cls, engine_cls, pipe, items, *, frames=None, **kw):
    broker = broker_cls()
    broker.producer().produce_batch("in", items)
    engine = engine_cls(pipe, broker.consumer(["in"], "g"), broker.producer(),
                        "out", batch_size=32, max_wait=0.05, **kw)
    if frames is not None:
        engine._frames_ok = frames
    engine.run(max_messages=len(items), idle_timeout=2.0)
    out = broker.messages("out")
    dlq = broker.messages("dlq")
    committed = {(t, p): off for (g, t, p), off in broker._group_offsets.items()
                 if g == "g"}
    return out, dlq, engine, committed


def _frames(msgs):
    return {m.key: json.loads(m.value) for m in msgs}


def _assert_frames_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = dict(got[k])
        w = dict(w)
        if "confidence" in w:
            assert abs(g.pop("confidence") - w.pop("confidence")) <= _CONF_TOL, k
        assert g == w, k


@pytest.mark.parametrize("kind", ["lr", "lr-int8", "dt"])
def test_predict_json_async_equals_jax(jpipes, kind):
    ref, port = _pipes(jpipes, kind)
    values = [v for v, _ in _stream()[:80]]
    got = port.predict_json_async(values)
    want = ref.predict_json_async(values)
    for g, w in zip(got[1:4], want[1:4]):      # status, span_start, span_len
        np.testing.assert_array_equal(g, w)
    pg, pw = got[0].resolve(), want[0].resolve()
    ok = got[1].astype(bool)
    np.testing.assert_array_equal(pg.labels[ok], pw.labels[ok])
    assert float(np.abs(pg.probabilities - pw.probabilities)[ok].max()) < 1e-6
    assert [n for _, n in got[4]] == [32, 32, 16]
    assert port.device_stats.snapshot()["uploads_per_chunk"] == 1.0
    dev = ServingPipeline(port.featurizer, port.model, batch_size=32,
                          featurize_device=True, device="cpu")
    assert dev.predict_json_async(values) is None


@pytest.mark.parametrize("dlq", [False, True])
@pytest.mark.parametrize("kind", ["lr", "dt"])
def test_fast_path_engine_equals_jax(jpipes, kind, dlq):
    ref, port = _pipes(jpipes, kind)
    items = _stream()
    kw = {"dlq_topic": "dlq"} if dlq else {}
    jout, jdlq, jeng, jcommit = _run(JBroker, JEngine, ref, items, **kw)
    tout, tdlq, teng, tcommit = _run(InProcessBroker, StreamingClassifier,
                                     port, items, **kw)
    assert jeng._json_fast is teng._json_fast is True
    assert jeng._frames_ok is teng._frames_ok is True
    assert Counter(m.key for m in tout) == Counter(m.key for m in jout)
    assert Counter(m.key for m in tdlq) == Counter(m.key for m in jdlq)
    _assert_frames_equal(_frames(tout), _frames(jout))
    _assert_frames_equal(_frames(tdlq), _frames(jdlq))
    assert teng.stats.malformed == jeng.stats.malformed == 4
    assert teng.stats.dead_lettered == jeng.stats.dead_lettered == (4 if dlq else 0)
    assert teng.stats.processed == jeng.stats.processed == len(items)
    assert tcommit == jcommit and sum(tcommit.values()) == len(items)
    # the escaped-key row is a valid row (json.loads reads key "text")
    assert _frames(tout)[f"k{_ESCAPED}".encode()]["original_text"] == \
        "urgent verify your account now"
    block = teng.health()["device"]
    assert block["featurize_path"] == "host" and block["uploads_per_batch"] == 1.0


@pytest.mark.parametrize("dlq", [False, True])
def test_native_frames_equal_template_frames_and_async_equals_sync(jpipes, dlq):
    _, port = _pipes(jpipes, "lr")
    items = _stream()
    kw = {"dlq_topic": "dlq"} if dlq else {}
    native, ndlq, neng, _ = _run(InProcessBroker, StreamingClassifier, port,
                                 items, **kw)
    template, tdlq, teng, _ = _run(InProcessBroker, StreamingClassifier, port,
                                   items, frames=False, **kw)
    lane, ldlq, leng, _ = _run(InProcessBroker, StreamingClassifier, port,
                               items, async_dispatch=True, **kw)
    assert neng._frames_ok is True and teng._frames_ok is False
    wire = lambda msgs: sorted((m.key, m.value) for m in msgs)  # noqa: E731
    assert wire(native) == wire(template) == wire(lane)
    assert wire(ndlq) == wire(tdlq) == wire(ldlq)
    assert leng._json_fast is True and leng._frames_ok is True
    block = leng.health()["device"]
    assert block["async_dispatch"] is True
    assert block["lane_batches"] == leng.stats.batches
    assert 1 <= block["max_inflight"] <= 3


@pytest.mark.parametrize("async_dispatch", [False, True])
def test_overload_sheds_to_the_dlq_with_exact_keys(jpipes, async_dispatch):
    _, port = _pipes(jpipes, "lr")
    items = _stream(600)
    sched = AdaptiveScheduler(
        SchedulerConfig(shed_policy="reject", max_queue=120,
                        batch_deadline_ms=5, target_p99_ms=500), 32)
    assert sched.prewarm(port) == len(sched.buckets)
    assert port.pad_ladder == tuple(sched.buckets)
    out, dlq, eng, committed = _run(
        InProcessBroker, StreamingClassifier, port, items, dlq_topic="dlq",
        scheduler=sched, async_dispatch=async_dispatch)
    fed = Counter(k for _, k in items)
    assert Counter(m.key for m in out) + Counter(m.key for m in dlq) == fed
    assert eng.stats.shed > 0
    assert eng.stats.processed == len(items) == sum(committed.values())
    reasons = Counter(json.loads(m.value)["reason"] for m in dlq)
    assert reasons["shed_queue_full"] == eng.stats.shed
    assert eng._json_fast is True and eng._frames_ok is True
    health = eng.health()
    snap = json.loads(json.dumps(health["sched"]))
    assert snap["admission"]["shed"]["shed_queue_full"] == eng.stats.shed
    assert snap["ladder_cost_ms"] and snap["buckets"] == list(sched.buckets)
    assert health["shed"] == eng.stats.shed
    with pytest.raises(ValueError, match="dlq_topic"):
        StreamingClassifier(port, None, None, "out", scheduler=sched)
