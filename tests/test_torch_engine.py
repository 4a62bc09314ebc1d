"""The port's StreamingClassifier against the JAX package's, on the CPU.

The same seeded stream (64 dialogues plus malformed JSON, a missing and a
non-string text field) runs through the JAX engine (host featurize, which
the JAX tests pin equal to device featurize) and through the port's engine
(device featurize, plain torch scan). Output key multisets must be equal,
parsed frames equal with ``confidence`` within 2e-6 (a 1e-6 probability
tolerance, plus the %.6f rounding of the frame), malformed / dead-lettered
counts equal, and the group's committed offsets equal.
"""

import json
from collections import Counter

import pytest

from fraud_detection_tpu.data import generate_corpus
from fraud_detection_tpu.models.pipeline import synthetic_demo_pipeline
from fraud_detection_tpu.stream import InProcessBroker as JBroker
from fraud_detection_tpu.stream import StreamingClassifier as JEngine
from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
from fraud_detection_tpu_torch.stream import InProcessBroker, StreamingClassifier
from tests.torch_parity import port_featurizer, port_model

_CONF_TOL = 2e-6


def _stream():
    msgs = [json.dumps({"text": d.text}).encode()
            for d in generate_corpus(n=64, seed=5)]
    msgs[3] = b"{not json"
    msgs[17] = json.dumps({"body": "no text field"}).encode()
    msgs[40] = json.dumps({"text": 42}).encode()
    msgs[55] = b"\xff\xfe"
    return [(v, f"k{i}".encode()) for i, v in enumerate(msgs)]


@pytest.fixture(scope="module")
def pipes():
    jpipe = synthetic_demo_pipeline(batch_size=32, n=200, seed=7)
    port = ServingPipeline(port_featurizer(jpipe.featurizer),
                           port_model(jpipe.model), batch_size=32,
                           featurize_device=True, device="cpu")
    return jpipe, port


def _run(broker_cls, engine_cls, pipe, **kw):
    broker = broker_cls()
    items = _stream()
    broker.producer().produce_batch("in", items)
    engine = engine_cls(pipe, broker.consumer(["in"], "g"), broker.producer(),
                        "out", batch_size=32, max_wait=0.05, **kw)
    engine.run(max_messages=len(items), idle_timeout=2.0)
    out = broker.consumer(["out"], "reader").poll_batch(10_000, 0.2)
    dlq = (broker.consumer(["dlq"], "reader").poll_batch(10_000, 0.2)
           if kw.get("dlq_topic") else [])
    committed = {(t, p): off for (g, t, p), off in broker._group_offsets.items()
                 if g == "g"}
    return out, dlq, engine, committed


def _frames(msgs):
    return {m.key: json.loads(m.value) for m in msgs}


def _assert_frames_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if "confidence" in w:
            assert abs(g.pop("confidence") - w.pop("confidence")) <= _CONF_TOL, k
        assert g == w, k


@pytest.mark.parametrize("dlq", [False, True])
def test_engine_matches_jax(pipes, dlq):
    jpipe, port = pipes
    kw = {"dlq_topic": "dlq"} if dlq else {}
    jout, jdlq, jeng, jcommit = _run(JBroker, JEngine, jpipe, **kw)
    tout, tdlq, teng, tcommit = _run(InProcessBroker, StreamingClassifier,
                                     port, **kw)
    assert Counter(m.key for m in tout) == Counter(m.key for m in jout)
    assert Counter(m.key for m in tdlq) == Counter(m.key for m in jdlq)
    _assert_frames_equal(_frames(tout), _frames(jout))
    _assert_frames_equal(_frames(tdlq), _frames(jdlq))
    assert teng.stats.malformed == jeng.stats.malformed == 4
    assert teng.stats.dead_lettered == jeng.stats.dead_lettered == (4 if dlq else 0)
    assert teng.stats.processed == jeng.stats.processed == 64
    assert tcommit == jcommit and sum(tcommit.values()) == 64
    block = teng.health()["device"]
    assert block["featurize_path"] == "torch"
    assert block["uploads_per_batch"] == 1.0
    assert block["truncated_rows"] == 0
    assert block["model_pins"] == 1


def test_poison_rows_divert_after_max_attempts(pipes):
    """A row re-delivered past dlq_max_attempts goes to the DLQ with its
    attempt count; the tracker survives incarnations through one dict."""
    _, port = pipes
    broker = InProcessBroker(num_partitions=1)
    broker.producer().produce_batch("in", _stream()[:4])
    attempts = {}
    for _ in range(2):        # two incarnations whose batches never commit
        eng = StreamingClassifier(port, broker.consumer(["in"], "g"),
                                  broker.producer(), "out", batch_size=8,
                                  dlq_topic="dlq", dlq_max_attempts=2,
                                  dlq_attempts=attempts)
        eng._prepare(eng.consumer.poll_batch(8, 0.1))
        eng.consumer.close()
    eng = StreamingClassifier(port, broker.consumer(["in"], "g"),
                              broker.producer(), "out", batch_size=8,
                              dlq_topic="dlq", dlq_max_attempts=2,
                              dlq_attempts=attempts)
    eng.run(max_messages=4, idle_timeout=0.5)
    dlq = broker.consumer(["dlq"], "r").poll_batch(100, 0.1)
    assert {json.loads(m.value)["reason"] for m in dlq} == {"max_attempts_exceeded"}
    assert len(dlq) == 4 and eng.stats.dead_lettered == 4
    assert not broker.consumer(["out"], "r").poll_batch(100, 0.1)
    assert broker.committed("g") == {("in", 0): 4}
    assert eng.health()["dlq"]["routed"] == {"max_attempts_exceeded": 4}


def test_stop_latches_and_process_batch(pipes):
    _, port = pipes
    broker = InProcessBroker()
    broker.producer().produce_batch("in", _stream()[:6])
    eng = StreamingClassifier(port, broker.consumer(["in"], "g"),
                              broker.producer(), "out", batch_size=8)
    assert eng.process_batch(eng.consumer.poll_batch(8, 0.1)) > 0
    eng.stop()
    assert eng.run(max_messages=10).processed == eng.stats.processed
    assert eng.health()["stopped"] is True
    with pytest.raises(ValueError):
        StreamingClassifier(port, None, None, "out", pipeline_depth=0)
