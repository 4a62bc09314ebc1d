"""The port's explanation layer against the JAX package's, on the CPU.

Prompt strings are equal byte for byte; the stream hook and the circuit
breaker, driven by the same scripted backends and clock, give equal
outputs, snapshots and errors; the historical store ranks the same cases
(similarities within 1e-6); the agent returns the same fields; the port's
engine with ``explain_batch_fn`` emits frames byte-identical to the JAX
engine's on the same stream and canned hook, and, with the on-device
backend over the same tiny decoder, the same greedy explanations.
``OnPodBackend.from_hf_checkpoint(int8=True)`` serves a checkpoint written
in the test with the JAX backend's int8 weights, on one device and split
over a ``mesh=`` model axis.
"""

import json

import jax
import numpy as np
import pytest

from fraud_detection_tpu import explain as jx
from fraud_detection_tpu.data import generate_corpus
from fraud_detection_tpu.explain.backends import frame_prompt as jframe
from fraud_detection_tpu.explain.onpod import flatten_chat as jflatten
from fraud_detection_tpu.models import llm as jllm
from fraud_detection_tpu.models.pipeline import synthetic_demo_pipeline
from fraud_detection_tpu.stream import InProcessBroker as JBroker
from fraud_detection_tpu.stream import StreamingClassifier as JEngine
from fraud_detection_tpu_torch import explain as px
from fraud_detection_tpu_torch.explain.backends import frame_prompt
from fraud_detection_tpu_torch.explain.onpod import flatten_chat
from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
from fraud_detection_tpu_torch.stream import InProcessBroker, StreamingClassifier
from tests.torch_parity import port_featurizer, port_llm, port_model

CASES = [("Agent: your account is suspended, pay now", 1, 0.98765),
         ("Customer: can I move my appointment to Friday?", 0, 0.5),
         ("", 1, 1.0), ("émoji 🚀 " * 100, 2, 0.0004)]


@pytest.fixture(scope="module")
def dt_pipes():
    """A JAX decision-tree pipeline and its port twin (tree probabilities
    are leaf fractions, so both give the same confidences)."""
    jpipe = synthetic_demo_pipeline(batch_size=32, n=200, seed=7, model="dt")
    port = ServingPipeline(port_featurizer(jpipe.featurizer),
                           port_model(jpipe.model), batch_size=32,
                           featurize_device=True, device="cpu")
    return jpipe, port


def test_prompt_strings_equal_jax():
    for text, label, conf in CASES:
        assert (px.analysis_prompt(text, label, conf)
                == jx.analysis_prompt(text, label, conf))
        assert px.label_name(label) == jx.label_name(label)
        assert (flatten_chat(frame_prompt(text)) == jflatten(jframe(text)))
        assert (flatten_chat(frame_prompt(text, system="sys"))
                == jflatten(jframe(text, system="sys")))
    cases = [(t, l, c) for t, l, c in CASES]
    assert (px.historical_insight_prompt("new call", cases)
            == jx.historical_insight_prompt("new call", cases))
    assert (px.historical_insight_prompt("x", [])
            == jx.historical_insight_prompt("x", []))


class _Batched:
    """A backend with ``generate_batch``: echoes, raises, or miscounts."""

    def __init__(self, mode):
        self.mode, self.calls = mode, []

    def generate_batch(self, prompts, *, temperature, max_tokens):
        self.calls.append((list(prompts), temperature, max_tokens))
        if self.mode == "raise":
            raise RuntimeError("backend down")
        replies = [f"analysis {len(p)}" for p in prompts]
        return replies[:-1] if self.mode == "short" else replies


@pytest.mark.parametrize("mode", ["canned", "ok", "raise", "short"])
def test_stream_hook_matches_jax(mode):
    texts = [t for t, _, _ in CASES]
    labels = [l for _, l, _ in CASES]
    confs = [c for _, _, c in CASES]
    if mode == "canned":
        pb, jb = (px.CannedBackend(["one", "two"]),
                  jx.CannedBackend(["one", "two"]))
    else:
        pb, jb = _Batched(mode), _Batched(mode)
    got = px.make_stream_explain_hook(pb, max_tokens=7)(texts, labels, confs)
    want = jx.make_stream_explain_hook(jb, max_tokens=7)(texts, labels, confs)
    assert got == want
    assert pb.calls == jb.calls and len(pb.calls) > 0
    every = px.make_stream_explain_hook(_Batched("ok"), only_scams=False)
    assert all(a is not None for a in every(texts, labels, confs))


class _Flaky:
    def __init__(self, script, exc=ConnectionError):
        self.script, self.exc = list(script), exc

    def chat(self, messages, *, temperature=1.0, max_tokens=1000):
        if self.script.pop(0):
            return "fine"
        raise self.exc("down")

    def generate(self, prompt, *, temperature=1.0, max_tokens=1000,
                 system=None):
        return self.chat([])


def test_circuit_breaker_matches_jax():
    script = [False, False, False, True, False, True, True]
    clock = {"t": 0.0}
    breakers = [mod.CircuitBreakerBackend(_Flaky(script), failure_threshold=2,
                                          probe_interval=5.0,
                                          clock=lambda: clock["t"])
                for mod in (px, jx)]
    trace = [[], []]
    for step in range(12):
        clock["t"] = step * 1.5
        for b, out in zip(breakers, trace):
            try:
                out.append(b.generate("p"))
            except Exception as e:  # noqa: BLE001 — the trace records it
                out.append(type(e).__name__)
            out.append(b.snapshot())
            out.append(b.state)
    assert trace[0] == trace[1]
    assert "BreakerOpenError" in trace[0] and "fine" in trace[0]
    assert not hasattr(breakers[0], "generate_batch")
    assert hasattr(px.CircuitBreakerBackend(_Batched("ok")), "generate_batch")


@pytest.fixture(scope="module")
def history(dt_pipes):
    jpipe, port = dt_pipes
    corpus = generate_corpus(n=120, seed=3)
    texts, labels = [d.text for d in corpus], [d.label for d in corpus]
    return (jx.HistoricalCaseStore(jpipe.featurizer, texts, labels),
            px.HistoricalCaseStore(port.featurizer, texts, labels,
                                   device="cpu"))


def test_history_find_similar_matches_jax(history):
    jstore, pstore = history
    assert len(pstore) == len(jstore) == 120
    queries = [d.text for d in generate_corpus(n=6, seed=9)] + ["zzqx", ""]
    for q in queries:
        for k in (1, 3, 200):
            want, got = jstore.find_similar(q, k), pstore.find_similar(q, k)
            assert [g[:2] for g in got] == [w[:2] for w in want], (q, k)
            np.testing.assert_allclose([g[2] for g in got],
                                       [w[2] for w in want], atol=1e-6)


def test_agent_classify_and_explain_matches_jax(dt_pipes, history):
    jpipe, port = dt_pipes
    jstore, pstore = history
    replies = ["analysis A", "insight B", "analysis C", "insight D"]
    jagent = jx.FraudAnalysisAgent(jpipe, jx.CannedBackend(list(replies)),
                                   history=jstore)
    pagent = px.FraudAnalysisAgent(port, px.CannedBackend(list(replies)),
                                   history=pstore)
    for text in [d.text for d in generate_corpus(n=2, seed=21)]:
        want = jagent.classify_and_explain(text, temperature=0.0)
        got = pagent.classify_and_explain(text, temperature=0.0)
        for key in ("confidence", "probability_scam"):
            assert abs(got.pop(key) - want.pop(key)) < 1e-6
        wc, gc = want.pop("similar_cases"), got.pop("similar_cases")
        assert [c[:2] for c in gc] == [c[:2] for c in wc]
        assert got == want
    assert pagent.backend.calls == jagent.backend.calls
    pagent.backend = _Flaky([False] * 4, exc=px.BackendError)
    breaker = pagent.enable_circuit_breaker(failure_threshold=1)
    out = pagent.classify_and_explain("hello", with_history=False)
    assert out["analysis"] is None and "down" in out["error"]
    assert pagent.backend_health()["state"] == "open"
    assert breaker is pagent.enable_circuit_breaker()


def _stream(n=64):
    corpus = generate_corpus(n=n, seed=5)
    msgs = [json.dumps({"text": d.text}).encode() for d in corpus]
    msgs[3] = b"{not json"
    msgs[17] = json.dumps({"body": "no text field"}).encode()
    return [(v, f"k{i}".encode()) for i, v in enumerate(msgs)]


def _run_engine(broker_cls, engine_cls, pipe, hook, **kw):
    broker = broker_cls()
    items = _stream()
    broker.producer().produce_batch("in", items)
    engine = engine_cls(pipe, broker.consumer(["in"], "g"), broker.producer(),
                        "out", batch_size=32, max_wait=0.05,
                        explain_batch_fn=hook, **kw)
    stats = engine.run(max_messages=len(items), idle_timeout=2.0)
    out = broker.consumer(["out"], "reader").poll_batch(10_000, 0.2)
    return {m.key: m.value for m in out}, stats


def test_engine_explained_frames_match_jax(dt_pipes):
    jpipe, port = dt_pipes
    replies = [f"canned {i}" for i in range(40)]
    want, jstats = _run_engine(JBroker, JEngine, jpipe,
                               jx.make_stream_explain_hook(
                                   jx.CannedBackend(list(replies))))
    got, pstats = _run_engine(InProcessBroker, StreamingClassifier, port,
                              px.make_stream_explain_hook(
                                  px.CannedBackend(list(replies))))
    assert got == want
    frames = [json.loads(v) for v in got.values()]
    flagged = [f for f in frames if f.get("prediction")]
    assert flagged and all("analysis" in f for f in flagged)
    assert all("analysis" not in f for f in frames if f.get("prediction") == 0)
    assert pstats.malformed == jstats.malformed == 2
    assert pstats.processed == jstats.processed == 64


def test_engine_explain_fn_and_count_check(dt_pipes):
    _, port = dt_pipes
    got, _ = _run_engine(InProcessBroker, StreamingClassifier, port, None,
                         explain_fn=lambda t, l, c: f"{l}:{len(t)}")
    frames = [json.loads(v) for v in got.values()]
    ok = [f for f in frames if "original_text" in f]
    assert ok and all(f["analysis"] == f"{f['prediction']}:"
                      f"{len(f['original_text'])}" for f in ok)
    with pytest.raises(ValueError, match="analyses"):
        _run_engine(InProcessBroker, StreamingClassifier, port,
                    lambda texts, labels, confs: [])


def test_engine_onpod_explanations_match_jax(dt_pipes):
    """The served path end to end: the engine's hook over OnPodBackend and
    a tiny decoder (prompts truncated to max_seq bytes) gives the JAX
    engine's greedy explanations."""
    jpipe, port = dt_pipes
    cfg = jllm.TransformerConfig(d_model=32, n_heads=4, n_layers=1, d_ff=64,
                                 max_seq=320)
    jlm = jllm.LanguageModel(cfg, jllm.init_params(jax.random.PRNGKey(4), cfg))
    plm = port_llm(jlm)
    want, _ = _run_engine(JBroker, JEngine, jpipe, jx.make_stream_explain_hook(
        jx.OnPodBackend.from_model(jlm), max_tokens=6))
    got, _ = _run_engine(InProcessBroker, StreamingClassifier, port,
                         px.make_stream_explain_hook(
                             px.OnPodBackend.from_model(plm), max_tokens=6))
    assert got == want
    assert any(b'"analysis"' in v for v in got.values())
    be = px.OnPodBackend.from_model(plm)
    assert (be.generate("why?", temperature=0.0, max_tokens=5)
            == jx.OnPodBackend.from_model(jlm).generate(
                "why?", temperature=0.0, max_tokens=5))


def test_from_hf_checkpoint_int8(tmp_path):
    """The counterpart of ``tests/test_explain.py``'s
    ``test_from_hf_checkpoint_int8``: an int8 load of a synthetic Llama
    checkpoint behind the backend API, its codes equal to the JAX load's;
    at f32 the backend's greedy analyses equal the JAX backend's (bf16 on
    the CPU may round a near-tie apart); with ``mesh=`` (tensor parallelism)
    the int8 codes split part for part and the analyses equal the JAX
    backend's mesh load."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    try:
        from convert_hf_checkpoint import make_synthetic_checkpoint
    finally:
        sys.path.pop(0)
    import jax.numpy as jnp
    import torch

    from fraud_detection_tpu.checkpoint.hf_convert import (
        load_hf_checkpoint as jload)
    from fraud_detection_tpu_torch.explain import OnPodBackend
    from fraud_detection_tpu_torch.models.llm import Q8

    d = str(tmp_path / "ckpt")
    os.makedirs(d)
    make_synthetic_checkpoint(d)
    be = OnPodBackend.from_hf_checkpoint(d, int8=True, tokenizer="byte",
                                         device="cpu")
    out = be.generate_batch(["why is this a scam?"], max_tokens=6)
    assert len(out) == 1 and isinstance(out[0], str)

    jlm = jload(d, tokenizer="byte", int8=True, use_cache=False)
    from fraud_detection_tpu_torch.checkpoint.hf_convert import (
        load_hf_checkpoint)

    plm = load_hf_checkpoint(d, tokenizer="byte", int8=True, device="cpu")
    for name, v in jlm.params.items():
        if isinstance(v, jllm.Q8):
            assert isinstance(plm.params.param(name), Q8)
            np.testing.assert_array_equal(plm.params.param(name).q.numpy(),
                                          np.asarray(v.q))

    j32 = jx.OnPodBackend.from_model(jload(d, tokenizer="byte", int8=True,
                                           dtype=jnp.float32))
    p32 = px.OnPodBackend.from_model(load_hf_checkpoint(
        d, tokenizer="byte", int8=True, dtype=torch.float32, device="cpu"))
    prompts = ["why is this a scam?", "Caller: read me the code now."]
    assert (p32.generate_batch(prompts, max_tokens=6)
            == j32.generate_batch(prompts, max_tokens=6))
    # tensor parallel over a 2-way model axis, int8 leaves split
    # componentwise: the same codes part for part, the same analyses
    from jax.sharding import Mesh as JMesh

    from fraud_detection_tpu_torch.models.llm import Sharded
    from fraud_detection_tpu_torch.parallel.mesh import Mesh

    jmesh = JMesh(np.array(jax.devices()[:2]), ("model",))
    pmesh = Mesh(np.array(["cpu"] * 2, object), ("model",))
    jtp = jx.OnPodBackend.from_hf_checkpoint(d, int8=True, tokenizer="byte",
                                             mesh=jmesh)
    ptp = OnPodBackend.from_hf_checkpoint(d, int8=True, tokenizer="byte",
                                          device="cpu", mesh=pmesh)
    tp = load_hf_checkpoint(d, tokenizer="byte", int8=True, device="cpu",
                            mesh=pmesh)
    wq = tp.params.param("l0.wq")
    assert isinstance(wq, Sharded) and isinstance(wq.parts[0], Q8)
    np.testing.assert_array_equal(wq.gather().q.numpy(),
                                  np.asarray(jlm.params["l0.wq"].q))
    assert (ptp.generate_batch(prompts, max_tokens=6)
            == jtp.generate_batch(prompts, max_tokens=6))
