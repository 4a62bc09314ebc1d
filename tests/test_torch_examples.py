"""The port's runnable examples (``examples/torch_*.py``) against the JAX
package's (``examples/*.py``), on the CPU under ``--device cpu``.

Each twin's ``run`` returns its exit code and the values the JAX example
prints; the JAX side runs the JAX example's own functions on the same
seeds. Timings and rates are never compared.

* serve and streaming quickstarts: labels equal and p(scam) within 1e-6;
  the stream's processed and malformed counts, every output key's label
  and the annotated keys equal the JAX pipeline's on the same messages.
* HF checkpoint: the greedy reply equals the JAX backend's, or the two
  part at a token where the JAX model's own two logits are one bf16 step
  apart or less (bf16 logits tie often on these random weights; at the
  demo's prompt the JAX decoder's cached step and its full forward already
  pick different tokens of such a tie), at bf16 and under ``--int8``.
* hot swap: v1 and v2 label the feeder corpus as the JAX versions do, p
  within 1e-3 (30 L-BFGS iterations stop short of convergence, where the
  two packages' f32 reduction orders part the iterates). The
  promotion itself is not compared with a JAX run: the two versions
  disagree on ~5% of the feeder corpus, the policy's bar is 5%, so which
  rows the shadow scorer samples decides it in both packages. The run
  must deliver every message once, and its active version and swaps must
  follow its own audited decision.

The train quickstart and the game-day twins are
``tests/test_torch_examples_gamedays.py``.
"""

import contextlib
import io
import tempfile

import numpy as np
import pytest

import examples.torch_convert_hf_checkpoint as TC
import examples.torch_hot_swap_demo as TH
import examples.torch_serve_quickstart as TS
import examples.torch_streaming_demo as TSD
from tests.torch_parity import port_featurizer, port_model

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def jax_demo():
    """The JAX serve quickstart's pipeline: its synthetic demo model, with
    its artifact path emptied so that it looks for no artifact."""
    from examples import serve_quickstart

    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(serve_quickstart, "ARTIFACT", "")
        return serve_quickstart.build_pipeline()


def test_serve_quickstart_equals_jax(jax_demo, monkeypatch):
    from examples import serve_quickstart as JS

    assert (TS.SCAM, TS.BENIGN) == (JS.SCAM, JS.BENIGN)
    monkeypatch.delenv(TS.ARTIFACT_ENV, raising=False)
    got = TS.run(CPU)
    assert got["exit_code"] == 0
    for name, text in (("scam-like", JS.SCAM), ("benign", JS.BENIGN)):
        label, p = jax_demo.predict_one(text)
        assert got["scored"][name][0] == int(label), name
        assert abs(got["scored"][name][1] - float(p)) <= 1e-6, name


def test_serve_quickstart_serves_the_named_artifact(tmp_path, monkeypatch,
                                                   capsys):
    """With ``FRAUD_TPU_SPARK_ARTIFACT`` naming a Spark save directory, the
    twin serves that artifact: its scores equal the pipeline loaded from it
    directly."""
    from fraud_detection_tpu_torch.checkpoint.spark_artifact import (
        load_spark_pipeline)
    from fraud_detection_tpu_torch.checkpoint.spark_writer import (
        save_spark_pipeline)
    from fraud_detection_tpu_torch.models.pipeline import (
        ServingPipeline, synthetic_demo_pipeline)

    demo = synthetic_demo_pipeline(device="cpu")
    save_spark_pipeline(str(tmp_path / "art"), demo.featurizer, demo.model)
    monkeypatch.setenv(TS.ARTIFACT_ENV, str(tmp_path / "art"))
    got = TS.run(CPU)
    assert got["exit_code"] == 0
    assert "using the shipped Spark artifact" in capsys.readouterr().out
    want = ServingPipeline.from_spark_artifact(
        load_spark_pipeline(str(tmp_path / "art")), batch_size=16,
        device="cpu")
    for name, text in (("scam-like", TS.SCAM), ("benign", TS.BENIGN)):
        label, p = want.predict_one(text)
        assert got["scored"][name] == (int(label), float(p)), name


def test_streaming_demo_equals_jax(jax_demo, monkeypatch, capsys):
    """The JAX example's own ``main`` on its pipeline (at the engine's
    batch) and the twin on the port's twin of that pipeline's arrays (the
    two packages' 50-iteration L-BFGS fits stop short of convergence and
    part by up to ~0.1 in p on this corpus; the fit itself is held against
    the JAX one where it converges, in ``tests/test_torch_train_linear.py``):
    the counts of the printed line, every output key's label and the
    annotated keys equal."""
    from examples import serve_quickstart, streaming_demo
    from fraud_detection_tpu.data import generate_corpus
    from fraud_detection_tpu.models.pipeline import ServingPipeline as JPipe
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline

    jpipe = JPipe(jax_demo.featurizer, jax_demo.model, batch_size=128)
    tpipe = ServingPipeline(port_featurizer(jax_demo.featurizer),
                            port_model(jax_demo.model), batch_size=128,
                            device="cpu")
    monkeypatch.setattr(serve_quickstart, "build_pipeline",
                        lambda batch_size=16: jpipe)
    monkeypatch.setattr(TS, "build_pipeline",
                        lambda batch_size=16, device="cuda": tpipe)
    streaming_demo.main()
    jline = capsys.readouterr().out
    got = TSD.run(CPU)
    assert got["exit_code"] == 0
    assert f"processed={got['processed']} malformed={got['malformed']} " \
        in jline
    assert (got["processed"], got["malformed"]) == (501, 1)
    texts = [d.text for d in generate_corpus(n=500, seed=11)]
    want = jpipe.predict(texts).labels.tolist()
    assert got["labels"] == {str(i).encode(): want[i]
                             for i in range(500)} | {b"oops": None}
    flagged = sorted(str(i).encode() for i in range(500) if want[i] == 1)
    assert got["annotated"] == flagged
    assert f"async annotations on side topic: {len(flagged)} " in jline


def _bf16_step(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7) if x else 0.0


@pytest.mark.parametrize("int8", [False, True])
def test_convert_hf_checkpoint_equals_jax(int8):
    import jax.numpy as jnp

    from examples.convert_hf_checkpoint import make_synthetic_checkpoint
    from fraud_detection_tpu.checkpoint.hf_convert import load_hf_checkpoint
    from fraud_detection_tpu.explain.backends import frame_prompt
    from fraud_detection_tpu.explain.onpod import flatten_chat
    from fraud_detection_tpu.models import llm as jllm
    from tests.test_hf_convert import make_hf_config, make_hf_state

    assert TC.make_hf_config() == make_hf_config()
    for a, b in zip(TC.make_hf_state(make_hf_config(), seed=7).items(),
                    make_hf_state(make_hf_config(), seed=7).items()):
        assert a[0] == b[0] and np.array_equal(a[1], b[1])
    got = TC.run(CPU + (["--int8"] if int8 else []))
    assert got["exit_code"] == 0
    with tempfile.TemporaryDirectory() as d:
        make_synthetic_checkpoint(d)
        lm = load_hf_checkpoint(d, max_seq=128, tokenizer="byte", int8=int8)
    prompt = lm.tokenizer.encode(flatten_chat(frame_prompt(
        "Classify this call: 'you won a prize, read me your SSN'.")))
    want = np.asarray(lm.generate_tokens(prompt, max_new_tokens=256,
                                         temperature=0.0))
    reply = lm.tokenizer.decode(want)
    if got["reply"] == reply:
        return
    i = next(i for i, (a, b) in enumerate(zip(got["reply"], reply))
             if a != b)
    assert got["reply"][:i] == reply[:i]
    logits, _ = jllm.forward(lm.params, jnp.asarray(
        np.concatenate([prompt, want[:i]])[None]), lm.cfg)
    last = np.asarray(logits[0, -1], np.float64)
    ours, theirs = last[ord(got["reply"][i])], last[want[i]]
    top = last.max()
    assert top - min(ours, theirs) <= _bf16_step(top), (i, ours, theirs)


def test_hot_swap_demo_versions_equal_jax_and_delivery_exact():
    from examples import hot_swap_demo as JH
    from fraud_detection_tpu.data import generate_corpus
    from fraud_detection_tpu.models.pipeline import ServingPipeline as JPipe
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline

    texts = [d.text for d in generate_corpus(n=1000, seed=11)]
    labels = {}
    for seed in (7, 8):
        jfeat, jmodel = JH.train(seed)
        tfeat, tmodel = TH.train(seed, device="cpu")
        jp = JPipe(jfeat, jmodel, batch_size=128).predict(texts)
        tp = ServingPipeline(tfeat, tmodel, batch_size=128,
                             device="cpu").predict(texts)
        np.testing.assert_array_equal(tp.labels, jp.labels)
        np.testing.assert_allclose(tp.probabilities, jp.probabilities,
                                   rtol=0, atol=1e-3)
        labels[seed] = tp.labels
    assert 0.02 < np.mean(labels[7] != labels[8]) < 0.1
    got = TH.run(CPU)
    assert got["exit_code"] == 0
    assert got["delivered"] == got["unique_keys"] == got["fed"] == 30_000
    events = got["audit_events"]
    assert events[:3] == ["publish", "publish", "stage"]
    assert events[3:] in (["promote"], ["reject"])
    promoted = events[-1] == "promote"
    assert (got["active_version"], got["swaps"]) == (
        (2, 1) if promoted else (1, 0))

