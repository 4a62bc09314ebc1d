"""The port's CountVectorizer-semantics featurizer (``VocabTfIdfFeaturizer``)
against the JAX package's on the CPU: vocabulary fit, rows, encode,
``featurize_dense``, checkpoints both ways, host-featurize serving, the
device featurizer's refusal, and the training CLI's ``--featurizer
count``."""

import json

import numpy as np
import pytest

from fraud_detection_tpu.checkpoint import native as jnative
from fraud_detection_tpu.data import generate_corpus as jgenerate
from fraud_detection_tpu.featurize.tfidf import VocabTfIdfFeaturizer as JVocab
from fraud_detection_tpu.models.linear import LogisticRegression as JLR
from fraud_detection_tpu_torch.app import train as ptrain
from fraud_detection_tpu_torch.checkpoint import native as pnative
from fraud_detection_tpu_torch.featurize.device import (
    DeviceFeaturizeUnavailable, DeviceFeaturizer)
from fraud_detection_tpu_torch.featurize.text import StopWordFilter
from fraud_detection_tpu_torch.featurize.tfidf import VocabTfIdfFeaturizer
from fraud_detection_tpu_torch.models import linear as plinear
from fraud_detection_tpu_torch.models.pipeline import ServingPipeline

TOY = ["apple apple banana", "apple cherry", "banana cherry cherry",
       "apple banana", "the process99 takes the time", "process takes effort"]


@pytest.fixture(scope="module")
def texts():
    return [d.text for d in jgenerate(n=120, seed=3)]


def _pair(texts, **kw):
    """(JAX, port) featurizers fit on the same texts with the same options."""
    j = JVocab.fit_vocabulary(texts, **kw)
    p = VocabTfIdfFeaturizer.fit_vocabulary(texts, **kw)
    j.fit_idf(texts)
    p.fit_idf(texts)
    return j, p


@pytest.mark.parametrize("kw", [
    dict(vocab_size=2), dict(vocab_size=10, min_df=3), dict(vocab_size=20000),
    dict(vocab_size=50, min_df=0.1), dict(vocab_size=300, min_tf=2.0),
    dict(vocab_size=300, binary_tf=True),
    dict(vocab_size=300, remove_stopwords=False)])
def test_fit_vocabulary_equals_jax(texts, kw):
    corpus = TOY if kw.get("vocab_size", 0) <= 10 else texts
    j, p = _pair(corpus, **kw)
    assert p.vocabulary == j.vocabulary
    assert p.num_features == j.num_features
    np.testing.assert_array_equal(p.idf, np.asarray(j.idf))
    np.testing.assert_array_equal(p.doc_freq, np.asarray(j.doc_freq))


@pytest.mark.parametrize("min_tf", [1.0, 2.0, 0.05])
@pytest.mark.parametrize("binary_tf", [False, True])
def test_rows_encode_and_dense_equal_jax(texts, min_tf, binary_tf):
    j, p = _pair(texts, vocab_size=400, min_tf=min_tf, binary_tf=binary_tf)
    probe = texts[:20] + ["", "!!!", "completely unrelated zzz words"]
    for t in probe:
        for a, b in zip(p.sparse_row(t), j.sparse_row(t)):
            np.testing.assert_array_equal(a, b)
    pe, je = p.encode(probe, batch_size=32), j.encode(probe, batch_size=32)
    np.testing.assert_array_equal(pe.ids, je.ids)
    np.testing.assert_array_equal(pe.counts, je.counts)
    np.testing.assert_array_equal(
        p.featurize_dense(probe, batch_size=32, device="cpu").numpy(),
        np.asarray(j.featurize_dense(probe, batch_size=32)))


def test_bucket_oov_and_no_hasher(texts):
    j, p = _pair(texts, vocab_size=100)
    for term in [*p.vocabulary[:5], "zzzunseen", ""]:
        assert p.bucket(term) == j.bucket(term)
    assert p.bucket("zzzunseen") == -1
    with pytest.raises(TypeError, match="vocabulary"):
        p.hashing_tf
    assert p._native_featurizer() is None
    assert p.encode_json([b'{"text": "apple"}']) is None


def test_device_featurize_refuses_a_vocabulary(texts):
    """The kernel hashes terms; a vocabulary featurizer has no hash, so
    ``--featurize-device`` raises with that reason and never falls back."""
    _, p = _pair(texts, vocab_size=100)
    model = plinear.LogisticRegression.from_arrays(
        np.zeros(p.num_features, np.float32), 0.0, device="cpu")
    with pytest.raises(DeviceFeaturizeUnavailable, match="vocabulary"):
        DeviceFeaturizer(p, device="cpu")
    with pytest.raises(DeviceFeaturizeUnavailable, match="hashes"):
        ServingPipeline(p, model, featurize_device=True, device="cpu")


def _lr_weights(n, seed=0):
    return np.random.default_rng(seed).normal(0, 1, n).astype(np.float32)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_vocab_checkpoint_crosses_both_ways(texts, tmp_path, writer):
    j, p = _pair(texts, vocab_size=300, min_tf=2.0)
    w = _lr_weights(p.num_features)
    path = str(tmp_path / "ckpt")
    if writer == "jax":
        import jax.numpy as jnp

        jnative.save_checkpoint(path, j, JLR(weights=jnp.asarray(w),
                                             intercept=jnp.float32(-0.3)))
        feat, model = pnative.load_checkpoint(path, device="cpu")
        want = j
    else:
        pnative.save_checkpoint(path, p, plinear.LogisticRegression.from_arrays(
            w, -0.3, device="cpu"))
        feat, model = jnative.load_checkpoint(path)
        want = p
    assert type(feat).__name__ == "VocabTfIdfFeaturizer"
    assert list(feat.vocabulary) == list(want.vocabulary)
    assert feat.min_tf == 2.0 and feat.num_docs == want.num_docs
    np.testing.assert_array_equal(np.asarray(feat.idf), np.asarray(want.idf))
    np.testing.assert_array_equal(np.asarray(feat.doc_freq),
                                  np.asarray(want.doc_freq))
    weights = model.weights.numpy() if writer == "jax" else np.asarray(model.weights)
    np.testing.assert_array_equal(weights, w)


def test_vocab_checkpoint_serves_on_host_featurize(texts, tmp_path):
    j, _ = _pair(texts, vocab_size=300)
    import jax.numpy as jnp

    w = _lr_weights(j.num_features, seed=1)
    jnative.save_checkpoint(str(tmp_path / "v"), j,
                            JLR(weights=jnp.asarray(w), intercept=jnp.float32(0.1)))
    pipe = ServingPipeline.from_checkpoint(str(tmp_path / "v"), device="cpu",
                                           batch_size=16)
    assert pipe.device_stats.featurize_path == "host"
    served = pipe.predict(texts[:40])
    dense = pipe.featurizer.featurize_dense(texts[:40], device="cpu")
    labels, p1 = plinear.predict_dense(pipe.model, dense)
    np.testing.assert_array_equal(served.labels, labels.numpy())
    np.testing.assert_allclose(served.probabilities, p1.numpy(), atol=1e-6)
    assert pipe.predict_json_async([b'{"text": "hi"}']) is None


def test_stop_filter_survives_the_checkpoint(tmp_path):
    p = VocabTfIdfFeaturizer.fit_vocabulary(
        TOY, vocab_size=10, stop_filter=StopWordFilter(["apple"], True))
    pnative.save_checkpoint(str(tmp_path / "s"), p,
                            plinear.LogisticRegression.from_arrays(
                                np.zeros(p.num_features), 0.0, device="cpu"))
    back, _ = jnative.load_checkpoint(str(tmp_path / "s"))
    assert back.vocabulary == p.vocabulary and "apple" not in back.vocabulary
    assert back.stop_filter.words == ["apple"]
    assert back.stop_filter.case_sensitive is True


def test_train_cli_count_featurizer_equals_jax(tmp_path):
    from fraud_detection_tpu.app import train as jtrain

    argv = ["--n", "200", "--models", "lr", "--featurizer", "count",
            "--vocab-size", "512"]
    assert ptrain.main(["--device", "cpu", *argv, "--save",
                        f"lr={tmp_path / 'port'}", "--metrics-out",
                        str(tmp_path / "port.json")]) == 0
    assert jtrain.main([*argv, "--save", f"lr={tmp_path / 'jax'}",
                        "--metrics-out", str(tmp_path / "jax.json")]) == 0
    pfeat, _ = pnative.load_checkpoint(str(tmp_path / "port"), device="cpu")
    jfeat, _ = jnative.load_checkpoint(str(tmp_path / "jax"))
    assert isinstance(pfeat, VocabTfIdfFeaturizer)
    assert pfeat.vocabulary == jfeat.vocabulary and pfeat.num_features == 512
    np.testing.assert_array_equal(pfeat.idf, np.asarray(jfeat.idf))
    pmeta = json.loads((tmp_path / "port.json").read_text())["meta"]
    jmeta = json.loads((tmp_path / "jax.json").read_text())["meta"]
    assert pmeta["vocab_size"] == jmeta["vocab_size"] == 512
    assert "num_features" not in pmeta and pmeta["featurizer"] == "count"
    pipe = ServingPipeline.from_checkpoint(str(tmp_path / "port"), device="cpu")
    texts = [d.text for d in jgenerate(n=30, seed=9)]
    dense = pipe.featurizer.featurize_dense(texts, device="cpu")
    np.testing.assert_array_equal(
        pipe.predict(texts).labels,
        plinear.predict_dense(pipe.model, dense)[0].numpy())
    np.testing.assert_array_equal(dense.numpy(),
                                  np.asarray(jfeat.featurize_dense(texts)))
