"""The port's word-association analysis (``eval/word_associations.py``)
against the JAX package's on the CPU: the side vocabulary, feature
importances and associations of one model of each family (LR, decision
tree, forest, boosting) over the hashing and the vocabulary featurizer, and
the training CLI's ``--associations``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from fraud_detection_tpu.data import generate_corpus as jgenerate
from fraud_detection_tpu.eval import word_associations as jwa
from fraud_detection_tpu.featurize.tfidf import HashingTfIdfFeaturizer as JFeat
from fraud_detection_tpu.featurize.tfidf import VocabTfIdfFeaturizer as JVocab
from fraud_detection_tpu.models import train_trees as jt
from fraud_detection_tpu.models.linear import LogisticRegression as JLR
from fraud_detection_tpu_torch.app import train as ptrain
from fraud_detection_tpu_torch.eval import word_associations as pwa
from fraud_detection_tpu_torch.featurize.tfidf import VocabTfIdfFeaturizer
from tests.torch_parity import port_featurizer, port_model


@pytest.fixture(scope="module")
def corpus():
    docs = jgenerate(n=300, seed=21)
    return [d.text for d in docs], [d.label for d in docs]


@pytest.fixture(scope="module", params=["hashing", "vocab"])
def featurizers(request, corpus):
    """(JAX, port) featurizers with the same vocabulary or hash space."""
    texts, _ = corpus
    if request.param == "hashing":
        j = JFeat(num_features=2048)
        j.fit_idf(texts)
        return j, port_featurizer(j)
    j = JVocab.fit_vocabulary(texts, vocab_size=1500)
    p = VocabTfIdfFeaturizer.fit_vocabulary(texts, vocab_size=1500)
    j.fit_idf(texts)
    p.fit_idf(texts)
    return j, p


def _dense(feat, texts):
    return np.asarray(feat.featurize_dense(texts, batch_size=len(texts)))


def _jax_model(kind, X, y):
    cfg = jt.TreeTrainConfig(max_depth=4, use_pallas=True)
    if kind == "lr":
        w = np.random.default_rng(5).normal(0, 1, X.shape[1]).astype(np.float32)
        return JLR(weights=jnp.asarray(w), intercept=jnp.float32(0.2))
    if kind == "dt":
        return jt.fit_decision_tree(X, y, config=cfg)
    if kind == "rf":
        return jt.fit_random_forest(X, y, n_trees=4, tree_chunk=4, config=cfg)
    return jt.fit_gradient_boosting(X, y, n_rounds=3)


def test_side_vocabulary_equals_jax(featurizers, corpus):
    (jf, pf), (texts, _) = featurizers, corpus
    jv = jwa.SideVocabulary(jf).add_corpus(texts)
    pv = pwa.SideVocabulary(pf).add_corpus(texts)
    assert len(pv) == len(jv)
    assert {b: dict(c) for b, c in pv.buckets.items()} == \
        {b: dict(c) for b, c in jv.buckets.items()}
    for b in list(jv.buckets)[:50] + [jf.num_features + 7]:
        assert pv.terms(b) == jv.terms(b) and pv.label(b) == jv.label(b)


@pytest.mark.parametrize("kind", ["lr", "dt", "rf", "xgb"])
def test_importances_and_associations_equal_jax(featurizers, corpus, kind):
    (jf, pf), (texts, labels) = featurizers, corpus
    X, y = _dense(jf, texts), np.asarray(labels)
    jmodel = _jax_model(kind, X, y)
    pmodel = port_model(jmodel)
    want_imp = jwa.model_feature_importances(jmodel, X, y)
    got_imp = pwa.model_feature_importances(pmodel, X, y)
    np.testing.assert_array_equal(got_imp, want_imp)
    want = jwa.analyze_word_associations(jmodel, jf, texts, labels, top_n=12)
    got = pwa.analyze_word_associations(pmodel, pf, texts, labels, top_n=12,
                                        device="cpu")
    assert [dataclasses.asdict(a) for a in got] == \
        [dataclasses.asdict(a) for a in want]
    assert [a.scam_ratio for a in got] == [a.scam_ratio for a in want]
    assert got, "no association found"


def test_tree_importances_need_the_data():
    tree = port_model(jt.fit_decision_tree(
        np.eye(4, dtype=np.float32), np.array([0, 1, 0, 1]),
        config=jt.TreeTrainConfig(max_depth=2, use_pallas=True)))
    with pytest.raises(ValueError, match="training data"):
        pwa.model_feature_importances(tree)
    with pytest.raises(TypeError, match="unsupported"):
        pwa.model_feature_importances(object())


def test_train_cli_associations(capsys):
    assert ptrain.main(["--device", "cpu", "--n", "200", "--num-features",
                        "512", "--models", "dt,lr", "--associations", "5"]) == 0
    out = capsys.readouterr().out
    for name in ("dt", "lr"):
        block = out.split(f"=== word associations: {name} ===\n")[1]
        rows = [r for r in block.splitlines()[:5] if "importance=" in r]
        assert len(rows) == 5, block
