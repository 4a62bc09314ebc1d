"""The port's Spark ``PipelineModel`` writer
(``fraud_detection_tpu_torch/checkpoint/spark_writer.py``): twins of the
eight cases of ``tests/test_spark_writer.py`` on the port's own fits (on the
CPU), and the cross cases — the port's artifacts read by the JAX package's
reader and served by its pipeline, and their parquet files against the JAX
writer's (pyarrow reads the same rows and the same parquet schema)."""

import glob
import json
import os

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from fraud_detection_tpu_torch.checkpoint import (load_spark_pipeline,
                                                  save_spark_pipeline)
from fraud_detection_tpu_torch.featurize.tfidf import (HashingTfIdfFeaturizer,
                                                       VocabTfIdfFeaturizer)
from fraud_detection_tpu_torch.models.pipeline import ServingPipeline


@pytest.fixture(scope="module")
def corpus():
    from fraud_detection_tpu_torch.data import generate_corpus

    dialogues = generate_corpus(n=300, seed=21)
    return [d.text for d in dialogues], np.asarray([d.label for d in dialogues])


def _dense(feat, texts):
    return feat.featurize_dense(texts, device="cpu").numpy()


def _assert_roundtrip(tmp_path, featurizer, model, texts):
    orig = ServingPipeline(featurizer, model, batch_size=64, device="cpu")
    save_spark_pipeline(str(tmp_path / "export"), featurizer, model)
    loaded = ServingPipeline.from_spark_artifact(
        load_spark_pipeline(str(tmp_path / "export")), batch_size=64,
        device="cpu")
    a, b = orig.predict(texts[:64]), loaded.predict(texts[:64])
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_allclose(a.probabilities, b.probabilities, atol=1e-6)


def test_lr_hashing_idf_roundtrip(tmp_path, corpus):
    from fraud_detection_tpu_torch.models.train_linear import fit_logistic_regression

    texts, y = corpus
    feat = HashingTfIdfFeaturizer(num_features=2048)
    feat.fit_idf(texts)
    model = fit_logistic_regression(_dense(feat, texts), y.astype(np.float32),
                                    max_iter=20, device="cpu")
    _assert_roundtrip(tmp_path, feat, model, texts)


def test_dt_count_vectorizer_roundtrip(tmp_path, corpus):
    from fraud_detection_tpu_torch.models.train_trees import (TreeTrainConfig,
                                                              fit_decision_tree)

    texts, y = corpus
    feat = VocabTfIdfFeaturizer.fit_vocabulary(texts, vocab_size=1024)
    feat.fit_idf(texts)
    model = fit_decision_tree(_dense(feat, texts), y,
                              config=TreeTrainConfig(max_depth=4), device="cpu")
    _assert_roundtrip(tmp_path, feat, model, texts)


def test_rf_roundtrip_with_tree_weights(tmp_path, corpus):
    from fraud_detection_tpu_torch.models.train_trees import (TreeTrainConfig,
                                                              fit_random_forest)

    texts, y = corpus
    feat = HashingTfIdfFeaturizer(num_features=1024)
    feat.fit_idf(texts)
    model = fit_random_forest(_dense(feat, texts), y, n_trees=8, tree_chunk=4,
                              config=TreeTrainConfig(max_depth=4), device="cpu")
    _assert_roundtrip(tmp_path, feat, model, texts)


def test_xgboost_exports_as_gbt_with_identical_probabilities(tmp_path, corpus):
    """sigmoid(margin) ensembles export as Spark GBT (sigmoid(2*margin))
    with halved tree weights and the bias folded into tree 0."""
    from fraud_detection_tpu_torch.models.train_trees import (
        TreeTrainConfig, fit_gradient_boosting)

    texts, y = corpus
    keep = np.concatenate([np.where(y == 1)[0][:40], np.where(y == 0)[0]])
    texts = [texts[i] for i in keep]
    y = y[keep]
    feat = HashingTfIdfFeaturizer(num_features=1024)
    feat.fit_idf(texts)
    model = fit_gradient_boosting(
        _dense(feat, texts), y, n_rounds=10,
        config=TreeTrainConfig(max_depth=3, criterion="xgb"), device="cpu")
    assert abs(model.bias) > 1e-6, "expected a nonzero base-score bias"
    save_spark_pipeline(str(tmp_path / "gbt"), feat, model)
    art = load_spark_pipeline(str(tmp_path / "gbt"))
    assert art.tree_ensemble.kind == "gbt"
    loaded = ServingPipeline.from_spark_artifact(art, batch_size=64,
                                                 device="cpu")
    orig = ServingPipeline(feat, model, batch_size=64, device="cpu")
    a, b = orig.predict(texts[:64]), loaded.predict(texts[:64])
    np.testing.assert_allclose(a.probabilities, b.probabilities, atol=1e-5)
    np.testing.assert_array_equal(a.labels, b.labels)


def test_written_layout_matches_spark_shape(tmp_path, corpus):
    from fraud_detection_tpu_torch.models.train_linear import fit_logistic_regression

    texts, y = corpus
    feat = HashingTfIdfFeaturizer(num_features=512)
    feat.fit_idf(texts)
    model = fit_logistic_regression(_dense(feat, texts), y.astype(np.float32),
                                    max_iter=5, device="cpu")
    out = str(tmp_path / "layout")
    save_spark_pipeline(out, feat, model)

    meta = json.loads(open(os.path.join(out, "metadata", "part-00000")).readline())
    assert meta["class"] == "org.apache.spark.ml.PipelineModel"
    uids = meta["paramMap"]["stageUids"]
    assert [u.split("_")[0] for u in uids] == [
        "Tokenizer", "StopWordsRemover", "HashingTF", "IDFModel",
        "LogisticRegressionModel"]
    stage_dirs = sorted(os.listdir(os.path.join(out, "stages")))
    assert len(stage_dirs) == 5
    for d in stage_dirs:
        assert os.path.isfile(os.path.join(out, "stages", d, "metadata", "part-00000"))


def test_no_stopword_featurizer_roundtrip(tmp_path, corpus):
    from fraud_detection_tpu_torch.models.train_linear import fit_logistic_regression

    texts, y = corpus
    feat = HashingTfIdfFeaturizer(num_features=2048, remove_stopwords=False)
    feat.fit_idf(texts)
    model = fit_logistic_regression(_dense(feat, texts), y.astype(np.float32),
                                    max_iter=20, device="cpu")
    _assert_roundtrip(tmp_path, feat, model, texts)
    loaded = ServingPipeline.from_spark_artifact(
        load_spark_pipeline(str(tmp_path / "export")), batch_size=64,
        device="cpu")
    assert loaded.featurizer.remove_stopwords is False


def test_tree_stage_records_num_features(tmp_path, corpus):
    from fraud_detection_tpu_torch.models.train_trees import (TreeTrainConfig,
                                                              fit_decision_tree)

    texts, y = corpus
    feat = HashingTfIdfFeaturizer(num_features=2048)
    feat.fit_idf(texts)
    model = fit_decision_tree(_dense(feat, texts), y,
                              config=TreeTrainConfig(max_depth=3), device="cpu")
    save_spark_pipeline(str(tmp_path / "export"), feat, model)
    [meta_path] = glob.glob(
        str(tmp_path / "export" / "stages" / "*DecisionTree*" / "metadata" / "part-00000"))
    with open(meta_path) as fh:
        meta = json.loads(fh.read())
    assert meta["paramMap"]["numFeatures"] == 2048


def test_random_ensemble_roundtrip_property(tmp_path):
    """Randomly structured ensembles (ragged trees, extreme thresholds and
    counts, 2-3 classes, per-tree weights) survive write -> load with
    identical traversal results."""
    from fraud_detection_tpu_torch.models.trees import TreeEnsemble, predict_proba

    rng = np.random.default_rng(123)
    F = 64

    def rand_tree(M, C, depth):
        feature = np.full(M, -1, np.int32)
        thr = np.zeros(M, np.float32)
        left = np.full(M, -1, np.int32)
        right = np.full(M, -1, np.int32)
        leaf = np.zeros((M, C), np.float32)
        slot = [1]

        def build(i, d):
            if d == 0 or rng.random() < 0.35 or slot[0] + 2 > M:
                leaf[i] = (rng.random(C) + 0.01) * rng.choice([1.0, 500.0, 0.01])
                return
            feature[i] = rng.integers(0, F)
            thr[i] = float(rng.normal() * rng.choice([1.0, 1e3, 1e-3]))
            l, r = slot[0], slot[0] + 1
            slot[0] += 2
            left[i], right[i] = l, r
            build(l, d - 1)
            build(r, d - 1)

        build(0, depth)
        return feature, thr, left, right, leaf

    for trial in range(6):
        C = int(rng.integers(2, 4))
        depth = int(rng.integers(1, 6))
        n_trees = int(rng.integers(1, 7))
        M = 2 ** (depth + 1) - 1
        parts = [rand_tree(M, C, depth) for _ in range(n_trees)]
        kind = "decision_tree" if n_trees == 1 else "random_forest"
        t = lambda k: torch.from_numpy(np.stack([p[k] for p in parts]))
        ens = TreeEnsemble(
            feature=t(0), threshold=t(1), left=t(2), right=t(3), leaf=t(4),
            tree_weights=torch.from_numpy(
                rng.random(n_trees).astype(np.float32) + 0.5),
            kind=kind, max_depth=depth)
        feat = HashingTfIdfFeaturizer(num_features=F)
        feat.fit_idf(["some scam text to give idf a corpus", "another text"])
        path = str(tmp_path / f"export{trial}")
        save_spark_pipeline(path, feat, ens)
        loaded = ServingPipeline.from_spark_artifact(
            load_spark_pipeline(path), batch_size=8, device="cpu").model
        X = torch.from_numpy(rng.normal(size=(32, F)).astype(np.float32) * 100)
        np.testing.assert_allclose(
            predict_proba(ens, X).numpy(), predict_proba(loaded, X).numpy(),
            atol=1e-6, err_msg=f"trial {trial} kind={kind} C={C} depth={depth}")


# --- cross cases: the port's artifacts in the JAX package -------------------

@pytest.fixture(scope="module")
def twins(corpus):
    """JAX fits of every exported shape with their port twins (the same
    arrays)."""
    from fraud_detection_tpu.featurize.tfidf import (
        HashingTfIdfFeaturizer as JFeat, VocabTfIdfFeaturizer as JVocab)
    from fraud_detection_tpu.models.train_linear import (
        fit_logistic_regression as jfit_lr)
    from fraud_detection_tpu.models.train_trees import (
        TreeTrainConfig, fit_decision_tree, fit_gradient_boosting,
        fit_random_forest)
    from torch_parity import port_featurizer, port_model

    texts, y = corpus
    jfeat = JFeat(num_features=1024)
    jfeat.fit_idf(texts)
    X = np.asarray(jfeat.featurize_dense(texts))
    jvocab = JVocab.fit_vocabulary(texts, vocab_size=512)
    jvocab.fit_idf(texts)
    Xv = np.asarray(jvocab.featurize_dense(texts))
    jplain = JFeat(num_features=1024, remove_stopwords=False)
    jplain.fit_idf(texts)
    Xp = np.asarray(jplain.featurize_dense(texts))
    keep = np.concatenate([np.where(y == 1)[0][:40], np.where(y == 0)[0]])

    def pfeat(jf):
        if isinstance(jf, JVocab):
            from fraud_detection_tpu_torch.featurize.text import StopWordFilter

            out = VocabTfIdfFeaturizer(
                vocabulary=list(jf.vocabulary), min_tf=jf.min_tf,
                idf=np.asarray(jf.idf), binary_tf=jf.binary_tf,
                stop_filter=StopWordFilter(jf.stop_filter.words,
                                           jf.stop_filter.case_sensitive),
                remove_stopwords=jf.remove_stopwords)
        else:
            out = port_featurizer(jf)
        out.doc_freq, out.num_docs = jf.doc_freq, jf.num_docs
        return out

    fits = {
        "lr": (jfeat, jfit_lr(X, y.astype(np.float32), max_iter=20)),
        "dt_vocabulary": (jvocab, fit_decision_tree(
            Xv, y, config=TreeTrainConfig(max_depth=4))),
        "rf": (jfeat, fit_random_forest(X, y, n_trees=8, tree_chunk=4,
                                        config=TreeTrainConfig(max_depth=4))),
        "xgb": (jfeat, fit_gradient_boosting(
            X[keep], y[keep], n_rounds=10,
            config=TreeTrainConfig(max_depth=3, criterion="xgb"))),
        "lr_no_stopwords": (jplain, jfit_lr(Xp, y.astype(np.float32),
                                            max_iter=20)),
    }
    return {k: (jf, jm, pfeat(jf), port_model(jm))
            for k, (jf, jm) in fits.items()}


@pytest.mark.parametrize("name", ["lr", "dt_vocabulary", "rf", "xgb",
                                  "lr_no_stopwords"])
def test_port_written_artifact_serves_in_the_jax_package(tmp_path, corpus,
                                                         twins, name):
    """The port's writer -> the JAX reader -> the JAX pipeline, against the
    port's pipeline on the same artifact: labels equal, p within 1e-6
    (xgb exported as GBT: 1e-5)."""
    from fraud_detection_tpu.checkpoint import load_spark_pipeline as jload
    from fraud_detection_tpu.models.pipeline import ServingPipeline as JPipe

    texts, _ = corpus
    _, _, pfeat, pmodel = twins[name]
    path = str(tmp_path / name)
    save_spark_pipeline(path, pfeat, pmodel)
    theirs = JPipe.from_spark_artifact(jload(path), batch_size=64)
    ours = ServingPipeline.from_spark_artifact(load_spark_pipeline(path),
                                               batch_size=64, device="cpu")
    a, b = theirs.predict(texts[:128]), ours.predict(texts[:128])
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_allclose(a.probabilities, b.probabilities, rtol=0,
                               atol=1e-5 if name == "xgb" else 1e-6)
    assert theirs.featurizer.remove_stopwords == pfeat.remove_stopwords


@pytest.mark.parametrize("name", ["lr", "dt_vocabulary", "rf", "xgb",
                                  "lr_no_stopwords"])
def test_port_files_equal_the_jax_writers(tmp_path, twins, name):
    """Stage for stage, the same metadata (but uid and timestamp) and, for
    every parquet file, pyarrow reads the port's with the JAX file's rows
    and parquet schema."""
    from fraud_detection_tpu.checkpoint import save_spark_pipeline as jsave

    jf, jm, pfeat, pmodel = twins[name]
    a, b = tmp_path / "port", tmp_path / "jax"
    save_spark_pipeline(str(a), pfeat, pmodel)
    jsave(str(b), jf, jm)
    sa, sb = sorted((a / "stages").iterdir()), sorted((b / "stages").iterdir())
    assert [d.name.split("_")[:2] for d in sa] == \
        [d.name.split("_")[:2] for d in sb]

    def meta(d):
        m = json.loads((d / "metadata" / "part-00000").read_text())
        return {k: v for k, v in m.items() if k not in ("uid", "timestamp")}

    n_files = 0
    for da, db in zip(sa, sb):
        assert meta(da) == meta(db)
        fa = sorted(p.relative_to(da) for p in da.rglob("*.parquet"))
        assert fa == sorted(p.relative_to(db) for p in db.rglob("*.parquet"))
        for rel in fa:
            ta, tb = pq.read_table(da / rel), pq.read_table(db / rel)
            assert ta.to_pylist() == tb.to_pylist(), rel
            assert pq.ParquetFile(da / rel).schema.equals(
                pq.ParquetFile(db / rel).schema), rel
            n_files += 1
    assert n_files >= 1
