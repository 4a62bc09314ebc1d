"""The port's Spark ``PipelineModel`` reader
(``fraud_detection_tpu_torch/checkpoint/spark_artifact.py``) — twins of
``tests/test_spark_artifact.py`` — and what it serves
(``ServingPipeline.from_spark_artifact``, ``trees.from_spark_stage``),
held against the JAX package on the same artifacts: artifacts the JAX
writer makes in the test, and the committed fixture
``tests/data/torch_spark_fixture`` (the shipped artifact's layout, written
by pyarrow in Spark's column types; ``scripts/make_torch_spark_fixture.py``
remakes it). Also the wide HashingTF space (262,144 features), which the
port serves on host featurize through the two-array layout."""

import json
import pathlib
import shutil

import numpy as np
import pytest

from fraud_detection_tpu.checkpoint import load_spark_pipeline as jload
from fraud_detection_tpu.checkpoint import save_spark_pipeline as jsave
from fraud_detection_tpu.checkpoint import spark_artifact as jart
from fraud_detection_tpu.featurize.tfidf import (HashingTfIdfFeaturizer,
                                                 VocabTfIdfFeaturizer)
from fraud_detection_tpu.models import trees as jtrees
from fraud_detection_tpu.models.pipeline import ServingPipeline as JPipe
from fraud_detection_tpu_torch.checkpoint import load_spark_pipeline
from fraud_detection_tpu_torch.checkpoint.spark_artifact import (
    _decode_matrix,
    _decode_vector,
)
from fraud_detection_tpu_torch.featurize.device import (
    DeviceFeaturizeUnavailable)
from fraud_detection_tpu_torch.models import trees as ptrees
from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
from torch_parity import port_featurizer, port_model

FIXTURE = pathlib.Path(__file__).resolve().parent / "data" / "torch_spark_fixture"
TOL = 1e-6          # tests/test_spark_writer.py's round-trip bound
GBT_TOL = 1e-5      # its xgb -> GBT bound


def test_decode_dense_vector():
    v = _decode_vector({"type": 1, "size": None, "indices": None, "values": [1.0, -2.0]})
    assert np.allclose(v, [1.0, -2.0])


def test_decode_sparse_vector():
    v = _decode_vector({"type": 0, "size": 5, "indices": [1, 3], "values": [2.0, 4.0]})
    assert np.allclose(v, [0, 2.0, 0, 4.0, 0])


def test_decode_sparse_matrix_csr_transposed():
    m = _decode_matrix({
        "type": 0, "numRows": 1, "numCols": 4,
        "colPtrs": [0, 2], "rowIndices": [1, 3], "values": [5.0, 7.0],
        "isTransposed": True,
    })
    assert m.shape == (1, 4)
    assert np.allclose(m, [[0, 5.0, 0, 7.0]])


def test_decode_sparse_matrix_csc():
    m = _decode_matrix({
        "type": 0, "numRows": 2, "numCols": 2,
        "colPtrs": [0, 1, 2], "rowIndices": [0, 1], "values": [1.0, 2.0],
        "isTransposed": False,
    })
    assert np.allclose(m, [[1.0, 0], [0, 2.0]])


@pytest.mark.parametrize("struct", [
    {"type": 1, "numRows": 2, "numCols": 3, "values": [1.0, 2, 3, 4, 5, 6],
     "isTransposed": False},
    {"type": 1, "numRows": 2, "numCols": 3, "values": [1.0, 2, 3, 4, 5, 6],
     "isTransposed": True},
    {"type": 0, "numRows": 3, "numCols": 2, "colPtrs": [0, 2, 3],
     "rowIndices": [0, 2, 1], "values": [1.0, 2.0, 3.0], "isTransposed": False},
    {"type": 0, "numRows": 2, "numCols": 3, "colPtrs": [0, 1, 3],
     "rowIndices": [2, 0, 1], "values": [1.0, 2.0, 3.0], "isTransposed": True},
])
def test_decode_matrix_equals_the_reference(struct):
    np.testing.assert_array_equal(_decode_matrix(struct),
                                  jart._decode_matrix(struct))


def test_load_fixture_in_the_shipped_layout():
    """The committed fixture has the shipped artifact's shape
    (SURVEY.md §2.2): five stages, HashingTF(10000), IDF over 1,150
    documents, a sparse LR with 4,081 non-zeros on trained buckets."""
    art = load_spark_pipeline(str(FIXTURE))
    assert art.spark_version == "3.5.5"
    assert len(art.stages) == 5
    htf = art.hashing_tf
    assert htf.num_features == 10000 and htf.binary is False
    idf = art.idf
    assert idf.num_docs == 1150
    assert idf.idf.shape == idf.doc_freq.shape == (10000,)
    expected = np.log((idf.num_docs + 1.0) / (idf.doc_freq + 1.0))
    assert np.allclose(idf.idf, expected, rtol=1e-12)
    lr = art.logistic_regression
    assert lr.num_classes == 2 and not lr.is_multinomial
    assert lr.coefficients.shape == (10000,)
    assert np.count_nonzero(lr.coefficients) == 4081
    assert lr.threshold == 0.5
    assert np.all(idf.doc_freq[np.nonzero(lr.coefficients)[0]] > 0)
    assert len(art.stopwords.stopwords) == 181


def test_fixture_stages_equal_the_jax_readers():
    ours, theirs = load_spark_pipeline(str(FIXTURE)), jload(str(FIXTURE))
    assert len(ours.stages) == len(theirs.stages)
    for a, b in zip(ours.stages, theirs.stages):
        assert type(a).__name__ == type(b).__name__
        for k, v in vars(b).items():
            got = getattr(a, k)
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got, v)
                assert got.dtype == v.dtype
            else:
                assert got == v, k


def test_fixture_reproduces_expected_json():
    """The fixture served by the port on the CPU gives the JAX pipeline's
    recorded labels, and its probabilities within 1e-6."""
    from fraud_detection_tpu_torch.data import generate_corpus

    exp = json.loads((FIXTURE / "expected.json").read_text())
    texts = [d.text for d in generate_corpus(**exp["corpus"])]
    pipe = ServingPipeline.from_spark_artifact(
        load_spark_pipeline(str(FIXTURE)), batch_size=64, device="cpu")
    got = pipe.predict(texts)
    np.testing.assert_array_equal(got.labels, exp["labels"])
    np.testing.assert_allclose(got.probabilities, exp["probabilities"],
                               rtol=0, atol=TOL)
    assert 0 < got.labels.sum() < len(texts)


@pytest.fixture(scope="module")
def corpus():
    from fraud_detection_tpu.data import generate_corpus

    docs = generate_corpus(n=300, seed=21)
    return [d.text for d in docs], np.asarray([d.label for d in docs])


@pytest.fixture(scope="module")
def jax_models(corpus):
    """JAX-trained featurizers and models of every shape the writer
    exports."""
    from fraud_detection_tpu.models.train_linear import fit_logistic_regression
    from fraud_detection_tpu.models.train_trees import (
        TreeTrainConfig, fit_decision_tree, fit_gradient_boosting,
        fit_random_forest)

    texts, y = corpus
    feat = HashingTfIdfFeaturizer(num_features=1024)
    feat.fit_idf(texts)
    X = np.asarray(feat.featurize_dense(texts))
    vocab = VocabTfIdfFeaturizer.fit_vocabulary(texts, vocab_size=512)
    vocab.fit_idf(texts)
    Xv = np.asarray(vocab.featurize_dense(texts))
    plain = HashingTfIdfFeaturizer(num_features=1024, remove_stopwords=False)
    plain.fit_idf(texts)
    Xp = np.asarray(plain.featurize_dense(texts))
    keep = np.concatenate([np.where(y == 1)[0][:40], np.where(y == 0)[0]])
    return {
        "lr": (feat, fit_logistic_regression(X, y.astype(np.float32),
                                             max_iter=20)),
        "dt_vocabulary": (vocab, fit_decision_tree(
            Xv, y, config=TreeTrainConfig(max_depth=4))),
        "rf": (feat, fit_random_forest(X, y, n_trees=8, tree_chunk=4,
                                       config=TreeTrainConfig(max_depth=4))),
        "xgb": (feat, fit_gradient_boosting(
            X[keep], y[keep], n_rounds=10,
            config=TreeTrainConfig(max_depth=3, criterion="xgb"))),
        "lr_no_stopwords": (plain, fit_logistic_regression(
            Xp, y.astype(np.float32), max_iter=20)),
    }


@pytest.mark.parametrize("name", ["lr", "dt_vocabulary", "rf", "xgb",
                                  "lr_no_stopwords"])
def test_jax_written_artifact_serves_in_the_port(tmp_path, corpus,
                                                 jax_models, name):
    """JAX writer -> the port's reader -> ``from_spark_artifact``, against
    the JAX pipeline on the same artifact: labels equal, p within the
    reference's round-trip bounds (1e-6; xgb exported as GBT 1e-5), tree
    structure and weights exact."""
    texts, _ = corpus
    feat, model = jax_models[name]
    path = str(tmp_path / name)
    jsave(path, feat, model)
    jart_, part = jload(path), load_spark_pipeline(path)
    theirs = JPipe.from_spark_artifact(jart_, batch_size=64)
    ours = ServingPipeline.from_spark_artifact(part, batch_size=64,
                                               device="cpu")
    a, b = theirs.predict(texts[:128]), ours.predict(texts[:128])
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_allclose(a.probabilities, b.probabilities, rtol=0,
                               atol=GBT_TOL if name == "xgb" else TOL)
    assert type(ours.featurizer).__name__ == type(theirs.featurizer).__name__
    assert ours.featurizer.remove_stopwords == theirs.featurizer.remove_stopwords
    assert ours.featurizer.num_features == theirs.featurizer.num_features
    if hasattr(theirs.model, "tree_weights"):
        for k in ("feature", "threshold", "left", "right", "leaf",
                  "tree_weights"):
            np.testing.assert_array_equal(getattr(ours.model, k).numpy(),
                                          np.asarray(getattr(theirs.model, k)))
        assert (ours.model.kind, ours.model.max_depth) == (
            theirs.model.kind, theirs.model.max_depth)
    else:
        np.testing.assert_array_equal(ours.model.weights.numpy(),
                                      np.asarray(theirs.model.weights))


@pytest.mark.parametrize("name", ["dt_vocabulary", "rf", "xgb"])
def test_tree_stage_decodes_as_the_jax_functions(tmp_path, jax_models, name):
    """``from_spark_stage``, ``num_outputs`` and ``feature_importances`` of
    the port equal the JAX package's on the same loaded stage."""
    feat, model = jax_models[name]
    path = str(tmp_path / name)
    jsave(path, feat, model)
    pstage = load_spark_pipeline(path).tree_ensemble
    jstage = jload(path).tree_ensemble
    ours, theirs = (ptrees.from_spark_stage(pstage, device="cpu"),
                    jtrees.from_spark_stage(jstage))
    assert ours.num_outputs == theirs.num_outputs
    assert ours.max_depth == theirs.max_depth
    for k in ("feature", "threshold", "left", "right", "leaf", "tree_weights"):
        np.testing.assert_array_equal(getattr(ours, k).numpy(),
                                      np.asarray(getattr(theirs, k)))
    # the writer leaves gain at -1; give the nodes gains so the
    # importances have something to weigh
    rng = np.random.default_rng(5)
    for ps, js in zip(pstage.trees, jstage.trees):
        for pn, jn in zip(ps, js):
            pn.gain = jn.gain = float(rng.random())
    n = feat.num_features
    np.testing.assert_array_equal(ptrees.feature_importances(pstage, n),
                                  jtrees.feature_importances(jstage, n))
    assert ptrees.feature_importances(pstage, n).sum() == pytest.approx(1.0)


def test_unsupported_stages_refuse_as_the_reference(tmp_path, jax_models):
    feat, model = jax_models["rf"]
    path = tmp_path / "rf"
    jsave(str(path), feat, model)
    # a categorical split: refused, never decoded as a threshold
    from fraud_detection_tpu_torch.checkpoint import parquet

    data = next((path / "stages").glob("*RandomForest*")) / "data"
    part = next(data.glob("*.parquet"))
    rows = parquet.read_rows(str(part))
    internal = next(r for r in rows if r["nodeData"]["leftChild"] >= 0)
    internal["nodeData"]["split"]["numCategories"] = 3
    parquet.write_rows(str(part), rows)
    with pytest.raises(NotImplementedError, match="categorical split"):
        load_spark_pipeline(str(path))
    # a RegexTokenizer stage: loads, but serving refuses it
    lr_path = tmp_path / "lr"
    jsave(str(lr_path), *jax_models["lr"])
    tok = next((lr_path / "stages").glob("0_*")) / "metadata" / "part-00000"
    meta = json.loads(tok.read_text())
    meta["class"] = "org.apache.spark.ml.feature.RegexTokenizer"
    meta["paramMap"]["pattern"] = "\\W"
    tok.write_text(json.dumps(meta) + "\n")
    art = load_spark_pipeline(str(lr_path))
    with pytest.raises(NotImplementedError, match="RegexTokenizer"):
        ServingPipeline.from_spark_artifact(art, device="cpu")


def test_corrupted_artifacts_fail_loudly(tmp_path, jax_models):
    """A missing stage directory, mangled metadata JSON and a truncated
    weights parquet each raise, on an artifact the JAX writer made."""
    src = tmp_path / "src"
    jsave(str(src), *jax_models["lr"])

    def fresh(name):
        dst = tmp_path / name
        shutil.copytree(src, dst)
        return dst

    art = fresh("missing_stage")
    stage = next(p for p in (art / "stages").iterdir() if "IDF" in p.name)
    shutil.rmtree(stage)
    with pytest.raises(Exception):
        load_spark_pipeline(str(art))

    art = fresh("bad_meta")
    (art / "metadata" / "part-00000").write_text("{not valid json")
    with pytest.raises(Exception):
        load_spark_pipeline(str(art))

    art = fresh("truncated_parquet")
    lr_dir = next(p for p in (art / "stages").iterdir()
                  if "LogisticRegression" in p.name)
    pq_file = next((lr_dir / "data").glob("*.parquet"))
    pq_file.write_bytes(pq_file.read_bytes()[:100])
    with pytest.raises(Exception):
        load_spark_pipeline(str(art))

    art = fresh("no_data")
    lr_dir = next(p for p in (art / "stages").iterdir()
                  if "LogisticRegression" in p.name)
    shutil.rmtree(lr_dir / "data")
    with pytest.raises(FileNotFoundError):
        load_spark_pipeline(str(art))


# --- the wide feature space ------------------------------------------------

WIDE = 262_144      # Spark HashingTF's default numFeatures


@pytest.fixture(scope="module")
def wide(corpus):
    from fraud_detection_tpu.models.train_linear import fit_logistic_regression
    from fraud_detection_tpu.models.train_trees import (TreeTrainConfig,
                                                        fit_random_forest)

    texts, y = corpus
    texts, y = texts[:160], y[:160]
    feat = HashingTfIdfFeaturizer(num_features=WIDE)
    feat.fit_idf(texts)
    X = np.asarray(feat.featurize_dense(texts))
    return texts, feat, {
        "lr": fit_logistic_regression(X, y.astype(np.float32), max_iter=10),
        "forest": fit_random_forest(X, y, n_trees=4, tree_chunk=4,
                                    config=TreeTrainConfig(max_depth=3))}


@pytest.mark.parametrize("name", ["lr", "forest"])
def test_wide_feature_space_serves_as_the_jax_pipeline(wide, name):
    """262,144 features on host featurize: int32 ids and uint16 counts in
    two uploads a chunk, on ``predict``, the raw-JSON path and
    ``predict_encoded``; labels equal the JAX pipeline's, p within the
    pipeline tests' 1e-6; ``featurize_device=True`` refuses it with the
    reference's message."""
    texts, jfeat, models = wide
    jmodel = models[name]
    theirs = JPipe(jfeat, jmodel, batch_size=64).predict(texts)
    pfeat = port_featurizer(jfeat)
    ours_pipe = ServingPipeline(pfeat, port_model(jmodel), batch_size=64,
                                device="cpu")
    ours = ours_pipe.predict(texts)
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    np.testing.assert_allclose(ours.probabilities, theirs.probabilities,
                               rtol=0, atol=TOL)
    snap = ours_pipe.device_stats.snapshot()
    assert snap["uploads_per_chunk"] == 2.0
    vals = [json.dumps({"text": t}).encode() for t in texts[:64]]
    out = ours_pipe.predict_json_async(vals)
    if out is not None:          # the native library built
        np.testing.assert_array_equal(out[0].resolve().labels,
                                      theirs.labels[:64])
    enc = pfeat.encode(texts[:64])
    assert enc.ids.dtype == np.int32
    np.testing.assert_array_equal(
        ours_pipe.predict_encoded(enc.ids, enc.counts).labels,
        theirs.labels[:64])
    with pytest.raises(DeviceFeaturizeUnavailable,
                       match="exceeds the int16 packed staging layout"):
        ServingPipeline(pfeat, port_model(jmodel), device="cpu",
                        featurize_device=True)
    if name == "lr":
        # int8 scores the two-array rows with the quantized weights (the
        # JAX pipeline scores a wide space fp32 whatever it was asked)
        q8 = ServingPipeline(pfeat, port_model(jmodel), batch_size=64,
                             int8=True, device="cpu")
        w_q, scales = (t.numpy() for t in q8._q8)
        w = w_q.astype(np.float64) * np.repeat(scales, 128)[:w_q.size]
        margin = (w[enc.ids] * enc.counts).sum(-1) + float(
            q8._fused_model.intercept)
        np.testing.assert_allclose(q8.predict(texts[:64]).probabilities,
                                   1 / (1 + np.exp(-margin)), rtol=0,
                                   atol=TOL)


def test_wide_feature_space_on_a_mesh(wide):
    """The mesh replicas shard both arrays of the wide layout; labels and
    probabilities equal the single-device pipeline's."""
    from fraud_detection_tpu_torch.parallel import make_mesh

    texts, jfeat, models = wide
    feat, model = port_featurizer(jfeat), port_model(models["lr"])
    plain = ServingPipeline(feat, model, batch_size=64, device="cpu")
    meshed = ServingPipeline(feat, model, batch_size=64,
                             mesh=make_mesh(devices=["cpu"] * 2))
    a, b = plain.predict(texts), meshed.predict(texts)
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.probabilities, b.probabilities)
    assert meshed.device_stats.snapshot()["uploads_per_chunk"] == 4.0


def test_wide_spark_artifact_round_trip(tmp_path, wide):
    """A HashingTF(262,144) + IDF + LR artifact the port writes serves in
    the port and in the JAX package alike."""
    from fraud_detection_tpu_torch.checkpoint import save_spark_pipeline

    texts, jfeat, models = wide
    path = str(tmp_path / "wide")
    pfeat = port_featurizer(jfeat)
    pfeat.doc_freq, pfeat.num_docs = jfeat.doc_freq, jfeat.num_docs
    save_spark_pipeline(path, pfeat, port_model(models["lr"]))
    ours = ServingPipeline.from_spark_artifact(
        load_spark_pipeline(path), batch_size=64, device="cpu").predict(texts)
    theirs = JPipe.from_spark_artifact(jload(path), batch_size=64).predict(texts)
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    np.testing.assert_allclose(ours.probabilities, theirs.probabilities,
                               rtol=0, atol=TOL)
