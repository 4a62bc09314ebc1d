"""The port's training CLI, checkpoints and dense scoring against the JAX
package on the CPU.

* ``app.train.main(["--device", "cpu", ...])`` writes the JAX CLI's metrics
  schema (``meta.device`` and ``meta.tree_kernels`` in place of the JAX
  report's ``backend`` and ``use_pallas``), and its dt and rf metrics equal
  those of the JAX decision tree and forest (kernel path) on the same
  split, exactly.
* A JAX ``save_checkpoint`` loads in the port and the reverse.
* Dense ``predict`` equals the JAX package's for DT, RF and GBT models.
"""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fraud_detection_tpu.checkpoint import native as jnative
from fraud_detection_tpu.data import generate_corpus as jgenerate
from fraud_detection_tpu.data import loader as jloader
from fraud_detection_tpu.data import train_val_test_split as jsplit
from fraud_detection_tpu.eval import evaluate_classification as jevaluate
from fraud_detection_tpu.featurize.tfidf import HashingTfIdfFeaturizer as JFeat
from fraud_detection_tpu.models import train_trees as jt
from fraud_detection_tpu.models import trees as jtrees
from fraud_detection_tpu_torch.app import train as ptrain
from fraud_detection_tpu_torch.checkpoint import native as pnative
from fraud_detection_tpu_torch.data import loader as ploader
from fraud_detection_tpu_torch.eval import metrics as pmetrics
from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
from fraud_detection_tpu_torch.models import trees as ptrees
from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
from tests.torch_parity import port_model

N, F, SEED = 200, 512, 42


@pytest.fixture(scope="module")
def jax_split():
    corpus = [(d.text, d.label) for d in jgenerate(n=N, seed=SEED)]
    train, val, test = jsplit(corpus, seed=SEED)
    feat = JFeat(num_features=F)
    feat.fit_idf([t for t, _ in train])

    def xy(split):
        return (np.array(feat.featurize_dense([t for t, _ in split])),
                np.asarray([l for _, l in split]))

    return feat, xy(train), {"Validation": xy(val), "Test": xy(test)}, test


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli")
    metrics = out / "metrics.json"
    rc = ptrain.main(["--device", "cpu", "--n", str(N), "--num-features",
                      str(F), "--models", "dt,rf,xgb", "--n-trees", "8",
                      "--n-rounds", "4", "--metrics-out", str(metrics),
                      "--save", f"dt={out / 'dt'}"])
    assert rc == 0
    return json.loads(metrics.read_text()), out / "dt"


def _assert_metrics_equal(got_by_split, jmodel, sets):
    for split, (X, y) in sets.items():
        pred, p1 = jtrees.predict(jmodel, jnp.asarray(X))
        want = jevaluate(y, np.asarray(pred), np.asarray(p1))
        got = got_by_split[split]
        assert got["confusion"] == want.confusion.tolist()
        for key, value in want.as_dict().items():
            assert got[key] == value, (split, key)


def test_cli_dt_metrics_equal_jax_kernel_path(cli_run, jax_split):
    report, _ = cli_run
    _, (Xtr, ytr), sets, _ = jax_split
    jdt = jt.fit_decision_tree(Xtr, ytr,
                               config=jt.TreeTrainConfig(use_pallas=True))
    _assert_metrics_equal(report["metrics"]["dt"], jdt, sets)


def test_cli_rf_metrics_equal_jax_kernel_path(cli_run, jax_split):
    """The CLI's forest (8 trees, the default chunk, seed 42) draws the JAX
    forest's bootstrap weights and masks, so its metrics are the JAX
    kernel path's forest's."""
    report, _ = cli_run
    _, (Xtr, ytr), sets, _ = jax_split
    jrf = jt.fit_random_forest(Xtr, ytr, n_trees=8, seed=SEED,
                               config=jt.TreeTrainConfig(use_pallas=True),
                               tree_chunk=8)
    _assert_metrics_equal(report["metrics"]["rf"], jrf, sets)


def test_cli_report_has_the_jax_schema(cli_run, tmp_path):
    from fraud_detection_tpu.app import train as jtrain

    report, _ = cli_run
    path = tmp_path / "jax.json"
    assert jtrain.main(["--n", "100", "--num-features", "128", "--models",
                        "dt", "--metrics-out", str(path)]) == 0
    jreport = json.loads(path.read_text())
    jmeta = set(jreport["meta"]) - {"backend", "use_pallas"}
    assert set(report["meta"]) == jmeta | {"device", "tree_kernels"}
    assert report["meta"]["device"] == "cpu"
    assert report["meta"]["tree_kernels"] == "plain"
    assert report["meta"]["splits"] == {"train": 140, "val": 20, "test": 40}
    assert set(report["metrics"]) == {"dt", "rf", "xgb"}
    for per_split in report["metrics"].values():
        assert set(per_split) == set(jreport["metrics"]["dt"])
        for split, m in per_split.items():
            assert set(m) == set(jreport["metrics"]["dt"][split])


def test_saved_dt_serves_through_the_pipeline(cli_run, jax_split):
    _, ckpt = cli_run
    _, _, sets, test = jax_split
    texts = [t for t, _ in test]
    pipe = ServingPipeline.from_checkpoint(str(ckpt), device="cpu",
                                           featurize_device=True)
    served = pipe.predict(texts)
    _, model = pnative.load_checkpoint(str(ckpt), device="cpu")
    dense = pipe.featurizer.featurize_dense(texts, device="cpu")
    labels, p1 = ptrees.predict(model, dense)
    np.testing.assert_array_equal(served.labels, labels.numpy())
    np.testing.assert_allclose(served.probabilities, p1.numpy(), rtol=0,
                               atol=1e-6)


def test_checkpoints_cross_both_ways(jax_split, tmp_path):
    jfeat, (Xtr, ytr), sets, _ = jax_split
    jdt = jt.fit_decision_tree(Xtr, ytr,
                               config=jt.TreeTrainConfig(use_pallas=True))
    jnative.save_checkpoint(str(tmp_path / "jax"), jfeat, jdt)
    pfeat, pmodel = pnative.load_checkpoint(str(tmp_path / "jax"), device="cpu")
    np.testing.assert_array_equal(pfeat.idf, np.asarray(jfeat.idf))
    assert pfeat.stop_filter.words == jfeat.stop_filter.words
    assert pfeat.num_docs == jfeat.num_docs
    X = sets["Test"][0]
    np.testing.assert_array_equal(
        ptrees.predict(pmodel, torch.from_numpy(X))[1].numpy(),
        np.asarray(jtrees.predict(jdt, jnp.asarray(X))[1]))

    pnative.save_checkpoint(str(tmp_path / "port"), pfeat, pmodel)
    back_feat, back = jnative.load_checkpoint(str(tmp_path / "port"))
    assert back.kind == jdt.kind and back.max_depth == jdt.max_depth
    for name in ("feature", "threshold", "left", "right", "leaf",
                 "tree_weights"):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(jdt, name)))
    np.testing.assert_array_equal(np.asarray(back_feat.idf),
                                  np.asarray(jfeat.idf))


def test_lr_checkpoint_crosses(tmp_path):
    from fraud_detection_tpu.models.linear import LogisticRegression as JLR

    jfeat = JFeat(num_features=64)
    jfeat.fit_idf(["urgent account verify", "see you at lunch"])
    jlr = JLR(weights=jnp.linspace(-1.0, 1.0, 64), intercept=jnp.float32(0.25),
              threshold=0.4)
    jnative.save_checkpoint(str(tmp_path / "lr"), jfeat, jlr)
    pipe = ServingPipeline.from_checkpoint(str(tmp_path / "lr"), device="cpu")
    assert pipe.model.threshold == 0.4
    np.testing.assert_array_equal(pipe.model.weights.numpy(),
                                  np.asarray(jlr.weights))
    pnative.save_checkpoint(str(tmp_path / "back"), pipe.featurizer, pipe.model)
    _, back = jnative.load_checkpoint(str(tmp_path / "back"))
    assert float(back.intercept) == 0.25 and back.threshold == 0.4


@pytest.mark.parametrize("kind", ["dt", "rf", "xgb"])
def test_dense_predict_matches_jax(jax_split, kind):
    _, (Xtr, ytr), sets, _ = jax_split
    cfg = jt.TreeTrainConfig(max_depth=4, use_pallas=True)
    if kind == "dt":
        jmodel = jt.fit_decision_tree(Xtr, ytr, config=cfg)
    elif kind == "rf":
        jmodel = jt.fit_random_forest(Xtr, ytr, n_trees=4, tree_chunk=4,
                                      config=cfg)
    else:
        jmodel = jt.fit_gradient_boosting(Xtr, ytr, n_rounds=3)
    X = sets["Validation"][0]
    jl, jp = (np.asarray(a) for a in jtrees.predict(jmodel, jnp.asarray(X)))
    pl, pp = ptrees.predict(port_model(jmodel), torch.from_numpy(X))
    np.testing.assert_array_equal(pl.numpy(), jl)
    np.testing.assert_allclose(pp.numpy(), jp, rtol=1e-6, atol=1e-7)


def test_featurize_dense_matches_jax(jax_split):
    jfeat, _, _, test = jax_split
    texts = [t for t, _ in test][:12] + ["", "!!!"]
    pfeat = HashingTfIdfFeaturizer(num_features=F, idf=np.asarray(jfeat.idf))
    got = pfeat.featurize_dense(texts, batch_size=16, device="cpu")
    want = np.asarray(jfeat.featurize_dense(texts, batch_size=16))
    np.testing.assert_array_equal(got.numpy(), want)


def test_loader_and_metrics_match_jax():
    csv_text = ("dialogue,personality,type,labels\n"
                "Hello THERE friend,a,b,1\n,a,b,0\n\"urgent, now\",x,y, 0 \n"
                "bad label,a,b,2\n12345,a,b,1\n")
    got = ploader.load_dialogue_csv(io.StringIO(csv_text))
    want = jloader.load_dialogue_csv(io.StringIO(csv_text))
    assert [vars(r) for r in got] == [vars(r) for r in want]
    assert ploader.as_xy(got) == jloader.as_xy(want)
    with pytest.raises(ValueError, match="local"):
        ploader.load_dialogue_csv("https://example.invalid/data.csv")

    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 50)
    scores = np.round(rng.random(50), 1)          # ties in the scores
    pred = (scores > 0.5).astype(int)
    a = pmetrics.evaluate_classification(y, pred, scores)
    b = jevaluate(y, pred, scores)
    assert a.as_dict() == b.as_dict()
    assert a.confusion.tolist() == b.confusion.tolist()


def test_cli_offers_only_this_slice(tmp_path):
    with pytest.raises(SystemExit):
        ptrain.main(["--device", "cpu", "--models", "lr"])
    with pytest.raises(SystemExit):
        ptrain.main(["--device", "cpu", "--mesh"])
    with pytest.raises(SystemExit):
        ptrain.main(["--device", "cpu", "--models", "dt",
                     "--save", f"rf={tmp_path}"])
