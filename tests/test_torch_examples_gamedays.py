"""The port's training and game-day examples (``examples/torch_*.py``)
against the JAX package's (``examples/*.py``), on the CPU under ``--device
cpu``; the serving, checkpoint and hot-swap twins are
``tests/test_torch_examples.py``.

* train quickstart (``torch_train_quickstart.py``): the JAX example takes
  ~30 s here and the port's plain tree kernels minutes at its size, so
  both run the same steps at 300 rows, 1,024 features and 5 rounds. The
  twin's every split is a best split of its node and its leaves the xgb
  values of their rows; its metrics are the JAX metrics code's on its
  predictions; its reloaded checkpoint predicts the same. The JAX fit's
  model, carried into the port, scores, evaluates and reloads as in JAX
  (see the test for why the two fits' trees are not compared).
* the game days (``torch_drift_loop_demo.py``: drift_shift at seed 11,
  scale 0.4; ``torch_game_day_demo.py``: campaign_kill_swap at seed 11,
  scale 0.6), each beside the JAX example's steps at its own seed and
  scale: the planned, classified and dead-lettered rows, the deaths and
  the swaps equal, both runs account for every row exactly, and each
  twin's exit code is its own verdict. The whole verdict is not compared:
  campaign_kill_swap's ``detects_worker_absence`` races the drain under
  load in both packages (``tests/test_torch_gameday_fleet.py``).
"""

import gc
import tempfile

import numpy as np
import pytest

import examples.torch_drift_loop_demo as TDL
import examples.torch_game_day_demo as TGD
import examples.torch_train_quickstart as TT
from tests.torch_parity import port_featurizer, port_model

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _frozen_heap():
    """The game days' fleet runs on real threads with 1 s leases; a gen-2
    collection over a long-lived test worker's heap stops every thread for
    up to seconds and can expire a live lease. ``gc.freeze()`` keeps that
    heap out of the collector's reach for this module (as in
    ``tests/test_torch_fleet.py``)."""
    gc.freeze()
    yield
    gc.unfreeze()


def _jax_train_quickstart(n, n_train, n_rounds, num_features):
    """``examples/train_quickstart.py``'s steps at the given sizes: the
    features, labels, featurizer, model and test-split report."""
    from fraud_detection_tpu.data import generate_corpus
    from fraud_detection_tpu.eval.metrics import evaluate_classification
    from fraud_detection_tpu.featurize.tfidf import HashingTfIdfFeaturizer
    from fraud_detection_tpu.models.train_trees import fit_gradient_boosting
    from fraud_detection_tpu.models.trees import predict

    corpus = generate_corpus(n=n, seed=42)
    texts = [d.text for d in corpus]
    y = np.asarray([d.label for d in corpus], np.int32)
    feat = HashingTfIdfFeaturizer(num_features=num_features)
    feat.fit_idf(texts)
    X = np.asarray(feat.featurize_dense(texts))
    model = fit_gradient_boosting(X[:n_train], y[:n_train], n_rounds=n_rounds)
    preds, proba = predict(model, X[n_train:])
    return X, y, feat, model, evaluate_classification(
        y[n_train:], np.asarray(preds), np.asarray(proba))


def _assert_splits_optimal(model, X, y, edges, lam=1.0, lr=0.3):
    """Every split of a boosted ensemble attains, within f32 rounding, the
    best xgb gain over all (feature, bin) of the rows reaching its node,
    reckoned in float64 from the margins of the trees before it; every leaf
    holds -G / (H + lam) * lr of its rows."""
    f_, t_ = model.feature.numpy(), model.threshold.numpy()
    l_, r_ = model.left.numpy(), model.right.numpy()
    leaf = model.leaf.numpy()[..., 0].astype(np.float64)
    weights = model.tree_weights.numpy().astype(np.float64)
    bins = np.stack([np.searchsorted(edges[f], X[:, f], side="left")
                     for f in range(X.shape[1])], 1)
    nb = edges.shape[1] + 1
    margin = np.full(len(X), float(model.bias))
    for t in range(f_.shape[0]):
        p = 1.0 / (1.0 + np.exp(-margin))
        g, h = p - y, p * (1.0 - p)
        rows = {0: np.ones(len(X), bool)}
        for node in range(f_.shape[1]):
            if node not in rows:
                continue
            m = rows[node]
            G, H = g[m].sum(), h[m].sum()
            if f_[t, node] < 0:
                assert leaf[t, node] == pytest.approx(-G / (H + lam) * lr,
                                                      rel=1e-4, abs=1e-6)
                margin[m] += weights[t] * leaf[t, node]
                continue
            cells = np.zeros((X.shape[1], nb, 3))
            for k, v in enumerate((g[m], h[m], np.ones(m.sum()))):
                np.add.at(cells[..., k], (np.arange(X.shape[1])[None, :],
                                          bins[m]), v[:, None])
            left = np.cumsum(cells, axis=1)[:, :-1]
            right = np.array([G, H, m.sum()]) - left
            score = lambda c: c[..., 0] ** 2 / (c[..., 1] + lam)  # noqa: E731
            gain = 0.5 * (score(left) + score(right) - G * G / (H + lam))
            gain[(left[..., 2] == 0) | (right[..., 2] == 0)] = -np.inf
            go_left = m & (X[:, f_[t, node]] <= t_[t, node])
            chosen = gain[f_[t, node], bins[go_left, f_[t, node]].max()]
            best = gain.max()
            assert chosen >= best - 1e-5 * max(1.0, abs(best)), (t, node)
            rows[l_[t, node]], rows[r_[t, node]] = go_left, m & ~go_left


def test_train_quickstart_equals_jax():
    """The fit's data and binning equal the JAX package's, and each of its
    splits is a best split of its node. The trees themselves are not held
    against the JAX fit's: at round one every row of a class has the same
    gradient, so two features that send the same number of each class left
    tie exactly, and many do in sparse TF-IDF; either package takes either,
    by the rounding of its f32 sums (the JAX package's own CPU path and
    kernel path take different features at this seed's first tree), and
    the trees after it part from there. The scoring, metrics and
    checkpoint steps are held on the JAX fit's own model carried across:
    labels equal, p within 1e-6, the report equal."""
    import torch

    from fraud_detection_tpu.eval.metrics import evaluate_classification
    from fraud_detection_tpu.models import train_trees as jtt
    from fraud_detection_tpu.models.trees import predict as jpredict
    from fraud_detection_tpu_torch.checkpoint.native import (load_checkpoint,
                                                             save_checkpoint)
    from fraud_detection_tpu_torch.eval.metrics import evaluate_classification as tevaluate
    from fraud_detection_tpu_torch.models.trees import predict as tpredict

    sizes = dict(n=300, n_train=210, n_rounds=5, num_features=1024)
    n_train = sizes["n_train"]
    got = TT.run(CPU, **sizes)
    assert got["exit_code"] == 0 and got["reloaded_equal"]
    X, y, jfeat, jmodel, jreport = _jax_train_quickstart(**sizes)
    edges = np.asarray(jtt.quantile_bin_edges(X[:n_train], 32))
    _assert_splits_optimal(got["model"], X[:n_train],
                           y[:n_train].astype(np.float64), edges)
    assert got["report"] == evaluate_classification(
        y[n_train:], got["preds"], got["scores"]).as_dict()
    assert got["metrics"] == {k: round(float(got["report"][k]), 4)
                              for k in ("accuracy", "f1", "auc")}

    tmodel = port_model(jmodel)
    jl, jp = (np.asarray(a) for a in jpredict(jmodel, X[n_train:]))
    tl, tp = (a.numpy() for a in tpredict(tmodel, torch.from_numpy(
        X[n_train:])))
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    assert tevaluate(y[n_train:], tl, tp).as_dict() == pytest.approx(
        jreport.as_dict(), rel=0, abs=1e-12)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d + "/m", port_featurizer(jfeat),
                        tmodel)
        _, again = load_checkpoint(d + "/m", device="cpu")
    np.testing.assert_array_equal(
        tpredict(again, torch.from_numpy(X[n_train:]))[0].numpy(), jl)


def _counts(result) -> dict:
    ev = result.evidence
    return {k: ev.get(k) for k in ("planned", "out_rows", "dlq_rows",
                                   "deaths", "swaps")}


@pytest.mark.parametrize("twin,name,seed,scale", [
    (TDL, "drift_shift", 11, 0.4), (TGD, "campaign_kill_swap", 11, 0.6)])
def test_game_day_twins_equal_jax(twin, name, seed, scale):
    from fraud_detection_tpu.scenarios import get_scenario, run_gameday

    got = twin.run(CPU)
    result = got["result"]
    assert got["exit_code"] == (0 if result.ok else 1)
    assert result.scenario == name and result.seed == seed
    jres = run_gameday(get_scenario(name, seed, scale=scale))
    assert _counts(result) == _counts(jres)
    for res in (result, jres):
        by = {v.name: v for v in res.report.verdicts}
        assert by["exact_accounting"].ok, res.table()
