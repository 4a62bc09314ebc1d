"""The port's warm-started boosting refresh (``models/train_trees.py``
``refresh_gradient_boosting``) against the JAX package's kernel path
(``TreeTrainConfig(use_pallas=True)``: both Pallas kernels in interpret
mode) on the CPU.

The same base ensemble (carried across with ``convert.py``, or through a
native checkpoint the JAX package writes) and the same window go through
both: at three seeds and windows ragged across two row buckets (300 rows
pad to 512, 700 to 1,024), the new trees' feature / split bin (threshold) /
left / right are equal and the leaf values within LEAF_TOL; ``info`` is
equal key for key. The data are continuous normals with linear boundaries,
so no two candidate splits tie exactly (an exact tie is broken by the last
bit of an f32 sum, whose order differs between the two packages).
"""

import numpy as np
import pytest
import torch

from fraud_detection_tpu.checkpoint.native import save_checkpoint as jsave
from fraud_detection_tpu.featurize.tfidf import HashingTfIdfFeaturizer as JFeat
from fraud_detection_tpu.models import train_trees as jt
from fraud_detection_tpu_torch.checkpoint.native import load_checkpoint
from fraud_detection_tpu_torch.models import train_trees as pt
from fraud_detection_tpu_torch.models import trees as ptrees
from tests.torch_parity import port_model

LEAF_TOL = 1e-5      # leaf values, port vs JAX (f32 sums in another order)
DEPTH = 3


def _window(n, seed, drift=False, f=24):
    """Normal features; the base regime's label is a linear boundary on
    features 1 and 7, the drifted one's on features 3 and 9."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    score = (X[:, 3] - 0.5 * X[:, 9] - 0.2) if drift else (X[:, 1]
                                                           + 0.5 * X[:, 7])
    return X, (score > 0).astype(np.float32)


def _jcfg():
    return jt.TreeTrainConfig(max_depth=DEPTH, criterion="xgb",
                              use_pallas=True)


@pytest.fixture(scope="module")
def bases():
    """A JAX xgb base ensemble per seed (4 rounds on the base regime)."""
    out = {}
    for seed in (0, 1, 2):
        X, y = _window(400, seed)
        out[seed] = jt.fit_gradient_boosting(X, y, n_rounds=4, config=_jcfg())
    return out


def _carry(jbase, how, tmp_path):
    if how == "convert":
        return port_model(jbase)
    path = str(tmp_path / "base")
    jsave(path, JFeat(num_features=24), jbase)
    return load_checkpoint(path, device="cpu")[1]


@pytest.mark.parametrize("n", [300, 700])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refresh_equals_jax(bases, seed, n, tmp_path):
    jbase = bases[seed]
    Xd, yd = _window(n, seed + 10, drift=True)
    want, jinfo = jt.refresh_gradient_boosting(jbase, Xd, yd, n_rounds=3,
                                               config=_jcfg())
    how = "checkpoint" if seed == 1 else "convert"
    got, pinfo = pt.refresh_gradient_boosting(
        _carry(jbase, how, tmp_path), Xd, yd, n_rounds=3,
        config=pt.TreeTrainConfig(max_depth=DEPTH), device="cpu")
    assert pinfo == jinfo
    assert pinfo["padded_rows"] == (512 if n == 300 else 1024)
    assert got.kind == "xgboost" and got.max_depth == DEPTH
    assert got.bias == pytest.approx(float(want.bias))
    for name in ("feature", "threshold", "left", "right", "tree_weights"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.leaf.numpy(), np.asarray(want.leaf),
                               rtol=0, atol=LEAF_TOL)
    # the base trees ride along unchanged
    np.testing.assert_array_equal(got.leaf.numpy()[:4],
                                  np.asarray(jbase.leaf))


def test_refresh_over_the_top_rung_keeps_recent_rows(bases):
    Xd, yd = _window(200, 21, drift=True)
    kw = dict(n_rounds=2, row_buckets=(64, 128))
    want, jinfo = jt.refresh_gradient_boosting(bases[0], Xd, yd,
                                               config=_jcfg(), **kw)
    got, pinfo = pt.refresh_gradient_boosting(
        port_model(bases[0]), Xd, yd, config=pt.TreeTrainConfig(max_depth=DEPTH),
        device="cpu", **kw)
    assert pinfo == jinfo and pinfo["window_rows"] == 128
    np.testing.assert_array_equal(got.feature.numpy(), np.asarray(want.feature))
    np.testing.assert_allclose(got.leaf.numpy(), np.asarray(want.leaf),
                               rtol=0, atol=LEAF_TOL)


def test_refresh_rejects_non_xgb_with_the_reference_message():
    X, y = _window(64, 2)
    jrf = jt.fit_random_forest(X, y, n_trees=3,
                               config=jt.TreeTrainConfig(max_depth=2))
    with pytest.raises(ValueError) as je:
        jt.refresh_gradient_boosting(jrf, X, y)
    with pytest.raises(ValueError) as pe:
        pt.refresh_gradient_boosting(port_model(jrf), X, y, device="cpu")
    assert str(pe.value) == str(je.value)
    assert "xgboost" in str(pe.value)


def _separable(n, seed, drift=False):
    """The reference test's rows: feature 0 => scam, feature 1 => legit; the
    drifted regime moves the scam signal to feature 2."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 0.1, (n, 8)).astype(np.float32)
    y = (np.arange(n) % 2).astype(np.float32)
    X[y == 1, 2 if drift else 0] += 3.0
    X[y == 0, 1] += 3.0
    return X, y


def test_refresh_learns_drift_and_keeps_base_behavior():
    """The reference's behavioural pin, on the port: blind base, refreshed
    model right on the drifted window and still right on the old one."""
    X0, y0 = _separable(256, 3)
    base = pt.fit_gradient_boosting(X0, y0, n_rounds=6, device="cpu")
    Xd, yd = _separable(256, 4, drift=True)
    p_base = ptrees.predict(base, torch.from_numpy(Xd))[1].numpy()
    assert np.mean((p_base > 0.5) != (yd > 0.5)) > 0.2
    refreshed, info = pt.refresh_gradient_boosting(base, Xd, yd, n_rounds=6,
                                                   device="cpu")
    p_new = ptrees.predict(refreshed, torch.from_numpy(Xd))[1].numpy()
    assert np.mean((p_new > 0.5) != (yd > 0.5)) < 0.05
    p_old = ptrees.predict(refreshed, torch.from_numpy(X0))[1].numpy()
    assert np.mean((p_old > 0.5) != (y0 > 0.5)) < 0.1
    assert info["base_trees"] == 6 and info["total_trees"] == 12
    assert info["window_rows"] == 256 and info["padded_rows"] == 512


def test_refresh_buckets_and_rung_rule_equal_jax():
    assert pt.REFRESH_ROW_BUCKETS == jt.REFRESH_ROW_BUCKETS
    for n in (1, 511, 512, 513, 4096, 4097, 10 ** 9):
        assert pt.refresh_row_bucket(n) == jt.refresh_row_bucket(n)
    X, y = _window(256, 5)
    base = pt.fit_gradient_boosting(X, y, n_rounds=2, device="cpu")
    _, a = pt.refresh_gradient_boosting(base, X[:150], y[:150], n_rounds=1,
                                        device="cpu")
    _, b = pt.refresh_gradient_boosting(base, X[:200], y[:200], n_rounds=1,
                                        device="cpu")
    assert a["padded_rows"] == b["padded_rows"] == 512


def test_refresh_refuses_bad_windows():
    X, y = _window(64, 6)
    base = pt.fit_gradient_boosting(X, y, n_rounds=1, device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        pt.refresh_gradient_boosting(base, X, y[:10], device="cpu")
    with pytest.raises(ValueError, match="at least 2"):
        pt.refresh_gradient_boosting(base, X[:1], y[:1], device="cpu")


def test_refresh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    X, y = _window(64, 7)
    base = pt.fit_gradient_boosting(X, y, n_rounds=1, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        pt.refresh_gradient_boosting(base, X, y)
