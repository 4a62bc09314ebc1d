"""The port's L-BFGS logistic-regression trainer against the JAX package's
(optax ``lbfgs()``) on the CPU.

* Step by step: the port's first five L-BFGS iterates and their line-search
  step sizes equal optax's, driven by hand on the same problem, within
  ``STEP_TOL``; the zoom line search alone equals optax's on functions that
  take each of its branches.
* Whole fits on a well-posed problem: weights within ``WEIGHT_TOL``, final
  loss within ``LOSS_RTOL`` relative, iteration counts within ``ITER_TOL``.
* At the training CLI's full width (a near-separable problem, where the
  stopping point depends on rounding): labels, confusion and accuracy equal
  ``reports/metrics.json``'s ``lr`` block, AUC within ``AUC_TOL``.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fraud_detection_tpu.models.linear import LogisticRegression as JLR
from fraud_detection_tpu.models.linear import margin_dense as jmargin_dense
from fraud_detection_tpu.models.linear import predict_dense as jpredict_dense
from fraud_detection_tpu.models.train_linear import _loss_fn as jloss_fn
from fraud_detection_tpu.models.train_linear import (
    fit_logistic_regression as jfit)
from fraud_detection_tpu_torch.app import train as ptrain
from fraud_detection_tpu_torch.models import linear as plinear
from fraud_detection_tpu_torch.models import train_linear as P

ROOT = pathlib.Path(__file__).resolve().parent.parent

STEP_TOL = 1e-5      # iterates and step sizes, first five L-BFGS steps
WEIGHT_TOL = 1e-4    # final weights and intercept of a whole fit
LOSS_RTOL = 1e-6     # final loss of a whole fit, relative
ITER_TOL = 1         # iterations of a whole fit
AUC_TOL = 0.01       # CLI-width AUC against the recorded run
LS_TOL = 1e-6        # a line search's step size alone, relative


def _problem(n=256, f=64, seed=0):
    """A well-posed problem: features of scale 10 (the first line searches
    zoom), labels drawn from a weak logistic model, so not separable."""
    rng = np.random.default_rng(seed)
    X = (rng.normal(0, 1, (n, f)) * 10.0).astype(np.float32)
    w = rng.normal(0, 0.2, f)
    p = 1.0 / (1.0 + np.exp(-(X @ w / 10.0 - 0.3)))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    return X, y


def _toy_problem(n=400, f=32, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(0, 2.0, f)
    X = rng.normal(0, 1.0, (n, f)).astype(np.float32)
    logits = X @ w_true - 0.5
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return X, y, w_true


@pytest.mark.parametrize("reg", [1e-2, 0.0])
def test_first_five_iterates_equal_optax(reg):
    X, y = _problem()
    Xj, yj, mj = jnp.asarray(X), jnp.asarray(y), jnp.ones(len(y))

    def loss(p):
        return jloss_fn(p, Xj, yj, mj, reg)

    opt = optax.lbfgs()
    params = (jnp.zeros(X.shape[1]), jnp.zeros(()))
    state = opt.init(params)
    value_and_grad = optax.value_and_grad_from_state(loss)
    port = P.LBFGS(P._Objective(torch.from_numpy(X), torch.from_numpy(y), reg),
                   torch.zeros(X.shape[1] + 1))
    zoomed = 0
    for k in range(5):
        val, grad = value_and_grad(params, state=state)
        updates, state = opt.update(grad, state, params, value=val, grad=grad,
                                    value_fn=loss)
        params = optax.apply_updates(params, updates)
        point = port.step()
        want = np.concatenate([np.asarray(params[0]), [float(params[1])]])
        np.testing.assert_allclose(port.theta.numpy(), want, rtol=0,
                                   atol=STEP_TOL, err_msg=f"iterate {k}")
        ls = state[-1]
        assert abs(float(point.step) - float(ls.learning_rate)) <= STEP_TOL
        assert port.linesearch_steps == int(ls.info.num_linesearch_steps)
        assert abs(float(point.value) - float(ls.value)) <= STEP_TOL
        zoomed += port.linesearch_steps > 1
    assert zoomed >= 1, "the problem no longer exercises the zoom phase"


def _linesearch_case(name):
    """(f in jax, f in torch, x0, direction) for one line-search branch."""
    if name == "expand":          # a short direction: the interval grows
        def jf(x):
            return jnp.sum((x - 10.0) ** 2)

        def tf(x):
            return torch.sum((x - 10.0) ** 2)

        return jf, tf, np.zeros(3, np.float32), np.full(3, 0.1, np.float32)
    if name == "zoom":            # a long direction: cubic/quadratic zoom
        def jf(x):
            return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2

        def tf(x):
            return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2

        x0 = np.array([-1.2, 1.0], np.float32)
        g = np.array([-215.6, -88.0], np.float32)
        return jf, tf, x0, -g
    if name == "ascent":          # not a descent direction: the search fails
        def jf(x):
            return jnp.sum(x ** 2)

        def tf(x):
            return torch.sum(x ** 2)

        return jf, tf, np.ones(2, np.float32), np.ones(2, np.float32)
    if name == "unbounded":       # decrease without curvature: the safe step
        def jf(x):
            return -jnp.sum(x)

        def tf(x):
            return -torch.sum(x)

        return jf, tf, np.zeros(2, np.float32), np.ones(2, np.float32)
    if name == "steep":           # exp growth: 20 zoom steps, then failure
        def jf(x):
            return jnp.sum(jnp.exp(3.0 * x) - 2.0 * x)

        def tf(x):
            return torch.sum(torch.exp(3.0 * x) - 2.0 * x)

        return jf, tf, np.zeros(4, np.float32), np.full(4, 3.0, np.float32)
    raise KeyError(name)


@pytest.mark.parametrize("case", ["expand", "zoom", "ascent", "unbounded",
                                  "steep"])
def test_zoom_linesearch_equals_optax(case):
    import jax

    jf, tf, x0, u = _linesearch_case(case)
    ls = optax.scale_by_zoom_linesearch(max_linesearch_steps=20,
                                        initial_guess_strategy="one")
    xj, uj = jnp.asarray(x0), jnp.asarray(u)
    val, grad = jax.value_and_grad(jf)(xj)
    _, state = ls.update(uj, ls.init(xj), xj, value=val, grad=grad,
                         value_fn=jf)

    xt, ut = torch.from_numpy(x0), torch.from_numpy(u)

    def point(step):
        x = (xt + float(step) * ut).requires_grad_(True)
        value = tf(x)
        (g,) = torch.autograd.grad(value, x)
        return P._Point(step, value.item(), float(torch.dot(g, ut)), 0.0, g)

    init = point(0.0)
    search = P._ZoomLinesearch(point, init)
    got = search.run()
    want = float(state.learning_rate)
    assert search.count == int(state.info.num_linesearch_steps)
    assert abs(float(got.step) - want) <= LS_TOL * max(1.0, abs(want))
    np.testing.assert_allclose(float(got.value), float(state.value),
                               rtol=LS_TOL)


@pytest.mark.parametrize("reg", [1e-2, 0.0])
def test_whole_fit_equals_jax(reg):
    X, y = _problem()
    jmodel, jinfo = jfit(X, y, reg_param=reg, return_info=True)
    pmodel, pinfo = P.fit_logistic_regression(X, y, reg_param=reg,
                                              return_info=True, device="cpu")
    np.testing.assert_allclose(pmodel.weights.numpy(),
                               np.asarray(jmodel.weights), rtol=0,
                               atol=WEIGHT_TOL)
    assert abs(float(pmodel.intercept) - float(jmodel.intercept)) <= WEIGHT_TOL
    assert abs(pinfo.final_loss - jinfo.final_loss) <= LOSS_RTOL * abs(
        jinfo.final_loss)
    assert abs(pinfo.iterations - jinfo.iterations) <= ITER_TOL
    assert pinfo.converged and pinfo.max_iter == jinfo.max_iter


def test_fit_counts_its_evaluations_and_host_reads():
    """One device-to-host read per loss evaluation and one per iteration
    (the slope along the new direction): the fit's whole sync budget."""
    X, y = _problem()
    _, info = P.fit_logistic_regression(X, y, return_info=True, device="cpu")
    assert info.evaluations > info.iterations
    assert info.host_syncs == info.evaluations + info.iterations


def test_fit_stops_at_max_iter_and_restores_tf32():
    X, y = _problem()
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, info = P.fit_logistic_regression(X, y, max_iter=3,
                                            return_info=True, device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert info.iterations == 3 and not info.converged
    with pytest.raises(ValueError, match="bad shapes"):
        P.fit_logistic_regression(X, y[:-1], device="cpu")


def test_lbfgs_separates_toy_data():
    X, y, _ = _toy_problem()
    model = P.fit_logistic_regression(X, y, max_iter=100, device="cpu")
    pred, _ = plinear.predict_dense(model, X)
    acc = np.mean(pred.numpy() == y)
    assert acc > 0.9, f"train accuracy {acc}"


def test_lbfgs_matches_sklearn_optimum():
    # regParam=0 unregularized optimum should agree with sklearn's lbfgs.
    from sklearn.linear_model import LogisticRegression as SkLR

    X, y, _ = _toy_problem(n=300, f=8, seed=1)
    ours = P.fit_logistic_regression(X, y, max_iter=200, tol=1e-9,
                                     device="cpu")
    sk = SkLR(penalty=None, max_iter=2000, tol=1e-10).fit(X, y)
    np.testing.assert_allclose(ours.weights.numpy(), sk.coef_[0], rtol=0.05,
                               atol=0.05)
    np.testing.assert_allclose(float(ours.intercept), sk.intercept_[0],
                               rtol=0.05, atol=0.05)


def test_loss_fn_equals_jax():
    X, y = _problem()
    rng = np.random.default_rng(3)
    w, b = rng.normal(0, 0.05, X.shape[1]).astype(np.float32), np.float32(0.2)
    mask = (rng.uniform(size=len(y)) < 0.8).astype(np.float32)
    want = float(jloss_fn((jnp.asarray(w), jnp.asarray(b)), jnp.asarray(X),
                          jnp.asarray(y), jnp.asarray(mask), 0.1))
    got = float(P._loss_fn((torch.from_numpy(w), torch.tensor(b)),
                           torch.from_numpy(X), torch.from_numpy(y),
                           torch.from_numpy(mask), 0.1))
    assert got == pytest.approx(want, rel=LOSS_RTOL)


def test_dense_scoring_equals_jax():
    X, _ = _problem()
    rng = np.random.default_rng(4)
    w = rng.normal(0, 0.05, X.shape[1]).astype(np.float32)
    jm = JLR(weights=jnp.asarray(w), intercept=jnp.float32(-0.1),
             threshold=0.4)
    pm = plinear.LogisticRegression.from_arrays(w, -0.1, 0.4, device="cpu")
    np.testing.assert_allclose(
        plinear.margin_dense(pm, torch.from_numpy(X)).numpy(),
        np.asarray(jmargin_dense(jm, jnp.asarray(X))), rtol=1e-5, atol=1e-5)
    jl, jp = jpredict_dense(jm, X)
    pl, pp = plinear.predict_dense(pm, X)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-6)


def test_cli_lr_equals_recorded_metrics(tmp_path):
    """The CLI's shipped configuration (1,600 dialogues, seed 42, 1,120 x
    10,000 TF-IDF) is nearly separable, so where L-BFGS stops depends on
    rounding: labels are gated exactly, AUC within AUC_TOL."""
    out = tmp_path / "metrics.json"
    assert ptrain.main(["--device", "cpu", "--models", "lr",
                        "--metrics-out", str(out)]) == 0
    got = json.loads(out.read_text())
    want = json.loads((ROOT / "reports" / "metrics.json").read_text())
    assert "tree_kernels" not in got["meta"]       # LR-only run
    assert set(got["meta"]["train_seconds"]) == {"lr"}
    for split in ("Validation", "Test"):
        g, w = got["metrics"]["lr"][split], want["metrics"]["lr"][split]
        assert g["confusion"] == w["confusion"], split
        assert g["accuracy"] == w["accuracy"], split
        assert abs(g["auc"] - w["auc"]) <= AUC_TOL, (split, g["auc"], w["auc"])
