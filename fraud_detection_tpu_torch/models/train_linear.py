"""Full-batch logistic-regression training — twin of
``fraud_detection_tpu/models/train_linear.py``.

Replaces Spark MLlib's ``LogisticRegression.fit`` (the trainer behind the
shipped artifact's final stage: regParam 0.0, maxIter 100, tol 1e-6,
fitIntercept). The optimizer is this module's own L-BFGS, which follows
optax 0.2.6's ``optax.lbfgs()`` at its defaults step for step, as the JAX
package runs it:

* memory 10, the identity scaled by ``<dy, ds> / <dy, dy>`` and, on the
  first step, by ``min(1, 1 / |g|)`` (``scale_by_lbfgs``,
  ``scale_init_precond=True``);
* the zoom line search (``scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy='one')``: slope_rtol 1e-4, curv_rtol 0.9,
  approx_dec_rtol 1e-6, increase_factor 2, stepsize_precision 1e-5, tol 0)
  with its cubic / quadratic / bisection interpolation and its fallback to
  the best point of sufficient decrease;
* the JAX fit's stopping rule: ``it < 2 or (|g| > tol and rel_impr > tol)``,
  at most ``max_iter`` iterations.

The parameters are one f32 vector ``[w; b]`` on the fit's device; the
loss, its gradient, the memory and the two-loop recursion stay there. The
line search's decisions are scalar tests that optax takes in f32: this
module takes them on the host in numpy float32, after ONE device-to-host
read per function evaluation (value, slope along the direction, gradient
norm) and one per iteration (the initial slope). ``FitInfo`` counts both.

Matrix products run in full f32: the fit turns TF32 off for its duration.

Distribution: with a ``mesh`` (``parallel/mesh.py``) the rows, labels and a
validity mask are padded to a data-axis multiple (padded rows carry mask
0) and sharded; each shard computes its masked log-loss sum and its GEMV
products (X_s w for the logits, X_s^T dz for the gradient) on its own
device, and the data-axis helper ``data_sum`` adds them (across processes
too) before the masked mean — the reference's psum, Spark's
treeAggregate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from fraud_detection_tpu_torch.models.linear import LogisticRegression
from fraud_detection_tpu_torch.parallel import mesh as mesh_lib
from fraud_detection_tpu_torch.utils.device import resolve_device

_f32 = np.float32

# optax.lbfgs() defaults (optax 0.2.6, alias.py / linesearch.py).
MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = _f32(1e-4), _f32(0.9), _f32(1e-6)
INCREASE_FACTOR, STEPSIZE_PRECISION, LINESEARCH_TOL = _f32(2.0), _f32(1e-5), _f32(0.0)


@dataclass
class FitInfo:
    """Convergence record for a training run. ``evaluations`` counts loss +
    gradient evaluations (each reads X twice) and ``host_syncs`` the
    device-to-host reads the line search's decisions took."""

    final_loss: float
    iterations: int
    max_iter: int
    evaluations: int = 0
    host_syncs: int = 0

    @property
    def converged(self) -> bool:
        return self.iterations < self.max_iter


def _mean_logloss(logits: torch.Tensor, y: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Masked mean of optax's ``sigmoid_binary_cross_entropy``."""
    per_row = -y * F.logsigmoid(logits) - (1.0 - y) * F.logsigmoid(-logits)
    return torch.sum(per_row * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _loss_fn(params: Tuple[torch.Tensor, torch.Tensor], X: torch.Tensor,
             y: torch.Tensor, mask: torch.Tensor, l2: float) -> torch.Tensor:
    """Masked mean binary log-loss + 0.5 * l2 * |w|^2 (no penalty on the
    intercept)."""
    w, b = params
    return _mean_logloss(X @ w + b, y, mask) + 0.5 * l2 * torch.sum(w * w)


class _Objective:
    """Loss and analytic gradient over the flat parameters ``[w; b]``: one
    pass over X for the logits, one for the gradient.

    ``X``, ``y`` and ``mask`` (default all ones) are tensors, or over a
    ``mesh`` lists of its row shards: each shard's masked loss sum,
    ``X_s^T dz_s`` and ``sum(dz_s)`` on its device, one ``data_sum`` of the
    three per evaluation, then the mean on the mesh's first device (where
    the parameters live). dz is divided by the masked row count before the
    GEMV, so a single device rounds as a plain fit does."""

    def __init__(self, X, y, l2: float, mask=None, mesh=None):
        shards = lambda a: a if isinstance(a, list) else [a]
        self.Xs, self.ys = shards(X), shards(y)
        self.masks = ([torch.ones_like(t) for t in self.ys] if mask is None
                      else shards(mask))
        self.l2, self.mesh = float(l2), mesh
        self.n = torch.clamp(self._sum([m.sum()[None] for m in self.masks])[0],
                             min=1.0)
        self.evaluations = 0

    def _sum(self, parts: List[torch.Tensor]) -> torch.Tensor:
        return parts[0] if self.mesh is None else mesh_lib.data_sum(parts,
                                                                    self.mesh)

    def __call__(self, theta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        self.evaluations += 1
        thetas = ([theta] if self.mesh is None
                  else mesh_lib.replicate(theta, self.mesh))
        parts = []
        for X, y, m, th in zip(self.Xs, self.ys, self.masks, thetas):
            logits = X @ th[:-1] + th[-1]
            per_row = -y * F.logsigmoid(logits) - (1.0 - y) * F.logsigmoid(-logits)
            # d/dz of -y log s(z) - (1-y) log s(-z), as autodiff forms it
            dz = (-y * torch.sigmoid(-logits)
                  + (1.0 - y) * torch.sigmoid(logits)) * m
            dz = dz / self.n.to(dz.device)
            parts.append(torch.cat([X.t() @ dz, dz.sum()[None],
                                    torch.sum(per_row * m)[None]]))
        tot = self._sum(parts)
        w = theta[:-1]
        value = tot[-1] / self.n + 0.5 * self.l2 * torch.sum(w * w)
        grad = torch.cat([tot[:-2] + self.l2 * w, tot[-2:-1]])
        return value, grad


class _Point:
    """A trial point of the line search: f32 scalars on the host, the
    gradient on the device."""

    __slots__ = ("step", "value", "slope", "gnorm", "grad")

    def __init__(self, step, value, slope, gnorm, grad):
        self.step, self.value, self.slope = _f32(step), _f32(value), _f32(slope)
        self.gnorm, self.grad = _f32(gnorm), grad


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax's ``_cubicmin``: the critical point of the cubic through (a, fa)
    with slope fpa, (b, fb) and (c, fc); NaN when there is none."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0, v1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc * dc * v0 + -(db * db) * v1) / denom
    B = (-(dc * dc * dc) * v0 + db * db * db * v1) / denom
    radical = B * B - _f32(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (_f32(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """optax's ``_quadmin``: the critical point of the quadratic through
    (a, fa) with slope fpa and (b, fb)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (_f32(2.0) * B)


class _ZoomLinesearch:
    """optax's ``zoom_linesearch`` state machine for one L-BFGS step, its
    scalars in f32 on the host. ``evaluate(stepsize)`` returns the
    ``_Point`` at ``params + stepsize * updates``."""

    def __init__(self, evaluate, init: _Point):
        self.evaluate = evaluate
        self.count = 0
        self.cur = init                        # stepsize / value / grad / slope
        self.value_init, self.slope_init = init.value, init.slope
        self.decrease_error = self.curvature_error = _f32(np.inf)
        self.interval_found = self.done = self.failed = False
        self.low = self.high = self.cubic_ref = init
        self.safe = init                       # safe.step 0 until one is found

    def _errors(self, p: _Point) -> Tuple[np.float32, np.float32]:
        dec = p.value - self.value_init - SLOPE_RTOL * p.step * self.slope_init
        approx = p.slope - (_f32(2.0) * SLOPE_RTOL - _f32(1.0)) * self.slope_init
        delta = p.value - self.value_init - APPROX_DEC_RTOL * np.abs(self.value_init)
        dec = np.minimum(np.maximum(approx, delta), dec)
        dec = np.maximum(dec, _f32(0.0))
        dec = _f32(np.inf) if np.isnan(dec) else dec
        curv = np.maximum(np.abs(p.slope) - CURV_RTOL * np.abs(self.slope_init),
                          _f32(0.0))
        curv = _f32(np.inf) if np.isnan(curv) else curv
        return dec, curv

    def _search_interval(self) -> None:
        prev = self.cur
        step = _f32(1.0) if self.count == 0 else INCREASE_FACTOR * prev.step
        new = self.evaluate(step)
        dec, curv = self._errors(new)
        error = np.maximum(dec, curv)
        if dec <= LINESEARCH_TOL:
            self.safe = new
        set_high = bool(dec > 0.0) or bool(new.value >= prev.value
                                           and self.count > 0)
        set_low = bool(new.slope >= 0.0) and not set_high
        self.low, self.high = (new, prev) if set_low else (prev, new)
        self.cubic_ref = self.low
        self.interval_found = set_high or set_low or bool(error <= LINESEARCH_TOL)
        self.done = bool(error <= LINESEARCH_TOL)
        self.failed = self.count + 1 >= MAX_LINESEARCH_STEPS and not self.done
        self._advance(new, dec, curv)

    def _zoom_into_interval(self) -> None:
        low, high, ref = self.low, self.high, self.cubic_ref
        delta = np.abs(high.step - low.step)
        left, right = np.minimum(high.step, low.step), np.maximum(high.step, low.step)
        cubic_chk, quad_chk = _f32(0.2) * delta, _f32(0.1) * delta
        too_small = bool(delta <= STEPSIZE_PRECISION)
        with np.errstate(all="ignore"):
            mid_c = _cubicmin(low.step, low.value, low.slope, high.step,
                              high.value, ref.step, ref.value)
            mid_q = _quadmin(low.step, low.value, low.slope, high.step,
                             high.value)
        if left + cubic_chk < mid_c < right - cubic_chk:
            step = mid_c
        elif left + quad_chk < mid_q < right - quad_chk:
            step = mid_q
        else:
            step = (low.step + high.step) / _f32(2.0)
        mid = self.evaluate(step)
        dec, curv = self._errors(mid)
        error = np.maximum(dec, curv)
        if dec <= LINESEARCH_TOL and mid.value < self.safe.value:
            self.safe = mid
        self.done = bool(error <= LINESEARCH_TOL)
        set_high_to_mid = bool(dec > 0.0) or bool(mid.value >= low.value)
        set_high_to_low = (bool(mid.slope * (high.step - low.step) >= 0.0)
                           and not set_high_to_mid)
        new_high = mid if set_high_to_mid else high
        self.high = low if set_high_to_low else new_high
        self.low = low if set_high_to_mid else mid
        self.cubic_ref = high if (set_high_to_mid or set_high_to_low) else low
        presumably_failed = (self.count + 1 >= MAX_LINESEARCH_STEPS
                             or (too_small and self.safe.step > 0.0))
        self.failed = presumably_failed and not self.done
        self._advance(mid, dec, curv)

    def _advance(self, p: _Point, dec, curv) -> None:
        self.count += 1
        self.cur = p
        self.decrease_error, self.curvature_error = dec, curv
        if self.failed and (self.safe.step > 0.0 or np.isinf(dec)):
            self.cur = self.safe          # optax's _try_safe_step

    def run(self) -> _Point:
        while not (self.done or self.failed):
            if self.interval_found:
                self._zoom_into_interval()
            else:
                self._search_interval()
        return self.cur


class LBFGS:
    """optax ``lbfgs()`` driven as the JAX fit drives it, one ``step()`` an
    iteration, on flat f32 parameters on the objective's device."""

    def __init__(self, objective, theta: torch.Tensor,
                 memory_size: int = MEMORY_SIZE):
        self.objective = objective
        self.theta = theta
        self.m = memory_size
        n, dev = theta.shape[0], theta.device
        self.count = 0
        self.prev_theta = torch.zeros_like(theta)
        self.prev_grad = torch.zeros_like(theta)
        self.S = torch.zeros((memory_size, n), dtype=theta.dtype, device=dev)
        self.Y = torch.zeros_like(self.S)
        self.rho = torch.zeros(memory_size, dtype=theta.dtype, device=dev)
        self.value: Optional[_Point] = None   # f and grad at theta, once known
        self.prev_value = _f32(np.inf)        # f where the last step started
        self.linesearch_steps = 0
        self.host_syncs = 0

    def _read(self, *scalars: torch.Tensor) -> List[float]:
        self.host_syncs += 1
        return torch.stack(scalars).tolist()

    def _point(self, step, theta: torch.Tensor,
               direction: Optional[torch.Tensor] = None) -> _Point:
        """Loss and gradient at ``theta``; one read brings back the value,
        |g|^2 and (given a direction) the slope along it."""
        value, grad = self.objective(theta)
        scalars = [value, torch.dot(grad, grad)]
        if direction is not None:
            scalars.append(torch.dot(grad, direction))
        v, g2, *slope = self._read(*scalars)
        return _Point(step, v, slope[0] if slope else 0.0, np.sqrt(_f32(g2)),
                      grad)

    def _direction(self, grad: torch.Tensor) -> torch.Tensor:
        """``scale_by_lbfgs`` then ``scale(-1)``: -P_k g_k, after the memory
        takes this iteration's differences."""
        k, m = self.count, self.m
        if k > 0:
            ds, dy = self.theta - self.prev_theta, grad - self.prev_grad
            vdot = torch.dot(dy, ds)
            slot = (k - 1) % m
            self.S[slot], self.Y[slot] = ds, dy
            self.rho[slot] = torch.where(vdot == 0.0, torch.zeros_like(vdot),
                                         1.0 / vdot)
            den = torch.dot(dy, dy)
            gamma = torch.where(den > 0.0, vdot / den, torch.ones_like(den))
        else:
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(grad), max=1.0)
        # optax scans all m slots, oldest first; a slot never written holds
        # zeros and rho 0 and leaves the vector exactly as it is, so only
        # the min(k, m) written ones are visited
        order = [(k + i) % m for i in range(m)][m - min(k, m):]
        vec, alphas = grad, {}
        for idx in reversed(order):
            alphas[idx] = self.rho[idx] * torch.dot(self.S[idx], vec)
            vec = vec - alphas[idx] * self.Y[idx]
        vec = gamma * vec
        for idx in order:
            beta = self.rho[idx] * torch.dot(self.Y[idx], vec)
            vec = vec + (alphas[idx] - beta) * self.S[idx]
        return -vec

    def step(self) -> _Point:
        """One L-BFGS iteration; returns the line search's accepted point
        (its ``step`` is the step size taken)."""
        cur = self.value
        if cur is None or not np.isfinite(cur.value):
            cur = self._point(0.0, self.theta)
        direction = self._direction(cur.grad)
        (slope,) = self._read(torch.dot(direction, cur.grad))
        init = _Point(0.0, cur.value, slope, cur.gnorm, cur.grad)
        theta = self.theta
        ls = _ZoomLinesearch(
            lambda s: self._point(s, theta + float(s) * direction, direction),
            init)
        new = ls.run()
        self.prev_theta, self.prev_grad = theta, cur.grad
        self.theta = theta + float(new.step) * direction
        self.count += 1
        self.prev_value, self.value = cur.value, new
        self.linesearch_steps = ls.count
        return new


def fit_logistic_regression(
    X, y, *, mesh=None, max_iter: int = 100, tol: float = 1e-6,
    reg_param: float = 0.0, threshold: float = 0.5,
    return_info: bool = False, device="cuda",
) -> Union[LogisticRegression, Tuple[LogisticRegression, FitInfo]]:
    """Fit binary LR on a dense (N, F) feature matrix (numpy, or a tensor)
    with labels (N,) in {0, 1}, on ``device``, or data-parallel over
    ``mesh`` (rows padded to a data-axis multiple and sharded, padded rows
    masked out). Returns a ``LogisticRegression`` on ``device`` (the mesh's
    first device) in float32; with ``return_info=True`` also a
    ``FitInfo``."""
    dev = mesh.home if mesh is not None else resolve_device(device)

    def f32(a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a, np.float32))
        return a.to(dev, torch.float32)

    if mesh is not None:
        X = X if isinstance(X, torch.Tensor) else np.asarray(X, np.float32)
        y = y if isinstance(y, torch.Tensor) else np.asarray(y, np.float32)
    else:
        X, y = f32(X), f32(y)
    if X.ndim != 2 or tuple(y.shape) != (X.shape[0],):
        raise ValueError(f"bad shapes X{tuple(X.shape)} y{tuple(y.shape)}")
    tol32 = _f32(tol)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if mesh is None:
            objective = _Objective(X, y, reg_param)
        else:
            f32s = lambda a: [t.to(torch.float32)
                              for t in mesh_lib.shard_rows(a, mesh).shards]
            objective = _Objective(
                f32s(X), f32s(y), reg_param,
                mask=f32s(np.ones(X.shape[0], np.float32)), mesh=mesh)
        opt = LBFGS(objective, torch.zeros(X.shape[1] + 1, dtype=torch.float32,
                                           device=dev))
        it = 0
        while it < max_iter:
            if it >= 2:
                prev, val = opt.prev_value, opt.value.value
                with np.errstate(all="ignore"):
                    rel = np.abs(prev - val) / np.maximum(np.abs(prev),
                                                          _f32(1e-12))
                if not (opt.value.gnorm > tol32 and rel > tol32):
                    break
            opt.step()
            it += 1
        final = (float(opt.value.value) if opt.value is not None
                 else float(objective(opt.theta)[0]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    w, b = opt.theta[:-1].clone(), opt.theta[-1].clone()
    model = LogisticRegression(weights=w, intercept=b, threshold=threshold)
    if return_info:
        return model, FitInfo(final, it, max_iter, objective.evaluations,
                              opt.host_syncs)
    return model
