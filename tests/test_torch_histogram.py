"""The port's tree-training kernels' plain versions against the JAX
package's Pallas kernels (interpret mode) on the CPU.

* Histogram, exact integer path (gini: one-hot stats x Poisson weights): the
  port equals ``node_feature_bin_histogram_multi(..., exact_int8=True,
  interpret=True)`` exactly, for T = 1 and T = 3, with N and F off the JAX
  tile grid and inactive rows.
* Histogram, f32 path: within rtol 1e-5 of the largest |cell| of JAX's
  ``histogram_reference`` (XLA segment sum). The port sums in f32 in row
  order; the TPU kernel's bf16 hi/lo passes are less exact, so the segment
  sum is the reference.
* ``best_splits``: indices exact and gains within rtol 1e-6 of the JAX
  kernel, for gini and xgb, with tied candidates, an all-invalid node and
  ``feature_tile`` < F (ragged).
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fraud_detection_tpu.ops import histogram as jh
from fraud_detection_tpu_torch.ops import histogram as ph
from tests import torch_parity  # noqa: F401 — one torch thread per worker


def _int_case(t, n=301, f=37, nb=8, L=4, k=2, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, nb, (n, f)).astype(np.int32)
    locals_ = rng.integers(-1, L + 1, (t, n)).astype(np.int32)   # -1, L: skip
    weights = rng.poisson(1.0, (t, n)).astype(np.float32)
    stats = np.eye(k, dtype=np.float32)[rng.integers(0, k, n)]
    return bins, locals_, weights, stats, nb, L


@pytest.mark.parametrize("t", [1, 3])
def test_int_histogram_equals_jax_kernel(t):
    bins, locals_, weights, stats, nb, L = _int_case(t, seed=t)
    want = np.asarray(jh.node_feature_bin_histogram_multi(
        jnp.asarray(bins), jnp.asarray(locals_), jnp.asarray(weights),
        jnp.asarray(stats), n_nodes=L, n_bins=nb, row_tile=64,
        feature_tile=16, interpret=True, exact_int8=True))
    got = ph.node_feature_bin_histogram_multi(
        torch.from_numpy(bins), torch.from_numpy(locals_),
        torch.from_numpy(weights), torch.from_numpy(stats), n_nodes=L,
        n_bins=nb, exact_int8=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("t", [1, 3])
def test_f32_histogram_matches_segment_sum(t):
    rng = np.random.default_rng(10 + t)
    n, f, nb, L, k = 300, 40, 8, 4, 3
    bins = rng.integers(0, nb, (n, f)).astype(np.int32)
    locals_ = rng.integers(0, L + 1, (t, n)).astype(np.int32)
    weights = rng.poisson(1.0, (t, n)).astype(np.float32)
    stats = rng.normal(size=(n, k)).astype(np.float32)
    got = ph.node_feature_bin_histogram_multi(
        torch.from_numpy(bins), torch.from_numpy(locals_),
        torch.from_numpy(weights), torch.from_numpy(stats), n_nodes=L,
        n_bins=nb).numpy()
    for ti in range(t):
        want = np.asarray(jh.histogram_reference(
            jnp.asarray(bins), jnp.asarray(locals_[ti]),
            jnp.asarray(stats * weights[ti][:, None]), n_nodes=L, n_bins=nb))
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got[ti], want, rtol=0, atol=1e-5 * scale)


def test_single_tree_wrapper_is_multi_with_unit_weights():
    bins, locals_, _, stats, nb, L = _int_case(1, seed=4)
    one = ph.node_feature_bin_histogram(
        torch.from_numpy(bins), torch.from_numpy(locals_[0]),
        torch.from_numpy(stats), n_nodes=L, n_bins=nb, exact_int8=True)
    multi = ph.node_feature_bin_histogram_multi(
        torch.from_numpy(bins), torch.from_numpy(locals_),
        torch.ones((1, bins.shape[0])), torch.from_numpy(stats), n_nodes=L,
        n_bins=nb, exact_int8=True)
    assert torch.equal(one, multi[0])


def test_int8_contract_violation_is_logged_and_clipped():
    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Grab()
    ph._log.addHandler(handler)
    try:
        bins = torch.zeros((2, 1), dtype=torch.int32)
        stats = torch.tensor([[1.0], [1.0]])
        out = ph.node_feature_bin_histogram_multi(
            bins, torch.zeros((1, 2), dtype=torch.int32),
            torch.tensor([[200.0, -3.0]]), stats, n_nodes=1, n_bins=2,
            exact_int8=True)
    finally:
        ph._log.removeHandler(handler)
    assert out[0, 0, 0, 0, 0].item() == 127.0           # 127 + clip(-3) = 0
    assert any("exact_int8 contract violated" in r for r in records)


def test_self_test_reckoning_equals_plain_version():
    """The host reckoning the card self-test holds the kernel to agrees
    with the plain version on the self-test's own inputs."""
    n, f, nb = 7, 40, 4
    bins = [[(3 * r + 5 * c) % nb for c in range(f)] for r in range(n)]
    locals_ = [[0, 1, 1, 2, 0, -1, 1], [1, 1, 0, 0, 0, 1, 0]]
    weights = [[1.0, 2.0, 0.0, 1.0, 3.0, 1.0, 1.0],
               [2.0, 1.0, 1.0, 1.0, 120.0, 1.0, 0.5]]
    stats = [[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, 1.0], [1.0, 0.0],
             [0.5, 0.25], [0.0, 1.0]]
    for exact in (True, False):
        want = torch.tensor(ph._expected_histogram(bins, locals_, weights,
                                                   stats, 2, nb, exact))
        got = ph.histogram_reference(
            torch.tensor(bins, dtype=torch.int32),
            torch.tensor(locals_, dtype=torch.int32), torch.tensor(weights),
            torch.tensor(stats), n_nodes=2, n_bins=nb, exact_int8=exact)
        assert torch.equal(got, want)


def test_wrappers_refuse_other_devices():
    meta = torch.empty((4, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        ph.node_feature_bin_histogram(meta, meta[:, 0], meta.float(),
                                      n_nodes=1, n_bins=2)
    with pytest.raises(ValueError, match="device"):
        ph.best_splits(torch.empty((1, 3, 4, 2), device="meta"),
                       torch.empty((1, 2), device="meta"))


# ---------------------------------------------------------------------------
# best_splits
# ---------------------------------------------------------------------------

def _gini_hist(seed, L=5, f=50, nb=8, k=2):
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 6, (L, f, nb, k)).astype(np.float32)
    hist[:, ::7] = hist[:, 3:4]           # duplicated features: exact ties
    hist[1] = 0.0
    hist[1, :, 0, :] = 3.0                # every row in bin 0: all invalid
    totals = hist[:, 0].sum(axis=1)
    return hist, totals


def _xgb_hist(seed, L=5, f=50, nb=8):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(L, f, nb)).astype(np.float32)
    h = rng.uniform(0.0, 0.25, (L, f, nb)).astype(np.float32)
    c = rng.integers(0, 4, (L, f, nb)).astype(np.float32)
    h[c == 0] = 0.0
    g[c == 0] = 0.0
    hist = np.stack([g, h, c], axis=-1)
    hist[:, 10] = hist[:, 2]              # tie between features 2 and 10
    hist[2] = 0.0                         # empty node: all invalid
    hist[2, :, 0, :] = 0.0
    totals = hist[:, 0].sum(axis=1)
    return hist, totals


@pytest.mark.parametrize("criterion", ["gini", "xgb"])
@pytest.mark.parametrize("feature_tile", [1024, 16])
def test_best_splits_matches_jax_kernel(criterion, feature_tile):
    hist, totals = (_gini_hist(1) if criterion == "gini" else _xgb_hist(2))
    jf, jb, jg = (np.asarray(a) for a in jh.best_splits(
        jnp.asarray(hist), jnp.asarray(totals), criterion=criterion,
        n_bins=hist.shape[2], feature_tile=feature_tile, interpret=True))
    pf, pb, pg = ph.best_splits(torch.from_numpy(hist),
                                torch.from_numpy(totals), criterion=criterion,
                                n_bins=hist.shape[2], feature_tile=feature_tile)
    np.testing.assert_array_equal(pf.numpy(), jf)
    np.testing.assert_array_equal(pb.numpy(), jb)
    np.testing.assert_allclose(pg.numpy(), jg, rtol=1e-6)
    invalid = 1 if criterion == "gini" else 2
    assert (int(pf[invalid]), int(pb[invalid])) == (0, 0)
    assert pg[invalid].item() == float("-inf")


def test_best_splits_first_occurrence_ties():
    """Equal gains resolve to the first (feature, bin) in row-major order:
    six identical features, each with three equally good bins, across two
    feature tiles."""
    hist = np.zeros((1, 6, 4, 2), np.float32)
    hist[0, :, 0] = [2.0, 0.0]
    hist[0, :, 3] = [0.0, 2.0]
    totals = hist[:, 0].sum(axis=1)
    f_, b_, g_ = ph.best_splits(torch.from_numpy(hist),
                                torch.from_numpy(totals), feature_tile=4)
    assert (int(f_[0]), int(b_[0])) == (0, 0)
    assert g_[0].item() == pytest.approx(0.5)


def test_best_splits_reference_is_the_wrapper_on_cpu():
    hist, totals = _xgb_hist(5)
    a = ph.best_splits(torch.from_numpy(hist), torch.from_numpy(totals),
                       criterion="xgb")
    b = ph.best_splits_reference(torch.from_numpy(hist),
                                 torch.from_numpy(totals), criterion="xgb")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_f32_plain_version_adds_in_the_kernel_order():
    """With several row chunks, each chunk's cells sum in f32 over its rows
    in ascending order and the partials add in chunk order — the CUDA
    kernel's order, so the plain version on the CPU is bit-equal to it."""
    rng = np.random.default_rng(7)
    n, f, nb, L = 3000, 3, 4, 2
    chunks = ph.histogram_chunks(n, f, 1, L)
    assert chunks == 2
    bins = rng.integers(0, nb, (n, f)).astype(np.int32)
    loc = rng.integers(0, L, (1, n)).astype(np.int32)
    stats = rng.normal(size=(n, 1)).astype(np.float32)
    got = ph.histogram_reference(
        torch.from_numpy(bins), torch.from_numpy(loc),
        torch.ones((1, n)), torch.from_numpy(stats), n_nodes=L,
        n_bins=nb).numpy()
    per = -(-n // chunks)
    want = np.zeros((L, f, nb), np.float32)
    for c in range(chunks):
        part = np.zeros((L, f, nb), np.float32)
        for r in range(c * per, min(n, (c + 1) * per)):
            for ff in range(f):
                cell = (loc[0, r], ff, bins[r, ff])
                part[cell] = np.float32(part[cell] + stats[r, 0])
        want = part if c == 0 else (want + part).astype(np.float32)
    np.testing.assert_array_equal(got[0, ..., 0], want)
