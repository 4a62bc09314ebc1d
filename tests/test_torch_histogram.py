"""The port's tree-training kernels' plain versions against the JAX
package's Pallas kernels (interpret mode) on the CPU.

* Histogram, exact integer path (gini: one-hot stats x Poisson weights): the
  port, on uint8 bins (the trainer's) and on int32 bins, equals
  ``node_feature_bin_histogram_multi(..., exact_int8=True, interpret=True)``
  on int32 bins exactly, for T = 1 and T = 3, with N and F off the JAX tile
  grid, inactive rows, and a column whose rows nearly all share one bin.
* Histogram, f32 path: within rtol 1e-5 of the largest |cell| of JAX's
  ``histogram_reference`` (XLA segment sum). The port sums in f32 in the
  CUDA kernel's order (``histogram_plan``'s row chunks); the TPU kernel's
  bf16 hi/lo passes are less exact, so the segment sum is the reference.
* ``best_splits``: indices exact and gains within rtol 1e-6 of the JAX
  kernel, for gini and xgb, with tied candidates, an all-invalid node,
  L = 1, F off the 32-feature slab, NB = 2 and 32, and answers that do not
  depend on ``feature_tile``.
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


@pytest.mark.parametrize("bins_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("t", [1, 3])
def test_int_histogram_equals_jax_kernel(t, bins_dtype):
    bins, locals_, weights, stats, nb, L = _int_case(t, seed=t)
    want = np.asarray(jh.node_feature_bin_histogram_multi(
        jnp.asarray(bins), jnp.asarray(locals_), jnp.asarray(weights),
        jnp.asarray(stats), n_nodes=L, n_bins=nb, row_tile=64,
        feature_tile=16, interpret=True, exact_int8=True))
    got = ph.node_feature_bin_histogram_multi(
        torch.from_numpy(bins.astype(bins_dtype)), torch.from_numpy(locals_),
        torch.from_numpy(weights), torch.from_numpy(stats), n_nodes=L,
        n_bins=nb, exact_int8=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bins_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("t", [1, 3])
def test_f32_histogram_matches_segment_sum(t, bins_dtype):
    rng = np.random.default_rng(10 + t)
    n, f, nb, L, k = 300, 40, 8, 4, 3
    bins = rng.integers(0, nb, (n, f)).astype(np.int32)
    locals_ = rng.integers(0, L + 1, (t, n)).astype(np.int32)
    weights = rng.poisson(1.0, (t, n)).astype(np.float32)
    stats = rng.normal(size=(n, k)).astype(np.float32)
    got = ph.node_feature_bin_histogram_multi(
        torch.from_numpy(bins.astype(bins_dtype)), torch.from_numpy(locals_),
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


@pytest.mark.parametrize("bins_dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("exact", [True, False])
def test_self_test_reckoning_equals_plain_version(exact, bins_dtype):
    """The host reckoning the card self-test holds the kernel to agrees
    with the plain version on the self-test's own inputs (bin id -1 is 255
    in the uint8 copy; both add nothing)."""
    bins, locals_, weights, stats, n_nodes, nb = ph.self_test_histogram_inputs()
    want = torch.tensor(ph._expected_histogram(bins, locals_, weights, stats,
                                               n_nodes, nb, exact))
    tb = torch.tensor(bins, dtype=torch.int32)
    got = ph.histogram_reference(
        torch.where(tb < 0, 255, tb).to(bins_dtype),
        torch.tensor(locals_, dtype=torch.int32), torch.tensor(weights),
        torch.tensor(stats), n_nodes=n_nodes, n_bins=nb, exact_int8=exact)
    assert torch.equal(got, want)
    # the self-test's plans split pairs into node and tree groups and rows
    # into chunks and sub-chunks: every pair is covered, and the C entry's
    # rule holds
    t = len(locals_)
    for plan in ph.SELF_TEST_PLANS:
        assert plan.trees == 1 or plan.nodes == n_nodes
        assert plan.warps <= plan.trees * plan.nodes * plan.subs <= 18
    assert {(p.trees, p.nodes > 1, p.chunks > 1) for p in ph.SELF_TEST_PLANS} >= {
        (1, False, False), (1, True, True), (2, True, True)}
    copies = [(p.trees * p.nodes * p.subs, p.warps) for p in ph.SELF_TEST_PLANS
              if p.subs > 1]
    assert any(c == w for c, w in copies) and any(c > w for c, w in copies)
    assert any(t % p.trees for p in ph.SELF_TEST_PLANS)
    assert any(n_nodes % p.nodes for p in ph.SELF_TEST_PLANS)


def _c_params(source: str, entry: str):
    """The C entry point's parameter types, from its source: "ptr" for a
    pointer, else the scalar type."""
    import re
    from pathlib import Path

    text = (Path(ph.__file__).parent / "csrc" / source).read_text()
    sig = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text).group(1)
    kinds = []
    for param in sig.split(","):
        words = param.replace("*", " * ").split()
        kinds.append("ptr" if "*" in words else words[-2])
    return kinds


@pytest.mark.parametrize("source,entry,argtypes", [
    ("histogram.cu", "histogram_launch", ph.HIST_ARGTYPES),
    ("best_splits.cu", "best_splits_launch", ph.GAIN_ARGTYPES),
])
def test_ctypes_argtypes_match_the_c_entry(source, entry, argtypes):
    """The wrappers' ctypes signatures name the C entry points' parameters
    one for one (a mismatch would show only at a launch on the card)."""
    import ctypes

    kind = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
            ctypes.c_float: "float"}
    assert [kind[a] for a in argtypes] == _c_params(source, entry)


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
    """With several row chunks, each split round-robin into sub-chunks,
    each sub-chunk's cells sum in f32 over its rows in ascending order, the
    sub-chunks add in order, then the partials in chunk order — the CUDA
    kernel's order (each accumulator copy's cell owned by one lane, row
    tiles in turn), so the plain version on the CPU is bit-equal to it. The
    plan does not depend on the bins' dtype: uint8 bins give the same
    bits."""
    rng = np.random.default_rng(7)
    n, f, nb, L = 3000, 3, 4, 2
    plan = ph.histogram_plan(n, f, 1, L, nb, 1)
    chunks, subs = plan.chunks, plan.subs
    assert (chunks, subs) == (11, 8)
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
        for sub in range(subs):
            copy = np.zeros((L, f, nb), np.float32)
            for r in range(c * per + sub, min(n, (c + 1) * per), subs):
                for ff in range(f):
                    cell = (loc[0, r], ff, bins[r, ff])
                    copy[cell] = np.float32(copy[cell] + stats[r, 0])
            part = copy if sub == 0 else (part + copy).astype(np.float32)
        want = part if c == 0 else (want + part).astype(np.float32)
    np.testing.assert_array_equal(got[0, ..., 0], want)
    got8 = ph.histogram_reference(
        torch.from_numpy(bins.astype(np.uint8)), torch.from_numpy(loc),
        torch.ones((1, n)), torch.from_numpy(stats), n_nodes=L,
        n_bins=nb).numpy()
    np.testing.assert_array_equal(got8, got)


# The chip run's four level shapes and others: (N, F, T, L, NB, K) -> (trees
# per block, nodes per block, warps, row chunks, sub-chunks) on the f32 path.
_PLAN_CASES = [
    ((1120, 10000, 1, 16, 32, 3), (1, 16, 16, 1, 1)),   # CLI xgb level
    ((1120, 10000, 8, 16, 32, 2), (1, 16, 16, 1, 1)),   # CLI forest level
    ((100000, 2048, 1, 16, 32, 3), (1, 16, 16, 5, 1)),  # bench xgb level
    ((100000, 2048, 8, 16, 32, 2), (1, 16, 16, 1, 1)),  # bench forest level
    ((100000, 2048, 1, 1, 32, 3), (1, 1, 16, 5, 16)),   # a root level
    ((1120, 10000, 1, 1, 32, 3), (1, 1, 16, 1, 16)),    # the CLI's root level
    ((1120, 10000, 1, 4, 32, 3), (1, 4, 16, 1, 4)),     # the CLI's third level
    ((100000, 2048, 8, 1, 32, 2), (8, 1, 16, 5, 2)),    # a forest root level
    ((100000, 2048, 8, 8, 32, 2), (3, 8, 16, 2, 1)),    # 8 trees as 3 + 3 + 2
    ((3000, 3, 1, 2, 4, 1), (1, 2, 16, 11, 8)),
    ((100, 70, 1, 20, 32, 3), (1, 10, 10, 1, 1)),       # 20 nodes as 10 + 10
    ((500, 70, 1, 3, 32, 3), (1, 3, 15, 1, 5)),         # 3 nodes x 5 copies
]


@pytest.mark.parametrize("shape,want", _PLAN_CASES)
def test_histogram_plan_rule(shape, want):
    """Accumulator copies fit shared memory with the ring's reserve; whole
    trees go together where they fit (balanced, at most 8), else balanced
    runs of one tree's nodes; on the f32 path a small group takes
    sub-chunks up to 16 copies, a warp each; row chunks give at least two
    waves of blocks unless each chunk would fall under 256 rows. The exact
    path gives every block 16 warps and one sub-chunk and, at up to 8,192
    rows, sizes blocks for two an SM."""
    n, f, t, L, nb, k = shape
    plan = ph.histogram_plan(*shape)
    assert (plan.trees, plan.nodes, plan.warps, plan.chunks, plan.subs) == want
    pairs = plan.trees * plan.nodes
    smem = ph._smem_budget(pairs * plan.subs, nb, k)
    assert smem <= ph._MAX_SHARED
    assert plan.subs == 1 or (pairs * plan.subs <= 16
                              and plan.warps == pairs * plan.subs)
    assert plan.trees <= 8 and (plan.trees == 1 or plan.nodes == L)
    groups = -(-t // plan.trees) * -(-L // plan.nodes)
    assert -(-t // groups) == plan.trees or plan.trees == 1
    per_sm = max(1, min(ph._SM_SHARED // (smem + 1024), 64 // plan.warps, 32))
    blocks = -(-f // 32) * groups * plan.chunks
    assert (blocks >= 2 * 132 * per_sm or plan.chunks == max(1, n // 256)
            or plan.chunks == ph._MAX_CHUNKS)
    assert plan.chunks == 1 or n // plan.chunks >= 256
    exact = ph.histogram_plan(*shape, exact=True)
    assert exact.warps == 16 and exact.subs == 1
    if n > 8192:
        assert (exact.trees, exact.nodes) == (plan.trees, plan.nodes)
    else:
        smem = ph._smem_budget(exact.trees * exact.nodes, nb, k)
        assert 2 * (smem + 1024) <= ph._SM_SHARED or exact.trees * exact.nodes == 1


def test_histogram_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared-memory"):
        ph.histogram_plan(100, 10, 1, 1, 256, 8)


@pytest.mark.parametrize("exact", [True, False])
def test_one_bin_holding_nearly_every_row(exact):
    """A zero-inflated column: 97% of rows in bin 0 and the rest spread
    over the upper bins, as TF-IDF bins are. The kernel keeps a run of one
    bin in registers; the plain version must still equal the JAX kernel
    (integer path) or its segment sum (f32), on uint8 bins."""
    rng = np.random.default_rng(21)
    n, f, nb, L, t = 700, 36, 32, 4, 2
    hot = rng.random((n, f)) < 0.03
    bins = np.where(hot, rng.integers(1, nb, (n, f)), 0).astype(np.int32)
    locals_ = rng.integers(0, L + 1, (t, n)).astype(np.int32)
    weights = rng.poisson(1.0, (t, n)).astype(np.float32)
    if exact:
        stats = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    else:
        stats = rng.normal(size=(n, 3)).astype(np.float32)
    got = ph.node_feature_bin_histogram_multi(
        torch.from_numpy(bins.astype(np.uint8)), torch.from_numpy(locals_),
        torch.from_numpy(weights), torch.from_numpy(stats), n_nodes=L,
        n_bins=nb, exact_int8=exact).numpy()
    if exact:
        want = np.asarray(jh.node_feature_bin_histogram_multi(
            jnp.asarray(bins), jnp.asarray(locals_), jnp.asarray(weights),
            jnp.asarray(stats), n_nodes=L, n_bins=nb, row_tile=64,
            feature_tile=16, interpret=True, exact_int8=True))
        np.testing.assert_array_equal(got, want)
        assert got[..., 0, :].sum() > 0.9 * got.sum()
        return
    for ti in range(t):
        want = np.asarray(jh.histogram_reference(
            jnp.asarray(bins), jnp.asarray(locals_[ti]),
            jnp.asarray(stats * weights[ti][:, None]), n_nodes=L, n_bins=nb))
        np.testing.assert_allclose(got[ti], want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("nb", [2, 32])
@pytest.mark.parametrize("criterion", ["gini", "xgb"])
def test_best_splits_one_node_ragged_slab(criterion, nb):
    """L = 1 (a root level), F = 45 (a full 32-feature slab and a ragged
    one), NB = 2 (one candidate per feature) and 32: the port equals the JAX
    kernel, and no feature tile changes its answer."""
    rng = np.random.default_rng(nb)
    f = 45
    if criterion == "gini":
        hist = rng.integers(0, 5, (1, f, nb, 2)).astype(np.float32)
    else:
        c = rng.integers(0, 3, (1, f, nb)).astype(np.float32)
        g = rng.normal(size=(1, f, nb)).astype(np.float32) * (c > 0)
        h = rng.uniform(0.0, 0.25, (1, f, nb)).astype(np.float32) * (c > 0)
        hist = np.stack([g, h, c], axis=-1)
    hist[0, 40] = hist[0, 6]              # a tie across the two slabs
    totals = hist[:, 0].sum(axis=1)
    jf, jb, jg = (np.asarray(a) for a in jh.best_splits(
        jnp.asarray(hist), jnp.asarray(totals), criterion=criterion,
        n_bins=nb, feature_tile=16, interpret=True))
    results = [ph.best_splits(torch.from_numpy(hist), torch.from_numpy(totals),
                              criterion=criterion, n_bins=nb, feature_tile=ft)
               for ft in (1024, 7, 1)]
    for pf, pb, pg in results:
        np.testing.assert_array_equal(pf.numpy(), jf)
        np.testing.assert_array_equal(pb.numpy(), jb)
        np.testing.assert_allclose(pg.numpy(), jg, rtol=1e-6)
        assert torch.equal(pg, results[0][2])
