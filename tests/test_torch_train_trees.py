"""The port's tree trainers against the JAX package's kernel path
(``TreeTrainConfig(use_pallas=True)``: both Pallas kernels in interpret
mode) on the CPU.

* Decision trees: structure, thresholds and leaf stats equal (the port's
  fit on its uint8 bins, the JAX fit on int32 bins).
* Random forests: the port draws the JAX forest's bootstrap weights and
  feature masks (its threefry streams over its padded shapes, sliced to
  the real rows and features), and a forest fit end to end equals the JAX
  one tree for tree. The JAX draws fed to the port's chunk builder give
  the same forest too, which holds the builder apart from the draws.
* Gradient boosting on ``test_ops.py``'s separable data: p within rtol 1e-4,
  atol 1e-5 (f32 sums run in another order, so near-tie splits may differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fraud_detection_tpu.models import train_trees as jt
from fraud_detection_tpu.models import trees as jtrees
from fraud_detection_tpu_torch.models import train_trees as pt
from fraud_detection_tpu_torch.models import trees as ptrees
from tests import torch_parity  # noqa: F401 — one torch thread per worker

CPU = torch.device("cpu")
_TREE_FIELDS = ("feature", "threshold", "left", "right", "leaf")


def _assert_same_trees(jmodel, pmodel):
    for name in _TREE_FIELDS:
        np.testing.assert_array_equal(getattr(pmodel, name).numpy(),
                                      np.asarray(getattr(jmodel, name)),
                                      err_msg=name)
    assert pmodel.kind == jmodel.kind and pmodel.max_depth == jmodel.max_depth


def _xor_data(seed=3, n=400, f=24):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = ((X[:, 3] > 0.2) ^ (X[:, 10] < -0.1)).astype(np.float32)
    return X, y


def _tfidf_like(seed=5, n=300, f=200):
    """Zero-inflated non-negative columns, like a TF-IDF matrix."""
    rng = np.random.default_rng(seed)
    X = ((rng.random((n, f)) < 0.08)
         * rng.gamma(2.0, 1.0, (n, f))).astype(np.float32)
    y = ((X[:, :5].sum(1) + rng.normal(0, 0.3, n)) > 0.6).astype(np.float32)
    return X, y


@pytest.mark.parametrize("data,depth", [("xor", 4), ("tfidf", 5)])
def test_decision_tree_equals_jax_kernel_path(data, depth):
    X, y = _xor_data() if data == "xor" else _tfidf_like()
    want = jt.fit_decision_tree(
        X, y, config=jt.TreeTrainConfig(max_depth=depth, use_pallas=True))
    got = pt.fit_decision_tree(X, y, config=pt.TreeTrainConfig(max_depth=depth),
                               device="cpu")
    _assert_same_trees(want, got)


def _jax_chunk_draws(seed, start, chunk, n, f, depth):
    """The JAX forest's draws for one chunk (its PRNG stream over padded
    shapes), sliced to the real rows and features."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), start)
    wkey, mkey = jax.random.split(key)
    n_pad = -(-n // 256) * 256
    f_pad = -(-f // 128) * 128
    weights = np.asarray(jt._poisson1(wkey, (chunk, n_pad)))[:, :n]
    keys = jax.random.split(mkey, chunk * (depth + 1)).reshape(chunk, depth + 1, -1)
    masks = [torch.from_numpy(np.array(jt._feature_mask(
        keys[:, level], 2 ** level, f, f_pad))[:, :, :f])
        for level in range(depth)]
    return torch.from_numpy(weights.copy()), masks


@pytest.mark.parametrize("seed,depth", [(7, 4), (9, 5)])
def test_forest_chunk_with_jax_draws_equals_jax(seed, depth):
    X, y = _tfidf_like(seed=seed)
    chunk = 6
    want = jt.fit_random_forest(
        X, y, n_trees=chunk, seed=seed, tree_chunk=chunk,
        config=jt.TreeTrainConfig(max_depth=depth, use_pallas=True))
    cfg = pt.TreeTrainConfig(max_depth=depth)
    edges, bins, _, stats, _, n = pt._prepare_inputs(X, y, 2, cfg, None, CPU)
    assert bins.dtype == torch.uint8          # the trainer's bins, as on the card
    weights, masks = _jax_chunk_draws(seed, 0, chunk, n, X.shape[1], depth)
    out = pt._build_forest_chunk(bins, stats, weights, masks, cfg)
    got = pt._assemble(*out, edges=edges, tree_weights=np.ones(chunk),
                       kind="random_forest", cfg=cfg, device="cpu")
    _assert_same_trees(want, got)


@pytest.mark.parametrize("seed,depth", [(7, 4), (9, 5)])
def test_forest_draws_equal_jax_draws(seed, depth):
    n, f, chunk = 300, 200, 6
    for start in (0, chunk):
        want_w, want_m = _jax_chunk_draws(seed, start, chunk, n, f, depth)
        got_w, got_m = pt.draw_forest_chunk(seed, start, chunk, n, f, depth)
        assert torch.equal(got_w, want_w)
        # the histogram kernel takes contiguous weights and masks only
        assert got_w.is_contiguous() and all(m.is_contiguous() for m in got_m)
        assert len(got_m) == depth
        for level, (g, w) in enumerate(zip(got_m, want_m)):
            assert torch.equal(g, w), f"level {level}"
    # without feature subsets the weights stay the same stream
    weights, masks = pt.draw_forest_chunk(seed, chunk, chunk, n, f, depth,
                                          feature_subset=False)
    assert masks is None and torch.equal(weights, want_w)


@pytest.mark.parametrize("seed,depth", [(7, 4), (9, 5)])
def test_forest_equals_jax_kernel_path(seed, depth):
    """No draws fed: the port's forest (two chunks, the second ragged) is
    the JAX kernel path's, tree for tree."""
    X, y = _tfidf_like(seed=seed)
    kw = dict(n_trees=7, seed=seed, tree_chunk=4)
    want = jt.fit_random_forest(
        X, y, config=jt.TreeTrainConfig(max_depth=depth, use_pallas=True),
        **kw)
    got = pt.fit_random_forest(X, y, config=pt.TreeTrainConfig(max_depth=depth),
                               device="cpu", **kw)
    _assert_same_trees(want, got)


def test_gradient_boosting_matches_jax():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(300, 16)).astype(np.float32)
    y = (X[:, 1] + 0.5 * X[:, 7] > 0).astype(np.float32)
    want = jt.fit_gradient_boosting(
        X, y, n_rounds=5,
        config=jt.TreeTrainConfig(max_depth=3, criterion="xgb", use_pallas=True))
    got = pt.fit_gradient_boosting(
        X, y, n_rounds=5, config=pt.TreeTrainConfig(max_depth=3), device="cpu")
    assert got.kind == "xgboost" and got.bias == pytest.approx(want.bias)
    p_want = np.asarray(jtrees.predict(want, jnp.asarray(X))[1])
    p_got = ptrees.predict(got, torch.from_numpy(X))[1].numpy()
    np.testing.assert_allclose(p_got, p_want, rtol=1e-4, atol=1e-5)
    margin = ptrees.predict_margin(got, torch.from_numpy(X))
    np.testing.assert_allclose(torch.sigmoid(margin).numpy(), p_got,
                               rtol=1e-6, atol=1e-7)


def test_same_seed_same_forest_and_chunks_stand_alone():
    X, y = _tfidf_like(seed=2, n=200, f=60)
    kw = dict(seed=11, config=pt.TreeTrainConfig(max_depth=4), tree_chunk=4,
              device="cpu")
    a = pt.fit_random_forest(X, y, n_trees=10, **kw)
    b = pt.fit_random_forest(X, y, n_trees=10, **kw)
    for name in _TREE_FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name))
    # a chunk's draws depend on (seed, start) only: the first 8 trees of a
    # 10-tree forest are the 8-tree forest
    c = pt.fit_random_forest(X, y, n_trees=8, **kw)
    assert torch.equal(a.feature[:8], c.feature)
    other = pt.fit_random_forest(X, y, n_trees=10, **{**kw, "seed": 12})
    assert not torch.equal(a.feature, other.feature)


def test_binning_matches_jax():
    X, _ = _tfidf_like(seed=8, n=120, f=30)
    edges = pt.quantile_bin_edges(X, 32)
    np.testing.assert_array_equal(edges, jt.quantile_bin_edges(X, 32))
    got = pt.apply_bins(torch.from_numpy(X), torch.from_numpy(edges))
    want = np.asarray(jt.apply_bins(jnp.asarray(X), jnp.asarray(edges)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pt.bin_rows_host(X, edges),
                                  jt.bin_rows_host(X, edges))
    with pytest.raises(ValueError, match="finite"):
        pt.bin_rows_host(np.full((2, 30), np.nan, np.float32), edges)


def test_prebinned_input_builds_the_float_path_tree():
    X, y = _xor_data(seed=6, n=200, f=12)
    edges = pt.quantile_bin_edges(X, 32)
    a = pt.fit_decision_tree(X, y, device="cpu")
    b = pt.fit_decision_tree(pt.bin_rows_host(X, edges), y, edges=edges,
                             device="cpu")
    for name in _TREE_FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name))
    with pytest.raises(ValueError, match="edges"):
        pt.fit_decision_tree(pt.bin_rows_host(X, edges), y, device="cpu")
    with pytest.raises(ValueError, match="pre-binned"):
        pt.fit_decision_tree(np.full(X.shape, 40, np.int32), y, edges=edges,
                             device="cpu")


def test_builder_final_positions_are_the_row_leaves():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(150, 10)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    cfg = pt.TreeTrainConfig(max_depth=4, criterion="xgb")
    _, bins, yf, _, weights, _ = pt._prepare_inputs(X, y, 2, cfg, None, CPU)
    margin = torch.zeros(150)
    f_, b_, l_, r_, _, row_leaf = pt._boost_round(margin, bins, yf, weights, cfg)
    walked = pt._row_leaves(bins, f_, b_, l_, r_, cfg.max_depth)
    assert torch.equal(walked, row_leaf)
    want = np.asarray(jt._row_leaves(jnp.asarray(bins.numpy()),
                                     jnp.asarray(f_.numpy()),
                                     jnp.asarray(b_.numpy()),
                                     jnp.asarray(l_.numpy()),
                                     jnp.asarray(r_.numpy()), cfg.max_depth))
    np.testing.assert_array_equal(walked.numpy(), want)


def test_gini_gain_rounds_as_the_reference():
    """The forest's gain equals the JAX ``_gini_gain`` bit for bit (XLA's
    fused multiply-adds reproduced), ties and empty children included."""
    rng = np.random.default_rng(2)
    left = rng.integers(0, 60, size=(3, 200, 31, 2)).astype(np.float32)
    total = (left.max(axis=(1, 2), keepdims=True)
             + rng.integers(0, 40, size=(3, 1, 1, 2))).astype(np.float32)
    want = np.asarray(jax.jit(jt._gini_gain)(left, total))
    got = pt._gini_gain(torch.from_numpy(left), torch.from_numpy(total))
    np.testing.assert_array_equal(got.numpy(), want)


def test_level_helpers_match_jax():
    rng = np.random.default_rng(3)
    t, width, f, nb, k, n = 2, 4, 9, 8, 2, 50
    hist = rng.integers(0, 5, (t, width, f, nb, k)).astype(np.float32)
    totals = hist[:, :, 0].sum(axis=2)
    best_f = rng.integers(0, f, (t, width)).astype(np.int32)
    best_b = rng.integers(0, nb - 1, (t, width)).astype(np.int32)
    do_split = rng.random((t, width)) < 0.7
    want = np.asarray(jt._child_totals(*(jnp.asarray(a) for a in (
        hist, totals, best_f, best_b, do_split))))
    got = pt._child_totals(*(torch.from_numpy(a) for a in (
        hist, totals, best_f, best_b, do_split)))
    np.testing.assert_array_equal(got.numpy(), want)

    bins = rng.integers(0, nb, (n, f)).astype(np.int32)
    node = rng.integers(width - 1, 2 * width - 1, (t, n)).astype(np.int32)
    local = node - (width - 1)
    seg_valid = rng.random((t, n)) < 0.8
    jn, ja = jt._route_rows(*(jnp.asarray(a) for a in (
        bins, local, seg_valid, node, best_f, best_b, do_split)), width)
    pn, pa = pt._route_rows(*(torch.from_numpy(a) for a in (
        bins, local, seg_valid, node, best_f, best_b, do_split)), width)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))

    # node totals derived from feature 0's bins equal the reference's
    # scanned totals (rows at id ``width`` are inactive)
    stats = rng.normal(size=(n, 3)).astype(np.float32)
    seg = rng.integers(0, width + 1, n).astype(np.int32)
    hist = pt.node_feature_bin_histogram(torch.from_numpy(bins),
                                         torch.from_numpy(seg),
                                         torch.from_numpy(stats),
                                         n_nodes=width, n_bins=nb)
    np.testing.assert_allclose(
        pt._bin_sum(hist[:, 0]).numpy(),
        np.asarray(jt._node_totals(jnp.asarray(stats), jnp.asarray(seg),
                                   width)), rtol=1e-6, atol=1e-6)


def test_poisson_draw_and_chunk_rule():
    u = torch.tensor([0.0, 0.3, 0.5, 0.9, 0.999999])
    np.testing.assert_array_equal(pt._poisson1(u).numpy(), np.asarray(
        jnp.sum(jnp.asarray(u.numpy())[:, None]
                > jnp.asarray(jt._POISSON1_CDF), axis=-1)))
    assert pt.resolve_tree_chunk(pt.TreeTrainConfig()) == 8
    assert pt.resolve_tree_chunk(pt.TreeTrainConfig(max_depth=4)) == \
        jt.resolve_tree_chunk(jt.TreeTrainConfig(max_depth=4, use_pallas=True))


@pytest.mark.parametrize("n_bins,dtype", [(32, torch.uint8), (256, torch.uint8),
                                          (257, torch.int32)])
def test_fit_bins_are_uint8_up_to_256_bins(n_bins, dtype):
    """``_prepare_inputs`` casts the bins once to uint8 when every id fits
    (float and pre-binned input alike), else keeps int32; a forest chunk
    built on either width gives the same trees."""
    X, y = _tfidf_like(seed=4, n=150, f=40)
    cfg = pt.TreeTrainConfig(max_depth=3, n_bins=n_bins)
    edges, bins, _, stats, _, n = pt._prepare_inputs(X, y, 2, cfg, None, CPU)
    assert bins.dtype == dtype and bins.is_contiguous()
    pre = pt._prepare_inputs(bins.numpy().astype(np.int64), y, 2, cfg, edges,
                             CPU)[1]
    assert pre.dtype == dtype and torch.equal(pre, bins)
    weights, masks = pt.draw_forest_chunk(3, 0, 2, n, X.shape[1], cfg.max_depth)
    a = pt._build_forest_chunk(bins, stats, weights, masks, cfg)
    b = pt._build_forest_chunk(bins.to(torch.int32), stats, weights, masks, cfg)
    for x, z in zip(a, b):
        assert torch.equal(x, z)
