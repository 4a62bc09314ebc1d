"""Histogram-based tree training — twin of
``fraud_detection_tpu/models/train_trees.py``.

One level-wise builder serves the reference's three tree trainers (Spark
DecisionTree, RandomForest and SparkXGBClassifier, depth 5):

  * Features are quantile-binned once (Spark's maxBins=32 discretization).
  * Trees grow level-wise in heap layout (node i -> children 2i+1, 2i+2) to
    a fixed depth. Per level: the (node, feature, bin) statistics histogram
    (``ops.histogram.node_feature_bin_histogram[_multi]``, a CUDA kernel on
    the card), the split choice, then every row descends by its node's
    split.
  * Criteria: weighted gini impurity decrease (DT, RF) and the second-order
    logloss gain G^2/(H+lambda) with leaf value -G/(H+lambda) (XGBoost).
  * Random forest: chunks of trees share one multi-tree histogram per level,
    over Poisson(1) bootstrap weights with per-node Bernoulli feature
    subsets (expected size sqrt(F)).
  * Boosting: one tree per round on (grad, hess, count) statistics.

**Which formulation runs.** This port always follows the JAX package's
kernel path (its ``TreeTrainConfig(use_pallas=True)``), on the CPU as on the
card, so a CPU fit and a card fit build the same trees; the config has no
``use_pallas`` field. Concretely: gini histograms take the exact integer
path; node totals are derived from the histogram (``carried``), for xgb
too; DT and GBT levels choose splits with ``ops.histogram.best_splits`` (a
CUDA kernel on the card); RF levels choose with ``_select_splits`` over the
feature masks, in ``_gini_gain``'s formulas. The device decides kernel or
plain version: a CUDA tensor launches the kernels, a CPU tensor runs their
plain torch versions. Every f32 sum of a fit runs in one fixed order on
both devices (the f32 histogram's plain version adds in the kernel's order,
node totals add bin by bin, the boosting sigmoid rounds once from f64), so
a card fit equals a CPU fit, boosting included.

**Random draws.** A forest draws what the JAX package draws, from JAX's
threefry streams (``utils/threefry.py``): chunk ``start``'s key is
``fold_in(PRNGKey(seed), start)``, split into a weight key and a mask key;
the Poisson(1) weights run over the rows padded to the reference's
256-row tile and are cut to N, and each level's Bernoulli feature masks
come from its own key of ``split(mask_key, T * (depth + 1))``. The draws
run on the fit's device with tensor ops, bit-equal on the CPU and on the
card, so a seed gives the JAX package's forest on either.

The contractions the JAX package runs at ``Precision.HIGHEST`` outside the
kernels (node and child totals, the bin prefix of ``_select_splits``) and
its bf16 one-hot column pull in ``_route_rows`` are exact gathers or plain
f32 elementwise sums here, not matrix products, so TF32 never enters and
no dense one-hot transient is built. Inputs need no tile padding (CUDA has
no lane tiling).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fraud_detection_tpu_torch import convert
from fraud_detection_tpu_torch.models.trees import TreeEnsemble
from fraud_detection_tpu_torch.ops.histogram import (
    best_splits, node_feature_bin_histogram, node_feature_bin_histogram_multi)
from fraud_detection_tpu_torch.utils import threefry
from fraud_detection_tpu_torch.utils.device import resolve_device

# ---------------------------------------------------------------------------
# Quantile binning
# ---------------------------------------------------------------------------


def quantile_bin_edges(X: np.ndarray, n_bins: int = 32) -> np.ndarray:
    """Per-feature quantile edges, (F, n_bins - 1), host-side numpy.

    Mirrors Spark's maxBins quantile discretization. Duplicate edges (heavy
    zero-inflation in TF-IDF columns) are fine: bins collapse and those split
    candidates simply tie."""
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    return np.quantile(np.asarray(X, np.float32), qs, axis=0).T.astype(np.float32)


def bin_rows_host(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Host-side twin of ``apply_bins`` returning int8 bin ids (bin =
    #(edges < x), as ``searchsorted(..., side="left")`` counts); training on
    these equals training on the floats, at a quarter of the upload bytes.
    n_bins <= 128 keeps int8 exact."""
    if edges.shape[1] > 127:
        raise ValueError(
            f"{edges.shape[1]} edges per feature exceeds int8 range "
            "(n_bins must be <= 128 for host binning)")
    if not np.isfinite(X).all():
        # searchsorted sorts NaN above every edge (top bin) while apply_bins
        # counts `edges < NaN` as 0 (bottom bin): refuse rather than let the
        # two equivalent paths train different models.
        raise ValueError("bin_rows_host requires finite input "
                         "(NaN/inf bin differently on host and device)")
    out = np.empty(X.shape, np.int8)
    for f in range(X.shape[1]):
        out[:, f] = np.searchsorted(edges[f], X[:, f], side="left")
    return out


def apply_bins(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(N, F) values -> (N, F) int32 bin ids; bin = #(edges < x), so
    ``x <= edges[b]  <=>  bin(x) <= b`` (serve-time ``x <= threshold``
    traversal agrees with train-time binning). An elementwise
    compare-accumulate over the (<= 31) edge columns."""
    bins = torch.zeros(X.shape, dtype=torch.int32, device=X.device)
    for j in range(edges.shape[1]):
        bins += (X > edges[None, :, j]).to(torch.int32)
    return bins


# ---------------------------------------------------------------------------
# Split criteria over (left, right) stat blocks (the RF selection)
# ---------------------------------------------------------------------------

def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 fused multiply-add a*b + c with one rounding: the product is
    exact in f64, the sum rounds once to f64 and then to f32."""
    return (a.double() * b.double() + c.double()).float()


def _gini_impurity(stats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """stats (..., K) class counts -> (impurity, total count). The sum of
    squared proportions accumulates as XLA's CPU backend contracts it
    (p0*p0, then one fused multiply-add per further class), the reference's
    rounding."""
    n = stats.sum(-1)
    p = stats / torch.clamp(n[..., None], min=1e-12)
    sq = p[..., 0] * p[..., 0]
    for kk in range(1, p.shape[-1]):
        sq = _fma(p[..., kk], p[..., kk], sq)
    return 1.0 - sq, n


def _gini_gain(left: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """Weighted impurity decrease for every (node, feature, bin) candidate.

    left: (..., B, K) cumulative class counts for rows with bin <= b;
    total broadcastable to it. Returns (..., B) gain; empty-child candidates
    -inf. ``n_l*gi_l + n_r*gi_r`` is one fused multiply-add, as the
    reference computes it."""
    right = total - left
    gi_p, n_p = _gini_impurity(total)
    gi_l, n_l = _gini_impurity(left)
    gi_r, n_r = _gini_impurity(right)
    n_safe = torch.clamp(n_p, min=1e-12)
    gain = gi_p - _fma(n_l, gi_l, n_r * gi_r) / n_safe
    valid = (n_l > 0) & (n_r > 0)
    return torch.where(valid, gain, torch.full_like(gain, float("-inf")))


def _xgb_gain(left: torch.Tensor, total: torch.Tensor, lam: float,
              min_child_weight: float) -> torch.Tensor:
    """Second-order gain: stats K=3 are (grad, hess, count)."""
    right = total - left
    gl, hl = left[..., 0], left[..., 1]
    gr, hr = right[..., 0], right[..., 1]
    gp, hp = total[..., 0], total[..., 1]

    def score(g, h):
        return (g * g) / (h + lam)

    gain = 0.5 * (score(gl, hl) + score(gr, hr) - score(gp, hp))
    valid = ((hl >= min_child_weight) & (hr >= min_child_weight)
             & (left[..., 2] > 0) & (right[..., 2] > 0))
    return torch.where(valid, gain, torch.full_like(gain, float("-inf")))


def _feature_mask(keys: torch.Tensor, width: int, f: int) -> torch.Tensor:
    """Per-node Bernoulli feature subsets (expected size sqrt(F)) for a
    chunk of T trees, each tree from its own key ``keys`` (T, 2): (T, width,
    f) bool, the reference's ``_feature_mask`` over the true feature count.
    A node that drew an empty subset (probability ~(1-p)^F) considers all
    features."""
    p_keep = np.sqrt(np.float32(f)) / np.float32(f)     # rounded in float32
    mask = threefry.bernoulli(keys, p_keep, (width, f))
    empty = ~mask.any(dim=2)
    return mask | empty[:, :, None]


def _bin_sum(hist_f: torch.Tensor) -> torch.Tensor:
    """(..., NB, K) -> (..., K): the sum over bins, one bin at a time, so it
    rounds alike on every device (a reduction kernel's order differs between
    the CPU and the card)."""
    acc = hist_f[..., 0, :]
    for b in range(1, hist_f.shape[-2]):
        acc = acc + hist_f[..., b, :]
    return acc


def _child_totals(hist: torch.Tensor, totals: torch.Tensor,
                  best_f: torch.Tensor, best_b: torch.Tensor,
                  do_split: torch.Tensor) -> torch.Tensor:
    """Next level's per-node totals from this level's histogram: the left
    child's stats are the parent's chosen feature's bins summed up to the
    chosen bin (in bin order, as ``best_splits`` forms its left side), the
    right child's the complement; children of parents that did not split get
    zeros. Heap order interleaves (left, right) per parent.

    hist (T, L, F, NB, K); totals (T, L, K); best_f/best_b/do_split (T, L)
    -> (T, 2L, K)."""
    t, width, _, nb, k = hist.shape
    idx_f = best_f.long()[:, :, None, None, None].expand(t, width, 1, nb, k)
    hist_f = torch.gather(hist, 2, idx_f)[:, :, 0]                  # (T,L,NB,K)
    left = torch.zeros_like(hist_f[:, :, 0])
    for b in range(nb):
        left = left + torch.where((b <= best_b)[:, :, None], hist_f[:, :, b],
                                  torch.zeros_like(left))
    right = totals - left
    pair = torch.stack([left, right], dim=2) * do_split[:, :, None, None]
    return pair.reshape(t, 2 * width, k)


def _select_splits(hist: torch.Tensor, totals: torch.Tensor,
                   mask: Optional[torch.Tensor], cfg: "TreeTrainConfig"):
    """Split selection for one level over a leading tree axis (the forest
    path). hist (T, L, F, NB, K); totals (T, L, K); mask (T, L, F) bool or
    None. Returns (best_f, best_b, best_gain), each (T, L): flat
    first-occurrence argmax over (F, NB-1) per node.

    Gains are computed only for the candidates that can win (inside the
    feature subset, both children non-empty, and for xgb above
    ``min_child_weight``); each is the same elementwise arithmetic as over
    the full grid, and every other candidate is -inf either way."""
    nb = cfg.n_bins
    cum = torch.cumsum(hist, dim=3)[:, :, :, : nb - 1]     # last bin: no right side
    total_b = totals[:, :, None, None, :].expand_as(cum)
    right = total_b - cum
    if cfg.criterion == "gini":
        live = (cum.sum(-1) > 0) & (right.sum(-1) > 0)
    else:
        live = ((cum[..., 1] >= cfg.min_child_weight)
                & (right[..., 1] >= cfg.min_child_weight)
                & (cum[..., 2] > 0) & (right[..., 2] > 0))
    if mask is not None:
        live &= mask[..., None]
    gain = torch.full(live.shape, float("-inf"), dtype=hist.dtype,
                      device=hist.device)
    if cfg.criterion == "gini":
        gain[live] = _gini_gain(cum[live], total_b[live])
    else:
        gain[live] = _xgb_gain(cum[live], total_b[live], cfg.reg_lambda,
                               cfg.min_child_weight)
    t, width = gain.shape[:2]
    flat = gain.reshape(t, width, -1)
    best = torch.argmax(flat, dim=2)
    best_gain = torch.gather(flat, 2, best[:, :, None])[:, :, 0]
    return ((best // (nb - 1)).to(torch.int32),
            (best % (nb - 1)).to(torch.int32), best_gain)


def _route_rows(bins: torch.Tensor, local: torch.Tensor,
                seg_valid: torch.Tensor, node: torch.Tensor,
                best_f: torch.Tensor, best_b: torch.Tensor,
                do_split: torch.Tensor, width: int):
    """Row re-routing for one level over a leading tree axis: each row reads
    its node's split (exact gathers), compares its bin id, descends. Rows
    whose node became a leaf stop descending and drop out of deeper
    histograms. local/seg_valid/node (T, N); best_f/best_b/do_split (T, L).
    Returns (node, active), each (T, N)."""
    n, f = bins.shape
    row_local = torch.clamp(local, 0, width - 1).long()
    row_b = torch.gather(best_b, 1, row_local)
    row_split = torch.gather(do_split, 1, row_local)
    row_f = torch.gather(best_f, 1, row_local).long()
    rows = torch.arange(n, device=bins.device, dtype=torch.int64) * f
    row_bin = bins.reshape(-1)[rows[None, :] + row_f]                # (T, N)
    go_left = row_bin <= row_b
    new_node = torch.where(go_left, 2 * node + 1, 2 * node + 2)
    moved = seg_valid & row_split
    return torch.where(moved, new_node, node), moved


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TreeTrainConfig:
    """Tree trainer settings (the JAX config without ``use_pallas``: the
    port always runs the kernel formulation, see the module docstring)."""

    max_depth: int = 5            # Spark maxDepth=5 (fraud_detection_spark.py:62,72,81)
    n_bins: int = 32              # Spark default maxBins
    min_info_gain: float = 0.0
    criterion: str = "gini"       # "gini" | "xgb"
    reg_lambda: float = 1.0       # xgb: L2 on leaf values and split gain
    min_child_weight: float = 1e-6
    learning_rate: float = 0.3    # xgb: leaf-value shrinkage (eta)


def _empty_tree_arrays(t: int, m: int, k: int, dev):
    return (torch.full((t, m), -1, dtype=torch.int32, device=dev),
            torch.zeros((t, m), dtype=torch.int32, device=dev),
            torch.full((t, m), -1, dtype=torch.int32, device=dev),
            torch.full((t, m), -1, dtype=torch.int32, device=dev),
            torch.zeros((t, m, k), dtype=torch.float32, device=dev))


def _record_level(arrays, offset: int, width: int, best_f, best_b, do_split):
    feature, split_bin, left, right, _ = arrays
    pos = offset + torch.arange(width, device=best_f.device, dtype=torch.int32)
    sl = slice(offset, offset + width)
    feature[:, sl] = torch.where(do_split, best_f, -1)
    split_bin[:, sl] = best_b
    left[:, sl] = torch.where(do_split, 2 * pos + 1, -1)
    right[:, sl] = torch.where(do_split, 2 * pos + 2, -1)


def _build_tree(bins: torch.Tensor, stats: torch.Tensor,
                row_weights: torch.Tensor, cfg: TreeTrainConfig):
    """Grow one tree with the histogram and split-gain kernels (DT and each
    boosting round).

    bins (N, F) uint8 or int32; stats (N, K) per-row statistics (class
    one-hots for gini, grad/hess/count for xgb); row_weights (N,) activity
    weights, multiplied into the stats. Gini statistics take the exact integer
    histogram. Node totals are derived, never scanned: level 0's from
    feature 0's bins, deeper levels' and the leaves' from the parent's bins
    at its chosen split (``_child_totals``). The JAX kernel path derives
    them so for gini; deriving them for xgb too keeps every f32 sum of a
    fit in one fixed order, so the card and the CPU build the same trees.

    Returns flat (M,) feature / split bin / left / right, (M, K) node stats,
    and each row's final heap position (N,)."""
    n = bins.shape[0]
    k = stats.shape[-1]
    nb, depth = cfg.n_bins, cfg.max_depth
    dev = bins.device
    arrays = _empty_tree_arrays(1, 2 ** (depth + 1) - 1, k, dev)
    node_stats = arrays[4]

    stats = stats * row_weights[:, None]
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    active = row_weights > 0
    exact = cfg.criterion == "gini"
    carried = None      # this level's totals, derived at l-1

    for level in range(depth + 1):
        offset, width = 2 ** level - 1, 2 ** level
        if level == depth and carried is not None:
            node_stats[0, offset : offset + width] = carried
            break
        local = node - offset
        seg_valid = active & (local >= 0) & (local < width)
        seg_node = torch.where(seg_valid, local, width).to(torch.int32)
        hist = node_feature_bin_histogram(
            bins, seg_node.contiguous(), stats, n_nodes=width, n_bins=nb,
            exact_int8=exact)                                   # (L, F, NB, K)
        totals = _bin_sum(hist[:, 0]) if carried is None else carried
        node_stats[0, offset : offset + width] = totals
        if level == depth:
            break

        best_f, best_b, best_gain = best_splits(
            hist, totals.contiguous(), criterion=cfg.criterion, n_bins=nb,
            reg_lambda=cfg.reg_lambda, min_child_weight=cfg.min_child_weight)
        do_split = best_gain > cfg.min_info_gain
        _record_level(arrays, offset, width, best_f[None], best_b[None],
                      do_split[None])
        carried = _child_totals(hist[None], totals[None], best_f[None],
                                best_b[None], do_split[None])[0]
        node1, active1 = _route_rows(
            bins, local[None], seg_valid[None], node[None], best_f[None],
            best_b[None], do_split[None], width)
        node, active = node1[0], active1[0]

    # ``node`` is each active row's final leaf position (weight-0 rows stay
    # at the root): the boosting round reuses it instead of re-traversing.
    return tuple(a[0] for a in arrays) + (node,)


def _build_forest_chunk(bins: torch.Tensor, stats: torch.Tensor,
                        row_weights: torch.Tensor,
                        masks: Optional[Sequence[torch.Tensor]],
                        cfg: TreeTrainConfig):
    """A chunk of T independent trees built together: every per-row and
    per-node array carries a leading tree axis, and each level's histogram
    is ONE ``node_feature_bin_histogram_multi`` call for the whole chunk
    (the exact integer path for gini: one-hot class stats x Poisson
    weights). Totals are derived as in ``_build_tree``.

    row_weights (T, N) bootstrap weights; masks[level] (T, 2**level, F) bool
    feature subsets, or None for all features. Returns (T, M) feature /
    split bin / left / right and (T, M, K) node stats."""
    t, n = row_weights.shape
    k = stats.shape[-1]
    nb, depth = cfg.n_bins, cfg.max_depth
    dev = bins.device
    arrays = _empty_tree_arrays(t, 2 ** (depth + 1) - 1, k, dev)
    node_stats = arrays[4]

    node = torch.zeros((t, n), dtype=torch.int64, device=dev)
    active = row_weights > 0
    exact = cfg.criterion == "gini"
    carried = None
    for level in range(depth + 1):
        offset, width = 2 ** level - 1, 2 ** level
        if level == depth and carried is not None:
            node_stats[:, offset : offset + width] = carried
            break
        local = node - offset                                    # (T, N)
        seg_valid = active & (local >= 0) & (local < width)
        locals_masked = torch.where(seg_valid, local, width).to(torch.int32)
        hist = node_feature_bin_histogram_multi(
            bins, locals_masked.contiguous(), row_weights, stats,
            n_nodes=width, n_bins=nb, exact_int8=exact)
        totals = _bin_sum(hist[:, :, 0]) if carried is None else carried
        node_stats[:, offset : offset + width] = totals
        if level == depth:
            break

        mask = None if masks is None else masks[level]
        best_f, best_b, best_gain = _select_splits(hist, totals, mask, cfg)
        do_split = best_gain > cfg.min_info_gain
        _record_level(arrays, offset, width, best_f, best_b, do_split)
        carried = _child_totals(hist, totals, best_f, best_b, do_split)
        node, active = _route_rows(bins, local, seg_valid, node, best_f,
                                   best_b, do_split, width)
    return arrays


# Poisson(1) inverse CDF, support 0..12: P(k > 12) ~ 6e-11 is below f32
# uniform resolution, so counting CDF entries below u IS the Poisson(1)
# quantile at the precision of the draw.
_POISSON1_CDF = np.cumsum(
    [math.exp(-1.0) / math.factorial(k) for k in range(13)]).astype(np.float32)


def _poisson1(u: torch.Tensor) -> torch.Tensor:
    """Poisson(1) bootstrap weights from uniforms ``u`` by inverse-CDF
    lookup (max weight 12, well inside the exact histogram's [0, 127])."""
    cdf = torch.from_numpy(_POISSON1_CDF).to(u.device)
    return (u[..., None] > cdf).sum(dim=-1).to(torch.float32)


#: The reference pads a fit's rows to its histogram's row tile before the
#: bootstrap draw (``fraud_detection_tpu/ops/histogram.py`` ``ROW_TILE``), so
#: the weight stream runs over that many rows.
_BOOTSTRAP_ROW_TILE = 256


def draw_forest_chunk(seed: int, start: int, tree_chunk: int, n: int, f: int,
                      max_depth: int, feature_subset: bool = True,
                      device="cpu"):
    """Bootstrap weights (T, N) f32 and per-level feature masks
    [(T, 2**level, F) bool for level < max_depth] (or None) of the chunk
    that starts at tree ``start``: the JAX package's draws for it, made on
    ``device``."""
    key = threefry.fold_in(threefry.prng_key(seed, device), start)
    wkey, mkey = threefry.split(key)
    n_padded = -(-n // _BOOTSTRAP_ROW_TILE) * _BOOTSTRAP_ROW_TILE
    weights = _poisson1(threefry.uniform(wkey, (tree_chunk, n_padded)))
    weights = weights[:, :n].contiguous()      # the histogram kernel's layout
    if not feature_subset:
        return weights, None
    keys = threefry.split(mkey, tree_chunk * (max_depth + 1)).reshape(
        tree_chunk, max_depth + 1, 2)
    masks = [_feature_mask(keys[:, level], 2 ** level, f)
             for level in range(max_depth)]
    return weights, masks


def _edges_to_thresholds(edges: np.ndarray, feature: np.ndarray,
                         split_bin: np.ndarray) -> np.ndarray:
    """Map (feature, bin) splits to serve-time thresholds: edges[f][b]."""
    thr = np.zeros(feature.shape, np.float32)
    valid = feature >= 0
    thr[valid] = edges[feature[valid], split_bin[valid]]
    return thr


# ---------------------------------------------------------------------------
# Public trainers
# ---------------------------------------------------------------------------

def resolve_tree_chunk(cfg: TreeTrainConfig, num_classes: int = 2) -> int:
    """Default trees per forest chunk: the JAX kernel path's rule (chunk x
    classes x 2**depth <= 512), 8 for two classes at depth 5. The chunk
    size shapes the bootstrap draw, so it is part of a forest's identity."""
    return max(1, 512 // (num_classes * 2 ** cfg.max_depth))


def _prepare_inputs(X, y, num_classes: int, cfg: TreeTrainConfig,
                    edges: Optional[np.ndarray], dev: torch.device):
    """Shared prep: binning, per-row class stats, activity weights.

    ``X`` is float features (numpy, or a tensor) binned here on ``dev``, or
    integer bin ids from ``bin_rows_host`` (numpy or tensor), which require
    the matching ``edges``. The bins are cast once to uint8 when
    ``n_bins <= 256`` (the histogram kernel reads a quarter of the bytes),
    else kept int32. Returns (edges, bins (N, F), y f32, class one-hot stats
    (N, C) f32, weights (N,) ones, N)."""
    if not hasattr(X, "shape"):
        X = np.asarray(X, np.float32)
    is_tensor = isinstance(X, torch.Tensor)
    prebinned = (not X.dtype.is_floating_point if is_tensor
                 else np.issubdtype(np.dtype(X.dtype), np.integer))
    if prebinned and edges is None:
        raise ValueError(
            "integer X means pre-binned input (bin_rows_host), which requires "
            "the matching edges= — thresholds cannot be recovered from bins")
    n = X.shape[0]
    if edges is None:
        X = X.cpu().numpy() if is_tensor else X
        X = np.asarray(X, np.float32)
        is_tensor = False
        edges = quantile_bin_edges(X, cfg.n_bins)
    edges = np.asarray(edges, np.float32)
    xd = X if is_tensor else torch.from_numpy(np.ascontiguousarray(X))
    xd = xd.to(dev)
    if prebinned:
        lo, hi = (int(v) for v in torch.stack([xd.min(), xd.max()]).tolist())
        if lo < 0 or hi >= cfg.n_bins:
            raise ValueError(
                f"pre-binned X has ids in [{lo}, {hi}] but n_bins={cfg.n_bins}; "
                "integer X must contain bin_rows_host output, not raw features")
        bins = xd
    else:
        bins = apply_bins(xd.to(torch.float32),
                          torch.from_numpy(edges).to(dev))
    bins = bins.to(torch.uint8 if cfg.n_bins <= 256 else torch.int32)
    yd = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
    stats = (yd.to(torch.int64)[:, None] == torch.arange(
        num_classes, device=dev)[None, :]).to(torch.float32)
    weights = torch.ones((n,), dtype=torch.float32, device=dev)
    return edges, bins.contiguous(), yd, stats, weights, n


def fit_decision_tree(X, y, *, num_classes: int = 2,
                      config: Optional[TreeTrainConfig] = None,
                      edges: Optional[np.ndarray] = None,
                      device="cuda") -> TreeEnsemble:
    """Gini decision tree (Spark DecisionTreeClassifier semantics, maxBins
    binning), trained on ``device``."""
    dev = resolve_device(device)
    cfg = config or TreeTrainConfig()
    edges, bins, _, stats, weights, _ = _prepare_inputs(
        X, y, num_classes, cfg, edges, dev)
    out = _build_tree(bins, stats, weights, cfg)[:5]
    return _assemble(*(a[None] for a in out), edges=edges,
                     tree_weights=np.ones(1), kind="decision_tree", cfg=cfg,
                     device=dev)


def fit_random_forest(X, y, *, n_trees: int = 100, num_classes: int = 2,
                      seed: int = 42, config: Optional[TreeTrainConfig] = None,
                      tree_chunk: Optional[int] = None,
                      feature_subset: bool = True,
                      edges: Optional[np.ndarray] = None,
                      device="cuda") -> TreeEnsemble:
    """Random forest: Poisson(1) bootstrap + per-node Bernoulli feature
    subsets (expected size sqrt(F); Spark's "auto" -> sqrt draws an exact
    subset — the JAX package's documented deviation, kept).

    Trees are built ``tree_chunk`` at a time (default
    ``resolve_tree_chunk``); each chunk draws the JAX package's bootstrap
    weights and masks for (seed, chunk start). A ragged last chunk is drawn
    and built in full and its extra trees dropped, so a forest's first
    trees do not depend on ``n_trees``."""
    dev = resolve_device(device)
    cfg = config or TreeTrainConfig()
    if tree_chunk is None:
        tree_chunk = resolve_tree_chunk(cfg, num_classes)
    edges, bins, _, stats, _, n = _prepare_inputs(
        X, y, num_classes, cfg, edges, dev)
    f = bins.shape[1]
    parts: List[Tuple[torch.Tensor, ...]] = []
    for start in range(0, n_trees, tree_chunk):
        need = min(tree_chunk, n_trees - start)
        weights, masks = draw_forest_chunk(seed, start, tree_chunk, n, f,
                                           cfg.max_depth, feature_subset, dev)
        out = _build_forest_chunk(bins, stats, weights, masks, cfg)
        parts.append(tuple(a[:need] for a in out))
    cat = [torch.cat(p, dim=0) for p in zip(*parts)]
    return _assemble(*cat, edges=edges, tree_weights=np.ones(n_trees),
                     kind="random_forest", cfg=cfg, device=dev)


def fit_gradient_boosting(X, y, *, n_rounds: int = 100,
                          config: Optional[TreeTrainConfig] = None,
                          edges: Optional[np.ndarray] = None,
                          base_score: Optional[float] = None,
                          device="cuda") -> TreeEnsemble:
    """XGBoost-style second-order boosting (binary logloss): each round fits
    a regression tree on (grad, hess, count) histograms; learning rate and
    lambda live on the config (0.3 and 1.0, XGBoost's defaults)."""
    dev = resolve_device(device)
    cfg = config or TreeTrainConfig(criterion="xgb")
    if cfg.criterion != "xgb":
        cfg = replace(cfg, criterion="xgb")
    if base_score is None:
        # Class-prior log-odds: keeps margins calibrated for rows that match
        # few features instead of defaulting to 0.
        prior = float(np.clip(np.mean(np.asarray(y, np.float64)), 1e-6, 1 - 1e-6))
        base_score = float(np.log(prior / (1.0 - prior)))
    edges, bins, yf, _, weights, n = _prepare_inputs(X, y, 2, cfg, edges, dev)
    margin = torch.full((n,), base_score, dtype=torch.float32, device=dev)
    rounds = []
    for _ in range(n_rounds):
        f_, b_, l_, r_, values, row_leaf = _boost_round(margin, bins, yf,
                                                        weights, cfg)
        margin = _update_margin(margin, row_leaf, values)
        rounds.append((f_, b_, l_, r_, values[:, None]))
    cat = [torch.stack(p) for p in zip(*rounds)]
    return _assemble(*cat, edges=edges, tree_weights=np.ones(n_rounds),
                     kind="xgboost", cfg=cfg, bias=base_score, device=dev)


def _update_margin(margin: torch.Tensor, row_node: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    return margin + values[row_node]


def _boost_round(margin, bins, yf, weights, cfg: TreeTrainConfig):
    """One boosting round: gradients, tree build, leaf values. The builder's
    final routing state is each row's leaf position."""
    # sigmoid in f64, rounded once: the card's and the CPU's f32 sigmoids
    # differ in the last bit, which would seed diverging trees
    p = torch.sigmoid(margin.double()).float()
    g, h = p - yf, p * (1.0 - p)
    stats = torch.stack([g, h, torch.ones_like(g)], dim=1)
    f_, b_, l_, r_, s_, row_leaf = _build_tree(bins, stats, weights, cfg)
    values = -s_[:, 0] / (s_[:, 1] + cfg.reg_lambda) * cfg.learning_rate
    return f_, b_, l_, r_, values, row_leaf


def _row_leaves(bins: torch.Tensor, feature: torch.Tensor,
                split_bin: torch.Tensor, left: torch.Tensor,
                right: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Leaf heap position per row, in bin space (train-time traversal)."""
    n, f = bins.shape
    node = torch.zeros((n,), dtype=torch.int64, device=bins.device)
    rows = torch.arange(n, device=bins.device, dtype=torch.int64) * f
    for _ in range(max_depth):
        feat = torch.clamp(feature[node], min=0).long()
        row_bin = bins.reshape(-1)[rows + feat]
        nxt = torch.where(row_bin <= split_bin[node], left[node],
                          right[node]).long()
        node = torch.where(left[node] < 0, node, nxt)
    return node


def _assemble(feature, split_bin, left, right, payload, *, edges, tree_weights,
              kind: str, cfg: TreeTrainConfig, bias: float = 0.0,
              device="cuda") -> TreeEnsemble:
    """Per-tree (T, M) arrays (one device->host copy) -> a TreeEnsemble on
    ``device`` with real thresholds edges[f][b]."""
    feature, split_bin, left, right, payload = (
        a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        for a in (feature, split_bin, left, right, payload))
    thresholds = np.stack([_edges_to_thresholds(edges, f, b)
                           for f, b in zip(feature, split_bin)])
    return convert.trees_from_arrays(
        feature, thresholds, left, right, payload,
        np.asarray(tree_weights, np.float32), kind=kind,
        max_depth=cfg.max_depth, bias=bias, device=device)
