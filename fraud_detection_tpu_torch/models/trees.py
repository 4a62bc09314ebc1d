"""Tree ensembles as flat tensors with vectorized traversal — twin of
``fraud_detection_tpu/models/trees.py`` (dense rows, the encoded serving
path, and the decoding of Spark tree stages).

Every ensemble is a struct of arrays

    feature   int32 (T, M)    split feature per node (-1 at leaves/padding)
    threshold f32   (T, M)    continuous split threshold ("go left if <=")
    left      int32 (T, M)    left-child index (-1 at leaves)
    right     int32 (T, M)
    leaf      f32   (T, M, C) leaf payload: class stats (classifiers, C>=2)
                              or scalar score (boosting, C=1)
    tree_weights f32 (T,)

and traversal is a fixed ``max_depth`` loop over all rows and trees at once
(staying put at leaves). Spark semantics: decision_tree / random_forest
normalize each tree's leaf stats and average with tree weights; gbt is
sigmoid(2 * margin), xgboost sigmoid(margin), margin = bias + sum of
weighted leaf scores.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import TYPE_CHECKING, Optional, Sequence, Tuple

import numpy as np
import torch

from fraud_detection_tpu_torch.utils.device import resolve_device

if TYPE_CHECKING:
    from fraud_detection_tpu_torch.checkpoint.spark_artifact import (
        TreeEnsembleStage, TreeNode)


@dataclass
class TreeEnsemble:
    feature: torch.Tensor        # (T, M) int32
    threshold: torch.Tensor      # (T, M) f32
    left: torch.Tensor           # (T, M) int32
    right: torch.Tensor          # (T, M) int32
    leaf: torch.Tensor           # (T, M, C) f32
    tree_weights: torch.Tensor   # (T,) f32
    kind: str = "decision_tree"
    max_depth: int = 8
    # Margin offset for boosted ensembles (XGBoost base_score in log-odds).
    bias: float = 0.0

    @property
    def num_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def num_outputs(self) -> int:
        return self.leaf.shape[-1]

    def to(self, device) -> "TreeEnsemble":
        return replace(self, feature=self.feature.to(device),
                       threshold=self.threshold.to(device),
                       left=self.left.to(device), right=self.right.to(device),
                       leaf=self.leaf.to(device),
                       tree_weights=self.tree_weights.to(device))


def from_spark_stage(stage: "TreeEnsembleStage",
                     max_depth: Optional[int] = None,
                     device="cuda") -> TreeEnsemble:
    """Decode a loaded Spark tree stage into the flat-array ensemble on
    ``device``.

    Spark stores nodes in preorder with explicit child ids; leaf payload for
    classifiers is the impurityStats class-count vector (normalized at
    predict time), for GBT regression trees the scalar prediction.
    """
    dev = resolve_device(device)
    trees = stage.trees
    m = max(len(t) for t in trees)
    num_classes = max(stage.num_classes, 2)
    is_gbt = stage.kind == "gbt"
    c = 1 if is_gbt else num_classes

    feature = np.full((len(trees), m), -1, np.int32)
    threshold = np.zeros((len(trees), m), np.float32)
    left = np.full((len(trees), m), -1, np.int32)
    right = np.full((len(trees), m), -1, np.int32)
    leaf = np.zeros((len(trees), m, c), np.float32)
    depth = 0

    for t, nodes in enumerate(trees):
        id_map = {n.id: i for i, n in enumerate(nodes)}
        for n in nodes:
            i = id_map[n.id]
            if n.left >= 0:
                feature[t, i] = n.split_feature
                threshold[t, i] = n.split_threshold
                left[t, i] = id_map[n.left]
                right[t, i] = id_map[n.right]
            if is_gbt:
                leaf[t, i, 0] = n.prediction
            elif n.impurity_stats.size:
                leaf[t, i, : n.impurity_stats.size] = n.impurity_stats
            else:  # stats absent: one-hot the predicted class
                leaf[t, i, int(n.prediction)] = 1.0
        depth = max(depth, _tree_depth(nodes, id_map))

    def put(a):
        return torch.from_numpy(a).to(dev)

    return TreeEnsemble(
        feature=put(feature), threshold=put(threshold), left=put(left),
        right=put(right), leaf=put(leaf),
        tree_weights=put(np.asarray(stage.tree_weights, np.float32)),
        kind=stage.kind,
        max_depth=max_depth if max_depth is not None else max(depth, 1),
    )


def _tree_depth(nodes: Sequence["TreeNode"], id_map) -> int:
    depth = {0: 0}
    out = 0
    for n in sorted(nodes, key=lambda n: n.id):
        i = id_map[n.id]
        d = depth.get(i, 0)
        out = max(out, d)
        if n.left >= 0:
            depth[id_map[n.left]] = d + 1
            depth[id_map[n.right]] = d + 1
    return out


def _leaf_indices(x: torch.Tensor, feature: torch.Tensor,
                  threshold: torch.Tensor, left: torch.Tensor,
                  right: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Dense rows (B, F) -> (B, T) leaf indices: ``max_depth`` steps of
    "go left if x[feature] <= threshold", staying put at leaves."""
    b = x.shape[0]
    t, m = feature.shape
    idx = torch.zeros((b, t), dtype=torch.int64, device=x.device)
    flat = (torch.arange(t, device=x.device) * m)[None, :]          # (1, T)
    feat_f, thr_f = feature.reshape(-1), threshold.reshape(-1)
    left_f, right_f = left.reshape(-1), right.reshape(-1)
    rows = torch.arange(b, device=x.device)[:, None]
    for _ in range(max_depth):
        node = flat + idx                                           # (B, T)
        f = torch.clamp(feat_f[node], min=0).to(torch.int64)        # leaves: -1
        l_child = left_f[node].to(torch.int64)
        nxt = torch.where(x[rows, f] <= thr_f[node], l_child,
                          right_f[node].to(torch.int64))
        idx = torch.where(l_child < 0, idx, nxt)
    return idx


def _leaf_indices_encoded(ids, counts, idf, feature, threshold, left, right,
                          max_depth: int) -> torch.Tensor:
    """Hashed sparse rows (B, L) -> (B, T) leaf indices WITHOUT densifying.

    The value of the current node's split feature is computed on demand
    from the row's term list: the sum of counts whose id equals the feature,
    THEN scaled by its IDF (counts are integers in f32, so the sum is exact
    in any order and the ``<= threshold`` test is bit-equal to the dense
    path). Padded term slots carry count 0."""
    b = ids.shape[0]
    t, m = feature.shape
    counts = counts.to(torch.float32)
    idx = torch.zeros((b, t), dtype=torch.int64, device=ids.device)
    flat = (torch.arange(t, device=ids.device) * m)[None, :]     # (1, T)
    feat_f, thr_f = feature.reshape(-1), threshold.reshape(-1)
    left_f, right_f = left.reshape(-1), right.reshape(-1)
    for _ in range(max_depth):
        node = flat + idx                                        # (B, T)
        f = torch.clamp(feat_f[node], min=0).to(torch.int64)     # leaves: -1
        hit = ids[:, None, :] == f[:, :, None]                   # (B, T, L)
        val = torch.sum(torch.where(hit, counts[:, None, :], 0.0),
                        dim=-1) * idf[f]
        l_child = left_f[node].to(torch.int64)
        nxt = torch.where(val <= thr_f[node], l_child,
                          right_f[node].to(torch.int64))
        idx = torch.where(l_child < 0, idx, nxt)
    return idx


def _proba_from_leaf_indices(ensemble: TreeEnsemble,
                             idx: torch.Tensor) -> torch.Tensor:
    """(B, T) leaf indices -> (B, C) class probabilities (Spark semantics)."""
    trees = torch.arange(ensemble.num_trees, device=idx.device)[None, :]
    payload = ensemble.leaf[trees, idx]                          # (B, T, C)

    if ensemble.kind in ("gbt", "xgboost"):
        margin = ensemble.bias + torch.sum(
            payload[..., 0] * ensemble.tree_weights[None, :], dim=1)
        # Spark GBT's logloss link is sigmoid(2*margin); XGBoost's sigmoid(margin).
        scale = 2.0 if ensemble.kind == "gbt" else 1.0
        p1 = torch.sigmoid(scale * margin)
        return torch.stack([1.0 - p1, p1], dim=-1)

    per_tree = payload / torch.clamp(payload.sum(-1, keepdim=True), min=1e-12)
    weighted = per_tree * ensemble.tree_weights[None, :, None]
    raw = weighted.sum(dim=1)
    return raw / torch.clamp(raw.sum(-1, keepdim=True), min=1e-12)


def predict_proba_encoded(ensemble: TreeEnsemble, ids, counts,
                          idf) -> torch.Tensor:
    """Hashed sparse rows -> (B, C) probabilities via the scatter-free
    traversal (the serving path)."""
    idx = _leaf_indices_encoded(ids, counts, idf, ensemble.feature,
                                ensemble.threshold, ensemble.left,
                                ensemble.right, ensemble.max_depth)
    return _proba_from_leaf_indices(ensemble, idx)


def predict_proba(ensemble: TreeEnsemble, x: torch.Tensor) -> torch.Tensor:
    """(B, F) dense features -> (B, C) class probabilities (Spark semantics)."""
    idx = _leaf_indices(x, ensemble.feature, ensemble.threshold,
                        ensemble.left, ensemble.right, ensemble.max_depth)
    return _proba_from_leaf_indices(ensemble, idx)


def predict(ensemble: TreeEnsemble,
            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (predicted class int32 (B,), probability of class 1 (B,))."""
    proba = predict_proba(ensemble, x)
    return torch.argmax(proba, dim=-1).to(torch.int32), proba[..., 1]


def predict_margin(ensemble: TreeEnsemble, x: torch.Tensor) -> torch.Tensor:
    """(B, F) dense features -> (B,) raw boosting margin (bias + weighted
    leaf sum) of a boosted ensemble; ``sigmoid(margin)`` (xgboost kind) is
    ``predict_proba(...)[:, 1]``."""
    if ensemble.kind not in ("gbt", "xgboost"):
        raise ValueError(
            f"predict_margin applies to boosted ensembles, not "
            f"{ensemble.kind!r} (classification forests carry class "
            "stats, not additive margins)")
    idx = _leaf_indices(x, ensemble.feature, ensemble.threshold,
                        ensemble.left, ensemble.right, ensemble.max_depth)
    trees = torch.arange(ensemble.num_trees, device=idx.device)[None, :]
    payload = ensemble.leaf[trees, idx][..., 0] * ensemble.tree_weights
    # Summed tree by tree in order, not by a reduction kernel, whose order
    # differs between the card and the CPU: the refresh's warm start must be
    # bit-equal on both, or a last-bit margin difference breaks the exact
    # split ties a window of near-identical rows is full of.
    acc = torch.zeros_like(payload[:, 0])
    for t in range(payload.shape[1]):
        acc = acc + payload[:, t]
    return ensemble.bias + acc


def feature_importances(ensemble_stage: "TreeEnsembleStage",
                        num_features: int) -> np.ndarray:
    """Spark-style gain-weighted feature importances (normalized to sum 1).

    Per tree, each internal node contributes gain * rawCount to its split
    feature; per-tree vectors are normalized, then averaged over trees and
    re-normalized (treeModel.featureImportances)."""
    total = np.zeros(num_features, np.float64)
    for nodes in ensemble_stage.trees:
        imp = np.zeros(num_features, np.float64)
        counts = {n.id: (n.impurity_stats.sum() if n.impurity_stats.size else 0.0)
                  for n in nodes}
        for n in nodes:
            if n.left >= 0 and n.split_feature >= 0 and n.gain > 0:
                imp[n.split_feature] += n.gain * max(counts.get(n.id, 0.0), 1.0)
        s = imp.sum()
        if s > 0:
            total += imp / s
    s = total.sum()
    return total / s if s > 0 else total
