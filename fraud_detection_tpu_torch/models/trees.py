"""Tree ensembles as flat tensors with vectorized traversal — twin of
``fraud_detection_tpu/models/trees.py`` (the encoded serving path).

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

import torch


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

    def to(self, device) -> "TreeEnsemble":
        return replace(self, feature=self.feature.to(device),
                       threshold=self.threshold.to(device),
                       left=self.left.to(device), right=self.right.to(device),
                       leaf=self.leaf.to(device),
                       tree_weights=self.tree_weights.to(device))


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
