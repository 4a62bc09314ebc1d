"""Word-association interpretability over hashed features — twin of
``fraud_detection_tpu/eval/word_associations.py`` (host-side numpy; the
models' tensors are read back once).

The reference's analysis (fraud_detection_spark.py:224-324) reads
``model.stages[2].vocabulary`` — possible only for CountVectorizer pipelines
and structurally impossible for the shipped HashingTF artifact, which has no
vocabulary (SURVEY.md Q11). The TPU-native answer: a **side vocabulary**
built in one corpus pass — hash bucket -> term counts — which inverts the
hashing trick for any bucket that matters, at the cost of one dict the size
of the observed vocabulary.

Feature importances come from two sources behind one function:
  * ``TreeEnsemble`` — true impurity-decrease importances computed by
    replaying the training data through each tree (Spark's
    ``featureImportances`` semantics: weighted gini decrease per split,
    summed per feature, normalized);
  * ``LogisticRegression`` — |coefficient| magnitude.

Per-term label statistics mirror the reference's ``array_contains``
aggregation (fraud_detection_spark.py:260-262): for each top bucket, the
number of scam/non-scam documents containing it, and the scam ratio.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

import torch

from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
from fraud_detection_tpu_torch.models.linear import LogisticRegression
from fraud_detection_tpu_torch.models.trees import TreeEnsemble


class SideVocabulary:
    """hash bucket -> Counter(term) built alongside featurization."""

    def __init__(self, featurizer: HashingTfIdfFeaturizer):
        self.featurizer = featurizer
        self.buckets: Dict[int, Counter] = {}

    def add_corpus(self, texts: Sequence[str]) -> "SideVocabulary":
        bucket = self.featurizer.bucket  # hashing: murmur3; vocab: index or -1
        for text in texts:
            for tok in self.featurizer.tokens(text):
                b = bucket(tok)
                if b >= 0:
                    self.buckets.setdefault(b, Counter())[tok] += 1
        return self

    def terms(self, bucket: int, k: int = 3) -> List[str]:
        """Most frequent terms observed in a bucket (collisions visible)."""
        c = self.buckets.get(int(bucket))
        return [t for t, _ in c.most_common(k)] if c else []

    def label(self, bucket: int) -> str:
        """Display label for a bucket: dominant term, or a placeholder."""
        ts = self.terms(bucket, 1)
        return ts[0] if ts else f"bucket#{int(bucket)}"

    def __len__(self) -> int:
        return len(self.buckets)


# ---------------------------------------------------------------------------
# feature importances
# ---------------------------------------------------------------------------

def _gini(counts: np.ndarray) -> np.ndarray:
    """Gini impurity per node from per-class counts (..., C)."""
    total = counts.sum(-1, keepdims=True)
    p = counts / np.maximum(total, 1e-12)
    return 1.0 - (p * p).sum(-1)


def tree_feature_importances(ensemble: TreeEnsemble, X: np.ndarray,
                             y: np.ndarray) -> np.ndarray:
    """Impurity-decrease importances for a native flat-array ensemble.

    Replays (X, y) through every tree: per internal node, the weighted gini
    decrease of its split is credited to its feature; per-tree importances
    are normalized then averaged (Spark RandomForest semantics).
    """
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int64)
    n_classes = max(2, int(y.max()) + 1)
    feature, threshold, left, right = (
        _host(getattr(ensemble, name))       # (T, M)
        for name in ("feature", "threshold", "left", "right"))
    T, M = feature.shape
    F = X.shape[1]
    out = np.zeros(F, np.float64)
    onehot = np.eye(n_classes, dtype=np.float64)[y]  # (N, C)

    for t in range(T):
        # route all rows down tree t, accumulating class counts per node
        node_counts = np.zeros((M, n_classes), np.float64)
        idx = np.zeros(len(X), np.int64)
        alive = np.ones(len(X), bool)
        for _ in range(ensemble.max_depth + 1):
            np.add.at(node_counts, idx[alive], onehot[alive])
            is_leaf = left[t][idx] < 0
            go_left = X[np.arange(len(X)), np.maximum(feature[t][idx], 0)] <= threshold[t][idx]
            nxt = np.where(go_left, left[t][idx], right[t][idx])
            alive = alive & ~is_leaf
            idx = np.where(alive, nxt, idx)
        imp = np.zeros(F, np.float64)
        for m in range(M):
            if left[t][m] < 0 or feature[t][m] < 0:
                continue
            n_node = node_counts[m].sum()
            if n_node == 0:
                continue
            nl, nr = node_counts[left[t][m]], node_counts[right[t][m]]
            decrease = (n_node * _gini(node_counts[m])
                        - nl.sum() * _gini(nl) - nr.sum() * _gini(nr))
            imp[feature[t][m]] += max(decrease, 0.0)
        s = imp.sum()
        if s > 0:
            out += imp / s
    s = out.sum()
    return (out / s if s > 0 else out).astype(np.float32)


def model_feature_importances(model, X: Optional[np.ndarray] = None,
                              y: Optional[np.ndarray] = None) -> np.ndarray:
    """Route to the right importance source for any supported model."""
    if isinstance(model, LogisticRegression):
        return np.abs(_host(model.weights).astype(np.float32))
    if isinstance(model, TreeEnsemble):
        if X is None or y is None:
            raise ValueError("tree importances need the training data (X, y)")
        return tree_feature_importances(model, X, y)
    raise TypeError(f"unsupported model type {type(model).__name__}")


# ---------------------------------------------------------------------------
# association analysis
# ---------------------------------------------------------------------------

@dataclass
class WordAssociation:
    bucket: int
    word: str            # dominant term for the bucket (side vocabulary)
    terms: List[str]     # top colliding terms
    importance: float
    scam_docs: int
    non_scam_docs: int

    @property
    def scam_ratio(self) -> float:
        total = self.scam_docs + self.non_scam_docs
        return self.scam_docs / total if total else 0.0


def analyze_word_associations(
    model,
    featurizer: HashingTfIdfFeaturizer,
    texts: Sequence[str],
    labels: Sequence[int],
    *,
    top_n: int = 20,
    vocab: Optional[SideVocabulary] = None,
    importances: Optional[np.ndarray] = None,
    device="cuda",
) -> List[WordAssociation]:
    """Top-N important features mapped back to words with per-label doc counts.

    Mirrors fraud_detection_spark.py:224-277 (importances -> top indices ->
    vocab lookup -> per-label occurrence counts -> scam ratio), with the side
    vocabulary standing in for CountVectorizer's vocabulary (Q11). Tree
    importances without ``importances`` featurize ``texts`` on ``device``.
    """
    labels_arr = np.asarray(labels, np.int64)
    if importances is None:
        X = (_dense(featurizer, texts, device)
             if isinstance(model, TreeEnsemble) else None)
        importances = model_feature_importances(model, X, labels_arr)
    if vocab is None:
        vocab = SideVocabulary(featurizer).add_corpus(texts)

    top = np.argsort(np.asarray(importances))[::-1][:top_n]
    # doc -> set of buckets, one host pass (-1 = out-of-vocabulary, dropped)
    doc_buckets = [
        {b for b in (featurizer.bucket(t) for t in featurizer.tokens(text)) if b >= 0}
        for text in texts]

    out: List[WordAssociation] = []
    for b in top:
        b = int(b)
        if float(importances[b]) <= 0.0:
            continue
        contains = np.fromiter((b in s for s in doc_buckets), bool, len(doc_buckets))
        scam = int((contains & (labels_arr == 1)).sum())
        ham = int((contains & (labels_arr == 0)).sum())
        out.append(WordAssociation(
            bucket=b, word=vocab.label(b), terms=vocab.terms(b),
            importance=float(importances[b]), scam_docs=scam, non_scam_docs=ham))
    return out


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _dense(featurizer: HashingTfIdfFeaturizer, texts: Sequence[str],
           device, chunk: int = 512) -> np.ndarray:
    rows = []
    for start in range(0, len(texts), chunk):
        part = list(texts[start : start + chunk])
        rows.append(_host(featurizer.featurize_dense(
            part, batch_size=chunk, device=device))[: len(part)])
    return np.concatenate(rows) if rows else np.empty((0, featurizer.num_features), np.float32)
