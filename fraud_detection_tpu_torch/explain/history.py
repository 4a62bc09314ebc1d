"""Historical-case similarity search — twin of
``fraud_detection_tpu/explain/history.py``.

L2-normalized TF-IDF rows of labelled past dialogues are held as one device
matrix (the classifier's own hashing featurizer, so any transcript length
collapses to the fixed feature width); a query is one matrix-vector product
and a top-k over the cosine similarities.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
from fraud_detection_tpu_torch.utils.device import resolve_device


def _top_k_cosine(matrix: torch.Tensor, query: torch.Tensor, k: int):
    """The k largest of ``matrix @ query`` and their row indices, equal
    values in ascending row order (``lax.top_k``'s rule; ``torch.topk``
    leaves the order of ties open, so this takes a stable sort)."""
    sims = matrix @ query
    vals, idx = torch.sort(sims, descending=True, stable=True)
    return vals[:k], idx[:k]


class HistoricalCaseStore:
    """In-memory corpus of labelled past dialogues with cosine top-k lookup
    on ``device``."""

    def __init__(self, featurizer: HashingTfIdfFeaturizer,
                 texts: Sequence[str], labels: Sequence[int],
                 batch_size: int = 256, device="cuda"):
        if len(texts) != len(labels):
            raise ValueError(f"{len(texts)} texts vs {len(labels)} labels")
        self.featurizer = featurizer
        self.device = resolve_device(device)
        self.texts: List[str] = list(texts)
        self.labels = np.asarray(labels, np.int32)
        chunks = []
        for start in range(0, len(self.texts), batch_size):
            chunk = self.texts[start:start + batch_size]
            chunks.append(featurizer.featurize_dense(
                chunk, batch_size=batch_size, device=self.device)[:len(chunk)])
        dense = (torch.cat(chunks) if chunks else torch.empty(
            (0, featurizer.num_features), device=self.device))
        norms = torch.linalg.vector_norm(dense, dim=1, keepdim=True)
        self._matrix = dense / torch.clamp_min(norms, 1e-12)

    def __len__(self) -> int:
        return len(self.texts)

    def find_similar(self, text: str, k: int = 3) -> List[Tuple[str, int, float]]:
        """Top-k most similar cases as (text, label, cosine similarity)."""
        k = min(k, len(self.texts))
        if k == 0:
            return []
        row = self.featurizer.featurize_dense([text], batch_size=1,
                                              device=self.device)[0]
        norm = float(torch.linalg.vector_norm(row))
        if norm == 0.0:  # no in-vocabulary tokens: nothing meaningful to rank
            return []
        sims, idx = _top_k_cosine(self._matrix, row / norm, k)
        return [(self.texts[i], int(self.labels[i]), float(s))
                for i, s in zip(idx.tolist(), sims.tolist())]
