"""Logistic-regression scorer — twin of ``fraud_detection_tpu/models/linear.py``
(the packed sparse serving entries and the dense scoring of the trainers).

For hashed-TF rows the margin is a gather + row sum over the padded term
slots; features are never materialized. ``idf * w`` is folded into one
effective weight vector at model-build time (``fold_idf``), so serve-time
work per term is a single gather-multiply-accumulate.

Spark semantics: probability = sigmoid(margin), prediction = 1 iff
p > threshold.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import torch

from fraud_detection_tpu_torch.utils.device import resolve_device


@dataclass
class LogisticRegression:
    """Binary logistic regression parameters as tensors. ``weights`` are in
    *feature* space (post-IDF); ``fold_idf`` makes the raw-count twin."""

    weights: torch.Tensor        # (F,) float32
    intercept: torch.Tensor      # () float32
    threshold: float = 0.5

    @classmethod
    def from_arrays(cls, weights, intercept, threshold: float = 0.5,
                    device="cuda") -> "LogisticRegression":
        dev = resolve_device(device)
        return cls(
            weights=torch.from_numpy(np.asarray(weights, np.float32).copy()).to(dev),
            intercept=torch.tensor(np.float32(intercept), device=dev),
            threshold=float(threshold),
        )

    def to(self, device) -> "LogisticRegression":
        return replace(self, weights=self.weights.to(device),
                       intercept=self.intercept.to(device))

    def fold_idf(self, idf: torch.Tensor) -> "LogisticRegression":
        """Fold an IDF vector into the weights (for raw term-count inputs)."""
        return replace(self, weights=self.weights * idf.to(self.weights))


def margin_dense(model: LogisticRegression, x: torch.Tensor) -> torch.Tensor:
    """(B, F) dense features -> (B,) raw margin."""
    return x @ model.weights + model.intercept


def predict_dense(model: LogisticRegression, x) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """Dense path: (predictions int32 (B,), p(class=1) (B,)) on the model's
    device (``x`` numpy or a tensor)."""
    x = torch.as_tensor(x).to(model.weights.device, torch.float32)
    p = torch.sigmoid(margin_dense(model, x))
    return (p > model.threshold).to(torch.int32), p


def unpack_rows(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 2, L) int16 -> (ids int64 (B, L), counts float32 (B, L)).
    Counts travel as uint16 bits inside the int16 plane."""
    ids = packed[:, 0, :].to(torch.int64)
    counts = (packed[:, 1, :].to(torch.int32) & 0xFFFF).to(torch.float32)
    return ids, counts


def unpack_wide_rows(ids: torch.Tensor,
                     counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two-array layout of feature spaces past int16 (int32 ids, uint16
    counts carried as int16 bits) -> (ids int64, counts float32)."""
    return (ids.to(torch.int64),
            (counts.to(torch.int32) & 0xFFFF).to(torch.float32))


def prob_rows(model: LogisticRegression, ids: torch.Tensor,
              counts: torch.Tensor) -> torch.Tensor:
    """(B, L) int64 ids and float32 counts -> (B,) p(class=1); idf folded
    into the weights. Padding slots carry count 0 and contribute nothing."""
    m = torch.sum(model.weights[ids] * counts, dim=-1) + model.intercept
    return torch.sigmoid(m)


def prob_packed(model: LogisticRegression, packed: torch.Tensor) -> torch.Tensor:
    """Packed staging buffer -> (B,) p(class=1)."""
    return prob_rows(model, *unpack_rows(packed))


# ---------------------------------------------------------------------------
# int8 scoring variant: symmetric per-BLOCK weight quantization. The gather
# reads int8 codes plus one f32 scale per 128-weight block; per-block scales
# matter because TF-IDF LR weights carry a few huge outliers.
# ---------------------------------------------------------------------------

_Q8_BLOCK = 128


def quantize_weights(model: LogisticRegression,
                     block: int = _Q8_BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes (ceil(F/block)*block,), f32 per-block scales (nb,)) with
    w[i] ~= scales[i // block] * w_q[i]."""
    w = model.weights
    f = w.shape[0]
    nb = -(-f // block)
    wp = torch.nn.functional.pad(w, (0, nb * block - f)).reshape(nb, block)
    absmax = torch.clamp(torch.max(torch.abs(wp), dim=1).values, min=1e-12)
    scales = (absmax / 127.0).to(torch.float32)
    w_q = torch.clamp(torch.round(wp / scales[:, None]),
                      -127, 127).to(torch.int8).reshape(-1)
    return w_q, scales


def prob_rows_q8(w_q: torch.Tensor, scales: torch.Tensor,
                 intercept: torch.Tensor, ids: torch.Tensor,
                 counts: torch.Tensor) -> torch.Tensor:
    """int8 scoring (see ``quantize_weights``) of (B, L) int64 ids and
    float32 counts."""
    block = w_q.shape[0] // scales.shape[0]
    per_term = (w_q[ids].to(torch.float32) * scales[ids // block] * counts)
    return torch.sigmoid(torch.sum(per_term, dim=-1) + intercept)
