"""Streaming latency quantile sketch — twin of ``LatencySketch`` in
``fraud_detection_tpu/sched/sketch.py``.

An HDR-histogram-style log-bucketed counter array with bounded memory,
vectorized batch inserts and exact counts. Quantiles are exact up to the
bucket's relative width (~7%).
"""

from __future__ import annotations

import math
import threading
from typing import Optional

import numpy as np

# Bucket geometry: [10us, ~1000s) at 7% relative width.
_MIN_SEC = 1e-5
_GROWTH = 1.07
_N_BUCKETS = int(math.ceil(math.log(1e8) / math.log(_GROWTH)))  # ~273
# Upper edge of bucket i; quantile queries report the upper edge, so the
# estimate errs toward overstating latency (conservative for an SLO check).
_EDGES = _MIN_SEC * _GROWTH ** np.arange(1, _N_BUCKETS + 1)


class LatencySketch:
    """Bounded-memory streaming quantile sketch over seconds-valued samples.

    Thread-safe: writers and readers take one small lock per CALL, never per
    sample."""

    __slots__ = ("_counts", "_lock", "count", "sum", "max")

    def __init__(self):
        self._counts = np.zeros(_N_BUCKETS, np.int64)
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def add_many(self, secs) -> None:
        """Insert a batch of samples (seconds): one vectorized pass + one
        lock acquisition regardless of batch size."""
        arr = np.asarray(secs, np.float64)
        if arr.size == 0:
            return
        arr = np.maximum(arr, 0.0)  # clock skew can produce tiny negatives
        idx = np.searchsorted(_EDGES, arr, side="left")
        idx = np.minimum(idx, _N_BUCKETS - 1)
        binned = np.bincount(idx, minlength=_N_BUCKETS).astype(np.int64)
        with self._lock:
            self._counts += binned
            self.count += int(arr.size)
            self.sum += float(arr.sum())
            self.max = max(self.max, float(arr.max()))

    def quantile(self, q: float) -> Optional[float]:
        """The q-quantile (q in [0, 1]) in seconds, or None when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            if self.count == 0:
                return None
            target = q * self.count
            cum = np.cumsum(self._counts)
            i = int(np.searchsorted(cum, target, side="left"))
        return float(_EDGES[min(i, _N_BUCKETS - 1)])
