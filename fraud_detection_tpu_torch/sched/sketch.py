"""Streaming latency accounting — twins of ``LatencySketch``, ``Ewma`` and
``SloTracker`` in ``fraud_detection_tpu/sched/sketch.py``.

``LatencySketch`` is an HDR-histogram-style log-bucketed counter array with
bounded memory, vectorized batch inserts, exact counts and lossless merges.
Quantiles are exact up to the bucket's relative width (~7%).
``SloTracker`` keeps a rotating window of per-row latencies for the
scheduler's governor and shedding; ``Ewma`` smooths batch walls.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional, Sequence

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

    def add(self, sec: float) -> None:
        self.add_many(np.asarray([sec], np.float64))

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

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def merge(self, other: "LatencySketch") -> None:
        """Lossless merge (bucket counts add); ``other`` is read under its
        own lock first, then added under this one's."""
        with other._lock:
            counts = other._counts.copy()
            count, total, mx = other.count, other.sum, other.max
        with self._lock:
            self._counts += counts
            self.count += count
            self.sum += total
            self.max = max(self.max, mx)

    def to_wire(self) -> dict:
        """JSON-safe sparse encoding of the full sketch (non-zero bucket
        indexes + counts + exact aggregates); ``from_wire`` round-trips it
        losslessly, so sketches published by several workers merge into
        exactly the sketch one process would have built. The same wire as
        the JAX package's."""
        with self._lock:
            idx = np.flatnonzero(self._counts)
            return {"v": 1,
                    "idx": idx.tolist(),
                    "counts": self._counts[idx].tolist(),
                    "count": self.count,
                    "sum": self.sum,
                    "max": self.max}

    @classmethod
    def from_wire(cls, wire) -> Optional["LatencySketch"]:
        """Rebuild a sketch from :meth:`to_wire` output; None on any
        malformed or foreign payload (telemetry ingest never raises)."""
        try:
            if not isinstance(wire, dict) or wire.get("v") != 1:
                return None
            sk = cls()
            idx = np.asarray(wire["idx"], np.int64)
            counts = np.asarray(wire["counts"], np.int64)
            if idx.shape != counts.shape or (
                    idx.size and (idx.min() < 0 or idx.max() >= _N_BUCKETS)):
                return None
            sk._counts[idx] = counts
            sk.count = int(wire["count"])
            sk.sum = float(wire["sum"])
            sk.max = float(wire["max"])
            return sk
        except (KeyError, TypeError, ValueError):
            return None

    def snapshot(self) -> dict:
        """p50/p95/p99/max/mean in milliseconds + count, one consistent read."""
        with self._lock:
            if self.count == 0:
                return {"count": 0, "p50_ms": None, "p95_ms": None,
                        "p99_ms": None, "mean_ms": None, "max_ms": None}
            cum = np.cumsum(self._counts)
            count, total, mx = self.count, self.sum, self.max

        def q(frac: float) -> float:
            i = int(np.searchsorted(cum, frac * count, side="left"))
            return float(_EDGES[min(i, _N_BUCKETS - 1)])

        return {"count": count,
                "p50_ms": round(q(0.50) * 1e3, 3),
                "p95_ms": round(q(0.95) * 1e3, 3),
                "p99_ms": round(q(0.99) * 1e3, 3),
                "mean_ms": round(total / count * 1e3, 3),
                "max_ms": round(mx * 1e3, 3)}


class Ewma:
    """Exponentially weighted moving average; None until the first observe."""

    __slots__ = ("alpha", "value")

    def __init__(self, alpha: float = 0.2):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.value: Optional[float] = None

    def observe(self, x: float) -> float:
        self.value = (x if self.value is None
                      else self.alpha * x + (1.0 - self.alpha) * self.value)
        return self.value


class SloTracker:
    """Windowed per-row latency quantiles feeding the governor and shedding.

    Two-sketch rotation: samples land in the CURRENT sketch; every
    ``window_sec`` it becomes PREVIOUS and a fresh current starts. Queries
    merge both, so estimates cover the last 1-2 windows."""

    def __init__(self, target_p99_ms: Optional[float] = None,
                 window_sec: float = 10.0, clock=None):
        if window_sec <= 0:
            raise ValueError(f"window_sec must be > 0, got {window_sec}")
        if target_p99_ms is not None and target_p99_ms <= 0:
            raise ValueError(
                f"target_p99_ms must be > 0, got {target_p99_ms}")
        self.target_p99_ms = target_p99_ms
        self.window_sec = window_sec
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._current = LatencySketch()
        self._previous = LatencySketch()
        self._rotated_at = self._clock()

    def _maybe_rotate_locked(self, now: float) -> None:
        if now - self._rotated_at >= self.window_sec:
            self._previous = self._current
            self._current = LatencySketch()
            self._rotated_at = now

    def record(self, secs: Sequence[float]) -> None:
        now = self._clock()
        with self._lock:
            self._maybe_rotate_locked(now)
            current = self._current
        current.add_many(secs)

    def _merged(self) -> LatencySketch:
        with self._lock:
            self._maybe_rotate_locked(self._clock())
            current, previous = self._current, self._previous
        merged = LatencySketch()
        merged.merge(previous)
        merged.merge(current)
        return merged

    def p99_ms(self) -> Optional[float]:
        q = self._merged().quantile(0.99)
        return None if q is None else q * 1e3

    def over_target(self) -> Optional[bool]:
        """True/False against the target; None without a target or samples
        (callers treat None as no pressure signal)."""
        if self.target_p99_ms is None:
            return None
        p99 = self.p99_ms()
        return None if p99 is None else p99 > self.target_p99_ms

    def snapshot(self) -> dict:
        snap = self._merged().snapshot()
        snap["target_p99_ms"] = self.target_p99_ms
        snap["window_sec"] = self.window_sec
        return snap
