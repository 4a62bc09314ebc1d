"""Tracing and profiling hooks — timers, rate counters, profiler spans —
twin of ``fraud_detection_tpu/utils/tracing.py``.

``Tracer`` aggregates named wall-clock spans (thread-safe), ``RateCounter``
tracks events/sec over a sliding window for the streaming loop, and
``device_trace`` wraps ``torch.profiler`` so a trace of the host's ops and
the card's kernels can be captured around any region with one env var
(FRAUD_TPU_PROFILE_DIR) and inspected in Perfetto or chrome://tracing.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Deque, Dict, Iterator, Optional, Tuple


@dataclass
class SpanStats:
    count: int = 0
    total: float = 0.0
    max: float = 0.0

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class Tracer:
    """Thread-safe named span aggregation.

    >>> tracer = Tracer()
    >>> with tracer.span("featurize"): ...
    >>> tracer.stats()["featurize"].count
    1
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: Dict[str, SpanStats] = {}

    @contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                s = self._spans.setdefault(name, SpanStats())
                s.count += 1
                s.total += dt
                s.max = max(s.max, dt)

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            s = self._spans.setdefault(name, SpanStats())
            s.count += 1
            s.total += seconds
            s.max = max(s.max, seconds)

    def stats(self) -> Dict[str, SpanStats]:
        with self._lock:
            return {k: SpanStats(v.count, v.total, v.max)
                    for k, v in self._spans.items()}

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {k: {"count": v.count, "total_sec": round(v.total, 6),
                    "mean_sec": round(v.mean, 6), "max_sec": round(v.max, 6)}
                for k, v in self.stats().items()}


class RateCounter:
    """Sliding-window events/sec (the streaming msgs/sec gauge)."""

    def __init__(self, window: float = 10.0):
        self.window = window
        self._events: Deque[Tuple[float, int]] = deque()
        self._lock = threading.Lock()

    def add(self, n: int = 1, now: Optional[float] = None) -> None:
        t = time.monotonic() if now is None else now
        with self._lock:
            self._events.append((t, n))
            self._evict(t)

    def _evict(self, now: float) -> None:
        cutoff = now - self.window
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()

    def rate(self, now: Optional[float] = None) -> float:
        t = time.monotonic() if now is None else now
        with self._lock:
            self._evict(t)
            if not self._events:
                return 0.0
            total = sum(n for _, n in self._events)
            span = max(t - self._events[0][0], 1e-9)
            return total / span


@contextmanager
def device_trace(name: str = "trace", out_dir: Optional[str] = None,
                 device=None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace around a region into
    ``<dir>/<name>.trace.json``: the host's ops, and the card's kernels when
    ``device`` is a card.

    Active only when ``out_dir`` or FRAUD_TPU_PROFILE_DIR is set — zero cost
    otherwise, so call sites can leave it in production paths.
    """
    target = out_dir or os.getenv("FRAUD_TPU_PROFILE_DIR")
    if not target:
        yield
        return
    import torch

    from fraud_detection_tpu_torch.obs.export import profiler_activities

    os.makedirs(target, exist_ok=True)
    with torch.profiler.profile(
            activities=profiler_activities(device)) as prof:
        yield
    prof.export_chrome_trace(os.path.join(target, f"{name}.trace.json"))
