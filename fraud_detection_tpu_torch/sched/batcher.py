"""Deadline-driven dynamic batching over a padding-bucket ladder, and the
async dispatch lane — twin of ``fraud_detection_tpu/sched/batcher.py``.

:class:`DynamicBatcher` forms batches by size OR deadline: after the first
row arrives it keeps polling until the batch fills or ``deadline_ms``
elapses. A partial batch then pads not to ``batch_size`` but to the
smallest rung of a **bucket ladder** (:func:`default_ladder`, e.g.
64/256/1024, or one derived from measured rung costs by
:func:`cost_aware_ladder`), each rung warmed at startup
(:func:`prewarm_ladder`). :class:`DispatchLane` runs the engine's
featurize + upload + launch leg on a thread of its own.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

_MIN_BUCKET = 16

_PREWARM_TEXTS = [
    "urgent your account has been suspended verify your social security "
    "number immediately to avoid arrest and pay the processing fee now",
    "good morning thank you for calling the clinic i would like to confirm "
    "my appointment for tomorrow afternoon please bring your insurance card",
]


def default_ladder(batch_size: int, factor: int = 4,
                   levels: int = 3) -> tuple:
    """``levels`` geometric rungs ending at ``batch_size`` (1024 -> (64,
    256, 1024)), floored at a minimum rung. Ascending, deduplicated, always
    containing ``batch_size``."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if factor < 2:
        raise ValueError(f"factor must be >= 2, got {factor}")
    rungs = {max(_MIN_BUCKET, batch_size // factor ** i)
             for i in range(levels)}
    rungs.add(batch_size)
    return tuple(sorted(b for b in rungs if b <= batch_size))


def ladder_candidates(batch_size: int) -> tuple:
    """Probe rungs for cost measurement: doublings from ``batch_size/16``
    (floored at the minimum rung) up to ``batch_size`` — 1024 -> (64, 128,
    256, 512, 1024), a superset of :func:`default_ladder`."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    rungs = {batch_size}
    b = max(_MIN_BUCKET, batch_size // 16)
    while b < batch_size:
        rungs.add(b)
        b *= 2
    return tuple(sorted(rungs))


def measure_rung_costs(pipeline, rungs: Sequence[int],
                       texts: Optional[Sequence[str]] = None,
                       repeats: int = 3) -> dict:
    """Per-rung steady cost in seconds per batch, warm-up excluded: for each
    rung an exactly rung-sized batch runs once untimed, then the median of
    ``repeats`` timed runs is kept. Each timed run ends in ``resolve()``,
    which waits for the device's result, before the clock is read. Times
    the raw-JSON path when the pipeline has it (the engine's hot path), else
    ``predict``. Leaves ``pad_ladder`` set to ``rungs``."""
    pool = list(texts or _PREWARM_TEXTS)
    rungs = tuple(sorted({int(b) for b in rungs}))
    pipeline.pad_ladder = rungs
    costs = {}
    for b in rungs:
        rows = [pool[i % len(pool)] for i in range(b)]
        values = [json.dumps({"text": t}).encode() for t in rows]
        pipeline.predict(rows)                 # warm (untimed)
        fast = pipeline.predict_json_async(values)
        if fast is not None:
            fast[0].resolve()
        samples = []
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            fast = pipeline.predict_json_async(values)
            if fast is not None:
                fast[0].resolve()
            else:
                pipeline.predict(rows)
            samples.append(time.perf_counter() - t0)
        samples.sort()
        costs[b] = samples[len(samples) // 2]
    return costs


def cost_aware_ladder(costs: dict, batch_size: int,
                      min_ratio: float = 1.25) -> tuple:
    """Ladder geometry from a measured cost curve: walking DOWN from the top
    rung, keep a smaller rung only when it is at least ``min_ratio`` cheaper
    than the smallest rung kept so far (in a flat region padding up costs
    nothing). The top rung (``batch_size``, else the largest measured) is
    always kept; the result is a subset of ``costs``' keys."""
    if min_ratio <= 1.0:
        raise ValueError(f"min_ratio must be > 1, got {min_ratio}")
    if not costs:
        raise ValueError("no measured rung costs")
    top = batch_size if batch_size in costs else max(costs)
    keep = [top]
    for b in sorted((x for x in costs if x < top), reverse=True):
        if costs[b] * min_ratio <= costs[keep[-1]]:
            keep.append(b)
    return tuple(sorted(keep))


def bucket_for(n: int, ladder: Sequence[int]) -> int:
    """Smallest rung >= n; the top rung for anything larger."""
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]


def prewarm_ladder(pipeline, buckets: Sequence[int],
                   texts: Optional[Sequence[str]] = None) -> int:
    """Apply the ladder to the pipeline, then run one batch of EXACTLY each
    rung's row count through ``predict`` and the raw-JSON path (when the
    pipeline has it). Returns the number of rungs warmed."""
    pool = list(texts or _PREWARM_TEXTS)
    pipeline.pad_ladder = tuple(sorted(set(buckets)))
    warmed = 0
    for b in pipeline.pad_ladder:
        rows = [pool[i % len(pool)] for i in range(b)]
        pipeline.predict(rows)
        fast = pipeline.predict_json_async(
            [json.dumps({"text": t}).encode() for t in rows])
        if fast is not None:
            fast[0].resolve()
        warmed += 1
    return warmed


class DispatchLane:
    """Double-buffered async dispatch: ONE background thread runs the
    engine's featurize + upload + launch leg (``launch_fn``) for batch N+1
    while the driver resolves and delivers batch N. ``depth`` bounds
    launched-but-undelivered batches.

    * **Strict FIFO.** One worker drains submissions in order and ``next()``
      returns results in that order, so offsets commit in order.
    * **Failure transparency.** An exception in ``launch_fn`` re-raises from
      ``next()`` at the failed batch's position.
    * **Threading.** ``submit``/``next``/``stop``/``pending`` are driver-
      only; ``stats()`` is safe from any thread. Queue and counters live
      under one condition variable.
    """

    def __init__(self, launch_fn: Callable, depth: int = 2, *,
                 name: str = "dispatch-lane"):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._launch_fn = launch_fn
        self.depth = depth
        self._cv = threading.Condition()
        self._in: deque = deque()      # submitted, not yet launched
        self._out: deque = deque()     # (inflight, exc) in submission order
        self._stopped = False
        self.submitted = 0
        self.launched = 0
        self.delivered = 0             # popped by next()
        self.waits = 0                 # next() calls that had to block
        self.max_inflight = 0          # peak submitted-minus-delivered
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    @property
    def pending(self) -> int:
        """Batches submitted but not yet returned by ``next()``."""
        with self._cv:
            return self.submitted - self.delivered

    def submit(self, item) -> None:
        with self._cv:
            if self._stopped:
                raise RuntimeError("dispatch lane is stopped")
            self._in.append(item)
            self.submitted += 1
            self.max_inflight = max(self.max_inflight,
                                    self.submitted - self.delivered)
            self._cv.notify_all()

    def next(self, timeout: Optional[float] = None):
        """Oldest launched batch (FIFO), blocking until the worker finishes
        it. Raises the worker's exception at that batch's position."""
        with self._cv:
            if not self._out:
                self.waits += 1
                if not self._cv.wait_for(lambda: bool(self._out),
                                         timeout=timeout):
                    raise TimeoutError(
                        f"dispatch lane produced nothing in {timeout}s "
                        f"(pending={self.submitted - self.delivered})")
            inflight, exc = self._out.popleft()
            self.delivered += 1
            if exc is not None:
                raise exc
            return inflight

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the worker and DISCARD anything not yet returned (never
        committed, so a restart replays it)."""
        with self._cv:
            self._stopped = True
            self._in.clear()
            self._cv.notify_all()
        self._thread.join(timeout)

    def stats(self) -> dict:
        with self._cv:
            return {
                "depth": self.depth,
                "submitted": self.submitted,
                "launched": self.launched,
                "max_inflight": self.max_inflight,
                "driver_waits": self.waits,
            }

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._in and not self._stopped:
                    self._cv.wait()
                if self._stopped:
                    return
                item = self._in.popleft()
            inflight, exc = None, None
            try:
                inflight = self._launch_fn(item)
            except BaseException as e:  # noqa: BLE001 — re-raised in next()
                exc = e
            with self._cv:
                self._out.append((inflight, exc))
                self.launched += 1
                self._cv.notify_all()


class DynamicBatcher:
    """Form micro-batches by size or deadline from a consumer: wait up to
    ``first_wait`` for the first row, then top up in short poll slices until
    the batch fills or ``deadline_ms`` has passed since the first non-empty
    poll returned. ``deadline_ms=None`` is one plain poll. Single-driver."""

    def __init__(self, deadline_ms: Optional[float] = None, *,
                 poll_slice: float = 0.005, clock=time.monotonic):
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        if poll_slice <= 0:
            raise ValueError(f"poll_slice must be > 0, got {poll_slice}")
        self.deadline_ms = deadline_ms
        self.poll_slice = poll_slice
        self._clock = clock

    def collect(self, consumer, budget: int, first_wait: float) -> List:
        msgs = consumer.poll_batch(budget, first_wait)
        if not msgs or self.deadline_ms is None or len(msgs) >= budget:
            return msgs
        deadline = self._clock() + self.deadline_ms / 1e3
        while len(msgs) < budget:
            remaining = deadline - self._clock()
            if remaining <= 0:
                break
            more = consumer.poll_batch(budget - len(msgs),
                                       min(remaining, self.poll_slice))
            if more:
                msgs.extend(more)
        return msgs
