"""Zero-downtime model swapping for the streaming engine — twin of
``fraud_detection_tpu/registry/hotswap.py``.

``HotSwapPipeline`` stands where a ``ServingPipeline`` does — the engine
scores through it untouched — and swaps the pipeline underneath RCU-style:
readers (the engine's dispatch path, any thread) take NO lock; each scoring
call reads the active ``(version, pipeline)`` reference exactly once, so a
batch dispatched concurrently with a swap scores wholly with one model or
wholly with the other, never a mix. Writers (the lifecycle watcher thread)
serialize on a small lock that the hot path never touches.

The swap contract that keeps p99 flat: a candidate is PRE-WARMED before it
becomes active — a representative dummy batch runs through every path it
will serve (text path, and the raw-JSON path when available; every ladder
rung once a scheduler configured one), so first-call costs (the kernels'
builds and loads, the allocator's first blocks, pinned host buffers) are
paid off the hot path, at stage/swap time.

On a CUDA device the prewarm runs on a stream of its own
(``utils/device.lane_stream``), after the work queued on the default stream
(the candidate's uploads, the engine's batches), and ends by synchronizing
that stream: the candidate's device state has landed before the pointer
swap lets the engine's stream read it.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional, Sequence, Tuple

from fraud_detection_tpu_torch.utils.device import lane_stream, on_lane

_PREWARM_TEXTS = [
    "urgent your account has been suspended verify your social security "
    "number immediately to avoid arrest and pay the processing fee now",
    "good morning thank you for calling the clinic i would like to confirm "
    "my appointment for tomorrow afternoon please bring your insurance card",
]


class HotSwapPipeline:
    """A ServingPipeline holder whose model can be replaced between batches.

    Engine-facing surface: ``predict_async`` / ``predict_json_async`` (the
    two calls the streaming engine makes) plus ``predict``/``predict_one``
    and attribute delegation for everything else — drop-in wherever a
    ``ServingPipeline`` is accepted.
    """

    def __init__(self, pipeline, version: Optional[int] = None, *,
                 prewarm_texts: Optional[Sequence[str]] = None,
                 prewarm_buckets: Optional[Sequence[int]] = None,
                 clock=time.monotonic):
        # Single-reference RCU publish point: one tuple, swapped atomically
        # under the GIL; every reader dereferences it exactly once per call.
        self._active: Tuple[Optional[int], object] = (version, pipeline)
        self._staged: Optional[Tuple[Optional[int], object]] = None
        self._lock = threading.Lock()   # writers only; readers never touch it
        self._clock = clock
        self._prewarm_texts = list(prewarm_texts or _PREWARM_TEXTS)
        # Scheduler padding-bucket ladder (sched/batcher.py): once
        # configured, EVERY candidate is pre-warmed at every rung, so
        # neither a swap nor a first small batch pays first-call costs on
        # the hot path.
        self._pad_buckets: Optional[Tuple[int, ...]] = None
        self._ladder_costs: Optional[dict] = None  # measured once, reused
        self.swaps = 0
        self._last_swap_at: Optional[float] = None
        self._streams: dict = {}    # device -> the prewarm lane's stream
        if prewarm_buckets is not None:
            self.configure_ladder(prewarm_buckets, prewarm=False)

    # ------------------------------------------------------------------
    # reader surface (lock-free)
    # ------------------------------------------------------------------

    def predict_async(self, texts):
        return self._active[1].predict_async(texts)

    def predict_json_async(self, values, text_field: str = "text"):
        return self._active[1].predict_json_async(values, text_field)

    def predict(self, texts):
        return self._active[1].predict(texts)

    def predict_one(self, text: str):
        return self._active[1].predict_one(text)

    @property
    def batch_size(self) -> int:
        return self._active[1].batch_size

    @property
    def active_version(self) -> Optional[int]:
        return self._active[0]

    @property
    def active_pipeline(self):
        return self._active[1]

    @property
    def staged_version(self) -> Optional[int]:
        staged = self._staged
        return staged[0] if staged is not None else None

    @property
    def staged_pipeline(self):
        staged = self._staged
        return staged[1] if staged is not None else None

    def __getattr__(self, name):
        # Anything beyond the scoring surface (featurizer, model, device,
        # device_stats…) reads from the CURRENT active pipeline.
        return getattr(self._active[1], name)

    # ------------------------------------------------------------------
    # writer surface (lifecycle thread)
    # ------------------------------------------------------------------

    def configure_ladder(self, buckets: Sequence[int], *,
                         prewarm: bool = True,
                         costs: Optional[dict] = None) -> None:
        """Adopt a scheduler padding-bucket ladder (sched/batcher.py): the
        active pipeline (and any staged candidate) starts padding partial
        batches to ladder rungs, and every future ``prewarm`` — i.e. every
        swap/stage candidate — warms every rung, across swaps AND across
        batch sizes.

        ``costs`` caches the measured per-rung device costs the geometry
        came from (``measure_ladder`` / sched measure_rung_costs): swap and
        stage candidates then only warm the selected rungs — the cost
        curve is a property of the rung shapes, not the weights, so
        candidates never re-bench."""
        # Writer-side lock: configure_ladder runs on the scheduler's driver
        # thread while swap/stage read _pad_buckets on the lifecycle
        # watcher — the lock keeps the buckets+costs pair a single
        # consistent publish. The prewarm calls below stay OUTSIDE it.
        with self._lock:
            self._pad_buckets = tuple(sorted(set(int(b) for b in buckets)))
            if costs is not None:
                self._ladder_costs = dict(costs)
        for target in (self.active_pipeline, self.staged_pipeline):
            if target is not None:
                if prewarm:
                    self.prewarm(target)
                else:
                    target.pad_ladder = self._pad_buckets

    def measure_ladder(self, candidates: Sequence[int], *,
                       texts: Optional[Sequence[str]] = None,
                       repeats: int = 3) -> dict:
        """Time candidate rungs on the ACTIVE pipeline (warm-up excluded —
        sched/batcher.py measure_rung_costs) and cache the table; the
        scheduler's cost-aware prewarm calls this instead of re-measuring
        per swap. The active pipeline is left padded to the candidate set
        until ``configure_ladder`` applies the selected geometry."""
        from fraud_detection_tpu_torch.sched.batcher import measure_rung_costs

        costs = measure_rung_costs(self.active_pipeline, tuple(candidates),
                                   texts=list(texts or self._prewarm_texts),
                                   repeats=repeats)
        with self._lock:   # writer-side publish, same contract as configure
            self._ladder_costs = dict(costs)
        return costs

    @property
    def ladder_costs(self) -> Optional[dict]:
        """Measured per-rung cost table (seconds/batch) the current ladder
        was derived from; None before any measurement."""
        return self._ladder_costs

    @property
    def pad_buckets(self) -> Optional[Tuple[int, ...]]:
        return self._pad_buckets

    def prewarm(self, pipeline) -> None:
        """Run a representative dummy batch through every path the pipeline
        will serve, so first-call costs land HERE, not on the first
        post-swap production batch. Blocks until device results land. With a
        ladder configured, every rung's shape is warmed.

        Also pins the candidate's model tensors device-resident
        (ServingPipeline.pin_device): pinning happens once per model
        version, here at stage/swap time — never per batch. On CUDA all of
        it runs on the prewarm lane's stream, which is synchronized before
        this returns (see the module docstring)."""
        stream = lane_stream(getattr(pipeline, "device", None), self._streams)
        with on_lane(stream):
            pin = getattr(pipeline, "pin_device", None)
            if callable(pin):
                pin()
            if self._pad_buckets is not None:
                from fraud_detection_tpu_torch.sched.batcher import (
                    prewarm_ladder)

                prewarm_ladder(pipeline, self._pad_buckets,
                               texts=self._prewarm_texts)
            else:
                n = max(int(getattr(pipeline, "batch_size", 1)), 1)
                texts = [self._prewarm_texts[i % len(self._prewarm_texts)]
                         for i in range(min(n, 256))]
                pipeline.predict(texts)
                # The raw-JSON fast path is a separate entry; warm it when
                # the pipeline offers it (mirrors the engine's own probe).
                values = [json.dumps({"text": t}).encode() for t in texts]
                fast = pipeline.predict_json_async(values)
                if fast is not None:
                    fast[0].resolve()
            if stream is not None:
                stream.synchronize()

    def swap(self, pipeline, version: Optional[int] = None, *,
             prewarm: bool = True) -> Optional[int]:
        """Make ``pipeline`` active (pre-warming it first, off the hot
        path); returns the version it replaced. Readers mid-batch keep the
        old model for that batch — nothing blocks, nothing tears."""
        if prewarm:
            self.prewarm(pipeline)
        elif self._pad_buckets is not None:
            pipeline.pad_ladder = self._pad_buckets  # ladder survives swaps
        with self._lock:
            old_version = self._active[0]
            self._active = (version, pipeline)
            self.swaps += 1
            self._last_swap_at = self._clock()
        return old_version

    def stage(self, pipeline, version: Optional[int] = None, *,
              prewarm: bool = True) -> None:
        """Hold a candidate next to the active model (shadow scoring reads
        it; ``promote_staged`` makes it active). Pre-warms at stage time so
        promotion itself is instant."""
        if prewarm:
            self.prewarm(pipeline)
        elif self._pad_buckets is not None:
            pipeline.pad_ladder = self._pad_buckets  # ladder survives swaps
        with self._lock:
            self._staged = (version, pipeline)

    def promote_staged(self) -> Optional[int]:
        """Swap the staged candidate in; returns its version. The candidate
        was pre-warmed at stage time, so this is a pure pointer swap."""
        with self._lock:
            if self._staged is None:
                raise RuntimeError("no staged candidate to promote")
            version, pipeline = self._staged
            self._staged = None
            self._active = (version, pipeline)
            self.swaps += 1
            self._last_swap_at = self._clock()
        return version

    def discard_staged(self) -> Optional[int]:
        with self._lock:
            staged, self._staged = self._staged, None
        return staged[0] if staged is not None else None

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def lifecycle_snapshot(self) -> dict:
        """The ``model`` block of ``StreamingClassifier.health()`` (minus
        the shadow stats, which the engine merges in from its scorer)."""
        now = self._clock()
        return {
            "active_version": self.active_version,
            "staged_version": self.staged_version,
            "swaps": self.swaps,
            "last_swap_age_sec": (None if self._last_swap_at is None
                                  else now - self._last_swap_at),
        }
