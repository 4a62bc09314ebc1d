"""The scheduler facade the streaming engine drives — twin of
``fraud_detection_tpu/sched/scheduler.py``. Prewarming a
``registry.HotSwapPipeline`` hands it the measured ladder and cost table for
every later candidate; under the fleet each worker's scheduler also sheds
against the fleet's global backlog watermark (``fleet_backlog``).

:class:`SchedulerConfig` is the validated knob set (the serve CLI's
``--batch-deadline-ms/--max-queue/--shed-policy/--target-p99-ms/--max-rate``
map onto it); :class:`AdaptiveScheduler` wires the dynamic batcher,
admission controller, backpressure governor and windowed SLO tracker
behind the calls the engine makes per batch:

* ``collect(consumer, budget, first_wait)`` — governor-paced, deadline-driven
  poll (replaces the bare ``poll_batch``);
* ``admit(msgs, backlog)`` — split the fresh batch into kept rows and
  explicit shed records;
* ``observe_batch(n_rows, batch_sec, row_latencies)`` — feed the EWMAs and
  the SLO window after delivery.

One scheduler serves ONE engine: collect/admit/observe/prewarm share
mutable state under an :class:`ExclusiveRegion`; ``snapshot()`` is safe
from any thread.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from fraud_detection_tpu_torch.sched.admission import (SHED_POLICIES,
                                                       AdmissionController,
                                                       TokenBucket)
from fraud_detection_tpu_torch.sched.batcher import (DynamicBatcher,
                                                     bucket_for,
                                                     cost_aware_ladder,
                                                     default_ladder,
                                                     ladder_candidates,
                                                     measure_rung_costs,
                                                     prewarm_ladder)
from fraud_detection_tpu_torch.sched.governor import BackpressureGovernor
from fraud_detection_tpu_torch.sched.sketch import SloTracker
from fraud_detection_tpu_torch.utils.racecheck import ExclusiveRegion


@dataclass(frozen=True)
class SchedulerConfig:
    """Validated scheduler knobs. All defaults: no deadline (one poll), no
    shedding, no rate limit, a generous batch-wall bound."""

    batch_deadline_ms: Optional[float] = None
    max_queue: Optional[int] = None
    shed_policy: str = "none"
    target_p99_ms: Optional[float] = None
    max_rate: Optional[float] = None      # admitted rows/s; None = off
    burst: Optional[float] = None         # token burst; None = 1 s of rate
    window_sec: float = 10.0              # SLO tracker rotation window
    max_batch_sec: Optional[float] = None  # None = derived (see resolve)
    # An explicit ladder pins the rung geometry (the rungs are still timed
    # for the health cost table); None derives it from measured costs. The
    # serve CLI sets it from one prewarmer's measured ladder, so that every
    # worker's scheduler shares the shapes the pipeline warmed.
    buckets: Optional[Tuple[int, ...]] = None
    # Cost-aware ladder: prewarm() times the candidate rungs and derives
    # the rung set from the measured cost curve; False keeps the fixed
    # default ladder (the game days run that way). cost_ratio is the least
    # cost gap that justifies keeping a smaller rung.
    cost_aware: bool = True
    cost_ratio: float = 1.25

    def __post_init__(self):
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"shed_policy must be one of {SHED_POLICIES}, "
                f"got {self.shed_policy!r}")
        if self.batch_deadline_ms is not None and self.batch_deadline_ms <= 0:
            raise ValueError(
                f"batch_deadline_ms must be > 0, got {self.batch_deadline_ms}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.target_p99_ms is not None and self.target_p99_ms <= 0:
            raise ValueError(
                f"target_p99_ms must be > 0, got {self.target_p99_ms}")
        if self.max_rate is not None and self.max_rate <= 0:
            raise ValueError(f"max_rate must be > 0, got {self.max_rate}")
        if self.window_sec <= 0:
            raise ValueError(f"window_sec must be > 0, got {self.window_sec}")
        if self.shed_policy == "adaptive" and self.target_p99_ms is None:
            raise ValueError(
                "shed_policy='adaptive' sheds on SLO pressure and needs "
                "target_p99_ms")
        if self.shed_policy == "reject" and (self.max_queue is None
                                             and self.max_rate is None):
            raise ValueError(
                "shed_policy='reject' needs a limit to enforce: set "
                "max_queue and/or max_rate")
        if self.cost_ratio <= 1.0:
            raise ValueError(f"cost_ratio must be > 1, got {self.cost_ratio}")

    def resolved_max_batch_sec(self) -> float:
        """The governor's batch-wall bound: an explicit value wins; else
        half the latency target (queue wait needs the other half); else a
        2 s backstop that keeps poll cadence inside a broker session
        timeout."""
        if self.max_batch_sec is not None:
            return self.max_batch_sec
        if self.target_p99_ms is not None:
            return self.target_p99_ms / 2e3
        return 2.0


class AdaptiveScheduler:
    """One engine's consume->score scheduler (see module docstring)."""

    def __init__(self, config: SchedulerConfig, batch_size: int, *,
                 clock=time.monotonic, sleep=time.sleep):
        self.config = config
        self.batch_size = batch_size
        # An explicit ladder, else the default one until prewarm() derives
        # one from measured costs.
        self.buckets: Tuple[int, ...] = tuple(
            config.buckets if config.buckets else default_ladder(batch_size))
        # Measured per-rung cost (seconds/batch, warm-up excluded), set by
        # prewarm(); the ladder's source.
        self.ladder_costs: Optional[dict] = None
        self.slo = SloTracker(target_p99_ms=config.target_p99_ms,
                              window_sec=config.window_sec, clock=clock)
        self.batcher = DynamicBatcher(config.batch_deadline_ms, clock=clock)
        bucket = (TokenBucket(config.max_rate, config.burst, clock=clock)
                  if config.max_rate is not None else None)
        self.admission = AdmissionController(
            config.shed_policy, max_queue=config.max_queue,
            bucket=bucket, slo=self.slo)
        self.governor = BackpressureGovernor(
            config.resolved_max_batch_sec(),
            min_budget=self.buckets[0])
        self._sleep = sleep
        # Fleet-coordinated shedding: an optional zero-arg callable returning
        # the fleet's backlog per worker (None while the fleet view is stale
        # or absent). When it reports more than this worker's own partitions
        # show, admission sheds against the global watermark, so a drowning
        # fleet sheds everywhere at once.
        self.fleet_backlog: Optional[Callable[[], Optional[float]]] = None
        self._region = ExclusiveRegion("AdaptiveScheduler.drive")

    @property
    def sheds(self) -> bool:
        """True when the policy can divert rows (the engine then requires a
        DLQ topic for the shed records)."""
        return self.admission.sheds

    def collect(self, consumer, budget: int, first_wait: float) -> List:
        """Governor-paced, deadline-driven poll of up to ``budget`` rows."""
        with self._region:
            budget, pause = self.governor.advise(
                budget, self.admission.pending_pause())
            if pause > 0:
                self._sleep(pause)
            return self.batcher.collect(consumer, budget, first_wait)

    def backlog_of(self, consumer) -> Optional[int]:
        """The queue depth admission sheds against: rows queued behind the
        consumer's poll position (its ``backlog()``; None when the transport
        cannot report it), raised to the fleet's backlog per worker when a
        ``fleet_backlog`` source is wired and reports more."""
        backlog = getattr(consumer, "backlog", None)
        local: Optional[int] = None
        if backlog is not None:
            try:
                local = backlog()
            except Exception:  # noqa: BLE001 — lag reporting must never kill serving
                local = None
        fleet = self.fleet_backlog
        if fleet is not None:
            try:
                g = fleet()
            except Exception:  # noqa: BLE001 — same contract as the local probe
                g = None
            if g is not None:
                return max(int(g), local if local is not None else 0)
        return local

    def admit(self, msgs: List, backlog: Optional[int], trace=None
              ) -> Tuple[List, List[Tuple[object, str]]]:
        with self._region:
            return self.admission.admit(msgs, backlog, trace=trace)

    def observe_batch(self, n_rows: int, batch_sec: float,
                      row_latencies: Optional[Sequence[float]] = None) -> None:
        with self._region:
            self.governor.observe(n_rows, batch_sec)
            if row_latencies is not None and len(row_latencies):
                self.slo.record(row_latencies)

    def bucket_for(self, n: int) -> int:
        return bucket_for(n, self.buckets)

    def prewarm(self, pipeline,
                texts: Optional[Sequence[str]] = None) -> int:
        """Time every candidate rung, derive the ladder from the measured
        cost curve, set it as ``pipeline.pad_ladder`` and warm every
        selected rung off the hot path. A ``HotSwapPipeline`` measures on
        its active pipeline and keeps the cost table and the ladder
        (``measure_ladder`` / ``configure_ladder``), so every later swap or
        stage candidate is warmed at the same rungs, never re-measured."""
        with self._region:
            cfg = self.config
            explicit = cfg.buckets is not None
            candidates = (self.buckets if explicit or not cfg.cost_aware
                          else ladder_candidates(self.batch_size))
            measure = getattr(pipeline, "measure_ladder", None)
            if measure is not None:
                costs = measure(candidates, texts=texts)
            else:
                costs = measure_rung_costs(pipeline, candidates, texts=texts)
            self.ladder_costs = dict(costs)
            if not explicit and cfg.cost_aware:
                self.buckets = cost_aware_ladder(costs, self.batch_size,
                                                 cfg.cost_ratio)
                # the smallest rung is the governor's budget floor
                self.governor.min_budget = self.buckets[0]
            configure = getattr(pipeline, "configure_ladder", None)
            if configure is not None:
                configure(self.buckets, prewarm=True, costs=costs)
            else:
                prewarm_ladder(pipeline, self.buckets, texts)
            return len(self.buckets)

    def snapshot(self) -> dict:
        """The ``sched`` block of ``StreamingClassifier.health()``."""
        costs = self.ladder_costs
        return {
            "batch_deadline_ms": self.config.batch_deadline_ms,
            "buckets": list(self.buckets),
            "ladder_cost_ms": (None if costs is None else
                               {str(b): round(s * 1e3, 3)
                                for b, s in sorted(costs.items())}),
            "slo": self.slo.snapshot(),
            "admission": self.admission.snapshot(),
            "governor": self.governor.snapshot(),
        }
