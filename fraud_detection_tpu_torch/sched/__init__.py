"""Adaptive serving scheduler — twin of ``fraud_detection_tpu/sched``: the
consume->score handoff, made load-aware.

* :mod:`sketch` — streaming quantile sketch, EWMA, windowed SLO tracker;
* :mod:`batcher` — deadline-driven batching over a padding-bucket ladder,
  and the async dispatch lane;
* :mod:`admission` — token-bucket rate limiting and queue watermarks with
  explicit shedding to the DLQ lane;
* :mod:`governor` — poll pacing from EWMAs of batch latency;
* :mod:`scheduler` — the facade the engine drives.
"""

from fraud_detection_tpu_torch.sched.admission import (AdmissionController,
                                                       TokenBucket)
from fraud_detection_tpu_torch.sched.batcher import (DispatchLane,
                                                     DynamicBatcher,
                                                     cost_aware_ladder,
                                                     default_ladder,
                                                     ladder_candidates,
                                                     measure_rung_costs,
                                                     prewarm_ladder)
from fraud_detection_tpu_torch.sched.governor import BackpressureGovernor
from fraud_detection_tpu_torch.sched.scheduler import (AdaptiveScheduler,
                                                       SchedulerConfig)
from fraud_detection_tpu_torch.sched.sketch import (Ewma, LatencySketch,
                                                    SloTracker)

__all__ = [
    "AdaptiveScheduler",
    "AdmissionController",
    "BackpressureGovernor",
    "DispatchLane",
    "DynamicBatcher",
    "Ewma",
    "LatencySketch",
    "SchedulerConfig",
    "SloTracker",
    "TokenBucket",
    "cost_aware_ladder",
    "default_ladder",
    "ladder_candidates",
    "measure_rung_costs",
    "prewarm_ladder",
]
