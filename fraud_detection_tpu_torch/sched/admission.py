"""Admission control: token-bucket rate limiting, queue watermarks and
explicit load shedding — twin of ``fraud_detection_tpu/sched/admission.py``.

* a :class:`TokenBucket` meters admitted rows/s against a configured rate;
* a queue-depth watermark (``max_queue``) bounds the backlog the engine
  tolerates before shedding toward the watermark;
* policy ``adaptive`` sheds a growing fraction of each batch (AIMD) while
  the SLO tracker reports p99 over target, and rows already older than
  half the target.

Shedding never drops silently: every shed row becomes a structured DLQ
record delivered and committed with the batch it was polled into, so
key-set accounting stays exact. Rows are shed only at admission, before
their batch dispatches. With policy ``none`` nothing is shed — the token
bucket then becomes a pacing signal (``pending_pause``) that the governor
turns into poll backpressure.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Tuple

SHED_POLICIES = ("none", "reject", "adaptive")

# Shed-record reasons (DLQ ``reason`` field + health counters).
SHED_QUEUE = "shed_queue_full"
SHED_RATE = "shed_rate_limit"
SHED_SLO = "shed_slo"
SHED_DEADLINE = "shed_deadline"

# With a latency target, rows older than this fraction of it at admission
# are shed: a row that has burned most of its deadline queueing breaches
# the SLO anyway, and serving it spends capacity fresh rows could use.
SHED_AGE_FRACTION = 0.5


class TokenBucket:
    """Rows/s token bucket with a burst ceiling. ``grant(n)`` returns how
    many of n rows fit the budget; ``drain(n)`` admits all n and returns
    the pacing debt in seconds (the no-shed policy's backpressure)."""

    def __init__(self, rate: float, burst: Optional[float] = None, *,
                 clock=time.monotonic):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else max(self.rate, 1.0)
        if self.burst <= 0:
            raise ValueError(f"burst must be > 0, got {self.burst}")
        self._clock = clock
        self._tokens = self.burst
        self._at = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._at) * self.rate)
        self._at = now

    def grant(self, n: int) -> int:
        self._refill()
        take = min(n, int(self._tokens))
        self._tokens -= take
        return take

    def drain(self, n: int) -> float:
        """Admit n rows, going into debt if needed; returns the seconds of
        pacing that repay the debt (0 when the budget covered the batch)."""
        self._refill()
        self._tokens -= n
        return max(0.0, -self._tokens) / self.rate

    @property
    def available(self) -> float:
        self._refill()
        return self._tokens


class AdmissionController:
    """Decides, per freshly polled batch, which rows score and which shed.

    Single-driver (the scheduler's region enforces it); ``counters`` is read
    racily by health snapshots. Shedding takes the NEWEST rows (the tail of
    the polled batch): the oldest have waited longest, and shedding them
    would waste their queue time."""

    def __init__(self, policy: str = "none", *,
                 max_queue: Optional[int] = None,
                 bucket: Optional[TokenBucket] = None,
                 slo=None,
                 shed_step: float = 0.05,
                 shed_decay: float = 0.7,
                 wall=time.time):
        if policy not in SHED_POLICIES:
            raise ValueError(
                f"shed policy must be one of {SHED_POLICIES}, got {policy!r}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.policy = policy
        self.max_queue = max_queue
        self.bucket = bucket
        self.slo = slo
        self.shed_step = shed_step
        self.shed_decay = shed_decay
        self._wall = wall   # message timestamps are wall-clock
        self.max_age_sec = (
            slo.target_p99_ms / 1e3 * SHED_AGE_FRACTION
            if (policy == "adaptive" and slo is not None
                and slo.target_p99_ms is not None) else None)
        self.shed_fraction = 0.0
        self.counters = {SHED_QUEUE: 0, SHED_RATE: 0, SHED_SLO: 0,
                         SHED_DEADLINE: 0}
        self._pending_pause = 0.0
        self.last_backlog: Optional[int] = None

    @property
    def sheds(self) -> bool:
        return self.policy != "none"

    def pending_pause(self) -> float:
        """Seconds of poll pacing owed (policy ``none`` with token debt);
        cleared on read — the governor applies it once."""
        pause, self._pending_pause = self._pending_pause, 0.0
        return pause

    def _update_shed_fraction(self) -> None:
        over = self.slo.over_target() if self.slo is not None else None
        if over is None:
            return
        if over:
            self.shed_fraction = min(
                1.0, self.shed_fraction * 1.5 + self.shed_step)
        else:
            f = self.shed_fraction * self.shed_decay
            self.shed_fraction = f if f > 1e-3 else 0.0

    def admit(self, msgs: List, backlog: Optional[int], trace=None
              ) -> Tuple[List, List[Tuple[object, str]]]:
        """Split a polled batch into (kept, [(msg, shed_reason)]).
        ``backlog`` is the rows still queued behind this batch (None when
        the transport cannot say: the watermark is then inert). ``trace``
        is the batch's ``obs.trace.BatchTrace`` when tracing is on: every
        shed row records its event at the shed site, naming the rule."""
        self.last_backlog = backlog
        if not msgs:
            return msgs, []
        if self.policy == "none":
            if self.bucket is not None:
                self._pending_pause = self.bucket.drain(len(msgs))
            return msgs, []

        keep = msgs
        shed: List[Tuple[object, str]] = []

        def cut(n_keep: int, reason: str) -> None:
            nonlocal keep
            if n_keep < len(keep):
                shed.extend((m, reason) for m in keep[n_keep:])
                if trace is not None:
                    for m in keep[n_keep:]:
                        trace.shed(m, reason)
                self.counters[reason] += len(keep) - n_keep
                keep = keep[:n_keep]

        # Deadline shedding: rows that already burned SHED_AGE_FRACTION of
        # the target queueing, wherever they sit; rows without a timestamp
        # (0.0) are exempt.
        if self.max_age_sec is not None:
            cutoff = self._wall() - self.max_age_sec
            stale = [m for m in keep if 0.0 < m.timestamp < cutoff]
            if stale:
                shed.extend((m, SHED_DEADLINE) for m in stale)
                if trace is not None:
                    for m in stale:
                        trace.shed(m, SHED_DEADLINE)
                self.counters[SHED_DEADLINE] += len(stale)
                keep = [m for m in keep
                        if not 0.0 < m.timestamp < cutoff]

        # Queue watermark: over it, shed in proportion to the excess, which
        # drives the backlog toward max_queue while work keeps flowing.
        if (self.max_queue is not None and backlog is not None
                and backlog > self.max_queue):
            frac = (backlog - self.max_queue) / backlog
            cut(len(keep) - int(math.ceil(frac * len(keep))), SHED_QUEUE)

        if self.bucket is not None and keep:
            cut(self.bucket.grant(len(keep)), SHED_RATE)

        if self.policy == "adaptive" and keep:
            self._update_shed_fraction()
            if self.shed_fraction > 0.0:
                cut(len(keep) - int(math.ceil(
                    self.shed_fraction * len(keep))), SHED_SLO)

        return keep, shed

    def snapshot(self) -> dict:
        return {
            "policy": self.policy,
            "max_queue": self.max_queue,
            "rate_limit": self.bucket.rate if self.bucket is not None else None,
            "tokens_available": (round(self.bucket.available, 1)
                                 if self.bucket is not None else None),
            "shed_fraction": round(self.shed_fraction, 4),
            "shed": dict(self.counters),
            "backlog": self.last_backlog,
        }
