"""Circuit breaker for explanation backends — twin of
``fraud_detection_tpu/explain/circuit.py``.

:class:`CircuitBreakerBackend` wraps any ``LLMBackend`` in the classic
three-state breaker, so a dead endpoint costs one fast ``BreakerOpenError``
per call instead of its full timeout and retry budget:

* **closed** — calls pass through; ``failure_threshold`` CONSECUTIVE
  failures trip it open (a single success resets the count).
* **open** — calls fail instantly with :class:`BreakerOpenError` (a
  ``BackendError`` subclass, so every degraded path — the agent's
  ``error`` field, the explain hook's unannotated batch — handles it
  unchanged).
* **half-open** — after ``probe_interval`` seconds of open state, exactly
  ONE call is admitted as a probe; success closes the breaker, failure
  re-opens it for another interval. Concurrent calls during the probe
  fast-fail.

The clock is injectable (monotonic seconds) so state transitions are
deterministic in tests; the breaker is thread-safe.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Sequence

from fraud_detection_tpu_torch.explain.backends import BackendError, ChatMessage
from fraud_detection_tpu_torch.utils import get_logger

log = get_logger("explain.circuit")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class BreakerOpenError(BackendError):
    """Fast-fail: the breaker is open and no backend call was attempted.
    Subclasses BackendError so every caller's degraded path applies."""


class CircuitBreakerBackend:
    """Wrap ``inner`` (any LLMBackend) in a closed/open/half-open breaker.

    Exposes the full backend surface — ``chat``/``generate`` always, and
    ``generate_batch`` only when the inner backend has one (so
    ``make_stream_explain_hook``'s feature probe sees the truth through the
    wrapper). ``snapshot()`` is the observability hook surfaced by
    ``StreamingClassifier.health()`` and the serve CLI stats JSON.
    """

    def __init__(self, inner, *, failure_threshold: int = 5,
                 probe_interval: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        if probe_interval <= 0:
            raise ValueError(
                f"probe_interval must be > 0, got {probe_interval}")
        self.inner = inner
        self.failure_threshold = failure_threshold
        self.probe_interval = probe_interval
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0          # consecutive failures while closed
        self._opened_at: Optional[float] = None
        self._probing = False       # a half-open probe call is in flight
        # Monotonic counters (observability, never reset).
        self._opens = 0
        self._fast_fails = 0
        self._probes = 0
        self._calls = 0             # calls admitted to the inner backend
        self._successes = 0
        if hasattr(inner, "generate_batch"):
            # Instance attribute: hasattr/getattr probes on the wrapper then
            # match the inner backend's capabilities exactly.
            self.generate_batch = self._generate_batch
        if hasattr(inner, "explain_rows"):
            # Slotserve's row-level surface (explain/slotserve/service.py):
            # forwarded under the same breaker so a dead slot lane
            # fast-fails instead of stalling the annotation worker.
            self.explain_rows = self._explain_rows

    # ------------------------------------------------------------------
    # state machine
    # ------------------------------------------------------------------

    def _admit(self) -> bool:
        """Gate one call. Returns True when the admitted call is the
        half-open probe; raises BreakerOpenError on fast-fail."""
        with self._lock:
            if self._state == CLOSED:
                self._calls += 1
                return False
            now = self._clock()
            if (self._state == OPEN
                    and now - self._opened_at >= self.probe_interval):
                self._state = HALF_OPEN
            if self._state == HALF_OPEN and not self._probing:
                self._probing = True
                self._probes += 1
                self._calls += 1
                return True
            self._fast_fails += 1
            age = now - self._opened_at
            raise BreakerOpenError(
                f"circuit breaker open for {age:.1f}s after "
                f"{self.failure_threshold} consecutive backend failures; "
                f"next probe in {max(0.0, self.probe_interval - age):.1f}s")

    def _on_success(self, probe: bool) -> None:
        with self._lock:
            self._successes += 1
            self._failures = 0
            if probe:
                self._probing = False
                if self._state == HALF_OPEN:
                    log.info("circuit breaker probe succeeded; closing")
                self._state = CLOSED
                self._opened_at = None

    def _on_failure(self, probe: bool, exc: BaseException) -> None:
        with self._lock:
            if probe:
                # Probe failed: straight back to open, clock restarted.
                self._probing = False
                self._state = OPEN
                self._opened_at = self._clock()
                log.warning("circuit breaker probe failed (%r); re-opening "
                            "for %.1fs", exc, self.probe_interval)
                return
            self._failures += 1
            if self._state == CLOSED and self._failures >= self.failure_threshold:
                self._state = OPEN
                self._opened_at = self._clock()
                self._opens += 1
                log.warning(
                    "circuit breaker OPEN after %d consecutive failures "
                    "(last: %r); fast-failing for %.1fs before probing",
                    self._failures, exc, self.probe_interval)

    def _call(self, fn, *args, **kwargs):
        probe = self._admit()
        try:
            out = fn(*args, **kwargs)
        except Exception as exc:
            self._on_failure(probe, exc)
            raise
        self._on_success(probe)
        return out

    # ------------------------------------------------------------------
    # LLMBackend surface
    # ------------------------------------------------------------------

    def chat(self, messages: Sequence[ChatMessage], *, temperature: float = 1.0,
             max_tokens: int = 1000) -> str:
        return self._call(self.inner.chat, messages,
                          temperature=temperature, max_tokens=max_tokens)

    def generate(self, prompt: str, *, temperature: float = 1.0,
                 max_tokens: int = 1000, system: Optional[str] = None) -> str:
        return self._call(self.inner.generate, prompt, temperature=temperature,
                          max_tokens=max_tokens, system=system)

    def _generate_batch(self, prompts, **kwargs):
        return self._call(self.inner.generate_batch, prompts, **kwargs)

    def _explain_rows(self, texts, labels, confs, **kwargs):
        return self._call(self.inner.explain_rows, texts, labels, confs,
                          **kwargs)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    @property
    def state(self) -> str:
        """Current state name; an expired open interval reads as half_open
        (the next call would be admitted as a probe)."""
        with self._lock:
            if (self._state == OPEN
                    and self._clock() - self._opened_at >= self.probe_interval):
                return HALF_OPEN
            return self._state

    def snapshot(self) -> Dict:
        """Health snapshot (surfaced by engine.health() / serve stats)."""
        with self._lock:
            state = self._state
            open_age = (None if self._opened_at is None
                        else self._clock() - self._opened_at)
            if (state == OPEN and open_age is not None
                    and open_age >= self.probe_interval):
                state = HALF_OPEN
            return {
                "state": state,
                "consecutive_failures": self._failures,
                "open_age_sec": open_age,
                "opens": self._opens,
                "fast_fails": self._fast_fails,
                "probes": self._probes,
                "calls": self._calls,
                "successes": self._successes,
            }
