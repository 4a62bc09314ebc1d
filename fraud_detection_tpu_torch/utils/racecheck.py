"""Race detection for the port's documented single-threaded contracts.

Twins of ``ExclusiveRegion`` and ``PairedCallChecker`` in
``fraud_detection_tpu/utils/racecheck.py``. A region may be held by one
thread at a time; same-thread re-entry is allowed. It never blocks — a second thread entering means the caller broke
the contract, so it raises ``RaceError`` and records the violation in a
process-wide log (``violations()``), so code that swallows exceptions still
leaves evidence.
"""

from __future__ import annotations

import threading
import traceback
from dataclasses import dataclass, field
from typing import List, Optional

_log_lock = threading.Lock()
_violations: List["RaceViolation"] = []

#: Every racecheck region the port instruments, by name: the runtime
#: detector's coverage list. flightcheck (analysis/threads.py, rule FC103)
#: cross-checks it against the ``ExclusiveRegion("...")`` /
#: ``PairedCallChecker(name=...)`` constructions in the source and against
#: ``analysis/entrypoints.py`` ``THREAD_ENTRY_POINTS``, so instrumenting a
#: contract, or deleting one, without updating all three fails lint. Keep
#: it a LITERAL set: the analyzer reads it from the AST.
INSTRUMENTED_REGIONS = frozenset({
    "StreamingClassifier.drive",     # engine single-driver loop
    "AdaptiveScheduler.drive",       # scheduler collect/admit/observe
    "InProcessConsumer",             # broker consumer poll/commit
    "InProcessAssignedConsumer",     # manual-assignment consumer (fleet)
    "NativeFeaturizer",              # native begin/fill pairing (checker)
    "ShadowScorer.worker",           # shadow-scoring worker (one thread)
    "LifecycleController.watch",     # hot-swap watch thread tick/rollback
    "FleetWorker.run",               # one thread drives a worker's engines
    "LearnLoop.lane",                # closed-loop learn-lane worker
})


@dataclass
class RaceViolation:
    region: str
    holder: str          # thread name that was inside
    intruder: str        # thread name that entered concurrently
    intruder_stack: str  # where the second entry came from


class RaceError(RuntimeError):
    """A documented single-threaded contract was violated."""

    def __init__(self, violation: RaceViolation):
        self.violation = violation
        super().__init__(
            f"race on {violation.region!r}: held by thread "
            f"{violation.holder!r} when thread {violation.intruder!r} entered "
            f"— this code path is documented single-threaded")


def violations() -> List[RaceViolation]:
    """All contract violations detected so far in this process."""
    with _log_lock:
        return list(_violations)


def clear_violations() -> None:
    """Empty the process-wide log (a test resets it before a drive)."""
    with _log_lock:
        _violations.clear()


def _record(v: RaceViolation) -> None:
    with _log_lock:
        _violations.append(v)


class ExclusiveRegion:
    """Detects concurrent entry into a code region documented as
    single-threaded. Same-thread re-entry is fine; cross-thread overlap
    raises ``RaceError`` (and is recorded either way)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._owner: Optional[threading.Thread] = None
        self._depth = 0

    def __enter__(self) -> "ExclusiveRegion":
        me = threading.current_thread()
        with self._lock:
            if self._owner is None or self._owner is me:
                self._owner = me
                self._depth += 1
                return self
            v = RaceViolation(
                region=self.name,
                holder=self._owner.name,
                intruder=me.name,
                intruder_stack="".join(traceback.format_stack(limit=8)),
            )
        _record(v)
        raise RaceError(v)

    def __exit__(self, *exc) -> None:
        me = threading.current_thread()
        with self._lock:
            if self._owner is me:
                self._depth -= 1
                if self._depth == 0:
                    self._owner = None


@dataclass
class PairedCallChecker:
    """Detects broken begin/finish pairing across threads — the native
    featurizer's ``encode_begin`` / ``encode_fill`` pair shares handle state
    and must be issued by one caller at a time (``featurize/native.py``
    holds a lock; this catches a path that forgets it)."""

    name: str
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _pending_by: Optional[str] = None

    def begin(self) -> None:
        me = threading.current_thread().name
        with self._lock:
            if self._pending_by is not None and self._pending_by != me:
                v = RaceViolation(
                    region=f"{self.name}.begin", holder=self._pending_by,
                    intruder=me,
                    intruder_stack="".join(traceback.format_stack(limit=8)))
                _record(v)
                raise RaceError(v)
            self._pending_by = me

    def finish(self) -> None:
        with self._lock:
            self._pending_by = None
