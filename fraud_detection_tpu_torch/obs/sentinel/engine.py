"""Sentinel: the alerting engine — rule evaluation, incident lifecycle —
twin of ``fraud_detection_tpu/obs/sentinel/engine.py``.

This module is the part of the running system that watches itself. One :class:`Sentinel`
owns:

* a **flight-recorder ring** of timestamped metric snapshots (the nested
  ``health()``-shaped dict its ``source`` callable returns), appended once
  per evaluation — the window store every burn-rate/delta/stale rule reads
  and the evidence the incident bundles capture;
* a **rule table** (obs/sentinel/rules.py) evaluated on every pass;
* the **incident lifecycle**: ok → pending (condition observed) → firing
  (held ``for_s``) → resolved (clear ``resolve_s``), with exact accounting
  (``fired == resolved + still_firing`` is a pinned invariant — the chaos
  suite asserts it across supervised restart chains);
* the **transition hooks**: every fire/resolve appends to the recorder's
  append-only ``incidents.jsonl`` and captures a bundle
  (obs/sentinel/bundle.py).

Time is INJECTABLE and one-dimensional: ``clock()`` stamps evaluations,
windows, and hysteresis alike, so the same sentinel runs on wall time under
serve (:func:`start_sentinel`'s thread) and on *virtual* time under the
scenario harness (:class:`VirtualCadence` /
:func:`evaluate_timeline`) — a warp-paced game day (time_scale 0) evaluates
rules at exactly the virtual times a real-time run would, which is what
makes ``detects_within`` SLO gates deterministic (the warp-vs-paced
test in tests/test_torch_sentinel.py pins it).

Thread model: ``evaluate()`` runs on whichever single thread drives this
sentinel (the serve "sentinel" thread, the scenario driver, a fleet
worker's poll path, the fleet monitor tick); ``snapshot()``/``firing()``/
``healthz()`` are the cross-thread surface. All mutable state sits under
one lock; the source pull and the recorder's file I/O happen OUTSIDE it,
so the sentinel never holds its lock across another subsystem's.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from fraud_detection_tpu_torch.obs.sentinel.bundle import IncidentRecorder
from fraud_detection_tpu_torch.obs.sentinel.rules import AlertRule
from fraud_detection_tpu_torch.utils import get_logger

log = get_logger("obs.sentinel")

#: Evidence-window samples kept per rule (what the bundle's
#: ``evidence_window`` shows: the last observed values the rule judged).
_EVIDENCE_KEEP = 32
#: Compact incident records kept in ``snapshot()["incidents"]``.
_INCIDENTS_KEEP = 64


class _RuleState:
    """One rule's lifecycle state (sentinel-lock protected)."""

    __slots__ = ("rule", "state", "pending_since", "clear_since",
                 "incident", "evidence")

    def __init__(self, rule: AlertRule):
        self.rule = rule
        self.state = "ok"                   # ok | pending | firing
        self.pending_since: Optional[float] = None
        self.clear_since: Optional[float] = None
        self.incident: Optional[dict] = None
        self.evidence: deque = deque(maxlen=_EVIDENCE_KEEP)


class Sentinel:
    """Rule evaluation + incident lifecycle over one metric source."""

    def __init__(self, source: Callable[[], Optional[dict]],
                 rules: Sequence[AlertRule], *,
                 clock: Callable[[], float] = time.monotonic,
                 recorder: Optional[IncidentRecorder] = None,
                 worker: str = "w0", history: int = 256):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {names}")
        if history < 2:
            raise ValueError(f"history must be >= 2, got {history}")
        self.source = source
        self.rules: Tuple[AlertRule, ...] = tuple(rules)
        self.clock = clock
        self.recorder = recorder
        self.worker = worker
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=history)   # (stamp, snapshot)
        self._states: Dict[str, _RuleState] = {
            r.name: _RuleState(r) for r in self.rules}
        self._incidents: deque = deque(maxlen=_INCIDENTS_KEEP)
        self._seq = 0
        self.evaluations = 0
        self.eval_errors = 0
        self.fired = 0
        self.resolved = 0
        self._last_eval_at: Optional[float] = None

    # ------------------------------------------------------------------
    # evaluation (single driver thread)
    # ------------------------------------------------------------------

    def prime(self, now: Optional[float] = None) -> None:
        """Seed the flight ring with a baseline snapshot at ``now``
        WITHOUT advancing rule lifecycles — the source's current state,
        or an EMPTY baseline when the source isn't up yet (missing
        counters read as 0 in window deltas). Without this, everything
        that happened before the first periodic evaluation is absorbed
        into its snapshot and window deltas read zero: a burn already in
        progress at the first tick must be visible AS a burn. The
        drivers (start_sentinel) prime automatically."""
        now = self.clock() if now is None else now
        try:
            snap = self.source()
        except Exception:  # noqa: BLE001
            snap = None
        with self._lock:
            if not self._ring:
                self._ring.append((now, snap if isinstance(snap, dict)
                                   else {}))

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation pass: pull the source, append to the flight
        ring, advance every rule's lifecycle. Returns the transitions
        (``{"event": "fired"/"resolved", ...}`` incident records) this
        pass produced. Source failures count in ``eval_errors`` and skip
        the pass — a broken health() must not read as 'all clear' forever,
        so the absence rule still sees a missing-source pass as a tick
        with NO fresh snapshot (the ring keeps its last state)."""
        now = self.clock() if now is None else now
        try:
            snap = self.source()
        except Exception:  # noqa: BLE001 — alerting must never kill serving
            snap = None
        transitions: List[dict] = []
        bundles: List[tuple] = []       # (kind, incident, state, ring copy)
        with self._lock:
            self.evaluations += 1
            self._last_eval_at = now
            if not isinstance(snap, dict):
                self.eval_errors += 1
                return []
            self._ring.append((now, snap))
            ring = tuple(self._ring)
            for state in self._states.values():
                t = self._advance_locked(state, ring, now)
                if t is not None:
                    transitions.append(t)
                    bundles.append((t["event"], t, state, ring))
        # Recorder I/O outside the lock (bundle.py owns its own lock).
        if self.recorder is not None:
            for kind, incident, state, ring in bundles:
                incident = {k: v for k, v in incident.items()
                            if k != "event"}
                if kind == "fired":
                    self.recorder.record_fired(
                        incident, state.rule.as_dict(),
                        list(state.evidence), ring)
                else:
                    self.recorder.record_resolved(incident, ring)
        return transitions

    def _advance_locked(self, st: _RuleState, ring, now: float
                        ) -> Optional[dict]:
        cond, observed = st.rule.condition(ring, now)
        if cond:
            st.evidence.append((now, observed))
        if st.state == "ok":
            if not cond:
                return None
            st.state = "pending"
            st.pending_since = now
            # falls through: for_s == 0 fires on the same pass
        if st.state == "pending":
            if not cond:
                st.state = "ok"
                st.pending_since = None
                return None
            if now - st.pending_since < st.rule.for_s:
                return None
            st.state = "firing"
            st.clear_since = None
            self._seq += 1
            self.fired += 1
            incident = {
                "id": f"{self.worker}-i{self._seq:04d}-{st.rule.name}",
                "rule": st.rule.name,
                "severity": st.rule.severity,
                "worker": self.worker,
                "fired_at": round(now, 6),
                "pending_since": round(st.pending_since, 6),
                "value": observed,
                "resolved_at": None,
            }
            st.incident = incident
            self._incidents.append(incident)
            log.warning("alert FIRING: %s (%s) value=%r",
                        st.rule.name, st.rule.severity, observed)
            return {"event": "fired", **incident}
        # firing
        if cond:
            st.clear_since = None
            return None
        if st.clear_since is None:
            st.clear_since = now
        if now - st.clear_since < st.rule.resolve_s:
            return None
        st.state = "ok"
        st.pending_since = None
        self.resolved += 1
        incident = dict(st.incident or {})
        incident["resolved_at"] = round(now, 6)
        incident["duration_s"] = round(
            now - incident.get("fired_at", now), 6)
        # The shared deque entry updates in place: snapshot() readers see
        # the incident resolve without a second record.
        if st.incident is not None:
            st.incident["resolved_at"] = incident["resolved_at"]
        st.incident = None
        st.clear_since = None
        log.info("alert resolved: %s", st.rule.name)
        return {"event": "resolved", **incident}

    # ------------------------------------------------------------------
    # cross-thread surface
    # ------------------------------------------------------------------

    def firing(self) -> List[str]:
        """Names of rules currently firing (sorted)."""
        with self._lock:
            return sorted(n for n, s in self._states.items()
                          if s.state == "firing")

    def last_eval_at(self) -> Optional[float]:
        """Stamp of the newest evaluation, in this sentinel's clock
        domain (VIRTUAL seconds under the scenario harness) — the time
        base the autoscaler shares so scale decisions are stamped in the
        same domain as the signals that caused them (fleet/autoscale/)."""
        with self._lock:
            return self._last_eval_at

    def critical_firing(self) -> List[str]:
        """Firing rules whose severity is critical — the /healthz gate."""
        with self._lock:
            return sorted(n for n, s in self._states.items()
                          if s.state == "firing"
                          and s.rule.severity == "critical")

    def healthz(self) -> Tuple[bool, List[str]]:
        """Readiness verdict: (ok, critical firing rule names)."""
        crit = self.critical_firing()
        return (not crit, crit)

    def snapshot(self) -> dict:
        """The ``alerts`` health block (the JAX sentinel's schema, held
        equal in tests/test_torch_sentinel.py).
        ``fired == resolved + still_firing`` is the accounting invariant
        the chaos suite pins."""
        with self._lock:
            firing = sorted(n for n, s in self._states.items()
                            if s.state == "firing")
            pending = sorted(n for n, s in self._states.items()
                             if s.state == "pending")
            critical = sorted(
                n for n, s in self._states.items()
                if s.state == "firing" and s.rule.severity == "critical")
            incidents = [dict(i) for i in self._incidents]
            return {
                "worker": self.worker,
                "rules": len(self.rules),
                "evaluations": self.evaluations,
                "eval_errors": self.eval_errors,
                "last_eval_at": self._last_eval_at,
                "ring_depth": len(self._ring),
                "firing": firing,
                "critical_firing": critical,
                "pending": pending,
                "fired": self.fired,
                "resolved": self.resolved,
                "still_firing": len(firing),
                "incidents": incidents,
                "recorder": (self.recorder.snapshot()
                             if self.recorder is not None else None),
            }


class ChainedHealthSource:
    """Cumulative health across a supervised incarnation chain.

    Engine counters reset when the supervisor rebuilds an incarnation,
    which breaks alerting two ways: a window delta spanning the restart
    reads the reset as "restarted from zero" (losing the dead
    incarnation's tail), and a short-lived signal — one ``commits_skipped``
    on a flush failure an instant before the engine dies — only exists in
    a snapshot the sentinel probably never samples. This source folds each
    dead incarnation's final counters into an accumulator at ``attach``
    time (the same place the supervisor's ``make_engine`` shares the DLQ
    poison tracker), so the sentinel sees MONOTONIC chain-cumulative
    counters plus a ``supervisor`` block whose ``restarts`` counter feeds
    the restart-churn rule.

    Single-writer: ``attach`` runs on the supervisor path; ``__call__``
    on the sentinel driver. The accumulator is only mutated under the
    lock, and health reads stay lock-free racy samples as everywhere.
    """

    COUNTERS = ("processed", "malformed", "dead_lettered", "shed",
                "rebalanced_commits", "commits_skipped")

    def __init__(self):
        self._lock = threading.Lock()
        self._acc = {k: 0 for k in self.COUNTERS}
        self._live = None
        self._builds = 0

    def attach(self, engine) -> None:
        """Declare a new live incarnation; the previous one's counters
        fold into the accumulator."""
        with self._lock:
            prev = self._live
            if prev is not None:
                stats = prev.stats
                for k in self.COUNTERS:
                    self._acc[k] += getattr(stats, k, 0)
            self._live = engine
            self._builds += 1

    def __call__(self) -> Optional[dict]:
        with self._lock:
            engine = self._live
            acc = dict(self._acc)
            builds = self._builds
        if engine is None:
            return None
        h = engine.health()
        for k in self.COUNTERS:
            v = h.get(k)
            if isinstance(v, (int, float)):
                h[k] = v + acc[k]
        h["supervisor"] = {"restarts": max(builds - 1, 0)}
        return h


# ---------------------------------------------------------------------------
# drivers: wall-cadence thread (serve) and virtual-time cadence (scenarios)
# ---------------------------------------------------------------------------

def start_sentinel(sentinels: Sequence[Sentinel], interval: float,
                   *, wall_sleep_floor: float = 0.002
                   ) -> Callable[[], None]:
    """The serve-side driver: ONE daemon thread ("sentinel") evaluating
    every sentinel each ``interval`` seconds; returns ``finish()`` which
    stops the thread and runs a FINAL evaluation pass so the exit stats
    reflect the run's last state (same contract as the metrics writer).
    No-op when ``sentinels`` is empty."""
    sentinels = list(sentinels)
    if not sentinels:
        return lambda: None
    if interval <= 0:
        raise ValueError(f"interval must be > 0, got {interval}")
    for s in sentinels:
        s.prime()       # baseline BEFORE traffic: burns measure from 0
    stop = threading.Event()

    def loop() -> None:
        while not stop.wait(max(interval, wall_sleep_floor)):
            for s in sentinels:
                s.evaluate()

    thread = threading.Thread(target=loop, daemon=True, name="sentinel")
    thread.start()

    def finish() -> None:
        stop.set()
        thread.join(timeout=5.0)
        for s in sentinels:
            s.evaluate()

    return finish


class VirtualCadence:
    """A sentinel clock for scenario runs: reads the scenario clock's
    VIRTUAL time, but never stalls — each call advances at least ``step``
    past the last reading, so hysteresis windows keep elapsing while the
    engine drains a warp-fed backlog (the feeder's cursor stops at the
    timeline's end; drain-side evaluations then advance one virtual tick
    each, which is what makes ``detects_within`` measure real evaluation
    latency in warp mode instead of freezing at the end stamp).

    Single-caller by contract (the one sentinel driver thread)."""

    def __init__(self, now_fn: Callable[[], float], step: float):
        if step <= 0:
            raise ValueError(f"step must be > 0, got {step}")
        self.now_fn = now_fn
        self.step = step
        self._last = -step

    def __call__(self) -> float:
        v = max(self.now_fn(), self._last + self.step)
        self._last = v
        return v


def evaluate_timeline(sentinel: Sentinel, clock, until_s: float,
                      interval_s: float) -> List[dict]:
    """Deterministically evaluate a sentinel at virtual times 0,
    ``interval_s``, 2·``interval_s``, … ``until_s`` on a
    scenario clock (anything with ``advance_to(t)``) — in warp
    mode (time_scale 0) this is instant, in paced mode ``advance_to``
    sleeps the gaps out; either way the EVALUATION TIMELINE is identical,
    which the warp-vs-paced regression test pins. Returns every transition
    in order."""
    if interval_s <= 0:
        raise ValueError(f"interval_s must be > 0, got {interval_s}")
    transitions: List[dict] = []
    t = 0.0
    while t <= until_s + 1e-9:
        clock.advance_to(t)
        transitions.extend(sentinel.evaluate(now=t))
        t += interval_s
    return transitions
