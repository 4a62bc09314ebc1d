"""Scale policy: the fleet's sizing decisions, as a pure function of time —
twin of ``fraud_detection_tpu/fleet/autoscale/policy.py``.

A :class:`ScalePolicy` turns the sentinel signal plane (which fleet rules
are firing — obs/sentinel/rules.py) plus the coordinator's capacity view
into at most one :class:`ScaleDecision` per evaluation:

* **replace** — live capacity (including in-flight launches) fell below
  desired: a member died or its lease expired. Restores the contract,
  never changes it, so it bypasses both hysteresis and cooldown — a
  replacement is not a resize.
* **scale_out** — a burn signal (``fleet_watermark_burn`` by default) has
  been firing continuously for ``out_for_s``: raise desired by ``step``,
  clamped to ``max_workers``.
* **scale_in** — an idle signal (``fleet_idle``) sustained ``in_for_s``
  with NO burn signal present: lower desired by ``step``, clamped to
  ``min_workers``. A burn and an idle signal firing together always
  resolve to the burn side (capacity errs toward availability).

Every resize starts a ``cooldown_s`` window during which further resizes
are suppressed — the fleet must observe the last decision's effect before
making another (the anti-flap half of the loop; the sentinel's
``autoscale_flap`` rule is the independent watchdog over the whole thing).

The policy is deliberately clock-free: ``decide(now, ...)`` takes the
caller's stamp, so the same policy runs on wall time under serve and on an
injected (virtual) clock in tests, deterministically.

Thread model: ``decide``/``note_denied`` run on the single controller
thread (the fleet monitor tick); ``snapshot()`` is the cross-thread
surface (racy reads of monotonic counters, same contract as engine
health).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class ScaleDecision:
    """One sizing decision, as published on the control bus and recorded
    in the incident timeline (``event: "scale"``)."""

    kind: str                   # "scale_out" | "scale_in" | "replace"
    reason: str                 # triggering rule name / condition
    at: float                   # policy-clock stamp
    desired_before: int
    desired_after: int
    evidence: Tuple[str, ...]   # fleet rules firing at decision time

    def as_dict(self) -> dict:
        return {"kind": self.kind, "reason": self.reason,
                "at": round(self.at, 6),
                "desired_before": self.desired_before,
                "desired_after": self.desired_after,
                "evidence": list(self.evidence)}


@dataclass
class ScalePolicy:
    """Hysteresis + cooldown + bounds over the fleet's firing signals
    (module docstring has the full decision semantics)."""

    min_workers: int
    max_workers: int
    cooldown_s: float = 30.0
    out_for_s: float = 0.0      # burn must hold this long before growing
    in_for_s: float = 0.0       # idle must hold this long before shrinking
    step: int = 1
    out_on: Tuple[str, ...] = ("fleet_watermark_burn",)
    in_on: Tuple[str, ...] = ("fleet_idle",)

    denied: int = field(default=0, init=False)      # clamp/actuation refusals
    _out_since: Optional[float] = field(default=None, init=False)
    _in_since: Optional[float] = field(default=None, init=False)
    _last_resize_at: Optional[float] = field(default=None, init=False)

    def __post_init__(self):
        if self.min_workers < 1:
            raise ValueError(
                f"min_workers must be >= 1, got {self.min_workers}")
        if self.max_workers < self.min_workers:
            raise ValueError(
                f"max_workers ({self.max_workers}) must be >= min_workers "
                f"({self.min_workers})")
        if self.cooldown_s < 0:
            raise ValueError(
                f"cooldown_s must be >= 0, got {self.cooldown_s}")
        if self.out_for_s < 0 or self.in_for_s < 0:
            raise ValueError("out_for_s/in_for_s must be >= 0")
        if self.step < 1:
            raise ValueError(f"step must be >= 1, got {self.step}")

    # -- evaluation ------------------------------------------------------

    def decide(self, now: float, *, firing: Sequence[str],
               live: int, desired: int,
               work_remaining: bool = True) -> Optional[ScaleDecision]:
        """At most one decision for this evaluation. ``live`` MUST count
        in-flight launches (provisioned but not yet members) — otherwise
        the join latency of the last scale-out reads as a deficit and
        every grow double-provisions as a replace. ``work_remaining``
        gates the replace arm exactly like the ``worker_absence`` rule's
        ``while_path``: drain-mode workers leave when the committed lag
        clears, and replacing THOSE would respawn the fleet forever."""
        names = set(firing)
        burn = bool(names & set(self.out_on))
        idle = bool(names & set(self.in_on)) and not burn
        # Hysteresis clocks advance BEFORE any early return: a burn that
        # started during cooldown has already served its out_for_s when
        # the window opens. Explicit None checks — a clock that started
        # at stamp 0.0 (virtual time) is set, not falsy.
        if burn:
            if self._out_since is None:
                self._out_since = now
        else:
            self._out_since = None
        if idle:
            if self._in_since is None:
                self._in_since = now
        else:
            self._in_since = None
        if live < desired and work_remaining:
            return ScaleDecision("replace", "capacity_deficit", now,
                                 desired, desired, tuple(sorted(names)))
        if self._cooldown_remaining(now) > 0:
            return None
        if burn and now - self._out_since >= self.out_for_s:
            if desired + self.step > self.max_workers:
                # Clamped: count ONE denial per cooldown window, not one
                # per evaluation of a signal that keeps firing.
                self.denied += 1
                self._last_resize_at = now
                return None
            self._last_resize_at = now
            return ScaleDecision(
                "scale_out",
                sorted(names & set(self.out_on))[0],
                now, desired, desired + self.step, tuple(sorted(names)))
        if idle and now - self._in_since >= self.in_for_s:
            if desired - self.step < self.min_workers:
                self.denied += 1
                self._last_resize_at = now
                return None
            self._last_resize_at = now
            return ScaleDecision(
                "scale_in",
                sorted(names & set(self.in_on))[0],
                now, desired, desired - self.step, tuple(sorted(names)))
        return None

    def note_denied(self, now: float) -> None:
        """An accepted decision the controller could NOT actuate (the
        provisioner refused, no releasable member). Counts as denied and
        restarts the cooldown so the controller doesn't hammer a refusal
        every tick."""
        self.denied += 1
        self._last_resize_at = now

    def _cooldown_remaining(self, now: float) -> float:
        if self._last_resize_at is None:
            return 0.0
        return max(0.0, self.cooldown_s - (now - self._last_resize_at))

    def snapshot(self, now: float) -> dict:
        return {"min": self.min_workers, "max": self.max_workers,
                "denied": self.denied,
                "cooldown_remaining_s": round(
                    self._cooldown_remaining(now), 6)}
