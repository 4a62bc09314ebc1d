"""Autoscaler: closes the loop from the signal plane to worker lifecycle —
twin of ``fraud_detection_tpu/fleet/autoscale/controller.py``.

One :class:`Autoscaler` runs on the fleet monitor tick, AFTER the
coordinator aggregates the view and the fleet sentinel evaluates it
(fleet/fleet.py ``_monitor_loop``), so every decision judges the freshest
signal state. Each ``step()``:

1. reads membership from the coordinator's view, prunes the in-flight
   ledgers (a launched worker that joined is live; a released worker that
   left is gone);
2. asks the :class:`~fraud_detection_tpu_torch.fleet.autoscale.policy.ScalePolicy`
   for at most one decision (replace > scale-out > scale-in precedence,
   hysteresis, cooldown, bounds — policy.py);
3. actuates it: grow/replace through the
   :class:`~fraud_detection_tpu_torch.fleet.autoscale.provisioner.WorkerProvisioner`
   seam, shrink through the coordinator's ``request_release`` — a
   VOLUNTARY LEAVE riding the existing revoke→drain→commit→reassign
   barrier, so a scale-in can never lose a row;
4. publishes the decision as a term-stamped ``scale`` record on the
   control bus (a successor coordinator — and any operator tailing the
   lane — inherits the sizing history; the released set itself rides the
   incumbent's state snapshots), and lands it in the incident flight
   recorder with the evidence the policy judged.

Scale-in victims are chosen newest-first (highest worker index): the
members the fleet grew by are the ones it returns, so a tide cycle ends
on the workers it began with.

Thread model: ``step()`` runs on the single monitor thread;
``stats()``/``report()`` are the cross-thread surface (one lock, no I/O
under it).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from fraud_detection_tpu_torch.fleet.autoscale.policy import (ScaleDecision,
                                                        ScalePolicy)
from fraud_detection_tpu_torch.fleet.autoscale.provisioner import WorkerProvisioner
from fraud_detection_tpu_torch.utils import get_logger

log = get_logger("fleet.autoscale")

#: Seconds an accepted launch may sit unjoined before it stops counting
#: as live capacity (the policy then sees the deficit and replaces it
#: under a fresh id). In-process thread workers join within one
#: heartbeat; this guards the cross-host seam where a bootstrap can die.
_LAUNCH_GRACE_S = 30.0

#: Decisions kept for the report (the health block carries only the last).
_DECISIONS_KEEP = 64


class Autoscaler:
    """The elasticity controller (module docstring has the loop)."""

    def __init__(self, policy: ScalePolicy, provisioner: WorkerProvisioner,
                 coordinator, *, initial_workers: int,
                 firing: Optional[Callable[[], Sequence[str]]] = None,
                 control=None, recorder=None,
                 clock: Callable[[], float] = time.monotonic,
                 worker_prefix: str = "w",
                 launch_grace_s: float = _LAUNCH_GRACE_S):
        if initial_workers < 1:
            raise ValueError(
                f"initial_workers must be >= 1, got {initial_workers}")
        if not (policy.min_workers <= initial_workers
                <= policy.max_workers):
            raise ValueError(
                f"initial_workers ({initial_workers}) must sit inside the "
                f"policy bounds [{policy.min_workers}, "
                f"{policy.max_workers}]")
        self.policy = policy
        self.provisioner = provisioner
        self.coordinator = coordinator
        self.firing = firing if firing is not None else (lambda: ())
        self.control = control
        self.recorder = recorder
        self.clock = clock
        self.worker_prefix = worker_prefix
        self.launch_grace_s = launch_grace_s
        self._lock = threading.Lock()
        self.desired = initial_workers
        self._next_index = initial_workers  # w<i> naming continues the fleet
        self._pending: Dict[str, float] = {}    # launched, not yet a member
        self._releasing: set = set()            # released, not yet left
        self._live = initial_workers
        self.scale_outs = 0
        self.scale_ins = 0
        self.replacements = 0
        self._decisions: List[dict] = []
        self._seq = 0

    # ------------------------------------------------------------------
    # the monitor-tick loop (the one monitor thread)
    # ------------------------------------------------------------------

    def step(self, now: Optional[float] = None) -> Optional[ScaleDecision]:
        """One control pass; returns the actuated decision, if any."""
        now = self.clock() if now is None else now
        view = self.coordinator.last_view() or {}
        members = set(view.get("workers") or ())
        with self._lock:
            for wid in [w for w in self._pending
                        if w in members
                        or now - self._pending[w] > self.launch_grace_s]:
                del self._pending[wid]
            self._releasing &= members
            live = len(members) + len(self._pending)
            self._live = live
            desired = self.desired
        try:
            firing = list(self.firing())
        except Exception:  # noqa: BLE001 — a broken signal plane reads as
            firing = []    # quiet, never as a crash of the control loop
        lag = view.get("committed_lag")
        decision = self.policy.decide(
            now, firing=firing, live=live, desired=desired,
            work_remaining=not isinstance(lag, (int, float)) or lag > 0)
        if decision is None:
            return None
        if not self._actuate(decision, members, now):
            self.policy.note_denied(now)
            return None
        with self._lock:
            self.desired = decision.desired_after
            if decision.kind == "scale_out":
                self.scale_outs += 1
            elif decision.kind == "scale_in":
                self.scale_ins += 1
            else:
                self.replacements += 1
            record = {**decision.as_dict(), "live": live,
                      "term": getattr(self.coordinator, "term", 1)}
            self._decisions.append(record)
            del self._decisions[:-_DECISIONS_KEEP]
        self._publish(record, view, now)
        log.info("autoscale %s (%s): desired %d -> %d, live %d",
                 decision.kind, decision.reason, decision.desired_before,
                 decision.desired_after, live)
        return decision

    def _actuate(self, decision: ScaleDecision, members: set,
                 now: float) -> bool:
        if decision.kind == "scale_in":
            return self._release_one(members)
        # scale_out / replace: a fresh id per launch — a crashed worker's
        # id is never reused (its lease, bus doc, and stats stay its own).
        with self._lock:
            wid = f"{self.worker_prefix}{self._next_index}"
            self._next_index += 1
        if not self.provisioner.launch(wid):
            log.warning("autoscale launch refused for %s", wid)
            return False
        with self._lock:
            self._pending[wid] = now
        return True

    def _release_one(self, members: set) -> bool:
        """Release the newest releasable member. The coordinator refuses
        a release that would leave fewer than two active members — the
        policy's min clamp normally prevents ever asking."""
        with self._lock:
            candidates = sorted(members - self._releasing,
                                key=self._member_order, reverse=True)
        for wid in candidates:
            if self.coordinator.request_release(wid):
                with self._lock:
                    self._releasing.add(wid)
                return True
        log.warning("autoscale scale-in found no releasable member "
                    "among %s", sorted(members))
        return False

    def _member_order(self, wid: str):
        suffix = wid[len(self.worker_prefix):]
        return (1, int(suffix)) if suffix.isdigit() else (0, wid)

    def _publish(self, record: dict, view: dict, now: float) -> None:
        if self.control is not None:
            try:
                self.control.publish("scale", "autoscaler", dict(record),
                                     term=record.get("term") or 0)
            except Exception:  # noqa: BLE001 — a lossy control lane is the
                pass           # operating assumption, not an error
        if self.recorder is not None:
            evidence = (now, {
                "backlog_per_worker": view.get("backlog_per_worker"),
                "global_backlog": view.get("global_backlog"),
                "n_workers": view.get("n_workers"),
                "committed_lag": view.get("committed_lag"),
                "firing": list(record.get("evidence") or ())})
            self.recorder.record_scale(dict(record),
                                       evidence_window=[evidence])

    # ------------------------------------------------------------------
    # cross-thread surface
    # ------------------------------------------------------------------

    def stats(self) -> dict:
        """The view's ``autoscale`` block (its keys are the reference's)."""
        now = self.clock()
        with self._lock:
            last = self._decisions[-1] if self._decisions else None
            out = {
                "desired": self.desired,
                "live": self._live,
                "scale_outs": self.scale_outs,
                "scale_ins": self.scale_ins,
                "replacements": self.replacements,
                "last_decision": dict(last) if last else None,
            }
        out.update(self.policy.snapshot(now))
        return out

    def report(self) -> dict:
        """Evidence block for Fleet.run's output: the full
        decision history plus the block."""
        with self._lock:
            decisions = [dict(d) for d in self._decisions]
        return {**self.stats(), "provisioner": self.provisioner.kind,
                "decisions": decisions}
