"""Promotion policy + lifecycle controller: the decision layer — twin of
``fraud_detection_tpu/registry/promote.py``.

``PromotionPolicy`` turns a shadow divergence snapshot plus the engine's
health into one of three actions: WAIT (not enough evidence, or the engine
is currently unhealthy — never promote into an incident), PROMOTE (the
candidate is statistically equivalent where it must be), or REJECT (it
diverges beyond the configured bounds).

``LifecycleController`` owns the end-to-end flow the serve CLI drives:
poll the registry for new versions (``--watch``), verify + load + pre-warm
each, either swap directly or stage for shadow evaluation (``--shadow``),
apply the policy each tick (``--promote-policy``), and support explicit
``rollback()`` to any prior version. EVERY transition — stage, promote,
reject, rollback, integrity failure — is an append-only JSONL audit event
in the registry (``audit.jsonl``), so the model history is reconstructible
from the registry directory alone.

Candidates load on the active pipeline's device (a registry served on
``cuda`` loads its candidates on ``cuda``, and raises without a card). The
watcher thread logs a failed ``tick()`` and keeps serving, as the reference
does — except a fault of the card itself (``utils/device.is_device_fault``),
which it records in ``fault`` and stops on.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, List, Optional

from fraud_detection_tpu_torch.registry.registry import (
    ModelRegistry, RegistryError, RegistryIntegrityError)
from fraud_detection_tpu_torch.utils import get_logger
from fraud_detection_tpu_torch.utils.device import is_device_fault
from fraud_detection_tpu_torch.utils.racecheck import ExclusiveRegion

log = get_logger("registry.promote")


@dataclass(frozen=True)
class PromotionDecision:
    action: str                  # "wait" | "promote" | "reject"
    reasons: tuple = ()

    def __str__(self) -> str:
        return f"{self.action} ({'; '.join(self.reasons) or 'ok'})"


@dataclass
class PromotionPolicy:
    """Thresholds for auto-promotion of a shadow-scored candidate.

    The defaults are conservative for a binary fraud scorer: at least
    ``min_shadow_batches`` micro-batches and ``min_shadow_rows`` rows of
    evidence; label disagreement above ``max_disagreement`` or a score-
    distribution PSI above ``max_psi`` (0.25 = "shifted" by the usual rule
    of thumb) or a flag-rate swing above ``max_flag_rate_delta`` rejects;
    an unhealthy engine (flush failures in progress) defers the decision —
    promotion must never ride an incident."""

    min_shadow_batches: int = 5
    min_shadow_rows: int = 100
    max_disagreement: float = 0.02
    max_psi: float = 0.25
    max_flag_rate_delta: float = 0.10
    require_healthy: bool = True

    @classmethod
    def parse(cls, spec: str) -> "PromotionPolicy":
        """Build from a CLI spec like
        ``min_batches=5,max_disagreement=0.02,max_psi=0.25``. Unknown keys
        are an error (a typo must not silently loosen a threshold)."""
        aliases = {"min_batches": "min_shadow_batches",
                   "min_rows": "min_shadow_rows"}
        kwargs = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            key, sep, value = part.partition("=")
            if not sep:
                raise ValueError(f"bad policy term {part!r} (want key=value)")
            key = aliases.get(key, key)
            fields = cls.__dataclass_fields__
            if key not in fields:
                raise ValueError(
                    f"unknown policy key {part.split('=')[0]!r} "
                    f"(known: {sorted(set(fields) | set(aliases))})")
            typ = fields[key].type
            if typ == "bool" or typ is bool:
                kwargs[key] = value.lower() in ("1", "true", "yes")
            elif typ == "int" or typ is int:
                kwargs[key] = int(value)
            else:
                kwargs[key] = float(value)
        return cls(**kwargs)

    def evaluate(self, shadow: dict,
                 health: Optional[dict] = None) -> PromotionDecision:
        """Decide on a candidate given its shadow snapshot + engine health."""
        if self.require_healthy and health is not None:
            if health.get("consecutive_flush_failures", 0) > 0:
                return PromotionDecision(
                    "wait", ("engine unhealthy: producer flush failing",))
        if (shadow.get("batches", 0) < self.min_shadow_batches
                or shadow.get("rows", 0) < self.min_shadow_rows):
            return PromotionDecision(
                "wait", (f"insufficient shadow evidence: "
                         f"{shadow.get('batches', 0)} batches / "
                         f"{shadow.get('rows', 0)} rows "
                         f"(need {self.min_shadow_batches} / "
                         f"{self.min_shadow_rows})",))
        reasons = []
        agreement = shadow.get("agreement_rate")
        if agreement is not None and 1.0 - agreement > self.max_disagreement:
            reasons.append(f"disagreement {1.0 - agreement:.4f} > "
                           f"max {self.max_disagreement}")
        psi = shadow.get("psi")
        if psi is not None and psi > self.max_psi:
            reasons.append(f"score-distribution PSI {psi:.4f} > "
                           f"max {self.max_psi}")
        delta = shadow.get("flag_rate_delta")
        if delta is not None and abs(delta) > self.max_flag_rate_delta:
            reasons.append(f"flag-rate delta {delta:+.4f} beyond "
                           f"±{self.max_flag_rate_delta}")
        if reasons:
            return PromotionDecision("reject", tuple(reasons))
        return PromotionDecision(
            "promote", (f"agreement {agreement:.4f}, PSI "
                        f"{psi if psi is not None else 0.0:.4f} over "
                        f"{shadow['rows']} rows",))


def _public(snapshot: dict) -> dict:
    """Shadow snapshot without the bulky histograms (audit-log friendly)."""
    return {k: v for k, v in snapshot.items()
            if not k.startswith("score_hist")}


class LifecycleController:
    """Drives a ``HotSwapPipeline`` from a ``ModelRegistry``.

    ``tick()`` is one poll step, safe to call from any single thread (the
    serve CLI runs it on a watcher thread; tests call it inline for
    determinism). With a ``shadow`` scorer, new versions are STAGED and a
    ``policy`` decides promotion; without one, new versions swap in
    directly (still pre-warmed). All loads are hash-verified; a corrupted
    publish is audited + skipped, never served. Candidates load on the
    active pipeline's device."""

    def __init__(self, registry: ModelRegistry, hotswap, *,
                 shadow=None, policy: Optional[PromotionPolicy] = None,
                 batch_size: int = 256,
                 health_fn: Optional[Callable[[], Optional[dict]]] = None,
                 on_transition: Optional[Callable[[dict], None]] = None):
        self.registry = registry
        self.hotswap = hotswap
        self.shadow = shadow
        self.policy = policy
        self.batch_size = batch_size
        self.health_fn = health_fn
        self.fault: Optional[BaseException] = None   # a device fault, fatal
        # Observer hook: called with EVERY audit record this controller
        # emits (stage/promote/reject/rollback/load_failed), synchronously
        # on the transitioning thread — the learn loop (learn/loop.py)
        # tracks its candidates' fates through this. Must be fast and
        # non-reentrant (it runs inside the watch region); exceptions are
        # swallowed with a log line — an observer must never veto or kill
        # a lifecycle transition.
        self.on_transition = on_transition
        # Cursor: adopt everything NEWER than the active version (a version
        # published before the watcher started must still be picked up).
        # Seeding from latest() instead would silently skip it.
        active = getattr(hotswap, "active_version", None)
        if active is None:
            latest = registry.latest()
            active = latest.version if latest is not None else 0
        self._seen = active
        self.events: List[dict] = []    # every audited transition, in order
        # Race tripwire (utils/racecheck.py): tick() is documented "safe to
        # call from any SINGLE thread", and rollback() is the operator
        # overruling the watcher — the two deciding concurrently could
        # promote a candidate the rollback just discarded. The region makes
        # that collision a loud RaceError (the watcher loop logs it and
        # retries next interval) instead of a silent double transition.
        self._region = ExclusiveRegion("LifecycleController.watch")

    def _audit(self, event: str, **fields) -> dict:
        record = self.registry.audit(event, **fields)
        self.events.append(record)
        if self.on_transition is not None:
            try:
                self.on_transition(record)
            except Exception as e:  # noqa: BLE001 — observers never veto
                log.warning("lifecycle on_transition observer failed: %s", e)
        return record

    def tick(self) -> List[dict]:
        """One poll step: adopt new versions, evaluate a staged candidate.
        Returns the audit events this tick generated."""
        with self._region:
            return self._tick_locked()

    def _tick_locked(self) -> List[dict]:
        before = len(self.events)
        for mv in self.registry.poll_new(self._seen):
            self._seen = mv.version
            try:
                mv, pipe = self.registry.load(mv.version,
                                              batch_size=self.batch_size,
                                              device=self.hotswap.device)
            except (RegistryIntegrityError, RegistryError, ValueError,
                    OSError, KeyError) as e:
                self._audit("load_failed", version=mv.version, error=str(e))
                log.warning("registry v%04d failed verification/load: %s",
                            mv.version, e)
                continue
            if self.shadow is not None:
                replaced = self.hotswap.staged_version
                self.hotswap.stage(pipe, mv.version)   # pre-warms
                self.shadow.set_candidate(pipe, mv.version)
                self._audit("stage", version=mv.version, replaced=replaced)
            else:
                old = self.hotswap.swap(pipe, mv.version)  # pre-warms
                self._audit("promote", version=mv.version, previous=old,
                            mode="direct")
        if (self.shadow is not None and self.policy is not None
                and self.hotswap.staged_version is not None):
            snapshot = self.shadow.snapshot()
            health = self.health_fn() if self.health_fn is not None else None
            decision = self.policy.evaluate(snapshot, health)
            if decision.action == "promote":
                version = self.hotswap.promote_staged()
                self.shadow.clear_candidate()
                self._audit("promote", version=version, mode="shadow",
                            reasons=list(decision.reasons),
                            shadow=_public(snapshot))
            elif decision.action == "reject":
                version = self.hotswap.discard_staged()
                self.shadow.clear_candidate()
                self._audit("reject", version=version,
                            reasons=list(decision.reasons),
                            shadow=_public(snapshot))
        return self.events[before:]

    def rollback(self, version: int) -> dict:
        """Swap any prior published version back in (verified, pre-warmed).
        A staged candidate, if any, is discarded — rolling back IS the
        operator overruling the pipeline. Shares tick()'s exclusive region:
        a rollback racing a concurrent tick raises RaceError rather than
        letting the two transition the same staged candidate twice (stop
        the watcher, or accept the retry, before rolling back)."""
        with self._region:
            mv, pipe = self.registry.load(version, batch_size=self.batch_size,
                                          device=self.hotswap.device)
            discarded = self.hotswap.discard_staged()
            if self.shadow is not None:
                self.shadow.clear_candidate()
            old = self.hotswap.swap(pipe, mv.version)
            return self._audit("rollback", version=mv.version, previous=old,
                               discarded_staged=discarded)

    def run_in_thread(self, interval: float = 2.0,
                      stop: Optional[threading.Event] = None):
        """Spawn the watcher thread (daemon). Returns (thread, stop_event);
        set the event and join to stop. tick() errors are logged, never
        fatal — a broken registry scan must not take serving down — except
        a device fault, which stops the watcher and stays in ``fault``."""
        stop = stop or threading.Event()

        def loop():
            while not stop.is_set():
                try:
                    self.tick()
                except Exception as e:  # noqa: BLE001 — watcher must survive
                    if is_device_fault(e):
                        self.fault = e
                        log.error("lifecycle watcher stopped on a device "
                                  "fault: %s", e)
                        return
                    log.warning("lifecycle tick failed: %s", e)
                stop.wait(interval)

        thread = threading.Thread(target=loop, daemon=True,
                                  name="lifecycle-watcher")
        thread.start()
        return thread, stop
