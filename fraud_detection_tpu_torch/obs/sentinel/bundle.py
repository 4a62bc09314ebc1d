"""Incident flight recorder: bundles written at every alert transition — twin of
``fraud_detection_tpu/obs/sentinel/bundle.py``.

An alert that fires at 3am is only useful if the evidence that fired it is
still on disk at 9am. The :class:`IncidentRecorder` captures that evidence
at the moment of the transition, while the flight-recorder ring still holds
it:

* ``incidents.jsonl`` — one append-only line per transition (``fired`` /
  ``resolved``), written as a single ``write()`` of one newline-terminated
  JSON document under the recorder's lock, so concurrent sentinels sharing
  a directory interleave whole records, never bytes. The file is the
  machine-readable incident timeline (the CI alert-smoke parses it).
* ``<dir>/<incident id>/bundle.json`` — the per-incident postmortem bundle,
  published via the shared atomic writer: the rule (full spec + the
  observed value), the **evidence window** (every ``(stamp, value)`` the
  rule evaluated over its window), the **metric deltas** of the flight
  ring (numeric leaves: oldest vs newest snapshot, so "what moved while
  this fired" is one diff), the full latest health snapshot, and — when a
  row tracer is attached — the **forced-keep trace chains** of recently
  implicated rows (shed/DLQ'd/aborted/flagged events still in the span
  ring), each a complete poll→terminal chain by correlation id.
* resolution updates the incident's ``resolution.json`` next to the bundle
  (the original bundle stays byte-stable — a postmortem artifact must not
  mutate under the reader).

Failures follow the observability prime directive: recording returns
False/None and counts, never raises into the evaluation loop.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from fraud_detection_tpu_torch.utils import get_logger
from fraud_detection_tpu_torch.utils.atomicio import atomic_write_json

log = get_logger("obs.sentinel")

#: Row-event stages whose cids implicate rows in an incident (obs/trace.py
#: vocabulary): accountability events are forced-keeps, so their chains are
#: still in the ring when the alert fires.
_IMPLICATING = ("shed", "dlq", "abort", "flag", "annotate")


def metric_deltas(old: dict, new: dict, prefix: str = "") -> Dict[str, float]:
    """Numeric-leaf deltas between two health-shaped snapshots (dotted
    keys). Only leaves present in BOTH snapshots and actually moved are
    reported — the bundle answers "what changed", not "what exists"."""
    out: Dict[str, float] = {}
    if not isinstance(old, dict) or not isinstance(new, dict):
        return out
    for key, nv in new.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        ov = old.get(key)
        if isinstance(nv, dict) and isinstance(ov, dict):
            out.update(metric_deltas(ov, nv, path))
        elif (isinstance(nv, (int, float)) and not isinstance(nv, bool)
              and isinstance(ov, (int, float)) and not isinstance(ov, bool)):
            d = nv - ov
            if d != 0:
                out[path] = round(float(d), 6)
    return out


def implicated_chains(rowtrace, *, max_chains: int = 8,
                      max_spans: int = 64) -> List[dict]:
    """The forced-keep chains of recently implicated rows: walk the span
    ring newest-first for accountability row events, then pull each cid's
    full chain. Bounded both ways — a bundle is a postmortem aid, not a
    ring dump."""
    if rowtrace is None:
        return []
    try:
        spans = rowtrace.ring.snapshot()
    except Exception:  # noqa: BLE001 — recording must never raise
        return []
    chains: List[dict] = []
    seen: set = set()
    for span in reversed(spans):
        if span.stage not in _IMPLICATING or span.cid in seen:
            continue
        seen.add(span.cid)
        chain = rowtrace.chain(span.cid)
        chains.append({
            "cid": span.cid,
            "event": span.stage,
            "detail": span.detail,
            "chain": [s.as_dict() for s in chain[:max_spans]],
        })
        if len(chains) >= max_chains:
            break
    return chains


class IncidentRecorder:
    """Append-only incident log + per-incident bundle dirs (module doc)."""

    def __init__(self, dir: str, *, rowtrace=None, ring_keep: int = 8):
        self.dir = dir
        self.rowtrace = rowtrace
        self.ring_keep = ring_keep      # flight-ring snapshots kept per bundle
        self.recorded = 0               # transitions appended to the log
        self.record_errors = 0
        self._lock = threading.Lock()
        os.makedirs(dir, exist_ok=True)

    @property
    def log_path(self) -> str:
        return os.path.join(self.dir, "incidents.jsonl")

    def _count_error(self) -> None:
        with self._lock:
            self.record_errors += 1

    def _append(self, record: dict) -> bool:
        """One transition line, appended whole (single write + flush)."""
        try:
            line = json.dumps(record) + "\n"
        except (TypeError, ValueError):
            self._count_error()
            return False
        with self._lock:
            try:
                with open(self.log_path, "a", encoding="utf-8") as f:
                    f.write(line)
                    f.flush()
                self.recorded += 1
                return True
            except OSError:
                self.record_errors += 1
                return False

    # ------------------------------------------------------------------
    # transitions (called by the sentinel OUTSIDE its state lock)
    # ------------------------------------------------------------------

    def record_fired(self, incident: dict, rule: dict,
                     evidence_window: Sequence[Tuple[float, object]],
                     ring: Sequence[Tuple[float, dict]]) -> Optional[str]:
        """Capture the bundle for a newly FIRING incident; returns the
        bundle dir (or None on failure). ``ring`` is the sentinel's
        flight-recorder snapshot ring, oldest → newest."""
        self._append({"event": "fired", **incident})
        bundle_dir = os.path.join(self.dir, incident["id"])
        try:
            os.makedirs(bundle_dir, exist_ok=True)
        except OSError:
            self._count_error()
            return None
        recent = list(ring)[-self.ring_keep:]
        bundle = {
            "incident": incident,
            "rule": rule,
            # The values the rule actually judged, stamped in the
            # sentinel's clock domain (virtual seconds under the
            # scenario harness).
            "evidence_window": [{"t": round(t, 6), "value": v}
                                for t, v in evidence_window],
            "ring": {
                "snapshots": len(recent),
                "span_s": (round(recent[-1][0] - recent[0][0], 6)
                           if len(recent) > 1 else 0.0),
                "deltas": (metric_deltas(recent[0][1], recent[-1][1])
                           if len(recent) > 1 else {}),
            },
            "health": recent[-1][1] if recent else None,
            "chains": implicated_chains(self.rowtrace),
        }
        if not atomic_write_json(os.path.join(bundle_dir, "bundle.json"),
                                 bundle):
            self._count_error()
            log.warning("incident bundle write failed: %s", bundle_dir)
            return None
        return bundle_dir

    def record_resolved(self, incident: dict,
                        ring: Sequence[Tuple[float, dict]]) -> None:
        """Log the resolution and publish ``resolution.json`` beside the
        (immutable) firing bundle."""
        self._append({"event": "resolved", **incident})
        bundle_dir = os.path.join(self.dir, incident["id"])
        if os.path.isdir(bundle_dir):
            recent = list(ring)[-self.ring_keep:]
            atomic_write_json(os.path.join(bundle_dir, "resolution.json"), {
                "incident": incident,
                "health": recent[-1][1] if recent else None,
            })

    def record_scale(self, decision: dict,
                     evidence_window: Sequence[Tuple[float, object]] = ()
                     ) -> bool:
        """One autoscale decision (fleet/autoscale/) on the SAME
        append-only timeline the alert transitions use, with the evidence
        the policy judged — "why did the fleet grow at 3am" reads next to
        the alert that caused it, in one ``incidents.jsonl``."""
        return self._append({
            "event": "scale", **decision,
            "evidence_window": [{"t": round(t, 6), "value": v}
                                for t, v in evidence_window]})

    def snapshot(self) -> dict:
        with self._lock:
            return {"dir": self.dir, "recorded": self.recorded,
                    "errors": self.record_errors}
