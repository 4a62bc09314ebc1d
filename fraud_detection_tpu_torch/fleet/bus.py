"""The fleet bus: where workers publish health and the coordinator answers
— twin of ``fraud_detection_tpu/fleet/bus.py``, with the same file names and
JSON, so a bus directory written by one package reads back in the other.

One small shared surface with two transports behind one API:

* **in-process** (always on): a dict under a lock. Worker threads publish
  their engine ``health()`` snapshots; the coordinator reads them all on
  each tick and publishes the aggregated fleet view back.
* **file-backed** (``dir=``): every publish ALSO lands as an atomic JSON
  file (``worker-<id>.json`` / ``fleet.json``) in the bus directory, and
  ``snapshots()`` merges files written by OTHER processes. That is what
  lets N serve processes on one host share a single fleet view — and what
  lets an operator ``cat`` the live fleet state — without this module
  growing a network dependency.

Reads tolerate torn/corrupt files (atomic replace makes them rare; a
concurrent writer mid-rename reads as "keep the last good value"). All
values are monitoring samples, racy by design, exactly like ``health()``
itself.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

from fraud_detection_tpu_torch.utils.atomicio import atomic_write_json

_FLEET_FILE = "fleet.json"
_WORKER_PREFIX = "worker-"


class FleetBus:
    """Shared health/fleet-view blackboard (see module docstring).

    Thread-safe: workers publish and the coordinator reads/aggregates
    concurrently; everything shared sits under one lock and file writes
    are atomic replaces."""

    def __init__(self, dir: Optional[str] = None, *, clock=time.time):
        self.dir = dir
        self._clock = clock
        self._lock = threading.Lock()
        self._local: Dict[str, dict] = {}     # worker_id -> entry
        self._fleet: Optional[dict] = None    # coordinator's aggregate
        if dir is not None:
            os.makedirs(dir, exist_ok=True)

    # ------------------------------------------------------------------
    # worker side
    # ------------------------------------------------------------------

    def publish(self, worker_id: str, health: dict) -> None:
        """Publish one worker's health snapshot (last write wins)."""
        entry = {"time": self._clock(), "worker": worker_id, "health": health}
        with self._lock:
            self._local[worker_id] = entry
        if self.dir is not None:
            self._write(f"{_WORKER_PREFIX}{worker_id}.json", entry)

    def retract(self, worker_id: str) -> None:
        """Remove a departed worker's snapshot (its file too, so stale
        processes don't haunt the fleet view)."""
        with self._lock:
            self._local.pop(worker_id, None)
        if self.dir is not None:
            try:
                os.unlink(os.path.join(
                    self.dir, f"{_WORKER_PREFIX}{worker_id}.json"))
            except OSError:
                pass

    # ------------------------------------------------------------------
    # coordinator side
    # ------------------------------------------------------------------

    def snapshots(self) -> Dict[str, dict]:
        """All published worker entries, local + (when file-backed) those
        of other processes sharing the directory. Local entries win for
        ids published by this process — they are fresher by construction."""
        merged: Dict[str, dict] = {}
        if self.dir is not None:
            try:
                names = os.listdir(self.dir)
            except OSError:
                names = []
            for name in names:
                if not (name.startswith(_WORKER_PREFIX)
                        and name.endswith(".json")):
                    continue
                entry = self._read(name)
                if entry is not None and "worker" in entry:
                    merged[entry["worker"]] = entry
        with self._lock:
            merged.update(self._local)
        return merged

    def publish_fleet(self, view: dict) -> None:
        """Publish the coordinator's aggregated fleet view (membership, generation, global backlog watermark, shed totals)."""
        with self._lock:
            self._fleet = view
        if self.dir is not None:
            self._write(_FLEET_FILE, view)

    def fleet_view(self) -> Optional[dict]:
        """The last published fleet view (workers read the global backlog
        watermark from here); falls back to the file for processes that
        only observe. None until the first coordinator tick."""
        with self._lock:
            if self._fleet is not None:
                return self._fleet
        if self.dir is not None:
            return self._read(_FLEET_FILE)
        return None

    # ------------------------------------------------------------------
    # file transport
    # ------------------------------------------------------------------

    def _write(self, name: str, obj: dict) -> None:
        # Shared atomic writer (utils/atomicio.py): unique temp names mean
        # two processes publishing the same worker id (a stale twin after
        # a botched restart) can interleave without tearing the file —
        # the old fixed ".tmp" name here could. Failures swallowed: bus
        # publishing must never kill serving.
        atomic_write_json(os.path.join(self.dir, name), obj)

    def _read(self, name: str) -> Optional[dict]:
        try:
            with open(os.path.join(self.dir, name)) as f:
                obj = json.load(f)
            return obj if isinstance(obj, dict) else None
        except (OSError, ValueError):
            return None
