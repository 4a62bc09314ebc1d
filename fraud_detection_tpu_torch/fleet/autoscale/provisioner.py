"""Worker provisioner: the seam between sizing decisions and machinery —
twin of ``fraud_detection_tpu/fleet/autoscale/provisioner.py``.

The autoscaler decides *that* the fleet needs a worker; a
:class:`WorkerProvisioner` decides *how* one comes to exist. The contract
is deliberately thin so the same
controller drives in-process thread workers today and a cross-host
bootstrap (a container scheduler, an instance group) tomorrow:

* ``launch(worker_id)`` — begin bringing up a worker that will ``join``
  the coordinator under exactly ``worker_id``. Returns True when the
  launch was ACCEPTED (not when the worker is up — joining is observed
  through the coordinator's membership view, never assumed). Must be
  refusable: returning False is the provisioner's veto (shutting down,
  out of capacity) and the controller counts it as a denied decision.
* ``launch`` must be idempotent per ``worker_id`` — the controller may
  retry an id it never saw join.
* Scale-IN needs no provisioner verb: the coordinator's
  ``request_release`` rides the existing revoke→drain→commit→reassign
  barrier and the worker dismantles itself (fleet/worker.py).

:class:`ThreadProvisioner` is the in-process implementation: it delegates
to a spawn callable (``Fleet._spawn_worker``) that builds a FleetWorker
and starts its thread inside the fleet's own registry, so scaled-out
workers are first-class members — stats merge, health file, join loop.
"""

from __future__ import annotations

import threading
from typing import Callable, List


class WorkerProvisioner:
    """Abstract seam (module docstring pins the contract)."""

    #: Human-readable transport name for the autoscale health block.
    kind = "abstract"

    def launch(self, worker_id: str) -> bool:
        raise NotImplementedError


class ThreadProvisioner(WorkerProvisioner):
    """In-process workers on threads: the configuration the tests and the
    serve CLI share. ``spawn(worker_id) -> bool`` is
    Fleet's factory+start hook; this class only adds the idempotence
    guard and the launch ledger."""

    kind = "thread"

    def __init__(self, spawn: Callable[[str], bool]):
        self._spawn = spawn
        self._lock = threading.Lock()
        self._launched: List[str] = []

    def launch(self, worker_id: str) -> bool:
        with self._lock:
            if worker_id in self._launched:
                return True         # idempotent retry: already accepted
        if not self._spawn(worker_id):
            return False
        with self._lock:
            if worker_id not in self._launched:
                self._launched.append(worker_id)
        return True

    def launched(self) -> List[str]:
        with self._lock:
            return list(self._launched)
