"""Fleet serving lane: partition-owning workers behind one coordinator —
twin of ``fraud_detection_tpu/fleet``.

The scale-out layer over the streaming engine: workers own
explicit partition leases (stream/broker.py manual-assignment consumers),
a coordinator rebalances them with a revoke->drain->commit->reassign
barrier on membership change and lease expiry on worker death, health
flows over an in-process/file-backed bus, and load shedding coordinates on
the GLOBAL backlog watermark instead of per-worker guesses. The
coordinator itself is a leased role (fleet/control.py): candidates
contend on it over a faultable control bus and a successor inherits the
assignment state — including in-flight revoke-barrier holds — so the
fleet survives its own brain dying. On top of both, the fleet sizes
ITSELF (fleet/autoscale/): a scale policy turns the
sentinel signal plane into grow/replace/shrink decisions, with scale-in
as a coordinator-requested voluntary leave on the same revoke barrier.

Every worker drives the ONE shared ``ServingPipeline``: on the card, N worker
threads dispatch chunks (and, under device featurize, ``featurize_packed``
launches) onto it at once.
"""

from fraud_detection_tpu_torch.fleet.autoscale import (Autoscaler, ScaleDecision,
                                                 ScalePolicy,
                                                 ThreadProvisioner,
                                                 WorkerProvisioner)
from fraud_detection_tpu_torch.fleet.bus import FleetBus
from fraud_detection_tpu_torch.fleet.control import (ControlBus, ControlRecord,
                                               KafkaControlBus,
                                               SuccessionCoordinator,
                                               TermGate)
from fraud_detection_tpu_torch.fleet.coordinator import FleetCoordinator, Lease
from fraud_detection_tpu_torch.fleet.fleet import Fleet
from fraud_detection_tpu_torch.fleet.worker import FleetWorker

__all__ = ["Autoscaler", "ControlBus", "ControlRecord", "Fleet", "FleetBus",
           "FleetCoordinator", "FleetWorker", "KafkaControlBus", "Lease",
           "ScaleDecision", "ScalePolicy", "SuccessionCoordinator",
           "TermGate", "ThreadProvisioner", "WorkerProvisioner"]
