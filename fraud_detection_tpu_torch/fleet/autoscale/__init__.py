"""Closed-loop autoscaling: the fleet sizes itself from its own signals —
twin of ``fraud_detection_tpu/fleet/autoscale``.

The elasticity subsystem: a
:class:`~fraud_detection_tpu_torch.fleet.autoscale.policy.ScalePolicy` maps the
sentinel signal plane to desired capacity (hysteresis, cooldown, min/max
bounds; replace > burn-scale-out > idle-scale-in), an
:class:`~fraud_detection_tpu_torch.fleet.autoscale.controller.Autoscaler` runs
it on the fleet monitor tick and actuates through the
:class:`~fraud_detection_tpu_torch.fleet.autoscale.provisioner.WorkerProvisioner`
seam (thread workers in-process; a declared contract for cross-host
bootstrap). Scale-in is a coordinator-requested VOLUNTARY LEAVE on the
existing revoke→drain→commit→reassign barrier, so a scale-in drains and
commits every in-flight batch before its partitions move.
"""

from fraud_detection_tpu_torch.fleet.autoscale.controller import Autoscaler
from fraud_detection_tpu_torch.fleet.autoscale.policy import (ScaleDecision,
                                                        ScalePolicy)
from fraud_detection_tpu_torch.fleet.autoscale.provisioner import (
    ThreadProvisioner, WorkerProvisioner)

__all__ = ["Autoscaler", "ScaleDecision", "ScalePolicy",
           "ThreadProvisioner", "WorkerProvisioner"]
