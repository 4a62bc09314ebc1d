"""The fleet's protocol role machines as data — the port's own copy of
``FLEET_PROTOCOLS`` (with ``ProtocolTransition``, ``RoleSpec`` and ``_t``)
from ``fraud_detection_tpu/analysis/entrypoints.py``. Anchors name
package-relative paths; the fleet modules carry the same paths in both
packages. Trace conformance (``analysis/conformance.py``) replays a
control-lane journal against the Worker and Candidate machines.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ProtocolTransition:
    """One labeled transition of a role machine.

    ``anchors`` are the code sites ("relpath::Class.method") that implement
    the transition; each anchor must exist and contain every ``calls``
    pattern (FC502). An empty ``anchors`` marks an environment transition
    (lease ttl elapsing) with no code to verify. Call patterns are dotted
    suffixes of the receiver chain as written at the call site:
    ``"coordinator.sync"`` matches ``self.coordinator.sync(...)``,
    ``"_expire_locked"`` matches ``self._expire_locked(...)``."""

    name: str
    source: str
    target: str
    anchors: Tuple[str, ...] = ()
    calls: Tuple[str, ...] = ()


@dataclass(frozen=True)
class RoleSpec:
    """One role's protocol machine (states + labeled transitions)."""

    role: str
    cls_key: Optional[str]          # "relpath::Class"; None = environment
    states: Tuple[str, ...]
    initial: str
    transitions: Tuple[ProtocolTransition, ...]

    def qualnames(self) -> Tuple[str, ...]:
        return tuple(f"{self.role}.{t.name}" for t in self.transitions)


def _t(name, source, target, anchors=(), calls=()):
    return ProtocolTransition(name, source, target, tuple(anchors),
                              tuple(calls))


FLEET_PROTOCOLS: Tuple[RoleSpec, ...] = (
    # The coordinator is a passive monitor object: its machine is the set of
    # entry points workers/monitor drive, each verified against its method
    # body (join folds renew -> expiry scan -> re-deal; the scan/deal
    # helpers are the required calls).
    RoleSpec("Coordinator", "fleet/coordinator.py::FleetCoordinator",
             ("steady",), "steady", (
        _t("join", "steady", "steady",
           ("fleet/coordinator.py::FleetCoordinator.join",),
           ("_expire_locked", "_rebalance_locked", "_lease_locked")),
        _t("sync", "steady", "steady",
           ("fleet/coordinator.py::FleetCoordinator.sync",),
           ("join",)),
        _t("ack", "steady", "steady",
           ("fleet/coordinator.py::FleetCoordinator.ack",),
           ("_lease_locked",)),
        _t("leave", "steady", "steady",
           ("fleet/coordinator.py::FleetCoordinator.leave",),
           ("_rebalance_locked",)),
        _t("fence", "steady", "steady",
           ("fleet/coordinator.py::FleetCoordinator.fence_lost",)),
        # ...and the call site wiring the fence into every fleet consumer.
        _t("fence", "steady", "steady",
           ("fleet/fleet.py::Fleet.in_process",),
           ("coordinator.fence_lost",)),
        _t("tick", "steady", "steady",
           ("fleet/coordinator.py::FleetCoordinator.tick",),
           ("_expire_locked", "_rebalance_locked")),
        # ...and the monitor-thread (plus post-run aggregate) drive sites.
        _t("tick", "steady", "steady",
           ("fleet/fleet.py::Fleet._monitor_loop", "fleet/fleet.py::Fleet.run"),
           ("coordinator.tick",)),
        # Elasticity (fleet/autoscale/, docs/autoscaling.md). scale_out:
        # the controller's policy pass decides and actuates a grow through
        # the provisioner seam — the coordinator's half is the eventual
        # join, already modeled above.
        _t("scale_out", "steady", "steady",
           ("fleet/autoscale/controller.py::Autoscaler.step",),
           ("policy.decide", "_actuate")),
        # scale_in: a coordinator-requested VOLUNTARY LEAVE. The member is
        # marked released and the re-deal moves its pairs behind the
        # existing revoke barrier (`flightcheck model --autoscale`;
        # mutation release_before_drain is the counterexample).
        _t("scale_in", "steady", "steady",
           ("fleet/coordinator.py::FleetCoordinator.request_release",),
           ("_rebalance_locked",)),
        # ...and the call sites that request it: the controller's victim
        # walk, and the succession wrapper's leader-fenced relay (an
        # interregnum refuses — granting from the lease cache could
        # shrink a fleet the successor's replayed state still needs).
        _t("scale_in", "steady", "steady",
           ("fleet/autoscale/controller.py::Autoscaler._release_one",
            "fleet/control.py::SuccessionCoordinator.request_release"),
           ("coordinator.request_release",)),
    )),
    # The worker half of revoke->drain->commit->reassign: one engine
    # incarnation chain per lease, heartbeat-on-poll, crash transitions
    # from the seeded WorkerDeathPlan.
    RoleSpec("Worker", "fleet/worker.py::FleetWorker",
             ("init", "running", "draining", "crashed", "left"), "init", (
        _t("join", "init", "running",
           ("fleet/worker.py::FleetWorker._run",),
           ("coordinator.join",)),
        _t("sync", "running", "running",
           ("fleet/worker.py::FleetWorker._on_poll",),
           ("coordinator.sync",)),
        # lease changed (or pairs withheld): stop the engine, drain
        _t("sync", "running", "draining",
           ("fleet/worker.py::FleetWorker._on_poll",),
           ("engine.stop",)),
        _t("poll", "running", "running",
           ("fleet/worker.py::_FleetConsumer.poll_batch",),
           ("_on_poll", "inner.poll_batch")),
        _t("commit", "running", "running",
           ("fleet/worker.py::_FleetConsumer.commit_offsets",),
           ("inner.commit_offsets",)),
        # the engine's shutdown path drains + commits in-flight batches
        _t("commit", "draining", "draining",
           ("fleet/worker.py::FleetWorker._run",),
           ("engine.run",)),
        _t("ack", "draining", "running",
           ("fleet/worker.py::FleetWorker._run",),
           ("coordinator.ack",)),
        _t("leave", "running", "left",
           ("fleet/worker.py::FleetWorker._run",),
           ("coordinator.leave", "coordinator.committed_lag")),
        _t("crash", "running", "crashed",
           ("fleet/worker.py::FleetWorker._on_poll",),
           ("death_plan.tick",)),
        _t("crash", "draining", "crashed",
           ("fleet/worker.py::FleetWorker._on_poll",),
           ("death_plan.tick",)),
        # Voluntary leave (scale-in): the ack that releases the revoke
        # barrier returns a lease marked released; the worker has already
        # drained + committed, so it exits through the graceful-leave
        # path (docs/autoscaling.md "Drain before release").
        _t("release", "draining", "left",
           ("fleet/worker.py::FleetWorker._run",),
           ("coordinator.ack", "coordinator.leave")),
    )),
    # The transport's manual-assignment consumer: committed-offset resume at
    # construction, fence consulted at commit time.
    RoleSpec("AssignedConsumer", "stream/broker.py::InProcessAssignedConsumer",
             ("consuming", "closed"), "consuming", (
        _t("resume", "consuming", "consuming",
           ("stream/broker.py::InProcessAssignedConsumer.__init__",)),
        _t("poll", "consuming", "consuming",
           ("stream/broker.py::InProcessAssignedConsumer.poll_batch",),
           ("poll",)),
        _t("commit", "consuming", "consuming",
           ("stream/broker.py::InProcessAssignedConsumer._commit_locked",),
           ("fence",)),
        _t("close", "consuming", "closed",
           ("stream/broker.py::InProcessAssignedConsumer.close",)),
    )),
    # The blackboard: workers publish, the coordinator aggregates per tick.
    RoleSpec("Bus", "fleet/bus.py::FleetBus", ("steady",), "steady", (
        _t("publish", "steady", "steady",
           ("fleet/worker.py::FleetWorker._publish",),
           ("bus.publish",)),
        _t("retract", "steady", "steady",
           ("fleet/worker.py::FleetWorker._run",),
           ("bus.retract",)),
        _t("aggregate", "steady", "steady",
           ("fleet/coordinator.py::FleetCoordinator.tick",),
           ("bus.snapshots", "bus.publish_fleet")),
    )),
    # Worker provisioner (fleet/autoscale/provisioner.py,
    # docs/autoscaling.md "Provisioner seam"): launch() ACCEPTS a bring-up
    # (idempotent per id, refusable); the worker's existence is only ever
    # observed through the coordinator's membership view. The checker's
    # `scale_out` macro-step IS this machine: an unprovisioned spare flips
    # to joinable and arrives through the ordinary join path.
    RoleSpec("Provisioner", "fleet/autoscale/provisioner.py::ThreadProvisioner",
             ("ready",), "ready", (
        _t("launch", "ready", "ready",
           ("fleet/autoscale/provisioner.py::ThreadProvisioner.launch",),
           ("_spawn",)),
        # ...the controller's actuation site and the in-process spawn
        # hook that builds + starts the worker inside Fleet's registry.
        _t("launch", "ready", "ready",
           ("fleet/autoscale/controller.py::Autoscaler._actuate",),
           ("provisioner.launch",)),
        _t("launch", "ready", "ready",
           ("fleet/fleet.py::Fleet._spawn_worker",),
           ("thread.start",)),
    )),
    # Coordinator succession (fleet/control.py, docs/fleet.md "Coordinator
    # succession"): the coordinator ROLE as a leased machine. Candidates
    # stand by, win term elections into leadership, relay the worker
    # surface to the incumbent coordinator they incarnate while leading,
    # and fall back to standby (zombie demotion on a newer term) or dead
    # (seeded kill). The `flightcheck model --succession` configuration
    # explores exactly this machine — the Candidate.* qualnames below are
    # the checker's ACTION_IMPLEMENTS vocabulary (analysis/checker.py).
    RoleSpec("Candidate", "fleet/control.py::SuccessionCoordinator",
             ("standby", "leading", "dead"), "standby", (
        # Win the vacancy: strictly-greater term CAS, then replay the
        # compacted control topic and reconstruct the coordinator.
        _t("elect", "standby", "leading",
           ("fleet/control.py::SuccessionCoordinator._elect",),
           ("gate.try_advance", "control.replay", "_reconstruct")),
        # State reconstruction: snapshot restore plus replay of the ops
        # past its watermark drives the fresh incumbent through the REAL
        # worker surface (the successor inherits barrier holds — see the
        # restore-inherits-holds obligation below).
        _t("restore", "standby", "leading",
           ("fleet/control.py::SuccessionCoordinator._reconstruct",),
           ("coordinator.join", "coordinator.ack", "coordinator.leave")),
        # Leading: every worker-surface call relays to the incumbent.
        _t("lead", "leading", "leading",
           ("fleet/control.py::SuccessionCoordinator.join",),
           ("coordinator.join",)),
        _t("lead", "leading", "leading",
           ("fleet/control.py::SuccessionCoordinator.sync",),
           ("coordinator.sync",)),
        _t("lead", "leading", "leading",
           ("fleet/control.py::SuccessionCoordinator.ack",),
           ("coordinator.ack",)),
        _t("lead", "leading", "leading",
           ("fleet/control.py::SuccessionCoordinator.leave",),
           ("coordinator.leave",)),
        _t("lead", "leading", "leading",
           ("fleet/control.py::SuccessionCoordinator.tick",),
           ("coordinator.tick",)),
        _t("lead", "leading", "leading",
           ("fleet/control.py::SuccessionCoordinator.committed_lag",),
           ("coordinator.committed_lag",)),
        # The stale-term fence: commit fencing relays to the incumbent
        # (and answers from the granted∪held cache during an
        # interregnum), and replay rejects snapshots from older terms.
        _t("fence", "leading", "leading",
           ("fleet/control.py::SuccessionCoordinator.fence_lost",),
           ("coordinator.fence_lost",)),
        _t("fence", "leading", "leading",
           ("fleet/control.py::ControlBus.replay",)),
        # Seeded leader death (stream/faults.py CoordinatorKillSpec).
        _t("crash", "leading", "dead",
           ("fleet/control.py::SuccessionCoordinator.tick",),
           ("kill.tick",)),
        # Role-lease lapse: a zombie leader discovers a newer term via
        # the fence and demotes itself WITHOUT publishing (see the
        # zombie-demotes-before-publish obligation below).
        _t("lapse", "leading", "standby",
           ("fleet/control.py::SuccessionCoordinator.tick",),
           ("gate.accept",)),
    )),
    # Environment: no code anchor — lease ttl elapsing is the adversary.
    RoleSpec("Environment", None, ("world",), "world", (
        _t("lapse", "world", "world"),
    )),
)
