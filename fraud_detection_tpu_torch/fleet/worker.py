"""FleetWorker: one engine incarnation chain under a partition lease — twin
of ``fraud_detection_tpu/fleet/worker.py``.

A fleet worker owns the worker-side half of the rebalance protocol: it joins the coordinator, consumes EXACTLY its leased
partitions through the broker's manual-assignment mode, heartbeats on the
poll path, publishes its health + local backlog on the fleet bus, and —
when a sync shows its lease changed — stops the current engine incarnation,
lets the engine's own shutdown path drain and commit every in-flight batch,
closes the consumer, ACKs the release barrier, and rebuilds on the new
lease. Worker death (the chaos harness's :class:`WorkerKilled`, or any
crash) propagates out of the poll path *before* a new batch dispatches, so
the dead incarnation leaves nothing produced-but-uncommitted: the
partitions' next owner resumes from the committed offsets with zero loss
and zero duplicates.

Threading: ``run()`` is the worker thread's single entry (one engine
per worker — the engine's own drive region guards it); ``stop()`` and
``result()`` are the cross-thread surface (lock-free latch + snapshot,
mirroring the engine's contract).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from fraud_detection_tpu_torch.stream.engine import StreamStats, _merge_stats
from fraud_detection_tpu_torch.stream.faults import WorkerKilled
from fraud_detection_tpu_torch.utils.racecheck import ExclusiveRegion


class _FleetConsumer:
    """Consumer wrapper riding the worker's poll path: fires the seeded
    death plan, heartbeats the coordinator lease, and publishes the bus doc
    on a time cadence — all on the engine's own thread, so the lease stays
    exactly as live as the worker's actual consumption (Kafka's
    poll-is-liveness model)."""

    def __init__(self, inner, worker: "FleetWorker"):
        self.inner = inner
        self._worker = worker

    def poll(self, timeout: float = 1.0):
        self._worker._on_poll(self.inner)
        return self.inner.poll(timeout)

    def poll_batch(self, max_messages: int, timeout: float):
        self._worker._on_poll(self.inner)
        return self.inner.poll_batch(max_messages, timeout)

    def commit(self) -> None:
        self.inner.commit()

    def commit_offsets(self, offsets) -> None:
        self.inner.commit_offsets(offsets)

    def backlog(self) -> int:
        return self.inner.backlog()

    def close(self) -> None:
        self.inner.close()

    def __getattr__(self, name):
        return getattr(self.inner, name)


class FleetWorker:
    """One fleet member: lease -> consumer -> engine, rebuilt per rebalance."""

    def __init__(self, worker_id: str, coordinator, bus,
                 make_engine: Callable, make_consumer: Callable, *,
                 death_plan=None, heartbeat_interval: float = 0.2,
                 rowtrace=None, sentinel=None, clock=time.monotonic):
        if heartbeat_interval <= 0:
            raise ValueError(
                f"heartbeat_interval must be > 0, got {heartbeat_interval}")
        self.worker_id = worker_id
        self.coordinator = coordinator
        self.bus = bus
        # make_consumer(lease) -> broker consumer over lease.partitions;
        # make_engine(consumer, worker_id) -> StreamingClassifier.
        self.make_engine = make_engine
        self.make_consumer = make_consumer
        self.death_plan = death_plan
        self.heartbeat_interval = heartbeat_interval
        # Optional obs.trace.RowTracer shared by this worker's engine
        # incarnations (Fleet wires the SAME tracer into make_engine):
        # every bus publish then carries the worker's per-stage sketch
        # wires, which the coordinator merges losslessly into fleet-level
        # p50/p99 per stage.
        self.rowtrace = rowtrace
        # Optional obs.sentinel.Sentinel watching THIS worker's engine
        # health: evaluated on the poll path at heartbeat cadence (the
        # same rate-limit gate as the coordinator sync), its alert state
        # rides every bus doc so the coordinator's tick aggregates
        # fleet-wide firing counts.
        self.sentinel = sentinel
        self._clock = clock
        self.stats = StreamStats()
        self.incarnations = 0
        self.death: Optional[WorkerKilled] = None
        self.error: Optional[BaseException] = None
        self._lease = None
        self._engine = None
        self._stopped = False
        self._last_sync = 0.0
        # One thread drives a worker's incarnation chain by contract —
        # stop()/result()/health() are the cross-thread surface. The region
        # turns a second concurrent run() into a RaceError instead of
        # silently interleaving two engines on one lease.
        self._region = ExclusiveRegion("FleetWorker.run")

    # ------------------------------------------------------------------
    # cross-thread surface
    # ------------------------------------------------------------------

    def stop(self) -> None:
        """Request shutdown (lock-free latch, same contract as the
        engine's): the current incarnation drains + commits and the worker
        leaves the fleet gracefully."""
        self._stopped = True    # flightcheck: ignore[FC102] — documented lock-free latch
        engine = self._engine
        if engine is not None:
            engine.stop()

    def result(self) -> dict:
        """Cross-thread progress snapshot (racy reads of monotonic state)."""
        return {
            "worker_id": self.worker_id,
            "processed": self.stats.processed,
            "incarnations": self.incarnations,
            "dead": None if self.death is None else self.death.mode,
            "error": repr(self.error) if self.error is not None else None,
        }

    def health(self) -> Optional[dict]:
        """The live incarnation's engine health (None between engines)."""
        engine = self._engine
        return engine.health() if engine is not None else None

    # ------------------------------------------------------------------
    # worker thread
    # ------------------------------------------------------------------

    def _on_poll(self, consumer) -> None:
        """Per-poll hook on the engine's thread: death plan, heartbeat,
        bus publish, rebalance detection (stops the engine so the outer
        loop rebuilds on the new lease)."""
        if self.death_plan is not None:
            self.death_plan.tick(self.worker_id)    # raises WorkerKilled
        now = self._clock()
        if now - self._last_sync < self.heartbeat_interval:
            return
        self._last_sync = now
        if self.sentinel is not None:
            # Heartbeat-cadence evaluation on the engine's thread, BEFORE
            # the publish below, so the bus doc carries this pass's state.
            self.sentinel.evaluate()
        lease = self.coordinator.sync(self.worker_id)
        self._publish(consumer)
        cur = self._lease
        if cur is not None and lease.generation != cur.generation:
            if (set(lease.partitions) != set(cur.partitions)
                    or lease.pending or lease.released):
                # Our ownership changed (or partitions are waiting on a
                # peer's drain): end this incarnation. The engine's
                # shutdown path drains + commits in-flight batches; the
                # outer loop then acks and rebuilds — the worker half of
                # revoke->drain->commit->reassign.
                engine = self._engine
                if engine is not None:
                    engine.stop()
            else:
                # Uninvolved survivor: same partitions, new generation —
                # keep running (sticky assignment's whole point).
                self._lease = lease

    def _publish(self, consumer, engine_health: Optional[dict] = None) -> None:
        if self.bus is None:
            return
        lease = self._lease
        try:
            backlog = consumer.backlog() if consumer is not None else None
        except Exception:  # noqa: BLE001 — observability must not kill serving
            backlog = None
        if engine_health is None:
            engine = self._engine
            engine_health = engine.health() if engine is not None else None
        self.bus.publish(self.worker_id, {
            "worker_id": self.worker_id,
            "generation": lease.generation if lease is not None else None,
            "partitions": ([list(p) for p in lease.partitions]
                           if lease is not None else []),
            "backlog": backlog,
            "dead": None if self.death is None else self.death.mode,
            "engine": engine_health,
            # Lossless per-stage sketch wires for the coordinator's
            # fleet-level stage-latency merge (None when not tracing).
            "obs": ({"stages": self.rowtrace.stages_wire()}
                    if self.rowtrace is not None else None),
            # This worker's alert state (obs/sentinel/): the compact
            # subset the coordinator aggregates — full incident history
            # stays in the worker's own health()["alerts"] block.
            "alerts": (self._alerts_doc()
                       if self.sentinel is not None else None),
        })

    def _alerts_doc(self) -> dict:
        snap = self.sentinel.snapshot()
        return {"firing": snap["firing"],
                "critical_firing": snap["critical_firing"],
                "fired": snap["fired"],
                "resolved": snap["resolved"]}

    def run(self, idle_timeout: Optional[float] = None) -> StreamStats:
        """Drive engine incarnations until stopped, killed, or — when
        ``idle_timeout`` is set (drain runs) — the input is idle AND the
        fleet's committed lag is clear (a dead peer's unreassigned backlog
        keeps survivors alive until its lease expires and the partitions
        reach them)."""
        with self._region:
            return self._run(idle_timeout)

    def _run(self, idle_timeout: Optional[float]) -> StreamStats:
        lease = self.coordinator.join(self.worker_id)
        if self.death_plan is not None:
            self.death_plan.arm(self.worker_id)
        graceful_exit = False
        try:
            while not self._stopped:
                self._lease = lease
                inner = self.make_consumer(lease)
                engine = self._engine = self.make_engine(
                    _FleetConsumer(inner, self), self.worker_id)
                self.incarnations += 1
                try:
                    stats = engine.run(idle_timeout=idle_timeout)
                except WorkerKilled as e:
                    # Seeded whole-worker death: nothing produced past the
                    # last commit (the kill fires at poll time and the
                    # engine's abort path discards unproduced in-flight
                    # batches). Graceful deaths release the lease NOW;
                    # crashes just vanish and the lease must expire.
                    self.death = e
                    _merge_stats(self.stats, engine.stats)
                    self._publish(None, engine_health=engine.health())
                    return self.stats
                finally:
                    inner.close()
                _merge_stats(self.stats, stats)
                # Incarnation fully drained + committed: release anything
                # the last rebalance revoked from us.
                lease = self.coordinator.ack(self.worker_id)
                if lease.released:
                    # Coordinator-requested voluntary leave (scale-in,
                    # fleet/autoscale/): the engine shutdown above drained
                    # + committed everything, the ack dropped our barrier
                    # holds — exit so the finally block leaves the fleet
                    # and retracts our bus doc (drain before release).
                    graceful_exit = True
                    break
                if self._stopped:
                    graceful_exit = True
                    break
                if (lease.generation != (self._lease.generation
                                         if self._lease else -1)
                        and (set(lease.partitions)
                             != set(self._lease.partitions)
                             or lease.pending)):
                    continue    # rebuild on the changed lease
                if idle_timeout is None:
                    continue    # serve-forever: only stop()/death end us
                lag = self.coordinator.committed_lag()
                if lag is None or lag <= 0:
                    graceful_exit = True
                    break
                # Input looks idle from OUR partitions but the fleet still
                # owes committed work (e.g. a dead peer's partitions are
                # waiting out their lease): stay up, poll again.
            else:
                graceful_exit = True
        except BaseException as e:  # noqa: BLE001 — surfaced via result()
            self.error = e
            engine = self._engine
            if engine is not None:
                _merge_stats(self.stats, engine.stats)
            raise
        finally:
            self._engine = None
            if self.death is None:
                # Normal/stop()/error exits all drained via the engine's
                # own shutdown path — leave gracefully so partitions
                # reassign immediately instead of waiting out the ttl.
                self.coordinator.leave(self.worker_id)
                self._publish(None)
                if graceful_exit and self.bus is not None:
                    self.bus.retract(self.worker_id)
            elif self.death.mode == "graceful":
                self.coordinator.leave(self.worker_id)
        return self.stats
