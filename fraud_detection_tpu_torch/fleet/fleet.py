"""Fleet facade: N partition-owning workers, one coordinator, one bus — twin
of ``fraud_detection_tpu/fleet/fleet.py``.

The assembly layer the serve CLI (``--fleet N``) drives: construct the bus + coordinator, build one
:class:`~fraud_detection_tpu_torch.fleet.worker.FleetWorker` per slot, run them
on threads with a monitor thread ticking the coordinator (lease expiry,
global-backlog aggregation, optional fleet health file), and merge the
results into one stats dict. ``Fleet.in_process`` wires everything against
an :class:`~fraud_detection_tpu_torch.stream.broker.InProcessBroker` — the
manual-assignment consumers, the commit fence, the group-lag drain signal,
per-worker adaptive schedulers with the fleet backlog source — which is
the configuration the tests, ``chip_smoke.py`` and the demo CLI share. Every
worker scores on the one pipeline it is given: on the card, N threads
dispatch onto it at once.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from fraud_detection_tpu_torch.fleet.bus import FleetBus
from fraud_detection_tpu_torch.fleet.coordinator import FleetCoordinator
from fraud_detection_tpu_torch.fleet.worker import FleetWorker
from fraud_detection_tpu_torch.obs.trace import RowTracer
from fraud_detection_tpu_torch.stream.engine import StreamStats, _merge_stats
from fraud_detection_tpu_torch.utils import get_logger
from fraud_detection_tpu_torch.utils.atomicio import atomic_write_json

log = get_logger("fleet")


class Fleet:
    """N fleet workers + coordinator + monitor, run to completion or until
    ``stop()``. Build directly with factories, or via :meth:`in_process`."""

    def __init__(self, n_workers: int, make_engine: Callable,
                 make_consumer: Callable, *,
                 topics, num_partitions: int,
                 bus: Optional[FleetBus] = None,
                 lease_ttl: float = 30.0,
                 lag_fn=None,
                 death_plan=None,
                 heartbeat_interval: float = 0.2,
                 tick_interval: float = 0.2,
                 health_file: Optional[str] = None,
                 trace: bool = False,
                 trace_sample: float = 1.0,
                 trace_seed: Optional[int] = None,
                 sentinel_rules=None,
                 worker_sentinel_rules=None,
                 sentinel_clock=None,
                 sentinel_recorder=None,
                 candidates: int = 1,
                 role_ttl: Optional[float] = None,
                 coordinator_kill=None,
                 control=None,
                 autoscale=None,
                 worker_prefix: str = "w"):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        if tick_interval <= 0:
            raise ValueError(
                f"tick_interval must be > 0, got {tick_interval}")
        self.bus = bus if bus is not None else FleetBus()
        # Coordinator succession (fleet/control.py):
        # ``candidates >= 2`` (or an injected coordinator kill) replaces
        # the single FleetCoordinator with the leased-role proxy —
        # candidate threads contend on the role lease and a successor
        # reconstructs assignment state from the control bus. The plain
        # single-coordinator path is untouched otherwise.
        if candidates > 1 or coordinator_kill is not None:
            from fraud_detection_tpu_torch.fleet.control import \
                SuccessionCoordinator

            if coordinator_kill is not None \
                    and coordinator_kill.kills >= candidates:
                raise ValueError(
                    f"coordinator_kill.kills ({coordinator_kill.kills}) "
                    f"must be < candidates ({candidates}): someone has "
                    f"to survive to coordinate")
            self.coordinator = SuccessionCoordinator(
                topics, num_partitions, bus=self.bus, control=control,
                lease_ttl=lease_ttl, lag_fn=lag_fn,
                candidates=candidates, role_ttl=role_ttl,
                kill=coordinator_kill)
        else:
            self.coordinator = FleetCoordinator(
                topics, num_partitions, bus=self.bus, lease_ttl=lease_ttl,
                lag_fn=lag_fn)
        self.coordinator_kill = coordinator_kill
        # Fleet alerting (obs/sentinel/):
        # ``sentinel_rules`` arms a COORDINATOR-level sentinel over the
        # aggregated fleet view (global watermark burn, worker absence,
        # worker-alert roll-up), evaluated once per monitor tick right
        # after the coordinator aggregates; per-worker sentinels (the
        # default engine pack unless ``worker_sentinel_rules`` overrides)
        # watch each worker's own engine health on the poll path and ride
        # the bus, which is what the roll-up aggregates. ``sentinel_clock``
        # injects the stamp domain (virtual time in tests); None = process
        # monotonic.
        self.sentinel = None
        self.worker_sentinels: dict = {}
        self._spawn_worker_rules = None     # per-worker pack for scale-outs
        if sentinel_rules is not None:
            from fraud_detection_tpu_torch.obs.sentinel import (Sentinel,
                                                          default_rule_pack)

            kw = {} if sentinel_clock is None else {"clock": sentinel_clock}
            self.sentinel = Sentinel(
                lambda: {"fleet": self.coordinator.last_view() or {}},
                sentinel_rules, worker="fleet",
                recorder=sentinel_recorder, **kw)
            worker_rules = (worker_sentinel_rules
                            if worker_sentinel_rules is not None
                            else default_rule_pack(
                                fast_s=2.0, slow_s=8.0, resolve_s=1.0,
                                p99_ms=60000.0, stall_s=30.0))
            if worker_rules:
                self._spawn_worker_rules = worker_rules
                holder = self.worker_sentinels
                for i in range(n_workers):
                    wid = f"{worker_prefix}{i}"

                    def source(w=wid):
                        worker = self._worker_by_id.get(w)
                        return worker.health() if worker is not None else None

                    holder[wid] = Sentinel(source, worker_rules,
                                           worker=wid, **kw)
        self.death_plan = death_plan
        self.tick_interval = tick_interval
        self.health_file = health_file
        # Saved factory wiring so the autoscaler's provisioner can build
        # workers AFTER construction exactly the way __init__ does.
        self._make_engine = make_engine
        self._make_consumer = make_consumer
        self.heartbeat_interval = heartbeat_interval
        self.worker_prefix = worker_prefix
        self._trace = trace
        self._trace_sample = trace_sample
        self._trace_seed = trace_seed
        self._sentinel_kw = ({} if sentinel_clock is None
                             else {"clock": sentinel_clock})
        self._idle_timeout: Optional[float] = None
        # Row tracing: one RowTracer per worker,
        # shared across that worker's engine incarnations — make_engine
        # factories look it up via ``tracers`` (Fleet.in_process wires it
        # automatically) and the workers publish stage-sketch wires on
        # the bus for the coordinator's fleet-level merge.
        self.tracers = ({f"{worker_prefix}{i}": RowTracer(
                            worker=f"{worker_prefix}{i}",
                            sample=trace_sample, seed=trace_seed)
                         for i in range(n_workers)} if trace else {})
        self.workers: List[FleetWorker] = [
            FleetWorker(f"{worker_prefix}{i}", self.coordinator, self.bus,
                        make_engine,
                        self._make_consumer,
                        death_plan=death_plan,
                        heartbeat_interval=heartbeat_interval,
                        rowtrace=self.tracers.get(f"{worker_prefix}{i}"),
                        sentinel=self.worker_sentinels.get(
                            f"{worker_prefix}{i}"))
            for i in range(n_workers)]
        self._worker_by_id = {w.worker_id: w for w in self.workers}
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # Registry lock for DYNAMIC membership (fleet/autoscale/): the
        # monitor thread appends scaled-out workers/threads while run()'s
        # join loop and health snapshots iterate — every reader takes a
        # snapshot under this lock, every writer appends under it.
        self._registry = threading.Lock()
        # Closed-loop elasticity: a ScalePolicy (or
        # its kwargs as a dict) arms the Autoscaler on the monitor tick —
        # sentinel signals in, provisioner launches / voluntary-leave
        # releases out, every decision term-stamped on the control lane.
        self.autoscaler = None
        if autoscale is not None:
            from fraud_detection_tpu_torch.fleet.autoscale import (
                Autoscaler, ScalePolicy, ThreadProvisioner)

            policy = (autoscale if isinstance(autoscale, ScalePolicy)
                      else ScalePolicy(**dict(autoscale)))
            sentinel = self.sentinel
            if sentinel is not None:
                # Share the fleet sentinel's clock domain WITHOUT
                # advancing it: decisions are stamped at the evaluation that
                # produced their signals.
                scale_clock = lambda: sentinel.last_eval_at() or 0.0  # noqa: E731
                firing = sentinel.firing
            else:
                # Signal-less elasticity still replaces dead capacity.
                scale_clock = time.monotonic
                firing = None
            self.autoscaler = Autoscaler(
                policy, ThreadProvisioner(self._spawn_worker),
                self.coordinator, initial_workers=n_workers,
                firing=firing,
                # Decisions ride the SAME control lane succession uses
                # (the proxy owns one even when none was injected), so a
                # successor inherits the sizing history.
                control=(control if control is not None
                         else getattr(self.coordinator, "control", None)),
                recorder=sentinel_recorder,
                clock=scale_clock, worker_prefix=worker_prefix)
            self.coordinator.autoscale_stats = self.autoscaler.stats

    def _spawn_worker(self, worker_id: str) -> bool:
        """ThreadProvisioner's spawn hook (fleet/autoscale/): build one
        more FleetWorker exactly the way __init__ does — same factories,
        its own tracer and sentinel — register it, and start its thread.
        Runs on the monitor thread; refuses once shutdown began (a
        scale-out must never outlive ``stop()``)."""
        if self._stop.is_set():
            return False
        with self._registry:
            if worker_id in self._worker_by_id:
                return True     # idempotent retry: already provisioned
            if self._trace:
                self.tracers[worker_id] = RowTracer(
                    worker=worker_id, sample=self._trace_sample,
                    seed=self._trace_seed)
            if self._spawn_worker_rules:
                from fraud_detection_tpu_torch.obs.sentinel import Sentinel

                def source(w=worker_id):
                    worker = self._worker_by_id.get(w)
                    return worker.health() if worker is not None else None

                self.worker_sentinels[worker_id] = Sentinel(
                    source, self._spawn_worker_rules, worker=worker_id,
                    **self._sentinel_kw)
            worker = FleetWorker(
                worker_id, self.coordinator, self.bus, self._make_engine,
                self._make_consumer, death_plan=self.death_plan,
                heartbeat_interval=self.heartbeat_interval,
                rowtrace=self.tracers.get(worker_id),
                sentinel=self.worker_sentinels.get(worker_id))
            self.workers.append(worker)
            self._worker_by_id[worker_id] = worker
            thread = threading.Thread(
                target=self._worker_main, args=(worker, self._idle_timeout),
                name=f"fleet-{worker_id}", daemon=True)
            self._threads.append(thread)
        thread.start()
        log.info("fleet scaled out: %s provisioned", worker_id)
        return True

    # ------------------------------------------------------------------
    # in-process wiring (tests / chip_smoke.py / demo CLI)
    # ------------------------------------------------------------------

    @classmethod
    def in_process(cls, broker, pipeline, input_topic: str,
                   output_topic: str, n_workers: int, *,
                   group_id: str = "fleet",
                   batch_size: int = 1024,
                   max_wait: float = 0.02,
                   pipeline_depth: int = 2,
                   async_dispatch: bool = False,
                   sched_config=None,
                   dlq_topic: Optional[str] = None,
                   death_plan=None,
                   fault_plan=None,
                   bus_dir: Optional[str] = None,
                   lease_ttl: float = 5.0,
                   heartbeat_interval: float = 0.05,
                   tick_interval: float = 0.05,
                   health_file: Optional[str] = None,
                   trace: bool = False,
                   trace_sample: float = 1.0,
                   trace_seed: Optional[int] = None,
                   sentinel_rules=None,
                   worker_sentinel_rules=None,
                   sentinel_clock=None,
                   sentinel_recorder=None,
                   candidates: int = 1,
                   role_ttl: Optional[float] = None,
                   coordinator_kill=None,
                   control=None,
                   autoscale=None) -> "Fleet":
        """A fleet over an InProcessBroker: assigned consumers with the
        coordinator's commit fence, group-lag drain signal, one shared
        scoring pipeline, and (with ``sched_config``) a per-worker adaptive
        scheduler shedding against the fleet's global backlog watermark.

        ``fault_plan`` (stream/faults.py FaultPlan) wraps every worker's
        transport in the
        chaos layer. Only NON-LETHAL fault kinds belong here (duplicates,
        corruption, latency spikes, commit fences, lossy flushes): a poll
        transport error or flush crash raises out of the worker thread and
        counts as a worker error — scripted whole-worker deaths are
        ``death_plan``'s job."""
        from fraud_detection_tpu_torch.stream.engine import StreamingClassifier

        fleet_holder: dict = {}
        schedulers: dict = {}

        def make_consumer(lease):
            coordinator = fleet_holder["fleet"].coordinator
            consumer = broker.assigned_consumer(
                lease.partitions, group_id,
                fence=lambda pairs, wid=lease.worker_id:
                    coordinator.fence_lost(wid, pairs))
            # Chaos wraps INSIDE the fleet's poll-path wrapper, so the
            # death plan / heartbeat hooks still fire even when a poll's
            # result is chaos-mangled.
            return (fault_plan.consumer(consumer)
                    if fault_plan is not None else consumer)

        def make_engine(consumer, worker_id):
            scheduler = None
            if sched_config is not None:
                from fraud_detection_tpu_torch.sched import AdaptiveScheduler

                # One scheduler per worker, shared across its incarnations
                # (same contract as serve.py --workers): incarnations run
                # sequentially, so the one-thread region holds.
                scheduler = schedulers.get(worker_id)
                if scheduler is None:
                    scheduler = AdaptiveScheduler(sched_config, batch_size)
                    bus = fleet_holder["fleet"].bus
                    scheduler.fleet_backlog = (
                        lambda b=bus: (b.fleet_view() or {}).get(
                            "backlog_per_worker"))
                    schedulers[worker_id] = scheduler
            producer = broker.producer()
            if fault_plan is not None:
                producer = fault_plan.producer(producer)
            return StreamingClassifier(
                pipeline, consumer, producer, output_topic,
                batch_size=batch_size, max_wait=max_wait,
                pipeline_depth=pipeline_depth,
                async_dispatch=async_dispatch,
                scheduler=scheduler, dlq_topic=dlq_topic,
                # One tracer per worker, shared across incarnations —
                # chains and stage sketches survive rebalances exactly
                # like the scheduler's SLO window does.
                rowtrace=fleet_holder["fleet"].tracers.get(worker_id),
                # One sentinel per worker, same sharing contract: alert
                # state and incident accounting survive rebalances.
                sentinel=fleet_holder["fleet"].worker_sentinels.get(
                    worker_id))

        fleet = cls(
            n_workers, make_engine, make_consumer,
            topics=[input_topic], num_partitions=broker.num_partitions,
            bus=FleetBus(dir=bus_dir), lease_ttl=lease_ttl,
            lag_fn=lambda: broker.group_lag(group_id, [input_topic]),
            death_plan=death_plan, heartbeat_interval=heartbeat_interval,
            tick_interval=tick_interval, health_file=health_file,
            trace=trace, trace_sample=trace_sample, trace_seed=trace_seed,
            sentinel_rules=sentinel_rules,
            worker_sentinel_rules=worker_sentinel_rules,
            sentinel_clock=sentinel_clock,
            sentinel_recorder=sentinel_recorder,
            candidates=candidates, role_ttl=role_ttl,
            coordinator_kill=coordinator_kill, control=control,
            autoscale=autoscale)
        fleet_holder["fleet"] = fleet
        return fleet

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def stop(self) -> None:
        """Cooperative shutdown: every worker drains + commits and leaves.
        The latch is set FIRST so a racing scale-out refuses instead of
        launching a worker nobody will stop."""
        self._stop.set()
        with self._registry:
            workers = list(self.workers)
        for w in workers:
            w.stop()

    def fleet_health(self) -> dict:
        """Monitor-thread-safe aggregate: the coordinator's last view plus
        every live worker's engine health (the ``--fleet-health-file``
        payload and the serve CLI's exit report)."""
        with self._registry:
            workers = list(self.workers)
        return {
            "time": time.time(),
            "fleet": self.coordinator.last_view(),
            "alerts": (self.sentinel.snapshot()
                       if self.sentinel is not None else None),
            "workers": {w.worker_id: {**w.result(), "health": w.health()}
                        for w in workers},
        }

    def _write_health_file(self) -> None:
        path = self.health_file
        if path is None:
            return
        # Shared atomic writer: failures swallowed inside (health
        # reporting must never kill serving).
        atomic_write_json(path, self.fleet_health())

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.tick_interval):
            try:
                self.coordinator.tick()
            except Exception:  # noqa: BLE001 — the tick must keep ticking
                log.exception("fleet coordinator tick failed")
            if self.sentinel is not None:
                # Coordinator-level rules judged on the view the tick just
                # aggregated (evaluate() guards its own failures).
                self.sentinel.evaluate()
            if self.autoscaler is not None:
                # Elasticity judged AFTER the sentinel pass: the policy
                # sees exactly the signal state this tick produced.
                try:
                    self.autoscaler.step()
                except Exception:  # noqa: BLE001 — sizing must not kill
                    log.exception("fleet autoscaler step failed")
            self._write_health_file()

    def _candidate_main(self, cid: str) -> None:
        """One coordinator candidate's contention loop (fleet/control.py):
        poll the role lease for vacancy (stale beacon past role_ttl, or
        an abdication) and elect when it opens. Harmless while standby —
        ``step`` is a no-op for a live incumbent."""
        coordinator = self.coordinator
        interval = max(0.01, coordinator.role_ttl / 8.0)
        while not self._stop.wait(interval):
            try:
                coordinator.step(cid)
            except Exception:  # noqa: BLE001 — candidates must keep running
                log.exception("fleet candidate %s election pass failed", cid)

    def _worker_main(self, worker: FleetWorker,
                     idle_timeout: Optional[float]) -> None:
        try:
            worker.run(idle_timeout=idle_timeout)
        except BaseException as e:  # noqa: BLE001 — surfaced via results
            if worker.error is None:
                worker.error = e
            log.warning("fleet worker %s died: %r (survivors take over "
                        "its partitions)", worker.worker_id, e)

    def run(self, idle_timeout: Optional[float] = 1.0,
            join_timeout: Optional[float] = None) -> dict:
        """Run the whole fleet; returns the merged stats dict. With
        ``idle_timeout`` set this is a drain run (workers exit once input
        is idle AND the group's committed lag is zero — see
        FleetWorker.run); None serves until ``stop()``."""
        if self.death_plan is not None:
            # Deterministic arming order — the seeded plan draws per ARM,
            # so victims must not depend on thread start races.
            for w in self.workers:
                self.death_plan.arm(w.worker_id)
        # Scaled-out workers inherit this run's drain semantics (the
        # provisioner spawns with the same idle_timeout).
        with self._registry:
            self._idle_timeout = idle_timeout
        t0 = time.perf_counter()
        monitor = threading.Thread(target=self._monitor_loop,
                                   name="fleet-monitor", daemon=True)
        monitor.start()
        candidate_threads: List[threading.Thread] = []
        if hasattr(self.coordinator, "candidate_ids"):
            candidate_threads = [
                threading.Thread(target=self._candidate_main, args=(cid,),
                                 name=f"fleet-candidate-{cid}", daemon=True)
                for cid in self.coordinator.candidate_ids]
            for t in candidate_threads:
                t.start()
        with self._registry:
            self._threads = [
                threading.Thread(target=self._worker_main,
                                 args=(w, idle_timeout),
                                 name=f"fleet-{w.worker_id}", daemon=True)
                for w in self.workers]
            threads = list(self._threads)
        for t in threads:
            t.start()
        try:
            # The join loop re-snapshots the registry each pass: the
            # autoscaler grows ``_threads`` from the monitor thread, and
            # a scaled-out worker is as load-bearing as a founding one.
            deadline = (time.perf_counter() + join_timeout
                        if join_timeout is not None else None)
            while True:
                with self._registry:
                    threads = list(self._threads)
                alive = [t for t in threads if t.is_alive()]
                if not alive:
                    break
                if deadline is not None and time.perf_counter() >= deadline:
                    break
                alive[0].join(min(0.2, self.tick_interval * 4))
        except KeyboardInterrupt:
            # Operator shutdown: drain + leave gracefully (partitions
            # reassign immediately; nothing waits out a lease ttl).
            self.stop()
            with self._registry:
                threads = list(self._threads)
            for t in threads:
                t.join(timeout=30.0)
        finally:
            self._stop.set()
            monitor.join(timeout=5.0)
            for t in candidate_threads:
                t.join(timeout=5.0)
            # A scale-out racing the loop's exit: the latch above stops
            # further launches; whatever landed still gets drained.
            with self._registry:
                threads = list(self._threads)
            for t in threads:
                if t.is_alive():
                    t.join(timeout=5.0)
        wall = time.perf_counter() - t0
        try:
            final_view = self.coordinator.tick()   # post-run aggregate
        except Exception:  # noqa: BLE001
            final_view = self.coordinator.last_view()
        self._write_health_file()
        total = StreamStats()
        with self._registry:
            workers = list(self.workers)
        for w in workers:
            _merge_stats(total, w.stats)
        total.elapsed = wall     # workers overlap: wall-clock, not the sum
        deaths = [w.result() for w in workers if w.death is not None]
        errors = [w.result() for w in workers if w.error is not None]
        out = {
            **total.as_dict(),
            "workers": len(workers),
            "per_worker": [w.result() for w in workers],
            "per_worker_processed": [w.stats.processed
                                     for w in workers],
            "incarnations": sum(w.incarnations for w in workers),
            "rebalances": self.coordinator.rebalances,
            "lease_expirations": self.coordinator.expirations,
            "deaths": deaths,
            "errors": [e["error"] for e in errors],
            "fleet": final_view,
        }
        if self.death_plan is not None:
            out["death_plan"] = self.death_plan.report()
        if self.autoscaler is not None:
            out["autoscale"] = self.autoscaler.report()
        if hasattr(self.coordinator, "succession_report"):
            succession = self.coordinator.succession_report()
            if self.coordinator_kill is not None:
                succession["kill_plan"] = self.coordinator_kill.report()
            out["succession"] = succession
        if self.sentinel is not None:
            # Final pass AFTER the post-run tick above, so membership
            # drops and last-tick watermarks are judged before the
            # snapshot lands in the merged stats. (Worker sentinels got
            # their last pass on their final poll; their engines are gone
            # now, so another pass would only count a source error.)
            self.sentinel.evaluate()
            out["alerts"] = self.sentinel.snapshot()
            out["worker_alerts"] = {
                wid: {k: snap[k] for k in ("firing", "critical_firing",
                                           "fired", "resolved",
                                           "still_firing")}
                for wid, snap in ((wid, s.snapshot())
                                  for wid, s in
                                  self.worker_sentinels.items())}
        if self.tracers:
            # Final fleet-level stage attribution straight from the
            # tracers (the post-drain coordinator tick sees no members —
            # workers retract their bus docs as they leave); lossless, so
            # it equals a single-process run over the same samples.
            from fraud_detection_tpu_torch.obs.trace import fleet_stage_latency

            out["stage_latency_ms"] = fleet_stage_latency(
                [t.stages_wire() for t in self.tracers.values()])
        return out
