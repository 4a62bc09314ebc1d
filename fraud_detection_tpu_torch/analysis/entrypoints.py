"""The port's concurrency map — the single source of truth flightcheck
lints the port's tree against; twin of
``fraud_detection_tpu/analysis/entrypoints.py``. Module paths mirror the
reference's, so the entries are the reference's unless a comment beside one
says why it differs; every entry names a site that exists in the port.

  * :data:`THREAD_SITES` — every ``threading.Thread`` / ``ThreadPoolExecutor``
    construction site in the package. FC103 fails when code spawns a thread
    this map doesn't know (or the map lists a thread that no longer exists):
    an unregistered thread is an unaudited concurrency surface.
  * :data:`THREAD_ENTRY_POINTS` — the functions those threads run, each
    with the racecheck region that guards it (or ``None`` with a reason).
    FC103 cross-checks the region names against
    ``utils.racecheck.INSTRUMENTED_REGIONS`` so the static map and the
    runtime detector can never drift apart.
  * :data:`CONCURRENT_CLASSES` — per-class thread-role assignments feeding
    the FC102 unguarded-shared-write rule: which methods run on which
    thread, so a write without a lock is only flagged when two roles can
    actually collide on the attribute.
  * :data:`OBJECT_BINDINGS` / :data:`IMPLEMENTATIONS` — receiver types for
    the whole-program lock-order pass (callgraph.py).
  * :data:`COMMIT_PROTOCOLS` — the FC401-FC403 delivery-protocol scope.
  * :data:`FLEET_PROTOCOLS` / :data:`SLOT_PROTOCOLS` and their barrier
    obligations and vocabularies — the FC501-FC503 scope and the model
    checker's vocabulary; trace conformance (``conformance.py``) replays a
    control-lane journal against the Worker and Candidate machines.
  * :data:`HOT_PATHS` — the per-batch serving functions where FC203/FC204
    police device syncs and ladder-bypassing batch shapes.

Adding a thread? Register it here (site + entry point + racecheck region),
instrument the region in ``utils/racecheck.py``'s ``INSTRUMENTED_REGIONS``,
and give the class a role map — the CLI fails the tree until all three
agree.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import FrozenSet, Mapping, Optional, Tuple

# ---------------------------------------------------------------------------
# Thread construction sites: (package-relative posix path, target callable
# name as written at the construction site).
# ---------------------------------------------------------------------------

THREAD_SITES: FrozenSet[Tuple[str, str]] = frozenset({
    # serve CLI: periodic health-file dumper ("health-writer").
    ("app/serve.py", "loop"),
    # serve CLI: one consumer-group worker per --workers.
    ("app/serve.py", "run_worker"),
    # Streamlit demo tab's background engine thread (target=engine.run).
    ("app/ui.py", "run"),
    # Model-lifecycle registry watcher ("lifecycle-watcher").
    ("registry/promote.py", "loop"),
    # Shadow candidate scorer ("shadow-scorer").
    ("registry/shadow.py", "self._worker"),
    # Async LLM annotation lane ("annotation-lane").
    ("stream/annotations.py", "self._run"),
    # Host featurization shard pool (ThreadPoolExecutor, prefix "featurize").
    ("featurize/parallel.py", "ThreadPoolExecutor"),
    # Double-buffered async dispatch lane ("dispatch-lane"): featurize +
    # upload + device launch for batch N+1 while the engine driver
    # delivers batch N (sched/batcher.py DispatchLane).
    ("sched/batcher.py", "self._run"),
    # Fleet serving lane (docs/fleet.md): one thread per partition-owning
    # worker, plus the monitor thread ticking the lease coordinator. The
    # autoscaler's scale-out path (Fleet._spawn_worker, fleet/autoscale/)
    # constructs workers at a second site with the SAME (path, target)
    # signature — one registry entry covers both.
    ("fleet/fleet.py", "self._worker_main"),
    ("fleet/fleet.py", "self._monitor_loop"),
    # Coordinator succession (fleet/control.py, docs/fleet.md "Coordinator
    # succession"): one standby-candidate thread per candidate id, each
    # watching for role vacancy and contending in the term election.
    ("fleet/fleet.py", "self._candidate_main"),
    # Sanitizer workload driver: hammer threads racing the shard ABI on
    # purpose — TSan is the detector there, not racecheck.
    ("native/san_driver.py", "hammer"),
    # Observability egress (obs/export.py, docs/observability.md):
    # periodic --metrics-file dumper, the --metrics-port HTTP endpoint's
    # serve thread, and the N-batch torch.profiler window watcher.
    ("obs/export.py", "loop"),
    ("obs/export.py", "serve_forever"),
    ("obs/export.py", "watch"),
    # Scenario harness (docs/scenarios.md): the single scenario-feeder
    # thread walking a seeded traffic timeline (produces rows to the
    # broker, fires scripted TimelineActions like hot swaps).
    ("scenarios/traffic.py", "self._run"),
    # Slotserve explain lane (docs/explain_serving.md): ONE worker owning
    # the slot pool's decoder — admissions, decode windows, retirement.
    ("explain/slotserve/service.py", "self._run"),
    # Sentinel alerting (obs/sentinel/, docs/observability.md): the ONE
    # evaluation thread driving every registered sentinel at the serve
    # CLI's --alert-interval cadence (fleet/worker sentinels evaluate on
    # the monitor/poll threads instead — no extra thread there).
    ("obs/sentinel/engine.py", "loop"),
    # Closed learning loop (learn/, docs/online_learning.md): ONE
    # learn-lane worker owning window ingestion, label joins, windowed
    # retrains, registry publishes, and shadow replays.
    ("learn/loop.py", "self._run"),
    # Scenario ground-truth oracle (scenarios/labels.py): consumes the
    # input topic and produces delayed feedback labels for drift game
    # days.
    ("scenarios/labels.py", "self._run"),
})


@dataclass(frozen=True)
class EntryPoint:
    """One background-thread entry function and its runtime race coverage."""

    thread: str                  # thread name / pool prefix
    module: str                  # package-relative posix path
    qualname: str                # Class.method or function name
    racecheck: Optional[str]     # ExclusiveRegion/PairedCallChecker name
    why_uncovered: str = ""      # required when racecheck is None


THREAD_ENTRY_POINTS: Tuple[EntryPoint, ...] = (
    # The engine loop is the PRIMARY driver thread: one per worker.
    EntryPoint("engine-driver", "stream/engine.py",
               "StreamingClassifier.run", "StreamingClassifier.drive"),
    # The scheduler rides the same driver thread; its region catches a
    # second driver sneaking in through the scheduler surface.
    EntryPoint("engine-driver", "sched/scheduler.py",
               "AdaptiveScheduler.collect", "AdaptiveScheduler.drive"),
    EntryPoint("health-writer", "app/serve.py", "loop", None,
               "read-only: dumps health() snapshots, mutates nothing"),
    EntryPoint("serve-worker", "app/serve.py", "run_worker", None,
               "each worker drives ITS OWN engine; the engine's drive "
               "region is the guard"),
    EntryPoint("ui-stream", "app/ui.py", "StreamingClassifier.run",
               "StreamingClassifier.drive"),
    # The in-process broker's consumer is single-driver like the engine.
    EntryPoint("engine-driver", "stream/broker.py",
               "InProcessConsumer.poll_batch", "InProcessConsumer"),
    EntryPoint("lifecycle-watcher", "registry/promote.py",
               "LifecycleController.tick", "LifecycleController.watch"),
    EntryPoint("shadow-scorer", "registry/shadow.py",
               "ShadowScorer._worker", "ShadowScorer.worker"),
    EntryPoint("annotation-lane", "stream/annotations.py",
               "AsyncAnnotationLane._run", None,
               "single worker by construction (one thread started in "
               "__init__, never respawned); queue + counters under _cv"),
    EntryPoint("dispatch-lane", "sched/batcher.py",
               "DispatchLane._run", None,
               "single worker by construction (one thread started in "
               "__init__, never respawned); queues + counters under _cv, "
               "and the launch_fn it runs (engine._launch) touches only "
               "documented monotonic latches outside the _InFlight it owns"),
    EntryPoint("featurize", "featurize/parallel.py",
               "encode_sharded_native", "NativeFeaturizer"),
    # Raw-JSON shard fan-out rides the same pool and the same stateless
    # shard contract (handle read-only during shard calls).
    EntryPoint("featurize", "featurize/parallel.py",
               "encode_json_sharded_native", "NativeFeaturizer"),
    # Fleet worker thread: drives its OWN engine incarnation chain (the
    # engine's drive region + the assigned consumer's region guard the
    # inner loop; FleetWorker.run's region pins one-driver-per-worker).
    EntryPoint("fleet-worker", "fleet/fleet.py", "Fleet._worker_main",
               "FleetWorker.run"),
    # The manual-assignment consumer is single-driver like the group one.
    EntryPoint("fleet-worker", "stream/broker.py",
               "InProcessAssignedConsumer.poll_batch",
               "InProcessAssignedConsumer"),
    EntryPoint("fleet-monitor", "fleet/fleet.py", "Fleet._monitor_loop", None,
               "coordinator state lives under FleetCoordinator._lock and "
               "the bus under FleetBus._lock; the tick never touches "
               "engine/consumer state; the autoscaler it steps keeps its "
               "ledgers under Autoscaler._lock and spawns workers through "
               "Fleet._spawn_worker under the fleet registry lock"),
    EntryPoint("fleet-candidate", "fleet/fleet.py", "Fleet._candidate_main",
               None,
               "succession state lives under SuccessionCoordinator._lock "
               "(elections additionally serialize on _elect_lock, the term "
               "fence under TermGate._lock, the control lane under "
               "ControlBus._lock); step() never touches engine/consumer "
               "state"),
    EntryPoint("san-hammer", "native/san_driver.py", "hammer", None,
               "deliberately racing workload — the sanitizer runtime "
               "(ASan/TSan) is the detector"),
    EntryPoint("metrics-writer", "obs/export.py", "loop", None,
               "read-only: renders registry collectors (health() pulls) "
               "and publishes via the atomic writer; mutates only its own "
               "Counter, which locks internally"),
    EntryPoint("metrics-http", "obs/export.py",
               "ThreadingHTTPServer.serve_forever", None,
               "stdlib HTTP server; handlers render the registry (same "
               "read-only pull as the writer) — shared state is the "
               "registry's own locked instruments"),
    # Differs from the reference in one word: the port's window drives
    # torch.profiler where the reference's drives jax.profiler.
    EntryPoint("profile-window", "obs/export.py", "watch", None,
               "polls a batches counter and stops the torch profiler trace "
               "once; all mutation behind the window's own lock"),
    EntryPoint("scenario-feeder", "scenarios/traffic.py",
               "TrafficFeeder._run", None,
               "single feeder by construction (one thread per start(), "
               "never respawned); counters under _lock, the error field "
               "is a documented write-once latch read after join(), and "
               "broker appends go through the broker's own lock"),
    EntryPoint("slotserve-lane", "explain/slotserve/service.py",
               "SlotServeService._run", None,
               "single worker by construction (one thread started in "
               "__init__, never respawned); queue/counters under _cv, "
               "slot-state arrays and the SlotDecoder are worker-only by "
               "the class's role map, waiters block on per-request "
               "events"),
    # Learn lane: the one closed-loop worker; the region also guards the
    # inline tick() test driver (learn/loop.py).
    EntryPoint("learn-lane", "learn/loop.py", "LearnLoop._run",
               "LearnLoop.lane"),
    EntryPoint("label-feeder", "scenarios/labels.py", "LabelFeeder._run",
               None,
               "single feeder by construction (one thread per start(), "
               "never respawned); counters under _lock, the error field "
               "is a documented write-once latch read after join(), "
               "broker/consumer calls go through their own locks"),
    EntryPoint("sentinel", "obs/sentinel/engine.py", "loop", None,
               "single evaluator by construction (start_sentinel spawns "
               "one thread per call and serve calls it once); all rule/"
               "incident state under Sentinel._lock, the source pull is "
               "a read-only health() sample, and recorder file I/O runs "
               "outside the sentinel lock under the recorder's own lock"),
)


# ---------------------------------------------------------------------------
# Thread roles per concurrent class (the FC102 scope).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ClassSpec:
    """Thread-role map for one class with a multi-thread surface.

    ``any_thread``: methods callable from arbitrary threads while the
    primary thread runs (health pollers, non-blocking submitters).
    ``workers``: role name -> methods that EXECUTE on that role's thread
    (reachability through self-calls is computed by the analyzer). Every
    unlisted method runs on the primary ("main") thread.
    """

    any_thread: FrozenSet[str] = frozenset()
    workers: Mapping[str, FrozenSet[str]] = field(default_factory=dict)


def _spec(any_thread=(), **workers) -> ClassSpec:
    return ClassSpec(any_thread=frozenset(any_thread),
                     workers={k: frozenset(v) for k, v in workers.items()})


CONCURRENT_CLASSES: Mapping[str, ClassSpec] = {
    # Engine: single-driver loop; stop()/health() are the documented
    # cross-thread surface (serve.py Ctrl-C + --health-file poller). Under
    # async_dispatch the featurize+launch leg (_launch and below) executes
    # on the dispatch-lane worker while the driver polls/delivers.
    "stream/engine.py::StreamingClassifier": _spec(
        any_thread=("stop", "health", "annotation_stats"),
        dispatch_lane=("_launch",)),
    # Dispatch lane: one worker runs _run; submit/next/stop are driver-only
    # (the engine's drive region guards the driver); stats() polls cross-
    # thread. Everything shared lives under _cv.
    "sched/batcher.py::DispatchLane": _spec(
        any_thread=("stats",),
        dispatch_lane=("_run",)),
    # Annotation lane: one worker drains the queue; stats() polls cross-
    # thread; submit() comes from the engine driver.
    "stream/annotations.py::AsyncAnnotationLane": _spec(
        any_thread=("stats",),
        annotation_lane=("_run",)),
    # Shadow scorer: worker rescopes batches; the engine driver calls
    # wants()/submit(); the lifecycle watcher sets/clears candidates;
    # health pollers snapshot.
    "registry/shadow.py::ShadowScorer": _spec(
        any_thread=("snapshot", "wants", "submit", "candidate_version",
                    "active"),
        shadow_scorer=("_worker",),
        lifecycle_watcher=("set_candidate", "clear_candidate")),
    # Hot swap: readers are lock-free RCU from any thread; the watcher
    # thread swaps/stages; the engine driver configures the ladder.
    "registry/hotswap.py::HotSwapPipeline": _spec(
        any_thread=("predict_async", "predict_json_async", "predict",
                    "predict_one", "batch_size", "active_version",
                    "active_pipeline", "staged_version", "staged_pipeline",
                    "lifecycle_snapshot", "pad_buckets", "ladder_costs"),
        lifecycle_watcher=("swap", "stage", "promote_staged",
                           "discard_staged", "prewarm")),
    # Lifecycle controller: tick() runs on the watcher thread; rollback()
    # is the operator's (main-thread) overrule.
    "registry/promote.py::LifecycleController": _spec(
        lifecycle_watcher=("tick",)),
    # Scheduler: collect/admit/observe/prewarm are driver-only (the
    # ExclusiveRegion contract); snapshot() serves health pollers.
    "sched/scheduler.py::AdaptiveScheduler": _spec(
        any_thread=("snapshot",)),
    # Native featurizer: shard_* entry points run on the featurize pool
    # over one shared read-only handle; encode paths hold _call_lock.
    "featurize/native.py::NativeFeaturizer": _spec(
        featurize=("shard_begin", "shard_json_begin", "shard_fill_into",
                   "shard_destroy")),
    # Fleet bus: a blackboard — every surface callable from any thread,
    # everything shared under FleetBus._lock (file writes are atomic).
    "fleet/bus.py::FleetBus": _spec(
        any_thread=("publish", "retract", "snapshots", "publish_fleet",
                    "fleet_view")),
    # Fleet coordinator: workers join/sync/ack/leave/fence from their own
    # threads, the monitor thread ticks; all state under _lock, and the
    # coordinator never calls out while holding it (acyclic lock graph).
    "fleet/coordinator.py::FleetCoordinator": _spec(
        any_thread=("join", "sync", "ack", "leave", "fence_lost",
                    "assignments", "committed_lag", "last_view",
                    "request_release"),
        fleet_monitor=("tick",)),
    # Fleet worker: run() (and the poll-path hooks the engine drives) is
    # the worker thread, guarded by the FleetWorker.run region;
    # stop/result/health are the documented cross-thread surface.
    "fleet/worker.py::FleetWorker": _spec(
        any_thread=("stop", "result", "health"),
        fleet_worker=("run", "_on_poll", "_publish")),
    # Fleet facade: run() on the caller's thread, monitor/worker/candidate
    # threads spawned by it; stop/fleet_health are cross-thread (Event +
    # reads of monitor-safe surfaces).
    "fleet/fleet.py::Fleet": _spec(
        any_thread=("stop", "fleet_health"),
        fleet_monitor=("_monitor_loop", "_write_health_file",
                       "_spawn_worker"),
        fleet_worker=("_worker_main",),
        fleet_candidate=("_candidate_main",)),
    # Succession coordinator (fleet/control.py, docs/fleet.md "Coordinator
    # succession"): same worker-facing surface contract as the plain
    # coordinator (workers call from their own threads), the monitor ticks
    # the incumbent, candidate threads step the vacancy watch/election;
    # all state under _lock, elections serialized on _elect_lock, and
    # control.stats() is only ever called OUTSIDE the lock (acyclic lock
    # graph, same rule as FleetCoordinator).
    "fleet/control.py::SuccessionCoordinator": _spec(
        any_thread=("join", "sync", "ack", "leave", "fence_lost",
                    "assignments", "committed_lag", "last_view",
                    "succession_report", "request_release"),
        fleet_monitor=("tick",),
        fleet_candidate=("step",)),
    # Control bus: a compacted-log blackboard like FleetBus — every surface
    # callable from any thread, ordering/dedup state under ControlBus._lock
    # (transport produce/flush happens outside it: chaos loss must not
    # serialize publishers).
    "fleet/control.py::ControlBus": _spec(
        any_thread=("publish", "retry", "poll", "replay", "lamport",
                    "lost", "stats")),
    # Term fence: a monotonic CAS — candidates advance, everyone accepts;
    # one lock, any thread.
    "fleet/control.py::TermGate": _spec(
        any_thread=("current", "try_advance", "accept")),
    # Autoscaler (fleet/autoscale/, docs/autoscaling.md): step() runs on
    # the fleet monitor tick (the single controller thread);
    # stats()/report() are the cross-thread surface (the coordinator's
    # view hook, health pollers, the post-run report). Desired capacity,
    # the launch/release ledgers, and counters live under
    # Autoscaler._lock; the policy object it drives is monitor-owned
    # (its snapshot reads are the usual racy monotonic samples).
    "fleet/autoscale/controller.py::Autoscaler": _spec(
        any_thread=("stats", "report"),
        fleet_monitor=("step",)),
    # Thread provisioner: launch() rides the monitor thread today but the
    # seam contract allows any caller; the idempotence ledger sits under
    # its own lock and the spawn hook serializes on Fleet's registry.
    "fleet/autoscale/provisioner.py::ThreadProvisioner": _spec(
        any_thread=("launch", "launched")),
    # Scenario feeder (docs/scenarios.md): _run/_fire execute on the one
    # feeder thread; stats/fed/alive are the cross-thread surface
    # (counters under _lock; the error field is a write-once latch read
    # after join()).
    "scenarios/traffic.py::TrafficFeeder": _spec(
        any_thread=("stats", "fed", "alive", "join"),
        scenario_feeder=("_run", "_fire")),
    # Slotserve lane (docs/explain_serving.md): _run (and the iteration
    # methods it reaches) executes on the one slotserve-lane worker; the
    # submit/backend surfaces and snapshot/drain/close are the
    # cross-thread API — queue/counters under _cv, slot-state arrays
    # worker-only, request resolution via per-request events.
    "explain/slotserve/service.py::SlotServeService": _spec(
        any_thread=("submit", "chat", "generate", "generate_batch",
                    "explain_rows", "snapshot", "drain", "close",
                    "set_rowtrace"),
        slotserve_lane=("_run",)),
    # Learn loop (learn/loop.py, docs/online_learning.md): _run (and the
    # ingestion/retrain/replay methods it reaches) executes on the one
    # learn-lane worker; wants/submit come from the engine driver,
    # on_transition from the lifecycle watcher, snapshot from health
    # pollers — every shared counter under _lock; the window store has
    # its own lock.
    "learn/loop.py::LearnLoop": _spec(
        any_thread=("wants", "submit", "snapshot", "on_transition",
                    "bind_controller", "drain", "close"),
        learn_lane=("_run", "tick")),
    # Window store (learn/store.py): a blackboard — the learn lane
    # inserts/joins/sweeps, health pollers snapshot; everything under
    # the store's one lock.
    "learn/store.py::WindowStore": _spec(
        any_thread=("insert", "join", "sweep", "count_malformed",
                    "labeled_rows", "error_stats", "error_by_version",
                    "snapshot", "__len__")),
    # Scenario label oracle (scenarios/labels.py): _run executes on the
    # one label-feeder thread; stats/fed/stop/join are the cross-thread
    # surface (counters under _lock, error is a write-once latch).
    "scenarios/labels.py::LabelFeeder": _spec(
        any_thread=("stats", "fed", "stop", "join"),
        label_feeder=("_run", "_truth_of")),
    # Sentinel (obs/sentinel/, docs/observability.md): evaluate/prime run
    # on whichever single thread drives this sentinel (the serve
    # "sentinel" thread, the fleet monitor, a fleet worker's poll path,
    # the scenario driver); snapshot/firing/healthz are the cross-thread
    # surface. Everything mutable sits under Sentinel._lock.
    "obs/sentinel/engine.py::Sentinel": _spec(
        any_thread=("snapshot", "firing", "critical_firing", "healthz",
                    "last_eval_at"),
        sentinel=("evaluate", "prime")),
    # Chain-cumulative health source: attach() on the supervisor path,
    # __call__ on the sentinel driver; accumulator under its own lock,
    # health reads are the usual lock-free racy samples.
    "obs/sentinel/engine.py::ChainedHealthSource": _spec(
        any_thread=("attach", "__call__")),
    # Incident recorder: transitions can arrive from any sentinel's
    # driving thread; the append log is serialized under _lock and
    # bundle publication rides the shared atomic writer.
    "obs/sentinel/bundle.py::IncidentRecorder": _spec(
        any_thread=("record_fired", "record_resolved", "record_scale",
                    "snapshot")),
}


# ---------------------------------------------------------------------------
# Cross-object seams (the whole-program FC101 scope, analysis/callgraph.py).
#
# The call-graph pass infers receiver types from direct instantiation and
# parameter annotations; everything duck-typed — the engine's injected
# clients, the scheduler's consumer parameter — is pinned HERE so the
# analyzer follows the calls the engine actually makes. Keys are either
# "relpath::Class.attr" (attribute binding) or "relpath::Class.method.param"
# (parameter binding); values are candidate class names, expanded through
# IMPLEMENTATIONS when they name a Protocol.
# ---------------------------------------------------------------------------

OBJECT_BINDINGS: Mapping[str, Tuple[str, ...]] = {
    # Engine clients: the Protocol types; expanded to in-process impls.
    "stream/engine.py::StreamingClassifier.consumer": ("Consumer",),
    "stream/engine.py::StreamingClassifier.producer": ("Producer",),
    "stream/engine.py::StreamingClassifier._sched": ("AdaptiveScheduler",),
    "stream/engine.py::StreamingClassifier._lane": ("DispatchLane",),
    "stream/engine.py::StreamingClassifier._shadow": ("ShadowScorer",),
    "stream/engine.py::StreamingClassifier.pipeline": ("HotSwapPipeline",),
    # Scheduler-owned consume handoff: collect/backlog_of (and the
    # batcher's accumulation loop they delegate to) drive the engine's
    # consumer while holding the scheduler's region. `*` binds the named
    # parameter in EVERY method of the class.
    "sched/scheduler.py::AdaptiveScheduler.*.consumer": ("Consumer",),
    "sched/batcher.py::DynamicBatcher.*.consumer": ("Consumer",),
    # Lifecycle controller drives hot swap + shadow under its watch region.
    "registry/promote.py::LifecycleController.hotswap": ("HotSwapPipeline",),
    "registry/promote.py::LifecycleController.shadow": ("ShadowScorer",),
    # Chaos wrappers forward to the real clients.
    "stream/faults.py::ChaosConsumer.inner": ("Consumer",),
    "stream/faults.py::ChaosProducer.inner": ("Producer",),
    # Fleet seams (docs/fleet.md): the worker drives the coordinator + bus
    # from the poll path, and its consumer wrapper forwards to the
    # manual-assignment transport.
    "fleet/worker.py::FleetWorker.coordinator": ("FleetCoordinator",
                                                 "SuccessionCoordinator"),
    "fleet/worker.py::FleetWorker.bus": ("FleetBus",),
    "fleet/worker.py::_FleetConsumer.inner": ("Consumer",),
    "fleet/worker.py::_FleetConsumer._worker": ("FleetWorker",),
    "fleet/fleet.py::Fleet.coordinator": ("FleetCoordinator",
                                          "SuccessionCoordinator"),
    "fleet/fleet.py::Fleet.bus": ("FleetBus",),
    "fleet/coordinator.py::FleetCoordinator.bus": ("FleetBus",),
    # Succession seams (fleet/control.py): the leased-role wrapper drives
    # the REAL coordinator it incarnates, its control lane, and the term
    # fence; the control lane rides the broker Protocol pair.
    "fleet/control.py::SuccessionCoordinator.coordinator":
        ("FleetCoordinator",),
    "fleet/control.py::SuccessionCoordinator.control": ("ControlBus",),
    "fleet/control.py::SuccessionCoordinator.gate": ("TermGate",),
    "fleet/control.py::SuccessionCoordinator._fleet_bus": ("FleetBus",),
    "fleet/control.py::ControlBus._producer": ("Producer",),
    "fleet/control.py::ControlBus._consumer": ("Consumer",),
    # Slotserve lane: the service drives its decoder from the lane thread.
    "explain/slotserve/service.py::SlotServeService._decoder": ("SlotDecoder",),
    # Learn seams (learn/, docs/online_learning.md): the engine offers
    # scored batches to the loop; the loop drives its window store, the
    # registry, and the shadow scorer's encoded-replay surface.
    "stream/engine.py::StreamingClassifier._learn": ("LearnLoop",),
    "learn/loop.py::LearnLoop.store": ("WindowStore",),
    "learn/loop.py::LearnLoop._shadow": ("ShadowScorer",),
    "learn/loop.py::LearnLoop._registry": ("ModelRegistry",),
    "learn/loop.py::LearnLoop._controller": ("LifecycleController",),
    "learn/loop.py::LearnLoop._consumer": ("Consumer",),
    "scenarios/labels.py::LabelFeeder._consumer": ("Consumer",),
    "scenarios/labels.py::LabelFeeder._producer": ("Producer",),
    # Autoscale seams (fleet/autoscale/, docs/autoscaling.md): the
    # controller reads the coordinator's view and actuates through the
    # provisioner seam / the coordinator's release surface; decisions
    # ride the control bus and the incident recorder.
    "fleet/autoscale/controller.py::Autoscaler.coordinator":
        ("FleetCoordinator", "SuccessionCoordinator"),
    "fleet/autoscale/controller.py::Autoscaler.provisioner":
        ("ThreadProvisioner",),
    "fleet/autoscale/controller.py::Autoscaler.policy": ("ScalePolicy",),
    "fleet/autoscale/controller.py::Autoscaler.control": ("ControlBus",),
    "fleet/autoscale/controller.py::Autoscaler.recorder":
        ("IncidentRecorder",),
    "fleet/fleet.py::Fleet.autoscaler": ("Autoscaler",),
    # Sentinel seams (obs/sentinel/): the engine/fleet surfaces hold a
    # sentinel whose snapshot they read; the sentinel drives its recorder.
    "stream/engine.py::StreamingClassifier._sentinel": ("Sentinel",),
    "fleet/worker.py::FleetWorker.sentinel": ("Sentinel",),
    "fleet/fleet.py::Fleet.sentinel": ("Sentinel",),
    "obs/sentinel/engine.py::Sentinel.recorder": ("IncidentRecorder",),
}

#: Protocol/ABC name -> concrete in-tree implementations the call-graph
#: pass follows (an unbound protocol method has a ``...`` body and would
#: contribute nothing).
IMPLEMENTATIONS: Mapping[str, Tuple[str, ...]] = {
    "Consumer": ("InProcessConsumer", "InProcessAssignedConsumer",
                 "ChaosConsumer", "_FleetConsumer"),
    "Producer": ("InProcessProducer", "ChaosProducer"),
    "ServingPipeline": ("HotSwapPipeline",),
}


# ---------------------------------------------------------------------------
# Commit protocols (the FC401-FC403 scope, analysis/protocol.py): classes
# that own a produce -> flush -> check -> commit delivery sequence. The
# names here ARE the protocol: the producer attribute(s) whose flush()
# accounts delivery, the commit calls that durably advance progress, the
# drain method that finishes queued batches, and the failure flag that
# must gate every post-failure drain.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CommitProtocolSpec:
    """One class's delivery-protocol shape for the FC4xx rules."""

    cls_key: str                      # "relpath::ClassName"
    producer_attrs: FrozenSet[str] = frozenset({"producer"})
    flush_name: str = "flush"
    commit_names: FrozenSet[str] = frozenset({"commit_offsets", "commit"})
    produce_names: FrozenSet[str] = frozenset({"produce", "produce_batch"})
    drain_names: FrozenSet[str] = frozenset()
    failure_flag: Optional[str] = None


COMMIT_PROTOCOLS: Tuple[CommitProtocolSpec, ...] = (
    # The headline protocol: the streaming engine's at-least-once commit
    # sequence (docs/robustness.md "delivery invariants").
    CommitProtocolSpec(
        "stream/engine.py::StreamingClassifier",
        drain_names=frozenset({"_finish"}),
        failure_flag="_flush_failed"),
    # The annotation lane produces+flushes (no offsets to commit, no
    # in-flight queue): FC402 still pins record-rides-flush ordering.
    CommitProtocolSpec(
        "stream/annotations.py::AsyncAnnotationLane",
        producer_attrs=frozenset({"_producer"}),
        commit_names=frozenset()),
)


# ---------------------------------------------------------------------------
# Fleet rebalance choreography (the FC501-FC503 scope, analysis/model.py, and
# the `flightcheck model` checker's vocabulary, analysis/checker.py): the
# fleet's distributed protocol — coordinator lease deals, the REVOKE
# BARRIER (revoke -> drain -> commit -> reassign), zombie commit fencing —
# declared as per-role state machines. Every code-anchored transition is
# AST-verified against the real tree (FC502), every protocol-vocabulary call
# site in fleet code must be claimed by a transition (FC501), and the
# fence/barrier call-site shapes that make the choreography safe are pinned
# as ordering obligations (FC503) — so this spec, the model the checker
# explores, and the implementation can never drift apart silently.
# ---------------------------------------------------------------------------

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


@dataclass(frozen=True)
class BarrierObligation:
    """An FC503 call-site shape: ``first`` must lexically precede ``then``
    inside ``anchor`` (or, with ``then`` empty, just exist). Event syntax:
    ``call:<pattern>`` (dotted call suffix), ``store:<attr>`` (assignment or
    ``del`` whose target chain mentions the attribute), and
    ``kwarg:<call_pattern>:<kwarg>`` (the call must pass the keyword)."""

    name: str
    anchor: str
    first: str
    then: str = ""
    why: str = ""


FLEET_BARRIER_OBLIGATIONS: Tuple[BarrierObligation, ...] = (
    BarrierObligation(
        "renew-before-expiry-scan",
        "fleet/coordinator.py::FleetCoordinator.join",
        first="store:_members", then="call:_expire_locked",
        why="a syncing member is alive by definition; scanning before the "
            "renewal lets a member expire ITSELF (checker invariant "
            "no_self_expiry, mutation expire_before_renew)"),
    BarrierObligation(
        "fence-before-offsets-advance",
        "stream/broker.py::InProcessAssignedConsumer._commit_locked",
        first="call:fence", then="store:_committed",
        why="the fence must refuse a revoked lease BEFORE any offset "
            "advances, or a zombie commit silently moves a partition "
            "someone else owns (checker invariant no_zombie_commit, "
            "mutation drop_fence)"),
    BarrierObligation(
        "fence-wired-into-fleet-consumers",
        "fleet/fleet.py::Fleet.in_process",
        first="kwarg:assigned_consumer:fence",
        why="an assigned consumer without the coordinator fence cannot "
            "fail stale commits (mutation drop_fence)"),
    BarrierObligation(
        "drain-before-ack",
        "fleet/worker.py::FleetWorker._run",
        first="call:engine.run", then="call:coordinator.ack",
        why="the ack releases the revoke barrier; acking before the engine "
            "drained + committed hands partitions over with uncommitted "
            "read-ahead outstanding (checker invariant revoke_barrier, "
            "mutation ack_before_drain)"),
    BarrierObligation(
        "rebalance-populates-revoke-barrier",
        "fleet/coordinator.py::FleetCoordinator._rebalance_locked",
        first="store:_pending",
        why="pairs leaving a live owner must enter the barrier or the new "
            "owner polls before the old owner commits (checker invariant "
            "revoke_barrier, mutation skip_revoke_barrier)"),
    BarrierObligation(
        "expiry-releases-holds",
        "fleet/coordinator.py::FleetCoordinator._expire_locked",
        first="store:_pending",
        why="a dead holder's barrier holds must release on lease expiry — "
            "expiry IS the drain barrier for a dead worker"),
    BarrierObligation(
        "resume-from-group-offsets",
        "stream/broker.py::InProcessAssignedConsumer.__init__",
        first="store:_position", then="store:_committed",
        why="construction must seed positions from the group-durable "
            "offsets before anything consumes — the zero-loss handoff"),
    BarrierObligation(
        "restore-inherits-holds",
        "fleet/coordinator.py::FleetCoordinator.restore_state",
        first="store:_pending",
        why="a successor rebuilding from a snapshot must inherit the "
            "in-flight revoke-barrier holds, or a mid-rebalance failover "
            "re-grants a partition its old owner is still draining "
            "(checker invariant revoke_barrier, mutation "
            "forget_holds_on_failover)"),
    BarrierObligation(
        "release-rides-revoke-barrier",
        "fleet/coordinator.py::FleetCoordinator.request_release",
        first="call:_released.add", then="call:_rebalance_locked",
        why="a scale-in victim must be MARKED released before the re-deal "
            "runs — only then does the deal exclude it and move its pairs "
            "behind the revoke barrier, so the new owners wait for its "
            "drain + commit ack (checker invariant revoke_barrier, "
            "mutation release_before_drain)"),
    BarrierObligation(
        "term-fence-before-install",
        "fleet/control.py::SuccessionCoordinator._elect",
        first="call:gate.try_advance", then="call:_install",
        why="the term CAS must be won BEFORE the reconstructed "
            "coordinator installs — two candidates racing one vacancy "
            "otherwise both lead and double-grant (checker invariant "
            "no_loss under mutation drop_coordinator_lease)"),
    BarrierObligation(
        "zombie-demotes-before-publish",
        "fleet/control.py::SuccessionCoordinator.tick",
        first="call:gate.accept", then="call:control.publish",
        why="a paused-and-resumed leader must consult the term fence "
            "BEFORE publishing beacons/snapshots stamped with its old "
            "term — a zombie that publishes first reasserts a dead term "
            "over the live one (checker invariant no_loss, mutation "
            "stale_term_fence_accepted)"),
)


#: Dotted call patterns that ARE the fleet protocol (FC501 scope): any call
#: site in a fleet module matching one of these must be claimed by a
#: FLEET_PROTOCOLS transition's (anchor, calls) pair — new protocol traffic
#: cannot land unregistered.
FLEET_PROTOCOL_VOCABULARY: Tuple[str, ...] = (
    "coordinator.join", "coordinator.sync", "coordinator.ack",
    "coordinator.leave", "coordinator.fence_lost", "coordinator.tick",
    "coordinator.committed_lag", "coordinator.request_release",
    "provisioner.launch",
    "bus.publish", "bus.retract", "bus.publish_fleet", "bus.snapshots",
)

#: Package-relative path prefixes FC501 scans for vocabulary call sites.
FLEET_PROTOCOL_SCOPE: Tuple[str, ...] = ("fleet/",)


# ---------------------------------------------------------------------------
# Decode-slot lifecycle (explain/slotserve/, docs/explain_serving.md): the
# continuous-batching lane's per-slot protocol, verified by the same
# FC501-FC503 machinery as the fleet choreography. A slot cycles
# free → prefill → decode → drain → free; the safety shapes are (a)
# admissions land at the iteration boundary BEFORE the decode window (free
# slots never idle through a window while requests queue), and (b) a
# finished row is fully resolved (_complete) BEFORE its slot returns to the
# free pool (_release) — slot reuse can never leak an unresolved row.
#
# The PAGE lifecycle rides the same machinery: a paged slot's
# KV pages are mapped (retain shared prefix / COW the partial page / alloc
# suffix) BEFORE its prefill runs, grown at the host side of each iteration
# boundary, and released BEFORE the slot id re-enters the free pool; shared
# prefix pages are never written in place — an admit that would append into
# one copies it first (the "Pages" role + the page obligations below).
# ---------------------------------------------------------------------------

SLOT_PROTOCOLS: Tuple[RoleSpec, ...] = (
    RoleSpec("Slot", "explain/slotserve/service.py::SlotServeService",
             ("free", "prefill", "decode", "drain"), "free", (
        # Iteration boundary: queued requests admit into free slots and
        # prefill (the decoder writes the prompt's k/v into the slot).
        # Paged pools gate the claim on the allocator's free count first
        # (pages_needed) so admission never over-commits the pool.
        _t("admit", "free", "prefill",
           ("explain/slotserve/service.py::SlotServeService._admit_pending",),
           ("_decoder.prefill", "_decoder.pages_needed")),
        # The admitted row joins the decode set (first token emitted).
        _t("first_token", "prefill", "decode",
           ("explain/slotserve/service.py::SlotServeService._admit_pending",),
           ("_emit",)),
        # Host side of the iteration boundary: every busy slot's page
        # table is extended to cover the coming window (no-op contiguous);
        # exhaustion preempts the newest admit as an accounted drop.
        _t("grow", "decode", "decode",
           ("explain/slotserve/service.py::"
            "SlotServeService._ensure_window_pages",),
           ("_decoder.grow_for_window",)),
        # One fused decode window advances every busy slot.
        _t("step", "decode", "decode",
           ("explain/slotserve/service.py::SlotServeService._decode_step",),
           ("_decoder.step",)),
        # EOS/budget: the row leaves the decode set and drains.
        _t("finish", "decode", "drain",
           ("explain/slotserve/service.py::SlotServeService._retire_done",),
           ("_complete",)),
        # Resolution done: the slot returns to the free pool.
        _t("free", "drain", "free",
           ("explain/slotserve/service.py::SlotServeService._retire_done",),
           ("_release",)),
        # Release drops the slot's page references BEFORE the slot id
        # re-enters the free pool (the page-lifecycle obligation below).
        _t("pages_free", "drain", "free",
           ("explain/slotserve/service.py::SlotServeService._release",),
           ("_decoder.release_slot",)),
        # Decoder death: every slot's pages return to the allocator as
        # part of failing the in-flight rows (no leak across the outage).
        _t("death_reset", "decode", "free",
           ("explain/slotserve/service.py::SlotServeService._fail_all",),
           ("_decoder.reset_slots",)),
        # Shutdown: the pool itself quiesces (prefix base refs released,
        # the leak counter recorded — zero at quiescence).
        _t("shutdown", "free", "free",
           ("explain/slotserve/service.py::SlotServeService.close",),
           ("_decoder.close",)),
    )),
    # The page-pool side of the same choreography: what each
    # decoder-level transition does to the refcounted allocator.
    RoleSpec("Pages", "explain/slotserve/decode.py::PagedSlotDecoder",
             ("free", "mapped"), "free", (
        # Admission maps the slot's table: retain shared prefix pages,
        # COW the partial one, alloc fresh suffix pages — all-or-nothing
        # (the except arm releases every reference taken so far).
        _t("map", "free", "mapped",
           ("explain/slotserve/decode.py::"
            "PagedSlotDecoder._table_for_admit",),
           ("allocator.retain", "allocator.alloc", "_cow_prefix_page",
            "allocator.release")),
        # COW: a private copy of the partial shared page — shared pages
        # are never written in place.
        _t("cow", "free", "mapped",
           ("explain/slotserve/decode.py::"
            "PagedSlotDecoder._cow_prefix_page",),
           ("allocator.alloc", "llm.copy_kv_page")),
        # The shared preamble prefills once into base-referenced pages.
        _t("prefix_seed", "free", "mapped",
           ("explain/slotserve/decode.py::PagedSlotDecoder.set_prefix",),
           ("allocator.alloc",)),
        # Window growth allocates cover for lens + steps.
        _t("grow", "mapped", "mapped",
           ("explain/slotserve/decode.py::"
            "PagedSlotDecoder.grow_for_window",),
           ("allocator.alloc",)),
        # Slot release returns every reference the slot holds.
        _t("unmap", "mapped", "free",
           ("explain/slotserve/decode.py::PagedSlotDecoder.release_slot",),
           ("allocator.release",)),
        # Close drops the prefix base refs — quiescence means all free.
        _t("quiesce", "mapped", "free",
           ("explain/slotserve/decode.py::PagedSlotDecoder.close",),
           ("allocator.release",)),
    )),
)

SLOT_BARRIER_OBLIGATIONS: Tuple[BarrierObligation, ...] = (
    BarrierObligation(
        "admission-before-decode",
        "explain/slotserve/service.py::SlotServeService._iteration",
        first="call:_admit_pending", then="call:_decode_step",
        why="admissions must land at the iteration boundary BEFORE the "
            "decode window, or free slots idle through a whole window "
            "while flagged rows queue — the continuous-batching property "
            "itself"),
    BarrierObligation(
        "drain-before-free",
        "explain/slotserve/service.py::SlotServeService._retire_done",
        first="call:_complete", then="call:_release",
        why="a finished row must be fully resolved (text decoded, waiter "
            "released, trace recorded) BEFORE its slot re-enters the free "
            "pool — slot reuse must never leak an unresolved row's state"),
    # -- page lifecycle ------------------------------------------------
    BarrierObligation(
        "pages-mapped-before-prefill",
        "explain/slotserve/decode.py::PagedSlotDecoder.prefill",
        first="call:_table_for_admit", then="call:llm.paged_slot_prefill",
        why="the slot's page table must be fully built (retain/COW/alloc) "
            "BEFORE the prefill program runs — the compiled program "
            "scatters by table entry and must never see an uncovered "
            "write position"),
    BarrierObligation(
        "pages-freed-on-slot-release",
        "explain/slotserve/service.py::SlotServeService._release",
        first="call:_decoder.release_slot", then="call:_free.append",
        why="a slot's page references must return to the allocator BEFORE "
            "the slot id re-enters the free pool — a re-admitted slot "
            "would otherwise double-map pages the old row still holds, "
            "leaking them (the accounting identity breaks)"),
    BarrierObligation(
        "cow-before-suffix-alloc",
        "explain/slotserve/decode.py::PagedSlotDecoder._table_for_admit",
        first="call:_cow_prefix_page", then="call:allocator.alloc",
        why="shared prefix pages are never written in place: the partial "
            "preamble page must be copied-on-write BEFORE fresh suffix "
            "pages are appended, or the admit's suffix k/v would land in "
            "a page every other slot's table reads"),
)

#: Call patterns that ARE the slot protocol (FC501 scope below): any call
#: site in slotserve code matching one must be claimed by a SLOT_PROTOCOLS
#: transition — new decoder traffic cannot land unmodeled. It includes the
#: page-lifecycle traffic: the service-side pool calls and the decoder's
#: allocator calls.
SLOT_PROTOCOL_VOCABULARY: Tuple[str, ...] = (
    "_decoder.prefill", "_decoder.step",
    "_decoder.pages_needed", "_decoder.grow_for_window",
    "_decoder.release_slot", "_decoder.reset_slots", "_decoder.close",
    "allocator.alloc", "allocator.retain", "allocator.release",
)

SLOT_PROTOCOL_SCOPE: Tuple[str, ...] = ("explain/slotserve/",)


# ---------------------------------------------------------------------------
# Hot-loop functions (FC203 host-sync / FC204 ladder-bypass scope): the
# per-batch serving path, where one stray device sync or unwarmed shape
# costs throughput on EVERY batch.
# ---------------------------------------------------------------------------

HOT_PATHS: FrozenSet[str] = frozenset({
    "stream/engine.py::StreamingClassifier._dispatch",
    "stream/engine.py::StreamingClassifier._prepare",
    "stream/engine.py::StreamingClassifier._launch",
    # Device-side featurization: the byte-tensor dispatch runs
    # per micro-batch on the lane thread — a stray host sync or unwarmed
    # shape here costs every batch, same as the engine legs above.
    "models/pipeline.py::ServingPipeline._dispatch_bytes",
    "stream/engine.py::StreamingClassifier._dispatch_raw_json",
    "stream/engine.py::StreamingClassifier._finish",
    "stream/engine.py::StreamingClassifier._deliver",
    "stream/engine.py::StreamingClassifier._assemble_frames_native",
    "stream/engine.py::StreamingClassifier._submit_annotations",
    "stream/engine.py::StreamingClassifier._submit_shadow",
    "sched/scheduler.py::AdaptiveScheduler.collect",
    "sched/scheduler.py::AdaptiveScheduler.admit",
    "sched/scheduler.py::AdaptiveScheduler.observe_batch",
})
