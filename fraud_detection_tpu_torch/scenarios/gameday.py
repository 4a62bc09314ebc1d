"""Game days: scripted multi-failure scenarios as data, with SLO gates —
twin of ``fraud_detection_tpu/scenarios/gameday.py``.

A :class:`GameDay` declares everything about a run — seeded traffic specs
(scenarios/traffic.py), broker faults (:class:`ChaosSpec` →
stream/faults.py ``FaultPlan``), whole-worker deaths (:class:`KillSpec` →
``WorkerDeathPlan``), a scripted hot swap, scheduler/DLQ config — plus the
pass/fail :class:`~fraud_detection_tpu_torch.scenarios.slo.SloSpec` gates judged
from the run's evidence. :func:`run_gameday` executes it against a real
in-process serving stack and returns a :class:`GameDayResult` whose ``ok``
bit is the game day's verdict. Every seeded component derives its stream
from the ONE scenario seed through the :class:`ScenarioClock`, so a game
day is reproducible end to end: same seed ⇒ same traffic bytes, same fault
schedule, same death draws, same timeline.

Two runner modes, chosen by the declaration:

* **fleet** (``workers >= 2`` or a kill spec): ``Fleet.in_process`` —
  partition-owning workers under the lease coordinator, tracing on, the
  seeded death plan armed, traffic fed live by the scenario-feeder thread.
  Chaos here is restricted to NON-LETHAL faults (duplicates, corruption,
  latency, commit fences, lossy flushes): a poll transport error or flush
  crash is an unhandled worker death in the fleet, which is the KILL
  spec's job to script, not the fault plan's.
* **single-engine** (otherwise): one supervised engine
  (``run_supervised``), where the FULL fault vocabulary applies (the
  supervisor is the recovery mechanism under test), and where the explain
  breaker can be exercised: ``breaker_threshold`` wires a deterministic
  dead explain backend (:class:`FlakyExplainBackend`) behind the explain
  circuit breaker, so a campaign wave's flagged burst trips it while
  classification keeps flowing.

The named catalog (:data:`CATALOG`) is the regression surface;
``serve --scenario NAME[:seed]`` drives one against a live serve run. CLI::

    python -m fraud_detection_tpu_torch.scenarios.gameday --name campaign_kill_swap
    python -m fraud_detection_tpu_torch.scenarios.gameday --list
    python -m fraud_detection_tpu_torch.scenarios.gameday --name flash_crowd \
        --device cpu --scale 0.25

exits 0 on a passing verdict, 1 on any failed SLO — the exit code IS the
game-day gate.

Device: the game-day pipeline trains and serves on the card unless the
caller passes ``device="cpu"`` (``--device cpu``); without a card the
runner raises, it never carries on on the CPU by itself.
``featurize_device`` (``--featurize-device``) featurizes on the device
(the ``featurize_packed`` kernel on the card). Every engine, fleet worker
and lane of a run shares the one pipeline.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from fraud_detection_tpu_torch.scenarios.clock import ScenarioClock
from fraud_detection_tpu_torch.scenarios.slo import (SloReport, SloSpec, evaluate,
                                               parse_slo)
from fraud_detection_tpu_torch.scenarios.traffic import (CampaignWave,
                                                   DiurnalLoad,
                                                   DriftCampaign, FlashCrowd,
                                                   SteadyLoad,
                                                   TimelineAction,
                                                   TrafficFeeder, TrafficSpec,
                                                   compose)

INPUT_TOPIC = "scenario-in"
OUTPUT_TOPIC = "scenario-out"
DLQ_TOPIC = "scenario-dlq"
ANNOTATIONS_TOPIC = "scenario-out-annotations"
FEEDBACK_TOPIC = "scenario-feedback"


class FlakyExplainBackend:
    """A deterministically DEAD explain backend: every call raises, like
    an LLM endpoint mid-outage. Wrapped in the circuit breaker it turns a
    campaign wave's flagged burst into the breaker-trip scenario — the
    gate asserts the breaker opened AND classification never stopped."""

    def __init__(self):
        self.calls = 0

    def _fail(self):
        self.calls += 1
        raise ConnectionError(
            "scenario: explain backend down (scripted outage)")

    def chat(self, messages, **kwargs) -> str:
        self._fail()

    def generate(self, prompt: str, **kwargs) -> str:
        self._fail()


@dataclass(frozen=True)
class KillSpec:
    """Seeded whole-worker deaths (stream/faults.py WorkerDeathPlan);
    the seed derives from the scenario clock."""

    kills: int = 1
    modes: Tuple[str, ...] = ("graceful", "crash")
    min_polls: int = 2
    max_polls: int = 8


@dataclass(frozen=True)
class CoordKillSpec:
    """Seeded coordinator-leader deaths (stream/faults.py
    CoordinatorKillSpec); the seed derives from the scenario clock. Kill
    ticks count LEADER ticks, so a second kill lands on the successor —
    ``kills=2`` scripts consecutive failovers. Crash mode leaves no
    dying-breath snapshot: detection waits out ``role_ttl``, which is
    why the catalog's crash scenarios keep role_ttl above the sentinel's
    fast window (the stale rule must see frozen ticks span it)."""

    kills: int = 1
    modes: Tuple[str, ...] = ("graceful", "crash")
    min_ticks: int = 3
    max_ticks: int = 10


@dataclass(frozen=True)
class AutoscaleSpec:
    """Closed-loop elasticity as scenario data (fleet/autoscale/,
    docs/autoscaling.md): the ScalePolicy bounds/hysteresis the fleet
    runner arms, plus the declared surge onset the reaction-latency
    evidence measures from. The autoscaler reads the game day's OWN
    sentinel (``fleet_watermark_burn`` out, ``fleet_idle`` in), so an
    elastic scenario must declare a :class:`SentinelSpec` — the signals
    it scales on are the ones the run's watchdog judges."""

    min_workers: int = 1
    max_workers: int = 4
    cooldown_s: float = 1.0
    out_for_s: float = 0.0
    in_for_s: float = 0.0
    step: int = 1
    # Declared surge onset (virtual s): origin for the
    # ``autoscale_reaction_s`` evidence (first scale_out.at - surge_at_s).
    surge_at_s: float = 0.0

    def policy_kwargs(self) -> dict:
        return {"min_workers": self.min_workers,
                "max_workers": self.max_workers,
                "cooldown_s": self.cooldown_s,
                "out_for_s": self.out_for_s, "in_for_s": self.in_for_s,
                "step": self.step}


@dataclass(frozen=True)
class ExpectedDetection:
    """One seeded fault class and the alert that must catch it: the
    sentinel gate asserts rule ``rule`` FIRES within ``within_s``
    sentinel-clock seconds of ``fault_at_s`` (the fault's virtual
    injection time). Bounds are chosen to hold in BOTH pacing modes: a
    warp run (time_scale 0) collapses the feed to its end stamp and then
    advances one virtual tick per evaluation during the drain, so a warp
    detection latency is bounded below by (timeline end - fault time)."""

    rule: str
    fault_at_s: float = 0.0
    within_s: float = 10.0


@dataclass(frozen=True)
class SentinelSpec:
    """The game day's watchdog (obs/sentinel/, docs/observability.md):
    which rules run, at what virtual cadence, and what they must detect.
    Empty ``rules`` resolves to the default pack (single-engine mode) or
    the fleet pack (fleet mode) with windows scaled to game-day
    durations. ``zero_incidents`` is the clean-control-arm gate: the run
    must end with ``alerts.fired == 0`` (the false-positive gate)."""

    interval_s: float = 0.25
    rules: Tuple = ()                     # obs.sentinel.AlertRule tuple
    expect: Tuple[ExpectedDetection, ...] = ()
    zero_incidents: bool = False

    def __post_init__(self):
        if self.interval_s <= 0:
            raise ValueError(
                f"sentinel interval_s must be > 0, got {self.interval_s}")
        if self.zero_incidents and self.expect:
            raise ValueError(
                "a sentinel spec cannot both expect detections and gate "
                "on zero incidents")

    def resolve_rules(self, fleet_mode: bool) -> Tuple:
        from fraud_detection_tpu_torch.obs.sentinel import (default_rule_pack,
                                                      fleet_rule_pack)

        if self.rules:
            return tuple(self.rules)
        # Game-day-scaled windows: catalog scenarios run seconds, not
        # hours — fast/slow burn windows and hysteresis shrink to match,
        # and the latency/stall limits widen past the warp-mode backlog
        # artifacts (a warp feed enqueues the whole timeline at once, so
        # enqueue->produce latency legitimately reaches seconds).
        if fleet_mode:
            # fast_s is also the delta-observation window: a worker-death
            # membership drop (-1) stays judgeable for fast_s virtual
            # seconds. The sentinel samples from a plain Python thread,
            # and on a 1-core host the GIL-releasing compute threads can
            # starve it for whole wall-seconds mid-drain — a 2 s window
            # can close between two samples while the while-gate's
            # backlog still exists. 8 s keeps the drop in-window for the
            # rest of a catalog run without loosening the gate itself
            # (the clean-drain exit still never fires: its drop happens
            # at committed_lag == 0, and the gate is judged at the
            # CURRENT sample). coordinator_absence is the opposite kind
            # of window — stale only fires once ticks sat frozen for the
            # WHOLE span, so it must stay shorter than the interregnum
            # it catches (~role_ttl); hence the separate stale_s.
            return fleet_rule_pack(backlog_limit=20000.0, fast_s=8.0,
                                   slow_s=16.0, resolve_s=1.0,
                                   stale_s=2.0)
        return default_rule_pack(fast_s=1.0, slow_s=4.0, for_s=0.0,
                                 resolve_s=1.0, p99_ms=60000.0,
                                 stall_s=30.0, dlq_limit=0.0005)


@dataclass(frozen=True)
class LearnSpec:
    """The closed learning loop, declared as scenario data
    (learn/, docs/online_learning.md). The runner publishes the pipeline
    as v1 in a fresh registry, wires the label lane (the
    scenarios/labels.py ground-truth oracle feeds ``feedback_topic``),
    runs the learn-lane beside the engine, and rides the REAL
    ``LifecycleController`` stage→shadow→judge→promote path — ``policy``
    is the ``PromotionPolicy`` spec string the auto-promotion gates
    run with (a drift-correcting candidate legitimately disagrees with
    the drifted primary, so the drift-tuned defaults allow more
    disagreement than a like-for-like rollout would)."""

    min_labeled: int = 120          # evidence floor before any retrain
    min_new_labels: int = 32
    error_threshold: float = 0.12   # drift trigger (recent label error)
    error_window: int = 256
    refresh_rounds: int = 6
    window: int = 8192
    label_delay_s: float = 0.2      # virtual label latency
    policy: str = ("min_batches=1,min_rows=128,max_disagreement=0.7,"
                   "max_psi=50.0,max_flag_rate_delta=0.8")
    drift_at_s: float = 0.0         # drift onset (promotion-latency origin)
    promote_within_s: float = 60.0  # virtual drift->promotion bound
    settle_s: float = 120.0         # wall bound for retrain+judge to land

    def __post_init__(self):
        if self.settle_s <= 0:
            raise ValueError(f"settle_s must be > 0, got {self.settle_s}")


@dataclass(frozen=True)
class ChaosSpec:
    """Seeded broker-fault rates (stream/faults.py FaultPlan). The
    lethal kinds (poll errors, flush crashes) are single-engine only —
    GameDay validation enforces it (see module docstring)."""

    poll_error_rate: float = 0.0
    latency_spike_rate: float = 0.0
    duplicate_rate: float = 0.0
    corrupt_rate: float = 0.0
    flush_fail_rate: float = 0.0
    flush_crash_rate: float = 0.0
    commit_fence_rate: float = 0.0
    max_faults: int = 40

    @property
    def lethal(self) -> bool:
        return self.poll_error_rate > 0 or self.flush_crash_rate > 0


@dataclass(frozen=True)
class GameDay:
    """One scripted scenario, declared as data (see module docstring)."""

    name: str
    description: str
    traffic: Tuple[TrafficSpec, ...]
    slos: Tuple[SloSpec, ...]
    seed: int = 0
    partitions: int = 4
    workers: int = 1
    batch_size: int = 256
    max_wait: float = 0.02
    sched: Optional[object] = None        # sched.SchedulerConfig
    dlq: bool = False
    kills: Optional[KillSpec] = None
    # Coordinator succession (fleet/control.py, docs/fleet.md
    # "Coordinator succession"): candidates >= 2 runs the fleet under a
    # SuccessionCoordinator — the coordinator role itself is leased and
    # coordinator_kills scripts the leader's death; a standby candidate
    # must win the term election and inherit assignment state from the
    # compacted control topic. role_ttl is the vacancy-detection window
    # (defaults to lease_ttl / 2 inside the coordinator).
    candidates: int = 1
    role_ttl: Optional[float] = None
    coordinator_kills: Optional[CoordKillSpec] = None
    # Closed-loop autoscaling (fleet/autoscale/, docs/autoscaling.md):
    # the fleet sizes itself from the run's sentinel signals — scale-out
    # on the burn, voluntary-leave scale-in on sustained idle, every
    # decision term-stamped on the control lane and judged by the SLOs
    # over the evidence's ``autoscale`` block.
    autoscale: Optional[AutoscaleSpec] = None
    # Declared pacing: elasticity is judged against the SLOPE of the
    # load, so elastic scenarios pin time_scale (1.0 = real time) instead
    # of inheriting the caller's warp default — a warp feed lands the
    # whole tide in an instant and there is no curve left to track. An
    # explicit nonzero --time-scale still wins.
    time_scale: Optional[float] = None
    chaos: Optional[ChaosSpec] = None
    hot_swap_at: Optional[float] = None   # virtual seconds
    breaker_threshold: Optional[int] = None
    # Slot-based continuous-batching explain lane (explain/slotserve/,
    # docs/explain_serving.md): N decode slots serve every flagged row
    # through the async annotation lane; evidence gains the coverage
    # accounting the explain_coverage gate judges.
    explain_slots: Optional[int] = None
    explain_queue: int = 48               # lane queue bound (small = drops
                                          # exercised; every drop records)
    explain_tokens: int = 12
    # Paged-KV variant of the slotserve lane (docs/explain_serving.md
    # "Paged KV and prefix sharing"): the lane's KV cache becomes a
    # refcounted page pool with the shared explain preamble prefilled
    # once, and ``explain_kv_pages`` caps the pool — pick a budget where
    # the contiguous per-slot cache could NOT fit ``explain_slots`` slots
    # and the coverage gate proves paging holds the line anyway.
    explain_paged: bool = False
    explain_kv_pages: Optional[int] = None
    # The run's watchdog (obs/sentinel/): rules evaluated on the scenario
    # clock while the game day runs, with detects_within gates per seeded
    # fault class — or the zero-incident false-positive gate on the clean
    # control arm (docs/observability.md "Detection-latency gates").
    sentinel: Optional[SentinelSpec] = None
    # The closed learning loop (learn/, docs/online_learning.md): window
    # store + label lane + windowed retrain + auto shadow->promote
    # through the registry lifecycle — single-engine only, and the
    # pipeline must be a boosted-tree model (the warm-start refresh's
    # input): ``model`` picks the demo family.
    learn: Optional[LearnSpec] = None
    model: str = "lr"
    lease_ttl: float = 1.0
    supervise: int = 25
    idle_timeout: float = 1.0

    def __post_init__(self):
        if not self.traffic:
            raise ValueError(f"game day {self.name!r} declares no traffic")
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.fleet_mode:
            if self.breaker_threshold is not None:
                raise ValueError(
                    f"game day {self.name!r}: the explain breaker lane is "
                    "single-engine only (the fleet does not wire explain)")
            if self.explain_slots is not None:
                raise ValueError(
                    f"game day {self.name!r}: the slotserve explain lane "
                    "is single-engine only (the fleet does not wire "
                    "explain)")
            if self.chaos is not None and self.chaos.lethal:
                raise ValueError(
                    f"game day {self.name!r}: poll errors / flush crashes "
                    "kill fleet workers outright — script worker deaths "
                    "with KillSpec instead")
        elif self.kills is not None:
            raise ValueError(
                f"game day {self.name!r}: worker kills need the fleet "
                "runner (workers >= 2)")
        if self.candidates < 1:
            raise ValueError(
                f"candidates must be >= 1, got {self.candidates}")
        if not self.fleet_mode and (self.candidates > 1
                                    or self.coordinator_kills is not None):
            raise ValueError(
                f"game day {self.name!r}: coordinator succession needs "
                "the fleet runner (workers >= 2)")
        if self.coordinator_kills is not None:
            if self.candidates < 2:
                raise ValueError(
                    f"game day {self.name!r}: killing the coordinator "
                    "needs a standby to succeed it (candidates >= 2)")
            if self.coordinator_kills.kills >= self.candidates:
                raise ValueError(
                    f"game day {self.name!r}: "
                    f"{self.coordinator_kills.kills} coordinator kills "
                    f"with {self.candidates} candidates leaves nobody to "
                    "coordinate")
        if self.breaker_threshold is not None and self.explain_slots is not None:
            raise ValueError(
                f"game day {self.name!r}: breaker_threshold scripts a DEAD "
                "explain backend; pick it or explain_slots, not both "
                "(breaker-over-slotserve is pinned at the engine level in "
                "tests/test_slotserve.py)")
        if self.explain_slots is not None and self.explain_slots < 1:
            raise ValueError(
                f"game day {self.name!r}: explain_slots must be >= 1, "
                f"got {self.explain_slots}")
        if self.explain_paged and self.explain_slots is None:
            raise ValueError(
                f"game day {self.name!r}: explain_paged pages the "
                "slotserve lane's KV cache — it needs explain_slots")
        if self.explain_kv_pages is not None:
            if not self.explain_paged:
                raise ValueError(
                    f"game day {self.name!r}: explain_kv_pages caps the "
                    "paged pool; set explain_paged=True")
            if self.explain_kv_pages < 1:
                raise ValueError(
                    f"game day {self.name!r}: explain_kv_pages must be "
                    f">= 1, got {self.explain_kv_pages}")
        if self.learn is not None:
            if self.fleet_mode:
                raise ValueError(
                    f"game day {self.name!r}: the learn loop is "
                    "single-engine only (one registry/lifecycle per run)")
            if self.hot_swap_at is not None:
                raise ValueError(
                    f"game day {self.name!r}: learn owns the hot-swap "
                    "path (promotion IS the swap) — drop hot_swap_at")
            if self.model != "xgb":
                raise ValueError(
                    f"game day {self.name!r}: the learn loop warm-starts "
                    f"boosted trees; set model='xgb' (got {self.model!r})")
        if self.autoscale is not None:
            if not self.fleet_mode:
                raise ValueError(
                    f"game day {self.name!r}: autoscaling needs the fleet "
                    "runner (workers >= 2)")
            if self.sentinel is None:
                raise ValueError(
                    f"game day {self.name!r}: the autoscaler is signal-"
                    "driven — declare a SentinelSpec (the fleet pack "
                    "carries fleet_watermark_burn / fleet_idle)")
            a = self.autoscale
            if not (a.min_workers <= self.workers <= a.max_workers):
                raise ValueError(
                    f"game day {self.name!r}: workers ({self.workers}) "
                    f"must sit inside the autoscale bounds "
                    f"[{a.min_workers}, {a.max_workers}]")
        if self.time_scale is not None and self.time_scale <= 0:
            raise ValueError(
                f"game day {self.name!r}: declared time_scale must be "
                f"> 0 (got {self.time_scale}); leave it None for warp")
        if self.sentinel is not None and self.sentinel.expect:
            known = {r.name for r in
                     self.sentinel.resolve_rules(self.fleet_mode)}
            missing = [e.rule for e in self.sentinel.expect
                       if e.rule not in known]
            if missing:
                raise ValueError(
                    f"game day {self.name!r}: detects_within expects "
                    f"rules not in the sentinel pack: {missing} "
                    f"(pack: {sorted(known)})")

    @property
    def fleet_mode(self) -> bool:
        return self.workers >= 2

    def duration_s(self) -> float:
        return max(s.at_s + s.duration_s for s in self.traffic)


@dataclass
class GameDayResult:
    scenario: str
    seed: int
    mode: str
    report: SloReport
    evidence: dict              # summary evidence (key lists reduced)
    wall_s: float

    @property
    def ok(self) -> bool:
        return self.report.ok

    def as_dict(self) -> dict:
        return {"scenario": self.scenario, "seed": self.seed,
                "mode": self.mode, "ok": self.ok,
                "wall_s": round(self.wall_s, 3),
                "slo": self.report.as_dict(), "evidence": self.evidence}

    def table(self) -> str:
        head = (f"game day {self.scenario!r} (seed {self.seed}, "
                f"{self.mode}): {'PASS' if self.ok else 'FAIL'} "
                f"in {self.wall_s:.1f}s")
        return head + "\n" + self.report.table()


def _default_pipeline(batch_size: int, seed: int = 7, model: str = "lr", *,
                      device="cuda", featurize_device: bool = False):
    from fraud_detection_tpu_torch.models.pipeline import synthetic_demo_pipeline

    # Separable corpus: scenario rows are drawn from the same families,
    # so flagged-row lanes (breaker, annotation) see real pressure.
    return synthetic_demo_pipeline(
        batch_size=batch_size, n=300, seed=seed, num_features=2048,
        model=model,
        corpus_kwargs=dict(hard_fraction=0.0, label_noise=0.0),
        featurize_device=featurize_device, device=device)


def _fault_plan(gd: GameDay, clock: ScenarioClock):
    if gd.chaos is None:
        return None
    from fraud_detection_tpu_torch.stream.faults import FaultPlan

    c = gd.chaos
    return FaultPlan(
        seed=clock.derive_seed("faults"),
        poll_error_rate=c.poll_error_rate,
        latency_spike_rate=c.latency_spike_rate,
        latency_spike_sec=0.001,
        duplicate_rate=c.duplicate_rate, corrupt_rate=c.corrupt_rate,
        flush_fail_rate=c.flush_fail_rate,
        flush_crash_rate=c.flush_crash_rate,
        commit_fence_rate=c.commit_fence_rate, max_faults=c.max_faults,
        sleep=((lambda s: None) if clock.time_scale == 0.0 else time.sleep))


def _swap_setup(gd: GameDay, pipeline, clock: ScenarioClock,
                actions: List[TimelineAction]):
    """Wrap the pipeline for the scripted hot swap and append the swap
    action: a v2 candidate (freshly trained, pre-built off-timeline so the
    timeline only pays the swap itself) lands mid-scenario through the
    zero-downtime RCU path every worker scores through."""
    if gd.hot_swap_at is None:
        return pipeline, None
    from fraud_detection_tpu_torch.registry.hotswap import HotSwapPipeline

    hot = HotSwapPipeline(pipeline, version=1)
    candidate = _default_pipeline(
        gd.batch_size, seed=clock.derive_seed("candidate") % 9973,
        device=pipeline.device,
        featurize_device=pipeline.device_stats.featurize_path != "host")
    actions.append(TimelineAction(
        gd.hot_swap_at, "hot_swap_v2",
        lambda: hot.swap(candidate, version=2)))
    return hot, hot


def _learn_setup(gd: GameDay, pipeline, clock: ScenarioClock):
    """Registry-backed serving for the learn loop: the pipeline publishes
    as v1 in a fresh registry and every worker scores through ONE
    HotSwapPipeline — promotion IS the run's zero-downtime hot swap."""
    import tempfile

    from fraud_detection_tpu_torch.registry import ModelRegistry
    from fraud_detection_tpu_torch.registry.hotswap import HotSwapPipeline

    root = tempfile.mkdtemp(prefix="gameday-registry-")
    registry = ModelRegistry(root)
    registry.publish(pipeline.featurizer, pipeline.model,
                     metrics={"origin": f"gameday:{gd.name}:v1"})
    hot = HotSwapPipeline(pipeline, version=1)
    return hot, hot, {"registry": registry, "root": root}


def _wait_for_feed(feeder: TrafficFeeder, n: int, timeout: float = 30.0):
    """Block until the feeder has produced ``n`` rows (or finished/died):
    workers idle-exit on an empty topic, so traffic must visibly exist
    before the serving side starts its idle clock."""
    deadline = time.monotonic() + timeout
    target = min(n, len(feeder.events))
    while time.monotonic() < deadline:
        if feeder.fed >= target or feeder.error is not None:
            return
        if not feeder.alive():
            return
        time.sleep(0.005)


def run_gameday(gd: GameDay, *, pipeline=None, time_scale: float = 0.0,
                extra_slos: Sequence[SloSpec] = (),
                record_path: Optional[str] = None, device=None,
                featurize_device: bool = False) -> GameDayResult:
    """Execute a game day and judge its SLOs (see module docstring).
    ``device`` defaults to the given pipeline's device, else the card;
    ``featurize_device`` applies to the pipeline built here."""
    from fraud_detection_tpu_torch.stream import InProcessBroker
    from fraud_detection_tpu_torch.utils.device import resolve_device

    if device is None:
        device = pipeline.device if pipeline is not None else "cuda"
    device = resolve_device(device)
    if pipeline is not None and pipeline.device != device:
        raise ValueError(
            f"game day {gd.name!r}: the pipeline serves on "
            f"{pipeline.device}, not on the requested {device}")

    if time_scale == 0.0 and gd.time_scale is not None:
        # The scenario declares its pacing (elastic tides are judged
        # against the slope); an explicit nonzero --time-scale still wins.
        time_scale = gd.time_scale
    clock = ScenarioClock(gd.seed, time_scale=time_scale)
    events = compose(gd.traffic, clock)
    if not events:
        raise ValueError(f"game day {gd.name!r} generated zero rows")
    actions: List[TimelineAction] = []
    if pipeline is None:
        pipeline = _default_pipeline(gd.batch_size, model=gd.model,
                                     device=device,
                                     featurize_device=featurize_device)
    serving, hot = _swap_setup(gd, pipeline, clock, actions)
    learn_ctx = None
    if gd.learn is not None:
        serving, hot, learn_ctx = _learn_setup(gd, pipeline, clock)
    broker = InProcessBroker(num_partitions=gd.partitions)
    feeder = TrafficFeeder(broker.producer(), INPUT_TOPIC, events, clock,
                           actions=actions)
    plan = _fault_plan(gd, clock)

    t0 = time.perf_counter()
    if gd.fleet_mode:
        evidence = _run_fleet(gd, serving, broker, feeder, plan, clock)
    else:
        evidence = _run_single(gd, serving, broker, feeder, plan, clock,
                               learn_ctx)
    wall = time.perf_counter() - t0

    evidence.update({
        "scenario": gd.name, "seed": gd.seed,
        "mode": "fleet" if gd.fleet_mode else "single",
        "planned": len(events),
        "fed": feeder.fed,
        "feeder": feeder.stats(),
        "fed_keys": [e.key.decode() for e in events],
        "out_keys": [m.key.decode() for m in broker.messages(OUTPUT_TOPIC)
                     if m.key is not None],
        "dlq_keys": [m.key.decode() for m in broker.messages(DLQ_TOPIC)
                     if m.key is not None],
        "swaps": hot.swaps if hot is not None else 0,
        "chaos": plan.report() if plan is not None else None,
        "wall_s": round(wall, 3),
    })
    evidence["shed_fraction"] = round(
        (evidence.get("stats") or {}).get("shed", 0)
        / max(1, len(events)), 4)
    if feeder.error is not None:
        evidence.setdefault("errors", []).append(
            f"feeder: {feeder.error!r}")

    # Sentinel gates (docs/observability.md "Detection-latency gates"):
    # every expected detection becomes a detects_within SLO, and the
    # clean control arm gates on zero incidents — auto-derived from the
    # declaration so a scenario cannot declare a watchdog it forgets to
    # judge.
    auto_slos: List[SloSpec] = []
    if gd.sentinel is not None:
        evidence["fault_times"] = {e.rule: e.fault_at_s
                                   for e in gd.sentinel.expect}
        for e in gd.sentinel.expect:
            auto_slos.append(SloSpec(f"detects_{e.rule}",
                                     kind="detects_within", path=e.rule,
                                     limit=e.within_s))
        if gd.sentinel.zero_incidents:
            auto_slos.append(SloSpec("zero_incidents", path="alerts.fired",
                                     op="==", limit=0))
    # Spec-conformance gate: any run that recorded a control-lane
    # journal must replay cleanly against the FLEET_PROTOCOLS role
    # machines — auto-derived (like the sentinel gates above) so a
    # succession-enabled scenario cannot skip the audit.
    if evidence.get("conformance") is not None:
        auto_slos.append(SloSpec(
            "spec_conformance", path="conformance.violation_count",
            op="==", limit=0))

    report = evaluate(tuple(gd.slos) + tuple(auto_slos) + tuple(extra_slos),
                      evidence, scope="gameday")
    # Verdict-line summary: the full evidence fed the gates above; the
    # committed line keeps counts and the interesting blocks, not the key
    # lists or whole health trees.
    summary = {k: v for k, v in evidence.items()
               if k not in ("fed_keys", "out_keys", "dlq_keys", "health",
                            "stage_latency_ms", "traces", "alerts")}
    if record_path is not None:
        # The `flightcheck conform` recording: the control-lane journal
        # plus the verdicts it fed, in the evidence shape
        # conformance.extract_trace understands.
        with open(record_path, "w", encoding="utf-8") as f:
            json.dump({"scenario": gd.name, "seed": gd.seed,
                       "evidence": {
                           "succession": evidence.get("succession"),
                           "conformance": evidence.get("conformance"),
                       }}, f, indent=2)
    if isinstance(summary.get("succession"), dict):
        # The raw control-lane journal fed the spec_conformance gate
        # above (and `flightcheck conform` can replay it from a full
        # recording via --record); the committed verdict line keeps its
        # verdict, not its thousands of records.
        summary["succession"] = {k: v for k, v in
                                 summary["succession"].items()
                                 if k != "trace"}
    alerts = evidence.get("alerts")
    if isinstance(alerts, dict):
        summary["alerts"] = {
            "evaluations": alerts.get("evaluations"),
            "fired": alerts.get("fired"),
            "resolved": alerts.get("resolved"),
            "still_firing": alerts.get("still_firing"),
            "firing": alerts.get("firing"),
            "incidents": [{k: i.get(k) for k in
                           ("rule", "severity", "fired_at", "resolved_at")}
                          for i in alerts.get("incidents") or []],
        }
    summary["out_rows"] = len(evidence["out_keys"])
    summary["dlq_rows"] = len(evidence["dlq_keys"])
    summary["traces"] = [
        {k: t.get(k) for k in ("worker", "spans_open", "batches_traced",
                               "batches_closed", "ring_dropped")}
        for t in evidence.get("traces") or []]
    return GameDayResult(gd.name, gd.seed,
                         "fleet" if gd.fleet_mode else "single",
                         report, summary, wall)


def _run_fleet(gd: GameDay, serving, broker, feeder: TrafficFeeder,
               plan, clock: ScenarioClock) -> dict:
    from fraud_detection_tpu_torch.fleet import Fleet
    from fraud_detection_tpu_torch.stream.faults import (CoordinatorKillSpec,
                                                   WorkerDeathPlan)

    death_plan = None
    if gd.kills is not None:
        k = gd.kills
        death_plan = WorkerDeathPlan(
            seed=clock.derive_seed("deaths"), kills=k.kills,
            min_polls=k.min_polls, max_polls=k.max_polls, modes=k.modes)
    coord_kill = None
    if gd.coordinator_kills is not None:
        ck = gd.coordinator_kills
        coord_kill = CoordinatorKillSpec(
            seed=clock.derive_seed("coordinator_kills"), kills=ck.kills,
            min_ticks=ck.min_ticks, max_ticks=ck.max_ticks,
            modes=ck.modes)
    dlq_topic = DLQ_TOPIC if (gd.dlq or (
        gd.sched is not None and gd.sched.shed_policy != "none")) else None
    sentinel_kw = {}
    if gd.sentinel is not None:
        # Coordinator-level watchdog on the scenario clock: the fleet
        # sentinel stamps virtual seconds (same VirtualCadence semantics
        # as the single-engine runner, stepped at the monitor tick), so
        # detects_within judges warp and paced fleet runs on one axis.
        from fraud_detection_tpu_torch.obs.sentinel import VirtualCadence

        sentinel_kw = dict(
            sentinel_rules=gd.sentinel.resolve_rules(fleet_mode=True),
            sentinel_clock=VirtualCadence(clock.now, 0.02))
    fleet = Fleet.in_process(
        broker, serving, INPUT_TOPIC, OUTPUT_TOPIC, gd.workers,
        batch_size=gd.batch_size, max_wait=gd.max_wait,
        sched_config=gd.sched, dlq_topic=dlq_topic,
        death_plan=death_plan, lease_ttl=gd.lease_ttl,
        heartbeat_interval=0.02, tick_interval=0.02,
        candidates=gd.candidates, role_ttl=gd.role_ttl,
        coordinator_kill=coord_kill,
        autoscale=(gd.autoscale.policy_kwargs()
                   if gd.autoscale is not None else None),
        fault_plan=plan, trace=True, trace_sample=1.0, **sentinel_kw)
    feeder.start()
    _wait_for_feed(feeder, n=min(64, len(feeder.events)))
    # Workers self-drain once input is idle AND the group's committed lag
    # clears; the idle window must outlast the timeline's longest paced gap.
    gaps = [b - a for a, b in zip([e.t for e in feeder.events],
                                  [e.t for e in feeder.events][1:])]
    idle = max(gd.idle_timeout,
               2.0 * clock.time_scale * max(gaps, default=0.0))
    out = fleet.run(idle_timeout=idle, join_timeout=300.0)
    feeder.join(timeout=120.0)
    # Scale-out reaction latency in VIRTUAL seconds: decision stamps ride
    # the sentinel's clock (VirtualCadence above), so the first
    # scale_out's ``at`` minus the DECLARED surge onset is comparable
    # across pacings and hosts (docs/autoscaling.md, the bench's
    # ``autoscale`` section trends it).
    reaction = None
    if gd.autoscale is not None:
        outs = [d for d in (out.get("autoscale") or {}).get(
                    "decisions") or [] if d.get("kind") == "scale_out"]
        if outs:
            reaction = round(outs[0]["at"] - gd.autoscale.surge_at_s, 3)
    return {
        "autoscale": out.get("autoscale"),
        "autoscale_reaction_s": reaction,
        "stats": {k: v for k, v in out.items()
                  if not isinstance(v, (dict, list))},
        "workers": out["workers"],
        "per_worker_processed": out["per_worker_processed"],
        "incarnations": out["incarnations"],
        "rebalances": out["rebalances"],
        "lease_expirations": out["lease_expirations"],
        "deaths": len(out["deaths"]),
        "death_plan": out.get("death_plan"),
        "errors": list(out["errors"]),
        "stage_latency_ms": out.get("stage_latency_ms"),
        "traces": [t.snapshot() for t in fleet.tracers.values()],
        "alerts": out.get("alerts"),
        "worker_alerts": out.get("worker_alerts"),
        "succession": out.get("succession"),
        "conformance": _conformance_block(out.get("succession")),
    }


def _conformance_block(succ) -> "Optional[dict]":
    """Replay the run's control-lane journal against the declared role
    machines (analysis/conformance.py) — the `spec_conformance` SLO
    gates on ``violation_count == 0``, so every succession-enabled game
    day proves the implementation and the model-checked spec agree."""
    if not isinstance(succ, dict) or not succ.get("trace"):
        return None
    from fraud_detection_tpu_torch.analysis import conformance

    records, ctx = conformance.extract_trace(succ)
    violations = conformance.check_records(
        records, handoffs=ctx.get("handoffs"),
        lost=ctx.get("lost", 0), reordered=ctx.get("reordered", 0))
    return conformance.summarize(violations, len(records))


def _run_single(gd: GameDay, serving, broker, feeder: TrafficFeeder,
                plan, clock: ScenarioClock, learn_ctx=None) -> dict:
    from fraud_detection_tpu_torch.obs.trace import RowTracer
    from fraud_detection_tpu_torch.stream.engine import (StreamingClassifier,
                                                   run_supervised)

    tracer = RowTracer(worker="gd0", sample=1.0, capacity=65536)
    scheduler = None
    if gd.sched is not None:
        from fraud_detection_tpu_torch.sched import AdaptiveScheduler

        scheduler = AdaptiveScheduler(gd.sched, gd.batch_size)
    dlq_topic = (DLQ_TOPIC if (gd.dlq or plan is not None
                               or (scheduler is not None and scheduler.sheds))
                 else None)
    breaker = None
    hook = None
    explain_service = None
    explain_async = gd.explain_slots is not None
    annotations_agg = {"submitted": 0, "annotated": 0, "dropped": 0,
                       "drop_records": 0, "backend_errors": 0}
    if gd.breaker_threshold is not None:
        from fraud_detection_tpu_torch.explain import (CircuitBreakerBackend,
                                                 make_stream_explain_hook)

        breaker = CircuitBreakerBackend(
            FlakyExplainBackend(), failure_threshold=gd.breaker_threshold,
            probe_interval=600.0)
        hook = make_stream_explain_hook(breaker, max_tokens=32)
    elif explain_async:
        # Slotserve lane (docs/explain_serving.md): a tiny seeded on-pod
        # model serves every flagged row through the slot pool behind the
        # async annotation lane; the lane's SMALL queue (gd.explain_queue)
        # makes campaign waves exercise drop-OLDEST, and every drop leaves
        # a structured record — coverage stays exactly 1.0.
        from fraud_detection_tpu_torch.explain.slotserve import (
            SlotServeService, make_slot_explain_hook)
        from fraud_detection_tpu_torch.models.llm import (LanguageModel,
                                                    TransformerConfig)

        lm = LanguageModel.init_random(
            TransformerConfig(d_model=64, n_layers=2, n_heads=4, d_ff=128,
                              max_seq=1024),
            seed=clock.derive_seed("explain-lm") % (2 ** 31),
            device=serving.device)
        # Paged variant: prompt_width widens to 448 so the ~293-token
        # shared explain preamble fits ahead of the transcript (at 256
        # the service degrades to unshared with a warning), and the page
        # pool is capped at gd.explain_kv_pages — a budget the scenario
        # picks so the contiguous cache could not fit this slot count.
        paged_kw: dict = {}
        width = 256
        if gd.explain_paged:
            width = 448
            paged_kw = {"paged": True}     # 64-position pages
            if gd.explain_kv_pages is not None:
                paged_kw["kv_pages"] = gd.explain_kv_pages
        explain_service = SlotServeService(
            lm, slots=gd.explain_slots, max_queue=4096,
            max_new_tokens=gd.explain_tokens, prompt_width=width,
            rowtrace=tracer, **paged_kw)
        hook = make_slot_explain_hook(explain_service,
                                      max_tokens=gd.explain_tokens)

    dlq_attempts: dict = {}
    engines: list = []

    # The closed learning loop (learn/, docs/online_learning.md): label
    # oracle -> feedback topic -> learn-lane window joins -> windowed
    # warm-started retrain -> registry publish -> the REAL
    # LifecycleController stages, shadow-judges, and auto-promotes.
    learn_loop = None
    shadow = None
    controller = None
    label_feeder = None
    watch_stop = None
    watch_thread = None
    if learn_ctx is not None:
        from fraud_detection_tpu_torch.learn import LearnConfig, LearnLoop
        from fraud_detection_tpu_torch.registry import (LifecycleController,
                                                  PromotionPolicy,
                                                  ShadowScorer)
        from fraud_detection_tpu_torch.scenarios.labels import LabelFeeder

        ls = gd.learn
        shadow = ShadowScorer(max_queue=64, sample=1.0, window_batches=32)
        learn_loop = LearnLoop(
            feedback_consumer=broker.consumer([FEEDBACK_TOPIC], "learn"),
            registry=learn_ctx["registry"], hotswap=serving, shadow=shadow,
            config=LearnConfig(
                window=ls.window, min_labeled=ls.min_labeled,
                min_new_labels=ls.min_new_labels,
                error_threshold=ls.error_threshold,
                error_window=ls.error_window,
                refresh_rounds=ls.refresh_rounds, cooldown_s=1.0),
            now_fn=clock.now)
        controller = LifecycleController(
            learn_ctx["registry"], serving, shadow=shadow,
            policy=PromotionPolicy.parse(ls.policy),
            batch_size=gd.batch_size,
            health_fn=lambda: (engines[-1].health() if engines else None),
            on_transition=learn_loop.on_transition)
        learn_loop.bind_controller(controller)
        label_feeder = LabelFeeder(
            broker.consumer([INPUT_TOPIC], "scenario-labels"),
            broker.producer(), FEEDBACK_TOPIC, clock=clock,
            delay_s=ls.label_delay_s).start()
        watch_thread, watch_stop = controller.run_in_thread(interval=0.05)

    # The watchdog (obs/sentinel/): ONE sentinel shared across the
    # supervised incarnation chain (like the tracer and the poison
    # tracker), reading the LIVE engine's health on the scenario clock —
    # VirtualCadence stamps evaluations in virtual seconds, and the
    # sentinel thread's wall cadence scales with time_scale (warp runs
    # evaluate every interval_s WALL seconds during the drain, advancing
    # one virtual tick each), so warp and paced game days judge detection
    # latency on the same axis.
    sentinel = None
    sentinel_source = None
    finish_sentinel = lambda: None  # noqa: E731 — mirrors serve's finishers
    if gd.sentinel is not None:
        from fraud_detection_tpu_torch.obs.sentinel import (ChainedHealthSource,
                                                      Sentinel,
                                                      VirtualCadence,
                                                      start_sentinel)

        # Chain-cumulative counters: a chaos run's restart chain must
        # read as monotonic burns + a supervisor.restarts counter, not as
        # per-incarnation resets the sampling cadence can miss.
        sentinel_source = ChainedHealthSource()
        sentinel = Sentinel(
            sentinel_source,
            gd.sentinel.resolve_rules(fleet_mode=False),
            clock=VirtualCadence(clock.now, gd.sentinel.interval_s),
            worker="gd0")
        wall_interval = gd.sentinel.interval_s * (
            clock.time_scale if clock.time_scale > 0 else 1.0)
        finish_sentinel = start_sentinel([sentinel], wall_interval)

    def harvest_annotations(engine) -> None:
        engine.close_annotations(timeout=120.0)
        s = engine.annotation_stats() or {}
        for k in annotations_agg:
            annotations_agg[k] += s.get(k, 0)

    def make_engine():
        consumer = broker.consumer([INPUT_TOPIC], "gameday")
        producer = broker.producer()
        if plan is not None:
            consumer, producer = plan.consumer(consumer), plan.producer(producer)
        if engines and explain_async:
            # One live lane at a time: drain + harvest the replaced
            # incarnation's counters (serve.py's make_engine contract).
            harvest_annotations(engines[-1])
        engine = StreamingClassifier(
            serving, consumer, producer, OUTPUT_TOPIC,
            batch_size=gd.batch_size, max_wait=gd.max_wait,
            explain_batch_fn=hook, breaker=breaker,
            explain_async=explain_async,
            annotations_producer=(broker.producer() if explain_async
                                  else None),
            annotations_topic=ANNOTATIONS_TOPIC,
            annotations_queue=gd.explain_queue,
            explain_service=explain_service,
            dlq_topic=dlq_topic, dlq_attempts=dlq_attempts,
            scheduler=scheduler, rowtrace=tracer, sentinel=sentinel,
            shadow=shadow, learn=learn_loop)
        engines.append(engine)
        if sentinel_source is not None:
            sentinel_source.attach(engine)
        return engine

    feeder.start()
    _wait_for_feed(feeder, n=min(64, len(feeder.events)))
    gaps = [b - a for a, b in zip([e.t for e in feeder.events],
                                  [e.t for e in feeder.events][1:])]
    idle = max(gd.idle_timeout,
               2.0 * clock.time_scale * max(gaps, default=0.0))
    backoff_rng = random.Random(clock.derive_seed("backoff"))
    sleep = ((lambda s: time.sleep(min(s, 0.01)))
             if clock.time_scale == 0.0 else time.sleep)
    from fraud_detection_tpu_torch.stream.engine import StreamStats, _merge_stats

    total = StreamStats()
    errors: List[str] = []
    # The supervisor exits when input goes idle; re-enter while the feeder
    # is still producing (paced timelines have real gaps) or committed lag
    # remains — bounded rounds so a wedged run still terminates.
    for _ in range(5):
        try:
            stats = run_supervised(make_engine, max_restarts=gd.supervise,
                                   idle_timeout=idle, sleep=sleep,
                                   rng=backoff_rng)
            _merge_stats(total, stats)
            total.restarts += stats.restarts
        except Exception as e:  # noqa: BLE001 — verdict-level failure
            errors.append(repr(e))
            stats = getattr(e, "supervisor_stats", None)
            if stats is not None:
                _merge_stats(total, stats)
            break
        if (not feeder.alive()
                and broker.group_lag("gameday", [INPUT_TOPIC]) <= 0):
            break
    feeder.join(timeout=120.0)
    learn_out: Optional[dict] = None
    if learn_ctx is not None:
        learn_out = _settle_learn(gd, broker, learn_loop, shadow,
                                  controller, label_feeder, watch_stop,
                                  watch_thread, serving, learn_ctx)
    # Stop the watchdog with a FINAL evaluation pass, so a condition that
    # only became judgeable at the very end of the drain still transitions
    # before the verdict reads the snapshot.
    finish_sentinel()
    annotations = None
    explain_snap = None
    coverage = None
    if explain_async:
        if engines:
            harvest_annotations(engines[-1])
        explain_service.close(timeout=60.0)
        explain_snap = explain_service.snapshot()
        annotations = dict(annotations_agg)
        # THE slot-lane invariant: every flagged row handed to the lane is
        # explained (annotated) OR accounted by a structured drop record —
        # a bare drop counter would read as coverage < 1.0 here.
        coverage = round((annotations["annotated"]
                          + annotations["drop_records"])
                         / max(1, annotations["submitted"]), 6)
    health = engines[-1].health() if engines else {}
    out = {
        "stats": total.as_dict(),
        "health": health,
        "sched": scheduler.snapshot() if scheduler is not None else None,
        "breaker": breaker.snapshot() if breaker is not None else None,
        "flaky_backend_calls": (breaker.inner.calls
                                if breaker is not None else None),
        "annotations": annotations,
        "explain": explain_snap,
        "explain_coverage": coverage,
        "explain_accounting_exact": (
            None if explain_snap is None
            else explain_snap["admitted"] == (explain_snap["completed"]
                                              + explain_snap["dropped"])),
        "annotation_rows": (broker.topic_size(ANNOTATIONS_TOPIC)
                            if explain_async else None),
        "traces": [tracer.snapshot()],
        "alerts": sentinel.snapshot() if sentinel is not None else None,
        "errors": errors,
    }
    if learn_out is not None:
        out.update(learn_out)
    return out


def _settle_learn(gd: GameDay, broker, learn_loop, shadow, controller,
                  label_feeder, watch_stop, watch_thread, serving,
                  learn_ctx) -> dict:
    """Bounded post-traffic drain of the closed loop: let the label oracle
    catch up with the input topic, the lane consume its queues, the
    windowed retrain land, and the controller judge the candidate — then
    stop every learn-side thread and assemble the verdict evidence. A run
    whose policy refuses promotion converges here too (the state goes
    stable without a promote), so the negative CI arm terminates fast
    instead of burning the whole settle budget."""
    ls = gd.learn
    deadline = time.monotonic() + ls.settle_s
    # The ground-truth oracle must see every input row before it stops.
    while time.monotonic() < deadline and \
            broker.group_lag("scenario-labels", [INPUT_TOPIC]) > 0 and \
            label_feeder.error is None:
        time.sleep(0.02)
    time.sleep(0.05)           # let the last due labels produce
    label_feeder.join(timeout=30.0)
    stable = None
    stable_since = time.monotonic()
    while time.monotonic() < deadline:
        snap = learn_loop.snapshot()
        staged = serving.staged_version
        state = (snap["published"], snap["promoted"], snap["rejected"],
                 snap["rolled_back"], snap["in_flight"], staged,
                 shadow.snapshot()["rows"])
        if snap["promoted"] >= 1 and staged is None \
                and not snap["in_flight"]:
            break
        if state != stable:
            stable, stable_since = state, time.monotonic()
        elif (time.monotonic() - stable_since > 6.0
              and not snap["in_flight"] and snap["queue_depth"] == 0
              and broker.group_lag("learn", [FEEDBACK_TOPIC]) <= 0):
            break   # converged without a promotion (e.g. policy refused)
        time.sleep(0.05)
    if watch_stop is not None:
        watch_stop.set()
        watch_thread.join(timeout=10.0)
    learn_loop.close(timeout=120.0)
    shadow.close(timeout=30.0)
    snap = learn_loop.snapshot()
    events = list(controller.events)
    staged_versions = {e.get("version") for e in events
                       if e.get("event") == "stage"}
    judged = sum(1 for e in events if e.get("event") in
                 ("promote", "reject", "rollback"))
    audit_ok = (set(snap["published_versions"]) <= staged_versions
                and (not snap["published_versions"] or judged >= 1)
                and len(learn_ctx["registry"].read_audit()) >= len(events))
    promoted_at = snap["promoted_at_s"]
    latency = (round(promoted_at - ls.drift_at_s, 3)
               if promoted_at is not None else None)
    return {
        "learn": snap,
        "labels": label_feeder.stats(),
        "lifecycle": {
            "events": [{k: e.get(k) for k in ("event", "version",
                                              "reasons")}
                       for e in events],
            "active_version": serving.active_version,
            "staged_version": serving.staged_version,
            "swaps": serving.swaps,
            "audit_ok": audit_ok,
        },
        "learn_promotion_latency_s": latency,
        "registry_root": learn_ctx["root"],
    }


# ---------------------------------------------------------------------------
# the named catalog (bench `scenarios` section, CI scenario-smoke,
# serve --scenario, docs/scenarios.md)
# ---------------------------------------------------------------------------

def _sched_config(**kw):
    from fraud_detection_tpu_torch.sched import SchedulerConfig

    # Cost-aware measurement is a perf-bench concern; the harness keeps
    # the fixed ladder so no scenario pays a rung-timing phase.
    return SchedulerConfig(cost_aware=False, **kw)


def _flash_crowd(seed: int, scale: float) -> GameDay:
    return GameDay(
        name="flash_crowd",
        description="A 20x flash-crowd ramp against admission control: "
                    "the watermark + AIMD shed must bite on the ramp and "
                    "every shed row must land as an accounted DLQ record.",
        seed=seed,
        traffic=(FlashCrowd(name="crowd", duration_s=3.5, scam_fraction=0.2,
                            base_rate=120 * scale, peak_rate=2400 * scale,
                            ramp_at_s=0.6, ramp_s=0.5, hold_s=1.2,
                            decay_s=0.5),),
        # Watermark-led shedding: the p99 target is generous because warp
        # mode (time_scale 0) lands the whole spike in an instant — a
        # tight target would CoDel-deadline-shed nearly every row on age
        # alone and the verdict would measure the clock, not the ramp.
        sched=_sched_config(max_queue=800, shed_policy="adaptive",
                            target_p99_ms=4000.0),
        dlq=True,
        # The watchdog must CATCH the ramp: the shed-burn alert fires
        # within bounded virtual seconds of the flash crowd's onset.
        sentinel=SentinelSpec(expect=(
            ExpectedDetection("shed_burn", fault_at_s=0.6, within_s=12.0),)),
        slos=(
            SloSpec("exact_accounting", kind="exact_accounting"),
            SloSpec("admission_shed_bit", path="stats.shed", op=">=",
                    limit=1),
            SloSpec("shed_budget", path="shed_fraction", op="<=",
                    limit=0.9),
            SloSpec("spans_exact", kind="spans_exact"),
            SloSpec("no_errors", kind="no_errors"),
        ))


def _campaign_breaker(seed: int, scale: float) -> GameDay:
    return GameDay(
        name="campaign_breaker",
        description="A correlated fraud-campaign wave with the explain "
                    "backend down: the circuit breaker must open and "
                    "classification must keep flowing, every row "
                    "accounted.",
        seed=seed,
        traffic=(
            SteadyLoad(name="baseline", rate=150 * scale, duration_s=3.0,
                       scam_fraction=0.1),
            CampaignWave(name="campaign", at_s=0.8, duration_s=2.2,
                         wave_rate=600 * scale, waves=2, wave_s=0.5,
                         gap_s=0.6),
        ),
        breaker_threshold=3,
        dlq=True,
        # The breaker trip is the seeded fault here: the breaker_open
        # delta rule must fire within bounded virtual seconds of the
        # campaign wave that drives the dead backend.
        sentinel=SentinelSpec(expect=(
            ExpectedDetection("breaker_open", fault_at_s=0.8,
                              within_s=12.0),)),
        slos=(
            SloSpec("exact_accounting", kind="exact_accounting"),
            SloSpec("breaker_tripped", path="breaker.opens", op=">=",
                    limit=1),
            SloSpec("breaker_fast_fails", path="breaker.fast_fails",
                    op=">=", limit=1),
            SloSpec("spans_exact", kind="spans_exact"),
            SloSpec("no_errors", kind="no_errors"),
        ))


def _campaign_kill_swap(seed: int, scale: float) -> GameDay:
    return GameDay(
        name="campaign_kill_swap",
        description="THE game day: a fraud-campaign spike while a seeded "
                    "worker kill rebalances the fleet while a v2 model "
                    "hot-swaps in — zero-loss/zero-dup accounting must "
                    "hold through all three at once.",
        seed=seed,
        workers=2,
        partitions=4,
        # Two coordinator candidates: no kill is seeded here, but the
        # control lane rides the succession bus, so the run records a
        # conformance journal and the auto spec_conformance gate judges
        # it (the spec audit must also cover a day whose coordinator
        # LIVES).
        candidates=2,
        kills=KillSpec(kills=1, modes=("graceful", "crash"), min_polls=2,
                       max_polls=6),
        hot_swap_at=1.2,
        # Short lease: a crash-mode kill is only OBSERVED at lease
        # expiry, and the worker_absence while-gate needs committed work
        # to remain at that instant — on a fast host a warp-fed run can
        # otherwise drain past the blind spot before the expiry lands
        # (the row count below sizes the drain for the same reason).
        lease_ttl=0.5,
        # The fleet watchdog must see the kill: membership shrank while
        # committed work remained (the while-gate separates the death
        # from the clean drain exit). Kill timing is poll-count-seeded,
        # not virtual-timed, so the bound covers the whole run.
        sentinel=SentinelSpec(expect=(
            ExpectedDetection("worker_absence", fault_at_s=0.0,
                              within_s=60.0),)),
        traffic=(
            SteadyLoad(name="baseline", rate=260 * scale, duration_s=4.0,
                       scam_fraction=0.15),
            CampaignWave(name="campaign", at_s=0.6, duration_s=2.9,
                         wave_rate=900 * scale, waves=2, wave_s=0.7,
                         gap_s=0.5),
        ),
        slos=(
            SloSpec("exact_accounting", kind="exact_accounting"),
            SloSpec("worker_killed", path="deaths", op="==", limit=1,
                    scope="gameday"),
            SloSpec("hot_swap_landed", path="swaps", op=">=", limit=1,
                    scope="gameday"),
            SloSpec("p99_batch_s", path="stats.p99_batch_latency_sec",
                    op="<=", limit=30.0),
            SloSpec("spans_exact", kind="spans_exact"),
            SloSpec("no_errors", kind="no_errors"),
        ))


def _coordinator_kill(seed: int, scale: float) -> GameDay:
    return GameDay(
        name="coordinator_kill",
        description="The succession game day: a crash-mode coordinator "
                    "kill mid-campaign — while a seeded worker crash "
                    "holds committed work in flight — forces a standby "
                    "candidate to win the term election and reconstruct "
                    "assignment state from the compacted control topic; "
                    "zero-loss/zero-dup accounting must hold across the "
                    "interregnum and the coordinator_absence watchdog "
                    "must catch the dead brain.",
        seed=seed,
        workers=3,
        partitions=6,
        candidates=3,
        # Crash mode only: a graceful abdication leaves a dying-breath
        # snapshot and a near-zero interregnum, which the stale rule
        # cannot see. The crash leaves frozen coordinator ticks that the
        # watchdog must notice the hard way — by waiting out role_ttl.
        coordinator_kills=CoordKillSpec(kills=1, modes=("crash",),
                                        min_ticks=3, max_ticks=10),
        # A crash-killed WORKER keeps committed lag pinned above zero
        # through the interregnum (its lease cannot expire while the
        # coordinator is dead): that stuck lag is the while-gate
        # separating "brain dead with work remaining" from a clean
        # drain's legitimately idle coordinator. The pin must be
        # STRUCTURAL, not lucky: the coordinator dies within its first
        # few 20 ms ticks, long before the worker's ~1 s lease could
        # expire, and the worker dies within its first 3 polls — at
        # batch_size 64 that is at most 192 rows consumed against the
        # ~290 its two partitions carry at gate scale, so it always
        # leaves unreassignable backlog behind. Without that floor
        # (e.g. at the default 256-row batches) a single early poll can
        # drain the doomed worker's partitions entirely, the fleet
        # finishes inside role_ttl, and the run exits with no election
        # to judge.
        kills=KillSpec(kills=1, modes=("crash",), min_polls=2,
                       max_polls=3),
        batch_size=64,
        lease_ttl=1.0,
        # The vacancy window must OUTLAST the sentinel's fast stale
        # window (2.0 virtual s at game-day scaling): coordinator ticks
        # stay frozen for the whole role_ttl, so the stale rule sees a
        # genuinely spanned window before a successor revives the pulse.
        role_ttl=2.8,
        sentinel=SentinelSpec(expect=(
            ExpectedDetection("coordinator_absence", fault_at_s=0.0,
                              within_s=60.0),)),
        traffic=(
            SteadyLoad(name="baseline", rate=260 * scale, duration_s=4.0,
                       scam_fraction=0.15),
            CampaignWave(name="campaign", at_s=0.6, duration_s=2.9,
                         wave_rate=800 * scale, waves=2, wave_s=0.7,
                         gap_s=0.5),
        ),
        slos=(
            SloSpec("exact_accounting", kind="exact_accounting"),
            SloSpec("worker_killed", path="deaths", op="==", limit=1,
                    scope="gameday"),
            SloSpec("coordinator_killed",
                    path="succession.kill_plan.killed.0.mode", op="==",
                    limit="crash", scope="gameday"),
            SloSpec("election_won", path="succession.elections", op=">=",
                    limit=1, scope="gameday"),
            SloSpec("term_advanced", path="succession.term", op=">=",
                    limit=2, scope="gameday"),
            # Wall-clock failover bound: vacancy detection (role_ttl)
            # plus election plus state reconstruction, with generous
            # headroom for slow CI hosts.
            SloSpec("failover_bounded_s",
                    path="succession.handoffs.0.failover_s", op="<=",
                    limit=30.0, scope="gameday"),
            SloSpec("control_zero_loss", path="succession.control.lost",
                    op="==", limit=0, scope="gameday"),
            SloSpec("spans_exact", kind="spans_exact"),
            SloSpec("no_errors", kind="no_errors"),
        ))


def _campaign_explain(seed: int, scale: float) -> GameDay:
    return GameDay(
        name="campaign_explain",
        description="A fraud-campaign wave drives the slotserve "
                    "continuous-batching explain lane: every flagged row "
                    "must be explained or leave a structured drop record "
                    "(explain_coverage == 1.0), slot accounting must be "
                    "exact, and p99 explain latency bounded.",
        seed=seed,
        traffic=(
            SteadyLoad(name="baseline", rate=100 * scale, duration_s=2.5,
                       scam_fraction=0.15),
            CampaignWave(name="campaign", at_s=0.5, duration_s=1.8,
                         wave_rate=400 * scale, waves=2, wave_s=0.5,
                         gap_s=0.4),
        ),
        explain_slots=8,
        explain_queue=48,
        explain_tokens=12,
        slos=(
            SloSpec("exact_accounting", kind="exact_accounting"),
            # THE gate this scenario exists for: flagged rows handed to
            # the lane are annotated OR drop-recorded — never silently
            # sampled away.
            SloSpec("explain_coverage", path="explain_coverage", op="==",
                    limit=1.0),
            SloSpec("explained_bit", path="annotations.annotated", op=">=",
                    limit=1),
            SloSpec("slot_accounting_exact", path="explain_accounting_exact",
                    op="==", limit=True),
            SloSpec("explain_p99_ms", path="explain.latency_ms.p99",
                    op="<=", limit=60000.0),
            SloSpec("spans_exact", kind="spans_exact"),
            SloSpec("no_errors", kind="no_errors"),
        ))


def _campaign_explain_paged(seed: int, scale: float) -> GameDay:
    # Pool arithmetic at the paged lane's geometry (page_size 64,
    # prompt_width 448, 12 new tokens → max_len 460, 8 view pages; the
    # ~293-token shared preamble is 5 pages, 4 of them full): each admit
    # needs 4 fresh pages, so 5 + 4*8 = 37 pages serves all 8 slots with
    # zero pool drops — while a 37-page budget would fit only FOUR
    # contiguous 8-page slots. Coverage == 1.0 at a slot count the
    # unpaged cache cannot afford is the point of this scenario.
    return GameDay(
        name="campaign_explain_paged",
        description="The campaign_explain wave on the PAGED slotserve "
                    "lane: the shared explain preamble is prefilled once "
                    "into refcounted pages, every admit copy-on-writes "
                    "the partial prefix page and allocates only suffix "
                    "pages, and the pool is capped where a contiguous "
                    "cache could not fit the slot count — coverage must "
                    "still be exactly 1.0 with exact page accounting.",
        seed=seed,
        traffic=(
            SteadyLoad(name="baseline", rate=100 * scale, duration_s=2.5,
                       scam_fraction=0.15),
            CampaignWave(name="campaign", at_s=0.5, duration_s=1.8,
                         wave_rate=400 * scale, waves=2, wave_s=0.5,
                         gap_s=0.4),
        ),
        explain_slots=8,
        explain_queue=48,
        explain_tokens=12,
        explain_paged=True,
        explain_kv_pages=37,
        slos=(
            SloSpec("exact_accounting", kind="exact_accounting"),
            SloSpec("explain_coverage", path="explain_coverage", op="==",
                    limit=1.0),
            SloSpec("explained_bit", path="annotations.annotated", op=">=",
                    limit=1),
            SloSpec("slot_accounting_exact", path="explain_accounting_exact",
                    op="==", limit=True),
            # The paged gates: the preamble must actually be shared (a
            # prefix hit per admitted request), the pool must hold the
            # declared cap, and the lane must report real HBM savings
            # against the contiguous layout at the same slot count.
            SloSpec("prefix_shared", path="explain.prefix_hits", op=">=",
                    limit=1),
            SloSpec("paged_pool_capped", path="explain.kv_pages", op="==",
                    limit=37),
            SloSpec("hbm_saved", path="explain.kv_bytes_saved_vs_contiguous",
                    op=">", limit=0),
            SloSpec("explain_p99_ms", path="explain.latency_ms.p99",
                    op="<=", limit=60000.0),
            SloSpec("spans_exact", kind="spans_exact"),
            SloSpec("no_errors", kind="no_errors"),
        ))


def _drift_shift(seed: int, scale: float) -> GameDay:
    return GameDay(
        name="drift_shift",
        description="THE closed-loop game day: a novel-vocabulary fraud "
                    "campaign the live model scores benign hits mid-run; "
                    "delayed ground-truth labels join the learn window, "
                    "the drift trigger fires a warm-started retrain, the "
                    "candidate publishes, shadow-scores, and "
                    "auto-promotes through the PSI/agreement/health "
                    "gates — with exact join accounting and "
                    "zero-loss/zero-dup through the hot swap.",
        seed=seed,
        model="xgb",
        batch_size=128,
        traffic=(
            SteadyLoad(name="baseline", rate=140 * scale, duration_s=4.0,
                       scam_fraction=0.15, emit_truth=True),
            DriftCampaign(name="drift", at_s=1.0, duration_s=3.0,
                          wave_rate=500 * scale, waves=2, wave_s=0.8,
                          gap_s=0.4),
        ),
        learn=LearnSpec(min_labeled=96, min_new_labels=24,
                        error_threshold=0.12, error_window=256,
                        refresh_rounds=6, label_delay_s=0.2,
                        drift_at_s=1.0, promote_within_s=60.0),
        # Drift becomes an INCIDENT through the shadow lane: once the
        # drift-corrected candidate stages, its disagreement with the
        # drifted primary burns both sentinel windows.
        sentinel=SentinelSpec(expect=(
            ExpectedDetection("shadow_disagreement_burn", fault_at_s=1.0,
                              within_s=60.0),)),
        # The learn-evidence gates are scope="gameday": only the full
        # game-day runner wires the label oracle + learn lane (a bare
        # `serve --scenario drift_shift` replays the traffic shape and
        # honestly skips them).
        slos=(
            SloSpec("exact_accounting", kind="exact_accounting"),
            # Drift was REAL: the primary's label-error rate on the
            # joined window shows the live model was wrong about recent
            # ground truth.
            SloSpec("drift_was_real",
                    path="learn.primary_window_error_rate", op=">=",
                    limit=0.08, scope="gameday"),
            SloSpec("retrain_published", path="learn.published", op=">=",
                    limit=1, scope="gameday"),
            SloSpec("auto_promoted", path="learn.promoted", op=">=",
                    limit=1, scope="gameday"),
            SloSpec("promotion_within_s",
                    path="learn_promotion_latency_s", op="<=",
                    limit=60.0, scope="gameday"),
            # Exact label-join accounting: joined + expired + missed +
            # pending == labels_seen, and labels actually joined.
            SloSpec("join_accounting_exact",
                    path="learn.window.accounting_exact", op="==",
                    limit=True, scope="gameday"),
            SloSpec("labels_joined_bit", path="learn.window.joined",
                    op=">=", limit=1, scope="gameday"),
            # Post-promotion agreement recovery: the promoted candidate
            # agrees with ground truth on the very window the primary
            # failed (its label-error rate collapses).
            SloSpec("agreement_recovery",
                    path="learn.candidate_window_error_rate", op="<=",
                    limit=0.1, scope="gameday"),
            # The promotion landed as a zero-downtime swap, fully audited.
            SloSpec("hot_swap_landed", path="swaps", op=">=", limit=1,
                    scope="gameday"),
            SloSpec("lifecycle_audited", path="lifecycle.audit_ok",
                    op="==", limit=True, scope="gameday"),
            SloSpec("spans_exact", kind="spans_exact"),
            SloSpec("no_errors", kind="no_errors"),
        ))


def _chaos_storm(seed: int, scale: float) -> GameDay:
    return GameDay(
        name="chaos_storm",
        description="Full-vocabulary broker chaos (transport errors, "
                    "lossy flushes, fences, duplicates, corruption) under "
                    "a campaign: the supervisor must converge with zero "
                    "LOST rows (at-least-once duplicates are the "
                    "documented semantics).",
        seed=seed,
        supervise=40,
        chaos=ChaosSpec(poll_error_rate=0.05, latency_spike_rate=0.04,
                        duplicate_rate=0.05, corrupt_rate=0.03,
                        flush_fail_rate=0.05, flush_crash_rate=0.04,
                        commit_fence_rate=0.04, max_faults=40),
        dlq=True,
        # Transport chaos kills incarnations from t=0 (poll errors, flush
        # crashes): the restart-churn rule — judged through the
        # chain-cumulative source — must see the crash loop. (Corruption
        # would also DLQ rows, but corrupt draws are per-poll and can be
        # zero at small scales; the restart chain is the guaranteed
        # manifestation.) The bound is wide because supervised backoff
        # chains stretch the drain.
        sentinel=SentinelSpec(expect=(
            ExpectedDetection("restart_churn", fault_at_s=0.0,
                              within_s=25.0),)),
        traffic=(
            SteadyLoad(name="baseline", rate=180 * scale, duration_s=3.0,
                       scam_fraction=0.2),
            CampaignWave(name="campaign", at_s=1.0, duration_s=1.8,
                         wave_rate=500 * scale, waves=1, wave_s=0.8,
                         gap_s=0.4),
        ),
        slos=(
            SloSpec("zero_loss", kind="zero_loss"),
            SloSpec("chaos_bit", path="chaos.total", op=">=", limit=1,
                    scope="gameday"),
            SloSpec("spans_exact", kind="spans_exact"),
            SloSpec("no_errors", kind="no_errors"),
        ))


def _diurnal_hotkey(seed: int, scale: float) -> GameDay:
    return GameDay(
        name="diurnal_hotkey",
        description="A diurnal tide with heavy hot-key/regional skew and "
                    "no faults: the clean-path control arm — exact "
                    "accounting and bounded batch latency under a "
                    "realistic, partition-skewed curve.",
        seed=seed,
        traffic=(DiurnalLoad(name="tide", duration_s=4.0,
                             base_rate=80 * scale, peak_rate=400 * scale,
                             period_s=4.0, scam_fraction=0.25,
                             hot_fraction=0.5, hot_keys=3),),
        # The false-positive gate: the FULL default rule pack runs on the
        # clean control arm and must produce ZERO incidents.
        sentinel=SentinelSpec(zero_incidents=True),
        slos=(
            SloSpec("exact_accounting", kind="exact_accounting"),
            SloSpec("p99_batch_s", path="stats.p99_batch_latency_sec",
                    op="<=", limit=30.0),
            SloSpec("spans_exact", kind="spans_exact"),
            SloSpec("no_errors", kind="no_errors"),
        ))


def _autoscale_rules(*, backlog_limit: float, idle_limit: float,
                     idle_for_s: float, fast_s: float = 1.0):
    """The fleet pack tuned for elastic game days: tight burn/idle
    windows (decisions are judged in seconds, not hours), the stale
    window kept short of any interregnum, and the flap watchdog at its
    default 3-events-per-window budget."""
    from fraud_detection_tpu_torch.obs.sentinel import fleet_rule_pack

    return fleet_rule_pack(backlog_limit=backlog_limit, fast_s=fast_s,
                           slow_s=4.0, resolve_s=0.5, stale_s=2.0,
                           idle_limit=idle_limit, idle_for_s=idle_for_s)


def _diurnal_tide_scale(seed: int, scale: float) -> GameDay:
    return GameDay(
        name="diurnal_tide_scale",
        description="The elastic tide: a paced diurnal curve whose crest "
                    "outruns two workers — the autoscaler must grow the "
                    "fleet on the watermark burn and hand the extra "
                    "worker back on the trough through the voluntary-"
                    "leave revoke barrier, with exact accounting, "
                    "bounded churn, and bounded reaction latency in "
                    "virtual seconds.",
        seed=seed,
        workers=2,
        partitions=4,
        batch_size=64,
        time_scale=1.0,
        idle_timeout=2.5,
        # One full cosine period: trough -> crest (t = 4) -> trough. The
        # crest rate is far past what two workers drain, the trough is
        # near-idle; the surge onset for reaction latency is the upslope
        # midpoint where the rate crosses the fleet's static capacity.
        traffic=(DiurnalLoad(name="tide", duration_s=8.0,
                             base_rate=30 * scale, peak_rate=2000 * scale,
                             period_s=8.0, scam_fraction=0.15),),
        autoscale=AutoscaleSpec(min_workers=2, max_workers=3,
                                cooldown_s=1.5, out_for_s=0.2,
                                in_for_s=0.3, surge_at_s=2.0),
        sentinel=SentinelSpec(
            rules=_autoscale_rules(backlog_limit=120.0, idle_limit=100.0,
                                   idle_for_s=0.4),
            expect=(ExpectedDetection("fleet_watermark_burn",
                                      fault_at_s=2.0, within_s=20.0),)),
        slos=(
            SloSpec("exact_accounting", kind="exact_accounting"),
            # THE gates this scenario exists for: the fleet breathed out
            # on the crest and back in on the trough...
            SloSpec("scaled_out", path="autoscale.scale_outs", op=">=",
                    limit=1),
            SloSpec("scaled_in", path="autoscale.scale_ins", op=">=",
                    limit=1),
            # ...without oscillating (the autoscale_flap budget is 3
            # events per window; one tide cycle must stay well under it).
            SloSpec("bounded_churn_out", path="autoscale.scale_outs",
                    op="<=", limit=2),
            SloSpec("bounded_churn_in", path="autoscale.scale_ins",
                    op="<=", limit=2),
            SloSpec("reaction_bounded_s", path="autoscale_reaction_s",
                    op="<=", limit=15.0),
            SloSpec("p99_batch_s", path="stats.p99_batch_latency_sec",
                    op="<=", limit=30.0),
            SloSpec("spans_exact", kind="spans_exact"),
            SloSpec("no_errors", kind="no_errors"),
        ))


def _flash_crowd_scale(seed: int, scale: float) -> GameDay:
    return GameDay(
        name="flash_crowd_scale",
        description="The elastic flash crowd: the 20x ramp lands on TWO "
                    "workers behind the globally-coordinated adaptive "
                    "shed — scale-out must outrun shed-budget erosion "
                    "(the fleet grows toward max instead of shedding "
                    "through the spike), every shed row still an "
                    "accounted DLQ record.",
        seed=seed,
        workers=2,
        partitions=4,
        batch_size=64,
        time_scale=1.0,
        idle_timeout=2.5,
        traffic=(FlashCrowd(name="crowd", duration_s=4.5,
                            scam_fraction=0.2, base_rate=100 * scale,
                            peak_rate=2400 * scale, ramp_at_s=0.8,
                            ramp_s=0.5, hold_s=1.5, decay_s=0.5),),
        sched=_sched_config(max_queue=800, shed_policy="adaptive",
                            target_p99_ms=4000.0),
        dlq=True,
        autoscale=AutoscaleSpec(min_workers=2, max_workers=4,
                                cooldown_s=0.5, out_for_s=0.1,
                                in_for_s=2.0, surge_at_s=0.8),
        sentinel=SentinelSpec(
            rules=_autoscale_rules(backlog_limit=150.0, idle_limit=50.0,
                                   idle_for_s=1.0),
            expect=(ExpectedDetection("fleet_watermark_burn",
                                      fault_at_s=0.8, within_s=15.0),)),
        slos=(
            SloSpec("exact_accounting", kind="exact_accounting"),
            SloSpec("scaled_out", path="autoscale.scale_outs", op=">=",
                    limit=1),
            SloSpec("reaction_bounded_s", path="autoscale_reaction_s",
                    op="<=", limit=10.0),
            # The elastic shed budget: the single-engine flash_crowd
            # tolerates 0.9 shed fraction; with capacity arriving
            # mid-ramp the crowd must mostly be SERVED, not shed.
            SloSpec("shed_budget", path="shed_fraction", op="<=",
                    limit=0.5),
            SloSpec("spans_exact", kind="spans_exact"),
            SloSpec("no_errors", kind="no_errors"),
        ))


def _elastic_control(seed: int, scale: float) -> GameDay:
    return GameDay(
        name="elastic_control",
        description="The elastic control arm: a clean steady load with "
                    "the autoscaler ARMED but every signal quiet (the "
                    "burn threshold unreachable, the idle rule gated "
                    "off) — the fleet must not scale, not replace, not "
                    "flap, and the full fleet pack must end with zero "
                    "incidents.",
        seed=seed,
        workers=2,
        partitions=4,
        traffic=(SteadyLoad(name="steady", rate=150 * scale,
                            duration_s=3.0, scam_fraction=0.1),),
        autoscale=AutoscaleSpec(min_workers=2, max_workers=3,
                                cooldown_s=0.5),
        # idle_limit=0 gates fleet_idle structurally (backlog can never
        # be < 0): the false-positive arm proves no-signal -> no-action,
        # not that idleness is absent. The burn limit sits far above
        # anything a warp-fed steady load enqueues.
        sentinel=SentinelSpec(
            rules=_autoscale_rules(backlog_limit=50000.0, idle_limit=0.0,
                                   idle_for_s=1.0, fast_s=8.0),
            zero_incidents=True),
        slos=(
            SloSpec("exact_accounting", kind="exact_accounting"),
            SloSpec("no_scale_out", path="autoscale.scale_outs", op="==",
                    limit=0),
            SloSpec("no_scale_in", path="autoscale.scale_ins", op="==",
                    limit=0),
            SloSpec("no_replace", path="autoscale.replacements", op="==",
                    limit=0),
            SloSpec("spans_exact", kind="spans_exact"),
            SloSpec("no_errors", kind="no_errors"),
        ))


CATALOG: dict = {
    "flash_crowd": _flash_crowd,
    "campaign_breaker": _campaign_breaker,
    "campaign_explain": _campaign_explain,
    "campaign_explain_paged": _campaign_explain_paged,
    "campaign_kill_swap": _campaign_kill_swap,
    "chaos_storm": _chaos_storm,
    "coordinator_kill": _coordinator_kill,
    "diurnal_hotkey": _diurnal_hotkey,
    "diurnal_tide_scale": _diurnal_tide_scale,
    "drift_shift": _drift_shift,
    "elastic_control": _elastic_control,
    "flash_crowd_scale": _flash_crowd_scale,
}


def get_scenario(name: str, seed: int = 0, *, scale: float = 1.0) -> GameDay:
    """Look up a catalog scenario; ``scale`` multiplies every traffic
    rate (CI/bench run scale < 1 for speed, soaks scale > 1)."""
    factory = CATALOG.get(name)
    if factory is None:
        raise KeyError(
            f"unknown scenario {name!r}; catalog: {sorted(CATALOG)}")
    if scale <= 0:
        raise ValueError(f"scale must be > 0, got {scale}")
    return factory(seed, scale)


def parse_scenario_ref(ref: str) -> Tuple[str, int]:
    """``NAME[:seed]`` → (name, seed) — the serve --scenario syntax."""
    name, _, seed_raw = ref.partition(":")
    if not seed_raw:
        return name, 0
    try:
        return name, int(seed_raw)
    except ValueError:
        raise ValueError(f"bad scenario ref {ref!r}: seed must be an int")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Run a named game-day scenario against an in-process "
                    "serving stack and gate on its SLOs "
                    "(docs/scenarios.md). Exit 0 = verdict PASS, "
                    "1 = an SLO failed.")
    ap.add_argument("--name", default=None,
                    help=f"catalog scenario ({', '.join(sorted(CATALOG))})")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="traffic-rate multiplier (CI smokes run < 1)")
    ap.add_argument("--time-scale", type=float, default=0.0,
                    help="0 = warp (default), 1 = real-time pacing")
    ap.add_argument("--slo", action="append", default=[], metavar="EXPR",
                    help="extra gate, e.g. 'stats.p99_batch_latency_sec"
                         "<=0.5' or a builtin name; repeatable")
    ap.add_argument("--learn-policy", default=None, metavar="SPEC",
                    help="override a learn scenario's PromotionPolicy "
                         "spec (registry/promote.py parse syntax) — the "
                         "CI learn-smoke proves an impossible policy "
                         "REFUSES promotion and fails the gate")
    ap.add_argument("--json", action="store_true",
                    help="print only the machine-readable verdict line")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="persist the run's control-lane journal (plus "
                         "its conformance verdict) as a JSON recording "
                         "`flightcheck conform --input PATH` can replay")
    ap.add_argument("--device", default="cuda",
                    help="torch device the game-day pipeline trains and "
                         "serves on (default cuda; 'cpu' runs the plain "
                         "torch versions)")
    ap.add_argument("--featurize-device", action="store_true",
                    help="featurize on the device (the featurize_packed "
                         "kernel on the card)")
    ap.add_argument("--list", action="store_true",
                    help="list catalog scenarios and exit")
    args = ap.parse_args(argv)
    if args.list:
        for name in sorted(CATALOG):
            gd = CATALOG[name](0, 1.0)
            print(f"{name:22s} {gd.description}")
        return 0
    if args.name is None:
        ap.error("--name is required (or --list)")
    try:
        extra = tuple(parse_slo(e) for e in args.slo)
        gd = get_scenario(args.name, args.seed, scale=args.scale)
        if args.learn_policy is not None:
            if gd.learn is None:
                raise ValueError(
                    f"--learn-policy: scenario {args.name!r} declares no "
                    "learn loop")
            import dataclasses

            from fraud_detection_tpu_torch.registry import PromotionPolicy

            PromotionPolicy.parse(args.learn_policy)   # validate early
            gd = dataclasses.replace(
                gd, learn=dataclasses.replace(gd.learn,
                                              policy=args.learn_policy))
    except (KeyError, ValueError) as e:
        raise SystemExit(str(e))
    result = run_gameday(gd, time_scale=args.time_scale, extra_slos=extra,
                         record_path=args.record, device=args.device,
                         featurize_device=args.featurize_device)
    if not args.json:
        print(result.table())
    print(json.dumps(result.as_dict()))
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
