"""Scenario harness — twin of ``fraud_detection_tpu.scenarios``: seeded
traffic, recorded-trace replay and game-day SLO gates.

* scenarios/clock.py — one seeded timeline (virtual time + per-component
  seed derivation) that traffic, ``FaultPlan`` and ``WorkerDeathPlan``
  compose on;
* scenarios/traffic.py — bit-reproducible generators (steady, diurnal,
  flash crowd, fraud-campaign waves, drift campaigns, hot-key skew) and
  the single scenario-feeder thread; the same seed gives the reference's
  timeline event for event;
* scenarios/labels.py — the delayed ground-truth oracle onto the
  feedback topic;
* scenarios/record.py / replay.py — serve ``--trace-record`` recordings
  (the span ring as JSONL, the reference's format) replayed with original
  or warped timing, reproducing the original run's row key set exactly;
* scenarios/slo.py — declarative pass/fail gates evaluated from run
  evidence;
* scenarios/gameday.py — scripted multi-failure scenarios as data, the
  12-entry catalog, and the CLI gate (exit nonzero on violation).
"""

from fraud_detection_tpu_torch.scenarios.clock import (
    ScenarioClock,
    derive_seed,
)
from fraud_detection_tpu_torch.scenarios.gameday import (
    CATALOG,
    AutoscaleSpec,
    ChaosSpec,
    ExpectedDetection,
    GameDay,
    GameDayResult,
    KillSpec,
    LearnSpec,
    SentinelSpec,
    get_scenario,
    parse_scenario_ref,
    run_gameday,
)
from fraud_detection_tpu_torch.scenarios.labels import (
    LabelFeeder,
)
from fraud_detection_tpu_torch.scenarios.record import (
    dump_tracer,
    load_recording,
    render_recording,
)
from fraud_detection_tpu_torch.scenarios.replay import (
    run_replay,
)
from fraud_detection_tpu_torch.scenarios.slo import (
    SloReport,
    SloSpec,
    evaluate,
    parse_slo,
)
from fraud_detection_tpu_torch.scenarios.traffic import (
    CampaignWave,
    DiurnalLoad,
    DriftCampaign,
    FlashCrowd,
    SteadyLoad,
    TimelineAction,
    TrafficEvent,
    TrafficFeeder,
    TrafficSpec,
    compose,
    drift_scam_pool,
    generate,
)

__all__ = [
    "AutoscaleSpec",
    "CATALOG", "CampaignWave", "ChaosSpec", "DiurnalLoad", "DriftCampaign",
    "ExpectedDetection", "FlashCrowd", "GameDay", "GameDayResult",
    "KillSpec", "LabelFeeder", "LearnSpec", "ScenarioClock", "SentinelSpec",
    "SloReport",
    "SloSpec", "SteadyLoad", "TimelineAction", "TrafficEvent",
    "TrafficFeeder", "TrafficSpec", "compose", "derive_seed", "dump_tracer",
    "evaluate", "generate", "get_scenario", "load_recording", "parse_slo",
    "parse_scenario_ref", "render_recording", "run_gameday", "run_replay",
]
