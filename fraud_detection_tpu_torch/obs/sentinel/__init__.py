"""Sentinel: burn-rate SLO alerting + incident flight recorder — twin of
``fraud_detection_tpu/obs/sentinel`` (docs/observability.md "Alerting and
incidents").

* sentinel/rules.py — declarative :class:`AlertRule`s (static thresholds,
  multi-window burn rate, ratios, deltas, absence/staleness) with
  hysteresis, the JSON rule-file parser, and the first-party default
  pack over the engine's ``health()`` plus the coordinator-level fleet
  pack;
* sentinel/engine.py — the :class:`Sentinel` evaluation engine: a
  flight-recorder ring of metric snapshots on an injectable clock, the
  pending→firing→resolved incident lifecycle with exact accounting, the
  serve-side "sentinel" thread driver, and the virtual-time drivers the
  scenario harness's ``detects_within`` gates run on;
* sentinel/bundle.py — the :class:`IncidentRecorder`: append-only
  ``incidents.jsonl`` plus per-incident bundle dirs (evidence window,
  flight-ring metric deltas, the full health block, forced-keep trace
  chains for implicated rows).
"""

from fraud_detection_tpu_torch.obs.sentinel.bundle import (IncidentRecorder,
                                                     implicated_chains,
                                                     metric_deltas)
from fraud_detection_tpu_torch.obs.sentinel.engine import (ChainedHealthSource,
                                                     Sentinel,
                                                     VirtualCadence,
                                                     evaluate_timeline,
                                                     start_sentinel)
from fraud_detection_tpu_torch.obs.sentinel.rules import (AlertRule,
                                                    default_rule_pack,
                                                    fleet_rule_pack,
                                                    load_rules, parse_rules,
                                                    resolve_path)

__all__ = [
    "AlertRule", "ChainedHealthSource", "IncidentRecorder", "Sentinel",
    "VirtualCadence",
    "default_rule_pack", "evaluate_timeline", "fleet_rule_pack",
    "implicated_chains", "load_rules", "metric_deltas", "parse_rules",
    "resolve_path", "start_sentinel",
]
