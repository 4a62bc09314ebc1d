"""Observability: row/batch tracing, unified metrics, telemetry export —
twin of ``fraud_detection_tpu/obs``.

The serving tree's attribution layer (docs/observability.md): correlation
ids minted at poll ride every row to its terminal, per-stage wall time
feeds mergeable quantile sketches, and one metrics registry maps every
``health()`` block into Prometheus text + JSON served by file, HTTP, and
the fleet bus. The sentinel (obs/sentinel/) closes the loop: declarative
alert rules over periodic metric snapshots drive a pending→firing→resolved
incident lifecycle, every transition captures a flight-recorder bundle,
and ``/healthz`` readiness flips on critical alerts.
"""

from fraud_detection_tpu_torch.obs.metrics import (Counter, Gauge, Histogram,
                                             MetricsRegistry, leaf_paths,
                                             metric_name, parse_prometheus)
from fraud_detection_tpu_torch.obs.sentinel import (AlertRule, IncidentRecorder,
                                              Sentinel, default_rule_pack,
                                              fleet_rule_pack, load_rules,
                                              start_sentinel)
from fraud_detection_tpu_torch.obs.trace import (BatchTrace, RowTracer, Span,
                                           SpanRing, aggregate_stage_wires,
                                           fleet_stage_latency)

__all__ = [
    "AlertRule", "BatchTrace", "Counter", "Gauge", "Histogram",
    "IncidentRecorder", "MetricsRegistry", "RowTracer", "Sentinel", "Span",
    "SpanRing", "aggregate_stage_wires", "default_rule_pack",
    "fleet_rule_pack", "fleet_stage_latency", "leaf_paths", "load_rules",
    "metric_name", "parse_prometheus", "start_sentinel",
]
