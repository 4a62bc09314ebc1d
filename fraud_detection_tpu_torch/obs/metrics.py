"""Unified metrics surface: one registry, Prometheus text + JSON out —
twin of ``fraud_detection_tpu/obs/metrics.py``.

Every subsystem already reports — but each through its own ``health()``
dict with its own shape, and the serve CLI, the fleet bus, and the bench
all re-plumb those dicts differently. This registry makes ONE schema out
of them:

* native instruments — :class:`Counter`, :class:`Gauge`, and
  :class:`Histogram` (a :class:`LatencySketch` behind a summary-style
  export) — for code that wants first-class metrics;
* **collectors** — zero-arg callables returning a (nested) health-style
  dict, flattened into metric samples at render time. Registering an
  engine's ``health`` as a collector maps EVERY existing health key into
  the exporter mechanically, so the exporter's key set is a superset of
  every ``health()`` block by construction (tests/test_torch_obs.py pins
  it).

Flattening rules (deterministic, pinned by tests):

* nested dict keys join with ``_`` and are sanitized to the Prometheus
  charset;
* numbers export as-is, booleans as 0/1, ``None`` as ``NaN`` (the key
  stays visible — absence and unknown are different facts);
* strings become ``<name>{value="..."} 1`` info-style samples;
* lists export ``<name>_count`` (their length); lists of dicts recurse
  with an ``index`` label (the serve CLI's per-engine lists).

Rendering is pull-based: nothing in the hot path writes here — the
engine's counters live where they always lived, and a scrape/write walks
``health()`` exactly like the ``--health-file`` dumper does.
"""

from __future__ import annotations

import math
import re
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from fraud_detection_tpu_torch.sched.sketch import LatencySketch

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_ESC = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}

#: Quantiles exported for every histogram/sketch (summary convention).
QUANTILES = (0.5, 0.95, 0.99)


def sanitize(name: str) -> str:
    """A valid Prometheus metric-name fragment from any health key."""
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def metric_name(prefix: str, path: Tuple[str, ...]) -> str:
    """The ONE mapping from a health-dict key path to an exported metric
    name — the renderer and the superset contract test both use it, so
    they cannot drift."""
    return "_".join(sanitize(p) for p in (prefix, *path) if p)


def _esc_label(v: str) -> str:
    return "".join(_LABEL_ESC.get(c, c) for c in str(v))


def _fmt_labels(labels: Optional[Mapping[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{sanitize(k)}="{_esc_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    if isinstance(v, bool):
        return "1" if v else "0"
    return repr(float(v)) if isinstance(v, float) else str(v)


class Counter:
    """Monotonic counter (thread-safe)."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value: ``set()`` it, or give it a callback that is
    read at render time (the usual shape here — gauges over live state)."""

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self._fn = fn
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 — scrapes must never kill serving
                return float("nan")
        with self._lock:
            return self._value


class Histogram:
    """Quantile-sketch histogram over seconds-valued observations,
    exported summary-style (quantile labels + _sum + _count). Reuses the
    serving tree's :class:`LatencySketch` — bounded memory, lossless
    merge, the same ~7% relative bucket width everywhere."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.sketch = LatencySketch()

    def observe(self, sec: float) -> None:
        self.sketch.add(sec)

    def observe_many(self, secs) -> None:
        self.sketch.add_many(secs)


class MetricsRegistry:
    """The process-wide metric surface (see module docstring)."""

    def __init__(self, prefix: str = "fraud", *,
                 wall: Callable[[], float] = time.time):
        self.prefix = sanitize(prefix)
        self._wall = wall
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        # name -> (fn, constant labels); fn() returns a nested dict.
        self._collectors: Dict[str, Tuple[Callable[[], Optional[dict]],
                                          Optional[dict]]] = {}

    # -- registration (idempotent get-or-create) ------------------------

    def counter(self, name: str, help: str = "") -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, help)
            return c

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, help, fn)
            return g

    def histogram(self, name: str, help: str = "") -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, help)
            return h

    def add_collector(self, name: str, fn: Callable[[], Optional[dict]], *,
                      labels: Optional[dict] = None) -> None:
        """Register a health-style dict source flattened at render time;
        re-registering a name replaces it (supervised engine rebuilds)."""
        with self._lock:
            self._collectors[name] = (fn, dict(labels) if labels else None)

    # -- flattening ------------------------------------------------------

    def _flatten(self, path: Tuple[str, ...], obj,
                 labels: Optional[dict],
                 out: List[Tuple[str, Optional[dict], float]]) -> None:
        name = metric_name(self.prefix, path)
        if isinstance(obj, dict):
            for k, v in obj.items():
                self._flatten(path + (str(k),), v, labels, out)
        elif isinstance(obj, bool):
            out.append((name, labels, 1.0 if obj else 0.0))
        elif isinstance(obj, (int, float)):
            out.append((name, labels, float(obj)))
        elif obj is None:
            out.append((name, labels, float("nan")))
        elif isinstance(obj, str):
            merged = dict(labels or {})
            merged["value"] = obj[:120]
            out.append((name, merged, 1.0))
        elif isinstance(obj, (list, tuple)):
            out.append((name + "_count", labels, float(len(obj))))
            if obj and all(isinstance(e, dict) for e in obj):
                for i, e in enumerate(obj):
                    merged = dict(labels or {})
                    merged["index"] = str(i)
                    self._flatten(path, e, merged, out)
        # anything else (bytes, objects) is silently unexportable

    def samples(self) -> List[Tuple[str, Optional[dict], float]]:
        """Every (name, labels, value) sample: native instruments first,
        then each collector's flattened dict."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.values())
            collectors = list(self._collectors.items())
        out: List[Tuple[str, Optional[dict], float]] = []
        for c in counters:
            out.append((metric_name(self.prefix, (c.name,)) + "_total",
                        None, c.value))
        for g in gauges:
            out.append((metric_name(self.prefix, (g.name,)), None, g.value))
        for h in hists:
            base = metric_name(self.prefix, (h.name,))
            snap = h.sketch
            for q in QUANTILES:
                v = snap.quantile(q)
                out.append((base, {"quantile": str(q)},
                            float("nan") if v is None else v))
            out.append((base + "_sum", None, snap.sum))
            out.append((base + "_count", None, float(snap.count)))
        for name, (fn, labels) in collectors:
            try:
                doc = fn()
            except Exception:  # noqa: BLE001 — scrapes must never kill serving
                doc = None
            if doc is None:
                continue
            self._flatten((name,), doc, labels, out)
        return out

    # -- rendering -------------------------------------------------------

    def render_prometheus(self) -> str:
        """Prometheus text exposition (0.0.4). One line per sample; HELP/
        TYPE emitted once per metric name (everything untyped-gauge except
        native counters/histograms, which carry their own conventions)."""
        with self._lock:
            typed = {metric_name(self.prefix, (c.name,)) + "_total":
                     ("counter", c.help) for c in self._counters.values()}
            typed.update({metric_name(self.prefix, (h.name,)):
                          ("summary", h.help)
                          for h in self._histograms.values()})
        lines: List[str] = []
        seen: set = set()
        for name, labels, value in self.samples():
            base = name
            for suffix in ("_sum", "_count"):
                if name.endswith(suffix) and name[: -len(suffix)] in typed:
                    base = name[: -len(suffix)]
            if base not in seen:
                seen.add(base)
                kind, help_ = typed.get(base, ("gauge", ""))
                if help_:
                    lines.append(f"# HELP {base} {help_}")
                lines.append(f"# TYPE {base} {kind}")
            lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(value)}")
        lines.append("")
        return "\n".join(lines)

    def render_json(self) -> dict:
        """The same surface as JSON: raw collector dicts (the ONE nested
        schema) plus the flattened sample map — machine-joinable either
        way."""
        with self._lock:
            collectors = list(self._collectors.items())
        raw = {}
        for name, (fn, _) in collectors:
            try:
                raw[name] = fn()
            except Exception:  # noqa: BLE001
                raw[name] = None
        flat = {}
        for name, labels, value in self.samples():
            key = name + _fmt_labels(labels)
            flat[key] = None if (isinstance(value, float)
                                 and math.isnan(value)) else value
        return {"time": self._wall(), "collectors": raw, "metrics": flat}


# ---------------------------------------------------------------------------
# contract-test helpers (also used by the CI smoke)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(NaN|[-+0-9.eE]+|[-+]?Inf)$")


def parse_prometheus(text: str) -> Dict[str, List[Tuple[str, float]]]:
    """Strict-enough parser for the exposition format: every non-comment,
    non-blank line must match ``name{labels} value`` or the text is
    rejected (ValueError). Returns name -> [(label-blob, value)]."""
    out: Dict[str, List[Tuple[str, float]]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line {lineno}: {line!r}")
        name, labels, value = m.group(1), m.group(2) or "", m.group(3)
        out.setdefault(name, []).append((labels, float(value)))
    return out


def leaf_paths(obj, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, ...]]:
    """Every leaf key path of a health-style dict — the contract test
    walks these through :func:`metric_name` and asserts each lands in the
    rendered output (list leaves map to their ``_count`` sample)."""
    if isinstance(obj, dict):
        out = []
        for k, v in obj.items():
            out.extend(leaf_paths(v, prefix + (str(k),)))
        return out
    return [prefix]
