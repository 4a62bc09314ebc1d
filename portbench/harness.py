"""What every cell shares: finding a cell's configuration, traffic mix, driver
and metric readers by the names in ``BENCHMARK.json``, the run's clock and
records, the profiled window, and the result line.

Nothing here names a cell. A cell is an entry of ``workloads``; its
``config`` names ``configs/<config>.json`` (through the ``configs`` entry's
``file``), its ``traffic`` names ``traffic/<traffic>.json``, whose
``driver`` names ``drivers/<driver>.py``; each metric is read by
``metrics/<metric name>.py``. A later cell adds files and entries and edits
none of these.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from arith import interval_union

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def limits(cell: str) -> dict:
    """The limits of the numbers ``correct`` compares, ``limits/<cell>.json``
    (with the control that calibrates them)."""
    return json.loads((BENCH_DIR / "limits" / f"{cell}.json").read_text())


def driver(name: str):
    return importlib.import_module(f"drivers.{name}")


def reader(metric: str):
    """``metrics/<metric>.py`` (a name may hold dots, so it is loaded by
    path); its ``read(rec)`` returns the value, or None where the run has
    nothing to read it from."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``trace`` off, its per-layer ones with it on. A metric without a
    ``workloads`` key goes with every cell that reports the metric it
    moves (end-to-end metrics without one go with every cell)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat field 22
    against /proc/uptime); 0 where neither can be read."""
    try:
        import os
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


@dataclass
class Check:
    """One number compared with its limit: ``ok`` when value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Context:
    """What a driver is given, and what it records for the readers."""
    cell: dict
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    started: float                     # perf_counter at process start
    rec: Dict[str, Any] = field(default_factory=dict)
    checks: List[Check] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: Optional[int] = None
    control: Optional[str] = None      # read the control too (calibration)

    def window_opens(self) -> float:
        """Set-up ends here: the first timed operation follows."""
        now = time.perf_counter()
        self.rec["setup_s"] = now - self.started
        return now

    def read_memory_peak(self) -> None:
        import torch
        self.memory_peak_bytes = max(
            torch.cuda.max_memory_allocated(d)
            for d in range(max(1, self.cell["chips"]))) \
            if self.device.type == "cuda" else 0

    def log(self, msg: str) -> None:
        """A progress line on standard error, at seconds since the start."""
        print(f"portbench [{time.perf_counter() - self.started:8.2f}s] {msg}",
              file=sys.stderr, flush=True)

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append(Check(name, float(value), float(limit)))


# ---------------------------------------------------------------------------
# the profiled window
# ---------------------------------------------------------------------------

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160       # a kernel's templated name, cut for the breakdown


def _activity(ev) -> str:
    try:
        return str(ev.activity_type())
    except AttributeError:
        return ""


def _annotation(ev, kind: str) -> bool:
    """A span mirrored on the device's timeline (some torch builds leave
    ``activity_type`` empty; then the event's own flag tells)."""
    if kind.endswith("user_annotation"):
        return True
    try:
        return bool(ev.is_user_annotation())
    except AttributeError:
        return False


class Spans:
    """Host spans the benchmark records around its calls into a layer, on
    the wall clock of the profiler's trace, while a profiled window is
    open (``on``). Any thread may record."""

    def __init__(self):
        self.on = False
        self.items: List[tuple] = []

    @contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((t0, time.time_ns(), name))


class Profiler:
    """A ``torch.profiler`` session of the card's activity alone (kernels,
    copies, sets: recording every host op would slow a host-bound step
    and inflate the idle share) over a steady window. The device's busy
    time is the union of its intervals; each idle gap is named by the
    benchmark's innermost span open on the host when it began."""

    def __init__(self, device, spans: Optional[Spans] = None):
        self.device = device
        self.spans = spans or Spans()
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts = [ProfilerActivity.CUDA]
            torch.cuda.synchronize()
        self.spans.items = []
        self.spans.on = True
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter_ns()

    def stop(self) -> dict:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
        self._prof.__exit__(None, None, None)
        self.spans.on = False
        result = self._reduce(self._prof.profiler.kineto_results.events(),
                              (t1 - self._t0) / 1e9, self.spans.items)
        self._prof = None
        return result

    @staticmethod
    def _reduce(events, window_s: float, spans: List[tuple]) -> dict:
        dev, kinds = [], {}
        for ev in events:
            kind = _activity(ev)
            is_cuda = "CUDA" in str(ev.device_type())
            note = _annotation(ev, kind)
            key = kind + ("/span" if note else "") + ("@cuda" if is_cuda else "")
            kinds[key] = kinds.get(key, 0) + 1
            if is_cuda and not note and (kind in DEVICE_ACTIVITIES or not kind):
                dev.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                            ev.name()))
        busy = interval_union([(a, b) for a, b, _ in dev]) / 1e9
        by_name: Dict[str, float] = {}
        for a, b, name in dev:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = []
        end = None
        for a, b in sorted((a, b) for a, b, _ in dev):
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        spans = sorted(spans)
        named: Dict[str, float] = {}
        for a, b in gaps:
            host = "host (no span)"
            for s0, s1, name in spans:
                if s0 <= a < s1:
                    host = name        # the innermost span opened last wins
                elif s0 > a:
                    break
            named[host] = named.get(host, 0.0) + (b - a) / 1e9
        idle_gaps = sorted(named.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy, "window_s": window_s,
                "device_ops": [[n[:NAME_CHARS], t] for n, t in device_ops],
                "idle_gaps": [[n, t] for n, t in idle_gaps],
                "kernels": len(dev), "kinds": kinds}


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------

def device_info(ctx: Context) -> dict:
    import torch
    info = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(0) if ctx.device.type == "cuda"
                     else "cpu"),
            "count": ctx.cell["chips"],
            "memory_peak_bytes": int(ctx.memory_peak_bytes or 0)}
    prof = ctx.rec.get("profile")
    if ctx.trace and prof is not None:
        info["busy_s"] = prof["busy_s"]
        info["window_s"] = prof["window_s"]
    return info


def result(ctx: Context, bench: dict) -> dict:
    """The run's last line: values of the cell's metrics that a reader
    found, the checks last."""
    metrics = {}
    for m in cell_metrics(bench, ctx.cell["name"], ctx.trace):
        value = reader(m["name"]).read(ctx.rec)
        if value is None:
            continue
        if not math.isfinite(value):
            value = 1e30 if m["better"] == "lower" else 0.0
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(ctx.checks) and all(c.ok for c in ctx.checks),
           "attempted": ctx.attempted, "failed": ctx.failed,
           "metrics": metrics, "device": device_info(ctx)}
    prof = ctx.rec.get("profile")
    if ctx.trace and prof is not None:
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in ctx.checks}
    return out


def print_checks(ctx: Context, stream=sys.stderr) -> None:
    for c in ctx.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=stream)
