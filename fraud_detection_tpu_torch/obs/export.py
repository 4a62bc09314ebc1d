"""Metric/trace egress: atomic file publication, a scrape endpoint, and
``torch.profiler`` capture windows — twin of
``fraud_detection_tpu/obs/export.py``.

Three small adapters from the in-process registry to the outside world:

* :func:`start_metrics_writer` — the ``--metrics-file`` dumper, the exact
  shape of serve's ``--health-file`` writer (periodic + final write,
  atomic publication via ``utils.atomicio``): a ``.prom``/``.txt`` path
  gets Prometheus text, anything else the JSON rendering.
* :class:`MetricsServer` — a ``--metrics-port`` stdlib HTTP endpoint
  (``/metrics`` Prometheus text, ``/metrics.json`` JSON) on a daemon
  thread; ``port=0`` binds an ephemeral port (tests read ``.port``).
  Scrapes are counted through the registry's own counter, so the exporter
  observes itself.
* :func:`start_profile_window` — an N-batch ``torch.profiler`` capture
  (host ops, and the card's kernels through CUPTI when serving on a card)
  started when serving begins and stopped once the engine has delivered
  ``n_batches`` (or at shutdown): ``serve --profile-dir`` hands the
  Chrome/Perfetto trace of exactly the warmed steady state instead of a
  build-noise-dominated whole run. Prewarm/ladder measurement gets its own
  capture via ``utils.tracing.device_trace`` at the call site.

Everything here follows the observability prime directive: failures are
logged/counted, never raised into serving.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Optional

from fraud_detection_tpu_torch.obs.metrics import MetricsRegistry
from fraud_detection_tpu_torch.utils import get_logger
from fraud_detection_tpu_torch.utils.atomicio import (atomic_write_json,
                                                atomic_write_text)

log = get_logger("obs.export")


def write_metrics(path: str, registry: MetricsRegistry) -> bool:
    """One atomic metrics publication; format chosen by extension
    (``.prom``/``.txt`` -> Prometheus text, else JSON)."""
    if path.endswith((".prom", ".txt")):
        return atomic_write_text(path, registry.render_prometheus())
    return atomic_write_json(path, registry.render_json())


def start_metrics_writer(path: Optional[str], interval: float,
                         registry: MetricsRegistry) -> Callable[[], None]:
    """Periodic ``--metrics-file`` dumper; returns ``finish()`` which
    stops the thread and writes the FINAL state (call it on every exit
    path, like the health writer's). No-op when ``path`` is None."""
    if path is None:
        return lambda: None
    writes = registry.counter("metrics_file_writes",
                              "metrics-file publications")

    def dump() -> None:
        if write_metrics(path, registry):
            writes.inc()

    stop = threading.Event()

    def loop() -> None:
        while not stop.wait(interval):
            dump()

    thread = threading.Thread(target=loop, daemon=True,
                              name="metrics-writer")
    thread.start()

    def finish() -> None:
        stop.set()
        thread.join(timeout=5.0)
        dump()

    return finish


class MetricsServer:
    """Stdlib HTTP scrape endpoint for one registry (see module doc).

    ``healthz_fn`` (optional) wires the ``/healthz`` readiness endpoint:
    a zero-arg callable returning ``(ok, firing_names)`` — the sentinel's
    ``healthz()`` (obs/sentinel/engine.py). 200 with ``{"ok": true}``
    while no critical alert is firing, 503 with the firing rule names as
    JSON otherwise; scrapes self-count exactly like ``/metrics``. Without
    a sentinel the endpoint reports ready with ``"alerts": false`` so
    probers can tell "healthy" from "not watched"."""

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1", healthz_fn=None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.registry = registry
        self.healthz_fn = healthz_fn
        scrapes = registry.counter("metrics_scrapes", "HTTP scrapes served")
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib handler contract
                import json as _json

                status = 200
                if self.path.split("?", 1)[0] == "/metrics":
                    body = outer.registry.render_prometheus().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.split("?", 1)[0] == "/metrics.json":
                    body = _json.dumps(outer.registry.render_json()).encode()
                    ctype = "application/json"
                elif self.path.split("?", 1)[0] == "/healthz":
                    fn = outer.healthz_fn
                    if fn is None:
                        doc = {"ok": True, "alerts": False, "firing": []}
                        ok = True
                    else:
                        try:
                            ok, firing = fn()
                        except Exception:  # noqa: BLE001 — probe must answer
                            ok, firing = True, []
                        doc = {"ok": bool(ok), "alerts": True,
                               "firing": list(firing)}
                    status = 200 if doc["ok"] else 503
                    body = _json.dumps(doc).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                scrapes.inc()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr spam
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="metrics-http")
        self._thread.start()

    def close(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:  # noqa: BLE001 — shutdown must never raise
            pass
        self._thread.join(timeout=5.0)


def profiler_activities(device=None) -> list:
    """``torch.profiler`` activities for a serving device: the host's ops
    always, and the card's kernels (CUPTI) when ``device`` is a card."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_profile_window(profile_dir: Optional[str], n_batches: int,
                         batches_fn: Callable[[], int], *, device=None,
                         poll_interval: float = 0.05
                         ) -> Callable[[], Optional[dict]]:
    """Capture a ``torch.profiler`` trace of the first ``n_batches``
    delivered batches (measured through ``batches_fn``, e.g.
    ``lambda: engine.stats.batches``): the card's own kernels (CUPTI, which
    records every thread's launches) when ``device`` is a card, and the
    host's ops. A torch profiling session belongs to the thread that
    started it (stopping it from another thread fails), so the watcher
    thread both starts it — before this function returns — and stops it
    once ``n_batches`` were delivered, then writes
    ``serve_window.trace.json`` (Chrome / Perfetto format) into
    ``profile_dir``. The host-op records are the watcher thread's own; the
    engine's threads show through the kernels they launched.

    Returns ``finish()`` -> a small report dict (or None when disabled);
    ``finish`` also stops the capture early at shutdown so a short run
    still leaves a valid trace. A profiler that cannot start or stop logs
    and reports ``{"error": ...}`` instead of raising into serving."""
    if profile_dir is None:
        return lambda: None
    trace_path = os.path.join(profile_dir, "serve_window.trace.json")
    state = {"error": None, "batches": 0, "trace": None}
    started = threading.Event()
    stop = threading.Event()
    try:
        import torch

        os.makedirs(profile_dir, exist_ok=True)
        acts = profiler_activities(device)
        # An empty session on this thread first: the profiler's backend
        # initializes on the thread that first uses it, and wants that to
        # be the thread it registered on.
        with torch.profiler.profile(activities=acts):
            pass
    except Exception as e:  # noqa: BLE001 — profiling must never kill serving
        log.warning("profiler trace unavailable: %r", e)
        return lambda: {"dir": profile_dir, "error": repr(e), "batches": 0}

    def watch() -> None:
        try:
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        except Exception as e:  # noqa: BLE001 — profiling must never kill serving
            log.warning("profiler trace unavailable: %r", e)
            state["error"] = repr(e)
            started.set()
            return
        started.set()
        while not stop.wait(poll_interval):
            try:
                n = int(batches_fn())
            except Exception:  # noqa: BLE001
                n = 0
            state["batches"] = n
            if n >= n_batches:
                break
        else:
            try:      # stopped early (finish): the count at the stop
                state["batches"] = int(batches_fn())
            except Exception:  # noqa: BLE001
                pass
        try:
            prof.stop()
            prof.export_chrome_trace(trace_path)
            state["trace"] = trace_path
        except Exception as e:  # noqa: BLE001 — profiling must never kill serving
            log.warning("profiler stop/export failed: %r", e)
            state["error"] = repr(e)

    thread = threading.Thread(target=watch, daemon=True,
                              name="profile-window")
    thread.start()
    started.wait(timeout=120.0)

    def finish() -> Optional[dict]:
        stop.set()
        thread.join(timeout=120.0)
        if thread.is_alive() and state["error"] is None:
            state["error"] = "profiler did not stop within 120 s"
        return {"dir": profile_dir, "target_batches": n_batches,
                "batches": state["batches"], "trace": state["trace"],
                "error": state["error"]}

    return finish
