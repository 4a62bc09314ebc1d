"""Micro-batching streaming classification engine — the synchronous core of
``fraud_detection_tpu/stream/engine.py``'s ``StreamingClassifier``.

Drain the consumer into a micro-batch (up to ``batch_size`` messages,
waiting at most ``max_wait`` for the first), featurize and score the whole
batch through the serving pipeline, produce the classified frames, THEN
flush and commit the batch's offsets: at-least-once with committed progress.
Up to ``pipeline_depth`` batches are in flight while the next one is polled.

The fast path is the raw-JSON one: with a host-featurizing pipeline and the
native library, message bytes go to hashed rows in one native pass (no
``json.loads``) and the output frames are assembled in C++, splicing each
message's own text literal (``_json_fast`` and ``_frames_ok`` turn True).
Otherwise the host decodes JSON and hands texts to ``predict_async`` (with
device featurization it packs their raw bytes for the featurize kernel).
A batch whose malformed rows the native scanner rejects but ``json.loads``
accepts (an escaped key) takes the slow path, so every row is judged as
``json.loads`` would judge it.

``scheduler=`` (``sched.AdaptiveScheduler``) owns the consume->score
handoff: deadline-driven batching over a warmed padding-bucket ladder,
admission control that sheds rows to the DLQ as explicit records, and
governor-paced polls. ``async_dispatch=True`` runs each batch's featurize +
upload + launch on a dispatch-lane thread (``sched.DispatchLane``) while
this thread delivers the previous batch; offsets still commit strictly in
order.

Malformed messages (bad JSON / missing text field) are counted and either
emitted inline as error frames or, with ``dlq_topic``, routed to the DLQ as
structured records; rows re-delivered more than ``dlq_max_attempts`` times
without a successful batch are diverted there too (poison screening).

Explanations ride the finish leg synchronously: ``explain_batch_fn`` is
called once per micro-batch over its valid rows (an on-device LLM then
explains every flagged row in one batched decode, see
``explain/onpod.make_stream_explain_hook``), ``explain_fn`` once per row;
a non-None result becomes the frame's ``"analysis"`` field.
"""

from __future__ import annotations

import json
import random
import time
from collections import deque
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Callable, List, Optional

import numpy as np

from fraud_detection_tpu_torch.explain.prompts import label_name
from fraud_detection_tpu_torch.featurize import native as native_mod
from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
from fraud_detection_tpu_torch.sched.sketch import LatencySketch
from fraud_detection_tpu_torch.stream.broker import (CommitFailedError,
                                                     Message)
from fraud_detection_tpu_torch.utils import get_logger
from fraud_detection_tpu_torch.utils.racecheck import ExclusiveRegion

log = get_logger("stream.engine")

# Output wire format: fixed frame, %.6f confidence. Raw-JSON mode fills the
# bytes twin with the input's own string literal (already valid JSON).
_OUT_TEMPLATE = '{"prediction": %d, "label": %s, "confidence": %.6f, "original_text": %s}'
_OUT_TEMPLATE_B = _OUT_TEMPLATE.encode()


@lru_cache(maxsize=None)
def _label_json(label: int) -> bytes:
    return json.dumps(label_name(label)).encode()


def _label_json_str(label: int) -> str:
    return _label_json(label).decode()


def _label_json_table(max_label: int) -> List[bytes]:
    """Label -> JSON bytes for labels 0..max(max_label, 1): the native frame
    assembler's table (rows whose label falls outside it get empty frames)."""
    return [_label_json(i) for i in range(max(max_label, 1) + 1)]


def _confidence_array(preds) -> np.ndarray:
    """p(predicted class): P for label 1, 1-P otherwise."""
    return np.where(np.asarray(preds.labels) == 1, preds.probabilities,
                    1.0 - preds.probabilities)


def _malformed_wire(msg: Message) -> bytes:
    """The inline error frame for an undecodable message."""
    return json.dumps({
        "error": "malformed message", "prediction": None,
        "original": msg.value.decode("utf-8", "replace")[:500]}).encode()


def _dlq_record(msg: Message, reason: str, error: str,
                attempts: Optional[int] = None) -> bytes:
    """Structured dead-letter record: why the row was diverted plus the
    source coordinates to find and replay it (keyed by the source key)."""
    rec = {
        "reason": reason,
        "error": error,
        "source": {"topic": msg.topic, "partition": msg.partition,
                   "offset": msg.offset},
        "original": msg.value.decode("utf-8", "replace")[:500],
    }
    if attempts is not None:
        rec["attempts"] = attempts
    return json.dumps(rec).encode()


@dataclass
class StreamStats:
    processed: int = 0
    malformed: int = 0
    dead_lettered: int = 0    # rows routed to the DLQ topic (subset of processed)
    shed: int = 0             # rows shed by admission control (subset of
                              # dead_lettered: every shed row leaves a record)
    batches: int = 0
    commits_skipped: int = 0  # producer didn't drain; offsets left uncommitted
    rebalanced_commits: int = 0  # commit fenced by a group rebalance (routine)
    restarts: int = 0         # supervised rebuilds (supervision not ported: 0)
    elapsed: float = 0.0
    batch_latency_sum: float = 0.0
    batch_latency_max: float = 0.0
    # Per-batch latencies for percentiles, bounded by reservoir sampling.
    latencies: List[float] = field(default_factory=list)
    # Per-ROW enqueue->produce latency (queue wait included).
    row_sketch: LatencySketch = field(default_factory=LatencySketch)
    _latency_cap: int = 4096
    _seen: int = 0

    def record_latency(self, dt: float) -> None:
        self.batch_latency_sum += dt
        self.batch_latency_max = max(self.batch_latency_max, dt)
        self._seen += 1
        if len(self.latencies) < self._latency_cap:
            self.latencies.append(dt)
        else:
            j = random.randrange(self._seen)
            if j < self._latency_cap:
                self.latencies[j] = dt

    def latency_percentile(self, q: float) -> float:
        if not self.latencies:
            return 0.0
        s = sorted(self.latencies)
        return s[min(len(s) - 1, int(q / 100.0 * len(s)))]

    @property
    def msgs_per_sec(self) -> float:
        return self.processed / self.elapsed if self.elapsed > 0 else 0.0

    @property
    def mean_batch_latency(self) -> float:
        return self.batch_latency_sum / self.batches if self.batches else 0.0

    def row_latency_ms(self, q: float) -> Optional[float]:
        sec = self.row_sketch.quantile(q)
        return None if sec is None else round(sec * 1e3, 3)

    def as_dict(self) -> dict:
        return {
            "processed": self.processed,
            "malformed": self.malformed,
            "dead_lettered": self.dead_lettered,
            "shed": self.shed,
            "batches": self.batches,
            "commits_skipped": self.commits_skipped,
            "rebalanced_commits": self.rebalanced_commits,
            "restarts": self.restarts,
            "elapsed_sec": round(self.elapsed, 4),
            "msgs_per_sec": round(self.msgs_per_sec, 1),
            "mean_batch_latency_sec": round(self.mean_batch_latency, 5),
            "p50_batch_latency_sec": round(self.latency_percentile(50), 5),
            "p99_batch_latency_sec": round(self.latency_percentile(99), 5),
            "max_batch_latency_sec": round(self.batch_latency_max, 5),
            "p50_row_latency_ms": self.row_latency_ms(0.50),
            "p99_row_latency_ms": self.row_latency_ms(0.99),
        }


class StreamingClassifier:
    """Consumer -> micro-batch -> device scoring -> producer, with offset
    commits. One thread at a time runs ``run``/``process_batch``.

    ``explain_fn(text, label, confidence)`` (per row) or
    ``explain_batch_fn(texts, labels, confidences)`` (per micro-batch,
    one result per row, taking precedence) attach their non-None results
    as the frame's ``"analysis"``; they need decoded text, so they keep the
    engine on the slow path."""

    def __init__(self, pipeline: ServingPipeline, consumer, producer,
                 output_topic: str, *, batch_size: int = 1024,
                 max_wait: float = 0.05, text_field: str = "text",
                 pipeline_depth: int = 2,
                 explain_fn: Optional[Callable[[str, int, float],
                                               Optional[str]]] = None,
                 explain_batch_fn: Optional[Callable[
                     [List[str], List[int], List[float]],
                     List[Optional[str]]]] = None,
                 dlq_topic: Optional[str] = None,
                 dlq_max_attempts: int = 3,
                 dlq_attempts: Optional[dict] = None,
                 scheduler: Optional[object] = None,
                 async_dispatch: bool = False):
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        if dlq_max_attempts < 1:
            raise ValueError(
                f"dlq_max_attempts must be >= 1, got {dlq_max_attempts}")
        # Shed rows are structured DLQ records, never silent drops: a
        # shedding scheduler needs a DLQ topic.
        if (scheduler is not None and getattr(scheduler, "sheds", False)
                and dlq_topic is None):
            raise ValueError(
                "scheduler sheds (shed_policy != 'none') but no dlq_topic is "
                "set — shed rows must land as explicit DLQ records")
        self.pipeline = pipeline
        self.consumer = consumer
        self.producer = producer
        self.output_topic = output_topic
        self.batch_size = batch_size
        self.max_wait = max_wait
        self.text_field = text_field
        self.pipeline_depth = pipeline_depth
        self.explain_fn = explain_fn
        self.explain_batch_fn = explain_batch_fn
        # Dead-letter routing: malformed rows and rows re-delivered more
        # than ``dlq_max_attempts`` times go to the DLQ topic. Pass ONE
        # ``dlq_attempts`` dict to every incarnation so poison counting
        # survives restarts. None keeps inline error frames.
        self.dlq_topic = dlq_topic
        self.dlq_max_attempts = dlq_max_attempts
        self._dlq_attempts = ((dlq_attempts if dlq_attempts is not None else {})
                              if dlq_topic is not None else None)
        self._dlq_counts: dict = {}   # reason -> records delivered to the DLQ
        self._sched = scheduler
        self.async_dispatch = bool(async_dispatch)
        self._lane = None                        # live lane while run()s
        self._lane_stats: Optional[dict] = None  # last run's lane counters
        # Raw-JSON fast path: None = untried, False = unavailable (device
        # featurize, no native library, or an explain hook), True = in use.
        self._json_fast: Optional[bool] = (
            None if explain_fn is None and explain_batch_fn is None else False)
        # Native output-frame assembly: None = untried (probed on first use).
        self._frames_ok: Optional[bool] = None
        self._created_at = time.monotonic()
        self._last_batch_at: Optional[float] = None
        self._inflight_depth = 0
        self._max_inflight = 0
        self._flush_fail_streak = 0
        self.stats = StreamStats()
        self._running = False
        self._flush_failed = False
        self._drive_region = ExclusiveRegion("StreamingClassifier.drive")
        self._stopped = False  # stop() latches this; run() then refuses

    def stop(self) -> None:
        """Request shutdown — and latch it: a stopped engine STAYS stopped.
        Lock-free by design (two monotonic flag writes)."""
        self._stopped = True
        self._running = False

    def _decode(self, msg: Message) -> Optional[str]:
        try:
            payload = json.loads(msg.value)
        except ValueError:  # JSONDecodeError and UnicodeDecodeError subclass it
            return None
        text = payload.get(self.text_field) if isinstance(payload, dict) else None
        return text if isinstance(text, str) else None

    def _dispatch(self, msgs: List[Message]) -> "_InFlight":
        """Admission + featurize + launch device scoring; does NOT wait for
        the device. The async lane runs the two halves on two threads."""
        return self._launch(self._prepare(msgs))

    def _prepare(self, msgs: List[Message]) -> "_Prep":
        """Driver-side admission for a freshly polled batch: offset cover,
        scheduler shedding, poison screening."""
        t0 = time.perf_counter()
        # Offsets cover the ORIGINAL batch — rows screened out below are
        # handled (their DLQ record ships with this batch) and must commit.
        offsets: dict = {}
        for m in msgs:
            key = (m.topic, m.partition)
            offsets[key] = max(offsets.get(key, 0), m.offset + 1)
        dead: Optional[List[tuple]] = None
        dead_reasons: Optional[dict] = None
        shed_n = 0
        if self._sched is not None and msgs:
            # Admission sees freshly polled rows only (rows in flight are
            # never shed); a shed row's record rides THIS batch's delivery
            # and commit, so key-set accounting stays exact.
            keep, shed_rows = self._sched.admit(
                msgs, self._sched.backlog_of(self.consumer))
            if shed_rows:
                dead, dead_reasons = [], {}
                for m, reason in shed_rows:
                    dead.append((_dlq_record(
                        m, reason,
                        "shed by admission control; replay from the DLQ "
                        "record's source coordinates"), m.key))
                    dead_reasons[reason] = dead_reasons.get(reason, 0) + 1
                shed_n = len(shed_rows)
                msgs = keep
        if self._dlq_attempts is not None:
            if dead is None:
                dead, dead_reasons = [], {}
            msgs = self._screen_poison(msgs, dead, dead_reasons)
        return _Prep(msgs, offsets, dead, dead_reasons, shed_n,
                     time.perf_counter() - t0)

    def _launch(self, prep: "_Prep") -> "_InFlight":
        """Featurize + device dispatch for a prepared batch; does NOT wait
        for the device. Runs on the driver, or on the dispatch lane's thread
        (``async_dispatch``): it touches no driver-owned state beyond the
        monotonic fast-path latches."""
        t0 = time.perf_counter()
        msgs, offsets = prep.msgs, prep.offsets
        inflight = None
        if msgs and self._json_fast is not False:
            inflight = self._dispatch_raw_json(msgs, offsets, t0)
        if inflight is None:
            texts: List[Optional[str]] = [self._decode(m) for m in msgs]
            valid_idx = [i for i, t in enumerate(texts) if t is not None]
            pending = (self.pipeline.predict_async([texts[i] for i in valid_idx])
                       if valid_idx else None)
            inflight = _InFlight(msgs, texts, valid_idx, pending, offsets,
                                 time.perf_counter() - t0)
        inflight.dispatch_time += prep.prep_time
        if prep.dead:
            inflight.dead = prep.dead
            inflight.dead_reasons = prep.dead_reasons
            # Screened and shed rows are OUTSIDE inflight.msgs: accounting
            # adds them back.
            inflight.dead_screened = len(prep.dead)
            inflight.shed_n = prep.shed_n
        inflight.recv_wall = time.time()
        return inflight

    def _dispatch_raw_json(self, msgs: List[Message], offsets: dict,
                           t0: float) -> Optional["_InFlight"]:
        """Try the raw-JSON path: one native pass from message bytes to
        hashed rows, no ``json.loads``. None means the slow path — for good
        (the pipeline cannot do it) or for this batch only (the native
        scanner rejected a message that ``json.loads`` accepts, e.g. an
        escaped key: each row must be judged as the slow path judges it)."""
        fast = self.pipeline.predict_json_async(
            [m.value for m in msgs], self.text_field)
        if fast is None:
            self._json_fast = False
            return None
        self._json_fast = True
        pending, status, span_start, span_len, ctxs = fast
        valid_idx = np.flatnonzero(status).tolist()
        if len(valid_idx) != len(msgs):
            for i in np.flatnonzero(status == 0).tolist():
                if self._decode(msgs[i]) is not None:
                    return None  # stricter than json.loads: slow path
        if self._native_frames():
            # Native frame assembly splices straight from the message
            # buffers: no per-message literal slices needed.
            return _InFlight(msgs, [None] * len(msgs), valid_idx, pending,
                             offsets, time.perf_counter() - t0, raw=True,
                             splice=(ctxs, span_start, span_len))
        literals: List[Optional[bytes]] = [None] * len(msgs)
        starts, lens = span_start.tolist(), span_len.tolist()
        for i in valid_idx:
            literals[i] = msgs[i].value[starts[i]: starts[i] + lens[i]]
        return _InFlight(msgs, literals, valid_idx, pending, offsets,
                         time.perf_counter() - t0, raw=True)

    def _native_frames(self) -> bool:
        """Native output-frame assembly available? (cached after first ask)"""
        if self._frames_ok is None:
            self._frames_ok = native_mod.available()
        return self._frames_ok

    def _screen_poison(self, msgs: List[Message], dead: List[tuple],
                       dead_reasons: dict) -> List[Message]:
        """Count this delivery against each row and divert rows whose count
        exceeded ``dlq_max_attempts``. Counts clear on batch success
        (``_deliver``) and are tracked per source offset."""
        attempts = self._dlq_attempts
        keep: List[Message] = []
        for m in msgs:
            key = (m.topic, m.partition, m.offset)
            n = attempts[key] = attempts.get(key, 0) + 1
            if n > self.dlq_max_attempts:
                dead.append((_dlq_record(
                    m, "max_attempts_exceeded",
                    f"re-delivered {n} times without a successful batch "
                    f"(dlq_max_attempts={self.dlq_max_attempts})",
                    attempts=n), m.key))
                dead_reasons["max_attempts_exceeded"] = (
                    dead_reasons.get("max_attempts_exceeded", 0) + 1)
            else:
                keep.append(m)
        return keep if len(keep) != len(msgs) else msgs

    def _malformed(self, inflight: "_InFlight", msg: Message,
                   wires: List[tuple]) -> None:
        """A malformed row: counted, then a DLQ record or an inline error
        frame."""
        self.stats.malformed += 1
        if self.dlq_topic is not None:
            self._dead_letter(inflight, msg, "malformed",
                              "undecodable JSON or missing/non-string text "
                              "field")
        else:
            wires.append((_malformed_wire(msg), msg.key))

    def _finish(self, inflight: "_InFlight") -> int:
        """Wait for an in-flight batch's device results, produce outputs,
        flush, commit that batch's offsets. Returns messages handled."""
        t1 = time.perf_counter()
        msgs, texts = inflight.msgs, inflight.texts
        preds = (inflight.pending.resolve()
                 if inflight.pending is not None else None)
        if inflight.splice is not None and preds is not None:
            return self._deliver(
                inflight, self._assemble_frames_native(inflight, preds), t1)

        results: List[Optional[tuple]] = [None] * len(msgs)
        if preds is not None:
            labels = preds.labels.tolist()
            confs = _confidence_array(preds).tolist()
            if inflight.raw:
                # raw mode: predictions cover all rows positionally
                for i in inflight.valid_idx:
                    results[i] = (labels[i], confs[i])
            else:
                for j, i in enumerate(inflight.valid_idx):
                    results[i] = (labels[j], confs[j])

        # One hook call covers the whole micro-batch's valid rows.
        analyses: Optional[List[Optional[str]]] = None
        if self.explain_batch_fn is not None:
            valid = [(i, results[i]) for i in range(len(msgs))
                     if results[i] is not None]
            batch_out = self.explain_batch_fn(
                [texts[i] for i, _ in valid], [r[0] for _, r in valid],
                [r[1] for _, r in valid]) if valid else []
            if len(batch_out) != len(valid):  # zip would silently drop rows
                raise ValueError(
                    f"explain_batch_fn returned {len(batch_out)} analyses "
                    f"for {len(valid)} rows")
            analyses = [None] * len(msgs)
            for (i, _), a in zip(valid, batch_out):
                analyses[i] = a
        explain = self.explain_fn is not None or analyses is not None

        wires: List[tuple] = []
        for idx, (msg, text, res) in enumerate(zip(msgs, texts, results)):
            if res is None:
                self._malformed(inflight, msg, wires)
                continue
            label, confidence = res
            if inflight.raw:
                # splice the input's own (already valid) string literal
                wire = _OUT_TEMPLATE_B % (label, _label_json(label),
                                          confidence, text)
            elif not explain:
                wire = (_OUT_TEMPLATE % (label, _label_json_str(label),
                                         confidence, json.dumps(text))).encode()
            else:
                out = {"prediction": label, "label": label_name(label),
                       "confidence": round(confidence, 6),
                       "original_text": text}
                analysis = (analyses[idx] if analyses is not None
                            else self.explain_fn(text, label, confidence))
                if analysis is not None:
                    out["analysis"] = analysis
                wire = json.dumps(out).encode()
            wires.append((wire, msg.key))
        return self._deliver(inflight, wires, t1)

    def _assemble_frames_native(self, inflight: "_InFlight",
                                preds) -> List[tuple]:
        """Every output frame of a raw-mode batch in ONE C++ pass per chunk
        (ints and floats formatted, text literals spliced from the message
        buffers at the encode's spans), byte-identical to the template
        path; Python slices the blob per message."""
        msgs = inflight.msgs
        ctxs, span_start, span_len = inflight.splice
        labels = np.asarray(preds.labels, np.int32)
        confs = _confidence_array(preds).astype(np.float64)
        table = _label_json_table(int(labels.max()) if labels.size else 0)
        if len(inflight.valid_idx) != len(msgs):
            labels = labels.copy()
            mask = np.ones(len(msgs), bool)
            mask[inflight.valid_idx] = False
            labels[mask] = -1  # malformed: empty frame -> Python path
        wires: List[tuple] = []
        off = 0
        for arr, n_chunk in ctxs:
            hi = off + n_chunk
            blob, ends = native_mod.build_frames(
                arr, span_start[off:hi], span_len[off:hi], labels[off:hi],
                confs[off:hi], table)
            start = 0
            for j, end in enumerate(ends.tolist()):
                msg = msgs[off + j]
                if end == start:  # malformed (valid frames are never empty)
                    self._malformed(inflight, msg, wires)
                else:
                    wires.append((blob[start:end], msg.key))
                    start = end
            off = hi
        return wires

    def _dead_letter(self, inflight: "_InFlight", msg: Message, reason: str,
                     error: str) -> None:
        """Divert one row to the DLQ: its record rides THIS batch's delivery
        (same flush/commit accounting as the output frames)."""
        if inflight.dead is None:
            inflight.dead, inflight.dead_reasons = [], {}
        inflight.dead.append((_dlq_record(msg, reason, error), msg.key))
        inflight.dead_reasons[reason] = inflight.dead_reasons.get(reason, 0) + 1

    def health(self) -> dict:
        """Point-in-time engine health snapshot (lock-free racy reads, a
        monitoring sample). ``dlq`` is None when the DLQ is off, ``sched``
        without a scheduler."""
        now = time.monotonic()
        return {
            "running": self._running,
            "stopped": self._stopped,
            "uptime_sec": now - self._created_at,
            "last_batch_age_sec": (None if self._last_batch_at is None
                                   else now - self._last_batch_at),
            "in_flight_depth": self._inflight_depth,
            "consecutive_flush_failures": self._flush_fail_streak,
            "processed": self.stats.processed,
            "malformed": self.stats.malformed,
            "dead_lettered": self.stats.dead_lettered,
            "shed": self.stats.shed,
            "rebalanced_commits": self.stats.rebalanced_commits,
            "commits_skipped": self.stats.commits_skipped,
            "row_latency_ms": {"p50": self.stats.row_latency_ms(0.50),
                               "p99": self.stats.row_latency_ms(0.99)},
            "device": self._device_block(),
            "sched": (self._sched.snapshot()
                      if self._sched is not None else None),
            "dlq": (None if self.dlq_topic is None else {
                "topic": self.dlq_topic,
                "routed": dict(self._dlq_counts),
                "tracked_offsets": len(self._dlq_attempts),
            }),
        }

    def _device_block(self) -> dict:
        """The ``device`` block of ``health()``: dispatch depth and the
        lane's counters (the live lane's, or the last run's), host->device
        copies per micro-batch, what is resident on the device, and which
        featurize path ran."""
        lane = self._lane
        ls = lane.stats() if lane is not None else (self._lane_stats or {})
        snap = self.pipeline.device_stats.snapshot()
        return {
            "device": str(self.pipeline.device),
            "async_dispatch": self.async_dispatch,
            "dispatch_depth": self.pipeline_depth,
            "max_inflight": ls.get("max_inflight", self._max_inflight),
            "lane_batches": ls.get("launched"),
            "driver_waits": ls.get("driver_waits"),
            "uploads": snap["uploads"],
            "upload_bytes": snap["upload_bytes"],
            "uploads_per_batch": snap["uploads_per_chunk"],
            "donation_hits": snap["donation_hits"],
            "pinned_bytes": snap["pinned_bytes"],
            "model_pins": snap["model_pins"],
            "int8": snap["int8"],
            "featurize_path": snap["featurize_path"],
            "bytes_in_per_row": snap["bytes_in_per_row"],
            "truncated_rows": snap["truncated_rows"],
        }

    def _deliver(self, inflight: "_InFlight", wires: List[tuple],
                 t1: float) -> int:
        msgs = inflight.msgs
        self.producer.produce_batch(self.output_topic, wires)
        if inflight.dead:
            self.producer.produce_batch(self.dlq_topic, inflight.dead)

        # Produce-then-commit: commit ONLY if the producer fully drained;
        # a skipped commit must also STOP the loop, or a later batch's
        # commit would advance past this batch's lost outputs.
        undelivered = self.producer.flush()
        if undelivered:
            self.stats.commits_skipped += 1
            self._flush_fail_streak += 1
            self._flush_failed = True
            self._running = False
            return 0
        self._flush_fail_streak = 0
        try:
            self.consumer.commit_offsets(inflight.offsets)
        except CommitFailedError as e:
            # The group rebalanced with this batch in flight: outputs stand,
            # the new owner reprocesses (at-least-once).
            self.stats.rebalanced_commits += 1
            log.info("commit fenced by rebalance (batch stays at-least-once): %s", e)

        if self._dlq_attempts:
            done = inflight.offsets
            for key in [k for k in self._dlq_attempts
                        if k[2] < done.get((k[0], k[1]), 0)]:
                del self._dlq_attempts[key]
        n_dead = len(inflight.dead) if inflight.dead else 0
        if n_dead:
            self.stats.dead_lettered += n_dead
            for reason, n in inflight.dead_reasons.items():
                self._dlq_counts[reason] = self._dlq_counts.get(reason, 0) + n

        dt = inflight.dispatch_time + time.perf_counter() - t1
        self.stats.processed += len(msgs) + inflight.dead_screened
        self.stats.shed += inflight.shed_n
        self.stats.batches += 1
        self.stats.record_latency(dt)
        if msgs:
            # Per-row enqueue->produce latency: producer timestamp when the
            # transport carries one, else this batch's poll-receipt stamp.
            now_wall = time.time()
            ts = np.fromiter((m.timestamp for m in msgs), np.float64,
                             len(msgs))
            lats = np.where(ts > 0.0, now_wall - ts,
                            now_wall - inflight.recv_wall)
            self.stats.row_sketch.add_many(lats)
            if self._sched is not None:
                self._sched.observe_batch(len(msgs), dt, lats)
        self._last_batch_at = time.monotonic()
        return len(msgs) + inflight.dead_screened

    def process_batch(self, msgs: List[Message]) -> int:
        """Score one micro-batch synchronously and emit results. Refuses
        after a failed flush (committing a later batch would orphan the
        failed batch's outputs): rebuild the engine or enter run()."""
        with self._drive_region:
            if self._flush_failed:
                raise RuntimeError(
                    "a previous batch's producer flush failed with its "
                    "offsets uncommitted — committing a later batch would "
                    "orphan its outputs; rebuild the engine (or use run(), "
                    "which declares a fresh incarnation) to resume")
            return self._finish(self._dispatch(msgs))

    def run(self, max_messages: Optional[int] = None,
            idle_timeout: Optional[float] = None) -> StreamStats:
        """Run the loop until stopped, ``max_messages`` handled, or the input
        stays empty for ``idle_timeout`` seconds.

        Depth-K software pipeline (K = ``pipeline_depth``): up to K batches'
        device scoring is in flight while the host polls, decodes and packs
        the next; batches finish strictly FIFO, so offsets commit in order."""
        with self._drive_region:
            if self._stopped:
                return self.stats
            self._running = True
            if self._stopped:       # stop() raced the write above: honor it
                self._running = False
                return self.stats
            self._flush_failed = False
            self.pipeline.pin_device()
            return self._run_loop(time.perf_counter(), max_messages,
                                  idle_timeout)

    def _poll(self, budget: int) -> List[Message]:
        if self._sched is not None:
            # governor-paced, deadline-driven accumulation
            return self._sched.collect(self.consumer, budget, self.max_wait)
        return self.consumer.poll_batch(budget, self.max_wait)

    def _run_loop(self, started, max_messages, idle_timeout) -> StreamStats:
        """The drive loop: this thread polls, admits, submits and delivers;
        the dispatcher runs each batch's featurize + launch, inline at
        submit or on the dispatch lane's thread (``async_dispatch``).
        ``next()`` returns batches strictly FIFO, and a launch failure
        re-raises here at the failed batch's position (newer batches are
        then discarded uncommitted)."""
        if self.async_dispatch:
            from fraud_detection_tpu_torch.sched.batcher import DispatchLane

            lane = DispatchLane(self._launch, depth=self.pipeline_depth)
        else:
            lane = _InlineDispatch(self._launch)
        self._lane = lane
        pending: "deque[_Prep]" = deque()   # submitted, not yet delivered
        idle_since: Optional[float] = None

        def deliver_oldest() -> None:
            self._finish(lane.next())
            pending.popleft()
            self._inflight_depth = len(pending)

        try:
            while self._running:
                budget = self.batch_size
                if max_messages is not None:
                    consumed = self.stats.processed + sum(
                        p.n_rows for p in pending)
                    budget = min(budget, max_messages - consumed)
                if budget <= 0:
                    if pending:
                        deliver_oldest()
                        continue
                    break
                msgs = self._poll(budget)
                if not msgs:
                    if pending:
                        # Drain the tail rather than idling behind it.
                        deliver_oldest()
                        continue
                    now = time.perf_counter()
                    idle_since = idle_since or now
                    if idle_timeout is not None and now - idle_since >= idle_timeout:
                        break
                    continue
                idle_since = None
                prep = self._prepare(msgs)
                lane.submit(prep)
                pending.append(prep)
                if len(pending) > self.pipeline_depth:
                    deliver_oldest()
                self._inflight_depth = len(pending)
        except BaseException:
            # Never finish newer batches past an interrupted one: leave
            # them uncommitted for a restart to replay (at-least-once).
            pending.clear()
            raise
        finally:
            try:
                while pending and not self._flush_failed:
                    deliver_oldest()
            finally:
                lane.stop()
                self._lane_stats = lane.stats()
                self._max_inflight = max(self._max_inflight,
                                         lane.max_inflight)
                self._lane = None
                self._inflight_depth = 0
                self._running = False
                self.stats.elapsed = time.perf_counter() - started
        return self.stats


class _InlineDispatch:
    """The synchronous dispatcher behind ``DispatchLane``'s interface: each
    batch is launched on the driver at ``submit``; ``next()`` returns them
    FIFO."""

    def __init__(self, launch_fn: Callable):
        self._launch_fn = launch_fn
        self._out: "deque[_InFlight]" = deque()
        self.max_inflight = 0

    def submit(self, prep: "_Prep") -> None:
        self._out.append(self._launch_fn(prep))
        self.max_inflight = max(self.max_inflight, len(self._out))

    def next(self) -> "_InFlight":
        return self._out.popleft()

    def stop(self) -> None:
        self._out.clear()

    def stats(self) -> dict:
        return {"max_inflight": self.max_inflight}


@dataclass
class _Prep:
    """A polled micro-batch after admission (shed + poison screen), ready
    for the featurize + launch leg — the unit the dispatch lane carries
    between threads."""
    msgs: List[Message]
    offsets: dict
    dead: Optional[List[tuple]]
    dead_reasons: Optional[dict]
    shed_n: int
    prep_time: float            # seconds spent preparing

    @property
    def n_rows(self) -> int:
        """Rows this batch accounts for (kept + screened/shed)."""
        return len(self.msgs) + (len(self.dead) if self.dead else 0)


@dataclass
class _InFlight:
    """A micro-batch whose device scoring has been dispatched but not resolved."""
    msgs: List[Message]
    texts: List[Optional[object]]  # decoded strs; raw mode: literal bytes
    valid_idx: List[int]
    pending: Optional[object]   # models.pipeline.PendingPrediction
    offsets: dict               # (topic, partition) -> next offset to commit
    dispatch_time: float        # host seconds spent dispatching
    raw: bool = False           # raw-JSON mode: pending covers ALL rows
    # Native frame assembly (raw mode): per-chunk marshalled message arrays
    # and the batch's span arrays.
    splice: Optional[tuple] = None  # (ctxs, span_start, span_len)
    dead: Optional[List[tuple]] = None
    dead_reasons: Optional[dict] = None
    dead_screened: int = 0      # dead rows NOT in msgs (poison screen + shed)
    shed_n: int = 0             # of dead_screened, rows shed by admission
    recv_wall: float = 0.0      # wall-clock poll receipt (latency fallback)
