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

``shadow=`` (``registry.ShadowScorer``) and ``learn=`` (``learn.LearnLoop``)
are offered each scored micro-batch's valid rows and primary results
through their bounded non-blocking queues (drop and count, never wait);
their decoding, scoring and training run on their own threads (and CUDA
streams). ``health()`` then carries their ``model`` and ``learn`` blocks.

Inline, explanations ride the finish leg synchronously: ``explain_batch_fn``
is called once per micro-batch over its valid rows (an on-device LLM then
explains every flagged row in one batched decode, see
``explain/onpod.make_stream_explain_hook``), ``explain_fn`` once per row;
a non-None result becomes the frame's ``"analysis"`` field. With
``explain_async=True`` the frames go out without analysis and the batch's
flagged rows go to an ``AsyncAnnotationLane`` (``stream/annotations.py``),
whose worker explains them onto a side topic; ``breaker=`` and
``explain_service=`` (the circuit breaker and the slotserve service behind
the hook) only surface their state in ``health()``.

``rowtrace=`` (``obs.RowTracer``) mints a correlation id per polled batch
and carries it to every row's terminal: batch stage spans (poll, admit,
launch, device, deliver) plus row events for flagged, shed and
dead-lettered rows, whose DLQ records carry the row's id. ``sentinel=``
(``obs.sentinel.Sentinel``) only surfaces its alert block in ``health()``.
``run_supervised`` rebuilds a failed engine (a broker fault, a lost flush)
from the group's committed offsets with jittered exponential backoff.
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
from fraud_detection_tpu_torch.utils.device import is_device_fault
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
                attempts: Optional[int] = None,
                trace: Optional[str] = None) -> bytes:
    """Structured dead-letter record: why the row was diverted plus the
    source coordinates to find and replay it (keyed by the source key);
    ``trace`` is the row's correlation id when tracing is on."""
    rec = {
        "reason": reason,
        "error": error,
        "source": {"topic": msg.topic, "partition": msg.partition,
                   "offset": msg.offset},
        "original": msg.value.decode("utf-8", "replace")[:500],
    }
    if attempts is not None:
        rec["attempts"] = attempts
    if trace is not None:
        rec["trace"] = trace
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
    restarts: int = 0         # supervised engine rebuilds (run_supervised)
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
        self._reservoir_add(dt)

    def _reservoir_add(self, dt: float) -> None:
        """Add a sample to the percentile reservoir without touching the
        exact sum/max (the supervisor's merge reuses this)."""
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
                 async_dispatch: bool = False,
                 shadow: Optional[object] = None,
                 learn: Optional[object] = None,
                 explain_async: bool = False,
                 annotations_topic: Optional[str] = None,
                 annotations_producer=None,
                 annotations_queue: int = 1024,
                 breaker: Optional[object] = None,
                 explain_service: Optional[object] = None,
                 rowtrace: Optional[object] = None,
                 sentinel: Optional[object] = None,
                 clock: Callable[[], float] = time.monotonic):
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
        if explain_async and explain_batch_fn is None:
            raise ValueError("explain_async requires explain_batch_fn")
        # The lane's producer is its own: flush() is how both sides account
        # delivery, and a shared producer would let either side consume the
        # other's failures.
        if explain_async and annotations_producer is None:
            raise ValueError(
                "explain_async requires a dedicated annotations_producer "
                "(a second producer on the same transport)")
        if explain_async and annotations_producer is producer:
            raise ValueError(
                "annotations_producer is the engine's own producer object — "
                "the async lane needs a DEDICATED producer (flush() is how "
                "both sides account delivery; sharing one lets either side "
                "consume the other's failures)")
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
        # Async lane: frames go out without analysis (so the raw-JSON and
        # native-frame paths stay in play) and flagged rows are explained
        # in the background onto the annotations topic.
        self._annotation_lane = None
        if explain_async:
            from fraud_detection_tpu_torch.stream.annotations import (
                AsyncAnnotationLane)

            self._annotation_lane = AsyncAnnotationLane(
                explain_batch_fn, annotations_producer,
                annotations_topic or f"{output_topic}-annotations",
                max_queue=annotations_queue, rowtrace=rowtrace)
            self.explain_fn = explain_fn = None
            self.explain_batch_fn = explain_batch_fn = None
        # Surfaced in health() only; the hook and the lane own the calls
        # (the sentinel is evaluated by its own driver thread). Share ONE
        # sentinel, like ONE row tracer, across a worker's supervised
        # incarnations, so incident and span accounting survive restarts.
        self._breaker = breaker
        self._explain_service = explain_service
        self._sentinel = sentinel
        self._rowtrace = rowtrace
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
        # Optional registry/shadow.ShadowScorer: each scored batch's inputs
        # + primary results are offered to it (non-blocking bounded queue);
        # the candidate scores on the shadow worker, never here.
        self._shadow = shadow
        # Optional learn.LearnLoop: each scored batch's coordinates, inputs
        # and results are offered to the learner's bounded queue (same
        # non-blocking contract); decode/encode/windowing run on its lane.
        self._learn = learn
        self._lane = None                        # live lane while run()s
        self._lane_stats: Optional[dict] = None  # last run's lane counters
        # Raw-JSON fast path: None = untried, False = unavailable (device
        # featurize, no native library, or an explain hook), True = in use.
        self._json_fast: Optional[bool] = (
            None if explain_fn is None and explain_batch_fn is None else False)
        # Native output-frame assembly: None = untried (probed on first use).
        self._frames_ok: Optional[bool] = None
        # Injectable monotonic clock for health ages (tests drive it).
        self._clock = clock
        self._created_at = clock()
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
        self._stopped = True    # flightcheck: ignore[FC102] — documented lock-free latch
        self._running = False   # flightcheck: ignore[FC102] — documented lock-free latch

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
        # Correlation id minted at poll: this batch's trace context rides
        # _Prep/_InFlight through every later leg.
        bt = (self._rowtrace.batch_begin(len(msgs))
              if self._rowtrace is not None else None)
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
                msgs, self._sched.backlog_of(self.consumer), trace=bt)
            if shed_rows:
                dead, dead_reasons = [], {}
                for m, reason in shed_rows:
                    dead.append((_dlq_record(
                        m, reason,
                        "shed by admission control; replay from the DLQ "
                        "record's source coordinates",
                        trace=(bt.row_cid(m) if bt is not None else None)),
                        m.key))
                    dead_reasons[reason] = dead_reasons.get(reason, 0) + 1
                shed_n = len(shed_rows)
                msgs = keep
        if self._dlq_attempts is not None:
            if dead is None:
                dead, dead_reasons = [], {}
            msgs = self._screen_poison(msgs, dead, dead_reasons, bt)
        prep_time = time.perf_counter() - t0
        if bt is not None:
            bt.add("admit", prep_time,
                   detail=f"kept={len(msgs)} shed={shed_n}")
        return _Prep(msgs, offsets, dead, dead_reasons, shed_n, prep_time,
                     bt)

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
        inflight.trace = prep.trace
        if prep.trace is not None:
            # The featurize + upload + launch leg (maybe on the lane's
            # thread: the trace travels with its batch, FIFO, never shared).
            prep.trace.add("launch", inflight.dispatch_time)
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
                       dead_reasons: dict,
                       bt: Optional[object] = None) -> List[Message]:
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
                    attempts=n,
                    trace=(bt.dlq(m, "max_attempts_exceeded")
                           if bt is not None else None)), m.key))
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
        bt = inflight.trace
        if inflight.pending is None:
            preds = None
        elif bt is not None:
            # Ends when the host holds the labels (the device-to-host copy
            # included), not at launch.
            with bt.span("device"):
                preds = inflight.pending.resolve()
        else:
            preds = inflight.pending.resolve()
        if bt is not None and preds is not None:
            self._trace_flags(inflight, preds)
        if preds is not None and self._annotation_lane is not None:
            self._submit_annotations(inflight, preds)
        if preds is not None and self._shadow is not None:
            self._submit_shadow(inflight, preds)
        if preds is not None and self._learn is not None:
            self._submit_learn(inflight, preds)
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

    def _submit_annotations(self, inflight: "_InFlight", preds) -> None:
        """Hand this batch's flagged (non-benign) valid rows to the async
        lane. Non-blocking: the lane's bounded queue absorbs or drops; the
        frames ship regardless. Text is extracted for flagged rows only, so
        the raw and native paths keep their zero-decode hot loop."""
        labels = np.asarray(preds.labels)
        flagged = np.flatnonzero(labels != 0)
        if flagged.size == 0:
            return
        confs = _confidence_array(preds)
        flag_labels = labels[flagged].tolist()
        flag_confs = confs[flagged].tolist()
        msgs = inflight.msgs
        bt = inflight.trace
        items = []
        if inflight.raw:
            # Predictions are positional over ALL rows; malformed rows hold
            # padding garbage — keep valid ones only.
            valid = frozenset(inflight.valid_idx)
            for i, label, conf in zip(flagged.tolist(), flag_labels,
                                      flag_confs):
                if i not in valid:
                    continue
                text = self._annotation_text(inflight, i)
                if text is not None:
                    items.append((msgs[i].key, text, label, conf,
                                  bt.row_cid(msgs[i])
                                  if bt is not None else None))
        else:
            for j, label, conf in zip(flagged.tolist(), flag_labels,
                                      flag_confs):
                i = inflight.valid_idx[j]
                items.append((msgs[i].key, inflight.texts[i], label, conf,
                              bt.row_cid(msgs[i])
                              if bt is not None else None))
        if items:
            self._annotation_lane.submit(items)

    def _trace_flags(self, inflight: "_InFlight", preds) -> None:
        """Row events for this batch's flagged (non-benign) rows: flagged
        rows are always kept by the tracer (head sampling only throttles
        clean traffic), stored as one compact block of (partition, offset)
        pairs — the row ids materialize when the ring is read."""
        labels = np.asarray(preds.labels)
        flagged = np.flatnonzero(labels != 0)
        if flagged.size == 0:
            return
        if not inflight.raw:
            idxs = [inflight.valid_idx[j] for j in flagged.tolist()]
        elif len(inflight.valid_idx) == len(inflight.msgs):
            idxs = flagged.tolist()
        else:
            valid = frozenset(inflight.valid_idx)
            idxs = [i for i in flagged.tolist() if i in valid]
        msgs = inflight.msgs
        inflight.trace.events_rows(
            "flag", [(m.partition, m.offset)
                     for m in map(msgs.__getitem__, idxs)])

    def _annotation_text(self, inflight: "_InFlight", i: int) -> Optional[str]:
        """Decoded text of row i of a raw-mode batch: the stored literal (or
        the native path's encode-time span) is the complete QUOTED JSON
        string, so ``json.loads`` unescapes it exactly."""
        lit = inflight.texts[i]
        if lit is None and inflight.splice is not None:
            _, span_start, span_len = inflight.splice
            s = int(span_start[i])
            lit = inflight.msgs[i].value[s: s + int(span_len[i])]
        if lit is None:
            return None
        try:
            return json.loads(lit)
        except ValueError:  # cannot happen for scanner-validated literals
            return None

    def annotation_stats(self) -> Optional[dict]:
        """Async-lane counters (submitted/annotated/dropped/queue_depth), or
        None when the engine runs inline or without explanations."""
        lane = self._annotation_lane
        return lane.stats() if lane is not None else None

    def close_annotations(self, timeout: float = 30.0) -> bool:
        """Drain and stop the async lane (no-op inline). Call after the last
        run() when annotation completeness matters — run() leaves the lane
        up so repeated runs share it."""
        lane = self._annotation_lane
        return lane.close(timeout) if lane is not None else True

    def _submit_shadow(self, inflight: "_InFlight", preds) -> None:
        """Offer this batch's valid rows + primary results to the shadow
        scorer. Non-blocking (bounded queue, drop + count on overflow);
        payloads are REFERENCES (message bytes in raw mode, decoded texts
        otherwise) — the candidate decode/score happens on the shadow
        worker, never here."""
        sh = self._shadow
        if not sh.wants():
            return
        valid = inflight.valid_idx
        if not valid:
            return
        if inflight.raw:
            # Predictions are positional over ALL rows; slice to valid.
            payloads = [inflight.msgs[i].value for i in valid]
            labels = np.asarray(preds.labels)[valid]
            probs = np.asarray(preds.probabilities)[valid]
        else:
            # Predictions already cover exactly the valid rows, in order.
            payloads = [inflight.texts[i] for i in valid]
            labels, probs = preds.labels, preds.probabilities
        sh.submit(payloads, labels, probs, raw=inflight.raw,
                  text_field=self.text_field)

    def _submit_learn(self, inflight: "_InFlight", preds) -> None:
        """Offer this batch's valid rows + primary results to the learn
        loop's window. Non-blocking (bounded queue, drop + count on
        overflow); payloads are REFERENCES — decode/encode happen on the
        learn lane, never here."""
        lr = self._learn
        if not lr.wants():
            return
        valid = inflight.valid_idx
        if not valid:
            return
        msgs = inflight.msgs
        coords = [(msgs[i].topic, msgs[i].partition, msgs[i].offset)
                  for i in valid]
        if inflight.raw:
            payloads = [msgs[i].value for i in valid]
            labels = np.asarray(preds.labels)[valid]
            probs = np.asarray(preds.probabilities)[valid]
        else:
            payloads = [inflight.texts[i] for i in valid]
            labels, probs = preds.labels, preds.probabilities
        lr.submit(coords, payloads, labels, probs, raw=inflight.raw,
                  version=getattr(self.pipeline, "active_version", None))

    def _dead_letter(self, inflight: "_InFlight", msg: Message, reason: str,
                     error: str) -> None:
        """Divert one row to the DLQ: its record rides THIS batch's delivery
        (same flush/commit accounting as the output frames)."""
        if inflight.dead is None:
            inflight.dead, inflight.dead_reasons = [], {}
        bt = inflight.trace
        inflight.dead.append((_dlq_record(
            msg, reason, error,
            trace=(bt.dlq(msg, reason) if bt is not None else None)),
            msg.key))
        inflight.dead_reasons[reason] = inflight.dead_reasons.get(reason, 0) + 1

    def health(self) -> dict:
        """Point-in-time engine health snapshot (lock-free racy reads, a
        monitoring sample). ``dlq`` is None when the DLQ is off, ``sched``
        without a scheduler, ``annotations`` without the async lane,
        ``breaker`` and ``explain`` without a breaker or slotserve service;
        ``model`` is None for a plain static pipeline without a shadow
        scorer, ``learn`` without a learn loop."""
        now = self._clock()
        # Model-lifecycle block: present when the engine scores through a
        # HotSwapPipeline (active/staged versions, swap count) and/or a
        # ShadowScorer is attached (divergence stats).
        snap_fn = getattr(self.pipeline, "lifecycle_snapshot", None)
        model = snap_fn() if callable(snap_fn) else None
        if self._shadow is not None:
            if model is None:
                model = {"active_version": None, "staged_version": None,
                         "swaps": 0, "last_swap_age_sec": None}
            model["shadow"] = self._shadow.snapshot()
        elif model is not None:
            model["shadow"] = None
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
            "annotations": self.annotation_stats(),
            "breaker": _snapshot_of(self._breaker),
            "explain": _snapshot_of(self._explain_service),
            "model": model,
            "learn": (self._learn.snapshot()
                      if self._learn is not None
                      and hasattr(self._learn, "snapshot")
                      else None),
            # Row tracing: span begun/ended counters, ring depth and drops,
            # per-stage latency quantiles.
            "trace": (self._rowtrace.snapshot()
                      if self._rowtrace is not None else None),
            # Alerting: rule states, firing lists, incident accounting.
            "alerts": _snapshot_of(self._sentinel),
        }

    def _device_block(self) -> dict:
        """The ``device`` block of ``health()``: dispatch depth and the
        lane's counters (the live lane's, or the last run's), host->device
        copies per micro-batch, what is resident on the device, the mesh,
        and which featurize path ran."""
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
            # mesh data-parallel scoring: devices on the data axis (0 = the
            # single-device path) and the per-device rungs dispatched, the
            # scheduler's prewarm included
            "mesh_devices": snap["mesh_devices"],
            "per_chip_rungs": snap["per_chip_rungs"],
            "featurize_path": snap["featurize_path"],
            "bytes_in_per_row": snap["bytes_in_per_row"],
            "truncated_rows": snap["truncated_rows"],
        }

    def _deliver(self, inflight: "_InFlight", wires: List[tuple],
                 t1: float) -> int:
        msgs = inflight.msgs
        bt = inflight.trace
        t_del = time.perf_counter() if bt is not None else 0.0
        produce_batch = getattr(self.producer, "produce_batch", None)
        if produce_batch is not None:
            produce_batch(self.output_topic, wires)
            if inflight.dead:
                produce_batch(self.dlq_topic, inflight.dead)
        else:
            # a producer with only ``produce`` (the front end's tap)
            for wire, key in wires:
                self.producer.produce(self.output_topic, wire, key=key)
            for wire, key in inflight.dead or ():
                self.producer.produce(self.dlq_topic, wire, key=key)

        # Produce-then-commit: commit ONLY if the producer fully drained;
        # a skipped commit must also STOP the loop, or a later batch's
        # commit would advance past this batch's lost outputs.
        undelivered = self.producer.flush()
        if undelivered:
            self.stats.commits_skipped += 1
            self._flush_fail_streak += 1
            self._flush_failed = True
            self._running = False
            if bt is not None:
                # The batch will be replayed: its deliver leg closes failed
                # and its trace is kept (aborted batches are interesting).
                bt.add("deliver", time.perf_counter() - t_del, ok=False,
                       detail=f"undelivered={undelivered}")
                self._rowtrace.abort(bt, "flush_failed")
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
        self._last_batch_at = self._clock()
        if bt is not None:
            if msgs and getattr(self._rowtrace, "record_rows", False):
                # Record mode: every delivered row's source coordinates, the
                # census an exact replay needs.
                bt.events_rows("row", [(m.partition, m.offset)
                                       for m in msgs])
            # Terminal: the deliver leg closes and the batch's spans commit
            # to the ring (kept when sampled or interesting).
            bt.add("deliver", time.perf_counter() - t_del,
                   detail=f"rows={len(wires)}")
            self._rowtrace.commit(bt)
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
        then discarded uncommitted).

        An incarnation that dies (a broker fault, a flush crash, a lane
        failure) with batches in flight stops the lane (its thread joined,
        its launched batches dropped with their pending device-to-host
        copies), commits none of their offsets, and closes their traces as
        aborted — the failed batch's too, so every minted batch reaches a
        terminal."""
        if self.async_dispatch:
            from fraud_detection_tpu_torch.sched.batcher import DispatchLane

            lane = DispatchLane(self._launch, depth=self.pipeline_depth)
        else:
            lane = _InlineDispatch(self._launch)
        self._lane = lane
        pending: "deque[_Prep]" = deque()   # submitted, not yet delivered
        discarded: list = []                # abandoned batches (their traces
                                            # close after the lane joins)
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
                pending.append(prep)   # first: a failed launch still aborts
                lane.submit(prep)
                if len(pending) > self.pipeline_depth:
                    deliver_oldest()
                self._inflight_depth = len(pending)
        except BaseException:
            # Never finish newer batches past an interrupted one: leave
            # them uncommitted for a restart to replay (at-least-once).
            discarded.extend(pending)
            pending.clear()
            raise
        finally:
            try:
                while pending and not self._flush_failed:
                    deliver_oldest()
            except BaseException:
                discarded.extend(pending)
                pending.clear()
                raise
            finally:
                lane.stop()
                self._abort_traces(discarded, "engine_abort")
                # Left behind a failed flush: replayed by the next run.
                self._abort_traces(pending, "discarded_after_flush_failure")
                pending.clear()
                self._lane_stats = lane.stats()
                self._max_inflight = max(self._max_inflight,
                                         lane.max_inflight)
                self._lane = None
                self._inflight_depth = 0
                self._running = False
                self.stats.elapsed = time.perf_counter() - started
        return self.stats


    def _abort_traces(self, batches, reason: str) -> None:
        """Close the traces of batches being discarded (crash / flush-fail
        replay paths), so every minted batch reaches a terminal. Abort is
        idempotent: a batch whose trace already closed is skipped."""
        if self._rowtrace is None:
            return
        for b in batches:
            self._rowtrace.abort(b.trace, reason)


def _snapshot_of(component) -> Optional[dict]:
    snap = getattr(component, "snapshot", None)
    return snap() if callable(snap) else None


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
    trace: Optional[object] = None  # obs.trace.BatchTrace (tracing on)

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
    trace: Optional[object] = None  # obs.trace.BatchTrace (tracing on)


def run_supervised(make_engine: Callable[[], StreamingClassifier], *,
                   max_restarts: int = 5,
                   backoff: float = 0.5,
                   backoff_cap: float = 30.0,
                   max_messages: Optional[int] = None,
                   idle_timeout: Optional[float] = None,
                   sleep=time.sleep,
                   jitter: bool = True,
                   rng: Optional[random.Random] = None) -> StreamStats:
    """Failure-detecting restart loop around the streaming engine.

    ``make_engine`` builds a fresh engine (a new consumer resumes from the
    group's committed offsets); a failed incarnation — an exception out of
    ``run`` or out of ``make_engine`` itself, or a producer flush that left
    outputs undelivered — is restarted after an exponential backoff that
    resets after any run that made progress. Gives up after
    ``max_restarts`` consecutive failures and re-raises the last error with
    the aggregated stats attached as ``.supervisor_stats``.

    A fault of the card (``utils/device.is_device_fault``: a CUDA error, a
    kernel that did not build or launch, device memory exhausted) is not
    restarted around: it re-raises at once, with zero restarts spent on
    it. Restarts are for broker and transport faults.

    Backoff uses FULL JITTER: each wait is uniform in [0, min(backoff *
    2^(n-1), backoff_cap)], so workers failed by one outage do not rejoin
    in synchronized waves. ``jitter=False`` restores the deterministic
    ceiling; ``rng`` injects a seeded ``random.Random`` for reproducible
    schedules. Returns StreamStats aggregated across incarnations
    (``restarts`` counts the rebuilds)."""
    uniform = (rng.uniform if rng is not None else random.uniform)
    total = StreamStats()
    consecutive = 0
    while True:
        budget = None if max_messages is None else max_messages - total.processed
        if budget is not None and budget <= 0:
            break
        engine: Optional[StreamingClassifier] = None
        failed: Optional[BaseException] = None
        interrupted = False
        stats = StreamStats()
        try:
            # Inside the guard: with the broker down, building the clients
            # can raise — a failed incarnation, not a supervisor crash.
            engine = make_engine()
            stats = engine.run(max_messages=budget, idle_timeout=idle_timeout)
        except KeyboardInterrupt:
            if engine is not None:
                stats = engine.stats
            interrupted = True
        except Exception as e:  # noqa: BLE001 — the supervisor's whole job
            if engine is not None:
                stats = engine.stats
            failed = e
        finally:
            # A crashed incarnation's consumer leaves the group promptly
            # (a zombie would hold its partitions) and its clients close.
            if engine is not None:
                for client in (engine.consumer, engine.producer):
                    close = getattr(client, "close", None)
                    if close is not None:
                        try:
                            close()
                        except Exception:  # noqa: BLE001
                            pass
        _merge_stats(total, stats)
        if interrupted:
            break
        if failed is not None and is_device_fault(failed):
            failed.supervisor_stats = total
            raise failed
        flush_failed = stats.commits_skipped > 0
        if failed is None and not flush_failed:
            break  # clean exit (idle timeout / max_messages / stop())
        if stats.processed > 0:
            consecutive = 0  # made progress: a fresh incident
        consecutive += 1
        if consecutive > max_restarts:
            if failed is None:
                failed = RuntimeError(
                    f"producer flush kept failing after {max_restarts} "
                    f"restarts (last committed offsets hold; "
                    f"{total.processed} processed)")
            failed.supervisor_stats = total
            raise failed
        total.restarts += 1
        delay = min(backoff * (2 ** (consecutive - 1)), backoff_cap)
        if jitter:
            delay = uniform(0.0, delay)
        try:
            sleep(delay)
        except KeyboardInterrupt:
            break
    return total


def _merge_stats(total: StreamStats, part: StreamStats) -> None:
    total.processed += part.processed
    total.malformed += part.malformed
    total.dead_lettered += part.dead_lettered
    total.shed += part.shed
    total.batches += part.batches
    total.commits_skipped += part.commits_skipped
    total.rebalanced_commits += part.rebalanced_commits
    total.elapsed += part.elapsed
    # Sum/max merge exactly; the percentile reservoir merges by samples.
    total.batch_latency_sum += part.batch_latency_sum
    total.batch_latency_max = max(total.batch_latency_max,
                                  part.batch_latency_max)
    for dt in part.latencies:
        total._reservoir_add(dt)
    # The row-latency sketch merges losslessly (bucket counts add).
    total.row_sketch.merge(part.row_sketch)
