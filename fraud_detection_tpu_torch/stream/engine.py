"""Micro-batching streaming classification engine — the synchronous core of
``fraud_detection_tpu/stream/engine.py``'s ``StreamingClassifier``.

Drain the consumer into a micro-batch (up to ``batch_size`` messages,
waiting at most ``max_wait`` for the first), JSON-decode on the host, score
the whole batch through the serving pipeline (with device featurization the
host only packs raw bytes), produce the classified frames, THEN flush and
commit the batch's offsets: at-least-once with committed progress. Up to
``pipeline_depth`` batches are in flight while the next one is polled.

Malformed messages (bad JSON / missing text field) are counted and either
emitted inline as error frames or, with ``dlq_topic``, routed to the DLQ as
structured records; rows re-delivered more than ``dlq_max_attempts`` times
without a successful batch are diverted there too (poison screening).
"""

from __future__ import annotations

import json
import random
import time
from collections import deque
from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, Optional

import numpy as np

from fraud_detection_tpu_torch.explain.prompts import label_name
from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
from fraud_detection_tpu_torch.sched.sketch import LatencySketch
from fraud_detection_tpu_torch.stream.broker import (CommitFailedError,
                                                     Message)
from fraud_detection_tpu_torch.utils import get_logger
from fraud_detection_tpu_torch.utils.racecheck import ExclusiveRegion

log = get_logger("stream.engine")

# Output wire format: fixed frame, %.6f confidence.
_OUT_TEMPLATE = '{"prediction": %d, "label": %s, "confidence": %.6f, "original_text": %s}'


@lru_cache(maxsize=None)
def _label_json_str(label: int) -> str:
    return json.dumps(label_name(label))


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
    batches: int = 0
    commits_skipped: int = 0  # producer didn't drain; offsets left uncommitted
    rebalanced_commits: int = 0  # commit fenced by a group rebalance (routine)
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
            "batches": self.batches,
            "commits_skipped": self.commits_skipped,
            "rebalanced_commits": self.rebalanced_commits,
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
    commits. One thread at a time runs ``run``/``process_batch``."""

    def __init__(self, pipeline: ServingPipeline, consumer, producer,
                 output_topic: str, *, batch_size: int = 1024,
                 max_wait: float = 0.05, text_field: str = "text",
                 pipeline_depth: int = 2, dlq_topic: Optional[str] = None,
                 dlq_max_attempts: int = 3,
                 dlq_attempts: Optional[dict] = None):
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        if dlq_max_attempts < 1:
            raise ValueError(
                f"dlq_max_attempts must be >= 1, got {dlq_max_attempts}")
        self.pipeline = pipeline
        self.consumer = consumer
        self.producer = producer
        self.output_topic = output_topic
        self.batch_size = batch_size
        self.max_wait = max_wait
        self.text_field = text_field
        self.pipeline_depth = pipeline_depth
        # Dead-letter routing: malformed rows and rows re-delivered more
        # than ``dlq_max_attempts`` times go to the DLQ topic. Pass ONE
        # ``dlq_attempts`` dict to every incarnation so poison counting
        # survives restarts. None keeps inline error frames.
        self.dlq_topic = dlq_topic
        self.dlq_max_attempts = dlq_max_attempts
        self._dlq_attempts = ((dlq_attempts if dlq_attempts is not None else {})
                              if dlq_topic is not None else None)
        self._dlq_counts: dict = {}   # reason -> records delivered to the DLQ
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
        """Decode + featurize + launch device scoring; does NOT wait for
        the device."""
        return self._launch(self._prepare(msgs))

    def _prepare(self, msgs: List[Message]) -> "_Prep":
        """Admission for a freshly polled batch: offset cover and poison
        screening."""
        t0 = time.perf_counter()
        # Offsets cover the ORIGINAL batch — rows screened out below are
        # handled (their DLQ record ships with this batch) and must commit.
        offsets: dict = {}
        for m in msgs:
            key = (m.topic, m.partition)
            offsets[key] = max(offsets.get(key, 0), m.offset + 1)
        dead: Optional[List[tuple]] = None
        dead_reasons: Optional[dict] = None
        if self._dlq_attempts is not None:
            dead, dead_reasons = [], {}
            msgs = self._screen_poison(msgs, dead, dead_reasons)
        return _Prep(msgs, offsets, dead, dead_reasons,
                     time.perf_counter() - t0)

    def _launch(self, prep: "_Prep") -> "_InFlight":
        """Decode + device dispatch for a prepared batch (the slow path: JSON
        decoded in Python, texts handed to ``pipeline.predict_async``)."""
        t0 = time.perf_counter()
        msgs = prep.msgs
        texts: List[Optional[str]] = [self._decode(m) for m in msgs]
        valid_idx = [i for i, t in enumerate(texts) if t is not None]
        pending = (self.pipeline.predict_async([texts[i] for i in valid_idx])
                   if valid_idx else None)
        inflight = _InFlight(msgs, texts, valid_idx, pending, prep.offsets,
                             time.perf_counter() - t0 + prep.prep_time)
        if prep.dead:
            inflight.dead = prep.dead
            inflight.dead_reasons = prep.dead_reasons
            # Screened rows are OUTSIDE inflight.msgs — accounting adds
            # them back.
            inflight.dead_screened = len(prep.dead)
        inflight.recv_wall = time.time()
        return inflight

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

    def _finish(self, inflight: "_InFlight") -> int:
        """Wait for an in-flight batch's device results, produce outputs,
        flush, commit that batch's offsets. Returns messages handled."""
        t1 = time.perf_counter()
        msgs, texts = inflight.msgs, inflight.texts
        results: List[Optional[tuple]] = [None] * len(msgs)
        if inflight.pending is not None:
            preds = inflight.pending.resolve()
            labels = preds.labels.tolist()
            confs = _confidence_array(preds).tolist()
            for j, i in enumerate(inflight.valid_idx):
                results[i] = (labels[j], confs[j])

        wires: List[tuple] = []
        for msg, text, res in zip(msgs, texts, results):
            if res is None:
                self.stats.malformed += 1
                if self.dlq_topic is not None:
                    self._dead_letter(inflight, msg, "malformed",
                                      "undecodable JSON or missing/"
                                      "non-string text field")
                    continue
                wire = _malformed_wire(msg)
            else:
                label, confidence = res
                wire = (_OUT_TEMPLATE % (label, _label_json_str(label),
                                         confidence, json.dumps(text))).encode()
            wires.append((wire, msg.key))
        return self._deliver(inflight, wires, t1)

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
        monitoring sample). ``dlq`` is None when the DLQ is off."""
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
            "rebalanced_commits": self.stats.rebalanced_commits,
            "commits_skipped": self.stats.commits_skipped,
            "row_latency_ms": {"p50": self.stats.row_latency_ms(0.50),
                               "p99": self.stats.row_latency_ms(0.99)},
            "device": self._device_block(),
            "dlq": (None if self.dlq_topic is None else {
                "topic": self.dlq_topic,
                "routed": dict(self._dlq_counts),
                "tracked_offsets": len(self._dlq_attempts),
            }),
        }

    def _device_block(self) -> dict:
        """The ``device`` block of ``health()``: dispatch depth, host->device
        copies per micro-batch, what is resident on the device, and which
        featurize path ran."""
        snap = self.pipeline.device_stats.snapshot()
        return {
            "device": str(self.pipeline.device),
            "dispatch_depth": self.pipeline_depth,
            "max_inflight": self._max_inflight,
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
        self.stats.batches += 1
        self.stats.record_latency(dt)
        if msgs:
            # Per-row enqueue->produce latency: producer timestamp when the
            # transport carries one, else this batch's poll-receipt stamp.
            now_wall = time.time()
            ts = np.fromiter((m.timestamp for m in msgs), np.float64,
                             len(msgs))
            self.stats.row_sketch.add_many(
                np.where(ts > 0.0, now_wall - ts, now_wall - inflight.recv_wall))
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
            started = time.perf_counter()
            in_flight: "deque[_InFlight]" = deque()
            try:
                self._run_loop(in_flight, max_messages, idle_timeout)
            except BaseException:
                # Never finish newer batches past an interrupted one: leave
                # them uncommitted for a restart to replay (at-least-once).
                in_flight.clear()
                raise
            finally:
                while in_flight and not self._flush_failed:
                    self._finish(in_flight.popleft())
                self._inflight_depth = 0
                self._running = False
                self.stats.elapsed = time.perf_counter() - started
            return self.stats

    def _run_loop(self, in_flight, max_messages, idle_timeout) -> None:
        idle_since: Optional[float] = None
        while self._running:
            budget = self.batch_size
            if max_messages is not None:
                consumed = self.stats.processed + sum(
                    len(f.msgs) + f.dead_screened for f in in_flight)
                budget = min(budget, max_messages - consumed)
            if budget <= 0:
                if in_flight:
                    self._finish(in_flight.popleft())
                    self._inflight_depth = len(in_flight)
                    continue
                break
            msgs = self.consumer.poll_batch(budget, self.max_wait)
            if not msgs:
                if in_flight:
                    # Drain the tail rather than idling behind it.
                    self._finish(in_flight.popleft())
                    self._inflight_depth = len(in_flight)
                    continue
                now = time.perf_counter()
                idle_since = idle_since or now
                if idle_timeout is not None and now - idle_since >= idle_timeout:
                    break
                continue
            idle_since = None
            in_flight.append(self._dispatch(msgs))
            self._max_inflight = max(self._max_inflight, len(in_flight))
            if len(in_flight) > self.pipeline_depth:
                self._finish(in_flight.popleft())
            self._inflight_depth = len(in_flight)


@dataclass
class _Prep:
    """A polled micro-batch after admission (poison screen)."""
    msgs: List[Message]
    offsets: dict
    dead: Optional[List[tuple]]
    dead_reasons: Optional[dict]
    prep_time: float            # seconds spent preparing


@dataclass
class _InFlight:
    """A micro-batch whose device scoring has been dispatched but not resolved."""
    msgs: List[Message]
    texts: List[Optional[str]]  # decoded texts (None = malformed)
    valid_idx: List[int]
    pending: Optional[object]   # models.pipeline.PendingPrediction
    offsets: dict               # (topic, partition) -> next offset to commit
    dispatch_time: float        # host seconds spent dispatching
    dead: Optional[List[tuple]] = None
    dead_reasons: Optional[dict] = None
    dead_screened: int = 0      # dead rows NOT in msgs (poison screen)
    recv_wall: float = 0.0      # wall-clock poll receipt (latency fallback)
