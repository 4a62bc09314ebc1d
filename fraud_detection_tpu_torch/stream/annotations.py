"""Asynchronous LLM annotation lane: classification never waits for decode —
twin of ``fraud_detection_tpu/stream/annotations.py``.

The inline ``explain_batch_fn`` hook explains a flagged micro-batch inside
the engine's finish leg, so the stream classifies at the explainer's rate.
This lane decouples them. Flagged rows are copied into a bounded queue and
the classified frames go out IMMEDIATELY (no "analysis" field — which keeps
the raw-JSON and native-frame paths in play); one worker thread drains the
queue in micro-batches through the same hook signature and produces
annotation records to a side topic (``<output_topic>-annotations``), keyed
like their source messages. When flagged rows arrive faster than the model
can explain them, the queue drops the OLDEST first and leaves a structured
drop record for each: the sampling rate is a recorded fact, not a stall.

Consumers join annotations to classifications by message key. A raising
backend is logged and counted; the lane and classification go on. With a
``rowtrace`` (``obs.RowTracer``) each row's explain span and annotate event
land on its correlation id, failures and drops as ok=False.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, List

from fraud_detection_tpu_torch.explain.prompts import label_name
from fraud_detection_tpu_torch.utils import get_logger

log = get_logger("stream.annotations")


class AsyncAnnotationLane:
    """Bounded background annotator feeding a side topic.

    ``explain_batch_fn``: the hook shape the inline path takes ((texts,
    labels, confs) -> [analysis | None]); a hook with ``accepts_cids`` also
    gets the rows' trace ids. Rows whose analysis comes back None produce
    no record.

    ``producer``/``topic``: where annotation records go. Records are JSON
    ``{"prediction", "label", "confidence", "analysis"}`` keyed by the
    source message's key. The producer must be the lane's OWN (a second
    client on the same transport), never the engine's: ``flush()`` is how
    both sides account delivery.
    """

    def __init__(self, explain_batch_fn: Callable, producer, topic: str, *,
                 max_queue: int = 1024, max_batch: int = 64,
                 rowtrace=None,
                 clock: Callable[[], float] = time.perf_counter):
        if max_queue < 1 or max_batch < 1:
            raise ValueError(
                f"max_queue/max_batch must be >= 1, got {max_queue}/{max_batch}")
        self._clock = clock   # injectable: drain/close deadlines in tests
        # Optional obs.trace.RowTracer: items may carry a 5th element (the
        # row's correlation id); the lane then records an "explain" span per
        # backend call and an "annotate" event per row (ok=False on backend
        # errors, breaker fast-fails and drops). Flagged rows are always
        # kept by the tracer, so these record straight into its ring.
        self._rowtrace = rowtrace
        self._fn = explain_batch_fn
        self._producer = producer
        self.topic = topic
        self.max_queue = max_queue
        self.max_batch = max_batch
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        # Structured drop records pending emission (built at the drop site
        # under _cv, produced by the WORKER so they ride the lane's
        # single-producer delivery accounting): (value_bytes, key, cid).
        self._drop_backlog: List[tuple] = []
        # submitted/dropped mutate under _cv; the rest are worker-thread
        # writes, read racily by stats() (snapshots, not invariants).
        self.submitted = 0
        self.dropped = 0
        # Drop records DELIVERED to the side topic. ``dropped`` exceeds it
        # only for close()-residual discards or undelivered flushes.
        self.drop_records = 0
        self.annotated = 0
        self.backend_errors = 0
        # Records handed to the producer across the lane's lifetime:
        # ``annotated`` is the running delivered total (produced minus
        # flush()'s queue depth), so records a failed flush left behind are
        # credited once when a later flush delivers them.
        self.produced = 0
        self._idle = threading.Event()
        self._idle.set()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="annotation-lane")
        self._thread.start()

    def submit(self, items: List[tuple]) -> None:
        """Enqueue (key, text, label, confidence[, trace_id]) rows; never
        blocks. Over capacity the OLDEST queued rows drop, each leaving a
        structured drop record (``{"dropped": true, "reason":
        "queue_overflow"}`` keyed like the source row) for the worker to
        produce."""
        if not items:
            return
        with self._cv:
            if self._closed:
                return
            for it in items:
                if len(self._q) >= self.max_queue:
                    old = self._q.popleft()
                    self.dropped += 1
                    self._drop_backlog.append(
                        self._drop_record(old, "queue_overflow"))
                self._q.append(it)
            self.submitted += len(items)
            self._idle.clear()
            self._cv.notify()

    @staticmethod
    def _drop_record(item: tuple, reason: str) -> tuple:
        """One structured drop record from a queued item: (value_bytes,
        key, cid). Same key and fields as an annotation record, ``analysis``
        null, ``dropped`` true, and ``trace`` when the row carries an id."""
        key, _text, label, conf = item[:4]
        cid = item[4] if len(item) == 5 else None
        rec = {"prediction": label, "label": label_name(label),
               "confidence": round(conf, 6), "analysis": None,
               "dropped": True, "reason": reason}
        if cid is not None:
            rec["trace"] = cid
        return json.dumps(rec).encode(), key, cid

    def _run(self) -> None:
        while True:
            with self._cv:
                while (not self._q and not self._drop_backlog
                       and not self._closed):
                    self._idle.set()
                    self._cv.wait(timeout=0.2)
                if not self._q and not self._drop_backlog and self._closed:
                    self._idle.set()
                    return
                drops, self._drop_backlog = self._drop_backlog, []
                batch = [self._q.popleft()
                         for _ in range(min(len(self._q), self.max_batch))]
            if drops:
                # Before the batch: a drop record must not wait behind a
                # multi-second decode — its row's accounting is already due.
                try:
                    self._emit_drops(drops)
                except Exception:  # noqa: BLE001 — lane must survive anything
                    # flightcheck: ignore[FC102] — worker-thread-only counter, read-racy by design (see __init__)
                    self.backend_errors += 1
                    log.exception("emitting %d drop records failed "
                                  "(counted in dropped, not drop_records)",
                                  len(drops))
            if not batch:
                continue
            try:
                self._annotate(batch)
            except Exception:  # noqa: BLE001 — lane must survive anything
                # flightcheck: ignore[FC102] — worker-thread-only counter, read-racy by design (see __init__)
                self.backend_errors += 1
                log.exception("annotation batch failed (%d rows dropped); "
                              "classification unaffected", len(batch))

    def _emit_drops(self, drops: List[tuple]) -> None:
        """Produce + flush the pending drop records, then count the
        delivered ones (the annotation records' accounting rule)."""
        for value, key, _cid in drops:
            self._producer.produce(self.topic, value, key=key)
        undelivered = int(self._producer.flush() or 0)
        # flightcheck: ignore[FC102] — worker-thread-only tally, read-racy by design
        self.drop_records += len(drops) - min(len(drops), undelivered)
        if undelivered:
            log.warning("producer left %d drop records undelivered "
                        "(dropped counter stays ahead of drop_records)",
                        undelivered)
        if self._rowtrace is not None:
            for _value, _key, cid in drops:
                if cid is not None:
                    self._rowtrace.record_event(
                        cid, "annotate", ok=False,
                        detail="dropped:queue_overflow")

    def _annotate(self, batch: List[tuple]) -> None:
        # Items are (key, text, label, conf[, trace_id]).
        batch = [it if len(it) == 5 else (*it, None) for it in batch]
        keys, texts, labels, confs, cids = map(list, zip(*batch))
        tr = self._rowtrace
        t0 = time.perf_counter()
        try:
            if getattr(self._fn, "accepts_cids", False):
                analyses = self._fn(texts, labels, confs, cids=cids)
            else:
                analyses = self._fn(texts, labels, confs)
        except Exception as e:
            if tr is not None:
                # One failed explain span for the call and a failed annotate
                # event per traced row (breaker fast-fails land here too).
                tr.record_span("lane", "explain", time.perf_counter() - t0,
                               ok=False, detail=type(e).__name__)
                for cid in cids:
                    if cid is not None:
                        tr.record_event(cid, "annotate", ok=False,
                                        detail=type(e).__name__)
            raise
        if tr is not None:
            tr.record_span("lane", "explain", time.perf_counter() - t0,
                           detail=f"rows={len(batch)}")
        if len(analyses) != len(batch):  # mirrors the engine's inline check
            raise ValueError(f"explain_batch_fn returned {len(analyses)} "
                             f"analyses for {len(batch)} rows")
        out, out_cids = [], []
        for key, label, conf, cid, analysis in zip(keys, labels, confs,
                                                   cids, analyses):
            if analysis is None:
                continue
            rec = {"prediction": label, "label": label_name(label),
                   "confidence": round(conf, 6), "analysis": analysis}
            out.append((json.dumps(rec).encode(), key))
            out_cids.append(cid)
        if not out:
            return
        batch_produce = getattr(self._producer, "produce_batch", None)
        if batch_produce is not None:
            batch_produce(self.topic, out)
        else:
            for value, key in out:
                self._producer.produce(self.topic, value, key=key)
        # Flush before counting: records still queued in a real producer
        # when the process exits are lost, and the counters are the lane's
        # recorded-fact contract.
        self.produced += len(out)
        undelivered = self._producer.flush()
        if undelivered:
            # flightcheck: ignore[FC102] — worker-thread-only counter, read-racy by design
            self.backend_errors += 1
            log.warning("producer left %d annotation records undelivered "
                        "(counted as not annotated)", undelivered)
        # max() keeps the running tally monotonic while the queue is deep.
        # flightcheck: ignore[FC102] — worker-thread-only tally, read-racy by design
        self.annotated = max(self.annotated, self.produced - int(undelivered))
        if tr is not None:
            for cid in out_cids:
                if cid is not None:
                    tr.record_event(cid, "annotate", ok=not undelivered)

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until the queue is empty and the worker is idle (or
        timeout). The lane stays usable after. True = fully drained.
        Bounded even against a hung backend; the deadline runs on the
        injectable ``clock``."""
        deadline = self._clock() + timeout
        while True:
            remaining = deadline - self._clock()
            if remaining <= 0:
                return False
            if self._idle.wait(timeout=min(remaining, 0.2)):
                with self._cv:
                    # Re-queued rows clear _idle under the same lock (see
                    # submit), so idle + empty here is conclusive. Pending
                    # drop records count as work.
                    if not self._q and not self._drop_backlog:
                        return True

    def close(self, timeout: float = 30.0) -> bool:
        """Drain best-effort, then stop the worker. True = clean shutdown
        (queue drained AND worker exited); False is honest about partial
        failure — rows discarded, or a worker hung in the backend (a daemon
        thread; the latched-closed lane drops late submits).

        After the drain deadline the residual queue is cleared under the
        lock, counted as dropped, before ``_closed`` latches, so stats read
        right after are quiescent up to the one batch in the worker's
        hands. The join is bounded too."""
        drained = self.drain(timeout)
        with self._cv:
            residual = len(self._q)
            if residual:
                self.dropped += residual
                self._q.clear()
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout=min(5.0, max(0.2, timeout)))
        alive = self._thread.is_alive()
        if alive:
            log.warning("annotation worker still running after close() "
                        "(hung backend?); daemon thread, counters may "
                        "move for one more batch")
        return drained and residual == 0 and not alive

    def stats(self) -> dict:
        with self._cv:
            return {"submitted": self.submitted, "annotated": self.annotated,
                    "dropped": self.dropped,
                    "drop_records": self.drop_records,
                    "backend_errors": self.backend_errors,
                    "queue_depth": len(self._q)}
