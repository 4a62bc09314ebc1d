"""Tracecraft: end-to-end row/batch tracing for the serving pipeline —
twin of ``fraud_detection_tpu/obs/trace.py``.

The pipeline grew deep — admission -> batch formation -> lane ``_prepare``/
``_launch`` -> device dispatch -> delivery -> async annotation -> DLQ —
and its only windows were per-component ``health()`` aggregates: when the
headline moves, nothing says WHICH stage, which worker, which rung. This
module adds the missing attribution layer, Dapper-style but sized for a
50k rows/sec hot loop:

* A **correlation id is minted per polled batch** (``<worker>-<seq>``) and
  every row derives a stable id from it (``<batch>:<partition>:<offset>``)
  — the same coordinates DLQ/shed records already carry, so a dead-lettered
  row joins back to its spans by construction.
* **Spans are batch-granular** ("poll", "admit", "launch", "device",
  "deliver") with **row-granular events** for the interesting minority
  (shed, dlq, flag, annotate): per-row spans for every clean row would cost
  more than the work they measure; per-batch spans plus row events keep the
  overhead under the bench's 5%% tracing budget while still giving every
  flagged/shed/DLQ'd row a complete poll->terminal chain by id.
* Spans buffer **batch-locally** (no shared state while the batch is in
  flight) and commit into a fixed-size ring in ONE append per batch at the
  terminal (deliver/abort). The ring drops OLDEST on overflow and counts
  the drop — it never blocks the hot path, and the counter makes the loss
  an explicit recorded fact.
* **Head sampling with forced keeps**: each batch draws its keep/discard
  fate at mint time (seeded RNG, ``sample`` fraction), but a batch that
  turns out interesting — flagged, shed, dead-lettered, breaker-tripped,
  aborted — is kept REGARDLESS of the draw. Sampling controls the clean-
  traffic volume; accountability rows are always-on.
* **Exact accounting**: every span begun is ended (context managers +
  explicit abort on the engine's failure paths), and ``begun == ended`` is
  a pinned invariant under seeded chaos and fleet worker kills
  (tests/test_torch_obs.py).
* Per-stage wall time also feeds one :class:`LatencySketch` per stage
  (bounded memory, lossless merge), independent of sampling — the fleet
  aggregation and the bench's ``stages`` attribution block read these, so
  p50/p99 per stage covers ALL batches, not the sampled subset.

Thread model: a batch's trace is owned by whichever thread is driving that
batch leg (engine driver, dispatch lane, annotation lane) — legs hand off
strictly FIFO, never concurrently. Tracer-global state (the ring, the
counters, the stage sketches) is guarded by one small lock held O(1) per
BATCH, not per row or per span.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

from fraud_detection_tpu_torch.sched.sketch import LatencySketch

# The span vocabulary (docs/observability.md). Batch stages carry
# durations; row events are instantaneous markers with a reason.
STAGE_POLL = "poll"          # batch minted from a poll (rows, wait)
STAGE_ADMIT = "admit"        # admission + poison screen (driver)
STAGE_LAUNCH = "launch"      # featurize + upload + device launch
STAGE_DEVICE = "device"      # blocking on device results
STAGE_DELIVER = "deliver"    # produce + flush + commit
STAGE_EXPLAIN = "explain"    # one LLM explain call (annotation lane)
EVENT_SHED = "shed"          # row diverted by admission control
EVENT_DLQ = "dlq"            # row dead-lettered (malformed/poison)
EVENT_FLAG = "flag"          # row classified non-benign
EVENT_ANNOTATE = "annotate"  # row's annotation produced (or failed)
EVENT_ABORT = "abort"        # batch abandoned (crash/flush-fail replay)
EVENT_ROW = "row"            # row delivered (record mode only: the full
                             # per-batch row census a trace RECORDING needs
                             # for exact replay — scenarios/record.py)


class Span(NamedTuple):
    """One recorded span/event. ``cid`` is the batch correlation id for
    batch stages and the row id (``<batch>:<part>:<off>``) for row
    events; ``detail`` is a small JSON-safe annotation (row counts,
    shed/DLQ reason, ...). A NamedTuple, not a dataclass: row events are
    created per flagged/shed row on the hot path and construction cost is
    the tracing overhead budget's biggest line item."""

    cid: str
    stage: str
    start: float            # wall-clock seconds (time.time domain)
    duration_ms: float
    ok: bool = True
    detail: Optional[str] = None

    def as_dict(self) -> dict:
        return {"cid": self.cid, "stage": self.stage,
                "start": round(self.start, 6),
                "duration_ms": round(self.duration_ms, 4),
                "ok": self.ok, "detail": self.detail}


class _RowEvents(NamedTuple):
    """A batch of row events stored COMPACT: one ring entry carrying the
    rows' (partition, offset) int pairs instead of N materialized Spans —
    at a 50% flag rate the hot path would otherwise build ~2000 Span
    objects + cid strings per micro-batch, which alone blows the 5%
    tracing-overhead budget. Expansion to Spans (cid strings included)
    happens at read time (snapshot/chain), where nobody is counting
    microseconds."""

    prefix: str             # batch correlation id
    stage: str
    pairs: tuple            # ((partition, offset), ...)
    start: float
    ok: bool = True
    detail: Optional[str] = None

    def expand(self) -> List[Span]:
        return [Span(f"{self.prefix}:{p}:{o}", self.stage, self.start,
                     0.0, self.ok, self.detail) for p, o in self.pairs]


def _weight(entry) -> int:
    return len(entry.pairs) if type(entry) is _RowEvents else 1


class SpanRing:
    """Fixed-capacity span store: drop-OLDEST on overflow, drops counted,
    O(1) per append with one small lock — appends never wait on readers
    (snapshot copies under the same lock and returns). Entries are Spans
    or compact :class:`_RowEvents` blocks; capacity, depth, and the
    recorded/dropped counters all count SPANS (a dropped block counts
    every row event it carried — overflow honesty is span-granular)."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity            # entries held at most
        self._buf: List[Optional[object]] = [None] * capacity
        self._next = 0          # next write slot
        self._len = 0           # entries held
        self._spans = 0         # span-weight currently held
        self.recorded = 0       # spans ever appended
        self.dropped = 0        # spans overwritten before anyone read them
        self._lock = threading.Lock()

    def extend(self, entries: Sequence[object]) -> None:
        n = 0
        with self._lock:
            for e in entries:
                w = _weight(e)
                n += w
                if self._len == self.capacity:
                    old = self._buf[self._next]
                    ow = _weight(old)
                    self.dropped += ow
                    self._spans -= ow
                else:
                    self._len += 1
                self._buf[self._next] = e
                self._spans += w
                self._next = (self._next + 1) % self.capacity
            self.recorded += n

    def __len__(self) -> int:
        """Spans currently held (expanded count, not entries)."""
        with self._lock:
            return self._spans

    def snapshot(self) -> List[Span]:
        """Oldest -> newest expanded copy of the live spans."""
        with self._lock:
            if self._len < self.capacity:
                entries = self._buf[: self._len]
            else:
                entries = self._buf[self._next:] + self._buf[: self._next]
        out: List[Span] = []
        for e in entries:
            if type(e) is _RowEvents:
                out.extend(e.expand())
            else:
                out.append(e)
        return out


class BatchTrace:
    """One polled batch's trace context: batch-local span buffer plus the
    keep/sample fate. NOT thread-safe on its own — a batch leg is owned by
    exactly one thread at a time (driver -> lane -> driver, strict FIFO),
    which is the engine's existing handoff contract."""

    __slots__ = ("tracer", "cid", "sampled", "keep", "spans", "committed")

    def __init__(self, tracer: "RowTracer", cid: str, sampled: bool):
        self.tracer = tracer
        self.cid = cid
        self.sampled = sampled
        self.keep = False           # forced keep: flagged/shed/dlq/abort
        self.spans: List[Span] = []
        self.committed = False

    # -- batch stages ---------------------------------------------------

    def span(self, stage: str, *, detail: Optional[str] = None):
        """Context manager timing one batch stage; exception-safe (the
        span ends, ok=False, and re-raises)."""
        return _SpanCtx(self, stage, detail)

    def add(self, stage: str, duration_sec: float, *, ok: bool = True,
            detail: Optional[str] = None,
            start: Optional[float] = None) -> None:
        """Record an already-measured batch stage (the engine's existing
        ``dispatch_time`` style timings)."""
        t = self.tracer
        t._count_begin_end()
        self.spans.append(Span(self.cid, stage,
                               t._wall() if start is None else start,
                               duration_sec * 1e3, ok, detail))
        t._observe_stage(stage, duration_sec)

    # -- row events -----------------------------------------------------

    def row_cid(self, msg) -> str:
        """The stable per-row correlation id: batch cid + the row's source
        coordinates (the same (partition, offset) its DLQ record carries)."""
        return f"{self.cid}:{msg.partition}:{msg.offset}"

    def event(self, stage: str, cid: str, *, ok: bool = True,
              detail: Optional[str] = None) -> None:
        """Instantaneous row-level marker; marks the batch kept (row
        events only exist for interesting rows)."""
        t = self.tracer
        t._count_begin_end()
        self.keep = True
        self.spans.append(Span(cid, stage, t._wall(), 0.0, ok, detail))

    def events_rows(self, stage: str, pairs: List[tuple], *,
                    ok: bool = True, detail: Optional[str] = None) -> None:
        """Batched row markers stored COMPACT (``pairs`` = the rows'
        (partition, offset) coordinates): one counter bump, one wall
        read, ONE ring entry for the whole list. This is the
        per-flagged-row path at 50k rows/sec — the tracing overhead
        budget lives or dies here; Span objects and cid strings only
        materialize when somebody reads the ring."""
        if not pairs:
            return
        t = self.tracer
        t._count(len(pairs))
        self.keep = True
        self.spans.append(_RowEvents(self.cid, stage, tuple(pairs),
                                     t._wall(), ok, detail))

    def shed(self, msg, reason: str) -> str:
        """Row diverted by admission control; returns the row cid so the
        DLQ record can carry it."""
        cid = self.row_cid(msg)
        self.event(EVENT_SHED, cid, ok=False, detail=reason)
        return cid

    def dlq(self, msg, reason: str) -> str:
        """Row dead-lettered (malformed / poison); returns the row cid."""
        cid = self.row_cid(msg)
        self.event(EVENT_DLQ, cid, ok=False, detail=reason)
        return cid


class _SpanCtx:
    __slots__ = ("bt", "stage", "detail", "_t0", "_w0")

    def __init__(self, bt: BatchTrace, stage: str, detail: Optional[str]):
        self.bt = bt
        self.stage = stage
        self.detail = detail

    def __enter__(self):
        self._w0 = self.bt.tracer._wall()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        bt, t = self.bt, self.bt.tracer
        t._count_begin_end()
        bt.spans.append(Span(bt.cid, self.stage, self._w0, dt * 1e3,
                             exc_type is None, self.detail))
        t._observe_stage(self.stage, dt)
        return False


class RowTracer:
    """Per-worker tracing context (see module docstring). One per engine/
    fleet worker; shared across supervised incarnations so chains survive
    restarts exactly like the DLQ poison tracker does."""

    def __init__(self, *, worker: str = "w0", capacity: int = 4096,
                 sample: float = 1.0, seed: Optional[int] = None,
                 record_rows: bool = False,
                 wall: Callable[[], float] = time.time):
        if not 0.0 <= sample <= 1.0:
            raise ValueError(f"sample must be in [0, 1], got {sample}")
        if record_rows and sample < 1.0:
            # A recording exists to replay the run's EXACT row set;
            # head-sampling away clean batches would silently hole it.
            raise ValueError(
                f"record_rows needs sample=1.0 (got {sample}): a sampled "
                "recording cannot reproduce the run's row set")
        self.worker = worker
        self.sample = sample
        # Record mode (scenarios/record.py): the engine adds one compact
        # EVENT_ROW block per delivered batch carrying EVERY row's source
        # coordinates — the census a recorded trace needs for exact
        # replay. Off (the default), clean rows stay un-enumerated and
        # only the interesting minority gets row events.
        self.record_rows = bool(record_rows)
        self.ring = SpanRing(capacity)
        self._rng = random.Random(seed)
        self._wall = wall
        self._lock = threading.Lock()
        self._seq = 0
        # Exact span accounting: every begin is matched by an end (spans
        # are only ever created fully-formed, so the pair increments land
        # together — the invariant the chaos tests pin is that no path
        # creates a begun-but-never-ended span, i.e. open == 0 at rest).
        self.spans_begun = 0
        self.spans_ended = 0
        self.batches_traced = 0     # batch traces minted
        self.batches_closed = 0     # committed or aborted
        self.kept = 0               # batches whose spans entered the ring
        self.sampled_out = 0        # clean batches discarded by sampling
        self._stages: Dict[str, LatencySketch] = {}

    # -- internal hooks (BatchTrace) ------------------------------------

    def _count_begin_end(self) -> None:
        self._count(1)

    def _count(self, n: int) -> None:
        with self._lock:
            self.spans_begun += n
            self.spans_ended += n

    def _observe_stage(self, stage: str, duration_sec: float) -> None:
        sk = self._stages.get(stage)
        if sk is None:
            with self._lock:
                sk = self._stages.setdefault(stage, LatencySketch())
        sk.add(duration_sec)

    # -- engine surface -------------------------------------------------

    def batch_begin(self, n_rows: int, *,
                    poll_wait_sec: float = 0.0) -> BatchTrace:
        """Mint a batch correlation id + its trace context at poll time.
        The head-sampling draw happens HERE; interesting outcomes flip the
        batch to kept later (forced keeps are outcome-driven, the draw
        only throttles clean traffic)."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            self.batches_traced += 1
            sampled = self._rng.random() < self.sample
        bt = BatchTrace(self, f"{self.worker}-{seq:x}", sampled)
        bt.add(STAGE_POLL, poll_wait_sec, detail=f"rows={n_rows}")
        return bt

    def commit(self, bt: Optional[BatchTrace]) -> None:
        """Terminal for a delivered batch: push its spans into the ring
        when kept (sampled or forced), count it out otherwise. Idempotent
        — abort-then-commit races on engine unwind paths count once."""
        if bt is None or bt.committed:
            return
        bt.committed = True
        with self._lock:
            self.batches_closed += 1
            if bt.keep or bt.sampled:
                self.kept += 1
            else:
                self.sampled_out += 1
                return
        self.ring.extend(bt.spans)

    def abort(self, bt: Optional[BatchTrace], reason: str = "abort") -> None:
        """Terminal for an abandoned batch (crash / flush failure / replay
        discard): always kept — an aborted batch is interesting by
        definition."""
        if bt is None or bt.committed:
            return
        bt.event(EVENT_ABORT, bt.cid, ok=False, detail=reason)
        self.commit(bt)

    # -- direct records (post-terminal legs: annotation lane) ------------

    def record_span(self, cid: str, stage: str, duration_sec: float, *,
                    ok: bool = True, detail: Optional[str] = None) -> None:
        """Record a span straight into the ring — for legs that run AFTER
        a batch's terminal commit (the annotation lane's explain calls).
        Only call for rows/legs that are always-kept (flagged rows are);
        head sampling does not apply here."""
        self._count_begin_end()
        self.ring.extend([Span(cid, stage, self._wall(),
                               duration_sec * 1e3, ok, detail)])
        self._observe_stage(stage, duration_sec)

    def record_event(self, cid: str, stage: str, *, ok: bool = True,
                     detail: Optional[str] = None) -> None:
        """Instantaneous direct marker (see :meth:`record_span`)."""
        self._count_begin_end()
        self.ring.extend([Span(cid, stage, self._wall(), 0.0, ok, detail)])

    # -- retrieval + export (any thread) --------------------------------

    def chain(self, cid: str) -> List[Span]:
        """Every recorded span on a correlation id's chain, oldest first.
        A ROW cid (``<batch>:<part>:<off>``) pulls its batch's stage spans
        plus the row's own events; a batch cid pulls the batch spans and
        all its rows' events."""
        batch_cid = cid.split(":", 1)[0]
        out = []
        for s in self.ring.snapshot():
            if s.cid == cid or s.cid == batch_cid or (
                    cid == batch_cid and s.cid.split(":", 1)[0] == batch_cid):
                out.append(s)
        return out

    def stage_quantiles(self) -> Dict[str, dict]:
        """Per-stage latency snapshot (ms quantiles + counts) over ALL
        batches — sampling-independent; the bench ``stages`` block and
        the fleet aggregation read this."""
        with self._lock:
            stages = dict(self._stages)
        return {name: sk.snapshot() for name, sk in sorted(stages.items())}

    def stages_wire(self) -> Dict[str, dict]:
        """Per-stage sketches in wire form (lossless bucket counts) for
        the fleet bus — the coordinator merges these exactly."""
        with self._lock:
            stages = dict(self._stages)
        return {name: sk.to_wire() for name, sk in sorted(stages.items())}

    def snapshot(self) -> dict:
        """The ``trace`` block of ``health()`` (the JAX tracer's schema,
        held equal in tests/test_torch_obs.py)."""
        with self._lock:
            begun, ended = self.spans_begun, self.spans_ended
            traced, closed = self.batches_traced, self.batches_closed
            kept, sampled_out = self.kept, self.sampled_out
        return {
            "worker": self.worker,
            "sample": self.sample,
            "spans_begun": begun,
            "spans_ended": ended,
            "spans_open": begun - ended,
            "batches_traced": traced,
            "batches_closed": closed,
            "kept": kept,
            "sampled_out": sampled_out,
            "ring_depth": len(self.ring),
            "ring_capacity": self.ring.capacity,
            "ring_recorded": self.ring.recorded,
            "ring_dropped": self.ring.dropped,
            "stages": self.stage_quantiles(),
        }


def aggregate_stage_wires(wires: Sequence[Dict[str, dict]]
                          ) -> Dict[str, LatencySketch]:
    """Merge per-worker stage-sketch wires into one sketch per stage —
    LOSSLESS (bucket counts add), so fleet-level p50/p99 per stage equals
    a single-process run over the same samples (pinned in
    tests/test_torch_obs.py)."""
    merged: Dict[str, LatencySketch] = {}
    for wire in wires:
        if not isinstance(wire, dict):
            continue
        for stage, w in wire.items():
            sk = LatencySketch.from_wire(w)
            if sk is None:
                continue
            into = merged.get(stage)
            if into is None:
                merged[stage] = sk
            else:
                into.merge(sk)
    return merged


def fleet_stage_latency(wires: Sequence[Dict[str, dict]]) -> Dict[str, dict]:
    """The fleet view's ``stage_latency_ms`` block: merged per-stage
    quantile snapshots across every worker's published wire."""
    return {stage: sk.snapshot()
            for stage, sk in sorted(aggregate_stage_wires(wires).items())}
