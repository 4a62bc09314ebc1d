"""LabelFeeder: the scenario harness's delayed ground-truth oracle — twin
of ``fraud_detection_tpu/scenarios/labels.py``.

A drift game day (scenarios/gameday.py ``drift_shift``) needs the label
lane fed: every input row's ground truth, delivered as a FEEDBACK record
keyed by the row's real source coordinate (topic, partition, offset).
Coordinates are assigned by the broker at
produce time, so the oracle cannot ride the traffic generator — instead it
CONSUMES the input topic through its own consumer group (observing exactly
the coordinates the serving engine sees), reads each payload's ``truth``
field (emitted by specs with ``emit_truth=True``, scenarios/traffic.py),
and produces one ``stream/feedback.py`` label record per truth-carrying
row. ``delay_s`` models label latency in virtual seconds (chargebacks
arrive late): labels are held back until the scenario clock passes
``row poll time + delay_s`` — in warp mode that's immediate, exactly like
every other virtual-time component.

One daemon thread per run ("label-feeder"); counters under a small lock;
rows without a ``truth`` field are counted and skipped (the oracle never guesses)."""

from __future__ import annotations

import json
import threading
from typing import Optional

from fraud_detection_tpu_torch.stream.feedback import label_record


class LabelFeeder:
    """See module docstring. ``consumer`` reads the input topic (own
    group); ``producer`` writes ``feedback_topic``; ``clock`` is the
    scenario clock (pacing + virtual stamps)."""

    def __init__(self, consumer, producer, feedback_topic: str, *,
                 clock=None, delay_s: float = 0.0,
                 poll_timeout_s: float = 0.02):
        self._consumer = consumer
        self._producer = producer
        self.feedback_topic = feedback_topic
        self._clock = clock
        self.delay_s = delay_s
        self._poll_timeout = poll_timeout_s
        self._lock = threading.Lock()
        self._fed = 0
        self._skipped = 0
        self._malformed = 0
        # Drain-side virtual cursor (the VirtualCadence pattern,
        # obs/sentinel/engine.py): the scenario clock's cursor STOPS at
        # the timeline's end, so a label stamped ``end + delay_s`` would
        # never come due in warp mode — idle oracle ticks advance the
        # reading one small virtual step each instead, exactly like
        # sentinel evaluations during a warp drain.
        self._vcursor = 0.0
        self._idle_step = max(delay_s / 4.0, 0.01)
        self._stop = threading.Event()
        self.error: Optional[BaseException] = None  # write-once latch
        self._thread: Optional[threading.Thread] = None

    # -- cross-thread surface -------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {"fed": self._fed, "skipped": self._skipped,
                    "malformed": self._malformed}

    @property
    def fed(self) -> int:
        with self._lock:
            return self._fed

    def start(self) -> "LabelFeeder":
        t = threading.Thread(target=self._run, name="label-feeder",
                             daemon=True)
        with self._lock:
            self._thread = t
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> None:
        t = self._thread
        if t is not None:
            self._stop.set()
            t.join(timeout)

    # -- feeder thread --------------------------------------------------

    def _run(self) -> None:
        try:
            pending = []   # (due_virtual_s, topic, partition, offset, truth)
            while not self._stop.is_set():
                msgs = self._consumer.poll_batch(256, self._poll_timeout)
                now = self._clock.now() if self._clock is not None else 0.0
                for m in msgs:
                    truth = self._truth_of(m.value)
                    if truth is None:
                        continue
                    pending.append((now + self.delay_s, m.topic,
                                    m.partition, m.offset, truth))
                if msgs:
                    offsets: dict = {}
                    for m in msgs:
                        offsets[(m.topic, m.partition)] = max(
                            offsets.get((m.topic, m.partition), 0),
                            m.offset + 1)
                    self._consumer.commit_offsets(offsets)
                now = self._clock.now() if self._clock is not None else 0.0
                if msgs:
                    self._vcursor = max(self._vcursor, now)
                else:
                    # Idle tick: advance the drain-side virtual cursor so
                    # held labels come due after a warp feed (see ctor).
                    self._vcursor = max(now, self._vcursor + self._idle_step)
                now = max(now, self._vcursor)
                due = [p for p in pending if p[0] <= now]
                if due:
                    pending = [p for p in pending if p[0] > now]
                    for _, topic, partition, offset, truth in due:
                        self._producer.produce(
                            self.feedback_topic,
                            label_record(topic, partition, offset, truth))
                    flush = getattr(self._producer, "flush", None)
                    if flush is not None:
                        flush()
                    with self._lock:
                        self._fed += len(due)
                if not msgs and not due:
                    self._stop.wait(0.005)
        except BaseException as e:  # noqa: BLE001 — surfaced via .error
            self.error = e

    def _truth_of(self, value: bytes) -> Optional[int]:
        try:
            obj = json.loads(value)
        except ValueError:
            with self._lock:
                self._malformed += 1
            return None
        truth = obj.get("truth") if isinstance(obj, dict) else None
        if isinstance(truth, bool) or not isinstance(truth, int):
            with self._lock:
                self._skipped += 1
            return None
        return truth
