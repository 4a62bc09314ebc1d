"""A stand-in ``confluent_kafka`` for driving ``stream/kafka.py`` where the
wheel and a broker are absent.

Two layers:

* the reference test's recording fakes (``FakeConsumer``, ``FakeProducer``,
  ``FakeKafkaMessage``, ... as in ``tests/test_kafka_client.py``), which
  check what the adapter passes to the client;
* ``FakeCluster``: an in-memory broker with partitioned topics, per-group
  committed offsets, consumer groups (members split the partitions, a
  commit for a partition the member does not own fails as a rebalance),
  manual assignment and log compaction, behind the same client surface
  (``Consumer``, ``Producer``, ``TopicPartition``, ``KafkaError``,
  ``KafkaException``), so the serve CLI's ``--kafka`` path runs end to end.

``module(cluster)`` returns a ``confluent_kafka`` module object bound to
``cluster`` (or to the recording fakes when ``cluster`` is None); put it
in ``sys.modules`` and reload ``stream/kafka.py`` around it. Nothing here
imports the JAX package or the port.
"""

from __future__ import annotations

import itertools
import threading
import time
import types
import zlib
from typing import Dict, List, Optional, Tuple

OFFSET_BEGINNING = -2
OFFSET_INVALID = -1001


class FakeKafkaMessage:
    def __init__(self, topic="t", value=b"v", key=b"k", partition=0, offset=0,
                 error=None, timestamp=None):
        self._fields = dict(topic=topic, value=value, key=key,
                            partition=partition, offset=offset, error=error)
        self._ts = timestamp

    def topic(self): return self._fields["topic"]
    def value(self): return self._fields["value"]
    def key(self): return self._fields["key"]
    def partition(self): return self._fields["partition"]
    def offset(self): return self._fields["offset"]
    def error(self): return self._fields["error"]

    def timestamp(self):
        if self._ts is None:
            return 0, -1          # TIMESTAMP_NOT_AVAILABLE
        return 1, int(self._ts * 1e3)


class FakeTopicPartition:
    def __init__(self, topic, partition, offset=None):
        self.topic, self.partition, self.offset = topic, partition, offset

    def __repr__(self):
        return f"TopicPartition({self.topic!r}, {self.partition}, {self.offset})"


class FakeKafkaError:
    ILLEGAL_GENERATION = 22
    UNKNOWN_MEMBER_ID = 25
    REBALANCE_IN_PROGRESS = 27
    _STATE = -172
    # transport-class codes (librdkafka rdkafka.h values)
    _TRANSPORT = -195
    _ALL_BROKERS_DOWN = -187
    _TIMED_OUT = -185
    _RESOLVE = -193
    _PARTITION_EOF = -191
    _FATAL = -150

    def __init__(self, code):
        self._code = code

    def code(self):
        return self._code

    def __repr__(self):
        return f"KafkaError({self._code})"


class FakeKafkaException(Exception):
    pass


# ---------------------------------------------------------------------------
# recording fakes (tests/test_kafka_client.py's)
# ---------------------------------------------------------------------------

class FakeConsumer:
    def __init__(self, config):
        self.config = config
        self.subscribed = None
        self.queue = []
        self.commits = []
        self.closed = False

    def subscribe(self, topics): self.subscribed = topics
    def poll(self, timeout): return self.queue.pop(0) if self.queue else None

    def consume(self, num_messages, timeout):
        out, self.queue = self.queue[:num_messages], self.queue[num_messages:]
        return out

    def commit(self, offsets=None, asynchronous=True):
        self.commits.append((offsets, asynchronous))

    def close(self): self.closed = True

    # manual-assignment surface (KafkaAssignedConsumer)
    committed_offsets: dict = {}

    def committed(self, tps, timeout=None):
        for tp in tps:
            tp.offset = self.committed_offsets.get(
                (tp.topic, tp.partition), OFFSET_INVALID)
        return tps

    def assign(self, tps):
        self.assigned = tps


class FakeProducer:
    def __init__(self, config):
        self.config = config
        self.produced = []
        self.polls = 0
        self.buffer_errors_left = 0  # raise BufferError this many times
        self.flush_remaining = 0
        self.pending_callbacks = []

    def produce(self, topic, value=None, key=None, on_delivery=None):
        if self.buffer_errors_left > 0:
            self.buffer_errors_left -= 1
            raise BufferError("queue full")
        self.produced.append((topic, value, key))
        if on_delivery is not None:
            self.pending_callbacks.append(on_delivery)

    def poll(self, timeout):
        self.polls += 1

    def flush(self, timeout):
        for cb in self.pending_callbacks:
            cb(None, None)
        self.pending_callbacks = []
        return self.flush_remaining


class FakeBacklogClient:
    """Just enough consumer surface for ``backlog()``: assignment,
    watermarks and position, counting the watermark queries."""

    def __init__(self, partitions):
        # partitions: {tp_key: (lo, hi, position_offset)}
        self.partitions = dict(partitions)
        self.watermark_calls = 0

    def assignment(self):
        return list(self.partitions)

    def get_watermark_offsets(self, tp, timeout=None, cached=False):
        self.watermark_calls += 1
        lo, hi, _ = self.partitions[tp]
        return lo, hi

    def position(self, tps):
        (tp,) = tps
        return [FakeTopicPartition("raw", tp, self.partitions[tp][2])]


# ---------------------------------------------------------------------------
# the in-memory cluster
# ---------------------------------------------------------------------------

class FakeCluster:
    """Partitioned topics with Kafka's offset rules: records keep their
    offsets for life (compaction removes records, never renumbers), a
    group's committed offset is the NEXT offset to read, and a key goes to
    partition ``crc32(key) % partitions`` (keyless records round-robin)."""

    def __init__(self, num_partitions: int = 3):
        self.num_partitions = num_partitions
        self._lock = threading.Lock()
        # topic -> [partition -> [(offset, FakeKafkaMessage)]]
        self._logs: Dict[str, List[List[Tuple[int, FakeKafkaMessage]]]] = {}
        self._next: Dict[Tuple[str, int], int] = {}
        self.committed: Dict[Tuple[str, str, int], int] = {}
        self.commit_log: List[Tuple[str, str, int, int]] = []
        self._groups: Dict[str, List["ClusterConsumer"]] = {}
        self._rr = itertools.count()
        self.produced = 0

    # -- topics -------------------------------------------------------------
    def _topic(self, topic: str):
        if topic not in self._logs:
            self._logs[topic] = [[] for _ in range(self.num_partitions)]
        return self._logs[topic]

    def append(self, topic: str, value: bytes, key: Optional[bytes]) -> None:
        with self._lock:
            parts = self._topic(topic)
            p = (zlib.crc32(key) if key is not None else next(self._rr)) \
                % len(parts)
            off = self._next.get((topic, p), 0)
            self._next[(topic, p)] = off + 1
            parts[p].append((off, FakeKafkaMessage(
                topic, value, key, p, off, timestamp=time.time())))
            self.produced += 1

    def records(self, topic: str) -> List[FakeKafkaMessage]:
        """Every retained record of ``topic``, partition by partition."""
        with self._lock:
            return [m for part in self._topic(topic) for _, m in part]

    def high_watermarks(self, topic: str) -> Dict[int, int]:
        with self._lock:
            self._topic(topic)
            return {p: self._next.get((topic, p), 0)
                    for p in range(self.num_partitions)}

    def compact(self, topic: str) -> int:
        """Log compaction: keep the newest record of each key. Returns the
        records removed."""
        removed = 0
        with self._lock:
            for part in self._topic(topic):
                last = {}
                for i, (_, m) in enumerate(part):
                    last[m.key()] = i
                keep = [rec for i, rec in enumerate(part)
                        if last[rec[1].key()] == i]
                removed += len(part) - len(keep)
                part[:] = keep
        return removed

    def _read(self, topic: str, p: int, position: int, n: int):
        part = self._topic(topic)[p]
        out = [m for off, m in part if off >= position][:n]
        return out

    def _low(self, topic: str, p: int) -> int:
        part = self._topic(topic)[p]
        return part[0][0] if part else self._next.get((topic, p), 0)

    # -- groups -------------------------------------------------------------
    def _rebalance_locked(self, group: str) -> None:
        members = self._groups.get(group, [])
        for i, member in enumerate(members):
            owned = set()
            for topic in member.topics:
                self._topic(topic)
                for p in range(self.num_partitions):
                    if p % len(members) == i:
                        owned.add((topic, p))
            member._reassign(owned)

    def join(self, member: "ClusterConsumer") -> None:
        with self._lock:
            self._groups.setdefault(member.group, []).append(member)
            self._rebalance_locked(member.group)

    def leave(self, member: "ClusterConsumer") -> None:
        with self._lock:
            members = self._groups.get(member.group, [])
            if member in members:
                members.remove(member)
                self._rebalance_locked(member.group)

    def make_consumer_class(self):
        cluster = self

        class Consumer(ClusterConsumer):
            def __init__(self, config):
                super().__init__(cluster, config)

        return Consumer

    def make_producer_class(self):
        cluster = self

        class Producer(ClusterProducer):
            def __init__(self, config):
                super().__init__(cluster, config)

        return Producer


class ClusterConsumer:
    """A consumer on a ``FakeCluster``: ``subscribe`` joins the group
    (partitions split among members), ``assign`` reads given pairs."""

    def __init__(self, cluster: FakeCluster, config: dict):
        self.cluster = cluster
        self.config = dict(config)
        self.group = config.get("group.id", "")
        self.topics: List[str] = []
        self._owned: set = set()
        self._pos: Dict[Tuple[str, int], int] = {}
        self._manual = False
        self._rr = 0
        self.closed = False

    def _start(self, topic: str, p: int) -> int:
        c = self.cluster
        off = c.committed.get((self.group, topic, p))
        return c._low(topic, p) if off is None else off

    def _reassign(self, owned: set) -> None:
        """Under the cluster lock: a new assignment resumes every pair at
        the group's committed offset (what the old owner did not commit is
        read again)."""
        self._owned = set(owned)
        self._pos = {tp: self._start(*tp) for tp in sorted(owned)}

    def subscribe(self, topics) -> None:
        self.topics = list(topics)
        self.cluster.join(self)

    def assign(self, tps) -> None:
        with self.cluster._lock:
            self._manual = True
            self._owned = {(tp.topic, tp.partition) for tp in tps}
            self._pos = {}
            for tp in tps:
                self.cluster._topic(tp.topic)
                key = (tp.topic, tp.partition)
                if tp.offset is None or tp.offset < 0:
                    self._pos[key] = self.cluster._low(*key)
                else:
                    self._pos[key] = tp.offset

    def assignment(self):
        with self.cluster._lock:
            return [FakeTopicPartition(t, p) for t, p in sorted(self._owned)]

    def committed(self, tps, timeout=None):
        with self.cluster._lock:
            for tp in tps:
                tp.offset = self.cluster.committed.get(
                    (self.group, tp.topic, tp.partition), OFFSET_INVALID)
        return tps

    def get_watermark_offsets(self, tp, timeout=None, cached=False):
        with self.cluster._lock:
            return (self.cluster._low(tp.topic, tp.partition),
                    self.cluster._next.get((tp.topic, tp.partition), 0))

    def position(self, tps):
        with self.cluster._lock:
            return [FakeTopicPartition(tp.topic, tp.partition,
                                       self._pos.get((tp.topic, tp.partition),
                                                     OFFSET_INVALID))
                    for tp in tps]

    def consume(self, num_messages: int = 1, timeout: float = -1):
        out: List[FakeKafkaMessage] = []
        with self.cluster._lock:
            pairs = sorted(self._pos)
            for i in range(len(pairs)):
                if len(out) >= num_messages:
                    break
                key = pairs[(self._rr + i) % len(pairs)]
                got = self.cluster._read(*key, self._pos[key],
                                         num_messages - len(out))
                if got:
                    self._pos[key] = got[-1].offset() + 1
                    out.extend(got)
            if pairs:
                self._rr = (self._rr + 1) % len(pairs)
        if not out and timeout and timeout > 0:
            time.sleep(min(timeout, 0.005))
        return out

    def poll(self, timeout: float = -1):
        got = self.consume(1, timeout)
        return got[0] if got else None

    def commit(self, offsets=None, asynchronous=True):
        c = self.cluster
        with c._lock:
            if offsets is None:
                items = [(t, p, off) for (t, p), off in self._pos.items()]
            else:
                items = [(tp.topic, tp.partition, tp.offset) for tp in offsets]
            for t, p, _ in items:
                if (t, p) not in self._owned:
                    raise FakeKafkaException(
                        FakeKafkaError(FakeKafkaError.ILLEGAL_GENERATION))
            for t, p, off in items:
                c.committed[(self.group, t, p)] = off
                c.commit_log.append((self.group, t, p, off))

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            if not self._manual and self.topics:
                self.cluster.leave(self)


class ClusterProducer:
    """Appends to the cluster at once; delivery callbacks run at
    ``poll``/``flush``, which then has nothing left queued."""

    def __init__(self, cluster: FakeCluster, config: dict):
        self.cluster = cluster
        self.config = dict(config)
        self._pending = []
        self._lock = threading.Lock()

    def produce(self, topic, value=None, key=None, on_delivery=None):
        self.cluster.append(topic, value, key)
        if on_delivery is not None:
            with self._lock:
                self._pending.append(on_delivery)

    def _serve(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        for cb in pending:
            cb(None, None)

    def poll(self, timeout=0):
        self._serve()
        return 0

    def flush(self, timeout=None):
        self._serve()
        return 0


def module(cluster: Optional[FakeCluster] = None) -> types.ModuleType:
    """A ``confluent_kafka`` module object: bound to ``cluster``, or to the
    recording fakes when ``cluster`` is None."""
    fake = types.ModuleType("confluent_kafka")
    if cluster is None:
        fake.Consumer = FakeConsumer
        fake.Producer = FakeProducer
    else:
        fake.Consumer = cluster.make_consumer_class()
        fake.Producer = cluster.make_producer_class()
    fake.TopicPartition = FakeTopicPartition
    fake.KafkaError = FakeKafkaError
    fake.KafkaException = FakeKafkaException
    fake.OFFSET_BEGINNING = OFFSET_BEGINNING
    fake.OFFSET_INVALID = OFFSET_INVALID
    fake.STAND_IN = True
    return fake


def install(fake: types.ModuleType):
    """Put ``fake`` in ``sys.modules`` as ``confluent_kafka`` and reload the
    port's ``stream/kafka.py`` around it; returns a function that undoes
    both."""
    import importlib
    import sys

    import fraud_detection_tpu_torch.stream.kafka as kmod

    prev = sys.modules.get("confluent_kafka")
    sys.modules["confluent_kafka"] = fake
    importlib.reload(kmod)

    def restore():
        if prev is None:
            sys.modules.pop("confluent_kafka", None)
        else:
            sys.modules["confluent_kafka"] = prev
        importlib.reload(kmod)

    return restore
