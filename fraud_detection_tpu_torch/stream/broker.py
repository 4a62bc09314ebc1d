"""In-process message broker — twin of ``InProcessBroker`` in
``fraud_detection_tpu/stream/broker.py``.

A partitioned, offset-tracked queue broker with Kafka semantics where they
matter to the engine: per-partition FIFO, consumer offsets advance only on
commit, and consumer-GROUP partition assignment — members of one group own
disjoint partition subsets (balanced-sticky assignor), rebalanced on
join/leave/eviction, with commits rejected for partitions the member no
longer owns (``CommitFailedError``). The fleet (``fleet/``) reads through
manual-assignment consumers instead (``assigned_consumer``, Kafka's
``assign()``): its coordinator owns the partition leases, and
``group_lag`` is its drain-complete signal.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Protocol, Sequence

from fraud_detection_tpu_torch.utils.racecheck import ExclusiveRegion


@dataclass(slots=True)
class Message:
    """One broker record (constructed POSITIONALLY on the hot path)."""

    topic: str
    value: bytes
    key: Optional[bytes] = None
    partition: int = 0
    offset: int = -1
    timestamp: float = 0.0
    # Broker-global produce sequence (timestamps are batch-shared, so they
    # cannot order a batch's messages across partitions; this can).
    seq: int = 0


class Consumer(Protocol):
    def poll(self, timeout: float = 1.0) -> Optional[Message]: ...
    def poll_batch(self, max_messages: int, timeout: float) -> List[Message]: ...
    def commit(self) -> None: ...

    def commit_offsets(self, offsets: Dict[tuple, int]) -> None:
        """Commit explicit next-offsets per (topic, partition): a pipelined
        engine records batch N while batch N+1 is already consumed."""
        ...

    def close(self) -> None: ...


class Producer(Protocol):
    def produce(self, topic: str, value: bytes, key: Optional[bytes] = None) -> None: ...

    def flush(self, timeout: float = 10.0) -> int:
        """Block until queued messages are delivered; returns how many are
        STILL undelivered (0 = fully drained)."""
        ...


class CommitFailedError(RuntimeError):
    """Commit advanced a partition this member does not currently own — the
    group rebalanced underneath it (Kafka's CommitFailedError)."""


class TransientBrokerError(RuntimeError):
    """Transport-level broker failure that is expected to heal (a broker
    down while the client retries, or an injected chaos fault). Raised from
    the poll path; it kills the engine incarnation and ``run_supervised``
    restarts from the last committed offsets."""


class _GroupState:
    """Broker-side consumer-group bookkeeping (the group-coordinator role)."""

    __slots__ = ("generation", "members", "assignment", "acquired", "join_seq",
                 "next_evict_scan")

    def __init__(self):
        self.generation = 0
        self.members: Dict[str, dict] = {}      # member_id -> {topics, seen, joined}
        self.assignment: Dict[str, set] = {}    # member_id -> {(topic, partition)}
        self.next_evict_scan = 0.0              # liveness scans are rate-limited
        # (topic, partition) -> generation its CURRENT owner acquired it at:
        # a consumer's local read-ahead position is only valid while it
        # owned the partition continuously.
        self.acquired: Dict[tuple, int] = {}
        self.join_seq = itertools.count()


class InProcessBroker:
    """Thread-safe partitioned topic store with Kafka-ish offset semantics."""

    def __init__(self, num_partitions: int = 3, session_timeout: float = 300.0):
        self.num_partitions = num_partitions
        # Members that neither polled nor committed within this window are
        # evicted at the next group operation (Kafka's max.poll.interval.ms).
        self.session_timeout = session_timeout
        self._topics: Dict[str, List[List[Message]]] = {}
        # Group-durable committed offsets: (group, topic, partition) -> next
        # offset, on the BROKER like Kafka's __consumer_offsets.
        self._group_offsets: Dict[tuple, int] = {}
        self._groups: Dict[str, _GroupState] = {}
        self._member_ids = itertools.count()
        self._lock = threading.Lock()
        self._rr = itertools.count()
        self._seq = itertools.count()

    def _partitions(self, topic: str) -> List[List[Message]]:
        with self._lock:
            if topic not in self._topics:
                self._topics[topic] = [[] for _ in range(self.num_partitions)]
            return self._topics[topic]

    def append(self, topic: str, value: bytes, key: Optional[bytes] = None) -> None:
        self.append_batch(topic, [(value, key)])

    def append_batch(self, topic: str, items: Iterable[tuple]) -> None:
        """Append (value, key) pairs under ONE lock acquisition. Keyed
        messages hash to a partition; unkeyed ones round-robin."""
        parts = self._partitions(topic)
        n_parts = len(parts)
        now = time.time()
        with self._lock:
            for value, key in items:
                idx = (hash(key) if key is not None else next(self._rr)) % n_parts
                part = parts[idx]
                part.append(Message(topic, value, key, idx, len(part), now,
                                    next(self._seq)))

    def topic_size(self, topic: str) -> int:
        parts = self._partitions(topic)
        with self._lock:
            return sum(len(p) for p in parts)

    def messages(self, topic: str) -> List[Message]:
        """Every message of ``topic`` in produce order."""
        parts = self._partitions(topic)
        with self._lock:
            out = [m for p in parts for m in p]
        return sorted(out, key=lambda m: m.seq)

    def consumer(self, topics: Sequence[str], group_id: str = "default") -> "InProcessConsumer":
        return InProcessConsumer(self, list(topics), group_id)

    def assigned_consumer(self, partitions: Sequence[tuple],
                          group_id: str = "default", fence=None
                          ) -> "InProcessAssignedConsumer":
        """Manual-assignment consumer (Kafka's ``assign()`` mode): reads
        EXACTLY the given (topic, partition) pairs, never joins the group's
        assignor, commits into the same group-durable offsets. Partition
        exclusivity is the CALLER's contract (the fleet coordinator's
        leases); ``fence`` lets that caller fail stale commits."""
        return InProcessAssignedConsumer(self, list(partitions), group_id,
                                         fence=fence)

    def group_lag(self, group_id: str,
                  topics: Optional[Sequence[str]] = None) -> int:
        """Rows appended but not yet COMMITTED by ``group_id`` across
        ``topics`` (all topics when None). Counted from the group-durable
        offsets, so it still sees a dead member's polled-but-uncommitted
        rows: the fleet's drain-complete signal."""
        with self._lock:
            names = list(topics) if topics is not None else list(self._topics)
            total = 0
            for t in names:
                parts = self._topics.get(t)
                if parts is None:
                    continue
                for p, part in enumerate(parts):
                    total += max(0, len(part)
                                 - self._group_offsets.get((group_id, t, p), 0))
            return total

    def producer(self) -> "InProcessProducer":
        return InProcessProducer(self)

    def committed(self, group_id: str) -> Dict[tuple, int]:
        """The group's durable next-offsets, {(topic, partition): offset}."""
        with self._lock:
            return {(t, p): off for (g, t, p), off in self._group_offsets.items()
                    if g == group_id}

    # ------------------------------------------------------------------
    # group coordination (Kafka's group-coordinator role, in-process)
    # ------------------------------------------------------------------

    def _evict_expired_locked(self, group: _GroupState, now: float) -> bool:
        stale = [m for m, info in group.members.items()
                 if now - info["seen"] > self.session_timeout]
        for m in stale:
            del group.members[m]
        return bool(stale)

    def _rebalance_locked(self, group: _GroupState) -> None:
        """Balanced-sticky assignor: every member keeps the partitions it
        already owns up to its fair share; only orphaned partitions and the
        excess above a shrunken share move. Bumps the generation; partitions
        that change hands get their acquisition generation restamped."""
        old_owner = {pair: m for m, pairs in group.assignment.items()
                     for pair in pairs}
        group.generation += 1
        members = sorted(group.members, key=lambda m: group.members[m]["joined"])
        group.assignment = {m: set() for m in members}
        topics = sorted({t for m in members for t in group.members[m]["topics"]})
        acquired: Dict[tuple, int] = {}
        for topic in topics:
            subs = [m for m in members if topic in group.members[m]["topics"]]
            pairs = [(topic, p) for p in range(self.num_partitions)]
            base, extra = divmod(len(pairs), len(subs))
            target = {m: base + (1 if i < extra else 0)
                      for i, m in enumerate(subs)}
            kept: Dict[str, list] = {m: [] for m in subs}
            pool = []
            for pair in pairs:           # partition order -> deterministic
                m = old_owner.get(pair)
                if m in target and len(kept[m]) < target[m]:
                    kept[m].append(pair)
                else:
                    pool.append(pair)
            for m in subs:               # join order -> deterministic
                take = target[m] - len(kept[m])
                if take > 0:
                    kept[m].extend(pool[:take])
                    del pool[:take]
            for m in subs:
                for pair in kept[m]:
                    group.assignment[m].add(pair)
                    acquired[pair] = (group.acquired.get(pair, group.generation)
                                      if old_owner.get(pair) == m
                                      else group.generation)
        group.acquired = acquired

    def _join_group(self, group_id: str, topics: Sequence[str]) -> str:
        with self._lock:
            group = self._groups.setdefault(group_id, _GroupState())
            now = time.monotonic()
            self._evict_expired_locked(group, now)
            member_id = f"{group_id}-{next(self._member_ids)}"
            group.members[member_id] = {"topics": tuple(topics), "seen": now,
                                        "joined": next(group.join_seq)}
            self._rebalance_locked(group)
            return member_id

    def _leave_group(self, group_id: str, member_id: str) -> None:
        with self._lock:
            group = self._groups.get(group_id)
            if group is None or member_id not in group.members:
                return
            del group.members[member_id]
            self._rebalance_locked(group)

    def _sync_member_locked(self, group_id: str, member_id: str,
                            topics: Sequence[str],
                            known_generation: int = -1) -> tuple:
        """Heartbeat + assignment fetch (caller holds self._lock). Returns
        (generation, owned set, {pair: acquisition generation}) — or
        (known_generation, None, None) on the fast path (member known,
        generation unchanged, no liveness scan due). An evicted member
        transparently rejoins."""
        group = self._groups.setdefault(group_id, _GroupState())
        now = time.monotonic()
        member = group.members.get(member_id)
        if member is not None:
            member["seen"] = now
            if group.generation == known_generation and now < group.next_evict_scan:
                return known_generation, None, None
        changed = False
        if now >= group.next_evict_scan:
            changed = self._evict_expired_locked(group, now)
            group.next_evict_scan = now + self.session_timeout / 4
        if member_id not in group.members:
            group.members[member_id] = {"topics": tuple(topics), "seen": now,
                                        "joined": next(group.join_seq)}
            changed = True
        if changed:
            self._rebalance_locked(group)
        if group.generation == known_generation:
            return known_generation, None, None
        owned = group.assignment[member_id]
        return (group.generation, owned,
                {pair: group.acquired[pair] for pair in owned})

    def group_assignment(self, group_id: str) -> Dict[str, List[tuple]]:
        """Current member -> sorted [(topic, partition)] map."""
        with self._lock:
            group = self._groups.get(group_id)
            if group is None:
                return {}
            return {m: sorted(pairs) for m, pairs in group.assignment.items()}


class InProcessConsumer:
    """Earliest-offset group consumer with manual commit. Not thread-safe
    (like a Kafka consumer): the region turns concurrent use into a
    ``RaceError`` instead of lost offsets."""

    def __init__(self, broker: InProcessBroker, topics: List[str], group_id: str):
        self.broker = broker
        self.topics = topics
        self.group_id = group_id
        self.member_id = broker._join_group(group_id, topics)
        self._generation = -1   # stale until the first poll refreshes it
        self._owned: set = set()
        self._acquired: Dict[tuple, int] = {}
        self._position: Dict[tuple, int] = {}
        self._committed: Dict[tuple, int] = {}
        self._closed = False
        self._region = ExclusiveRegion("InProcessConsumer")

    def _refresh_locked(self) -> None:
        """Heartbeat + adopt the current assignment (caller holds the broker
        lock). Partitions owned CONTINUOUSLY keep their local read-ahead
        position; everything else resumes from the group's committed
        offsets. Raises on a closed consumer."""
        if self._closed:
            raise RuntimeError(
                f"consumer {self.member_id!r} (group {self.group_id!r}) is closed")
        gen, owned, acquired = self.broker._sync_member_locked(
            self.group_id, self.member_id, self.topics, self._generation)
        if owned is None:
            return
        offsets = self.broker._group_offsets
        self._position = {
            key: (self._position.get(key, offsets.get((self.group_id, *key), 0))
                  if self._acquired.get(key) == acquired[key]
                  else offsets.get((self.group_id, *key), 0))
            for key in owned}
        self._acquired = dict(acquired)
        self._committed = {
            key: max(self._committed.get(key, 0),
                     offsets.get((self.group_id, *key), 0))
            for key in owned}
        self._owned = set(owned)
        self._generation = gen

    def assignment(self) -> List[tuple]:
        """This member's current (topic, partition) ownership (refreshed)."""
        with self._region, self.broker._lock:
            self._refresh_locked()
            return sorted(self._owned)

    def _next_from(self, topic: str, part_idx: int) -> Optional[Message]:
        parts = self.broker._partitions(topic)
        key = (topic, part_idx)
        pos = self._position.get(key, 0)
        with self.broker._lock:
            part = parts[part_idx]
            if pos < len(part):
                self._position[key] = pos + 1
                return part[pos]
        return None

    def poll(self, timeout: float = 1.0) -> Optional[Message]:
        with self._region:
            deadline = time.time() + timeout
            while True:
                with self.broker._lock:
                    self._refresh_locked()
                for topic, p in sorted(self._owned):
                    msg = self._next_from(topic, p)
                    if msg is not None:
                        return msg
                if time.time() >= deadline:
                    return None
                time.sleep(0.001)

    def poll_batch(self, max_messages: int, timeout: float) -> List[Message]:
        """Drain up to max_messages; waits at most ``timeout`` for the first,
        then slices the rest per owned partition under one lock."""
        out: List[Message] = []
        first = self.poll(timeout)
        if first is None:
            return out
        out.append(first)
        with self._region, self.broker._lock:
            for topic, p_idx in sorted(self._owned):
                if len(out) >= max_messages:
                    return out
                all_parts = self.broker._topics.get(topic)
                if all_parts is None:
                    continue
                part = all_parts[p_idx]
                key = (topic, p_idx)
                pos = self._position.get(key, 0)
                take = min(len(part) - pos, max_messages - len(out))
                if take > 0:
                    out.extend(part[pos : pos + take])
                    self._position[key] = pos + take
        return out

    def commit(self) -> None:
        """Commit the consumer's current position. A partition whose
        uncommitted read-ahead was rebalanced away (or bounced away and
        back, restamped at a new generation) raises ``CommitFailedError``,
        as Kafka does for a stale generation."""
        with self._region:
            before_pos = dict(self._position)
            before_committed = dict(self._committed)
            before_acq = dict(self._acquired)
            with self.broker._lock:
                self._refresh_locked()
            lost = sorted(key for key, pos in before_pos.items()
                          if (key not in self._owned
                              or self._acquired.get(key) != before_acq.get(key))
                          and pos > before_committed.get(key, 0))
            if lost:
                raise CommitFailedError(
                    f"group {self.group_id!r} rebalanced: member "
                    f"{self.member_id!r} no longer owns {lost}; "
                    "offsets stay uncommitted — the new owner reprocesses")
            self._committed.update(self._position)
            self._write_through()

    def _write_through(self) -> None:
        with self.broker._lock:
            for (t, p), off in self._committed.items():
                key = (self.group_id, t, p)
                if off > self.broker._group_offsets.get(key, 0):
                    self.broker._group_offsets[key] = off

    def commit_offsets(self, offsets: Dict[tuple, int]) -> None:
        """Commit explicit next-offsets per (topic, partition), so a
        pipelined engine records batch N while batch N+1 is in flight."""
        with self._region:
            advances = {key: off for key, off in offsets.items()
                        if off > self._committed.get(key, 0)}
            with self.broker._lock:
                self._refresh_locked()
                lost = [key for key in advances if key not in self._owned]
                if lost:
                    raise CommitFailedError(
                        f"group {self.group_id!r} rebalanced: member "
                        f"{self.member_id!r} no longer owns {sorted(lost)}; "
                        "offsets stay uncommitted — the new owner reprocesses")
            self._committed.update(advances)
            self._write_through()

    def committed_offsets(self) -> Dict[tuple, int]:
        return dict(self._committed)

    def backlog(self) -> int:
        """Rows appended to this member's owned partitions but not yet
        polled — the queue depth the scheduler's admission watermark reads
        (sched/admission.py). Engine-thread only, like poll and commit."""
        with self._region, self.broker._lock:
            self._refresh_locked()
            total = 0
            for topic, p in self._owned:
                parts = self.broker._topics.get(topic)
                if parts is not None:
                    total += max(0, len(parts[p])
                                 - self._position.get((topic, p), 0))
            return total

    def seek_to_committed(self) -> None:
        """Simulate a restart: resume every owned partition from the GROUP's
        durable offsets (the committed truth — each commit writes through)."""
        with self._region, self.broker._lock:
            self._refresh_locked()
            offsets = self.broker._group_offsets
            self._position = {key: offsets.get((self.group_id, *key), 0)
                              for key in self._owned}

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.broker._leave_group(self.group_id, self.member_id)


class InProcessAssignedConsumer:
    """Manual-assignment consumer: an explicit (topic, partition) set, no
    group membership, commits write through to the group-durable offsets.

    Construction resumes every pair from the group's committed offsets
    (earliest where the group never committed): whatever a dead owner failed
    to commit is exactly what the next owner re-reads. An optional ``fence``
    callable, given the pairs a commit would advance, returns those the
    caller no longer owns; any makes the commit raise ``CommitFailedError``
    instead of advancing a partition someone else now owns."""

    def __init__(self, broker: InProcessBroker, partitions: Sequence[tuple],
                 group_id: str, fence=None):
        self.broker = broker
        self.group_id = group_id
        self.partitions = [tuple(p) for p in partitions]
        self._fence = fence
        self._closed = False
        with broker._lock:
            offsets = broker._group_offsets
            self._position: Dict[tuple, int] = {
                pair: offsets.get((group_id, *pair), 0)
                for pair in self.partitions}
        self._committed: Dict[tuple, int] = dict(self._position)
        # Same one-thread contract as InProcessConsumer.
        self._region = ExclusiveRegion("InProcessAssignedConsumer")

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(
                f"assigned consumer (group {self.group_id!r}, "
                f"{self.partitions}) is closed")

    def assignment(self) -> List[tuple]:
        return sorted(self.partitions)

    def poll(self, timeout: float = 1.0) -> Optional[Message]:
        with self._region:
            self._check_open()
            deadline = time.time() + timeout
            while True:
                for topic, p in sorted(self.partitions):
                    parts = self.broker._partitions(topic)
                    key = (topic, p)
                    pos = self._position.get(key, 0)
                    with self.broker._lock:
                        part = parts[p]
                        if pos < len(part):
                            self._position[key] = pos + 1
                            return part[pos]
                if time.time() >= deadline:
                    return None
                time.sleep(0.001)

    def poll_batch(self, max_messages: int, timeout: float) -> List[Message]:
        out: List[Message] = []
        first = self.poll(timeout)
        if first is None:
            return out
        out.append(first)
        with self._region, self.broker._lock:
            for topic, p in sorted(self.partitions):
                if len(out) >= max_messages:
                    return out
                all_parts = self.broker._topics.get(topic)
                if all_parts is None:
                    continue
                part = all_parts[p]
                key = (topic, p)
                pos = self._position.get(key, 0)
                take = min(len(part) - pos, max_messages - len(out))
                if take > 0:
                    out.extend(part[pos : pos + take])
                    self._position[key] = pos + take
        return out

    def commit(self) -> None:
        with self._region:
            self._check_open()
            self._commit_locked(dict(self._position))

    def commit_offsets(self, offsets: Dict[tuple, int]) -> None:
        with self._region:
            self._check_open()
            self._commit_locked({key: off for key, off in offsets.items()
                                 if off > self._committed.get(key, 0)})

    def _commit_locked(self, advances: Dict[tuple, int]) -> None:
        fence = self._fence
        if fence is not None and advances:
            lost = fence(sorted(advances))
            if lost:
                raise CommitFailedError(
                    f"lease for {sorted(lost)} was revoked from this worker "
                    f"(group {self.group_id!r}); offsets stay uncommitted — "
                    "the partitions' new owner reprocesses")
        self._committed.update(advances)
        with self.broker._lock:
            for (t, p), off in advances.items():
                key = (self.group_id, t, p)
                if off > self.broker._group_offsets.get(key, 0):
                    self.broker._group_offsets[key] = off

    def committed_offsets(self) -> Dict[tuple, int]:
        return dict(self._committed)

    def backlog(self) -> int:
        """Rows appended to the assigned partitions but not yet polled (the
        scheduler's local queue depth; the fleet coordinator sums these
        into the global watermark)."""
        with self._region, self.broker._lock:
            total = 0
            for topic, p in self.partitions:
                parts = self.broker._topics.get(topic)
                if parts is not None:
                    total += max(0, len(parts[p])
                                 - self._position.get((topic, p), 0))
            return total

    def close(self) -> None:
        self._closed = True   # no group to leave: assignment is external


class InProcessProducer:
    def __init__(self, broker: InProcessBroker):
        self.broker = broker

    def produce(self, topic: str, value: bytes, key: Optional[bytes] = None) -> None:
        self.broker.append(topic, value, key)

    def produce_batch(self, topic: str, items: Iterable[tuple]) -> None:
        """Produce (value, key) pairs in one call (single lock acquisition)."""
        self.broker.append_batch(topic, items)

    def flush(self, timeout: float = 10.0) -> int:
        return 0  # in-process appends are synchronous; nothing can be pending
