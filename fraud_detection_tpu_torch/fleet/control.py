"""Control-lane transport + coordinator succession — twin of
``fraud_detection_tpu/fleet/control.py``.

The fleet's control plane — join/heartbeat/ack/leave and the
coordinator's assignment decisions — historically travelled as direct
method calls into one `FleetCoordinator` object: a perfect, unlosable
bus and a single fatal point. This module replaces both assumptions:

* :class:`ControlBus` turns every control interaction into a RECORD on a
  compacted control topic riding any existing ``Consumer``/``Producer``
  pair (stream/broker.py protocols). With no transport it degrades to an
  in-memory wire — and because the seam is the stream protocols, the
  chaos vocabulary (``ChaosConsumer``/``ChaosProducer``/
  ``FaultPlan``: loss, delay, duplication, reorder) applies to the
  CONTROL lane exactly as it does to the data lane. Records carry a
  per-sender sequence (dedup + loss accounting), the publishing
  coordinator's term (stale-term fencing), and a bus-global lamport
  stamp (replay order + snapshot watermarks).

* :class:`SuccessionCoordinator` makes the coordinator itself a LEASED
  ROLE: N candidates contend on it with monotonic terms
  (:class:`TermGate` is the election fence). The incumbent publishes a
  beacon + a state snapshot every tick; when beacons go stale past
  ``role_ttl`` (crash) or an abdication record lands (graceful), a
  standby candidate advances the term, replays the compacted topic
  (newest unfenced snapshot + every worker op past its watermark), and
  installs a reconstructed `FleetCoordinator`. Critically the snapshot
  carries the revoke-barrier holds (``_pending``) and the successor
  re-applies possibly-lost ops from a local outbox, so a mid-rebalance
  failover can neither double-grant a draining owner's partitions nor
  let a zombie commit.

During an interregnum the proxy answers workers from its lease cache
(no mutations: the dead leader's last word stands until a successor
owns the state) and commit fences answer from granted ∪ held pairs —
permissive for a draining old owner, while withheld targets stay
fenced, so both sides of an in-flight handoff keep their invariants.
Worker ops that arrive leaderless still land on the bus (and in the
outbox), which is the whole point: records outlive the brain.

Kill injection (:class:`~fraud_detection_tpu_torch.stream.faults.CoordinatorKillSpec`)
drives this live.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from fraud_detection_tpu_torch.fleet.coordinator import FleetCoordinator, Lease
from fraud_detection_tpu_torch.stream.faults import CoordinatorKilled

#: worker-originated ops replayed into a successor (all idempotent:
#: join/sync renew, ack releases what is already released, leave of a
#: gone member is a no-op — at-least-once redelivery is safe).
WORKER_OPS = ("join", "sync", "ack", "leave")

#: candidate-originated records (never replayed into assignment state).
CANDIDATE_KINDS = ("beacon", "claim", "abdicate")

CONTROL_KINDS = WORKER_OPS + CANDIDATE_KINDS + ("snapshot",)

_COMPACT_AT = 4096      # in-memory log bound before compaction
_OUTBOX_KEEP = 1024     # uncovered-op retry buffer bound
_JOURNAL_KEEP = 16384   # conformance journal bound (never compacted)


@dataclass(frozen=True)
class ControlRecord:
    """One control-lane record. ``seq`` is per-sender and 1-based (the
    dedup/loss key); ``lamport`` is the bus-global publish order (the
    replay key); ``term`` is the publisher's coordinator term at publish
    time (0 for worker ops — workers don't vote, they report)."""

    kind: str
    sender: str
    seq: int
    term: int
    lamport: int
    payload: dict

    def key(self) -> str:
        """Compaction key: last record per (kind, sender) is the one a
        compacted topic retains."""
        return f"{self.kind}:{self.sender}"

    def as_dict(self) -> dict:
        return {"kind": self.kind, "sender": self.sender, "seq": self.seq,
                "term": self.term, "lamport": self.lamport,
                "payload": self.payload}

    @staticmethod
    def from_dict(obj: dict) -> Optional["ControlRecord"]:
        try:
            return ControlRecord(
                str(obj["kind"]), str(obj["sender"]), int(obj["seq"]),
                int(obj["term"]), int(obj["lamport"]),
                dict(obj.get("payload") or {}))
        except (KeyError, TypeError, ValueError):
            return None


class ControlBus:
    """The control lane: publish/poll/replay over a Consumer/Producer
    pair, or an in-memory wire when none is given.

    Thread-safe. Delivery accounting rides per-sender sequences: a seq
    seen twice is a duplicate (dropped — every op is idempotent anyway,
    this just keeps the counters honest), a seq below the sender's high
    watermark is a reorder (accepted; replay sorts by lamport), and gaps
    below the watermark are the lossy lane's casualties (``lost``)."""

    def __init__(self, producer=None, consumer=None, *,
                 topic: str = "__fleet_control"):
        if (producer is None) != (consumer is None):
            raise ValueError("ControlBus needs both a producer and a "
                             "consumer, or neither (in-memory wire)")
        self.topic = topic
        self._producer = producer
        self._consumer = consumer
        self._lock = threading.Lock()
        self._lamport = 0
        self._next_seq: Dict[str, int] = {}     # sender -> last assigned
        self._wire: List[ControlRecord] = []    # in-memory transport
        self._log: List[ControlRecord] = []     # accepted, compacted
        # Conformance journal: every accepted record in delivery order,
        # NEVER compacted (compaction keeps what a successor needs; the
        # journal keeps what an auditor needs). Bounded;
        # overflow drops the oldest and counts, so a long-lived fleet
        # degrades to a suffix audit instead of unbounded memory.
        self._journal: List[ControlRecord] = []
        self.journal_dropped = 0
        self._seen: Dict[str, Set[int]] = {}    # sender -> delivered seqs
        self._high: Dict[str, int] = {}         # sender -> highest delivered
        self.published = 0
        self.delivered = 0
        self.duplicates_dropped = 0
        self.reordered = 0
        self.stale_snapshots_rejected = 0
        self.compactions = 0

    # ------------------------------------------------------------------
    # publish side (workers + the incumbent coordinator)
    # ------------------------------------------------------------------

    def publish(self, kind: str, sender: str, payload: Optional[dict] = None,
                *, term: int = 0) -> ControlRecord:
        """Stamp and send one record. Transport failures are swallowed —
        a lossy control lane is the operating assumption, not an error;
        the returned record still carries its stamps so callers can
        retry it later (the succession outbox does exactly that)."""
        with self._lock:
            self._lamport += 1
            seq = self._next_seq.get(sender, 0) + 1
            self._next_seq[sender] = seq
            rec = ControlRecord(kind, sender, seq, term, self._lamport,
                                dict(payload or {}))
            self.published += 1
            if self._producer is None:
                self._wire.append(rec)
                return rec
        # Transport outside the bus lock: the producer has its own locks
        # (and chaos wrappers), and the lock graph must stay acyclic.
        try:
            self._producer.produce(
                self.topic, json.dumps(rec.as_dict()).encode("utf-8"),
                key=rec.key().encode("utf-8"))
            self._producer.flush()
        except Exception:  # noqa: BLE001 — chaos loss: the record is gone
            pass
        return rec

    def retry(self, rec: ControlRecord) -> None:
        """Re-send an already-stamped record verbatim (at-least-once: the
        per-sender seq dedups the copy on delivery)."""
        with self._lock:
            if self._producer is None:
                self._wire.append(rec)
                return
        try:
            self._producer.produce(
                self.topic, json.dumps(rec.as_dict()).encode("utf-8"),
                key=rec.key().encode("utf-8"))
            self._producer.flush()
        except Exception:  # noqa: BLE001
            pass

    # ------------------------------------------------------------------
    # delivery side (candidates / the incumbent)
    # ------------------------------------------------------------------

    def poll(self) -> List[ControlRecord]:
        """Drain the transport into the local log; returns the NEWLY
        accepted records (duplicates dropped, reorders accepted)."""
        raws: List[ControlRecord] = []
        if self._consumer is not None:
            while True:
                msg = self._consumer.poll(0.0)
                if msg is None:
                    break
                rec = self._decode(msg)
                if rec is not None:
                    raws.append(rec)
        with self._lock:
            if self._consumer is None:
                raws = self._wire
                self._wire = []
            accepted: List[ControlRecord] = []
            for rec in raws:
                seen = self._seen.setdefault(rec.sender, set())
                if rec.seq in seen:
                    self.duplicates_dropped += 1
                    continue
                high = self._high.get(rec.sender, 0)
                if rec.seq < high:
                    self.reordered += 1
                seen.add(rec.seq)
                self._high[rec.sender] = max(high, rec.seq)
                self._lamport = max(self._lamport, rec.lamport)
                self.delivered += 1
                accepted.append(rec)
                self._log.append(rec)
                self._journal.append(rec)
            if len(self._journal) > _JOURNAL_KEEP:
                drop = len(self._journal) - _JOURNAL_KEEP
                del self._journal[:drop]
                self.journal_dropped += drop
            if len(self._log) > _COMPACT_AT:
                self._compact_locked()
            return accepted

    @staticmethod
    def _decode(msg) -> Optional[ControlRecord]:
        value = getattr(msg, "value", None)
        if value is None:
            return None
        try:
            obj = json.loads(value.decode("utf-8")
                             if isinstance(value, (bytes, bytearray))
                             else value)
        except (ValueError, AttributeError):
            return None
        return ControlRecord.from_dict(obj) if isinstance(obj, dict) else None

    def replay(self) -> Tuple[Optional[ControlRecord], List[ControlRecord]]:
        """The successor's read: (newest unfenced snapshot, worker ops
        past its watermark in lamport order). Snapshot choice orders by
        (term, lamport) — a stale-term snapshot published LATE (the
        zombie-coordinator dying breath) loses to any newer-term one no
        matter its lamport, and is counted, not honored."""
        with self._lock:
            snaps = [r for r in self._log if r.kind == "snapshot"]
            best: Optional[ControlRecord] = None
            for r in snaps:
                if best is None or (r.term, r.lamport) > (best.term,
                                                          best.lamport):
                    best = r
            if best is not None:
                self.stale_snapshots_rejected += sum(
                    1 for r in snaps
                    if r.term < best.term and r.lamport > best.lamport)
            watermark = (int(best.payload.get("watermark") or 0)
                         if best is not None else 0)
            ops = sorted(
                (r for r in self._log
                 if r.kind in WORKER_OPS and r.lamport > watermark),
                key=lambda r: (r.lamport, r.sender, r.seq))
            return best, ops

    def lamport(self) -> int:
        with self._lock:
            return self._lamport

    def export_trace(self) -> List[dict]:
        """The conformance journal as JSON-ready dicts, delivery order (the
        ``succession.trace`` block of ``Fleet.run``'s output)."""
        with self._lock:
            return [r.as_dict() for r in self._journal]

    def lost(self) -> int:
        """Records definitely lost below each sender's delivery high
        watermark (in-flight records above it don't count yet)."""
        with self._lock:
            return self._lost_locked()

    def _lost_locked(self) -> int:
        return sum(high - len(self._seen.get(sender, ()))
                   for sender, high in self._high.items())

    def stats(self) -> dict:
        with self._lock:
            return {
                "published": self.published,
                "delivered": self.delivered,
                "lost": self._lost_locked(),
                "duplicates_dropped": self.duplicates_dropped,
                "reordered": self.reordered,
                "stale_snapshots_rejected": self.stale_snapshots_rejected,
                "log": len(self._log),
                "compactions": self.compactions,
                "journal": len(self._journal),
                "journal_dropped": self.journal_dropped,
            }

    def _compact_locked(self) -> None:
        """Compacted-topic semantics on the in-memory log: keep the
        winning snapshot + every worker op past its watermark; candidate
        chatter (beacons/claims) and superseded ops drop."""
        snaps = [r for r in self._log if r.kind == "snapshot"]
        best = max(snaps, key=lambda r: (r.term, r.lamport), default=None)
        watermark = (int(best.payload.get("watermark") or 0)
                     if best is not None else 0)
        keep = [r for r in self._log
                if r.kind in WORKER_OPS and r.lamport > watermark]
        if best is not None:
            keep.append(best)
        keep.sort(key=lambda r: r.lamport)
        self._log = keep
        self.compactions += 1


class KafkaControlBus(ControlBus):
    """Control lane over a compacted Kafka topic — the cross-host
    transport, a producer and consumer pair of ``stream/kafka.py``.
    Import-gated on confluent_kafka: without it construction raises and the
    caller stays on the in-process bus. Create the topic with
    ``cleanup.policy=compact``: records are keyed ``kind:sender``
    (:meth:`ControlRecord.key`), so the broker's compaction keeps what
    :meth:`ControlBus._compact_locked` keeps."""

    def __init__(self, config=None, *, topic: str = "__fleet_control"):
        from fraud_detection_tpu_torch.stream import kafka as _kafka

        if not _kafka.kafka_available():
            raise RuntimeError(
                "KafkaControlBus requires confluent_kafka; use the "
                "in-process ControlBus (or broker consumer/producer "
                "pair) instead")
        producer = _kafka.KafkaProducer(config)
        consumer = _kafka.KafkaConsumer([topic], config)
        super().__init__(producer, consumer, topic=topic)


class TermGate:
    """The election fence: a monotonic term with compare-and-swap
    advance. ``try_advance`` is how a candidate wins (strictly greater
    terms only — two candidates racing the same term elect once);
    ``accept`` is how everyone else decides whether a decision stamped
    with some term is still authoritative."""

    def __init__(self, term: int = 0):
        self._lock = threading.Lock()
        self._term = term

    def current(self) -> int:
        with self._lock:
            return self._term

    def try_advance(self, term: int) -> bool:
        with self._lock:
            if term > self._term:
                self._term = term
                return True
            return False

    def accept(self, term: int) -> bool:
        """A decision stamped ``term`` is acceptable iff no newer term
        has been granted (the stale-term fence: accepting an old term
        would let two coordinators duplicate rows)."""
        with self._lock:
            return term >= self._term


class SuccessionCoordinator:
    """Coordinator-as-a-leased-role: a drop-in `FleetCoordinator`
    surface (join/sync/ack/leave/fence_lost/tick/...) whose actual
    brain is whichever candidate currently holds the role lease.

    See the module docstring for the protocol; thread model: worker
    threads call the membership surface, the fleet monitor calls
    ``tick``, and one thread per candidate calls ``step`` — everything
    shared sits under ``_lock``, elections serialize under
    ``_elect_lock``, and neither is ever held across a call into the
    bus, the gate, or the inner coordinator."""

    def __init__(self, topics: Sequence[str], num_partitions: int, *,
                 bus=None, control: Optional[ControlBus] = None,
                 lease_ttl: float = 30.0,
                 lag_fn: Optional[Callable[[], Optional[int]]] = None,
                 candidates: int = 2, role_ttl: Optional[float] = None,
                 kill=None, clock=time.monotonic, wall=time.time):
        if candidates < 1:
            raise ValueError(f"candidates must be >= 1, got {candidates}")
        self.topics = tuple(topics)
        self.num_partitions = num_partitions
        self.lease_ttl = lease_ttl
        self.role_ttl = role_ttl if role_ttl is not None else lease_ttl / 2
        if self.role_ttl <= 0:
            raise ValueError(f"role_ttl must be > 0, got {self.role_ttl}")
        self._fleet_bus = bus
        self._lag_fn = lag_fn
        self._clock = clock
        self._wall = wall
        self.control = control if control is not None else ControlBus()
        self.gate = TermGate()
        self.kill = kill
        self.candidate_ids = tuple(f"c{i}" for i in range(candidates))
        self._lock = threading.Lock()
        self._elect_lock = threading.Lock()
        self._cands: Dict[str, str] = {c: "standby" for c in
                                       self.candidate_ids}
        self.handoff_log: List[dict] = []
        self.elections = 0
        self._leases: Dict[str, Lease] = {}      # last lease each worker saw
        self._granted: Dict[str, Set[tuple]] = {}
        self._held: Dict[str, Set[tuple]] = {}   # revoked, not yet acked
        self._outbox: List[ControlRecord] = []   # ops possibly lost on wire
        self._counters = {"rebalances": 0, "expirations": 0}
        self._last_view: Optional[dict] = None
        self._abdicated = False
        self._leader_down_at: Optional[float] = None
        self._last_leader: Optional[str] = None
        # Autoscale stats hook (fleet/autoscale/): propagated onto every
        # installed incumbent so the view's ``autoscale`` block survives
        # failover (the property setter below re-wires the live one).
        self._autoscale_stats: Optional[Callable[[], dict]] = None
        # Bootstrap: the first candidate takes term 1 with a fresh
        # coordinator — no interregnum before the fleet's first tick.
        first = self.candidate_ids[0]
        self.gate.try_advance(1)
        coordinator = self._new_coordinator()
        coordinator.term = 1
        coordinator.leader_id = first
        coordinator.control_stats = self.control.stats
        self.coordinator: Optional[FleetCoordinator] = coordinator
        self.leader_id: Optional[str] = first
        self._leader_term = 1
        self._cands[first] = "leading"
        self._last_beacon = self._clock()

    def _new_coordinator(self) -> FleetCoordinator:
        coordinator = FleetCoordinator(
            self.topics, self.num_partitions, bus=self._fleet_bus,
            lease_ttl=self.lease_ttl, lag_fn=self._lag_fn,
            clock=self._clock, wall=self._wall)
        coordinator.autoscale_stats = self._autoscale_stats
        return coordinator

    @property
    def autoscale_stats(self) -> Optional[Callable[[], dict]]:
        return self._autoscale_stats

    @autoscale_stats.setter
    def autoscale_stats(self, fn: Optional[Callable[[], dict]]) -> None:
        with self._lock:
            self._autoscale_stats = fn
            coordinator = self.coordinator
        if coordinator is not None:
            coordinator.autoscale_stats = fn

    # ------------------------------------------------------------------
    # worker-facing surface (worker threads)
    # ------------------------------------------------------------------

    def join(self, worker_id: str) -> Lease:
        with self._lock:
            coordinator = self.coordinator
        if coordinator is None:
            # Interregnum: the op still lands on the bus (records outlive
            # the brain — the successor replays it); the answer is the
            # dead leader's last word, unmutated.
            self._publish_op("join", worker_id)
            return self._cached_lease(worker_id)
        lease = coordinator.join(worker_id)
        self._publish_op("join", worker_id)
        self._cache_lease(worker_id, lease)
        return lease

    def sync(self, worker_id: str) -> Lease:
        with self._lock:
            coordinator = self.coordinator
        if coordinator is None:
            self._publish_op("sync", worker_id)
            return self._cached_lease(worker_id)
        lease = coordinator.sync(worker_id)
        self._publish_op("sync", worker_id)
        self._cache_lease(worker_id, lease)
        return lease

    def ack(self, worker_id: str) -> Lease:
        with self._lock:
            coordinator = self.coordinator
        if coordinator is None:
            self._publish_op("ack", worker_id)
            with self._lock:
                # The worker drained + committed: its holds are over even
                # while leaderless (the replayed ack tells the successor).
                self._held.pop(worker_id, None)
            return self._cached_lease(worker_id)
        lease = coordinator.ack(worker_id)
        self._publish_op("ack", worker_id)
        self._cache_lease(worker_id, lease)
        with self._lock:
            self._held.pop(worker_id, None)
        return lease

    def leave(self, worker_id: str) -> None:
        with self._lock:
            coordinator = self.coordinator
        if coordinator is not None:
            coordinator.leave(worker_id)
        self._publish_op("leave", worker_id)
        with self._lock:
            self._leases.pop(worker_id, None)
            self._granted.pop(worker_id, None)
            self._held.pop(worker_id, None)

    def fence_lost(self, worker_id: str,
                   pairs: Sequence[tuple]) -> List[tuple]:
        """Commit fence. Leaderless, the proxy answers from its lease
        cache: granted ∪ held — a draining old owner's commits stay
        authoritative mid-failover (the revoke barrier holds them until
        its ack), while a pair merely targeted-but-withheld fences. The
        narrow residue (a pre-kill zombie whose expiry the dead leader
        never processed) is exactly what the model's term fences cover —
        the successor's first tick expires it before any re-grant."""
        with self._lock:
            coordinator = self.coordinator
            if coordinator is None:
                own = (self._granted.get(worker_id, set())
                       | self._held.get(worker_id, set()))
                return [p for p in pairs if tuple(p) not in own]
        return coordinator.fence_lost(worker_id, pairs)

    def request_release(self, worker_id: str) -> bool:
        """Coordinator-requested voluntary leave (fleet/autoscale/
        scale-in). Leaderless, the request is REFUSED — the autoscaler
        simply retries next tick; granting from the lease cache could
        shrink a fleet whose successor's replayed state still needs the
        member. A granted release lands in ``export_state`` and rides
        the next snapshot, so an in-flight drain survives failover."""
        with self._lock:
            coordinator = self.coordinator
        if coordinator is None:
            return False
        return coordinator.request_release(worker_id)

    # ------------------------------------------------------------------
    # lease cache + op outbox internals
    # ------------------------------------------------------------------

    def _cache_lease(self, worker_id: str, lease: Lease) -> None:
        granted = {tuple(p) for p in lease.partitions}
        with self._lock:
            old = self._granted.get(worker_id, set())
            revoked = old - granted
            if revoked:
                # Revoked-not-yet-acked: the worker keeps commit rights
                # on these until its drain ack (mirrors _pending).
                self._held.setdefault(worker_id, set()).update(revoked)
            self._granted[worker_id] = granted
            self._leases[worker_id] = lease

    def _cached_lease(self, worker_id: str) -> Lease:
        with self._lock:
            lease = self._leases.get(worker_id)
            if lease is None:
                lease = Lease(worker_id, 0, (), ())
                self._leases[worker_id] = lease
            return lease

    def _publish_op(self, kind: str, worker_id: str) -> None:
        # Apply-then-publish (callers apply first): the record's lamport
        # is assigned AFTER the op landed in coordinator state, so any
        # snapshot watermark covering this lamport covers the op — safe
        # to prune from the outbox.
        rec = self.control.publish(kind, worker_id, {},
                                   term=self.gate.current())
        with self._lock:
            self._outbox.append(rec)
            if len(self._outbox) > _OUTBOX_KEEP:
                del self._outbox[:len(self._outbox) - _OUTBOX_KEEP]

    def _prune_outbox(self, watermark: int) -> None:
        with self._lock:
            self._outbox = [r for r in self._outbox
                            if r.lamport > watermark]

    # ------------------------------------------------------------------
    # the incumbent's tick (fleet monitor thread)
    # ------------------------------------------------------------------

    def tick(self) -> dict:
        # Drain the wire every tick: delivery accounting (lost/reordered)
        # and the conformance journal must not wait for an election's
        # poll — an incumbent that never dies still records an auditable
        # run.
        self.control.poll()
        with self._lock:
            coordinator = self.coordinator
            leader = self.leader_id
            my_term = self._leader_term
        if coordinator is None or leader is None:
            # Interregnum: give standby candidates a chance (fallback for
            # deployments that never started candidate threads), then
            # answer with the STALE view — its frozen ticks counter is
            # what trips the sentinel's coordinator_absence rule.
            self._maybe_elect()
            with self._lock:
                coordinator = self.coordinator
                if coordinator is None:
                    return dict(self._last_view or {})
                leader = self.leader_id
                my_term = self._leader_term
        kill = self.kill
        if kill is not None:
            try:
                kill.tick(leader)
            except CoordinatorKilled as exc:
                self._on_killed(exc)
                with self._lock:
                    return dict(self._last_view or {})
        if not self.gate.accept(my_term):
            # Zombie incumbent: a newer term won the role while this
            # tick was in flight. Demote WITHOUT publishing — a stale-
            # term snapshot or beacon must never follow a newer fence
            # (the zombie demotes before it publishes).
            with self._lock:
                if self.coordinator is coordinator:
                    self.coordinator = None
                    self.leader_id = None
                    self._cands[leader] = "standby"
                return dict(self._last_view or {})
        view = coordinator.tick()
        self.control.publish("beacon", leader,
                             {"ticks": view.get("coordinator", {})
                              .get("ticks")}, term=my_term)
        state = coordinator.export_state()
        watermark = self.control.lamport()
        self.control.publish("snapshot", leader,
                             {"state": state, "watermark": watermark},
                             term=my_term)
        self._prune_outbox(watermark)
        with self._lock:
            self._last_beacon = self._clock()
            self._last_view = view
            self._counters["rebalances"] = coordinator.rebalances
            self._counters["expirations"] = coordinator.expirations
        return view

    def _on_killed(self, exc: CoordinatorKilled) -> None:
        with self._lock:
            coordinator = self.coordinator
            cid = self.leader_id
            term = self._leader_term
        if coordinator is None or cid is None:
            return
        if exc.mode == "graceful":
            # Dying breath: a final snapshot + abdication record, so the
            # successor starts from a complete log and elects at once.
            state = coordinator.export_state()
            watermark = self.control.lamport()
            self.control.publish("snapshot", cid,
                                 {"state": state, "watermark": watermark},
                                 term=term)
            self.control.publish("abdicate", cid, {}, term=term)
        with self._lock:
            self._cands[cid] = "dead"
            self._last_leader = cid
            self.coordinator = None
            self.leader_id = None
            self._abdicated = exc.mode == "graceful"
            self._leader_down_at = self._clock()

    # ------------------------------------------------------------------
    # candidate side (one thread per candidate, or inline fallback)
    # ------------------------------------------------------------------

    def step(self, cid: str) -> bool:
        """One candidate pass: contend for the role if it is vacant —
        either announced (abdication) or deduced (no beacon for
        ``role_ttl``, the crash-detection delay a real deployment pays).
        Returns True when this call installed a new incumbent."""
        with self._lock:
            if self._cands.get(cid) != "standby":
                return False
            if not self._vacancy_locked():
                return False
        return self._elect(cid)

    def _vacancy_locked(self) -> bool:
        if self.coordinator is not None:
            return False
        if self._abdicated:
            return True
        return (self._clock() - self._last_beacon) > self.role_ttl

    def _maybe_elect(self) -> None:
        with self._lock:
            if not self._vacancy_locked():
                return
            ready = [c for c, s in self._cands.items() if s == "standby"]
        if ready:
            self._elect(ready[0])

    def _elect(self, cid: str) -> bool:
        with self._elect_lock:
            # Re-check under the election lock: a racing candidate may
            # have just installed itself — without this, the loser would
            # escalate the term and steal a freshly-won role.
            with self._lock:
                if (self._cands.get(cid) != "standby"
                        or not self._vacancy_locked()):
                    return False
                down = self._leader_down_at
            term = self.gate.current() + 1
            if not self.gate.try_advance(term):
                return False
            self.control.publish("claim", cid, {}, term=term)
            self.control.poll()
            snapshot, ops = self.control.replay()
            coordinator = self._reconstruct(snapshot, ops)
            self._install(cid, term, coordinator, down)
            return True

    def _reconstruct(self, snapshot: Optional[ControlRecord],
                     ops: List[ControlRecord]) -> FleetCoordinator:
        """Successor state: newest unfenced snapshot (restoring target,
        REVOKE-BARRIER HOLDS, generation, counters) + every worker op
        past its watermark in lamport order + any outbox op the wire may
        have eaten (at-least-once; ops are idempotent)."""
        coordinator = self._new_coordinator()
        if snapshot is not None:
            coordinator.restore_state(snapshot.payload.get("state") or {})
        watermark = (int(snapshot.payload.get("watermark") or 0)
                     if snapshot is not None else 0)
        with self._lock:
            extra = list(self._outbox)
        delivered = {(r.sender, r.seq) for r in ops}
        replay = list(ops)
        for rec in extra:
            if (rec.kind in WORKER_OPS and rec.lamport > watermark
                    and (rec.sender, rec.seq) not in delivered):
                replay.append(rec)
                self.control.retry(rec)
        replay.sort(key=lambda r: (r.lamport, r.sender, r.seq))
        for rec in replay:
            if rec.kind in ("join", "sync"):
                coordinator.join(rec.sender)
            elif rec.kind == "ack":
                coordinator.ack(rec.sender)
            elif rec.kind == "leave":
                coordinator.leave(rec.sender)
        return coordinator

    def _install(self, cid: str, term: int,
                 coordinator: FleetCoordinator, down: Optional[float]) -> None:
        now = self._clock()
        with self._lock:
            mode = "graceful" if self._abdicated else "crash"
            self.elections += 1
            self.handoff_log.append({
                "term": term,
                "from": self._last_leader,
                "to": cid,
                "mode": mode,
                "failover_s": (round(now - down, 6)
                               if down is not None else 0.0),
                "at": self._wall(),
            })
            coordinator.term = term
            coordinator.leader_id = cid
            coordinator.handoffs = len(self.handoff_log)
            coordinator.elections = self.elections
            coordinator.control_stats = self.control.stats
            self.coordinator = coordinator
            self.leader_id = cid
            self._leader_term = term
            self._cands[cid] = "leading"
            self._abdicated = False
            self._leader_down_at = None
            self._last_beacon = now

    # ------------------------------------------------------------------
    # observability surface (drop-in FleetCoordinator compatibility)
    # ------------------------------------------------------------------

    def assignments(self) -> Dict[str, List[tuple]]:
        with self._lock:
            coordinator = self.coordinator
            if coordinator is None:
                return {w: sorted(g) for w, g in self._granted.items()}
        return coordinator.assignments()

    def committed_lag(self) -> Optional[int]:
        with self._lock:
            coordinator = self.coordinator
        if coordinator is None:
            fn = self._lag_fn
            if fn is None:
                return None
            try:
                return fn()
            except Exception:  # noqa: BLE001 — observability never kills
                return None
        return coordinator.committed_lag()

    def last_view(self) -> Optional[dict]:
        with self._lock:
            coordinator = self.coordinator
            if coordinator is None:
                return self._last_view
        view = coordinator.last_view()
        if view is not None:
            return view
        with self._lock:
            return self._last_view

    @property
    def rebalances(self) -> int:
        with self._lock:
            coordinator = self.coordinator
            if coordinator is None:
                return self._counters["rebalances"]
        return coordinator.rebalances

    @property
    def expirations(self) -> int:
        with self._lock:
            coordinator = self.coordinator
            if coordinator is None:
                return self._counters["expirations"]
        return coordinator.expirations

    @property
    def term(self) -> int:
        return self.gate.current()

    @property
    def handoffs(self) -> int:
        with self._lock:
            return len(self.handoff_log)

    def succession_report(self) -> dict:
        """Evidence block for Fleet.run's output."""
        with self._lock:
            leader = self.leader_id
            cands = dict(self._cands)
            elections = self.elections
            handoffs = [dict(h) for h in self.handoff_log]
        return {
            "term": self.gate.current(),
            "leader": leader,
            "candidates": cands,
            "elections": elections,
            "handoffs": handoffs,
            "control": self.control.stats(),
            # The full conformance journal.
            "trace": self.control.export_trace(),
        }
