"""Deterministic fault injection for the streaming serving path — twin of
``fraud_detection_tpu/stream/faults.py``.

The engine claims at-least-once delivery with fenced commits and supervised
restarts (``stream/engine.py``); this module is what makes those claims
testable. A seeded :class:`FaultPlan` drives :class:`ChaosConsumer` /
:class:`ChaosProducer` wrappers that conform to the ``broker.py``
Consumer/Producer protocols and inject, on a reproducible schedule:

* **poll transport errors** — ``TransientBrokerError`` from ``poll`` /
  ``poll_batch``; kills the incarnation, the supervisor restarts.
* **latency spikes** — an injected stall before poll results return
  (``plan.sleep`` is injectable so tests pay zero wall-clock).
* **duplicate delivery** — a polled message re-delivered in the same batch.
* **payload corruption** — a message's value replaced by undecodable bytes
  (exercises the malformed/DLQ path while keeping the message's key).
* **flush failures** — ``flush()`` reports undelivered records and REALLY
  loses them: the chaos producer buffers produces and only appends to the
  inner producer at flush, so a failed flush drops a subset for real. The
  engine must then stop without committing (the lost records are in
  ``ChaosProducer.lost`` for invariant accounting).
* **flush crashes** — ``flush()`` raises ``ConnectionError`` with the whole
  buffer still undelivered (broker gone mid-batch).
* **delivery reorder** — a flushed batch lands rotated out of publish order.
* **commit fences** — ``CommitFailedError`` from commits (a group rebalance
  landing between produce and commit).

Determinism: the plan owns ONE seeded ``random.Random`` consumed in call
order — the same generator and draw order as the JAX package's plan, so one
seed and one sequence of broker calls give the same schedule in both. The
serving loop is single-driver by contract, so a fixed seed gives a
bit-reproducible fault schedule and, over the in-process broker, a
bit-reproducible output stream. ``max_faults`` bounds the total injections
so a supervised run provably converges once the budget is spent.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional

from fraud_detection_tpu_torch.stream.broker import (CommitFailedError, Message,
                                               TransientBrokerError)

# Prefix that makes any payload undecodable as JSON (0x00 is rejected by both
# the native scanner and json.loads) while keeping the original bytes visible
# in error frames / DLQ records for debugging.
_CORRUPTION_PREFIX = b"\x00chaos:"


@dataclass
class FaultPlan:
    """A seeded, budgeted schedule of broker faults.

    Rates are per-opportunity probabilities (per poll, per flush, per
    commit). ``max_faults`` caps TOTAL injections across all kinds — after
    the budget is spent every wrapper passes through, so a supervised run
    under any plan converges. One plan instance is shared by every wrapper
    of a scenario (including across supervised-restart incarnations): the
    single rng stream is what makes the schedule reproducible.
    """

    seed: int = 0
    poll_error_rate: float = 0.0
    latency_spike_rate: float = 0.0
    latency_spike_sec: float = 0.01
    duplicate_rate: float = 0.0
    corrupt_rate: float = 0.0
    flush_fail_rate: float = 0.0
    flush_crash_rate: float = 0.0
    commit_fence_rate: float = 0.0
    # Delivery reorder: a flushed batch lands rotated (records delivered
    # out of publish order). Harmless to the data lane's per-partition
    # offsets; it is the out-of-order adversary of a control lane.
    reorder_rate: float = 0.0
    max_faults: Optional[int] = None
    sleep: Callable[[float], None] = time.sleep
    injected: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        # A plan shared across worker threads (several engines, one plan):
        # draws and counter updates must not lose injections. Single-thread
        # runs (the chaos suite) stay deterministic — the lock adds no draw.
        self._lock = threading.Lock()

    @classmethod
    def demo(cls, seed: int = 0, *, sleep: Callable[[float], None] = time.sleep,
             max_faults: int = 40) -> "FaultPlan":
        """The serve CLI's ``--chaos`` preset: every fault kind enabled at
        moderate rates under a budget that lets a supervised demo converge."""
        return cls(seed=seed, poll_error_rate=0.06, latency_spike_rate=0.05,
                   latency_spike_sec=0.002, duplicate_rate=0.05,
                   corrupt_rate=0.03, flush_fail_rate=0.06,
                   flush_crash_rate=0.05, commit_fence_rate=0.05,
                   max_faults=max_faults, sleep=sleep)

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def spent(self) -> bool:
        """True once the fault budget is exhausted (wrappers pass through)."""
        return (self.max_faults is not None
                and self.total_injected >= self.max_faults)

    def fire(self, kind: str, rate: float) -> bool:
        """One fault opportunity. Draws from the rng ONLY for enabled kinds
        with budget remaining, so disabling a kind (rate 0) or exhausting
        the budget never shifts the schedule of the draws that do happen."""
        if rate <= 0.0:
            return False
        with self._lock:
            if self.spent():
                return False
            if self._rng.random() >= rate:
                return False
            self.injected[kind] = self.injected.get(kind, 0) + 1
            return True

    def pick(self, n: int) -> int:
        """Deterministic index draw in [0, n) for choosing a victim row."""
        with self._lock:
            return self._rng.randrange(n)

    def report(self) -> dict:
        """Injection counts by kind (the serve CLI's stats JSON and the
        chaos suite's sanity check that the chaos actually bit)."""
        return {"total": self.total_injected, **dict(sorted(self.injected.items()))}

    def consumer(self, inner) -> "ChaosConsumer":
        return ChaosConsumer(inner, self)

    def producer(self, inner) -> "ChaosProducer":
        return ChaosProducer(inner, self)


class WorkerKilled(RuntimeError):
    """An injected whole-worker death (WorkerDeathPlan). Raised out of the
    victim worker's poll path — BEFORE any new batch dispatches, so nothing
    is produced-but-uncommitted when it fires; the engine's abort path
    discards in-flight (unproduced) batches and the partitions' next owner
    resumes from the committed offsets with zero loss and zero duplicates.
    ``mode`` is "graceful" (the worker releases its lease immediately —
    revoke->drain->commit->reassign) or "crash" (the worker just vanishes;
    its lease must EXPIRE before the coordinator reassigns)."""

    def __init__(self, worker_id: str, mode: str):
        self.worker_id = worker_id
        self.mode = mode
        super().__init__(f"chaos: worker {worker_id!r} killed ({mode})")


@dataclass
class WorkerDeathPlan:
    """A seeded schedule of whole-worker deaths for a fleet chaos harness
    (:class:`FaultPlan` kills *calls*; this kills *workers* — the failure a
    fleet rebalance protocol exists to survive).

    For each victim the plan draws, deterministically from one seeded rng:
    which worker dies, after how many of ITS polls, and how (graceful
    lease release vs crash + lease expiry). ``arm(worker_id)`` is called
    once per worker as it joins (arming order must therefore be
    deterministic — the fleet arms workers in index order); ``tick`` is
    called per poll and raises :class:`WorkerKilled` when that worker's
    time comes. Workers beyond ``kills`` never die."""

    seed: int = 0
    kills: int = 1
    min_polls: int = 2
    max_polls: int = 12
    modes: tuple = ("graceful", "crash")

    def __post_init__(self):
        if self.kills < 0:
            raise ValueError(f"kills must be >= 0, got {self.kills}")
        if not 0 < self.min_polls <= self.max_polls:
            raise ValueError(
                f"need 0 < min_polls <= max_polls, got "
                f"{self.min_polls}/{self.max_polls}")
        self._rng = random.Random(self.seed)
        self._schedule: Dict[str, tuple] = {}   # worker_id -> (at_poll, mode)
        self._polls: Dict[str, int] = {}
        self._armed: List[str] = []
        self.killed: List[tuple] = []           # (worker_id, mode, at_poll)
        self._lock = threading.Lock()

    def arm(self, worker_id: str) -> None:
        """Register a worker with the plan; the first ``kills`` armed
        workers draw a death (poll count + mode) from the seeded rng."""
        with self._lock:
            if worker_id in self._polls:
                return
            self._polls[worker_id] = 0
            self._armed.append(worker_id)
            if len(self._schedule) < self.kills:
                at = self._rng.randint(self.min_polls, self.max_polls)
                mode = self.modes[self._rng.randrange(len(self.modes))]
                self._schedule[worker_id] = (at, mode)

    def tick(self, worker_id: str) -> None:
        """One poll by ``worker_id``; raises WorkerKilled at its drawn poll."""
        with self._lock:
            if worker_id not in self._polls:
                return
            self._polls[worker_id] += 1
            death = self._schedule.get(worker_id)
            if death is None or self._polls[worker_id] < death[0]:
                return
            del self._schedule[worker_id]
            self.killed.append((worker_id, death[1], death[0]))
            mode = death[1]
        raise WorkerKilled(worker_id, mode)

    def report(self) -> dict:
        with self._lock:
            return {"kills_planned": self.kills,
                    "killed": [{"worker": w, "mode": m, "at_poll": p}
                               for w, m, p in self.killed]}


class CoordinatorKilled(RuntimeError):
    """An injected death of a fleet's COORDINATOR.
    Raised out of the incumbent's own ``tick`` path. ``mode`` is
    "graceful" (dying breath: final snapshot + abdication record — the
    successor elects immediately) or "crash" (the incumbent just stops
    beaconing; candidates only deduce the vacancy after ``role_ttl`` of
    silence — the detection delay a real deployment pays)."""

    def __init__(self, coordinator_id: str, mode: str):
        self.coordinator_id = coordinator_id
        self.mode = mode
        super().__init__(
            f"chaos: coordinator {coordinator_id!r} killed ({mode})")


@dataclass
class CoordinatorKillSpec:
    """A seeded schedule of coordinator deaths — :class:`WorkerDeathPlan`
    for the fleet's brain. Each kill draws, deterministically from one
    seeded rng, after how many LEADER ticks the incumbent dies and how
    (graceful abdication vs crash). The tick counter resets after each
    kill, so ``kills=2`` exercises consecutive failovers: the successor
    runs its drawn span and then dies too."""

    seed: int = 0
    kills: int = 1
    min_ticks: int = 5
    max_ticks: int = 40
    modes: tuple = ("graceful", "crash")

    def __post_init__(self):
        if self.kills < 0:
            raise ValueError(f"kills must be >= 0, got {self.kills}")
        if not 0 < self.min_ticks <= self.max_ticks:
            raise ValueError(
                f"need 0 < min_ticks <= max_ticks, got "
                f"{self.min_ticks}/{self.max_ticks}")
        if not self.modes:
            raise ValueError("modes must not be empty")
        self._rng = random.Random(self.seed)
        self._ticks = 0
        self._next: Optional[tuple] = None      # (at_tick, mode), lazy
        self.killed: List[tuple] = []           # (coordinator, mode, at_tick)
        self._lock = threading.Lock()

    def tick(self, coordinator_id: str) -> None:
        """One tick by the CURRENT incumbent; raises CoordinatorKilled at
        the drawn tick (then re-draws for the next incumbent while kills
        remain)."""
        with self._lock:
            if len(self.killed) >= self.kills:
                return
            if self._next is None:
                at = self._rng.randint(self.min_ticks, self.max_ticks)
                mode = self.modes[self._rng.randrange(len(self.modes))]
                self._next = (at, mode)
            self._ticks += 1
            at, mode = self._next
            if self._ticks < at:
                return
            self.killed.append((coordinator_id, mode, at))
            self._next = None
            self._ticks = 0
        raise CoordinatorKilled(coordinator_id, mode)

    def report(self) -> dict:
        with self._lock:
            return {"kills_planned": self.kills,
                    "killed": [{"coordinator": c, "mode": m, "at_tick": t}
                               for c, m, t in self.killed]}


def _corrupt(msg: Message) -> Message:
    """A copy of ``msg`` with an undecodable value and everything else —
    key, partition, offset — intact, so commit accounting and key-set
    invariants still see the message."""
    return Message(msg.topic, _CORRUPTION_PREFIX + msg.value, msg.key,
                   msg.partition, msg.offset, msg.timestamp, msg.seq)


class ChaosConsumer:
    """Consumer-protocol wrapper injecting poll/commit faults per the plan."""

    def __init__(self, inner, plan: FaultPlan):
        self.inner = inner
        self.plan = plan

    def _pre_poll(self) -> None:
        if self.plan.fire("poll_error", self.plan.poll_error_rate):
            raise TransientBrokerError(
                "chaos: transport failure while polling (injected)")
        if self.plan.fire("latency_spike", self.plan.latency_spike_rate):
            self.plan.sleep(self.plan.latency_spike_sec)

    def _post_poll(self, msgs: List[Message]) -> List[Message]:
        if msgs and self.plan.fire("duplicate", self.plan.duplicate_rate):
            msgs.append(msgs[self.plan.pick(len(msgs))])
        if msgs and self.plan.fire("corrupt", self.plan.corrupt_rate):
            i = self.plan.pick(len(msgs))
            msgs[i] = _corrupt(msgs[i])
        return msgs

    def poll(self, timeout: float = 1.0) -> Optional[Message]:
        self._pre_poll()
        msg = self.inner.poll(timeout)
        if msg is not None and self.plan.fire("corrupt", self.plan.corrupt_rate):
            msg = _corrupt(msg)
        return msg

    def poll_batch(self, max_messages: int, timeout: float) -> List[Message]:
        self._pre_poll()
        return self._post_poll(list(self.inner.poll_batch(max_messages, timeout)))

    def _pre_commit(self) -> None:
        if self.plan.fire("commit_fence", self.plan.commit_fence_rate):
            raise CommitFailedError(
                "chaos: commit fenced by injected rebalance — offsets stay "
                "uncommitted, the batch replays (at-least-once)")

    def commit(self) -> None:
        self._pre_commit()
        self.inner.commit()

    def commit_offsets(self, offsets: Dict[tuple, int]) -> None:
        self._pre_commit()
        self.inner.commit_offsets(offsets)

    def close(self) -> None:
        self.inner.close()

    def __getattr__(self, name):
        # seek_to_committed, committed_offsets, assignment, member_id, ...
        return getattr(self.inner, name)


class ChaosProducer:
    """Producer-protocol wrapper whose flush failures lose records FOR REAL.

    Produces are buffered and only reach the inner producer at ``flush()``
    — exactly librdkafka's enqueue-then-drain shape — so an injected flush
    failure can drop a subset before delivery. The dropped records land in
    ``self.lost`` so tests can assert no commit ever advanced past them.
    """

    def __init__(self, inner, plan: FaultPlan):
        self.inner = inner
        self.plan = plan
        self._buffer: List[tuple] = []     # (topic, value, key)
        self.lost: List[tuple] = []        # records dropped by injected faults

    def produce(self, topic: str, value: bytes, key: Optional[bytes] = None) -> None:
        self._buffer.append((topic, value, key))

    def produce_batch(self, topic: str, items: Iterable[tuple]) -> None:
        self._buffer.extend((topic, value, key) for value, key in items)

    def _deliver(self, records: List[tuple]) -> None:
        for topic, value, key in records:
            self.inner.produce(topic, value, key=key)

    def flush(self, timeout: float = 10.0) -> int:
        if self.plan.fire("flush_crash", self.plan.flush_crash_rate):
            # Broker gone mid-batch: nothing delivered, engine incarnation
            # dies, supervisor restarts and the batch replays from the last
            # committed offset (the buffer dies with this incarnation's
            # producer — uncommitted, so nothing is orphaned).
            self.lost.extend(self._buffer)
            self._buffer.clear()
            raise ConnectionError("chaos: broker connection lost in flush (injected)")
        if self._buffer and self.plan.fire("flush_fail", self.plan.flush_fail_rate):
            # Partial delivery: a deterministic subset is lost, the rest
            # lands. The engine must report the batch undelivered, skip the
            # commit, and stop — a restart re-drives the WHOLE batch
            # (duplicating the delivered subset: at-least-once).
            n_lost = 1 + self.plan.pick(len(self._buffer))
            victims = sorted(self.plan.pick(len(self._buffer))
                             for _ in range(n_lost))
            lost_idx = set(victims)
            kept = [r for i, r in enumerate(self._buffer) if i not in lost_idx]
            self.lost.extend(r for i, r in enumerate(self._buffer) if i in lost_idx)
            self._buffer.clear()
            self._deliver(kept)
            self.inner.flush(timeout)
            return len(lost_idx)
        records, self._buffer = self._buffer, []
        if len(records) > 1 and self.plan.fire("reorder",
                                               self.plan.reorder_rate):
            # Deterministic rotation: every record still arrives exactly
            # once, just out of publish order.
            k = 1 + self.plan.pick(len(records) - 1)
            records = records[k:] + records[:k]
        self._deliver(records)
        return self.inner.flush(timeout)

    def close(self) -> None:
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()

    def __getattr__(self, name):
        return getattr(self.inner, name)
