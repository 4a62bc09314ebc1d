"""Fleet coordinator: group membership, partition leases, the global view —
twin of ``fraud_detection_tpu/fleet/coordinator.py``.

The broker's own consumer groups (stream/broker.py) already scale N engines
behind one topic, but their assignor is reactive — a member only discovers a
rebalance when its next poll is fenced. The fleet layer makes ownership a
first-class, *coordinated* object instead:

* **membership** — workers ``join``/``sync`` (heartbeat) /``leave``; a
  worker that stops heartbeating for ``lease_ttl`` seconds is expired and
  its partitions reassigned (the crash path).
* **leases** — every worker owns an EXPLICIT (topic, partition) set,
  granted by the balanced-sticky assignor here and consumed through the
  broker's manual-assignment mode (``InProcessBroker.assigned_consumer``).
* **revoke barrier** — when a rebalance moves a partition away from a LIVE
  worker, the new owner's lease withholds it until the old owner has
  drained its in-flight batches, committed, and ``ack``ed (the
  revoke->drain->commit->reassign choreography). A dead
  worker's partitions skip the barrier: its lease expiry IS the barrier,
  and the group-durable committed offsets are the zero-loss resume point.
* **global backlog watermark** — each tick aggregates the per-worker
  backlogs published on the fleet bus into ONE global number and publishes
  it back (``backlog_per_worker``); every worker's admission controller
  then sheds against the FLEET's queue depth instead of its own partitions'
  (sched/scheduler.py ``fleet_backlog``), so one drowning fleet sheds
  everywhere at once instead of each worker guessing from its own slice.

Thread model: workers call join/sync/ack/leave/fence_lost from their own
threads and the monitor thread calls ``tick`` — every mutation sits under
one lock, and the coordinator never calls back into engines, consumers, or
the broker while holding it (the fleet's lock graph stays acyclic).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from fraud_detection_tpu_torch.obs.trace import fleet_stage_latency


@dataclass(frozen=True)
class Lease:
    """One worker's partition ownership at one assignment generation."""

    worker_id: str
    generation: int
    partitions: Tuple[tuple, ...]    # granted pairs, sorted
    pending: Tuple[tuple, ...]       # target pairs withheld behind a live
                                     # previous owner's drain barrier
    released: bool = False           # the coordinator requested this
                                     # worker's voluntary leave (scale-in):
                                     # drain + commit + ack, then exit


class FleetCoordinator:
    """Lease-based partition assignment + fleet-view aggregation."""

    def __init__(self, topics: Sequence[str], num_partitions: int, *,
                 bus=None, lease_ttl: float = 30.0,
                 lag_fn: Optional[Callable[[], Optional[int]]] = None,
                 clock=time.monotonic, wall=time.time):
        if num_partitions < 1:
            raise ValueError(
                f"num_partitions must be >= 1, got {num_partitions}")
        if lease_ttl <= 0:
            raise ValueError(f"lease_ttl must be > 0, got {lease_ttl}")
        self.topics = tuple(topics)
        self.num_partitions = num_partitions
        self.bus = bus
        self.lease_ttl = lease_ttl
        # Optional committed-offset lag probe (rows appended but not yet
        # committed by the group, fleet-wide): the drain-run termination
        # signal workers consult when idle — it still counts a dead
        # worker's unreassigned partitions, which per-worker backlogs
        # cannot see (Fleet.in_process wires it to the broker).
        self._lag_fn = lag_fn
        self._clock = clock
        self._wall = wall
        self._lock = threading.Lock()
        self._members: Dict[str, dict] = {}   # wid -> {renewed, joined}
        self._target: Dict[str, Set[tuple]] = {}
        self._pending: Dict[tuple, str] = {}  # pair -> live holder draining it
        # Last GRANTED set actually issued to each worker (join/sync/ack
        # response). A re-deal may only create a NEW barrier hold for a
        # pair its previous owner was really issued — a pair that merely
        # transited a member's target between two of its syncs leaves no
        # read-ahead to drain, and a phantom hold for it would never be
        # acked (the member's lease never changes, so it never drains),
        # withholding the pair from its new owner FOREVER.
        self._issued: Dict[str, Set[tuple]] = {}
        # Members the autoscaler asked to leave (scale-in): excluded from
        # every re-deal but still live barrier HOLDERS until they drain,
        # commit, and ack — release rides the EXISTING revoke barrier.
        self._released: Set[str] = set()
        self._generation = 0
        self._join_seq = 0
        self._all_pairs = [(t, p) for t in self.topics
                           for p in range(num_partitions)]
        self.rebalances = 0
        self.expirations = 0
        self._last_view: Optional[dict] = None
        self._peak_backlog = 0   # max global backlog any tick aggregated
        # Succession identity (fleet/control.py): which term/leader this
        # coordinator instance serves under. A standalone coordinator is
        # its own term-1 incumbent; SuccessionCoordinator._install
        # overwrites these on every failover, and export_state/
        # restore_state carry the assignment state between incumbents.
        self.term = 1
        self.leader_id = "c0"
        self.handoffs = 0
        self.elections = 0
        self._ticks = 0
        self._last_tick_at: Optional[float] = None
        # Optional control-lane stats callable (ControlBus.stats) merged
        # into the view's coordinator block when succession is wired.
        self.control_stats: Optional[Callable[[], dict]] = None
        # Optional autoscale stats callable (Autoscaler.stats) merged
        # into the view as its ``autoscale`` block when elasticity is
        # wired (fleet/autoscale/).
        self.autoscale_stats: Optional[Callable[[], dict]] = None

    # ------------------------------------------------------------------
    # membership (worker threads)
    # ------------------------------------------------------------------

    def join(self, worker_id: str) -> Lease:
        with self._lock:
            now = self._clock()
            # Renew the caller FIRST: a syncing member is alive by
            # definition and must never fall to its own expiry scan.
            new = worker_id not in self._members
            if new:
                self._members[worker_id] = {"renewed": now,
                                            "joined": self._join_seq}
                self._join_seq += 1
            else:
                self._members[worker_id]["renewed"] = now
            expired = self._expire_locked(now)
            if new or expired:
                self._rebalance_locked()
            return self._lease_locked(worker_id)

    def sync(self, worker_id: str) -> Lease:
        """Heartbeat + current lease. A worker whose lease expired while it
        wasn't heartbeating transparently rejoins — with a FRESH lease whose
        partitions resume from the group's committed offsets (its old
        read-ahead is gone; the in-between owner was authoritative)."""
        return self.join(worker_id)

    def ack(self, worker_id: str) -> Lease:
        """The worker declares it has stopped consuming everything outside
        its current lease (engine drained, offsets committed, old consumer
        closed) — releases every partition it was holding behind the revoke
        barrier, so the new owners' next ``sync`` grants them."""
        with self._lock:
            released = [pair for pair, holder in self._pending.items()
                        if holder == worker_id]
            for pair in released:
                del self._pending[pair]
            if worker_id in self._members:
                self._members[worker_id]["renewed"] = self._clock()
            return self._lease_locked(worker_id)

    def leave(self, worker_id: str) -> None:
        """Graceful departure (the worker already drained + committed):
        its partitions reassign immediately — no barrier, no ttl wait."""
        with self._lock:
            self._released.discard(worker_id)
            self._issued.pop(worker_id, None)
            if worker_id not in self._members:
                return
            del self._members[worker_id]
            for pair in [p for p, h in self._pending.items()
                         if h == worker_id]:
                del self._pending[pair]
            self._rebalance_locked()

    def request_release(self, worker_id: str) -> bool:
        """Coordinator-requested VOLUNTARY LEAVE (the autoscaler's
        scale-in actuator). The member is excluded from the re-deal NOW —
        its pairs move to the surviving members *behind the existing
        revoke barrier*, so the released worker drains and commits every
        in-flight batch before the new owners may poll. The worker observes the released lease on
        its next sync/ack and exits through the graceful-leave path.

        Refused (returns False) for a non-member, a member already
        released, or when granting it would leave the fleet without an
        active (non-released) member."""
        with self._lock:
            if worker_id not in self._members \
                    or worker_id in self._released:
                return False
            active = [w for w in self._members if w not in self._released]
            if len(active) < 2:
                return False
            self._released.add(worker_id)
            self._rebalance_locked()
            return True

    def fence_lost(self, worker_id: str, pairs: Sequence[tuple]) -> List[tuple]:
        """Commit fence for the assigned consumer: which of ``pairs`` does
        ``worker_id`` NOT currently own? Non-empty for a zombie whose lease
        expired (its commit must fail — the new owner is authoritative),
        empty in normal operation. A pair the worker is still draining
        behind the revoke barrier is still the worker's to commit — but a
        pair merely TARGETED at the worker while withheld behind a peer's
        drain is not: until that peer commit-acks, the peer's commits are
        the authoritative ones, and letting the target owner commit too
        lets both sides durably commit the same rows (a stalled worker
        rejoins and is re-dealt its old pair as target while the
        in-between owner is mid-drain)."""
        with self._lock:
            held = {p for p, h in self._pending.items() if h == worker_id}
            granted = {p for p in self._target.get(worker_id, set())
                       if self._pending.get(p) in (None, worker_id)}
            return [p for p in pairs if tuple(p) not in granted
                    and tuple(p) not in held]

    # ------------------------------------------------------------------
    # succession state transfer (fleet/control.py)
    # ------------------------------------------------------------------

    def export_state(self) -> dict:
        """JSON-safe snapshot of the assignment state a successor needs:
        membership (join order preserved), the target map, and — the part
        a naive rebuild-from-targets drops — the revoke-barrier holds
        (``_pending``), so a mid-rebalance failover cannot re-grant a
        pair its draining old owner still commits on."""
        with self._lock:
            return {
                "term": self.term,
                "generation": self._generation,
                "join_seq": self._join_seq,
                "members": {w: info["joined"]
                            for w, info in self._members.items()},
                "target": {w: sorted([t, p] for (t, p) in pairs)
                           for w, pairs in self._target.items()},
                "pending": sorted(
                    [[t, p], holder]
                    for (t, p), holder in self._pending.items()),
                # In-flight scale-in drains: a successor must keep a
                # released member OUT of its re-deals, or failover would
                # silently cancel the voluntary leave mid-drain.
                "released": sorted(self._released),
                # Issued leases travel too: without them a successor's
                # first re-deal could not tell a pair with real
                # read-ahead behind it from one that merely transited a
                # target — it would either drop a needed hold (barrier
                # breach) or mint a phantom one (livelock).
                "issued": {w: sorted([t, p] for (t, p) in pairs)
                           for w, pairs in self._issued.items()},
                "rebalances": self.rebalances,
                "expirations": self.expirations,
                "ticks": self._ticks,
            }

    def restore_state(self, state: dict) -> None:
        """Adopt an exported snapshot (the successor's first act). Every
        restored member gets a FRESH renewal stamp: the successor cannot
        know how stale each lease was when the old incumbent died, and
        guessing short would expire live workers en masse — a dead
        worker just pays one extra ``lease_ttl`` before its partitions
        move, which the committed offsets make safe."""
        with self._lock:
            now = self._clock()
            members = state.get("members") or {}
            self._members = {w: {"renewed": now, "joined": int(joined)}
                             for w, joined in members.items()}
            self._join_seq = max(
                int(state.get("join_seq") or 0),
                max((int(j) for j in members.values()), default=-1) + 1)
            self._target = {
                w: {(t, p) for t, p in pairs}
                for w, pairs in (state.get("target") or {}).items()}
            self._pending = {
                (t, p): holder
                for (t, p), holder in (state.get("pending") or [])
                if holder in self._members}
            self._released = {w for w in (state.get("released") or [])
                              if w in self._members}
            # Snapshots from before the issued-lease field default to
            # "everything targeted was issued": conservative — it can
            # mint a phantom hold, never drop a real one.
            issued = state.get("issued")
            if issued is None:
                self._issued = {w: set(pairs)
                                for w, pairs in self._target.items()}
            else:
                self._issued = {w: {(t, p) for t, p in pairs}
                                for w, pairs in issued.items()
                                if w in self._members}
            self._generation = int(state.get("generation") or 0)
            self.rebalances = int(state.get("rebalances") or 0)
            self.expirations = int(state.get("expirations") or 0)
            self._ticks = int(state.get("ticks") or 0)

    # ------------------------------------------------------------------
    # assignment internals (caller holds self._lock)
    # ------------------------------------------------------------------

    def _expire_locked(self, now: float) -> bool:
        """Drop members whose lease ran out; returns True when any did
        (the CALLER then rebalances — join/tick fold it into one re-deal)."""
        stale = [w for w, info in self._members.items()
                 if now - info["renewed"] > self.lease_ttl]
        for w in stale:
            del self._members[w]
            self._released.discard(w)
            # A dead incarnation's issued lease must not vouch for its
            # successor: a rejoin starts with nothing issued.
            self._issued.pop(w, None)
            # Expiry IS the drain barrier for a dead worker: release its
            # holds — the committed offsets are the resume point.
            for pair in [p for p, h in self._pending.items() if h == w]:
                del self._pending[pair]
            self.expirations += 1
        return bool(stale)

    def _rebalance_locked(self) -> None:
        """Balanced-sticky re-deal (same shape as the broker's assignor):
        every member keeps what it owns up to its fair share; only orphaned
        pairs and the excess above a shrunken share move. Pairs leaving a
        LIVE member enter the revoke barrier (``_pending``) until that
        member acks its drain."""
        old = {pair: w for w, pairs in self._target.items() for pair in pairs}
        members = sorted(self._members,
                         key=lambda w: self._members[w]["joined"])
        # Released members (scale-in in flight) get NOTHING from the deal
        # — their whole lease is revoked — but stay live barrier holders
        # below until their drain acks.
        deal = [w for w in members if w not in self._released]
        self._generation += 1
        self.rebalances += 1
        self._target = {w: set() for w in members}
        if deal:
            base, extra = divmod(len(self._all_pairs), len(deal))
            share = {w: base + (1 if i < extra else 0)
                     for i, w in enumerate(deal)}
            kept: Dict[str, list] = {w: [] for w in deal}
            pool = []
            for pair in self._all_pairs:      # partition order: deterministic
                w = old.get(pair)
                if w in share and len(kept[w]) < share[w]:
                    kept[w].append(pair)
                else:
                    pool.append(pair)
            for w in deal:                    # join order: deterministic
                take = share[w] - len(kept[w])
                if take > 0:
                    kept[w].extend(pool[:take])
                    del pool[:take]
            for w in deal:
                self._target[w].update(kept[w])
        # Barrier: pairs that moved away from a still-live previous owner
        # wait for its drain ack; everything else (dead/absent owner, or
        # still with its owner) clears immediately. An EXISTING hold outlives
        # re-deals: the holder is whoever actually consumed the pair, and
        # until it acks, re-targeting the pair (a second rebalance before the
        # drain finishes) must not hand it to the next owner — rebuilding
        # from the target map alone would drop exactly those holds.
        # Iterates ALL pairs, not just targeted ones: a pair the deal has
        # nobody to give to yet (every dealable member released mid-scale-
        # in) keeps its live holder's hold — the hold protects the pair's
        # NEXT owner, whoever that turns out to be.
        # A NEW hold (no existing one) additionally requires the previous
        # owner to have been ISSUED the pair: only a granted lease can
        # carry read-ahead worth draining. Without this gate, a pair that
        # bounced through a member's target while it never synced (expired
        # peer's pair parked on it, then re-dealt away) acquires a hold
        # its "holder" can never ack, and the pair is never committed.
        new_owner = {pair: w for w, pairs in self._target.items()
                     for pair in pairs}
        self._pending = {
            pair: holder
            for pair in self._all_pairs
            for holder in (self._pending.get(pair)
                           if pair in self._pending
                           else self._issued_holder_locked(pair, old),)
            if holder is not None and holder != new_owner.get(pair)
            and holder in self._members}

    def _issued_holder_locked(self, pair, old) -> Optional[str]:
        holder = old.get(pair)
        if holder is not None \
                and pair not in self._issued.get(holder, ()):
            return None
        return holder

    def _lease_locked(self, worker_id: str) -> Lease:
        target = self._target.get(worker_id, set())
        withheld = tuple(sorted(
            p for p in target
            if self._pending.get(p) not in (None, worker_id)))
        granted = tuple(sorted(p for p in target if p not in withheld))
        self._issued[worker_id] = set(granted)
        return Lease(worker_id, self._generation, granted, withheld,
                     released=worker_id in self._released)

    # ------------------------------------------------------------------
    # observability + aggregation (monitor thread)
    # ------------------------------------------------------------------

    def assignments(self) -> Dict[str, List[tuple]]:
        with self._lock:
            return {w: sorted(pairs) for w, pairs in self._target.items()}

    def committed_lag(self) -> Optional[int]:
        """Rows not yet committed by the group, fleet-wide (None when no
        probe is wired). Counts dead workers' unreassigned partitions."""
        fn = self._lag_fn
        if fn is None:
            return None
        try:
            return fn()
        except Exception:  # noqa: BLE001 — observability must not kill serving
            return None

    def tick(self) -> dict:
        """One coordinator pass: expire dead leases, aggregate the bus into
        the fleet view, publish it back. Returns the view."""
        with self._lock:
            if self._expire_locked(self._clock()):
                self._rebalance_locked()
            self._ticks += 1
            self._last_tick_at = self._clock()
            generation = self._generation
            members = set(self._members)
            assignments = {w: sorted(pairs)
                           for w, pairs in self._target.items()}
            pending = len(self._pending)
            rebalances, expirations = self.rebalances, self.expirations
        snaps = self.bus.snapshots() if self.bus is not None else {}
        backlogs: Dict[str, int] = {}
        shed_total = 0
        processed_total = 0
        stage_wires: List[dict] = []
        alerts_firing = 0
        alerts_critical = 0
        worker_alerts: Dict[str, list] = {}
        for wid, entry in snaps.items():
            if wid not in members:
                continue    # departed/expired worker's stale publish
            doc = entry.get("health") or {}
            b = doc.get("backlog")
            if isinstance(b, (int, float)):
                backlogs[wid] = int(b)
            engine = doc.get("engine") or {}
            shed_total += engine.get("shed") or 0
            processed_total += engine.get("processed") or 0
            obs = doc.get("obs") or {}
            if isinstance(obs.get("stages"), dict):
                stage_wires.append(obs["stages"])
            # Per-worker sentinel states riding the bus (obs/sentinel/):
            # aggregate into the fleet view the coordinator-level
            # worker_alerts rule judges.
            alerts = doc.get("alerts")
            if isinstance(alerts, dict):
                firing = alerts.get("firing") or []
                alerts_firing += len(firing)
                alerts_critical += len(alerts.get("critical_firing") or [])
                if firing:
                    worker_alerts[wid] = list(firing)
        global_backlog = sum(backlogs.values()) if backlogs else None
        if global_backlog is not None:
            self._peak_backlog = max(self._peak_backlog, global_backlog)
        view = {
            "time": self._wall(),
            "generation": generation,
            "workers": sorted(members),
            # Membership COUNT as a first-class metric: the fleet
            # sentinel's worker_absence rule is a window delta over it
            # (a drop means a death or lease expiry — capacity gone).
            "n_workers": len(members),
            # Fleet-wide count of firing worker-level alerts (+ the
            # critical subset) and which worker is firing what.
            "alerts_firing": alerts_firing,
            "alerts_critical": alerts_critical,
            "worker_alerts": worker_alerts,
            "assignments": assignments,
            "pending_release": pending,
            "rebalances": rebalances,
            "expirations": expirations,
            "lease_ttl_sec": self.lease_ttl,
            "global_backlog": global_backlog,
            "peak_global_backlog": self._peak_backlog,
            "backlog_per_worker": (
                round(global_backlog / max(1, len(members)), 1)
                if global_backlog is not None else None),
            "per_worker_backlog": backlogs,
            "shed_total": shed_total,
            "processed_total": processed_total,
            "committed_lag": self.committed_lag(),
            # Fleet-level p50/p99 per pipeline stage: the workers' sketch
            # wires merge LOSSLESSLY (bucket counts add — obs/trace.py),
            # so this equals a single-process run over the same samples.
            # None when no worker is tracing.
            "stage_latency_ms": (fleet_stage_latency(stage_wires)
                                 if stage_wires else None),
            # Who is coordinating, under what term, and how the control
            # lane is faring — the block the sentinel's coordinator
            # rules judge (a frozen ``ticks`` counter IS the absence
            # signal: an interregnum keeps republishing the stale view).
            "coordinator": self._coordinator_block(),
        }
        # Elasticity block (fleet/autoscale/): desired-vs-live capacity,
        # cumulative scale counters the sentinel's autoscale_flap rule
        # windows over, and the last decision with its evidence. Absent
        # (not null) when autoscaling isn't wired, so '+'-joined sentinel
        # paths over the counters abstain instead of reading zeros.
        scale_fn = self.autoscale_stats
        if scale_fn is not None:
            try:
                view["autoscale"] = scale_fn()
            except Exception:  # noqa: BLE001 — observability never kills
                pass
        with self._lock:
            self._last_view = view
        if self.bus is not None:
            self.bus.publish_fleet(view)
        return view

    def _coordinator_block(self) -> dict:
        """The view's ``coordinator`` block (the reference's keys):
        succession identity + liveness + control-lane delivery health."""
        with self._lock:
            ticks = self._ticks
            last = self._last_tick_at
        age = round(self._clock() - last, 6) if last is not None else None
        stats_fn = self.control_stats
        control = None
        if stats_fn is not None:
            try:
                control = stats_fn()
            except Exception:  # noqa: BLE001 — observability never kills
                control = None
        return {
            "term": self.term,
            "leader": self.leader_id,
            "handoffs": self.handoffs,
            "elections": self.elections,
            "ticks": ticks,
            "last_tick_age_s": age,
            "control": control,
        }

    def last_view(self) -> Optional[dict]:
        with self._lock:
            return self._last_view
