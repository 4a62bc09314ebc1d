"""`flightcheck model` — explicit-state model checking of the fleet choreography.
The port's twin of ``fraud_detection_tpu/analysis/checker.py``.

The chaos suite samples a handful of interleavings per seed; this module
checks ALL of them, bounded. It composes the role machines declared in
:data:`~fraud_detection_tpu_torch.analysis.entrypoints.FLEET_PROTOCOLS` —
Coordinator (lease deals, REVOKE BARRIER, expiry, fencing), Worker
(poll/heartbeat/drain/commit/ack/rebuild, crash transitions from the
``WorkerDeathPlan`` fault model), AssignedConsumer (committed-offset
resume, fence-at-commit), Bus (publish folded into the sync step) — with
an environment model (worker crash on the poll path, lease ttl elapsing
and racing renewal), and explores every bounded interleaving breadth-first
in the TLA+/SPIN explicit-state tradition, checking on every edge the
invariants the chaos runs only sample:

* ``no_duplicate`` — no input row's delivery is ever covered by two
  successful offset commits;
* ``no_loss`` — every quiescent run delivered (and committed) every row;
* ``no_zombie_commit`` — a commit never advances a partition its worker no
  longer owns (the fence's whole job);
* ``revoke_barrier`` — a pair's new owner never polls it while a live,
  unexpired previous owner still holds uncommitted read-ahead on it;
* ``no_self_expiry`` — a syncing member never falls to its own expiry scan.

**Fidelity notes** (docs/static_analysis.md "model checking the fleet").
The model follows the code's fault model: crashes fire on the poll path
(``WorkerDeathPlan`` kills before a batch dispatches), so the engine's
produce -> flush -> check -> commit sequence — whose intra-batch shape
FC401-FC403 already pin statically — collapses to one atomic
deliver+commit step with the fence consulted first, exactly the
``InProcessAssignedConsumer._commit_locked`` shape FC503 pins. A fenced
commit matches the engine's real behavior: the incarnation carries on
(``rebalanced_commits``), its outputs stand as documented at-least-once
duplicates, and only *committed* deliveries count toward the
duplicate/loss accounting — which is precisely the key-set invariant
tests/test_torch_fleet.py pins. Lease expiry is untimed: ``lapse`` marks any
member's ttl as elapsed (the zombie-stall adversary), bounded by
``max_lapses`` for live workers and always eventually enabled for crashed
ones (ttl elapsing is inevitable, not an adversary move).

**Reductions.** Two sound ones: (1) *macro-step fusion* (a partial-order
reduction): protocol sequences that are invisible to every other role —
coordinator renew+scan+re-deal inside one ``sync``, ack+release+rebuild,
deliver+fence+commit — execute as single atomic actions, so commuting
intermediate states are never materialized; (2) *worker symmetry*: workers
start identical and the assignor depends only on join order, so states are
canonicalized under worker relabeling (min over all permutations) before
dedup. Budgets (``max_states``, ``max_seconds``) bound the search; BFS
order makes every counterexample a SHORTEST trace.

Seeded **mutations** re-introduce the bugs the choreography exists to
prevent; each must produce a counterexample (tests/test_torch_model_checker.py),
which is the checker's own regression guard:

* ``drop_fence`` — commit never consults the fence (zombie commits land);
* ``skip_revoke_barrier`` — re-deals grant moved pairs immediately;
* ``ack_before_drain`` — the worker releases the barrier before draining;
* ``expire_before_renew`` — the expiry scan runs before the caller's
  renewal (a syncing member can expire itself);
* ``forget_barrier_holds`` — re-deals rebuild holds from the target map
  alone, dropping a still-draining owner's hold (the TRUE POSITIVE this
  checker found in ``FleetCoordinator._rebalance_locked``; fixed in-tree,
  kept here as the regression mutant).

**Succession environment** (docs/fleet.md "Coordinator
succession"). The coordinator itself is a leased role contended by
``candidates`` identical candidates over a lossy control lane, and the
model gains a coordinator dimension with its own fault budget:

* ``coord_crash`` — the leading candidate dies mid-flight (bounded by
  ``max_coord_crashes``); the control plane is leaderless until ``elect``.
* ``coord_lapse`` — the leading candidate stalls past its role lease
  (bounded by ``max_coord_lapses``): it becomes a ZOMBIE coordinator that
  still believes it leads, and its last assignment decision survives as an
  arbitrarily-delayed, duplicable control record.
* ``elect`` — a standby candidate wins the role lease at ``term + 1`` and
  reconstructs members/target/pending from the compacted control topic —
  crucially INHERITING the in-flight revoke-barrier holds and fence state.
* ``stale_assign`` — the zombie's delayed assignment record finally
  arrives; the term fence accepts it only while its term is still
  current, so post-succession it is REJECTED (the epoch-stamped fence).

During an interregnum (no leader) the data plane continues — polls and
commits ride existing leases and the materialized fence — while control
decisions (join/sync/ack/leave/expiry scans) wait for a successor, whose
election is always enabled (``max_coord_crashes + max_coord_lapses <
candidates`` keeps a survivor, mirroring ``max_crashes < workers``).

**Control-lane fault mapping.** Control messages are idempotent,
seq/term-stamped records, so the classic message faults reduce to moves
the model already explores: a LOST or DELAYED worker->coordinator request
is an RPC edge simply not (yet) taken — every such schedule is a BFS
interleaving; a DUPLICATED idempotent record re-applies to a fixed point
(tests/test_torch_succession.py pins per-kind idempotency in the real
transport); and the one *dangerous* delay/duplicate — a superseded
coordinator's assignment decision landing late — is modeled explicitly as
``stale_assign`` against the term fence. The succession mutations
re-introduce the failover bugs the choreography prevents:

* ``drop_coordinator_lease`` — successors claim leadership WITHOUT
  winning the role lease, so the term never advances and the fence cannot
  tell the zombie's delayed decision from the successor's (a same-term
  two-leader split; the stale re-deal resurrects released holds/grants);
* ``stale_term_fence_accepted`` — terms advance but the fence ignores
  them: a zombie coordinator's stale-term decision is applied after
  succession;
* ``forget_holds_on_failover`` — the successor rebuilds assignment state
  from the target map alone, dropping in-flight revoke-barrier holds (the
  failover twin of ``forget_barrier_holds``).

**Elasticity environment** (docs/autoscaling.md). The autoscaler
turns the sentinel signal plane into worker lifecycle decisions, and the
model gains a capacity dimension so those decisions compose with every
fault above. ``spares`` workers start UNPROVISIONED (not yet launched);
``max_scale_ins`` budgets coordinator-requested voluntary leaves:

* ``scale_out`` — the provisioner launches an unprovisioned spare, which
  then joins through the ordinary join path (a replacement for a dead
  worker is exactly this move scheduled after a crash);
* ``scale_in`` — the coordinator marks a member RELEASED and re-deals its
  partitions among the remaining active members — with the moved pairs
  entering the EXISTING revoke barrier held by the released worker, so
  scale-in is provably a voluntary leave through revoke -> drain ->
  commit -> reassign (refused when it would empty the active set);
* ``release`` — the released worker, drained and committed, acks the
  barrier and leaves in one step (the ``FleetWorker`` released-lease
  exit: ack + leave + retract fused, invisible to other roles between).

The elasticity mutation re-introduces the bug the barrier routing
prevents:

* ``release_before_drain`` — the scale-in re-deal grants the released
  worker's pairs to their new owners immediately (its barrier hold is
  dropped), so a new owner polls while the live released owner still
  holds uncommitted read-ahead — the scale-in twin of
  ``skip_revoke_barrier``, and the counterexample CI pins.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from itertools import permutations
from typing import Dict, FrozenSet, Iterator, List, Optional, Tuple

#: Mutations that break a bad-state predicate: the safety search
#: (``check``) must kill each with a shortest counterexample trace.
SAFETY_MUTATIONS: Tuple[str, ...] = (
    "drop_fence", "skip_revoke_barrier", "ack_before_drain",
    "expire_before_renew", "forget_barrier_holds",
    "drop_coordinator_lease", "stale_term_fence_accepted",
    "forget_holds_on_failover", "release_before_drain",
)

#: Mutations that break a PROGRESS property instead: no reachable state is
#: ever bad, but an obligation can now evade discharge forever on a fair
#: cycle. Only the liveness search (``check_liveness``) kills these, each
#: with a stem+cycle lasso — the liveness machinery's own regression
#: guard, mirroring what SAFETY_MUTATIONS is to ``check``:
#:
#: * ``election_ping_pong`` — TOTAL beacon loss eats every claim: a
#:   standby's election never lands, leadership ping-pongs back to vacant,
#:   and ``election_eventually_converges`` dies on the elect cycle;
#: * ``zero_cooldown_flap`` — scale-in decisions cost no budget and the
#:   policy relaunches the workers it just released: scale_in -> drain ->
#:   release -> scale_out -> join repeats forever
#:   (``autoscale_eventually_stabilizes``);
#: * ``drain_requeues_revoke`` — the drain-complete ack re-queues its own
#:   revoke instead of releasing the barrier: the worker re-enters
#:   draining and ``every_drain_eventually_acked`` never discharges.
LIVELOCK_MUTATIONS: Tuple[str, ...] = (
    "election_ping_pong", "zero_cooldown_flap", "drain_requeues_revoke",
)

MUTATIONS: Tuple[str, ...] = SAFETY_MUTATIONS + LIVELOCK_MUTATIONS

INVARIANTS: Tuple[str, ...] = (
    "no_duplicate", "no_loss", "no_zombie_commit", "revoke_barrier",
    "no_self_expiry",
)

#: The "eventually" invariant class (``check_liveness``): progress
#: obligations that a safety search cannot state, checked by LASSO
#: detection — a reachable cycle, fair under the declared weak-fairness
#: constraints, on which the obligation never discharges. Listed in CHECK
#: order, most specific obligation first, so a livelock mutant
#: deterministically names the invariant it was built to break.
EVENTUALLY_INVARIANTS: Tuple[str, ...] = (
    "election_eventually_converges",
    "autoscale_eventually_stabilizes",
    "every_drain_eventually_acked",
    "every_row_eventually_committed",
)

#: checker action -> the FLEET_PROTOCOLS transitions (``Role.name``) each
#: macro-step implements. tests pin that the union covers EVERY spec
#: transition, so the spec, this model, and (through FC501/FC502) the code
#: are one three-way-verified artifact.
ACTION_IMPLEMENTS: Dict[str, Tuple[str, ...]] = {
    "join": ("Worker.join", "Coordinator.join", "AssignedConsumer.resume"),
    "sync": ("Worker.sync", "Coordinator.sync", "Bus.publish"),
    "poll": ("Worker.poll", "AssignedConsumer.poll"),
    "commit": ("Worker.commit", "AssignedConsumer.commit",
               "Coordinator.fence"),
    "ack": ("Worker.ack", "Coordinator.ack", "AssignedConsumer.close",
            "AssignedConsumer.resume"),
    "leave": ("Worker.leave", "Coordinator.leave", "AssignedConsumer.close",
              "Bus.retract"),
    "crash": ("Worker.crash",),
    "lapse": ("Environment.lapse",),
    "tick": ("Coordinator.tick", "Bus.aggregate", "Candidate.lead"),
    "coord_crash": ("Candidate.crash",),
    "coord_lapse": ("Candidate.lapse",),
    "elect": ("Candidate.elect", "Candidate.restore"),
    "stale_assign": ("Candidate.fence",),
    "scale_out": ("Coordinator.scale_out", "Provisioner.launch"),
    "scale_in": ("Coordinator.scale_in",),
    "release": ("Worker.release", "Coordinator.leave",
                "AssignedConsumer.close", "Bus.retract"),
}

#: The actions only a succession configuration (``candidates >= 2`` with a
#: coordinator fault budget) can exercise; the coverage pin unions the
#: default and succession runs (tests/test_torch_model_checker.py).
SUCCESSION_ACTIONS: Tuple[str, ...] = (
    "coord_crash", "coord_lapse", "elect", "stale_assign",
)

#: The actions only an elastic configuration (``spares > 0`` and/or
#: ``max_scale_ins > 0``) can exercise; excluded from the default and
#: succession coverage pins the same way SUCCESSION_ACTIONS is.
AUTOSCALE_ACTIONS: Tuple[str, ...] = (
    "scale_out", "scale_in", "release",
)


@dataclass(frozen=True)
class CheckConfig:
    workers: int = 2
    partitions: int = 2
    keys_per_partition: int = 2
    max_crashes: int = 1
    max_lapses: int = 1
    #: succession dimension: identical candidates contending on the
    #: coordinator role lease. The defaults (one immortal candidate, zero
    #: coordinator fault budget) collapse the coordinator component to a
    #: constant, so the explored state space is byte-identical to the
    #: pre-succession model.
    candidates: int = 1
    max_coord_crashes: int = 0
    max_coord_lapses: int = 0
    #: elasticity dimension: ``spares`` of the ``workers`` start
    #: UNPROVISIONED (scale_out launches them); ``max_scale_ins`` budgets
    #: coordinator-requested voluntary leaves. The defaults (no spares,
    #: no scale-in budget) leave the capacity constant, so the explored
    #: state space matches the pre-elasticity model.
    spares: int = 0
    max_scale_ins: int = 0
    mutations: FrozenSet[str] = frozenset()
    max_states: int = 400_000
    max_seconds: float = 120.0
    symmetry: bool = True

    def validate(self) -> None:
        if self.workers < 1 or self.workers > 4:
            raise ValueError(f"workers must be 1..4, got {self.workers}")
        if self.partitions < 1 or self.partitions > 4:
            raise ValueError(
                f"partitions must be 1..4, got {self.partitions}")
        if self.keys_per_partition < 1 or self.keys_per_partition > 3:
            raise ValueError(
                f"keys_per_partition must be 1..3, got "
                f"{self.keys_per_partition}")
        if self.max_crashes >= self.workers:
            raise ValueError(
                "max_crashes must leave at least one surviving worker "
                f"(got {self.max_crashes} with {self.workers} workers): "
                "the zero-loss guarantee is conditioned on a survivor")
        if self.candidates < 1 or self.candidates > 4:
            raise ValueError(
                f"candidates must be 1..4, got {self.candidates}")
        if self.max_coord_crashes < 0 or self.max_coord_lapses < 0:
            raise ValueError("coordinator fault budgets must be >= 0")
        if self.max_coord_crashes + self.max_coord_lapses \
                >= self.candidates:
            raise ValueError(
                "max_coord_crashes + max_coord_lapses must leave at least "
                f"one never-failing candidate (got "
                f"{self.max_coord_crashes}+{self.max_coord_lapses} with "
                f"{self.candidates} candidates): liveness of the control "
                "plane is conditioned on a survivor, like max_crashes")
        if self.spares < 0 or self.spares >= self.workers:
            raise ValueError(
                f"spares must be 0..workers-1 (got {self.spares} with "
                f"{self.workers} workers): at least one worker starts "
                "provisioned")
        if self.max_scale_ins < 0:
            raise ValueError("max_scale_ins must be >= 0")
        if self.max_crashes + self.max_scale_ins >= self.workers:
            raise ValueError(
                "max_crashes + max_scale_ins must leave at least one "
                f"never-crashed, never-released worker (got "
                f"{self.max_crashes}+{self.max_scale_ins} with "
                f"{self.workers} workers): the zero-loss guarantee is "
                "conditioned on a survivor that can still deliver")
        unknown = set(self.mutations) - set(MUTATIONS)
        if unknown:
            raise ValueError(f"unknown mutations {sorted(unknown)} "
                             f"(known: {list(MUTATIONS)})")


#: The headline succession configuration (CI's failover-smoke, the
#: ``--succession`` CLI preset): W=3/P=3 with a coordinator crash AND a
#: coordinator lapse (so the zombie/stale-delivery edges are explored) on
#: top of one worker crash. ``keys_per_partition=1`` keeps the data plane
#: minimal and ``max_lapses=0`` leaves the worker-stall adversary to the
#: default configuration — the succession interleavings (coordinator
#: death racing join/crash-driven rebalances), not the row volume, are
#: what this configuration exists to cover. Verifies in ~176k states.
SUCCESSION_CONFIG = dict(workers=3, partitions=3, keys_per_partition=1,
                         max_crashes=1, max_lapses=0, candidates=3,
                         max_coord_crashes=1, max_coord_lapses=1)

#: The headline elastic configuration (CI's autoscale-smoke, the
#: ``--autoscale`` CLI preset): one spare to launch (scale_out — which,
#: scheduled after the crash, IS the replacement move), one voluntary
#: leave to request (scale_in -> drain -> release), composed with one
#: worker crash AND one coordinator crash so scale decisions interleave
#: with worker death and failover. ``keys_per_partition=1`` and
#: ``max_lapses=0`` keep the data plane minimal for the same reason as
#: SUCCESSION_CONFIG: the scale interleavings are the point.
AUTOSCALE_CONFIG = dict(workers=3, partitions=2, keys_per_partition=1,
                        max_crashes=1, max_lapses=0, spares=1,
                        max_scale_ins=1, candidates=2,
                        max_coord_crashes=1, max_coord_lapses=0)


@dataclass(frozen=True)
class Step:
    """One trace step: the action label plus its visible effect."""

    actor: str
    action: str
    detail: str


@dataclass(frozen=True)
class Violation:
    invariant: str
    detail: str
    trace: Tuple[Step, ...]


@dataclass
class CheckResult:
    ok: bool
    violation: Optional[Violation]
    states: int
    transitions: int
    depth: int
    elapsed: float
    budget_exhausted: bool = False
    budget_reason: str = ""
    coverage: Dict[str, int] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# state encoding
#
# state = (members, stale, target, pending, committed, workers,
#          crashes, lapses, coord)
#   members:  tuple[int]      membership in JOIN ORDER (the assignor's key)
#   stale:    tuple[int]      members whose lease ttl has elapsed, sorted
#   target:   tuple[int]*P    authoritative owner per partition (-1 none)
#   pending:  tuple[int]*P    live holder draining the pair (-1 none)
#   committed:tuple[int]*P    group-durable committed offset
#   workers:  tuple[W] of (wstate, lease, pos, base, zombie, released)
#             wstate: u/i/r/d/c/l (unprovisioned init running draining
#                     crashed left) — "u" is a spare the provisioner has
#                     not launched yet (scale_out flips it to "i")
#             lease:  tuple[int] partitions of the CURRENT incarnation's
#                     consumer (the worker's possibly-stale local view)
#             pos/base: tuple[int]*P, -1 outside the lease; read-ahead on
#                     p is the window [base[p], pos[p])
#             zombie: True from lease expiry until the next rebuild —
#                     its stale read-ahead is written off (expiry IS the
#                     barrier for an expired owner) and its re-deliveries
#                     are the DOCUMENTED at-least-once duplicates, exempt
#                     from the committed-coverage dup accounting
#             released: True from the coordinator's scale_in request
#                     until the voluntary leave completes — a released
#                     member keeps its barrier holds (it must drain and
#                     commit first) but is excluded from every re-deal
#   crashes, lapses: environment budget spent
#   coord:    (leading, standby, zombie, term, ccrashes, clapses,
#              scale_ins)
#             leading: 1 while a live candidate holds the coordinator
#                     role lease, 0 during an interregnum
#             standby: count of standby candidates (candidates are
#                     identical, so only the COUNT matters — a sound
#                     symmetry by construction; elections resolve
#                     deterministically to "some standby wins")
#             zombie: None, or (zterm, ztarget, zpending) — a lapsed
#                     leader's identity plus the assignment decision it
#                     may still deliver late (the delayed/duplicated
#                     control record); one-shot, spent by stale_assign
#             term:   the epoch the authoritative term fence currently
#                     accepts; elect advances it (Kafka controller-epoch
#                     style), so a zombie's zterm < term is rejectable
#             ccrashes, clapses: coordinator fault budget spent
#             scale_ins: elasticity budget spent (voluntary leaves
#                     requested; scale_out needs no counter — each spare
#                     can launch exactly once)
#
# Delivery accounting rides ``committed`` alone: a success commit covers
# exactly the rows it newly advances past (each row exactly once, by
# monotonicity), so no_loss is "quiescent with committed < K" and
# no_duplicate is "a live, unexpired worker success-commits a window
# overlapping rows already covered" — the committed key-set accounting
# tests/test_torch_fleet.py pins, with the zombie-stall at-least-once caveat
# exempted explicitly instead of hidden.
# ---------------------------------------------------------------------------

_UNPROV, _INIT, _RUN, _DRAIN, _CRASH, _LEFT = "u", "i", "r", "d", "c", "l"


def _initial_state(cfg: CheckConfig):
    P = cfg.partitions
    live = (_INIT, (), (-1,) * P, (-1,) * P, False, False)
    spare = (_UNPROV, (), (-1,) * P, (-1,) * P, False, False)
    active = cfg.workers - cfg.spares
    # Candidate 0 holds the role lease from the start (the bootstrap
    # election is uncontended); the rest stand by.
    coord = (1, cfg.candidates - 1, None, 0, 0, 0, 0)
    return (
        (),                       # members
        (),                       # stale
        (-1,) * P,                # target
        (-1,) * P,                # pending
        (0,) * P,                 # committed
        tuple(live if i < active else spare for i in range(cfg.workers)),
        0, 0,
        coord,
    )


def _relabel(state, perm):
    """Apply worker permutation ``perm`` (old id -> new id). Join order is
    positional, so the members tuple keeps its order with ids mapped —
    relabeling is an automorphism of the deterministic assignor. The
    coordinator component names no worker ids except inside the zombie's
    captured assignment, which must relabel with the rest."""
    (members, stale, target, pending, committed, workers, cr, la,
     coord) = state
    inv = [0] * len(perm)
    for old, new in enumerate(perm):
        inv[new] = old
    leading, standby, zombie, term, ccr, cla, sins = coord
    if zombie is not None and zombie[1] is not None:
        zterm, ztarget, zpending = zombie
        zombie = (zterm,
                  tuple(perm[w] if w >= 0 else -1 for w in ztarget),
                  tuple(perm[w] if w >= 0 else -1 for w in zpending))
    return (
        tuple(perm[w] for w in members),
        tuple(sorted(perm[w] for w in stale)),
        tuple(perm[w] if w >= 0 else -1 for w in target),
        tuple(perm[w] if w >= 0 else -1 for w in pending),
        committed,
        tuple(workers[inv[new]] for new in range(len(workers))),
        cr, la,
        (leading, standby, zombie, term, ccr, cla, sins),
    )


def _canonical(state, cfg: CheckConfig):
    if not cfg.symmetry or cfg.workers == 1:
        return state
    return min(_relabel(state, perm)
               for perm in permutations(range(cfg.workers)))


# ---------------------------------------------------------------------------
# coordinator internals (pure functions over the state fields)
# ---------------------------------------------------------------------------

def _rebalance(members, old_target, old_pending, P, mutations,
               released=frozenset(), leases=None):
    """The balanced-sticky re-deal, mirroring
    ``FleetCoordinator._rebalance_locked`` (with the barrier-hold
    persistence fix; ``forget_barrier_holds`` restores the pre-fix shape,
    ``skip_revoke_barrier`` drops the barrier entirely). ``released``
    members — a coordinator-requested voluntary leave in flight — are
    excluded from the DEAL but remain eligible barrier HOLDERS until they
    drain and ack; ``release_before_drain`` drops exactly that hold (the
    scale-in twin of ``skip_revoke_barrier``).

    ``leases`` (per-worker issued-lease tuples) gates NEW holds: a hold
    protects uncommitted read-ahead, which only an owner whose issued
    lease actually covered the pair can have. A pair that merely
    TRANSITED a member's target between two of its syncs (an expired
    peer's pair parked on it, then re-dealt away before it ever synced)
    leaves nothing to drain — and a phantom hold for it is never acked,
    withholding the pair from its new owner forever. Found by
    ``check_liveness`` as an ``every_row_eventually_committed`` lasso;
    fixed in ``FleetCoordinator._rebalance_locked`` (the ``_issued``
    map), kept here as the model's faithful mirror."""
    deal = tuple(m for m in members if m not in released)
    holders = set(deal) if "release_before_drain" in mutations \
        else set(members)
    target = [-1] * P
    if deal:
        base_share, extra = divmod(P, len(deal))
        share = {w: base_share + (1 if i < extra else 0)
                 for i, w in enumerate(deal)}
        kept = {w: 0 for w in deal}
        pool = []
        for p in range(P):                # partition order: deterministic
            w = old_target[p]
            if w in share and kept[w] < share[w]:
                target[p] = w
                kept[w] += 1
            else:
                pool.append(p)
        for w in deal:                    # join order: deterministic
            take = share[w] - kept[w]
            while take > 0 and pool:
                target[pool.pop(0)] = w
                take -= 1
    pending = [-1] * P
    if "skip_revoke_barrier" not in mutations:
        for p in range(P):
            w = target[p]
            if "forget_barrier_holds" in mutations:
                holder = old_target[p]
            elif old_pending[p] >= 0:
                holder = old_pending[p]       # existing holds outlive deals
            else:
                holder = old_target[p]
                if holder >= 0 and leases is not None \
                        and p not in leases[holder]:
                    holder = -1               # never issued: no read-ahead
                                              # to protect, no phantom hold
            # An UNOWNED pair (w == -1: the deal has nobody to give it
            # to yet) still keeps its live holder's barrier hold — the
            # hold protects the pair's NEXT owner, whoever that is.
            if holder not in (-1, w) and holder in holders:
                pending[p] = holder
    return tuple(target), tuple(pending)


def _release_holds(pending, wid):
    return tuple(-1 if h == wid else h for h in pending)


def _granted(target, pending, wid) -> Tuple[Tuple[int, ...], bool]:
    """(granted partitions, any-withheld) for ``wid`` — the Lease shape."""
    granted, withheld = [], False
    for p, owner in enumerate(target):
        if owner != wid:
            continue
        if pending[p] in (-1, wid):
            granted.append(p)
        else:
            withheld = True
    return tuple(granted), withheld


def _coord_sync(members, stale, target, pending, wid, mutations,
                released=frozenset(), leases=None):
    """join/sync(wid): renew-then-scan (or the mutant's scan-then-renew),
    re-deal when membership changed. Returns the updated fields plus the
    id the scan expired-of-itself (the no_self_expiry witness) and the
    list of expired members."""
    members = list(members)
    stale_set = set(stale)
    self_expired = False
    changed = False

    def scan():
        nonlocal members, pending, changed
        expired = [m for m in members if m in stale_set]
        for e in expired:
            members.remove(e)
            stale_set.discard(e)
            pending = _release_holds(pending, e)
        if expired:
            changed = True
        return expired

    if "expire_before_renew" in mutations:
        expired = scan()
        self_expired = wid in expired
        stale_set.discard(wid)
        if wid not in members:
            members.append(wid)
            changed = True
    else:
        stale_set.discard(wid)            # renew the caller FIRST
        if wid not in members:
            members.append(wid)
            changed = True
        expired = scan()

    if changed:
        target, pending = _rebalance(tuple(members), target, pending,
                                     len(target), mutations, released,
                                     leases)
    return (tuple(members), tuple(sorted(stale_set)), target, pending,
            expired, self_expired)


def _mark_zombies(workers, expired):
    if not expired:
        return workers
    out = list(workers)
    for e in expired:
        wstate, lease, pos, base, _, rel = out[e]
        out[e] = (wstate, lease, pos, base, True, rel)
    return tuple(out)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class FleetModel:
    """Successor generator + invariant oracle for one configuration."""

    def __init__(self, cfg: CheckConfig):
        cfg.validate()
        self.cfg = cfg
        self.mut = cfg.mutations

    def initial(self):
        return _initial_state(self.cfg)

    # -- helpers -----------------------------------------------------------

    def _read_ahead(self, worker) -> List[Tuple[int, int, int]]:
        """[(p, base, pos)] windows with uncommitted read-ahead."""
        _, lease, pos, base, _, _ = worker
        return [(p, base[p], pos[p]) for p in lease if pos[p] > base[p]]

    def _rebuild_worker(self, committed, granted, released=False):
        P = self.cfg.partitions
        pos = tuple(committed[p] if p in granted else -1 for p in range(P))
        return (_RUN, tuple(sorted(granted)), pos, pos, False, released)

    # -- successors --------------------------------------------------------

    def successors(self, state) -> Iterator[Tuple[Step, object,
                                                  Optional[Violation]]]:
        """Yield (step, next_state, violation). A violation ends the
        search; its step is included in the trace."""
        (members, stale, target, pending, committed, workers,
         crashes, lapses, coord) = state
        cfg, P, K = self.cfg, self.cfg.partitions, self.cfg.keys_per_partition
        leading, standby, czombie, term, ccrashes, clapses, scale_ins = coord
        released_set = frozenset(i for i, w in enumerate(workers) if w[5])
        # Issued leases per worker (the coordinator's ``_issued`` map):
        # gates NEW barrier holds in every re-deal below.
        leases = tuple(w[1] for w in workers)
        # Control-plane RPCs (join/sync/ack/leave, the expiry scan) need a
        # live leader; the data plane (poll/commit on existing leases, the
        # materialized fence) rides out an interregnum. A lost or delayed
        # control request is indistinguishable from the RPC edge not yet
        # being scheduled, so message loss/delay on the control lane is
        # covered by the interleavings themselves.
        have_leader = leading == 1

        for wid, worker in enumerate(workers):
            wstate, lease, pos, base, zombie, rel = worker
            actor = f"w{wid}"

            # ---- unprovisioned spare: only scale_out (below) launches it
            if wstate == _UNPROV:
                continue

            # ---- join: init -> running (waits out an interregnum) ------
            if wstate == _INIT:
                if have_leader:
                    m2, s2, t2, p2, expired, self_exp = _coord_sync(
                        members, stale, target, pending, wid, self.mut,
                        released_set, leases)
                    w2 = _mark_zombies(workers, expired)
                    granted, _ = _granted(t2, p2, wid)
                    w2 = list(w2)
                    w2[wid] = self._rebuild_worker(committed, granted)
                    nxt = (m2, s2, t2, p2, committed, tuple(w2),
                           crashes, lapses, coord)
                    yield (Step(actor, "join",
                                f"joins; lease {{{_pp(granted)}}} (consumer "
                                f"resumes from committed offsets)"),
                           nxt, None)
                continue

            if wstate in (_CRASH, _LEFT):
                # A hard-crashed member's ttl elapsing is inevitable (the
                # fairness assumption, not an adversary move): always
                # enabled, outside the lapse budget.
                if wstate == _CRASH and wid in members and wid not in stale:
                    s2 = tuple(sorted(set(stale) | {wid}))
                    nxt = (members, s2, target, pending, committed,
                           workers, crashes, lapses, coord)
                    yield (Step(actor, "lapse",
                                f"lease ttl elapses for dead {actor}"),
                           nxt, None)
                continue

            # ---- sync: heartbeat + lease refresh (running only; a
            # draining engine no longer polls). During an interregnum the
            # heartbeat goes unanswered: the worker keeps its current
            # lease and the data plane carries on below. -------------------
            if wstate == _RUN and have_leader:
                m2, s2, t2, p2, expired, self_exp = _coord_sync(
                    members, stale, target, pending, wid, self.mut,
                    released_set, leases)
                w2 = list(_mark_zombies(workers, expired))
                granted, withheld = _granted(t2, p2, wid)
                detail = f"heartbeat; lease {{{_pp(granted)}}}"
                violation = None
                if self_exp:
                    violation = Violation(
                        "no_self_expiry",
                        f"{actor}'s own sync expired it: the expiry scan "
                        f"ran before the caller's renewal, so a live, "
                        f"syncing member lost its lease to itself",
                        ())
                if set(granted) != set(lease) or withheld or rel:
                    # revoke detected (a released member's lease is
                    # revoked WHOLESALE): stop the engine, drain
                    if "ack_before_drain" in self.mut:
                        p2 = _release_holds(p2, wid)
                        detail += ("; lease changed -> ACKS THE BARRIER "
                                   "EARLY, then drains")
                    elif rel:
                        detail += ("; lease RELEASED by the scale-in "
                                   "request -> stops engine, drains "
                                   "in-flight")
                    else:
                        detail += ("; lease changed -> stops engine, "
                                   "drains in-flight")
                    w2[wid] = (_DRAIN, lease, pos, base, zombie, rel)
                else:
                    w2[wid] = (_RUN, lease, pos, base, zombie, rel)
                nxt = (m2, s2, t2, p2, committed, tuple(w2),
                       crashes, lapses, coord)
                yield Step(actor, "sync", detail), nxt, violation

            if wstate == _RUN:
                # ---- poll: one row from one granted partition ----------
                for p in lease:
                    if pos[p] >= K:
                        continue
                    violation = None
                    if target[p] == wid and pending[p] == -1:
                        # wid is the pair's authoritative owner: the
                        # barrier says no live unexpired previous owner
                        # may still hold uncommitted read-ahead on it.
                        for hid, other in enumerate(workers):
                            if hid == wid or hid not in members:
                                continue
                            ostate, olease, opos, obase, ozombie, _ = other
                            if ozombie or p not in olease:
                                continue
                            if opos[p] > obase[p]:
                                violation = Violation(
                                    "revoke_barrier",
                                    f"{actor} polls p{p} (granted by the "
                                    f"coordinator) while live member "
                                    f"w{hid} still holds uncommitted "
                                    f"read-ahead p{p}:[{obase[p]},"
                                    f"{opos[p]}) and never commit-acked "
                                    f"— the REVOKE BARRIER",
                                    ())
                                break
                    w2 = list(workers)
                    pos2 = list(pos)
                    pos2[p] += 1
                    w2[wid] = (_RUN, lease, tuple(pos2), base, zombie, rel)
                    nxt = (members, stale, target, pending, committed,
                           tuple(w2), crashes, lapses, coord)
                    yield (Step(actor, "poll",
                                f"polls p{p} offset {pos[p]}"),
                           nxt, violation)

            # ---- commit: deliver + fence + advance (atomic; the
            # produce->flush->check->commit shape FC401 pins) --------------
            if wstate in (_RUN, _DRAIN):
                windows = self._read_ahead(worker)
                if windows:
                    # committable = granted-or-held: the pair's barrier
                    # hold is mine, or I'm the target with NO peer hold
                    # outstanding (a withheld target pair is the HOLDER's
                    # to commit until it acks — fence fix, see
                    # FleetCoordinator.fence_lost).
                    def committable(p, w=wid):
                        return pending[p] == w or (target[p] == w
                                                  and pending[p] == -1)

                    fenced = [p for p, _, _ in windows if not committable(p)]
                    if "drop_fence" in self.mut:
                        fenced = []
                    base2 = list(base)
                    for p, b, q in windows:
                        base2[p] = q
                    w2 = list(workers)
                    w2[wid] = (wstate, lease, pos, tuple(base2), zombie,
                               rel)
                    span = ", ".join(f"p{p}:[{b},{q})"
                                     for p, b, q in windows)
                    if fenced:
                        # CommitFailedError: nothing advances; the engine
                        # carries on (rebalanced_commits) and the rows
                        # stand as documented at-least-once duplicates.
                        nxt = (members, stale, target, pending, committed,
                               tuple(w2), crashes, lapses, coord)
                        yield (Step(actor, "commit",
                                    f"commit of {span} FENCED (lease "
                                    f"revoked for "
                                    f"{_pp(fenced, prefix='p')}); offsets "
                                    f"stay; outputs stand as at-least-"
                                    f"once duplicates"),
                               nxt, None)
                    else:
                        violation = None
                        rogue = [p for p, _, _ in windows
                                 if not committable(p)]
                        if rogue:
                            violation = Violation(
                                "no_zombie_commit",
                                f"{actor} committed "
                                f"{_pp(rogue, prefix='p')} it no longer "
                                f"owns (lease expired/revoked, fence "
                                f"absent) — offsets advanced for a "
                                f"partition someone else is "
                                f"authoritative for",
                                ())
                        # Committed-coverage accounting: each row is
                        # covered by exactly the commit that advances past
                        # it. A live, UNEXPIRED worker success-committing
                        # a window overlapping already-covered rows means
                        # the choreography let two owners both deliver and
                        # both durably commit — the zero-dup breach. A
                        # zombie's re-coverage (stall -> expiry -> pair
                        # re-granted on rejoin) is the DOCUMENTED
                        # at-least-once duplicate and exempt.
                        committed2 = list(committed)
                        for p, b, q in windows:
                            if b < committed2[p] and not zombie \
                                    and violation is None:
                                violation = Violation(
                                    "no_duplicate",
                                    f"rows p{p}:[{b},"
                                    f"{min(q, committed2[p])}) were "
                                    f"already covered by a successful "
                                    f"commit, and live unexpired {actor} "
                                    f"delivered + committed them AGAIN — "
                                    f"two owners durably committed the "
                                    f"same rows (zero-dup broken)",
                                    ())
                            committed2[p] = max(committed2[p], q)
                        nxt = (members, stale, target, pending,
                               tuple(committed2),
                               tuple(w2), crashes, lapses, coord)
                        yield (Step(actor, "commit",
                                    f"delivers + commits {span}"),
                               nxt, violation)

            # ---- ack: drain complete -> release barrier, rebuild -------
            if wstate == _DRAIN and not rel and have_leader \
                    and not self._read_ahead(worker) \
                    and "drain_requeues_revoke" in self.mut:
                # Livelock mutant: the drain-complete ack RE-QUEUES its
                # own revoke instead of releasing the barrier — the hold
                # is restored verbatim and the worker re-enters draining,
                # so the drain obligation never discharges.
                yield (Step(actor, "ack",
                            "drained + committed: acks the barrier, but "
                            "the BROKEN ack path re-queues its own revoke "
                            "— the hold is restored and the worker is "
                            "back in draining"),
                       state, None)
            elif wstate == _DRAIN and not rel and have_leader \
                    and not self._read_ahead(worker):
                p2 = _release_holds(pending, wid)
                s2 = tuple(x for x in stale if x != wid)   # ack renews
                granted, _ = _granted(target, p2, wid)
                w2 = list(workers)
                w2[wid] = self._rebuild_worker(committed, granted)
                nxt = (members, s2, target, p2, committed,
                       tuple(w2), crashes, lapses, coord)
                yield (Step(actor, "ack",
                            f"drained + committed: acks the barrier, "
                            f"rebuilds on lease {{{_pp(granted)}}}"),
                       nxt, None)

            # ---- release: a RELEASED member's drain completed -> it acks
            # the barrier and leaves in one step (the FleetWorker
            # released-lease exit: ack + leave + retract fused; no
            # re-deal needed — a released member was already excluded
            # from every deal, so its departure moves no pairs) ----------
            if wstate == _DRAIN and rel and wid in members \
                    and have_leader and not self._read_ahead(worker):
                p2 = _release_holds(pending, wid)
                m2 = tuple(m for m in members if m != wid)
                s2 = tuple(x for x in stale if x != wid)
                w2 = list(workers)
                w2[wid] = (_LEFT, (), (-1,) * P, (-1,) * P, False, False)
                nxt = (m2, s2, target, p2, committed, tuple(w2),
                       crashes, lapses, coord)
                yield (Step(actor, "release",
                            "drained + committed under the scale-in "
                            "request: acks the barrier and leaves "
                            "voluntarily (its pairs' new owners may now "
                            "poll)"),
                       nxt, None)

            # ---- leave: drain-run idle exit ----------------------------
            if wstate == _RUN and have_leader \
                    and all(pos[p] >= K and base[p] == pos[p]
                            for p in lease) \
                    and all(c >= K for c in committed):
                m2 = tuple(m for m in members if m != wid)
                s2 = tuple(x for x in stale if x != wid)
                t2, p2 = target, _release_holds(pending, wid)
                if wid in members:
                    t2, p2 = _rebalance(m2, t2, p2, P, self.mut,
                                        released_set, leases)
                w2 = list(workers)
                w2[wid] = (_LEFT, (), (-1,) * P, (-1,) * P, False, False)
                nxt = (m2, s2, t2, p2, committed, tuple(w2),
                       crashes, lapses, coord)
                yield (Step(actor, "leave",
                            "input idle and group lag 0: leaves "
                            "gracefully (partitions reassign immediately)"),
                       nxt, None)

            # ---- idle incarnation, group lag remains: ack + rebuild ----
            # (FleetWorker._run's loop: engine.run exits idle, the lag
            # probe says the fleet still owes committed work — e.g. this
            # worker's own fenced-away rows, or a dead peer's partitions —
            # so it rebuilds a FRESH consumer resuming from the committed
            # offsets instead of leaving. The at-least-once recovery.)
            if wstate == _RUN and have_leader \
                    and all(pos[p] >= K and base[p] == pos[p]
                            for p in lease) \
                    and any(c < K for c in committed):
                p2 = _release_holds(pending, wid)
                s2 = tuple(x for x in stale if x != wid)   # ack renews
                granted, _ = _granted(target, p2, wid)
                if set(granted) != set(lease) \
                        or any(committed[p] < pos[p] for p in granted):
                    w2 = list(workers)
                    w2[wid] = self._rebuild_worker(committed, granted,
                                                   released=rel)
                    nxt = (members, s2, target, p2, committed,
                           tuple(w2), crashes, lapses, coord)
                    yield (Step(actor, "ack",
                                f"incarnation idle but group lag remains: "
                                f"acks + rebuilds a fresh consumer on "
                                f"lease {{{_pp(granted)}}} from the "
                                f"committed offsets"),
                           nxt, None)

            # ---- crash: the WorkerDeathPlan, on the poll path ----------
            if wstate in (_RUN, _DRAIN) and crashes < cfg.max_crashes:
                w2 = list(workers)
                w2[wid] = (_CRASH, lease, pos, base, zombie, rel)
                nxt = (members, stale, target, pending, committed,
                       tuple(w2), crashes + 1, lapses, coord)
                yield (Step(actor, "crash",
                            "KILLED (crash mode): stops heartbeating; "
                            "read-ahead dies with it; lease must expire"),
                       nxt, None)
                # graceful death: the plan releases the lease NOW (the
                # leave RPC needs a leader; leaderless, only the hard
                # crash above is possible)
                if have_leader:
                    m2 = tuple(m for m in members if m != wid)
                    s2 = tuple(x for x in stale if x != wid)
                    t2, p2 = target, _release_holds(pending, wid)
                    if wid in members:
                        t2, p2 = _rebalance(m2, t2, p2, P, self.mut,
                                            released_set, leases)
                    w2 = list(workers)
                    w2[wid] = (_CRASH, (), (-1,) * P, (-1,) * P, False,
                               False)
                    nxt = (m2, s2, t2, p2, committed, tuple(w2),
                           crashes + 1, lapses, coord)
                    yield (Step(actor, "crash",
                                "KILLED (graceful mode): leaves the group; "
                                "partitions reassign immediately"),
                           nxt, None)

            # ---- lapse: a LIVE worker stalls past its ttl (the zombie
            # adversary, budgeted; dead workers' lapse is handled above) --
            if wid in members and wid not in stale \
                    and lapses < cfg.max_lapses:
                s2 = tuple(sorted(set(stale) | {wid}))
                nxt = (members, s2, target, pending, committed,
                       workers, crashes, lapses + 1, coord)
                yield (Step(actor, "lapse",
                            f"lease ttl elapses for {actor} (stalled; "
                            f"expiry races its renewal)"),
                       nxt, None)

        # ---- tick: the monitor thread's expiry scan (leader-only) -------
        expired = [m for m in members if m in stale]
        if expired and have_leader:
            m2 = tuple(m for m in members if m not in expired)
            p2 = pending
            for e in expired:
                p2 = _release_holds(p2, e)
            t2, p2 = _rebalance(m2, target, p2, P, self.mut, released_set,
                                leases)
            w2 = _mark_zombies(workers, expired)
            nxt = (m2, (), t2, p2, committed, w2, crashes, lapses, coord)
            yield (Step("coord", "tick",
                        f"monitor tick expires "
                        f"{', '.join(f'w{e}' for e in expired)}: leases "
                        f"released, partitions re-dealt (expiry IS the "
                        f"dead owner's barrier)"),
                   nxt, None)

        # ---- the elasticity environment ---------------------------------
        # scale_out: the provisioner launches an unprovisioned spare; it
        # then joins through the ordinary join path. Scheduled after a
        # crash this IS the replacement move; nondeterministic scheduling
        # explores every policy timing. Leader-fenced: scale decisions
        # are coordinator control-plane moves.
        if have_leader:
            for wid, worker in enumerate(workers):
                # Livelock mutant: a zero-cooldown policy will relaunch
                # the very worker it just released — the scale decisions
                # chase each other and capacity flaps forever.
                flap = ("zero_cooldown_flap" in self.mut
                        and worker[0] == _LEFT)
                if worker[0] != _UNPROV and not flap:
                    continue
                w2 = list(workers)
                w2[wid] = (_INIT, (), (-1,) * P, (-1,) * P, False, False)
                nxt = (members, stale, target, pending, committed,
                       tuple(w2), crashes, lapses, coord)
                detail = (f"policy scales OUT with ZERO COOLDOWN: the "
                          f"provisioner relaunches w{wid}, the worker the "
                          f"policy itself just released"
                          if flap else
                          f"policy scales OUT: the provisioner launches "
                          f"spare w{wid}, which will join through the "
                          f"ordinary join path")
                yield Step("coord", "scale_out", detail), nxt, None

        # scale_in: the coordinator marks a member RELEASED and re-deals
        # its pairs among the remaining active members — moved pairs enter
        # the EXISTING revoke barrier held by the released worker, so the
        # voluntary leave drains + commits before its pairs' new owners
        # may poll (release_before_drain drops that hold). Refused when it
        # would leave fewer than one active member — the same refusal
        # FleetCoordinator.request_release implements.
        if have_leader and scale_ins < cfg.max_scale_ins:
            active = [m for m in members if m not in released_set]
            if len(active) >= 2:
                for wid in active:
                    rel2 = released_set | {wid}
                    t2, p2 = _rebalance(members, target, pending, P,
                                        self.mut, rel2, leases)
                    w2 = list(workers)
                    ws, wl, wpos, wbase, wz, _ = workers[wid]
                    w2[wid] = (ws, wl, wpos, wbase, wz, True)
                    # Livelock mutant: scale-in decisions cost no budget
                    # (the zero-cooldown policy never runs out of them).
                    spent_in = 0 if "zero_cooldown_flap" in self.mut else 1
                    c2 = (leading, standby, czombie, term, ccrashes,
                          clapses, scale_ins + spent_in)
                    nxt = (members, stale, t2, p2, committed, tuple(w2),
                           crashes, lapses, c2)
                    yield (Step("coord", "scale_in",
                                f"policy scales IN: w{wid} is RELEASED — "
                                f"its pairs re-deal to the remaining "
                                f"members behind the revoke barrier, and "
                                f"it must drain + commit before leaving"),
                           nxt, None)

        # ---- the succession environment ---------------------------------
        # coord_crash: the leading candidate dies mid-flight.
        if have_leader and ccrashes < cfg.max_coord_crashes:
            c2 = (0, standby, czombie, term, ccrashes + 1, clapses,
                  scale_ins)
            nxt = (members, stale, target, pending, committed, workers,
                   crashes, lapses, c2)
            yield (Step("coord", "coord_crash",
                        "coordinator CRASHES mid-flight: beacons stop, "
                        "the control plane is leaderless until a "
                        "successor claims the role lease"),
                   nxt, None)

        # coord_lapse: the leading candidate stalls past its role lease.
        # It becomes a zombie that still believes it leads; its last
        # assignment decision is captured as the delayed control record it
        # may still deliver (stale_assign below). SNAPSHOT REDUCTION: with
        # an intact fence, the record is accepted only while its term is
        # current, i.e. before any elect — and leaderless, no control edge
        # can change target/pending, so the captured decision provably
        # equals the live one and need not be carried in the state. Only
        # the fence-breaking mutations make the snapshot observable.
        if have_leader and clapses < cfg.max_coord_lapses:
            if self.mut & {"drop_coordinator_lease",
                           "stale_term_fence_accepted"}:
                snap = (term, target, pending)
            else:
                snap = (term, None, None)
            c2 = (0, standby, snap, term, ccrashes, clapses + 1,
                  scale_ins)
            nxt = (members, stale, target, pending, committed, workers,
                   crashes, lapses, c2)
            yield (Step("coord", "coord_lapse",
                        f"coordinator stalls past its role lease at term "
                        f"{term}: it is now a ZOMBIE leader whose last "
                        f"assignment decision may still arrive late"),
                   nxt, None)

        # elect: a standby candidate claims the role lease and
        # reconstructs assignment state from the compacted control topic —
        # inheriting members, target AND the in-flight revoke-barrier
        # holds/fence state. Winning the lease advances the term, so the
        # fence can reject the superseded leader's late decisions
        # (drop_coordinator_lease skips the lease CAS: no term advance;
        # forget_holds_on_failover drops the inherited holds).
        if not have_leader and standby > 0 \
                and "election_ping_pong" in self.mut:
            # Livelock mutant: TOTAL beacon loss eats the claim. The
            # standby wins the CAS but no peer (nor the standby itself)
            # ever observes the win, so it steps straight back to standby
            # and the role stays vacant — the election is a self-loop
            # that can repeat forever.
            yield (Step("coord", "elect",
                        f"standby candidate claims the vacant role at "
                        f"term {term + 1}, but TOTAL BEACON LOSS eats the "
                        f"claim: no peer observes the win, the claimer "
                        f"hears no echo of its own beacon and steps back "
                        f"to standby — the role is vacant again"),
                   state, None)
        elif not have_leader and standby > 0:
            term2 = term if "drop_coordinator_lease" in self.mut \
                else term + 1
            p2 = pending
            detail = (f"standby candidate wins the coordinator lease at "
                      f"term {term2}; restores members/target/pending "
                      f"from the compacted control topic (barrier holds "
                      f"and fence state INHERITED)")
            if "forget_holds_on_failover" in self.mut:
                p2 = (-1,) * P
                detail = (f"standby candidate wins the coordinator lease "
                          f"at term {term2}; restores from the target map "
                          f"alone — DROPS the in-flight revoke-barrier "
                          f"holds")
            if "drop_coordinator_lease" in self.mut:
                detail = (f"standby candidate seizes leadership WITHOUT "
                          f"the role lease: the term stays {term2}, so "
                          f"the fence cannot tell its decisions from the "
                          f"old leader's")
            c2 = (1, standby - 1, czombie, term2, ccrashes, clapses,
                  scale_ins)
            nxt = (members, stale, target, p2, committed, workers,
                   crashes, lapses, c2)
            yield Step("coord", "elect", detail), nxt, None

        # stale_assign: the zombie's delayed assignment record arrives.
        # The term fence accepts it only while its term is still current
        # (pre-succession it is a harmless no-op republish; post-
        # succession zterm < term and it is REJECTED) — unless
        # stale_term_fence_accepted breaks the fence, or
        # drop_coordinator_lease left the terms indistinguishable.
        if czombie is not None:
            zterm, ztarget, zpending = czombie
            spent = (leading, standby, None, term, ccrashes, clapses,
                     scale_ins)
            if zterm >= term or "stale_term_fence_accepted" in self.mut:
                # With no snapshot carried (clean model), the accepted
                # record provably republishes the live assignment — apply
                # is the identity (see the reduction note at coord_lapse).
                t2 = target if ztarget is None else ztarget
                p2 = pending if zpending is None else zpending
                nxt = (members, stale, t2, p2, committed,
                       workers, crashes, lapses, spent)
                yield (Step("coord", "stale_assign",
                            f"the zombie coordinator's term-{zterm} "
                            f"assignment decision arrives late and the "
                            f"fence APPLIES it (current term {term}) — "
                            f"target/pending revert to the superseded "
                            f"deal"),
                       nxt, None)
            else:
                nxt = (members, stale, target, pending, committed,
                       workers, crashes, lapses, spent)
                yield (Step("coord", "stale_assign",
                            f"the zombie coordinator's term-{zterm} "
                            f"assignment decision arrives late and the "
                            f"term fence REJECTS it (current term "
                            f"{term})"),
                       nxt, None)

    # -- terminal loss check ----------------------------------------------

    def quiescent_loss(self, state) -> Optional[Violation]:
        """In a state with no enabled actions (or only self-loops), every
        row must have been delivered under a successful commit."""
        committed = state[4]
        K = self.cfg.keys_per_partition
        missing = {p: K - c for p, c in enumerate(committed) if c < K}
        if not missing:
            return None
        spans = ", ".join(f"p{p}:[{K - n},{K})" for p, n in missing.items())
        return Violation(
            "no_loss",
            f"the run went quiescent with {sum(missing.values())} row(s) "
            f"never delivered under a successful commit ({spans}) — keys "
            f"lost",
            ())


def _pp(items, prefix="p") -> str:
    return ", ".join(f"{prefix}{p}" for p in items)


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def check(cfg: CheckConfig) -> CheckResult:
    """Exhaustive bounded BFS over the composed model. Counterexamples are
    shortest traces by construction."""
    model = FleetModel(cfg)
    start = time.perf_counter()
    init = _canonical(model.initial(), cfg)
    visited = {init}
    # parent pointers for trace reconstruction
    parents: Dict[object, Tuple[object, Step]] = {}
    frontier = [init]
    states = 1
    transitions = 0
    depth = 0
    coverage: Dict[str, int] = {}

    def trace_to(state, last_step: Step) -> Tuple[Step, ...]:
        steps = [last_step]
        cur = state
        while cur in parents:
            cur, step = parents[cur]
            steps.append(step)
        return tuple(reversed(steps))

    while frontier:
        depth += 1
        nxt_frontier = []
        for state in frontier:
            progressed = False
            for step, succ, violation in model.successors(state):
                transitions += 1
                coverage[step.action] = coverage.get(step.action, 0) + 1
                if violation is not None:
                    return CheckResult(
                        False,
                        Violation(violation.invariant, violation.detail,
                                  trace_to(state, step)),
                        states, transitions, depth,
                        time.perf_counter() - start, coverage=coverage)
                canon = _canonical(succ, cfg)
                if canon != state:
                    progressed = True
                if canon in visited:
                    continue
                visited.add(canon)
                parents[canon] = (state, step)
                nxt_frontier.append(canon)
                states += 1
                if states > cfg.max_states:
                    return CheckResult(
                        False, None, states, transitions, depth,
                        time.perf_counter() - start, budget_exhausted=True,
                        budget_reason=f"state budget exceeded "
                                      f"({cfg.max_states})",
                        coverage=coverage)
            if not progressed:
                # quiescent (terminal or self-loop-only): nothing will
                # ever change from here — the loss check applies.
                violation = model.quiescent_loss(state)
                if violation is not None:
                    last = Step("-", "quiescent",
                                "no action can make further progress")
                    return CheckResult(
                        False,
                        Violation(violation.invariant, violation.detail,
                                  trace_to(state, last)),
                        states, transitions, depth,
                        time.perf_counter() - start, coverage=coverage)
            if time.perf_counter() - start > cfg.max_seconds:
                return CheckResult(
                    False, None, states, transitions, depth,
                    time.perf_counter() - start, budget_exhausted=True,
                    budget_reason=f"wall budget exceeded "
                                  f"({cfg.max_seconds}s)",
                    coverage=coverage)
        frontier = nxt_frontier

    return CheckResult(True, None, states, transitions, depth,
                       time.perf_counter() - start, coverage=coverage)


# ---------------------------------------------------------------------------
# liveness: lasso detection under weak fairness
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Lasso:
    """A liveness counterexample: a reachable FAIR cycle on which the
    obligation never discharges. ``stem`` reaches the cycle's entry state
    from the initial state; ``cycle`` returns to that entry state and can
    repeat forever under a weakly-fair scheduler — the run it denotes is
    infinite, which no finite safety trace can say."""

    invariant: str
    detail: str
    stem: Tuple[Step, ...]
    cycle: Tuple[Step, ...]


@dataclass
class LivenessResult:
    ok: bool
    lasso: Optional[Lasso]
    states: int
    transitions: int
    sccs: int
    elapsed: float
    budget_exhausted: bool = False
    budget_reason: str = ""
    checked: Tuple[str, ...] = EVENTUALLY_INVARIANTS


#: Adversary moves: weak fairness never obliges the environment to keep
#: acting — crash/stall budgets may go unspent, the zombie's delayed
#: record may never arrive, the scaling policy may never issue another
#: decision. Everything else is protocol work whose continuous enablement
#: means it is eventually scheduled (the declared fairness constraints:
#: the environment cannot crash/lapse forever, a candidate's election
#: tick is eventually scheduled). ``lapse`` is split by actor state in
#: :func:`_fair_label`: a DEAD worker's ttl elapsing is inevitable
#: (fair), a live worker stalling past its ttl is the budgeted adversary.
_UNFAIR_ACTIONS = frozenset({
    "crash", "coord_crash", "coord_lapse", "scale_in", "scale_out",
    "stale_assign",
})


def _fair_label(label: Tuple[str, str], state) -> bool:
    actor, action = label
    if action in _UNFAIR_ACTIONS:
        return False
    if action == "lapse":
        return state[5][int(actor[1:])][0] == _CRASH
    return True


def _pending_rows(state, K: int) -> bool:
    return any(c < K for c in state[4])


def _pending_drain(state, K: int) -> bool:
    return any(w[0] == _DRAIN for w in state[5])


def _pending_election(state, K: int) -> bool:
    return state[8][0] == 0


def _pending_autoscale(state, K: int) -> bool:
    return any(w[5] for w in state[5])


#: name -> (pending predicate, flagged actions, meaning). A fair cycle
#: violates an eventually-invariant two ways: the obligation is pending
#: at EVERY state of the cycle (it never discharges), or a FLAGGED action
#: — one a converging run performs only finitely often — labels one of
#: the cycle's edges (it recurs forever). Ordered as
#: EVENTUALLY_INVARIANTS: most specific obligation first, so each
#: livelock mutant deterministically names the invariant it breaks.
_EVENTUALLY_DEFS: Tuple[Tuple[str, object, FrozenSet[str], str], ...] = (
    ("election_eventually_converges", _pending_election,
     frozenset({"elect"}),
     "the coordinator role never converges to a stable leader"),
    ("autoscale_eventually_stabilizes", _pending_autoscale,
     frozenset({"scale_in", "scale_out", "release"}),
     "scaling decisions never quiesce — capacity flaps forever"),
    ("every_drain_eventually_acked", _pending_drain, frozenset(),
     "a draining worker never completes its barrier ack"),
    ("every_row_eventually_committed", _pending_rows, frozenset(),
     "rows stay undelivered at every state of a fair cycle"),
)


def _step_for(model: FleetModel, cfg: CheckConfig, u, label, v) -> Step:
    """Regenerate the Step for edge ``u --label--> v`` (the graph stores
    only interned (actor, action) labels; details are re-derived on the
    witness path alone). Deterministic: successors() is."""
    for step, succ, _violation in model.successors(u):
        if (step.actor, step.action) == label \
                and _canonical(succ, cfg) == v:
            return step
    # Unreachable: the edge came from the same generator.
    return Step(label[0], label[1], "")  # pragma: no cover


def check_liveness(cfg: CheckConfig) -> LivenessResult:
    """Lasso detection for the EVENTUALLY_INVARIANTS.

    Builds the full reachable state graph (same macro-step fusion and
    worker-symmetry reductions as :func:`check` — exploration happens in
    canonical space, so trace actor labels are canonical worker ids),
    decomposes it into strongly-connected components (iterative Tarjan),
    drops the UNFAIR components — a component is fair iff every
    (actor, action) that is fair-enabled at EVERY one of its states
    labels some edge inside it; weak fairness at cycle granularity: an
    action continuously enabled along a loop must eventually be taken ON
    the loop, so a cycle that merely starves a ready worker is a
    scheduling artifact, not a livelock — and reports the first fair
    component on which an obligation never discharges, rendered as a
    stem reaching the cycle plus the repeating cycle itself."""
    cfg.validate()
    model = FleetModel(cfg)
    K = cfg.keys_per_partition
    start = time.perf_counter()

    def budget(reason: str, n_states: int, n_trans: int, n_sccs: int = 0):
        return LivenessResult(
            False, None, n_states, n_trans, n_sccs,
            time.perf_counter() - start, budget_exhausted=True,
            budget_reason=reason)

    # -- phase 1: the reachable graph, edges kept this time ---------------
    init = _canonical(model.initial(), cfg)
    adj: Dict[object, List[Tuple[Tuple[str, str], object]]] = {init: []}
    parents: Dict[object, Tuple[object, Step]] = {}
    depth: Dict[object, int] = {init: 0}
    labels: Dict[Tuple[str, str], Tuple[str, str]] = {}
    transitions = 0
    frontier = [init]
    while frontier:
        nxt_frontier = []
        for state in frontier:
            out = adj[state]
            for step, succ, _violation in model.successors(state):
                # Liveness ignores the safety oracles: a violating edge
                # is still an edge of the graph (``check`` owns the
                # safety verdict).
                transitions += 1
                canon = _canonical(succ, cfg)
                label = labels.setdefault((step.actor, step.action),
                                          (step.actor, step.action))
                out.append((label, canon))
                if canon not in adj:
                    adj[canon] = []
                    parents[canon] = (state, step)
                    depth[canon] = depth[state] + 1
                    nxt_frontier.append(canon)
                    if len(adj) > cfg.max_states:
                        return budget(
                            f"state budget exceeded ({cfg.max_states})",
                            len(adj), transitions)
            if time.perf_counter() - start > cfg.max_seconds:
                return budget(
                    f"wall budget exceeded ({cfg.max_seconds}s)",
                    len(adj), transitions)
        frontier = nxt_frontier

    # -- phase 2: SCC decomposition (iterative Tarjan) --------------------
    index: Dict[object, int] = {}
    low: Dict[object, int] = {}
    on_stack = set()
    stack: List[object] = []
    sccs: List[List[object]] = []
    order = 0
    for root in adj:
        if root in index:
            continue
        call = [(root, iter(adj[root]))]
        index[root] = low[root] = order
        order += 1
        stack.append(root)
        on_stack.add(root)
        while call:
            node, it = call[-1]
            pushed = False
            for _label, succ in it:
                if succ not in index:
                    index[succ] = low[succ] = order
                    order += 1
                    stack.append(succ)
                    on_stack.add(succ)
                    call.append((succ, iter(adj[succ])))
                    pushed = True
                    break
                if succ in on_stack and index[succ] < low[node]:
                    low[node] = index[succ]
            if pushed:
                continue
            call.pop()
            if call and low[node] < low[call[-1][0]]:
                low[call[-1][0]] = low[node]
            if low[node] == index[node]:
                comp = []
                while True:
                    s = stack.pop()
                    on_stack.discard(s)
                    comp.append(s)
                    if s == node:
                        break
                sccs.append(comp)
        if time.perf_counter() - start > cfg.max_seconds:
            return budget(f"wall budget exceeded ({cfg.max_seconds}s)",
                          len(adj), transitions, len(sccs))

    # -- phase 3: fairness filter -----------------------------------------
    fair_comps = []
    for comp in sccs:
        if len(comp) == 1 and all(v != comp[0] for _l, v in adj[comp[0]]):
            continue              # trivial SCC, no self-loop: no cycle
        compset = frozenset(comp)
        edge_labels = set()
        for u in comp:
            for lab, v in adj[u]:
                if v in compset:
                    edge_labels.add(lab)
        required = None
        for s in comp:
            enabled = {lab for lab, v in adj[s] if _fair_label(lab, s)}
            required = enabled if required is None \
                else required & enabled
            if not required:
                break
        if required and not required <= edge_labels:
            continue              # a continuously-enabled fair action is
                                  # starved only by scheduling: unfair
        fair_comps.append((comp, compset, edge_labels))

    # -- phase 4: the obligations -----------------------------------------
    lasso = None
    for name, pending, flagged, meaning in _EVENTUALLY_DEFS:
        if lasso is not None:
            break
        for comp, compset, edge_labels in fair_comps:
            flagged_hit = sorted(
                {a for _actor, a in edge_labels if a in flagged})
            if not flagged_hit and not all(pending(s, K) for s in comp):
                continue
            entry = comp[0]
            for s in comp:
                if depth[s] < depth[entry]:
                    entry = s
            stem: List[Step] = []
            cur = entry
            while cur in parents:
                cur, step = parents[cur]
                stem.append(step)
            stem.reverse()
            cycle = _cycle_steps(model, cfg, adj, compset, entry,
                                 frozenset(flagged_hit))
            if flagged_hit:
                detail = (
                    f"{meaning}: the fair cycle performs "
                    f"{', '.join(flagged_hit)} on every lap, so under "
                    f"weak fairness the action recurs forever instead of "
                    f"happening finitely often and settling")
            else:
                detail = (
                    f"{meaning}: the obligation is pending at every "
                    f"state of the cycle, every fair action that is "
                    f"continuously enabled is taken ON the cycle, and "
                    f"none of them discharges it — a livelock no "
                    f"fairness assumption excuses")
            lasso = Lasso(name, detail, tuple(stem), tuple(cycle))
            break

    return LivenessResult(lasso is None, lasso, len(adj), transitions,
                          len(sccs), time.perf_counter() - start)


def _cycle_steps(model, cfg, adj, compset, entry,
                 flagged: FrozenSet[str]) -> List[Step]:
    """The witness cycle: a shortest closed walk entry -> entry inside
    the component, routed through a flagged edge when the violation is
    action-recurrence. Steps are regenerated from the model so the
    rendered trace carries full details."""
    def bfs(srcs, reverse=False):
        """dist/prev maps from the (possibly reversed) edge relation."""
        if reverse:
            radj: Dict[object, List[Tuple[Tuple[str, str], object]]] = {}
            for u in compset:
                for lab, v in adj[u]:
                    if v in compset:
                        radj.setdefault(v, []).append((lab, u))
            rel = lambda s: radj.get(s, ())
        else:
            rel = lambda s: [(lab, v) for lab, v in adj[s]
                             if v in compset]
        dist = {s: 0 for s in srcs}
        prev: Dict[object, Tuple[object, Tuple[str, str]]] = {}
        queue = list(srcs)
        while queue:
            nxt_queue = []
            for u in queue:
                for lab, v in rel(u):
                    if v in dist:
                        continue
                    dist[v] = dist[u] + 1
                    prev[v] = (u, lab)
                    nxt_queue.append(v)
            queue = nxt_queue
        return dist, prev

    def walk_from(prev, node, src):
        """[(u, label, v)] edges along prev-pointers src -> node."""
        edges = []
        while node != src:
            u, lab = prev[node]
            edges.append((u, lab, node))
            node = u
        edges.reverse()
        return edges

    fwd_dist, fwd_prev = bfs([entry])
    rev_dist, rev_prev = bfs([entry], reverse=True)
    edges: List[Tuple[object, Tuple[str, str], object]] = []
    if flagged:
        # Route through the flagged edge minimizing the total lap.
        best = None
        for u in compset:
            if u not in fwd_dist:
                continue
            for lab, v in adj[u]:
                if v not in compset or lab[1] not in flagged \
                        or v not in rev_dist:
                    continue
                cost = fwd_dist[u] + 1 + rev_dist[v]
                if best is None or cost < best[0]:
                    best = (cost, u, lab, v)
        _cost, u, lab, v = best
        edges = walk_from(fwd_prev, u, entry) + [(u, lab, v)]
        # rev_prev walks the REVERSED relation: prev[x] = (y, lab) means
        # a real edge x --lab--> y; follow it v -> entry.
        node = v
        while node != entry:
            y, lab2 = rev_prev[node]
            edges.append((node, lab2, y))
            node = y
    else:
        # Shortest closed walk: the first edge back to entry found in
        # BFS order closes it.
        best = None
        for u in sorted(fwd_dist, key=fwd_dist.get):
            for lab, v in adj[u]:
                if v == entry and v in compset:
                    best = (u, lab)
                    break
            if best:
                break
        u, lab = best
        edges = walk_from(fwd_prev, u, entry) + [(u, lab, entry)]
    return [_step_for(model, cfg, u, lab, v) for u, lab, v in edges]


def spec_transition_names() -> FrozenSet[str]:
    """Every ``Role.name`` in FLEET_PROTOCOLS (the coverage test's ground
    truth for ACTION_IMPLEMENTS)."""
    from fraud_detection_tpu_torch.analysis.entrypoints import FLEET_PROTOCOLS

    return frozenset(q for role in FLEET_PROTOCOLS
                     for q in role.qualnames())
