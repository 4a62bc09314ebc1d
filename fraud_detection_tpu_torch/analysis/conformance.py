"""Runtime trace conformance against the protocol specs — twin of
``fraud_detection_tpu/analysis/conformance.py``.

The model checker (analysis/checker.py) proves the DECLARED choreography
safe and live; this module closes the remaining gap — does the running
system actually speak that choreography? It replays a recorded
control-lane run (the :meth:`ControlBus.export_trace` journal that game
days persist as ``succession.trace`` evidence, plus the coordinator
handoff log) against the declared role state machines
(analysis/entrypoints.py ``FLEET_PROTOCOLS``) and reports every record
the spec cannot explain:

* **unknown-kind** — a record kind outside ``CONTROL_KINDS`` (a phantom
  op: nothing in the spec emits it).
* **role-confusion** — one sender speaking both the Worker and the
  Candidate alphabet.
* **seq-gap / out-of-order / duplicate-delivery** — per-sender sequence
  discipline. The journal records *accepted* deliveries in order, so on
  an honest recording gaps and reorders appear only when the transport
  itself lost or reordered records — which the bus counts. A skipped
  seq is charged as a gap only if no later record fills the hole (a
  filled hole is a reorder, not a loss). The checker tolerates exactly
  the recorded ``lost``/``reordered`` budgets; anything beyond them
  means the log was doctored (or the counters lie, which is just as
  reportable).
* **stale-term** — a candidate-kind record stamped with a term older
  than one already observed: a zombie published after demotion (FC503's
  zombie-demotes-before-publish, observed at runtime).
* **election-fence** — a ``claim`` that does not strictly advance the
  term (two leaders under one term is the ``drop_coordinator_lease``
  counterexample, observed at runtime).
* **unknown-transition** — the sender's role machine has no transition
  explaining the record from any currently-possible state (out-of-order
  protocol step; e.g. an ``ack`` from a worker that never drained, or a
  ``beacon`` from a candidate that never won an election). Each role
  machine replays its sender's records in that sender's own seq order —
  the order the sender *performed* its steps — so an honest transport
  reorder never cascades into protocol findings.
* **handoff-fence** — the coordinator handoff log's terms not strictly
  increasing.

Role machines are replayed as NFAs (subset simulation): bus records
observe only part of each machine's alphabet, so unobservable
transitions (poll, commit, crash, a zombie's silent demotion) are
epsilon moves, and the simulation tracks the SET of states the role may
occupy. A record is conformant iff at least one occupied state explains
it. Every finding cites the first offending record by journal index —
rule FC505 in SARIF.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from fraud_detection_tpu_torch.analysis.core import Finding
from fraud_detection_tpu_torch.analysis.entrypoints import FLEET_PROTOCOLS

#: Mirrors fleet/control.py (imported lazily there — analysis/ stays
#: import-light; test_conformance pins the two tuples in lockstep).
WORKER_OPS = ("join", "sync", "ack", "leave")
CANDIDATE_KINDS = ("beacon", "claim", "abdicate")
CONTROL_KINDS = WORKER_OPS + CANDIDATE_KINDS + ("snapshot",)

#: Candidate-machine view of the bus alphabet: which spec transition a
#: candidate-kind record witnesses. ``beacon``/``snapshot`` are the
#: incumbent's lead loop; ``claim`` is the election win; ``abdicate`` is
#: the graceful death's last word.
_CANDIDATE_OBSERVED = {"claim": "elect", "beacon": "lead",
                       "snapshot": "lead", "abdicate": "crash"}

#: Worker-machine records observe their own transition names verbatim.
_WORKER_OBSERVED = {k: k for k in WORKER_OPS}


def _role_spec(role: str):
    for spec in FLEET_PROTOCOLS:
        if spec.role == role:
            return spec
    raise LookupError(f"FLEET_PROTOCOLS has no role {role!r}")


class _RoleNFA:
    """Subset simulation of one RoleSpec against a partial alphabet.

    ``observed`` maps record kind -> transition name; every transition
    whose name is NOT an observed value is an epsilon move (it happens,
    the bus just doesn't see it). ``extra_eps`` adds environment moves
    the spec leaves implicit (a crashed worker's replacement respawns
    under the same id via the provisioner — crashed is not terminal on
    the bus). ``initials`` widens the start set (the bootstrap candidate
    leads from construction without ever publishing a claim)."""

    def __init__(self, role: str, observed: Dict[str, str],
                 extra_eps: Sequence[Tuple[str, str]] = (),
                 initials: Optional[Sequence[str]] = None):
        spec = _role_spec(role)
        self.role = role
        self.observed = dict(observed)
        names = set(self.observed.values())
        self._delta: Dict[Tuple[str, str], Set[str]] = {}
        self._eps: Dict[str, Set[str]] = {}
        for t in spec.transitions:
            if t.name in names:
                self._delta.setdefault((t.source, t.name),
                                       set()).add(t.target)
            else:
                self._eps.setdefault(t.source, set()).add(t.target)
        for src, dst in extra_eps:
            self._eps.setdefault(src, set()).add(dst)
        start = tuple(initials) if initials is not None else (spec.initial,)
        self.states: Set[str] = self._closure(set(start))

    def _closure(self, states: Set[str]) -> Set[str]:
        frontier = list(states)
        closed = set(states)
        while frontier:
            s = frontier.pop()
            for nxt in self._eps.get(s, ()):
                if nxt not in closed:
                    closed.add(nxt)
                    frontier.append(nxt)
        return closed

    def step(self, kind: str) -> bool:
        """Advance on one record; False = no occupied state explains it
        (the state set is left unchanged so the replay can continue and
        surface further violations instead of cascading)."""
        name = self.observed[kind]
        nxt: Set[str] = set()
        for s in self.states:
            nxt |= self._delta.get((s, name), set())
        if not nxt:
            return False
        self.states = self._closure(nxt)
        return True


def _worker_nfa() -> _RoleNFA:
    return _RoleNFA("Worker", _WORKER_OBSERVED,
                    extra_eps=(("crashed", "init"),))


def _candidate_nfa() -> _RoleNFA:
    return _RoleNFA("Candidate", _CANDIDATE_OBSERVED,
                    initials=("standby", "leading"))


@dataclass(frozen=True)
class Nonconformance:
    """One spec violation, citing the offending record by journal index
    (0-based delivery order)."""

    index: int
    rule: str
    detail: str
    record: Optional[dict] = None

    def render(self) -> str:
        where = (f"record {self.index}" if self.index >= 0
                 else "handoff log")
        rec = ""
        if self.record is not None:
            rec = (f" [{self.record.get('kind')}:"
                   f"{self.record.get('sender')} "
                   f"seq={self.record.get('seq')} "
                   f"term={self.record.get('term')} "
                   f"lamport={self.record.get('lamport')}]")
        return f"{where}{rec}: {self.rule}: {self.detail}"


def check_records(records: Sequence[dict], *,
                  handoffs: Optional[Sequence[dict]] = None,
                  lost: int = 0, reordered: int = 0) -> List[Nonconformance]:
    """Replay a recorded journal against the role machines.

    ``lost``/``reordered`` are the bus's own transport-accounting
    counters from the same run: that many seq gaps / order inversions
    are legitimate lane casualties and are tolerated; one more is a
    doctored log."""
    out: List[Nonconformance] = []
    #: sender -> [(delivery index, seq, kind, record)] for the role-
    #: machine replay, run after the scan in the sender's seq order.
    role_steps: Dict[str, List[Tuple[int, int, str, dict]]] = {}
    roles: Dict[str, str] = {}
    high: Dict[str, int] = {}
    seen: Dict[str, Set[int]] = {}
    #: (sender, missing seq) -> (index, record) of the delivery that
    #: jumped over it. A later record may FILL the hole (a transport
    #: reorder, not a loss) — so gaps are only charged against the loss
    #: budget after the whole journal has had its chance to fill them.
    gap_open: Dict[Tuple[str, int], Tuple[int, dict]] = {}
    gap_budget = max(0, int(lost))
    reorder_budget = max(0, int(reordered))
    max_cand_term = 0

    for i, rec in enumerate(records):
        if not isinstance(rec, dict):
            out.append(Nonconformance(i, "malformed-record",
                                      f"not a record object: {rec!r}"))
            continue
        kind = rec.get("kind")
        sender = rec.get("sender")
        try:
            seq = int(rec.get("seq"))
            term = int(rec.get("term"))
        except (TypeError, ValueError):
            out.append(Nonconformance(i, "malformed-record",
                                      "seq/term not integers", rec))
            continue
        if kind not in CONTROL_KINDS or not isinstance(sender, str):
            out.append(Nonconformance(
                i, "unknown-kind",
                f"kind {kind!r} is not in the control vocabulary "
                f"{CONTROL_KINDS} — nothing in FLEET_PROTOCOLS emits "
                f"it (phantom record)", rec))
            continue

        # -- per-sender sequence discipline ---------------------------
        s_seen = seen.setdefault(sender, set())
        if seq in s_seen:
            out.append(Nonconformance(
                i, "duplicate-delivery",
                f"{sender} seq {seq} delivered twice — the bus dedups "
                f"on delivery, an honest journal never repeats a seq",
                rec))
            continue
        s_seen.add(seq)
        prev = high.get(sender, 0)
        if seq < prev:
            # a late arrival fills the hole its own skip opened earlier
            gap_open.pop((sender, seq), None)
            if reorder_budget > 0:
                reorder_budget -= 1
            else:
                out.append(Nonconformance(
                    i, "out-of-order",
                    f"{sender} seq {seq} arrives after seq {prev} with "
                    f"no recorded transport reorder to blame", rec))
        elif seq > prev + 1:
            for missing in range(prev + 1, seq):
                gap_open[(sender, missing)] = (i, rec)
        high[sender] = max(prev, seq)

        # -- role machines --------------------------------------------
        role = "Worker" if kind in WORKER_OPS else "Candidate"
        owner = roles.setdefault(sender, role)
        if owner != role:
            out.append(Nonconformance(
                i, "role-confusion",
                f"{sender} already speaks the {owner} alphabet but "
                f"published the {role} kind {kind!r}", rec))
            continue
        if role == "Candidate":
            if kind == "claim" and term <= max_cand_term:
                out.append(Nonconformance(
                    i, "election-fence",
                    f"claim at term {term} does not strictly advance "
                    f"the observed term {max_cand_term} — the TermGate "
                    f"CAS can never grant this election", rec))
            elif kind != "claim" and term < max_cand_term:
                out.append(Nonconformance(
                    i, "stale-term",
                    f"{kind} stamped term {term} after term "
                    f"{max_cand_term} was already observed — a zombie "
                    f"published after its demotion fence", rec))
            max_cand_term = max(max_cand_term, term)
        role_steps.setdefault(sender, []).append((i, seq, kind, rec))

    # -- role machines, each sender in its own seq order --------------
    for sender, steps in role_steps.items():
        role = roles[sender]
        nfa = _worker_nfa() if role == "Worker" else _candidate_nfa()
        for i, _seq, kind, rec in sorted(steps, key=lambda s: s[1]):
            before = sorted(nfa.states)
            if not nfa.step(kind):
                out.append(Nonconformance(
                    i, "unknown-transition",
                    f"no {role} transition named "
                    f"{nfa.observed[kind]!r} leaves any possible state "
                    f"{before} — out-of-order protocol step", rec))

    # -- unfilled gaps: records genuinely absent from the log ---------
    for (sender, missing), (i, rec) in sorted(gap_open.items(),
                                              key=lambda kv: kv[1][0]):
        if gap_budget > 0:
            gap_budget -= 1
        else:
            out.append(Nonconformance(
                i, "seq-gap",
                f"{sender} seq {missing} was never delivered: the jump "
                f"{missing - 1} -> {rec.get('seq')} opened a hole no "
                f"later record fills, beyond the recorded transport-"
                f"loss budget — a record was dropped from the log", rec))
    # first offending record first (handoff-log findings trail)
    out.sort(key=lambda v: v.index if v.index >= 0 else len(records))

    # -- coordinator handoff log -------------------------------------
    last_term = 0
    for h in handoffs or ():
        term = int(h.get("term") or 0)
        if term <= last_term:
            out.append(Nonconformance(
                -1, "handoff-fence",
                f"handoff to {h.get('to')!r} at term {term} does not "
                f"advance the previous handoff term {last_term}"))
        last_term = max(last_term, term)
    return out


def extract_trace(obj) -> Tuple[List[dict], dict]:
    """Pull (records, context) out of any of the shapes the tree
    persists: a raw record list, ``{"records": [...]}``, a
    ``succession_report()`` dict, or a full game-day result / report
    with ``evidence.succession.trace``. Context carries the transport
    budgets and the handoff log when the shape has them."""
    ctx: dict = {"lost": 0, "reordered": 0, "handoffs": None}

    def _from_succession(succ: dict) -> Tuple[List[dict], dict]:
        control = succ.get("control") or {}
        ctx["lost"] = int(control.get("lost") or 0)
        ctx["reordered"] = int(control.get("reordered") or 0)
        ctx["handoffs"] = succ.get("handoffs")
        return list(succ.get("trace") or []), ctx

    if isinstance(obj, list):
        return list(obj), ctx
    if isinstance(obj, dict):
        if "trace" in obj and isinstance(obj.get("trace"), list):
            return _from_succession(obj)
        if isinstance(obj.get("records"), list):
            return list(obj["records"]), ctx
        evidence = obj.get("evidence")
        if isinstance(evidence, dict):
            succ = evidence.get("succession")
            if isinstance(succ, dict) and isinstance(succ.get("trace"),
                                                     list):
                return _from_succession(succ)
        succ = obj.get("succession")
        if isinstance(succ, dict) and isinstance(succ.get("trace"), list):
            return _from_succession(succ)
    raise ValueError(
        "no control-lane trace found: expected a record list, "
        "{'records': [...]}, a succession_report() dict, or game-day "
        "evidence with succession.trace")


def summarize(violations: Sequence[Nonconformance],
              n_records: int) -> dict:
    """The game-day evidence block (`spec_conformance` SLO gates on
    ``violation_count == 0``)."""
    rules: Dict[str, int] = {}
    for v in violations:
        rules[v.rule] = rules.get(v.rule, 0) + 1
    return {
        "records": n_records,
        "violation_count": len(violations),
        "rules": dict(sorted(rules.items())),
        "first": violations[0].render() if violations else None,
    }


def to_findings(violations: Sequence[Nonconformance]) -> List[Finding]:
    """FC505 findings, anchored at the control lane (the module whose
    journal failed the replay), first offender first."""
    return [
        Finding("FC505", "fleet/control.py", 1,
                f"trace nonconformance — {v.render()}")
        for v in violations
    ]


def render_report(violations: Sequence[Nonconformance], n_records: int,
                  source: str) -> str:
    lines = [f"flightcheck conform: {n_records} record(s) from {source}"]
    if not violations:
        lines.append(
            "  CONFORMANT: the recorded run is a valid word of the "
            "declared role machines (FLEET_PROTOCOLS)")
        return "\n".join(lines)
    for v in violations:
        lines.append(f"  {v.render()}")
    where = (f"record {violations[0].index}" if violations[0].index >= 0
             else "the handoff log")
    lines.append(f"  NONCONFORMANT: {len(violations)} violation(s); "
                 f"first at {where}")
    return "\n".join(lines)
