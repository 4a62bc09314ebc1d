"""FC501-FC503 — the fleet protocol spec verified against the real code;
twin of ``fraud_detection_tpu/analysis/model.py``.

The fleet makes correctness a *distributed* property: zero-loss/zero-dup now
rides a multi-role choreography (coordinator lease deals, the REVOKE
BARRIER's revoke -> drain -> commit -> reassign, zombie commit fencing)
that spans threads and — with the file-backed bus — processes. The
choreography is declared as explicit per-role state machines in
:data:`~fraud_detection_tpu_torch.analysis.entrypoints.FLEET_PROTOCOLS`; the
``flightcheck model`` checker (analysis/checker.py) explores that model's
interleavings, and THIS module keeps the spec honest against the tree the
same way ``COMMIT_PROTOCOLS``/``THREAD_ENTRY_POINTS`` already are:

* **FC501 transition-in-code-missing-from-spec** — a protocol-vocabulary
  call site (``coordinator.join``, ``bus.publish``, …) inside the fleet
  modules that NO spec transition claims. New protocol traffic cannot land
  without being modeled; an unclaimed call is an unmodeled interleaving.
* **FC502 spec-transition-unreachable-in-code** — a spec transition whose
  anchor method no longer exists, or whose required implementation calls
  vanished from the anchor's body. The machine the checker verifies must
  be the machine the code runs.
* **FC503 fence/barrier call-site drift** — the ordering shapes that make
  the choreography safe, pinned per call site
  (:data:`FLEET_BARRIER_OBLIGATIONS`): the commit fence consulted BEFORE
  any offset advances, a syncing member renewed BEFORE the expiry scan,
  the engine drained BEFORE the barrier ack, the re-deal populating (and
  expiry releasing) the barrier holds, committed-offset resume at consumer
  construction, and the fence actually wired into the fleet's consumers.

Like every flightcheck pass this is pure AST — the verified modules are
parsed, never imported. Matching is therefore lexical: a call pattern is a
dotted suffix of the receiver chain as written (``"coordinator.sync"``
matches ``self.coordinator.sync(...)`` and ``coord.coordinator.sync(...)``
but not ``self.sync(...)``), and FC503's ordering is line order, the same
approximation FC402 uses. That is exactly the right strength for drift
detection: renames, deletions, and reorderings — the ways a refactor
silently breaks a protocol — all change the lexical facts.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from fraud_detection_tpu_torch.analysis.callgraph import _attr_chain
from fraud_detection_tpu_torch.analysis.core import Finding

# ---------------------------------------------------------------------------
# lexical fact extraction
# ---------------------------------------------------------------------------


def _split_key(key: str) -> Tuple[str, str]:
    relpath, _, qual = key.partition("::")
    return relpath, qual


def _method_index(files: Sequence) -> Dict[str, ast.AST]:
    """"relpath::Class.method" -> FunctionDef for every class method (and
    "relpath::function" for module-level functions) in ``files``."""
    index: Dict[str, ast.AST] = {}
    for sf in files:
        for node in sf.tree.body:
            if isinstance(node, ast.ClassDef):
                for fn in node.body:
                    if isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                        index[f"{sf.relpath}::{node.name}.{fn.name}"] = fn
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                index[f"{sf.relpath}::{node.name}"] = node
    return index


def _call_chain(node: ast.Call) -> Optional[List[str]]:
    """The dotted receiver chain of a call: ``self.coordinator.sync(...)``
    -> ["self", "coordinator", "sync"]; None for non-name callees."""
    return _attr_chain(node.func)


def _chain_matches(chain: Sequence[str], pattern: str) -> bool:
    """True when the call chain ends with the pattern's dotted parts."""
    parts = pattern.split(".")
    return len(chain) >= len(parts) and list(chain[-len(parts):]) == parts


def _calls_in(fn: ast.AST) -> List[Tuple[List[str], ast.Call]]:
    out: List[Tuple[List[str], ast.Call]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            chain = _call_chain(node)
            if chain is not None:
                out.append((chain, node))
    return out


def _store_lines(fn: ast.AST, attr: str) -> List[int]:
    """Lines where ``attr`` appears in an assignment/del/augassign TARGET
    chain (``self._pending = …``, ``del self._pending[pair]``,
    ``self._members[w]["renewed"] = now`` all mention their attribute)."""
    lines: List[int] = []

    def targets_of(node: ast.AST) -> List[ast.AST]:
        if isinstance(node, ast.Assign):
            return list(node.targets)
        if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            return [node.target]
        if isinstance(node, ast.Delete):
            return list(node.targets)
        return []

    for node in ast.walk(fn):
        for target in targets_of(node):
            for sub in ast.walk(target):
                if isinstance(sub, ast.Attribute) and sub.attr == attr:
                    lines.append(node.lineno)
                elif isinstance(sub, ast.Name) and sub.id == attr:
                    lines.append(node.lineno)
        # mutating method calls on the attribute count as stores too
        # (``self._committed.update(...)``): the attr appears in the
        # call chain BEFORE the method name.
        if isinstance(node, ast.Call):
            chain = _call_chain(node)
            if chain is not None and attr in chain[:-1]:
                lines.append(node.lineno)
    return sorted(set(lines))


def _call_lines(fn: ast.AST, pattern: str) -> List[int]:
    return sorted({node.lineno for chain, node in _calls_in(fn)
                   if _chain_matches(chain, pattern)})


def _kwarg_lines(fn: ast.AST, call_pattern: str, kwarg: str) -> List[int]:
    lines: List[int] = []
    for chain, node in _calls_in(fn):
        if _chain_matches(chain, call_pattern) \
                and any(kw.arg == kwarg for kw in node.keywords):
            lines.append(node.lineno)
    return sorted(set(lines))


def _event_lines(fn: ast.AST, event: str) -> Tuple[List[int], str]:
    """Resolve an obligation event spec to its line numbers + a label."""
    kind, _, rest = event.partition(":")
    if kind == "call":
        return _call_lines(fn, rest), f"call {rest}()"
    if kind == "store":
        return _store_lines(fn, rest), f"write to {rest}"
    if kind == "kwarg":
        call_pattern, _, kwarg = rest.partition(":")
        return (_kwarg_lines(fn, call_pattern, kwarg),
                f"{call_pattern}(..., {kwarg}=)")
    raise ValueError(f"unknown obligation event kind {kind!r} in {event!r}")


# ---------------------------------------------------------------------------
# FC502 — spec transitions must exist in code
# ---------------------------------------------------------------------------

def _check_spec_reachable(protocols, index: Dict[str, ast.AST],
                          have_file: Set[str]) -> List[Finding]:
    findings: List[Finding] = []
    for role in protocols:
        for t in role.transitions:
            for anchor in t.anchors:
                relpath, qual = _split_key(anchor)
                fn = index.get(anchor)
                if fn is None:
                    where = relpath if relpath in have_file \
                        else "analysis/entrypoints.py"
                    findings.append(Finding(
                        "FC502", where, 1,
                        f"FLEET_PROTOCOLS {role.role}.{t.name}: anchor "
                        f"{qual!r} does not exist in {relpath} — the spec "
                        f"models a transition the code no longer has; "
                        f"update the machine (and the checker model) to "
                        f"match the tree"))
                    continue
                for pattern in t.calls:
                    if not _call_lines(fn, pattern):
                        findings.append(Finding(
                            "FC502", relpath, fn.lineno,
                            f"FLEET_PROTOCOLS {role.role}.{t.name}: anchor "
                            f"{qual} no longer calls {pattern!r} — the "
                            f"transition's implementation drifted from the "
                            f"spec (renamed/removed call); re-verify the "
                            f"choreography and update FLEET_PROTOCOLS"))
    return findings


# ---------------------------------------------------------------------------
# FC501 — protocol calls in code must be claimed by the spec
# ---------------------------------------------------------------------------

def _check_code_claimed(protocols, vocabulary, scope,
                        files, index: Dict[str, ast.AST]) -> List[Finding]:
    # (anchor key, pattern) pairs the spec claims
    claimed: Set[Tuple[str, str]] = set()
    for role in protocols:
        for t in role.transitions:
            for anchor in t.anchors:
                for pattern in t.calls:
                    claimed.add((anchor, pattern))

    findings: List[Finding] = []
    scoped = [sf for sf in files
              if any(sf.relpath.startswith(prefix) for prefix in scope)]
    for sf in scoped:
        for key, fn in _method_index([sf]).items():
            for chain, node in _calls_in(fn):
                for pattern in vocabulary:
                    if not _chain_matches(chain, pattern):
                        continue
                    if (key, pattern) in claimed:
                        continue
                    findings.append(Finding(
                        "FC501", sf.relpath, node.lineno,
                        f"{_split_key(key)[1]} drives the fleet protocol "
                        f"({pattern}) but no FLEET_PROTOCOLS transition "
                        f"claims this call site — the model checker never "
                        f"explores this interleaving; add/extend a "
                        f"transition in analysis/entrypoints.py (and teach "
                        f"the checker its semantics)"))
    return findings


# ---------------------------------------------------------------------------
# FC503 — fence/barrier call-site shapes
# ---------------------------------------------------------------------------

def _check_obligations(obligations, index: Dict[str, ast.AST],
                       have_file: Set[str]) -> List[Finding]:
    findings: List[Finding] = []
    for ob in obligations:
        relpath, qual = _split_key(ob.anchor)
        fn = index.get(ob.anchor)
        if fn is None:
            where = relpath if relpath in have_file \
                else "analysis/entrypoints.py"
            findings.append(Finding(
                "FC503", where, 1,
                f"barrier obligation {ob.name!r}: anchor {qual!r} does not "
                f"exist in {relpath} — {ob.why}"))
            continue
        first_lines, first_label = _event_lines(fn, ob.first)
        if not first_lines:
            findings.append(Finding(
                "FC503", relpath, fn.lineno,
                f"barrier obligation {ob.name!r}: {qual} has no "
                f"{first_label} — {ob.why}"))
            continue
        if not ob.then:
            continue
        then_lines, then_label = _event_lines(fn, ob.then)
        if not then_lines:
            # the ordered-after event vanishing is drift too: the shape
            # the obligation pins no longer exists to be ordered.
            findings.append(Finding(
                "FC503", relpath, fn.lineno,
                f"barrier obligation {ob.name!r}: {qual} has no "
                f"{then_label} to order after {first_label} — {ob.why}"))
            continue
        if min(first_lines) >= min(then_lines):
            findings.append(Finding(
                "FC503", relpath, min(then_lines),
                f"barrier obligation {ob.name!r}: in {qual}, {then_label} "
                f"(line {min(then_lines)}) precedes {first_label} (line "
                f"{min(first_lines)}) — {ob.why}"))
    return findings


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def analyze(files: Sequence, *, protocols=None, obligations=None,
            vocabulary=None, scope=None) -> List[Finding]:
    """FC501-FC503 over the declared protocol specs — the fleet rebalance
    choreography AND the slotserve decode-slot lifecycle. The keyword
    overrides feed fixture specs through as ONE group (tests); defaults
    come from entrypoints.py, with FC501's vocabulary scan scoped
    per-spec-group so fleet vocabulary never lints slotserve files and
    vice versa."""
    from fraud_detection_tpu_torch.analysis.entrypoints import (
        FLEET_BARRIER_OBLIGATIONS, FLEET_PROTOCOL_SCOPE,
        FLEET_PROTOCOL_VOCABULARY, FLEET_PROTOCOLS,
        SLOT_BARRIER_OBLIGATIONS, SLOT_PROTOCOL_SCOPE,
        SLOT_PROTOCOL_VOCABULARY, SLOT_PROTOCOLS)

    if (protocols is None and obligations is None and vocabulary is None
            and scope is None):
        groups = [(FLEET_PROTOCOLS, FLEET_PROTOCOL_VOCABULARY,
                   FLEET_PROTOCOL_SCOPE),
                  (SLOT_PROTOCOLS, SLOT_PROTOCOL_VOCABULARY,
                   SLOT_PROTOCOL_SCOPE)]
        all_protocols = FLEET_PROTOCOLS + SLOT_PROTOCOLS
        all_obligations = FLEET_BARRIER_OBLIGATIONS + SLOT_BARRIER_OBLIGATIONS
    else:
        protocols = FLEET_PROTOCOLS if protocols is None else protocols
        obligations = (FLEET_BARRIER_OBLIGATIONS if obligations is None
                       else obligations)
        vocabulary = (FLEET_PROTOCOL_VOCABULARY if vocabulary is None
                      else vocabulary)
        scope = FLEET_PROTOCOL_SCOPE if scope is None else scope
        groups = [(protocols, vocabulary, scope)]
        all_protocols = protocols
        all_obligations = obligations

    index = _method_index(files)
    have_file = {sf.relpath for sf in files}
    findings: List[Finding] = []
    for g_protocols, g_vocabulary, g_scope in groups:
        findings += _check_code_claimed(g_protocols, g_vocabulary, g_scope,
                                        files, index)
    findings += _check_spec_reachable(all_protocols, index, have_file)
    findings += _check_obligations(all_obligations, index, have_file)
    return findings
