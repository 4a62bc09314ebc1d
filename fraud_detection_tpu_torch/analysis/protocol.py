"""FC401-FC404 — delivery-protocol shape and exception-safety rules.
The port's twin of ``fraud_detection_tpu/analysis/protocol.py``.

The at-least-once guarantee the whole framework leans on is one ordering
(docs/robustness.md): results are PRODUCED, then the producer is FLUSHED
and its result CHECKED, and only then are offsets COMMITTED. Break any
link and a commit can advance past outputs that never left the process —
silent message loss that no unit test of the happy path catches. These
rules pin the shape statically, per protocol class registered in
:data:`~fraud_detection_tpu_torch.analysis.entrypoints.COMMIT_PROTOCOLS`:

* **FC401 commit-order** — an offset commit (``commit_offsets``/``commit``)
  reachable without a *verified* flush: either no flush precedes it on the
  path, the flush's return value is discarded, or the failure branch of
  the flush check can fall through to the commit. The verified shape is
  ``undelivered = producer.flush()`` followed by ``if undelivered:`` whose
  body terminates (return/raise/break/continue) — or the inverted
  ``if not undelivered: commit`` nesting.
* **FC402 record-after-flush** — a ``produce``/``produce_batch`` call
  lexically after the method's flush: the record rides NO delivery
  accounting (the flush that "succeeded" never covered it), so a commit
  can orphan it. DLQ and annotation records must be produced before their
  batch's flush.
* **FC403 unguarded-drain** — draining in-flight batches without checking
  the protocol's failure flag first: (a) a drain call inside a ``finally``
  with no enclosing test of the flag — the post-failure cleanup path would
  finish (and commit) batches QUEUED BEHIND the failed one; (b) a public
  entry method that drains without consulting the flag — a caller looping
  it would commit right past a previous incarnation's lost outputs.
* **FC404 lock-leak** — package-wide exception-safety dataflow for bare
  lock usage: an ``x.acquire()`` whose very next statement is not a
  ``try`` with a matching ``x.release()`` in its ``finally`` leaks the
  lock on any exception between acquire and release. ``with x:`` is the
  fix; acquire-try-finally is the accepted manual form.

FC401-403 are deliberately scoped to registered protocol classes: the
method/attribute names ("flush", "commit", a failure flag) are only
meaningful where the commit protocol actually lives, and scoping keeps
unrelated code free to use those names.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Set, Tuple

from fraud_detection_tpu_torch.analysis.core import Finding

_TERMINATORS = (ast.Return, ast.Raise, ast.Break, ast.Continue)

# FC401 path states, ordered by progress through the protocol.
_NONE = 0          # no flush seen on this path
_FLUSH_DROPPED = 1  # flush called, result discarded — can never verify
_FLUSHED = 2       # flush result captured, not yet checked
_VERIFIED = 3      # failure branch checked and terminated


def _terminates(body: List[ast.stmt]) -> bool:
    return bool(body) and isinstance(body[-1], _TERMINATORS)


class _ClassScan:
    """Shared per-class context for FC401-403."""

    def __init__(self, sf, cls: ast.ClassDef, spec):
        self.sf = sf
        self.cls = cls
        self.spec = spec
        self.findings: List[Finding] = []

    # -- call-shape recognizers -------------------------------------------

    def _receiver_is_producer(self, node: ast.AST) -> bool:
        """``self.<producer_attr>`` or a local alias of it (aliases are
        collected per method before scanning)."""
        from fraud_detection_tpu_torch.analysis.callgraph import _attr_chain

        chain = _attr_chain(node)
        if chain is None:
            return False
        if len(chain) == 2 and chain[0] == "self":
            return chain[1] in self.spec.producer_attrs
        return len(chain) == 1 and chain[0] in self._producer_aliases

    def _is_flush_call(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == self.spec.flush_name
                and self._receiver_is_producer(node.func.value))

    def _is_commit_call(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in self.spec.commit_names)

    def _is_produce_call(self, node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        fn = node.func
        if isinstance(fn, ast.Attribute):
            return fn.attr in self.spec.produce_names
        if isinstance(fn, ast.Name):
            return (fn.id in self.spec.produce_names
                    or fn.id in self._produce_aliases)
        return False

    def _is_drain_call(self, node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        fn = node.func
        name = (fn.attr if isinstance(fn, ast.Attribute)
                else fn.id if isinstance(fn, ast.Name) else None)
        return name in self.spec.drain_names

    def _collect_aliases(self, fn: ast.AST) -> None:
        """``produce_batch = getattr(self.producer, "produce_batch", ...)``
        and ``p = self.producer`` aliases, per method."""
        from fraud_detection_tpu_torch.analysis.callgraph import _attr_chain

        self._produce_aliases: Set[str] = set()
        self._producer_aliases: Set[str] = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1 \
                    or not isinstance(node.targets[0], ast.Name):
                continue
            target = node.targets[0].id
            v = node.value
            chain = _attr_chain(v)
            if (chain is not None and len(chain) == 2 and chain[0] == "self"
                    and chain[1] in self.spec.producer_attrs):
                self._producer_aliases.add(target)
            if (isinstance(v, ast.Call) and isinstance(v.func, ast.Name)
                    and v.func.id == "getattr" and len(v.args) >= 2
                    and isinstance(v.args[1], ast.Constant)
                    and v.args[1].value in self.spec.produce_names
                    and self._receiver_is_producer(v.args[0])):
                self._produce_aliases.add(target)

    def _flag_in_test(self, test: ast.AST) -> bool:
        flag = self.spec.failure_flag
        if flag is None:
            return False
        for sub in ast.walk(test):
            if (isinstance(sub, ast.Attribute) and sub.attr == flag
                    and isinstance(sub.value, ast.Name)
                    and sub.value.id == "self"):
                return True
        return False

    # -- FC401 -------------------------------------------------------------

    def scan_commit_order(self, fn: ast.AST) -> None:
        where = f"{self.cls.name}.{fn.name}"
        flush_vars: Set[str] = set()

        def stmt_commit_check(stmt: ast.stmt, state: int) -> None:
            for sub in ast.walk(stmt):
                if self._is_commit_call(sub):
                    if state == _NONE:
                        msg = (f"{where}: offsets committed with NO producer "
                               f"flush on the path — a commit can advance "
                               f"past outputs still sitting in the producer "
                               f"queue (produce -> flush -> check -> commit)")
                    elif state == _FLUSH_DROPPED:
                        msg = (f"{where}: flush() result discarded before "
                               f"the commit — undelivered counts are the "
                               f"ONLY failure signal; capture and check it "
                               f"before committing offsets")
                    elif state == _FLUSHED:
                        msg = (f"{where}: flush() result never checked "
                               f"before the commit — on a failed flush this "
                               f"path still commits, orphaning the batch's "
                               f"undelivered outputs")
                    else:
                        continue
                    self.findings.append(Finding(
                        "FC401", self.sf.relpath, sub.lineno, msg))

        def test_checks_flush(test: ast.AST) -> Optional[bool]:
            """True: truthy test = failure branch (``if undelivered:``);
            False: truthy test = success branch (``if not undelivered:`` /
            ``== 0``); None: test unrelated to the flush result."""
            names = {n.id for n in ast.walk(test) if isinstance(n, ast.Name)}
            if not (names & flush_vars):
                return None
            if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
                return False
            if isinstance(test, ast.Compare) and len(test.ops) == 1:
                comp = test.comparators[0]
                is_zero = (isinstance(comp, ast.Constant)
                           and comp.value == 0)
                if isinstance(test.ops[0], ast.Eq) and is_zero:
                    return False
            return True

        def walk(body: List[ast.stmt], state: int) -> int:
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if isinstance(stmt, ast.If):
                    polarity = test_checks_flush(stmt.test)
                    if polarity is True and state in (_FLUSHED,
                                                      _FLUSH_DROPPED):
                        # body is the FAILURE path
                        walk(stmt.body, state)
                        walk(stmt.orelse, _VERIFIED)
                        if _terminates(stmt.body):
                            state = _VERIFIED
                        continue
                    if polarity is False and state in (_FLUSHED,
                                                       _FLUSH_DROPPED):
                        walk(stmt.body, _VERIFIED)   # body is SUCCESS
                        walk(stmt.orelse, state)
                        continue
                    state = min(walk(stmt.body, state), state)
                    if stmt.orelse:
                        state = min(walk(stmt.orelse, state), state)
                    continue
                if isinstance(stmt, ast.Try):
                    state = walk(stmt.body, state)
                    for handler in stmt.handlers:
                        walk(handler.body, state)
                    if stmt.orelse:
                        state = walk(stmt.orelse, state)
                    if stmt.finalbody:
                        state = walk(stmt.finalbody, state)
                    continue
                if isinstance(stmt, (ast.For, ast.While, ast.With,
                                     ast.AsyncWith, ast.AsyncFor)):
                    state = walk(stmt.body, state)
                    if getattr(stmt, "orelse", None):
                        walk(stmt.orelse, state)
                    continue
                # simple statement: commits first (a commit in the same
                # statement as the flush cannot be ordered after it)...
                stmt_commit_check(stmt, state)
                # ...then flush transitions.
                if isinstance(stmt, ast.Assign) \
                        and self._is_flush_call(stmt.value):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            flush_vars.add(t.id)
                    state = _FLUSHED
                elif any(self._is_flush_call(sub) for sub in ast.walk(stmt)):
                    state = max(state, _FLUSH_DROPPED)
            return state

        walk(fn.body, _NONE)

    # -- FC402 -------------------------------------------------------------

    def scan_record_after_flush(self, fn: ast.AST) -> None:
        flush_line: Optional[int] = None
        for node in ast.walk(fn):
            if self._is_flush_call(node):
                line = node.lineno
                flush_line = line if flush_line is None \
                    else min(flush_line, line)
        if flush_line is None:
            return
        for node in ast.walk(fn):
            if self._is_produce_call(node) and node.lineno > flush_line:
                self.findings.append(Finding(
                    "FC402", self.sf.relpath, node.lineno,
                    f"{self.cls.name}.{fn.name}: record produced AFTER the "
                    f"batch's flush (line {flush_line}) — it rides no "
                    f"delivery accounting, so a commit can orphan it; "
                    f"produce every record (outputs, DLQ, annotations) "
                    f"before the flush that accounts for the batch"))

    # -- FC403 -------------------------------------------------------------

    def scan_drain_guard(self, fn: ast.AST) -> None:
        if not self.spec.drain_names or self.spec.failure_flag is None:
            return
        where = f"{self.cls.name}.{fn.name}"

        def drains_in(body: List[ast.stmt], guarded: bool) -> None:
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                g = guarded
                if isinstance(stmt, (ast.If, ast.While)) \
                        and self._flag_in_test(stmt.test):
                    g = True
                # recurse structurally so nested guard tests accumulate
                for field_name in ("body", "orelse", "finalbody"):
                    inner = getattr(stmt, field_name, None)
                    if inner:
                        drains_in(inner, g)
                for handler in getattr(stmt, "handlers", ()):
                    drains_in(handler.body, g)
                if isinstance(stmt, (ast.Expr, ast.Assign, ast.Return)):
                    for sub in ast.walk(stmt):
                        if self._is_drain_call(sub) and not g:
                            self.findings.append(Finding(
                                "FC403", self.sf.relpath, sub.lineno,
                                f"{where}: in-flight drain in a cleanup "
                                f"path without checking self."
                                f"{self.spec.failure_flag} — after a failed "
                                f"flush this finishes (and commits) batches "
                                f"queued BEHIND the failed one, orphaning "
                                f"its outputs"))

        # (a) finally-block drains must be flag-guarded
        for node in ast.walk(fn):
            if isinstance(node, ast.Try) and node.finalbody:
                drains_in(node.finalbody, False)

        # (b) public entries that drain must consult the flag somewhere
        if fn.name.startswith("_"):
            return
        has_drain = any(self._is_drain_call(sub) for sub in ast.walk(fn)
                        if not self._inside_finally(fn, sub))
        if not has_drain:
            return
        flag = self.spec.failure_flag
        checks_flag = any(
            isinstance(sub, ast.Attribute) and sub.attr == flag
            and isinstance(sub.value, ast.Name) and sub.value.id == "self"
            and not self._is_store(sub)
            for sub in ast.walk(fn))
        if not checks_flag:
            first = next(sub.lineno for sub in ast.walk(fn)
                         if self._is_drain_call(sub))
            self.findings.append(Finding(
                "FC403", self.sf.relpath, first,
                f"{where}: public entry drains/finishes batches without "
                f"ever consulting self.{flag} — after a previous batch's "
                f"failed flush, the next call here would commit offsets "
                f"past the lost outputs; check (or reset with full "
                f"incarnation semantics, like run()) the flag first"))

    @staticmethod
    def _is_store(node: ast.Attribute) -> bool:
        return isinstance(node.ctx, (ast.Store, ast.Del))

    @staticmethod
    def _inside_finally(fn: ast.AST, target: ast.AST) -> bool:
        for node in ast.walk(fn):
            if isinstance(node, ast.Try) and node.finalbody:
                for stmt in node.finalbody:
                    for sub in ast.walk(stmt):
                        if sub is target:
                            return True
        return False


# ---------------------------------------------------------------------------
# FC404 — package-wide bare-acquire scan
# ---------------------------------------------------------------------------

def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - malformed synthetic trees
        return ""


def _scan_lock_leaks(sf) -> List[Finding]:
    findings: List[Finding] = []
    safe_ids: Set[int] = set()

    def release_targets(body: List[ast.stmt]) -> Set[str]:
        out: Set[str] = set()
        for stmt in body:
            for sub in ast.walk(stmt):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "release"):
                    out.add(_unparse(sub.func.value))
        return out

    # Pass 1: bless acquire statements immediately followed by a
    # try/finally that releases the same receiver.
    for node in ast.walk(sf.tree):
        body_lists = [getattr(node, f, None)
                      for f in ("body", "orelse", "finalbody")]
        body_lists += [h.body for h in getattr(node, "handlers", ())]
        for body in body_lists:
            if not isinstance(body, list):
                continue
            for stmt, nxt in zip(body, body[1:] + [None]):
                value = (stmt.value if isinstance(stmt, (ast.Expr, ast.Assign))
                         else None)
                if not (isinstance(value, ast.Call)
                        and isinstance(value.func, ast.Attribute)
                        and value.func.attr == "acquire"):
                    continue
                recv = _unparse(value.func.value)
                if (isinstance(nxt, ast.Try) and nxt.finalbody
                        and recv in release_targets(nxt.finalbody)):
                    safe_ids.add(id(value))

    # Pass 2: every other .acquire() call is a leak-on-exception.
    for node in ast.walk(sf.tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "acquire"
                and id(node) not in safe_ids):
            recv = _unparse(node.func.value) or "<lock>"
            findings.append(Finding(
                "FC404", sf.relpath, node.lineno,
                f"bare {recv}.acquire() with no try/finally release "
                f"directly after it — any exception before the release "
                f"leaks the lock and deadlocks every later acquirer; use "
                f"`with {recv}:` (or acquire();try:...finally:release())"))
    return findings


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def analyze(files: Sequence, *, protocols=None) -> List[Finding]:
    """FC401-403 over registered protocol classes + FC404 package-wide.
    ``protocols`` overrides the entrypoints registry (tests feed fixture
    specs through it)."""
    from fraud_detection_tpu_torch.analysis.entrypoints import COMMIT_PROTOCOLS

    protocols = COMMIT_PROTOCOLS if protocols is None else protocols
    by_key = {p.cls_key: p for p in protocols}
    findings: List[Finding] = []
    for sf in files:
        findings += _scan_lock_leaks(sf)
        for node in sf.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            spec = by_key.get(f"{sf.relpath}::{node.name}")
            if spec is None:
                continue
            scan = _ClassScan(sf, node, spec)
            for fn in node.body:
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                scan._collect_aliases(fn)
                scan.scan_commit_order(fn)
                scan.scan_record_after_flush(fn)
                scan.scan_drain_guard(fn)
            findings += scan.findings
    return findings
