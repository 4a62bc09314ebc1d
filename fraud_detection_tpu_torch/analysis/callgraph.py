"""Whole-program lock-order analysis — the cross-object half of FC101.
The port's twin of ``fraud_detection_tpu/analysis/callgraph.py``.

The per-class pass (concurrency.py) sees only locks a class acquires on
``self``; it cannot see the engine holding its drive region while a call
chain three objects deep takes the broker's lock. This module builds the
project-wide view:

1. a **class index** over every analyzed file (top-level classes, their
   lock attributes, their methods);
2. an **attribute/parameter type binding** map: ``self.consumer`` on the
   engine is an ``InProcessConsumer``, the scheduler's ``collect(consumer)``
   parameter likewise. Bindings come from three sources, strongest first —
   direct instantiation (``self._lane = AsyncAnnotationLane(...)``),
   parameter annotations (``broker: InProcessBroker``), and the explicit
   :data:`~fraud_detection_tpu_torch.analysis.entrypoints.OBJECT_BINDINGS`
   registry for duck-typed seams. Protocol names (``Consumer``) expand to
   their in-tree implementations via :data:`IMPLEMENTATIONS`.
3. per-method **summaries**: qualified lock acquisitions
   (``"InProcessBroker._lock"``) with the lexically-held stack at each, and
   resolved call sites (self-calls, ``self.attr.m()``, local aliases,
   bound parameters, and direct constructions);
4. a transitive **acquires-closure** per method (what the whole call tree
   under it can lock), and from it a global qualified lock graph: edge
   ``A.x -> B.y`` whenever some path acquires ``B.y`` while ``A.x`` is
   held — including through any number of cross-object calls.

A cycle whose locks span two or more classes is the cross-object deadlock
shape FC101 exists for (engine drive region vs broker lock, controller
region vs hot-swap writer lock); same-class cycles are left to the
per-class pass so findings are never double-reported.

Soundness note (docs/static_analysis.md "call-graph limitations"): the
closure unions over all branches of a callee, so an edge may correspond to
a path the program never takes together — the analysis over-approximates
and a finding can be a false positive (pragma it with a why). It also
UNDER-approximates wherever a receiver cannot be bound (untyped
parameters, dynamic dispatch, containers of objects): an unbound call is
silently not followed, which is why the seams the engine actually crosses
are pinned in OBJECT_BINDINGS rather than inferred.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Set, Tuple

from fraud_detection_tpu_torch.analysis.core import Finding
from fraud_detection_tpu_torch.analysis.concurrency import _lock_attrs


# ---------------------------------------------------------------------------
# class index + bindings
# ---------------------------------------------------------------------------

@dataclass
class ClassInfo:
    name: str
    relpath: str
    node: ast.ClassDef
    locks: Set[str]
    methods: Dict[str, ast.AST] = field(default_factory=dict)
    # attribute name -> candidate class names it may hold
    attr_types: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    # (method, param) -> candidate class names
    param_types: Dict[Tuple[str, str], Tuple[str, ...]] = field(
        default_factory=dict)


def _attr_chain(node: ast.AST) -> Optional[List[str]]:
    """``self.broker._lock`` -> ["self", "broker", "_lock"]; None when the
    expression is not a plain Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return None


def _annotation_names(node: Optional[ast.AST]) -> List[str]:
    """Class names an annotation may refer to: ``Foo``, ``"Foo"``,
    ``Optional[Foo]``, ``mod.Foo`` -> ["Foo"]."""
    if node is None:
        return []
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, ast.Attribute):
        return [node.attr]
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        # forward reference; take the last dotted component
        return [node.value.split("[")[0].split(".")[-1].strip()]
    if isinstance(node, ast.Subscript):   # Optional[Foo], Union[Foo, None]...
        names: List[str] = []
        inner = node.slice
        elts = inner.elts if isinstance(inner, ast.Tuple) else [inner]
        for e in elts:
            names.extend(_annotation_names(e))
        return names
    return []


def build_index(files: Sequence,
                bindings: Mapping[str, Tuple[str, ...]],
                implementations: Mapping[str, Tuple[str, ...]]
                ) -> Dict[str, ClassInfo]:
    """Top-level classes across ``files`` with lock sets and type bindings.
    Class names are unique package-wide today (pinned by a test); on a
    collision the LAST definition wins and the earlier one simply stops
    contributing edges — degraded, never wrong-file findings."""
    index: Dict[str, ClassInfo] = {}
    for sf in files:
        for node in sf.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            ci = ClassInfo(node.name, sf.relpath, node, _lock_attrs(node))
            for fn in node.body:
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    ci.methods[fn.name] = fn
            index[node.name] = ci

    def expand(names: Sequence[str]) -> Tuple[str, ...]:
        out: List[str] = []
        for n in names:
            if n in index:
                out.append(n)
            for impl in implementations.get(n, ()):
                if impl in index and impl not in out:
                    out.append(impl)
        return tuple(dict.fromkeys(out))

    for ci in index.values():
        for mname, fn in ci.methods.items():
            ann: Dict[str, Tuple[str, ...]] = {}
            args = fn.args
            for a in args.posonlyargs + args.args + args.kwonlyargs:
                resolved = expand(_annotation_names(a.annotation))
                if resolved:
                    ann[a.arg] = resolved
                    ci.param_types[(mname, a.arg)] = resolved
            # self.x = Param | self.x = ClassName(...)
            for stmt in ast.walk(fn):
                if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
                    continue
                chain = _attr_chain(stmt.targets[0])
                if chain is None or len(chain) != 2 or chain[0] != "self":
                    continue
                attr = chain[1]
                v = stmt.value
                if (isinstance(v, ast.Call) and isinstance(v.func, ast.Name)
                        and v.func.id in index):
                    ci.attr_types.setdefault(attr, (v.func.id,))
                elif isinstance(v, ast.Name) and v.id in ann:
                    ci.attr_types.setdefault(attr, ann[v.id])
        # explicit registry entries override/extend inference
        prefix = f"{ci.relpath}::{ci.name}."
        for key, targets in bindings.items():
            if not key.startswith(prefix):
                continue
            rest = key[len(prefix):]
            resolved = expand(targets)
            if not resolved:
                continue
            if "." in rest:                      # Class.method.param
                mname, _, param = rest.partition(".")
                if mname == "*":                 # every method's `param`
                    for m in ci.methods:
                        ci.param_types[(m, param)] = resolved
                else:
                    ci.param_types[(mname, param)] = resolved
            else:                                # Class.attr
                ci.attr_types[rest] = resolved
    return index


# ---------------------------------------------------------------------------
# per-method summaries
# ---------------------------------------------------------------------------

@dataclass
class MethodSummary:
    key: str                    # "relpath::Class.method"
    relpath: str
    cls: str
    name: str
    # (qualified lock, line, held stack at acquisition)
    acquires: List[Tuple[str, int, Tuple[str, ...]]] = field(
        default_factory=list)
    # (candidate callee keys, held set, line)
    calls: List[Tuple[Tuple[str, ...], FrozenSet[str], int]] = field(
        default_factory=list)


class _MethodScanner(ast.NodeVisitor):
    def __init__(self, index: Dict[str, ClassInfo], ci: ClassInfo,
                 mname: str, summary: MethodSummary):
        self.index = index
        self.ci = ci
        self.summary = summary
        self.held: List[str] = []
        # local name -> candidate classes (params + `x = self.attr` aliases)
        self.locals: Dict[str, Tuple[str, ...]] = {
            p: t for (m, p), t in ci.param_types.items() if m == mname}

    # -- resolution helpers ------------------------------------------------

    def _classes_of(self, base: str, attr: Optional[str]) -> Tuple[str, ...]:
        """Candidate classes of ``base``/``base.attr`` receiver."""
        if base == "self":
            if attr is None:
                return (self.ci.name,)
            return self.ci.attr_types.get(attr, ())
        if attr is None:
            return self.locals.get(base, ())
        out: List[str] = []
        for c in self.locals.get(base, ()):
            ci = self.index.get(c)
            if ci is not None:
                out.extend(ci.attr_types.get(attr, ()))
        return tuple(dict.fromkeys(out))

    def _resolve_lock(self, expr: ast.AST) -> Optional[str]:
        chain = _attr_chain(expr)
        if chain is None or len(chain) < 2:
            return None
        *recv, lock = chain
        if len(recv) == 1:
            owners = self._classes_of(recv[0], None)
        elif len(recv) == 2:
            owners = self._classes_of(recv[0], recv[1])
        else:
            return None
        for owner in owners:
            ci = self.index.get(owner)
            if ci is not None and lock in ci.locks:
                return f"{owner}.{lock}"
        return None

    def _resolve_call(self, fn: ast.AST) -> Tuple[str, ...]:
        if isinstance(fn, ast.Name):            # ClassName(...) construction
            ci = self.index.get(fn.id)
            if ci is not None and "__init__" in ci.methods:
                return (f"{ci.relpath}::{ci.name}.__init__",)
            return ()
        chain = _attr_chain(fn)
        if chain is None or len(chain) < 2:
            return ()
        *recv, method = chain
        if len(recv) == 1:
            owners = self._classes_of(recv[0], None)
        elif len(recv) == 2:
            owners = self._classes_of(recv[0], recv[1])
        else:
            return ()
        keys: List[str] = []
        for owner in owners:
            ci = self.index.get(owner)
            if ci is not None and method in ci.methods:
                keys.append(f"{ci.relpath}::{ci.name}.{method}")
        return tuple(keys)

    # -- traversal ---------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        acquired: List[str] = []
        for item in node.items:
            q = self._resolve_lock(item.context_expr)
            if q is not None:
                self.summary.acquires.append(
                    (q, node.lineno, tuple(self.held)))
                self.held.append(q)
                acquired.append(q)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()

    visit_AsyncWith = visit_With

    def visit_FunctionDef(self, node) -> None:
        saved, self.held = self.held, []        # runs on an unknown stack
        for stmt in node.body:
            self.visit(stmt)
        self.held = saved

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node: ast.Assign) -> None:
        # alias tracking: x = self.attr / x = ClassName(...)
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            v = node.value
            chain = _attr_chain(v)
            if chain is not None and len(chain) == 2 and chain[0] == "self":
                bound = self.ci.attr_types.get(chain[1], ())
                if bound:
                    self.locals[name] = bound
            elif (isinstance(v, ast.Call) and isinstance(v.func, ast.Name)
                    and v.func.id in self.index):
                self.locals[name] = (v.func.id,)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        keys = self._resolve_call(node.func)
        if keys:
            self.summary.calls.append(
                (keys, frozenset(self.held), node.lineno))
        self.generic_visit(node)


def build_summaries(files: Sequence, index: Dict[str, ClassInfo]
                    ) -> Dict[str, MethodSummary]:
    summaries: Dict[str, MethodSummary] = {}
    for ci in index.values():
        for mname, fn in ci.methods.items():
            key = f"{ci.relpath}::{ci.name}.{mname}"
            s = MethodSummary(key, ci.relpath, ci.name, mname)
            scanner = _MethodScanner(index, ci, mname, s)
            for stmt in fn.body:
                scanner.visit(stmt)
            summaries[key] = s
    return summaries


def acquires_closure(summaries: Dict[str, MethodSummary]
                     ) -> Dict[str, FrozenSet[str]]:
    """Locks each method's whole call tree can acquire (union fixed point;
    converges in <= graph-diameter passes, bounded for safety)."""
    acq: Dict[str, Set[str]] = {
        k: {q for q, _, _ in s.acquires} for k, s in summaries.items()}
    for _ in range(len(summaries) + 1):
        changed = False
        for key, s in summaries.items():
            mine = acq[key]
            before = len(mine)
            for keys, _, _ in s.calls:
                for callee in keys:
                    if callee in acq:
                        mine |= acq[callee]
            if len(mine) != before:
                changed = True
        if not changed:
            break
    return {k: frozenset(v) for k, v in acq.items()}


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

def _owner(qlock: str) -> str:
    return qlock.split(".", 1)[0]


def _find_path(graph: Dict[str, Set[str]], src: str,
               dst: str) -> Optional[List[str]]:
    """Shortest src->dst node path (inclusive), None if unreachable."""
    if src == dst:
        return [src]
    seen = {src}
    frontier = [[src]]
    while frontier:
        nxt: List[List[str]] = []
        for path in frontier:
            for n in sorted(graph.get(path[-1], ())):
                if n == dst:
                    return path + [n]
                if n not in seen:
                    seen.add(n)
                    nxt.append(path + [n])
        frontier = nxt
    return None


def analyze(files: Sequence, *,
            bindings: Optional[Mapping[str, Tuple[str, ...]]] = None,
            implementations: Optional[Mapping[str, Tuple[str, ...]]] = None
            ) -> List[Finding]:
    """Cross-object FC101: cycles in the global qualified lock graph that
    span more than one class. ``bindings``/``implementations`` override the
    entrypoints registries (tests feed fixture seams through them)."""
    from fraud_detection_tpu_torch.analysis.entrypoints import (IMPLEMENTATIONS,
                                                          OBJECT_BINDINGS)

    bindings = OBJECT_BINDINGS if bindings is None else bindings
    implementations = (IMPLEMENTATIONS if implementations is None
                       else implementations)
    index = build_index(files, bindings, implementations)
    summaries = build_summaries(files, index)
    closure = acquires_closure(summaries)

    # (outer, inner) -> (relpath, line, via) first-seen acquisition site
    edges: Dict[Tuple[str, str], Tuple[str, int, Optional[str]]] = {}

    def add_edge(outer: str, inner: str, relpath: str, line: int,
                 via: Optional[str]) -> None:
        if outer != inner:
            edges.setdefault((outer, inner), (relpath, line, via))

    for s in summaries.values():
        for qlock, line, held in s.acquires:
            for h in held:
                add_edge(h, qlock, s.relpath, line, None)
        for keys, held, line in s.calls:
            if not held:
                continue
            for callee in keys:
                for qlock in closure.get(callee, ()):
                    for h in held:
                        add_edge(h, qlock, s.relpath, line, callee)

    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)

    findings: List[Finding] = []
    for (a, b), (relpath, line, via) in sorted(
            edges.items(), key=lambda kv: (kv[1][0], kv[1][1], kv[0])):
        back = _find_path(graph, b, a)
        if back is None:
            continue
        cycle_classes = {_owner(n) for n in [a, b, *back]}
        if len(cycle_classes) < 2:
            continue                 # per-class pass owns same-class cycles
        hop = (f" (via call into {via.split('::', 1)[1]})"
               if via is not None else "")
        findings.append(Finding(
            "FC101", relpath, line,
            f"cross-object lock order: acquires {b} while holding {a}"
            f"{hop}, but another path acquires {a} while holding {b} "
            f"(cycle: {' -> '.join([a, *back])}) — inconsistent "
            f"cross-object lock order can deadlock"))
    return findings
