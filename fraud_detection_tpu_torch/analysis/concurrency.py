"""FC101/FC102 — lock-discipline lint over the package's concurrent classes.
The port's twin of ``fraud_detection_tpu/analysis/concurrency.py``.

Model (docs/static_analysis.md has the worked examples):

* A class's **locks** are the attributes assigned ``threading.Lock()`` /
  ``RLock()`` / ``Condition()`` or a racecheck ``ExclusiveRegion(...)`` in
  ``__init__``. ``with self._lock:`` opens a lock region; everything
  lexically inside holds it.
* Held-lock sets propagate **interprocedurally through self-calls**: a
  method only ever invoked while the caller holds the drive region is
  analyzed as holding it too (the engine's whole dispatch/finish tree runs
  under ``run()``'s region without re-entering it). The propagation is a
  fixed point: a method's context is the INTERSECTION of every call site's
  held set — one unguarded call site strips the guarantee.
* **Thread roles** come from the entrypoints registry
  (:data:`~fraud_detection_tpu_torch.analysis.entrypoints.CONCURRENT_CLASSES`):
  worker entry methods and their self-call closure run on that worker's
  thread; ``any_thread`` methods run anywhere; the rest is the primary
  thread. An attribute is *shared* when methods of two different roles
  touch it (or an any-thread method writes it).
* **FC102**: a write (outside ``__init__``/``__del__``, and outside
  ``*_locked``-suffixed methods, whose name documents "caller holds the
  lock") to a shared attribute with no lock held.
* **FC101**: taking lock B while holding lock A adds edge A->B to the
  class's lock graph (caller context included); a cycle means two code
  paths can acquire the same locks in opposite orders — the classic
  deadlock shape. Reads are never flagged: racy health snapshots are a
  documented design choice here; it's unguarded WRITES that corrupt.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from fraud_detection_tpu_torch.analysis.core import Finding
from fraud_detection_tpu_torch.analysis.entrypoints import (CONCURRENT_CLASSES,
                                                      ClassSpec)

LOCK_CALLS = {"Lock", "RLock", "Condition", "ExclusiveRegion"}


@dataclass
class WriteSite:
    attr: str                # root attribute name (self.X...)
    line: int
    held: FrozenSet[str]     # lexically held locks at the write


@dataclass
class CallSite:
    callee: str              # self.<callee>(...)
    held: FrozenSet[str]


@dataclass
class MethodInfo:
    name: str
    line: int
    writes: List[WriteSite] = field(default_factory=list)
    reads: Set[str] = field(default_factory=set)
    calls: List[CallSite] = field(default_factory=list)
    # (outer_lock, inner_lock, line) lexical acquisition pairs
    lock_edges: List[Tuple[str, str, int]] = field(default_factory=list)


def _self_attr_root(node: ast.AST) -> Optional[str]:
    """`self.X`, `self.X.Y`, `self.X[i]`... -> "X" (None if not self-rooted)."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        parent = node.value
        if (isinstance(node, ast.Attribute)
                and isinstance(parent, ast.Name) and parent.id == "self"):
            return node.attr
        node = parent
    return None


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    """Attributes assigned a Lock/RLock/Condition/ExclusiveRegion anywhere
    in the class body (normally ``__init__``)."""
    locks: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign) or not isinstance(
                node.value, ast.Call):
            continue
        fn = node.value.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None)
        if name not in LOCK_CALLS:
            continue
        for target in node.targets:
            root = _self_attr_root(target)
            if root is not None:
                locks.add(root)
    return locks


class _MethodScanner(ast.NodeVisitor):
    """Walks one method body tracking the lexically-held lock stack."""

    def __init__(self, locks: Set[str], info: MethodInfo):
        self.locks = locks
        self.info = info
        self.held: List[str] = []

    # -- lock regions -----------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        acquired: List[str] = []
        for item in node.items:
            root = _self_attr_root(item.context_expr)
            if root in self.locks:
                for outer in self.held:
                    self.info.lock_edges.append((outer, root, node.lineno))
                self.held.append(root)
                acquired.append(root)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()

    # -- nested defs run on their own (unknown) call stack ----------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        saved, self.held = self.held, []
        for stmt in node.body:
            self.visit(stmt)
        self.held = saved

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- writes / reads / self-calls --------------------------------------

    def _record_write(self, target: ast.AST, line: int) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._record_write(elt, line)
            return
        root = _self_attr_root(target)
        if root is not None:
            self.info.writes.append(
                WriteSite(root, line, frozenset(self.held)))

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            self._record_write(target, node.lineno)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_write(node.target, node.lineno)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_write(node.target, node.lineno)
            self.visit(node.value)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            self.info.reads.add(node.attr)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if (isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name) and fn.value.id == "self"):
            self.info.calls.append(CallSite(fn.attr, frozenset(self.held)))
        self.generic_visit(node)


def _scan_class(cls: ast.ClassDef) -> Tuple[Set[str], Dict[str, MethodInfo]]:
    locks = _lock_attrs(cls)
    methods: Dict[str, MethodInfo] = {}
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info = MethodInfo(node.name, node.lineno)
            scanner = _MethodScanner(locks, info)
            for stmt in node.body:
                scanner.visit(stmt)
            methods[node.name] = info
    return locks, methods


def _contexts(methods: Dict[str, MethodInfo],
              entry_methods: Set[str]) -> Dict[str, FrozenSet[str]]:
    """Fixed-point held-lock context per method.

    Externally callable methods (public names, dunders, declared entry
    points) are seeded with the empty context; a private method's context
    is the intersection over every internal call site of the caller's
    context plus the locks lexically held at the call."""
    internal_callers: Dict[str, int] = {name: 0 for name in methods}
    for info in methods.values():
        for call in info.calls:
            if call.callee in internal_callers:
                internal_callers[call.callee] += 1
    ctx: Dict[str, Optional[FrozenSet[str]]] = {}
    for name in methods:
        external = (not name.startswith("_")) or (
            name.startswith("__") and name.endswith("__"))
        # A private method nobody in the class calls is externally driven
        # (tests, other classes): seed it unguarded so ITS calls propagate.
        orphan = internal_callers[name] == 0
        ctx[name] = (frozenset() if external or orphan
                     or name in entry_methods else None)
    for _ in range(len(methods) + 1):
        changed = False
        for name, info in methods.items():
            base = ctx[name]
            if base is None:
                continue
            for call in info.calls:
                if call.callee not in methods:
                    continue
                eff = base | call.held
                cur = ctx[call.callee]
                new = eff if cur is None else cur & eff
                if new != cur:
                    ctx[call.callee] = new
                    changed = True
        if not changed:
            break
    return {name: (c if c is not None else frozenset())
            for name, c in ctx.items()}


def _closure(methods: Dict[str, MethodInfo], roots: Set[str]) -> Set[str]:
    seen = set(r for r in roots if r in methods)
    frontier = list(seen)
    while frontier:
        m = frontier.pop()
        for call in methods[m].calls:
            if call.callee in methods and call.callee not in seen:
                seen.add(call.callee)
                frontier.append(call.callee)
    return seen


def _roles(methods: Dict[str, MethodInfo],
           spec: ClassSpec) -> Dict[str, Set[str]]:
    """method -> set of role labels ("main", worker roles, "any")."""
    roles: Dict[str, Set[str]] = {name: set() for name in methods}
    for role, entries in spec.workers.items():
        for m in _closure(methods, set(entries)):
            roles[m].add(role)
    for m in spec.any_thread:
        if m in roles:
            roles[m].add("any")
    for name, rs in roles.items():
        if not rs:
            rs.add("main")
    return roles


def analyze(files: Sequence, *,
            registry: Optional[Dict[str, ClassSpec]] = None) -> List[Finding]:
    """Run FC101 over every class and FC102 over the registered concurrent
    classes. ``registry`` overrides the entrypoints map (tests feed fixture
    specs through it)."""
    registry = CONCURRENT_CLASSES if registry is None else registry
    findings: List[Finding] = []
    for sf in files:
        for node in sf.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            locks, methods = _scan_class(node)
            if not locks:
                continue
            spec = registry.get(f"{sf.relpath}::{node.name}")
            entry_methods: Set[str] = set()
            if spec is not None:
                for entries in spec.workers.values():
                    entry_methods |= set(entries)
                entry_methods |= set(spec.any_thread)
            ctx = _contexts(methods, entry_methods)
            findings += _lock_order(sf, node.name, methods, ctx)
            if spec is not None:
                findings += _shared_writes(sf, node.name, locks, methods,
                                           ctx, spec)
    return findings


def _lock_order(sf, clsname: str, methods: Dict[str, MethodInfo],
                ctx: Dict[str, FrozenSet[str]]) -> List[Finding]:
    """FC101: cycle in the class's lock-acquisition graph."""
    edges: Dict[Tuple[str, str], int] = {}
    for name, info in methods.items():
        base = ctx[name]
        for outer, inner, line in info.lock_edges:
            if outer != inner:
                edges.setdefault((outer, inner), line)
        # context-held locks order before any lexically-acquired one
        for _, inner, line in info.lock_edges:
            for outer in base:
                if outer != inner:
                    edges.setdefault((outer, inner), line)
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    findings = []
    for (a, b), line in sorted(edges.items(), key=lambda kv: kv[1]):
        if _reaches(graph, b, a):
            findings.append(Finding(
                "FC101", sf.relpath, line,
                f"{clsname}: acquires self.{b} while holding self.{a}, but "
                f"another path acquires self.{a} while holding self.{b} — "
                f"inconsistent lock order can deadlock"))
    return findings


def _reaches(graph: Dict[str, Set[str]], src: str, dst: str) -> bool:
    seen: Set[str] = set()
    frontier = [src]
    while frontier:
        n = frontier.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        frontier.extend(graph.get(n, ()))
    return False


def _shared_writes(sf, clsname: str, locks: Set[str],
                   methods: Dict[str, MethodInfo],
                   ctx: Dict[str, FrozenSet[str]],
                   spec: ClassSpec) -> List[Finding]:
    """FC102: unguarded write to an attribute two thread roles share."""
    roles = _roles(methods, spec)
    attr_roles: Dict[str, Set[str]] = {}
    attr_any_write: Set[str] = set()
    for name, info in methods.items():
        if name in ("__init__", "__del__"):
            continue
        touched = set(info.reads) | {w.attr for w in info.writes}
        for attr in touched:
            attr_roles.setdefault(attr, set()).update(roles[name])
        if "any" in roles[name]:
            attr_any_write.update(w.attr for w in info.writes)
    shared = {attr for attr, rs in attr_roles.items()
              if len(rs - {"any"}) + ("any" in rs) >= 2} | attr_any_write

    findings = []
    for name, info in methods.items():
        if name in ("__init__", "__del__") or name.endswith("_locked"):
            continue
        for w in info.writes:
            if w.attr in locks or w.attr not in shared:
                continue
            held = w.held | ctx[name]
            if held & locks:
                continue
            role_str = "/".join(sorted(roles[name]))
            other = sorted(attr_roles[w.attr] - roles[name]) or ["any"]
            findings.append(Finding(
                "FC102", sf.relpath, w.line,
                f"{clsname}.{name} ({role_str} thread) writes shared "
                f"attribute self.{w.attr} with no lock held (also touched "
                f"from {'/'.join(other)} thread(s)); guard it with one of "
                f"{sorted('self.' + l for l in locks)} or record a "
                f"deliberate exception with a pragma"))
    return findings
