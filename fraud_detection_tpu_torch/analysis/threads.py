"""FC103 — thread map, entry-point registry, racecheck instrumentation sync.
The port's twin of ``fraud_detection_tpu/analysis/threads.py``.

Three artifacts describe the same thing and rot independently:

1. the CODE spawns threads (``threading.Thread(...)`` /
   ``ThreadPoolExecutor(...)`` sites);
2. the entrypoints registry DOCUMENTS them
   (:data:`~fraud_detection_tpu_torch.analysis.entrypoints.THREAD_SITES` /
   :data:`THREAD_ENTRY_POINTS`);
3. the runtime detector INSTRUMENTS them
   (``utils.racecheck.INSTRUMENTED_REGIONS`` vs the
   ``ExclusiveRegion("...")`` / ``PairedCallChecker(name="...")``
   constructions actually present in the source).

FC103 fails the tree whenever any pair disagrees, so a new thread cannot
land without being registered AND a registered racecheck region cannot be
deleted from code while the list still claims coverage. The racecheck list
is read from ``utils/racecheck.py``'s AST (a literal set), not imported —
the linter never executes the code it audits.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional, Sequence, Set, Tuple

from fraud_detection_tpu_torch.analysis.core import Finding
from fraud_detection_tpu_torch.analysis.entrypoints import (THREAD_ENTRY_POINTS,
                                                      THREAD_SITES)

_RACECHECK_REL = "utils/racecheck.py"
_REGISTRY_NAME = "INSTRUMENTED_REGIONS"


def _call_name(node: ast.Call) -> Optional[str]:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _target_label(node: ast.Call) -> str:
    """The spawn site's target callable, as written (``loop``,
    ``self._worker``, ``run_worker``…); executors key on the class name."""
    for kw in node.keywords:
        if kw.arg == "target":
            v = kw.value
            if isinstance(v, ast.Name):
                return v.id
            if isinstance(v, ast.Attribute):
                base = v.value
                if isinstance(base, ast.Name) and base.id == "self":
                    return f"self.{v.attr}"
                return v.attr
            return ast.dump(v)[:40]
    return "<no target>"


def collect_thread_sites(files: Sequence) -> List[Tuple[str, str, int]]:
    sites: List[Tuple[str, str, int]] = []
    for sf in files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name == "Thread":
                sites.append((sf.relpath, _target_label(node), node.lineno))
            elif name == "ThreadPoolExecutor":
                sites.append((sf.relpath, "ThreadPoolExecutor", node.lineno))
    return sites


def collect_region_names(files: Sequence) -> List[Tuple[str, str, int]]:
    """Every ``ExclusiveRegion("<name>")`` / ``PairedCallChecker(name=...)``
    construction with a literal name in the package (racecheck.py itself
    excluded — it defines the classes, it doesn't instrument a contract)."""
    names: List[Tuple[str, str, int]] = []
    for sf in files:
        if sf.relpath == _RACECHECK_REL:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            if _call_name(node) not in ("ExclusiveRegion",
                                        "PairedCallChecker"):
                continue
            literal: Optional[str] = None
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                literal = node.args[0].value
            for kw in node.keywords:
                if kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                        and isinstance(kw.value.value, str):
                    literal = kw.value.value
            if literal is not None:
                names.append((sf.relpath, literal, node.lineno))
    return names


def parse_instrumented_registry(package_root: str) -> Optional[Set[str]]:
    """``INSTRUMENTED_REGIONS`` literal from utils/racecheck.py's AST."""
    path = os.path.join(package_root, "utils", "racecheck.py")
    try:
        with open(path, "r", encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return None
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if _REGISTRY_NAME in targets:
                return _literal_str_set(node.value)
    return None


def _literal_str_set(node: ast.AST) -> Set[str]:
    if isinstance(node, ast.Call) and _call_name(node) == "frozenset" \
            and node.args:
        node = node.args[0]
    if isinstance(node, (ast.Set, ast.Tuple, ast.List)):
        return {e.value for e in node.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)}
    return set()


def analyze(files: Sequence, *, package_root: str,
            sites_registry: Optional[Set[Tuple[str, str]]] = None,
            entry_points=None) -> List[Finding]:
    sites_registry = (THREAD_SITES if sites_registry is None
                      else sites_registry)
    entry_points = (THREAD_ENTRY_POINTS if entry_points is None
                    else entry_points)
    findings: List[Finding] = []

    # 1. spawn sites <-> THREAD_SITES
    seen_sites: Set[Tuple[str, str]] = set()
    for rel, target, line in collect_thread_sites(files):
        reg_key = (rel, target)
        seen_sites.add(reg_key)
        if reg_key not in sites_registry:
            findings.append(Finding(
                "FC103", rel, line,
                f"thread spawn site target={target!r} is not in the "
                f"analysis/entrypoints.py THREAD_SITES registry — register "
                f"it (and its racecheck coverage) before adding threads"))
    for (rel, target) in sorted(sites_registry - seen_sites):
        findings.append(Finding(
            "FC103", "analysis/entrypoints.py", 1,
            f"THREAD_SITES lists ({rel!r}, {target!r}) but no such spawn "
            f"site exists — stale registry entry"))

    # 2. source region names <-> racecheck.INSTRUMENTED_REGIONS
    instrumented = parse_instrumented_registry(package_root)
    if instrumented is None:
        findings.append(Finding(
            "FC103", _RACECHECK_REL, 1,
            f"utils/racecheck.py has no literal {_REGISTRY_NAME} set — the "
            f"runtime detector's coverage list is gone"))
        instrumented = set()
    source_regions = collect_region_names(files)
    source_names = {name for _, name, _ in source_regions}
    for rel, name, line in source_regions:
        if name not in instrumented:
            findings.append(Finding(
                "FC103", rel, line,
                f"racecheck region {name!r} constructed here is missing "
                f"from utils/racecheck.py {_REGISTRY_NAME}"))
    for name in sorted(instrumented - source_names):
        findings.append(Finding(
            "FC103", _RACECHECK_REL, 1,
            f"{_REGISTRY_NAME} lists {name!r} but no ExclusiveRegion/"
            f"PairedCallChecker in the package constructs it — stale "
            f"instrumentation claim"))

    # 3. entry points' claimed racecheck coverage must exist
    for ep in entry_points:
        if ep.racecheck is None:
            if not ep.why_uncovered:
                findings.append(Finding(
                    "FC103", "analysis/entrypoints.py", 1,
                    f"entry point {ep.qualname} ({ep.thread}) has no "
                    f"racecheck region and no why_uncovered justification"))
        elif ep.racecheck not in instrumented:
            findings.append(Finding(
                "FC103", "analysis/entrypoints.py", 1,
                f"entry point {ep.qualname} claims racecheck region "
                f"{ep.racecheck!r}, which is not in {_REGISTRY_NAME}"))
    return findings
