"""flightcheck core: finding model, pragma handling, source loading, runner
— the port's twin of ``fraud_detection_tpu/analysis/core.py``.

The analyzers are pure-AST (stdlib ``ast`` only — no runtime imports of the
modules under analysis), so the CLI runs anywhere the source tree exists,
with no torch import at all.

The rule catalog is the reference's minus FC201 (``jax.jit`` inside a
function body) and FC202 (a Python branch on a traced value in a jitted
function): both police JAX tracing, and the port traces nothing — it has
no ``jit`` and no ``torch.compile`` — so they have no counterpart.

Suppression: a finding is dropped when the flagged line — or the line
directly above it — carries a ``# flightcheck: ignore[RULE]`` pragma naming
the finding's rule (comma-separate for several:
``# flightcheck: ignore[FC102,FC203] — why``). Pragmas are deliberate
false-positive records; the trailing free text should say why, and the
suppressed count is reported so silent pragma creep is visible.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set

_PRAGMA_RE = re.compile(r"#\s*flightcheck:\s*ignore\[([A-Z0-9_,\s]+)\]")

#: Rule catalog: id -> (name, one-line summary); the reference's catalog
#: without FC201/FC202 (module docstring).
RULES: Dict[str, tuple] = {
    "FC101": ("lock-order",
              "inconsistent lock acquisition order (potential deadlock "
              "cycle in the class lock graph)"),
    "FC102": ("unguarded-shared-write",
              "write to a thread-shared attribute outside any lock region"),
    "FC103": ("thread-registry-drift",
              "thread spawn site, entry-point registry, and racecheck "
              "instrumentation list disagree"),
    "FC203": ("host-sync",
              ".item()/float()/int() device sync inside a hot-loop "
              "function"),
    "FC204": ("ladder-bypass",
              "literal batch dim at a jit/predict call site that is not a "
              "prewarmed padding-ladder rung"),
    "FC301": ("health-schema-drift",
              "health()/snapshot() key set disagrees with the contract "
              "test schema"),
    "FC401": ("commit-order",
              "offset commit reachable without a verified producer flush "
              "(no flush on the path, flush result dropped, or failure "
              "branch falls through to the commit)"),
    "FC402": ("record-after-flush",
              "record produced after the batch's flush — it rides no "
              "delivery accounting and a commit can orphan it"),
    "FC403": ("unguarded-drain",
              "in-flight batches drained without checking the flush-"
              "failure flag (cleanup path or public entry)"),
    "FC404": ("lock-leak",
              "bare lock.acquire() without a with/try-finally release — "
              "an exception between acquire and release leaks the lock"),
    "FC501": ("transition-missing-from-spec",
              "a fleet-protocol call site no FLEET_PROTOCOLS transition "
              "claims — the model checker never explores this "
              "interleaving"),
    "FC502": ("spec-transition-unreachable",
              "a FLEET_PROTOCOLS transition whose code anchor (or its "
              "required implementation call) no longer exists — spec "
              "drifted from the tree"),
    "FC503": ("fence-barrier-drift",
              "a fence/barrier call-site shape obligation violated "
              "(ordering or presence) — the choreography's safety "
              "argument no longer holds as written"),
    "FC504": ("protocol-model-violation",
              "the fleet protocol model checker found an invariant-"
              "violating interleaving (counterexample trace attached)"),
    "FC505": ("trace-nonconformance",
              "a recorded control-lane run is not a valid word of the "
              "declared role state machines (unknown transition, "
              "out-of-order step, seq gap, or stale-term record)"),
}


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative posix path
    line: int
    message: str

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule}"
                f"[{RULES[self.rule][0]}]: {self.message}")


@dataclass
class SourceFile:
    """One parsed module plus its pragma map."""

    path: str               # absolute
    relpath: str            # package-relative posix path (engine keys use it)
    text: str
    tree: ast.Module
    ignores: Dict[int, Set[str]] = field(default_factory=dict)

    @classmethod
    def load(cls, path: str, relpath: str) -> Optional["SourceFile"]:
        try:
            with open(path, "r", encoding="utf-8") as f:
                text = f.read()
            tree = ast.parse(text, filename=path)
        except (OSError, SyntaxError):
            return None
        ignores: Dict[int, Set[str]] = {}
        for lineno, line in enumerate(text.splitlines(), start=1):
            m = _PRAGMA_RE.search(line)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                ignores[lineno] = rules
        return cls(path=path, relpath=relpath, text=text, tree=tree,
                   ignores=ignores)

    def suppressed(self, rule: str, line: int) -> bool:
        for at in (line, line - 1):
            if rule in self.ignores.get(at, ()):
                return True
        return False


def load_package(root: str, *,
                 exclude: Sequence[str] = ("analysis",)) -> List[SourceFile]:
    """Every ``.py`` under the package ``root``, parsed; ``exclude`` prunes
    top-level subpackages (the analyzer doesn't lint itself — its fixtures
    would be findings)."""
    files: List[SourceFile] = []
    root = os.path.abspath(root)
    for dirpath, dirnames, filenames in os.walk(root):
        rel_dir = os.path.relpath(dirpath, root)
        top = rel_dir.split(os.sep)[0]
        if top in exclude or "__pycache__" in dirpath:
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            if top in exclude:
                continue
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            sf = SourceFile.load(path, rel)
            if sf is not None:
                files.append(sf)
    return files


def filter_suppressed(files_by_rel: Dict[str, SourceFile],
                      findings: Iterable[Finding]) -> tuple:
    """Split raw findings into (kept, n_suppressed) honoring pragmas."""
    kept: List[Finding] = []
    suppressed = 0
    for f in findings:
        sf = files_by_rel.get(f.path)
        if sf is not None and sf.suppressed(f.rule, f.line):
            suppressed += 1
        else:
            kept.append(f)
    return kept, suppressed


def resolve_roots(package_root: Optional[str] = None,
                  tests_dir: Optional[str] = None) -> tuple:
    """Default-resolve (package_root, tests_dir) the way the CLI does —
    the port's package (``fraud_detection_tpu_torch/``), with tests/ as its
    sibling when present."""
    if package_root is None:
        package_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
    if tests_dir is None:
        cand = os.path.join(os.path.dirname(package_root), "tests")
        tests_dir = cand if os.path.isdir(cand) else None
    return package_root, tests_dir


def run_analysis(package_root: Optional[str] = None,
                 tests_dir: Optional[str] = None,
                 rules: Optional[Set[str]] = None,
                 cache_dir: Optional[str] = None,
                 stats: Optional[dict] = None) -> tuple:
    """Run every analyzer over the package tree.

    Returns ``(findings, n_suppressed, n_files)`` with pragma suppression
    applied. ``rules`` restricts to a subset of rule ids (a finding whose
    rule is excluded is neither reported nor counted). ``cache_dir``
    enables the incremental per-file cache (analysis/cache.py) for the
    file-local passes; whole-program passes always run fresh. ``stats``,
    when given, is filled in place with cache hit/miss counts."""
    from fraud_detection_tpu_torch.analysis import (callgraph, concurrency,
                                                    health, model, protocol,
                                                    synclint)
    from fraud_detection_tpu_torch.analysis import threads as threadmap

    package_root, tests_dir = resolve_roots(package_root, tests_dir)

    files = load_package(package_root)
    by_rel = {f.relpath: f for f in files}

    cache = None
    if cache_dir is not None:
        from fraud_detection_tpu_torch.analysis.cache import AnalysisCache

        cache = AnalysisCache(cache_dir)

    # file-local passes (cacheable per file: findings depend only on the
    # file's content + the registries folded into the cache salt)
    raw: List[Finding] = []
    for sf in files:
        cached = cache.get(sf) if cache is not None else None
        if cached is None:
            cached = (concurrency.analyze([sf]) + protocol.analyze([sf])
                      + synclint.analyze([sf]))
            if cache is not None:
                cache.put(sf, cached)
        raw += cached

    # whole-program passes (always fresh: they read the cross-file facts)
    raw += callgraph.analyze(files)
    raw += threadmap.analyze(files, package_root=package_root)
    raw += health.analyze(files, tests_dir=tests_dir)
    raw += model.analyze(files)

    if stats is not None and cache is not None:
        stats.update(cache.stats())

    if rules is not None:
        raw = [f for f in raw if f.rule in rules]
    findings, suppressed = filter_suppressed(by_rel, raw)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, suppressed, len(files)
