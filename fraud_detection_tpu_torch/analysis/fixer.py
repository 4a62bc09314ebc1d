"""``--fix`` — pragma scaffolding for flightcheck findings.
The port's twin of ``fraud_detection_tpu/analysis/fixer.py``.

The fixer never changes behavior: it cannot rewrite locks or reorder a
commit protocol. What it does is turn each finding into an explicit,
reviewable suppression site — a ``# flightcheck: ignore[RULE]`` pragma on
the line above the finding, carrying a ``TODO(justify)`` stub that the
clean-tree test and human review then force to be resolved: either the
code gets fixed and the pragma deleted, or the TODO becomes a real why.
That keeps the CLI's contract ("a pragma is a recorded false-positive
decision") intact while making triage of a new rule's first run on a big
tree mechanical instead of clerical.

Idempotency is structural: a scaffolded finding is suppressed on the next
run, so it produces no finding and therefore no edit — running ``--fix``
twice leaves the tree byte-identical (pinned by a test). When the line
above a finding already carries a pragma, the missing rule ids are merged
into its bracket instead of stacking a second pragma line.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

from fraud_detection_tpu_torch.analysis.core import Finding, _PRAGMA_RE

_TODO = "TODO(justify): scaffolded by --fix; explain why this is a " \
        "deliberate exception, or fix the code and delete this pragma"


@dataclass(frozen=True)
class Edit:
    """One applied (or planned) pragma insertion/merge."""

    path: str          # package-relative posix path
    line: int          # 1-indexed line the pragma lands on/above
    rules: Tuple[str, ...]
    action: str        # "insert" | "merge"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.action} pragma "
                f"ignore[{','.join(self.rules)}]")


def _merge_pragma(line: str, rules: List[str]) -> str:
    """Add missing rule ids into an existing pragma's bracket."""
    m = _PRAGMA_RE.search(line)
    assert m is not None
    existing = [r.strip() for r in m.group(1).split(",") if r.strip()]
    merged = existing + [r for r in rules if r not in existing]
    start, end = m.span(1)
    return line[:start] + ",".join(merged) + line[end:]


def apply_fixes(findings: Iterable[Finding], package_root: str, *,
                dry_run: bool = False) -> List[Edit]:
    """Scaffold suppression pragmas for ``findings`` under ``package_root``.
    Returns the edits (planned when ``dry_run``). Files are rewritten at
    most once each; findings on unreadable files are skipped."""
    by_path: Dict[str, Dict[int, List[str]]] = {}
    for f in findings:
        rules = by_path.setdefault(f.path, {}).setdefault(f.line, [])
        if f.rule not in rules:
            rules.append(f.rule)

    edits: List[Edit] = []
    for rel in sorted(by_path):
        abspath = os.path.join(package_root, *rel.split("/"))
        try:
            with open(abspath, "r", encoding="utf-8") as fh:
                text = fh.read()
        except OSError:
            continue
        lines = text.splitlines(keepends=True)
        changed = False
        # Bottom-up so earlier insertions don't shift later line numbers.
        for lineno in sorted(by_path[rel], reverse=True):
            rules = by_path[rel][lineno]
            if lineno < 1 or lineno > len(lines):
                continue
            target = lines[lineno - 1]
            above = lines[lineno - 2] if lineno >= 2 else ""
            if _PRAGMA_RE.search(target):
                lines[lineno - 1] = _merge_pragma(target, rules)
                edits.append(Edit(rel, lineno, tuple(rules), "merge"))
            elif _PRAGMA_RE.search(above):
                lines[lineno - 2] = _merge_pragma(above, rules)
                edits.append(Edit(rel, lineno - 1, tuple(rules), "merge"))
            else:
                indent = re.match(r"[ \t]*", target).group(0)
                eol = "\n" if target.endswith("\n") or lineno < len(lines) \
                    else ""
                pragma = (f"{indent}# flightcheck: "
                          f"ignore[{','.join(rules)}] — {_TODO}{eol}")
                lines.insert(lineno - 1, pragma)
                edits.append(Edit(rel, lineno, tuple(rules), "insert"))
            changed = True
        if changed and not dry_run:
            with open(abspath, "w", encoding="utf-8") as fh:
                fh.write("".join(lines))
    edits.sort(key=lambda e: (e.path, e.line))
    return edits
