"""Counterexample trace rendering for ``flightcheck model``.
The port's twin of ``fraud_detection_tpu/analysis/traces.py``.

A violated invariant is only useful if a human can replay it: the checker
returns the SHORTEST offending interleaving (BFS order), and this module
renders it as a numbered step list — who acted, what they did, what it
means — followed by the invariant and its explanation, the same shape the
chaos suite's failure dumps take. ``to_finding`` adapts a violation onto
the ordinary :class:`~fraud_detection_tpu_torch.analysis.core.Finding` model so
counterexamples ride the existing ``--sarif`` output (rule FC504) and CI
code-scanning annotates the module that owns the violated choreography.

Liveness counterexamples (``check_liveness``) are LASSOS — a finite stem
reaching a cycle that repeats forever under a weakly-fair scheduler — and
render as two numbered sections: the stem, then the cycle marked
``(repeats forever)``. ``lasso_to_finding`` adapts them onto the same
FC504 SARIF rule.
"""

from __future__ import annotations

from typing import List

from fraud_detection_tpu_torch.analysis.checker import (CheckConfig, CheckResult,
                                                  Lasso, LivenessResult,
                                                  Violation)
from fraud_detection_tpu_torch.analysis.core import Finding

#: invariant -> (owning module, one-line meaning) for finding anchoring.
_INVARIANT_HOME = {
    "no_duplicate": ("fleet/coordinator.py",
                     "a row was delivered under two successful commits"),
    "no_loss": ("fleet/worker.py",
                "the fleet went quiescent with undelivered rows"),
    "no_zombie_commit": ("stream/broker.py",
                         "a commit advanced a partition its worker no "
                         "longer owns"),
    "revoke_barrier": ("fleet/coordinator.py",
                       "a pair's new owner polled it before the old "
                       "owner's commit-ack"),
    "no_self_expiry": ("fleet/coordinator.py",
                       "a syncing member expired itself"),
    # The "eventually" class (check_liveness lassos).
    "every_row_eventually_committed": (
        "fleet/coordinator.py",
        "a fair schedule exists on which rows are never delivered"),
    "every_drain_eventually_acked": (
        "fleet/worker.py",
        "a draining worker never completes its barrier ack"),
    "election_eventually_converges": (
        "fleet/control.py",
        "the coordinator role never converges to a stable leader"),
    "autoscale_eventually_stabilizes": (
        "fleet/autoscale/controller.py",
        "scaling decisions never quiesce — capacity flaps forever"),
}


def render(result: CheckResult, cfg: CheckConfig) -> str:
    """Human-readable report for any checker outcome."""
    lines: List[str] = []
    muts = ",".join(sorted(cfg.mutations)) or "none"
    line = (f"flightcheck model: workers={cfg.workers} "
            f"partitions={cfg.partitions} keys={cfg.keys_per_partition} "
            f"crashes<={cfg.max_crashes} lapses<={cfg.max_lapses} "
            f"mutations={muts}")
    if cfg.candidates > 1:
        line += (f" candidates={cfg.candidates} "
                 f"coord_crashes<={cfg.max_coord_crashes} "
                 f"coord_lapses<={cfg.max_coord_lapses}")
    lines.append(line)
    lines.append(
        f"  explored {result.states} states / {result.transitions} "
        f"transitions to depth {result.depth} in {result.elapsed:.2f}s")
    if result.coverage:
        cov = "  ".join(f"{k}:{v}" for k, v in sorted(result.coverage.items()))
        lines.append(f"  action coverage: {cov}")
    if result.budget_exhausted:
        lines.append(f"  BUDGET EXHAUSTED: {result.budget_reason} — "
                     f"verification incomplete (shrink the configuration "
                     f"or raise the budget)")
        return "\n".join(lines)
    if result.ok:
        lines.append("  VERIFIED: all invariants hold over every explored "
                     "interleaving (no_duplicate, no_loss, "
                     "no_zombie_commit, revoke_barrier, no_self_expiry)")
        return "\n".join(lines)
    lines.append("")
    lines.append(render_trace(result.violation))
    return "\n".join(lines)


def render_trace(violation: Violation) -> str:
    lines: List[str] = []
    lines.append(f"counterexample: invariant `{violation.invariant}` "
                 f"violated after {len(violation.trace)} step(s) "
                 f"(shortest such interleaving):")
    width = len(str(len(violation.trace)))
    for i, step in enumerate(violation.trace, start=1):
        lines.append(f"  step {i:>{width}}  [{step.actor:>5}] "
                     f"{step.action:<6} {step.detail}")
    lines.append(f"  VIOLATION: {violation.detail}")
    return "\n".join(lines)


def render_liveness(result: LivenessResult, cfg: CheckConfig) -> str:
    """Human-readable report for a liveness (lasso) check outcome."""
    lines: List[str] = []
    muts = ",".join(sorted(cfg.mutations)) or "none"
    line = (f"flightcheck model --liveness: workers={cfg.workers} "
            f"partitions={cfg.partitions} keys={cfg.keys_per_partition} "
            f"crashes<={cfg.max_crashes} lapses<={cfg.max_lapses} "
            f"mutations={muts}")
    if cfg.candidates > 1:
        line += (f" candidates={cfg.candidates} "
                 f"coord_crashes<={cfg.max_coord_crashes} "
                 f"coord_lapses<={cfg.max_coord_lapses}")
    lines.append(line)
    lines.append(
        f"  explored {result.states} states / {result.transitions} "
        f"transitions, {result.sccs} SCCs in {result.elapsed:.2f}s")
    if result.budget_exhausted:
        lines.append(f"  BUDGET EXHAUSTED: {result.budget_reason} — "
                     f"verification incomplete (shrink the configuration "
                     f"or raise the budget)")
        return "\n".join(lines)
    if result.ok:
        lines.append("  VERIFIED: every weakly-fair cycle discharges its "
                     "obligations (" + ", ".join(result.checked) + ")")
        return "\n".join(lines)
    lines.append("")
    lines.append(render_lasso(result.lasso))
    return "\n".join(lines)


def render_lasso(lasso: Lasso) -> str:
    """Numbered stem + repeating cycle. The stem reaches the cycle's
    entry state; the cycle is a closed fair walk on which the named
    obligation never discharges — replaying it forever is a legal
    schedule under the declared fairness, so the property fails."""
    lines: List[str] = []
    total = len(lasso.stem) + len(lasso.cycle)
    lines.append(f"lasso counterexample: eventually-invariant "
                 f"`{lasso.invariant}` — the obligation never discharges "
                 f"on a weakly-fair cycle "
                 f"(stem {len(lasso.stem)} step(s), "
                 f"cycle {len(lasso.cycle)} step(s)):")
    width = len(str(total))
    lines.append("  stem (reaches the cycle):")
    if not lasso.stem:
        lines.append("    (empty — the cycle is reachable from the "
                     "initial state)")
    for i, step in enumerate(lasso.stem, start=1):
        lines.append(f"  step {i:>{width}}  [{step.actor:>5}] "
                     f"{step.action:<6} {step.detail}")
    lines.append("  cycle (repeats forever under a fair schedule):")
    for i, step in enumerate(lasso.cycle, start=len(lasso.stem) + 1):
        lines.append(f"  step {i:>{width}}  [{step.actor:>5}] "
                     f"{step.action:<6} {step.detail} ↻")
    lines.append(f"  LIVELOCK: {lasso.detail}")
    return "\n".join(lines)


def lasso_to_finding(lasso: Lasso) -> Finding:
    """Adapt a lasso onto the Finding model (rule FC504, same as safety
    counterexamples) so liveness violations ride ``--sarif`` unchanged:
    anchored at the module owning the starved obligation, message =
    meaning + numbered stem then cycle steps."""
    home, meaning = _INVARIANT_HOME.get(
        lasso.invariant, ("fleet/coordinator.py", lasso.invariant))
    stem = "; ".join(
        f"{i}. {s.actor} {s.action}: {s.detail}"
        for i, s in enumerate(lasso.stem, start=1))
    cycle = "; ".join(
        f"{i}. {s.actor} {s.action}: {s.detail}"
        for i, s in enumerate(lasso.cycle, start=len(lasso.stem) + 1))
    return Finding(
        "FC504", home, 1,
        f"model checker lasso — {meaning} "
        f"(eventually-invariant {lasso.invariant}): {lasso.detail}. "
        f"Trace: stem: {stem or '(empty)'}; "
        f"cycle (repeats forever): {cycle}")


def to_finding(violation: Violation) -> Finding:
    """Adapt a counterexample onto the Finding model (rule FC504) so it
    rides ``--sarif``: anchored at the module owning the violated
    invariant, message = meaning + the full replayable trace."""
    home, meaning = _INVARIANT_HOME.get(
        violation.invariant, ("fleet/coordinator.py", violation.invariant))
    steps = "; ".join(
        f"{i}. {s.actor} {s.action}: {s.detail}"
        for i, s in enumerate(violation.trace, start=1))
    return Finding(
        "FC504", home, 1,
        f"model checker counterexample — {meaning} "
        f"(invariant {violation.invariant}): {violation.detail}. "
        f"Trace: {steps}")
