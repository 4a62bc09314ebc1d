"""``python -m fraud_detection_tpu_torch.analysis`` — the port's flightcheck
CLI, twin of ``fraud_detection_tpu/analysis/__main__.py`` (same flags,
subcommands and exit codes).

Walks the package, runs every rule, prints findings as
``path:line: RULE[name]: message`` (stable order: path, line, rule), and
exits nonzero when any survive pragma suppression — the CI ``flightcheck``
job is exactly this command. See docs/static_analysis.md for the rule
catalog, the pragma syntax, the ``--fix`` workflow, and SARIF usage.

* ``--sarif PATH`` additionally writes the findings as a SARIF 2.1.0
  document (validated before writing) for code-scanning upload.
* ``--fix`` scaffolds ``# flightcheck: ignore[RULE]`` pragmas (with a
  required-justification TODO stub) over every finding; ``--dry-run``
  prints the planned edits without touching files. The exit code still
  reflects the findings — scaffolding is triage, not absolution.
* File-local passes ride the incremental cache (``.flightcheck_cache/``,
  analysis/cache.py) keyed on content hash; ``--no-cache`` disables it
  and ``--verbose`` reports hit/miss counts.

``flightcheck model`` runs the distributed-protocol model checker
(analysis/checker.py) over the fleet rebalance choreography: exit 0 when
every invariant holds over all bounded interleavings, 1 with a
counterexample trace (also written to ``--trace-file``, and to ``--sarif``
as an FC504 result), 2 when the state/wall budget was exhausted before
the frontier emptied. ``--mutate`` seeds a protocol mutation that MUST
produce a counterexample — the checker checking itself. ``--liveness``
switches to the eventually-invariants: lasso detection under weak
fairness over the same bounded space, exit 1 rendering the stem+cycle
counterexample (the three livelock mutations each MUST die this way).

``flightcheck conform`` replays a recorded control-lane run (``--input``:
a game-day ``--record`` file, a ``succession_report()`` dict, or a raw
record list) against the declared role state machines, tolerating exactly
the transport casualties the bus accounted: exit 0 conformant, 1 with
each violation citing the offending record (FC505 via ``--sarif``), 2 on
unreadable input.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from fraud_detection_tpu_torch.analysis.core import (RULES, resolve_roots,
                                               run_analysis)


def model_main(argv=None) -> int:
    from fraud_detection_tpu_torch.analysis.checker import (AUTOSCALE_CONFIG,
                                                      MUTATIONS,
                                                      SUCCESSION_CONFIG,
                                                      CheckConfig, check,
                                                      check_liveness)
    from fraud_detection_tpu_torch.analysis import traces

    parser = argparse.ArgumentParser(
        prog="flightcheck model",
        description="explicit-state model checking of the fleet rebalance "
                    "choreography (docs/static_analysis.md)")
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument("--partitions", type=int, default=2)
    parser.add_argument("--keys", type=int, default=2,
                        help="messages per partition")
    parser.add_argument("--max-crashes", type=int, default=1)
    parser.add_argument("--max-lapses", type=int, default=1,
                        help="live-worker lease lapses (the zombie-stall "
                             "adversary budget)")
    parser.add_argument("--candidates", type=int, default=1,
                        help="coordinator candidates contending on the "
                             "role lease (>= 2 enables the succession "
                             "environment)")
    parser.add_argument("--coord-crashes", type=int, default=0,
                        help="coordinator crash budget")
    parser.add_argument("--coord-lapses", type=int, default=0,
                        help="coordinator role-lease lapses (the zombie-"
                             "coordinator / delayed-decision adversary "
                             "budget)")
    parser.add_argument("--spares", type=int, default=0,
                        help="workers that start UNPROVISIONED until a "
                             "scale_out launches them (the elasticity "
                             "environment's capacity headroom)")
    parser.add_argument("--max-scale-ins", type=int, default=0,
                        help="coordinator-requested voluntary-leave "
                             "budget (scale_in decisions)")
    parser.add_argument("--succession", action="store_true",
                        help="use the headline succession configuration "
                             "(W=3/P=3, one coordinator crash + one "
                             "coordinator lapse on a lossy control lane); "
                             "overrides the topology flags")
    parser.add_argument("--autoscale", action="store_true",
                        help="use the headline elastic configuration "
                             "(W=3 with one spare to launch and one "
                             "voluntary leave, composed with one worker "
                             "crash and one coordinator crash); overrides "
                             "the topology flags")
    parser.add_argument("--mutate", default=None,
                        help="comma-separated protocol mutations to seed "
                             f"(known: {', '.join(MUTATIONS)})")
    parser.add_argument("--liveness", action="store_true",
                        help="check the eventually-invariants by lasso "
                             "detection under weak fairness instead of "
                             "the safety invariants; a violation renders "
                             "as stem + repeating cycle")
    parser.add_argument("--max-states", type=int, default=400_000)
    parser.add_argument("--max-seconds", type=float, default=120.0)
    parser.add_argument("--no-symmetry", action="store_true",
                        help="disable the worker-symmetry reduction")
    parser.add_argument("--trace-file", default=None, metavar="PATH",
                        help="write the full report (and any "
                             "counterexample trace) to PATH")
    parser.add_argument("--sarif", default=None, metavar="PATH",
                        help="write any counterexample as a SARIF 2.1.0 "
                             "FC504 result")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable result on stdout")
    parser.add_argument("--list-mutations", action="store_true")
    args = parser.parse_args(argv)

    if args.list_mutations:
        for m in MUTATIONS:
            print(m)
        return 0

    mutations = frozenset(
        m.strip() for m in (args.mutate or "").split(",") if m.strip())
    try:
        topology = dict(
            workers=args.workers, partitions=args.partitions,
            keys_per_partition=args.keys, max_crashes=args.max_crashes,
            max_lapses=args.max_lapses, candidates=args.candidates,
            max_coord_crashes=args.coord_crashes,
            max_coord_lapses=args.coord_lapses,
            spares=args.spares, max_scale_ins=args.max_scale_ins)
        if args.succession and args.autoscale:
            raise ValueError(
                "--succession and --autoscale are mutually exclusive "
                "presets")
        if args.succession:
            topology = dict(SUCCESSION_CONFIG)
        if args.autoscale:
            topology = dict(AUTOSCALE_CONFIG)
        cfg = CheckConfig(
            mutations=mutations,
            max_states=args.max_states, max_seconds=args.max_seconds,
            symmetry=not args.no_symmetry, **topology)
        cfg.validate()
    except ValueError as e:
        print(f"flightcheck model: {e}", file=sys.stderr)
        return 2

    if args.liveness:
        # Liveness explores in canonical (symmetry-reduced) space and
        # lasso steps are regenerated inside it, so the rendered worker
        # labels are canonical ids — there is no plain re-search here
        # (a lasso found in the quotient graph need not exist verbatim
        # in the concrete graph; the canonical replay is the witness).
        lresult = check_liveness(cfg)
        report = traces.render_liveness(lresult, cfg)
        if args.json:
            payload = {
                "ok": lresult.ok,
                "liveness": True,
                "states": lresult.states,
                "transitions": lresult.transitions,
                "sccs": lresult.sccs,
                "elapsed_s": round(lresult.elapsed, 3),
                "budget_exhausted": lresult.budget_exhausted,
                "budget_reason": lresult.budget_reason,
                "checked": list(lresult.checked),
                "mutations": sorted(cfg.mutations),
                "invariant_violated": (lresult.lasso.invariant
                                       if lresult.lasso else None),
                "stem": ([{"actor": s.actor, "action": s.action,
                           "detail": s.detail}
                          for s in lresult.lasso.stem]
                         if lresult.lasso else []),
                "cycle": ([{"actor": s.actor, "action": s.action,
                            "detail": s.detail}
                           for s in lresult.lasso.cycle]
                          if lresult.lasso else []),
            }
            print(json.dumps(payload, indent=2))
        else:
            print(report)
        if args.trace_file:
            with open(args.trace_file, "w", encoding="utf-8") as f:
                f.write(report + "\n")
        if args.sarif:
            from fraud_detection_tpu_torch.analysis import sarif

            findings = ([traces.lasso_to_finding(lresult.lasso)]
                        if lresult.lasso else [])
            doc = sarif.build(findings, suppressed=0, n_files=0)
            problems = sarif.validate(doc)
            if problems:  # pragma: no cover - emitter/validator drift
                print("SARIF self-validation failed:\n  "
                      + "\n  ".join(problems), file=sys.stderr)
                return 2
            with open(args.sarif, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=2)
        if lresult.lasso is not None:
            return 1
        if lresult.budget_exhausted:
            return 2
        return 0

    result = check(cfg)
    if result.violation is not None and cfg.symmetry:
        # Re-search without the symmetry reduction so the trace's worker
        # labels stay stable step to step (canonical relabeling can swap
        # identities mid-trace); fall back to the symmetric trace if the
        # plain search blows the budget first.
        from dataclasses import replace

        plain = check(replace(cfg, symmetry=False))
        if plain.violation is not None:
            plain.coverage = result.coverage
            result = plain

    report = traces.render(result, cfg)
    if args.json:
        payload = {
            "ok": result.ok,
            "states": result.states,
            "transitions": result.transitions,
            "depth": result.depth,
            "elapsed_s": round(result.elapsed, 3),
            "budget_exhausted": result.budget_exhausted,
            "budget_reason": result.budget_reason,
            "coverage": result.coverage,
            "mutations": sorted(cfg.mutations),
            "invariant_violated": (result.violation.invariant
                                   if result.violation else None),
            "trace": ([{"actor": s.actor, "action": s.action,
                        "detail": s.detail}
                       for s in result.violation.trace]
                      if result.violation else []),
        }
        print(json.dumps(payload, indent=2))
    else:
        print(report)
    if args.trace_file:
        with open(args.trace_file, "w", encoding="utf-8") as f:
            f.write(report + "\n")
    if args.sarif:
        from fraud_detection_tpu_torch.analysis import sarif

        findings = ([traces.to_finding(result.violation)]
                    if result.violation else [])
        doc = sarif.build(findings, suppressed=0, n_files=0)
        problems = sarif.validate(doc)
        if problems:  # pragma: no cover - emitter/validator drift guard
            print("SARIF self-validation failed:\n  "
                  + "\n  ".join(problems), file=sys.stderr)
            return 2
        with open(args.sarif, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2)
    if result.violation is not None:
        return 1
    if result.budget_exhausted:
        return 2
    return 0


def conform_main(argv=None) -> int:
    from fraud_detection_tpu_torch.analysis import conformance

    parser = argparse.ArgumentParser(
        prog="flightcheck conform",
        description="replay a recorded control-lane run against the "
                    "declared role state machines (FLEET_PROTOCOLS); "
                    "exit 1 on any non-conforming record "
                    "(docs/static_analysis.md)")
    parser.add_argument("--input", required=True, metavar="PATH",
                        help="JSON file: a record list, {'records': "
                             "[...]}, a succession_report() dict, or a "
                             "game-day result with evidence."
                             "succession.trace")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable result on stdout")
    parser.add_argument("--sarif", default=None, metavar="PATH",
                        help="write violations as SARIF 2.1.0 FC505 "
                             "results")
    args = parser.parse_args(argv)

    try:
        with open(args.input, "r", encoding="utf-8") as f:
            obj = json.load(f)
        records, ctx = conformance.extract_trace(obj)
    except (OSError, ValueError) as e:
        print(f"flightcheck conform: {e}", file=sys.stderr)
        return 2

    violations = conformance.check_records(
        records, handoffs=ctx.get("handoffs"),
        lost=ctx.get("lost", 0), reordered=ctx.get("reordered", 0))
    if args.json:
        print(json.dumps({
            "ok": not violations,
            "summary": conformance.summarize(violations, len(records)),
            "violations": [{"index": v.index, "rule": v.rule,
                            "detail": v.detail, "record": v.record}
                           for v in violations],
        }, indent=2))
    else:
        print(conformance.render_report(violations, len(records),
                                        args.input))
    if args.sarif:
        from fraud_detection_tpu_torch.analysis import sarif

        doc = sarif.build(conformance.to_findings(violations),
                          suppressed=0, n_files=0)
        problems = sarif.validate(doc)
        if problems:  # pragma: no cover - emitter/validator drift guard
            print("SARIF self-validation failed:\n  "
                  + "\n  ".join(problems), file=sys.stderr)
            return 2
        with open(args.sarif, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2)
    return 1 if violations else 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "model":
        return model_main(argv[1:])
    if argv and argv[0] == "conform":
        return conform_main(argv[1:])
    parser = argparse.ArgumentParser(
        prog="flightcheck",
        description="flightcheck: first-party static analysis "
                    "(concurrency lint, cross-object lock order, commit-"
                    "protocol shape, hot-path sync lint, health-schema "
                    "lint)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids to run "
                             "(default: all)")
    parser.add_argument("--root", default=None,
                        help="package root to analyze (default: the "
                             "fraud_detection_tpu_torch package)")
    parser.add_argument("--tests", default=None,
                        help="tests/ directory holding the *_SCHEMA "
                             "contract dicts (default: sibling of the "
                             "package root)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable findings on stdout")
    parser.add_argument("--sarif", default=None, metavar="PATH",
                        help="also write findings as SARIF 2.1.0 to PATH")
    parser.add_argument("--fix", action="store_true",
                        help="scaffold ignore-pragmas (with a TODO(justify) "
                             "stub) over every finding; idempotent")
    parser.add_argument("--dry-run", action="store_true",
                        help="with --fix: print planned edits, write "
                             "nothing")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument("--no-cache", action="store_true",
                        help="disable the incremental per-file analysis "
                             "cache (.flightcheck_cache/)")
    parser.add_argument("--cache-dir", default=None, metavar="PATH",
                        help="cache directory (default: "
                             ".flightcheck_cache/ at the repo root)")
    parser.add_argument("--verbose", action="store_true",
                        help="report cache hit/miss counts")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule, (name, summary) in sorted(RULES.items()):
            print(f"{rule}  {name:<24} {summary}")
        return 0
    if args.dry_run and not args.fix:
        print("--dry-run only makes sense with --fix", file=sys.stderr)
        return 2

    rules = None
    if args.rules:
        rules = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = rules - set(RULES)
        if unknown:
            print(f"unknown rule ids: {sorted(unknown)} "
                  f"(known: {sorted(RULES)})", file=sys.stderr)
            return 2

    tests_dir = args.tests
    if tests_dir is not None and not os.path.isdir(tests_dir):
        print(f"--tests {tests_dir!r} is not a directory", file=sys.stderr)
        return 2

    cache_dir = args.cache_dir
    if cache_dir is None and not args.no_cache:
        from fraud_detection_tpu_torch.analysis.cache import default_cache_dir

        package_root, _ = resolve_roots(args.root, tests_dir)
        cache_dir = default_cache_dir(package_root)
    if args.no_cache:
        cache_dir = None

    cache_stats: dict = {}
    findings, suppressed, n_files = run_analysis(
        package_root=args.root, tests_dir=tests_dir, rules=rules,
        cache_dir=cache_dir, stats=cache_stats)
    if args.verbose and cache_stats:
        print(f"flightcheck: cache {cache_stats.get('hits', 0)} hit(s), "
              f"{cache_stats.get('misses', 0)} miss(es) "
              f"({cache_dir})", file=sys.stderr)

    if args.sarif:
        from fraud_detection_tpu_torch.analysis import sarif

        package_root, _ = resolve_roots(args.root, tests_dir)
        doc = sarif.build(findings, suppressed=suppressed, n_files=n_files,
                          uri_prefix=os.path.basename(package_root))
        problems = sarif.validate(doc)
        if problems:  # pragma: no cover - emitter/validator drift guard
            print("SARIF self-validation failed:\n  "
                  + "\n  ".join(problems), file=sys.stderr)
            return 2
        with open(args.sarif, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2)
        print(f"flightcheck: SARIF written to {args.sarif} "
              f"({len(findings)} result(s))", file=sys.stderr)

    edits = []
    if args.fix and findings:
        from fraud_detection_tpu_torch.analysis.fixer import apply_fixes

        package_root, _ = resolve_roots(args.root, tests_dir)
        edits = apply_fixes(findings, package_root, dry_run=args.dry_run)

    if args.json:
        print(json.dumps({
            "findings": [{"rule": f.rule, "path": f.path, "line": f.line,
                          "message": f.message} for f in findings],
            "suppressed": suppressed,
            "files": n_files,
            "fix_edits": [e.render() for e in edits],
            "fix_applied": bool(args.fix and not args.dry_run),
        }, indent=2))
    else:
        for f in findings:
            print(f.render())
        print(f"flightcheck: {len(findings)} finding(s), "
              f"{suppressed} suppressed by pragma, {n_files} files analyzed")
        if args.fix:
            verb = "planned" if args.dry_run else "applied"
            for e in edits:
                print(f"  fix {verb}: {e.render()}")
            print(f"flightcheck --fix: {len(edits)} edit(s) {verb}; every "
                  f"scaffolded pragma carries a TODO(justify) to resolve")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
