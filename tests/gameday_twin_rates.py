#!/usr/bin/env python3
"""Pass rates of catalog game days in both packages, on one host.

Run from the repository root on the CPU:

    python3 tests/gameday_twin_rates.py [--reps 12]
        [--name diurnal_tide_scale] [--name flash_crowd_scale]
        [--seed 0] [--scale 1.0] [--test-pipelines] [--procs 1]

Each named catalog day runs ``--reps`` times in each package, the JAX
reference and the port (``device="cpu"``), alternating run by run which
package goes first, so that both meet the same host load. By default the
day runs at its declared pacing on each package's game-day pipeline
(``_default_pipeline``: 2,048 features, host featurize), as in the card's
phase; ``--test-pipelines`` runs it on the scenario tests' pipelines
(``torch_parity.gameday_pipelines``: LR, 1,024 features, batch 128).
``--procs N`` runs N such processes at once, each with its own reps, to
load the host as a test run's N workers do. Per run it prints one JSON
line (verdict, failed gates, deaths, the autoscaler's scale-outs,
scale-ins and denials, the reaction in virtual seconds, wall), then each
package's pass count per day over every process.

This is how a gate whose verdict races the host is held against the
reference: the paced autoscale days' decision gates race the reference's
own scale policy (a denied scale-in restarts the cooldown,
``fleet/autoscale/policy.py``). Not a test: pytest does not collect it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]

PACKAGES = ("fraud_detection_tpu", "fraud_detection_tpu_torch")


def _runs(args) -> list:
    mods = {p: importlib.import_module(p + ".scenarios.gameday")
            for p in PACKAGES}
    if args.test_pipelines:
        from torch_parity import gameday_pipelines

        shared = dict(zip(PACKAGES, gameday_pipelines()))
    runs = []
    for name in args.name:
        days, pipes = {}, {}
        for p, G in mods.items():
            days[p] = G.get_scenario(name, args.seed, scale=args.scale)
            if args.test_pipelines:
                pipes[p] = shared[p]
            else:
                kw = {"device": "cpu"} if p.endswith("_torch") else {}
                pipes[p] = G._default_pipeline(
                    days[p].batch_size, model=days[p].model, **kw)
        for i in range(args.reps):
            for p in PACKAGES if i % 2 == 0 else PACKAGES[::-1]:
                t0 = time.perf_counter()
                result = mods[p].run_gameday(days[p], pipeline=pipes[p])
                wall = time.perf_counter() - t0
                ev = result.evidence
                a = ev.get("autoscale") or {}
                run = dict(package=p, name=name, seed=args.seed,
                           scale=args.scale, rep=i, ok=result.ok,
                           failed=[v.name for v in result.report.failed],
                           deaths=ev.get("deaths"),
                           scale_outs=a.get("scale_outs"),
                           scale_ins=a.get("scale_ins"),
                           denied=a.get("denied"),
                           reaction_s=ev.get("autoscale_reaction_s"),
                           wall_s=round(wall, 3))
                runs.append(run)
                print(json.dumps(run), flush=True)
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--name", action="append", default=None)
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--test-pipelines", action="store_true")
    ap.add_argument("--procs", type=int, default=1)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.name = args.name or ["diurnal_tide_scale", "flash_crowd_scale"]
    if args.worker or args.procs == 1:
        runs = _runs(args)
        if args.worker:
            return 0
    else:
        argv = [a for a in (argv if argv is not None else sys.argv[1:])]
        procs = [subprocess.Popen(
            [sys.executable, __file__, *argv, "--worker"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
            for _ in range(args.procs)]
        runs = []
        for proc in procs:
            out, _ = proc.communicate()
            for line in out.splitlines():
                if line.startswith("{"):
                    runs.append(json.loads(line))
                    print(line, flush=True)
    host = (f"CPU, {os.cpu_count()} cores, {args.procs} process(es), "
            + ("the tests' pipelines" if args.test_pipelines
               else "host featurize"))
    for name in args.name:
        for p in PACKAGES:
            mine = [r for r in runs if r["name"] == name
                    and r["package"] == p]
            print(f"[rates] {name} seed {args.seed} scale {args.scale} "
                  f"{p}: {sum(r['ok'] for r in mine)} of {len(mine)} PASS "
                  f"({host})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
