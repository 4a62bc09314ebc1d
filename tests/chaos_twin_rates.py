#!/usr/bin/env python3
"""Fault reports of the supervised chaos run in both packages, on one host.

Run from the repository root on the CPU:

    python3 tests/chaos_twin_rates.py [--reps 10] [--seed 1234] [--n 100]
        [--procs 6]

Each rep runs ``tests/test_torch_chaos.py``'s supervised chaos case
(``_mixed_plan`` at ``--seed`` over ``--n`` messages, the host-featurize
pipelines of its fixtures) in the JAX package and in the port, alternating
which goes first. The fault plan draws once per fault opportunity (each
poll, commit and flush), so a run's report is a function of the sequence of
broker calls its engine makes. Per run it prints one JSON line: the
package, the report's total, the restarts, the number of opportunities and
how many of them were polls that came back empty (the idle window's
polls, whose count is set by the host's clock: ``idle_timeout`` is 0.2 s).
Then, per package, the spread of totals, whether the two packages' call
sequences agree up to the first empty poll, and how many back-to-back
pairs (one run of each package, as the parity test runs them) disagree. ``--procs N`` runs N such
processes at once, to load the host as a test run's N workers do. Not a
test: pytest does not collect it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]


def _pipelines():
    from fraud_detection_tpu.models.pipeline import synthetic_demo_pipeline
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from torch_parity import port_featurizer, port_model

    jp = synthetic_demo_pipeline(batch_size=64, n=400, seed=3,
                                 num_features=2048,
                                 corpus_kwargs=dict(hard_fraction=0.0,
                                                    label_noise=0.0))
    tp = ServingPipeline(port_featurizer(jp.featurizer),
                         port_model(jp.model), batch_size=64, device="cpu")
    return jp, tp


def _one(pkg: str, pipe, seed: int, n: int) -> dict:
    import test_torch_chaos as tc

    faults = tc.tfaults if pkg == "torch" else tc.jfaults
    plan = tc._mixed_plan(faults, seed)
    calls = []
    fire = plan.fire

    def counted(kind, rate):
        calls.append(kind)
        return fire(kind, rate)

    plan.fire = counted
    empty = [0]
    cons_cls = faults.ChaosConsumer
    inner_poll = cons_cls.poll_batch

    def poll_batch(self, max_messages, timeout):
        got = inner_poll(self, max_messages, timeout)
        if not got:
            empty[0] += 1
            calls.append("empty")
        return got

    cons_cls.poll_batch = poll_batch
    try:
        _, stats, _ = tc._run_chaos(pipe, plan, n, port=(pkg == "torch"))
    finally:
        cons_cls.poll_batch = inner_poll
    return {"pkg": pkg, "total": plan.report()["total"],
            "restarts": stats.restarts, "opportunities": len(calls),
            "empty_polls": empty[0], "calls": calls}


def _prefix(calls):
    return calls[:calls.index("empty")] if "empty" in calls else calls


def _worker(args) -> list:
    jp, tp = _pipelines()
    out = []
    for rep in range(args.reps):
        order = ("jax", "torch") if rep % 2 == 0 else ("torch", "jax")
        runs = {pkg: _one(pkg, jp if pkg == "jax" else tp, args.seed, args.n)
                for pkg in order}
        same = _prefix(runs["jax"]["calls"]) == _prefix(runs["torch"]["calls"])
        for pkg in ("jax", "torch"):
            r = dict(runs[pkg])
            r["pair"] = f"{os.getpid()}:{rep}"
            r["calls_before_first_empty_equal"] = same
            r.pop("calls")
            print(json.dumps(r), flush=True)
            out.append(r)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--procs", type=int, default=1)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import torch

    torch.set_num_threads(1)
    if args.child or args.procs == 1:
        runs = _worker(args)
    else:
        cmd = [sys.executable, __file__, "--child", "--reps", str(args.reps),
               "--seed", str(args.seed), "--n", str(args.n)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
                 for _ in range(args.procs)]
        runs = []
        for p in procs:
            out, _ = p.communicate()
            for line in out.splitlines():
                if line.startswith("{"):
                    print(line)
                    runs.append(json.loads(line))
    if args.child:
        return 0
    for pkg in ("jax", "torch"):
        totals = sorted(r["total"] for r in runs if r["pkg"] == pkg)
        empties = sorted(r["empty_polls"] for r in runs if r["pkg"] == pkg)
        print(f"{pkg}: totals {totals}; empty polls {empties}")
    same = sum(r["calls_before_first_empty_equal"] for r in runs
               if r["pkg"] == "torch")
    pairs = sum(1 for r in runs if r["pkg"] == "torch")
    print(f"call sequences equal up to the first empty poll: {same}/{pairs}")
    by_pair: dict = {}
    for r in runs:
        by_pair.setdefault(r["pair"], {})[r["pkg"]] = r["total"]
    apart = sum(1 for v in by_pair.values() if v["jax"] != v["torch"])
    print(f"pairs whose totals differ: {apart}/{len(by_pair)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
