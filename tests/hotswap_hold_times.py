#!/usr/bin/env python3
"""How long each package's hot swap holds its caller, on one host.

Run from the repository root on the CPU:

    python3 tests/hotswap_hold_times.py [--reps 20] [--procs 1]

The game day ``campaign_kill_swap`` swaps a v2 candidate in from its
timeline thread (``scenarios/gameday.py`` ``_swap_setup``): ``swap`` pins
and prewarms the candidate (a 256-row ``predict`` and the raw-JSON path),
then flips the active pipeline, and the timeline feeds nothing while it
runs. This times ``HotSwapPipeline.swap`` in the JAX package and in the
port on the game day's pipelines (``_default_pipeline(256)``: LR, 2,048
features, host featurize; a fresh candidate per rep, as each game day
builds one), alternating which package goes first, after one warm-up swap
each (the JAX programs compile there, the port's native library builds
there). ``--procs N`` runs N such processes at once, to load the host as a
test run's N workers do. It prints each package's hold times in ms
(sorted) and their 10th, 50th and 90th percentiles. Not a test: pytest
does not collect it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]


def _worker(reps: int) -> dict:
    from fraud_detection_tpu.registry.hotswap import HotSwapPipeline as JHot
    from fraud_detection_tpu.scenarios import gameday as jg
    from fraud_detection_tpu_torch.registry.hotswap import \
        HotSwapPipeline as THot
    from fraud_detection_tpu_torch.scenarios import gameday as tg

    build = {"jax": lambda seed: jg._default_pipeline(256, seed=seed),
             "torch": lambda seed: tg._default_pipeline(256, seed=seed,
                                                        device="cpu")}
    hots = {"jax": JHot(build["jax"](7), version=1),
            "torch": THot(build["torch"](7), version=1)}
    times = {"jax": [], "torch": []}
    for rep in range(reps + 1):
        order = ("jax", "torch") if rep % 2 == 0 else ("torch", "jax")
        for pkg in order:
            cand = build[pkg](100 + rep)
            t0 = time.perf_counter()
            hots[pkg].swap(cand, version=rep + 2)
            ms = (time.perf_counter() - t0) * 1e3
            if rep:                     # rep 0 is the warm-up swap
                times[pkg].append(ms)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--procs", type=int, default=1)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import torch

    torch.set_num_threads(1)
    if args.child or args.procs == 1:
        times = _worker(args.reps)
        if args.child:
            print(json.dumps(times), flush=True)
            return 0
    else:
        cmd = [sys.executable, __file__, "--child", "--reps", str(args.reps)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
                 for _ in range(args.procs)]
        times = {"jax": [], "torch": []}
        for p in procs:
            out, _ = p.communicate()
            for line in out.splitlines():
                if line.startswith("{"):
                    got = json.loads(line)
                    for k in times:
                        times[k] += got[k]
    for pkg, ts in times.items():
        ts = sorted(ts)
        pct = {q: ts[min(len(ts) - 1, int(q / 100 * len(ts)))]
               for q in (10, 50, 90)}
        print(f"{pkg}: n={len(ts)} p10 {pct[10]:.1f} p50 {pct[50]:.1f} "
              f"p90 {pct[90]:.1f} ms; all "
              + ", ".join(f"{t:.1f}" for t in ts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
