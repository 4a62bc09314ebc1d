"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's configuration and traffic, sets up the program on the
card, warms every shape the traffic uses, measures for ``--seconds``,
checks what the timed path produced against the plain reference, and
prints one JSON object as the last line of standard output (the numbers
compared, each beside its limit, also as the last lines of standard error).
It refuses to run, and prints no result, without the cards the cell asks
for, or when a module of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a cell's first run there builds (the program's own CUDA
    kernels build under ``build/torch_kernels``), and no library that the
    program may load pulls JAX in (``transformers`` reads ``USE_FLAX``)."""
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _fixed_caches()
    sys.path.insert(0, str(BENCH_DIR))
    sys.path.insert(0, str(ROOT))
    import harness
    from reference.imports import forbidden_modules

    bench = harness.load_benchmark()
    cell = harness.workload(bench, args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    ctx = harness.Context(
        cell=cell, cfg=harness.config(bench, cell["config"]),
        mix=harness.traffic(cell["traffic"]), seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace),
        device=torch.device("cuda", 0),
        started=time.perf_counter() - harness.process_age_s())
    harness.driver(ctx.mix["driver"]).run(ctx)

    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or of the JAX package were loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    line = harness.result(ctx, bench)
    harness.print_checks(ctx)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
