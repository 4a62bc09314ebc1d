"""Readings that the limits of ``correct`` are set from: the program's
numbers over many seeds and the control's over some, in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 12 \
        --control-seeds 3 --seconds 10 --out <file.jsonl>

Each seed runs the cell's driver as a run does (set-up, a window at the
cell's own load, the check), and with ``--control-seeds`` the first seeds
also read the control named in ``limits/<cell>.json``: the reference in
the precision one step below the configuration's, in the program's place.
``--fault`` plants one of ``FAULTS`` in the program for every seed. The
benchmark's own runs never read the control or plant a fault. One JSON
line per seed.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(0, str(BENCH_DIR.parent))


def _token_altered(patch) -> None:
    """Every served token replaced by the next id where it is sampled."""
    from fraud_detection_tpu_torch.models import llm
    rows, first = llm._sample_rows, llm._sample_with_key

    def bad_rows(temperature, logits, key):
        return (rows(temperature, logits, key) + 1) % logits.shape[-1]

    def bad_first(temperature, logits, key):
        return (first(temperature, logits, key) + 1) % logits.shape[-1]

    patch(llm, "_sample_rows", bad_rows)
    patch(llm, "_sample_with_key", bad_first)


# Faults planted underneath the timed path, each given a setattr-like
# ``patch`` (``setattr`` here, pytest's ``monkeypatch.setattr`` in tests).
FAULTS = {"token_altered": _token_altered}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None,
                    help="plant a fault in the program for every seed")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.fault:
        FAULTS[args.fault](setattr)

    import torch
    import harness
    from reference.imports import forbidden_modules

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    cell = harness.workload(bench, args.workload)
    lim = harness.limits(args.workload)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for i in range(args.seeds):
            seed = args.first_seed + 7919 * i
            ctx = harness.Context(
                cell=cell, cfg=harness.config(bench, cell["config"]),
                mix=harness.traffic(cell["traffic"]), seed=seed,
                seconds=args.seconds, trace=False,
                device=torch.device("cuda", 0), started=time.perf_counter(),
                control=lim["control"] if i < args.control_seeds else None)
            torch.cuda.reset_peak_memory_stats()
            harness.driver(ctx.mix["driver"]).run(ctx)
            row = {"workload": args.workload, "seed": seed,
                   "control": ctx.control, "fault": args.fault,
                   "checks": {c.name: c.value for c in ctx.checks},
                   "readings": ctx.rec.get("readings", {}),
                   "served": ctx.rec.get("served"),
                   "attempted": ctx.attempted, "failed": ctx.failed,
                   "memory_peak_bytes": ctx.memory_peak_bytes,
                   "card": torch.cuda.get_device_name(0)}
            f.write(json.dumps(row) + "\n")
            f.flush()
            print(json.dumps(row)[:600], flush=True)
            del ctx
            gc.collect()
            torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        print(f"calibrate: JAX modules loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
