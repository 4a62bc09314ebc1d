#!/usr/bin/env python3
"""Aggregate msgs/s of the fleet at 1, 2 and 3 workers sharing one pipeline
on the card, at a drain long enough to see past the fleet's start.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/fleet_scaling.py [--msgs 65536] [--seed 0]

The pipeline is ``chip_smoke.py``'s phase 5d one: the seeded LR at the
serve CLI's widths (HashingTF 10,000 + IDF, batch 256), written as a
checkpoint and served by ``ServingPipeline.from_checkpoint``, under device
featurize (``featurize_packed``) and under the native host featurizer. Each
drain is ``chip_smoke.fleet_drain``: ``Fleet.in_process`` over 4
partitions holding ``--msgs`` seeded messages (malformed ones included),
every key checked classified exactly once. The arms run in turns (1, 2, 3,
3, 2, 1 workers) and report msgs/s to the last key (the idle tail that
ends a drain run left out), the fleet's rebalances, and for 3 workers the
device-idle share of a profiled drain. The card's name and power limit
lead the output; the table goes to ``chiprun_out/fleet_scaling.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--msgs", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("fleet_scaling: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from fraud_detection_tpu_torch.checkpoint.native import save_checkpoint
    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.featurize.tfidf import (
        HashingTfIdfFeaturizer)
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline

    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    cs.build_native()
    feat = HashingTfIdfFeaturizer(num_features=cs.FEATURES)
    feat.fit_idf([d.text for d in generate_corpus(n=800, seed=7)])
    lr, _ = cs.make_models(feat, args.seed, dev)
    ckpt = HERE / "build" / "fleet_scaling" / "lr"
    save_checkpoint(str(ckpt), feat, lr)
    items, want = cs.chaos_items(args.msgs, args.seed + 131)
    table = {"card": card, "msgs": args.msgs, "arms": {}}
    for featurize in ("device", "host"):
        pipe = ServingPipeline.from_checkpoint(
            str(ckpt), device=dev, batch_size=cs.CHAOS_BATCH,
            featurize_device=featurize == "device")
        cs.fleet_drain(pipe, items[:4096], 1)          # warm-up
        arm = table["arms"][featurize] = {"msgs_per_s": {}, "rebalances": {}}
        for n in (1, 2, 3, 3, 2, 1):
            run = cs.fleet_drain(pipe, items, n)
            cs.fleet_gates(run, items, want, pipe.predict,
                           f"{featurize} {n} workers")
            arm["msgs_per_s"].setdefault(n, []).append(
                round(run["msgs_per_s"], 1))
            arm["rebalances"].setdefault(n, []).append(
                run["result"]["rebalances"])
        prof = cs.fleet_drain(pipe, items, 3, profile=True)
        arm["idle_3_workers"] = round(prof["idle"], 4)
        print(f"[fleet-scaling] {featurize} featurize, {args.msgs} msgs: "
              f"msgs/s {arm['msgs_per_s']}, rebalances {arm['rebalances']}, "
              f"device idle at 3 workers {arm['idle_3_workers']} ({card})",
              flush=True)
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "fleet_scaling.json").write_text(json.dumps(table, indent=1))
    print(json.dumps(table))
    return 0


if __name__ == "__main__":
    sys.exit(main())
