"""Tree-training CLI — twin of ``fraud_detection_tpu/app/train.py`` for
the decision tree, random forest and gradient-boosting models.

Mirrors the reference's ``main()`` (fraud_detection_spark.py:326-405): load +
clean the dialogue corpus, 70/10/20 seeded split, HashingTF + IDF dense
features, train the chosen tree models on ``--device`` (the card unless
``--device cpu``), evaluate each on validation and test (accuracy /
weighted P / R / F1 / AUC / confusion), print the report, and save a model
as a native checkpoint that ``ServingPipeline.from_checkpoint`` serves:

    python -m fraud_detection_tpu_torch.app.train --data synthetic --n 1600 \\
        --models dt,rf,xgb --save dt=fraud_model_dt --num-features 10000
"""

from __future__ import annotations

import argparse
import csv as csv_mod
import json
import math
import os
import sys
import time
from typing import Dict, List, Tuple

import numpy as np

MODELS = ("dt", "rf", "xgb")


def load_corpus(args) -> List[Tuple[str, int]]:
    """Returns [(dialogue, label)]. The CSV schema matches the reference
    dataset: columns ``dialogue`` and ``labels`` in {0, 1}."""
    if args.data == "synthetic":
        from fraud_detection_tpu_torch.data import generate_corpus

        return [(d.text, d.label) for d in generate_corpus(n=args.n, seed=args.seed)]
    from fraud_detection_tpu_torch.data import clean_rows

    if args.data.startswith(("http://", "https://")):
        raise SystemExit(f"{args.data}: local CSV files only (download it first)")
    if not os.path.exists(args.data):
        raise SystemExit(f"CSV {args.data} not found")
    with open(args.data, newline="", encoding="utf-8") as fh:
        raw = list(csv_mod.DictReader(fh))
    if raw and "dialogue" not in raw[0]:
        raise SystemExit(
            f"CSV {args.data} missing 'dialogue' column (has {list(raw[0])})")
    # CLI conveniences on top of the strict reference chain: accept a
    # singular 'label' header and float-style labels ("1.0").
    for r in raw:
        if "labels" not in r and "label" in r:
            r["labels"] = r["label"]
        lab = (r.get("labels") or "").strip()
        try:
            val = float(lab)
        except ValueError:
            continue
        if val in (0.0, 1.0):
            r["labels"] = str(int(val))
    rows = clean_rows(raw)
    if not rows:
        raise SystemExit(
            f"CSV {args.data}: no usable rows — labels must be 0/1 "
            "(column 'labels' or 'label') and clean_text non-empty")
    return [(r.dialogue, r.label) for r in rows]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default="synthetic",
                    help="'synthetic' or a CSV path with dialogue/labels columns")
    ap.add_argument("--n", type=int, default=1600, help="synthetic corpus size")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--models", default="dt,rf,xgb",
                    help="comma list from {dt,rf,xgb}")
    ap.add_argument("--num-features", type=int, default=10000)
    ap.add_argument("--max-depth", type=int, default=5)
    ap.add_argument("--n-trees", type=int, default=100)
    ap.add_argument("--n-rounds", type=int, default=100)
    ap.add_argument("--tree-chunk", type=int, default=None,
                    help="forest trees built per histogram launch (default: "
                         "8 at depth 5; part of a forest's draws)")
    ap.add_argument("--save", action="append", default=[],
                    help="model=dir pairs, e.g. dt=./fraud_model_dt (repeatable)")
    ap.add_argument("--json", action="store_true", help="emit metrics as JSON")
    ap.add_argument("--metrics-out", metavar="FILE", default=None,
                    help="write the full metric report (all models x splits "
                         "+ run metadata) as JSON to FILE")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train and score on (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from fraud_detection_tpu_torch.checkpoint.native import save_checkpoint
    from fraud_detection_tpu_torch.data import train_val_test_split
    from fraud_detection_tpu_torch.eval import evaluate_classification
    from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
    from fraud_detection_tpu_torch.models import trees as trees_mod
    from fraud_detection_tpu_torch.models.train_trees import (
        TreeTrainConfig, fit_decision_tree, fit_gradient_boosting,
        fit_random_forest)
    from fraud_detection_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    chosen = [m.strip() for m in args.models.split(",") if m.strip()]
    for name in chosen:
        if name not in MODELS:
            raise SystemExit(f"unknown model {name!r} (choose from "
                             f"{','.join(MODELS)})")
    save_pairs = []
    for pair in args.save:  # validate before any training time is spent
        name, _, out_dir = pair.partition("=")
        if not out_dir or name not in chosen:
            raise SystemExit(
                f"--save expects model=dir with the model in --models "
                f"(got {pair!r}, models: {chosen})")
        save_pairs.append((name, out_dir))

    corpus = load_corpus(args)
    train, val, test = train_val_test_split(corpus, seed=args.seed)
    print(f"Training samples: {len(train)}\nValidation samples: {len(val)}"
          f"\nTest samples: {len(test)}")

    feat = HashingTfIdfFeaturizer(num_features=args.num_features)
    feat.fit_idf([t for t, _ in train])

    def to_xy(split):
        x = feat.featurize_dense([t for t, _ in split], device=dev)
        return x.cpu().numpy(), np.asarray([l for _, l in split])

    Xtr, ytr = to_xy(train)
    sets = {"Validation": to_xy(val), "Test": to_xy(test)}

    cfg = TreeTrainConfig(max_depth=args.max_depth)
    trained = {}
    timings: Dict[str, float] = {}
    for name in chosen:
        t0 = time.perf_counter()
        if name == "dt":
            model = fit_decision_tree(Xtr, ytr, config=cfg, device=dev)
        elif name == "rf":
            model = fit_random_forest(
                Xtr, ytr, n_trees=args.n_trees, seed=args.seed, config=cfg,
                tree_chunk=args.tree_chunk, device=dev)
        else:
            model = fit_gradient_boosting(
                Xtr, ytr, n_rounds=args.n_rounds,
                config=TreeTrainConfig(max_depth=args.max_depth,
                                       criterion="xgb"), device=dev)
        trained[name] = model
        timings[name] = round(time.perf_counter() - t0, 3)
        print(f"trained {name} in {timings[name]:.2f}s")

    all_metrics: Dict[str, Dict[str, Dict[str, float]]] = {}
    all_reports: Dict[str, Dict[str, object]] = {}
    for name, model in trained.items():
        all_metrics[name] = {}
        all_reports[name] = {}
        for split_name, (X, y) in sets.items():
            pred, p1 = trees_mod.predict(model, torch.from_numpy(X).to(dev))
            rep = evaluate_classification(y, pred.cpu().numpy(),
                                          p1.cpu().numpy())
            all_metrics[name][split_name] = rep.as_dict()
            all_reports[name][split_name] = rep
            if not args.json:
                print(f"\n=== {name} / {split_name} ===")
                for k, v in rep.as_dict().items():
                    print(f"  {k}: {v:.4f}")
                print(f"  confusion: {rep.confusion.tolist()}")
    if args.json:
        print(json.dumps(all_metrics, indent=2))
    if args.metrics_out:
        def de_nan(v):
            # Undefined metrics (single-class AUC) serialize as null: bare
            # NaN is outside the JSON spec.
            return None if isinstance(v, float) and math.isnan(v) else v

        meta = {
            "data": args.data, "n": len(corpus), "seed": args.seed,
            "featurizer": "hashing",
            "max_depth": args.max_depth, "n_trees": args.n_trees,
            "n_rounds": args.n_rounds,
            "splits": {"train": len(train), "val": len(val),
                       "test": len(test)},
            "device": str(dev),
            "mesh": None,
            "train_seconds": timings,
            # which tree kernels ran: the CUDA kernels, or their plain torch
            # versions on the CPU (the JAX report's "use_pallas")
            "tree_kernels": "cuda" if dev.type == "cuda" else "plain",
            "num_features": args.num_features,
        }
        report = {
            "meta": meta,
            "metrics": {
                name: {split: dict(
                           {k: de_nan(v) for k, v in m.items()},
                           confusion=all_reports[name][split]
                           .confusion.tolist())
                       for split, m in per_split.items()}
                for name, per_split in all_metrics.items()
            },
        }
        os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
        with open(args.metrics_out, "w") as fh:
            json.dump(report, fh, indent=2, allow_nan=False)
        print(f"metrics report -> {args.metrics_out}")

    for name, out_dir in save_pairs:
        save_checkpoint(out_dir, feat, trained[name])
        print(f"saved {name} -> {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
