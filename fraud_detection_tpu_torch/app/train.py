"""Training CLI — twin of ``fraud_detection_tpu/app/train.py``.

Mirrors the reference's ``main()`` (fraud_detection_spark.py:326-405): load +
clean the dialogue corpus, 70/10/20 seeded split, HashingTF (or
CountVectorizer) + IDF dense features, train the chosen models (decision
tree, random forest, gradient boosting, logistic regression) on
``--device`` (the card unless ``--device cpu``), evaluate each on
validation and test (accuracy / weighted P / R / F1 / AUC / confusion),
print the report, and save a model as a native checkpoint that
``ServingPipeline.from_checkpoint`` serves (``--save model=spark:<dir>``:
the Spark ``PipelineModel`` layout, ``checkpoint/spark_writer.py``), or
publish it to a model registry:

    python -m fraud_detection_tpu_torch.app.train --data synthetic --n 1600 \\
        --models dt,rf,xgb,lr --save dt=fraud_model_dt --num-features 10000

``--mesh`` trains every model data-parallel over all local devices
(``parallel/mesh.py``: rows sharded, per-shard histograms and gradients
summed over the data axis). ``--plots DIR`` writes the metric-comparison,
confusion-matrix and word-association figures (``eval/report.py``); it
needs matplotlib.
"""

from __future__ import annotations

import argparse
import csv as csv_mod
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Tuple

import numpy as np

MODELS = ("dt", "rf", "xgb", "lr")


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


def _ckpt_subdir(args, model_name: str):
    """Per-model snapshot directory under --checkpoint-dir (None when off)."""
    if args.checkpoint_dir is None:
        return None
    return os.path.join(args.checkpoint_dir, model_name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default="synthetic",
                    help="'synthetic' or a CSV path with dialogue/labels columns")
    ap.add_argument("--n", type=int, default=1600, help="synthetic corpus size")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--models", default="dt,rf,xgb,lr",
                    help="comma list from {dt,rf,xgb,lr}")
    ap.add_argument("--num-features", type=int, default=10000)
    ap.add_argument("--featurizer", choices=("hashing", "count"),
                    default="hashing",
                    help="'hashing' = HashingTF(num-features) like the shipped "
                         "artifact; 'count' = CountVectorizer(vocab-size) like "
                         "the reference training script (fraud_detection_spark.py:51)")
    ap.add_argument("--vocab-size", type=int, default=20000,
                    help="vocabulary cap for --featurizer count")
    ap.add_argument("--max-depth", type=int, default=5)
    ap.add_argument("--n-trees", type=int, default=100)
    ap.add_argument("--n-rounds", type=int, default=100)
    ap.add_argument("--tree-chunk", type=int, default=None,
                    help="forest trees built per histogram launch (default: "
                         "8 at depth 5; part of a forest's draws, so pass the "
                         "original value when resuming)")
    ap.add_argument("--save", action="append", default=[],
                    help="model=dir pairs, e.g. dt=./fraud_model_dt (repeatable); "
                         "model=spark:<dir> exports the Spark PipelineModel "
                         "layout instead of the native format")
    ap.add_argument("--publish", action="append", default=[],
                    help="model=registry-root pairs (repeatable): publish "
                         "the trained model as the next version of a model "
                         "registry (atomic, content-hashed, with this run's "
                         "metrics in the manifest)")
    ap.add_argument("--mesh", action="store_true",
                    help="train data-parallel over all available devices")
    ap.add_argument("--json", action="store_true", help="emit metrics as JSON")
    ap.add_argument("--metrics-out", metavar="FILE", default=None,
                    help="write the full metric report (all models x splits "
                         "+ run metadata) as JSON to FILE")
    ap.add_argument("--plots", metavar="DIR", default=None,
                    help="write metric-comparison + confusion-matrix PNGs "
                         "here (needs matplotlib)")
    ap.add_argument("--associations", type=int, metavar="N", default=0,
                    help="word-association analysis over the top N features "
                         "per model (side-vocabulary inversion of hashed "
                         "features)")
    ap.add_argument("--checkpoint-dir", metavar="DIR", default=None,
                    help="mid-training snapshot directory for the iterative "
                         "trainers (rf/xgb): snapshots land in DIR/<model>, "
                         "and an interrupted run resumes bit-identically")
    ap.add_argument("--checkpoint-every", type=int, metavar="K", default=10,
                    help="snapshot cadence: boosting rounds / forest trees "
                         "(default 10)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train and score on (default cuda)")
    args = ap.parse_args(argv)

    if args.plots and importlib.util.find_spec("matplotlib") is None:
        # checked before any training time is spent
        raise SystemExit("--plots needs matplotlib, which is not installed "
                         "(eval/report.py draws with it)")
    chosen = [m.strip() for m in args.models.split(",") if m.strip()]
    for name in chosen:
        if name not in MODELS:
            raise SystemExit(f"unknown model {name!r} (choose from "
                             f"{','.join(MODELS)})")
    save_pairs = []
    for pair in args.save:  # validate before any training time is spent
        name, _, out_dir = pair.partition("=")
        target = (out_dir[len("spark:"):] if out_dir.startswith("spark:")
                  else out_dir)
        if not target or name not in chosen:
            raise SystemExit(
                f"--save expects model=dir or model=spark:dir with the model "
                f"in --models (got {pair!r}, models: {chosen})")
        save_pairs.append((name, out_dir))
    publish_pairs = []
    for pair in args.publish:
        name, _, root = pair.partition("=")
        if not root or name not in chosen:
            raise SystemExit(
                f"--publish expects model=registry-root with the model in "
                f"--models (got {pair!r}, models: {chosen})")
        publish_pairs.append((name, root))

    import torch

    from fraud_detection_tpu_torch.checkpoint.native import save_checkpoint
    from fraud_detection_tpu_torch.data import train_val_test_split
    from fraud_detection_tpu_torch.eval import evaluate_classification
    from fraud_detection_tpu_torch.featurize.tfidf import (
        HashingTfIdfFeaturizer, VocabTfIdfFeaturizer)
    from fraud_detection_tpu_torch.models import trees as trees_mod
    from fraud_detection_tpu_torch.models.linear import predict_dense
    from fraud_detection_tpu_torch.models.train_linear import (
        fit_logistic_regression)
    from fraud_detection_tpu_torch.models.train_trees import (
        TreeTrainConfig, fit_decision_tree, fit_gradient_boosting,
        fit_random_forest)
    from fraud_detection_tpu_torch.utils.atomicio import atomic_write_json
    from fraud_detection_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    mesh = None
    if args.mesh:
        from fraud_detection_tpu_torch.parallel import make_mesh

        mesh = make_mesh(device_type=dev.type)
        dev = mesh.home
        print(f"mesh: {dict(mesh.shape)}")
    corpus = load_corpus(args)
    train, val, test = train_val_test_split(corpus, seed=args.seed)
    print(f"Training samples: {len(train)}\nValidation samples: {len(val)}"
          f"\nTest samples: {len(test)}")

    if args.featurizer == "count":
        feat = VocabTfIdfFeaturizer.fit_vocabulary(
            [t for t, _ in train], vocab_size=args.vocab_size)
    else:
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
            model = fit_decision_tree(Xtr, ytr, config=cfg, device=dev,
                                      mesh=mesh)
        elif name == "rf":
            model = fit_random_forest(
                Xtr, ytr, n_trees=args.n_trees, seed=args.seed, config=cfg,
                tree_chunk=args.tree_chunk, device=dev, mesh=mesh,
                checkpoint_dir=_ckpt_subdir(args, name),
                checkpoint_every=args.checkpoint_every)
        elif name == "xgb":
            model = fit_gradient_boosting(
                Xtr, ytr, n_rounds=args.n_rounds,
                config=TreeTrainConfig(max_depth=args.max_depth,
                                       criterion="xgb"), device=dev,
                mesh=mesh, checkpoint_dir=_ckpt_subdir(args, name),
                checkpoint_every=args.checkpoint_every)
        else:
            model = fit_logistic_regression(Xtr, ytr.astype(np.float32),
                                            device=dev, mesh=mesh)
        trained[name] = model
        timings[name] = round(time.perf_counter() - t0, 3)
        print(f"trained {name} in {timings[name]:.2f}s")

    def scores(model, X):
        x = torch.from_numpy(X).to(dev)
        if isinstance(model, trees_mod.TreeEnsemble):
            return trees_mod.predict(model, x)
        return predict_dense(model, x)

    all_metrics: Dict[str, Dict[str, Dict[str, float]]] = {}
    all_reports: Dict[str, Dict[str, object]] = {}
    for name, model in trained.items():
        all_metrics[name] = {}
        all_reports[name] = {}
        for split_name, (X, y) in sets.items():
            pred, p1 = scores(model, X)
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
            "featurizer": args.featurizer,
            "max_depth": args.max_depth, "n_trees": args.n_trees,
            "n_rounds": args.n_rounds,
            "splits": {"train": len(train), "val": len(val),
                       "test": len(test)},
            "device": str(dev),
            "mesh": dict(mesh.shape) if mesh is not None else None,
            "train_seconds": timings,
        }
        if any(m in chosen for m in ("dt", "rf", "xgb")):
            # which tree kernels ran: the CUDA kernels, or their plain torch
            # versions on the CPU (the JAX report's "use_pallas"); omitted
            # for LR-only runs
            meta["tree_kernels"] = "cuda" if dev.type == "cuda" else "plain"
        if args.featurizer == "count":
            meta["vocab_size"] = args.vocab_size
        else:
            meta["num_features"] = args.num_features
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
        if not atomic_write_json(args.metrics_out, report):
            raise SystemExit(f"could not write {args.metrics_out}")
        print(f"metrics report -> {args.metrics_out}")

    if args.plots:
        from fraud_detection_tpu_torch.eval.report import (
            plot_confusion_matrices, plot_metrics_comparison)

        os.makedirs(args.plots, exist_ok=True)
        p = plot_metrics_comparison(
            all_reports, os.path.join(args.plots, "metrics_comparison.png"))
        cms = plot_confusion_matrices(
            all_reports, os.path.join(args.plots, "confusion_matrices"))
        print(f"plots: {p} + {len(cms)} confusion-matrix figures")

    if args.associations:
        from fraud_detection_tpu_torch.eval.word_associations import (
            SideVocabulary, analyze_word_associations,
            model_feature_importances)

        train_texts = [t for t, _ in train]
        train_labels = [l for _, l in train]
        vocab = SideVocabulary(feat).add_corpus(train_texts)
        for name, model in trained.items():
            imps = model_feature_importances(model, Xtr, ytr)
            assocs = analyze_word_associations(
                model, feat, train_texts, train_labels,
                top_n=args.associations, vocab=vocab, importances=imps)
            print(f"\n=== word associations: {name} ===")
            for a in assocs:
                print(f"  {a.word:<20} importance={a.importance:.4f} "
                      f"scam_ratio={a.scam_ratio:.3f} "
                      f"({a.scam_docs} scam / {a.non_scam_docs} non-scam)")
            if args.plots:
                from fraud_detection_tpu_torch.eval.report import (
                    plot_word_associations)

                plot_word_associations(
                    assocs, os.path.join(args.plots,
                                         f"word_associations_{name}.png"),
                    model_name=name)

    for name, out_dir in save_pairs:
        if out_dir.startswith("spark:"):
            from fraud_detection_tpu_torch.checkpoint.spark_writer import (
                save_spark_pipeline)

            save_spark_pipeline(out_dir[len("spark:"):], feat, trained[name])
            print(f"saved {name} -> {out_dir[len('spark:'):]} (Spark "
                  "PipelineModel layout)")
        else:
            save_checkpoint(out_dir, feat, trained[name])
            print(f"saved {name} -> {out_dir}")

    for name, root in publish_pairs:
        from fraud_detection_tpu_torch.registry import ModelRegistry

        mv = ModelRegistry(root).publish(
            feat, trained[name], metrics=all_metrics.get(name),
            extra={"trained_with": {"model": name, "data": args.data,
                                    "seed": args.seed,
                                    "featurizer": args.featurizer}})
        print(f"published {name} -> {root} as {mv.name} "
              f"(parent: {mv.manifest['parent']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
