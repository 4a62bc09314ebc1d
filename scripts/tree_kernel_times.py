#!/usr/bin/env python3
"""Device times of the port's two tree-training kernels (the histogram and
``best_splits``) from two checkouts, on one card, in one run.

Unpack the commit to compare with into a directory that ``.gitignore``
lists, then run this from the repository root on a machine with one NVIDIA
GPU:

    mkdir -p build/other && git archive <commit> | tar -x -C build/other
    python3 scripts/tree_kernel_times.py --other build/other

Each checkout runs in processes of its own, in turns (other, this, this,
other), on the same inputs made from ``--seed`` with ``chip_smoke.py``'s
helpers and seeds: the four level shapes of its phase 3 (cli_xgb, cli_rf,
bench_xgb, bench_rf at L=16) and, at the training CLI's shape, every level
width L in {1, 2, 4, 8, 16} of the xgb rounds (f32, K=3), the dt fit (exact,
K=2) and the forest (8 trees, exact, K=2). The histogram runs on int32 bins,
and on uint8 bins where the checkout takes them. ``best_splits`` reads the
checkout's own level histogram. For each call it prints the device time per
call from a ``torch.profiler`` trace of 10 calls (every kernel the call
launches, so the wrapper's host work is left out), CUDA events around one
call (median of 20), and the kernels' names. The card's name and power
limit lead the output; the whole table goes to
``chiprun_out/tree_kernel_times.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _chip_smoke():
    """``chip_smoke.py`` of this checkout as a module (its helpers import
    the port lazily, so they use whichever checkout leads ``sys.path``)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _time(cs, fn) -> dict:
    rows = cs.device_breakdown(fn, reps=10)
    return dict(device_ms=sum(us for _, us, _ in rows) / 1e3,
                events_ms=cs.cuda_ms(fn, 20, 3),
                kernels=sorted({key[:60] for key, _, _ in rows}))


def worker(root: Path, seed: int) -> dict:
    """Time one checkout's kernels; returns {item: times}."""
    sys.path.insert(0, str(root))
    import torch

    cs = _chip_smoke()
    from fraud_detection_tpu_torch.models import train_trees as tt
    from fraud_detection_tpu_torch.ops import histogram as H

    dev = torch.device("cuda")
    xtr, ytr, _, _ = cs.cli_data(dev)
    edges = tt.quantile_bin_edges(xtr, cs.NBINS)
    bins_c = tt.apply_bins(torch.from_numpy(xtr).to(dev),
                           torch.from_numpy(edges).to(dev)).to(torch.int32)
    y_c = torch.from_numpy(ytr).to(dev)
    bins_b, y_b = cs.bench_bins(dev, seed + 21)
    n_c, n_b = bins_c.shape[0], bins_b.shape[0]
    src = {"cli": (bins_c, y_c, n_c), "bench": (bins_b, y_b, n_b)}
    items = {   # name -> (source, trees, K, level width, seed, criterion)
        "cli_rf": ("cli", 8, 2, 16, seed + 22, "gini"),
        "cli_xgb": ("cli", 1, 3, 16, seed + 23, "xgb"),
        "bench_rf": ("bench", 8, 2, 16, seed + 24, "gini"),
        "bench_xgb": ("bench", 1, 3, 16, seed + 25, "xgb"),
    }
    for width in cs.LEVEL_WIDTHS:
        items[f"cli_xgb_L{width}"] = ("cli", 1, 3, width, seed + 60 + width, "xgb")
        items[f"cli_dt_L{width}"] = ("cli", 1, 2, width, seed + 60 + width, "gini")
        items[f"cli_rf_L{width}"] = ("cli", 8, 2, width, seed + 70 + width, "gini")
    out = {}
    for name, (where, trees, k, width, s, crit) in items.items():
        bins, y, n = src[where]
        loc, w, st = cs.level_inputs(n, trees, k, y, dev, s, width)
        kw = dict(n_nodes=width, n_bins=cs.NBINS, exact_int8=crit == "gini")
        row = {}
        for label, b in (("int32", bins), ("uint8", bins.to(torch.uint8))):
            def call(b=b):
                return H.node_feature_bin_histogram_multi(b, loc, w, st, **kw)

            try:
                hist = call()
            except ValueError as e:     # a checkout that takes int32 only
                row[f"hist_{label}"] = f"refused: {e}"[:120]
                continue
            row[f"hist_{label}"] = _time(cs, call)
        if trees == 1 or width == 16:   # the forest's: its first tree's level
            h = hist[0].contiguous()
            totals = h[:, 0].sum(dim=1).contiguous()
            row["best_splits"] = _time(
                cs, lambda: H.best_splits(h, totals, criterion=crit))
        out[name] = row
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path,
                    help="checkout to compare with (run in turns with this one)")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path,
                    default=HERE / "chiprun_out" / "tree_kernel_times.json")
    args = ap.parse_args(argv)
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve(), args.seed)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("tree_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    if args.other is None or not (args.other / "fraud_detection_tpu_torch").is_dir():
        print("tree_kernel_times: --other must name a checkout of the port",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    turns = [("other", args.other.resolve()), ("this", HERE),
             ("this", HERE), ("other", args.other.resolve())]
    runs = {"other": [], "this": []}
    for who, root in turns:
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--worker", str(root), "--seed", str(args.seed)],
                             capture_output=True, text=True, cwd=str(root))
        if res.returncode != 0:
            print(res.stdout[-4000:])
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        runs[who].append(json.loads(res.stdout.strip().splitlines()[-1]))
    table = {}
    for name in runs["this"][0]:
        for key in runs["this"][0][name]:
            cell = {}
            for who in ("other", "this"):
                got = [r[name].get(key) for r in runs[who]]
                if all(isinstance(g, dict) for g in got):
                    cell[who] = dict(
                        device_ms=statistics.median(g["device_ms"] for g in got),
                        device_ms_turns=[g["device_ms"] for g in got],
                        events_ms_turns=[g["events_ms"] for g in got],
                        kernels=got[0]["kernels"])
                else:
                    cell[who] = got[0]
            table[f"{name} {key}"] = cell
            o, t = cell["other"], cell["this"]
            if isinstance(o, dict) and isinstance(t, dict):
                print(f"[{card}] {name} {key}: other device "
                      f"{o['device_ms']:.4f} ms (turns {o['device_ms_turns']}, "
                      f"events {o['events_ms_turns']}), this device "
                      f"{t['device_ms']:.4f} ms (turns {t['device_ms_turns']}, "
                      f"events {t['events_ms_turns']}): "
                      f"{o['device_ms'] / t['device_ms']:.2f}x")
            else:
                print(f"[{card}] {name} {key}: other {o}; this {t}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "table": table}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
