#!/usr/bin/env python3
"""Device times of the port's kernels from two checkouts, on one card, in
one run.

Unpack the commit to compare with into a directory that ``.gitignore``
lists, then run this from the repository root on a machine with one NVIDIA
GPU:

    mkdir -p build/other && git archive <commit> | tar -x -C build/other
    python3 scripts/kernel_times.py --slice tree --other build/other
    python3 scripts/kernel_times.py --slice featurize --other build/other
    python3 scripts/kernel_times.py --slice int8 --other build/other

Each checkout runs in processes of its own, in turns (other, this, this,
other), on the same inputs made from ``--seed`` with ``chip_smoke.py``'s
helpers and seeds. A timed call reports its device time per call from a
``torch.profiler`` trace (every kernel the call launches, so the wrapper's
host work is left out), the device ops per call, the time of each kernel,
and CUDA events around one call (a median).

``--slice tree``: the histogram and ``best_splits`` at the four level
shapes of ``chip_smoke.py``'s phase 3 (cli_xgb, cli_rf, bench_xgb, bench_rf
at L=16) and, at the training CLI's shape, every level width L in
{1, 2, 4, 8, 16} of the xgb rounds (f32, K=3), the dt fit (exact, K=2) and
the forest (8 trees, exact, K=2). The histogram runs on int32 bins, and on
uint8 bins where the checkout takes them; ``best_splits`` reads the
checkout's own level histogram.

``--slice featurize``: ``featurize_bytes`` (the whole device featurize
program) and ``tokenize_hash`` (the scan's stream contract) on a 256-row
chunk of synthetic dialogues staged at W=2048 with the artifact's
featurizer widths (HashingTF 10,000, 256 token slots); then the pipeline
rows/s of LR fp32, LR int8 and a 20-tree forest over 2,048 texts (median of
5 predicts, with each one's device idle share from a trace of one predict)
and the engine msgs/s over 4,096 messages (batch 256, depth 2).

``--slice int8``: ``w8_matmul`` at every Gemma-2B weight shape of
``chip_smoke.py`` (``W8_SHAPES``) at decode (M = 8) and prefill (M = 2,048)
in bf16, and at M = 8 in f32, beside the library's product on a copy of the
same weight in x's type (cuBLAS through ``torch.matmul``, which the port
never calls for int8), each also per call over a back-to-back burst (the
host's launch cost hidden behind the card); and a decode step's 127
products (the bursts times ``W8_STEP_LAUNCHES``).

The card's name and power limit lead the output; the whole table goes to
``chiprun_out/<slice>_kernel_times.json``.
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


def _time(cs, fn, reps: int, events_reps: int) -> dict:
    rows = cs.device_breakdown(fn, reps=reps)
    return dict(device_ms=sum(us for _, us, _ in rows) / 1e3,
                ops_per_call=sum(n for *_, n in rows),
                kernels={key[:60]: us / 1e3 for key, us, _ in rows[:8]},
                events_ms=cs.cuda_ms(fn, events_reps, 3))


def tree_worker(cs, seed: int) -> dict:
    """The tree kernels of one checkout; returns {item: {call: times}}."""
    import torch

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
            row[f"hist_{label}"] = _time(cs, call, 10, 20)
        if trees == 1 or width == 16:   # the forest's: its first tree's level
            h = hist[0].contiguous()
            totals = h[:, 0].sum(dim=1).contiguous()
            row["best_splits"] = _time(
                cs, lambda: H.best_splits(h, totals, criterion=crit), 10, 20)
        out[name] = row
        torch.cuda.empty_cache()
    return out


def featurize_worker(cs, seed: int) -> dict:
    """The featurize path of one checkout and what it feeds; returns
    {item: {call or metric: numbers}}."""
    import json as _json
    import time

    import torch

    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.featurize.device import DeviceFeaturizer
    from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk
    from fraud_detection_tpu_torch.stream import (InProcessBroker,
                                                  StreamingClassifier)

    dev = torch.device("cuda")
    feat = HashingTfIdfFeaturizer(num_features=cs.FEATURES)
    feat.fit_idf([d.text for d in generate_corpus(n=800, seed=7)])
    dfeat = DeviceFeaturizer(feat, width=cs.WIDTH, tokens=cs.TOKENS,
                             device=dev)
    stop = dfeat.stop_table()
    corpus = [d.text for d in generate_corpus(n=cs.BATCH, seed=seed + 11)]
    staged, cls = cs.staged_classes(corpus, cs.WIDTH, dev)
    out = {"chunk": {
        "featurize_bytes": _time(cs, lambda: fk.featurize_bytes(
            staged, stop, spec=dfeat.spec), 20, 50),
        "tokenize_hash": _time(cs, lambda: fk.tokenize_hash(cls), 20, 50)}}

    lr, forest = cs.make_models(feat, seed, dev)
    texts = [d.text for d in generate_corpus(n=2048, seed=seed + 3)]
    pipes = {}
    for name, model, int8 in (("lr_fp32", lr, False), ("lr_int8", lr, True),
                              ("forest", forest, False)):
        pipe = ServingPipeline(feat, model, device=dev, batch_size=cs.BATCH,
                               int8=int8, featurize_device=True,
                               featurize_width=cs.WIDTH,
                               featurize_tokens=cs.TOKENS)
        pipe.predict(texts[: cs.BATCH])
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            pipe.predict(texts)
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        busy = sum(us for _, us, _ in cs.device_breakdown(
            lambda: pipe.predict(texts), reps=1)) / 1e6
        out[f"pipeline_{name}"] = dict(rows_per_s=len(texts) / wall,
                                       wall_s=wall, device_busy_s=busy,
                                       device_idle=1 - busy / wall)
        pipes[name] = pipe

    items = [(_json.dumps({"text": d.text}).encode(), f"m{i}".encode())
             for i, d in enumerate(generate_corpus(n=4096, seed=seed + 6))]
    broker = InProcessBroker()
    broker.producer().produce_batch("in", items)
    engine = StreamingClassifier(pipes["lr_fp32"], broker.consumer(["in"], "g"),
                                 broker.producer(), "out",
                                 batch_size=cs.BATCH, max_wait=0.05,
                                 pipeline_depth=2)
    stats = engine.run(max_messages=len(items), idle_timeout=5.0)
    if len(broker.messages("out")) != len(items):
        raise AssertionError("engine output count != fed count")
    out["engine"] = dict(msgs_per_s=stats.msgs_per_sec)
    return out


def int8_worker(cs, seed: int) -> dict:
    """``w8_matmul`` of one checkout and the library's product beside it;
    returns {shape and M: {call: times}}."""
    import torch

    from fraud_detection_tpu_torch.ops import int8_matmul as W

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(seed)

    def timed(fn, burst: int) -> dict:
        return dict(_time(cs, fn, 10, 20), burst_ms=cs.burst_ms(fn, burst))

    out = {}
    for i, (name, (k, n, layout)) in enumerate(cs.W8_SHAPES.items()):
        q, scale = cs.w8_weight(k, n, layout, dev, seed + i)
        for dtype, ms in ((torch.bfloat16, (8, 2048)), (torch.float32, (8,))):
            w = q.to(dtype)
            for m in ms:
                x = torch.randn((m, k), generator=g, device=dev).to(dtype)
                lib = (lambda: x @ w) if layout == "kn" else (lambda: x @ w.T)
                burst = 100 if m == 8 else 10
                out[f"{name} M={m} {str(dtype)[6:]}"] = {
                    "w8_matmul": timed(lambda: W.w8_matmul(x, q, scale, layout),
                                       burst),
                    "library": timed(lib, burst)}
            del w
        del q, scale
        torch.cuda.empty_cache()
    out["decode_step M=8 bfloat16"] = {
        f"{call}_burst_sum_ms": sum(
            out[f"{s} M=8 bfloat16"][call]["burst_ms"] * cs.W8_STEP_LAUNCHES[s]
            for s in cs.W8_SHAPES) for call in ("w8_matmul", "library")}
    return out


WORKERS = {"tree": tree_worker, "featurize": featurize_worker,
           "int8": int8_worker}


def _summary(got: list):
    """One checkout's turns of one cell: a timed call's median device time
    with every turn's device and events times, else the turns' values. A
    turn whose trace recorded no launch (the profiler drops one now and
    then) has no device time and is left out of the median."""
    if all(isinstance(g, dict) and "device_ms" in g for g in got):
        traced = [g["device_ms"] for g in got if g["ops_per_call"]]
        cell = dict(device_ms=statistics.median(traced) if traced else None,
                    device_ms_turns=[g["device_ms"] for g in got],
                    events_ms_turns=[g["events_ms"] for g in got],
                    ops_per_call_turns=[g["ops_per_call"] for g in got],
                    kernels=got[0]["kernels"])
        if all("burst_ms" in g for g in got):
            cell["burst_ms_turns"] = [g["burst_ms"] for g in got]
        return cell
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slice", choices=sorted(WORKERS), required=True)
    ap.add_argument("--other", type=Path,
                    help="checkout to compare with (run in turns with this one)")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if args.worker is not None:
        sys.path.insert(0, str(args.worker.resolve()))
        print(json.dumps(WORKERS[args.slice](_chip_smoke(), args.seed)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    if args.other is None or not (args.other / "fraud_detection_tpu_torch").is_dir():
        print("kernel_times: --other must name a checkout of the port",
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
                              "--slice", args.slice, "--worker", str(root),
                              "--seed", str(args.seed)],
                             capture_output=True, text=True, cwd=str(root))
        if res.returncode != 0:
            print(res.stdout[-4000:])
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        runs[who].append(json.loads(res.stdout.strip().splitlines()[-1]))
    table = {}
    for name in runs["this"][0]:
        for key in runs["this"][0][name]:
            cell = {who: _summary([r[name].get(key) for r in runs[who]])
                    for who in ("other", "this")}
            table[f"{name} {key}"] = cell
            o, t = cell["other"], cell["this"]
            if (isinstance(o, dict) and isinstance(t, dict)
                    and o["device_ms"] and t["device_ms"]):
                print(f"[{card}] {name} {key}: other device "
                      f"{o['device_ms']:.4f} ms (turns {o['device_ms_turns']}, "
                      f"events {o['events_ms_turns']}, ops a call "
                      f"{o['ops_per_call_turns']}"
                      + (f", bursts {o['burst_ms_turns']}" if "burst_ms_turns" in o
                         else "") + f"), this device "
                      f"{t['device_ms']:.4f} ms (turns {t['device_ms_turns']}, "
                      f"events {t['events_ms_turns']}, ops a call "
                      f"{t['ops_per_call_turns']}"
                      + (f", bursts {t['burst_ms_turns']}" if "burst_ms_turns" in t
                         else "") + "): "
                      f"{o['device_ms'] / t['device_ms']:.2f}x")
            else:
                print(f"[{card}] {name} {key}: other {o}; this {t}")
    out = args.out or HERE / "chiprun_out" / f"{args.slice}_kernel_times.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "slice": args.slice,
                               "turns": runs, "table": table}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
