#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``fraud_detection_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit (nvidia-smi) beside torch's device name;
2. build every CUDA kernel from ``fraud_detection_tpu_torch/ops/csrc`` into
   ``build/torch_kernels/`` and run the kernel self-test;
3. each kernel against its plain torch version on the same CUDA tensors,
   exactly: the featurize scan on synthetic-corpus rows at W=2048, the
   adversarial strings and a seeded fuzz, in both hash modes, then the full
   ``featurize_bytes`` packed output;
4. the serving slice at full width (HashingTF(10000)+IDF, W=2048, L=256,
   B=256; LR fp32, LR int8 and a depth-5 20-tree forest made from --seed)
   on ``cuda`` with device featurization, against the same pipeline on the
   CPU: labels equal and |dp| <= 1e-6;
5. the streaming engine over 4,096 seeded messages (malformed ones
   included): output keys exactly the fed keys, malformed count exact,
   every label equal to ``pipeline.predict`` on its text;
6. timings (CUDA events, median of >= 20 after warm-up) of the kernel, its
   plain version and ``featurize_bytes``; pipeline rows/s and engine msgs/s
   on the host clock;
7. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Launch counts are reset just before the main path (phases 4-5) and read
just after it. It imports nothing of JAX or of ``fraud_detection_tpu``.
"""

from __future__ import annotations

import argparse
import json
import random
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM non-tensor 32-bit rate (NVIDIA data sheet)
SCAN_OPS_PER_ELEMENT = 30   # compare/select/shift/or per (row, column) step

# The adversarial strings of the JAX package's device-featurize tests.
ADVERSARIAL = [
    "hello world hello",
    "",
    "   ",
    "the a an and of urgent urgent account",
    "İstanbul K 42 --- !!!",
    "a  b   c",
    "tab\tand\nnewline stay joined",
    "ALL CAPS MiXeD",
    "ß é ü ñ",
    "x" * 90,
    "z 9 9 9",
    "trailing spaces   ",
    "🚀 emoji 🚀🚀 between 🚀",
    "a" * 12 + " " + "b" * 13,
]
FUZZ_ALPHABET = list("abcXYZ  \t\n0!-'") + ["İ", "K", "ß", "é", "🚀"]

WIDTH, TOKENS, BATCH, FEATURES = 2048, 256, 256, 10000


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, each timed with a
    pair of CUDA events, after ``warmup`` runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_breakdown(fn, reps: int = 10):
    """The device kernels ``fn`` launches, from a torch.profiler (CUPTI)
    trace of ``reps`` calls: [(name, us per call, launches per call)],
    largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / reps, e.count / reps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])


def staged_classes(texts, width, dev, batch=None):
    import torch

    from fraud_detection_tpu_torch.featurize.device import pack_staged
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk

    staged, _ = pack_staged(texts, width, batch)
    staged = torch.from_numpy(staged).to(dev)
    byts, lengths = fk.split_staged(staged)
    return staged, fk.byte_classes(byts, lengths)


def scan_max_err(classes, legacy: bool) -> int:
    """Run the scan kernel and its plain version on the same CUDA tensor;
    raise unless all five outputs are equal. Returns the max |diff| (0)."""
    import torch

    from fraud_detection_tpu_torch.ops import featurize_kernel as fk

    got = fk.tokenize_hash(classes, legacy=legacy)
    want = fk.tokenize_hash_reference(classes, legacy=legacy)
    torch.cuda.synchronize()
    err = 0
    for name, g, w in zip(("h", "w0", "w1", "tok_len", "emp"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"scan {name}: {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        diff = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
        if diff:
            bad = int((g != w).sum())
            raise AssertionError(f"scan kernel != plain version on {name} "
                                 f"(legacy={legacy}): {bad} elements differ")
        err = max(err, diff)
    return err


def make_models(feat, seed: int, dev):
    """LR parameters and a depth-5 20-tree random forest, from ``seed``. Tree
    splits use buckets that occur in the IDF corpus, so rows really branch."""
    import numpy as np

    from fraud_detection_tpu_torch import convert

    rng = np.random.default_rng(seed)
    lr = convert.logistic_from_arrays(
        rng.normal(0.0, 0.5, FEATURES).astype(np.float32), -0.25,
        device=dev)
    depth, n_trees = 5, 20
    n_nodes = 2 ** (depth + 1) - 1
    n_inner = 2 ** depth - 1
    seen = np.flatnonzero(feat.doc_freq > 0)
    feature = np.full((n_trees, n_nodes), -1, np.int32)
    threshold = np.zeros((n_trees, n_nodes), np.float32)
    left = np.full((n_trees, n_nodes), -1, np.int32)
    right = np.full((n_trees, n_nodes), -1, np.int32)
    inner = np.arange(n_inner)
    feature[:, :n_inner] = rng.choice(seen, size=(n_trees, n_inner))
    threshold[:, :n_inner] = rng.uniform(0.0, 3.0, (n_trees, n_inner))
    left[:, :n_inner] = 2 * inner + 1
    right[:, :n_inner] = 2 * inner + 2
    leaf = rng.uniform(0.0, 10.0, (n_trees, n_nodes, 2)).astype(np.float32)
    trees = convert.trees_from_arrays(
        feature, threshold, left, right, leaf, np.ones(n_trees, np.float32),
        kind="random_forest", max_depth=depth, device=dev)
    return lr, trees


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import numpy as np

    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.featurize.device import DeviceFeaturizer
    from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from fraud_detection_tpu_torch.ops import _build
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk
    from fraud_detection_tpu_torch.stream import (InProcessBroker,
                                                  StreamingClassifier)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. card ------------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"[card] nvidia-smi: {card} | torch: {kind} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build("featurize_scan")
    build_s = time.perf_counter() - t0
    fk.kernel_self_test(dev)
    print(f"[build] featurize_scan.cu built in {build_s:.3f} s; self-test ok")
    for line in _build.build_log("featurize_scan").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")

    # -- 3. kernel against plain version ------------------------------------
    corpus_texts = [d.text for d in generate_corpus(n=BATCH, seed=args.seed + 11)]
    rng = random.Random(args.seed + 1234)
    fuzz = ["".join(rng.choice(FUZZ_ALPHABET)
                    for _ in range(rng.randrange(0, 300))) for _ in range(128)]
    fuzz[0] = ""
    staged_main, cls_main = staged_classes(corpus_texts, WIDTH, dev)
    inputs = [("corpus", cls_main),
              ("adversarial", staged_classes(ADVERSARIAL, 128, dev, 16)[1]),
              ("fuzz", staged_classes(fuzz, 256, dev, 130)[1])]
    max_err = 0
    for name, cls in inputs:
        for legacy in (False, True):
            max_err = max(max_err, scan_max_err(cls, legacy))
            print(f"[check] scan kernel == plain version: {name} "
                  f"{tuple(cls.shape)} legacy={legacy}")
    feat = HashingTfIdfFeaturizer(num_features=FEATURES)
    feat.fit_idf([d.text for d in generate_corpus(n=800, seed=7)])
    dfeat = DeviceFeaturizer(feat, width=WIDTH, tokens=TOKENS, device=dev)
    stop = dfeat.stop_table()
    packed_k, n_k = fk.featurize_bytes(staged_main, stop, spec=dfeat.spec)
    h, w0, w1, tl, emp = fk.tokenize_hash_reference(cls_main,
                                                    legacy=dfeat.spec.legacy)
    packed_p, n_p = fk.assemble_packed(h, w0, w1, tl, emp, stop,
                                       spec=dfeat.spec)
    if not (torch.equal(packed_k, packed_p) and torch.equal(n_k, n_p)):
        raise AssertionError("featurize_bytes via the kernel != via the plain version")
    if packed_k.shape != (BATCH, 2, TOKENS) or not bool((n_k > 0).all()):
        raise AssertionError(f"featurize_bytes output {tuple(packed_k.shape)} "
                             "or empty rows on corpus text")
    print(f"[check] featurize_bytes packed {tuple(packed_k.shape)} equal "
          "(kernel vs plain version)")

    # -- 4. the slice at full width (main path) -----------------------------
    lr_gpu, trees_gpu = make_models(feat, args.seed, dev)
    lr_cpu, trees_cpu = make_models(feat, args.seed, "cpu")
    texts = [d.text for d in generate_corpus(n=2048, seed=args.seed + 3)]
    fk.tokenize_hash.launches = 0
    pipes = {}
    for name, gm, cm, int8 in (("lr_fp32", lr_gpu, lr_cpu, False),
                               ("lr_int8", lr_gpu, lr_cpu, True),
                               ("forest", trees_gpu, trees_cpu, False)):
        kw = dict(batch_size=BATCH, int8=int8, featurize_device=True,
                  featurize_width=WIDTH, featurize_tokens=TOKENS)
        gpu = ServingPipeline(feat, gm, device=dev, **kw)
        cpu = ServingPipeline(feat, cm, device="cpu", **kw)
        pg, pc = gpu.predict(texts), cpu.predict(texts)
        if pg.probabilities.shape != (len(texts),) or not np.isfinite(
                pg.probabilities).all():
            raise AssertionError(f"{name}: bad output {pg.probabilities.shape}")
        dp = float(np.abs(pg.probabilities - pc.probabilities).max())
        if not np.array_equal(pg.labels, pc.labels) or dp > 1e-6:
            raise AssertionError(f"{name}: cuda vs cpu labels differ or "
                                 f"|dp| {dp} > 1e-6")
        assert gpu.device_stats.featurize_path == "cuda"
        pipes[name] = gpu
        print(f"[slice] {name}: {len(texts)} texts, labels equal cuda/cpu, "
              f"max |dp| {dp:.3g}, positives {int(pg.labels.sum())}, "
              f"truncated {gpu.device_stats.truncated_rows}")

    # -- 5. engine ----------------------------------------------------------
    def load_broker(n: int, seed: int):
        erng = random.Random(seed)
        items, want, malformed = [], {}, 0
        for i, d in enumerate(generate_corpus(n=n, seed=seed)):
            key = f"m{i}".encode()
            r = erng.random()
            if r < 0.01:
                value, malformed = b'{"text": "unterminated', malformed + 1
            elif r < 0.02:
                value, malformed = json.dumps({"body": d.text}).encode(), malformed + 1
            else:
                value = json.dumps({"text": d.text}).encode()
                want[key] = d.text
            items.append((value, key))
        broker = InProcessBroker()
        broker.producer().produce_batch("in", items)
        return broker, items, want, malformed

    pipe = pipes["lr_fp32"]
    broker, items, want, n_malformed = load_broker(4096, args.seed + 5)
    engine = StreamingClassifier(pipe, broker.consumer(["in"], "g"),
                                 broker.producer(), "out", batch_size=BATCH,
                                 max_wait=0.05, pipeline_depth=2)
    stats = engine.run(max_messages=len(items), idle_timeout=5.0)
    launches = fk.tokenize_hash.launches
    out = broker.messages("out")
    if sorted(m.key for m in out) != sorted(k for _, k in items):
        raise AssertionError("engine output keys != fed keys")
    if stats.malformed != n_malformed:
        raise AssertionError(f"malformed {stats.malformed} != fed {n_malformed}")
    keys = sorted(want)
    expect = dict(zip(keys, pipe.predict([want[k] for k in keys]).labels.tolist()))
    frames = {m.key: json.loads(m.value) for m in out}
    bad = [k for k in keys if frames[k].get("prediction") != expect[k]]
    if bad:
        raise AssertionError(f"{len(bad)} engine labels != pipeline.predict")
    if launches < 1:
        raise AssertionError("the main path never launched the scan kernel")
    print(f"[engine] {len(items)} messages, keys exact, malformed "
          f"{stats.malformed}, labels equal predict; scan launches on the "
          f"main path {launches}")

    # -- 6. times -------------------------------------------------------------
    k_ms = cuda_ms(lambda: fk.tokenize_hash(cls_main), 50, 5)
    p_ms = cuda_ms(lambda: fk.tokenize_hash_reference(cls_main), 20, 2)
    fb_ms = cuda_ms(lambda: fk.featurize_bytes(staged_main, stop,
                                               spec=dfeat.spec), 50, 5)
    rows, cols = cls_main.shape
    nbytes = rows * cols * 4 + 4 * rows * cols * 4 + rows * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = rows * cols * SCAN_OPS_PER_ELEMENT / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    rates = {}
    for name, p in pipes.items():
        p.predict(texts[:BATCH])
        reps = []
        for _ in range(5):
            t0 = time.perf_counter()
            p.predict(texts)
            reps.append(time.perf_counter() - t0)
        rates[name] = len(texts) / statistics.median(reps)
    broker2, items2, _, _ = load_broker(4096, args.seed + 6)
    engine2 = StreamingClassifier(pipe, broker2.consumer(["in"], "g"),
                                  broker2.producer(), "out", batch_size=BATCH,
                                  max_wait=0.05, pipeline_depth=2)
    stats2 = engine2.run(max_messages=len(items2), idle_timeout=5.0)
    msgs_s = stats2.msgs_per_sec
    print(f"[engine] {card}: stats {json.dumps(stats2.as_dict())}")
    print(f"[time] {card}: scan kernel ({rows}, {cols}) {k_ms:.4f} ms; plain "
          f"version {p_ms:.2f} ms; bound {bound_ms * 1e3:.2f} us "
          f"({nbytes / 1e6:.2f} MB moved); featurize_bytes {fb_ms:.4f} ms")
    print(f"[time] {card}: pipeline rows/s at batch {BATCH}: "
          + ", ".join(f"{k} {v:.0f}" for k, v in rates.items())
          + f"; engine msgs/s {msgs_s:.0f}")
    print("[time] library_ms: none — no single PyTorch call computes the scan")
    breakdown = device_breakdown(lambda: fk.featurize_bytes(
        staged_main, stop, spec=dfeat.spec))
    busy = sum(us for _, us, _ in breakdown)
    print(f"[trace] {card}: featurize_bytes device busy {busy:.1f} us/call of "
          f"{fb_ms * 1e3:.1f} us; {sum(n for *_, n in breakdown):.0f} device "
          f"ops/call")
    for name, us, n in breakdown[:8]:
        print(f"[trace]   {us:9.1f} us/call  x{n:.0f}  {name[:90]}")

    # -- 7. result lines -----------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "featurize_scan",
        "route": "cuda",
        "source": "fraud_detection_tpu_torch/ops/csrc/featurize_scan.cu",
        "replaces": "fraud_detection_tpu/ops/featurize_kernel.py:266",
        "launches": launches,
        "max_abs_err": max_err,
        "matched": True,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": [rows, cols],
        "featurize_bytes_ms": fb_ms,
        "card": card,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
