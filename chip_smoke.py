#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``fraud_detection_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit (nvidia-smi) beside torch's device name;
2. build every CUDA kernel from ``fraud_detection_tpu_torch/ops/csrc`` into
   ``build/torch_kernels/`` (one nvcc per source, all started together),
   print each one's ``-Xptxas -v`` report, build the native host featurizer
   with g++ into ``build/native/``, and run the kernels' self-tests
   on hand-reckoned inputs (the histogram's on uint8 and int32 bins, under
   plans that split the pairs into node groups and tree groups and the rows
   into chunks; the featurize kernel's two entries on hand-reckoned rows, an
   overflow row among them);
3. each kernel against its plain torch version on the same CUDA tensors:
   ``featurize_packed`` (the serving path's one featurize kernel) bit for
   bit, packed output and unique counts, two launches bit-equal, on
   synthetic-corpus rows at W=2048, the adversarial strings and a seeded
   fuzz (padding rows included), rows past 256 unique buckets, the fuzz at
   W=8 and rows at W=16,384, in both hash modes, ``binary`` on and off,
   with the English stop table and one holding "", and at 32 slots; the
   stream entry ``featurize_scan`` exactly (corpus, adversarial, fuzz,
   both hash modes); the tree histogram (int path equal,
   f32 path within 1e-5 of the largest cell, two launches bit-equal, T=1
   and T=8, uint8 bins as the trainer passes them and int32 bins, the two
   bit-equal) and ``best_splits`` (indices equal, gains bit-equal, gini and
   xgb, a ragged feature tile, an all-invalid node) at the training CLI's
   shape (1,120 x 10,000, the real TF-IDF bins) and at the bench shape
   (100,000 x 2,048, zero-inflated bins); both again at every level width
   L in {1, 2, 4, 8, 16} at the CLI shape (the histogram for the xgb, dt
   and 8-tree forest levels, each width its own plan, on both bin widths;
   ``best_splits`` on the xgb and dt levels it reads);
4. the serving slice at full width (HashingTF(10000)+IDF, W=2048, L=256,
   B=256; LR fp32, LR int8 and a depth-5 20-tree forest made from --seed)
   on ``cuda`` with device featurization, against the same pipeline on the
   CPU: labels equal and |dp| <= 1e-6;
5. the streaming engine over 4,096 seeded messages (malformed ones
   included): output keys exactly the fed keys, malformed count exact,
   every label equal to ``pipeline.predict`` on its text; phases 4-5 must
   launch ``featurize_packed`` once per chunk the card pipelines dispatch
   and never the stream entry, whose own path
   (``tokenize_hash`` over phase 4's texts, a call a chunk) follows;
5b. the serve CLI's default path (phase 2 built the native host
   featurizer, ``featurize/native.py``, printing the g++ command; a library
   that does not build or load fails the run with the compiler's message):
   the host-featurize pipelines (LR fp32, LR int8, the forest) on the card
   against the CPU (labels equal, |dp| <= 1e-6) and against phase 4's
   device-featurize pipelines (labels equal), their raw-JSON path equal to
   ``predict``; the engine over phase 5's messages on the raw-JSON path
   with native frames (``_json_fast`` and ``_frames_ok`` True), sync and
   with the dispatch lane: keys exact, wires byte-identical, labels equal
   ``predict``; the scheduler's overload case (out + DLQ keys == fed,
   shed > 0); no ``featurize_packed`` launch in any of it. Then the serve
   CLI (``app/serve.py main``, ``--demo 4096 --batch-size 1024``) on a
   checkpoint of the seeded LR that ``save_checkpoint`` writes: host
   featurize (no ``featurize_packed`` launch, the raw-JSON path and native
   frames), ``--featurize-device`` (one launch per chunk dispatched) and
   ``--async-dispatch --int8``: each exits 0 and classifies every message;
6. the training slice at full width (the CLI's 1,600-dialogue synthetic
   corpus, HashingTF(10000), depth 5, 32 bins), card against CPU: dt and a
   16-tree rf (JAX's threefry draws, made on each device) equal tree for
   tree, 16-round xgb within 1e-4 in p;
7. the training CLI on the card (dt, rf 100 trees, xgb 100 rounds): dt's
   and rf's metrics equal the JAX package's recorded ones
   (reports/metrics.json),
   and its saved checkpoint served by ``ServingPipeline.from_checkpoint``
   gives the dense ``predict`` labels;
7b. the serve CLI on that dt checkpoint, host featurize and
   ``--featurize-device``, with phase 5b's gates;
8. timings (CUDA events, median of >= 10 after warm-up) of each kernel, its
   plain version and its library call where one exists (both featurize
   entries in turns with their profiler device time, beside the first scan
   kernel's recorded 1.1390 ms; the histogram at
   four shapes on uint8 and int32 bins, each with its own byte bound, beside
   ``index_add_`` and the first kernel's recorded time; both tree kernels
   at every level width of the CLI's fits, with their device time from the
   profiler and their sums per xgb100, rf100 and dt fit); pipeline rows/s
   (device featurize and native host featurize in turns) and the host
   encode alone, engine msgs/s (raw JSON with native frames, the slow
   path, device featurize, the dispatch lane; in turns), the serve CLI's
   msgs/s and the fits' walls (CLI shape and bench shape) on the host
   clock, each pipeline's and engine run's device idle share (device time
   over the wall of the same profiled call); profiler breakdowns of
   ``featurize_bytes`` (one launch a call, and the one kernel in its
   trace) and of a DT fit;
9. the flash-attention kernels against their plain version: the sm90
   route (bf16, wgmma) at the prefill shape (1, 2048, 8, 256) with one K/V
   head and at ragged bf16 shapes (B=2, T in {1, 64, 127, 1000, 2049}, d in
   {64, 128, 256}, 1, 2 or 4 K/V heads over 4); the SIMT route at f32
   ragged shapes with GQA and at phase 11's shape (1, 600, 8, 256) with one
   K/V head; native-width K/V bit-equal to expanded, two launches
   bit-equal, on every shape;
10. the explanation LLM's prefill at full width (the Gemma-2B architecture,
   18 layers, bf16, weights N(0, 0.02) from --seed): ``forward`` at T=2048
   through the flash kernel (18 launches, all on the sm90 route) against
   the chunked path, prefill tokens/s at T=2048 and 8192, and a profiler
   breakdown;
11. card against CPU at Gemma widths, 2 layers, f32, T=600 (the SIMT
   route's path: 2 launches): last logits within 5e-4, and greedy batched
   generation equal (and equal to B=1); sampled generation at temperature
   1.0, card against CPU, rows equal reported (the logits differ by up to
   5e-4, so a near-tie may flip a token; not gated);
12. greedy generation at full width (bench.py's 8 prompts, 64 new tokens):
   tokens/s and explanations/s; rows equal to B=1 calls is reported (bf16
   GEMMs of other shapes may round apart; phase 11 is the gate); the token
   choice at B=8 x 256,000, greedy against sampled;
13. the streaming engine with ``explain_batch_fn`` over the on-device
   model (1,024 messages, ~5% scam, the CLI's dt as classifier, batch
   512, 48 new tokens): keys exact, ``analysis`` on exactly the flagged
   rows; msgs/s with and without the hook, flagged explanations/s;
14. flash times at T=2048 and 8192, in one run on one card: the sm90
   kernel and the SIMT kernel on the same bf16 inputs (in turns: sm90,
   SIMT, SIMT, sm90), ``scaled_dot_product_attention`` (the library
   yardstick), the plain version, and the bound; the same four for the
   SIMT kernel at phase 11's f32 shape;
15. a ``{"kernels": [...]}`` line (six entries: featurize_packed, the
   stream entry, histogram, best_splits, both flash routes), then the last
   line
   ``{"ok": true, "device": {...}}``.

Launch counts are reset just before each main path (serving: phases 4-5;
the stream entry: the pass after phase 5; ``featurize_packed`` again
before phase 5b's host pipelines and before each serve CLI run;
training: phase 7, the CLI; the LLM prefill: one T=2048 forward in phase
10, for the sm90 flash kernel; the f32 forward of phase 11, for the SIMT
flash kernel) and read just after it. It imports nothing of JAX or of
``fraud_detection_tpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM non-tensor 32-bit rate (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate (data sheet)
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
SERVE_DEMO = 4096   # messages a serve CLI run classifies (--demo)
KERNELS = ("featurize_scan", "histogram", "best_splits", "flash_attention",
           "flash_attention_sm90")
ROOT = Path(__file__).resolve().parent
# The training CLI's shipped configuration and the JAX bench's training shape.
DEPTH, NBINS, CLI_N, CLI_SEED = 5, 32, 1600, 42
LEVEL_WIDTHS = (1, 2, 4, 8, 16)   # the nodes of each split level at depth 5
HIST_KERNELS, GAIN_KERNELS = ("hist_kernel", "reduce_chunks"), ("_slabs",)
# The first kernels' events times as PERF.md records them (NVIDIA H100 80GB
# HBM3 at 700 W), printed as recorded beside this run's; their device times
# come from scripts/kernel_times.py --slice tree.
FIRST_HIST_MS = {"cli_xgb": 0.1606, "cli_rf": 0.8936, "bench_xgb": 1.8768,
                 "bench_rf": 12.3148}
FIRST_GAIN_MS = {"bench_xgb": 0.2048, "cli_rf": 0.2466, "cli_xgb": 0.2732}
FIRST_SCAN_MS = 1.1390   # the first scan kernel at (256, 2049), as PERF.md records
BENCH_ROWS, BENCH_FEATURES = 100_000, 2048
# The explanation LLM: Gemma-2B's architecture (bench.py GEMMA2B_HF_CONFIG).
GEMMA_2B = dict(vocab_size=256_000, d_model=2048, n_layers=18, n_heads=8,
                n_kv_heads=1, head_dim_override=256, d_ff=16_384,
                activation="gelu", embed_scale=math.sqrt(2048),
                tie_embeddings=True, rms_eps=1e-6, rope_theta=10000.0,
                max_seq=4096)
FLASH_MAIN = (1, 2048, 8, 256)      # the prefill's q shape; one K/V head
FLASH_SIMT_MAIN = (1, 600, 8, 256)  # phase 11's q shape (f32); one K/V head
# f32: the JAX flash test's 2e-5, absolute plus relative. bf16: absolute, from
# this shape's own reading (max |diff| 0.0039 at (1, 2048, 8, 256), where
# most outputs are a few hundredths), so a kernel that drops or misweights
# keys fails it.
FLASH_F32_TOL, FLASH_BF16_ATOL = 2e-5, 1e-2
# Ragged bf16 shapes: at small T an output averages a few v values and is
# O(1), where one bf16 step is up to 2^-7 relative, so the ragged gate adds
# 2^-7 relative to the absolute 1e-2.
FLASH_BF16_RTOL = 2.0 ** -7
FLASH_RAGGED_T, FLASH_RAGGED_D, FLASH_RAGGED_H = (1, 64, 127, 1000, 2049), (64, 128, 256), 4
CARD_CPU_TOL = 5e-4                 # the JAX flash forward test's bound
# bench.py's generation prompts (mk_prompts(8)).
GEN_PROMPTS = [f"Analyze this dialogue for scam risk (case {i}): the caller "
               "claims to be the bank fraud department and demands immediate "
               "gift card payment to reverse a suspicious charge. "
               + "Customer hesitates repeatedly. " * (i % 3 + 1)
               for i in range(8)]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    """One line from nvcc's ``-Xptxas -v`` report: the functions compiled,
    their register range, the largest stack frame and spills, and any
    warning."""
    import re

    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", log)
    worst = max(((int(a), int(b), int(c)) for a, b, c in frames), default=(0, 0, 0))
    spilling = sum(1 for _, b, c in frames if int(b) or int(c))
    warnings = [l.strip() for l in log.splitlines() if "warning" in l]
    return (f"{len(regs)} functions, {min(regs, default=0)}-{max(regs, default=0)} "
            f"registers; largest stack frame {worst[0]} B, spill stores / loads "
            f"{worst[1]} / {worst[2]} B ({spilling} functions spill)"
            + (f"; warnings: {warnings}" if warnings else "; no warnings"))


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


def device_breakdown(fn, reps: int = 10, tries: int = 3):
    """The device kernels ``fn`` launches, from a torch.profiler (CUPTI)
    trace of ``reps`` calls: [(name, us per call, launches per call)],
    largest first. Now and then a trace records no device activity at all
    (the profiler drops it, not the card); such a trace is taken again, up
    to ``tries`` times, and an empty list means every try came back empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    rows = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.device_time_total / reps, e.count / reps)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if rows:
            break
    return sorted(rows, key=lambda r: -r[1])


def kernel_device_ms(fn, names, reps: int = 10) -> float:
    """Milliseconds of device time per call of ``fn`` in the kernels whose
    name contains one of ``names``, each of which ``fn`` launches once: the
    sum over those kernels of a profiler trace's time per recorded launch
    (the trace may miss a few launches, which a per-call average would
    count as zero; the wrapper's host work, which CUDA events around one
    call include, is left out)."""
    return sum(us / n for key, us, n in device_breakdown(fn, reps)
               if n and any(k in key for k in names)) / 1e3


def burst_ms(fn, n: int) -> float:
    """Milliseconds per call of ``fn`` over ``n`` back-to-back calls between
    one pair of CUDA events, after a warm-up call: the host enqueues ahead
    of the card, so unlike ``cuda_ms`` a launch's host cost is hidden
    whenever it is shorter than the kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


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


def packed_spec(base, **over):
    """``base`` (a FeaturizeSpec) with fields replaced; the "" token's bucket
    follows the hash mode and feature count."""
    from fraud_detection_tpu_torch.featurize.hashing import spark_hash_bucket

    spec = base._replace(**over)
    return spec._replace(empty_bucket=spark_hash_bucket(
        "", spec.num_features, spec.legacy))


def packed_max_err(label: str, staged, stop, spec, scans: dict) -> int:
    """Run ``featurize_packed`` twice and its plain version once on the same
    CUDA tensors; raise unless the two launches are bit-equal and equal the
    plain version (packed output and unique counts). The plain version's
    scan is kept per (input, hash mode) in ``scans``: assemble_packed is
    the only step a spec changes. Returns the max |diff| (0)."""
    import torch

    from fraud_detection_tpu_torch.ops import featurize_kernel as fk

    got = fk.featurize_bytes(staged, stop, spec=spec)
    again = fk.featurize_bytes(staged, stop, spec=spec)
    key = (label.split()[0], spec.legacy)
    if key not in scans:
        scans[key] = fk.tokenize_hash_reference(
            fk.byte_classes(*fk.split_staged(staged)), legacy=spec.legacy)
    want = fk.assemble_packed(*scans[key], stop, spec=spec)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"featurize_packed {label}: two launches differ")
    for name, g, w in zip(("packed", "n_unique"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"featurize_packed {label} {name}: "
                                 f"{tuple(g.shape)}/{g.dtype} vs "
                                 f"{tuple(w.shape)}/{w.dtype}")
        if not torch.equal(g, w):
            rows = (g != w).reshape(g.shape[0], -1).any(dim=1).nonzero()
            raise AssertionError(f"featurize_packed {label} != plain version "
                                 f"on {name}: rows {rows.flatten().tolist()[:8]}")
    n = got[1]
    print(f"[check] featurize_packed == plain version, launches bit-equal: "
          f"{label} {tuple(staged.shape)} (legacy={spec.legacy}, binary="
          f"{spec.binary}, empty_is_stop={spec.empty_is_stop}, slots "
          f"{spec.n_slots}; unique per row {int(n.min())}-{int(n.max())}, "
          f"{int((n > spec.n_slots).sum())} rows past the slots)")
    return 0


def packed_inputs(corpus_texts, fuzz, dev, seed: int):
    """The staged inputs phase 3 holds featurize_packed to: W=2048 corpus
    rows, the adversarial strings (padding rows included), the seeded fuzz,
    rows of random words with more unique buckets than 256 slots, the fuzz
    at W=8, and W=16,384 rows (long dialogues, one truncated, "", a
    16,000-letter token, padding)."""
    import torch

    from fraud_detection_tpu_torch.featurize.device import pack_staged

    rng = random.Random(seed)
    letters = "abcdefghijklmnopqrstuvwxyz"
    words = ["".join(rng.choice(letters) for _ in range(rng.randrange(2, 5)))
             for _ in range(900)]
    overflow = [" ".join(rng.choice(words[: rng.choice((450, 900))])
                         for _ in range(600))[:WIDTH] for _ in range(6)]
    long_rows, i = [], 0
    for target in (16_384, 16_000, 20_000, 9_000):
        row = ""
        while len(row) < target:
            row += corpus_texts[i % len(corpus_texts)] + " "
            i += 1
        long_rows.append(row[:target])
    long_rows += ["", "Q" * 16_000 + " end"]

    def stage(texts, width, batch=None):
        return torch.from_numpy(pack_staged(texts, width, batch)[0]).to(dev)

    return [("corpus", stage(corpus_texts, WIDTH)),
            ("adversarial", stage(ADVERSARIAL, 128, 16)),
            ("fuzz", stage(fuzz, 256, 130)),
            ("overflow", stage(overflow, WIDTH, 8)),
            ("w8", stage(fuzz, 8, 130)),
            ("w16384", stage(long_rows, 16_384, 8))]


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


# ---------------------------------------------------------------------------
# tree training
# ---------------------------------------------------------------------------

def cli_data(dev):
    """The training CLI's data at full width: the synthetic corpus (n=1600,
    seed 42), its 70/10/20 split and HashingTF(10000)+IDF fitted on the
    training texts, as host matrices (train, test) plus the test texts."""
    import numpy as np

    from fraud_detection_tpu_torch.data import (generate_corpus,
                                                train_val_test_split)
    from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer

    corpus = [(d.text, d.label)
              for d in generate_corpus(n=CLI_N, seed=CLI_SEED)]
    train, _, test = train_val_test_split(corpus, seed=CLI_SEED)
    feat = HashingTfIdfFeaturizer(num_features=FEATURES)
    feat.fit_idf([t for t, _ in train])

    def dense(split):
        return feat.featurize_dense([t for t, _ in split],
                                    device=dev).cpu().numpy()

    return (dense(train), np.asarray([l for _, l in train], np.float32),
            dense(test), [t for t, _ in test])


def bench_bins(dev, seed: int):
    """(100,000 x 2,048) int32 bins shaped like a quantile-binned TF-IDF
    matrix, made on the card from ``seed``: each feature is nonzero in 2-12%
    of rows, which spread over its upper bins, and its zeros collapse into
    bin 0. Labels come from 16 features plus noise."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    n, f = BENCH_ROWS, BENCH_FEATURES
    rate = 0.02 + 0.10 * torch.rand((1, f), generator=g, device=dev)
    low = torch.floor(NBINS * (1.0 - rate)).clamp(max=NBINS - 1)
    upper = low + torch.floor(
        torch.rand((n, f), generator=g, device=dev) * (NBINS - low))
    nonzero = torch.rand((n, f), generator=g, device=dev) < rate
    bins = torch.where(nonzero, upper, torch.zeros_like(upper)).to(torch.int32)
    score = (bins[:, :16].to(torch.float32).sum(dim=1)
             + 4.0 * torch.randn((n,), generator=g, device=dev))
    return bins.contiguous(), (score > score.median()).to(torch.float32)


def level_inputs(n: int, trees: int, k: int, labels, dev, seed: int,
                 width: int = 16):
    """One level's kernel inputs. At the default width, depth 4 of a
    depth-5 tree (16 nodes): node ids in [0, 15), node 15 left empty, ~1/16
    of the rows inactive (id 16); at another width, ids in [0, width).
    Poisson(1) bootstrap weights for a forest chunk (trees > 1), else ones;
    stats the one-hot labels (k=2) or xgb (grad, hess, count) from random
    margins (k=3)."""
    import torch

    from fraud_detection_tpu_torch.models.train_trees import _poisson1

    g = torch.Generator(device=dev).manual_seed(seed)
    loc = torch.randint(0, width, (trees, n), generator=g, device=dev)
    if width == 16:
        loc = torch.where(loc == 15, 16, loc)
    loc = loc.to(torch.int32).contiguous()
    w = (_poisson1(torch.rand((trees, n), generator=g, device=dev))
         if trees > 1 else torch.ones((1, n), device=dev))
    if k == 2:
        stats = torch.stack([1.0 - labels, labels], dim=1)
    else:
        p = torch.sigmoid(torch.randn((n,), generator=g, device=dev))
        stats = torch.stack([p - labels, p * (1.0 - p), torch.ones_like(p)],
                            dim=1)
    return loc, w.contiguous(), stats.contiguous()


def check_histogram(label: str, bins, loc, w, stats, exact: bool,
                    n_nodes: int = 16):
    """Kernel twice and plain version on the same CUDA tensors; raises
    unless the two launches are bit-equal and the kernel equals the plain
    version (exact path) or lies within 1e-5 of its largest |cell| (f32).
    Returns (max |diff|, the kernel's histogram)."""
    import torch

    from fraud_detection_tpu_torch.ops import histogram as H

    kw = dict(n_nodes=n_nodes, n_bins=NBINS, exact_int8=exact)
    a = H.node_feature_bin_histogram_multi(bins, loc, w, stats, **kw)
    b = H.node_feature_bin_histogram_multi(bins, loc, w, stats, **kw)
    ref = H.histogram_reference(bins, loc, w, stats, **kw)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"histogram {label}: two launches differ")
    err = float((a - ref).abs().max())
    scale = float(ref.abs().max())
    if (exact and err != 0.0) or err > 1e-5 * scale:
        raise AssertionError(f"histogram {label} (exact={exact}): kernel vs "
                             f"plain max |diff| {err} at scale {scale}")
    n, f = bins.shape
    plan = H.histogram_plan(n, f, loc.shape[0], n_nodes, NBINS,
                            stats.shape[1], exact)
    print(f"[check] histogram {label} {tuple(a.shape)} {bins.dtype} bins "
          f"exact={exact}: max |diff| {err:.3g} (largest cell {scale:.6g}), "
          f"two launches bit-equal; {plan}")
    return err, a


def check_best_splits(label: str, hist, totals, criterion: str,
                      empty_node=15) -> None:
    """Kernel and plain version on the same CUDA tensors, at the default
    and a ragged feature tile: indices equal, gains bit-equal, and the
    empty node (if any) returns (0, 0, -inf)."""
    import torch

    from fraud_detection_tpu_torch.ops import histogram as H

    for tile in (1024, 300):
        kf, kb, kg = H.best_splits(hist, totals, criterion=criterion,
                                   feature_tile=tile)
        pf, pb, pg = H.best_splits_reference(hist, totals, criterion=criterion)
        torch.cuda.synchronize()
        if not (torch.equal(kf, pf) and torch.equal(kb, pb)
                and torch.equal(kg, pg)):
            raise AssertionError(f"best_splits {label} {criterion} tile {tile}:"
                                 " kernel != plain version")
        e = empty_node
        if e is not None and (int(kf[e]), int(kb[e]), float(kg[e])) != (
                0, 0, float("-inf")):
            raise AssertionError(f"best_splits {label}: the empty node gave "
                                 f"{(int(kf[e]), int(kb[e]), float(kg[e]))}")
    valid = int(torch.isfinite(kg).sum())
    print(f"[check] best_splits {label} {criterion} {tuple(hist.shape)}: "
          f"indices equal, gains bit-equal (tiles 1024 and 300), "
          f"{valid}/{hist.shape[0]} nodes with a valid split"
          + ("" if empty_node is None else ", empty node -> (0, 0, -inf)"))


def histogram_library_call(bins, loc, w, stats, n_nodes: int):
    """One ``index_add_`` over the flat segment id ((t*L + l)*F + f)*NB + b
    computing the same histogram, with ids and values built beforehand
    into tensors allocated once (no concatenated copy). Returns (the call
    to time, None), or (None, bytes it would need) when the card cannot
    hold its ids and values."""
    import torch

    n, f = bins.shape
    k = stats.shape[1]
    t = loc.shape[0]
    active = (loc >= 0) & (loc < n_nodes)
    total = int(active.sum()) * f
    need = total * (8 + 4 * k)
    try:
        flat = torch.empty((total,), dtype=torch.int64, device=bins.device)
        val = torch.empty((total, k), dtype=torch.float32, device=bins.device)
        cols = torch.arange(f, device=bins.device, dtype=torch.int64)
        at = 0
        for ti in range(t):
            rows = torch.nonzero(active[ti])[:, 0]
            m = rows.numel() * f
            base = (ti * n_nodes + loc[ti, rows].to(torch.int64)) * f
            flat[at:at + m].view(-1, f).copy_(
                (base[:, None] + cols[None, :]) * NBINS + bins[rows].to(torch.int64))
            v = stats[rows] * w[ti, rows][:, None]
            val[at:at + m].view(-1, f, k).copy_(v[:, None, :].expand(-1, f, -1))
            at += m
            del rows, base, v
        out = torch.zeros((t * n_nodes * f * NBINS, k), dtype=torch.float32,
                          device=bins.device)
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return None, need
    return (lambda: out.index_add_(0, flat, val)), None


def histogram_bound(bins, loc, w, stats, n_nodes: int):
    """(bound ms, "bytes" | "operations", MB moved): the bins (at the width
    passed, 1 byte for uint8) of the rows some tree uses, the per-row inputs
    and the output once, at the HBM rate; one multiply and one add per
    (tree, active row, feature, stat) at the 32-bit rate."""
    n, f = bins.shape
    t, k = loc.shape[0], stats.shape[1]
    active = (loc >= 0) & (loc < n_nodes)
    rows = int(active.any(dim=0).sum())
    nbytes = (rows * f * bins.element_size() + loc.numel() * 4 + w.numel() * 4
              + stats.numel() * 4 + t * n_nodes * f * NBINS * k * 4)
    ops = int(active.sum()) * f * k * 2
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations", nbytes / 1e6


def best_splits_bound(hist):
    """(bound ms, "bytes" | "operations"): the histogram, totals and
    results moved once; per (node, feature, bin) candidate K prefix adds, K
    subtractions and ~12 gain operations at the 32-bit rate."""
    L, f, nb, k = hist.shape
    nbytes = hist.numel() * 4 + L * k * 4 + L * 12
    ops = L * f * (nb - 1) * (2 * k + 12)
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def train_card_vs_cpu(Xtr, ytr, Xte, dev) -> dict:
    """dt, a 16-tree rf and a 16-round xgb at full width on the card and on
    the CPU: dt and rf equal tree for tree (feature, threshold, children,
    leaf stats), xgb test-set max |dp| <= 1e-4. Returns host walls."""
    import dataclasses

    import torch

    from fraud_detection_tpu_torch.models import train_trees as tt
    from fraud_detection_tpu_torch.models import trees as tm
    from fraud_detection_tpu_torch.ops import histogram as H

    cfg = tt.TreeTrainConfig(max_depth=DEPTH, n_bins=NBINS)
    fits = {
        "dt": lambda d: tt.fit_decision_tree(Xtr, ytr, config=cfg, device=d),
        "rf16": lambda d: tt.fit_random_forest(Xtr, ytr, n_trees=16,
                                               seed=CLI_SEED, config=cfg,
                                               device=d),
        "xgb16": lambda d: tt.fit_gradient_boosting(
            Xtr, ytr, n_rounds=16,
            config=dataclasses.replace(cfg, criterion="xgb"), device=d),
    }
    h0, b0 = H.node_feature_bin_histogram_multi.launches, H.best_splits.launches
    walls = {}
    for name, fit in fits.items():
        t0 = time.perf_counter()
        card = fit(dev)
        walls[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = fit("cpu")
        cpu_s = time.perf_counter() - t0
        if name == "xgb16":
            pg = tm.predict(card, torch.from_numpy(Xte).to(dev))[1].cpu()
            pc = tm.predict(cpu, torch.from_numpy(Xte))[1]
            dp = float((pg - pc).abs().max())
            if dp > 1e-4:
                raise AssertionError(f"xgb16: card vs cpu test max |dp| {dp}")
            same = f"test max |dp| {dp:.3g}"
        else:
            for field in ("feature", "threshold", "left", "right", "leaf"):
                if not torch.equal(getattr(card, field).cpu(),
                                   getattr(cpu, field)):
                    raise AssertionError(f"{name}: card and cpu trees differ "
                                         f"in {field}")
            same = "trees equal"
        print(f"[train] {name}: card vs cpu {same}; {card.num_trees} trees, "
              f"card {walls[name]:.3f} s, cpu {cpu_s:.3f} s (host clock)")
    launched = (H.node_feature_bin_histogram_multi.launches - h0,
                H.best_splits.launches - b0)
    if min(launched) < 1:
        raise AssertionError(f"training phase launches {launched}")
    print(f"[train] card fits launched histogram {launched[0]}x, best_splits "
          f"{launched[1]}x")
    return walls


def train_cli(dev, test_texts) -> dict:
    """The training CLI on the card at its defaults (dt, rf 100 trees, xgb
    100 rounds), saving dt. dt's and rf's metrics must equal the JAX
    package's recorded run (reports/metrics.json, same corpus, split, exact
    gini and, for rf, the same threefry draws);
    the saved checkpoint, served with device featurization, must give the
    dense ``predict`` labels on the test texts. Returns the report."""
    import contextlib
    import io

    import numpy as np
    import torch

    from fraud_detection_tpu_torch.app import train as cli
    from fraud_detection_tpu_torch.models import trees as tm
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline

    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    ckpt, metrics = out / "dt", out / "metrics.json"
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = cli.main(["--device", str(dev), "--models", "dt,rf,xgb",
                       "--n-trees", "100", "--n-rounds", "100",
                       "--save", f"dt={ckpt}", "--metrics-out", str(metrics)])
    if rc != 0:
        raise AssertionError(f"train CLI exit {rc}:\n{log.getvalue()}")
    report = json.loads(metrics.read_text())
    ref = json.loads((ROOT / "reports" / "metrics.json").read_text())
    for name in ("dt", "rf", "xgb"):
        got, want = report["metrics"][name]["Test"], ref["metrics"][name]["Test"]
        print(f"[cli] {name} test: accuracy {got['accuracy']:.4f} f1 "
              f"{got['f1']:.4f} auc {got['auc']:.4f} (JAX package's recorded "
              f"run: {want['accuracy']:.4f} / {want['f1']:.4f} / "
              f"{want['auc']:.4f}); fit {report['meta']['train_seconds'][name]}"
              " s host clock")
    for name in ("dt", "rf"):
        if report["metrics"][name] != ref["metrics"][name]:
            raise AssertionError(f"{name} metrics differ from the JAX "
                                 "package's recorded run")
    width = -(-max(len(t.encode()) for t in test_texts) // 64) * 64
    tokens = -(-max(sum(c.isspace() for c in t) + 1 for t in test_texts)
               // 16) * 16
    pipe = ServingPipeline.from_checkpoint(
        str(ckpt), device=dev, featurize_device=True, featurize_width=width,
        featurize_tokens=tokens)
    served = pipe.predict(test_texts)
    dense = pipe.featurizer.featurize_dense(test_texts, device=dev)
    labels = tm.predict(pipe.model, dense)[0].cpu().numpy()
    if not np.array_equal(served.labels, labels):
        raise AssertionError("served dt labels != dense predict labels")
    want_path = "cuda" if torch.device(dev).type == "cuda" else "torch"
    if (pipe.device_stats.truncated_rows
            or pipe.device_stats.featurize_path != want_path):
        raise AssertionError(f"served dt: {pipe.device_stats.snapshot()}")
    print(f"[cli] dt and rf metrics equal the recorded JAX run; checkpoint "
          f"served on {dev} (device featurize W={width}, L={tokens}): "
          f"{len(test_texts)} labels equal dense predict")
    return report


# ---------------------------------------------------------------------------
# explanation LLM
# ---------------------------------------------------------------------------

def flash_inputs(shape, hkv: int, dtype, dev, seed: int):
    """q (B, T, H, d) and k/v (B, T, hkv, d), standard normal, from seed."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    b, t, _, d = shape
    return tuple(torch.randn(s, generator=g, device=dev).to(dtype)
                 for s in (shape, (b, t, hkv, d), (b, t, hkv, d)))


def check_flash(label: str, q, k, v, atol: float, rtol: float = 0.0,
                route: str = "", quiet: bool = False):
    """Kernel twice and plain version once on the same CUDA tensors; raises
    unless the launches are bit-equal, native-width K/V give what expanded
    K/V give bit for bit, and |kernel - plain| <= atol + rtol * |plain|
    everywhere. ``route`` names the kernel ("sm90" or "simt"); by default
    ``flash_attention`` picks it, and the check raises unless it picked the
    route ``flash_route`` names. Returns max |kernel - plain|."""
    import torch

    from fraud_detection_tpu_torch.ops import attention as A

    want = A.flash_route(q.dtype, q.shape[3])
    fn = {"sm90": A.flash_attention_sm90, "simt": A.flash_attention_simt,
          "": A.flash_attention}[route]
    counts = (A.flash_attention_sm90.launches, A.flash_attention_simt.launches)
    a = fn(q, k, v)
    b = fn(q, k, v)
    rep = q.shape[2] // k.shape[2]
    e = fn(q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2))
    ran = {"sm90": A.flash_attention_sm90.launches - counts[0],
           "simt": A.flash_attention_simt.launches - counts[1]}
    if ran[route or want] != 3:
        raise AssertionError(f"flash {label}: launches by route {ran}, want 3 "
                             f"on {route or want}")
    ref = A.flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"flash {label}: two launches differ")
    if not torch.equal(a, e):
        raise AssertionError(f"flash {label}: native K/V != expanded K/V")
    diff = (a.float() - ref.float()).abs()
    err = float(diff.max())
    rms = float(ref.float().square().mean().sqrt())
    if not bool(torch.isfinite(a).all()) or not bool(
            (diff <= atol + rtol * ref.float().abs()).all()):
        raise AssertionError(f"flash {label}: kernel vs plain max |diff| "
                             f"{err} beyond {atol} (+ {rtol} relative)")
    if not quiet:
        print(f"[check] flash {label} ({route or want}) q {tuple(q.shape)} kv "
              f"heads {k.shape[2]} {q.dtype}: max |diff| {err:.3g} (limit "
              f"{atol} + {rtol} relative), plain output RMS {rms:.3g}, two "
              "launches bit-equal, native K/V == expanded K/V")
    return err


def flash_bound(shape, hkv: int, itemsize: int):
    """(bound ms, "bytes" | "operations"): q, k, v read and out written once
    at the HBM rate, against 4 d operations (q.k and p.v) per causal (query,
    key) pair and head at the bf16 tensor-core rate (itemsize 2) or the
    non-tensor f32 rate (itemsize 4: TF32 would not give f32 results)."""
    b, t, h, d = shape
    nbytes = (2 * b * t * h * d + 2 * b * t * hkv * d) * itemsize
    ops = 4 * b * h * d * (t * (t + 1) // 2)
    rate = BF16_OPS_PER_S if itemsize == 2 else FP32_OPS_PER_S
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def sdpa_call(q, k, v):
    """One ``scaled_dot_product_attention(is_causal=True)`` on the same
    inputs in its (B, H, T, d) layout, K/V at native width."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)


def gemma(dev, seed: int, **over):
    """A language model of Gemma-2B's architecture with weights N(0, 0.02)
    drawn on ``dev`` from ``seed`` (norm gains 1), as bench.py's synthetic
    checkpoint; ``over`` replaces config fields."""
    import torch

    from fraud_detection_tpu_torch.models.llm import (LanguageModel,
                                                      TransformerConfig)

    cfg = TransformerConfig(**{**GEMMA_2B, "dtype": torch.bfloat16, **over})
    return LanguageModel.init_random(cfg, seed=seed, device=dev, std=0.02)


def prefill(lm, dev, seed: int, card: str) -> dict:
    """The flash path's main run: one T=2048 forward with the launch count
    reset before and read after (18 = one per layer), held against the
    chunked path (``use_flash=False``) on the card; then prefill times at
    T=2048 and 8192 and a profiler breakdown at T=2048."""
    import torch

    from fraud_detection_tpu_torch.models.llm import forward
    from fraud_detection_tpu_torch.ops import attention as A

    cfg = lm.cfg
    g = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, 8192), generator=g, device=dev)
    short = toks[:, :2048]
    with torch.inference_mode():
        A.flash_attention.launches = 0
        A.flash_attention_sm90.launches = A.flash_attention_simt.launches = 0
        flash = forward(lm.params, short, cfg, logits_last_only=True)[0][0, 0]
        torch.cuda.synchronize()
        launches = A.flash_attention.launches
        on_sm90 = A.flash_attention_sm90.launches
        plain = forward(lm.params, short, cfg, use_flash=False,
                        logits_last_only=True)[0][0, 0]
        torch.cuda.synchronize()
    if launches != cfg.n_layers or on_sm90 != cfg.n_layers:
        raise AssertionError(f"prefill launched the flash kernels {launches}x "
                             f"({on_sm90} on the sm90 route), want "
                             f"{cfg.n_layers} on sm90")
    dmax = float((flash - plain).abs().max())
    scale = float(plain.abs().max())
    same_top = int(flash.argmax()) == int(plain.argmax())
    # bf16 activations through 18 layers: the kernel rounds p to bf16, the
    # chunked path keeps it in f32, so the two drift by bf16 round-off.
    if not (bool(torch.isfinite(flash).all()) and dmax <= 0.05 * scale):
        raise AssertionError(f"prefill flash vs chunked: max |dlogit| {dmax} "
                             f"> 5% of max |logit| {scale}")
    print(f"[llm] prefill T=2048 ({cfg.n_layers} layers, bf16): flash kernel "
          f"{launches} launches, {on_sm90} on the sm90 route; last logits flash vs chunked max |d| "
          f"{dmax:.4g} (max |logit| {scale:.4g}, gate 5%), argmax "
          f"{'agrees' if same_top else 'differs'}")

    def run(t):
        return lambda: forward(lm.params, toks[:, :t], cfg,
                               logits_last_only=True)

    with torch.inference_mode():
        ms = {2048: cuda_ms(run(2048), 5, 2), 8192: cuda_ms(run(8192), 3, 1)}
        chunked_ms = cuda_ms(lambda: forward(lm.params, short, cfg,
                                             use_flash=False,
                                             logits_last_only=True), 3, 1)
        breakdown = device_breakdown(run(2048), reps=2)
    busy = sum(us for _, us, _ in breakdown)
    flash_us = sum(us for name, us, _ in breakdown if "flash_fwd" in name)
    print(f"[time] {card}: prefill tokens/s T=2048 {2048 / ms[2048] * 1e3:.0f} "
          f"({ms[2048]:.2f} ms), T=8192 {8192 / ms[8192] * 1e3:.0f} "
          f"({ms[8192]:.2f} ms); chunked path T=2048 {chunked_ms:.2f} ms")
    print(f"[trace] {card}: prefill T=2048 device busy {busy / 1e3:.2f} ms "
          f"of {ms[2048]:.2f} ms; flash kernel {flash_us / 1e3:.2f} ms "
          f"({100 * flash_us / max(busy, 1e-9):.1f}% of busy)")
    for name, us, n in breakdown[:8]:
        print(f"[trace]   {us:10.1f} us  x{n:.0f}  {name[:90]}")
    return dict(launches=launches, dlogit=dmax, logit_scale=scale,
                argmax_agrees=same_top, ms_2048=ms[2048], ms_8192=ms[8192],
                chunked_ms_2048=chunked_ms, busy_ms_2048=busy / 1e3,
                flash_ms_2048=flash_us / 1e3)


def llm_card_vs_cpu(dev, seed: int) -> dict:
    """Gemma widths at 2 layers in f32, card against CPU on the same weights:
    last logits at T=600 (flash kernel on the card, its plain version on the
    CPU) within 5e-4; greedy batched generation of uneven prompts equal on
    both, and equal to each prompt's B=1 generation on the card."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.models.llm import (LanguageModel,
                                                      Transformer, forward)
    from fraud_detection_tpu_torch.ops import attention as A

    card = gemma(dev, seed, n_layers=2, dtype=torch.float32)
    params = Transformer(card.cfg, device="cpu")
    for name in params.param_names():
        params.param(name).data.copy_(card.params.param(name))
    cpu = LanguageModel(card.cfg, params)
    toks = torch.randint(0, card.cfg.vocab_size, (1, FLASH_SIMT_MAIN[1]),
                         generator=torch.Generator().manual_seed(seed))
    A.flash_attention.launches = 0
    A.flash_attention_sm90.launches = A.flash_attention_simt.launches = 0
    with torch.inference_mode():
        lg = forward(card.params, toks.to(dev), card.cfg,
                     logits_last_only=True)[0][0, 0].cpu()
        simt = A.flash_attention_simt.launches
        if simt != card.cfg.n_layers or A.flash_attention.launches != simt:
            raise AssertionError(f"the f32 card forward at T=600 ran the SIMT "
                                 f"flash kernel {simt}x of "
                                 f"{A.flash_attention.launches}, want "
                                 f"{card.cfg.n_layers}")
        lc = forward(cpu.params, toks, cpu.cfg, logits_last_only=True)[0][0, 0]
    err = float((lg - lc).abs().max())
    if not bool((lg - lc).abs().le(CARD_CPU_TOL * (1 + lc.abs())).all()):
        raise AssertionError(f"card vs cpu logits max |d| {err}")
    prompts = [GEN_PROMPTS[0], "Agent: hello, is this Mr Smith?",
               GEN_PROMPTS[5][:90]]
    enc = [card.tokenizer.encode(p) for p in prompts]
    tg = card.generate_tokens_batch(enc, max_new_tokens=8)
    tc = cpu.generate_tokens_batch(enc, max_new_tokens=8)
    if not np.array_equal(tg, tc):
        raise AssertionError(f"greedy tokens card {tg.tolist()} != cpu "
                             f"{tc.tolist()}")
    for i, e in enumerate(enc):
        if not np.array_equal(card.generate_tokens(e, max_new_tokens=8), tg[i]):
            raise AssertionError(f"f32 card: batched row {i} != its B=1 call")
    # sampled at temperature 1.0: both draw the same threefry noise, but the
    # logits differ by up to 5e-4, so a near-tie may flip a row (reported)
    sg = card.generate_tokens_batch(enc, max_new_tokens=8, temperature=1.0,
                                    seed=seed)
    sc = cpu.generate_tokens_batch(enc, max_new_tokens=8, temperature=1.0,
                                   seed=seed)
    sampled_equal = int(sum(np.array_equal(a, b) for a, b in zip(sg, sc)))
    print(f"[llm] sampled generation at temperature 1.0, card vs cpu: "
          f"{sampled_equal}/{len(enc)} rows equal (reported, not gated)")
    print(f"[llm] card vs cpu (Gemma widths, 2 layers, f32, T=600): last "
          f"logits max |d| {err:.3g} (tol {CARD_CPU_TOL}), SIMT flash kernel "
          f"{simt} launches; greedy tokens of {len(enc)} uneven prompts equal "
          "card/cpu and batched/single")
    return dict(dlogit=err, simt_launches=simt,
                sampled_rows_equal=sampled_equal, sampled_rows=len(enc))


def llm_generate(lm, card: str) -> dict:
    """Greedy generation of bench.py's 8 prompts, 64 new tokens, batched
    (host clock, after one warm call), and each prompt's B=1 call."""
    import numpy as np

    enc = [lm.tokenizer.encode(p) for p in GEN_PROMPTS]
    lm.generate_tokens_batch(enc, max_new_tokens=4)
    t0 = time.perf_counter()
    out = lm.generate_tokens_batch(enc, max_new_tokens=64)
    wall = time.perf_counter() - t0
    singles = [lm.generate_tokens(e, max_new_tokens=64) for e in enc]
    equal = [i for i in range(len(enc)) if np.array_equal(out[i], singles[i])]
    eos = lm.cfg.EOS
    emitted = int(sum(int(np.argmax(r == eos)) + 1 if (r == eos).any()
                      else len(r) for r in out))
    print(f"[llm] generate B=8 x 64 new tokens ({lm.cfg.dtype}, "
          f"{lm.cfg.n_layers} layers): {emitted} tokens up to EOS; rows "
          f"equal to their B=1 call: {len(equal)}/8 (reported, not gated: "
          "bf16 GEMMs at B=1 and B=8 may round apart; the f32 check above "
          "is the gate)")
    print(f"[time] {card}: generation B=8 x 64 tokens {wall:.3f} s host "
          f"clock, {8 * 64 / wall:.1f} tokens/s, {8 / wall:.3f} "
          "explanations/s")
    t0 = time.perf_counter()
    lm.generate_tokens_batch(enc, max_new_tokens=16)
    wall16 = time.perf_counter() - t0
    breakdown = device_breakdown(
        lambda: lm.generate_tokens_batch(enc, max_new_tokens=16), reps=1)
    busy = sum(us for _, us, _ in breakdown) / 1e3
    print(f"[trace] {card}: generate B=8 x 16 tokens: device busy {busy:.2f} "
          f"ms of a {wall16 * 1e3:.1f} ms wall "
          f"({100 * (1 - busy / (wall16 * 1e3)):.0f}% idle); "
          f"{sum(n for *_, n in breakdown):.0f} device ops")
    for name, us, n in breakdown[:8]:
        print(f"[trace]   {us:10.1f} us  x{n:.0f}  {name[:90]}")
    # one decode step's token choice at B=8 over the full vocabulary:
    # greedy against sampled (the threefry Gumbel noise in int64 torch ops)
    import torch

    from fraud_detection_tpu_torch.models.llm import _sample_token

    logits = torch.randn((8, lm.cfg.vocab_size), device=lm.device,
                         generator=torch.Generator(lm.device).manual_seed(3))
    greedy_ms = cuda_ms(lambda: _sample_token(0.0, logits, 0, 5), 20, 3)
    sampled_ms = cuda_ms(lambda: _sample_token(1.0, logits, 0, 5), 20, 3)
    print(f"[time] {card}: token choice at B=8 x {lm.cfg.vocab_size}: greedy "
          f"{greedy_ms:.4f} ms, sampled {sampled_ms:.4f} ms; a decode step "
          f"takes {wall16 * 1e3 / 16:.2f} ms (16-token wall / 16)")
    return dict(wall_s=wall, tokens_per_s=8 * 64 / wall,
                explanations_per_s=8 / wall, rows_equal_single=len(equal),
                busy_ms_16=busy, wall_ms_16=wall16 * 1e3,
                choice_greedy_ms=greedy_ms, choice_sampled_ms=sampled_ms)


def explained_stream(lm, dev, ckpt: Path, card: str) -> dict:
    """bench.py's explained-stream recipe on the port: 1,024 messages drawn
    from generate_corpus(n=2000, seed=42) with ~5% scams (rng 7), the CLI's
    dt checkpoint as the in-domain classifier (device featurize), batch
    512, ``make_stream_explain_hook(OnPodBackend.from_model(lm),
    max_tokens=48)``. One warm run, then a timed run with the hook and one
    without. Gates: keys exact, frames carry exactly their fields, and
    ``analysis`` on exactly the flagged rows, with labels equal to the
    no-hook run's."""
    import numpy as np

    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.explain.onpod import (
        OnPodBackend, make_stream_explain_hook)
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from fraud_detection_tpu_torch.stream import (InProcessBroker,
                                                  StreamingClassifier)

    corpus = generate_corpus(n=2000, seed=42)
    scams = [d.text for d in corpus if d.label == 1]
    benign = [d.text for d in corpus if d.label == 0]
    rng = np.random.default_rng(7)
    texts = [(scams[int(rng.integers(len(scams)))] if rng.uniform() < 0.05
              else benign[int(rng.integers(len(benign)))])
             for _ in range(1024)]
    width = -(-max(len(t.encode()) for t in texts) // 64) * 64
    tokens = -(-max(sum(c.isspace() for c in t) + 1 for t in texts) // 16) * 16
    pipe = ServingPipeline.from_checkpoint(
        str(ckpt), device=dev, batch_size=512, featurize_device=True,
        featurize_width=width, featurize_tokens=tokens)
    hook = make_stream_explain_hook(OnPodBackend.from_model(lm), max_tokens=48)
    items = [(json.dumps({"text": t, "id": i}).encode(), str(i).encode())
             for i, t in enumerate(texts)]

    def run(with_hook: bool):
        broker = InProcessBroker(num_partitions=3)
        broker.producer().produce_batch("in", items)
        engine = StreamingClassifier(
            pipe, broker.consumer(["in"], "x"), broker.producer(), "out",
            batch_size=512, max_wait=0.01,
            explain_batch_fn=hook if with_hook else None)
        stats = engine.run(max_messages=len(items), idle_timeout=10.0)
        out = broker.messages("out")
        if sorted(m.key for m in out) != sorted(k for _, k in items):
            raise AssertionError("explained stream: output keys != fed keys")
        if stats.processed != len(items):
            raise AssertionError(f"explained stream: {stats.processed} processed")
        return stats, {m.key: json.loads(m.value) for m in out}

    run(True)
    stats_x, frames_x = run(True)
    stats_0, frames_0 = run(False)
    base = {"prediction", "label", "confidence", "original_text"}
    flagged = 0
    for key, f in frames_x.items():
        want = base | ({"analysis"} if f["prediction"] != 0 else set())
        if set(f) != want or f["prediction"] != frames_0[key]["prediction"]:
            raise AssertionError(f"explained frame {key}: fields {sorted(f)}, "
                                 f"prediction {f['prediction']} (no hook: "
                                 f"{frames_0[key]['prediction']})")
        if "analysis" in f:
            if not isinstance(f["analysis"], str):
                raise AssertionError(f"frame {key}: analysis {f['analysis']!r}")
            flagged += 1
    if flagged == 0:
        raise AssertionError("explained stream: no row was flagged")
    out = dict(messages=len(items), flagged=flagged,
               flagged_explanations_per_s=flagged / stats_x.elapsed,
               msgs_per_s_with_explain=stats_x.msgs_per_sec,
               msgs_per_s_without=stats_0.msgs_per_sec)
    print(f"[engine] explained stream: {len(items)} messages, {flagged} "
          "flagged, each flagged frame (and only those) carries analysis; "
          "keys exact")
    print(f"[time] {card}: explained stream msgs/s with hook "
          f"{stats_x.msgs_per_sec:.1f}, without {stats_0.msgs_per_sec:.1f}; "
          f"flagged explanations/s {flagged / stats_x.elapsed:.2f}")
    return out


# ---------------------------------------------------------------------------
# the serve CLI's default path: native host featurize, raw JSON, C++ frames
# ---------------------------------------------------------------------------

def build_native() -> dict:
    """Build and load the port's native host featurizer; fail with the
    compiler's message when it does not load (the card run must not serve
    the pure-Python encode by default)."""
    from fraud_detection_tpu_torch.featurize import native

    t0 = time.perf_counter()
    if native.load_library() is None:
        raise AssertionError("the native featurizer did not build or load: "
                             f"{' '.join(native.build_command or [])}\n"
                             f"{native.build_error}")
    secs = time.perf_counter() - t0
    print(f"[native] {' '.join(native.build_command)} ({secs:.2f} s, "
          f"library {native.library_path()})")
    return dict(command=native.build_command, seconds=secs)


def make_engine(pipe, items, batch: int, json_fast=None, **kw):
    """An engine (batch ``batch``, depth 2) over a fresh broker holding
    ``items``; returns (engine, broker)."""
    from fraud_detection_tpu_torch.stream import (InProcessBroker,
                                                  StreamingClassifier)

    broker = InProcessBroker()
    broker.producer().produce_batch("in", items)
    engine = StreamingClassifier(pipe, broker.consumer(["in"], "g"),
                                 broker.producer(), "out", batch_size=batch,
                                 max_wait=0.05, pipeline_depth=2, **kw)
    if json_fast is not None:
        engine._json_fast = json_fast
    return engine, broker


def run_engine(pipe, items, batch: int, json_fast=None, **kw):
    """One engine run over a fresh broker holding ``items``; returns
    (engine, stats, output messages, DLQ messages)."""
    engine, broker = make_engine(pipe, items, batch, json_fast, **kw)
    stats = engine.run(max_messages=len(items), idle_timeout=5.0)
    return engine, stats, broker.messages("out"), broker.messages("dlq")


def host_serving(feat, texts, models, dev_pipes, items, want, n_malformed,
                 dev) -> dict:
    """Phase 5b: the host-featurize pipelines (LR fp32, LR int8, forest) on
    the card against the CPU and against the device-featurize pipelines;
    the engine over raw JSON with native frames, sync and with the dispatch
    lane; the scheduler's overload case. ``featurize_packed`` must not
    launch. Returns the card's host pipelines."""
    import numpy as np

    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk
    from fraud_detection_tpu_torch.sched import (AdaptiveScheduler,
                                                 SchedulerConfig)

    dev_labels = {name: dev_pipes[name].predict(texts).labels
                  for name in models}
    fk.featurize_bytes.launches = 0
    pipes = {}
    for name, (gm, cm, int8) in models.items():
        gpu = ServingPipeline(feat, gm, batch_size=BATCH, int8=int8, device=dev)
        cpu = ServingPipeline(feat, cm, batch_size=BATCH, int8=int8,
                              device="cpu")
        pg, pc = gpu.predict(texts), cpu.predict(texts)
        dp = float(np.abs(pg.probabilities - pc.probabilities).max())
        if not np.array_equal(pg.labels, pc.labels) or dp > 1e-6:
            raise AssertionError(f"host {name}: cuda vs cpu labels differ or "
                                 f"|dp| {dp} > 1e-6")
        if not np.array_equal(pg.labels, dev_labels[name]):
            raise AssertionError(f"host {name}: labels != the device-featurize "
                                 "pipeline's")
        values = [json.dumps({"text": t}).encode() for t in texts]
        fast = gpu.predict_json_async(values)
        if fast is None or not fast[1].all() or not np.array_equal(
                fast[0].resolve().labels, pg.labels):
            raise AssertionError(f"host {name}: raw-JSON path != predict")
        if gpu.device_stats.featurize_path != "host":
            raise AssertionError(f"host {name}: {gpu.device_stats.snapshot()}")
        pipes[name] = gpu
        print(f"[host] {name}: {len(texts)} texts, native host featurize, "
              f"labels equal cuda/cpu and equal device featurize, max |dp| "
              f"{dp:.3g}; raw-JSON path equals predict")

    pipe = pipes["lr_fp32"]
    wires = {}
    for lane in (False, True):
        eng, stats, out, _ = run_engine(pipe, items, 1024, async_dispatch=lane)
        if sorted(m.key for m in out) != sorted(k for _, k in items):
            raise AssertionError(f"host engine (lane={lane}): keys != fed")
        if stats.malformed != n_malformed:
            raise AssertionError(f"host engine: malformed {stats.malformed} "
                                 f"!= fed {n_malformed}")
        if not (eng._json_fast is True and eng._frames_ok is True):
            raise AssertionError(f"host engine (lane={lane}): _json_fast "
                                 f"{eng._json_fast}, _frames_ok {eng._frames_ok}")
        if lane and eng.health()["device"]["lane_batches"] != stats.batches:
            raise AssertionError(f"lane: {eng.health()['device']}")
        wires[lane] = sorted((m.key, m.value) for m in out)
    if wires[False] != wires[True]:
        raise AssertionError("async_dispatch wires != sync wires")
    keys = sorted(want)
    expect = dict(zip(keys, pipe.predict([want[k] for k in keys]).labels.tolist()))
    frames = {k: json.loads(v) for k, v in wires[False]}
    if any(frames[k]["prediction"] != expect[k] for k in keys):
        raise AssertionError("host engine labels != pipeline.predict")
    print(f"[host] engine: {len(items)} messages over raw JSON with native "
          "frames (_json_fast, _frames_ok), sync and async_dispatch: keys "
          "exact, wires byte-identical, labels equal predict")

    sched = AdaptiveScheduler(SchedulerConfig(
        shed_policy="reject", max_queue=len(items) // 8,
        batch_deadline_ms=5), 1024)
    sched.prewarm(pipe)
    eng, stats, out, dlq = run_engine(pipe, items, 1024, dlq_topic="dlq",
                                      scheduler=sched)
    got = sorted([m.key for m in out] + [m.key for m in dlq])
    if got != sorted(k for _, k in items) or stats.shed < 1:
        raise AssertionError(f"overload: out+dlq {len(got)} keys, shed "
                             f"{stats.shed}")
    json.dumps(eng.health()["sched"])
    print(f"[host] overload (reject, max_queue {len(items) // 8}): out {len(out)} + dlq "
          f"{len(dlq)} == fed {len(items)}, shed {stats.shed}; ladder "
          f"{list(sched.buckets)}")
    pipe.pad_ladder = None
    if fk.featurize_bytes.launches:
        raise AssertionError(f"host featurize launched featurize_packed "
                             f"{fk.featurize_bytes.launches}x")
    return pipes


def serve_cli(argv, card: str) -> dict:
    """The port's serve CLI in-process (``main(argv)``): exit 0, the stats
    line, the classified count, the engine the CLI ran and its
    ``featurize_packed`` launches."""
    import contextlib
    import io

    from fraud_detection_tpu_torch.app import serve
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk
    from fraud_detection_tpu_torch.stream import engine as engine_mod

    engines = []
    run = engine_mod.StreamingClassifier.run

    def recording_run(self, *a, **kw):
        engines.append(self)
        return run(self, *a, **kw)

    fk.featurize_bytes.launches = 0
    log = io.StringIO()
    engine_mod.StreamingClassifier.run = recording_run
    try:
        with contextlib.redirect_stdout(log):
            rc = serve.main(argv)
    finally:
        engine_mod.StreamingClassifier.run = run
    lines = log.getvalue().strip().splitlines()
    if rc != 0:
        raise AssertionError(f"serve {argv}: exit {rc}\n{log.getvalue()}")
    stats = json.loads(lines[-2])
    n = int(lines[-1].rsplit(":", 1)[1])
    print(f"[serve] {' '.join(argv)}: exit 0, classified {n}, msgs/s "
          f"{stats['msgs_per_sec']} ({card})")
    return dict(stats=stats, classified=n, engine=engines[-1],
                launches=fk.featurize_bytes.launches)


def check_serve_runs(ckpt, n: int, dev, card: str, variants) -> dict:
    """Serve ``ckpt`` with each flag variant over ``--demo n``: every run
    classifies n (or n minus its shed rows); host featurize launches no
    ``featurize_packed`` and takes the raw-JSON path with native frames;
    ``--featurize-device`` launches it once per chunk dispatched."""
    results = {}
    for name, extra in variants.items():
        r = serve_cli(["--device", str(dev), "--model", str(ckpt), "--demo",
                       str(n), "--batch-size", "1024", *extra], card)
        stats, eng = r["stats"], r["engine"]
        device = stats["health"]["device"]
        if r["classified"] + stats["shed"] != n or stats["processed"] != n:
            raise AssertionError(f"serve {name}: classified {r['classified']}")
        if "--featurize-device" in extra:
            if device["featurize_path"] != "cuda" or r["launches"] < 1 \
                    or r["launches"] != device["uploads"] \
                    or device["uploads_per_batch"] != 1.0:
                raise AssertionError(f"serve {name}: featurize_packed "
                                     f"launched {r['launches']}x, {device}")
        elif r["launches"] or not (eng._json_fast is True
                                   and eng._frames_ok is True):
            raise AssertionError(f"serve {name}: featurize_packed launched "
                                 f"{r['launches']}x, _json_fast "
                                 f"{eng._json_fast}, _frames_ok {eng._frames_ok}")
        if "--async-dispatch" in extra and device["lane_batches"] != stats["batches"]:
            raise AssertionError(f"serve {name}: {device}")
        results[name] = dict(msgs_per_sec=stats["msgs_per_sec"],
                             classified=r["classified"],
                             featurize_packed_launches=r["launches"],
                             chunks=device["uploads"])
    return results


def profiled_idle(setup, tries: int = 3) -> float:
    """Device idle share of one call under torch.profiler: 1 - (device time
    of its kernels) / (host-clock wall of that same call, synchronized).
    ``setup()`` runs outside the trace and returns the call. A trace that
    records no device activity (the profiler drops one now and then) is
    taken again, up to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        fn = setup()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy_us = sum(e.device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        if busy_us:
            return 1 - busy_us / wall_us
    raise AssertionError(f"{tries} profiler traces recorded no device time")


def pipeline_rate(p, texts):
    """Rows/s of ``p.predict`` over ``texts`` (median of 5, host clock,
    each predict resolved) and the device idle share of a sixth, profiled
    predict."""
    p.predict(texts[:BATCH])
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        p.predict(texts)
        reps.append(time.perf_counter() - t0)
    idle = profiled_idle(lambda: lambda: p.predict(texts))
    return len(texts) / statistics.median(reps), idle


def engine_rate(pipe, items, **kw):
    """Engine msgs/s over ``items`` (batch 256, depth 2) and the device
    idle share of a second, profiled ``engine.run`` (the broker is built
    and loaded outside the trace)."""
    _, stats, _, _ = run_engine(pipe, items, BATCH, **kw)

    def setup():
        engine, _ = make_engine(pipe, items, BATCH, **kw)
        return lambda: engine.run(max_messages=len(items), idle_timeout=5.0)

    return stats.msgs_per_sec, profiled_idle(setup)


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

    from fraud_detection_tpu_torch.checkpoint.native import save_checkpoint
    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.featurize.device import DeviceFeaturizer
    from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from fraud_detection_tpu_torch.models import train_trees as tt
    from fraud_detection_tpu_torch.ops import _build
    from fraud_detection_tpu_torch.ops import attention as A
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk
    from fraud_detection_tpu_torch.ops import histogram as H
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

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    build_s = time.perf_counter() - t0
    fk.kernel_self_test(dev)
    H.kernel_self_test(dev)
    A.kernel_self_test(dev)
    print(f"[build] {', '.join(k + '.cu' for k in KERNELS)} built in "
          f"{build_s:.3f} s (one nvcc each, in parallel); self-tests ok")
    native_build = build_native()
    for name in KERNELS:
        print(f"[build] ptxas {name}: {ptxas_summary(_build.build_log(name))}")

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
    stop_empty = torch.from_numpy(fk.build_stop_table(
        list(feat.stop_filter.words) + [""])[0]).to(dev)
    spec = dfeat.spec
    scans = {}
    packed_err = 0
    for name, staged in packed_inputs(corpus_texts, fuzz, dev, args.seed + 9):
        variants = [(stop, spec), (stop, packed_spec(spec, legacy=True)),
                    (stop, packed_spec(spec, binary=True))]
        if name in ("corpus", "fuzz", "w16384"):
            variants += [(stop_empty, packed_spec(spec, empty_is_stop=True)),
                         (stop, packed_spec(spec, n_slots=32))]
        if name == "fuzz":
            variants.append((stop, packed_spec(spec, legacy=True,
                                               binary=True)))
        for table, sp in variants:
            packed_err = max(packed_err, packed_max_err(name, staged, table,
                                                        sp, scans))
    del scans
    packed_k, n_k = fk.featurize_bytes(staged_main, stop, spec=spec)
    if packed_k.shape != (BATCH, 2, TOKENS) or not bool((n_k > 0).all()):
        raise AssertionError(f"featurize_bytes output {tuple(packed_k.shape)} "
                             "or empty rows on corpus text")

    # tree kernels at the CLI shape (the real TF-IDF bins) and the bench
    # shape, on uint8 bins (the trainer's) and int32 bins: the same plan, so
    # the same sums in the same order
    Xtr, ytr, Xte, test_texts = cli_data(dev)
    edges = tt.quantile_bin_edges(Xtr, NBINS)
    bins_c = tt.apply_bins(torch.from_numpy(Xtr).to(dev),
                           torch.from_numpy(edges).to(dev)).contiguous()
    y_c = torch.from_numpy(ytr).to(dev)
    bins_b, y_b = bench_bins(dev, args.seed + 21)
    n_c, n_b = bins_c.shape[0], bins_b.shape[0]
    wide = {"cli": {torch.uint8: bins_c.to(torch.uint8), torch.int32: bins_c},
            "bench": {torch.uint8: bins_b.to(torch.uint8), torch.int32: bins_b}}
    shapes = {
        "cli_rf": ("cli", *level_inputs(n_c, 8, 2, y_c, dev, args.seed + 22), True),
        "cli_xgb": ("cli", *level_inputs(n_c, 1, 3, y_c, dev, args.seed + 23), False),
        "bench_rf": ("bench", *level_inputs(n_b, 8, 2, y_b, dev, args.seed + 24), True),
        "bench_xgb": ("bench", *level_inputs(n_b, 1, 3, y_b, dev, args.seed + 25), False),
    }
    hist_err, hists = {}, {}
    for name, (src, loc, w, st, exact) in shapes.items():
        for dt, bins in wide[src].items():
            err, h = check_histogram(name, bins, loc, w, st, exact)
            hist_err[(name, dt)] = err
            if dt == torch.uint8:
                hists[name] = h
            elif not torch.equal(h, hists[name]):
                raise AssertionError(f"histogram {name}: uint8 and int32 bins "
                                     "give different sums")
        print(f"[check] histogram {name}: uint8 and int32 bins bit-equal")
    gain_inputs = {}
    for name, crit in (("cli_rf", "gini"), ("cli_xgb", "xgb"),
                       ("bench_rf", "gini"), ("bench_xgb", "xgb")):
        hist = hists[name][0].contiguous()
        gain_inputs[name] = (hist, hist[:, 0].sum(dim=1).contiguous(), crit)
        check_best_splits(name, *gain_inputs[name])
    del hists
    # the histogram and best_splits at every level width of a depth-5 tree
    # at the CLI shape (the xgb rounds', the dt fit's and, 8 trees a chunk,
    # the forest's widths): each width runs its own plan, so each is held
    # against the plain version on uint8 and int32 bins, and best_splits
    # reads the checked level histograms
    width_inputs, level_hist = {}, {}
    for fit, trees, k in (("xgb", 1, 3), ("gini", 1, 2), ("rf", 8, 2)):
        for width in LEVEL_WIDTHS:
            seed = args.seed + (70 if fit == "rf" else 60) + width
            loc, w, st = level_inputs(n_c, trees, k, y_c, dev, seed, width)
            exact = fit != "xgb"
            hist = {dt: check_histogram(f"cli {fit} L={width}", bins, loc, w,
                                        st, exact, width)[1]
                    for dt, bins in wide["cli"].items()}
            if not torch.equal(hist[torch.uint8], hist[torch.int32]):
                raise AssertionError(f"histogram cli {fit} L={width}: uint8 "
                                     "and int32 bins give different sums")
            level_hist[(fit, width)] = (loc, w, st, dict(
                n_nodes=width, n_bins=NBINS, exact_int8=exact))
            if fit == "rf":
                continue
            h = hist[torch.uint8][0].contiguous()
            totals = h[:, 0].sum(dim=1).contiguous()
            check_best_splits(f"cli L={width}", h, totals, fit, None)
            width_inputs[(fit, width)] = (h, totals)
        del hist

    # -- 4. the slice at full width (main path) -----------------------------
    lr_gpu, trees_gpu = make_models(feat, args.seed, dev)
    lr_cpu, trees_cpu = make_models(feat, args.seed, "cpu")
    texts = [d.text for d in generate_corpus(n=2048, seed=args.seed + 3)]
    fk.featurize_bytes.launches = fk.tokenize_hash.launches = 0
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
    launches = fk.featurize_bytes.launches
    chunks = sum(p.device_stats.chunks for p in pipes.values())
    if launches != chunks:
        raise AssertionError(f"featurize_packed launched {launches}x over "
                             f"{chunks} chunks, want one launch a chunk")
    if fk.tokenize_hash.launches:
        raise AssertionError(f"the serving path ran the stream entry "
                             f"{fk.tokenize_hash.launches}x")
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
        raise AssertionError("the main path never launched featurize_packed")
    print(f"[engine] {len(items)} messages, keys exact, malformed "
          f"{stats.malformed}, labels equal predict; featurize_packed "
          f"launches on the main path {launches} over {chunks} chunks, "
          "stream entry 0")
    # the stream entry's own path: the reference tokenize_hash contract
    # (per-column token streams) over phase 4's texts, chunk by chunk
    fk.tokenize_hash.launches = 0
    for i in range(0, len(texts), BATCH):
        fk.tokenize_hash(staged_classes(texts[i:i + BATCH], WIDTH, dev)[1])
    scan_launches = fk.tokenize_hash.launches

    # -- 5b. the serve CLI's default path: native host featurize -------------
    host_pipes = host_serving(
        feat, texts, {"lr_fp32": (lr_gpu, lr_cpu, False),
                      "lr_int8": (lr_gpu, lr_cpu, True),
                      "forest": (trees_gpu, trees_cpu, False)},
        pipes, items, want, n_malformed, dev)
    ckpt_dir = ROOT / "build" / "chip_smoke"
    save_checkpoint(str(ckpt_dir / "lr"), feat, lr_gpu)
    serve_runs = check_serve_runs(ckpt_dir / "lr", SERVE_DEMO, dev, card, {
        "lr_host": [], "lr_featurize_device": ["--featurize-device"],
        "lr_async_int8": ["--async-dispatch", "--int8"]})

    # -- 6. training slice, card against CPU ---------------------------------
    train_walls = train_card_vs_cpu(Xtr, ytr, Xte, dev)

    # -- 7. training CLI on the card (the training main path) ----------------
    H.node_feature_bin_histogram_multi.launches = 0
    H.best_splits.launches = 0
    report = train_cli(dev, test_texts)
    hist_launches = H.node_feature_bin_histogram_multi.launches
    gain_launches = H.best_splits.launches
    if hist_launches < 1 or gain_launches < 1:
        raise AssertionError("the training CLI never launched the tree kernels")
    print(f"[cli] tree kernel launches on the main path: histogram "
          f"{hist_launches}, best_splits {gain_launches}")
    # -- 7b. the serve CLI on the training CLI's dt checkpoint ---------------
    serve_runs.update(check_serve_runs(ckpt_dir / "dt", SERVE_DEMO, dev, card, {
        "dt_host": [], "dt_featurize_device": ["--featurize-device"]}))

    # -- 8. times -------------------------------------------------------------
    def packed_call():
        before = fk.featurize_bytes.launches
        out = fk.featurize_bytes(staged_main, stop, spec=spec)
        if fk.featurize_bytes.launches != before + 1:
            raise AssertionError("featurize_bytes did not launch its kernel "
                                 "exactly once")
        return out

    def stream_call():
        return fk.tokenize_hash(cls_main)

    # the two entries in turns (packed, stream, stream, packed), beside the
    # first kernel's recorded time
    fb_ms = cuda_ms(packed_call, 50, 5)
    k_ms = cuda_ms(stream_call, 50, 5)
    k_ms = statistics.median([k_ms, cuda_ms(stream_call, 50, 5)])
    fb_ms = statistics.median([fb_ms, cuda_ms(packed_call, 50, 5)])
    fb_dev = kernel_device_ms(packed_call, ("packed_kernel",), 20)
    k_dev = kernel_device_ms(stream_call, ("stream_kernel",), 20)
    p_ms = cuda_ms(lambda: fk.tokenize_hash_reference(cls_main), 5, 1)
    fb_plain_ms = cuda_ms(lambda: fk.featurize_bytes_reference(
        staged_main, stop, spec=spec), 5, 1)
    rows, cols = cls_main.shape
    nbytes = rows * cols * 4 + 4 * rows * cols * 4 + rows * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = rows * cols * SCAN_OPS_PER_ELEMENT / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    # the rows read, the packed planes and unique counts written; the stop
    # table is probed once a token, not read whole, so it is not counted
    fb_bytes = staged_main.numel() + rows * 2 * spec.n_slots * 2 + rows * 4
    fb_bytes_ms = fb_bytes / HBM_BYTES_PER_S * 1e3
    fb_ops_ms = rows * cols * SCAN_OPS_PER_ELEMENT / FP32_OPS_PER_S * 1e3
    fb_bound_ms = max(fb_bytes_ms, fb_ops_ms)
    # pipelines: device featurize and native host featurize in turns
    # (device, host, host, device), each with its device idle share
    rates, idle, host_rates, host_idle = {}, {}, {}, {}
    for name, p in pipes.items():
        turns = [pipeline_rate(q, texts)
                 for q in (p, host_pipes[name], host_pipes[name], p)]
        rates[name] = statistics.median([turns[0][0], turns[3][0]])
        idle[name] = statistics.median([turns[0][1], turns[3][1]])
        host_rates[name] = statistics.median([turns[1][0], turns[2][0]])
        host_idle[name] = statistics.median([turns[1][1], turns[2][1]])
    # the host encode alone over the same 256-row chunks (host clock,
    # median of 5)
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        for i in range(0, len(texts), BATCH):
            feat.encode(texts[i:i + BATCH], batch_size=BATCH)
        reps.append((time.perf_counter() - t0) * 1e3)
    host_encode_ms = statistics.median(reps)
    # the engine over 4,096 messages (batch 256, depth 2): raw JSON with
    # native frames (host featurize), the slow path (json.loads + Python
    # frames, host featurize), device featurize, and the raw-JSON path
    # with the dispatch lane; in turns, each with its device idle share
    _, items2, _, _ = load_broker(4096, args.seed + 6)
    modes = {"raw_json_native_frames": (host_pipes["lr_fp32"], {}),
             "slow_path": (host_pipes["lr_fp32"], {"json_fast": False}),
             "device_featurize": (pipe, {}),
             "raw_json_async_dispatch": (host_pipes["lr_fp32"],
                                         {"async_dispatch": True})}
    engine_turns = {m: [] for m in modes}
    for m in [*modes, *reversed(modes)]:
        engine_turns[m].append(engine_rate(modes[m][0], items2, **modes[m][1]))
    engine_modes = {m: dict(msgs_per_s=statistics.median(r[0] for r in t),
                            device_idle=statistics.median(r[1] for r in t),
                            turns=[r[0] for r in t])
                    for m, t in engine_turns.items()}
    msgs_s = engine_modes["device_featurize"]["msgs_per_s"]
    print(f"[engine] {card}: msgs/s over {len(items2)} messages (batch "
          f"{BATCH}, in turns): " + "; ".join(
              f"{m} {v['msgs_per_s']:.0f} (turns "
              f"{', '.join(f'{x:.0f}' for x in v['turns'])}; device idle "
              f"{100 * v['device_idle']:.1f}%)"
              for m, v in engine_modes.items()))
    print(f"[time] {card}: featurize_packed ({rows}, {WIDTH + 4}) -> "
          f"({rows}, 2, {spec.n_slots}): events {fb_ms:.4f} ms, device "
          f"{fb_dev:.4f} ms; plain version {fb_plain_ms:.2f} ms; bound "
          f"{fb_bound_ms * 1e3:.3f} us ({fb_bytes / 1e6:.3f} MB moved, "
          f"{'bytes' if fb_bytes_ms >= fb_ops_ms else 'operations'})")
    print(f"[time] {card}: stream entry ({rows}, {cols}): events {k_ms:.4f} "
          f"ms, device {k_dev:.4f} ms; plain version {p_ms:.2f} ms; bound "
          f"{bound_ms * 1e3:.2f} us ({nbytes / 1e6:.2f} MB moved); first "
          f"kernel (one thread per row) {FIRST_SCAN_MS} ms as recorded")
    print(f"[time] {card}: pipeline rows/s at batch {BATCH}, device "
          "featurize: "
          + ", ".join(f"{k} {v:.0f} (device idle {100 * idle[k]:.1f}%)"
                      for k, v in rates.items())
          + "; native host featurize: "
          + ", ".join(f"{k} {v:.0f} (device idle {100 * host_idle[k]:.1f}%)"
                      for k, v in host_rates.items())
          + f"; engine msgs/s (device featurize) {msgs_s:.0f}")
    print(f"[time] {card}: host encode of the {len(texts)} texts in "
          f"{BATCH}-row chunks: {host_encode_ms:.2f} ms")
    print(f"[time] {card}: serve CLI --demo {SERVE_DEMO} --batch-size 1024 "
          "msgs_per_sec: " + ", ".join(f"{k} {v['msgs_per_sec']}"
                                        for k, v in serve_runs.items()))
    print("[time] library_ms: none — no single PyTorch call computes the "
          "featurize program or the scan")
    breakdown = device_breakdown(packed_call)
    fb_kernels = sorted({name for name, _, _ in breakdown})
    print(f"[trace] {card}: featurize_bytes device ops: {fb_kernels} "
          f"(device {fb_dev * 1e3:.1f} us a launch of {fb_ms * 1e3:.1f} us "
          "events around the call)")
    for name, us, n in breakdown[:8]:
        print(f"[trace]   {us:9.1f} us/call  x{n:.1f}  {name[:90]}")
    if len(fb_kernels) != 1 or "packed_kernel" not in fb_kernels[0]:
        raise AssertionError(f"featurize_bytes ran {fb_kernels}, want the "
                             "one featurize_packed kernel")

    # tree kernels: kernel (uint8 bins, the main path's, and int32 bins),
    # plain version, library call, bound, per shape, beside the first
    # kernels' recorded times
    tree_times = {}
    for name, (src, loc, w, st, exact) in shapes.items():
        kw = dict(n_nodes=16, n_bins=NBINS, exact_int8=exact)
        big = src == "bench"
        row = {}
        for dt, bins in wide[src].items():
            def call():
                return H.node_feature_bin_histogram_multi(bins, loc, w, st, **kw)

            ms = cuda_ms(call, 20, 3)
            hb, hby, mb = histogram_bound(bins, loc, w, st, 16)
            row[str(dt).split(".")[1]] = dict(
                ms=ms, device_ms=kernel_device_ms(call, HIST_KERNELS),
                bound_ms=hb, bound_by=hby, mb=mb,
                max_abs_err=hist_err[(name, dt)])
        bins = wide[src][torch.uint8]
        hp = cuda_ms(lambda: H.histogram_reference(bins, loc, w, st, **kw),
                     5 if big else 20, 1)
        call, need = histogram_library_call(bins, loc, w, st, 16)
        lib = None if call is None else cuda_ms(call, 10 if big else 20, 2)
        del call
        torch.cuda.empty_cache()
        u8, i32 = row["uint8"], row["int32"]
        tree_times[name] = dict(
            ms=u8["ms"], device_ms=u8["device_ms"], plain_ms=hp,
            library_ms=lib, bound_ms=u8["bound_ms"],
            bound_by=u8["bound_by"], max_abs_err=u8["max_abs_err"],
            int32=i32, shape=[*bins.shape, loc.shape[0], 16, NBINS, st.shape[1]])
        print(f"[time] {card}: histogram {name} (N, F, T, L, NB, K) = "
              f"{tree_times[name]['shape']}: kernel uint8 bins {u8['ms']:.4f} ms "
              f"(device {u8['device_ms']:.4f} ms; bound {u8['bound_ms'] * 1e3:.2f} "
              f"us, {u8['bound_by']}, {u8['mb']:.1f} MB), int32 bins "
              f"{i32['ms']:.4f} ms (device {i32['device_ms']:.4f} ms; bound "
              f"{i32['bound_ms'] * 1e3:.2f} us, {i32['mb']:.1f} MB); first "
              f"kernel (recorded) {FIRST_HIST_MS[name]}; plain {hp:.2f} ms; "
              "index_add_ "
              + (f"{lib:.4f} ms" if lib is not None else
                 f"not built: needs {need / 1e9:.1f} GB of ids and values"))
        if not u8["ms"] < FIRST_HIST_MS[name]:
            print(f"[time] NOTE: histogram {name} is not faster than the "
                  "first kernel's recorded time")
        if lib is not None and not u8["ms"] < lib:
            print(f"[time] NOTE: histogram {name} is not faster than index_add_")
    gain_times = {}
    for name, (hist, totals, crit) in gain_inputs.items():
        def call():
            return H.best_splits(hist, totals, criterion=crit)

        gk = cuda_ms(call, 50, 5)
        gd = kernel_device_ms(call, GAIN_KERNELS)
        gp = cuda_ms(lambda: H.best_splits_reference(hist, totals,
                                                     criterion=crit), 20, 2)
        gb, gby = best_splits_bound(hist)
        gain_times[name] = dict(ms=gk, device_ms=gd, plain_ms=gp, bound_ms=gb,
                                bound_by=gby, shape=list(hist.shape),
                                criterion=crit)
        print(f"[time] {card}: best_splits {name} {crit} (L, F, NB, K) = "
              f"{list(hist.shape)}: kernel {gk:.4f} ms (device {gd:.4f} ms); first kernel "
              f"(recorded) {FIRST_GAIN_MS.get(name, 'not recorded')}; plain "
              f"{gp:.2f} ms; bound {gb * 1e3:.2f} us ({gby}); library call: none")
    width_times, hist_width_times = {}, {}
    for (crit, width), (hist, totals) in width_inputs.items():
        def call():
            return H.best_splits(hist, totals, criterion=crit)

        gk = cuda_ms(call, 50, 5)
        gd = kernel_device_ms(call, GAIN_KERNELS)
        gb, gby = best_splits_bound(hist)
        width_times[f"{crit}_L{width}"] = dict(ms=gk, device_ms=gd, bound_ms=gb,
                                               bound_by=gby,
                                               shape=list(hist.shape))
        print(f"[time] {card}: best_splits cli {crit} L={width} "
              f"{list(hist.shape)}: kernel {gk:.4f} ms (device {gd:.4f} ms); "
              f"bound {gb * 1e3:.2f} us ({gby})")
    per_fit = {f"{fit}_{key}": reps * sum(width_times[f"{crit}_L{w}"][key]
                                          for w in LEVEL_WIDTHS)
               for fit, crit, reps in (("xgb100", "xgb", 100), ("dt", "gini", 1))
               for key in ("ms", "device_ms")}
    print(f"[time] {card}: best_splits per fit at the CLI shape (sum over the "
          f"level widths): xgb100 {per_fit['xgb100_ms']:.3f} ms (device "
          f"{per_fit['xgb100_device_ms']:.3f}), dt {per_fit['dt_ms']:.4f} ms "
          f"(device {per_fit['dt_device_ms']:.4f})")
    bins_u8 = wide["cli"][torch.uint8]
    for (fit, width), (loc, w, st, kw) in level_hist.items():
        def call():
            return H.node_feature_bin_histogram_multi(bins_u8, loc, w, st, **kw)

        hist_width_times[f"{fit}_L{width}"] = dict(
            ms=cuda_ms(call, 20, 3), device_ms=kernel_device_ms(call, HIST_KERNELS),
            trees=loc.shape[0], k=st.shape[1])
        t = hist_width_times[f"{fit}_L{width}"]
        print(f"[time] {card}: histogram cli {fit} L={width} T={t['trees']} "
              f"K={t['k']}: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms)")
    # launches per CLI fit: xgb 100 rounds, the forest 13 chunks of 8 trees,
    # dt once, each at every level width
    for key in ("ms", "device_ms"):
        for fit, crit, n_fit in (("xgb100", "xgb", 100), ("rf100", "rf", 13),
                                 ("dt", "gini", 1)):
            per_fit[f"hist_{fit}_{key}"] = n_fit * sum(
                hist_width_times[f"{crit}_L{w}"][key] for w in LEVEL_WIDTHS)
    print(f"[time] {card}: histogram per fit at the CLI shape (sum over the "
          "level widths): " + ", ".join(
              f"{fit} {per_fit[f'hist_{fit}_ms']:.3f} ms (device "
              f"{per_fit[f'hist_{fit}_device_ms']:.3f})"
              for fit in ("xgb100", "rf100", "dt")))
    cli_walls = report["meta"]["train_seconds"]
    print(f"[time] {card}: fit walls at the CLI shape (1120 x 10000, host "
          f"clock): train CLI dt {cli_walls['dt']} s, rf100 {cli_walls['rf']} "
          f"s, xgb100 {cli_walls['xgb']} s; phase 6 dt "
          f"{train_walls['dt']:.3f} s, rf16 {train_walls['rf16']:.3f} s, "
          f"xgb16 {train_walls['xgb16']:.3f} s")
    y_bh = y_b.cpu().numpy()
    edges_b = np.tile(np.linspace(0.0, 1.0, NBINS - 1, dtype=np.float32),
                      (BENCH_FEATURES, 1))
    bench_fits = {
        "dt": lambda: tt.fit_decision_tree(bins_b, y_bh, edges=edges_b,
                                           device=dev),
        "rf100": lambda: tt.fit_random_forest(bins_b, y_bh, n_trees=100,
                                              edges=edges_b, device=dev),
        "xgb100": lambda: tt.fit_gradient_boosting(bins_b, y_bh, n_rounds=100,
                                                   edges=edges_b, device=dev),
    }
    bench_walls = {}
    for name, fit in bench_fits.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        bench_walls[name] = time.perf_counter() - t0
    print(f"[time] {card}: fit walls at the bench shape ({BENCH_ROWS} x "
          f"{BENCH_FEATURES}, pre-binned on the card, host clock): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in bench_walls.items()))
    fit_ms = bench_walls["dt"] * 1e3
    breakdown = device_breakdown(bench_fits["dt"], reps=1)
    busy = sum(us for _, us, _ in breakdown)
    print(f"[trace] {card}: dt fit at the bench shape: device busy "
          f"{busy / 1e3:.2f} ms of a {fit_ms:.1f} ms wall; "
          f"{sum(n for *_, n in breakdown):.0f} device ops")
    for name, us, n in breakdown[:10]:
        print(f"[trace]   {us:10.1f} us  x{n:.0f}  {name[:90]}")

    # -- 9. flash kernels against their plain version ------------------------
    bf16, f32 = torch.bfloat16, torch.float32
    flash_err = check_flash("main", *flash_inputs(FLASH_MAIN, 1, bf16, dev,
                                                  args.seed + 31),
                            FLASH_BF16_ATOL)
    ragged_err = {}
    for d in FLASH_RAGGED_D:
        for t in FLASH_RAGGED_T:
            for hkv in (1, 2, FLASH_RAGGED_H):
                shape = (2, t, FLASH_RAGGED_H, d)
                ragged_err[(t, d, hkv)] = check_flash(
                    f"ragged bf16 T={t} d={d} Hkv={hkv}",
                    *flash_inputs(shape, hkv, bf16, dev, args.seed + t + d + hkv),
                    FLASH_BF16_ATOL, FLASH_BF16_RTOL, quiet=True)
        worst = max((e, t, hkv) for (t, dd, hkv), e in ragged_err.items()
                    if dd == d)
        print(f"[check] flash ragged bf16 (sm90) d={d}: B=2, H=4, T in "
              f"{FLASH_RAGGED_T}, Hkv in (1, 2, 4): all within "
              f"{FLASH_BF16_ATOL} + {FLASH_BF16_RTOL:.4g} relative, max |diff| "
              f"{worst[0]:.3g} (T={worst[1]}, Hkv={worst[2]}); every shape two "
              "launches bit-equal, native K/V == expanded K/V")
    for i, (shape, hkv) in enumerate((((2, 1000, 4, 64), 2),
                                      ((1, 131, 1, 32), 1))):
        check_flash("ragged", *flash_inputs(shape, hkv, f32, dev,
                                            args.seed + 32 + i),
                    FLASH_F32_TOL, FLASH_F32_TOL)
    simt_qkv = flash_inputs(FLASH_SIMT_MAIN, 1, f32, dev, args.seed + 34)
    simt_err = check_flash("phase-11 shape", *simt_qkv, FLASH_F32_TOL,
                           FLASH_F32_TOL)

    # -- 10. full-width prefill (the flash kernel's main path) --------------
    lm = gemma(dev, args.seed)
    n_params = sum(p.numel() for p in lm.params.parameters())
    print(f"[llm] Gemma-2B architecture, {n_params / 1e9:.3f} B parameters "
          "in bf16 drawn on the card from --seed")
    pre = prefill(lm, dev, args.seed + 40, card)
    flash_launches = pre["launches"]

    # -- 11. card against CPU, 2 layers, f32 ---------------------------------
    cvc = llm_card_vs_cpu(dev, args.seed + 41)
    torch.cuda.empty_cache()

    # -- 12. full-width generation -------------------------------------------
    gen = llm_generate(lm, card)

    # -- 13. the engine with explanations ------------------------------------
    expl = explained_stream(lm, dev, ROOT / "build" / "chip_smoke" / "dt", card)
    del lm
    torch.cuda.empty_cache()

    # -- 14. flash kernel times ------------------------------------------------
    flash_times, simt_times = {}, {}
    for t in (2048, 8192):
        shape = (1, t, 8, 256)
        q, k, v = flash_inputs(shape, 1, bf16, dev, args.seed + 50)
        err = check_flash(f"T={t}", q, k, v, FLASH_BF16_ATOL, route="sm90")
        err_simt = check_flash(f"T={t}", q, k, v, FLASH_BF16_ATOL, route="simt")
        fb, fby = flash_bound(shape, 1, 2)
        reps = 20 if t == 2048 else 5
        sm90_a = cuda_ms(lambda: A.flash_attention_sm90(q, k, v), 3 * reps, 3)
        simt_a = cuda_ms(lambda: A.flash_attention_simt(q, k, v), reps, 2)
        simt_b = cuda_ms(lambda: A.flash_attention_simt(q, k, v), reps, 0)
        sm90_b = cuda_ms(lambda: A.flash_attention_sm90(q, k, v), 3 * reps, 0)
        sdpa = sdpa_call(q, k, v)
        burst = 50 if t == 2048 else 10
        common = dict(
            plain_ms=cuda_ms(lambda: A.flash_attention_reference(q, k, v), 5, 1),
            library_ms=cuda_ms(sdpa, 20, 3), library_burst_ms=burst_ms(sdpa, burst),
            bound_ms=fb, bound_by=fby, shape=[*shape, 1])
        flash_times[t] = dict(
            ms=(sm90_a + sm90_b) / 2, ms_turns=[sm90_a, sm90_b],
            burst_ms=burst_ms(lambda: A.flash_attention_sm90(q, k, v), burst),
            max_abs_err=err, **common)
        simt_times[t] = dict(
            ms=(simt_a + simt_b) / 2, ms_turns=[simt_a, simt_b],
            burst_ms=burst_ms(lambda: A.flash_attention_simt(q, k, v), 5),
            max_abs_err=err_simt, **common)
        ft, st = flash_times[t], simt_times[t]
        print(f"[time] {card}: flash (B, T, H, d, Hkv) = {ft['shape']} bf16, "
              f"CUDA events around one call (around a burst of back-to-back "
              f"calls, per call, beside it): sm90 kernel {ft['ms']:.4f} ms "
              f"(turns {sm90_a:.4f} / {sm90_b:.4f}; burst {ft['burst_ms']:.4f}); "
              f"SIMT kernel {st['ms']:.4f} ms (turns {simt_a:.4f} / "
              f"{simt_b:.4f}; burst {st['burst_ms']:.4f}); "
              f"scaled_dot_product_attention {ft['library_ms']:.4f} ms (burst "
              f"{ft['library_burst_ms']:.4f}); plain {ft['plain_ms']:.2f} ms; "
              f"bound {fb * 1e3:.2f} us ({fby}); sm90 {ft['ms'] / fb:.1f}x "
              f"bound, {st['ms'] / ft['ms']:.1f}x faster than SIMT, "
              f"{ft['ms'] / ft['library_ms']:.2f}x SDPA's time")
        if not ft["ms"] < st["ms"]:
            print(f"[time] NOTE: the sm90 kernel is not faster than the SIMT "
                  f"kernel at T={t}")
        del q, k, v
    q, k, v = simt_qkv
    fb, fby = flash_bound(FLASH_SIMT_MAIN, 1, 4)
    simt_main = dict(
        ms=cuda_ms(lambda: A.flash_attention_simt(q, k, v), 20, 3),
        plain_ms=cuda_ms(lambda: A.flash_attention_reference(q, k, v), 10, 2),
        library_ms=cuda_ms(sdpa_call(q, k, v), 20, 3), bound_ms=fb,
        bound_by=fby, shape=[*FLASH_SIMT_MAIN, 1], dtype="float32",
        max_abs_err=simt_err)
    print(f"[time] {card}: flash (B, T, H, d, Hkv) = {simt_main['shape']} f32 "
          f"(phase 11's shape), CUDA events around one call: SIMT kernel "
          f"{simt_main['ms']:.4f} ms; scaled_dot_product_attention "
          f"{simt_main['library_ms']:.4f} ms; plain {simt_main['plain_ms']:.2f} "
          f"ms; bound {fb * 1e3:.2f} us ({fby}, f32 at 67 TFLOP/s); SIMT "
          f"{simt_main['ms'] / fb:.1f}x bound")
    del q, k, v, simt_qkv

    # -- 15. result lines ----------------------------------------------------
    # the tree kernels' main shape: the CLI's xgb level (500 of each
    # kernel's launches on the main path)
    main_h, main_g = tree_times["cli_xgb"], gain_times["cli_xgb"]
    print(json.dumps({"kernels": [{
        "name": "featurize_packed",
        "route": "cuda",
        "source": "fraud_detection_tpu_torch/ops/csrc/featurize_scan.cu",
        "replaces": "fraud_detection_tpu/ops/featurize_kernel.py:266 and :488",
        "launches": launches,
        "max_abs_err": packed_err,
        "matched": True,
        "ms": fb_ms,
        "device_ms": fb_dev,
        "plain_ms": fb_plain_ms,
        "bound_ms": fb_bound_ms,
        "bound_by": "bytes" if fb_bytes_ms >= fb_ops_ms else "operations",
        "library_ms": None,
        "shape": [rows, WIDTH + 4],
        "trace_kernels": fb_kernels,
        "card": card,
    }, {
        "name": "featurize_scan",
        "route": "cuda",
        "source": "fraud_detection_tpu_torch/ops/csrc/featurize_scan.cu",
        "replaces": "fraud_detection_tpu/ops/featurize_kernel.py:266",
        "launches": scan_launches,
        "max_abs_err": max_err,
        "matched": True,
        "ms": k_ms,
        "device_ms": k_dev,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": [rows, cols],
        "main_path": "tokenize_hash over phase 4's texts, one call a chunk",
        "card": card,
    }, {
        "name": "histogram",
        "route": "cuda",
        "source": "fraud_detection_tpu_torch/ops/csrc/histogram.cu",
        "replaces": "fraud_detection_tpu/ops/histogram.py:185",
        "launches": hist_launches,
        "max_abs_err": main_h["max_abs_err"],
        "matched": True,
        "ms": main_h["ms"],
        "device_ms": main_h["device_ms"],
        "plain_ms": main_h["plain_ms"],
        "bound_ms": main_h["bound_ms"],
        "bound_by": main_h["bound_by"],
        "library_ms": main_h["library_ms"],
        "shape": main_h["shape"],
        "bins": "uint8",
        "int32_bins": main_h["int32"],
        "other_shapes": {k: v for k, v in tree_times.items()
                         if k != "cli_xgb"},
        "cli_level_widths": hist_width_times,
        "card": card,
    }, {
        "name": "best_splits",
        "route": "cuda",
        "source": "fraud_detection_tpu_torch/ops/csrc/best_splits.cu",
        "replaces": "fraud_detection_tpu/ops/histogram.py:378",
        "launches": gain_launches,
        "max_abs_err": 0.0,
        "matched": True,
        "ms": main_g["ms"],
        "device_ms": main_g["device_ms"],
        "plain_ms": main_g["plain_ms"],
        "bound_ms": main_g["bound_ms"],
        "bound_by": main_g["bound_by"],
        "library_ms": None,
        "shape": main_g["shape"],
        "other_shapes": {k: v for k, v in gain_times.items()
                         if k != "cli_xgb"},
        "cli_level_widths": width_times,
        "card": card,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "fraud_detection_tpu_torch/ops/csrc/flash_attention_sm90.cu",
        "replaces": "fraud_detection_tpu/ops/attention.py:75",
        "launches": flash_launches,
        "max_abs_err": flash_err,
        "matched": True,
        "ms": flash_times[2048]["ms"],
        "plain_ms": flash_times[2048]["plain_ms"],
        "bound_ms": flash_times[2048]["bound_ms"],
        "bound_by": flash_times[2048]["bound_by"],
        "library_ms": flash_times[2048]["library_ms"],
        "shape": flash_times[2048]["shape"],
        "other_shapes": {"T8192": flash_times[8192]},
        "ragged_bf16_max_abs_err": max(ragged_err.values()),
        "card": card,
    }, {
        "name": "flash_attention_simt",
        "route": "cuda",
        "source": "fraud_detection_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "fraud_detection_tpu/ops/attention.py:75",
        "launches": cvc["simt_launches"],
        "max_abs_err": simt_main["max_abs_err"],
        "matched": True,
        "ms": simt_main["ms"],
        "plain_ms": simt_main["plain_ms"],
        "bound_ms": simt_main["bound_ms"],
        "bound_by": simt_main["bound_by"],
        "library_ms": simt_main["library_ms"],
        "shape": simt_main["shape"],
        "dtype": "float32",
        "other_shapes": {"bf16_T2048": simt_times[2048],
                         "bf16_T8192": simt_times[8192]},
        "main_path": "phase 11: the 2-layer f32 forward at T=600",
        "card": card,
    }], "serving": {"pipeline_rows_per_s": rates, "device_idle": idle,
                    "host_featurize_rows_per_s": host_rates,
                    "host_featurize_device_idle": host_idle,
                    "host_encode_ms": host_encode_ms,
                    "engine_msgs_per_s": msgs_s, "engine": engine_modes,
                    "serve_cli": serve_runs, "native_build": native_build},
        "fit_walls_s": {"cli": cli_walls, "bench": bench_walls},
        "tree_kernels_ms_per_cli_fit": per_fit,
        "llm": {"prefill": pre, "card_vs_cpu": cvc, "generate": gen,
                "explained_stream": expl}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
