#!/usr/bin/env python3
"""Where the mesh serving lane's time goes, on every local card.

Run from the repository root on a machine with one or more NVIDIA GPUs:

    python3 scripts/mesh_trace.py [--reps 5]

It builds the featurize kernel and the LR pipeline of ``chip_smoke.py``'s
phase 7h (HashingTF 10,000 + IDF, device featurize at W = 2,048 and 256
slots, global batch 1,024) and scores 2,048 texts on three arms: the
single-card pipeline, a virtual mesh of as many shards on cuda:0 as there
are cards (4 on one card), and the mesh over the local cards (with two or
more). For each arm, in turns:

* rows/s of ``predict`` (median of ``--reps``, host clock, each resolved);
* host spans of one chunk's dispatch, summed over a predict's chunks:
  the staging pack, the shard split, each shard's upload, its
  ``featurize_packed`` launch, its scoring launches, its readback start
  (a pinned buffer, the copy, an event), and the wait in ``resolve``;
* one predict under ``torch.profiler``: host self time of the top
  operators and runtime calls, device busy time per card, and the device
  idle share (1 - busiest card's kernel time / wall).

Every line names the card and its power limit. The numbers go to
``chiprun_out/mesh_trace.json`` and the mesh arm's Chrome trace to
``chiprun_out/mesh_trace_<arm>.trace.json``.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

SPANS = ("pack", "shard_split", "upload", "featurize", "score", "readback",
         "resolve_wait")


class Spans:
    """Host-clock spans of the pipeline's dispatch steps, by patching the
    functions a chunk calls (the patch is undone by ``restore``)."""

    def __init__(self):
        self.t = defaultdict(float)
        self.on = False
        self._undo = []

    def wrap(self, owner, name: str, span: str, inner=()):
        """Time ``owner.name`` as ``span``, less the spans in ``inner``
        that run inside it."""
        fn = getattr(owner, name)

        @functools.wraps(fn)      # keeps a kernel wrapper's launch count
        def timed(*a, **k):
            if not self.on:
                return fn(*a, **k)
            before = sum(self.t[s] for s in inner)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                took = time.perf_counter() - t0
                self.t[span] += took - (sum(self.t[s] for s in inner) - before)

        setattr(owner, name, timed)
        self._undo.append((owner, name, fn))

    def restore(self):
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)


def busy_by_card(prof) -> dict:
    """Kernel and copy time per card (us) from a profiler's events."""
    import torch

    out = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[int(e.device_index)] += e.time_range.elapsed_us()
    return dict(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.featurize import device as devfeat
    from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
    from fraud_detection_tpu_torch.models import pipeline as pl
    from fraud_detection_tpu_torch.ops import _build
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk
    from fraud_detection_tpu_torch.parallel import make_mesh
    from fraud_detection_tpu_torch.parallel.serving import MeshServingPipeline

    if not torch.cuda.is_available():
        print("mesh_trace: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    cards = torch.cuda.device_count()
    print(f"{card} x {cards}")
    _build.build_all(("featurize_scan",))
    for i in range(cards):
        fk.kernel_self_test(torch.device("cuda", i))
    feat = HashingTfIdfFeaturizer(num_features=cs.FEATURES)
    feat.fit_idf([d.text for d in generate_corpus(n=800, seed=7)])
    lr, _ = cs.make_models(feat, 0, dev)
    texts = [d.text for d in generate_corpus(n=2048, seed=3)]
    kw = dict(featurize_device=True, featurize_width=cs.WIDTH,
              featurize_tokens=cs.TOKENS)
    shards = cards if cards > 1 else cs.MESH_SHARDS
    single = pl.ServingPipeline(feat, lr, batch_size=cs.MESH_PER_CHIP
                                * shards, device=dev, **kw)
    arms = {"single": single,
            "virtual_mesh": MeshServingPipeline(
                feat, lr, per_chip_batch=cs.MESH_PER_CHIP,
                mesh=make_mesh(devices=[dev] * shards), **kw)}
    if cards > 1:
        arms["local_mesh"] = MeshServingPipeline.from_pipeline(single)
    for p in arms.values():
        p.predict(texts)
    torch.cuda.synchronize()

    spans = Spans()
    spans.wrap(devfeat.DeviceFeaturizer, "pack", "pack")
    spans.wrap(pl.ServingPipeline, "_shards", "shard_split")
    spans.wrap(fk, "featurize_bytes", "featurize")
    spans.wrap(pl._HostCopy, "__init__", "readback")
    spans.wrap(pl.ServingPipeline, "_score", "score", inner=("readback",))
    spans.wrap(pl.ServingPipeline, "_dispatch_bytes", "upload",
               inner=("pack", "shard_split", "featurize", "score",
                      "readback"))
    spans.wrap(pl.PendingPrediction, "resolve", "resolve_wait")
    order = [*arms, *reversed(arms)]
    rates = defaultdict(list)
    host = {k: defaultdict(list) for k in arms}
    try:
        for name in order:
            p = arms[name]
            for _ in range(args.reps):
                t0 = time.perf_counter()
                p.predict(texts)
                rates[name].append(len(texts) / (time.perf_counter() - t0))
            spans.t.clear()
            spans.on = True
            t0 = time.perf_counter()
            p.predict(texts)
            wall = time.perf_counter() - t0
            spans.on = False
            for s in SPANS:
                host[name][s].append(spans.t[s] * 1e3)
            host[name]["wall"].append(wall * 1e3)
    finally:
        spans.restore()

    out = {"card": card, "cards": cards, "shards": shards,
           "texts": len(texts), "global_batch": single.batch_size, "arms": {}}
    dest = HERE / "chiprun_out"
    dest.mkdir(exist_ok=True)
    for name, p in arms.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            p.predict(texts)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        busy = busy_by_card(prof)
        med = {s: statistics.median(v) for s, v in host[name].items()}
        out["arms"][name] = {
            "rows_per_s": statistics.median(rates[name]),
            "rows_per_s_all": rates[name],
            "host_ms": med,
            "profiled_wall_us": wall_us,
            "device_busy_us": busy,
            "device_idle": (1 - max(busy.values()) / wall_us) if busy else None,
            "top_host_self_us": [(e.key, e.count, e.self_cpu_time_total)
                                 for e in top[:12]],
        }
        a = out["arms"][name]
        print(f"[trace] {name}: {a['rows_per_s']:.0f} rows/s; host ms per "
              f"predict of {len(texts)} rows: "
              + ", ".join(f"{s} {med[s]:.3f}" for s in (*SPANS, "wall"))
              + f"; device busy us by card {busy}; idle "
              + (f"{100 * a['device_idle']:.1f}%" if busy else "not measured")
              + f" ({card})")
        print(f"[trace] {name} top host self time (op, calls, us): "
              + "; ".join(f"{k} {c} {us:.0f}" for k, c, us
                          in a["top_host_self_us"]))
        (dest / "mesh_trace.json").write_text(json.dumps(out, indent=1))
        if name != "single":
            prof.export_chrome_trace(str(dest / f"mesh_trace_{name}.trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
