#!/usr/bin/env python3
"""``chip_smoke.py``'s LLM mesh phases over every local card.

Run from the repository root on a machine with two NVIDIA GPUs or more
(four gives the 4-way model and sequence axes of the one-card phases):

    python3 scripts/llm_mesh_phases.py

It builds the flash and int8 kernels, runs their self-tests on every card,
draws the Gemma-2B-architecture model of phase 10 (bf16, random N(0, 0.02)
weights from seed 0) on cuda:0 with its int8 copy, and runs over the real
cards what ``chip_smoke.py`` runs over a virtual mesh of cuda:0:
``tp_serving`` (12b: the model split over a model axis of the cards, the
prefill's and the int8 generation's launch counts, logits and greedy
tokens against one card), ``sp_forward`` (12c: ring and Ulysses over a
sequence axis of the cards), ``sharded_caches`` (12d: the Llama-3-8B
architecture over a 4-way model axis of the cards, each card holding its
2 K/V heads' part of every cache, the decode step with the cache on
cuda:0 against per part, the KV bytes of each card) and ``mesh_fits``
(14c: (data 2, model 2) and (data 2, seq 2) fits over the first four cards
against one card). First, before this process starts CUDA, two processes,
one card each, run the tensor-parallel and the ring forward across the
process boundary over NCCL (the row-parallel sums an ``all_reduce``, the
ring's rotation a send/recv); they are held against a one-process forward
once both exit. Phase 14d's two-process fits follow them, before this
process starts CUDA too (``chip_smoke.two_process_fit_ranks``): two NCCL
processes of one card each and, with four cards, of two cards each; last
(``chip_smoke.two_process_fits``) they are held against this process's
fits on meshes of the same cards, each one's step time beside the
other's. Every line names the card
and its power limit; the results go to
``chiprun_out/llm_mesh_phases.json``.

A multi-process fit of one's own: start one process per card (torchrun, or
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` set by hand), call
``parallel.mesh.initialize_distributed()``, build a ``Mesh`` of the
process's cards with ``process_count``, ``process_index`` and
``group=torch.distributed.group.WORLD`` (its first axis spans the
processes) and call ``fit_language_model(..., mesh=)`` in every process.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

# the two-process forwards: Gemma-2B's architecture at 2 layers, bf16
_CHILD = r'''
import sys
import torch
import numpy as np
import chip_smoke as cs
from fraud_detection_tpu_torch.models.llm import (
    MODEL_AXIS, SEQ_AXIS, TransformerConfig, forward, init_params_threefry,
    shard_params)
from fraud_detection_tpu_torch.parallel.mesh import Mesh, initialize_distributed

assert initialize_distributed(timeout_s=120)
rank = torch.distributed.get_rank()
dev = torch.device("cuda", rank)
cfg = TransformerConfig(**{**cs.GEMMA_2B, "n_layers": 2,
                           "dtype": torch.bfloat16})
params = init_params_threefry(cfg, 0, dev)
toks = (torch.arange(256, device=dev)[None, :] * 7) % 250
out = {}
for axis in (MODEL_AXIS, SEQ_AXIS):
    mesh = Mesh(np.array([dev], object), (axis,), process_count=2,
                process_index=rank, group=torch.distributed.group.WORLD)
    with torch.inference_mode():
        if axis == MODEL_AXIS:
            logits = forward(shard_params(params, cfg, mesh), toks, cfg)[0]
        else:
            logits = forward(params, toks, cfg, seq_mesh=mesh)[0]
    out[axis] = logits[0, [127, 255]].float().cpu().tolist()
print("RESULT", rank, __import__("json").dumps(out), flush=True)
torch.distributed.destroy_process_group()
'''


def run_two_process(timeout: float = 150.0) -> list:
    """The two NCCL processes' forwards (``_CHILD``): each rank's result."""
    import chip_smoke as cs

    return [json.loads([ln for ln in out.splitlines()
                        if ln.startswith("RESULT")][0].split(" ", 2)[2])
            for out in cs.run_two_ranks(_CHILD, {}, timeout)]


def two_process(got: list, card: str) -> dict:
    """The two NCCL processes' TP and ring forwards (``run_two_process``)
    held against a one-process forward on cuda:0: positions 127 and 255 of
    every rank's logits, within chip_smoke's TP_LOGIT_FRAC of their max."""
    import torch

    import chip_smoke as cs
    from fraud_detection_tpu_torch.models.llm import (
        TransformerConfig, forward, init_params_threefry)

    dev = torch.device("cuda", 0)
    cfg = TransformerConfig(**{**cs.GEMMA_2B, "n_layers": 2,
                               "dtype": torch.bfloat16})
    toks = (torch.arange(256, device=dev)[None, :] * 7) % 250
    with torch.inference_mode():
        want = forward(init_params_threefry(cfg, 0, dev), toks,
                       cfg)[0][0, [127, 255]].float()
    res = {}
    for axis in ("model", "seq"):
        for r, g in enumerate(got):
            res[f"{axis} rank {r}"] = cs.last_logits_close(
                f"two-process {axis} forward, rank {r}",
                torch.tensor(g[axis], device=dev), want)
    print(f"[multiprocess] 2 NCCL processes, one card each, Gemma-2B width "
          f"at 2 layers, bf16, T=256: the TP forward (row-parallel sums an "
          f"all_reduce) and the ring forward (the rotation a send/recv) on "
          f"both ranks against one process: max |d| "
          f"{max(v['dlogit'] for v in res.values()):.4g} (max |logit| "
          f"{max(v['logit_scale'] for v in res.values()):.4g}, gate "
          f"{cs.TP_LOGIT_FRAC}) ({card})")
    return res


def main() -> int:
    import torch

    import chip_smoke as cs
    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.ops import _build
    from fraud_detection_tpu_torch.ops import attention as A
    from fraud_detection_tpu_torch.ops import int8_matmul as W

    if not torch.cuda.is_available():
        print("llm_mesh_phases: no CUDA device", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"llm_mesh_phases: {cards} card; the phases over cards need "
              "two or more (chip_smoke.py runs them on a virtual mesh)",
              file=sys.stderr)
        return 2
    card = cs.card_line()
    print(f"{card} x {cards}", flush=True)
    # Every NCCL pair runs before this process starts CUDA, phase 14d's
    # fits first. A pair that fails is recorded and the phases over the
    # cards still run; the script then exits 1.
    failed = {}
    fit_ranks = {}
    for per in (1, 2):
        if cards < 2 * per:
            continue
        t0 = time.perf_counter()
        try:
            fit_ranks[per] = cs.two_process_fit_ranks(per)
        except AssertionError as e:
            failed[f"two_process_fits {per}"] = str(e)[-4000:]
        print(f"[multiprocess] the two NCCL processes' fits, {per} card(s) "
              f"a process: {'failed' if per not in fit_ranks else 'done'} "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    try:
        ranks = run_two_process()
    except AssertionError as e:
        ranks, failed["two_process"] = None, str(e)[-4000:]
    print(f"[multiprocess] the two NCCL processes' forwards "
          f"{'failed' if ranks is None else 'done'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(("flash_attention", "flash_attention_sm90",
                      "int8_matmul"))
    # self-tests launch (and count) once a card: before any count is read
    for i in range(cards):
        A.kernel_self_test(torch.device("cuda", i))
        W.kernel_self_test(torch.device("cuda", i))
    devices = [torch.device("cuda", i) for i in range(min(cards, 4))]
    t0 = time.perf_counter()
    lm = cs.gemma(dev, 0)
    lm8 = lm.quantized()
    out = {"cards": cards, "card": card,
           "tp_serving": cs.tp_serving(lm, lm8, dev, 44, card,
                                       devices=devices),
           "sp_forward": cs.sp_forward(lm, dev, 45, card, devices=devices)}
    del lm, lm8
    torch.cuda.empty_cache()
    if len(devices) == 4:
        out["sharded_caches"] = cs.sharded_caches(dev, 46, card,
                                                  devices=devices)
        torch.cuda.empty_cache()
        texts = [d.text for d in generate_corpus(n=64, seed=5)]
        out["mesh_fits"] = cs.mesh_fits(texts, dev, devices, card)
    if ranks is not None:
        out["two_process"] = two_process(ranks, card)
    torch.cuda.empty_cache()
    out["two_process_fits"] = {f"{per} card(s) a process":
                               cs.two_process_fits(per, card, ranks=r)
                               for per, r in fit_ranks.items()}
    out["wall_s"] = time.perf_counter() - t0
    out["failed"] = failed
    print(f"[llm-mesh] phases 12b, 12c, 12d, 14c, 14d and the two-process "
          f"forwards over {cards} cards: {out['wall_s']:.1f} s ({card})"
          + "".join(f"\n[llm-mesh] FAILED {k}: {v}" for k, v in failed.items()))
    dest = HERE / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "llm_mesh_phases.json").write_text(json.dumps(out, default=str,
                                                          indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
