#!/usr/bin/env python3
"""Two checks of the explanation LLM's collectives across processes, on a
machine with four NVIDIA GPUs (two NCCL processes of two cards each, then
two of one card each). Run from the repository root:

    python3 scripts/collective_order.py

1. The order of backward collectives. Autograd runs a backward node on a
   thread of the device its gradient lies on, so where a process holds two
   cards, two collectives' backwards become ready in an order set by
   timing. Each process takes two replicated inputs on its first card
   through ``grad_sum_across`` (forward the identity, backward an
   all-reduce), A first, then B; A's result feeds a chain of elementwise
   ops on the first card and B's a chain on the second card, each chain
   long on one rank and short on the other, so A's gradient is ready first
   on rank 0 and B's first on rank 1. The loss is sum(A) + 10 sum(B), so
   the summed gradients are 2 and 20 a element; an all-reduce that pairs
   one rank's A with the other's B gives 11. Run ORDER_REPS times outside
   ``collective_order`` and inside it.
2. A full-width data-parallel fine-tune step across the two processes:
   Gemma-2B's architecture (18 layers, bf16, ``init_params_threefry``),
   B=8, T=128, a ("data",) mesh of one card a process, so the data rows'
   gradients go through ``sum_in_rank_order``: each rank's peak device
   memory and the step's wall (each step synchronised, the median of the
   last FIT_TIMED), beside one process fitting on a ("data",) mesh of the
   same two cards.

Every line names the card and its power limit; the results go to
``chiprun_out/collective_order.json``.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

ORDER_REPS = 5
FIT_TIMED = 3

_ORDER_CHILD = r'''
import contextlib, json
import numpy as np
import torch
from fraud_detection_tpu_torch.parallel.mesh import (
    Mesh, collective_order, grad_sum_across, initialize_distributed)

LONG, N = 3000, 1 << 16
assert initialize_distributed(timeout_s=60)
rank = torch.distributed.get_rank()
d0, d1 = torch.device("cuda", 2 * rank), torch.device("cuda", 2 * rank + 1)
mesh = Mesh(np.array([d0, d1], object), ("model",), process_count=2,
            process_index=rank, group=torch.distributed.group.WORLD)


def once(chained):
    xa = torch.ones(N, device=d0, requires_grad=True)
    xb = torch.ones(N, device=d0, requires_grad=True)
    with collective_order() if chained else contextlib.nullcontext():
        ca = grad_sum_across(xa, mesh)
        cb = grad_sum_across(xb, mesh)
    ya, yb = ca, cb.to(d1)
    for _ in range(LONG if rank == 1 else 1):
        ya = ya * 1.0
    for _ in range(LONG if rank == 0 else 1):
        yb = yb * 1.0
    (ya.sum() + 10 * yb.sum().to(d0)).backward()
    torch.cuda.synchronize(d0)
    return [float(xa.grad[0]), float(xb.grad[0])]


out = {"unchained": [once(False) for _ in range(REPS)],
       "chained": [once(True) for _ in range(REPS)]}
print("RESULT", rank, json.dumps(out), flush=True)
torch.distributed.destroy_process_group()
'''

_FIT_CHILD = r'''
import json, os
import numpy as np
import torch
import chip_smoke as cs
from fraud_detection_tpu_torch.parallel.mesh import Mesh, initialize_distributed
from scripts.collective_order import full_width_fit

assert initialize_distributed(timeout_s=120)
rank = torch.distributed.get_rank()
dev = torch.device("cuda", rank)
mesh = Mesh(np.array([dev], object), ("data",), process_count=2,
            process_index=rank, group=torch.distributed.group.WORLD)
print("RESULT", rank, json.dumps(full_width_fit(mesh, [dev])), flush=True)
torch.distributed.destroy_process_group()
'''


def full_width_fit(mesh, devices) -> dict:
    """1 + FIT_TIMED steps of the full-width bf16 fit on ``mesh``: losses,
    each step's wall, the median of the last FIT_TIMED, and each card's
    peak allocated bytes."""
    import torch

    import chip_smoke as cs
    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.models import train_llm as TL
    from fraud_detection_tpu_torch.models.llm import TransformerConfig

    cfg = TransformerConfig(**{**cs.GEMMA_2B, "dtype": torch.bfloat16})
    texts = [d.text for d in generate_corpus(n=64, seed=5)]
    walls, step = [], TL._train_step

    def timed(*args, **kw):
        for d in devices:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        out = step(*args, **kw)
        for d in devices:
            torch.cuda.synchronize(d)
        walls.append((time.perf_counter() - t0) * 1e3)
        return out

    for d in devices:
        torch.empty(0, device=d)           # the card's context, then its peak
        torch.cuda.reset_peak_memory_stats(d)
    tcfg = TL.LLMTrainConfig(steps=1 + FIT_TIMED, batch_size=cs.TRAIN_B,
                             seq_len=cs.TRAIN_T, learning_rate=1e-4,
                             warmup_steps=0, seed=3)
    TL._train_step = timed
    try:
        _, losses = TL.fit_language_model(texts, cfg, tcfg, mesh=mesh,
                                          device=devices[0])
    finally:
        TL._train_step = step
    return dict(losses=losses, step_walls_ms=walls,
                step_ms=statistics.median(walls[1:]),
                peak_bytes={str(d): torch.cuda.max_memory_allocated(d)
                            for d in devices})


def ranks_of(texts: list) -> list:
    return [json.loads([ln for ln in t.splitlines()
                        if ln.startswith("RESULT")][0].split(" ", 2)[2])
            for t in texts]


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from fraud_detection_tpu_torch.parallel.mesh import Mesh

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("collective_order: needs four CUDA devices", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(f"{card} x {torch.cuda.device_count()}", flush=True)
    out, failed = {"card": card}, []
    # both pairs run before this process starts CUDA on the cards
    t0 = time.perf_counter()
    order = ranks_of(cs.run_two_ranks(
        _ORDER_CHILD.replace("REPS", str(ORDER_REPS)),
        {"LOCAL_RANKS": "0,2"}, 180))
    want = [2.0, 20.0]
    for mode in ("unchained", "chained"):
        wrong = sum(any(r[mode][i] != want for r in order)
                    for i in range(ORDER_REPS))
        out[f"order_{mode}"] = dict(grads=[r[mode] for r in order],
                                    wrong_reps=wrong)
        print(f"[order] 2 NCCL processes x 2 cards, two grad_sum_across "
              f"whose gradients arrive A-then-B on rank 0 and B-then-A on "
              f"rank 1, {mode}: {wrong} of {ORDER_REPS} runs paired the "
              f"wrong gradients (per rank [dA, dB], want {want}: "
              f"{[r[mode] for r in order]}) ({card})", flush=True)
    if out["order_chained"]["wrong_reps"]:
        failed.append("the chained collectives paired the wrong gradients")
    print(f"[order] {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    two = ranks_of(cs.run_two_ranks(_FIT_CHILD, {"LOCAL_RANKS": "0,1"}, 600))
    print(f"[fit] 2 NCCL processes: {json.dumps(two)}", flush=True)
    devs = [torch.device("cuda", i) for i in range(2)]
    one = full_width_fit(Mesh(np.array(devs, object), ("data",)), devs)
    out["fit"] = dict(two_process=two, one_process=one)
    if not all(abs(a - b) <= cs.MESH_LOSS_TOL * (1 + abs(b))
               for a, b in zip(two[0]["losses"], one["losses"])) or \
            two[0]["losses"] != two[1]["losses"]:
        failed.append("the two-process full-width fit's losses")
    gb = 1e9
    print(f"[fit] Gemma-2B width, 18 layers, bf16, B={cs.TRAIN_B}, "
          f"T={cs.TRAIN_T}, ('data',) over 2 cards: 2 NCCL processes step "
          f"{two[0]['step_ms']:.1f} ms (walls "
          f"{[round(w, 1) for w in two[0]['step_walls_ms']]}), peak "
          + ", ".join(f"rank {r} {v / gb:.2f} GB" for r, t in enumerate(two)
                      for v in t["peak_bytes"].values())
          + f"; one process step {one['step_ms']:.1f} ms (walls "
          f"{[round(w, 1) for w in one['step_walls_ms']]}), peak "
          + ", ".join(f"{d} {v / gb:.2f} GB"
                      for d, v in one["peak_bytes"].items())
          + f"; losses {[round(x, 5) for x in two[0]['losses']]} vs "
          f"{[round(x, 5) for x in one['losses']]} "
          f"({time.perf_counter() - t0:.1f} s) ({card})", flush=True)
    out["failed"] = failed
    dest = HERE / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "collective_order.json").write_text(json.dumps(out, indent=1))
    for f in failed:
        print(f"[collective-order] FAILED {f}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
