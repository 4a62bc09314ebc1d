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
sequence axis of the cards) and ``mesh_fits`` (14c: (data 2, model 2) and
(data 2, seq 2) fits over the first four cards against one card). First,
before this process starts CUDA, two processes, one card each, run the
tensor-parallel and the ring forward across the process boundary over
NCCL (the row-parallel sums an ``all_reduce``, the ring's rotation a
send/recv); they are held against a one-process forward once both exit.
Every line names the card and its power limit; the results go to
``chiprun_out/llm_mesh_phases.json``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
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
    """Start the two NCCL processes, wait for both under one deadline
    (their output goes to files, so neither blocks on a full pipe while the
    other waits in a collective), kill whatever is left, and return each
    rank's result; raises with both ranks' error tails otherwise."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            for _ in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD], cwd=HERE, text=True,
        stdout=logs[r][0], stderr=logs[r][1],
        env=dict(os.environ, PYTHONPATH=str(HERE), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(r),
                 LOCAL_RANK=str(r))) for r in range(2)]
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline and any(p.poll() is None
                                                  for p in procs):
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for out, err in logs:
        out.seek(0)
        err.seek(0)
        texts.append((out.read(), err.read()))
        out.close()
        err.close()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("two-process LLM forward: exits "
                             f"{[p.returncode for p in procs]}\n" + "\n".join(
                                 f"rank {r}: {e[-3000:]}"
                                 for r, (_, e) in enumerate(texts)))
    return [json.loads([ln for ln in o.splitlines()
                        if ln.startswith("RESULT")][0].split(" ", 2)[2])
            for o, _ in texts]


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
    t0 = time.perf_counter()
    ranks = run_two_process()
    print(f"[multiprocess] the two NCCL processes' forwards done in "
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
        texts = [d.text for d in generate_corpus(n=64, seed=5)]
        out["mesh_fits"] = cs.mesh_fits(texts, dev, devices, card)
    out["two_process"] = two_process(ranks, card)
    out["wall_s"] = time.perf_counter() - t0
    print(f"[llm-mesh] phases 12b, 12c, 14c and the two-process forwards "
          f"over {cards} cards: {out['wall_s']:.1f} s ({card})")
    dest = HERE / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "llm_mesh_phases.json").write_text(json.dumps(out, default=str,
                                                          indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
