#!/usr/bin/env python3
"""``chip_smoke.py``'s phases 7g-7j alone, over every local card.

Run from the repository root on a machine with one or more NVIDIA GPUs:

    python3 scripts/mesh_phases.py

It builds the kernels, runs their self-tests on every card, writes the LR
checkpoint that phase 5b writes (HashingTF 10,000 + IDF, the seeded LR) and
runs ``kafka_phase`` (7g: ``serve --kafka`` over the stand-in broker),
``mesh_serving_phase`` (7h: the mesh over the local cards and the 4-shard
virtual mesh on cuda:0), ``mesh_training_phase`` (7i: ``train --mesh`` over
the local cards and the virtual-mesh fits) and ``multiprocess_phase`` (7j:
a 2-process NCCL rendezvous when there are two cards or more). With two
cards or more it also fits xgb8 at the training CLI's shape over the real
cards and over as many shards on cuda:0, and holds the two equal tree for
tree. Every line names the card and its power limit; the results go to
``chiprun_out/mesh_phases.json``.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))


def main() -> int:
    import torch

    import chip_smoke as cs
    from fraud_detection_tpu_torch.checkpoint.native import save_checkpoint
    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
    from fraud_detection_tpu_torch.models import train_trees as tt
    from fraud_detection_tpu_torch.ops import _build
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk
    from fraud_detection_tpu_torch.ops import histogram as H
    from fraud_detection_tpu_torch.parallel import make_mesh

    if not torch.cuda.is_available():
        print("mesh_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cards = torch.cuda.device_count()
    print(f"{card} x {cards}")
    _build.build_all(cs.KERNELS)
    # self-tests launch (and count) once a card: run them before any
    # count is read
    for i in range(cards):
        fk.kernel_self_test(torch.device("cuda", i))
        H.kernel_self_test(torch.device("cuda", i))
    cs.build_native()
    feat = HashingTfIdfFeaturizer(num_features=cs.FEATURES)
    feat.fit_idf([d.text for d in generate_corpus(n=800, seed=7)])
    lr, _ = cs.make_models(feat, 0, dev)
    work = HERE / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    save_checkpoint(str(work / "lr"), feat, lr)
    texts = [d.text for d in generate_corpus(n=2048, seed=3)]
    t0 = time.perf_counter()
    out = {"cards": cards, "card": card,
           "kafka": cs.kafka_phase(dev, work / "lr", card, 0),
           "mesh": cs.mesh_serving_phase(dev, work / "lr", feat, lr, texts,
                                         card, 0)}
    Xtr, ytr, *_ = cs.cli_data(dev)
    out["train"] = cs.mesh_training_phase(dev, Xtr, ytr, work, card)
    if cards > 1:
        cfg = tt.TreeTrainConfig(max_depth=cs.DEPTH, n_bins=cs.NBINS,
                                 criterion="xgb")
        fits, walls = {}, {}
        for name, mesh in (("cards", make_mesh()),
                           ("virtual", make_mesh(devices=[dev] * cards))):
            t1 = time.perf_counter()
            fits[name] = tt.fit_gradient_boosting(
                Xtr, ytr, n_rounds=cs.MESH_XGB_ROUNDS, config=cfg, mesh=mesh)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t1
        a, b = fits["cards"], fits["virtual"]
        if not all(torch.equal(getattr(a, k), getattr(b, k)) for k in
                   ("feature", "threshold", "left", "right", "leaf")):
            raise AssertionError(f"xgb over {cards} cards != over {cards} x "
                                 "cuda:0")
        print(f"[mesh-train] xgb{cs.MESH_XGB_ROUNDS} over the {cards} cards "
              f"== over {cards} x {dev} tree for tree; walls {walls} s ({card})")
        out["cards_vs_virtual_walls_s"] = walls
    out["multiprocess"] = cs.multiprocess_phase(card)
    out["wall_s"] = time.perf_counter() - t0
    print(f"[mesh] phases 7g-7j over {cards} card(s): {out['wall_s']:.1f} s "
          f"({card})")
    dest = HERE / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "mesh_phases.json").write_text(json.dumps(out, default=str,
                                                      indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
