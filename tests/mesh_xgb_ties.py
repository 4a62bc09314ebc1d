#!/usr/bin/env python3
"""How far a mesh xgb fit at the training CLI's shape lies from the
single-device fit, in both packages, on the CPU.

Run from the repository root:

    python3 tests/mesh_xgb_ties.py [--rounds 20] [--shards 4]

It fits xgb (depth 5, 32 bins) on the training CLI's data (1,120 x 10,000
HashingTF + IDF, ``chip_smoke.cli_data``) on one device and on a mesh of
``--shards`` shards, in the port (``make_mesh(devices=["cpu"] * shards)``)
and in the JAX package (as many virtual XLA CPU devices), and prints for
each package the largest |p| difference on the training rows and the first
tree whose features differ. Trees may differ where features split a node's
rows alike (one f64 gain) and the f32 sums break the tie another way; p
then stays within rounding. If the port's first tree apart is tree 0, it
also finds the first differing node, routes the rows to it through the
single-device tree, and prints the features that share the best f64 gain
there. Not a test: pytest does not collect it.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args(argv)
    os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                               f"{args.shards}")
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path[:0] = [str(HERE.parent)]
    import jax.numpy as jnp
    import numpy as np
    import torch

    import chip_smoke as cs
    from fraud_detection_tpu.models import train_trees as jt
    from fraud_detection_tpu.models.trees import predict_proba as jproba
    from fraud_detection_tpu.parallel import make_mesh as jmesh
    from fraud_detection_tpu_torch.models import train_trees as tt
    from fraud_detection_tpu_torch.models.trees import predict_proba
    from fraud_detection_tpu_torch.parallel import make_mesh

    torch.set_num_threads(4)
    X, y, *_ = cs.cli_data("cpu")
    fits = {}
    cfg = tt.TreeTrainConfig(max_depth=5, n_bins=32, criterion="xgb")
    single = tt.fit_gradient_boosting(X, y, n_rounds=args.rounds, config=cfg,
                                      device="cpu")
    mesh = tt.fit_gradient_boosting(
        X, y, n_rounds=args.rounds, config=cfg,
        mesh=make_mesh(devices=["cpu"] * args.shards))
    x = torch.from_numpy(X)
    fits["torch"] = (predict_proba(single, x).numpy(),
                     predict_proba(mesh, x).numpy(),
                     single.feature.numpy(), mesh.feature.numpy())
    jcfg = jt.TreeTrainConfig(max_depth=5, n_bins=32, criterion="xgb")
    js = jt.fit_gradient_boosting(X, y, n_rounds=args.rounds, config=jcfg)
    jm = jt.fit_gradient_boosting(X, y, n_rounds=args.rounds, config=jcfg,
                                  mesh=jmesh())
    xj = jnp.asarray(X)
    fits["jax"] = (np.asarray(jproba(js, xj)), np.asarray(jproba(jm, xj)),
                   np.asarray(js.feature), np.asarray(jm.feature))
    for pkg, (p1, p2, f1, f2) in fits.items():
        first = next((i for i in range(args.rounds)
                      if not np.array_equal(f1[i], f2[i])), None)
        print(f"{pkg}: xgb{args.rounds} single vs {args.shards}-shard mesh: "
              f"max |dp| {np.abs(p1 - p2).max():.4g}, first tree apart "
              f"{first}")
    _, _, f1, f2 = fits["torch"]
    tree = next((i for i in range(args.rounds)
                 if not np.array_equal(f1[i], f2[i])), None)
    if tree is None:
        return 0
    if tree:
        print(f"torch: first tree apart {tree}; the node check reads tree 0's "
              "margins only")
        return 0
    node = int(np.flatnonzero(f1[tree] != f2[tree])[0])
    thr = single.threshold.numpy()[tree]
    at = np.zeros(len(X), int)
    for _ in range(int(np.floor(np.log2(node + 1)))):
        left = X[np.arange(len(X)), np.maximum(f1[tree][at], 0)] <= thr[at]
        at = np.where(left, 2 * at + 1, 2 * at + 2)
    rows = at == node
    margin = single.bias            # tree 0: every row at the base score
    p = 1.0 / (1.0 + np.exp(-np.float64(margin)))
    g = p - y.astype(np.float64)
    h = np.full_like(g, p * (1 - p))
    bins = tt.bin_rows_host(X, tt.quantile_bin_edges(X, 32))

    def best_gain(f):
        b, gg, hh = bins[rows, f], g[rows], h[rows]
        G, Hs, best = gg.sum(), hh.sum(), -np.inf
        for t in range(31):
            left = b <= t
            if left.all() or not left.any():
                continue
            gl, hl = gg[left].sum(), hh[left].sum()
            best = max(best, 0.5 * (gl * gl / (hl + 1.0) + (G - gl) ** 2
                                    / (Hs - hl + 1.0) - G * G / (Hs + 1.0)))
        return best

    gains = sorted(((best_gain(f), f) for f in range(X.shape[1])),
                   reverse=True)
    top = [f for gain, f in gains if gain == gains[0][0]]
    print(f"torch: tree {tree} node {node}: {int(rows.sum())} rows; single "
          f"feature {f1[tree][node]}, mesh feature {f2[tree][node]}; "
          f"features sharing the best f64 gain {gains[0][0]:.8g}: {top}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
