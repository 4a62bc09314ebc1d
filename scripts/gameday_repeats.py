#!/usr/bin/env python3
"""Repeat catalog game days on the card and report each run's verdict.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/gameday_repeats.py [--name diurnal_tide_scale]
        [--name flash_crowd_scale] [--reps 5] [--host-featurize]
        [--device cpu]

Each named scenario (seed 0, scale 1.0, its declared pacing) runs
``--reps`` times through ``run_gameday`` on one game-day pipeline
(``scenarios/gameday.py _default_pipeline``) on the card, under device
featurize unless ``--host-featurize`` (``--device cpu`` runs the same on
the CPU with host featurize, a rehearsal whose figures are the CPU's).
Per run it prints the verdict, the failed gates, the autoscaler's
scale-outs, scale-ins and denials, the scale-out reaction in virtual
seconds, the fleet sentinel's incidents, and the fleet's global backlog as
the coordinator saw it at every tick (its peak and the ticks above the
burn rule's limit). This is how the paced
autoscale days' pass rate is measured: their verdict races the
autoscaler's cooldown (``chip_smoke.py`` ``GAMEDAY_DECISION_GATES``). The
card's name and power limit lead the output; the runs go to
``chiprun_out/gameday_repeats.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--name", action="append", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--host-featurize", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("gameday_repeats: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from fraud_detection_tpu_torch.fleet import coordinator as C
    from fraud_detection_tpu_torch.ops import _build
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk
    from fraud_detection_tpu_torch.scenarios import gameday as G

    if dev.type == "cuda":
        card = cs.card_line()
        _build.build_all(("featurize_scan", "histogram", "best_splits"))
        fk.kernel_self_test(dev)
    else:
        card = f"CPU, {os.cpu_count()} cores, host featurize"
        args.host_featurize = True
    print(card, flush=True)

    ticks = []
    tick = C.FleetCoordinator.tick

    def sampled_tick(self):
        view = tick(self)
        ticks.append(view.get("global_backlog") or 0)
        return view

    C.FleetCoordinator.tick = sampled_tick
    names = args.name or ["diurnal_tide_scale", "flash_crowd_scale"]
    runs = []
    for name in names:
        gd = G.get_scenario(name, 0, scale=1.0)
        limit = next((r.limit for r in gd.sentinel.resolve_rules(True)
                      if r.name == "fleet_watermark_burn"), None) \
            if gd.sentinel is not None else None
        pipe = G._default_pipeline(gd.batch_size, model=gd.model,
                                   device=dev,
                                   featurize_device=not args.host_featurize)
        for i in range(args.reps):
            ticks.clear()
            t0 = time.perf_counter()
            result = G.run_gameday(gd, pipeline=pipe)
            wall = time.perf_counter() - t0
            ev = result.evidence
            a = ev.get("autoscale") or {}
            workers = max(1, gd.workers)
            over = (sum(1 for b in ticks if b / workers > limit)
                    if limit is not None else None)
            run = dict(
                name=name, rep=i, ok=result.ok, wall_s=wall,
                failed=[v.name for v in result.report.failed],
                scale_outs=a.get("scale_outs"), scale_ins=a.get("scale_ins"),
                denied=a.get("denied"),
                reaction_s=ev.get("autoscale_reaction_s"),
                incidents=[(x.get("rule"), x.get("fired_at"))
                           for x in (ev.get("alerts") or {}).get(
                               "incidents") or []],
                peak_backlog=max(ticks, default=None),
                ticks_over_limit=over, ticks=len(ticks))
            runs.append(run)
            print(f"[repeat] {name} #{i}: {'PASS' if result.ok else 'FAIL'} "
                  f"{run['failed']}; scale-outs {run['scale_outs']}, "
                  f"scale-ins {run['scale_ins']}, denied {run['denied']}, "
                  f"reaction {run['reaction_s']} s; peak global backlog "
                  f"{run['peak_backlog']} ({over} of {len(ticks)} ticks over "
                  f"the burn limit {limit}/worker); incidents "
                  f"{run['incidents'][:4]}; wall {wall:.2f} s ({card})",
                  flush=True)
    for name in names:
        mine = [r for r in runs if r["name"] == name]
        print(f"[repeat] {name}: {sum(r['ok'] for r in mine)} of "
              f"{len(mine)} PASS under "
              f"{'host' if args.host_featurize else 'device'} featurize "
              f"({card})")
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "gameday_repeats.json").write_text(json.dumps(
        {"card": card, "host_featurize": args.host_featurize,
         "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
