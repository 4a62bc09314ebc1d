"""Game-day demo on the PyTorch port: a fraud-campaign spike + a seeded
worker kill + a hot swap, all on one deterministic timeline, judged by SLO
gates — twin of ``examples/game_day_demo.py``.

Runs the catalog's ``campaign_kill_swap`` scenario (docs/scenarios.md)
against a real in-process fleet: two partition-owning workers under the
lease coordinator score a campaign wave while the seeded death plan kills
one of them mid-drain and a freshly trained v2 model hot-swaps in through
the RCU path — and the verdict table at the end says whether zero-loss/
zero-dup accounting, the kill, the swap, and the latency bound all held.

    python examples/torch_game_day_demo.py [seed] [--device cpu]

Exit code 0 = every SLO passed; 1 = the game day failed its gates. The
fleet serves on the card unless ``--device cpu`` is given; it featurizes
on the host, so no kernel launches.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from examples.torch_serve_quickstart import device_arg  # noqa: E402
from fraud_detection_tpu_torch.scenarios import (get_scenario,  # noqa: E402
                                                 run_gameday)


def run(argv=None) -> dict:
    """The game day at ``seed`` (default 11); returns its result and the
    exit code."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("seed", nargs="?", type=int, default=11)
    device_arg(ap)
    args = ap.parse_args(argv)
    seed = args.seed
    gd = get_scenario("campaign_kill_swap", seed, scale=0.6)
    print(f"scenario: {gd.name} — {gd.description}")
    print(f"timeline: {gd.duration_s():.1f}s of traffic, "
          f"{gd.workers} fleet workers, 1 seeded kill, "
          f"hot swap at t={gd.hot_swap_at}s (seed {seed}, warp pacing)\n")
    result = run_gameday(gd, device=args.device)
    print(result.table())
    ev = result.evidence
    print(f"\nrows: {ev['planned']} planned / {ev['out_rows']} classified "
          f"/ {ev['dlq_rows']} dead-lettered; "
          f"deaths={ev['deaths']} swaps={ev['swaps']} "
          f"rebalances={ev['rebalances']} "
          f"lease_expirations={ev['lease_expirations']}")
    if ev.get("death_plan"):
        for k in ev["death_plan"]["killed"]:
            print(f"killed: worker {k['worker']} ({k['mode']}) "
                  f"at its poll #{k['at_poll']}")
    return {"result": result, "exit_code": 0 if result.ok else 1}


def main(argv=None) -> int:
    return run(argv)["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
