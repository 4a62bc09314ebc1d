"""Driftloop end to end on the PyTorch port: drift -> detect -> retrain ->
shadow -> promote — twin of ``examples/drift_loop_demo.py``.

Runs the seeded ``drift_shift`` game day (docs/online_learning.md) on the
in-process stack and narrates what the closed loop did: the
novel-vocabulary campaign the v1 model scored benign, the delayed labels
that revealed it, the warm-started retrain, the shadow judgment, the
audited auto-promotion, and the exact join accounting. Exit code is the
game day's verdict (0 = every gate passed).

    python examples/torch_drift_loop_demo.py [--device cpu]

On the card the game day's boosting fit and the learn lane's refresh
launch the hand-written histogram and split-gain kernels; ``--device cpu``
runs their plain torch versions.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from examples.torch_serve_quickstart import device_arg  # noqa: E402
from fraud_detection_tpu_torch.scenarios import (get_scenario,  # noqa: E402
                                                 run_gameday)


def run(argv=None) -> dict:
    """The game day at seed 11; returns its result and the exit code."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    device_arg(ap)
    args = ap.parse_args(argv)
    gd = get_scenario("drift_shift", seed=11, scale=0.4)
    print(f"running game day {gd.name!r} "
          f"(drift onset at {gd.learn.drift_at_s}s virtual)...\n")
    result = run_gameday(gd, device=args.device)
    ev = result.evidence
    learn = ev["learn"]
    w = learn["window"]

    print(result.table())
    print()
    print("the loop, in order:")
    print(f"  1. window ingested {w['inserted']} scored rows "
          f"(packed features, no text)")
    print(f"  2. label lane joined {w['joined']}/{w['labels_seen']} "
          f"ground-truth labels (expired={w['expired']} "
          f"missed={w['missed']} pending={w['pending_labels']} — "
          f"accounting exact: {w['accounting_exact']})")
    print(f"  3. drift trigger fired at {learn['first_trigger_at_s']}s "
          f"virtual: the live model's recent label error was "
          f"{learn['primary_window_error_rate']}")
    print(f"  4. warm-started retrain published "
          f"v{learn['published_versions'][0]:04d} in "
          f"{learn['last_retrain_wall_s']}s wall "
          f"(candidate window error: "
          f"{learn['candidate_window_error_rate']})")
    print(f"  5. shadow judged the window replay and the controller "
          f"auto-promoted at {learn['promoted_at_s']}s virtual "
          f"({ev['learn_promotion_latency_s']}s after drift onset)")
    print(f"  6. hot swap landed (swaps={ev['swaps']}), "
          f"active_version={ev['lifecycle']['active_version']}, "
          f"every transition audited: "
          f"{[e['event'] for e in ev['lifecycle']['events']]}")
    incidents = [i["rule"] for i in (ev.get("alerts") or {})
                 .get("incidents", [])]
    print(f"  7. the sentinel made drift an INCIDENT: {incidents}")
    print(f"\naudit trail: {ev['registry_root']}/audit.jsonl")
    return {"result": result, "exit_code": 0 if result.ok else 1}


def main(argv=None) -> int:
    return run(argv)["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
