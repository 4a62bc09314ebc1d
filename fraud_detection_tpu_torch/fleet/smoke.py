"""Fleet smoke check: ``python -m fraud_detection_tpu_torch.fleet.smoke``
(``--device cpu`` off the card) — twin of
``fraud_detection_tpu/fleet/smoke.py``.

The fleet gate (and a handy local sanity command): run the smoke corpus
through a 1-worker and an N-worker in-process fleet, then a seeded
worker-kill run, and assert the invariants that define the fleet lane:

* exact key-set accounting on both drains (every input key classified
  exactly once — zero loss, zero duplicates);
* zero loss / zero duplicates ACROSS a seeded worker death + rebalance;
* aggregate throughput >= ``FLEET_SMOKE_MIN_SCALING`` x the single-worker
  rate — asserted only when the machine has >= 2 usable cores (thread
  workers cannot parallelize compute on one core; the measured ratio is
  always printed either way).

The pipeline runs on ``--device`` (default ``cuda``: every worker thread
scores on the card).

Exit 0 = all invariants hold; nonzero prints the failing invariant.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _drain(pipeline, n_msgs: int, n_workers: int, texts, *,
           death_plan=None, num_partitions: int = 4, batch_size: int = 256):
    from fraud_detection_tpu_torch.fleet import Fleet
    from fraud_detection_tpu_torch.stream import InProcessBroker

    broker = InProcessBroker(num_partitions=num_partitions)
    feeder = broker.producer()
    for i in range(n_msgs):
        feeder.produce("in", json.dumps(
            {"text": texts[i % len(texts)], "id": i}).encode(),
            key=str(i).encode())
    fleet = Fleet.in_process(broker, pipeline, "in", "out", n_workers,
                             batch_size=batch_size, death_plan=death_plan,
                             lease_ttl=1.0)
    result = fleet.run(idle_timeout=0.5, join_timeout=120.0)
    out_keys = [m.key for m in broker.messages("out")]
    return result, out_keys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device the shared pipeline scores on "
                         "(default cuda)")
    args = ap.parse_args(argv)
    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.models.pipeline import synthetic_demo_pipeline
    from fraud_detection_tpu_torch.stream.faults import WorkerDeathPlan

    n_msgs = int(os.environ.get("FLEET_SMOKE_MSGS", "6000"))
    n_workers = int(os.environ.get("FLEET_SMOKE_WORKERS", "2"))
    min_scaling = float(os.environ.get("FLEET_SMOKE_MIN_SCALING", "1.5"))
    corpus = generate_corpus(n=500, seed=11)
    texts = [d.text for d in corpus]
    pipeline = synthetic_demo_pipeline(256, n=400, seed=7,
                                       num_features=4096, device=args.device)
    pipeline.predict(texts[:256])    # warm up off the measured path
    expect = {str(i).encode() for i in range(n_msgs)}

    single, keys1 = _drain(pipeline, n_msgs, 1, texts)
    if sorted(keys1) != sorted(expect):
        print(f"FAIL: 1-worker drain key accounting "
              f"(got {len(keys1)} keys, want {n_msgs} exactly once)")
        return 1
    multi, keys_n = _drain(pipeline, n_msgs, n_workers, texts)
    if sorted(keys_n) != sorted(expect):
        print(f"FAIL: {n_workers}-worker drain key accounting "
              f"(got {len(keys_n)} keys, want {n_msgs} exactly once)")
        return 1

    plan = WorkerDeathPlan(seed=5, kills=1, min_polls=2, max_polls=6)
    chaos, keys_c = _drain(pipeline, n_msgs, n_workers, texts,
                           death_plan=plan)
    dup = len(keys_c) - len(set(keys_c))
    lost = len(expect - set(keys_c))
    if lost or dup or not chaos["deaths"]:
        print(f"FAIL: worker-kill rebalance (lost={lost} dup={dup} "
              f"deaths={chaos['deaths']})")
        return 1

    scaling = (multi["msgs_per_sec"] / single["msgs_per_sec"]
               if single["msgs_per_sec"] else 0.0)
    cores = os.cpu_count() or 1
    report = {
        "device": str(pipeline.device),
        "workers": n_workers,
        "cores": cores,
        "single_worker_msgs_per_s": single["msgs_per_sec"],
        "aggregate_msgs_per_s": multi["msgs_per_sec"],
        "scaling_x": round(scaling, 3),
        "kill": chaos["death_plan"],
        "rebalances": chaos["rebalances"],
        "lease_expirations": chaos["lease_expirations"],
    }
    print(json.dumps(report))
    if cores >= 2 and scaling < min_scaling:
        print(f"FAIL: aggregate {scaling:.2f}x single-worker on {cores} "
              f"cores (want >= {min_scaling}x)")
        return 1
    if cores < 2:
        print(f"note: {cores} core(s) — thread workers cannot parallelize "
              f"compute here; scaling assert skipped, invariants held")
    return 0


if __name__ == "__main__":
    sys.exit(main())
