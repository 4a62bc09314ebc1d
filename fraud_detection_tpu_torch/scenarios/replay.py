"""Recorded-trace replay: turn a trace recording back into traffic — twin of
``fraud_detection_tpu/scenarios/replay.py``.

A recording (scenarios/record.py) carries, per delivered batch, its start
time and every row's source coordinates — enough to regenerate the run as
a load shape: the same batches, the same row counts, the same inter-batch
gaps (or time-warped through ``time_scale``), and the same flagged-row mix
(rows the original run flagged replay with scam-family text, so the
explain/annotation lanes see the same pressure). Each replayed row is
keyed by its original source coordinate ``<partition>:<offset>`` — the
row's identity in the recording — so after the replay run drains, the
output key multiset must equal the recording's row census EXACTLY
(zero-loss accounting through the whole pipeline, surfaced by the CLI's
exit code).

CLI::

    python -m fraud_detection_tpu_torch.scenarios.replay recording.jsonl \
        [--time-scale 0.0] [--batch-size 1024] [--force] [--device cuda]

exits 0 when the replayed key set reproduces the recording exactly,
1 otherwise. ``--time-scale 0`` (default) is warp mode: the schedule
replays as fast as the engine drains it; 1.0 replays the original pacing.
The replaying pipeline is trained on ``--device`` (default the card; the
CLI raises without one unless ``--device cpu`` is given).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Tuple

from fraud_detection_tpu_torch.scenarios.clock import ScenarioClock, derive_seed
from fraud_detection_tpu_torch.scenarios.record import (batch_schedule,
                                                  load_recording,
                                                  recording_rows)
from fraud_detection_tpu_torch.scenarios.traffic import TrafficEvent, _text_pools


def coordinate_key(coord: Tuple[int, int]) -> bytes:
    """The replayed row's broker key — its recorded source coordinate."""
    return f"{coord[0]}:{coord[1]}".encode()


def replay_events(header: dict, spans: List[dict], *,
                  seed: int = 0) -> List[TrafficEvent]:
    """Synthesize the recording's traffic timeline. Deterministic for a
    given (recording, seed): replayed payload text derives from the row's
    coordinates, not from any call-order rng."""
    schedule = batch_schedule(spans)
    legit_pool, scam_pool = _text_pools(derive_seed(seed, "replay-texts"))
    t0 = min((b["start"] for b in schedule if b["start"] is not None),
             default=0.0)
    events: List[TrafficEvent] = []
    seen = set()    # a chaos-replayed row can appear in an aborted batch
                    # AND its re-drive — replay each coordinate ONCE, at
                    # its first appearance
    for b in schedule:
        t = max(0.0, (b["start"] or t0) - t0)
        for p, o in b["rows"]:
            if (p, o) in seen:
                continue
            seen.add((p, o))
            flagged = (p, o) in b["flagged"]
            pool = scam_pool if flagged else legit_pool
            text = pool[(p * 8191 + o) % len(pool)]
            value = json.dumps(
                {"text": text, "id": f"{p}:{o}",
                 "replay": header.get("worker", "w0")},
                sort_keys=True).encode()
            events.append(TrafficEvent(round(t, 6), value,
                                       coordinate_key((p, o)),
                                       "scam" if flagged else "legit"))
    return events


def run_replay(recording_path: str, pipeline, *, time_scale: float = 0.0,
               batch_size: int = 1024, force: bool = False,
               seed: int = 0) -> dict:
    """Replay a recording against a fresh in-process engine; returns the
    machine-readable report (``keys_exact`` is the regression verdict)."""
    from fraud_detection_tpu_torch.stream import InProcessBroker, StreamingClassifier

    header, spans = load_recording(recording_path)
    if not header.get("complete") and not force:
        raise ValueError(
            f"{recording_path!r} is not a complete recording (record mode "
            f"off, sampled, or ring overflowed: "
            f"dropped={header.get('snapshot', {}).get('ring_dropped')}) — "
            "an exact replay is impossible; pass force=True to replay the "
            "surviving subset anyway")
    events = replay_events(header, spans, seed=seed)
    coords = recording_rows(spans)
    expected = sorted(coordinate_key(c) for c in coords)

    clock = ScenarioClock(seed, time_scale=time_scale)
    max_part = max((p for p, _ in coords), default=2)
    broker = InProcessBroker(num_partitions=max(3, max_part + 1))
    from fraud_detection_tpu_torch.scenarios.traffic import TrafficFeeder

    feeder = TrafficFeeder(broker.producer(), "replay-in", events, clock)
    engine = StreamingClassifier(
        pipeline, broker.consumer(["replay-in"], "replay"),
        broker.producer(), "replay-out", batch_size=batch_size,
        max_wait=0.02)
    # The engine must outlast the replay's longest quiet stretch, or a
    # paced replay of a bursty recording would idle-exit mid-schedule.
    gaps = [b - a for a, b in zip([e.t for e in events],
                                  [e.t for e in events][1:])]
    idle = max(5.0, 2.0 * time_scale * max(gaps, default=0.0))
    t0 = time.perf_counter()
    feeder.start()
    stats = engine.run(max_messages=len(events), idle_timeout=idle)
    feeder.join(timeout=60.0)
    engine.consumer.close()
    wall = time.perf_counter() - t0
    if feeder.error is not None:
        raise feeder.error

    got = sorted(m.key for m in broker.messages("replay-out"))
    missing = len(set(expected) - set(got))
    extra = len(got) - len(set(got) & set(expected))
    return {
        "recording": {"path": recording_path,
                      "worker": header.get("worker"),
                      "complete": bool(header.get("complete")),
                      "spans": len(spans)},
        "rows": len(coords),
        "batches": len(batch_schedule(spans)),
        "fed": feeder.fed,
        "keys_exact": got == expected,
        "missing": missing,
        "duplicated_or_extra": extra,
        "time_scale": time_scale,
        "wall_s": round(wall, 3),
        "stats": stats.as_dict(),
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Replay a serve --trace-record recording against a "
                    "fresh in-process engine and verify the row key set "
                    "reproduces exactly (docs/scenarios.md).")
    ap.add_argument("recording", help="JSONL recording path "
                                      "(serve --trace-record FILE)")
    ap.add_argument("--time-scale", type=float, default=0.0,
                    help="0 = warp (as fast as the engine drains; "
                         "default), 1.0 = original pacing, 0.5 = 2x speed")
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--force", action="store_true",
                    help="replay an INCOMPLETE recording's surviving "
                         "subset (keys_exact then covers the subset only)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for the synthesized payload texts")
    ap.add_argument("--device", default="cuda",
                    help="torch device the replaying pipeline trains and "
                         "serves on (default cuda; 'cpu' runs the plain "
                         "torch versions)")
    args = ap.parse_args(argv)
    if args.time_scale < 0:
        raise SystemExit(f"--time-scale must be >= 0, got {args.time_scale}")
    if args.batch_size < 1:
        raise SystemExit(f"--batch-size must be >= 1, got {args.batch_size}")

    from fraud_detection_tpu_torch.models.pipeline import synthetic_demo_pipeline

    pipeline = synthetic_demo_pipeline(args.batch_size, device=args.device)
    try:
        report = run_replay(args.recording, pipeline,
                            time_scale=args.time_scale,
                            batch_size=args.batch_size, force=args.force,
                            seed=args.seed)
    except (ValueError, OSError) as e:
        raise SystemExit(str(e))
    print(json.dumps(report))
    return 0 if report["keys_exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
