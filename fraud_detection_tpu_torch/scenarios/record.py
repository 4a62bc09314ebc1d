"""Trace recordings: serialize a RowTracer's SpanRing to replayable JSONL —
twin of ``fraud_detection_tpu/scenarios/record.py``; the format is the
reference's, so each package reads the other's recordings.

A production-shaped run becomes a regression input: ``serve
--trace-record FILE`` runs the tracer in **record mode** (sample forced to
1.0, plus one compact ``row`` event block per delivered batch carrying
every row's source coordinates — obs/trace.py ``record_rows``) and dumps
the ring at exit through the shared atomic writer, so the file on disk is
never torn. ``scenarios/replay.py`` turns the file back into traffic with
the original inter-batch timing (or time-warped).

Format — one JSON object per line:

* line 1, the header::

      {"format": "fraud_tpu_trace", "version": 1, "worker": "w0",
       "time": <wall>, "complete": true|false, "snapshot": {<trace block>}}

  ``complete`` is the replayability claim: record mode was on, nothing was
  head-sampled away, and the ring dropped zero spans. Replay REFUSES an
  incomplete recording unless forced — a recording with holes would
  silently replay a smaller run and call it regression coverage.
* every further line: one span, exactly ``Span.as_dict()`` —
  ``{"cid", "stage", "start", "duration_ms", "ok", "detail"}``. Row-level
  lines carry the row cid ``<batch>:<partition>:<offset>``; the
  coordinates ARE the row identity (the same coordinates DLQ records
  carry), which is what lets replay reproduce the exact row set without
  recording payload bytes.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from fraud_detection_tpu_torch.utils.atomicio import atomic_write_text

FORMAT = "fraud_tpu_trace"
VERSION = 1

# Stages whose cids are ROW cids (<batch>:<partition>:<offset>); the union
# of their coordinates is the recording's row census.
ROW_STAGES = ("row", "shed", "dlq", "flag")


def render_recording(tracer, *, now: Optional[float] = None) -> str:
    """The JSONL text of ``tracer``'s current ring (header + spans)."""
    snapshot = tracer.snapshot()
    spans = tracer.ring.snapshot()
    complete = (bool(getattr(tracer, "record_rows", False))
                and snapshot["sample"] >= 1.0
                and snapshot["ring_dropped"] == 0)
    header = {
        "format": FORMAT,
        "version": VERSION,
        "worker": snapshot["worker"],
        "time": now,
        "complete": complete,
        "snapshot": snapshot,
    }
    lines = [json.dumps(header)]
    lines.extend(json.dumps(s.as_dict()) for s in spans)
    return "\n".join(lines) + "\n"


def dump_tracer(tracer, path: str, *, now: Optional[float] = None) -> dict:
    """Atomically publish ``tracer``'s recording at ``path``; returns the
    header (with ``spans`` count added) for the caller's exit report.
    Raises OSError-shaped failures as a plain RuntimeError — a requested
    recording that silently vanished would be worse than a loud exit."""
    text = render_recording(tracer, now=now)
    if not atomic_write_text(path, text):
        raise RuntimeError(f"could not write trace recording to {path!r}")
    header = json.loads(text.split("\n", 1)[0])
    header["spans"] = text.count("\n") - 1
    return header


def load_recording(path: str) -> Tuple[dict, List[dict]]:
    """Parse a recording file -> (header, span dicts). Validates the
    format marker; raises ValueError on anything unrecognizable."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path!r} is empty — not a trace recording")
    header = json.loads(lines[0])
    if header.get("format") != FORMAT:
        raise ValueError(
            f"{path!r} is not a {FORMAT} recording "
            f"(format={header.get('format')!r})")
    if header.get("version") != VERSION:
        raise ValueError(
            f"{path!r} has recording version {header.get('version')!r}; "
            f"this build reads version {VERSION}")
    return header, [json.loads(ln) for ln in lines[1:]]


def row_coordinate(cid: str) -> Optional[Tuple[int, int]]:
    """(partition, offset) of a ROW cid; None for batch cids."""
    parts = cid.split(":")
    if len(parts) != 3:
        return None
    try:
        return int(parts[1]), int(parts[2])
    except ValueError:
        return None


def recording_rows(spans: List[dict]) -> List[Tuple[int, int]]:
    """The recording's row census: every distinct (partition, offset)
    seen on a row-stage span, sorted."""
    coords = set()
    for s in spans:
        if s.get("stage") in ROW_STAGES:
            c = row_coordinate(s.get("cid", ""))
            if c is not None:
                coords.add(c)
    return sorted(coords)


def batch_schedule(spans: List[dict]) -> List[dict]:
    """Per-batch replay schedule, in original start order. Each entry:
    ``{"cid", "start", "rows": [(p, o), ...], "flagged": {(p, o), ...}}``.
    Rows attach to their batch through the cid prefix; batches whose poll
    span was dropped (incomplete recordings) still appear, ordered by
    their earliest span."""
    batches: Dict[str, dict] = {}

    def entry(batch_cid: str) -> dict:
        b = batches.get(batch_cid)
        if b is None:
            b = batches[batch_cid] = {"cid": batch_cid, "start": None,
                                      "rows": set(), "flagged": set()}
        return b

    for s in spans:
        cid = s.get("cid", "")
        batch_cid = cid.split(":", 1)[0]
        b = entry(batch_cid)
        start = s.get("start")
        if start is not None and (b["start"] is None or start < b["start"]):
            b["start"] = start
        if s.get("stage") in ROW_STAGES:
            c = row_coordinate(cid)
            if c is not None:
                b["rows"].add(c)
                if s["stage"] == "flag":
                    b["flagged"].add(c)
    out = [b for b in batches.values() if b["rows"]]
    out.sort(key=lambda b: (b["start"] if b["start"] is not None else 0.0,
                            b["cid"]))
    for b in out:
        b["rows"] = sorted(b["rows"])
        b["flagged"] = set(b["flagged"])
    return out
