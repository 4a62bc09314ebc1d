"""Feedback label lane: the wire format delayed ground truth rides on —
twin of ``fraud_detection_tpu/stream/feedback.py``, byte for byte the same
records.

The closed learning loop (learn/, docs/online_learning.md) consumes a
FEEDBACK TOPIC of delayed ground-truth labels — chargeback outcomes, manual
review verdicts, customer disputes — each keyed by the SOURCE COORDINATE of
the scored row it judges (topic, partition, offset: the same coordinates
DLQ records and trace ids carry, stream/engine.py ``_dlq_record``). A label
that can name its row exactly is a label that can be joined exactly; joins
by message key or text hash are ambiguous under hot-key skew and replays.

This module owns only the record format. Transport is the existing
``Consumer``/``Producer`` protocol (stream/broker.py), which carries these
bytes unchanged, so the label lane needs no transport code of its own: the
learn loop polls any Consumer, and a ground-truth producer writes through
any Producer.

Record schema (JSON, one label per message)::

    {"source": {"topic": "...", "partition": 0, "offset": 1234},
     "label": 1}

``label`` is the ground-truth class (0 = legit, 1 = scam for the binary
fraud scorer; any small int for multiclass trees). Malformed records parse
to ``None`` and are COUNTED by the consumer (learn/store.py accounting) —
never raised, never silently skipped.
"""

from __future__ import annotations

import json
from typing import NamedTuple, Optional

#: (topic, partition, offset) — the coordinate key the window store joins on.
Coordinate = tuple


class LabelRecord(NamedTuple):
    """One parsed feedback label."""

    key: Coordinate     # (topic, partition, offset) of the scored row
    label: int          # ground-truth class


def label_record(topic: str, partition: int, offset: int,
                 label: int) -> bytes:
    """Serialize one feedback label (the producer side — scenario oracle,
    review tooling, chargeback importers)."""
    return json.dumps(
        {"source": {"topic": topic, "partition": int(partition),
                    "offset": int(offset)},
         "label": int(label)},
        sort_keys=True).encode()


def parse_label(value: bytes) -> Optional[LabelRecord]:
    """Parse one feedback message; ``None`` for anything malformed (bad
    JSON, missing/mistyped fields) — the caller counts it, the lane never
    dies on a poison label."""
    try:
        obj = json.loads(value)
    except ValueError:
        return None
    if not isinstance(obj, dict):
        return None
    src = obj.get("source")
    label = obj.get("label")
    if not isinstance(src, dict) or isinstance(label, bool) \
            or not isinstance(label, int):
        return None
    topic = src.get("topic")
    partition = src.get("partition")
    offset = src.get("offset")
    if not isinstance(topic, str) or isinstance(partition, bool) \
            or isinstance(offset, bool) \
            or not isinstance(partition, int) or not isinstance(offset, int):
        return None
    return LabelRecord((topic, partition, offset), label)
