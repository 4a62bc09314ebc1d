"""Slotserve — slot-based continuous-batching on-device explanation service
(twin of ``fraud_detection_tpu.explain.slotserve``).

One persistent KV pool of decode slots (or a paged pool with a shared
prefix); newly flagged rows admit into free slots at iteration boundaries
(no fixed-batch barrier), rows retire per slot at EOS, and every flagged
row is explained or accounted.
"""

from fraud_detection_tpu_torch.explain.slotserve.decode import SlotDecoder
from fraud_detection_tpu_torch.explain.slotserve.service import (
    DROPPED_MARKER,
    UNAVAILABLE_MARKER,
    SlotServeService,
    make_slot_explain_hook,
)

__all__ = [
    "SlotDecoder",
    "SlotServeService",
    "make_slot_explain_hook",
    "DROPPED_MARKER",
    "UNAVAILABLE_MARKER",
]
