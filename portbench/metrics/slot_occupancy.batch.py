"""slot_occupancy.batch: the slot lane's busy share of slot-steps in the
window, from SlotServeService.snapshot() at its two ends."""
from readings import slot_occupancy_pct


def read(rec):
    return slot_occupancy_pct(rec)
