"""device_idle: the share of the profiled window with no kernel, copy or set
running on the card."""
from readings import device_idle_pct


def read(rec):
    return device_idle_pct(rec)
