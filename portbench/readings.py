"""What the metric readers under ``metrics/`` share: each reader is one small
file named after its metric that calls one of these on the run's records,
and returns None where the run recorded nothing to read."""

from __future__ import annotations

from typing import Optional

from arith import BF16_OPS_PER_S


def per_second(rec: dict, key: str) -> Optional[float]:
    """A count recorded over the window, over the window's seconds."""
    if key not in rec or not rec.get("window_s"):
        return None
    return rec[key] / rec["window_s"]


def device_idle_pct(rec: dict) -> Optional[float]:
    """Percent of the profiled window in which no kernel, copy or set ran."""
    prof = rec.get("profile")
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def mfu_pct(rec: dict) -> Optional[float]:
    """Model operations (``flops``) over the seconds they were counted over
    (``flops_s``) at the bf16 dense peak."""
    if not rec.get("flops") or not rec.get("flops_s"):
        return None
    return 100.0 * rec["flops"] / (rec["flops_s"] * BF16_OPS_PER_S)


def slot_occupancy_pct(rec: dict) -> Optional[float]:
    """The busy share of slot-steps between the window's two service
    snapshots: occupancy x decode_steps x slots over decode_steps x slots."""
    a, b = rec.get("snap0"), rec.get("snap1")
    if not a or not b:
        return None
    steps = b["decode_steps"] - a["decode_steps"]
    if steps <= 0:
        return None
    busy = ((b["occupancy"] or 0.0) * b["decode_steps"]
            - (a["occupancy"] or 0.0) * a["decode_steps"])
    return 100.0 * busy / steps
