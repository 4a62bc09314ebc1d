"""Scenario traffic — twin of ``fraud_detection_tpu.scenarios``; so far only
the seeded drift pool (``traffic.drift_scam_pool``)."""

from fraud_detection_tpu_torch.scenarios.traffic import (derive_seed,
                                                         drift_scam_pool)

__all__ = ["derive_seed", "drift_scam_pool"]
