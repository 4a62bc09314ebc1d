"""Model registry — twin of ``fraud_detection_tpu/registry/`` (the
filesystem registry only: versioned dirs, atomic publish, content-hash
verification, poll-based watch, JSONL audit log). Hot swap, shadow scoring
and promotion are not ported yet (ROADMAP.md Queue 1 item 5)."""

from fraud_detection_tpu_torch.registry.registry import (ModelRegistry,
                                                         ModelVersion,
                                                         RegistryError,
                                                         RegistryIntegrityError)

__all__ = ["ModelRegistry", "ModelVersion", "RegistryError",
           "RegistryIntegrityError"]
