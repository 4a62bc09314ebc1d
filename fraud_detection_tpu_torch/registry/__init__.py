"""Model lifecycle — twin of ``fraud_detection_tpu/registry/``:

  registry.py   filesystem model registry — versioned dirs, atomic publish,
                content-hash verification, poll-based watch, JSONL audit log
  hotswap.py    HotSwapPipeline — RCU-style zero-downtime model swap with
                pre-warming off the hot path (on a stream of its own)
  shadow.py     ShadowScorer — async candidate scoring with divergence stats
                (agreement, mean |Δp|, flag-rate delta, PSI)
  promote.py    PromotionPolicy + LifecycleController — auto promote/reject
                staged candidates, explicit rollback, audited transitions
"""

from fraud_detection_tpu_torch.registry.hotswap import HotSwapPipeline
from fraud_detection_tpu_torch.registry.promote import (LifecycleController,
                                                        PromotionDecision,
                                                        PromotionPolicy)
from fraud_detection_tpu_torch.registry.registry import (ModelRegistry,
                                                         ModelVersion,
                                                         RegistryError,
                                                         RegistryIntegrityError)
from fraud_detection_tpu_torch.registry.shadow import ShadowScorer

__all__ = ["HotSwapPipeline", "LifecycleController", "ModelRegistry",
           "ModelVersion", "PromotionDecision", "PromotionPolicy",
           "RegistryError", "RegistryIntegrityError", "ShadowScorer"]
