"""Display names for predicted classes (the ``label`` field of output
frames) — twin of ``label_name`` in ``fraud_detection_tpu/explain/prompts.py``."""

from __future__ import annotations

LABEL_NAMES = {0: "Normal Conversation", 1: "Potential Scam"}


def label_name(prediction: int) -> str:
    return LABEL_NAMES.get(int(prediction), str(prediction))
