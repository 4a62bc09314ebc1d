"""Prompt templates for the explanation layer — twin of
``fraud_detection_tpu/explain/prompts.py`` (the same strings, byte for
byte): the structured analysis request for one classified dialogue, the
comparison against similar past cases, and the display names of predicted
classes (the ``label`` field of output frames).
"""

from __future__ import annotations

from typing import Sequence, Tuple

LABEL_NAMES = {0: "Normal Conversation", 1: "Potential Scam"}

# The static first line every analysis prompt opens with. Named so the
# slotserve shared-prefix cache (explain/slotserve/) can split prompts at
# the exact template/payload boundary without duplicating the string.
ANALYSIS_PREAMBLE = (
    "A phone-call transcript was classified by a fraud-detection model.\n")


def label_name(prediction: int) -> str:
    return LABEL_NAMES.get(int(prediction), str(prediction))


def analysis_prompt(dialogue: str, prediction: int, confidence: float) -> str:
    """Structured explanation request for one classified dialogue."""
    return (
        ANALYSIS_PREAMBLE +
        f"Predicted class: {label_name(prediction)} "
        f"(confidence {confidence:.1%}).\n\n"
        "Transcript:\n"
        f"---\n{dialogue}\n---\n\n"
        "Provide a structured analysis with exactly these sections:\n"
        "1. Content examination — quote the specific phrases or patterns in "
        "the transcript that support or contradict the predicted class "
        "(urgency tactics, requests for payment or personal data, "
        "impersonation of institutions, pressure to stay on the line).\n"
        "2. Classification assessment — state whether you agree with the "
        "model's call and how the stated confidence squares with the "
        "evidence.\n"
        "3. Recommended actions — concrete next steps for the recipient "
        "and, if this is a scam, how to report it.\n"
    )


def historical_insight_prompt(dialogue: str,
                              cases: Sequence[Tuple[str, int, float]]) -> str:
    """Comparison against similar past cases.

    ``cases`` rows are (text, label, similarity in [0,1]).
    """
    lines = []
    for i, (text, label, sim) in enumerate(cases, 1):
        snippet = text if len(text) <= 400 else text[:400] + "…"
        lines.append(f"Case {i} [{label_name(label)}, similarity {sim:.2f}]: {snippet}")
    joined = "\n".join(lines) if lines else "(no similar cases on record)"
    return (
        "Compare the new transcript below against these similar historical "
        "cases and say what the pattern suggests — recurring script, shared "
        "tactics, or notable differences.\n\n"
        f"Historical cases:\n{joined}\n\n"
        f"New transcript:\n---\n{dialogue}\n---\n"
    )
