"""How an analysis request reaches the explanation model: a frozen copy of the
port's prompt templates (``explain/prompts.py`` ``analysis_prompt``,
``explain/backends.py`` ``frame_prompt`` and its system prompt,
``explain/onpod.py`` ``flatten_chat``), and of its byte tokenizer's ids.

The benchmark builds every prompt from this copy, so that its inputs do not
move when the program's templates do, and tokenizes it itself for the
reference.
"""

from __future__ import annotations

import numpy as np

SYSTEM_PROMPT = (
    "You are a fraud-analysis assistant. You examine phone-call transcripts "
    "that a classifier has flagged, explain the signals behind the decision, "
    "and recommend concrete next steps. Be precise and structured."
)
ANALYSIS_PREAMBLE = (
    "A phone-call transcript was classified by a fraud-detection model.\n")
LABEL_NAMES = {0: "Normal Conversation", 1: "Potential Scam"}
BOS, EOS = 256, 257


def analysis_prompt(dialogue: str, prediction: int, confidence: float) -> str:
    return (
        ANALYSIS_PREAMBLE +
        f"Predicted class: {LABEL_NAMES[int(prediction)]} "
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


def framed(prompt: str) -> str:
    """The chat framing of one user prompt under the system prompt, as one
    plain-text prompt."""
    return (f"<|system|>\n{SYSTEM_PROMPT}\n<|user|>\n{prompt}\n"
            "<|assistant|>\n")


def shared_prefix() -> str:
    """The text every framed analysis prompt opens with, through the
    preamble's first line."""
    return f"<|system|>\n{SYSTEM_PROMPT}\n<|user|>\n{ANALYSIS_PREAMBLE}"


def tokens(text: str, width: int) -> np.ndarray:
    """BOS and the text's UTF-8 bytes, the head kept to ``width`` tokens."""
    ids = [BOS] + list(text.encode("utf-8"))
    return np.asarray(ids[:width], np.int32)
