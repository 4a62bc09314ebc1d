"""Explanation layer — twin of ``fraud_detection_tpu.explain``: pluggable
LLM backends (an OpenAI-compatible HTTP client, a canned backend for tests
and offline runs, the on-device decoder of ``models/llm.py``), a circuit
breaker, a historical-case store and the classification agent that explains
through whichever backend is plugged in."""

from fraud_detection_tpu_torch.explain.agent import FraudAnalysisAgent
from fraud_detection_tpu_torch.explain.backends import (
    BackendError,
    CannedBackend,
    LLMBackend,
    OpenAIChatBackend,
)
from fraud_detection_tpu_torch.explain.circuit import (
    BreakerOpenError,
    CircuitBreakerBackend,
)
from fraud_detection_tpu_torch.explain.history import HistoricalCaseStore
from fraud_detection_tpu_torch.explain.onpod import (OnPodBackend,
                                                     make_stream_explain_hook)
from fraud_detection_tpu_torch.explain.prompts import (
    analysis_prompt,
    historical_insight_prompt,
    label_name,
)

__all__ = [
    "FraudAnalysisAgent",
    "BackendError",
    "BreakerOpenError",
    "CircuitBreakerBackend",
    "CannedBackend",
    "LLMBackend",
    "OpenAIChatBackend",
    "OnPodBackend",
    "make_stream_explain_hook",
    "HistoricalCaseStore",
    "analysis_prompt",
    "historical_insight_prompt",
    "label_name",
]
