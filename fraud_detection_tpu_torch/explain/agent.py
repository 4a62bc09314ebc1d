"""Classification + explanation agent — twin of
``fraud_detection_tpu/explain/agent.py``.

``FraudAnalysisAgent`` scores a dialogue once through the port's
``ServingPipeline.predict_one``, explains it through whichever backend is
plugged in (hosted, local server, on-device, canned), and compares it with
similar past cases from a ``HistoricalCaseStore``. Backend failures degrade
into an ``error`` field instead of raising.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence

from fraud_detection_tpu_torch.explain.backends import BackendError, CannedBackend, LLMBackend
from fraud_detection_tpu_torch.explain.circuit import CircuitBreakerBackend
from fraud_detection_tpu_torch.explain.history import HistoricalCaseStore
from fraud_detection_tpu_torch.explain.prompts import (
    analysis_prompt,
    historical_insight_prompt,
    label_name,
)
from fraud_detection_tpu_torch.models.pipeline import ServingPipeline


@dataclass
class FraudAnalysisAgent:
    """Serving pipeline + LLM backend + optional historical store."""

    pipeline: ServingPipeline
    backend: LLMBackend = field(default_factory=CannedBackend)
    history: Optional[HistoricalCaseStore] = None
    temperature: float = 1.0

    def load_history(self, texts: Sequence[str], labels: Sequence[int]) -> None:
        """Install a historical corpus indexed with the pipeline's own
        featurizer, on the pipeline's device."""
        self.history = HistoricalCaseStore(self.pipeline.featurizer, texts,
                                           labels, device=self.pipeline.device)

    def enable_circuit_breaker(self, *, failure_threshold: int = 5,
                               probe_interval: float = 30.0,
                               clock: Callable[[], float] = time.monotonic,
                               ) -> CircuitBreakerBackend:
        """Wrap the agent's backend in a circuit breaker (explain/circuit.py)
        so a dead endpoint costs one fast ``error`` field per request instead
        of the full timeout x retry budget (the reference paid 90 s x 3 per
        click, agent_api.py:34-42). Idempotent; returns the breaker for
        state inspection. ``classify_and_explain`` needs no change — the
        breaker's fast-fail is a ``BackendError`` and degrades through the
        existing path."""
        if not isinstance(self.backend, CircuitBreakerBackend):
            self.backend = CircuitBreakerBackend(
                self.backend, failure_threshold=failure_threshold,
                probe_interval=probe_interval, clock=clock)
        return self.backend

    def backend_health(self) -> Optional[Dict]:
        """The breaker's snapshot, or None when no breaker is installed."""
        b = self.backend
        return b.snapshot() if isinstance(b, CircuitBreakerBackend) else None

    def predict_and_get_label(self, text: str) -> Dict:
        """Classifier-only result: {prediction, label, confidence}."""
        pred, prob = self.pipeline.predict_one(text)
        return {
            "prediction": pred,
            "label": label_name(pred),
            # p of the predicted class, matching the UI's confidence metric
            "confidence": prob if pred == 1 else 1.0 - prob,
            "probability_scam": prob,
        }

    def classify_and_explain(self, text: str, *,
                             temperature: Optional[float] = None,
                             with_history: bool = True,
                             history_k: int = 3) -> Dict:
        """Classify once, then explain; LLM failures degrade, not crash.

        Returns {prediction, label, confidence, probability_scam, analysis,
        historical_insight?, error?}.
        """
        result = self.predict_and_get_label(text)
        temp = self.temperature if temperature is None else temperature
        try:
            result["analysis"] = self.backend.generate(
                analysis_prompt(text, result["prediction"], result["confidence"]),
                temperature=temp)
        except BackendError as exc:
            result["analysis"] = None
            result["error"] = str(exc)
            return result

        if with_history and self.history is not None and len(self.history):
            cases = self.history.find_similar(text, k=history_k)
            if cases:
                try:
                    result["historical_insight"] = self.backend.generate(
                        historical_insight_prompt(text, cases), temperature=temp)
                    result["similar_cases"] = cases
                except BackendError as exc:
                    result["error"] = str(exc)
        return result
