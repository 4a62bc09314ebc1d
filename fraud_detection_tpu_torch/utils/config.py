"""Explanation-backend settings from the environment — the ``LLMConfig``
part of ``fraud_detection_tpu/utils/config.py`` (the serve CLI's
``--explain`` temperature rule and its ``deepseek`` backend read it). The
same variable names:
``DEEPSEEK_API_KEY``, ``LLM_BASE_URL``, ``LLM_MODEL``, ``LLM_TEMPERATURE``,
``LLM_TIMEOUT``, ``LLM_MAX_ATTEMPTS``."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping, Optional


@dataclass(frozen=True)
class LLMConfig:
    api_key: Optional[str] = None
    base_url: str = "https://api.deepseek.com/v1"
    model: str = "deepseek-chat"
    temperature: float = 1.0
    timeout: float = 90.0
    max_attempts: int = 3

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "LLMConfig":
        """Parse the variables once; a malformed number raises ValueError."""
        e = os.environ if env is None else env
        return cls(
            api_key=e.get("DEEPSEEK_API_KEY") or None,
            base_url=e.get("LLM_BASE_URL", "https://api.deepseek.com/v1"),
            model=e.get("LLM_MODEL", "deepseek-chat"),
            temperature=float(e.get("LLM_TEMPERATURE", "1.0")),
            timeout=float(e.get("LLM_TIMEOUT", "90")),
            max_attempts=int(e.get("LLM_MAX_ATTEMPTS", "3")),
        )

    def make_backend(self, **kw):
        """The OpenAI-compatible HTTP backend these settings describe (no
        request is made until the backend is asked for an explanation)."""
        from fraud_detection_tpu_torch.explain.backends import OpenAIChatBackend

        return OpenAIChatBackend(base_url=self.base_url, model=self.model,
                                 api_key=self.api_key, timeout=self.timeout,
                                 max_attempts=self.max_attempts, **kw)
