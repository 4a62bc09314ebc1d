"""Pluggable LLM backends for the explanation layer — twin of
``fraud_detection_tpu/explain/backends.py``.

One OpenAI-compatible ``/chat/completions`` client covers hosted DeepSeek
and local servers (LM Studio, vLLM, llama.cpp); ``CannedBackend`` replays
fixed replies for tests and offline runs; the on-device model
(``explain/onpod.py``) plugs into the same small interface. Pure Python:
``requests`` is imported only when the HTTP client is built without an
injected transport.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Protocol, Sequence

ChatMessage = Dict[str, str]  # {"role": "system"|"user"|"assistant", "content": ...}

DEFAULT_SYSTEM_PROMPT = (
    "You are a fraud-analysis assistant. You examine phone-call transcripts "
    "that a classifier has flagged, explain the signals behind the decision, "
    "and recommend concrete next steps. Be precise and structured."
)


class LLMBackend(Protocol):
    """Minimal surface every explanation backend implements."""

    def chat(self, messages: Sequence[ChatMessage], *, temperature: float = 1.0,
             max_tokens: int = 1000) -> str:
        """Run one chat turn and return the assistant text."""
        ...

    def generate(self, prompt: str, *, temperature: float = 1.0,
                 max_tokens: int = 1000, system: Optional[str] = None) -> str:
        """Single-prompt convenience over ``chat``."""
        ...


class BackendError(RuntimeError):
    """Raised when a backend exhausts retries or gets a malformed response."""


def frame_prompt(prompt: str, system: Optional[str] = None) -> List[ChatMessage]:
    """THE message assembly for a bare prompt — single and batched paths
    share it so their framed inputs cannot drift apart (the parity
    OnPodBackend.generate_batch documents)."""
    return [{"role": "system",
             "content": system if system is not None else DEFAULT_SYSTEM_PROMPT},
            {"role": "user", "content": prompt}]


@dataclass
class _GenerateMixin:
    def generate(self, prompt: str, *, temperature: float = 1.0,
                 max_tokens: int = 1000, system: Optional[str] = None) -> str:
        return self.chat(frame_prompt(prompt, system),
                         temperature=temperature, max_tokens=max_tokens)


@dataclass
class OpenAIChatBackend(_GenerateMixin):
    """Client for any OpenAI-compatible ``/chat/completions`` endpoint.

    Covers both of the reference's transports:

    * hosted DeepSeek — ``OpenAIChatBackend.deepseek(api_key)``
      (base https://api.deepseek.com/v1, model deepseek-chat, matching
      utils/agent_api.py:34-42 semantics: 90 s timeout, 3 attempts with
      exponential backoff on timeout/connection errors), and
    * any local OpenAI-compatible server (LM Studio / vLLM / llama.cpp) —
      ``OpenAIChatBackend(base_url=..., model=...)``
      (the deepseek_chat_ui.py:7-12 pattern).

    ``transport`` is injectable (signature of ``requests.post``) so tests run
    with zero network; the default lazily imports requests.
    """

    base_url: str
    model: str
    api_key: Optional[str] = None
    timeout: float = 90.0
    max_attempts: int = 3
    backoff_base: float = 2.0
    backoff_max: float = 10.0
    transport: Optional[Callable] = None
    sleep: Callable[[float], None] = field(default=None)  # injectable for tests

    def __post_init__(self):
        if self.transport is None:
            import requests

            self.transport = requests.post
        if self.sleep is None:
            import time

            self.sleep = time.sleep

    @classmethod
    def deepseek(cls, api_key: str, **kw) -> "OpenAIChatBackend":
        return cls(base_url="https://api.deepseek.com/v1",
                   model="deepseek-chat", api_key=api_key, **kw)

    def _retryable(self, exc: Exception) -> bool:
        if isinstance(exc, (TimeoutError, ConnectionError)):
            return True
        try:
            import requests

            return isinstance(exc, (requests.exceptions.Timeout,
                                    requests.exceptions.ConnectionError))
        except ImportError:  # transport injected, requests absent
            return False

    def chat(self, messages: Sequence[ChatMessage], *, temperature: float = 1.0,
             max_tokens: int = 1000) -> str:
        url = self.base_url.rstrip("/") + "/chat/completions"
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        payload = {
            "model": self.model,
            "messages": list(messages),
            "temperature": temperature,
            "max_tokens": max_tokens,
        }
        last_exc: Optional[Exception] = None
        for attempt in range(self.max_attempts):
            try:
                resp = self.transport(url, headers=headers, json=payload,
                                      timeout=self.timeout)
                resp.raise_for_status()
            except Exception as exc:  # transport-level
                if not self._retryable(exc) or attempt == self.max_attempts - 1:
                    raise BackendError(f"LLM request failed: {exc}") from exc
                last_exc = exc
                self.sleep(min(self.backoff_max, self.backoff_base * (2 ** attempt)))
                continue
            try:
                data = resp.json()
                return data["choices"][0]["message"]["content"]
            except (KeyError, IndexError, TypeError, ValueError) as exc:
                raise BackendError(f"malformed chat-completions response: {exc}") from exc
        raise BackendError(f"LLM request failed after {self.max_attempts} attempts: {last_exc}")


@dataclass
class CannedBackend(_GenerateMixin):
    """Deterministic backend for tests, demos, and offline runs.

    Replays ``responses`` in order (sticking on the last one) and records
    every call in ``calls`` so tests can assert on prompts and parameters.
    """

    responses: List[str] = field(default_factory=lambda: ["[offline analysis unavailable]"])
    calls: List[dict] = field(default_factory=list)

    def chat(self, messages: Sequence[ChatMessage], *, temperature: float = 1.0,
             max_tokens: int = 1000) -> str:
        idx = min(len(self.calls), len(self.responses) - 1)
        self.calls.append({"messages": list(messages), "temperature": temperature,
                          "max_tokens": max_tokens})
        return self.responses[idx]
