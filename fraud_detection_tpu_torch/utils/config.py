"""Configuration: typed dataclasses over environment variables and ``.env``
files — twin of ``fraud_detection_tpu/utils/config.py``.

The same variable names as the reference deployment (``DEEPSEEK_API_KEY``,
``KAFKA_BOOTSTRAP_SERVERS``, ``KAFKA_INPUT_TOPIC``, ``KAFKA_OUTPUT_TOPIC``,
``KAFKA_CONSUMER_GROUP``, ``KAFKA_SECURITY_PROTOCOL``, ``KAFKA_USERNAME``,
``KAFKA_PASSWORD``; ``LLM_*`` and ``FRAUD_*`` for the settings it hard-codes),
parsed once into frozen dataclasses that every layer takes as an argument.
``.env`` files are read from two places (the repository root and
``utils/``), and variables already in the environment win. python-dotenv
is not a dependency: the parser covers the subset the reference's files
use (KEY=VALUE, comments, quotes, an ``export`` prefix).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence


def parse_env_file(path: "str | Path") -> Dict[str, str]:
    """Parse a .env file: KEY=VALUE lines, '#' comments, optional quotes,
    optional 'export ' prefix. Returns {} for a missing file."""
    out: Dict[str, str] = {}
    p = Path(path)
    if not p.is_file():
        return out
    for raw in p.read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        if line.startswith("export "):
            line = line[len("export "):]
        key, _, value = line.partition("=")
        key = key.strip()
        value = value.strip()
        if len(value) >= 2 and value[0] == value[-1] and value[0] in "\"'":
            value = value[1:-1]
        elif " #" in value:
            # an unquoted value ends at its inline comment
            value = value.split(" #", 1)[0].rstrip()
        if key:
            out[key] = value
    return out


def load_dotenv(paths: Sequence["str | Path"] = (".env", "utils/.env"),
                *, override: bool = False,
                environ: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Load .env files into the process environment (or ``environ``), in
    order; a variable already set wins unless ``override``. Returns what
    was applied."""
    env = os.environ if environ is None else environ
    applied: Dict[str, str] = {}
    for path in paths:
        for k, v in parse_env_file(path).items():
            if override or k not in env:
                env[k] = v
                applied[k] = v
    return applied


@dataclass(frozen=True)
class KafkaConfig:
    """Kafka settings with the reference deployment's defaults. The clients
    built from them (``stream/kafka.py``) read from the earliest offset,
    commit by hand, and add the SASL_SSL block when the protocol asks."""

    bootstrap_servers: str = "localhost:9092"
    input_topic: str = "customer-dialogues-raw"
    output_topic: str = "dialogues-classified"
    consumer_group: str = "dialogue-classifier-group"
    security_protocol: Optional[str] = None  # e.g. SASL_SSL
    username: Optional[str] = None
    password: Optional[str] = None

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "KafkaConfig":
        e = os.environ if env is None else env
        return cls(
            bootstrap_servers=e.get("KAFKA_BOOTSTRAP_SERVERS", "localhost:9092"),
            input_topic=e.get("KAFKA_INPUT_TOPIC", "customer-dialogues-raw"),
            output_topic=e.get("KAFKA_OUTPUT_TOPIC", "dialogues-classified"),
            consumer_group=e.get("KAFKA_CONSUMER_GROUP",
                                 "dialogue-classifier-group"),
            security_protocol=e.get("KAFKA_SECURITY_PROTOCOL") or None,
            username=e.get("KAFKA_USERNAME") or None,
            password=e.get("KAFKA_PASSWORD") or None,
        )


@dataclass(frozen=True)
class LLMConfig:
    """Explanation-backend settings (the serve CLI's ``--explain``
    temperature rule and its ``deepseek`` backend read them)."""

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


@dataclass(frozen=True)
class ServingConfig:
    """Micro-batching settings of the serve path (the reference scores row
    by row and has none)."""

    model_path: str = ""
    batch_size: int = 1024
    max_wait: float = 0.05

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "ServingConfig":
        e = os.environ if env is None else env
        return cls(
            model_path=e.get("FRAUD_MODEL_PATH", ""),
            batch_size=int(e.get("FRAUD_BATCH_SIZE", "1024")),
            max_wait=float(e.get("FRAUD_MAX_WAIT", "0.05")),
        )


@dataclass(frozen=True)
class AppConfig:
    kafka: KafkaConfig = field(default_factory=KafkaConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None,
                 dotenv_paths: Optional[Sequence[str]] = None) -> "AppConfig":
        """All three from ``env`` (the process environment by default),
        after loading ``dotenv_paths`` into the process environment."""
        if dotenv_paths is not None:
            load_dotenv(dotenv_paths)
        return cls(kafka=KafkaConfig.from_env(env),
                   llm=LLMConfig.from_env(env),
                   serving=ServingConfig.from_env(env))
