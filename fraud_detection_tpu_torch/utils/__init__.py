"""Cross-cutting utilities: typed config, logfmt logging, tracing — the
reference's ``fraud_detection_tpu.utils`` names."""

from fraud_detection_tpu_torch.utils.config import (
    AppConfig,
    KafkaConfig,
    LLMConfig,
    ServingConfig,
    load_dotenv,
    parse_env_file,
)
from fraud_detection_tpu_torch.utils.logging import configure, get_logger, kv
from fraud_detection_tpu_torch.utils.tracing import (RateCounter, Tracer,
                                                     device_trace)

__all__ = [
    "AppConfig",
    "KafkaConfig",
    "LLMConfig",
    "ServingConfig",
    "load_dotenv",
    "parse_env_file",
    "configure",
    "get_logger",
    "kv",
    "RateCounter",
    "Tracer",
    "device_trace",
]
