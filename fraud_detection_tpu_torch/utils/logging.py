"""Structured logging: stdlib logging with a logfmt-style formatter
(``ts level logger msg ...``), configured once per process, level from
FRAUD_TPU_LOG_LEVEL. Twin of ``fraud_detection_tpu/utils/logging.py``."""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Any

_ROOT = "fraud_detection_tpu_torch"
_CONFIGURED = False


class LogfmtFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
        base = (f"ts={ts}.{int(record.msecs):03d}Z level={record.levelname.lower()} "
                f"logger={record.name} msg={_quote(record.getMessage())}")
        extra = getattr(record, "kv", None)
        if extra:
            base += "".join(f" {k}={_quote(v)}" for k, v in extra.items())
        if record.exc_info:
            base += f" exc={_quote(self.formatException(record.exc_info))}"
        return base


def _quote(value: Any) -> str:
    s = str(value)
    if any(c in s for c in ' "=\n'):
        return '"' + s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n") + '"'
    return s


def configure() -> None:
    """Install the logfmt handler on the package root logger (idempotent)."""
    global _CONFIGURED
    if _CONFIGURED:
        return
    root = logging.getLogger(_ROOT)
    root.handlers.clear()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(LogfmtFormatter())
    root.addHandler(handler)
    root.setLevel(os.getenv("FRAUD_TPU_LOG_LEVEL", "INFO").upper())
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str = _ROOT) -> logging.Logger:
    configure()
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)


def kv(**fields) -> dict:
    """Structured-fields adapter: ``log.info("scored", extra=kv(batch=32))``."""
    return {"kv": fields}
