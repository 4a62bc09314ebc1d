"""Atomic file publication: tmp + ``os.replace`` — twin of
``fraud_detection_tpu/utils/atomicio.py``.

The temp name is unique per process AND per call (pid + a counter), so two
writers publishing the same path can only ever rename a fully written file
into place; the last rename wins. Failures are reported by returning False
(the orphaned temp file is unlinked best-effort), so a caller decides
whether a failed write is fatal: the training CLI's ``--metrics-out``
treats it as such.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Optional

_seq = itertools.count()


def _tmp_name(path: str) -> str:
    """Unique-per-writer temp path in the target's directory (same
    filesystem, so the final ``os.replace`` stays atomic)."""
    return f"{path}.{os.getpid()}.{next(_seq)}.tmp"


def atomic_write_text(path: str, text: str) -> bool:
    """Publish ``text`` at ``path`` atomically; False on any OS failure."""
    tmp = _tmp_name(path)
    try:
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
        return True
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def atomic_write_json(path: str, obj, *, indent: Optional[int] = 2) -> bool:
    """Publish ``obj`` as JSON at ``path`` atomically; False on failure (OS
    errors and unserializable objects)."""
    try:
        text = json.dumps(obj, indent=indent)
    except (TypeError, ValueError):
        return False
    return atomic_write_text(path, text)
