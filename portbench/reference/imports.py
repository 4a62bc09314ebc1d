"""The benchmark measures the PyTorch port alone: no module of JAX, of its
libraries or of the JAX package may be loaded in a run's process.

Names are compared by their top-level part (before the first dot), whole:
``fraud_detection_tpu_torch`` is the port and passes, ``fraud_detection_tpu``
is the JAX package and fails.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "fraud_detection_tpu"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded module names (``sys.modules`` by default) whose top-level
    name is forbidden, sorted."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
