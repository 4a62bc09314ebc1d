"""The finding model of the analysis package — the port's own copy of the
part of ``fraud_detection_tpu/analysis/core.py`` that trace conformance
reports through (rule FC505)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

#: Rule catalog: id -> (name, one-line summary); only the rule this
#: package reports.
RULES: Dict[str, tuple] = {
    "FC505": ("trace-nonconformance",
              "a recorded control-lane run is not a valid word of the "
              "declared role state machines (unknown transition, "
              "out-of-order step, seq gap, or stale-term record)"),
}


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative posix path
    line: int
    message: str

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule}"
                f"[{RULES[self.rule][0]}]: {self.message}")
