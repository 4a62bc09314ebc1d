"""Dataset loading + cleaning with the reference's exact semantics — twin
of ``fraud_detection_tpu/data/loader.py``.

Replicates ``load_and_clean_data`` (fraud_detection_spark.py:30-45) without
a SparkSession: 4-column schema (dialogue, personality, type, labels — all
strings), rows kept only when trimmed ``labels`` is "0" or "1" (then cast to
a number), ``clean_text`` = lowercase + strip of everything outside
``[a-zA-Z ]``, and rows with empty ``clean_text`` dropped.

Local files only: the reference streams the CSV from HuggingFace
(``REFERENCE_DATASET_URL``); this loader never touches the network, so a
URL raises with a pointer to downloading the file.

Parity notes: the empty-``clean_text`` drop is a training-side filter (the
serving path scores whatever arrives); "personality" and "type" ride along
untouched.
"""

from __future__ import annotations

import csv
import io
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

from fraud_detection_tpu_torch.featurize.text import clean_text

REFERENCE_DATASET_URL = (
    "https://huggingface.co/datasets/BothBosu/multi-agent-scam-conversation/"
    "raw/main/agent_conversation_all.csv")

#: Reference schema, in column order (fraud_detection_spark.py:32-37).
SCHEMA = ("dialogue", "personality", "type", "labels")


@dataclass
class DialogueRow:
    dialogue: str
    label: int                      # 0 | 1 (reference casts "0"/"1" to double)
    clean_text: str                 # lowercase, [a-zA-Z ] only
    personality: Optional[str] = None
    kind: Optional[str] = None      # the reference's "type" column

    @property
    def text(self) -> str:
        """Raw dialogue — alias so [(row.text, row.label)] code is uniform
        with data.synthetic.Dialogue."""
        return self.dialogue


def clean_rows(rows: Sequence[dict], drop_empty: bool = True) -> List[DialogueRow]:
    """Apply the reference's filter/cast/clean chain to raw CSV dicts."""
    out: List[DialogueRow] = []
    for r in rows:
        raw_label = (r.get("labels") or "").strip()
        if raw_label not in ("0", "1"):
            continue  # fraud_detection_spark.py:40 — trim + isin filter
        dialogue = r.get("dialogue") or ""
        cleaned = clean_text(dialogue)
        if drop_empty and cleaned == "":
            # :45 — filter(clean_text != ""): only the exact empty string
            # drops; an all-spaces clean_text survives.
            continue
        out.append(DialogueRow(
            dialogue=dialogue,
            label=int(raw_label),
            clean_text=cleaned,
            personality=r.get("personality"),
            kind=r.get("type"),
        ))
    return out


def load_dialogue_csv(source: Union[str, io.TextIOBase],
                      drop_empty: bool = True) -> List[DialogueRow]:
    """Load + clean the dialogue dataset from a local path or a file
    object. URLs are refused: download the CSV and pass its path."""
    if isinstance(source, io.TextIOBase):
        return clean_rows(list(csv.DictReader(source)), drop_empty)
    if isinstance(source, str) and source.startswith(("http://", "https://")):
        raise ValueError(
            f"{source}: this loader reads local files only; download the CSV "
            "and pass its local path")
    if not os.path.exists(source):
        raise FileNotFoundError(
            f"{source} not found (the reference dataset is not vendored; "
            f"fetch {REFERENCE_DATASET_URL} and pass its path)")
    with open(source, newline="", encoding="utf-8") as fh:
        return clean_rows(list(csv.DictReader(fh)), drop_empty)


def as_xy(rows: Sequence[DialogueRow]) -> Tuple[List[str], List[int]]:
    """(texts, labels) view for featurizer/trainer consumption."""
    return [r.dialogue for r in rows], [r.label for r in rows]
