"""Host-side text preparation with Spark-parity semantics.

Twin of ``fraud_detection_tpu/featurize/text.py``; its behavior must match,
token for token, what the reference's serving path does before features hit
the classifier:

  * clean_text: lowercase then strip every char not in ``[a-z ]``.
  * tokenize: Spark ``ml.feature.Tokenizer`` semantics — ``toLowerCase`` then
    Java ``String.split("\\s")``: split on *single* whitespace chars, interior
    and leading empty tokens are KEPT, trailing empty tokens are dropped.
  * stop word removal: Spark ``StopWordsRemover`` with the default English
    181-word list, caseSensitive=false.
"""

from __future__ import annotations

import re
from importlib import resources
from typing import FrozenSet, List, Sequence

_NON_ALPHA_SPACE = re.compile(r"[^a-z ]")
# Java's regex \s is ASCII-only: [ \t\n\x0B\f\r]. Python's \s also matches
# Unicode whitespace, which would split tokens Spark keeps intact.
_WS_SPLIT = re.compile(r"[ \t\n\x0b\f\r]")


def clean_text(text: str) -> str:
    """Lowercase and strip every char not in ``[a-z ]`` (Spark-reference style)."""
    return _NON_ALPHA_SPACE.sub("", text.lower())


def tokenize(text: str) -> List[str]:
    """Spark ``Tokenizer`` semantics: lowercase + Java ``split("\\s")``.

    Java's split keeps interior/leading empty strings but drops trailing ones,
    EXCEPT that splitting the empty string returns [""]."""
    if text == "":
        return [""]
    parts = _WS_SPLIT.split(text.lower())
    while parts and parts[-1] == "":
        parts.pop()
    return parts


def load_default_stopwords() -> List[str]:
    """The 181-word default English stop list used by Spark's StopWordsRemover
    (package data)."""
    data = (resources.files("fraud_detection_tpu_torch.data")
            .joinpath("english_stopwords.txt").read_text())
    return [w for w in data.splitlines() if w]


class StopWordFilter:
    """Spark ``StopWordsRemover`` with caseSensitive=false semantics."""

    def __init__(self, stopwords: Sequence[str] | None = None, case_sensitive: bool = False):
        words = list(stopwords) if stopwords is not None else load_default_stopwords()
        self.case_sensitive = case_sensitive
        self._set: FrozenSet[str] = frozenset(words if case_sensitive else [w.lower() for w in words])

    @property
    def words(self) -> List[str]:
        """The effective stop list (lowercased unless case_sensitive)."""
        return sorted(self._set)

    def __call__(self, tokens: Sequence[str]) -> List[str]:
        if self.case_sensitive:
            return [t for t in tokens if t not in self._set]
        return [t for t in tokens if t.lower() not in self._set]
