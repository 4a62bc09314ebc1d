"""TF-IDF featurization: host encoding to padded sparse batches — twin of
``fraud_detection_tpu/featurize/tfidf.py`` (pure-Python encode path).

The host emits fixed-shape padded (bucket_ids, counts) batches; the scoring
models (models/linear.py, models/trees.py) consume them without ever
materializing dense features. The device featurize path
(featurize/device.py) produces the same layout on the card from raw bytes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fraud_detection_tpu_torch.featurize.hashing import HashingTF
from fraud_detection_tpu_torch.featurize.text import StopWordFilter, clean_text, tokenize


class EncodedBatch(NamedTuple):
    """Fixed-shape sparse batch: per-row hashed-bucket ids and term counts.

    ``ids`` is (B, L) int16 (int32 when num_features exceeds int16 range) and
    ``counts`` is (B, L) uint16. Padding has count 0 (bucket id 0 — harmless
    because every consumer weights by count)."""

    ids: np.ndarray
    counts: np.ndarray


def _pad_len(n: int, minimum: int = 16) -> int:
    return max(minimum, 1 << math.ceil(math.log2(max(n, 1))))


def _fill_python_rows(rows, ids: np.ndarray, counts: np.ndarray,
                      length: int) -> None:
    """Write sparse (idx, val) rows into preallocated padded arrays. Rows
    with more unique buckets than ``length`` keep the top counts, ties
    resolving toward the LOWER bucket id (stable sort)."""
    for r, (idx, val) in enumerate(rows):
        if len(idx) > length:
            keep = np.argsort(-val, kind="stable")[:length]
            keep.sort()
            idx, val = idx[keep], val[keep]
        ids[r, : len(idx)] = idx
        counts[r, : len(val)] = np.minimum(val, 65535.0)


@dataclass
class HashingTfIdfFeaturizer:
    """Tokenizer -> StopWordsRemover -> HashingTF -> IDF featurizer.

    ``legacy`` selects the old ``mllib`` murmur tail (featurize/hashing.py);
    the JAX package sets the same thing by swapping its hasher."""

    num_features: int = 10000
    idf: Optional[np.ndarray] = None  # None => raw TF (identity IDF)
    binary_tf: bool = False
    stop_filter: StopWordFilter = field(default_factory=StopWordFilter)
    remove_stopwords: bool = True
    legacy: bool = False

    def __post_init__(self):
        self._hashing = HashingTF(self.num_features, binary=self.binary_tf,
                                  legacy=self.legacy)
        self._idf_dev: dict = {}   # torch.device -> cached IDF tensor
        if self.idf is not None:
            self.idf = np.asarray(self.idf, np.float32)
            if self.idf.shape != (self.num_features,):
                raise ValueError(
                    f"idf shape {self.idf.shape} != ({self.num_features},)")

    @property
    def hashing_tf(self) -> HashingTF:
        return self._hashing

    def bucket(self, term: str) -> int:
        """Feature index for a term (hashing never returns -1)."""
        return self._hashing.bucket(term)

    def tokens(self, text: str) -> List[str]:
        toks = tokenize(clean_text(text))
        if self.remove_stopwords:
            toks = self.stop_filter(toks)
        return toks

    def sparse_row(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        return self._hashing.transform_arrays(self.tokens(text))

    def encode(self, texts: Sequence[str], batch_size: Optional[int] = None,
               max_tokens: Optional[int] = None) -> EncodedBatch:
        """Encode texts into a fixed-shape padded EncodedBatch (numpy, host).

        batch_size pads the row count; max_tokens fixes L (defaults to the
        padded max unique-bucket count in this batch). Rows beyond
        len(texts) are all-padding."""
        b = batch_size if batch_size is not None else len(texts)
        if len(texts) > b:
            raise ValueError(f"{len(texts)} texts > batch_size {b}")
        rows = [self.sparse_row(t) for t in texts]
        width = max((len(i) for i, _ in rows), default=1)
        length = max_tokens if max_tokens is not None else _pad_len(width)
        ids = np.zeros((b, length), self._ids_dtype())
        counts = np.zeros((b, length), np.uint16)
        _fill_python_rows(rows, ids, counts, length)
        return EncodedBatch(ids=ids, counts=counts)

    def _ids_dtype(self):
        return np.int16 if self.num_features <= np.iinfo(np.int16).max else np.int32

    def fit_idf(self, texts: Sequence[str], min_doc_freq: int = 0) -> "HashingTfIdfFeaturizer":
        """Fit the IDF vector from a corpus (Spark ``IDF.fit`` semantics):
        idf = ln((numDocs + 1) / (docFreq + 1)), zeroed below min_doc_freq."""
        doc_freq = np.zeros(self.num_features, np.int64)
        for t in texts:
            idx, _ = self.sparse_row(t)
            doc_freq[idx] += 1
        idf = np.log((len(texts) + 1.0) / (doc_freq + 1.0))
        if min_doc_freq > 0:
            idf = np.where(doc_freq >= min_doc_freq, idf, 0.0)
        self.idf = idf.astype(np.float32)
        self._idf_dev = {}         # refit invalidates the device caches
        self.doc_freq = doc_freq
        self.num_docs = len(texts)
        return self

    def idf_array(self, device) -> torch.Tensor:
        """IDF vector on ``device``, copied there ONCE and cached — model-side
        constants stay device-resident."""
        dev = torch.device(device)
        out = self._idf_dev.get(dev)
        if out is None:
            out = (torch.ones(self.num_features, dtype=torch.float32, device=dev)
                   if self.idf is None else torch.from_numpy(self.idf).to(dev))
            self._idf_dev[dev] = out
        return out
