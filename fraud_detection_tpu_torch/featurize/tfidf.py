"""TF-IDF featurization: host encoding to padded sparse batches — twin of
``fraud_detection_tpu/featurize/tfidf.py``.

The host emits fixed-shape padded (bucket_ids, counts) batches — through the
native C++ featurizer (``featurize/native.py``, sharded over a thread pool
for large batches by ``featurize/parallel.py``) when it builds, else through
the pure-Python rows, which are the reference semantics the native path
equals bit for bit. ``encode_json`` goes from raw JSON message bytes to the
same batch in one native pass. The scoring
models (models/linear.py, models/trees.py) consume them without ever
materializing dense features. The device featurize path
(featurize/device.py) produces the same layout on the card from raw bytes.
The trainers take the dense (B, F) TF-IDF matrix (``featurize_dense``).
``VocabTfIdfFeaturizer`` swaps the hasher for an explicit vocabulary
(CountVectorizer semantics) and encodes on the Python rows.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fraud_detection_tpu_torch.featurize.hashing import HashingTF
from fraud_detection_tpu_torch.featurize.text import StopWordFilter, clean_text, tokenize
from fraud_detection_tpu_torch.utils.device import resolve_device

# Serializes the lazy native-handle build of every featurizer (rare: once
# per featurizer).
_NATIVE_INIT_LOCK = threading.Lock()


class EncodedBatch(NamedTuple):
    """Fixed-shape sparse batch: per-row hashed-bucket ids and term counts.

    ``ids`` is (B, L) int16 (int32 when num_features exceeds int16 range) and
    ``counts`` is (B, L) uint16. Padding has count 0 (bucket id 0 — harmless
    because every consumer weights by count)."""

    ids: np.ndarray
    counts: np.ndarray


def tfidf_dense(ids: torch.Tensor, counts: torch.Tensor,
                idf: torch.Tensor) -> torch.Tensor:
    """Scatter padded sparse rows into a dense (B, F) TF-IDF matrix: counts
    added at (row, id), then scaled by the IDF (HashingTF + IDFModel's
    "features" column). A row's ids are distinct apart from count-0
    padding, so the scatter's order cannot change a value."""
    dense = torch.zeros((ids.shape[0], idf.shape[0]), dtype=idf.dtype,
                        device=idf.device)
    dense.scatter_add_(1, ids.to(torch.int64), counts.to(idf.dtype))
    return dense * idf[None, :]


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
    the JAX package sets the same thing by swapping its hasher. The native
    library hashes with the standard tail only, so a legacy featurizer
    encodes through the Python rows.

    ``parallel_workers`` shards ``encode`` / ``encode_json`` over the
    process-wide pool (None = ``FRAUD_TPU_FEAT_WORKERS``, else the CPU
    count, capped; 1 = serial); batches under ``parallel_min_rows`` stay
    serial, where fan-out costs more than it saves."""

    num_features: int = 10000
    idf: Optional[np.ndarray] = None  # None => raw TF (identity IDF)
    binary_tf: bool = False
    stop_filter: StopWordFilter = field(default_factory=StopWordFilter)
    remove_stopwords: bool = True
    legacy: bool = False
    parallel_workers: Optional[int] = None
    parallel_min_rows: int = 256

    def __post_init__(self):
        self._hashing = HashingTF(self.num_features, binary=self.binary_tf,
                                  legacy=self.legacy)
        self._idf_dev: dict = {}   # torch.device -> cached IDF tensor
        self._native = None        # lazy NativeFeaturizer
        self._native_tried = False
        self._json_splice_ctx = None
        if self.idf is not None:
            self.idf = np.asarray(self.idf, np.float32)
            if self.idf.shape != (self.num_features,):
                raise ValueError(
                    f"idf shape {self.idf.shape} != ({self.num_features},)")

    def _native_featurizer(self):
        """The C++ clean/tokenize/hash path, or None (no library, or the
        legacy hash the library does not implement). Built once under a
        lock: worker threads sharing one pipeline call this at once, and a
        thread that found the build begun but not finished would take None,
        i.e. the slow path, for good."""
        if not self._native_tried:
            with _NATIVE_INIT_LOCK:
                if not self._native_tried:
                    from fraud_detection_tpu_torch.featurize import native

                    if not self.legacy and native.available():
                        self._native = native.NativeFeaturizer(
                            self.stop_filter.words if self.remove_stopwords
                            else [],
                            self.num_features, self.binary_tf,
                            self.remove_stopwords)
                    self._native_tried = True
        return self._native

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
        workers = self._encode_workers(len(texts))
        native = self._native_featurizer()
        if native is not None:
            want16 = self._ids_dtype() is np.int16
            if workers > 1:
                from fraud_detection_tpu_torch.featurize import parallel

                ids, counts = parallel.encode_sharded_native(
                    native, texts, b, max_tokens, _pad_len, want16=want16,
                    workers=workers)
            else:
                ids, counts = native.encode(texts, b, max_tokens, _pad_len,
                                            want16=want16)
            return EncodedBatch(*self._narrow(ids, counts))
        if workers > 1:
            from fraud_detection_tpu_torch.featurize import parallel

            rows = parallel.sparse_rows_chunked(self.sparse_row, texts, workers)
        else:
            rows = [self.sparse_row(t) for t in texts]
        width = max((len(i) for i, _ in rows), default=1)
        length = max_tokens if max_tokens is not None else _pad_len(width)
        ids = np.zeros((b, length), self._ids_dtype())
        counts = np.zeros((b, length), np.uint16)
        _fill_python_rows(rows, ids, counts, length)
        return EncodedBatch(ids=ids, counts=counts)

    def _encode_workers(self, n: int) -> int:
        if n < self.parallel_min_rows:
            return 1
        from fraud_detection_tpu_torch.featurize import parallel

        return parallel.resolve_workers(self.parallel_workers)

    def encode_json(self, values: Sequence[bytes], text_field: str = "text",
                    batch_size: Optional[int] = None,
                    max_tokens: Optional[int] = None,
                    keep_splice_ctx: bool = False) -> Optional[Tuple[
                        EncodedBatch, np.ndarray, np.ndarray, np.ndarray]]:
        """Raw-JSON path: encode message bytes WITHOUT ``json.loads`` — one
        native pass extracts ``text_field``, cleans, tokenizes and hashes.

        Returns ``(batch, status, span_start, span_len)``: row i is
        values[i] (status 0 rows are all-padding; the caller discards their
        scores), and the spans locate each message's raw string literal
        (quotes included) for splicing into output frames. With
        ``keep_splice_ctx`` the marshalled message array waits in
        ``pop_json_splice_ctx()`` for native frame assembly (same thread,
        right after this call). None when the native path is unavailable:
        callers fall back to ``json.loads`` + ``encode``."""
        out = self._encode_json(values, text_field, batch_size, max_tokens)
        if out is None:
            return None
        self._json_splice_ctx = out[4] if keep_splice_ctx else None
        return out[:4]

    def _encode_json(self, values: Sequence[bytes], text_field: str,
                     batch_size: Optional[int], max_tokens: Optional[int]
                     ) -> Optional[Tuple[EncodedBatch, np.ndarray, np.ndarray,
                                         np.ndarray, object]]:
        """``encode_json``'s result plus its splice context (the marshalled
        ``char*[]`` that ``native.build_frames`` reads), handed back to the
        caller rather than kept on this shared featurizer."""
        native = self._native_featurizer()
        if native is None:
            return None
        b = batch_size if batch_size is not None else len(values)
        if len(values) > b:
            raise ValueError(f"{len(values)} values > batch_size {b}")
        workers = self._encode_workers(len(values))
        key = text_field.encode("utf-8")
        want16 = self._ids_dtype() is np.int16
        if workers > 1:
            from fraud_detection_tpu_torch.featurize import parallel

            ids, counts, status, span_start, span_len, ctx = (
                parallel.encode_json_sharded_native(
                    native, values, key, b, max_tokens, _pad_len,
                    want16=want16, workers=workers))
        else:
            ids, counts, status, span_start, span_len, ctx = native.encode_json(
                values, key, b, max_tokens, _pad_len, want16=want16)
        return (EncodedBatch(*self._narrow(ids, counts)), status, span_start,
                span_len, ctx)

    def pop_json_splice_ctx(self):
        """Take the last ``encode_json`` call's marshalled message array
        (``native.build_frames``' splice context); cleared on read."""
        ctx, self._json_splice_ctx = self._json_splice_ctx, None
        return ctx

    def _ids_dtype(self):
        return np.int16 if self.num_features <= np.iinfo(np.int16).max else np.int32

    def _narrow(self, ids: np.ndarray, counts: np.ndarray):
        """The wire dtypes (EncodedBatch): the native fill emits int16 ids
        and uint16 counts directly when the feature space fits, else int32
        ids and float32 counts, narrowed here (counts clipped at 65535)."""
        if ids.dtype == np.int16:
            return ids, counts
        return (ids.astype(self._ids_dtype(), copy=False),
                np.minimum(counts, 65535.0).astype(np.uint16))

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

    def featurize_dense(self, texts: Sequence[str],
                        batch_size: Optional[int] = None,
                        device="cuda") -> torch.Tensor:
        """Texts -> dense (B, F) TF-IDF matrix on ``device`` (pads B to
        batch_size)."""
        dev = resolve_device(device)
        enc = self.encode(texts, batch_size=batch_size)
        ids = torch.from_numpy(enc.ids.astype(np.int64)).to(dev)
        counts = torch.from_numpy(enc.counts.astype(np.float32)).to(dev)
        return tfidf_dense(ids, counts, self.idf_array(dev))

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


@dataclass
class VocabTfIdfFeaturizer(HashingTfIdfFeaturizer):
    """CountVectorizer-semantics featurizer: explicit vocabulary -> index.

    Replicates the reference TRAINING pipeline's feature path
    (fraud_detection_spark.py:47-54: Tokenizer -> StopWordsRemover ->
    CountVectorizer(vocabSize=20000) -> IDF). Out-of-vocabulary terms drop
    (Spark's behavior); ``vocabulary[i]`` names feature i.

    ``min_tf`` follows Spark's CountVectorizerModel: values >= 1 are an
    absolute per-document count floor; values < 1 are a fraction of the
    document's token count. It encodes on the Python rows only: the native
    library and the device kernel hash, and a vocabulary lookup is not a
    hash (the device featurizer refuses this class)."""

    vocabulary: Sequence[str] = ()
    min_tf: float = 1.0

    def __post_init__(self):
        self.vocabulary = list(self.vocabulary)
        if self.vocabulary:
            self.num_features = len(self.vocabulary)
        self._index = {t: i for i, t in enumerate(self.vocabulary)}
        super().__post_init__()
        self._native_tried = True
        self._native = None

    @property
    def hashing_tf(self) -> HashingTF:
        raise TypeError(
            "VocabTfIdfFeaturizer maps terms through an explicit vocabulary; "
            "there is no hasher (use .bucket(term) / .vocabulary instead)")

    def bucket(self, term: str) -> int:
        """Feature index of a term, -1 when it is out of the vocabulary."""
        idx = self._index.get(term)
        return -1 if idx is None else idx

    @classmethod
    def fit_vocabulary(cls, texts: Sequence[str], vocab_size: int = 20000, *,
                       min_df: float = 1.0, min_tf: float = 1.0,
                       binary_tf: bool = False,
                       stop_filter: Optional[StopWordFilter] = None,
                       remove_stopwords: bool = True) -> "VocabTfIdfFeaturizer":
        """Spark ``CountVectorizer.fit`` semantics: vocabulary = the top
        ``vocab_size`` terms by total corpus count, restricted to terms whose
        document frequency is >= ``min_df`` (absolute if >= 1, else a
        fraction of the corpus). Ties break lexicographically."""
        probe = cls(vocabulary=["\x00probe"], min_tf=min_tf, binary_tf=binary_tf,
                    stop_filter=stop_filter or StopWordFilter(),
                    remove_stopwords=remove_stopwords)
        term_count: dict = {}
        doc_freq: dict = {}
        for text in texts:
            toks = probe.tokens(text)
            for t in toks:
                term_count[t] = term_count.get(t, 0) + 1
            for t in set(toks):
                doc_freq[t] = doc_freq.get(t, 0) + 1
        df_floor = min_df if min_df >= 1.0 else min_df * max(len(texts), 1)
        eligible = [t for t, df in doc_freq.items() if df >= df_floor]
        eligible.sort(key=lambda t: (-term_count[t], t))
        return cls(vocabulary=eligible[:vocab_size], min_tf=min_tf,
                   binary_tf=binary_tf, stop_filter=probe.stop_filter,
                   remove_stopwords=remove_stopwords)

    def sparse_row(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        toks = self.tokens(text)
        counts: dict = {}
        for t in toks:
            i = self._index.get(t)
            if i is not None:
                counts[i] = counts.get(i, 0) + 1
        floor = self.min_tf if self.min_tf >= 1.0 else self.min_tf * max(len(toks), 1)
        items = sorted((i, c) for i, c in counts.items() if c >= floor)
        if not items:
            return np.empty(0, np.int32), np.empty(0, np.float32)
        ids = np.fromiter((i for i, _ in items), np.int32, len(items))
        vals = np.fromiter((c for _, c in items), np.float32, len(items))
        if self.binary_tf:
            vals = np.ones_like(vals)
        return ids, vals
