"""MurmurHash3_x86_32 term hashing with exact Spark ``ml.feature.HashingTF``
parity — twin of ``fraud_detection_tpu/featurize/hashing.py``.

Spark 3.x hashes the UTF-8 bytes of each term with the *standard* murmur3
tail (``hashUnsafeBytes2``, seed 42) and maps to a bucket with
``Utils.nonNegativeMod(signed_hash, numFeatures)``. The older
``mllib.feature.HashingTF`` ran each tail byte, sign-extended, through a full
mix round (``hashUnsafeBytes``); both are here.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

_MASK = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593

SPARK_HASHING_TF_SEED = 42


def _mix_k1(k1: int) -> int:
    k1 = (k1 * _C1) & _MASK
    k1 = ((k1 << 15) | (k1 >> 17)) & _MASK
    return (k1 * _C2) & _MASK


def _mix_h1(h1: int, k1: int) -> int:
    h1 ^= k1
    h1 = ((h1 << 13) | (h1 >> 19)) & _MASK
    return (h1 * 5 + 0xE6546B64) & _MASK


def _fmix(h1: int, length: int) -> int:
    h1 ^= length
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & _MASK
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & _MASK
    h1 ^= h1 >> 16
    return h1


def murmur3_x86_32(data: bytes, seed: int = 0) -> int:
    """Standard MurmurHash3_x86_32 (== Spark's ``hashUnsafeBytes2``), as an
    unsigned 32-bit int."""
    h1 = seed & _MASK
    aligned = len(data) & ~3
    for i in range(0, aligned, 4):
        h1 = _mix_h1(h1, _mix_k1(int.from_bytes(data[i : i + 4], "little")))
    k1 = 0
    shift = 0
    for i in range(aligned, len(data)):
        k1 ^= data[i] << shift
        shift += 8
    h1 ^= _mix_k1(k1)
    return _fmix(h1, len(data))


def murmur3_x86_32_legacy_tail(data: bytes, seed: int = 0) -> int:
    """Spark's ``hashUnsafeBytes``: each tail byte sign-extended + full round."""
    h1 = seed & _MASK
    aligned = len(data) & ~3
    for i in range(0, aligned, 4):
        h1 = _mix_h1(h1, _mix_k1(int.from_bytes(data[i : i + 4], "little")))
    for i in range(aligned, len(data)):
        b = data[i]
        if b >= 0x80:
            b -= 0x100  # Java bytes are signed; the int promotion sign-extends
        h1 = _mix_h1(h1, _mix_k1(b & _MASK))
    return _fmix(h1, len(data))


def _to_signed32(x: int) -> int:
    return x - (1 << 32) if x >= (1 << 31) else x


def non_negative_mod(x: int, mod: int) -> int:
    """Spark ``Utils.nonNegativeMod``: ((x % mod) + mod) % mod on signed ints."""
    raw = x % mod if x >= 0 else -((-x) % mod)
    return raw + mod if raw < 0 else raw


@lru_cache(maxsize=1 << 20)
def spark_hash_bucket(term: str, num_features: int = 10000, legacy: bool = False) -> int:
    """Bucket index Spark's ml HashingTF assigns to ``term``. Cached per process."""
    fn = murmur3_x86_32_legacy_tail if legacy else murmur3_x86_32
    h = _to_signed32(fn(term.encode("utf-8"), SPARK_HASHING_TF_SEED))
    return non_negative_mod(h, num_features)


class HashingTF:
    """Term-frequency featurizer via the hashing trick (Spark ml parity).
    ``binary=True`` mirrors Spark's binary toggle (presence, not counts)."""

    def __init__(self, num_features: int = 10000, binary: bool = False, legacy: bool = False):
        if num_features <= 0:
            raise ValueError("num_features must be positive")
        self.num_features = num_features
        self.binary = binary
        self.legacy = legacy

    def bucket(self, term: str) -> int:
        return spark_hash_bucket(term, self.num_features, self.legacy)

    def transform_counts(self, tokens: Sequence[str]) -> Dict[int, float]:
        counts: Dict[int, float] = {}
        if self.binary:
            for t in tokens:
                counts[self.bucket(t)] = 1.0
        else:
            for t in tokens:
                b = self.bucket(t)
                counts[b] = counts.get(b, 0.0) + 1.0
        return counts

    def transform_arrays(self, tokens: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """(sorted bucket indices, counts) as numpy arrays."""
        counts = self.transform_counts(tokens)
        if not counts:
            return np.empty(0, np.int32), np.empty(0, np.float32)
        idx = np.fromiter(counts.keys(), np.int32, len(counts))
        val = np.fromiter(counts.values(), np.float32, len(counts))
        order = np.argsort(idx)
        return idx[order], val[order]

    def transform_batch(self, docs: Iterable[Sequence[str]]
                        ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """``transform_arrays`` of each token list in ``docs``."""
        return [self.transform_arrays(d) for d in docs]
