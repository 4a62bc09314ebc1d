"""Thread-pool sharded host featurization — twin of
``fraud_detection_tpu/featurize/parallel.py``.

A batch is split into contiguous shards over a process-wide thread pool
using the native library's stateless shard entry points
(``ftok_shard_begin`` / ``ftok_shard_json_begin`` / ``ftok_shard_fill*``).
ctypes releases the GIL for each native call, so N shards tokenize and hash
at once over one read-only handle, then fill their rows straight into row
slices of ONE preallocated output pair. The output is byte-identical to the
serial encode by construction.

Without the native library the same sharding runs the pure-Python
``sparse_row`` over the pool (the GIL bounds that win; the rows and their
order are the serial loop's).

Worker count: explicit ``parallel_workers`` on the featurizer, else the
``FRAUD_TPU_FEAT_WORKERS`` environment variable, else ``min(cpu_count, 8)``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

_MAX_WORKERS = 8  # the native library's own internal cap

_pool: Optional[ThreadPoolExecutor] = None
_pool_size = 0
_pool_lock = threading.Lock()


def resolve_workers(configured: Optional[int] = None) -> int:
    """Worker count: explicit config > FRAUD_TPU_FEAT_WORKERS > cpu count."""
    if configured is not None:
        return max(1, int(configured))
    env = os.environ.get("FRAUD_TPU_FEAT_WORKERS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return max(1, min(os.cpu_count() or 1, _MAX_WORKERS))


def _executor(workers: int) -> ThreadPoolExecutor:
    """The shared process-wide pool, grown (never shrunk) to ``workers``:
    per-call pools would pay thread spawn on the serving path."""
    global _pool, _pool_size
    with _pool_lock:
        if _pool is None or _pool_size < workers:
            old = _pool
            _pool = ThreadPoolExecutor(max_workers=workers,
                                       thread_name_prefix="featurize")
            _pool_size = workers
            if old is not None:
                old.shutdown(wait=False)
        return _pool


def shard_bounds(n: int, workers: int) -> List[Tuple[int, int]]:
    """Contiguous [lo, hi) shards covering range(n), at most ``workers``."""
    if n <= 0:
        return []
    per = -(-n // max(1, workers))
    return [(lo, min(n, lo + per)) for lo in range(0, n, per)]


def _fill_shards(native, shards, bounds, rows: int, length: int,
                 want16: bool, pool) -> Tuple[np.ndarray, np.ndarray]:
    """Phase 2 of a sharded encode: each shard fills its own row slice of
    one zeroed output pair (rows past the last shard stay padding)."""
    ids = np.zeros((rows, length), np.int16 if want16 else np.int32)
    counts = np.zeros((rows, length), np.uint16 if want16 else np.float32)

    def fill(i: int) -> None:
        lo, hi = bounds[i]
        native.shard_fill_into(shards[i], ids[lo:hi], counts[lo:hi],
                               hi - lo, length)

    list(pool.map(fill, range(len(bounds))))
    return ids, counts


def encode_sharded_native(native, texts: Sequence[str], rows: int,
                          max_tokens: Optional[int], pad_len: Callable,
                          want16: bool, workers: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Sharded native encode: ``NativeFeaturizer.encode``'s contract and
    bytes. Two phases around one barrier — the padded length L is the max
    over every shard's width, so fills start once every begin has landed."""
    bounds = shard_bounds(len(texts), workers)
    pool = _executor(workers)
    shards: List[Optional[int]] = [None] * len(bounds)
    try:
        def begin(i: int) -> int:
            lo, hi = bounds[i]
            shard, w = native.shard_begin(
                [native.sanitize(t) for t in texts[lo:hi]])
            shards[i] = shard  # slot write: no two workers share an index
            return w

        width = max(pool.map(begin, range(len(bounds))), default=0)
        length = max_tokens if max_tokens is not None else pad_len(max(width, 1))
        return _fill_shards(native, shards, bounds, rows, length, want16, pool)
    finally:
        for shard in shards:
            if shard is not None:
                native.shard_destroy(shard)


def encode_json_sharded_native(native, values: Sequence[bytes], key: bytes,
                               rows: int, max_tokens: Optional[int],
                               pad_len: Callable, want16: bool, workers: int
                               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray, object]:
    """Sharded raw-JSON encode: ``NativeFeaturizer.encode_json``'s contract
    and bytes. The batch marshals into ONE ``char*[n]`` (the returned splice
    context still feeds ``build_frames``); each worker encodes a sub-pointer
    into it with its disjoint slices of the status/span arrays."""
    n = len(values)
    arr = (ctypes.c_char_p * n)(*values)
    lens = np.fromiter((len(v) for v in values), np.int32, n)
    status = np.zeros(n, np.int32)
    span_start = np.zeros(n, np.int32)
    span_len = np.zeros(n, np.int32)
    bounds = shard_bounds(n, workers)
    pool = _executor(workers)
    shards: List[Optional[int]] = [None] * len(bounds)
    ptr_size = ctypes.sizeof(ctypes.c_char_p)
    try:
        def begin(i: int) -> int:
            lo, hi = bounds[i]
            ptr = ctypes.cast(ctypes.byref(arr, lo * ptr_size),
                              ctypes.POINTER(ctypes.c_char_p))
            shard, w = native.shard_json_begin(
                ptr, lens[lo:hi], hi - lo, key, status[lo:hi],
                span_start[lo:hi], span_len[lo:hi])
            shards[i] = shard  # slot write: no two workers share an index
            return w

        width = max(pool.map(begin, range(len(bounds))), default=0)
        length = max_tokens if max_tokens is not None else pad_len(max(width, 1))
        ids, counts = _fill_shards(native, shards, bounds, rows, length,
                                   want16, pool)
        return ids, counts, status, span_start, span_len, arr
    finally:
        for shard in shards:
            if shard is not None:
                native.shard_destroy(shard)


def sparse_rows_chunked(sparse_row: Callable, texts: Sequence[str],
                        workers: int) -> List[tuple]:
    """Pure-Python path: ``sparse_row`` over contiguous chunks on the pool,
    in the serial loop's row order."""
    bounds = shard_bounds(len(texts), workers)
    pool = _executor(workers)

    def run(i: int) -> List[tuple]:
        lo, hi = bounds[i]
        return [sparse_row(t) for t in texts[lo:hi]]

    out: List[tuple] = []
    for part in pool.map(run, range(len(bounds))):
        out.extend(part)
    return out
