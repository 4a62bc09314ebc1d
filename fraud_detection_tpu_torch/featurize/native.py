"""ctypes loader for the native host featurizer — twin of
``fraud_detection_tpu/featurize/native.py``.

The C++ source is the port's own copy (``native/fast_featurize.cpp``, a
plain C ABI). At first use it is compiled with
``g++ -O3 -std=c++17 -shared -fPIC -pthread`` into
``build/native/<source hash>/libfastfeat.so`` at the repository root
(git-ignored): to a temporary name first, then ``os.replace``, so test
workers and concurrent processes that build at once never load half a file.
Nothing builds at import time.

``load_library()`` returns None when the library cannot be built or loaded
(no g++): the featurizer then runs its pure-Python encode, which is the
reference's own semantics. The compiler's stderr stays on
``build_error`` and the command on ``build_command``, so a caller that needs
the native path (``chip_smoke.py``) can fail and say why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fraud_detection_tpu_torch.utils.racecheck import PairedCallChecker

SRC = Path(__file__).resolve().parents[1] / "native" / "fast_featurize.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False
# Why the last build or load failed (the compiler's stderr), and the command
# that built the library; None until a build was attempted.
build_error: Optional[str] = None
build_command: Optional[List[str]] = None


def _arr(dtype):
    return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")


_CHARPP = ctypes.POINTER(ctypes.c_char_p)
# (restype, argtypes) of every C entry point, in the order of the C
# signatures in native/fast_featurize.cpp (a test holds them against it).
ARGTYPES = {
    "ftok_create": (ctypes.c_void_p, [_CHARPP, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int]),
    "ftok_destroy": (None, [ctypes.c_void_p]),
    "ftok_hash_bucket": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p]),
    "ftok_encode_begin": (ctypes.c_int, [ctypes.c_void_p, _CHARPP,
                                         ctypes.c_int]),
    "ftok_encode_json_begin": (ctypes.c_int, [
        ctypes.c_void_p, _CHARPP, _arr(np.int32), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, _arr(np.int32), _arr(np.int32),
        _arr(np.int32)]),
    "ftok_encode_fill": (None, [ctypes.c_void_p, _arr(np.int32),
                                _arr(np.float32), ctypes.c_int,
                                ctypes.c_int]),
    "ftok_encode_fill16": (None, [ctypes.c_void_p, _arr(np.int16),
                                  _arr(np.uint16), ctypes.c_int,
                                  ctypes.c_int]),
    "ftok_shard_begin": (ctypes.c_void_p, [ctypes.c_void_p, _CHARPP,
                                           ctypes.c_int, _arr(np.int32)]),
    "ftok_shard_fill": (None, [ctypes.c_void_p, _arr(np.int32),
                               _arr(np.float32), ctypes.c_int, ctypes.c_int]),
    "ftok_shard_fill16": (None, [ctypes.c_void_p, _arr(np.int16),
                                 _arr(np.uint16), ctypes.c_int,
                                 ctypes.c_int]),
    "ftok_shard_destroy": (None, [ctypes.c_void_p]),
    "ftok_shard_json_begin": (ctypes.c_void_p, [
        ctypes.c_void_p, _CHARPP, _arr(np.int32), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, _arr(np.int32), _arr(np.int32),
        _arr(np.int32), _arr(np.int32)]),
    "ftok_build_frames": (ctypes.c_longlong, [
        _CHARPP, _arr(np.int32), _arr(np.int32), _arr(np.int32),
        _arr(np.float64), _CHARPP, _arr(np.int32), ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_longlong, _arr(np.int64)]),
}


def library_path() -> Path:
    """Where the source builds to (a hash of the source and flags names the
    directory, so an edited source rebuilds and an unchanged one loads)."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / digest.hexdigest()[:16] / "libfastfeat.so"


def build() -> Optional[Path]:
    """Compile the library unless its current build exists; returns its
    path, or None with ``build_error`` set when g++ fails or is absent."""
    global build_error, build_command
    out = library_path()
    build_command = ["g++", *GXX_FLAGS, str(SRC), "-o", str(out)]
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", tmp],
                              capture_output=True, text=True, timeout=240)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        build_error = f"{build_command[0]}: {e}"
        return None
    if proc.returncode != 0:
        os.unlink(tmp)
        build_error = f"g++ exit {proc.returncode}:\n{proc.stderr}"
        return None
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return out


def load_library() -> Optional[ctypes.CDLL]:
    """The process-wide native library, built and loaded at first call;
    None if unavailable (``build_error`` says why)."""
    global _lib, _lib_failed, build_error
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = build()
        if path is None:
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            build_error = f"loading {path}: {e}"
            _lib_failed = True
            return None
        for name, (restype, argtypes) in ARGTYPES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


class NativeFeaturizer:
    """One native handle: stop-word set + hashing config bound at creation."""

    def __init__(self, stopwords: Sequence[str], num_features: int,
                 binary: bool, remove_stopwords: bool):
        lib = load_library()
        if lib is None:
            raise RuntimeError(f"native featurizer library unavailable: "
                               f"{build_error}")
        self._lib = lib
        arr = (ctypes.c_char_p * len(stopwords))(
            *[s.encode("utf-8") for s in stopwords])
        self._handle = lib.ftok_create(arr, len(stopwords), num_features,
                                       int(binary), int(remove_stopwords))
        # begin/fill share the handle's row state: one caller at a time
        # (the lock); the checker wraps the ABI calls so a path that skips
        # the lock raises instead of corrupting rows.
        self._call_lock = threading.Lock()
        self._pair_check = PairedCallChecker(name="NativeFeaturizer")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.ftok_destroy(handle)
            self._handle = None

    def hash_bucket(self, term: str) -> int:
        return self._lib.ftok_hash_bucket(self._handle, term.encode("utf-8"))

    def _begin(self, lib_begin, *args) -> int:
        self._pair_check.begin()
        return lib_begin(self._handle, *args)

    def _fill(self, rows: int, length: int, want16: bool
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Drain the handle's row state into padded arrays: int16 ids and
        uint16 counts (clipped) with ``want16`` (callers gate it on
        num_features <= int16 max), else int32 / float32."""
        if want16:
            ids = np.empty((rows, length), np.int16)
            counts = np.empty((rows, length), np.uint16)
            self._lib.ftok_encode_fill16(self._handle, ids, counts, rows,
                                         length)
        else:
            ids = np.empty((rows, length), np.int32)
            counts = np.empty((rows, length), np.float32)
            self._lib.ftok_encode_fill(self._handle, ids, counts, rows,
                                       length)
        return ids, counts

    @staticmethod
    def sanitize(text: str) -> bytes:
        """The wire prep of every text encode: NUL-strip (a NUL would end
        the C string; the Python clean strips it too) and surrogatepass
        (``json.loads`` yields lone surrogates, which the C++ decoder strips
        as the Python clean does)."""
        return text.encode("utf-8", "surrogatepass").replace(b"\x00", b"")

    def encode(self, texts: Sequence[str], rows: int,
               max_tokens: Optional[int], pad_len,
               want16: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Padded (rows, L) ids/counts — the Python encode's contract."""
        buf = [self.sanitize(t) for t in texts]
        arr = (ctypes.c_char_p * len(buf))(*buf)
        with self._call_lock:
            try:
                width = self._begin(self._lib.ftok_encode_begin, arr, len(buf))
                length = (max_tokens if max_tokens is not None
                          else pad_len(max(width, 1)))
                return self._fill(rows, length, want16)
            finally:
                self._pair_check.finish()

    # ---------------- stateless shard API (featurize/parallel.py) --------
    # Shard calls never touch the handle's begin/fill row state, so N
    # threads may encode N shards of one batch over this one handle.

    def shard_begin(self, texts: Sequence[bytes]) -> Tuple[int, int]:
        """Tokenize+hash ``sanitize``d texts into a heap-owned shard object;
        returns ``(shard_handle, width)``."""
        arr = (ctypes.c_char_p * len(texts))(*texts)
        width = np.zeros(1, np.int32)
        shard = self._lib.ftok_shard_begin(self._handle, arr, len(texts), width)
        return shard, int(width[0])

    def shard_fill_into(self, shard: int, ids: np.ndarray, counts: np.ndarray,
                        rows: int, length: int) -> None:
        """Write one shard's padded rows into a C-contiguous row slice of the
        caller's output arrays."""
        if ids.dtype == np.int16:
            self._lib.ftok_shard_fill16(shard, ids, counts, rows, length)
        else:
            self._lib.ftok_shard_fill(shard, ids, counts, rows, length)

    def shard_destroy(self, shard: int) -> None:
        if shard:
            self._lib.ftok_shard_destroy(shard)

    def shard_json_begin(self, msgs_ptr, lens: np.ndarray, n: int,
                         key: bytes, status: np.ndarray,
                         span_start: np.ndarray,
                         span_len: np.ndarray) -> Tuple[int, int]:
        """Raw-JSON shard encode of ``n`` messages from ``msgs_ptr`` (a
        sub-pointer into the batch's one ``char*[]``), writing this shard's
        slice of the status/span arrays; fill it like a text shard."""
        width = np.zeros(1, np.int32)
        shard = self._lib.ftok_shard_json_begin(
            self._handle, msgs_ptr, lens, n, key, len(key),
            status, span_start, span_len, width)
        return shard, int(width[0])

    def encode_json(self, values: Sequence[bytes], key: bytes, rows: int,
                    max_tokens: Optional[int], pad_len,
                    want16: bool = False) -> Tuple[
                        np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                        np.ndarray, object]:
        """Raw-JSON batch encode: one native pass extracts the string field
        ``key`` of each message and cleans, tokenizes and hashes it.

        Returns (ids, counts, status, span_start, span_len, splice_ctx):
        padded (rows, L) arrays where malformed messages (status 0) are
        all-padding rows; each message's raw string literal span (quotes
        included); and the marshalled ``char*[n]`` message array, which
        ``build_frames`` splices from while the caller keeps the message
        bytes alive."""
        n = len(values)
        arr = (ctypes.c_char_p * n)(*values)
        lens = np.fromiter((len(v) for v in values), np.int32, n)
        status = np.zeros(n, np.int32)
        span_start = np.zeros(n, np.int32)
        span_len = np.zeros(n, np.int32)
        with self._call_lock:
            try:
                width = self._begin(self._lib.ftok_encode_json_begin,
                                    arr, lens, n, key, len(key),
                                    status, span_start, span_len)
                length = (max_tokens if max_tokens is not None
                          else pad_len(max(width, 1)))
                ids, counts = self._fill(rows, length, want16)
            finally:
                self._pair_check.finish()
        return ids, counts, status, span_start, span_len, arr


def build_frames(msgs_arr, span_start: np.ndarray, span_len: np.ndarray,
                 labels: np.ndarray, confs: np.ndarray,
                 label_jsons: Sequence[bytes]) -> Tuple[bytes, np.ndarray]:
    """Assemble the engine's classified-output frames in one native pass.

    ``msgs_arr`` is the ``char*[n]`` array an ``encode_json`` call returned
    as its splice context; ``span_start`` / ``span_len`` locate each
    message's string literal. ``labels`` (n,) int32 — rows outside
    ``[0, len(label_jsons))`` come back as EMPTY frames for the caller's
    Python path; ``confs`` (n,) float64. Returns ``(blob, ends)``: frame i
    is ``blob[ends[i-1]:ends[i]]``."""
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native featurizer library unavailable: "
                           f"{build_error}")
    n = len(span_start)
    ljs = (ctypes.c_char_p * len(label_jsons))(*label_jsons)
    ljlens = np.fromiter((len(s) for s in label_jsons), np.int32,
                         len(label_jsons))
    ends = np.empty(n, np.int64)
    # Mirrors the C++ per-row bound: 96 fixed + label json + text literal.
    cap = int(span_len.sum()) + n * (96 + int(ljlens.max(initial=0)))
    buf = ctypes.create_string_buffer(cap)
    total = lib.ftok_build_frames(msgs_arr, span_start, span_len, labels,
                                  confs, ljs, ljlens, len(label_jsons),
                                  n, buf, cap, ends)
    if total < 0:  # cannot happen while cap mirrors the C++ bound
        raise RuntimeError("frame buffer overflow")
    return ctypes.string_at(buf, total), ends
