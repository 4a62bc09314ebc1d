#!/usr/bin/env python
"""Sanitizer drive of the port's native featurizer ABI (ASan+UBSan / TSan);
twin of ``fraud_detection_tpu/native/san_driver.py``.

The multi-thread ``ftok_shard_*`` entry points run N pool threads over ONE
shared C++ handle — exactly the shape a race detector exists for, and the
serve CLI's default host featurize path. This script is the workload run
inside an instrumented process (tests/test_torch_sanitizers.py, and the
sanitizer step of ``chip_smoke.py``):

  1. byte parity: serial ``encode()`` vs thread-pool sharded assembly, both
     int32/float32 and the int16/uint16 wire dtypes, over a corpus with
     unicode, embedded NULs, empty strings and stopwords; and serial
     ``encode_json()`` vs its sharded twin;
  2. a shard hammer: several driver threads concurrently shard-encoding
     over the SAME handle (the documented read-only-handle contract);
  3. the raw-JSON scanner + native frame assembler (``encode_json`` /
     ``build_frames``) for ASan/UBSan coverage of the parsing/formatting
     paths, with frame-level JSON round-trip checks.

It loads ``featurize/native.py`` and ``featurize/parallel.py`` BY FILE PATH
under a stub package, so the sanitized process imports no torch:

    LD_PRELOAD=$(gcc -print-file-name=libasan.so) \\
    ASAN_OPTIONS=detect_leaks=0 \\
    python fraud_detection_tpu_torch/native/san_driver.py --variant asan

Exit 0 = every check passed and the sanitizer stayed silent (sanitizer
findings abort the process via halt_on_error / -fno-sanitize-recover).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import random
import sys
import threading
import types

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG_DIR = os.path.dirname(_HERE)
_PKG = "fraud_detection_tpu_torch"


def _load_by_path(modname: str, relpath: str):
    """Import a package module from its file WITHOUT running the package
    __init__ chain of the modules it lives in."""
    if _PKG not in sys.modules:
        stub = types.ModuleType(_PKG)
        stub.__path__ = [_PKG_DIR]
        sys.modules[_PKG] = stub
    spec = importlib.util.spec_from_file_location(
        modname, os.path.join(_PKG_DIR, relpath))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


_STOPWORDS = ["the", "a", "an", "is", "to", "and", "of", "in", "you", "your"]


def _corpus(n: int, seed: int) -> list:
    rng = random.Random(seed)
    words = ["urgent", "account", "suspended", "verify", "social",
             "security", "winner", "congratulations", "appointment",
             "insurance", "transfer", "immediately", "the", "you", "claim",
             "café", "naïve", "詐欺", "\U0001f4b8"]
    texts = []
    for i in range(n):
        k = rng.randrange(0, 60)
        t = " ".join(rng.choice(words) for _ in range(k))
        if i % 17 == 0:
            t += " embedded\x00nul"
        if i % 23 == 0:
            t = ""
        if i % 29 == 0:
            t = "x" * 4000   # one long row per few shards
        texts.append(t)
    return texts


def _pad16(w: int) -> int:
    return max(16, (w + 15) // 16 * 16)


def check(label: str, ok: bool, detail: str = "") -> None:
    if not ok:
        print(f"FAIL {label}: {detail}", file=sys.stderr)
        sys.exit(1)
    print(f"ok   {label}")


def _json_values(texts: list) -> list:
    values = []
    for i, t in enumerate(texts):
        if i % 13 == 0:
            values.append(b'{"broken json')           # malformed
        elif i % 11 == 0:
            values.append(json.dumps({"other": t}).encode())  # no field
        else:
            values.append(json.dumps({"text": t}).encode())
    return values


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--variant", default=os.environ.get(
        "FRAUD_TPU_NATIVE_VARIANT", "plain"))
    parser.add_argument("--threads", type=int, default=8)
    parser.add_argument("--rounds", type=int, default=6)
    parser.add_argument("--rows", type=int, default=512)
    args = parser.parse_args()
    if args.variant != "plain":
        os.environ["FRAUD_TPU_NATIVE_VARIANT"] = args.variant

    native = _load_by_path(f"{_PKG}.featurize.native",
                           os.path.join("featurize", "native.py"))
    parallel = _load_by_path(f"{_PKG}.featurize.parallel",
                             os.path.join("featurize", "parallel.py"))
    import numpy as np

    lib = native.load_library()
    check("library loads", lib is not None,
          f"variant={args.variant!r}: {native.build_error}")
    feat = native.NativeFeaturizer(_STOPWORDS, num_features=4096,
                                   binary=False, remove_stopwords=True)

    texts = _corpus(args.rows, seed=1234)
    rows = args.rows + 32          # trailing all-padding rows, like serving

    # --- 1. serial vs sharded byte parity (both wire dtypes) -------------
    values = _json_values(texts)
    for want16 in (False, True):
        ids_s, cnt_s = feat.encode(texts, rows, None, _pad16, want16=want16)
        js = feat.encode_json(values, b"text", rows, None, _pad16, want16)
        for workers in (2, 3, args.threads):
            ids_p, cnt_p = parallel.encode_sharded_native(
                feat, texts, rows, None, _pad16, want16, workers)
            check(f"parity want16={want16} workers={workers}",
                  (ids_s.dtype == ids_p.dtype
                   and np.array_equal(ids_s, ids_p)
                   and np.array_equal(cnt_s, cnt_p)),
                  "sharded encode diverged from serial bytes")
            jp = parallel.encode_json_sharded_native(
                feat, values, b"text", rows, None, _pad16, want16, workers)
            check(f"json parity want16={want16} workers={workers}",
                  all(np.array_equal(a, b) for a, b in zip(js[:5], jp[:5])),
                  "sharded encode_json diverged from serial bytes")

    # --- 2. concurrent shard hammer over ONE handle ----------------------
    errors: list = []

    def hammer(tid: int) -> None:
        try:
            for r in range(args.rounds):
                sub = _corpus(128 + 16 * (tid % 3), seed=tid * 997 + r)
                ids_a, cnt_a = parallel.encode_sharded_native(
                    feat, sub, len(sub), None, _pad16,
                    bool(r % 2), 2 + (tid + r) % 3)
                if int(ids_a.shape[0]) != len(sub):
                    raise AssertionError("row count mismatch")
                # raw ABI: begin/fill/destroy directly, same handle
                buf = [feat.sanitize(t) for t in sub[: 64]]
                shard, width = feat.shard_begin(buf)
                try:
                    length = _pad16(max(width, 1))
                    ids = np.zeros((64, length), np.int32)
                    cnt = np.zeros((64, length), np.float32)
                    feat.shard_fill_into(shard, ids, cnt, 64, length)
                finally:
                    feat.shard_destroy(shard)
        except BaseException as e:  # noqa: BLE001 — relayed to the exit code
            errors.append((tid, repr(e)))

    threads = [threading.Thread(target=hammer, args=(i,), daemon=True)
               for i in range(args.threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(f"shard hammer x{args.threads}", not errors, repr(errors[:3]))

    # --- 3. raw-JSON scanner + native frame assembly ---------------------
    values = values[:256]
    ids, cnt, status, s_start, s_len, arr = feat.encode_json(
        values, b"text", len(values), None, _pad16)
    ok = all((status[i] == 0) or
             (values[i][s_start[i]] == ord('"')
              and values[i][s_start[i] + s_len[i] - 1] == ord('"'))
             for i in range(len(values)))
    check("encode_json spans", ok, "span does not cover quoted literal")
    n = len(values)
    labels = np.where(status == 0, -1, np.arange(n) % 2).astype(np.int32)
    confs = np.linspace(0.0, 1.0, n).astype(np.float64)
    blob, ends = native.build_frames(arr, s_start, s_len, labels, confs,
                                     [b'"benign"', b'"fraud"'])
    start = 0
    for i, end in enumerate(ends.tolist()):
        frame = blob[start:end]
        start = end
        if labels[i] < 0:
            check("malformed frame empty", not frame, repr(frame))
            continue
        rec = json.loads(frame)
        if rec["prediction"] != int(labels[i]):
            check("frame label", False, repr(rec))
    check("build_frames round-trip", True)
    print(f"san_driver: all checks passed (variant={args.variant}, "
          f"threads={args.threads}, rounds={args.rounds})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
