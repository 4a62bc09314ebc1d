"""Build and load the port's hand-written CUDA kernels.

Each ``ops/csrc/<name>.cu`` exposes a plain C entry point. At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/torch_kernels/`` at the repository root (git-ignored), named by a
hash of its source and flags, so an edited source rebuilds and an unchanged
one loads straight away. The library is loaded with ``ctypes``. Nothing
builds at import time; a failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = cand if os.path.exists(cand) else None
    if found is None:
        raise RuntimeError("nvcc not found (PATH or CUDA_HOME): cannot build "
                           "the CUDA kernels")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (its content hash in the name)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its current build exists; returns
    the library path. nvcc's output (``-Xptxas -v`` register and spill
    report) is kept beside it as ``.log``."""
    return build_all([name])[0]


def build_all(names) -> list:
    """Compile every ``csrc/<name>.cu`` whose current build is missing, one
    nvcc process per source, all started together; returns the library
    paths in order. Raises with nvcc's stderr if any build fails."""
    outs = [library_path(n) for n in names]
    todo = [(n, out) for n, out in zip(names, outs) if not out.exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs.append((name, out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed building {name}.cu "
                          f"(exit {proc.returncode}):\n{stderr}")
            continue
        out.with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build_log(name: str) -> str:
    """nvcc's output from the current build of ``name`` ("" before one)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per
    process."""
    return ctypes.CDLL(str(build(name)))
