"""Build and load the port's hand-written CUDA kernels.

Each ``ops/csrc/<name>.cu`` exposes a plain C entry point. At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/torch_kernels/`` at the repository root (git-ignored), named by a
hash of its source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header rebuilds and an unchanged one loads straight away.
The library is loaded with ``ctypes``. Nothing builds at import time; a
failed build raises with nvcc's stderr.

Serving threads share the kernels: a process-wide lock makes a first call
from several threads at once build and load each library exactly once, and
``count_launch`` keeps every wrapper's ``.launches`` count exact under
threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


class KernelError(RuntimeError):
    """A hand-written kernel failed to build or to launch: a fault of the
    card's toolchain or of the card, never of the data, so no lane may log it
    and carry on (``utils/device.is_device_fault``)."""


# Held across a build and a load: two threads that miss at the same moment
# must not start two nvcc runs writing one library (re-entrant: ``load``
# builds under it).
_BUILD_LOCK = threading.RLock()
_loaded: dict = {}
_COUNT_LOCK = threading.Lock()


def count_launch(fn, attr: str = "launches") -> None:
    """Add one to ``fn.<attr>``, a wrapper's launch count. ``+=`` on an
    attribute is a read, an add and a store, which threads launching the
    same kernel can interleave and lose a count by; this takes a lock."""
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + 1)


NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = cand if os.path.exists(cand) else None
    if found is None:
        raise KernelError("nvcc not found (PATH or CUDA_HOME): cannot build "
                           "the CUDA kernels")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (a hash of its content, of the
    shared headers ``csrc/*.cuh`` and of the flags in the name)."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
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
    with _BUILD_LOCK:
        return _build_all(list(names))


def _build_all(names) -> list:
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
        raise KernelError("\n".join(failed))
    return outs


def build_log(name: str) -> str:
    """nvcc's output from the current build of ``name`` ("" before one)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per
    process, whichever threads ask first."""
    with _BUILD_LOCK:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build(name)))
        return lib
