"""FC203-FC204 — hot-path device-sync / ladder-bypass lint; the port's
counterpart of ``fraud_detection_tpu/analysis/jaxlint.py``.

The serving hot path stays fast only while every batch hits an
already-warmed shape and never blocks on a device scalar. Two
statically-checkable ways to break that:

* **FC203** ``.item()`` / ``float(x[i])`` / ``int(x[i])`` in a hot-loop
  function is a per-row device sync — the engine's paths convert whole
  batches with ``.tolist()`` once instead (stream/engine.py). Scope:
  :data:`~fraud_detection_tpu_torch.analysis.entrypoints.HOT_PATHS`.
* **FC204** a literal batch dimension at a predict call site in a hot
  function that is not a padding-ladder rung shape: the ladder prewarms
  power-of-two rungs (sched/batcher.py — ``default_ladder`` /
  ``ladder_candidates`` emit power-of-two geometries for the power-of-two
  batch sizes serve runs), so a stray literal like 37 pads to an
  unwarmed shape on the hot path.

The reference's FC201 (``jax.jit`` inside a function body) and FC202 (a
Python branch on a traced value inside a jitted function) have no
counterpart here: the port traces nothing — it has no ``jit`` and no
``torch.compile`` — so neither hazard can arise.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Set

from fraud_detection_tpu_torch.analysis.core import Finding
from fraud_detection_tpu_torch.analysis.entrypoints import HOT_PATHS

_PREDICT_FNS = {"predict", "predict_async", "predict_json_async",
                "predict_one"}


def analyze(files: Sequence, *,
            hot_paths: Optional[Set[str]] = None) -> List[Finding]:
    hot_paths = HOT_PATHS if hot_paths is None else hot_paths
    findings: List[Finding] = []
    for sf in files:
        findings += _hot_path_rules(sf, hot_paths)
    return findings


def _hot_path_rules(sf, hot_paths: Set[str]) -> List[Finding]:
    findings: List[Finding] = []
    for cls in sf.tree.body:
        if isinstance(cls, ast.ClassDef):
            for fn in cls.body:
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    key = f"{sf.relpath}::{cls.name}.{fn.name}"
                    if key in hot_paths:
                        findings += _scan_hot_function(sf, key, fn)
        elif isinstance(cls, (ast.FunctionDef, ast.AsyncFunctionDef)):
            key = f"{sf.relpath}::{cls.name}"
            if key in hot_paths:
                findings += _scan_hot_function(sf, key, cls)
    return findings


def _scan_hot_function(sf, key: str, fn: ast.AST) -> List[Finding]:
    findings: List[Finding] = []
    where = key.split("::", 1)[1]
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        callee = node.func
        # .item(): always a device sync when it matters, never batch-cheap.
        if isinstance(callee, ast.Attribute) and callee.attr == "item":
            findings.append(Finding(
                "FC203", sf.relpath, node.lineno,
                f"{where}: .item() in a hot-loop function is a per-row "
                f"device sync — convert the whole batch once with "
                f".tolist() / np.asarray outside the row loop"))
        # float(x[i]) / int(x[i]): per-element scalar conversion in a row
        # loop (the numpy/tensor scalar path costs ~0.1-1us per element
        # and blocks on the device for CUDA tensors).
        if (isinstance(callee, ast.Name) and callee.id in ("float", "int")
                and node.args
                and isinstance(node.args[0], ast.Subscript)):
            findings.append(Finding(
                "FC203", sf.relpath, node.lineno,
                f"{where}: {callee.id}() on a subscripted array element in "
                f"a hot-loop function — per-row scalar conversion; use a "
                f"vectorized .tolist() before the loop"))
        # FC204: literal batch dims at predict call sites.
        if (isinstance(callee, ast.Attribute)
                and callee.attr in _PREDICT_FNS and node.args):
            dim = _literal_leading_dim(node.args[0])
            if dim is not None and not _ladder_aligned(dim):
                findings.append(Finding(
                    "FC204", sf.relpath, node.lineno,
                    f"{where}: {callee.attr}() with literal batch dim "
                    f"{dim} — not a padding-ladder rung shape (rungs are "
                    f"power-of-two; sched/batcher.py), so this pads to an "
                    f"unwarmed shape and compiles on the hot path"))
    return findings


def _literal_leading_dim(node: ast.AST) -> Optional[int]:
    """Statically-known batch length of an argument expression:
    ``[...] * N``, ``N * [...]``, or a literal list/tuple."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for side, other in ((node.left, node.right),
                            (node.right, node.left)):
            if (isinstance(side, ast.Constant)
                    and isinstance(side.value, int)
                    and isinstance(other, (ast.List, ast.Tuple))):
                return side.value * len(other.elts)
    if isinstance(node, (ast.List, ast.Tuple)):
        return len(node.elts)
    return None


def _ladder_aligned(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0
