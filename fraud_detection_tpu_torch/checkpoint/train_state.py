"""Mid-training checkpoint/resume for the iterative trainers — twin of
``fraud_detection_tpu/checkpoint/train_state.py``, with the same layout, so
a snapshot written by either package reads in the other's
``load_train_state``:

    <dir>/manifest.json   {"format": "fraud_detection_tpu.train_state",
                           "version": 1, "kind": ..., "progress": ...,
                           "fingerprint": {...}}
    <dir>/arrays.npz      accumulated per-round/per-tree arrays

A resumed fit builds the SAME ensemble an uninterrupted one builds
(tests/test_torch_train_state.py asserts array equality). A fit whose mesh
spans processes writes one snapshot, from its first process
(``save_train_state_once``), which every process resumes from. Writes are atomic
(write to <dir>.tmp, then rename) so a crash mid-save leaves the previous
snapshot intact, never a torn one. The fingerprint binds a snapshot to its
exact training setup (the port's config fields, data shape, bin-edge and
label checksums, the draws' identity); resuming under any other setup
raises instead of blending trees. The fingerprint names each package's own
config fields, so resuming across packages is refused.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np

FORMAT_NAME = "fraud_detection_tpu.train_state"
FORMAT_VERSION = 1


def data_fingerprint(cfg_fields: Dict, edges: np.ndarray, n_rows: int,
                     y: Optional[np.ndarray] = None,
                     extra: Optional[Dict] = None) -> Dict:
    """Deterministic identity of a training setup: trainer config, data shape,
    a checksum of the quantile bin edges (a function of X — matching edges on
    matching shapes is strong evidence of the same features), and a checksum
    of the labels (same X under relabeled y must refuse to resume: blending
    trees fit on different targets is the silent frankenmodel this exists to
    prevent)."""
    h = hashlib.sha256(np.ascontiguousarray(edges, np.float32).tobytes())
    fp = {
        "config": {k: (v if not isinstance(v, (np.floating, np.integer)) else v.item())
                   for k, v in sorted(cfg_fields.items())},
        "n_rows": int(n_rows),
        "n_features": int(edges.shape[0]),
        "edges_sha256": h.hexdigest(),
    }
    if y is not None:
        fp["y_sha256"] = hashlib.sha256(
            np.ascontiguousarray(y, np.float64).tobytes()).hexdigest()
    if extra:
        fp.update(extra)
    return fp


def mesh_extra(mesh) -> Dict:
    """Fingerprint fields for the device topology, merge-style:
    ``extra.update(mesh_extra(mesh))``. {} off-mesh, so the key is absent
    (not None) and older off-mesh snapshots still resume off-mesh; a
    snapshot taken on a mesh and resumed off it (or the reverse) drifts by
    that key. The axis names with their sizes (``shape``: a (data, model)
    mesh and a (data, seq) one of one size differ) and the device grid are
    kept: the data-axis sum adds the shards in grid order, so the same
    shape over other devices (or processes) would sum in another order and
    break bit-identical resume. The grid names each device by type and
    index. Where the mesh spans processes the grid is every process's, in
    rank order, beside the process count: the same fields on every process,
    so the one snapshot they share resumes on each and a snapshot of
    another process layout is refused by all (every process calls this)."""
    if mesh is None:
        return {}
    out = {"shape": {str(k): int(v) for k, v in mesh.shape.items()},
           "devices": [str(d) for d in mesh.devices.flat]}
    if mesh.process_count > 1:
        import torch.distributed as dist

        grids: list = [None] * mesh.process_count
        dist.all_gather_object(grids, out["devices"], group=mesh.group)
        out["devices"] = [d for g in grids for d in g]
        out["process"] = {"count": mesh.process_count}
    return {"mesh": out}


def save_train_state(path: str, kind: str, progress: int,
                     fingerprint: Dict, arrays: Dict[str, np.ndarray]) -> None:
    """Atomically write a snapshot: <path>.tmp is fully built then renamed
    over <path> (os.replace of a directory is atomic on POSIX when the target
    is first moved aside; we remove-then-rename, with the remove happening
    only after the tmp dir is complete)."""
    tmp = path + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})
    manifest = {
        "format": FORMAT_NAME,
        "version": FORMAT_VERSION,
        "kind": kind,
        "progress": int(progress),
        "fingerprint": fingerprint,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=2)
    if os.path.isdir(path):
        old = path + ".old"
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old)
    else:
        os.rename(tmp, path)


def save_train_state_once(mesh, path: str, kind: str, progress: int,
                          fingerprint: Dict,
                          arrays: Dict[str, np.ndarray]) -> None:
    """``save_train_state`` by the first process of ``mesh`` (every process
    holds the same arrays and calls this); the others wait until it is
    written, so none reads or moves on before the snapshot exists."""
    if mesh is None or mesh.process_count == 1:
        save_train_state(path, kind, progress, fingerprint, arrays)
        return
    import torch.distributed as dist

    if mesh.process_index == 0:
        save_train_state(path, kind, progress, fingerprint, arrays)
    dist.barrier(group=mesh.group)


def load_train_state(path: str) -> Optional[Tuple[str, int, Dict, Dict[str, np.ndarray]]]:
    """Load a snapshot -> (kind, progress, fingerprint, arrays), or None when
    no snapshot exists. A crash inside ``save_train_state``'s rename dance can
    leave the previous snapshot parked at ``<path>.old`` with nothing at
    ``path`` — that copy is consulted before declaring a cold start, so the
    atomicity guarantee (old or new, never neither) holds. A torn/unreadable
    snapshot raises (the caller decides whether to start over)."""
    manifest_path = os.path.join(path, "manifest.json")
    if not os.path.isfile(manifest_path):
        fallback = os.path.join(path + ".old", "manifest.json")
        if not os.path.isfile(fallback):
            return None
        path = path + ".old"
        manifest_path = fallback
    with open(manifest_path) as fh:
        manifest = json.load(fh)
    if manifest.get("format") != FORMAT_NAME:
        raise ValueError(f"{path} is not a {FORMAT_NAME} snapshot")
    if manifest.get("version") != FORMAT_VERSION:
        raise ValueError(
            f"{path} is a version-{manifest.get('version')} snapshot; this "
            f"code reads version {FORMAT_VERSION}")
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        arrays = {k: npz[k] for k in npz.files}
    return (manifest["kind"], int(manifest["progress"]),
            manifest["fingerprint"], arrays)


def load_for(path: str, kind: str, fingerprint: Dict
             ) -> Optional[Tuple[int, Dict[str, np.ndarray]]]:
    """Resume helper shared by the trainers: load the snapshot at ``path``,
    refuse a wrong-kind or wrong-setup one, return (progress, arrays) — or
    None for a cold start."""
    snap = load_train_state(path)
    if snap is None:
        return None
    saved_kind, progress, saved_fp, arrays = snap
    if saved_kind != kind:
        raise ValueError(f"{path} holds a {saved_kind!r} snapshot, not {kind!r}")
    check_fingerprint(saved_fp, fingerprint, path)
    return progress, arrays


def check_fingerprint(saved: Dict, current: Dict, path: str) -> None:
    """Refuse to resume under a different setup than the snapshot's."""
    if saved != current:
        drift = {k for k in set(saved) | set(current)
                 if saved.get(k) != current.get(k)}
        raise ValueError(
            f"training snapshot at {path} was taken under a different setup "
            f"(mismatched: {sorted(drift)}); delete it or rerun with the "
            f"original configuration")
