"""Serving pipeline: text in, (label, probability) out — twin of
``fraud_detection_tpu/models/pipeline.py``.

Two featurize legs feed the same scoring entries:

* host (``featurize_device=False``, the default): the native C++ encoder
  (thread-pool sharded for large chunks; the pure-Python rows without the
  library) hashes a micro-batch into packed (B, 2, L) int16 ids/counts, one
  host->device copy. ``predict_json_async`` starts from raw JSON message
  bytes instead of texts (no ``json.loads``);
* device (``featurize_device=True``): the host packs raw UTF-8 bytes (a
  memcpy) into ONE (B, W+4) uint8 staging tensor per chunk and the device
  runs tokenize/hash (the CUDA scan kernel) + count/pack + scoring.

Dispatch never synchronises with the device: results are copied back
asynchronously into pinned host memory and ``PendingPrediction.resolve``
waits for them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fraud_detection_tpu_torch.featurize.tfidf import (EncodedBatch,
                                                       HashingTfIdfFeaturizer)
from fraud_detection_tpu_torch.models import linear as linear_mod
from fraud_detection_tpu_torch.models import trees as trees_mod
from fraud_detection_tpu_torch.models.linear import LogisticRegression
from fraud_detection_tpu_torch.models.trees import TreeEnsemble
from fraud_detection_tpu_torch.utils.device import resolve_device


@dataclass
class PredictionBatch:
    labels: np.ndarray          # (N,) int32 — 1 = scam
    probabilities: np.ndarray   # (N,) float32 — p(class=1)

    def __iter__(self):
        return iter(zip(self.labels.tolist(), self.probabilities.tolist()))


def _pack_encoded(enc) -> np.ndarray:
    """Stack an EncodedBatch into ONE (B, 2, L) int16 staging array (ids in
    plane 0, uint16 counts bit-cast into plane 1), so a micro-batch crosses
    host->device as a single copy."""
    ids = np.asarray(enc.ids, np.int16)
    counts = np.asarray(enc.counts, np.uint16)
    return np.stack([ids, counts.view(np.int16)], axis=1)


def unpack_packed_host(packed) -> Tuple[np.ndarray, np.ndarray]:
    """Host inverse of ``_pack_encoded``: (B, 2, L) int16 -> (int16 ids,
    uint16 counts)."""
    packed = np.asarray(packed)
    return packed[:, 0, :], packed[:, 1, :].view(np.uint16)


class DeviceStats:
    """Per-pipeline device-path counters (the ``device`` block of engine
    health). Single-writer — the dispatching thread — with racy reads from
    health pollers by design. Snapshot keys match the JAX package's."""

    __slots__ = ("uploads", "upload_bytes", "chunks", "donated",
                 "pinned_bytes", "pins", "int8", "mesh_devices", "_rungs",
                 "featurize_path", "feat_bytes_in", "feat_rows",
                 "truncated_rows")

    def __init__(self, int8: bool = False):
        self.uploads = 0        # host->device copies
        self.upload_bytes = 0
        self.chunks = 0         # micro-batch chunks dispatched
        # PyTorch has no buffer donation (XLA's hand-over of an input buffer
        # to the program); the staging tensor is freed when its last
        # reference drops, so donation_hits stays 0.
        self.donated = 0
        self.pinned_bytes = 0   # model-side bytes made device-resident
        self.pins = 0           # pin_device() calls
        self.int8 = int8
        self.mesh_devices = 0   # single-device path (no mesh in this port)
        self._rungs: set = set()
        # "host" = Python encode on the host, "cuda" = the scan kernel,
        # "torch" = its plain torch version on the CPU.
        self.featurize_path = "host"
        self.feat_bytes_in = 0
        self.feat_rows = 0
        self.truncated_rows = 0

    def record_chunk(self, nbytes: int, transfers: int = 1,
                     rows: Optional[int] = None) -> None:
        self.chunks += 1
        self.uploads += transfers
        self.upload_bytes += nbytes
        if rows:
            self._rungs.add(rows)

    def record_featurize(self, nbytes: int, rows: int, truncated: int) -> None:
        self.feat_bytes_in += nbytes
        self.feat_rows += rows
        self.truncated_rows += truncated

    def per_chip_rungs(self) -> list:
        return sorted(self._rungs)

    def snapshot(self) -> dict:
        chunks = self.chunks
        return {
            "uploads": self.uploads,
            "upload_bytes": self.upload_bytes,
            "chunks": chunks,
            "uploads_per_chunk": (round(self.uploads / chunks, 3)
                                  if chunks else None),
            "donation_hits": self.donated,
            "pinned_bytes": self.pinned_bytes,
            "model_pins": self.pins,
            "int8": self.int8,
            "mesh_devices": self.mesh_devices,
            "per_chip_rungs": self.per_chip_rungs(),
            "featurize_path": self.featurize_path,
            "bytes_in_per_row": (round(self.feat_bytes_in / self.feat_rows, 1)
                                 if self.feat_rows else None),
            "truncated_rows": self.truncated_rows,
        }


class _HostCopy:
    """A device result on its way to the host: on CUDA an asynchronous copy
    into pinned memory plus the event that marks its completion; on the CPU
    the tensor itself."""

    __slots__ = ("_host", "_event")

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host, self._event = t, None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class PendingPrediction:
    """Unresolved device results from ``ServingPipeline.predict_async``:
    per-chunk (host copy, valid row count). Only p(class=1) crosses back
    (full (B, C) probas for multiclass trees); labels come from the same
    ``p > threshold`` comparison on the host."""

    def __init__(self, parts: List[Tuple[_HostCopy, int]],
                 threshold: float = 0.5, argmax: bool = False):
        self._parts = parts
        self.threshold = threshold
        self.argmax = argmax

    def resolve(self) -> PredictionBatch:
        if not self._parts:
            return PredictionBatch(np.empty(0, np.int32), np.empty(0, np.float32))
        host = np.concatenate([p.numpy()[:n] for p, n in self._parts])
        if self.argmax:
            labels = np.argmax(host, axis=-1).astype(np.int32)
            probs = host[:, 1].astype(np.float32)
        else:
            probs = host
            labels = (probs > np.float32(self.threshold)).astype(np.int32)
        return PredictionBatch(labels, probs)


class ServingPipeline:
    """Featurizer + classifier bound together behind ``predict(texts)``,
    on ``device`` (``cuda`` unless the caller passes ``device="cpu"``)."""

    def __init__(self, featurizer: HashingTfIdfFeaturizer,
                 model: "LogisticRegression | TreeEnsemble",
                 fold_idf: bool = True, batch_size: int = 256,
                 int8: bool = False, featurize_device: bool = False,
                 featurize_width: Optional[int] = None,
                 featurize_tokens: Optional[int] = None,
                 device="cuda"):
        if featurizer.num_features > np.iinfo(np.int16).max:
            raise ValueError(
                f"num_features={featurizer.num_features}: the packed (B, 2, L) "
                "int16 staging layout holds bucket ids below 32768 (wider "
                "feature spaces are not ported yet)")
        self.device = resolve_device(device)
        self.featurizer = featurizer
        self.batch_size = batch_size
        # Padding-bucket ladder: when set (ascending rungs), a partial chunk
        # pads to the smallest rung that fits instead of to batch_size.
        self.pad_ladder: Optional[Tuple[int, ...]] = None
        self.model = model.to(self.device)
        if isinstance(model, LogisticRegression):
            # Fold IDF into the weights so scoring sees raw counts.
            self._fused_model: Optional[LogisticRegression] = (
                self.model.fold_idf(featurizer.idf_array(self.device))
                if fold_idf else self.model)
            self._tree_idf = None
        else:
            # Trees branch on absolute TF-IDF values (the IDF rides along).
            self._fused_model = None
            self._tree_idf = featurizer.idf_array(self.device)
        self.int8 = bool(int8)
        self._q8 = None
        if self.int8:
            if self._fused_model is None:
                raise ValueError(
                    "int8 scoring requires a LogisticRegression pipeline — "
                    "tree ensembles serve fp32 (their traversal compares "
                    "thresholds, not dot products)")
            self._q8 = linear_mod.quantize_weights(self._fused_model)
        self.device_stats = DeviceStats(int8=self.int8)
        self._dev_feat = None
        if featurize_device:
            from fraud_detection_tpu_torch.featurize.device import DeviceFeaturizer

            self._dev_feat = DeviceFeaturizer(
                featurizer,
                **({"width": featurize_width}
                   if featurize_width is not None else {}),
                **({"tokens": featurize_tokens}
                   if featurize_tokens is not None else {}),
                device=self.device)
            self.device_stats.featurize_path = self._dev_feat.path
        self._pinned = False

    @classmethod
    def from_checkpoint(cls, path: str, device="cuda",
                        **kwargs) -> "ServingPipeline":
        """A pipeline over a native checkpoint (``checkpoint/native.py``,
        written by either package); ``kwargs`` go to the constructor."""
        from fraud_detection_tpu_torch.checkpoint.native import load_checkpoint

        featurizer, model = load_checkpoint(path, device=device)
        return cls(featurizer, model, device=device, **kwargs)

    def _pad_rows(self, n: int) -> int:
        """Row-padding target for an n-row chunk: the smallest ladder rung
        that fits (ladder configured), else batch_size."""
        ladder = self.pad_ladder
        if ladder:
            for b in ladder:
                if n <= b:
                    return b
        return self.batch_size

    def predict_json_async(self, values: Sequence[bytes],
                           text_field: str = "text"
                           ) -> Optional[Tuple["PendingPrediction", np.ndarray,
                                               np.ndarray, np.ndarray,
                                               Optional[list]]]:
        """Raw-JSON path: score message bytes without ``json.loads`` — one
        native pass per chunk from bytes to hashed rows
        (``HashingTfIdfFeaturizer.encode_json``), then the chunk's ONE
        packed upload and LR or tree scoring.

        Returns ``(pending, status, span_start, span_len, splice_ctxs)``:
        the pending prediction covers ALL rows positionally (status 0 rows
        are padding whose scores the caller discards), the spans locate each
        message's string literal, and ``splice_ctxs`` lists per-chunk
        ``(marshalled char*[] array, chunk_len)`` for native frame assembly
        (``featurize/native.build_frames``). None when unavailable: under
        device featurization (the engine then decodes JSON and
        ``predict_async`` ships raw bytes to the featurize kernel — the host
        tokenize/hash pass this path fronts is the work the kernel took
        over), and without the native library."""
        if self._dev_feat is not None:
            return None
        feat = self.featurizer
        tree_binary = self._tree_is_binary()
        parts: List[Tuple[_HostCopy, int]] = []
        stats: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        ctxs: List[Tuple[object, int]] = []
        for start in range(0, len(values), self.batch_size):
            chunk = values[start : start + self.batch_size]
            out = feat._encode_json(chunk, text_field,
                                    self._pad_rows(len(chunk)), None)
            if out is None:
                return None
            enc, status, span_start, span_len, ctx = out
            ctxs.append((ctx, len(chunk)))
            parts.append((self._dispatch_encoded(enc, tree_binary), len(chunk)))
            stats.append((status, span_start, span_len))
        pending = self._pending(parts)
        if not stats:
            empty = np.empty(0, np.int32)
            return pending, empty, empty, empty, ctxs
        return (pending, *(np.concatenate([s[k] for s in stats])
                           for k in range(3)), ctxs)

    def _tree_is_binary(self) -> bool:
        """Binary trees: p(class=1) > 0.5 equals argmax over the normalized
        proba (ties -> class 0 both ways), so a 1-D fetch is exact."""
        return isinstance(self.model, TreeEnsemble) and (
            self.model.kind in ("gbt", "xgboost")
            or self.model.leaf.shape[-1] == 2)

    def pin_device(self) -> dict:
        """Account every model-side constant resident on the device: fused
        LR weights (int8 codes + scales when enabled), tree arrays + IDF,
        and the featurize stop table. They were placed at construction;
        this counts them (once per pipeline) and returns the pin stats."""
        ds = self.device_stats
        if not self._pinned:
            src = self._fused_model if self._fused_model is not None else self.model
            tensors = [v for v in vars(src).values()
                       if isinstance(v, torch.Tensor)]
            if self._tree_idf is not None:
                tensors.append(self._tree_idf)
            if self._q8 is not None:
                tensors.extend(self._q8)
            if self._dev_feat is not None:
                tensors.append(self._dev_feat.stop_table())
            ds.pinned_bytes = int(sum(t.numel() * t.element_size()
                                      for t in tensors))
            ds.pins += 1
            self._pinned = True
        return {"pinned_bytes": ds.pinned_bytes, "model_pins": ds.pins}

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device, non_blocking=True)

    def _score(self, packed: torch.Tensor, tree_binary: bool) -> _HostCopy:
        """Score a packed (B, 2, L) device buffer and start the copy back."""
        if self._fused_model is None:
            ids, counts = linear_mod.unpack_rows(packed)
            proba = trees_mod.predict_proba_encoded(self.model, ids, counts,
                                                    self._tree_idf)
            p = proba[:, 1] if tree_binary else proba
        elif self._q8 is not None:
            p = linear_mod.prob_packed_q8(self._q8[0], self._q8[1],
                                          self._fused_model.intercept, packed)
        else:
            p = linear_mod.prob_packed(self._fused_model, packed)
        return _HostCopy(p)

    def _dispatch_encoded(self, enc: EncodedBatch,
                          tree_binary: bool) -> _HostCopy:
        """Host-encoded chunk: ONE packed host->device copy."""
        packed = _pack_encoded(enc)
        self.device_stats.record_chunk(packed.nbytes, transfers=1,
                                       rows=packed.shape[0])
        return self._score(self._upload(packed), tree_binary)

    def _dispatch_bytes(self, texts: Sequence[str], rows: int,
                        tree_binary: bool) -> _HostCopy:
        """Device-featurized chunk: pack raw UTF-8 bytes (the host's entire
        featurize leg — a memcpy), copy the ONE staging tensor, and launch
        featurize + scoring."""
        from fraud_detection_tpu_torch.ops.featurize_kernel import featurize_bytes

        dev = self._dev_feat
        staged, truncated = dev.pack(texts, batch_size=rows)
        ds = self.device_stats
        ds.record_featurize(staged.nbytes, len(texts), truncated)
        ds.record_chunk(staged.nbytes, transfers=1, rows=rows)
        packed, _ = featurize_bytes(self._upload(staged), dev.stop_table(),
                                    spec=dev.spec)
        return self._score(packed, tree_binary)

    def _pending(self, parts) -> PendingPrediction:
        if self._fused_model is not None:
            return PendingPrediction(parts, threshold=self._fused_model.threshold)
        return PendingPrediction(parts, argmax=not self._tree_is_binary())

    def predict_async(self, texts: Sequence[str]) -> PendingPrediction:
        """Featurize + dispatch device scoring WITHOUT waiting for results;
        ``resolve()`` on the handle materializes the PredictionBatch."""
        parts: List[Tuple[_HostCopy, int]] = []
        tree_binary = self._tree_is_binary()
        for start in range(0, len(texts), self.batch_size):
            chunk = list(texts[start : start + self.batch_size])
            n = len(chunk)
            rows = self._pad_rows(n)
            if self._dev_feat is not None:
                parts.append((self._dispatch_bytes(chunk, rows, tree_binary), n))
            else:
                enc = self.featurizer.encode(chunk, batch_size=rows)
                parts.append((self._dispatch_encoded(enc, tree_binary), n))
        return self._pending(parts)

    def predict(self, texts: Sequence[str]) -> PredictionBatch:
        """Score texts in fixed-size micro-batches (pads the tail batch)."""
        return self.predict_async(texts).resolve()

    def predict_one(self, text: str) -> Tuple[int, float]:
        batch = self.predict([text])
        return int(batch.labels[0]), float(batch.probabilities[0])

    def predict_encoded(self, ids: np.ndarray,
                        counts: np.ndarray) -> PredictionBatch:
        """Score ALREADY-ENCODED (B, L) hashed ids + term counts through the
        same dispatch entries as live serving; rows chunk and pad to the
        pipeline's shapes (padding slots are inert)."""
        ids = np.asarray(ids)
        counts = np.asarray(counts)
        if ids.shape != counts.shape or ids.ndim != 2:
            raise ValueError(
                f"ids {ids.shape} / counts {counts.shape} must be equal "
                "2-D (B, L) arrays")
        tree_binary = self._tree_is_binary()
        parts: List[Tuple[_HostCopy, int]] = []
        for start in range(0, ids.shape[0], self.batch_size):
            chunk_ids = ids[start : start + self.batch_size]
            chunk_counts = counts[start : start + self.batch_size]
            n = chunk_ids.shape[0]
            rows = self._pad_rows(n)
            if rows != n:
                chunk_ids = np.concatenate(
                    [chunk_ids, np.zeros((rows - n, ids.shape[1]), ids.dtype)])
                chunk_counts = np.concatenate(
                    [chunk_counts,
                     np.zeros((rows - n, counts.shape[1]), counts.dtype)])
            enc = EncodedBatch(ids=chunk_ids, counts=chunk_counts)
            parts.append((self._dispatch_encoded(enc, tree_binary), n))
        return self._pending(parts).resolve()
