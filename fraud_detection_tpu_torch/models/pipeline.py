"""Serving pipeline: text in, (label, probability) out — twin of
``fraud_detection_tpu/models/pipeline.py``.

Two featurize legs feed the same scoring entries:

* host (``featurize_device=False``, the default): the native C++ encoder
  (thread-pool sharded for large chunks; the pure-Python rows without the
  library) hashes a micro-batch into packed (B, 2, L) int16 ids/counts, one
  host->device copy; a feature space past int16 (num_features > 32767,
  Spark's HashingTF default is 262,144) keeps two arrays instead, int32 ids
  and uint16 counts, two copies. ``predict_json_async`` starts from raw
  JSON message bytes instead of texts (no ``json.loads``);
* device (``featurize_device=True``): the host packs raw UTF-8 bytes (a
  memcpy) into ONE (B, W+4) uint8 staging tensor per chunk and the device
  runs tokenize/hash (the CUDA scan kernel) + count/pack + scoring.

Dispatch never synchronises with the device: results are copied back
asynchronously into pinned host memory and ``PendingPrediction.resolve``
waits for them.

With a ``mesh`` (``parallel/mesh.py``; ``parallel/serving.py`` packages it
for the serving lane) every chunk is row-sharded over the mesh's data axis:
each shard is uploaded to its own device, featurized there (under device
featurize, one ``featurize_packed`` launch a shard) and scored by that
device's replica of the model, and the shards' results come back in row
order, the padding rows dropped at resolve — the reference's
``_device_rows``/``_device_packed``/``_dispatch_bytes`` placed by
``shard_rows``. Scoring has no cross-row reduction, so the shards' labels
and probabilities equal the single-device pipeline's.

The reference's ``donation_effective`` has no twin, by design: PyTorch has
no buffer donation, so ``DeviceStats.donation_hits`` stays 0 as it does on
the reference's CPU.
"""

from __future__ import annotations

import threading
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
from fraud_detection_tpu_torch.parallel.mesh import DATA_AXIS, pad_to_multiple
from fraud_detection_tpu_torch.utils.device import resolve_device


@dataclass
class PredictionBatch:
    labels: np.ndarray          # (N,) int32 — 1 = scam
    probabilities: np.ndarray   # (N,) float32 — p(class=1)

    def __iter__(self):
        return iter(zip(self.labels.tolist(), self.probabilities.tolist()))


def _pack_encoded(enc) -> Optional[np.ndarray]:
    """Stack an EncodedBatch into ONE (B, 2, L) int16 staging array (ids in
    plane 0, uint16 counts bit-cast into plane 1), so a micro-batch crosses
    host->device as a single copy. None when the featurizer widened ids
    past int16 (num_features > 32767): that configuration keeps the
    two-array upload."""
    ids = np.asarray(enc.ids)
    counts = np.asarray(enc.counts)
    if ids.dtype != np.int16 or counts.dtype != np.uint16:
        return None
    return np.stack([ids, counts.view(np.int16)], axis=1)


def unpack_packed_host(packed) -> Tuple[np.ndarray, np.ndarray]:
    """Host inverse of ``_pack_encoded``: (B, 2, L) int16 -> (int16 ids,
    uint16 counts)."""
    packed = np.asarray(packed)
    return packed[:, 0, :], packed[:, 1, :].view(np.uint16)


class DeviceStats:
    """Per-pipeline device-path counters (the ``device`` block of engine
    health). Every worker thread that shares the pipeline dispatches
    through it, so the updates (each a read, an add and a store) and the
    rung set's reads take a lock; health pollers read the plain counters
    without it. Snapshot keys match the JAX package's."""

    __slots__ = ("uploads", "upload_bytes", "chunks", "donated",
                 "pinned_bytes", "pins", "int8", "mesh_devices", "_rungs",
                 "featurize_path", "feat_bytes_in", "feat_rows",
                 "truncated_rows", "_lock")

    def __init__(self, int8: bool = False, mesh_devices: int = 0):
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
        # chips on the mesh's data axis (0 = the single-device path); every
        # distinct padded row count dispatched is kept, so health shows the
        # per-chip rungs the scheduler's prewarm warmed before traffic
        self.mesh_devices = mesh_devices
        self._rungs: set = set()
        # "host" = Python encode on the host, "cuda" = the scan kernel,
        # "torch" = its plain torch version on the CPU.
        self.featurize_path = "host"
        self.feat_bytes_in = 0
        self.feat_rows = 0
        self.truncated_rows = 0
        self._lock = threading.Lock()

    def record_chunk(self, nbytes: int, transfers: int = 1,
                     rows: Optional[int] = None) -> None:
        with self._lock:
            self.chunks += 1
            self.uploads += transfers
            self.upload_bytes += nbytes
            if rows:
                self._rungs.add(rows)

    def record_featurize(self, nbytes: int, rows: int, truncated: int) -> None:
        with self._lock:
            self.feat_bytes_in += nbytes
            self.feat_rows += rows
            self.truncated_rows += truncated

    def record_pin(self, nbytes: int) -> None:
        with self._lock:
            self.pinned_bytes = nbytes
            self.pins += 1

    def per_chip_rungs(self) -> list:
        """Distinct padded row counts dispatched, per chip of the data axis
        (the global rungs on the single-device path)."""
        dp = max(1, self.mesh_devices)
        # under the lock: a set that another thread adds to while this
        # iterates raises "Set changed size during iteration"
        with self._lock:
            return sorted({-(-r // dp) for r in self._rungs})

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


class _ShardCopies:
    """A mesh chunk's per-shard host copies, read back in row order."""

    __slots__ = ("_parts",)

    def __init__(self, parts: List[_HostCopy]):
        self._parts = parts

    def numpy(self) -> np.ndarray:
        return np.concatenate([p.numpy() for p in self._parts])


class _Replica:
    """One device's copy of the scoring state: the model (IDF folded for
    LR), the trees' IDF, the int8 codes and scales, the featurize stop
    table."""

    __slots__ = ("device", "model", "fused", "tree_idf", "q8", "stop")

    def __init__(self, device, model, fused, tree_idf, q8, stop):
        self.device, self.model, self.fused = device, model, fused
        self.tree_idf, self.q8, self.stop = tree_idf, q8, stop

    def to(self, device) -> "_Replica":
        move = lambda t: None if t is None else t.to(device)
        return _Replica(device, self.model.to(device),
                        None if self.fused is None else self.fused.to(device),
                        move(self.tree_idf),
                        None if self.q8 is None else tuple(move(t) for t in self.q8),
                        move(self.stop))

    def tensors(self) -> List[torch.Tensor]:
        src = self.fused if self.fused is not None else self.model
        out = [v for v in vars(src).values() if isinstance(v, torch.Tensor)]
        for t in (self.tree_idf, self.stop, *(self.q8 or ())):
            if t is not None:
                out.append(t)
        return out


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
    on ``device`` (``cuda`` unless the caller passes ``device="cpu"``), or
    row-sharded over ``mesh``'s data devices (``device`` is then the
    mesh's first device)."""

    def __init__(self, featurizer: HashingTfIdfFeaturizer,
                 model: "LogisticRegression | TreeEnsemble",
                 fold_idf: bool = True, batch_size: int = 256,
                 int8: bool = False, featurize_device: bool = False,
                 featurize_width: Optional[int] = None,
                 featurize_tokens: Optional[int] = None,
                 device="cuda", mesh=None):
        if mesh is not None and mesh.process_count > 1:
            raise ValueError(
                "a serving mesh spans this process's devices only: run one "
                "engine per process over its own partitions")
        self.mesh = mesh
        self.device = mesh.home if mesh is not None else resolve_device(device)
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
        self.device_stats = DeviceStats(
            int8=self.int8,
            mesh_devices=0 if mesh is None else mesh.shape[DATA_AXIS])
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
        # one replica of the scoring state per distinct mesh device, made
        # here (never lazily: N engine threads dispatch onto this pipeline)
        self._replicas = None
        if mesh is not None:
            home = _Replica(self.device, self.model, self._fused_model,
                            self._tree_idf, self._q8,
                            None if self._dev_feat is None
                            else self._dev_feat.stop_table())
            by_dev = {self.device: home}
            for d in mesh.data_devices:
                if d not in by_dev:
                    by_dev[d] = home.to(d)
            self._replicas = [by_dev[d] for d in mesh.data_devices]
        self._pinned = False
        self._pin_lock = threading.Lock()

    @property
    def fused_model(self) -> LogisticRegression:
        """The serving model with the IDF folded into its weights (it scores
        raw counts); a tree pipeline has none."""
        if self._fused_model is None:
            raise TypeError("fused sparse scoring only applies to "
                            "LogisticRegression")
        return self._fused_model

    @classmethod
    def from_checkpoint(cls, path: str, device="cuda",
                        **kwargs) -> "ServingPipeline":
        """A pipeline over a native checkpoint (``checkpoint/native.py``,
        written by either package); ``kwargs`` go to the constructor."""
        from fraud_detection_tpu_torch.checkpoint.native import load_checkpoint

        featurizer, model = load_checkpoint(path, device=device)
        return cls(featurizer, model, device=device, **kwargs)

    @classmethod
    def from_spark_artifact(cls, artifact, batch_size: int = 256, mesh=None,
                            device="cuda", **kwargs) -> "ServingPipeline":
        """Serve a Spark ``PipelineModel`` (``checkpoint/spark_artifact.py``):
        the hashing HashingTF + LogisticRegression shape and the training
        script's CountVectorizer + tree shapes. ``kwargs`` (``int8``,
        ``featurize_device``, ...) go to the constructor."""
        from fraud_detection_tpu_torch.checkpoint.spark_artifact import (
            RegexTokenizerStage)
        from fraud_detection_tpu_torch.featurize.text import StopWordFilter
        from fraud_detection_tpu_torch.featurize.tfidf import (
            VocabTfIdfFeaturizer)

        for s in artifact.stages:
            if isinstance(s, RegexTokenizerStage):
                raise NotImplementedError(
                    "artifact uses RegexTokenizer; only plain Tokenizer "
                    f"semantics are implemented (pattern={s.pattern!r}, "
                    f"gaps={s.gaps})")
        dev = mesh.home if mesh is not None else resolve_device(device)
        htf = artifact.hashing_tf
        cv = artifact.count_vectorizer
        idf_stage = artifact.idf
        lr = artifact.logistic_regression
        tree = artifact.tree_ensemble
        sw = artifact.stopwords
        stop = (StopWordFilter(sw.stopwords, sw.case_sensitive) if sw
                else StopWordFilter())
        idf = None if idf_stage is None else idf_stage.idf.astype(np.float32)
        if htf is not None:
            featurizer: HashingTfIdfFeaturizer = HashingTfIdfFeaturizer(
                num_features=htf.num_features, idf=idf, binary_tf=htf.binary,
                stop_filter=stop, remove_stopwords=sw is not None)
        elif cv is not None:
            featurizer = VocabTfIdfFeaturizer(
                vocabulary=cv.vocabulary, min_tf=cv.min_tf, idf=idf,
                binary_tf=cv.binary, stop_filter=stop,
                remove_stopwords=sw is not None)
        else:
            raise ValueError(
                "artifact has no HashingTF or CountVectorizerModel stage "
                f"(got {[type(s).__name__ for s in artifact.stages]})")
        if idf_stage is not None:
            featurizer.doc_freq = idf_stage.doc_freq
            featurizer.num_docs = idf_stage.num_docs
        if lr is not None:
            model: "LogisticRegression | TreeEnsemble" = (
                LogisticRegression.from_arrays(lr.coefficients, lr.intercept,
                                               threshold=lr.threshold,
                                               device=dev))
        elif tree is not None:
            model = trees_mod.from_spark_stage(tree, device=dev)
        else:
            raise ValueError(
                "artifact has no LogisticRegression or tree classifier stage "
                f"(got {[type(s).__name__ for s in artifact.stages]})")
        return cls(featurizer, model, fold_idf=True, batch_size=batch_size,
                   mesh=mesh, device=dev, **kwargs)

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
        this counts them (once per pipeline, however many engines start on
        it at once) and returns the pin stats."""
        ds = self.device_stats
        with self._pin_lock:
            if not self._pinned:
                src = (self._fused_model if self._fused_model is not None
                       else self.model)
                tensors = [v for v in vars(src).values()
                           if isinstance(v, torch.Tensor)]
                if self._tree_idf is not None:
                    tensors.append(self._tree_idf)
                if self._q8 is not None:
                    tensors.extend(self._q8)
                if self._dev_feat is not None:
                    tensors.append(self._dev_feat.stop_table())
                if self._replicas is not None:
                    # every mesh device's copy, each once
                    seen = {r.device for r in self._replicas[:1]}
                    for r in self._replicas:
                        if r.device not in seen:
                            seen.add(r.device)
                            tensors.extend(r.tensors())
                ds.record_pin(int(sum(t.numel() * t.element_size()
                                      for t in tensors)))
                self._pinned = True
        return {"pinned_bytes": ds.pinned_bytes, "model_pins": ds.pins}

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device, non_blocking=True)

    def _score(self, rows: Tuple[torch.Tensor, torch.Tensor],
               tree_binary: bool,
               replica: Optional[_Replica] = None) -> _HostCopy:
        """Score device rows (ids int64, counts float32; unpacked from the
        packed buffer or the two-array layout) and start the copy back;
        ``replica`` is the mesh device's copy of the model that the rows
        live beside (None: the pipeline's own)."""
        if replica is None:
            model, fused, tree_idf, q8 = (self.model, self._fused_model,
                                          self._tree_idf, self._q8)
        else:
            model, fused, tree_idf, q8 = (replica.model, replica.fused,
                                          replica.tree_idf, replica.q8)
        ids, counts = rows
        if fused is None:
            proba = trees_mod.predict_proba_encoded(model, ids, counts,
                                                    tree_idf)
            p = proba[:, 1] if tree_binary else proba
        elif q8 is not None:
            p = linear_mod.prob_rows_q8(q8[0], q8[1], fused.intercept, ids,
                                        counts)
        else:
            p = linear_mod.prob_rows(fused, ids, counts)
        return _HostCopy(p)

    def _shards(self, staged: np.ndarray) -> List[np.ndarray]:
        """A chunk's host rows cut into one shard per data device, padded
        with zero rows to a data-axis multiple (``shard_rows``'s rule)."""
        dp = len(self._replicas)
        rows = pad_to_multiple(staged.shape[0], dp)
        if rows != staged.shape[0]:
            staged = np.concatenate([staged, np.zeros(
                (rows - staged.shape[0], *staged.shape[1:]), staged.dtype)])
        return np.split(staged, dp)

    def _dispatch_encoded(self, enc: EncodedBatch, tree_binary: bool):
        """Host-encoded chunk: ONE packed host->device copy (one a shard
        under a mesh), or, past int16 ids, two: the int32 ids and the
        uint16 counts (as int16 bits)."""
        packed = _pack_encoded(enc)
        if packed is None:
            arrays = (np.asarray(enc.ids, np.int32),
                      np.asarray(enc.counts, np.uint16).view(np.int16))
            unpack = linear_mod.unpack_wide_rows
        else:
            arrays = (packed,)
            unpack = linear_mod.unpack_rows
        nbytes = sum(a.nbytes for a in arrays)
        rows = arrays[0].shape[0]
        if self._replicas is None:
            self.device_stats.record_chunk(nbytes, transfers=len(arrays),
                                           rows=rows)
            return self._score(unpack(*(self._upload(a) for a in arrays)),
                               tree_binary)
        self.device_stats.record_chunk(
            nbytes, transfers=len(arrays) * len(self._replicas), rows=rows)
        parts = []
        shards = [self._shards(a) for a in arrays]
        for i, r in enumerate(self._replicas):
            dev_arrays = [torch.from_numpy(s[i]).to(r.device, non_blocking=True)
                          for s in shards]
            parts.append(self._score(unpack(*dev_arrays), tree_binary, r))
        return _ShardCopies(parts)

    def _dispatch_bytes(self, texts: Sequence[str], rows: int,
                        tree_binary: bool):
        """Device-featurized chunk: pack raw UTF-8 bytes (the host's entire
        featurize leg — a memcpy), copy the ONE staging tensor, and launch
        featurize + scoring; under a mesh, a staging shard, a featurize
        launch and a scoring pass per data device."""
        from fraud_detection_tpu_torch.ops.featurize_kernel import featurize_bytes

        dev = self._dev_feat
        staged, truncated = dev.pack(texts, batch_size=rows)
        ds = self.device_stats
        ds.record_featurize(staged.nbytes, len(texts), truncated)
        if self._replicas is None:
            ds.record_chunk(staged.nbytes, transfers=1, rows=rows)
            packed, _ = featurize_bytes(self._upload(staged), dev.stop_table(),
                                        spec=dev.spec)
            return self._score(linear_mod.unpack_rows(packed), tree_binary)
        ds.record_chunk(staged.nbytes, transfers=len(self._replicas),
                        rows=rows)
        parts = []
        for shard, r in zip(self._shards(staged), self._replicas):
            dev_shard = torch.from_numpy(shard).to(r.device, non_blocking=True)
            packed, _ = featurize_bytes(dev_shard, r.stop, spec=dev.spec)
            parts.append(self._score(linear_mod.unpack_rows(packed),
                                     tree_binary, r))
        return _ShardCopies(parts)

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


def synthetic_demo_pipeline(batch_size: int = 256, *, n: int = 800, seed: int = 7,
                            num_features: int = 10000, model: str = "lr",
                            corpus_kwargs: Optional[dict] = None,
                            int8: bool = False, featurize_device: bool = False,
                            device="cuda") -> ServingPipeline:
    """Train a quick model on the synthetic corpus on ``device`` — the serve
    CLI's ``--model synthetic``. ``model``: "lr" (default, 50 L-BFGS
    iterations) | "dt" | "rf" | "xgb". ``corpus_kwargs`` is forwarded to
    ``generate_corpus``."""
    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.models.train_linear import fit_logistic_regression
    from fraud_detection_tpu_torch.models.train_trees import (
        fit_decision_tree, fit_gradient_boosting, fit_random_forest)

    dev = resolve_device(device)
    corpus = generate_corpus(n=n, seed=seed, **(corpus_kwargs or {}))
    feat = HashingTfIdfFeaturizer(num_features=num_features)
    feat.fit_idf([d.text for d in corpus])
    X = feat.featurize_dense([d.text for d in corpus], device=dev)
    y = np.asarray([d.label for d in corpus], np.float32)
    if model == "lr":
        clf = fit_logistic_regression(X, y, max_iter=50, device=dev)
    elif model == "dt":
        clf = fit_decision_tree(X, y, device=dev)
    elif model == "rf":
        clf = fit_random_forest(X, y, n_trees=20, device=dev)
    elif model == "xgb":
        clf = fit_gradient_boosting(X, y, n_rounds=20, device=dev)
    else:
        raise ValueError(f"unknown demo model {model!r}")
    return ServingPipeline(feat, clf, batch_size=batch_size, int8=int8,
                           featurize_device=featurize_device, device=dev)
