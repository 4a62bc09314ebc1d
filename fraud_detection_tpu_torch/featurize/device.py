"""Device-side featurization: host byte packing + the device featurizer —
twin of ``fraud_detection_tpu/featurize/device.py``.

``ops/featurize_kernel.py`` owns the device program (CUDA scan kernel +
torch count/pack). This module owns everything around it:

* :func:`pack_bytes` / :func:`pack_staged` — the host's ENTIRE remaining
  featurize work: UTF-8 encode + memcpy into a fixed-width uint8 tensor with
  per-row byte lengths. Rows longer than ``W`` truncate at a CODEPOINT
  boundary and are counted (``DeviceStats.truncated_rows``).
* :class:`DeviceFeaturizer` — validates that a host featurizer's exact
  semantics are expressible on device, builds the stop table and static
  spec, and runs the program on its device: ``path`` is ``"cuda"`` (the
  hand-written kernel) on the card and ``"torch"`` (the plain torch
  version) on the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fraud_detection_tpu_torch.featurize.hashing import spark_hash_bucket
from fraud_detection_tpu_torch.featurize.tfidf import (EncodedBatch,
                                                       HashingTfIdfFeaturizer)
from fraud_detection_tpu_torch.ops import featurize_kernel as fk
from fraud_detection_tpu_torch.utils.device import resolve_device

DEFAULT_WIDTH = 2048
DEFAULT_TOKENS = 256


class DeviceFeaturizeUnavailable(RuntimeError):
    """The device featurize path cannot represent this configuration."""


def truncation_cut(data: bytes, width: int) -> int:
    """Largest cut <= width that does not split a UTF-8 sequence."""
    cut = width
    while cut > 0 and (data[cut] & 0xC0) == 0x80:
        cut -= 1
    return cut


def pack_bytes(texts: Sequence[str], width: int,
               batch_size: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Texts -> ((B, width) uint8, (B,) int32 lengths, truncated_rows).

    Rows beyond ``len(texts)`` carry length -1: PADDING, not the empty
    string — a real ``""`` tokenizes to ``[""]`` and counts one empty-token
    bucket, while a padding row must featurize to nothing."""
    b = batch_size if batch_size is not None else len(texts)
    if len(texts) > b:
        raise ValueError(f"{len(texts)} texts > batch_size {b}")
    out = np.zeros((b, width), np.uint8)
    lengths = np.full(b, -1, np.int32)
    truncated = 0
    for i, t in enumerate(texts):
        data = t.encode("utf-8")
        if len(data) > width:
            data = data[: truncation_cut(data, width)]
            truncated += 1
        n = len(data)
        out[i, :n] = np.frombuffer(data, np.uint8)
        lengths[i] = n
    return out, lengths, truncated


def pack_staged(texts: Sequence[str], width: int,
                batch_size: Optional[int] = None
                ) -> Tuple[np.ndarray, int]:
    """Texts -> ((B, width+4) uint8 staging tensor, truncated_rows): the
    byte tensor with each row's length in its last four columns (little-
    endian), so the whole micro-batch is ONE host->device copy."""
    byts, lengths, truncated = pack_bytes(texts, width, batch_size)
    staged = np.empty((byts.shape[0], width + 4), np.uint8)
    staged[:, :width] = byts
    staged[:, width:] = lengths.astype("<i4").view(np.uint8).reshape(-1, 4)
    return staged, truncated


class DeviceFeaturizer:
    """The device twin of a :class:`HashingTfIdfFeaturizer`.

    Construction VALIDATES exactness — any configuration the kernel cannot
    reproduce bit-for-bit raises :class:`DeviceFeaturizeUnavailable` — and
    binds the program to ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``; CUDA asked for and absent raises). On the card the
    kernel is built and self-tested once, here, so a kernel that cannot
    build or launch fails construction rather than the first request."""

    def __init__(self, featurizer: HashingTfIdfFeaturizer, *,
                 width: int = DEFAULT_WIDTH, tokens: int = DEFAULT_TOKENS,
                 device="cuda"):
        if type(featurizer) is not HashingTfIdfFeaturizer:
            raise DeviceFeaturizeUnavailable(
                f"{type(featurizer).__name__} is not the hashing featurizer "
                "the device kernel implements")
        if featurizer.num_features > np.iinfo(np.int16).max:
            raise DeviceFeaturizeUnavailable(
                f"num_features={featurizer.num_features} exceeds the int16 "
                "packed staging layout")
        if width < 8:
            raise ValueError(f"width must be >= 8 bytes, got {width}")
        if tokens < 1:
            raise ValueError(f"tokens must be >= 1, got {tokens}")
        stop_words = (featurizer.stop_filter.words
                      if featurizer.remove_stopwords else [])
        built = fk.build_stop_table(stop_words)
        if built is None:
            raise DeviceFeaturizeUnavailable(
                "stop list contains a pure-[a-z] word longer than the "
                "identity pack — exact device-side removal is impossible")
        table, empty_is_stop = built
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            fk.kernel_self_test(self.device)
        legacy = bool(featurizer.hashing_tf.legacy)
        self.featurizer = featurizer
        self.width = int(width)
        self.tokens = int(tokens)
        self.stop_table_np = table
        self.spec = fk.FeaturizeSpec(
            num_features=featurizer.num_features,
            n_slots=int(tokens),
            binary=bool(featurizer.binary_tf),
            legacy=legacy,
            empty_bucket=spark_hash_bucket("", featurizer.num_features,
                                           legacy),
            empty_is_stop=empty_is_stop,
        )
        self._stop_dev: Optional[torch.Tensor] = None

    @property
    def path(self) -> str:
        """Which path the scan runs: ``cuda`` (kernel) or ``torch`` (the
        plain version, CPU)."""
        return "cuda" if self.device.type == "cuda" else "torch"

    def stop_table(self) -> torch.Tensor:
        """Device copy of the stop table — copied ONCE and cached."""
        if self._stop_dev is None:
            self._stop_dev = torch.from_numpy(self.stop_table_np).to(self.device)
        return self._stop_dev

    def pack(self, texts: Sequence[str], batch_size: Optional[int] = None
             ) -> Tuple[np.ndarray, int]:
        """Texts -> ((B, width+4) uint8 staging tensor, truncated_rows)."""
        return pack_staged(texts, self.width, batch_size)

    def encode_packed(self, staged) -> torch.Tensor:
        """Standalone device featurize: (B, W+4) staging array -> packed
        (B, 2, L) int16 tensor on this featurizer's device."""
        staged = torch.as_tensor(staged).to(self.device)
        packed, _ = fk.featurize_bytes(staged, self.stop_table(),
                                       spec=self.spec)
        return packed

    def encode(self, texts: Sequence[str],
               batch_size: Optional[int] = None) -> EncodedBatch:
        """Texts -> host EncodedBatch via the DEVICE path (directly
        comparable with ``HashingTfIdfFeaturizer.encode``)."""
        from fraud_detection_tpu_torch.models.pipeline import unpack_packed_host

        staged, _ = self.pack(texts, batch_size)
        ids, counts = unpack_packed_host(self.encode_packed(staged).cpu())
        return EncodedBatch(ids=ids, counts=counts)

    def decode_truncated(self, texts: Sequence[str]) -> List[str]:
        """What each text becomes after byte-width truncation — the exact
        input whose HOST featurization the device path must match."""
        out = []
        for t in texts:
            data = t.encode("utf-8")
            if len(data) > self.width:
                data = data[: truncation_cut(data, self.width)]
            out.append(data.decode("utf-8"))
        return out
