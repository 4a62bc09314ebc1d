"""Mesh data-parallel serving: one worker drives every local device — twin
of ``fraud_detection_tpu/parallel/serving.py``.

``ServingPipeline`` takes a ``mesh`` and shards each chunk's rows over its
data axis (``models/pipeline.py``: a shard's upload, featurize and scoring
run on its own device, against that device's replica of the model). This
module packages that placement for the serving lane:

* :class:`MeshServingPipeline` — a ``ServingPipeline`` whose chunk size
  scales with the device count (``per_chip_batch`` rows a device) and
  whose padding-ladder rungs stay data-axis multiples, so every chunk splits
  into equal shards (a global rung R runs R/dp rows on each device). On ONE
  device it constructs the plain single-device pipeline: identical
  scoring, no mesh in the way, but ``mesh_devices`` reads 1.
* :func:`make_serving_mesh` — all local devices on the data axis (models
  are small and replicated; rows are plentiful).

Parity: labels and probabilities equal the single-device pipeline's on the
same inputs (padding rows are zeros, dropped at resolve; scoring has no
cross-row reduction). ``health()['device']`` carries ``mesh_devices`` and
the ``per_chip_rungs`` the scheduler's prewarm filled.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
from fraud_detection_tpu_torch.parallel.mesh import (DATA_AXIS, local_devices,
                                                     make_mesh)


def make_serving_mesh(n_devices: Optional[int] = None,
                      devices: Optional[Sequence] = None, *,
                      device_type: str = "cuda"):
    """All (or the first ``n_devices``) local devices of ``device_type`` on
    the data axis, or the named ``devices``."""
    return make_mesh(n_devices=n_devices, devices=devices,
                     device_type=device_type)


def local_device_count(device_type: str = "cuda") -> int:
    """``torch.cuda.device_count()`` on the card (this process's share
    under a multi-process group); 1 on the CPU."""
    return len(local_devices(device_type))


class MeshServingPipeline(ServingPipeline):
    """Data-parallel ``ServingPipeline`` over the local device mesh.

    ``per_chip_batch`` is the chunk size EACH device scores; ``batch_size``
    becomes ``per_chip_batch * data_parallel``, so one engine micro-batch
    feeds every device at single-device occupancy. With one device this is
    the single-device pipeline (``mesh`` None). ``device`` picks the
    device type of the default mesh (``cuda`` unless the caller asks for
    the CPU)."""

    def __init__(self, featurizer, model, *, per_chip_batch: int = 256,
                 mesh=None, fold_idf: bool = True, int8: bool = False,
                 featurize_device=False,
                 featurize_width=None, featurize_tokens=None,
                 device="cuda"):
        if per_chip_batch < 1:
            raise ValueError(
                f"per_chip_batch must be >= 1, got {per_chip_batch}")
        if mesh is None:
            mesh = make_serving_mesh(device_type=torch.device(device).type)
        dp = int(dict(mesh.shape).get(DATA_AXIS, 1))
        self.data_parallel = dp
        self.per_chip_batch = per_chip_batch
        # Device featurize shards with scoring: each device featurizes its
        # rung/dp rows of the staging tensor (_pad_rows keeps every rung a
        # dp multiple).
        super().__init__(featurizer, model, fold_idf=fold_idf,
                         batch_size=per_chip_batch * dp,
                         mesh=mesh if dp > 1 else None, int8=int8,
                         featurize_device=featurize_device,
                         featurize_width=featurize_width,
                         featurize_tokens=featurize_tokens,
                         device=mesh.home)
        # The 1-device fallback drops the mesh but the health block says
        # "mesh lane, 1 device", not the plain pipeline's 0.
        self.device_stats.mesh_devices = dp

    def _pad_rows(self, n: int) -> int:
        """Ladder rung for an n-row chunk, rounded up to a data-axis
        multiple, so a chunk always splits into equal shards and the rung
        set stays the menu the prewarm warmed."""
        target = super()._pad_rows(n)
        dp = self.data_parallel
        return -(-target // dp) * dp if dp > 1 else target

    @classmethod
    def from_pipeline(cls, pipe: ServingPipeline, *,
                      per_chip_batch: Optional[int] = None,
                      mesh=None) -> "MeshServingPipeline":
        """Mesh twin of an existing pipeline: the same featurizer and model,
        device featurize with the same width and slots, on ``pipe``'s
        device type."""
        dev = pipe._dev_feat
        feat_kwargs = {}
        if dev is not None:
            feat_kwargs = {"featurize_device": True,
                           "featurize_width": dev.width,
                           "featurize_tokens": dev.tokens}
        return cls(pipe.featurizer, pipe.model,
                   per_chip_batch=per_chip_batch or pipe.batch_size,
                   mesh=mesh, int8=pipe.int8, device=pipe.device,
                   **feat_kwargs)
