"""Device resolution shared by every entry point of the port, and the CUDA
streams of the background lanes that share a card with the serving engine."""

from __future__ import annotations

import contextlib
import functools
from contextlib import contextmanager
from typing import Optional

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent. Entry points run on the card unless the caller passes
    ``device="cpu"`` — they never carry on on the CPU by themselves."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain torch versions")
    return dev


def device_key(device) -> torch.device:
    """``device`` with its card named: a bare ``"cuda"`` becomes the current
    card's ``cuda:i``, so a per-card cache holds one entry a card whichever
    way a caller spells it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def cache_per_card(fn):
    """``fn(device)`` cached once a card, keyed by ``device_key``: "cuda"
    and "cuda:0" share one entry, so a kernel's self-test launches (and
    counts) once a card, never again inside a caller's launch-count window.
    ``.cached`` is the cache; ``.__wrapped__`` is ``fn`` uncached."""
    @functools.wraps(fn)
    def call(device):
        return call.cached(device_key(device))

    call.cached = functools.lru_cache(maxsize=None)(fn)
    return call


def lane_stream(device, streams: dict) -> Optional["torch.cuda.Stream"]:
    """A background lane's own CUDA stream on ``device`` (shadow scoring,
    the learn lane, the watcher's prewarm), made at first use and kept in
    the lane's ``streams`` (device -> stream); None on the CPU or for no
    device.

    The serving engine launches on the device's default stream. A lane on
    that stream too would queue behind every micro-batch, and each of its
    host reads would wait for them (and they for it); on a stream of its
    own a host read waits for the lane's work alone."""
    if device is None or torch.device(device).type != "cuda":
        return None
    dev = torch.device(device)
    if dev not in streams:
        streams[dev] = torch.cuda.Stream(device=dev)
    return streams[dev]


@contextmanager
def on_lane(stream: Optional["torch.cuda.Stream"]):
    """Run the block's device work on ``stream`` (from ``lane_stream``).

    Model tensors are uploaded on the default stream; the lane's stream
    first waits (on the card, not the host) for the work queued there, so
    it never reads a tensor before its upload has landed. Everything the
    lane allocates stays on its stream; what it hands back crosses as host
    data, or after the lane synchronized its own stream. No-op for None."""
    if stream is None:
        yield
        return
    stream.wait_stream(torch.cuda.default_stream(stream.device))
    with torch.cuda.stream(stream):
        yield


def is_device_fault(exc: BaseException) -> bool:
    """True for a fault of the card or its toolchain — a CUDA error, device
    memory exhausted, a hand-written kernel that did not build or launch —
    which a background lane must surface, never log and carry on past (a
    bad model file or a poison row is not one)."""
    from fraud_detection_tpu_torch.ops._build import KernelError

    accel = getattr(torch, "AcceleratorError", None)
    return (isinstance(exc, (KernelError, torch.cuda.OutOfMemoryError))
            or (accel is not None and isinstance(exc, accel))
            or (isinstance(exc, RuntimeError) and "CUDA error" in str(exc)))


def device_context(device):
    """Make ``device`` the current CUDA device for the block; nothing for the
    CPU. A hand-written kernel's C entry launches on the current device, so
    every ``ops/`` wrapper launches under its tensors' device (a mesh's
    shards live on several cards)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
