"""Weight-only int8 matrix product (W8A16) — the int8 weight products of
``models/llm.py`` (``_mm`` and the int8 head).

``w8_matmul(x, q, scale, layout)``: x (M, K) in float32 or bfloat16, q int8,
scale float32 over the N output channels, at the JAX package's rounding
points (``fraud_detection_tpu/models/llm.py`` ``_mm`` and its int8 head):

- ``"kn"``: q (K, N), a layer weight; y (M, N) in x's dtype,
  ``round(round(x @ q) * scale)``, round being to x's dtype;
- ``"nk"``: q (N, K), the output head; y (M, N) float32,
  ``float32(round(x @ q.T)) * scale``.

On a CUDA tensor the wrapper launches the hand-written kernel of
``ops/csrc/int8_matmul.cu`` (bfloat16: ``mma.sync`` on the tensor cores;
float32: a SIMT route), which reads the weight at int8 width and never
writes a wider copy of it; ``w8_matmul.launches`` counts every launch and
``w8_matmul.simt_launches`` those of the float32 route. On a CPU tensor it
runs ``w8_matmul_reference``, the plain torch version with the same
rounding points. There is no fallback between the two: on the card the
kernel launches or the call raises. The JAX package has no Pallas kernel
here: it leaves the product to XLA, which fuses the int8 convert into the
dot.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from fraud_detection_tpu_torch.ops._build import KernelError
from fraud_detection_tpu_torch.ops.attention import _packed

LAYOUTS = ("kn", "nk")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
           layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if x.ndim != 2 or q.ndim != 2 or scale.ndim != 1:
        raise ValueError(f"w8_matmul takes x (M, K), q 2-d and scale (N,), got "
                         f"{tuple(x.shape)}, {tuple(q.shape)}, "
                         f"{tuple(scale.shape)}")
    k, n = q.shape if layout == "kn" else q.shape[::-1]
    if x.shape[1] != k or scale.shape[0] != n:
        raise ValueError(f"shapes do not match for {layout}: x "
                         f"{tuple(x.shape)}, q {tuple(q.shape)}, scale "
                         f"{tuple(scale.shape)}")
    if x.dtype not in _DTYPES or q.dtype != torch.int8 or \
            scale.dtype != torch.float32:
        raise ValueError(f"w8_matmul takes float32 or bfloat16 x, int8 q and "
                         f"float32 scale, got {x.dtype}, {q.dtype}, "
                         f"{scale.dtype}")
    if not x.device == q.device == scale.device:
        raise ValueError(f"devices differ: {x.device}, {q.device}, "
                         f"{scale.device}")


def w8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
              layout: str = "kn") -> torch.Tensor:
    """The product; see the module docstring."""
    _check(x, q, scale, layout)
    if x.device.type == "cpu":
        return w8_matmul_reference(x, q, scale, layout)
    m, k = x.shape
    n = scale.shape[0]
    out = torch.empty((m, n), dtype=x.dtype if layout == "kn" else torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    if x.dtype == torch.bfloat16 and (
            (layout == "kn" and (k % 8 or n % 8)) or (layout == "nk" and k % 16)):
        raise ValueError(f"the bf16 w8_matmul kernel takes K and N multiples "
                         f"of 8 (kn) or K a multiple of 16 (nk), got {layout} "
                         f"K={k} N={n}")
    x, q = _packed(x), _packed(q)
    _launch(x, q, scale.contiguous(), out, layout)
    w8_matmul.launches += 1
    if x.dtype == torch.float32:
        w8_matmul.simt_launches += 1
    return out


w8_matmul.launches = 0        # every launch
w8_matmul.simt_launches = 0   # those of the float32 (SIMT) route


def w8_matmul_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                        layout: str = "kn") -> torch.Tensor:
    """Plain torch version: the int8 weight converted to x's dtype, the
    product in x's dtype (a float32 sum rounded once), then the scale in
    float32; kn rounds the result to x's dtype, nk keeps it float32."""
    _check(x, q, scale, layout)
    w = q.to(x.dtype)
    y = x @ (w if layout == "kn" else w.T)
    if layout == "nk":
        return y.float() * scale
    return (y.float() * scale).to(x.dtype)


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from fraud_detection_tpu_torch.ops import _build

    lib = _build.load("int8_matmul")
    fn = lib.w8_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _launch(x, q, scale, out, layout: str) -> None:
    m, k = x.shape
    rc = _lib().w8_matmul_launch(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), m,
        scale.shape[0], k, _DTYPES[x.dtype], LAYOUTS.index(layout),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise KernelError(f"w8_matmul kernel launch failed: cudaError {rc}")


@lru_cache(maxsize=None)
def kernel_self_test(device) -> bool:
    """Build the kernel and launch it on ``device`` (a CUDA device) over
    inputs whose answers are exact: x and q in {-1, 0, 1}, K = 160 (two
    chunks of 128, the second ragged; every partial sum an integer of at
    most 160, exact in bf16 and f32), M = 3 and 20 (one and two row tiles),
    N = 40 (a ragged channel tile), scales powers of two. Both layouts, both
    dtypes, against the product in float64, exactly. Raises on any mismatch;
    cached per device."""
    dev = torch.device(device)
    k, n = 160, 40
    for m in (3, 20):
        xs = torch.tensor([[((3 * i + 5 * j) % 3) - 1 for j in range(k)]
                           for i in range(m)], dtype=torch.float64)
        qs = torch.tensor([[((7 * a + b) % 3) - 1 for b in range(n)]
                           for a in range(k)], dtype=torch.int8)
        sc = torch.tensor([2.0 ** ((c % 5) - 2) for c in range(n)])
        want = (xs @ qs.double()) * sc.double()
        for dtype in _DTYPES:
            for layout, qq in (("kn", qs), ("nk", qs.T.contiguous())):
                out = torch.empty((m, n), device=dev, dtype=dtype
                                  if layout == "kn" else torch.float32)
                _launch(xs.to(dev, dtype), qq.to(dev), sc.to(dev), out, layout)
                got = out.cpu().double()
                if not torch.equal(got, want):
                    raise RuntimeError(
                        f"w8_matmul self-test ({dtype}, {layout}, M={m}): max "
                        f"|diff| {float((got - want).abs().max())}")
    return True
