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
``ops/csrc/int8_matmul.cu`` (bfloat16: ``wgmma`` on TMA-fed tiles, the
weight converted in registers; float32: a SIMT route), which reads the
weight at int8 width and never writes a wider copy of it;
``w8_matmul.launches`` counts every call that launches it (a call whose K
splits go to separate blocks adds its ordered second pass, counted with it)
and ``w8_matmul.simt_launches`` those of the float32 route. On a CPU tensor
it runs ``w8_matmul_reference``, the plain torch version with the same
rounding points. There is no fallback between the two: on the card the
kernel launches or the call raises. The JAX package has no Pallas kernel
here: it leaves the product to XLA, which fuses the int8 convert into the
dot.

``_plan(k, n, layout, dtype)`` fixes, from those alone, the channel tile,
the K splits and the k chunk, and with them the order of every output's
f32 sum: a row's output is bit-equal under every M and every launch, which
keeps paged decode equal to contiguous. M picks only the token tile and
whether the splits go to separate blocks (then through f32 partials
``(S, M, N)``, ``_scratch_shape``, in a scratch buffer kept per CUDA stream,
and a second, ordered pass) or stay in one block, added in registers in the
same order.
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache
from typing import NamedTuple

import torch

from fraud_detection_tpu_torch.ops._build import KernelError, count_launch
from fraud_detection_tpu_torch.ops.attention import _packed
from fraud_detection_tpu_torch.utils.device import cache_per_card, device_context

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


def _check_kernel_shape(k: int, n: int, layout: str, dtype: torch.dtype) -> None:
    """The shapes the bf16 kernel takes (the f32 route takes any)."""
    if dtype == torch.bfloat16 and (
            (layout == "kn" and (k % 8 or n % 8)) or (layout == "nk" and k % 16)):
        raise ValueError(f"the bf16 w8_matmul kernel takes K and N multiples "
                         f"of 8 (kn) or K a multiple of 16 (nk), got {layout} "
                         f"K={k} N={n}")


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
    _check_kernel_shape(k, n, layout, x.dtype)
    x, q = _packed(x), _packed(q)
    _launch(x, q, scale.contiguous(), out, layout)
    count_launch(w8_matmul)
    if x.dtype == torch.float32:
        count_launch(w8_matmul, "simt_launches")
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


# f32 partials of split launches, one buffer a CUDA stream (work on a stream
# runs in order, so each call reuses it once the last call's second pass is
# done), grown with torch.empty up to _PARTIALS_MAX bytes; the lock keeps a
# call's two launches together where threads share a stream.
_SCRATCH: dict = {}
_SCRATCH_LOCK = threading.Lock()

_SMS = 132                   # streaming multiprocessors of an H100 SXM
_CHUNKS = (128, 64, 32)      # k chunks a plan may take, largest first
_PARTIALS_MAX = 16 << 20     # bytes of f32 partials a launch may write (L2-resident)


class Plan(NamedTuple):
    """How ``w8_matmul`` sums a (K, N, layout, dtype): ``tile`` output
    channels a block, ``splits`` K splits of ``split_len`` k (a whole number
    of ``chunk``; the last split takes the rest)."""

    tile: int
    splits: int
    chunk: int
    split_len: int


@lru_cache(maxsize=None)
def _plan(k: int, n: int, layout: str, dtype: torch.dtype) -> Plan:
    """The split plan of a weight, from (K, N, layout, dtype) alone: the
    channel tile (bf16: 128, or 64 for a kn weight of at most 512 channels;
    f32: the SIMT route's 64), and enough K splits that the tiles times the
    splits give about two blocks per SM at decode; none where the tiles
    alone nearly fill the card. A split is a whole number of chunks, the
    largest chunk that still gives that many splits."""
    if dtype == torch.bfloat16:
        tile = 128 if layout == "nk" or n > 512 else 64
    else:
        tile = 64
    tiles = -(-n // tile)
    want = 1 if tiles >= _SMS * 7 // 8 else -(-2 * _SMS // tiles)
    chunk = next((c for c in _CHUNKS if -(-k // c) >= want), _CHUNKS[-1])
    chunks = -(-k // chunk)
    per = -(-chunks // want)
    return Plan(tile, -(-chunks // per), chunk, per * chunk)


def _tokens(m: int, n: int, layout: str, plan: Plan, dtype: torch.dtype) -> int:
    """Rows of x a block takes (bf16: wgmma's instruction N): 8 at decode,
    32 up to 64 rows or for a weight of fewer than 8 channel tiles (wk/wv),
    256 past 128 rows for a kn weight of one split (a block that adds no
    split sums has the registers), else 128 (each measured the fastest of
    those on an H100 at M = 464-2,048)."""
    if dtype != torch.bfloat16:
        return 8 if m <= 8 else 32
    if m <= 8:
        return 8
    if m <= 64 or -(-n // plan.tile) < 8:
        return 32
    return 256 if layout == "kn" and plan.splits == 1 and m > 128 else 128


class Launch(NamedTuple):
    """A launch: the plan, the rows a block takes and whether each K split
    has blocks of its own."""

    plan: Plan
    tokens: int
    across: bool


def _config(m: int, k: int, n: int, layout: str, dtype: torch.dtype) -> Launch:
    """A launch of (M, K, N, layout, dtype): the plan from (K, N, layout,
    dtype) alone, the rest from M too. Putting the splits in blocks of their
    own (then an ordered second pass adds the partials) is taken where the
    tiles alone leave the card short of blocks and the partials stay small;
    it changes no bit of the output."""
    plan = _plan(k, n, layout, dtype)
    tokens = _tokens(m, n, layout, plan, dtype)
    blocks = -(-m // tokens) * -(-n // plan.tile)
    across = (plan.splits > 1 and blocks < _SMS
              and plan.splits * m * n * 4 <= _PARTIALS_MAX)
    return Launch(plan, tokens, across)


def _scratch_shape(m: int, k: int, n: int, layout: str, dtype: torch.dtype):
    """The f32 partials a launch writes, (S, M, N), or None."""
    launch = _config(m, k, n, layout, dtype)
    return (launch.plan.splits, m, n) if launch.across else None


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from fraud_detection_tpu_torch.ops import _build

    lib = _build.load("int8_matmul")
    fn = lib.w8_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _launch(x, q, scale, out, layout: str, across: bool | None = None,
            tokens: int | None = None) -> None:
    """Launch the kernel (and its second pass) on the current stream;
    ``across`` and ``tokens`` override ``_config`` (the self-test runs every
    route)."""
    m, k = x.shape
    n = scale.shape[0]
    launch = _config(m, k, n, layout, x.dtype)
    plan = launch.plan
    across = launch.across if across is None else across
    tokens = launch.tokens if tokens is None else tokens
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    args = (x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr())
    shape = (m, n, k, _DTYPES[x.dtype], LAYOUTS.index(layout), plan.tile,
             plan.split_len, plan.splits, tokens, int(across))
    if across and plan.splits > 1:
        need = plan.splits * m * n
        key = (x.device.index, stream)
        with _SCRATCH_LOCK:   # the main kernel and its second pass, in order
            part = _SCRATCH.get(key)
            if part is None or part.numel() < need:
                part = _SCRATCH[key] = torch.empty(
                    need, dtype=torch.float32, device=x.device)
            with device_context(x.device):
                rc = _lib().w8_matmul_launch(*args, part.data_ptr(), *shape,
                                             stream)
    else:
        with device_context(x.device):
            rc = _lib().w8_matmul_launch(*args, None, *shape, stream)
    if rc != 0:
        raise KernelError(f"w8_matmul kernel launch failed: cudaError {rc}")


@cache_per_card
def kernel_self_test(device) -> bool:
    """Build the kernel and launch it on ``device`` (a CUDA device) over
    inputs whose answers are exact: x and q in {-1, 0, 1}, K = 176 (six
    32-k splits, the last one ragged; every partial sum an integer of at
    most 176, exact in bf16 and f32), M = 3, 20 and 70 (8-, 32- and, forced,
    128- and 256-row blocks), N = 40 (a ragged channel tile; bf16 kn staged by
    cp.async), 42 (f32 kn staged byte by byte) and 48 (bf16 kn by TMA),
    scales powers of two. Both layouts, both dtypes, the splits in separate
    blocks and in one, against the product in float64, exactly.
    Raises on any mismatch; cached per card."""
    dev = torch.device(device)
    k = 176
    for n in (40, 42, 48):
        for m in (3, 20, 70):
            xs = torch.tensor([[((3 * i + 5 * j) % 3) - 1 for j in range(k)]
                               for i in range(m)], dtype=torch.float64)
            qs = torch.tensor([[((7 * a + b) % 3) - 1 for b in range(n)]
                               for a in range(k)], dtype=torch.int8)
            sc = torch.tensor([2.0 ** ((c % 5) - 2) for c in range(n)])
            want = (xs @ qs.double()) * sc.double()
            for dtype in _DTYPES:
                for layout, qq in (("kn", qs), ("nk", qs.T.contiguous())):
                    try:
                        _check_kernel_shape(k, n, layout, dtype)
                    except ValueError:
                        continue      # bf16 kn takes N in multiples of 8
                    if _plan(k, n, layout, dtype).splits < 2:
                        raise RuntimeError(f"w8_matmul self-test: K={k} "
                                           f"takes one split ({layout})")
                    routes = [(across, None) for across in (True, False)]
                    if m > 64 and dtype == torch.bfloat16:   # 128-, 256-row blocks
                        routes += [(True, 128), (False, 128)] + (
                            [(True, 256)] if layout == "kn" else [])
                    for across, tokens in routes:
                        out = torch.empty((m, n), device=dev, dtype=dtype
                                          if layout == "kn" else torch.float32)
                        _launch(xs.to(dev, dtype), qq.to(dev), sc.to(dev), out,
                                layout, across, tokens)
                        got = out.cpu().double()
                        if not torch.equal(got, want):
                            raise RuntimeError(
                                f"w8_matmul self-test ({dtype}, {layout}, "
                                f"M={m}, N={n}, across={across}, tokens="
                                f"{tokens}): max |diff| "
                                f"{float((got - want).abs().max())}")
    return True
