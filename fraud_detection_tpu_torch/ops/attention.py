"""Causal flash attention — twin of ``fraud_detection_tpu/ops/attention.py``.

``flash_attention(q, k, v)``: q (B, T, H, d), k/v (B, T, Hkv, d) with
H % Hkv == 0 -> (B, T, H, d) in q's dtype, out[t] = softmax over s <= t of
q[t].k[s] / sqrt(d), times v. GQA/MQA K/V stay at their native width: query
head h reads K/V head h // (H / Hkv), and nothing is expanded.

On a CUDA tensor the wrapper launches one of two hand-written kernels,
chosen before the launch from dtype and head dim alone (``flash_route``):

- ``"sm90"``: ``ops/csrc/flash_attention_sm90.cu`` for bfloat16 at d in
  ``SM90_HEAD_DIMS`` (wgmma tensor-core products, TMA loads into an mbarrier
  ring, a producer warp and two consumer warpgroups);
- ``"simt"``: ``ops/csrc/flash_attention.cu`` for everything else (float32
  at any d <= 256, bfloat16 at other head dims), f32 FMAs on the CUDA cores.

``flash_attention.launches`` counts every launch, and
``flash_attention_sm90.launches`` / ``flash_attention_simt.launches`` each
route's own. On a CPU tensor every entry runs ``flash_attention_reference``,
the plain torch version with the kernels' rounding points. There is no
fallback from one to another: a route's kernel that fails to build or launch
raises. The JAX wrapper's ``blk_q``/``blk_k`` have no counterpart: each CUDA
kernel's tiles are part of its design.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch

#: Masked scores: exp(s - m) of one underflows to exactly 0 (no inf - inf).
NEG = -1e30
#: The sm90 self-test's bound against float64 on the same bf16 inputs (|q|,
#: |k|, |v| <= 1): the output rounds to bf16 once (half a step, <= 2^-9 for
#: outputs below 1) and p rounds to bf16 as the p.v operand (<= 2^-9
#: relative per weight, so <= 2^-9 of max |v| on the average), ~0.004 in all.
SM90_SELF_TEST_TOL = 1e-2
MAX_HEAD_DIM = 256
SM90_HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B, T, H, d) and k/v "
                         f"(B, T, Hkv, d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != t or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"kv heads {k.shape[2]} must divide query heads {h}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")


def flash_route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA tensor of ``dtype`` and head dim ``d`` runs:
    ``"sm90"`` for bfloat16 at d in ``SM90_HEAD_DIMS``, else ``"simt"``."""
    return "sm90" if dtype == torch.bfloat16 and d in SM90_HEAD_DIMS else "simt"


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal attention, (B, T, H, d) in q's dtype; see the module
    docstring."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    if flash_route(q.dtype, q.shape[3]) == "sm90":
        return _flash_sm90(q, k, v)
    return _flash_simt(q, k, v)


flash_attention.launches = 0


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Plain torch version: per (batch, head) a materialized causal softmax
    with the kernel's rounding points — the q.k dot as an f32 product of the
    input values scaled in f32, masked scores -1e30, p rounded to v's dtype
    before p.v (an f32 product), acc / l rounded to q's dtype once. It
    normalizes by the row's final max instead of a running one, so in bf16
    its p values round at other magnitudes than the kernel's. Float64
    inputs are reckoned in float64 throughout (the kernel's self-test)."""
    _check(q, k, v)
    acc_t = torch.promote_types(q.dtype, torch.float32)
    b_, t, h_, d = q.shape
    rep = h_ // k.shape[2]
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    above = torch.ones((t, t), dtype=torch.bool, device=q.device).triu(1)
    for b in range(b_):
        for h in range(h_):
            kv = h // rep
            s = (q[b, :, h].to(acc_t) @ k[b, :, kv].to(acc_t).T) * scale
            s = s.masked_fill(above, NEG)
            p = torch.exp(s - s.amax(dim=1, keepdim=True))
            acc = p.to(v.dtype).to(acc_t) @ v[b, :, kv].to(acc_t)
            out[b, :, h] = (acc / p.sum(dim=1, keepdim=True)).to(q.dtype)
    return out


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from fraud_detection_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def flash_attention_simt(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """The "simt" route: ``flash_attention.cu`` (float32 or bfloat16, d <=
    256) on CUDA tensors, made contiguous first; counted in
    ``flash_attention.launches`` and its own ``.launches``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    return _flash_simt(q, k, v)


flash_attention_simt.launches = 0


def _flash_simt(q, k, v):
    b, t, h, d = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash kernel takes float32 or bfloat16, got {q.dtype}")
    if d > MAX_HEAD_DIM or b * h > 65535:
        raise ValueError(f"flash kernel takes d <= {MAX_HEAD_DIM} and "
                         f"B*H <= 65535, got d={d}, B*H={b * h}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _launch(q, k, v, out)
    flash_attention.launches += 1
    flash_attention_simt.launches += 1
    return out


def _launch(q, k, v, out) -> None:
    b, t, h, d = q.shape
    rc = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, h,
        k.shape[2], d, _DTYPES[q.dtype], 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {rc}")


@lru_cache(maxsize=None)
def _lib_sm90() -> ctypes.CDLL:
    from fraud_detection_tpu_torch.ops import _build

    lib = _build.load("flash_attention_sm90")
    fn = lib.flash_attention_sm90_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def flash_attention_sm90(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """The "sm90" route: ``flash_attention_sm90.cu`` on CUDA tensors, made
    contiguous and 16-byte aligned first (``_packed``). Takes bfloat16 at d
    in ``SM90_HEAD_DIMS``; anything else raises ValueError before any
    launch, on any device. Counted in ``flash_attention.launches`` and its
    own ``.launches``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        _sm90_check(q)
        return flash_attention_reference(q, k, v)
    return _flash_sm90(q, k, v)


flash_attention_sm90.launches = 0


def _sm90_check(q) -> None:
    d = q.shape[3]
    if q.dtype != torch.bfloat16 or d not in SM90_HEAD_DIMS:
        raise ValueError(f"sm90 flash kernel takes bfloat16 at d in "
                         f"{SM90_HEAD_DIMS}, got {q.dtype} at d={d}")


def _packed(x: torch.Tensor) -> torch.Tensor:
    """x as the sm90 kernel's packed tensor maps take it: contiguous (a
    no-op for a contiguous x), its data 16-byte aligned (copied when a
    contiguous view starts off that grid)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _flash_sm90(q, k, v):
    _sm90_check(q)
    q, k, v = _packed(q), _packed(k), _packed(v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _launch_sm90(q, k, v, out)
    flash_attention.launches += 1
    flash_attention_sm90.launches += 1
    return out


def _launch_sm90(q, k, v, out) -> None:
    b, t, h, d = q.shape
    rc = _lib_sm90().flash_attention_sm90_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, h,
        k.shape[2], d, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sm90 flash attention kernel launch failed: "
                           f"cudaError {rc}")


@lru_cache(maxsize=None)
def kernel_self_test(device) -> bool:
    """Build both kernels and launch them on ``device`` (a CUDA device) over
    tiny inputs whose answers are reckoned on the host. SIMT: f32 at T=70
    (two query tiles, three key tiles, both ragged), H=2 over one K/V head,
    d=40 (a ragged column group), within 1e-5 of the plain version in
    float64; bf16 with q = 0, where every row averages v[0..t] of small
    integers, exactly. sm90: bf16 at d=64, T=70, H=2 over one K/V head,
    within ``SM90_SELF_TEST_TOL`` of the plain version in float64 on the
    same bf16 values, and the q = 0 case at d=64, exactly. Raises on any
    mismatch; cached per device."""
    dev = torch.device(device)
    t, d = 70, 40
    q = [[[[math.sin(0.37 * i + 0.11 * c + h) for c in range(d)]
           for h in range(2)] for i in range(t)]]
    k = [[[[math.cos(0.23 * i - 0.07 * c) for c in range(d)]] for i in range(t)]]
    v = [[[[math.sin(0.5 * i + 0.3 * c) for c in range(d)]] for i in range(t)]]
    tq, tk, tv = (torch.tensor(x, dtype=torch.float32) for x in (q, k, v))
    out = torch.empty_like(tq, device=dev)
    _launch(tq.to(dev), tk.to(dev), tv.to(dev), out)
    want = flash_attention_reference(tq.double(), tk.double(), tv.double())
    err = float((out.cpu().double() - want).abs().max())
    if not err <= 1e-5:
        raise RuntimeError(f"flash attention self-test (f32): max |diff| {err}")

    tb = 5
    vb = torch.arange(1, tb + 1, dtype=torch.float32)[None, :, None, None]
    vb = vb.expand(1, tb, 1, 4).to(torch.bfloat16).contiguous().to(dev)
    qb = torch.zeros((1, tb, 2, 4), dtype=torch.bfloat16, device=dev)
    kb = torch.ones((1, tb, 1, 4), dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(qb)
    _launch(qb, kb, vb, out)
    want = ((torch.arange(1, tb + 1, dtype=torch.float32) + 1) / 2)
    want = want[None, :, None, None].expand(1, tb, 2, 4)
    if not torch.equal(out.cpu().float(), want):
        raise RuntimeError(f"flash attention self-test (bf16): got "
                           f"{out.cpu().float()[0, :, 0, 0].tolist()}, want "
                           f"{want[0, :, 0, 0].tolist()}")

    d = 64
    q = [[[[math.sin(0.37 * i + 0.11 * c + h) for c in range(d)]
           for h in range(2)] for i in range(t)]]
    k = [[[[math.cos(0.23 * i - 0.07 * c) for c in range(d)]] for i in range(t)]]
    v = [[[[math.sin(0.5 * i + 0.3 * c) for c in range(d)]] for i in range(t)]]
    tq, tk, tv = (torch.tensor(x, dtype=torch.bfloat16) for x in (q, k, v))
    dq, dk, dv = (x.to(dev) for x in (tq, tk, tv))
    out = torch.empty_like(dq)
    _launch_sm90(dq, dk, dv, out)
    want = flash_attention_reference(tq.double(), tk.double(), tv.double())
    err = float((out.cpu().double() - want).abs().max())
    if not err <= SM90_SELF_TEST_TOL:
        raise RuntimeError(f"sm90 flash attention self-test (bf16): max |diff| {err}")

    vb = torch.arange(1, tb + 1, dtype=torch.float32)[None, :, None, None]
    vb = vb.expand(1, tb, 1, d).to(torch.bfloat16).contiguous().to(dev)
    qb = torch.zeros((1, tb, 2, d), dtype=torch.bfloat16, device=dev)
    kb = torch.ones((1, tb, 1, d), dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(qb)
    _launch_sm90(qb, kb, vb, out)
    want = ((torch.arange(1, tb + 1, dtype=torch.float32) + 1) / 2)
    want = want[None, :, None, None].expand(1, tb, 2, d)
    if not torch.equal(out.cpu().float(), want):
        raise RuntimeError(f"sm90 flash attention self-test (q = 0): got "
                           f"{out.cpu().float()[0, :, 0, 0].tolist()}, want "
                           f"{want[0, :, 0, 0].tolist()}")
    return True
