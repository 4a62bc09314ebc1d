"""The decoder's equations in plain PyTorch, batched over (B, T): RMSNorm with
its gains, rotary embeddings on interleaved pairs, causal attention with
grouped K/V heads, and a pre-norm block with a SiLU-gated MLP. Used by the
serving reference (``decoder.py``); every tensor here is float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def plain_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) times w viewed as (K, N)."""
    return x @ w.reshape(x.shape[-1], -1)


def rms_norm(x: torch.Tensor, eps: float, gain: torch.Tensor) -> torch.Tensor:
    """RMSNorm times its gain."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * gain


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, h, d) rotated at positions 0..T-1, pairs (0::2, 1::2)."""
    T, d = x.shape[1], x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                    device=x.device) / d)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def attention(q, k, v, query_block: int = 1024) -> torch.Tensor:
    """Causal softmax attention, q (B, T, H, d), k/v (B, T, Hkv, d), each
    K/V head shared by H / Hkv consecutive query heads, in query blocks."""
    B, T, H, d = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)      # (B, H, T, d)
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    qh = q.transpose(1, 2)
    outs = []
    scale = 1.0 / math.sqrt(d)
    for lo in range(0, T, query_block):
        hi = min(T, lo + query_block)
        s = (qh[:, :, lo:hi] @ k[:, :, :hi].transpose(2, 3)) * scale
        causal = (torch.arange(hi, device=q.device)[None, :]
                  <= torch.arange(lo, hi, device=q.device)[:, None])
        s = s.masked_fill(~causal, float("-inf"))
        outs.append(torch.softmax(s, dim=-1) @ v[:, :, :hi])
    return torch.cat(outs, dim=2).transpose(1, 2)


def layer(x: torch.Tensor, w: Dict[str, torch.Tensor], cfg: Dict,
          mm: Matmul = plain_mm) -> torch.Tensor:
    """One pre-norm decoder block on x (B, T, D)."""
    B, T, _ = x.shape
    H, Hkv, d = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    h = rms_norm(x, eps, w["ln1"])
    q = rope(mm(h, w["wq"]).view(B, T, H, d), theta)
    k = rope(mm(h, w["wk"]).view(B, T, Hkv, d), theta)
    v = mm(h, w["wv"]).view(B, T, Hkv, d)
    x = x + mm(attention(q, k, v).reshape(B, T, H * d), w["wo"])
    h2 = rms_norm(x, eps, w["ln2"])
    gated = torch.nn.functional.silu(mm(h2, w["w_gate"])) * mm(h2, w["w_up"])
    return x + mm(gated, w["w_down"])


def fp32_exact() -> None:
    """Float32 products stay float32 (no TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
