"""On-device explanation LLM — twin of ``fraud_detection_tpu/models/llm.py``.

A pre-norm decoder (RMSNorm / RoPE attention with GQA or MQA / SwiGLU or
GeGLU), as ``nn.Module``s holding the JAX package's parameter layout
(``Transformer``, ``DecoderLayer``) and plain functions on tensors:

  * ``forward`` in full-sequence mode (causal attention dispatched by
    length: materialized scores below ``_FLASH_MIN_T``, the hand-written
    CUDA flash kernel of ``ops/attention.py`` above it, or the chunked
    online-softmax path with ``use_flash=False``) and in KV-cache mode
    (``positions``, ``cache_len``, ``valid_from`` for left-padded batches);
  * batched decode of uneven prompts (``LanguageModel.generate_tokens_batch``),
    greedy or sampled, early exit once every row is done.

Where the JAX package rounds at a point that matters (RMSNorm's f32
variance, RoPE's f32 angles cast to the activation type, the embedding
scale rounded to the model type, bf16 logits cast to f32 after the head,
first-maximum argmax), this module rounds at the same point, and says so
beside the code. Tensor and sequence parallelism, int8 weights and the
slot/paged decode programs are not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fraud_detection_tpu_torch.ops.attention import flash_attention
from fraud_detection_tpu_torch.utils import threefry
from fraud_detection_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 258          # 256 bytes + BOS + EOS
    d_model: int = 256
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 1024
    max_seq: int = 2048
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.float32   # bfloat16 on the card
    n_kv_heads: Optional[int] = None     # < n_heads = GQA; 1 = MQA (Gemma-2B)
    head_dim_override: Optional[int] = None  # Gemma: head_dim != D/H
    activation: str = "silu"             # "silu" | "gelu" (tanh GeLU)
    embed_scale: float = 1.0             # Gemma scales embeddings by sqrt(D)
    tie_embeddings: bool = True          # False = separate "lm_head"
    rms_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return (self.head_dim_override if self.head_dim_override is not None
                else self.d_model // self.n_heads)

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    BOS: int = field(default=256, init=False)
    EOS: int = field(default=257, init=False)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _layer_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    D, H, Hkv, d, Ff = (cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim,
                        cfg.d_ff)
    return {"wq": (D, H, d), "wk": (D, Hkv, d), "wv": (D, Hkv, d),
            "wo": (H, d, D), "w_gate": (D, Ff), "w_up": (D, Ff),
            "w_down": (Ff, D), "ln1": (D,), "ln2": (D,)}


def _weight(shape, cfg: TransformerConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device),
                        requires_grad=False)


class DecoderLayer(nn.Module):
    """One layer's weights: wq (D, H, d), wk/wv (D, Hkv, d), wo (H, d, D),
    w_gate/w_up (D, F), w_down (F, D), ln1/ln2 (D,)."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        for name, shape in _layer_shapes(cfg).items():
            self.register_parameter(name, _weight(shape, cfg, device))


class Transformer(nn.Module):
    """The decoder's weights: embed (V, D), lm_head (V, D) unless tied,
    ``layers``, ln_f (D,). ``param(name)`` reads them by the JAX package's
    parameter names (``embed``, ``l3.wq``, ``ln_f`` ...)."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        shape = (cfg.vocab_size, cfg.d_model)
        self.embed = _weight(shape, cfg, device)
        if not cfg.tie_embeddings:
            self.lm_head = _weight(shape, cfg, device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = _weight((cfg.d_model,), cfg, device)

    def param_names(self) -> list:
        names = ["embed"] + ([] if self.cfg.tie_embeddings else ["lm_head"])
        names += [f"l{l}.{leaf}" for l in range(self.cfg.n_layers)
                  for leaf in _layer_shapes(self.cfg)]
        return names + ["ln_f"]

    def param(self, name: str) -> nn.Parameter:
        if "." in name:
            layer, leaf = name.split(".")
            return getattr(self.layers[int(layer[1:])], leaf)
        return getattr(self, name)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg: TransformerConfig, generator: torch.Generator, *,
                std: Optional[float] = None) -> Transformer:
    """Random weights on ``generator``'s device: every matrix drawn as f32
    N(0, std^2) and rounded to ``cfg.dtype``, norm gains 1. ``std`` defaults
    to 1/sqrt(D), the JAX package's init; the draws themselves differ from
    JAX's (another generator)."""
    std = 1.0 / math.sqrt(cfg.d_model) if std is None else std
    model = Transformer(cfg, device=generator.device)
    for name in model.param_names():
        p = model.param(name)
        if name.rsplit(".", 1)[-1] in ("ln1", "ln2", "ln_f"):
            p.data.fill_(1.0)
        else:
            p.data.copy_(torch.randn(p.shape, generator=generator,
                                     device=generator.device).mul_(std))
    return model


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm as the JAX package rounds it: the variance in f32, x times
    its rsqrt in f32, cast to x's dtype, then times gamma."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def _rope_tables(positions: torch.Tensor, d: int, theta: float, dtype):
    """cos/sin (..., T, 1, d/2) for ``rope``: computed in f32 and cast to
    the activation dtype before the multiply, as in the JAX package."""
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=positions.device) / d)
    angles = positions[..., :, None].float() * freqs
    return (torch.cos(angles)[..., :, None, :].to(dtype),
            torch.sin(angles)[..., :, None, :].to(dtype))


def _apply_rope(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on interleaved pairs (0::2, 1::2), restacked — not
    rotate-half. x: (..., T, H, d); positions (..., T), negative on left-pad
    rows."""
    return _apply_rope(x, *_rope_tables(positions, x.shape[-1], theta, x.dtype))


def _attend(q, k, v, mask) -> torch.Tensor:
    """Masked attention with materialized scores. q: (B, T, H, d), k/v:
    (B, S, H, d), mask (T, S) or per-row (B, T, S). As in the JAX package
    the score product runs in the input dtype, is cast to f32 and divided by
    sqrt(d); masked entries are -inf; softmax in f32; probabilities cast to
    q's dtype."""
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(q.shape[-1])
    mask_b = mask[None] if mask.ndim == 2 else mask
    scores.masked_fill_(~mask_b[:, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


# Below this the materialized-score path is used; above it the blockwise
# paths keep memory bounded.
_FLASH_MIN_T = 512


def _online_softmax_update(qf, k_part, v_part, q_pos, k_pos, m, l, acc,
                           scale: float):
    """One online-softmax accumulation against a slice of keys; m, l (B, H,
    T) and acc (B, H, T, d) in f32, -inf for masked scores and for rows with
    no key yet."""
    scores = torch.einsum("bthd,bshd->bhts", qf, k_part.float()) * scale
    causal = q_pos[:, None] >= k_pos[None, :]
    scores = scores.masked_fill(~causal[None, None], float("-inf"))
    m_new = torch.maximum(m, scores.amax(dim=-1))
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(torch.isneginf(scores), 0.0, p)
    correction = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
    l_new = l * correction + p.sum(dim=-1)
    acc_new = (acc * correction[..., None]
               + torch.einsum("bhts,bshd->bhtd", p, v_part.float()))
    return m_new, l_new, acc_new


def _chunked_key_pass(qf, q_pos, k_pad, v_pad, *, chunk: int, n_chunks: int,
                      valid_len: int, far: int, carry, scale: float):
    """Online-softmax accumulation over the first ``n_chunks`` key chunks
    of a padded block; keys at or past ``valid_len`` get the ``far``
    position the causal test rejects. With autograd on, each chunk's
    probabilities are recomputed in backward instead of saved, so backward
    memory stays bounded too."""
    m, l, acc = carry
    for c in range(n_chunks):
        k_c = k_pad[:, c * chunk:(c + 1) * chunk]
        v_c = v_pad[:, c * chunk:(c + 1) * chunk]
        j = c * chunk + torch.arange(chunk, device=k_pad.device)
        k_pos = torch.where(j < valid_len, j, far)
        args = (qf, k_c, v_c, q_pos, k_pos, m, l, acc, scale)
        if torch.is_grad_enabled():
            m, l, acc = checkpoint(_online_softmax_update, *args,
                                   use_reentrant=False)
        else:
            m, l, acc = _online_softmax_update(*args)
    return m, l, acc


def chunked_causal_attention(q, k, v, q_chunk: int = 512,
                             key_chunk: int = 1024) -> torch.Tensor:
    """Memory-bounded causal attention in plain torch: a loop over query
    chunks, online softmax over the key chunks at or below each chunk's
    diagonal; peak score memory O(q_chunk * key_chunk) per head, in backward
    too. q/k/v (B, T, H, d) at one head count."""
    B, T, H, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qc, kc = min(q_chunk, T), min(key_chunk, T)
    n_q, n_k = -(-T // qc), -(-T // kc)
    q_pad = F.pad(q, (0, 0, 0, 0, 0, n_q * qc - T))
    k_pad = F.pad(k, (0, 0, 0, 0, 0, n_k * kc - T))
    v_pad = F.pad(v, (0, 0, 0, 0, 0, n_k * kc - T))
    far = T + 1
    outs = []
    for qi in range(n_q):
        qf = q_pad[:, qi * qc:(qi + 1) * qc].float()
        q_pos = qi * qc + torch.arange(qc, device=q.device)
        carry = (torch.full((B, H, qc), float("-inf"), device=q.device),
                 torch.zeros((B, H, qc), device=q.device),
                 torch.zeros((B, H, qc, d), device=q.device))
        n_k_i = min(n_k, -(-(qi * qc + qc) // kc))
        _, l, acc = _chunked_key_pass(
            qf, q_pos, k_pad, v_pad, chunk=kc, n_chunks=n_k_i, valid_len=T,
            far=far, carry=carry, scale=scale)
        out = acc / torch.clamp_min(l, 1e-30)[..., None]      # (B, H, qc, d)
        outs.append(out.transpose(1, 2))
    return torch.cat(outs, dim=1)[:, :T].to(q.dtype)


def _expand_kv_heads(t: torch.Tensor, rep: int) -> torch.Tensor:
    """GQA/MQA kv -> full query-head width (each kv head repeated ``rep``
    times in place, ``jnp.repeat`` semantics)."""
    return t if rep == 1 else t.repeat_interleave(rep, dim=2)


class _FlashAttention(torch.autograd.Function):
    """The flash kernel forward; backward recomputes through
    ``chunked_causal_attention`` with k/v expanded, whose autograd sums
    dk/dv over each head group (the JAX package's ``_flash_diff_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        rep = q.shape[2] // k.shape[2]
        with torch.enable_grad():
            qi, ki, vi = (t.detach().requires_grad_() for t in (q, k, v))
            out = chunked_causal_attention(qi, _expand_kv_heads(ki, rep),
                                           _expand_kv_heads(vi, rep))
            return torch.autograd.grad(out, (qi, ki, vi), g)


def causal_attention(q, k, v, use_flash: Optional[bool] = None) -> torch.Tensor:
    """Full-sequence causal attention, dispatched as in the JAX package:
    short sequences use materialized scores; long ones (T >=
    ``_FLASH_MIN_T``) the flash kernel (differentiable through
    ``_FlashAttention``) unless ``use_flash=False``, which takes
    ``chunked_causal_attention``. k/v may be at their narrow GQA width: the
    flash kernel reads them natively, the other branches expand here."""
    long_seq = q.shape[1] >= _FLASH_MIN_T
    if use_flash is None:
        use_flash = long_seq
    if use_flash:
        return _FlashAttention.apply(q, k, v)
    rep = q.shape[2] // k.shape[2]
    k, v = _expand_kv_heads(k, rep), _expand_kv_heads(v, rep)
    if long_seq:
        return chunked_causal_attention(q, k, v)
    t = q.shape[1]
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    return _attend(q, k, v, causal)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(params: Transformer, tokens: torch.Tensor, cfg: TransformerConfig,
            *, positions: Optional[torch.Tensor] = None,
            kv_cache: Optional[Dict[str, torch.Tensor]] = None,
            cache_len: int = 0,
            valid_from: Optional[torch.Tensor] = None,
            use_flash: Optional[bool] = None,
            logits_last_only: bool = False
            ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """f32 logits (B, T, V) for tokens (B, T), or (B, 1, V) with
    ``logits_last_only``.

    Full-sequence mode (``kv_cache`` None): causal attention dispatched by
    length (``causal_attention``). KV-cache mode: this call's k/v are
    written into ``kv_cache`` at ``cache_len`` IN PLACE (the returned cache
    is the same dict) and queries attend every cache slot at or below their
    own; ``valid_from`` (B,) masks each row's left-pad slots, keeping each
    query's own slot visible so a pad query never softmaxes an empty row."""
    B, T = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = torch.arange(T, device=dev).expand(B, T)
    x = params.embed[tokens].to(cfg.dtype)
    if cfg.embed_scale != 1.0:
        # rounded to the model dtype before the multiply (bf16: 45.25)
        x = x * float(torch.tensor(cfg.embed_scale, dtype=cfg.dtype))
    act = F.silu if cfg.activation == "silu" else partial(F.gelu,
                                                          approximate="tanh")
    rep = cfg.n_heads // cfg.kv_heads
    H, Hkv, d, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
    # Every layer shares the RoPE tables and the cache mask: built once.
    cos, sin = _rope_tables(positions, d, cfg.rope_theta, cfg.dtype)
    if kv_cache is not None:
        s_idx = torch.arange(kv_cache["l0.k"].shape[1], device=dev)
        t_idx = cache_len + torch.arange(T, device=dev)
        valid = s_idx[None, :] <= t_idx[:, None]                 # (T, S)
        if valid_from is not None:
            own = s_idx[None, :] == t_idx[:, None]
            valid = ((valid[None]
                      & (s_idx[None, None, :] >= valid_from[:, None, None]))
                     | own[None])                                # (B, T, S)

    for l, layer in enumerate(params.layers):
        h = rms_norm(x, layer.ln1, cfg.rms_eps)
        q = (h @ layer.wq.reshape(D, H * d)).view(B, T, H, d)
        k = (h @ layer.wk.reshape(D, Hkv * d)).view(B, T, Hkv, d)
        v = (h @ layer.wv.reshape(D, Hkv * d)).view(B, T, Hkv, d)
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)

        if kv_cache is not None:
            ck, cv = kv_cache[f"l{l}.k"], kv_cache[f"l{l}.v"]
            ck[:, cache_len:cache_len + T] = k
            cv[:, cache_len:cache_len + T] = v
            attn = _attend(q, _expand_kv_heads(ck, rep),
                           _expand_kv_heads(cv, rep), valid)
        else:
            attn = causal_attention(q, k, v, use_flash)

        x = x + attn.reshape(B, T, H * d) @ layer.wo.reshape(H * d, D)
        h2 = rms_norm(x, layer.ln2, cfg.rms_eps)
        x = x + (act(h2 @ layer.w_gate) * (h2 @ layer.w_up)) @ layer.w_down

    x = rms_norm(x, params.ln_f, cfg.rms_eps)
    if logits_last_only:
        x = x[:, -1:]
    head = params.embed if cfg.tie_embeddings else params.lm_head
    # the head product in the model dtype, then f32 (bf16 logits round first)
    return (x @ head.T).float(), kv_cache


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device) -> Dict[str, torch.Tensor]:
    """Zeroed (batch, max_len, Hkv, d) k and v per layer; ``forward``
    writes it in place."""
    return {f"l{l}.{t}": torch.zeros((batch, max_len, cfg.kv_heads,
                                      cfg.head_dim), dtype=cfg.dtype,
                                     device=device)
            for l in range(cfg.n_layers) for t in ("k", "v")}


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def _sample_token(temperature: float, logits: torch.Tensor, seed: int,
                  step: int) -> torch.Tensor:
    """Greedy at or below the temperature epsilon (argmax returns the first
    maximum, as ``jnp.argmax``), else the reference's draw: row ``r`` at
    ``step`` is ``categorical(fold_in(fold_in(PRNGKey(seed), step), r),
    logits_r / T)``, the Gumbel-max of JAX's threefry noise in the logits'
    dtype, so a row's token depends only on (seed, step, row).
    (B, V) -> (B,) int64."""
    if temperature <= 1e-6:
        return logits.argmax(dim=-1)
    dev = logits.device
    step_key = threefry.fold_in(threefry.prng_key(seed, dev), step)
    row_keys = threefry.fold_in(step_key, torch.arange(logits.shape[0],
                                                       device=dev))
    # a 0-dim tensor on the logits' device, so the division rounds as JAX's
    # does (a Python scalar divisor may become a multiply by its reciprocal)
    t = torch.tensor(max(temperature, 1e-6), dtype=logits.dtype, device=dev)
    noise = threefry.gumbel(row_keys, (logits.shape[1],), logits.dtype)
    return (noise + logits / t).argmax(dim=-1)


@torch.inference_mode()
def _generate_batch(params: Transformer, prompt: torch.Tensor,
                    prompt_len: torch.Tensor, row_real: torch.Tensor,
                    cfg: TransformerConfig, max_new: int, temperature: float,
                    seed: int) -> torch.Tensor:
    """Batched decode of uneven prompts. ``prompt`` (B, Tp) is LEFT-padded
    so every row's last real token sits at Tp-1: all rows share one cache
    write position per step, ``valid_from`` masks each row's pad slots and
    RoPE positions stay per-row real (negative on pads). Rows that sample
    EOS freeze (emit EOS from then on); rows not ``row_real`` are done from
    the start; the loop stops once every row is done (one host read per
    step). Returns (B, max_new) int64, EOS past each row's end."""
    B, Tp = prompt.shape
    dev = prompt.device
    cache = init_cache(cfg, B, Tp + max_new, dev)
    valid_from = Tp - prompt_len                               # (B,)
    positions = torch.arange(Tp, device=dev)[None, :] - valid_from[:, None]
    logits, _ = forward(params, prompt, cfg, positions=positions,
                        kv_cache=cache, cache_len=0, valid_from=valid_from,
                        logits_last_only=True)
    last = logits[:, -1]
    out = torch.full((B, max_new), cfg.EOS, dtype=torch.int64, device=dev)
    done = ~row_real
    for i in range(max_new):
        if bool(done.all()):
            break
        tok = torch.where(done, cfg.EOS,
                          _sample_token(temperature, last, seed, i))
        out[:, i] = tok
        done = done | (tok == cfg.EOS)
        if i + 1 == max_new:
            break
        logits, _ = forward(params, tok[:, None], cfg,
                            positions=(prompt_len + i)[:, None],
                            kv_cache=cache, cache_len=Tp + i,
                            valid_from=valid_from)
        last = logits[:, 0]
    return out


class ByteTokenizer:
    """Self-contained byte-level tokenizer (no external vocab)."""

    def __init__(self, cfg: TransformerConfig):
        self.cfg = cfg

    def encode(self, text: str) -> np.ndarray:
        data = text.encode("utf-8")[: self.cfg.max_seq - 2]
        return np.asarray([self.cfg.BOS] + list(data), np.int32)

    def decode(self, tokens) -> str:
        out = bytearray()
        for t in np.asarray(tokens).tolist():
            if t == self.cfg.EOS:
                break
            if 0 <= t < 256:
                out.append(t)
        return out.decode("utf-8", "replace")


@dataclass
class LanguageModel:
    """Weights + config + tokenizer behind a text-in/text-out API."""

    cfg: TransformerConfig
    params: Transformer
    tokenizer: ByteTokenizer = None

    def __post_init__(self):
        if self.tokenizer is None:
            self.tokenizer = ByteTokenizer(self.cfg)

    @property
    def device(self) -> torch.device:
        return self.params.device

    @classmethod
    def init_random(cls, cfg: Optional[TransformerConfig] = None, seed: int = 0,
                    device="cuda", std: Optional[float] = None
                    ) -> "LanguageModel":
        """Random weights drawn on ``device`` from ``seed`` (see
        ``init_params``)."""
        cfg = cfg or TransformerConfig()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_params(cfg, gen, std=std))

    def generate_tokens(self, prompt_tokens, *, max_new_tokens: int = 64,
                        temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        """Single-prompt decode: the B=1 case of ``generate_tokens_batch``."""
        return self.generate_tokens_batch(
            [np.asarray(prompt_tokens)], max_new_tokens=max_new_tokens,
            temperature=temperature, seed=seed)[0]

    def generate_tokens_batch(self, prompts: Sequence, *,
                              max_new_tokens: int = 64,
                              temperature: float = 0.0,
                              seed: int = 0) -> np.ndarray:
        """Decode a batch of uneven-length token prompts together. Prompts
        are left-padded to a multiple of 8 and the batch to a power of two
        (dummy rows, done from the start and sliced away), the JAX package's
        buckets. Row r's tokens depend only on (seed, step, r), not on the
        rows batched with it. Returns (B, max_new_tokens) int32."""
        n = len(prompts)
        if n == 0:
            return np.zeros((0, max_new_tokens), np.int32)
        b_pad = 1 << (n - 1).bit_length()
        lens = np.asarray([len(p) for p in prompts] + [1] * (b_pad - n),
                          np.int64)
        pad = 8 * ((int(lens.max()) + 7) // 8)
        prompt = np.zeros((b_pad, pad), np.int64)
        for i, p in enumerate(prompts):
            prompt[i, pad - len(p):] = p        # LEFT-padded
        dev = self.device
        toks = _generate_batch(
            self.params, torch.from_numpy(prompt).to(dev),
            torch.from_numpy(lens).to(dev),
            torch.arange(b_pad, device=dev) < n, self.cfg,
            int(max_new_tokens), float(temperature), int(seed))
        return toks[:n].cpu().numpy().astype(np.int32)

    def generate_text(self, prompt: str, *, temperature: float = 0.0,
                      max_new_tokens: int = 256, seed: int = 0) -> str:
        toks = self.generate_tokens(self.tokenizer.encode(prompt),
                                    max_new_tokens=max_new_tokens,
                                    temperature=temperature, seed=seed)
        return self.tokenizer.decode(toks)

    def generate_text_batch(self, prompts: Sequence[str], *,
                            temperature: float = 0.0,
                            max_new_tokens: int = 256, seed: int = 0):
        """Text in, text out for many prompts in one batched decode."""
        toks = self.generate_tokens_batch(
            [self.tokenizer.encode(p) for p in prompts],
            max_new_tokens=max_new_tokens, temperature=temperature, seed=seed)
        return [self.tokenizer.decode(t) for t in toks]
