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
beside the code.

The slot programs of continuous batching (``slot_prefill``,
``slot_decode_window``) and their paged twins over a flat page pool
(``init_kv_pages``, ``copy_kv_page``, ``paged_slot_prefill``,
``paged_decode_window``) serve ``explain/slotserve/``.

Weight-only int8 (``quantize_params``, ``LanguageModel.quantized``, and
``checkpoint/hf_convert.py``'s ``int8=True`` load): a ``Q8`` leaf (int8
``q`` and f32 per-output-channel ``scale``) stands in a weight's place, and
every weight product goes through ``_mm`` or the head's ``_logits_head``,
which hand an int8 weight to ``ops/int8_matmul.py`` (the hand-written W8A16
kernel on the card, reading the weight at int8 width), so every program
above takes int8 weights with no code of its own.

Tensor parallelism (``param_shardings``, ``shard_params``, the Megatron
layout over a mesh's "model" axis): a split weight is a ``Sharded`` leaf,
one slice per model-axis device. ``_qkv`` and ``_layer_out``, which every
program builds its layers from, run the column-parallel products (wq, wk/wv
when the K/V heads divide the axis, w_gate, w_up) on each slice's device
and add the row-parallel partials (wo, w_down) in model-axis order on the
residual's device, ``all_reduce``-d across processes where the model axis
spans several. Full-sequence attention runs per head group on its device
(the flash kernel there, at the group's width). The KV-cache programs
(batched decode, the slot and paged programs) keep each layer's cache
head-sharded beside wk/wv where the K/V heads divide the model axis: one
(..., Hkv/n, d) part per model-axis device, written and attended by its
head group there (``init_cache(params=)``, ``_cache_groups``); MQA and any
Hkv the axis does not divide keep one cache on the first device, where
each layer's q/k/v are gathered. Sequence parallelism (``ring_attention``,
``ulysses_attention``, ``forward(..., seq_mesh=)``): the sequence is split
over a mesh's "seq" axis (and the batch over "data"); a ring rotation is a
``.to()`` of the next device (differentiable, so training backpropagates
through it). Across processes, one per card as torchrun starts them, the
model, sequence or batch axis spans them and the programs move tensors
with ``parallel/mesh.py``'s collectives, each with its own backward:
``sum_across`` (the row-parallel sum), ``grad_sum_across`` (a replicated
input to each process's share of the work), ``gather_across``,
``all_to_all_across`` (Ulysses' two re-splits) and ``ring_shift``; a
forward chains them (``collective_order``) so that their backwards run in
one order on every process.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import partial, wraps
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fraud_detection_tpu_torch.ops.attention import flash_attention
from fraud_detection_tpu_torch.ops.int8_matmul import w8_matmul
from fraud_detection_tpu_torch.parallel.mesh import (
    Mesh, Sharding, all_to_all_across, collective_order, gather_across,
    grad_sum_across, ring_shift, spans, sum_across)
from fraud_detection_tpu_torch.utils import threefry
from fraud_detection_tpu_torch.utils.device import resolve_device

MODEL_AXIS = "model"
SEQ_AXIS = "seq"
DATA_AXIS = "data"   # batch axis of 2-D (data, seq) / (data, model) meshes


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


class Q8(nn.Module):
    """Per-output-channel int8 weight, ``w ~= q * scale``: ``q`` int8 in the
    weight's shape, ``scale`` f32 with the weight's rank, singleton along its
    input dims (the JAX package's ``Q8``). Consumers hand ``q`` to the
    product at int8 width and apply the scale to the product's output."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)


class Sharded:
    """A weight split over a mesh's "model" axis (``shard_params``):
    ``parts[i]``, a tensor or a ``Q8``, is this process's i-th model index's
    slice of the weight along ``dim``, on that index's device. Where the
    mesh's first axis is the model axis and spans processes, each process
    holds its own indices' parts and ``mesh.group`` is the group the
    row-parallel sums all-reduce over."""

    def __init__(self, parts, dim: int, mesh: Mesh):
        self.parts = list(parts)
        self.dim = dim
        self.mesh = mesh

    @property
    def devices(self) -> list:
        return [_leaf_device(p) for p in self.parts]

    def gather(self):
        """The whole weight (a tensor or a ``Q8``) on the first part's
        device: the parts in model-axis order, every process's."""
        if isinstance(self.parts[0], Q8):
            scales = [p.scale for p in self.parts]
            split = scales[0].shape[self.dim] != 1
            return Q8(self._cat([p.q for p in self.parts]),
                      self._cat(scales) if split else scales[0])
        return self._cat(self.parts)

    def _cat(self, parts) -> torch.Tensor:
        home = parts[0].device
        local = torch.cat([p.detach().to(home) for p in parts], dim=self.dim)
        if not spans(self.mesh, MODEL_AXIS):
            return local
        return gather_across(local, self.dim, self.mesh)


def _leaf_device(leaf) -> torch.device:
    return leaf.q.device if isinstance(leaf, Q8) else leaf.device


class DecoderLayer(nn.Module):
    """One layer's weights: wq (D, H, d), wk/wv (D, Hkv, d), wo (H, d, D),
    w_gate/w_up (D, F), w_down (F, D), ln1/ln2 (D,); a matrix may be a
    ``Q8``."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        for name, shape in _layer_shapes(cfg).items():
            self.register_parameter(name, _weight(shape, cfg, device))


class Transformer(nn.Module):
    """The decoder's weights: embed (V, D), lm_head (V, D) unless tied,
    ``layers``, ln_f (D,). ``param(name)`` reads them by the JAX package's
    parameter names (``embed``, ``l3.wq``, ``ln_f`` ...), ``set_param``
    replaces one (a tensor or a ``Q8``)."""

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

    @classmethod
    def from_leaves(cls, cfg: TransformerConfig, leaves, *,
                    wrap: bool = True) -> "Transformer":
        """A model holding ``leaves`` ({name: tensor | Q8 | Sharded}, every
        name of ``param_names``) as they are: nothing is copied or cast.
        ``wrap=False`` keeps tensors as they are instead of frozen
        ``nn.Parameter`` s, so a trainer's forward differentiates through
        them to the tensors they were made from."""
        model = cls(cfg, device="meta")
        for name in model.param_names():
            model.set_param(name, leaves[name], wrap=wrap)
        return model

    def param_names(self) -> list:
        names = ["embed"] + ([] if self.cfg.tie_embeddings else ["lm_head"])
        names += [f"l{l}.{leaf}" for l in range(self.cfg.n_layers)
                  for leaf in _layer_shapes(self.cfg)]
        return names + ["ln_f"]

    def _owner(self, name: str):
        if "." in name:
            layer, leaf = name.split(".")
            return self.layers[int(layer[1:])], leaf
        return self, name

    def param(self, name: str):
        owner, leaf = self._owner(name)
        return getattr(owner, leaf)

    def set_param(self, name: str, value, *, wrap: bool = True) -> None:
        owner, leaf = self._owner(name)
        if leaf in owner._parameters or leaf in owner._modules:
            delattr(owner, leaf)   # a Parameter's slot takes no module
        if wrap and isinstance(value, torch.Tensor):
            value = nn.Parameter(value, requires_grad=False)
        setattr(owner, leaf, value)

    @property
    def device(self) -> torch.device:
        return self.ln_f.device


def init_params_threefry(cfg: TransformerConfig, seed: int,
                         device="cuda") -> Transformer:
    """The JAX package's ``init_params(PRNGKey(seed), cfg)``: the keys of
    ``split(PRNGKey(seed), 7 L + 2)`` (embed 0, lm_head the last, layer l's
    seven matrices 1 + 7 l ...), each matrix a float32 ``normal`` draw
    (``utils/threefry.py``) times 1/sqrt(D), rounded to ``cfg.dtype``; norm
    gains 1. Equal to JAX's weights to float32 rounding (torch's erfinv)."""
    dev = resolve_device(device)
    keys = threefry.split(threefry.prng_key(seed, dev), cfg.n_layers * 7 + 2)
    scale = torch.full((), 1.0 / math.sqrt(cfg.d_model), dtype=torch.float32,
                       device=dev)
    order = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    model = Transformer(cfg, device="meta")
    leaves = {}
    for name in model.param_names():
        shape = tuple(model.param(name).shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("ln1", "ln2", "ln_f"):
            leaves[name] = torch.ones(shape, dtype=cfg.dtype, device=dev)
            continue
        if leaf == "embed":
            key = keys[0]
        elif leaf == "lm_head":
            key = keys[-1]
        else:
            layer = int(name.split(".")[0][1:])
            key = keys[1 + layer * 7 + order.index(leaf)]
        leaves[name] = (threefry.normal(key, shape) * scale).to(cfg.dtype)
    return Transformer.from_leaves(cfg, leaves)


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
# weight-only int8: decode streams every weight at every step, so int8
# weights halve the bytes a step reads
# ---------------------------------------------------------------------------

#: weight name suffix -> axes reduced for the absmax (the INPUT dims).
_QUANT_REDUCE_AXES = {
    "wq": (0,), "wk": (0,), "wv": (0,),      # (D, h, d): in = D
    "wo": (0, 1),                            # (h, d, D): in = (h, d)
    "w_gate": (0,), "w_up": (0,),            # (D, F): in = D
    "w_down": (0,),                          # (F, D): in = F
    "embed": (1,), "lm_head": (1,),          # (V, D): per-row (gather + head)
}


def _quant_axes(name: str, include_embed: bool):
    """The absmax axes of parameter ``name``, None where it stays as it is
    (norm gains; the embedding and head unless ``include_embed``)."""
    suffix = name.rsplit(".", 1)[-1]
    if suffix in ("embed", "lm_head") and not include_embed:
        return None
    return _QUANT_REDUCE_AXES.get(suffix)


def _absmax(w: torch.Tensor, axes) -> torch.Tensor:
    return w.float().abs().amax(dim=axes, keepdim=True)


def _quantize(w: torch.Tensor, axes, absmax: Optional[torch.Tensor] = None
              ) -> Q8:
    """The JAX package's quantizer: f32 math, keepdims absmax over the input
    axes, scale max(absmax, 1e-8) / 127, round half to even, clip to +-127.
    Each f32 quotient is taken in float64 and rounded to f32 once, which is
    the correctly rounded f32 quotient (53 >= 2 x 24 + 2 bits), on every
    device: torch's CUDA division by a Python scalar multiplies by its
    reciprocal instead, one ulp off now and then. So the card, the CPU and
    numpy give the same bits."""
    wf = w.float()
    if absmax is None:
        absmax = _absmax(wf, axes)
    denom = torch.full((), 127.0, dtype=torch.float64, device=w.device)
    scale = (torch.clamp_min(absmax, 1e-8).double() / denom).float()
    q = torch.round((wf.double() / scale.double()).float())
    return Q8(torch.clamp(q, -127, 127).to(torch.int8), scale)


def quantize_params(params: Transformer, *,
                    include_embed: bool = True) -> Transformer:
    """Weight-only int8 copy of ``params`` on its device, per-output-channel
    scales. Norm gains stay at full precision; ``include_embed=False`` keeps
    the embedding and output head too. Leaves that stay are shared, not
    copied."""
    leaves = {}
    for name in params.param_names():
        w = params.param(name)
        axes = _quant_axes(name, include_embed)
        if isinstance(w, Sharded):
            leaves[name] = w if axes is None else _quantize_sharded(w, axes)
        else:
            leaves[name] = (w if axes is None or isinstance(w, Q8)
                            else _quantize(w.detach(), axes))
    return Transformer.from_leaves(params.cfg, leaves)


def _quantize_sharded(w: Sharded, axes) -> Sharded:
    """A split weight quantized shard by shard, to the bits of quantizing
    it whole: where the split dim is an input dim (wo, w_down) the absmax
    is the max of every shard's, across processes too, and each shard
    takes the whole scale; elsewhere each shard's scale is its slice."""
    if any(isinstance(p, Q8) for p in w.parts):
        return w
    parts = [p.detach() for p in w.parts]
    if w.dim not in axes:
        return Sharded([_quantize(p, axes) for p in parts], w.dim, w.mesh)
    home = parts[0].device
    total = _absmax(parts[0], axes)
    for p in parts[1:]:
        total = torch.maximum(total, _absmax(p, axes).to(home))
    if spans(w.mesh, MODEL_AXIS):
        torch.distributed.all_reduce(total, torch.distributed.ReduceOp.MAX,
                                     group=w.mesh.group)
    return Sharded([_quantize(p, axes, total.to(p.device)) for p in parts],
                   w.dim, w.mesh)


def quantize_params_host(params: Dict[str, torch.Tensor], *,
                         include_embed: bool = True,
                         compute_dtype: Optional[torch.dtype] = None) -> dict:
    """``quantize_params`` over a dict of host tensors ({name: tensor}), for
    loads that quantize before the upload (``checkpoint/hf_convert.py``):
    half the bytes go to the card. ``compute_dtype``: the model dtype an
    after-load ``quantize_params`` would have seen; weights round-trip
    through it first (round to nearest even), so a checkpoint loaded at
    another dtype quantizes the same values on both paths. Returns
    {name: tensor | Q8}."""
    out = {}
    for name, w in params.items():
        axes = _quant_axes(name, include_embed)
        if axes is None:
            out[name] = w
            continue
        if compute_dtype is not None:
            w = w.to(compute_dtype)
        out[name] = _quantize(w, axes)
    return out


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """``x`` (..., K) times the weight ``w`` viewed as (K, N): a layer
    weight's product in the JAX package's layout (``_mm``). An int8 weight
    goes to ``w8_matmul`` at int8 width, its scale applied to the product's
    output, at the reference's rounding points: the product in the model
    dtype, times the f32 scale, rounded to the model dtype again."""
    k = x.shape[-1]
    if isinstance(w, Q8):
        y = w8_matmul(x.reshape(-1, k), w.q.reshape(k, -1),
                      w.scale.reshape(-1), "kn")
        return y.reshape(*x.shape[:-1], y.shape[-1])
    return x @ w.reshape(k, -1)


# ---------------------------------------------------------------------------
# tensor parallelism: the Megatron layout over a mesh's "model" axis
# ---------------------------------------------------------------------------

def param_shardings(cfg: TransformerConfig, mesh: Mesh) -> Dict[str, Sharding]:
    """The Megatron layout as one ``Sharding`` a parameter: wq split over
    heads, wk/wv too when the K/V heads divide the model axis (else
    replicated, as MQA's one head is), wo and w_down row-parallel (their
    input dim split), w_gate and w_up column-parallel; embed, lm_head and
    the norms replicated (spec ``()``)."""
    rep = Sharding(mesh, ())
    kv = (Sharding(mesh, (None, MODEL_AXIS, None))
          if cfg.kv_heads % mesh.shape[MODEL_AXIS] == 0 else rep)
    out = {"embed": rep, "ln_f": rep}
    if not cfg.tie_embeddings:
        out["lm_head"] = rep
    for l in range(cfg.n_layers):
        out.update({f"l{l}.wq": Sharding(mesh, (None, MODEL_AXIS, None)),
                    f"l{l}.wk": kv, f"l{l}.wv": kv,
                    f"l{l}.wo": Sharding(mesh, (MODEL_AXIS, None, None)),
                    f"l{l}.w_gate": Sharding(mesh, (None, MODEL_AXIS)),
                    f"l{l}.w_up": Sharding(mesh, (None, MODEL_AXIS)),
                    f"l{l}.w_down": Sharding(mesh, (MODEL_AXIS, None)),
                    f"l{l}.ln1": rep, f"l{l}.ln2": rep})
    return out


def _scale_sharding(weight_sh: Sharding, scale_shape) -> Sharding:
    """A ``Q8`` scale's placement: the weight's spec on the dims the scale
    keeps. Scales are singleton along the weight's input dims, so only its
    output dims can be split: wq's (1, H, d) scale is split over heads,
    wo's (1, 1, D) replicated."""
    spec = list(weight_sh.spec) + [None] * (len(scale_shape) - len(weight_sh.spec))
    return Sharding(weight_sh.mesh, tuple(
        None if scale_shape[i] == 1 else spec[i]
        for i in range(len(scale_shape))))


def _model_offset(mesh: Mesh) -> int:
    """This process's first global index on the model axis."""
    if spans(mesh, MODEL_AXIS):
        return mesh.process_index * mesh.local_size(MODEL_AXIS)
    return 0


def _shard_slice(t: torch.Tensor, dim: int, index: int, n: int,
                 dev) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.detach().narrow(dim, index * size, size).to(dev, copy=True)


def shard_params(params: Transformer, cfg: TransformerConfig,
                 mesh: Mesh) -> Transformer:
    """``params`` (full precision or int8) placed on ``mesh`` in the
    Megatron layout (``param_shardings``): each split weight a ``Sharded``
    leaf holding one fresh 1/n slice per device of the model axis (this
    process's devices where the axis spans processes), every replicated one
    on the mesh's first device. A ``Q8`` shards componentwise: ``q`` takes
    the weight's split, the scale its output dims' (``_scale_sharding``), so
    quantizing then sharding and sharding then quantizing give the same
    leaves."""
    n = mesh.shape[MODEL_AXIS]
    if cfg.n_heads % n or cfg.d_ff % n:
        raise ValueError(f"the model axis ({n}) must divide n_heads "
                         f"({cfg.n_heads}) and d_ff ({cfg.d_ff})")
    devs = mesh.axis_devices(MODEL_AXIS)
    first = _model_offset(mesh)
    sh = param_shardings(cfg, mesh)
    leaves = {}
    for name in params.param_names():
        v = params.param(name)
        if isinstance(v, Sharded):
            raise ValueError(f"{name} is already sharded")
        spec = sh[name].spec
        if MODEL_AXIS not in spec:
            leaves[name] = (Q8(v.q.to(mesh.home), v.scale.to(mesh.home))
                            if isinstance(v, Q8) else v.detach().to(mesh.home))
            continue
        dim = spec.index(MODEL_AXIS)
        parts = []
        for i, dev in enumerate(devs):
            if isinstance(v, Q8):
                split = MODEL_AXIS in _scale_sharding(sh[name],
                                                      v.scale.shape).spec
                parts.append(Q8(_shard_slice(v.q, dim, first + i, n, dev),
                                _shard_slice(v.scale, dim, first + i, n, dev)
                                if split else v.scale.to(dev, copy=True)))
            else:
                parts.append(_shard_slice(v, dim, first + i, n, dev))
        leaves[name] = Sharded(parts, dim, mesh)
    return Transformer.from_leaves(cfg, leaves)


def _model_sum(partials, home: torch.device, mesh: Mesh,
               dtype: torch.dtype) -> torch.Tensor:
    """The row-parallel sum: the partials added in float32 on ``home`` in
    model-axis order, all-reduced over the mesh's group where the model
    axis spans processes (``sum_across``: the gradient passes through), and
    rounded once to ``dtype``."""
    total = partials[0].to(home).float()
    for t in partials[1:]:
        total = total + t.to(home).float()
    if spans(mesh, MODEL_AXIS):
        total = sum_across(total, mesh)
    return total.to(dtype)


def _model_input(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A replicated activation fed to this process's column-parallel parts:
    where the model axis spans processes its gradient is summed over them
    (``grad_sum_across``), each holding only its parts' share."""
    return grad_sum_across(t, mesh) if spans(mesh, MODEL_AXIS) else t


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
                      valid_len: int, far: int, carry, scale: float,
                      base_pos: int = 0, remat: bool = True):
    """Online-softmax accumulation over the first ``n_chunks`` key chunks
    of a padded block whose keys sit at global positions ``base_pos + j``;
    keys at or past ``valid_len`` get the ``far`` position the causal test
    rejects. With ``remat`` and autograd on, each chunk's probabilities are
    recomputed in backward instead of saved, so backward memory stays
    bounded too."""
    m, l, acc = carry
    for c in range(n_chunks):
        k_c = k_pad[:, c * chunk:(c + 1) * chunk]
        v_c = v_pad[:, c * chunk:(c + 1) * chunk]
        j = c * chunk + torch.arange(chunk, device=k_pad.device)
        k_pos = torch.where(j < valid_len, base_pos + j, far)
        args = (qf, k_c, v_c, q_pos, k_pos, m, l, acc, scale)
        if remat and torch.is_grad_enabled():
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
    times in place, ``jnp.repeat`` semantics). A broadcast and a reshape,
    not ``repeat_interleave``: its backward is a sum over the repeats, not
    an indexed add, so it is deterministic on the card."""
    if rep == 1:
        return t
    B, S, H, d = t.shape
    return t[:, :, :, None, :].expand(B, S, H, rep, d).reshape(B, S, H * rep, d)


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
# sequence parallelism: ring and Ulysses attention over a mesh's "seq" axis
# ---------------------------------------------------------------------------

# Peak-memory knob of a ring step: scores materialize (B, H, T_loc, chunk)
# instead of (B, H, T_loc, T_loc).
_RING_KEY_CHUNK = 2048


def _seq_rows(mesh: Mesh, axis_name: str, batch_axis: Optional[str], B: int):
    """(batch slice, devices along ``axis_name``) per local batch row: one
    row over the whole batch, or one per ``batch_axis`` index of this
    process (its rows of the global batch where the axis spans
    processes)."""
    if batch_axis is None:
        return [(slice(0, B), mesh.axis_devices(axis_name))]
    nb = mesh.shape[batch_axis]
    if B % nb:
        raise ValueError(f"batch {B} not divisible by the '{batch_axis}' "
                         f"axis size ({nb})")
    per = B // nb
    local = mesh.local_size(batch_axis)
    first = mesh.process_index * local if spans(mesh, batch_axis) else 0
    return [(slice((first + r) * per, (first + r + 1) * per),
             mesh.take(batch_axis, r).axis_devices(axis_name))
            for r in range(local)]


def _sp_inputs(mesh: Mesh, axis_name: str, batch_axis: Optional[str],
               *ts) -> list:
    """q/k/v, whole on every process, entering attention whose sequence or
    batch axis spans the processes: each process's share of the work gives
    a partial gradient, summed over them (``grad_sum_across``)."""
    if spans(mesh, axis_name) or (batch_axis is not None
                                  and spans(mesh, batch_axis)):
        return [grad_sum_across(t, mesh) for t in ts]
    return list(ts)


def _sp_output(rows: list, mesh: Mesh, batch_axis: Optional[str]):
    """The local batch rows' outputs as one (B, T, H, d), every process's
    rows gathered in rank order where the batch axis spans processes."""
    out = rows[0] if len(rows) == 1 else torch.cat(rows, dim=0)
    if batch_axis is not None and spans(mesh, batch_axis):
        out = gather_across(out, 0, mesh)
    return out


def _seq_first(mesh: Mesh, axis_name: str) -> int:
    """This process's first global block on the sequence axis."""
    if spans(mesh, axis_name):
        return mesh.process_index * mesh.local_size(axis_name)
    return 0


def _gather_seq(blocks, home: torch.device, mesh: Mesh,
                axis_name: str) -> torch.Tensor:
    """Sequence blocks (B, T_loc, H, d) concatenated on ``home`` in global
    order, every process's where the axis spans several."""
    local = torch.cat([b.to(home) for b in blocks], dim=1)
    if not spans(mesh, axis_name):
        return local
    return gather_across(local, 1, mesh)


def _ring_rotate(blocks: list, devs: list, mesh: Mesh,
                 axis_name: str) -> list:
    """One rotation: the block of global index i moves to index i + 1. In
    one process a ``.to()`` of the next device (differentiable; the same
    tensor where both are one device: nothing writes a block in place); the
    block leaving this process goes to the next one by send/recv
    (``ring_shift``, whose backward rotates the gradient back)."""
    out = [None] + [b.to(d) for b, d in zip(blocks[:-1], devs[1:])]
    if spans(mesh, axis_name):
        out[0] = ring_shift(blocks[-1], devs[0], mesh)
    else:
        out[0] = blocks[-1].to(devs[0])
    return out


def _ring_row(q_blk, k_blk, v_blk, devs, *, n: int, first: int, mesh: Mesh,
              axis_name: str, scale: float, key_chunk: int) -> list:
    """Exact causal attention of one batch row's sequence blocks (this
    process's, global indices ``first + j`` of ``n``) with K/V rotating
    around the ring: n steps of online softmax per block, keys in
    ``key_chunk`` slices (ceil division; overhang keys take the ``far``
    sentinel). K/V ride the ring at their narrow GQA width and expand on
    arrival. Returns each block's output (B, T_loc, H, d) on its device."""
    B, T, H, d = q_blk[0].shape
    rep = H // k_blk[0].shape[2]
    chunk = min(T, key_chunk)
    n_chunks = -(-T // chunk)
    pad = n_chunks * chunk - T
    far = n * T + 1
    qf = [q.float() for q in q_blk]
    state = [(torch.full((B, H, T), float("-inf"), device=dev),
              torch.zeros((B, H, T), device=dev),
              torch.zeros((B, H, T, d), device=dev)) for dev in devs]
    kb, vb = list(k_blk), list(v_blk)
    for s in range(n):
        for j, dev in enumerate(devs):
            idx = first + j
            src = (idx - s) % n
            q_pos = idx * T + torch.arange(T, device=dev)
            k_full = _expand_kv_heads(kb[j], rep)
            v_full = _expand_kv_heads(vb[j], rep)
            if n_chunks == 1:
                k_pos = src * T + torch.arange(T, device=dev)
                state[j] = _online_softmax_update(qf[j], k_full, v_full, q_pos,
                                                  k_pos, *state[j], scale)
            else:
                state[j] = _chunked_key_pass(
                    qf[j], q_pos, F.pad(k_full, (0, 0, 0, 0, 0, pad)),
                    F.pad(v_full, (0, 0, 0, 0, 0, pad)), chunk=chunk,
                    n_chunks=n_chunks, valid_len=T, far=far, carry=state[j],
                    scale=scale, base_pos=src * T, remat=False)
        if s + 1 < n:
            kb = _ring_rotate(kb, devs, mesh, axis_name)
            vb = _ring_rotate(vb, devs, mesh, axis_name)
    return [(acc / torch.clamp_min(l, 1e-30)[..., None]).transpose(1, 2)
            .to(q_blk[0].dtype) for _, l, acc in state]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, axis_name: str = SEQ_AXIS,
                   key_chunk: int = _RING_KEY_CHUNK,
                   batch_axis: Optional[str] = None) -> torch.Tensor:
    """Exact causal attention with the sequence split over ``axis_name``.

    q (B, T, H, d), k/v at their narrow GQA width (B, T, Hkv, d), whole on
    one device; T must divide by the axis size. Device r of the axis owns
    positions [r T/n, (r + 1) T/n); K/V blocks rotate the ring (narrow),
    ``key_chunk`` bounds a step's score memory. ``batch_axis``: on a
    (data, seq) mesh, the batch split over that axis too, a ring per data
    row. Across processes (the sequence or the batch axis spanning them)
    each computes its own blocks or rows and the outputs are all-gathered;
    gradients flow back through the gathers and the rotation. Returns (B,
    T, H, d) on q's device."""
    if key_chunk < 1:
        raise ValueError(f"key_chunk must be >= 1, got {key_chunk}")
    n = mesh.shape[axis_name]
    B, T, H, d = q.shape
    if T % n:
        raise ValueError(f"ring_attention needs T ({T}) divisible by the "
                         f"'{axis_name}' axis size ({n})")
    t_loc = T // n
    first = _seq_first(mesh, axis_name)
    scale = 1.0 / math.sqrt(d)
    qkv = _sp_inputs(mesh, axis_name, batch_axis, q, k, v)
    rows = []
    for bs, devs in _seq_rows(mesh, axis_name, batch_axis, B):
        blocks = [[t[bs, (first + j) * t_loc:(first + j + 1) * t_loc].to(dev)
                   for j, dev in enumerate(devs)] for t in qkv]
        outs = _ring_row(*blocks, devs, n=n, first=first, mesh=mesh,
                         axis_name=axis_name, scale=scale, key_chunk=key_chunk)
        rows.append(_gather_seq(outs, q.device, mesh, axis_name))
    return _sp_output(rows, mesh, batch_axis)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: Mesh, axis_name: str = SEQ_AXIS,
                      batch_axis: Optional[str] = None) -> torch.Tensor:
    """All-to-all sequence parallelism (the Ulysses layout), the second
    strategy beside ``ring_attention``: each device's sequence block is
    re-split by heads (the first all-to-all, done by hand: device i takes
    head group i of every block), each device runs full causal attention
    for its H/n heads over the whole sequence, and the second all-to-all
    returns each block its positions for every head. q/k/v (B, T, H, d);
    narrow GQA k/v expand at entry (the re-split cuts the head axis); T and
    H must divide by the axis size. Where the sequence axis spans
    processes both re-splits are ``all_to_all_single`` between them
    (``_ulysses_across``); where the batch axis does, each process takes
    its rows and the outputs are all-gathered. Returns (B, T, H, d) on q's
    device."""
    n = mesh.shape[axis_name]
    B, T, H, d = q.shape
    k = _expand_kv_heads(k, H // k.shape[2])
    v = _expand_kv_heads(v, H // v.shape[2])
    if T % n or H % n:
        raise ValueError(
            f"ulysses_attention needs T ({T}) and H ({H}) divisible by the "
            f"'{axis_name}' axis size ({n}); use ring_attention otherwise")
    tl, hl = T // n, H // n
    qkv = _sp_inputs(mesh, axis_name, batch_axis, q, k, v)
    rows = []
    for bs, devs in _seq_rows(mesh, axis_name, batch_axis, B):
        if spans(mesh, axis_name):
            rows.append(_ulysses_across([t[bs] for t in qkv], devs, mesh,
                                        tl, hl).to(q.device))
            continue
        heads = []
        for t in qkv:
            blocks = [t[bs, j * tl:(j + 1) * tl].to(dev)
                      for j, dev in enumerate(devs)]
            heads.append([torch.cat([b[:, :, i * hl:(i + 1) * hl].to(dev)
                                     for b in blocks], dim=1)
                          for i, dev in enumerate(devs)])
        attn = [_attend(qh, kh, vh, torch.ones((T, T), dtype=torch.bool,
                                               device=dev).tril())
                for qh, kh, vh, dev in zip(*heads, devs)]
        outs = [torch.cat([a[:, j * tl:(j + 1) * tl].to(dev) for a in attn],
                          dim=2) for j, dev in enumerate(devs)]
        rows.append(torch.cat([o.to(q.device) for o in outs], dim=1))
    return _sp_output(rows, mesh, batch_axis)


def _ulysses_across(qkv: list, devs: list, mesh: Mesh, tl: int,
                    hl: int) -> torch.Tensor:
    """One batch row of Ulysses with the sequence axis over P processes of
    L devices each: this process holds blocks [r L, (r + 1) L), a range of
    L tl positions. The first all-to-all sends process p the head range of
    its L devices from that range and receives this process's head range
    from every range, so it holds the whole sequence for its H/P heads;
    each of its devices attends its hl heads; the second all-to-all returns
    each range its positions for every head, and the ranges are
    all-gathered. Returns (B, T, H, d) on the first device."""
    P, home = mesh.process_count, devs[0]
    lo = mesh.process_index * len(devs) * tl
    span = len(devs) * tl
    heads = []
    for t in qkv:
        b, T, H, d = t.shape
        part = t[:, lo:lo + span].to(home).reshape(b, span, P, H // P, d)
        got = all_to_all_across(part.permute(2, 0, 1, 3, 4), mesh)
        heads.append(got.permute(1, 0, 2, 3, 4).reshape(b, T, H // P, d))
    attn = [_attend(*(h[:, :, i * hl:(i + 1) * hl].to(dev) for h in heads),
                    torch.ones((T, T), dtype=torch.bool, device=dev).tril())
            for i, dev in enumerate(devs)]
    mine = torch.cat([a.to(home) for a in attn], dim=2)     # (b, T, H/P, d)
    back = all_to_all_across(
        mine.reshape(b, P, span, H // P, d).permute(1, 0, 2, 3, 4), mesh)
    local = back.permute(1, 2, 0, 3, 4).reshape(b, span, H, d)
    return gather_across(local, 1, mesh)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

class _EmbedRows(torch.autograd.Function):
    """``w[tokens]`` whose backward is a one-hot product: a sum in a fixed
    order, where an indexed gather's backward adds with atomics on the card
    (so a resumed fine-tune would not repeat the uninterrupted one)."""

    @staticmethod
    def forward(ctx, w, tokens):
        ctx.save_for_backward(tokens)
        ctx.rows = w.shape[0]
        return w[tokens]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        flat = tokens.reshape(-1)
        onehot = torch.zeros((flat.numel(), ctx.rows), dtype=g.dtype,
                             device=g.device).scatter_(1, flat[:, None], 1.0)
        return onehot.T @ g.reshape(flat.numel(), -1), None


def _embed(params: Transformer, tokens: torch.Tensor,
           cfg: TransformerConfig) -> torch.Tensor:
    emb = params.embed
    if cfg.vocab_size <= cfg.EOS:
        # A vocabulary narrower than the byte ids (a small HF checkpoint):
        # finished rows feed EOS back in, and JAX clamps an out-of-range
        # gather index where torch raises (or faults on the card).
        tokens = tokens.clamp(0, cfg.vocab_size - 1)
    if isinstance(emb, Q8):
        # only the gathered rows are dequantized (``_embed_rows``)
        x = (emb.q[tokens].float() * emb.scale[tokens]).to(cfg.dtype)
    elif emb.requires_grad and torch.is_grad_enabled():
        x = _EmbedRows.apply(emb, tokens).to(cfg.dtype)
    else:
        x = emb[tokens].to(cfg.dtype)
    if cfg.embed_scale != 1.0:
        # rounded to the model dtype before the multiply (bf16: 45.25)
        x = x * float(torch.tensor(cfg.embed_scale, dtype=cfg.dtype))
    return x


def _activation(cfg: TransformerConfig):
    return F.silu if cfg.activation == "silu" else partial(F.gelu,
                                                           approximate="tanh")


def _group_kv(t: torch.Tensor, q0: int, hq: int, rep: int) -> torch.Tensor:
    """The K/V heads (B, T, h, d) that query heads [q0, q0 + hq) read, at
    the narrowest width that keeps each query head's K/V head ``rep``
    query heads wide: whole K/V groups, or the one head they all share
    (MQA), else the heads expanded to the queries' width."""
    if hq % rep == 0:
        return t[:, :, q0 // rep:(q0 + hq) // rep]
    if rep % hq == 0:
        return t[:, :, q0 // rep:q0 // rep + 1]
    return _expand_kv_heads(t, rep)[:, :, q0:q0 + hq]


def _qkv_groups(layer: DecoderLayer, x: torch.Tensor, cos, sin,
                cfg: TransformerConfig):
    """Tensor parallelism's column-parallel products: for each model-axis
    device of this process, its head group's q (B, T, H/n, d) and k, v at
    the group's K/V width (H_kv/n split; where the K/V weights are
    replicated, computed once on x's device and the group's K/V heads
    copied: ``_group_kv``), RoPE applied, on that device; and the
    replicated (k, v) (B, T, Hkv, d) on x's device (None where split).
    Across processes the gradients of the replicated inputs, h and the
    replicated k/v, are summed over them (``_model_input``)."""
    B, T, _ = x.shape
    wq = layer.wq
    n = wq.mesh.shape[MODEL_AXIS]
    H, Hkv, d = cfg.n_heads // n, cfg.kv_heads, cfg.head_dim
    h = rms_norm(x, layer.ln1, cfg.rms_eps)
    split_kv = isinstance(layer.wk, Sharded)
    kv_rep = None
    if not split_kv:
        kv_rep = (_model_input(_apply_rope(_mm(h, layer.wk).view(B, T, Hkv, d),
                                           cos, sin), wq.mesh),
                  _model_input(_mm(h, layer.wv).view(B, T, Hkv, d), wq.mesh))
    h = _model_input(h, wq.mesh)
    first = _model_offset(wq.mesh)
    groups = []
    for i, dev in enumerate(wq.devices):
        h_i, cos_i, sin_i = h.to(dev), cos.to(dev), sin.to(dev)
        q = _apply_rope(_mm(h_i, wq.parts[i]).view(B, T, H, d), cos_i, sin_i)
        if split_kv:
            k = _apply_rope(_mm(h_i, layer.wk.parts[i]).view(B, T, Hkv // n, d),
                            cos_i, sin_i)
            v = _mm(h_i, layer.wv.parts[i]).view(B, T, Hkv // n, d)
        else:
            k, v = (_group_kv(t, (first + i) * H, H,
                              cfg.n_heads // Hkv).to(dev) for t in kv_rep)
        groups.append((q, k, v))
    return groups, kv_rep


def _gather_heads(parts, home: torch.device, mesh: Mesh) -> torch.Tensor:
    """Head groups (B, T, h, d) concatenated on ``home`` in model-axis
    order, every process's where the model axis spans several."""
    local = torch.cat([t.to(home) for t in parts], dim=2)
    if not spans(mesh, MODEL_AXIS):
        return local
    return gather_across(local, 2, mesh)


def _qkv(layer: DecoderLayer, x: torch.Tensor, cos, sin,
         cfg: TransformerConfig):
    """One layer's q (B, T, H, d) and k, v (B, T, Hkv, d), RoPE applied, on
    x's device (under tensor parallelism, the head groups gathered there)."""
    B, T, _ = x.shape
    if isinstance(layer.wq, Sharded):
        groups, kv_rep = _qkv_groups(layer, x, cos, sin, cfg)
        mesh = layer.wq.mesh
        q = _gather_heads([g[0] for g in groups], x.device, mesh)
        if kv_rep is not None:
            return (q, *kv_rep)
        return (q, _gather_heads([g[1] for g in groups], x.device, mesh),
                _gather_heads([g[2] for g in groups], x.device, mesh))
    H, Hkv, d = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    h = rms_norm(x, layer.ln1, cfg.rms_eps)
    q = _mm(h, layer.wq).view(B, T, H, d)
    k = _mm(h, layer.wk).view(B, T, Hkv, d)
    v = _mm(h, layer.wv).view(B, T, Hkv, d)
    return _apply_rope(q, cos, sin), _apply_rope(k, cos, sin), v


def kv_parts(arr) -> list:
    """A cache array's tensors: a head-sharded cache's parts, or [arr]."""
    return arr.parts if isinstance(arr, Sharded) else [arr]


def _kv_devices(cache: Dict[str, object]) -> list:
    return [p.device for p in kv_parts(next(iter(cache.values())))]


def _each_device(devices, *ts) -> dict:
    """{device: ``ts`` on it} for each distinct device of ``devices``: the
    small index and mask tensors every cache part reads, copied once."""
    return {d: tuple(t.to(d) for t in ts) for d in dict.fromkeys(devices)}


def _cache_groups(layer: DecoderLayer, x: torch.Tensor, cos, sin,
                  cfg: TransformerConfig, ck, cv) -> list:
    """(q, k, v, cache k, cache v) of one layer per head group: one per part
    of a head-sharded cache, on the part's device (``_qkv_groups``), else
    one of every head on x's device (``_qkv``: under tensor parallelism the
    head groups gathered there, where a replicated cache lives). A whole
    cache beside K/V weights split over a model axis is refused: its cache
    is head-sharded (``init_cache(params=)``)."""
    if isinstance(ck, Sharded):
        return [(q, k, v, pk, pv) for (q, k, v), pk, pv in
                zip(_qkv_groups(layer, x, cos, sin, cfg)[0], ck.parts,
                    cv.parts)]
    if isinstance(layer.wk, Sharded):
        raise ValueError("the K/V weights are split over a model axis, so "
                         "the KV cache is head-sharded beside them: make it "
                         "with init_cache(..., params=) or "
                         "init_kv_pages(..., params=)")
    return [(*_qkv(layer, x, cos, sin, cfg), ck, cv)]


def _heads_out(outs: list, ck):
    """Attention outputs for ``_layer_out``: the head groups on their
    devices for a head-sharded cache, else the one output of every head."""
    return outs if isinstance(ck, Sharded) else outs[0]


def _layer_out(layer: DecoderLayer, x: torch.Tensor, attn,
               cfg: TransformerConfig, act) -> torch.Tensor:
    """The attention output projection and the gated MLP, both residual.
    Under tensor parallelism ``attn`` is the head groups on their devices
    (or all heads on x's device, split here), wo and w_down are
    row-parallel and their partials add on x's device (``_model_sum``)."""
    B, T, _ = x.shape
    wo = layer.wo
    if not isinstance(wo, Sharded):
        x = x + _mm(attn.reshape(B, T, cfg.n_heads * cfg.head_dim), wo)
        h2 = rms_norm(x, layer.ln2, cfg.rms_eps)
        return x + _mm(act(_mm(h2, layer.w_gate)) * _mm(h2, layer.w_up),
                       layer.w_down)
    home, devs = x.device, wo.devices
    if not isinstance(attn, list):
        hs = cfg.n_heads // wo.mesh.shape[MODEL_AXIS]
        first = _model_offset(wo.mesh)
        attn = [attn[:, :, (first + i) * hs:(first + i + 1) * hs].to(dev)
                for i, dev in enumerate(devs)]
    x = x + _model_sum([_mm(a.reshape(B, T, -1), w)
                        for a, w in zip(attn, wo.parts)], home, wo.mesh, x.dtype)
    h2 = _model_input(rms_norm(x, layer.ln2, cfg.rms_eps), wo.mesh)
    partials = []
    for i, dev in enumerate(layer.w_gate.devices):
        h_i = h2.to(dev)
        partials.append(_mm(act(_mm(h_i, layer.w_gate.parts[i]))
                            * _mm(h_i, layer.w_up.parts[i]),
                            layer.w_down.parts[i]))
    return x + _model_sum(partials, home, layer.w_down.mesh, x.dtype)


def _logits_head(x: torch.Tensor, params: Transformer,
                 cfg: TransformerConfig) -> torch.Tensor:
    """f32 logits of features ``x`` (..., D): the head product in the model
    dtype, then f32 (bf16 logits round first). An int8 head goes to
    ``w8_matmul``'s (V, D) layout, its (V, 1) per-row scale applied to the
    f32 logits."""
    head = params.embed if cfg.tie_embeddings else params.lm_head
    if isinstance(head, Q8):
        y = w8_matmul(x.reshape(-1, x.shape[-1]), head.q,
                      head.scale.reshape(-1), "nk")
        return y.reshape(*x.shape[:-1], y.shape[-1])
    return (x @ head.T).float()


def _in_collective_order(fn):
    """``fn`` inside ``collective_order``: the collectives of one forward
    (or of a caller's chain, where one is open) in one chain, so their
    backwards run in one order on every process."""
    @wraps(fn)
    def chained(*args, **kwargs):
        with collective_order():
            return fn(*args, **kwargs)
    return chained


@_in_collective_order
def forward(params: Transformer, tokens: torch.Tensor, cfg: TransformerConfig,
            *, positions: Optional[torch.Tensor] = None,
            kv_cache: Optional[Dict[str, torch.Tensor]] = None,
            cache_len: int = 0,
            valid_from: Optional[torch.Tensor] = None,
            seq_mesh: Optional[Mesh] = None,
            sp_impl: str = "ring",
            use_flash: Optional[bool] = None,
            logits_last_only: bool = False,
            remat: bool = False
            ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """f32 logits (B, T, V) for tokens (B, T), or (B, 1, V) with
    ``logits_last_only``.

    Full-sequence mode (``kv_cache`` None): causal attention dispatched by
    length (``causal_attention``), per head group on its device when the
    params are sharded (``shard_params``). Sequence-parallel mode
    (``seq_mesh``): exact attention with T split over the mesh's "seq" axis,
    ``sp_impl`` "ring" (``ring_attention``) or "ulysses"; on a mesh with a
    "data" axis the batch is split over it too (across processes where
    that axis spans them; ``tokens`` is the global batch on every process).
    KV-cache mode: this call's k/v are written into ``kv_cache`` at
    ``cache_len`` IN PLACE (the returned cache is the same dict) and
    queries attend every cache slot at or below their own; ``valid_from``
    (B,) masks each row's left-pad slots, keeping each query's own slot
    visible so a pad query never softmaxes an empty row. A head-sharded
    cache (``init_cache(params=)`` under tensor parallelism) is written and
    attended part by part, each head group on its device (it must be, where
    the K/V weights are split); a whole cache takes every head's q/k/v on
    the first device. ``remat``: with autograd
    on, each layer's activations are recomputed in backward
    (``torch.utils.checkpoint``) instead of kept."""
    B, T = tokens.shape
    sharded = isinstance(params.layers[0].wq, Sharded)
    if seq_mesh is not None and (kv_cache is not None or sharded):
        raise ValueError("seq_mesh takes full-sequence mode on unsharded "
                         "params (no kv_cache, no tensor parallelism)")
    dev = tokens.device
    if positions is None:
        positions = torch.arange(T, device=dev).expand(B, T)
    x = _embed(params, tokens, cfg)
    act = _activation(cfg)
    rep = cfg.n_heads // cfg.kv_heads
    # Every layer shares the RoPE tables and the cache mask: built once.
    cos, sin = _rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.dtype)
    if kv_cache is not None:
        s_idx = torch.arange(kv_parts(kv_cache["l0.k"])[0].shape[1],
                             device=dev)
        t_idx = cache_len + torch.arange(T, device=dev)
        valid = s_idx[None, :] <= t_idx[:, None]                 # (T, S)
        if valid_from is not None:
            own = s_idx[None, :] == t_idx[:, None]
            valid = ((valid[None]
                      & (s_idx[None, None, :] >= valid_from[:, None, None]))
                     | own[None])                                # (B, T, S)
        masks = _each_device(_kv_devices(kv_cache), valid)

    def layer_fn(l: int, layer: DecoderLayer, x: torch.Tensor):
        if kv_cache is None and sharded:
            attn = [causal_attention(q, k, v, use_flash)
                    for q, k, v in _qkv_groups(layer, x, cos, sin, cfg)[0]]
            return _layer_out(layer, x, attn, cfg, act)
        if kv_cache is not None:
            ck, cv = kv_cache[f"l{l}.k"], kv_cache[f"l{l}.v"]
            outs = []
            for q, k, v, pk, pv in _cache_groups(layer, x, cos, sin, cfg, ck,
                                                 cv):
                pk[:, cache_len:cache_len + T] = k
                pv[:, cache_len:cache_len + T] = v
                outs.append(_attend(q, _expand_kv_heads(pk, rep),
                                    _expand_kv_heads(pv, rep),
                                    masks[pk.device][0]))
            return _layer_out(layer, x, _heads_out(outs, ck), cfg, act)
        q, k, v = _qkv(layer, x, cos, sin, cfg)
        if seq_mesh is not None:
            b_axis = DATA_AXIS if DATA_AXIS in seq_mesh.axis_names else None
            sp = ulysses_attention if sp_impl == "ulysses" else ring_attention
            attn = sp(q, k, v, seq_mesh, batch_axis=b_axis)
        else:
            attn = causal_attention(q, k, v, use_flash)
        return _layer_out(layer, x, attn, cfg, act)

    ckpt = remat and kv_cache is None and torch.is_grad_enabled()
    for l, layer in enumerate(params.layers):
        x = (checkpoint(layer_fn, l, layer, x, use_reentrant=False) if ckpt
             else layer_fn(l, layer, x))

    x = rms_norm(x, params.ln_f, cfg.rms_eps)
    if logits_last_only:
        x = x[:, -1:]
    return _logits_head(x, params, cfg), kv_cache


def _kv_arrays(cfg: TransformerConfig, lead: Tuple[int, int], device,
               params: Optional[Transformer]) -> Dict[str, object]:
    """Zeroed (*lead, Hkv, d) k and v per layer: head-sharded where
    ``params``' K/V weights are split over a model axis, else one tensor on
    ``device``."""
    wk = None if params is None else params.layers[0].wk
    d = cfg.head_dim

    def one():
        if isinstance(wk, Sharded):
            h = cfg.kv_heads // wk.mesh.shape[MODEL_AXIS]
            return Sharded([torch.zeros((*lead, h, d), dtype=cfg.dtype,
                                        device=dev) for dev in wk.devices],
                           2, wk.mesh)
        return torch.zeros((*lead, cfg.kv_heads, d), dtype=cfg.dtype,
                           device=device)

    return {f"l{l}.{t}": one() for l in range(cfg.n_layers)
            for t in ("k", "v")}


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, device,
               params: Optional[Transformer] = None) -> Dict[str, object]:
    """Zeroed (batch, max_len, Hkv, d) k and v per layer; ``forward``
    writes it in place. Where ``params``' K/V weights are split over a
    model axis (``shard_params``: the K/V heads divide it), each layer's k
    and v are head-sharded as the reference keeps them beside wk/wv: a
    ``Sharded`` of one (batch, max_len, Hkv/n, d) part per model-axis
    device of this process, on that device. Else (MQA and any Hkv the axis
    does not divide, or unsharded params) one tensor on ``device``. Without
    ``params`` the cache is whole, which the programs refuse beside split
    K/V weights."""
    return _kv_arrays(cfg, (batch, max_len), device, params)


def kv_bytes_by_device(cache: Dict[str, object]) -> Dict[str, int]:
    """The bytes of a cache or page pool on each device, every part
    counted."""
    out: Dict[str, int] = {}
    for arr in cache.values():
        for p in kv_parts(arr):
            out[str(p.device)] = (out.get(str(p.device), 0)
                                  + p.numel() * p.element_size())
    return out


# ---------------------------------------------------------------------------
# slot decode (continuous batching: explain/slotserve/)
#
# One PERSISTENT (slots, S, Hkv, d) KV pool where each row owns a slot: a
# prompt prefills into a free slot at any iteration boundary, and one decode
# window advances every busy slot — per-slot lengths, per-slot retirement,
# no barrier. The pools are allocated once and updated in place (JAX's
# donated functional updates). Host inputs go up in one pinned,
# non-blocking copy and a window's results come back in ONE host read.
# ---------------------------------------------------------------------------


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev`` without waiting for the device: a plain copy
    from pageable memory synchronizes the stream on the card, a pinned
    non-blocking one does not."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


@torch.inference_mode()
def slot_prefill(params: Transformer, tokens: np.ndarray, length: int,
                 cfg: TransformerConfig, kv_cache: Dict[str, torch.Tensor],
                 slot: int, temperature: float, seed: int) -> int:
    """Prefill ONE prompt into row ``slot`` of a pooled slot cache, in place.

    ``tokens``: (1, Tp) RIGHT-padded (Tp is the prompt bucket). Padding-region
    k/v land in cache rows [length, Tp): every later read masks to [0, len]
    and decode overwrites them in order, so they are never attended.
    Attention over the prompt is ``causal_attention(use_flash=False)``, the
    reference's choice, per head group on its device where the cache is
    head-sharded. Returns the first token, sampled from the logits at
    ``length - 1`` with ``PRNGKey(seed)`` as the step key."""
    dev = params.device
    toks = _to_device(np.asarray(tokens, np.int64), dev)
    B, T = toks.shape
    positions = torch.arange(T, device=dev).expand(B, T)
    cos, sin = _rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.dtype)
    x = _embed(params, toks, cfg)
    act = _activation(cfg)
    for l, layer in enumerate(params.layers):
        ck, cv = kv_cache[f"l{l}.k"], kv_cache[f"l{l}.v"]
        outs = []
        for q, k, v, pk, pv in _cache_groups(layer, x, cos, sin, cfg, ck, cv):
            pk[slot, :T] = k[0]
            pv[slot, :T] = v[0]
            # padded queries attend real+pad keys at or below their
            # position — garbage-but-finite, and only position length-1 is
            # read
            outs.append(causal_attention(q, k, v, use_flash=False))
        x = _layer_out(layer, x, _heads_out(outs, ck), cfg, act)
    x_last = rms_norm(x, params.ln_f, cfg.rms_eps)[0, length - 1:length]
    logits = _logits_head(x_last, params, cfg)                   # (1, V)
    return int(_sample_with_key(temperature, logits,
                                threefry.prng_key(seed, dev))[0])


def _slot_step_math(params: Transformer, cfg: TransformerConfig,
                    kv_cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                    lens: torch.Tensor, temperature: torch.Tensor,
                    step_key: Optional[torch.Tensor]) -> torch.Tensor:
    """One step of the slot pool: feed (B,) tokens, write their k/v at each
    row's own ``lens[b]``, attend each row over [0, lens[b]], and choose
    (B,) next tokens at each row's temperature (``_sample_rows``)."""
    B = tokens.shape[0]
    dev = tokens.device
    rows = torch.arange(B, device=dev)
    cos, sin = _rope_tables(lens[:, None], cfg.head_dim, cfg.rope_theta,
                            cfg.dtype)
    S = kv_parts(kv_cache["l0.k"])[0].shape[1]
    valid = torch.arange(S, device=dev)[None, None, :] <= lens[:, None, None]
    at = _each_device(_kv_devices(kv_cache), rows, lens, valid)
    rep = cfg.n_heads // cfg.kv_heads
    act = _activation(cfg)
    x = _embed(params, tokens[:, None], cfg)
    for l, layer in enumerate(params.layers):
        ck, cv = kv_cache[f"l{l}.k"], kv_cache[f"l{l}.v"]
        outs = []
        for q, k, v, pk, pv in _cache_groups(layer, x, cos, sin, cfg, ck, cv):
            r, n, m = at[pk.device]
            pk[r, n] = k[:, 0]
            pv[r, n] = v[:, 0]
            outs.append(_attend(q, _expand_kv_heads(pk, rep),
                                _expand_kv_heads(pv, rep), m))
        x = _layer_out(layer, x, _heads_out(outs, ck), cfg, act)
    x = rms_norm(x, params.ln_f, cfg.rms_eps)[:, 0]
    return _sample_rows(temperature, _logits_head(x, params, cfg), step_key)


def _slot_window_loop(params: Transformer, cfg: TransformerConfig,
                      kv_cache: Dict[str, torch.Tensor], tokens, lens, active,
                      remaining, temperature, seed: int, steps: int):
    """The window loop over a (B, S, Hkv, d) cache layout, shared by the
    contiguous pool and the paged pool's gathered view. Host arrays in;
    device tensors ``(out (B, steps), new_lens, steps_run, active_row_steps)``
    out, with no host read inside.

    The freeze rule: a row that emits EOS or exhausts its budget emits EOS
    and writes nothing further. The reference's loop stops once every row
    froze; this one runs a number of steps the host knows bounds that point
    (the largest budget of an active row, at least 1), and counts on the
    device the steps in which a row was active. Steps past the last freeze
    only rewrite each row's position ``lens[b]``, which the next window or
    prefill overwrites before anything reads it."""
    dev = params.device
    B = len(tokens)
    ints = _to_device(np.concatenate([np.asarray(a, np.int64).ravel() for a in
                                      (tokens, lens, active, remaining)]), dev)
    last, lens_c, act, rem = ints.view(4, B).unbind(0)
    act = act.bool()
    temps = np.asarray(temperature, np.float32)
    sampled = bool((temps > 1e-6).any())
    temp_t = _to_device(temps, dev) if sampled else None
    step_keys = (threefry.fold_in(threefry.prng_key(seed, dev),
                                  torch.arange(steps, device=dev))
                 if sampled else None)
    active_np = np.asarray(active, bool)
    budget = np.asarray(remaining, np.int64)[active_np]
    run = min(steps, max(1, int(budget.max()))) if active_np.any() else 0
    out = torch.full((B, steps), cfg.EOS, dtype=torch.int64, device=dev)
    steps_run = torch.zeros((), dtype=torch.int64, device=dev)
    row_steps = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(run):
        tok = _slot_step_math(params, cfg, kv_cache, last, lens_c, temp_t,
                              step_keys[i] if sampled else None)
        a = act.long()
        lens_c = lens_c + a
        row_steps = row_steps + a.sum()
        steps_run = steps_run + act.any().long()
        tok = torch.where(act, tok, cfg.EOS)
        out[:, i] = tok
        rem = rem - a
        act = act & (tok != cfg.EOS) & (rem > 0)
        last = tok
    return out, lens_c, steps_run, row_steps


def _window_result(out, new_lens, steps_run, row_steps):
    """The window's one host read: ``(out (B, steps) int32, new_lens int32,
    steps_run, active_row_steps)``."""
    B, steps = out.shape
    flat = torch.cat([out.reshape(-1), new_lens, steps_run[None],
                      row_steps[None]]).cpu().numpy()
    return (flat[:B * steps].reshape(B, steps).astype(np.int32),
            flat[B * steps:B * steps + B].astype(np.int32),
            int(flat[-2]), int(flat[-1]))


@torch.inference_mode()
def slot_decode_window(params: Transformer, tokens: np.ndarray,
                       lens: np.ndarray, active: np.ndarray,
                       remaining: np.ndarray, cfg: TransformerConfig,
                       kv_cache: Dict[str, torch.Tensor],
                       temperature: np.ndarray, seed: int, steps: int):
    """Up to ``steps`` decode iterations for the WHOLE slot pool, the cache
    updated in place.

    ``tokens``: (B,) last sampled token per slot; ``lens``: (B,) valid cache
    length per slot; ``active``: (B,) bool (inactive slots compute garbage
    into index ``lens[b]``, which the next prefill overwrites, and emit
    EOS); ``remaining``: (B,) per-slot token budget; ``temperature`` (B,).
    Step ``i`` draws row ``r`` from ``fold_in(fold_in(PRNGKey(seed), i), r)``.

    Returns host ``(out (B, steps) EOS-padded, new_lens, steps_run,
    active_row_steps)`` after one host read."""
    return _window_result(*_slot_window_loop(
        params, cfg, kv_cache, tokens, lens, active, remaining, temperature,
        seed, steps))


# ---------------------------------------------------------------------------
# paged slot decode (PagedAttention-style KV pool: explain/slotserve/)
#
# A flat pool of fixed-size KV pages per layer/tensor, (num_pages, page, Hkv,
# d), plus a per-slot PAGE TABLE of page ids kept on the host. The programs
# gather pages into the contiguous layout and scatter the positions they
# wrote back; nothing here allocates (the allocator lives in
# explain/slotserve/decode.py).
# ---------------------------------------------------------------------------


def init_kv_pages(cfg: TransformerConfig, num_pages: int, page_size: int,
                  device, params: Optional[Transformer] = None
                  ) -> Dict[str, object]:
    """The paged twin of ``init_cache``: a zeroed flat page pool per
    layer/tensor, head-sharded as ``init_cache`` is (one (num_pages,
    page_size, Hkv/n, d) part per model-axis device). A slot's logical
    position p lives at ``(table[p // page_size], p % page_size)`` of every
    part."""
    return _kv_arrays(cfg, (num_pages, page_size), device, params)


def _page_size(kv_pages: Dict[str, object]) -> int:
    return kv_parts(next(iter(kv_pages.values())))[0].shape[1]


@torch.inference_mode()
def copy_kv_page(kv_pages: Dict[str, object], src: int,
                 dst: int) -> Dict[str, object]:
    """Copy-on-write: page ``src`` -> page ``dst`` across every layer,
    tensor and part, in place (the returned pool is the same dict)."""
    for arr in kv_pages.values():
        for p in kv_parts(arr):
            p[dst].copy_(p[src])
    return kv_pages


def _gather_view(kv_pages: Dict[str, object], tables: torch.Tensor,
                 view_len: Optional[int] = None) -> Dict[str, object]:
    """The contiguous layout of ``tables`` (B, n): (B, view_len, Hkv, d) per
    layer/tensor (each part's (B, view_len, Hkv/n, d) on its device for a
    head-sharded pool), ``view_len`` at most (and by default) n * page.
    Unallocated table entries hold filler id 0: their content is stale pool
    data, which every read masks and no scatter-back targets."""
    page = _page_size(kv_pages)
    if view_len is None:
        view_len = tables.shape[1] * page
    pos = torch.arange(view_len, device=tables.device)
    at = _each_device(_kv_devices(kv_pages), tables[:, pos // page],
                      pos % page)                           # (B, view_len)
    out = {}
    for name, arr in kv_pages.items():
        views = [p[at[p.device]] for p in kv_parts(arr)]
        out[name] = (Sharded(views, arr.dim, arr.mesh)
                     if isinstance(arr, Sharded) else views[0])
    return out


@torch.inference_mode()
def paged_slot_prefill(params: Transformer, tokens: np.ndarray, length: int,
                       cfg: TransformerConfig,
                       kv_pages: Dict[str, torch.Tensor],
                       table_row: np.ndarray, temperature: float, seed: int,
                       prefix_len: int) -> int:
    """Prefill ONE prompt suffix into the pages of ``table_row``, in place.

    ``tokens``: (1, Ts) RIGHT-padded suffix; the first ``prefix_len``
    positions of the row are already resident (the shared preamble's
    read-only pages), so only the suffix is computed (``prefix_len`` 0 is
    the plain path). ``length`` is the FULL prompt length, as in
    ``slot_prefill``. ``table_row``: (n,) page ids covering ``prefix_len +
    Ts`` positions. The suffix k/v scatter into the row's own pages; the
    prefix region is only gathered. Row j attends every resident position
    at or below ``prefix_len + j``. Returns the first sampled token."""
    dev = params.device
    toks = _to_device(np.asarray(tokens, np.int64), dev)
    table = _to_device(np.asarray(table_row, np.int64), dev)
    B, Ts = toks.shape
    page = _page_size(kv_pages)
    pos = prefix_len + torch.arange(Ts, device=dev)
    kv_mask = (torch.arange(table.shape[0] * page, device=dev)[None, :]
               <= pos[:, None])                                  # (Ts, Tkv)
    at = _each_device(_kv_devices(kv_pages), table, table[pos // page],
                      pos % page, kv_mask)
    cos, sin = _rope_tables(pos.expand(B, Ts), cfg.head_dim, cfg.rope_theta,
                            cfg.dtype)
    rep = cfg.n_heads // cfg.kv_heads
    act = _activation(cfg)
    x = _embed(params, toks, cfg)
    for l, layer in enumerate(params.layers):
        ck, cv = kv_pages[f"l{l}.k"], kv_pages[f"l{l}.v"]
        outs = []
        for q, k, v, pk, pv in _cache_groups(layer, x, cos, sin, cfg, ck, cv):
            tbl, pids, offs, mask = at[pk.device]
            pk[pids, offs] = k[0]
            pv[pids, offs] = v[0]
            view = _gather_view({"k": pk, "v": pv}, tbl[None])
            outs.append(_attend(q, _expand_kv_heads(view["k"], rep),
                                _expand_kv_heads(view["v"], rep), mask))
        x = _layer_out(layer, x, _heads_out(outs, ck), cfg, act)
    last = length - 1 - prefix_len
    x_last = rms_norm(x, params.ln_f, cfg.rms_eps)[0, last:last + 1]
    logits = _logits_head(x_last, params, cfg)
    return int(_sample_with_key(temperature, logits,
                                threefry.prng_key(seed, dev))[0])


@torch.inference_mode()
def paged_decode_window(params: Transformer, tokens: np.ndarray,
                        lens: np.ndarray, active: np.ndarray,
                        remaining: np.ndarray, cfg: TransformerConfig,
                        kv_pages: Dict[str, torch.Tensor], tables: np.ndarray,
                        temperature: np.ndarray, seed: int, steps: int,
                        view_len: int):
    """``slot_decode_window`` over the paged pool: gather every slot's pages
    into the contiguous (B, view_len, Hkv, d) layout (``view_len`` is the
    contiguous pool's max_len, so the window runs at exactly its attention
    width), run the same window loop, then scatter each row's newly
    written positions [lens[b], new_lens[b]) back to its pages.

    ``tables``: (B, n) page ids; the allocator guarantees every active
    row's table covers [0, lens + steps). The scatter-back is built on the
    host after the window's one read, from exactly the written positions:
    frozen or inactive rows' in-window garbage and unallocated table
    entries are never written (JAX drops out-of-range scatter indices;
    torch would raise or fault on them)."""
    page = _page_size(kv_pages)
    tables = np.asarray(tables, np.int64)
    if not 0 < view_len <= tables.shape[1] * page:
        raise ValueError(f"view_len {view_len} outside (0, "
                         f"{tables.shape[1] * page}]")
    dev = params.device
    view = _gather_view(kv_pages, _to_device(tables, dev), view_len)
    result = _window_result(*_slot_window_loop(
        params, cfg, view, tokens, lens, active, remaining, temperature,
        seed, steps))
    new_lens = result[1].astype(np.int64)
    lens = np.asarray(lens, np.int64)
    rows = np.repeat(np.arange(len(lens)), np.maximum(new_lens - lens, 0))
    if rows.size:
        pos = np.concatenate([np.arange(a, b) for a, b in zip(lens, new_lens)
                              if b > a])
        at = _each_device(_kv_devices(kv_pages), _to_device(
            np.stack([rows, pos, tables[rows, pos // page], pos % page]), dev))
        for name, arr in kv_pages.items():
            for p, w in zip(kv_parts(arr), kv_parts(view[name])):
                idx = at[p.device][0]
                p[idx[2], idx[3]] = w[idx[0], idx[1]]
    return result


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def _sample_with_key(temperature: float, logits: torch.Tensor,
                     step_key: torch.Tensor) -> torch.Tensor:
    """Greedy at or below the temperature epsilon (argmax returns the first
    maximum, as ``jnp.argmax``), else the reference's draw: row ``r`` is
    ``categorical(fold_in(step_key, r), logits_r / T)``, the Gumbel-max of
    JAX's threefry noise in the logits' dtype, so a row's token depends only
    on (key, row). (B, V) -> (B,) int64."""
    if temperature <= 1e-6:
        return logits.argmax(dim=-1)
    dev = logits.device
    row_keys = threefry.fold_in(step_key, torch.arange(logits.shape[0],
                                                       device=dev))
    # a 0-dim tensor on the logits' device, so the division rounds as JAX's
    # does (a Python scalar divisor may become a multiply by its reciprocal)
    t = torch.full((), max(temperature, 1e-6), dtype=logits.dtype, device=dev)
    noise = threefry.gumbel(row_keys, (logits.shape[1],), logits.dtype)
    return (noise + logits / t).argmax(dim=-1)


def _sample_token(temperature: float, logits: torch.Tensor, seed: int,
                  step: int) -> torch.Tensor:
    """``_sample_with_key`` at the decode step's key,
    ``fold_in(PRNGKey(seed), step)``."""
    key = threefry.fold_in(threefry.prng_key(seed, logits.device), step)
    return _sample_with_key(temperature, logits, key)


def _sample_rows(temperature: torch.Tensor, logits: torch.Tensor,
                 step_key: Optional[torch.Tensor]) -> torch.Tensor:
    """``_sample_with_key`` at a temperature per row (B,): rows at or below
    the epsilon take the argmax, the others draw from ``fold_in(step_key,
    row)`` at their own temperature. ``step_key`` None draws no noise: the
    caller knows every row is greedy."""
    greedy = logits.argmax(dim=-1)
    if step_key is None:
        return greedy
    row_keys = threefry.fold_in(step_key, torch.arange(logits.shape[0],
                                                       device=logits.device))
    scaled = logits / torch.clamp_min(temperature, 1e-6)[:, None]
    noise = threefry.gumbel(row_keys, (logits.shape[1],), logits.dtype)
    return torch.where(temperature <= 1e-6, greedy,
                       (noise + scaled).argmax(dim=-1))


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
    cache = init_cache(cfg, B, Tp + max_new, dev, params)
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
                    device="cuda", std: Optional[float] = None,
                    mesh: Optional[Mesh] = None) -> "LanguageModel":
        """Random weights drawn on ``device`` (the mesh's first device when
        ``mesh`` is given) from ``seed`` (see ``init_params``), placed on
        ``mesh``'s model axis by ``shard_params`` when given."""
        cfg = cfg or TransformerConfig()
        dev = mesh.home if mesh is not None else resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(cfg, gen, std=std)
        if mesh is not None:
            params = shard_params(params, cfg, mesh)
        return cls(cfg, params)

    def quantized(self, *, include_embed: bool = True) -> "LanguageModel":
        """Weight-only int8 copy (see ``quantize_params``): the same API and
        KV cache, about half the weight bytes per decode step."""
        return LanguageModel(self.cfg, quantize_params(
            self.params, include_embed=include_embed), tokenizer=self.tokenizer)

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
