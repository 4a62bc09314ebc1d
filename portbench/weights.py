"""Seeded decoder weights, made on the card by the benchmark and handed to
the program and to the reference alike.

Every group (the embedding, each layer, the head) is one ``torch.randn``
call on a generator of the group's own seed, so the reference can draw any
one group again after the window without holding a second copy of the
model. Matrices are N(0, 1/hidden_size), the port's and the JAX package's
initialisation; the RMSNorm gains (group ``norms``) are 1 + N(0, 0.1^2), so
that a path that skips a gain reads wrong. All are rounded once to the
served dtype.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
NORM_GAIN_SD = 0.1


def group_seed(seed: int, group: str) -> int:
    """A 63-bit generator seed for one group of one run's weights."""
    digest = hashlib.sha256(f"{seed}:{group}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def layer_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """One layer's matrices in the port's layout: wq (D, H, d), wk/wv
    (D, Hkv, d), wo (H, d, D), w_gate/w_up (D, F), w_down (F, D)."""
    D, H, Hkv = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    d, F = cfg["head_dim"], cfg["intermediate_size"]
    return {"wq": (D, H, d), "wk": (D, Hkv, d), "wv": (D, Hkv, d),
            "wo": (H, d, D), "w_gate": (D, F), "w_up": (D, F),
            "w_down": (F, D)}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def norm_names(cfg: Dict) -> List[str]:
    """The RMSNorm gains by the port's leaf names, in the order drawn."""
    return [f"l{i}.{n}" for i in range(cfg["num_hidden_layers"])
            for n in ("ln1", "ln2")] + ["ln_f"]


def draw_group(cfg: Dict, seed: int, group: str, device,
               dtype: torch.dtype = None) -> Dict[str, torch.Tensor]:
    """One group's weights, drawn in one call: ``embed`` and ``lm_head``
    (V, D), ``l<i>`` (the layer's seven matrices, keyed by leaf name), or
    ``norms`` (every gain (D,), keyed by full leaf name), as views of one
    buffer in ``dtype`` (the configuration's by default)."""
    dtype = dtype or DTYPES[cfg["dtype"]]
    if group in ("embed", "lm_head"):
        shapes = {group: (cfg["vocab_size"], cfg["hidden_size"])}
    elif group == "norms":
        shapes = {n: (cfg["hidden_size"],) for n in norm_names(cfg)}
    else:
        shapes = layer_shapes(cfg)
    total = sum(_numel(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, group))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    if group == "norms":
        flat.mul_(NORM_GAIN_SD).add_(1.0)
    else:
        flat.mul_(cfg["hidden_size"] ** -0.5)
    flat = flat.to(dtype)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = _numel(shape)
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def groups(cfg: Dict):
    """The groups of a model's weights, in the order they are drawn."""
    names = ["embed"] + [f"l{i}" for i in range(cfg["num_hidden_layers"])]
    if not cfg["tie_word_embeddings"]:
        names.append("lm_head")
    return names + ["norms"]


def leaf_name(group: str, name: str) -> str:
    """The port's parameter name of ``name`` as ``draw_group`` keys it."""
    return name if group in ("embed", "lm_head", "norms") else f"{group}.{name}"


def model_leaves(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight by the port's parameter names (``embed``, ``l3.wq``,
    ``ln_f`` ...), norm gains included."""
    return {leaf_name(g, name): t for g in groups(cfg)
            for name, t in draw_group(cfg, seed, g, device).items()}
