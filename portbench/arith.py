"""The benchmark's arithmetic: the card's published peaks, the operations of
a decoder's work counted from its shapes and lengths, and the spread of
repeated runs.

The peaks are a copy of ``chip_smoke.py``'s (bytes at the HBM rate against
operations at the dtype's rate).
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12


def layer_matrix_params(cfg: Dict) -> int:
    """Weights one decoder layer multiplies a token by: q, k, v, o and the
    gated MLP's three matrices."""
    d_model, heads, kv_heads = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    head_dim = cfg["head_dim"]
    ffn = cfg["intermediate_size"]
    return (d_model * (heads + 2 * kv_heads) * head_dim
            + heads * head_dim * d_model + 3 * d_model * ffn)


def token_product_flops(cfg: Dict, with_head: bool) -> int:
    """2 x the parameters one token's products use: every layer's matrices,
    and the output head where that token's logits are computed."""
    params = cfg["num_hidden_layers"] * layer_matrix_params(cfg)
    if with_head:
        params += cfg["vocab_size"] * cfg["hidden_size"]
    return 2 * params


def attention_flops(cfg: Dict, context: int) -> int:
    """q.k and p.v of one query over ``context`` keys, every layer and head:
    4 x layers x heads x head dim x context."""
    return (4 * cfg["num_hidden_layers"] * cfg["num_attention_heads"]
            * cfg["head_dim"] * context)


def prefill_flops(cfg: Dict, cached: int, length: int) -> int:
    """A prompt of ``length`` tokens whose first ``cached`` come from a
    shared prefix: the products of the rest, the head once (the last
    position's logits), and causal attention of each computed position j
    over its j + 1 keys."""
    n = length - cached
    if n <= 0:
        return 0
    # sum over j in [cached, length) of (j + 1)
    keys = (length * (length + 1) - cached * (cached + 1)) // 2
    return (n * token_product_flops(cfg, with_head=False)
            + 2 * cfg["vocab_size"] * cfg["hidden_size"]
            + attention_flops(cfg, keys))


def decode_flops(cfg: Dict, prompt_len: int, first: int, last: int) -> int:
    """Output tokens ``first`` to ``last - 1`` (0-based) of a request, each
    produced by one decode step: output i >= 1 feeds token i - 1 at position
    prompt_len + i - 1, attends prompt_len + i keys and computes the head.
    Output 0 comes from the prefill and is not counted here."""
    first = max(first, 1)
    n = last - first
    if n <= 0:
        return 0
    keys = n * prompt_len + (first + last - 1) * n // 2
    return n * token_product_flops(cfg, with_head=True) + attention_flops(cfg, keys)


def spread(values: Iterable[float]) -> float:
    """Inter-quartile distance over the median (``statistics.quantiles``
    with n=4, its default exclusive method)."""
    vals = list(values)
    q1, med, q3 = statistics.quantiles(vals, n=4)
    return (q3 - q1) / abs(med)


def interval_union(intervals: List[tuple]) -> float:
    """Total length covered by (start, end) intervals."""
    total = 0.0
    end: Optional[float] = None
    start0 = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start0
            start0, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start0
    return total
