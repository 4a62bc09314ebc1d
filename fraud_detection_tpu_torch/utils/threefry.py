"""JAX's default PRNG, threefry2x32, as torch tensor functions.

Reproduces ``jax.random`` of jax 0.9.0 with its defaults: the threefry2x32
implementation, ``jax_threefry_partitionable=True`` (keys split and bits
drawn from a 64-bit counter per element) and ``jax_enable_x64=False`` (a
seed keeps its low 32 bits). The port draws the forests' bootstrap weights
and feature masks, the decoder's sampling noise and the LLM trainer's
initial weights from these streams, so a seed gives the JAX package's
draws. The card has no jax to ask, so the
tests hold these functions against ``jax.random`` on the CPU: bit for bit,
except ``gumbel``, whose two float32 logs round as torch's do, not as
XLA's (within a float32 epsilon of max(1, |g|)).

Keys are ``(..., 2)`` int64 tensors holding uint32 values, the raw
``key_data`` of a legacy ``PRNGKey``. Every function is stateless tensor
arithmetic (uint32 words in int64, masked) and runs on the device of its
key; keys, bits, uniforms and bernoullis have the same bits on the CPU and
on the card.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
# float32: 23 mantissa bits, 1.0's bit pattern, the smallest normal
_F32_NMANT = 23
_F32_ONE_BITS = 0x3F800000
_F32_TINY = torch.finfo(torch.float32).tiny

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _scalar(value, dtype: torch.dtype, device) -> torch.Tensor:
    """A 0-dim tensor of ``value`` made on ``device`` by a fill: on the card
    ``torch.tensor(value, device=...)`` copies from the host and waits for
    the stream, which a decode step must not do."""
    return torch.full((), value, dtype=dtype, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The threefry2x32 block function (20 rounds) of ``key`` (..., 2) over
    the counter pairs (x0, x1), which broadcast against the key's leading
    dims. Returns the two output words."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``key_data(jax.random.PRNGKey(seed))``: (2,) int64. With x64 off,
    jax keeps the seed's low 32 bits: (0, seed mod 2**32)."""
    return torch.stack((_scalar(0, torch.int64, device),
                        _scalar(int(seed) & _MASK32, torch.int64, device)))


def _counters(key: torch.Tensor, shape: tuple):
    """The partitionable streams' counters: element i of ``shape`` (in
    row-major order) takes the 64-bit counter i, as (hi, lo) words, here
    always (0, i) (fewer than 2**32 elements). Broadcast after the key's
    leading dims."""
    n = math.prod(shape)
    if n >= 1 << 32:
        raise ValueError(f"{n} elements: at most 2**32 - 1 per draw")
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    lo = lo.reshape((1,) * len(lead) + shape)
    return torch.zeros_like(lo), lo


def _bits_range(key: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """``random_bits`` of one (2,) key over the flat elements [start,
    start + count) of a draw: the counters (0, i) of those elements."""
    lo = torch.arange(start, start + count, dtype=torch.int64,
                      device=key.device)
    b0, b1 = threefry2x32(key, torch.zeros_like(lo), lo)
    return b0 ^ b1


def _bits_pair(key: torch.Tensor, shape: tuple):
    k = key.reshape(key.shape[:-1] + (1,) * len(shape) + (2,))
    hi, lo = _counters(key, shape)
    return threefry2x32(k, hi, lo)


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (*lead, *num, 2) keys."""
    b0, b1 = _bits_pair(key, _shape(num))
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the threefry of ``key`` over the
    counter pair (0, data mod 2**32). ``data`` is an int or an integer
    tensor that broadcasts against the key's leading dims."""
    d = (_scalar(data, torch.int64, key.device) if isinstance(data, int)
         else torch.as_tensor(data, dtype=torch.int64, device=key.device))
    d = d & _MASK32
    b0, b1 = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` as uint32 values in int64:
    (*lead, *shape)."""
    b0, b1 = _bits_pair(key, _shape(shape))
    return b0 ^ b1


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 bits as the mantissa of a float in [1, 2), less 1, scaled, and held
    at or above ``minval``."""
    return _uniform_bits(random_bits(key, shape), minval, maxval, key.device)


def _uniform_bits(bits: torch.Tensor, minval: float, maxval: float,
                  device) -> torch.Tensor:
    fbits = (bits >> (32 - _F32_NMANT)) | _F32_ONE_BITS
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo = _scalar(minval, torch.float32, device)
    hi = _scalar(maxval, torch.float32, device)
    # XLA fuses the scale and shift into one fused multiply-add; in float64
    # the product of two floats is exact, so one rounding of the sum
    # stands in for the FMA's
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def bernoulli(key: torch.Tensor, p, shape: Shape) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` with a float32 ``p`` (mode
    "low"): ``uniform(key, shape) < p``."""
    p = torch.as_tensor(p, dtype=torch.float32, device=key.device)
    return uniform(key, shape) < p


def gumbel(key: torch.Tensor, shape: Shape,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, dtype)`` (mode "low"):
    ``-log(-log(uniform(key, shape, minval=tiny, maxval=1)))``. float32
    only, the one dtype the port samples in."""
    if dtype != torch.float32:
        raise ValueError(f"gumbel draws float32, not {dtype}")
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


# elements a ``normal`` draw computes at once (its int64 words take ~10x
# their count in bytes)
_NORMAL_CHUNK = 1 << 24


def normal(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` of one (2,) key: uniform
    on [nextafter(-1, 0), 1), then sqrt(2) * erfinv, in float32. Drawn in
    flat chunks of the element range, so a (256,000, 2,048) embedding never
    holds its counters whole."""
    shape = _shape(shape)
    n = math.prod(shape)
    if n >= 1 << 32:
        raise ValueError(f"{n} elements: at most 2**32 - 1 per draw")
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    sqrt2 = _scalar(math.sqrt(2.0), torch.float32, key.device)
    out = torch.empty(n, dtype=torch.float32, device=key.device)
    for start in range(0, n, _NORMAL_CHUNK):
        count = min(_NORMAL_CHUNK, n - start)
        u = _uniform_bits(_bits_range(key, start, count), lo, 1.0, key.device)
        out[start:start + count] = sqrt2 * torch.erfinv(u)
    return out.reshape(shape)
