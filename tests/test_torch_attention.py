"""The port's causal attention against the JAX package's, on the CPU.

``flash_attention`` on a CPU tensor runs its plain torch version, held here
against the JAX Pallas kernel in interpret mode at
``tests/test_flash_attention.py``'s shapes and tolerances (2e-5 in f32, 3e-2
in bf16: the two normalize p at different maxima, so bf16 rounds apart).
``causal_attention``'s three branches and ``chunked_causal_attention`` are
held against their JAX twins at 2e-5, and the flash branch's gradients
(backward through the chunked path) against ``jax.grad`` at the JAX tests'
2e-4 / 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fraud_detection_tpu.models import llm as jllm
from fraud_detection_tpu.ops.attention import auto_interpret
from fraud_detection_tpu.ops.attention import flash_attention as jflash
from fraud_detection_tpu_torch.models import llm
from fraud_detection_tpu_torch.ops import attention
import tests.torch_parity  # noqa: F401 — one intra-op torch thread per worker

F32_TOL = 2e-5


def _qkv(shape, hkv=None, seed=3, dtype=np.float32):
    B, T, H, d = shape
    rng = np.random.default_rng(seed)
    kv = (B, T, hkv or H, d)
    return (rng.normal(size=shape).astype(dtype),
            rng.normal(size=kv).astype(dtype),
            rng.normal(size=kv).astype(dtype))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape", [(2, 384, 3, 64), (1, 256, 2, 128),
                                   (1, 131, 1, 32)])
def test_flash_matches_jax_kernel(shape):
    q, k, v = _qkv(shape)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             interpret=auto_interpret()))
    got = attention.flash_attention(*_t(q, k, v))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


def test_flash_matches_jax_kernel_bf16():
    q, k, v = _qkv((1, 256, 2, 64), seed=9)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jflash(jq, jk, jv, interpret=auto_interpret()),
                      np.float32)
    got = attention.flash_attention(
        *(x.to(torch.bfloat16) for x in _t(q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("hkv", [1, 2])
def test_flash_gqa_native_equals_expanded(hkv):
    """Native-width K/V give bit for bit what expanded K/V give, and match
    the JAX kernel's native-width path."""
    q, k, v = _qkv((2, 192, 4, 32), hkv=hkv, seed=5)
    tq, tk, tv = _t(q, k, v)
    native = attention.flash_attention(tq, tk, tv)
    rep = 4 // hkv
    expanded = attention.flash_attention(tq, tk.repeat_interleave(rep, 2),
                                         tv.repeat_interleave(rep, 2))
    assert torch.equal(native, expanded)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             interpret=auto_interpret()))
    np.testing.assert_allclose(native.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


def test_flash_refuses_bad_shapes():
    q, k, v = _t(*_qkv((1, 16, 3, 8), hkv=2))
    with pytest.raises(ValueError, match="divide"):
        attention.flash_attention(q, k, v)
    q, k, v = _t(*_qkv((1, 16, 4, 8), hkv=2))
    with pytest.raises(ValueError, match="dtypes"):
        attention.flash_attention(q, k.double(), v)


@pytest.mark.parametrize("branch,t,use_flash", [
    ("materialized", 64, None),
    ("flash", 576, None),
    ("chunked", 576, False),
])
def test_causal_attention_branches_match_jax(branch, t, use_flash):
    """Each branch of the dispatch, with narrow (GQA) K/V, against the same
    branch of the JAX package."""
    q, k, v = _qkv((1, t, 4, 16), hkv=2, seed=11)
    jcausal = jax.jit(jllm.causal_attention, static_argnums=3)
    want = np.asarray(jcausal(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              use_flash))
    got = llm.causal_attention(*_t(q, k, v), use_flash=use_flash)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL,
                               err_msg=branch)


def test_chunked_causal_attention_matches_jax():
    q, k, v = _qkv((2, 131, 2, 16), seed=13)
    jchunked = jax.jit(jllm.chunked_causal_attention,
                       static_argnames=("q_chunk", "key_chunk"))
    want = np.asarray(jchunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               q_chunk=32, key_chunk=48))
    got = llm.chunked_causal_attention(*_t(q, k, v), q_chunk=32, key_chunk=48)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


def _port_grads(q, k, v, **kw):
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    llm.causal_attention(tq, tk, tv, **kw).sum().backward()
    return tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()


def test_flash_gradients_match_jax():
    """Auto-dispatched flash (T >= 512) differentiates through the chunked
    recompute, as in the JAX package: the gradients of sum(out ** 2) match
    ``jax.grad`` of the JAX causal_attention."""
    q, k, v = _qkv((1, 512, 2, 8), seed=3)
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    (llm.causal_attention(tq, tk, tv) ** 2).sum().backward()
    loss = lambda a, b, c: jnp.sum(jllm.causal_attention(a, b, c) ** 2)
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


def test_flash_gqa_narrow_gradients():
    """Narrow K/V gradients: equal to the expanded-K/V gradients summed over
    each head group, and to ``jax.grad`` of the JAX flash path."""
    H, hkv = 4, 2
    q, k, v = _qkv((1, 640, H, 16), hkv=hkv, seed=7)
    gq, gk, gv = _port_grads(q, k, v)
    assert gk.shape == k.shape and gv.shape == v.shape
    rep = H // hkv
    eq, ek, ev = _port_grads(q, np.repeat(k, rep, axis=2),
                             np.repeat(v, rep, axis=2))
    group = lambda g: g.reshape(g.shape[:2] + (hkv, rep) + g.shape[3:]).sum(3)
    for got, want in ((gq, eq), (gk, group(ek)), (gv, group(ev))):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    loss = lambda a, b, c: jllm.causal_attention(a, b, c).astype(jnp.float32).sum()
    jg = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    for got, want in zip((gq, gk, gv), jg):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
