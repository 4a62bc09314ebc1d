"""The port's causal attention against the JAX package's, on the CPU.

``flash_attention`` on a CPU tensor runs its plain torch version, held here
against the JAX Pallas kernel in interpret mode at
``tests/test_flash_attention.py``'s shapes and tolerances (2e-5 in f32, 3e-2
in bf16: the two normalize p at different maxima, so bf16 rounds apart), and
at the Gemma head shape within 1e-2 absolute.
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


@pytest.mark.parametrize("shape,hkv,seed,atol,rtol", [
    ((1, 256, 2, 64), None, 9, 3e-2, 3e-2),
    # The Gemma head shape (MQA, d = 256). At T = 640 a typical |out| is
    # ~0.06, so 3e-2 would pass half an output; the two differ by one bf16
    # step (0.0039) here, and chip_smoke holds the kernel at 1e-2 absolute.
    ((1, 640, 8, 256), 1, 17, 1e-2, 0.0),
])
def test_flash_matches_jax_kernel_bf16(shape, hkv, seed, atol, rtol):
    q, k, v = _qkv(shape, hkv=hkv, seed=seed)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jflash(jq, jk, jv, interpret=auto_interpret()),
                      np.float32)
    got = attention.flash_attention(
        *(x.to(torch.bfloat16) for x in _t(q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 256, "sm90"),
    (torch.bfloat16, 32, "simt"),      # the default config's head dim
    (torch.bfloat16, 40, "simt"),
    (torch.bfloat16, 96, "simt"),
    (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"),
    (torch.float32, 256, "simt"),
])
def test_flash_route(dtype, d, route):
    assert attention.flash_route(dtype, d) == route


def _bf16(shape):
    return torch.from_numpy(
        np.random.default_rng(0).normal(size=shape).astype(np.float32)
    ).to(torch.bfloat16)


def _sm90_case(case):
    """Inputs (1, 16, 2, 64) over one K/V head, bf16, with one flaw."""
    q, k, v = _bf16((1, 16, 2, 64)), _bf16((1, 16, 1, 64)), _bf16((1, 16, 1, 64))
    if case == "d not contiguous":
        k = _bf16((1, 16, 1, 128))[..., ::2]
    elif case == "stride not 16-byte":
        v = _bf16((1, 16, 1, 65))[..., :64]
    elif case == "pointer not 16-byte":
        q = _bf16((16 * 2 * 64 + 1,))[1:].view(1, 16, 2, 64)
    elif case == "float32":
        q, k, v = q.float(), k.float(), v.float()
    elif case == "d 32":
        q, k, v = q[..., :32].contiguous(), k[..., :32].contiguous(), v[..., :32].contiguous()
    return q, k, v


@pytest.mark.parametrize("case,match", [
    ("float32", "bfloat16"),
    ("d 32", "bfloat16 at d in"),
])
def test_sm90_refuses_before_any_launch(case, match):
    """The sm90 route's own checks raise ValueError before it launches (or,
    on the CPU, before it runs the plain version), and count nothing."""
    before = (attention.flash_attention.launches,
              attention.flash_attention_sm90.launches)
    with pytest.raises(ValueError, match=match):
        attention.flash_attention_sm90(*_sm90_case(case))
    assert (attention.flash_attention.launches,
            attention.flash_attention_sm90.launches) == before


@pytest.mark.parametrize("case", ["d not contiguous", "stride not 16-byte",
                                  "pointer not 16-byte"])
def test_sm90_packs_what_its_tensor_maps_cannot_take(case):
    """Inputs the packed tensor maps cannot describe as they are (strided,
    or off the 16-byte grid) are copied into ones they can, with the same
    values; every route still runs them, the plain version on the CPU."""
    q, k, v = _sm90_case(case)
    packed = [attention._packed(x) for x in (q, k, v)]
    for x, p in zip((q, k, v), packed):
        assert p.is_contiguous() and p.data_ptr() % 16 == 0
        assert torch.equal(p, x)
    want = attention.flash_attention_reference(*packed)
    for route in (attention.flash_attention_sm90, attention.flash_attention_simt,
                  attention.flash_attention):
        assert torch.equal(route(q, k, v), want)


def test_sm90_takes_aligned_views_without_a_copy():
    """A contiguous view that starts on the 16-byte grid goes to the sm90
    kernel as it is; q, k and v as strided views into one fused (B, T, H + 2,
    d) projection are packed, and on the CPU every route runs the plain
    version on them."""
    flat = _bf16((8 + 2 * 40 * 2 * 64,))
    view = flat[8:].view(2, 40, 2, 64)
    assert view.data_ptr() % 16 == 0
    assert attention._packed(view).data_ptr() == view.data_ptr()
    fused = _bf16((2, 40, 4, 64))
    q, k, v = fused[:, :, :2], fused[:, :, 2:3], fused[:, :, 3:4]
    assert not q.is_contiguous()
    want = attention.flash_attention_reference(q.contiguous(), k.contiguous(),
                                               v.contiguous())
    before = attention.flash_attention.launches
    for route in (attention.flash_attention_sm90, attention.flash_attention_simt,
                  attention.flash_attention):
        assert torch.equal(route(q, k, v), want)
    assert attention.flash_attention.launches == before


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
