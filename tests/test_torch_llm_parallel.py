"""The port's tensor and sequence parallelism (``models/llm.py``) against the
JAX package's and against the port's own single-device paths, on the CPU.

The port's meshes name the CPU device several times (``Mesh(["cpu"] * 8,
("seq",))``), the JAX side runs on conftest's 8 virtual CPU devices.
Tolerances are the reference's own (``tests/test_llm.py``): ring and
Ulysses attention 2e-5 against dense; forward in ring or Ulysses mode and
the tensor-parallel forward 3e-4 against the plain forward; the int8
tensor-parallel forward 2e-5 against the single-device int8 forward. The
same bounds hold against JAX's sharded runs. Greedy and sampled tokens and
a slot window on a tensor-parallel model EQUAL the single-device model's.
The mesh loads (``load_hf_checkpoint(mesh=)``,
``OnPodBackend.from_hf_checkpoint(mesh=, int8=True)``) are held against
the JAX package in ``tests/test_torch_hf_convert.py`` and
``tests/test_torch_explain.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from fraud_detection_tpu.models import llm as jllm
from fraud_detection_tpu_torch.models import llm
from fraud_detection_tpu_torch.models.llm import Q8, Sharded
from fraud_detection_tpu_torch.parallel.mesh import Mesh
from tests.torch_parity import port_llm, port_llm_config

CFG = jllm.TransformerConfig(d_model=64, n_heads=8, n_layers=2, d_ff=128,
                             max_seq=256)
MQA = jllm.TransformerConfig(d_model=64, n_heads=8, n_layers=2, d_ff=128,
                             max_seq=256, n_kv_heads=1, head_dim_override=16)
CPU8 = np.array(["cpu"] * 8, dtype=object)
ATTN_TOL, MODE_TOL, INT8_TOL = 2e-5, 3e-4, 2e-5
_jinit = jax.jit(jllm.init_params, static_argnums=1)


def port_mesh(name, n=8):
    return Mesh(CPU8[:n], (name,))


def jax_mesh(name, n=8):
    return JMesh(np.array(jax.devices()[:n]), (name,))


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, cfg, seed in (("base", CFG, 0), ("mqa", MQA, 4)):
        jlm = jllm.LanguageModel(cfg, _jinit(jax.random.PRNGKey(seed), cfg))
        out[name] = (jlm, port_llm(jlm))
    return out


def _qkv(shape, hkv=None, seed=0):
    rng = np.random.default_rng(seed)
    B, T, H, d = shape
    q = rng.normal(size=shape).astype(np.float32)
    k, v = (rng.normal(size=(B, T, hkv or H, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _dense(q, k, v):
    t = q.shape[1]
    rep = q.shape[2] // k.shape[2]
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    return llm._attend(q, llm._expand_kv_heads(k, rep),
                       llm._expand_kv_heads(v, rep),
                       torch.ones((t, t), dtype=torch.bool).tril()).numpy()


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [32, 64])
def test_ring_attention_matches_dense_and_jax(T):
    q, k, v = _qkv((2, T, 4, 16))
    got = llm.ring_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             port_mesh("seq"))
    _close(got, _dense(q, k, v), ATTN_TOL)
    want = jllm.ring_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               jax_mesh("seq"))
    _close(got, want, ATTN_TOL)


def test_ring_attention_key_chunked_matches_dense():
    """key_chunk below T_loc = 16, with overhang chunks (5, 7) masked by the
    far sentinel; key_chunk 0 refused as in the reference."""
    q, k, v = _qkv((1, 128, 2, 16), seed=7)
    dense = _dense(q, k, v)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    for key_chunk in (4, 5, 7, 16):
        _close(llm.ring_attention(*t, port_mesh("seq"), key_chunk=key_chunk),
               dense, ATTN_TOL)
    with pytest.raises(ValueError, match="key_chunk must be >= 1"):
        llm.ring_attention(*t, port_mesh("seq"), key_chunk=0)
    with pytest.raises(ValueError, match="divisible"):
        llm.ring_attention(*(x[:, :100] for x in t), port_mesh("seq"))


@pytest.mark.parametrize("hkv", [1, 2])
def test_ring_attention_narrow_kv_matches_dense(hkv):
    """GQA/MQA K/V ride the ring at their narrow width, single-pass and
    key-chunked, and equal dense attention over the expanded K/V."""
    q, k, v = _qkv((2, 64, 4, 16), hkv=hkv, seed=9)
    dense = _dense(q, k, v)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    _close(llm.ring_attention(*t, port_mesh("seq")), dense, ATTN_TOL)
    _close(llm.ring_attention(*t, port_mesh("seq"), key_chunk=3), dense,
           ATTN_TOL)


@pytest.mark.parametrize("hkv", [8, 2])
def test_ulysses_attention_matches_dense_and_jax(hkv):
    q, k, v = _qkv((2, 64, 8, 16), hkv=hkv, seed=21)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = llm.ulysses_attention(*t, port_mesh("seq"))
    _close(got, _dense(q, k, v), ATTN_TOL)
    _close(got, jllm.ulysses_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                       jax_mesh("seq")), ATTN_TOL)
    j = [jnp.asarray(a[:, :, :6]) for a in (q, q, q)]
    with pytest.raises(ValueError, match="divisible") as port_err:
        llm.ulysses_attention(*(x[:, :, :6] for x in (t[0],) * 3),
                              port_mesh("seq"))
    with pytest.raises(ValueError, match="divisible") as jax_err:
        jllm.ulysses_attention(*j, jax_mesh("seq"))
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("sp_impl", ["ring", "ulysses"])
@pytest.mark.parametrize("name", ["base", "mqa"])
def test_forward_sp_matches_plain_and_jax(models, sp_impl, name):
    jlm, plm = models[name]
    toks = np.random.default_rng(2).integers(0, 256, (2, 64))
    plain, _ = llm.forward(plm.params, torch.from_numpy(toks), plm.cfg)
    got, _ = llm.forward(plm.params, torch.from_numpy(toks), plm.cfg,
                         seq_mesh=port_mesh("seq"), sp_impl=sp_impl)
    _close(got, plain, MODE_TOL)
    want, _ = jllm.forward(jlm.params, jnp.asarray(toks), jlm.cfg,
                           seq_mesh=jax_mesh("seq"), sp_impl=sp_impl)
    _close(got, want, MODE_TOL)


def test_forward_sp_on_a_data_seq_mesh(models):
    """On a (data, seq) mesh the batch splits over "data" and a ring runs
    per data row."""
    _, plm = models["base"]
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (4, 32)))
    mesh = Mesh(CPU8.reshape(2, 4), (llm.DATA_AXIS, llm.SEQ_AXIS))
    plain, _ = llm.forward(plm.params, toks, plm.cfg)
    got, _ = llm.forward(plm.params, toks, plm.cfg, seq_mesh=mesh)
    _close(got, plain, MODE_TOL)
    with pytest.raises(ValueError, match="seq_mesh"):
        llm.forward(llm.shard_params(plm.params, plm.cfg, port_mesh("model")),
                    toks, plm.cfg, seq_mesh=port_mesh("seq"))


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

def _shard_layout(params, name, n):
    """(device, shape) of each part of a Sharded leaf."""
    leaf = params.param(name)
    assert isinstance(leaf, Sharded) and len(leaf.parts) == n, name
    return [(str(llm._leaf_device(p)),
             tuple((p.q if isinstance(p, Q8) else p).shape))
            for p in leaf.parts]


def test_param_shardings_equal_jax():
    for cfg, n in ((CFG, 8), (MQA, 8), (CFG, 2)):
        want = jllm.param_shardings(cfg, jax_mesh("model", n))
        got = llm.param_shardings(port_llm_config(cfg), port_mesh("model", n))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].spec == tuple(want[k].spec), k


@pytest.mark.parametrize("name", ["base", "mqa"])
def test_tp_forward_matches_single_and_jax(models, name):
    """8-way model axis: each device holds its 1/8 of every split matrix;
    the forward equals the single-device one and JAX's sharded forward."""
    jlm, plm = models[name]
    cfg = plm.cfg
    mesh = port_mesh("model")
    sharded = llm.shard_params(plm.params, cfg, mesh)
    D, F, d = cfg.d_model, cfg.d_ff, cfg.head_dim
    assert _shard_layout(sharded, "l0.wq", 8) == [("cpu", (D, 1, d))] * 8
    assert _shard_layout(sharded, "l1.wo", 8) == [("cpu", (1, d, D))] * 8
    assert _shard_layout(sharded, "l0.w_gate", 8) == [("cpu", (D, F // 8))] * 8
    assert _shard_layout(sharded, "l1.w_down", 8) == [("cpu", (F // 8, D))] * 8
    if cfg.kv_heads == 1:   # MQA: K/V replicated on the first device
        assert not isinstance(sharded.param("l0.wk"), Sharded)
    else:
        assert _shard_layout(sharded, "l0.wk", 8) == [("cpu", (D, 1, d))] * 8
    for rep in ("embed", "ln_f", "l0.ln1"):
        assert not isinstance(sharded.param(rep), Sharded)
    parts = sharded.param("l0.wq").parts
    for i, p in enumerate(parts):   # slices, not views of the whole weight
        np.testing.assert_array_equal(
            p.numpy(), plm.params.param("l0.wq").detach().numpy()[:, i:i + 1])
        assert p.untyped_storage().data_ptr() != \
            plm.params.param("l0.wq").untyped_storage().data_ptr()
    toks = np.random.default_rng(3).integers(0, 256, (2, 16))
    want, _ = llm.forward(plm.params, torch.from_numpy(toks), cfg)
    got, _ = llm.forward(sharded, torch.from_numpy(toks), cfg)
    _close(got, want, MODE_TOL)
    jsh = jllm.shard_params(jlm.params, jlm.cfg, jax_mesh("model"))
    jgot = jax.jit(lambda p, t: jllm.forward(p, t, jlm.cfg)[0])(
        jsh, jnp.asarray(toks))
    _close(got, jgot, MODE_TOL)


def test_tp_long_forward_runs_flash_per_head_group(models, monkeypatch):
    """T >= 512 under tensor parallelism: the flash path runs once per layer
    and head group, at the group's width (here its plain version), and the
    logits equal the single-device flash forward's."""
    _, plm = models["mqa"]
    calls = []
    real = llm.flash_attention

    def counting(q, k, v):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v)

    monkeypatch.setattr(llm, "flash_attention", counting)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (1, 520)))
    want, _ = llm.forward(plm.params, toks, plm.cfg, logits_last_only=True)
    calls.clear()
    sharded = llm.shard_params(plm.params, plm.cfg, port_mesh("model", 4))
    got, _ = llm.forward(sharded, toks, plm.cfg, logits_last_only=True)
    assert calls == [((1, 520, 2, 16), (1, 520, 1, 16))] * (2 * 4)
    _close(got, want, MODE_TOL)


def test_int8_tp_both_orders(models):
    """Quantize then shard, and shard then quantize, give the same leaves
    bit for bit; the forward matches the single-device int8 forward and
    JAX's int8 tensor-parallel one."""
    jlm, plm = models["base"]
    cfg = plm.cfg
    mesh = port_mesh("model")
    toks = np.arange(24)[None, :] % 250
    q_single = llm.quantize_params(plm.params)
    want, _ = llm.forward(q_single, torch.from_numpy(toks), cfg)
    q_then_s = llm.shard_params(q_single, cfg, mesh)
    s_then_q = llm.quantize_params(llm.shard_params(plm.params, cfg, mesh))
    for name in q_then_s.param_names():
        a, b = q_then_s.param(name), s_then_q.param(name)
        if isinstance(a, Sharded):
            for x, y in zip(a.parts, b.parts):
                assert torch.equal(x.q, y.q) and torch.equal(x.scale, y.scale)
            assert a.parts[0].q.dtype == torch.int8
        elif isinstance(a, Q8):
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
    wq, wo = q_then_s.param("l0.wq"), q_then_s.param("l0.wo")
    assert tuple(wq.parts[0].scale.shape) == (1, 1, cfg.head_dim)   # split
    assert tuple(wo.parts[0].scale.shape) == (1, 1, cfg.d_model)    # whole
    jq = jllm.shard_params(jllm.quantize_params(jlm.params), jlm.cfg,
                           jax_mesh("model"))
    jgot = jax.jit(lambda p, t: jllm.forward(p, t, jlm.cfg)[0])(
        jq, jnp.asarray(toks))
    for sharded in (q_then_s, s_then_q):
        got, _ = llm.forward(sharded, torch.from_numpy(toks), cfg)
        _close(got, want, INT8_TOL)
        _close(got, jgot, INT8_TOL)


def test_int8_tp_mqa_kv_replicated(models):
    """MQA at 8-way: the int8 K/V stay whole on the first device while wq's
    int8 parts split over heads; the forward matches the single-device int8
    forward and JAX's."""
    jlm, plm = models["mqa"]
    toks = np.arange(24)[None, :] % 250
    qparams = llm.quantize_params(plm.params)
    want, _ = llm.forward(qparams, torch.from_numpy(toks), plm.cfg)
    sharded = llm.shard_params(qparams, plm.cfg, port_mesh("model"))
    wk = sharded.param("l0.wk")
    assert isinstance(wk, Q8) and tuple(wk.q.shape) == (64, 1, 16)
    assert isinstance(sharded.param("l0.wq"), Sharded)
    got, _ = llm.forward(sharded, torch.from_numpy(toks), plm.cfg)
    _close(got, want, INT8_TOL)
    jsh = jllm.shard_params(jllm.quantize_params(jlm.params), jlm.cfg,
                            jax_mesh("model"))
    jgot = jax.jit(lambda p, t: jllm.forward(p, t, jlm.cfg)[0])(
        jsh, jnp.asarray(toks))
    _close(got, jgot, INT8_TOL)


PROMPTS = ["Agent: hello", "Customer: I was told I won a big prize yesterday",
           "A"]


@pytest.mark.parametrize("name", ["base", "mqa"])
def test_tp_generation_equals_single_device(models, name):
    """Greedy and sampled batched decode (head-sharded KV caches where the
    K/V heads divide the axis, MQA's one cache on the first device with
    each layer's q/k/v gathered there) and the init_random(mesh=) path."""
    _, plm = models[name]
    tp = llm.LanguageModel(plm.cfg, llm.shard_params(plm.params, plm.cfg,
                                                     port_mesh("model")))
    enc = [plm.tokenizer.encode(p) for p in PROMPTS]
    for kw in ({}, {"temperature": 1.0, "seed": 5}):
        np.testing.assert_array_equal(
            tp.generate_tokens_batch(enc, max_new_tokens=10, **kw),
            plm.generate_tokens_batch(enc, max_new_tokens=10, **kw))
    assert tp.generate_text("x", max_new_tokens=4) == \
        plm.generate_text("x", max_new_tokens=4)
    lm = llm.LanguageModel.init_random(plm.cfg, seed=3,
                                       mesh=port_mesh("model", 4))
    assert isinstance(lm.params.param("l0.w_up"), Sharded)
    assert lm.generate_tokens(lm.tokenizer.encode("x"),
                              max_new_tokens=4).shape == (4,)


def test_tp_slot_window_equals_single_device(models):
    """The slot programs on a tensor-parallel model (int8 too): prefill into
    two slots and one decode window give the single-device tokens, lens and
    caches."""
    _, plm = models["mqa"]
    cfg = plm.cfg
    for params in (plm.params, llm.quantize_params(plm.params)):
        tp = llm.shard_params(params, cfg, port_mesh("model", 4))
        outs = []
        for p in (params, tp):
            cache = llm.init_cache(cfg, 3, 64, "cpu")
            firsts, lens = [], np.zeros(3, np.int32)
            for slot, text in ((0, PROMPTS[0]), (2, PROMPTS[1])):
                toks = plm.tokenizer.encode(text)
                pad = np.zeros((1, 56), np.int32)
                pad[0, :len(toks)] = toks
                firsts.append(llm.slot_prefill(p, pad, len(toks), cfg, cache,
                                               slot, 0.0, 7 + slot))
                lens[slot] = len(toks)
            tokens = np.asarray([firsts[0], cfg.EOS, firsts[1]], np.int32)
            res = llm.slot_decode_window(
                p, tokens, lens, np.asarray([True, False, True]),
                np.asarray([6, 0, 6], np.int32), cfg, cache,
                np.asarray([0.0, 0.0, 1.0], np.float32), 11, 6)
            outs.append((firsts, res, cache))
        (f0, r0, c0), (f1, r1, c1) = outs
        assert f0 == f1
        np.testing.assert_array_equal(r0[0], r1[0])
        np.testing.assert_array_equal(r0[1], r1[1])
        for k in c0:
            _close(c1[k], c0[k], MODE_TOL)
