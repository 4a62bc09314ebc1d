"""The port's decoder against the JAX package's, on the CPU.

The same weights (a JAX ``init_params`` draw, carried across with
``convert.llm_params_from_arrays``) go through both forwards: f32 logits
agree within 1e-4 on the materialized path (5e-4, the JAX flash test's
bound, once the flash or chunked path runs at T=576), and greedy batched
generation gives EQUAL tokens, and so does sampled generation: the port
draws its Gumbel noise from JAX's threefry streams (``utils/threefry.py``)
at the reference's keys, ``fold_in(fold_in(PRNGKey(seed), step), row)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fraud_detection_tpu.models import llm as jllm
from fraud_detection_tpu_torch.models import llm
from tests.torch_parity import port_llm, port_llm_config

CFG = jllm.TransformerConfig(d_model=64, n_heads=8, n_layers=2, d_ff=128,
                             max_seq=640)
# Gemma's quirks at a tiny width: MQA, a head dim that is not D/H, tanh
# GeGLU, a sqrt(D) embedding scale and an untied output head.
GEMMA = jllm.TransformerConfig(vocab_size=300, d_model=64, n_heads=4,
                               n_kv_heads=1, head_dim_override=32, d_ff=96,
                               n_layers=2, max_seq=640, activation="gelu",
                               embed_scale=8.0, tie_embeddings=False)
SHORT_TOL, LONG_TOL = 1e-4, 5e-4
# One compiled program per shape instead of op-by-op dispatch (the
# threshold-patched reference below runs eagerly: a trace would cache it).
_jinit = jax.jit(jllm.init_params, static_argnums=1)
_jforward = jax.jit(jllm.forward, static_argnames=("cfg", "use_flash",
                                                   "logits_last_only"))
PROMPTS = ["Agent: hello", "Customer: I was told I won a big prize yesterday",
           "A", "Caller: this is your bank, read me the code we just sent"]


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, cfg, seed in (("base", CFG, 0), ("gemma", GEMMA, 1)):
        jlm = jllm.LanguageModel(cfg, _jinit(jax.random.PRNGKey(seed), cfg))
        out[name] = (jlm, port_llm(jlm))
    return out


def _tokens(t, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(2, t))


@pytest.mark.parametrize("name", ["base", "gemma"])
def test_forward_short_matches_jax(models, name):
    jlm, plm = models[name]
    toks = _tokens(40, jlm.cfg.vocab_size)
    want, _ = _jforward(jlm.params, jnp.asarray(toks), jlm.cfg)
    got, cache = llm.forward(plm.params, torch.from_numpy(toks), plm.cfg)
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SHORT_TOL,
                               rtol=SHORT_TOL)


@pytest.fixture(scope="module")
def long_logits(models):
    """JAX logits at T=576 through the flash kernel (its default dispatch)
    and through the materialized path (threshold raised)."""
    out = {}
    for name in ("base", "gemma"):
        jlm, _ = models[name]
        toks = _tokens(576, jlm.cfg.vocab_size, seed=2)[:1]
        flash, _ = _jforward(jlm.params, jnp.asarray(toks), jlm.cfg)
        saved = jllm._FLASH_MIN_T
        jllm._FLASH_MIN_T = 10_000
        try:
            plain, _ = jllm.forward(jlm.params, jnp.asarray(toks), jlm.cfg)
        finally:
            jllm._FLASH_MIN_T = saved
        out[name] = (toks, np.asarray(flash), np.asarray(plain))
    return out


@pytest.mark.parametrize("name", ["base", "gemma"])
@pytest.mark.parametrize("branch", ["flash", "materialized", "chunked"])
def test_forward_long_matches_jax(models, long_logits, monkeypatch, name,
                                  branch):
    """T=576: every port branch against the JAX flash forward, and the port's
    flash forward against the JAX materialized one."""
    _, plm = models[name]
    toks, jflash, jplain = long_logits[name]
    kw = {"use_flash": False} if branch == "chunked" else {}
    if branch == "materialized":
        monkeypatch.setattr(llm, "_FLASH_MIN_T", 10_000)
    got, _ = llm.forward(plm.params, torch.from_numpy(toks), plm.cfg, **kw)
    np.testing.assert_allclose(got.numpy(), jflash, atol=LONG_TOL, rtol=LONG_TOL)
    if branch == "flash":
        np.testing.assert_allclose(got.numpy(), jplain, atol=LONG_TOL,
                                   rtol=LONG_TOL)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_building_blocks_match_jax(dtype):
    """rms_norm, rope at negative (left-pad) positions and per-row masked
    _attend, in f32 (1e-5) and bf16 (two bf16 ulps of the value scale)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    kv = rng.normal(size=(2, 7, 3, 8)).astype(np.float32)
    gamma = rng.normal(size=(8,)).astype(np.float32)
    pos = np.asarray([[-2, -1, 0, 1, 2], [0, 1, 2, 3, 4]])
    mask = rng.uniform(size=(2, 5, 7)) < 0.6
    mask[:, :, 0] = True
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    j = lambda a: jnp.asarray(a).astype(jdt)
    t = lambda a: torch.from_numpy(a).to(tdt)
    tol = 1e-5 if dtype is np.float32 else 2 * 2.0 ** -7
    pairs = [
        (jllm.rms_norm(j(x), j(gamma)), llm.rms_norm(t(x), t(gamma))),
        (jllm.rope(j(x), jnp.asarray(pos), 10000.0),
         llm.rope(t(x), torch.from_numpy(pos), 10000.0)),
        (jllm._attend(j(x), j(kv), j(kv), jnp.asarray(mask)),
         llm._attend(t(x), t(kv), t(kv), torch.from_numpy(mask))),
    ]
    for want, got in pairs:
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=tol * max(1.0, np.abs(want).max()),
                                   rtol=0)


def test_incremental_decode_matches_full_forward(models):
    """Prefill + one-token steps against the in-place cache give the full
    forward's logits at every position; logits_last_only gives its last."""
    _, plm = models["base"]
    toks = torch.from_numpy(_tokens(12, 256, seed=4)[:1])
    full, _ = llm.forward(plm.params, toks, plm.cfg)
    cache = llm.init_cache(plm.cfg, 1, 12, "cpu")
    pre, out_cache = llm.forward(plm.params, toks[:, :6], plm.cfg,
                                 positions=torch.arange(6)[None],
                                 kv_cache=cache, cache_len=0)
    assert out_cache is cache
    np.testing.assert_allclose(pre.numpy(), full[:, :6].numpy(), rtol=2e-4,
                               atol=2e-4)
    for t in range(6, 12):
        step, _ = llm.forward(plm.params, toks[:, t:t + 1], plm.cfg,
                              positions=torch.tensor([[t]]), kv_cache=cache,
                              cache_len=t)
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=f"pos {t}")
    last, _ = llm.forward(plm.params, toks, plm.cfg, logits_last_only=True)
    assert last.shape == (1, 1, plm.cfg.vocab_size)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["base", "gemma"])
def test_greedy_batch_generation_equals_jax(models, name):
    jlm, plm = models[name]
    enc = [jlm.tokenizer.encode(p) for p in PROMPTS[:3]]
    want = jlm.generate_tokens_batch(enc, max_new_tokens=12)
    got = plm.generate_tokens_batch(enc, max_new_tokens=12)
    assert got.dtype == np.int32 and got.shape == (3, 12)
    np.testing.assert_array_equal(got, want)
    assert (plm.generate_text_batch(PROMPTS[:3], max_new_tokens=12)
            == jlm.generate_text_batch(PROMPTS[:3], max_new_tokens=12))


@pytest.mark.parametrize("temperature", [0.7, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampled_batch_generation_equals_jax(models, temperature, seed):
    """Sampled tokens equal the JAX decoder's: the same keys and threefry
    noise, argmax over logits that agree within 1e-4 (a flip would need two
    perturbed logits that close)."""
    jlm, plm = models["base"]
    enc = [jlm.tokenizer.encode(p) for p in PROMPTS[:3]]
    kw = dict(max_new_tokens=16, temperature=temperature, seed=seed)
    want = jlm.generate_tokens_batch(enc, **kw)
    got = plm.generate_tokens_batch(enc, **kw)
    np.testing.assert_array_equal(got, want)
    assert (plm.generate_text_batch(PROMPTS[:3], **kw)
            == jlm.generate_text_batch(PROMPTS[:3], **kw))


def test_batched_generation_matches_single(models):
    _, plm = models["base"]
    enc = [plm.tokenizer.encode(p) for p in PROMPTS]
    batched = plm.generate_tokens_batch(enc, max_new_tokens=10)
    for i, tp in enumerate(enc):
        np.testing.assert_array_equal(
            batched[i], plm.generate_tokens(tp, max_new_tokens=10),
            err_msg=PROMPTS[i])


def test_generation_freezes_after_eos(models):
    """A row that samples EOS emits EOS from then on, while the rows beside
    it go on; high-temperature sampling draws an early EOS within a few
    seeds."""
    _, plm = models["base"]
    enc = [plm.tokenizer.encode(p) for p in PROMPTS[:2]]
    eos = plm.cfg.EOS
    for seed in range(40):
        toks = plm.generate_tokens_batch(enc, max_new_tokens=24,
                                         temperature=3.0, seed=seed)
        hits = [np.flatnonzero(row == eos) for row in toks]
        early = [h[0] for h in hits if len(h) and h[0] < 16]
        if early:
            for row, h in zip(toks, hits):
                if len(h):
                    assert (row[h[0]:] == eos).all(), row
            break
    else:
        raise AssertionError("no early EOS drawn in 40 seeds at temp 3.0")


def test_sampling_is_batch_composition_invariant(models):
    _, plm = models["base"]
    tok = plm.tokenizer.encode("Customer: is this a scam?")
    alone = plm.generate_tokens_batch([tok], max_new_tokens=10,
                                      temperature=1.0, seed=5)
    extras = [plm.tokenizer.encode(p) for p in ("Agent: hi", "B", "CC")]
    cobatched = plm.generate_tokens_batch([tok] + extras, max_new_tokens=10,
                                          temperature=1.0, seed=5)
    np.testing.assert_array_equal(alone[0], cobatched[0])
    np.testing.assert_array_equal(
        plm.generate_tokens(tok, max_new_tokens=10, temperature=1.0, seed=5),
        alone[0])
    other = plm.generate_tokens_batch([tok], max_new_tokens=10,
                                      temperature=1.0, seed=6)
    assert not np.array_equal(other[0], alone[0])


def test_byte_tokenizer_equals_jax():
    cfg = jllm.TransformerConfig(max_seq=16)
    jt, pt = jllm.ByteTokenizer(cfg), llm.ByteTokenizer(port_llm_config(cfg))
    for text in ("hello wörld", "", "a" * 40, "🚀 émoji"):
        np.testing.assert_array_equal(pt.encode(text), jt.encode(text))
        ids = list(jt.encode(text)[1:]) + [cfg.EOS, 65, 300, -1]
        assert pt.decode(ids) == jt.decode(ids)


def test_bf16_forward_matches_jax():
    """bf16 weights and activations: the two frameworks round at the same
    points but sum in other orders (and XLA may keep excess f32 precision
    inside fusions), so logits agree to a few bf16 ulps of their scale:
    max |diff| within 5% of max |logit|."""
    cfg = jllm.TransformerConfig(d_model=64, n_heads=8, n_layers=2, d_ff=128,
                                 dtype=jnp.bfloat16)
    jlm = jllm.LanguageModel(cfg, _jinit(jax.random.PRNGKey(0), cfg))
    plm = port_llm(jlm)
    assert plm.params.embed.dtype == torch.bfloat16
    toks = _tokens(40, 256)
    want = np.asarray(_jforward(jlm.params, jnp.asarray(toks), cfg)[0])
    got = llm.forward(plm.params, torch.from_numpy(toks), plm.cfg)[0].numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 0.05 * scale


def test_llm_params_from_arrays_refuses_mismatch(models):
    from fraud_detection_tpu_torch import convert

    jlm, plm = models["base"]
    arrays = {k: np.asarray(v) for k, v in jlm.params.items()}
    with pytest.raises(ValueError, match="missing"):
        convert.llm_params_from_arrays(plm.cfg, {k: v for k, v in arrays.items()
                                                 if k != "ln_f"}, device="cpu")
    arrays["l0.wq"] = arrays["l0.wq"][:, :4]
    with pytest.raises(ValueError, match="l0.wq"):
        convert.llm_params_from_arrays(plm.cfg, arrays, device="cpu")
