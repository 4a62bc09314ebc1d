"""The port's weight-only int8 (``models/llm.py`` ``Q8``, ``quantize_params``,
``quantize_params_host``, ``_mm``, the int8 head; ``ops/int8_matmul.py``)
against the JAX package's, on the CPU.

Tolerances: the quantizers are bit-equal (f32 math, IEEE division,
round-half-to-even and a clip, in both frameworks); int8 logits within
``tests/test_torch_llm.py``'s ``SHORT_TOL`` (1e-4) of the JAX int8 model's
(both dequantize the same codes; f32 sums in another order), and
correlated > 0.999 with the full-precision logits (the reference's bar for
int8); greedy tokens equal. ``w8_matmul_reference`` against numpy at the
reference's rounding points: equal for f32 sums of small integers, and
within one bf16 step for the rounded bf16 outputs. On a CPU tensor the
kernel's wrapper runs its plain version; the kernel itself is held to it on
the card (``chip_smoke.py`` phase 3, and the ``cuda`` test below).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fraud_detection_tpu.checkpoint import hf_convert as jhf
from fraud_detection_tpu.explain.slotserve import (
    SlotServeService as JaxSlotServeService)
from fraud_detection_tpu.models import llm as jllm
from fraud_detection_tpu_torch import convert
from fraud_detection_tpu_torch.checkpoint import hf_convert as phf
from fraud_detection_tpu_torch.explain.slotserve import SlotServeService
from fraud_detection_tpu_torch.models import llm
from fraud_detection_tpu_torch.ops import int8_matmul as W
from tests.test_hf_convert import make_hf_config, make_hf_state
from tests.test_torch_hf_convert import bits, to_torch, write_dir
from tests.test_torch_llm import CFG, GEMMA, PROMPTS, SHORT_TOL
from tests.torch_parity import port_llm, port_llm_config

_jinit = jax.jit(jllm.init_params, static_argnums=1)
_jforward = jax.jit(jllm.forward, static_argnames=("cfg", "use_flash",
                                                   "logits_last_only"))


def port_q8_llm(jlm):
    """The port's twin of a JAX ``LanguageModel`` whose leaves may be
    ``Q8``: each Q8 leaf crosses as its (q, scale) numpy pair."""
    cfg = port_llm_config(jlm.cfg)
    arrays = {k: (np.asarray(v.q), np.asarray(v.scale))
              if isinstance(v, jllm.Q8) else np.asarray(v)
              for k, v in jlm.params.items()}
    return llm.LanguageModel(cfg, convert.llm_params_from_arrays(
        cfg, arrays, device="cpu"))


@pytest.fixture(scope="module")
def models():
    """(JAX float model, JAX int8 model, port int8 model) per config."""
    out = {}
    for name, cfg, seed in (("base", CFG, 0), ("gemma", GEMMA, 1)):
        jlm = jllm.LanguageModel(cfg, _jinit(jax.random.PRNGKey(seed), cfg))
        out[name] = (jlm, jlm.quantized(), port_llm(jlm).quantized())
    return out


def assert_same_leaves(jparams, pparams: llm.Transformer):
    for name, jv in jparams.items():
        pv = pparams.param(name)
        assert isinstance(pv, llm.Q8) == isinstance(jv, jllm.Q8), name
        if isinstance(jv, jllm.Q8):
            assert pv.q.dtype == torch.int8 and pv.scale.dtype == torch.float32
            np.testing.assert_array_equal(pv.q.numpy(), np.asarray(jv.q),
                                          err_msg=name)
            np.testing.assert_array_equal(pv.scale.numpy(),
                                          np.asarray(jv.scale), err_msg=name)
        else:
            np.testing.assert_array_equal(bits(pv.detach()), bits(jv),
                                          err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("include_embed", [True, False])
def test_quantize_params_bit_equal_jax(dtype, include_embed):
    cfg = jllm.TransformerConfig(vocab_size=300, d_model=64, n_heads=4,
                                 n_kv_heads=2, d_ff=96, n_layers=2,
                                 tie_embeddings=False,
                                 dtype=jnp.dtype(dtype))
    jlm = jllm.LanguageModel(cfg, _jinit(jax.random.PRNGKey(4), cfg))
    plm = port_llm(jlm)
    want = jllm.quantize_params(jlm.params, include_embed=include_embed)
    got = llm.quantize_params(plm.params, include_embed=include_embed)
    assert_same_leaves(want, got)
    assert isinstance(got.param("embed"), llm.Q8) == include_embed
    assert isinstance(got.param("l1.w_down"), llm.Q8)
    assert not isinstance(got.param("ln_f"), llm.Q8)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16", "float32"])
@pytest.mark.parametrize("include_embed", [True, False])
def test_quantize_params_host_bit_equal_jax(compute_dtype, include_embed):
    """The host quantizer on an f32 checkpoint's converted layout, with and
    without the round trip through the model dtype."""
    hf = make_hf_config(gemma=False, n_kv=2)
    st = make_hf_state(hf, seed=12)
    jparams = jhf.convert_hf_state(dict(st), jhf.config_from_hf(hf))
    pparams = phf.convert_hf_state({k: to_torch(v) for k, v in st.items()},
                                   phf.config_from_hf(hf))
    jdt = None if compute_dtype is None else jnp.dtype(compute_dtype)
    pdt = None if compute_dtype is None else getattr(torch, compute_dtype)
    want = jllm.quantize_params_host(jparams, include_embed=include_embed,
                                     compute_dtype=jdt)
    got = llm.quantize_params_host(pparams, include_embed=include_embed,
                                   compute_dtype=pdt)
    assert list(got) == list(want)
    for name, jv in want.items():
        pv = got[name]
        if isinstance(jv, jllm.Q8):
            np.testing.assert_array_equal(pv.q.numpy(), jv.q, err_msg=name)
            np.testing.assert_array_equal(pv.scale.numpy(), jv.scale,
                                          err_msg=name)
        else:
            assert not isinstance(pv, llm.Q8), name
            np.testing.assert_array_equal(bits(pv), bits(jv), err_msg=name)


def test_int8_load_equals_quantized_across_dtype_gap(tmp_path, monkeypatch):
    """``load_hf_checkpoint(int8=True)`` quantizes on the host what an
    after-load ``.quantized()`` sees: an f32 checkpoint loaded at bf16 bakes
    the bf16-rounded codes, at f32 the f32 ones (and the two differ). The
    loads' sources: the shards, then the q8 cache; a q8 cache at one dtype
    never serves another; an int8 miss reuses a valid bf16 cache."""
    hf = make_hf_config(gemma=False, n_kv=2)
    write_dir(tmp_path, hf, make_hf_state(hf, seed=12))
    d = str(tmp_path)
    kw = dict(max_seq=64, tokenizer="byte", device="cpu")
    ref = phf.load_hf_checkpoint(d, use_cache=False, **kw).quantized()
    info = {}
    lm = phf.load_hf_checkpoint(d, int8=True, load_info=info, **kw)
    assert info == {"source": "hf_shards"}
    for name in ref.params.param_names():
        a, b = ref.params.param(name), lm.params.param(name)
        if isinstance(a, llm.Q8):
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
        else:
            assert torch.equal(a, b)
    assert phf.has_converted_cache(d, "q8")
    assert phf.has_converted_cache(d, "q8", quant_dtype=torch.bfloat16)
    assert not phf.has_converted_cache(d, "q8", quant_dtype=torch.float32)
    assert not phf.has_converted_cache(d)

    def boom(*a, **k):
        raise AssertionError("a warm q8 load must not reconvert or requantize")

    with monkeypatch.context() as m:
        m.setattr(phf, "convert_hf_state", boom)
        m.setattr(phf, "quantize_params_host", boom)
        info = {}
        warm = phf.load_hf_checkpoint(d, int8=True, load_info=info, **kw)
    assert info == {"source": "q8_cache"}
    assert torch.equal(warm.params.param("l0.wq").q, lm.params.param("l0.wq").q)

    ref32 = phf.load_hf_checkpoint(d, use_cache=False, dtype=torch.float32,
                                   **kw).quantized()
    lm32 = phf.load_hf_checkpoint(d, int8=True, dtype=torch.float32, **kw)
    assert torch.equal(ref32.params.param("l0.wq").q,
                       lm32.params.param("l0.wq").q)
    assert not torch.equal(ref32.params.param("l0.wq").q,
                           ref.params.param("l0.wq").q)
    # the JAX loader bakes the same codes
    jlm = jhf.load_hf_checkpoint(d, max_seq=64, tokenizer="byte", int8=True,
                                 use_cache=False)
    assert_same_leaves(jlm.params, lm.params)

    other = tmp_path / "other"
    other.mkdir()
    write_dir(other, hf, make_hf_state(hf, seed=13))
    phf.load_hf_checkpoint(str(other), **kw)          # writes the bf16 cache
    with monkeypatch.context() as m:
        m.setattr(phf, "convert_hf_state", boom)
        info = {}
        phf.load_hf_checkpoint(str(other), int8=True, load_info=info, **kw)
    assert info == {"source": "bf16_cache"}


@pytest.mark.parametrize("name", ["base", "gemma"])
def test_int8_forward_matches_jax_and_full_precision(models, name):
    jlm, jq, pq = models[name]
    toks = np.random.default_rng(1).integers(0, jlm.cfg.vocab_size, (2, 40))
    want = np.asarray(_jforward(jq.params, jnp.asarray(toks), jq.cfg)[0])
    got, _ = llm.forward(pq.params, torch.from_numpy(toks), pq.cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=SHORT_TOL,
                               rtol=SHORT_TOL)
    full = np.asarray(_jforward(jlm.params, jnp.asarray(toks), jlm.cfg)[0])
    corr = np.corrcoef(got.numpy().ravel(), full.ravel())[0, 1]
    assert corr > 0.999, corr
    last, _ = llm.forward(pq.params, torch.from_numpy(toks), pq.cfg,
                          logits_last_only=True)
    np.testing.assert_allclose(last[:, 0].numpy(), got[:, -1].numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["base", "gemma"])
def test_int8_greedy_generation_equals_jax(models, name):
    _, jq, pq = models[name]
    enc = [jq.tokenizer.encode(p) for p in PROMPTS[:3]]
    want = jq.generate_tokens_batch(enc, max_new_tokens=12)
    got = pq.generate_tokens_batch(enc, max_new_tokens=12)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("paged", [False, True])
def test_int8_slot_services_equal_jax(models, paged):
    """The int8 model through the slot (and paged) services gives the JAX
    int8 service's greedy analyses text for text, and the fixed-batch
    path's tokens."""
    _, jq, pq = models["base"]
    kw = dict(slots=2, max_new_tokens=10, prompt_width=448, decode_window=4,
              wait_timeout=300.0, paged=paged)
    texts = ["Caller: this is your bank, read me the code now.",
             "Agent: your parcel is held; pay the fee in gift cards.",
             "Customer: I was told I won a big prize yesterday"]
    labels, confs = [1, 1, 0], [0.9, 0.8, 0.6]
    jsvc = JaxSlotServeService(jq, **kw)
    try:
        want = jsvc.explain_rows(texts, labels, confs, max_tokens=10)
    finally:
        jsvc.close()
    psvc = SlotServeService(pq, **kw)
    try:
        got = psvc.explain_rows(texts, labels, confs, max_tokens=10)
        snap = psvc.snapshot()
    finally:
        assert psvc.close()
    assert got == want
    assert snap["completed"] == 3 and snap["dropped"] == 0


def test_jax_q8_params_carry_across(models):
    """A JAX ``LanguageModel.quantized()`` crosses through
    ``llm_params_from_arrays`` unchanged, leaf for leaf."""
    _, jq, pq = models["gemma"]
    carried = port_q8_llm(jq)
    assert_same_leaves(jq.params, carried.params)
    toks = torch.from_numpy(np.arange(12)[None, :] % 300)
    assert torch.equal(llm.forward(carried.params, toks, carried.cfg)[0],
                       llm.forward(pq.params, toks, pq.cfg)[0])
    arrays = {k: (np.asarray(v.q), np.asarray(v.scale))
              if isinstance(v, jllm.Q8) else np.asarray(v)
              for k, v in jq.params.items()}
    arrays["l0.wq"] = (arrays["l0.wq"][0], arrays["l0.wq"][1][..., :4])
    with pytest.raises(ValueError, match="l0.wq"):
        convert.llm_params_from_arrays(carried.cfg, arrays, device="cpu")


def _round_bf16(a: np.ndarray) -> np.ndarray:
    return a.astype(ml_dtypes.bfloat16).astype(np.float32)


@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_w8_matmul_reference_matches_numpy(layout):
    """The plain version at the reference's rounding points, against numpy:
    f32 exactly (sums of small integers, power-of-two scales); bf16 kn is
    round(round(x @ q) * scale) and nk float32(round(x @ q.T)) * scale,
    within one bf16 step (torch's bf16 product may round its f32 sum
    differently only at a tie)."""
    rng = np.random.default_rng(0)
    m, k, n = 5, 48, 24
    x = rng.integers(-3, 4, (m, k)).astype(np.float32)
    q = rng.integers(-127, 128, (k, n) if layout == "kn" else (n, k)).astype(np.int8)
    scale = (2.0 ** rng.integers(-8, -2, n)).astype(np.float32)
    w = q.astype(np.float32) if layout == "kn" else q.astype(np.float32).T
    exact = x @ w
    got32 = W.w8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                        torch.from_numpy(scale), layout)
    assert got32.dtype == torch.float32
    np.testing.assert_array_equal(got32.numpy(), exact * scale)
    xb = torch.from_numpy(x).bfloat16()
    got = W.w8_matmul(xb, torch.from_numpy(q), torch.from_numpy(scale), layout)
    if layout == "kn":
        assert got.dtype == torch.bfloat16
        want = _round_bf16(_round_bf16(exact) * scale)
    else:
        assert got.dtype == torch.float32
        want = _round_bf16(exact) * scale
    step = np.abs(want) * 2.0 ** -7
    assert (np.abs(got.float().numpy() - want) <= step).all()


def test_w8_matmul_checks_its_arguments():
    x = torch.zeros((2, 16))
    q = torch.zeros((16, 8), dtype=torch.int8)
    s = torch.ones(8)
    with pytest.raises(ValueError, match="layout"):
        W.w8_matmul(x, q, s, "kk")
    with pytest.raises(ValueError, match="do not match"):
        W.w8_matmul(x, q, s, "nk")
    with pytest.raises(ValueError, match="int8 q"):
        W.w8_matmul(x, q.float(), s)
    with pytest.raises(ValueError, match="x \\(M, K\\)"):
        W.w8_matmul(x[None], q, s)
    W.w8_matmul.launches = 0
    assert W.w8_matmul(x, q, s).shape == (2, 8)
    assert W.w8_matmul.launches == 0     # the CPU runs the plain version


def test_int8_products_go_through_w8_matmul(models, monkeypatch):
    """Every weight product of an int8 decode step reaches ``w8_matmul``:
    7 per layer and the head; the embedding gather does not."""
    _, _, pq = models["base"]
    calls = []
    real = llm.w8_matmul

    def counted(x, q, scale, layout="kn"):
        calls.append(layout)
        return real(x, q, scale, layout)

    monkeypatch.setattr(llm, "w8_matmul", counted)
    toks = torch.tensor([[256, 65]])
    llm.forward(pq.params, toks, pq.cfg)
    assert calls.count("kn") == 7 * pq.cfg.n_layers and calls.count("nk") == 1


# Gemma-2B's weight products as (K, N, layout): wq/wo, wk/wv, w_gate/w_up,
# w_down and the tied head (chip_smoke.py ``W8_SHAPES``).
GEMMA_2B_W8 = {"wq,wo": (2048, 2048, "kn"), "wk,wv": (2048, 256, "kn"),
               "w_gate,w_up": (2048, 16_384, "kn"), "w_down": (16_384, 2048, "kn"),
               "head": (2048, 256_000, "nk")}
W8_MS = (1, 8, 35, 64, 512, 2048)
W8_DTYPES = (torch.bfloat16, torch.float32)


@pytest.mark.parametrize("dtype", W8_DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("shape", list(GEMMA_2B_W8), ids=list(GEMMA_2B_W8))
def test_w8_plan_is_the_same_for_every_m(shape, layout, dtype):
    """The split plan (channel tile, K splits, k chunk) a launch takes at
    every M is the one of (K, N, layout, dtype): every output's f32 order is
    fixed by the weight alone, which keeps a row's output bit-equal across M
    (paged decode == contiguous)."""
    k, n, _ = GEMMA_2B_W8[shape]
    plans = {W._config(m, k, n, layout, dtype).plan for m in W8_MS}
    assert plans == {W._plan(k, n, layout, dtype)}


@pytest.mark.parametrize("dtype", W8_DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 256), (2048, 16_384),
                                 (16_384, 2048), (2048, 256_000), (1008, 1000),
                                 (176, 40), (8, 8), (4096, 11_008)])
def test_w8_plan_splits_cover_k_in_whole_chunks(k, n, layout, dtype):
    plan = W._plan(k, n, layout, dtype)
    assert plan.chunk in W._CHUNKS and plan.split_len % plan.chunk == 0
    assert plan.split_len >= plan.chunk and plan.splits >= 1
    # every split holds k; the last one the rest (ragged or whole)
    assert (plan.splits - 1) * plan.split_len < k <= plan.splits * plan.split_len
    assert plan.tile in ((64, 128) if dtype == torch.bfloat16 else (64,))
    if layout == "nk" and dtype == torch.bfloat16:
        assert plan.tile == 128


@pytest.mark.parametrize("dtype", W8_DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", ["w_down", "wq,wo", "wk,wv"])
def test_w8_plan_fills_the_card_at_decode(shape, dtype):
    """At decode (M = 8) the small-N shapes run at least one block per SM of
    an H100 (132): channel tiles times K splits."""
    k, n, layout = GEMMA_2B_W8[shape]
    launch = W._config(8, k, n, layout, dtype)
    plan = launch.plan
    assert launch.across and plan.splits > 1
    blocks = -(-8 // launch.tokens) * -(-n // plan.tile) * plan.splits
    assert blocks >= 132, (plan, blocks)


def test_w8_plan_known_values():
    """The plans the card's numbers were taken with (PERF.md §6)."""
    bf16 = {name: W._plan(k, n, layout, torch.bfloat16)[:3]
            for name, (k, n, layout) in GEMMA_2B_W8.items()}
    assert bf16 == {"wq,wo": (128, 16, 64), "wk,wv": (64, 64, 32),
                    "w_gate,w_up": (128, 1, 128), "w_down": (128, 16, 128),
                    "head": (128, 1, 128)}
    assert W._plan(16_384, 2048, "kn", torch.float32)[:3] == (64, 9, 128)


@pytest.mark.parametrize("dtype", W8_DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", list(GEMMA_2B_W8), ids=list(GEMMA_2B_W8))
def test_w8_scratch_is_the_partials_of_split_launches(shape, dtype):
    """A launch writes f32 partials (S, M, N) exactly when its K splits go
    to separate blocks: at decode for a split plan, never at M = 2048 or
    for a one-split plan, and never past 16 MiB."""
    k, n, layout = GEMMA_2B_W8[shape]
    plan = W._plan(k, n, layout, dtype)
    for m in W8_MS:
        got = W._scratch_shape(m, k, n, layout, dtype)
        launch = W._config(m, k, n, layout, dtype)
        if got is None:
            assert not launch.across or plan.splits == 1
            continue
        assert got == (plan.splits, m, n) and launch.across
        assert 4 * plan.splits * m * n <= W._PARTIALS_MAX
        assert -(-m // launch.tokens) * -(-n // plan.tile) < 132
    assert W._scratch_shape(2048, k, n, layout, dtype) is None
    want = (plan.splits, 8, n) if plan.splits > 1 else None
    assert W._scratch_shape(8, k, n, layout, dtype) == want


@pytest.mark.parametrize("m", [1, 7, 8, 9, 35, 64, 65, 600, 2048])
@pytest.mark.parametrize("shape", list(GEMMA_2B_W8), ids=list(GEMMA_2B_W8))
def test_w8_token_tiles(m, shape):
    """bf16 takes 8 rows at decode, 32 up to 64 rows or for a weight of
    fewer than 8 channel tiles, 256 past 128 rows for a one-split kn weight,
    else 128; f32 8 or 32."""
    k, n, layout = GEMMA_2B_W8[shape]
    bf16 = W._config(m, k, n, layout, torch.bfloat16)
    f32 = W._config(m, k, n, layout, torch.float32)
    wide = m > 64 and -(-n // bf16.plan.tile) >= 8
    widest = wide and m > 128 and layout == "kn" and bf16.plan.splits == 1
    assert bf16.tokens == (8 if m <= 8 else 256 if widest else 128 if wide else 32)
    assert f32.tokens == (8 if m <= 8 else 32) and f32.plan.tile == 64
    if m == 2048 and shape != "wk,wv":
        assert wide     # every prefill product but wk/wv on 128-row blocks


def _takes(k, n, layout, dtype) -> bool:
    try:
        W._check_kernel_shape(k, n, layout, dtype)
    except ValueError:
        return False
    return True


def test_w8_kernel_accepts_and_refuses_the_same_shapes():
    """The kernel takes what it took before the split plan: bf16 kn needs K
    and N multiples of 8, nk K a multiple of 16; f32 any shape. Every shape
    it takes gets a plan and a launch the C entry point accepts (the
    arguments it checks, mirrored here)."""
    bf16, f32 = torch.bfloat16, torch.float32
    for k in range(1, 70):
        for n in (1, 8, 12, 16, 24, 40, 1000, 1016):
            assert _takes(k, n, "kn", bf16) == (k % 8 == 0 and n % 8 == 0)
            assert _takes(k, n, "nk", bf16) == (k % 16 == 0)
            assert _takes(k, n, "kn", f32) and _takes(k, n, "nk", f32)
            for layout in ("kn", "nk"):
                for dtype in (bf16, f32):
                    if not _takes(k, n, layout, dtype):
                        continue
                    for m in (1, 8, 9, 64, 65, 3000, 40_000):
                        plan, tokens, across = W._config(m, k, n, layout, dtype)
                        assert (plan.splits - 1) * plan.split_len < k \
                            <= plan.splits * plan.split_len
                        if dtype == bf16:
                            assert plan.split_len % 16 == 0
                            assert tokens in (8, 32, 128, 256)
                            # 256-row blocks keep no split sums
                            assert tokens != 256 or plan.splits == 1 or across
                            assert plan.tile in ((64, 128) if layout == "kn"
                                                 else (128,))
                        else:
                            assert tokens in (8, 32) and plan.tile == 64
    with pytest.raises(ValueError, match="multiples of 8"):
        W._check_kernel_shape(1000, 1004, "kn", bf16)
    with pytest.raises(ValueError, match="multiple of 16"):
        W._check_kernel_shape(1000, 1000, "nk", bf16)


@pytest.mark.cuda
def test_w8_matmul_kernel_matches_reference_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    dev = torch.device("cuda")
    W.kernel_self_test(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    for layout in ("kn", "nk"):
        q = torch.randint(-127, 128, (1008, 1000) if layout == "kn"
                          else (1000, 1008), generator=g, device=dev,
                          dtype=torch.int8)
        s = torch.rand(1000, generator=g, device=dev) * 0.01
        x = torch.randn((35, 1008), generator=g, device=dev)
        a, b = W.w8_matmul(x, q, s, layout), W.w8_matmul(x, q, s, layout)
        assert torch.equal(a, b)
        ref = W.w8_matmul_reference(x, q, s, layout)
        assert float((a - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
        # a split plan (K 1,008 in 32-k splits, the last ragged): rows alone
        # and across the dispatch's boundaries equal the same rows in bf16
        xb = torch.randn((2048, 1008), generator=g, device=dev).bfloat16()
        assert W._plan(1008, 1000, layout, torch.bfloat16).splits > 1
        full = W.w8_matmul(xb, q, s, layout)
        assert torch.equal(full, W.w8_matmul(xb, q, s, layout))
        for rows in (8, 1):
            assert torch.equal(W.w8_matmul(xb[:rows].contiguous(), q, s, layout),
                               full[:rows])
        refb = W.w8_matmul_reference(xb, q, s, layout).float()
        step = refb.abs().clamp_min(1e-30) * 2.0 ** -7
        assert bool(((full.float() - refb).abs() <= 2 * step + 1e-3).all())
