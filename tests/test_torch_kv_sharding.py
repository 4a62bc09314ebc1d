"""Head-sharded KV caches under tensor parallelism (``models/llm.py``'s cache
programs, ``explain/slotserve/``), on the CPU.

A tiny GQA model (8 heads, 4 K/V heads, d 8) over a 4-way CPU model axis:
each layer's k and v are one (..., 1, d) part per model-axis device, and
batched generation (greedy and sampled, f32 and int8), the slot programs
(prefill and two windows), the paged programs (a shared prefix, a
copy-on-write admit, table growth), ``SlotServeService`` and
``OnPodBackend`` give the single device's tokens EQUAL, and the JAX
package's. MQA (1 K/V head) and 2 K/V heads over 4 stay whole, as in the
reference. The reference's own layout is pinned as a fact: after a decode
step its cache comes back ``P(None, None, "model")`` beside wk's ``P(None,
"model", None)``. Last, two gloo processes of two parts each run a slot
window on their parts of the caches.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from fraud_detection_tpu.explain.slotserve import (
    SlotServeService as JaxSlotServeService)
from fraud_detection_tpu.explain.slotserve import decode as jdecode
from fraud_detection_tpu.models import llm as jllm
from fraud_detection_tpu_torch.explain.onpod import OnPodBackend
from fraud_detection_tpu_torch.explain.slotserve import SlotServeService
from fraud_detection_tpu_torch.explain.slotserve import decode as pdecode
from fraud_detection_tpu_torch.models import llm
from fraud_detection_tpu_torch.models.llm import Sharded
from fraud_detection_tpu_torch.parallel.mesh import Mesh
from tests.test_torch_mesh_multihost import _run_two_process
from tests.test_torch_slot_decode import _next_window
from tests.torch_parity import port_llm

GQA = jllm.TransformerConfig(d_model=64, n_heads=8, n_kv_heads=4, n_layers=2,
                             d_ff=128, max_seq=256)
N = 4
SLOTS, STEPS, BUCKET, PAGE = 3, 6, 16, 16
PREFIX = "<|system|>\nYou are a fraud analyst.\n"
ROWS = ((0, PREFIX + "Caller: this is your bank, read me the code."),
        (2, "Agent: your parcel is held; pay the fee in gift cards."))
TEMPS = np.asarray([0.0, 0.0, 1.0], np.float32)
PROMPTS = ["Agent: hello", "Customer: I was told I won a big prize", "A"]
_jinit = jax.jit(jllm.init_params, static_argnums=1)


def model_mesh(n=N):
    return Mesh(np.array(["cpu"] * n, dtype=object), ("model",))


@pytest.fixture(scope="module")
def models():
    jlm = jllm.LanguageModel(GQA, _jinit(jax.random.PRNGKey(0), GQA))
    plm = port_llm(jlm)
    tp = llm.LanguageModel(plm.cfg, llm.shard_params(plm.params, plm.cfg,
                                                     model_mesh()))
    return jlm, plm, tp


def _layout(cache):
    return {k: [(str(p.device), tuple(p.shape)) for p in llm.kv_parts(v)]
            for k, v in cache.items()}


def test_cache_parts_hold_their_heads_on_their_devices(models):
    _, plm, tp = models
    cfg = plm.cfg
    d = cfg.head_dim
    cache = llm.init_cache(cfg, 2, 32, "cpu", tp.params)
    pages = llm.init_kv_pages(cfg, 5, PAGE, "cpu", tp.params)
    for got, lead in ((cache, (2, 32)), (pages, (5, PAGE))):
        assert sorted(got) == sorted(f"l{l}.{t}" for l in range(2)
                                     for t in "kv")
        for arr in got.values():
            assert isinstance(arr, Sharded) and arr.dim == 2
        assert set(map(tuple, (map(tuple, v) for v in _layout(got).values()))) \
            == {(("cpu", (*lead, 1, d)),) * N}
    whole = llm.init_cache(cfg, 2, 32, "cpu")
    assert llm.kv_bytes_by_device(cache) == llm.kv_bytes_by_device(whole)
    # one decode step writes each head group's k/v into its own part: the
    # parts, put side by side, are the single-device cache
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 8)))
    with torch.inference_mode():
        llm.forward(plm.params, toks, cfg, kv_cache=whole)
        llm.forward(tp.params, toks, cfg, kv_cache=cache)
    for k in whole:
        np.testing.assert_allclose(cache[k].gather().numpy(),
                                   whole[k].numpy(), rtol=1e-5, atol=1e-6)


def test_whole_cache_beside_split_kv_weights_is_refused(models):
    """A cache made without the model's params (whole, on one device)
    beside K/V weights split over the model axis: the cache programs
    refuse it rather than gather every layer's q/k/v onto one device."""
    _, plm, tp = models
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 8)))
    with pytest.raises(ValueError, match="head-sharded"):
        llm.forward(tp.params, toks, plm.cfg,
                    kv_cache=llm.init_cache(plm.cfg, 2, 32, "cpu"))
    pad = np.zeros((1, 16), np.int32)
    with pytest.raises(ValueError, match="head-sharded"):
        llm.slot_prefill(tp.params, pad, 8, plm.cfg,
                         llm.init_cache(plm.cfg, 2, 32, "cpu"), 0, 0.0, 1)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("kw", [{}, {"temperature": 1.0, "seed": 5}])
def test_generation_equals_single_device_and_jax(models, kw, int8):
    jlm, plm, tp = models
    if int8:
        single = plm.quantized()
        model = llm.LanguageModel(plm.cfg, llm.shard_params(
            single.params, plm.cfg, model_mesh()))
        jlm = jllm.LanguageModel(jlm.cfg, jllm.quantize_params(jlm.params))
    else:
        single, model = plm, tp
    enc = [plm.tokenizer.encode(p) for p in PROMPTS]
    got = model.generate_tokens_batch(enc, max_new_tokens=10, **kw)
    np.testing.assert_array_equal(
        got, single.generate_tokens_batch(enc, max_new_tokens=10, **kw))
    np.testing.assert_array_equal(
        got, jlm.generate_tokens_batch(enc, max_new_tokens=10, **kw))


def _drive(dec):
    """ROWS admitted at their temperatures (the first shares PREFIX: a
    copy-on-write on a paged pool with that prefix), then two windows."""
    firsts, lens = [], np.zeros(SLOTS, np.int32)
    tokens = np.full(SLOTS, GQA.EOS, np.int32)
    for slot, text in ROWS:
        toks, _ = dec.encode_prompt(text)
        tokens[slot] = int(dec.prefill(slot, toks, float(TEMPS[slot]),
                                       7 + slot))
        firsts.append(int(tokens[slot]))
        lens[slot] = len(toks)
    active = np.asarray([True, False, True])
    remaining = np.asarray([5, 0, 9], np.int32)
    state, results = (tokens, lens, active, remaining), []
    for w in range(2):
        for slot in np.flatnonzero(state[2]):
            assert dec.grow_for_window(slot, int(state[1][slot]), STEPS)
        res = tuple(np.asarray(r) for r in dec.step(*state, TEMPS, 11 + w,
                                                    STEPS))
        results.append(res)
        state = _next_window(res, *state)
    return firsts, results


def _equal_runs(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1], b[1]):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("paged", [False, True])
def test_slot_programs_equal_single_device_and_jax(models, paged):
    jlm, plm, tp = models
    kw = dict(prompt_width=96, max_new_tokens=16, prompt_bucket=BUCKET)
    if paged:
        kw.update(page_size=PAGE, total_pages=40, prefix_text=PREFIX)
    cls, jcls = ((pdecode.PagedSlotDecoder, jdecode.PagedSlotDecoder) if paged
                 else (pdecode.SlotDecoder, jdecode.SlotDecoder))
    dec = cls(tp, SLOTS, **kw)
    pool = dec.pages if paged else dec.cache
    assert all(isinstance(a, Sharded) and len(a.parts) == N
               for a in pool.values())
    assert dec.kv_bytes == sum(dec.kv_bytes_per_device.values())
    single = cls(plm, SLOTS, **kw)
    assert dec.kv_bytes == single.kv_bytes
    got = _drive(dec)
    if paged:
        assert dec.cow_copies == 1 and dec.prefix_hits == 1
    _equal_runs(got, _drive(single))
    _equal_runs(got, _drive(jcls(jlm, SLOTS, **kw)))


@pytest.mark.parametrize("paged", [False, True])
def test_service_and_backend_equal_single_device_and_jax(models, paged):
    jlm, plm, tp = models
    texts = [f"Analyze dialogue {i}: the caller demands gift cards. "
             + "Customer hesitates. " * i for i in range(4)]
    kw = dict(slots=2, max_new_tokens=8, prompt_width=192, decode_window=4,
              wait_timeout=120.0, paged=paged)
    replies = []
    for cls, lm in ((SlotServeService, tp), (SlotServeService, plm),
                    (JaxSlotServeService, jlm)):
        svc = cls(lm, **kw)
        try:
            replies.append(svc.generate_batch(texts, temperature=0.0,
                                              max_tokens=8))
            if lm is tp:
                snap = svc.snapshot()
                assert snap["kv_bytes_per_device"] == {"cpu": snap["kv_bytes"]}
        finally:
            svc.close()
    assert replies[0] == replies[1] == replies[2]
    if not paged:
        assert OnPodBackend.from_model(tp).generate_batch(
            texts[:2], max_tokens=6) == OnPodBackend.from_model(
                plm).generate_batch(texts[:2], max_tokens=6)


@pytest.mark.parametrize("kv_heads", [1, 2])
def test_kv_heads_the_axis_does_not_split_stay_whole(kv_heads):
    """MQA and 2 K/V heads over 4: wk/wv replicated as in the reference
    (``param_shardings``), so the caches are one tensor on the first
    device and generation and a slot window equal the single device's. In
    the full-sequence forward each head group reads the K/V heads its
    query heads map to (with 2 over 4, groups 0-1 head 0 and 2-3 head 1):
    the logits equal the single device's and the JAX package's sharded
    forward's within the TP forward's 3e-4."""
    cfg = jllm.TransformerConfig(**{**GQA.__dict__, "n_kv_heads": kv_heads})
    jlm = jllm.LanguageModel(cfg, _jinit(jax.random.PRNGKey(2), cfg))
    plm = port_llm(jlm)
    tp = llm.LanguageModel(plm.cfg, llm.shard_params(plm.params, plm.cfg,
                                                     model_mesh()))
    assert not isinstance(tp.params.param("l0.wk"), Sharded)
    toks = np.random.default_rng(3).integers(0, 256, (2, 16))
    got = llm.forward(tp.params, torch.from_numpy(toks), plm.cfg)[0].numpy()
    np.testing.assert_allclose(got, llm.forward(
        plm.params, torch.from_numpy(toks), plm.cfg)[0].numpy(),
        rtol=3e-4, atol=3e-4)
    jsh = jllm.shard_params(jlm.params, cfg,
                            JMesh(np.array(jax.devices()[:N]), ("model",)))
    np.testing.assert_allclose(got, np.asarray(jax.jit(
        lambda p, t: jllm.forward(p, t, cfg)[0])(jsh, jnp.asarray(toks))),
        rtol=3e-4, atol=3e-4)
    cache = llm.init_cache(plm.cfg, 2, 32, "cpu", tp.params)
    assert all(isinstance(a, torch.Tensor) and a.shape[2] == kv_heads
               for a in cache.values())
    enc = [plm.tokenizer.encode(p) for p in PROMPTS]
    np.testing.assert_array_equal(
        tp.generate_tokens_batch(enc, max_new_tokens=8),
        plm.generate_tokens_batch(enc, max_new_tokens=8))
    kw = dict(prompt_width=96, max_new_tokens=16, prompt_bucket=BUCKET)
    _equal_runs(_drive(pdecode.SlotDecoder(tp, SLOTS, **kw)),
                _drive(pdecode.SlotDecoder(plm, SLOTS, **kw)))


def test_reference_keeps_the_cache_head_sharded(models):
    """The JAX package's layout, which the port's parts follow: after one
    jitted decode step on its 4-way model axis the cache comes back split
    over heads, beside wk."""
    jlm, _, _ = models
    mesh = JMesh(np.array(jax.devices()[:N]), ("model",))
    params = jllm.shard_params(jlm.params, GQA, mesh)
    cache = jllm.init_cache(GQA, 2, 32)
    toks = jnp.asarray(np.arange(16).reshape(2, 8) % 250, jnp.int32)
    _, cache = jax.jit(lambda p, t, c: jllm.forward(
        p, t, GQA, kv_cache=c, cache_len=0))(params, toks, cache)
    assert tuple(cache["l0.k"].sharding.spec) == (None, None, "model")
    assert tuple(params["l0.wk"].sharding.spec) == (None, "model", None)


_CHILD = r'''
import json
import numpy as np
import torch
torch.set_num_threads(1)
from fraud_detection_tpu_torch.explain.slotserve.decode import SlotDecoder
from fraud_detection_tpu_torch.models import llm
from fraud_detection_tpu_torch.parallel.mesh import Mesh, initialize_distributed

assert initialize_distributed(timeout_s=60)
rank = torch.distributed.get_rank()
cfg = llm.TransformerConfig(**json.loads(CFG))
mesh = Mesh(np.array(["cpu"] * 2, object), ("model",), process_count=2,
            process_index=rank, group=torch.distributed.group.WORLD)
lm = llm.LanguageModel(cfg, llm.shard_params(
    llm.init_params_threefry(cfg, 0, "cpu"), cfg, mesh))
dec = SlotDecoder(lm, 2, prompt_width=64, max_new_tokens=8, prompt_bucket=16)
layout = sorted({(str(p.device), tuple(p.shape)) for a in dec.cache.values()
                 for p in llm.kv_parts(a)})
firsts = [dec.prefill(s, np.asarray(lm.tokenizer.encode(t), np.int32), 0.0, s)
          for s, t in enumerate(["Agent: hello there", "Customer: a prize?"])]
out, lens, _, _ = dec.step(np.asarray(firsts, np.int32), np.asarray(
    [19, 19], np.int32), np.ones(2, bool), np.full(2, 6, np.int32),
    np.zeros(2, np.float32), 3, 6)
print("RESULT", json.dumps(dict(firsts=firsts, out=out.tolist(),
                                lens=lens.tolist(), layout=layout,
                                kv=dec.kv_bytes)), flush=True)
torch.distributed.destroy_process_group()
'''


def test_two_process_slot_window_on_sharded_caches():
    """Each of two gloo processes holds two of the four parts of every
    cache (its heads only) and the row-parallel sums cross between them:
    the first tokens and the window equal one process's on the same
    weights."""
    shape = dict(d_model=64, n_heads=8, n_kv_heads=4, n_layers=2, d_ff=128,
                 max_seq=128)
    got = [json.loads(ln.split(" ", 1)[1]) for ln in _run_two_process(
        _CHILD.replace("json.loads(CFG)", f"json.loads({json.dumps(shape)!r})"))]
    cfg = llm.TransformerConfig(**shape)
    lm = llm.LanguageModel(cfg, llm.init_params_threefry(cfg, 0, "cpu"))
    dec = pdecode.SlotDecoder(lm, 2, prompt_width=64, max_new_tokens=8,
                              prompt_bucket=16)
    firsts = [dec.prefill(s, np.asarray(lm.tokenizer.encode(t), np.int32),
                          0.0, s)
              for s, t in enumerate(["Agent: hello there",
                                     "Customer: a prize?"])]
    out, lens, _, _ = dec.step(np.asarray(firsts, np.int32),
                               np.asarray([19, 19], np.int32),
                               np.ones(2, bool), np.full(2, 6, np.int32),
                               np.zeros(2, np.float32), 3, 6)
    for g in got:
        assert g["layout"] == [["cpu", [2, 72, 1, 8]]]
        assert g["kv"] * 2 == dec.kv_bytes
        assert g["firsts"] == firsts
        assert g["out"] == out.tolist() and g["lens"] == lens.tolist()
