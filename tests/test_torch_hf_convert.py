"""The port's HF checkpoint reader (``checkpoint/hf_convert.py``) against
the JAX package's, on the CPU.

The checkpoints are written in the tests, in the HF layout of
``tests/test_hf_convert.py`` (its ``make_hf_config`` / ``make_hf_state`` and
its independent numpy HF forward). Tolerances: the config and the converted
weights are equal field for field and bit for bit (both converters only
move, permute and round-to-nearest-even cast); files the port writes are
byte-identical to the JAX writer's; logits against the numpy HF forward
within that file's 2e-4 (f32 weights, float64 reference).
"""

import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fraud_detection_tpu.checkpoint import hf_convert as jhf
from fraud_detection_tpu.models import llm as jllm
from fraud_detection_tpu_torch.checkpoint import hf_convert as phf
from fraud_detection_tpu_torch.models import llm
from tests.test_hf_convert import hf_forward_numpy, make_hf_config, make_hf_state

VARIANTS = {"llama_gqa": (False, 2), "llama_untied_mha": (False, 4),
            "gemma_mqa": (True, 1)}
TOL = 2e-4   # tests/test_hf_convert.py's bound against the float64 forward


def to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 included) as a CPU tensor."""
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def bits(t) -> np.ndarray:
    """The raw bits of a tensor or array (bfloat16 as uint16)."""
    if isinstance(t, torch.Tensor):
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def state(variant, dtype="f32", seed=3):
    gemma, n_kv = VARIANTS[variant]
    hf = make_hf_config(gemma=gemma, n_kv=n_kv)
    st = make_hf_state(hf, seed=seed)
    if dtype == "bf16":
        st = {k: v.astype(ml_dtypes.bfloat16) for k, v in st.items()}
    return hf, st


def write_dir(path, hf, st, shards=1):
    """config.json and the state as one file or ``shards`` files with an
    index, written by the JAX package's writer."""
    with open(path / "config.json", "w") as f:
        json.dump(hf, f)
    if shards == 1:
        jhf.write_safetensors(str(path / "model.safetensors"), st)
        return
    names = sorted(st)
    per = -(-len(names) // shards)
    weight_map = {}
    for i in range(shards):
        fname = f"model-{i + 1:05d}.safetensors"
        part = names[i * per:(i + 1) * per]
        jhf.write_safetensors(str(path / fname), {k: st[k] for k in part})
        weight_map.update({k: fname for k in part})
    with open(path / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": weight_map}, f)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", [None, "float32"])
def test_config_from_hf_equals_jax(variant, dtype):
    hf, _ = state(variant)
    want = jhf.config_from_hf(hf, max_seq=64,
                              dtype=None if dtype is None else jnp.float32)
    got = phf.config_from_hf(hf, max_seq=64,
                             dtype=None if dtype is None else torch.float32)
    for field in ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff",
                  "max_seq", "rope_theta", "n_kv_heads", "head_dim_override",
                  "activation", "embed_scale", "tie_embeddings", "rms_eps",
                  "head_dim", "kv_heads"):
        assert getattr(got, field) == getattr(want, field), field
    assert phf._dtype_name(got.dtype) == np.dtype(want.dtype).name


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_convert_hf_state_bit_equal_jax(variant, dtype):
    hf, st = state(variant, dtype)
    want = jhf.convert_hf_state(dict(st), jhf.config_from_hf(hf, max_seq=64))
    got = phf.convert_hf_state({k: to_torch(v) for k, v in st.items()},
                               phf.config_from_hf(hf, max_seq=64))
    assert list(got) == list(want)
    for name in want:
        assert tuple(got[name].shape) == np.shape(want[name]), name
        np.testing.assert_array_equal(bits(got[name]), bits(want[name]),
                                      err_msg=name)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_converted_logits_match_hf_semantics(variant):
    hf, st = state(variant)
    cfg = phf.config_from_hf(hf, max_seq=64, dtype=torch.float32)
    params = phf.convert_hf_state({k: to_torch(v) for k, v in st.items()}, cfg)
    model = llm.Transformer.from_leaves(cfg, params)
    tokens = np.random.default_rng(9).integers(0, hf["vocab_size"], (2, 11))
    got, _ = llm.forward(model, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(got.numpy(), hf_forward_numpy(st, hf, tokens),
                               rtol=TOL, atol=TOL)


def test_safetensors_bytes_equal_jax_and_read_back(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"a": rng.normal(size=(3, 5)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(ml_dtypes.bfloat16),
              "c": rng.integers(0, 100, (2, 2, 2)).astype(np.int64),
              "d": rng.integers(-127, 128, (4, 3)).astype(np.int8)}
    jhf.write_safetensors(str(tmp_path / "j.safetensors"), arrays)
    phf.write_safetensors(str(tmp_path / "p.safetensors"),
                          {k: to_torch(v) for k, v in arrays.items()})
    assert ((tmp_path / "j.safetensors").read_bytes()
            == (tmp_path / "p.safetensors").read_bytes())
    back = phf.read_safetensors(str(tmp_path / "j.safetensors"))
    assert list(back) == list(arrays)
    for k, v in arrays.items():
        assert back[k].dtype == to_torch(v).dtype
        np.testing.assert_array_equal(bits(back[k]), bits(v))
    # the JAX reader reads the port's file
    jback = jhf.read_safetensors(str(tmp_path / "p.safetensors"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(bits(jback[k]), bits(v))


@pytest.mark.parametrize("shards", [1, 2])
def test_load_checkpoint_dir_and_cache(tmp_path, shards):
    """A directory load (one file, or shards behind an index) gives the
    numpy HF forward's logits; the first load writes the converted cache, a
    reload hits it with equal weights, and an mtime bump on a shard
    invalidates it."""
    hf, st = state("llama_gqa", seed=5)
    write_dir(tmp_path, hf, st, shards)
    info = {}
    lm = phf.load_hf_checkpoint(str(tmp_path), max_seq=64,
                                dtype=torch.float32, tokenizer="byte",
                                device="cpu", load_info=info)
    assert info == {"source": "hf_shards"}
    tokens = np.arange(10, dtype=np.int64)[None, :] % hf["vocab_size"]
    got, _ = llm.forward(lm.params, torch.from_numpy(tokens), lm.cfg)
    np.testing.assert_allclose(got.numpy(), hf_forward_numpy(st, hf, tokens),
                               rtol=TOL, atol=TOL)
    assert phf.has_converted_cache(str(tmp_path))
    info2 = {}
    lm2 = phf.load_hf_checkpoint(str(tmp_path), max_seq=64,
                                 dtype=torch.float32, tokenizer="byte",
                                 device="cpu", load_info=info2)
    assert info2 == {"source": "bf16_cache"}
    for name in lm.params.param_names():
        assert torch.equal(lm.params.param(name), lm2.params.param(name))
    shard = "model.safetensors" if shards == 1 else "model-00001.safetensors"
    os.utime(tmp_path / shard)   # bumps mtime_ns
    assert not phf.has_converted_cache(str(tmp_path))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("int8", [False, True])
def test_caches_load_across_packages(tmp_path, writer, int8):
    """A converted cache either package writes validates and loads in the
    other, with the same weights (bf16 model; the q8 variant for int8)."""
    hf, st = state("gemma_mqa", "bf16", seed=7)
    write_dir(tmp_path, hf, st)
    if writer == "jax":
        jlm = jhf.load_hf_checkpoint(str(tmp_path), max_seq=64,
                                     tokenizer="byte", int8=int8)
        info = {}
        plm = phf.load_hf_checkpoint(str(tmp_path), max_seq=64,
                                     tokenizer="byte", int8=int8,
                                     device="cpu", load_info=info)
    else:
        plm = phf.load_hf_checkpoint(str(tmp_path), max_seq=64,
                                     tokenizer="byte", int8=int8,
                                     device="cpu")
        info = {}
        jlm = jhf.load_hf_checkpoint(str(tmp_path), max_seq=64,
                                     tokenizer="byte", int8=int8,
                                     load_info=info)
    assert info == {"source": "q8_cache" if int8 else "bf16_cache"}
    for name, jv in jlm.params.items():
        pv = plm.params.param(name)
        if isinstance(jv, jllm.Q8):
            assert isinstance(pv, llm.Q8), name
            np.testing.assert_array_equal(pv.q.numpy(), np.asarray(jv.q))
            np.testing.assert_array_equal(pv.scale.numpy(),
                                          np.asarray(jv.scale))
        else:
            np.testing.assert_array_equal(bits(pv), bits(jv), err_msg=name)


def test_unknown_architecture_rejected():
    for mtype in ("mamba", "qwen2", "gemma2", "deepseek_v2"):
        hf = make_hf_config()
        hf["model_type"] = mtype
        with pytest.raises(NotImplementedError, match="model_type"):
            phf.config_from_hf(hf)
    hf = make_hf_config()
    hf["hidden_act"] = "relu"
    with pytest.raises(NotImplementedError, match="hidden_act"):
        phf.config_from_hf(hf)


def test_leftover_tensors_rejected():
    hf, st = state("llama_gqa")
    st["model.layers.0.self_attn.q_proj.bias"] = np.zeros(32, np.float32)
    with pytest.raises(NotImplementedError, match="unconverted"):
        phf.convert_hf_state({k: to_torch(v) for k, v in st.items()},
                             phf.config_from_hf(hf))
    del st["model.layers.0.self_attn.q_proj.bias"]
    del st["model.norm.weight"]
    with pytest.raises(KeyError, match="model.norm.weight"):
        phf.convert_hf_state({k: to_torch(v) for k, v in st.items()},
                             phf.config_from_hf(hf))


def test_missing_tokenizer_refuses_silent_byte_fallback(tmp_path):
    hf, st = state("llama_gqa")
    write_dir(tmp_path, hf, st)
    with pytest.raises(ValueError, match="tokenizer"):
        phf.load_hf_checkpoint(str(tmp_path), max_seq=64,
                               dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("variant,n", [("llama_gqa", 2), ("gemma_mqa", 4)])
def test_mesh_load_equals_jax(tmp_path, variant, n):
    """``load_hf_checkpoint(mesh=)``: the loaded weights split over the
    model axis (K/V split where the K/V heads divide it, else whole on the
    first device) and the logits within the tensor-parallel forward's 3e-4
    of the JAX package's mesh load and of the numpy HF forward's."""
    import jax
    from jax.sharding import Mesh as JMesh

    from fraud_detection_tpu_torch.models.llm import Sharded
    from fraud_detection_tpu_torch.parallel.mesh import Mesh

    hf, st = state(variant, seed=9)
    write_dir(tmp_path, hf, st)
    kw = dict(max_seq=64, tokenizer="byte", use_cache=False)
    plm = phf.load_hf_checkpoint(str(tmp_path), dtype=torch.float32,
                                 mesh=Mesh(np.array(["cpu"] * n, object),
                                           ("model",)), **kw)
    jlm = jhf.load_hf_checkpoint(
        str(tmp_path), dtype=jnp.float32,
        mesh=JMesh(np.array(jax.devices()[:n]), ("model",)), **kw)
    wq = plm.params.param("l0.wq")
    assert isinstance(wq, Sharded) and len(wq.parts) == n
    assert isinstance(plm.params.param("l0.wk"), Sharded) == (n == 2)
    tokens = np.arange(10, dtype=np.int64)[None, :] % hf["vocab_size"]
    got, _ = llm.forward(plm.params, torch.from_numpy(tokens), plm.cfg)
    want, _ = jax.jit(lambda p, t: jllm.forward(p, t, jlm.cfg))(
        jlm.params, jnp.asarray(tokens, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(got.numpy(), hf_forward_numpy(st, hf, tokens),
                               rtol=3e-4, atol=3e-4)


def test_hf_tokenizer_adapter_truncates():
    class FakeTok:
        bos_token_id = 1
        eos_token_id = 2

        def encode(self, text):
            return list(range(3, 3 + len(text)))

        def decode(self, ids, skip_special_tokens=True):
            return "x" * len(ids)

    for adapter in (phf.HFTokenizerAdapter(FakeTok(), max_seq=16),
                    jhf.HFTokenizerAdapter(FakeTok(), max_seq=16)):
        ids = adapter.encode("a" * 100)
        assert len(ids) == 14 and ids[0] == 1 and ids.dtype == np.int32
        assert adapter.decode([3, 4, 2, 5]) == "xx"


def test_mapped_tensors_are_materialized_before_upload(tmp_path):
    """Tensors read from a file are views of the mapping (nothing resident
    until touched) when their bytes are aligned, as in HF's files, whose
    header is padded with spaces to 8 bytes; the loader copies them before
    the upload. Off alignment (this repo's writers pad nothing) they are
    read as copies."""
    hf, st = state("llama_gqa")
    path = tmp_path / "model.safetensors"
    jhf.write_safetensors(str(path), st)
    raw = path.read_bytes()
    n = int.from_bytes(raw[:8], "little")
    pad = -n % 8
    path.write_bytes((n + pad).to_bytes(8, "little") + raw[8:8 + n]
                     + b" " * pad + raw[8 + n:])
    tensors = phf.read_safetensors(str(path))
    assert all(phf._mapped(t) for t in tensors.values())
    converted = phf.convert_hf_state(dict(tensors), phf.config_from_hf(hf))
    assert phf._mapped(converted["embed"])          # passed through
    assert not phf._mapped(converted["l0.wq"])      # transposed copy
    odd = tmp_path / "odd.safetensors"
    jhf.write_safetensors(str(odd), {"x": np.zeros((3,), np.float32)})
    if int.from_bytes(odd.read_bytes()[:8], "little") % 4:
        assert not phf._mapped(phf.read_safetensors(str(odd))["x"])


TOKENIZER_WORDS = ("<unk> <s> </s> the a is this scam bank code caller "
                   "customer agent your you call money gift card prize won "
                   "urgent account why it").split()
# one word per id of the checkpoints' 64-token vocabulary, so that every
# generated id decodes
TOKENIZER_WORDS += [f"w{i}" for i in range(len(TOKENIZER_WORDS), 64)]


def write_tokenizer(path) -> None:
    """A word-level tokenizer (``tokenizers``) that ``transformers`` loads
    from local files: ``tokenizer.json`` and ``tokenizer_config.json``."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    tok = Tokenizer(models.WordLevel(
        vocab={w: i for i, w in enumerate(TOKENIZER_WORDS)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(path / "tokenizer.json"))
    with open(path / "tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "bos_token": "<s>", "eos_token": "</s>",
                   "unk_token": "<unk>"}, f)


def test_directory_tokenizer_loads_and_equals_jax(tmp_path):
    """With tokenizer files in the directory, the loader wraps them in
    ``HFTokenizerAdapter`` (BOS first, decode stops at EOS), encoding as the
    JAX loader's does."""
    hf, st = state("llama_gqa")
    write_dir(tmp_path, hf, st)
    write_tokenizer(tmp_path)
    plm = phf.load_hf_checkpoint(str(tmp_path), max_seq=64,
                                 dtype=torch.float32, device="cpu")
    jlm = jhf.load_hf_checkpoint(str(tmp_path), max_seq=64,
                                 dtype=jnp.float32)
    assert isinstance(plm.tokenizer, phf.HFTokenizerAdapter)
    text = "why is this a scam call from your bank"
    ids = plm.tokenizer.encode(text)
    np.testing.assert_array_equal(ids, jlm.tokenizer.encode(text))
    assert ids[0] == 1 and ids.dtype == np.int32
    assert plm.tokenizer.decode([3, 4, 2, 5]) == jlm.tokenizer.decode([3, 4, 2, 5])


def test_small_vocab_generation_equals_jax(tmp_path):
    """A checkpoint whose vocabulary (64) is narrower than the byte
    tokenizer's BOS/EOS ids (256/257): JAX clamps those gather indices, and
    so does the port, so greedy tokens (finished rows feeding EOS back in)
    equal the JAX decoder's."""
    hf, st = state("gemma_mqa", seed=8)
    write_dir(tmp_path, hf, st)
    kw = dict(max_seq=64, tokenizer="byte", use_cache=False)
    plm = phf.load_hf_checkpoint(str(tmp_path), dtype=torch.float32,
                                 device="cpu", **kw)
    jlm = jhf.load_hf_checkpoint(str(tmp_path), dtype=jnp.float32, **kw)
    enc = [jlm.tokenizer.encode(p) for p in ("hi", "a longer prompt here")]
    np.testing.assert_array_equal(
        plm.generate_tokens_batch(enc, max_new_tokens=8),
        jlm.generate_tokens_batch(enc, max_new_tokens=8))
