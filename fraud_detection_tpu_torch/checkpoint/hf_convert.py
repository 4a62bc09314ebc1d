"""Hugging Face safetensors checkpoints -> ``models/llm.py`` weights — twin of
``fraud_detection_tpu/checkpoint/hf_convert.py``.

Given a locally downloaded checkpoint directory (config.json + *.safetensors
[+ tokenizer files]), ``load_hf_checkpoint`` builds the ``LanguageModel``
whose logits are the checkpoint's. Nothing is fetched.

* **No safetensors or ml_dtypes dependency.** The format is 8 bytes of header
  length, a JSON header and raw little-endian tensor bytes;
  ``read_safetensors`` / ``write_safetensors`` implement it over numpy and
  torch. A BF16 tensor is read as its uint16 bits and viewed as
  ``torch.bfloat16``, and written back as those bits.
* **RoPE basis permutation.** HF Llama/Gemma checkpoints pair dimension i
  with i + d/2 ("rotate_half"); ``models/llm.py``'s ``rope`` pairs (2i,
  2i+1). The converter permutes the head_dim axis of wq/wk, a basis change
  under which the attention scores are identical.
* **Architecture quirks become config or weights.** Gemma's (1 + w) RMSNorm
  is folded into the stored gains (in f32, rounded to nearest even, as the
  JAX converter does, so the two give the same bits); its sqrt(D) embedding
  scale and GeGLU are ``TransformerConfig`` fields; GQA/MQA widths land in
  ``n_kv_heads``; an untied head becomes ``lm_head``.

The converted-layout caches (``converted.fraud_tpu_cache``, and
``converted_q8.fraud_tpu_cache`` for int8 loads) are the JAX package's
format: the same names, meta, fingerprint and converter version, so a cache
either package writes loads in the other. ``mesh=`` places the loaded
weights tensor-parallel (``models/llm.py`` ``shard_params``).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from fraud_detection_tpu_torch.models.llm import (LanguageModel, Q8,
                                                  Transformer,
                                                  TransformerConfig,
                                                  quantize_params_host,
                                                  shard_params)
from fraud_detection_tpu_torch.utils.device import resolve_device

# safetensors dtype tag -> (torch dtype, numpy dtype of the same bytes)
_DTYPES = {
    "F64": (torch.float64, np.float64), "F32": (torch.float32, np.float32),
    "F16": (torch.float16, np.float16), "BF16": (torch.bfloat16, np.uint16),
    "I64": (torch.int64, np.int64), "I32": (torch.int32, np.int32),
    "I16": (torch.int16, np.int16), "I8": (torch.int8, np.int8),
    "U8": (torch.uint8, np.uint8), "BOOL": (torch.bool, np.bool_),
}
_TAGS = {t: tag for tag, (t, _) in _DTYPES.items()}


def _mapped(t: torch.Tensor) -> bool:
    """Whether ``t`` is (a view of) a tensor over a file mapping
    (``read_safetensors``)."""
    while t is not None:
        if getattr(t, "_from_mapping", False):
            return True
        t = t._base
    return False


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Parse one .safetensors file into {name: CPU tensor}.

    The data region is memory-mapped copy-on-write and each tensor is a view
    into the mapped pages: a multi-GB shard costs address space, not resident
    memory, until a tensor is touched (and only that tensor's pages). A
    tensor whose bytes sit off its type's alignment (the header length
    decides) is copied."""
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(header_len))
    base = 8 + header_len
    data = np.memmap(path, dtype=np.uint8, mode="c")
    out: Dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        dtype, np_dtype = _DTYPES[meta["dtype"]]
        arr = data[base + start: base + end].view(np_dtype)
        if not arr.flags.aligned:
            arr = arr.copy()
        root = torch.from_numpy(arr)
        root._from_mapping = arr.base is not None
        t = root.view(dtype) if dtype == torch.bfloat16 else root
        out[name] = t.reshape(meta["shape"])
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Write {name: tensor} as a .safetensors file, byte for byte the JAX
    package's writer's output (header in insertion order, no metadata);
    tensors are written one at a time."""
    header: Dict[str, dict] = {}
    offset = 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    hdr = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(hdr).to_bytes(8, "little"))
        f.write(hdr)
        for t in tensors.values():
            f.write(memoryview(t.contiguous().reshape(-1).view(torch.uint8)
                               .numpy()))


def read_checkpoint_tensors(ckpt_dir: str) -> Dict[str, torch.Tensor]:
    """All tensors of a checkpoint dir, following the sharding index when
    present (model.safetensors.index.json -> weight_map)."""
    index = os.path.join(ckpt_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map: Dict[str, str] = json.load(f)["weight_map"]
        out: Dict[str, torch.Tensor] = {}
        for fname in sorted(set(weight_map.values())):
            out.update(read_safetensors(os.path.join(ckpt_dir, fname)))
        return out
    single = os.path.join(ckpt_dir, "model.safetensors")
    if os.path.exists(single):
        return read_safetensors(single)
    cands = [f for f in os.listdir(ckpt_dir) if f.endswith(".safetensors")]
    if len(cands) == 1:
        return read_safetensors(os.path.join(ckpt_dir, cands[0]))
    raise FileNotFoundError(
        f"no model.safetensors(.index.json) in {ckpt_dir!r} (found {cands})")


def config_from_hf(hf: dict, *, max_seq: int = 4096,
                   dtype: Optional[torch.dtype] = None) -> TransformerConfig:
    """Map an HF config.json dict onto TransformerConfig (bfloat16 unless
    ``dtype``).

    Handles the Llama family (llama/mistral/deepseek) and Gemma; other model
    types raise so that a silent architecture mismatch cannot ship: qwen2
    (mandatory q/k/v biases), gemma2 (extra norms, logit softcapping) and
    deepseek_v2 (MLA attention) would fail late or convert wrong."""
    mtype = hf.get("model_type", "llama")
    if mtype not in ("llama", "mistral", "deepseek", "gemma"):
        raise NotImplementedError(
            f"model_type {mtype!r} is not a supported architecture "
            "(Llama-family and Gemma-1 checkpoints map onto models/llm.py)")
    act = hf.get("hidden_act", "silu")
    if act in ("silu", "swish"):
        activation = "silu"
    elif act in ("gelu", "gelu_new", "gelu_pytorch_tanh"):
        activation = "gelu"
    else:
        raise NotImplementedError(f"hidden_act {act!r} unsupported")
    d_model = int(hf["hidden_size"])
    n_heads = int(hf["num_attention_heads"])
    gemma = mtype.startswith("gemma")
    head_dim = hf.get("head_dim")
    return TransformerConfig(
        vocab_size=int(hf["vocab_size"]),
        d_model=d_model,
        n_heads=n_heads,
        n_layers=int(hf["num_hidden_layers"]),
        d_ff=int(hf["intermediate_size"]),
        max_seq=max_seq,
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        dtype=dtype if dtype is not None else torch.bfloat16,
        n_kv_heads=int(hf.get("num_key_value_heads", n_heads)),
        head_dim_override=None if head_dim is None else int(head_dim),
        activation=activation,
        embed_scale=math.sqrt(d_model) if gemma else 1.0,
        tie_embeddings=bool(hf.get("tie_word_embeddings", gemma)),
        rms_eps=float(hf.get("rms_norm_eps", 1e-6)),
    )


def _rope_permutation(d: int) -> torch.Tensor:
    """Index map half-split -> interleaved: new[2i]=old[i], new[2i+1]=old[i+d/2]."""
    perm = torch.empty(d, dtype=torch.int64)
    perm[0::2] = torch.arange(d // 2)
    perm[1::2] = torch.arange(d // 2) + d // 2
    return perm


def convert_hf_state(state: Dict[str, torch.Tensor],
                     cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """HF Llama/Gemma-layout state dict -> ``models/llm.py`` parameter dict
    (host tensors in the checkpoint's dtype, in the JAX package's layout).
    Consumes ``state``; refuses tensors it cannot map (attention biases and
    the like) instead of dropping them."""
    h, hkv, d, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
    perm = _rope_permutation(d)
    gemma = cfg.embed_scale != 1.0

    def take(name: str) -> torch.Tensor:
        # stays in the checkpoint's dtype (often bf16 views of the mapping)
        try:
            return state.pop(name)
        except KeyError:
            raise KeyError(f"checkpoint is missing tensor {name!r}") from None

    def norm(w: torch.Tensor) -> torch.Tensor:
        # Gemma stores gamma - 1 (applies x * (1 + w)); fold the offset in,
        # in f32 so that bf16 gains near -1 keep their bits
        return (w.float() + 1.0).to(w.dtype) if gemma else w

    p: Dict[str, torch.Tensor] = {"embed": take("model.embed_tokens.weight")}
    if not cfg.tie_embeddings:
        p["lm_head"] = take("lm_head.weight")
    else:
        state.pop("lm_head.weight", None)  # some exports duplicate the tie
    for l in range(cfg.n_layers):
        pre = f"model.layers.{l}."
        # HF projections are (out, in); ours are input-major
        wq = take(pre + "self_attn.q_proj.weight").T.reshape(D, h, d)
        wk = take(pre + "self_attn.k_proj.weight").T.reshape(D, hkv, d)
        p[f"l{l}.wq"] = wq[:, :, perm]
        p[f"l{l}.wk"] = wk[:, :, perm]
        p[f"l{l}.wv"] = take(pre + "self_attn.v_proj.weight").T.reshape(D, hkv, d)
        p[f"l{l}.wo"] = take(pre + "self_attn.o_proj.weight").T.reshape(h, d, D)
        p[f"l{l}.w_gate"] = take(pre + "mlp.gate_proj.weight").T
        p[f"l{l}.w_up"] = take(pre + "mlp.up_proj.weight").T
        p[f"l{l}.w_down"] = take(pre + "mlp.down_proj.weight").T
        p[f"l{l}.ln1"] = norm(take(pre + "input_layernorm.weight"))
        p[f"l{l}.ln2"] = norm(take(pre + "post_attention_layernorm.weight"))
    p["ln_f"] = norm(take("model.norm.weight"))
    if state:
        raise NotImplementedError(
            "unconverted tensors remain (unsupported architecture details, "
            f"e.g. attention biases): {sorted(state)[:8]}")
    return p


# ---------------------------------------------------------------------------
# converted-layout cache
# ---------------------------------------------------------------------------
#
# The conversion transposes and reshapes every projection out of the mapped
# shards before anything reaches the card. That cost is waste after the
# first load, so the converted tensors are written once (contiguous, already
# in models/llm.py layout) next to the HF dir, keyed by a fingerprint of the
# source (config bytes + shard names/sizes/mtimes). Warm loads map the cache
# and go straight to the upload.

_CACHE_NAME = "converted.fraud_tpu_cache"  # not .safetensors: must never be
#                                            picked up as a checkpoint shard

#: The JAX package's converter version: the two converters give the same
#: layout, so a cache either writes serves both. Bump both together.
_CONVERTER_VERSION = 1


def _converted_cache_paths(ckpt_dir: str, *, create: bool = False,
                           variant: str = ""):
    """(tensor_file, meta_file) for the converted cache: next to the HF dir
    when writable, under ~/.cache/fraud_tpu_converted/<dirhash> otherwise.
    ``create`` makes the fallback directory (the write path only).
    ``variant`` names an alternate converted layout ("q8": host-quantized
    int8, half the bytes to read and upload)."""
    import hashlib

    stem, dot, ext = _CACHE_NAME.partition(".")
    name = f"{stem}_{variant}{dot}{ext}" if variant else _CACHE_NAME
    if os.access(ckpt_dir, os.W_OK):
        base = os.path.join(ckpt_dir, name)
    else:
        tag = hashlib.sha256(
            os.path.abspath(ckpt_dir).encode()).hexdigest()[:16]
        d = os.path.join(os.path.expanduser("~/.cache/fraud_tpu_converted"),
                         tag)
        if create:
            os.makedirs(d, exist_ok=True)
        base = os.path.join(d, name)
    return base, base + ".json"


def _source_fingerprint(ckpt_dir: str) -> str:
    """Hash of everything the conversion reads: config.json bytes plus the
    (name, size, mtime_ns) of every safetensors shard."""
    import hashlib

    h = hashlib.sha256()
    with open(os.path.join(ckpt_dir, "config.json"), "rb") as f:
        h.update(f.read())
    for fn in sorted(os.listdir(ckpt_dir)):
        if fn.endswith(".safetensors"):
            st = os.stat(os.path.join(ckpt_dir, fn))
            h.update(f"{fn}:{st.st_size}:{st.st_mtime_ns}".encode())
    return h.hexdigest()


def _valid_cache_file(ckpt_dir: str, variant: str = "",
                      require: Optional[dict] = None) -> Optional[str]:
    """Path of a valid converted cache (fingerprint and converter version
    match, tensor file present), else None: the one validity check of
    ``load_hf_checkpoint`` and ``has_converted_cache``. ``require``: extra
    meta key/values that must match (a q8 cache bakes in its compute dtype,
    ``{"quant_dtype": ...}``)."""
    cache_f, meta_f = _converted_cache_paths(ckpt_dir, variant=variant)
    try:
        with open(meta_f) as f:
            meta = json.load(f)
        if (meta.get("fingerprint") == _source_fingerprint(ckpt_dir)
                and meta.get("converter_version") == _CONVERTER_VERSION
                and all(meta.get(k) == v for k, v in (require or {}).items())
                and os.path.exists(cache_f)):
            return cache_f
    except (OSError, ValueError):
        pass
    return None


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a dtype ("bfloat16", "float32"), the caches' meta."""
    return str(dtype).removeprefix("torch.")


def has_converted_cache(ckpt_dir: str, variant: str = "",
                        quant_dtype=None) -> bool:
    """True when a valid converted cache exists. ``variant="q8"`` asks about
    the int8 load's cache; pass the load's ``quant_dtype`` (the model dtype)
    to ask the loader's exact question: a q8 cache bakes its compute dtype
    into the codes."""
    require = ({"quant_dtype": _dtype_name(quant_dtype)}
               if quant_dtype is not None else None)
    return _valid_cache_file(ckpt_dir, variant, require) is not None


class HFTokenizerAdapter:
    """A transformers tokenizer behind the ByteTokenizer protocol (encode ->
    int32 ids with BOS, clamped to max_seq; decode stops at EOS), loaded from
    local files only."""

    def __init__(self, tok, max_seq: int = 4096):
        self.tok = tok
        self.max_seq = max_seq

    @classmethod
    def from_dir(cls, ckpt_dir: str, max_seq: int = 4096) -> "HFTokenizerAdapter":
        from transformers import AutoTokenizer

        return cls(AutoTokenizer.from_pretrained(ckpt_dir, local_files_only=True),
                   max_seq=max_seq)

    def encode(self, text: str) -> np.ndarray:
        ids = self.tok.encode(text)
        if self.tok.bos_token_id is not None and (
                not ids or ids[0] != self.tok.bos_token_id):
            ids = [self.tok.bos_token_id] + ids
        # ByteTokenizer's bound: an unclamped transcript would size the KV
        # cache and the prefill
        return np.asarray(ids[: self.max_seq - 2], np.int32)

    def decode(self, tokens) -> str:
        ids = []
        for t in np.asarray(tokens).tolist():
            if t == self.tok.eos_token_id:
                break
            ids.append(int(t))
        return self.tok.decode(ids, skip_special_tokens=True)


_Q8_KEY, _Q8_SCALE_KEY = "::q8", "::q8_scale"   # "::" never occurs in param names


def _flatten_q8(params: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """{name: tensor | Q8} -> flat safetensors-writable {name: tensor}."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in params.items():
        if isinstance(v, Q8):
            out[k + _Q8_KEY] = v.q
            out[k + _Q8_SCALE_KEY] = v.scale
        else:
            out[k] = v
    return out


def _unflatten_q8(tensors: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """Inverse of ``_flatten_q8`` (raises KeyError on a q8 half-pair, which
    the loader treats as a corrupt cache)."""
    out: Dict[str, object] = {}
    for k, v in tensors.items():
        if k.endswith(_Q8_SCALE_KEY):
            continue
        elif k.endswith(_Q8_KEY):
            name = k[: -len(_Q8_KEY)]
            out[name] = Q8(v, tensors[name + _Q8_SCALE_KEY])
        else:
            out[k] = v
    return out


def _write_cache(ckpt_dir: str, params: Dict[str, object], variant: str,
                 meta_extra: Optional[dict]) -> None:
    """Tensors first, the meta (the validity marker) last and atomically: a
    kill mid-write cannot leave a valid-looking cache. An unwritable or full
    disk leaves no partial files behind (the cache is an optimization)."""
    cache_f, meta_f = _converted_cache_paths(ckpt_dir, create=True,
                                             variant=variant)
    try:
        write_safetensors(cache_f + ".tmp",
                          _flatten_q8(params) if variant else params)
        os.replace(cache_f + ".tmp", cache_f)
        tmp = meta_f + ".tmp"
        meta = {"fingerprint": _source_fingerprint(ckpt_dir),
                "converter_version": _CONVERTER_VERSION, **(meta_extra or {})}
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, meta_f)
    except OSError:
        for leftover in (cache_f + ".tmp", meta_f + ".tmp", cache_f):
            try:
                os.unlink(leftover)
            except OSError:
                pass


def load_hf_checkpoint(ckpt_dir: str, *, max_seq: int = 4096,
                       dtype: Optional[torch.dtype] = None, mesh=None,
                       tokenizer: Optional[object] = None,
                       use_cache: bool = True, int8: bool = False,
                       load_info: Optional[dict] = None,
                       device="cuda") -> LanguageModel:
    """Directory of a downloaded HF checkpoint -> ready ``LanguageModel`` on
    ``device``; ``OnPodBackend.from_model(load_hf_checkpoint(dir))`` serves
    it.

    ``use_cache``: reuse (and on a miss, write) the converted-layout cache.
    ``int8``: weight-only int8 quantized on the host before the upload; the
    model equals ``load_hf_checkpoint(dir).quantized()`` bit for bit but
    ships half the bytes. It keeps its own cache variant ("q8"), and an int8
    miss reuses a valid bf16 cache without reconverting.
    ``load_info``: receives ``source``, the tier the weights came from
    ("q8_cache" | "bf16_cache" | "hf_shards"), set where it happened.
    ``tokenizer``: None loads the directory's tokenizer (``transformers``,
    local files) and raises ValueError if it cannot; ``"byte"`` takes the
    byte-level tokenizer explicitly; anything else is used as given.
    ``mesh``: the weights go up to the mesh's first device (``device`` is
    not read) and are placed on its "model" axis in the Megatron layout
    (``models/llm.py`` ``shard_params``; int8 leaves shard componentwise)."""
    dev = mesh.home if mesh is not None else resolve_device(device)
    info = load_info if load_info is not None else {}
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        cfg = config_from_hf(json.load(f), max_seq=max_seq, dtype=dtype)
    variant = "q8" if int8 else ""
    require = {"quant_dtype": _dtype_name(cfg.dtype)} if int8 else None
    params = None
    if use_cache:
        valid = _valid_cache_file(ckpt_dir, variant, require)
        if valid is not None:
            try:
                raw = read_safetensors(valid)
                params = _unflatten_q8(raw) if int8 else raw
                info["source"] = "q8_cache" if int8 else "bf16_cache"
            except (OSError, ValueError, KeyError):
                params = None
    if params is None:
        if use_cache and int8:
            # int8 miss, bf16 cache hit: quantize the cached layout
            bf16_cache = _valid_cache_file(ckpt_dir)
            if bf16_cache is not None:
                try:
                    params = read_safetensors(bf16_cache)
                    info["source"] = "bf16_cache"
                except (OSError, ValueError):
                    params = None
        if params is None:
            params = convert_hf_state(read_checkpoint_tensors(ckpt_dir), cfg)
            info["source"] = "hf_shards"
        if int8:
            params = quantize_params_host(params, compute_dtype=cfg.dtype)
        if use_cache:
            _write_cache(ckpt_dir, params, variant, require)

    def materialize(t: torch.Tensor) -> torch.Tensor:
        # mapped tensors come into memory first: an upload straight from the
        # mapping page-faults through the copy
        return t.clone() if _mapped(t) else t

    def to_device(v):
        if isinstance(v, Q8):
            # int8 and the f32 scale go up at their own widths
            return Q8(materialize(v.q).to(dev),
                      materialize(v.scale).to(dev, torch.float32))
        return materialize(v).to(dev, cfg.dtype)

    model = Transformer.from_leaves(cfg, {k: to_device(v)
                                          for k, v in params.items()})
    if mesh is not None:
        model = shard_params(model, cfg, mesh)
    if tokenizer == "byte":
        tokenizer = None  # the byte-level tokenizer, asked for explicitly
    elif tokenizer is None:
        # never fall back to bytes silently: byte ids against a learned
        # vocabulary generate fluent-looking garbage with no error
        try:
            tokenizer = HFTokenizerAdapter.from_dir(ckpt_dir, max_seq=max_seq)
        except Exception as e:
            raise ValueError(
                f"could not load a tokenizer from {ckpt_dir!r} ({e}); pass "
                "tokenizer=<object with encode/decode> or tokenizer='byte' "
                "to explicitly use the byte-level tokenizer") from e
    return LanguageModel(cfg, model, tokenizer=tokenizer)
