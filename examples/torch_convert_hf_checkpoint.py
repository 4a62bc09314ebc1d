"""Serve a HuggingFace checkpoint on the card as the explanation LLM, on
the PyTorch port — twin of ``examples/convert_hf_checkpoint.py``.

Point this at a locally downloaded HF model directory (config.json +
*.safetensors [+ index] + tokenizer files) and it becomes the zero-egress
replacement for the reference's hosted DeepSeek round trip
(utils/agent_api.py:36,66): Llama/Mistral/Gemma-family decoders convert
into the port's parameter layout (checkpoint/hf_convert.py — GQA/MQA,
untied heads, Gemma's norm/scale/GeGLU quirks all handled).

Run:  python examples/torch_convert_hf_checkpoint.py /path/to/hf-model-dir
      python examples/torch_convert_hf_checkpoint.py /path/to/hf-model-dir --int8
      python examples/torch_convert_hf_checkpoint.py          # tiny synthetic demo
      ... --device cpu                                  # the plain torch versions

--int8 quantizes ON THE HOST before upload (bit-identical to an
after-load .quantized(), half the bytes through the device transfer) and
keeps a converted_q8 cache next to the checkpoint for warm reloads. On the
card its weight products launch the hand-written ``w8_matmul`` kernel; the
demo's prompts are far below the flash kernel's 512 tokens.
"""
import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def make_hf_config(*, gemma=False, n_kv=2):
    """A tiny HF ``config.json`` of the Llama (or Gemma) architecture."""
    hf = {
        "model_type": "gemma" if gemma else "llama",
        "vocab_size": 64,
        "hidden_size": 32,
        "num_attention_heads": 4,
        "num_key_value_heads": n_kv,
        "num_hidden_layers": 2,
        "intermediate_size": 48,
        "rope_theta": 10000.0,
        "rms_norm_eps": 1e-6,
        "hidden_act": "gelu_pytorch_tanh" if gemma else "silu",
        "tie_word_embeddings": gemma,
    }
    if gemma:
        hf["head_dim"] = 8  # == D/H here; exercises the config path
    return hf


def make_hf_state(hf, seed=0):
    """Random checkpoint in HF naming/shapes ((out, in) projections), drawn
    from ``np.random.default_rng(seed)`` in the JAX package's tests' order."""
    rng = np.random.default_rng(seed)
    D = hf["hidden_size"]; H = hf["num_attention_heads"]
    HKV = hf["num_key_value_heads"]; F = hf["intermediate_size"]
    d = hf.get("head_dim", D // H); V = hf["vocab_size"]
    r = lambda *s: (rng.normal(0, 0.08, s)).astype(np.float32)  # noqa: E731
    st = {"model.embed_tokens.weight": r(V, D),
          "model.norm.weight": r(D)}
    if not hf["tie_word_embeddings"]:
        st["lm_head.weight"] = r(V, D)
    for l in range(hf["num_hidden_layers"]):
        pre = f"model.layers.{l}."
        st[pre + "self_attn.q_proj.weight"] = r(H * d, D)
        st[pre + "self_attn.k_proj.weight"] = r(HKV * d, D)
        st[pre + "self_attn.v_proj.weight"] = r(HKV * d, D)
        st[pre + "self_attn.o_proj.weight"] = r(D, H * d)
        st[pre + "mlp.gate_proj.weight"] = r(F, D)
        st[pre + "mlp.up_proj.weight"] = r(F, D)
        st[pre + "mlp.down_proj.weight"] = r(D, F)
        st[pre + "input_layernorm.weight"] = r(D)
        st[pre + "post_attention_layernorm.weight"] = r(D)
    return st


def make_synthetic_checkpoint(d: str) -> str:
    """A tiny random Llama-architecture checkpoint so the demo runs without
    downloading anything (the conversion path is identical)."""
    import torch

    from fraud_detection_tpu_torch.checkpoint.hf_convert import write_safetensors

    hf = make_hf_config(gemma=False, n_kv=2)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf, f)
    write_safetensors(os.path.join(d, "model.safetensors"),
                      {k: torch.from_numpy(v)
                       for k, v in make_hf_state(hf, seed=7).items()})
    return d


def run(argv=None) -> dict:
    """Load the checkpoint (or the synthetic one) and generate one greedy
    reply; returns the reply and the exit code."""
    from examples.torch_serve_quickstart import device_arg
    from fraud_detection_tpu_torch.explain.onpod import OnPodBackend

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpt", nargs="?", help="HF model directory (default: a "
                                            "tiny synthetic checkpoint)")
    ap.add_argument("--int8", action="store_true")
    device_arg(ap)
    args = ap.parse_args(argv)
    if args.ckpt:
        # real dir: use its tokenizer
        backend = OnPodBackend.from_hf_checkpoint(args.ckpt, int8=args.int8,
                                                  device=args.device)
    else:
        with tempfile.TemporaryDirectory() as d:
            make_synthetic_checkpoint(d)
            from fraud_detection_tpu_torch.checkpoint.hf_convert import (
                load_hf_checkpoint)

            lm = load_hf_checkpoint(d, max_seq=128, tokenizer="byte",
                                    int8=args.int8, device=args.device)
            backend = OnPodBackend.from_model(lm)
            print("loaded synthetic checkpoint:",
                  f"{lm.cfg.n_layers} layers, d_model={lm.cfg.d_model},",
                  f"kv_heads={lm.cfg.kv_heads} (GQA)",
                  "[int8 weight-only]" if args.int8 else "")

    reply = backend.generate(
        "Classify this call: 'you won a prize, read me your SSN'.",
        temperature=0.0)
    print("backend reply (random weights => noise; real weights => analysis):")
    print(repr(reply[:200]))
    return {"reply": reply, "exit_code": 0}


def main(argv=None) -> int:
    return run(argv)["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
