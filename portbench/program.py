"""The system under test, built from a configuration file: the port's decoder
at the configuration's widths, holding the weights the benchmark drew.

This is the only module besides the drivers that imports the program
(``fraud_detection_tpu_torch``).
"""

from __future__ import annotations

from typing import Dict

import torch

from weights import DTYPES


def transformer_config(cfg: Dict):
    from fraud_detection_tpu_torch.models.llm import TransformerConfig
    d_model, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    if cfg["hidden_act"] != "silu":
        raise ValueError(f"unsupported activation {cfg['hidden_act']!r}")
    return TransformerConfig(
        vocab_size=cfg["vocab_size"], d_model=d_model, n_heads=heads,
        n_layers=cfg["num_hidden_layers"], d_ff=cfg["intermediate_size"],
        max_seq=cfg["max_position_embeddings"], rope_theta=cfg["rope_theta"],
        dtype=DTYPES[cfg["dtype"]], n_kv_heads=cfg["num_key_value_heads"],
        head_dim_override=(None if cfg["head_dim"] * heads == d_model
                           else cfg["head_dim"]),
        activation="silu", tie_embeddings=cfg["tie_word_embeddings"],
        rms_eps=cfg["rms_norm_eps"])


def language_model(cfg: Dict, leaves: Dict[str, torch.Tensor]):
    """The port's ``LanguageModel`` over ``leaves``."""
    from fraud_detection_tpu_torch.models.llm import LanguageModel, Transformer
    tcfg = transformer_config(cfg)
    return LanguageModel(tcfg, Transformer.from_leaves(tcfg, leaves))
