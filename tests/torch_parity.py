"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py):
carry a JAX pipeline's or language model's arrays across to the port, and
run the JAX package's Pallas featurize kernel in interpret mode as the
reference.
"""

import numpy as np
import pytest
import torch

from fraud_detection_tpu_torch import convert
from fraud_detection_tpu_torch.models import llm as port_llm_module

# The port's CPU tests run tiny tensors; one intra-op thread per test worker
# keeps torch from oversubscribing the cores the other workers' tests share.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pallas_store():
    """The JAX featurize kernel calls ``pl.store``, an alias that newer jax
    releases dropped from ``jax.experimental.pallas``. For this module's
    tests the alias points at jax's own store primitive (the function the
    alias named), so the unchanged JAX kernel runs in interpret mode as the
    reference; it is removed again afterwards."""
    from jax._src.pallas import primitives
    from jax.experimental import pallas as pl

    added = not hasattr(pl, "store")
    if added:
        pl.store = primitives.store
    yield
    if added:
        del pl.store


def port_featurizer(jfeat, legacy: bool = False):
    """The port's twin of a JAX ``HashingTfIdfFeaturizer``."""
    return convert.featurizer_from_arrays(
        jfeat.num_features,
        None if jfeat.idf is None else np.asarray(jfeat.idf),
        jfeat.binary_tf, jfeat.stop_filter.words,
        jfeat.stop_filter.case_sensitive, jfeat.remove_stopwords,
        legacy=legacy)


def port_model(jmodel, device="cpu"):
    """The port's twin of a JAX LogisticRegression or TreeEnsemble."""
    if hasattr(jmodel, "weights"):
        return convert.logistic_from_arrays(
            np.asarray(jmodel.weights), np.asarray(jmodel.intercept),
            jmodel.threshold, device=device)
    return convert.trees_from_arrays(
        np.asarray(jmodel.feature), np.asarray(jmodel.threshold),
        np.asarray(jmodel.left), np.asarray(jmodel.right),
        np.asarray(jmodel.leaf), np.asarray(jmodel.tree_weights),
        kind=jmodel.kind, max_depth=jmodel.max_depth, bias=jmodel.bias,
        device=device)


def port_llm_config(jcfg):
    """The port's twin of a JAX ``TransformerConfig`` (float32 or bfloat16)."""
    dtype = {"float32": torch.float32,
             "bfloat16": torch.bfloat16}[np.dtype(jcfg.dtype).name]
    return port_llm_module.TransformerConfig(
        vocab_size=jcfg.vocab_size, d_model=jcfg.d_model,
        n_heads=jcfg.n_heads, n_layers=jcfg.n_layers, d_ff=jcfg.d_ff,
        max_seq=jcfg.max_seq, rope_theta=jcfg.rope_theta, dtype=dtype,
        n_kv_heads=jcfg.n_kv_heads, head_dim_override=jcfg.head_dim_override,
        activation=jcfg.activation, embed_scale=jcfg.embed_scale,
        tie_embeddings=jcfg.tie_embeddings, rms_eps=jcfg.rms_eps)


def port_llm(jlm, device="cpu"):
    """The port's twin of a JAX ``LanguageModel``: the same weights, carried
    across with ``convert.llm_params_from_arrays``."""
    cfg = port_llm_config(jlm.cfg)
    params = convert.llm_params_from_arrays(
        cfg, {k: np.asarray(v) for k, v in jlm.params.items()}, device=device)
    return port_llm_module.LanguageModel(cfg, params)
