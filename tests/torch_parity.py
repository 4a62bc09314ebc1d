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


def warmed(pipe):
    """``pipe`` after one text and one raw-JSON message went through it: the
    native featurizer's library builds at first use (g++, seconds on a fresh
    checkout), and a fleet worker stuck in that build stops heartbeating,
    loses its lease and sees its batch replayed by the next owner."""
    pipe.predict(["warm up the featurizer"])
    pipe.predict_json_async([b'{"text": "warm up the raw JSON path"}'])
    return pipe


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


# Game-day gates whose verdict is a property of a run's data, not of its
# timing: a port run and a JAX run of one scenario at one seed and scale
# read the same on them.
STEADY_GATES = {"exact_accounting", "zero_loss", "spans_exact", "no_errors",
                "breaker_tripped", "explain_coverage", "explained_bit",
                "slot_accounting_exact", "prefix_shared",
                "paged_pool_capped", "hbm_saved", "zero_incidents",
                "worker_killed", "hot_swap_landed", "coordinator_killed",
                "control_zero_loss", "spec_conformance", "no_scale_out",
                "no_scale_in", "no_replace", "lifecycle_audited",
                "join_accounting_exact", "labels_joined_bit"}


def gameday_pipelines():
    """The JAX scenario tests' game-day pipeline (LR, 1,024 features, batch
    128, the separable corpus) and the port's twin of its arrays, warmed."""
    from fraud_detection_tpu.models.pipeline import synthetic_demo_pipeline
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline

    jp = synthetic_demo_pipeline(batch_size=128, n=300, seed=3,
                                 num_features=1024,
                                 corpus_kwargs=dict(hard_fraction=0.0,
                                                    label_noise=0.0))
    tp = ServingPipeline(port_featurizer(jp.featurizer), port_model(jp.model),
                         batch_size=128, device="cpu")
    return warmed(jp), warmed(tp)


def gameday_twins(name, seed, scale, pipelines, *, jax=True):
    """Run one catalog game day in the port (and, with ``jax``, in the JAX
    package) on ``pipelines``; the two runs must judge the same gates, plan
    the same rows and agree on every steady gate. Returns (jax, port)
    results."""
    from fraud_detection_tpu.scenarios import gameday as Jgd
    from fraud_detection_tpu_torch.scenarios import gameday as Tgd

    jp, tp = pipelines
    tres = Tgd.run_gameday(Tgd.get_scenario(name, seed, scale=scale),
                           pipeline=tp)
    if not jax:
        return None, tres
    jres = Jgd.run_gameday(Jgd.get_scenario(name, seed, scale=scale),
                           pipeline=jp)
    assert ([v.name for v in tres.report.verdicts]
            == [v.name for v in jres.report.verdicts])
    assert tres.evidence["planned"] == jres.evidence["planned"]
    assert tres.mode == jres.mode
    port = {v.name: v.ok for v in tres.report.verdicts
            if v.name in STEADY_GATES}
    ref = {v.name: v.ok for v in jres.report.verdicts
           if v.name in STEADY_GATES}
    assert port == ref, (port, ref, tres.table(), jres.table())
    return jres, tres
