"""The port's LLM trainer (``models/train_llm.py``) — twins of the twelve
tests of ``tests/test_train_llm.py``, and the trainer held against the JAX
package's on the CPU.

The port's meshes name the CPU device several times; the JAX side runs on
conftest's 8 virtual CPU devices. Tolerances: the dp x sp losses within the
reference's 3e-4 of the single-device fit (the dp x tp and dp ones too);
remat within its 1e-5; resume EQUAL array for array. Against JAX: the
initial weights within 1e-5 (the two erfinv's float32 rounding), three
optimizer steps of optax's ``chain(clip_by_global_norm, adamw(schedule))``
within rtol 1e-6 (float32 and bfloat16), and the loss trajectory of ``fit_language_model`` within
rtol 1e-4 (measured ~1.5e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fraud_detection_tpu.models import llm as jllm
from fraud_detection_tpu.models import train_llm as jtl
from fraud_detection_tpu_torch.models import llm
from fraud_detection_tpu_torch.models.llm import Sharded
from fraud_detection_tpu_torch.models.train_llm import (
    AdamW, LLMTrainConfig, OptState, batch_for_step, fit_language_model,
    make_optimizer, pack_corpus)
from fraud_detection_tpu_torch.parallel.mesh import Mesh
from tests.torch_parity import port_llm_config

JTINY = jllm.TransformerConfig(d_model=32, n_heads=4, n_layers=2, d_ff=64,
                               max_seq=128)
TINY = port_llm_config(JTINY)
CPU8 = np.array(["cpu"] * 8, dtype=object)

CORPUS = [
    "agent: hello this is the prize department calling about your winnings",
    "customer: i did not enter any lottery please remove me from your list",
    "agent: we just need a small processing fee paid with gift cards today",
    "customer: that sounds like a scam i am hanging up now goodbye",
] * 8


def fit(texts, cfg=TINY, tcfg=None, **kw):
    """The port's fit on the CPU (or on the mesh given)."""
    if "mesh" not in kw:
        kw["device"] = "cpu"
    return fit_language_model(texts, cfg, tcfg, **kw)


def mesh2d(names):
    return Mesh(CPU8.reshape(2, 4), names)


def test_pack_and_batch_are_deterministic():
    stream = pack_corpus(CORPUS, TINY)
    assert stream.dtype == np.int32 and stream.size > 100
    np.testing.assert_array_equal(stream, jtl.pack_corpus(CORPUS, JTINY))
    tcfg = LLMTrainConfig(batch_size=4, seq_len=32, seed=3)
    b1 = batch_for_step(stream, 7, tcfg)
    np.testing.assert_array_equal(b1, batch_for_step(stream, 7, tcfg))
    np.testing.assert_array_equal(
        b1, jtl.batch_for_step(stream, 7, jtl.LLMTrainConfig(**tcfg.__dict__)))
    assert b1.shape == (4, 33)
    assert not np.array_equal(b1, batch_for_step(stream, 8, tcfg))


def test_loss_decreases_single_device():
    tcfg = LLMTrainConfig(steps=30, batch_size=4, seq_len=32,
                          learning_rate=1e-2, warmup_steps=5, seed=1)
    lm, losses = fit(CORPUS, tcfg=tcfg)
    assert len(losses) == 30
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])
    assert isinstance(lm.generate_text("agent: hello", max_new_tokens=8), str)


def test_dp_tp_mesh_training_step_keeps_shardings():
    """(data 2, model 4): the split matrices stay split, a part a device,
    through the optimizer update, and the losses follow the single-device
    fit's."""
    tcfg = LLMTrainConfig(steps=4, batch_size=4, seq_len=16, seed=2)
    lm, losses = fit(CORPUS, tcfg=tcfg,
                     mesh=mesh2d((llm.DATA_AXIS, llm.MODEL_AXIS)))
    assert all(np.isfinite(losses))
    sh = llm.param_shardings(TINY, mesh2d((llm.DATA_AXIS, llm.MODEL_AXIS)))
    for name in ("l0.wq", "l1.w_down"):
        leaf = lm.params.param(name)
        assert isinstance(leaf, Sharded) and len(leaf.parts) == 4
        assert leaf.dim == sh[name].spec.index(llm.MODEL_AXIS)
    assert not isinstance(lm.params.param("embed"), Sharded)
    _, base = fit(CORPUS, tcfg=tcfg)
    np.testing.assert_allclose(losses, base, rtol=3e-4, atol=3e-4)


def test_remat_matches_no_remat():
    tcfg = LLMTrainConfig(steps=6, batch_size=2, seq_len=16, seed=4)
    _, base = fit(CORPUS, tcfg=tcfg)
    _, remat = fit(CORPUS, tcfg=LLMTrainConfig(**{**tcfg.__dict__,
                                                  "remat": True}))
    np.testing.assert_allclose(base, remat, rtol=1e-5)


def test_resume_is_bit_identical(tmp_path):
    tcfg = LLMTrainConfig(steps=12, batch_size=2, seq_len=16, decay_steps=12,
                          learning_rate=3e-3, warmup_steps=2, seed=5)
    full, _ = fit(CORPUS, tcfg=tcfg)
    ckpt = str(tmp_path / "lm")
    half = LLMTrainConfig(**{**tcfg.__dict__, "steps": 6})
    fit(CORPUS, tcfg=half, checkpoint_dir=ckpt, checkpoint_every=3)
    resumed, tail_losses = fit(CORPUS, tcfg=tcfg, checkpoint_dir=ckpt,
                               checkpoint_every=3)
    assert len(tail_losses) == 6  # only the remaining steps ran
    for k in full.params.param_names():
        assert torch.equal(full.params.param(k), resumed.params.param(k)), k


def test_resume_is_bit_identical_on_a_tp_mesh(tmp_path):
    """The sharded weights and moments go out whole and come back split."""
    mesh = mesh2d((llm.DATA_AXIS, llm.MODEL_AXIS))
    tcfg = LLMTrainConfig(steps=6, batch_size=4, seq_len=16, decay_steps=6,
                          learning_rate=3e-3, warmup_steps=2, seed=5)
    full, _ = fit(CORPUS, tcfg=tcfg, mesh=mesh)
    ckpt = str(tmp_path / "lm_tp")
    fit(CORPUS, tcfg=LLMTrainConfig(**{**tcfg.__dict__, "steps": 3}),
        mesh=mesh, checkpoint_dir=ckpt, checkpoint_every=3)
    resumed, tail = fit(CORPUS, tcfg=tcfg, mesh=mesh, checkpoint_dir=ckpt)
    assert len(tail) == 3
    for k in full.params.param_names():
        a, b = full.params.param(k), resumed.params.param(k)
        a, b = ((a.parts, b.parts) if isinstance(a, Sharded) else ([a], [b]))
        assert all(torch.equal(x, y) for x, y in zip(a, b)), k


def test_resume_refuses_different_corpus(tmp_path):
    tcfg = LLMTrainConfig(steps=4, batch_size=2, seq_len=16, seed=6)
    ckpt = str(tmp_path / "lm2")
    fit(CORPUS, tcfg=tcfg, checkpoint_dir=ckpt, checkpoint_every=2)
    with pytest.raises(ValueError, match="different setup"):
        fit(CORPUS[:8] + ["totally different text"],
            tcfg=LLMTrainConfig(**{**tcfg.__dict__, "steps": 8}),
            checkpoint_dir=ckpt)


def test_resume_refuses_overtrained_snapshot(tmp_path):
    tcfg = LLMTrainConfig(steps=6, batch_size=2, seq_len=16, decay_steps=6,
                          warmup_steps=2, seed=7)
    ckpt = str(tmp_path / "lm3")
    fit(CORPUS, tcfg=tcfg, checkpoint_dir=ckpt, checkpoint_every=3)
    with pytest.raises(ValueError, match="already trained"):
        fit(CORPUS, tcfg=LLMTrainConfig(**{**tcfg.__dict__, "steps": 3}),
            checkpoint_dir=ckpt)


def test_resume_refuses_different_mesh(tmp_path):
    tcfg = LLMTrainConfig(steps=4, batch_size=2, seq_len=16, decay_steps=4,
                          warmup_steps=1, seed=8)
    ckpt = str(tmp_path / "lm4")
    fit(CORPUS, tcfg=tcfg, checkpoint_dir=ckpt, checkpoint_every=2)
    with pytest.raises(ValueError, match="different setup"):
        fit(CORPUS, tcfg=LLMTrainConfig(**{**tcfg.__dict__, "steps": 8}),
            mesh=Mesh(CPU8[:2], (llm.DATA_AXIS,)), checkpoint_dir=ckpt)


def test_too_small_corpus_raises():
    with pytest.raises(ValueError, match="smaller than one"):
        fit(["hi"], tcfg=LLMTrainConfig(steps=1, batch_size=2, seq_len=128))


def test_window_sampling_reaches_stream_tail():
    stream = pack_corpus(CORPUS, TINY)
    tcfg = LLMTrainConfig(batch_size=64, seq_len=32, seed=0)
    tail = stream[-(tcfg.seq_len + 1):]
    for s in range(200):
        batch = batch_for_step(stream, s, tcfg)
        if any(np.array_equal(row, tail) for row in batch):
            return
    pytest.fail("no sampled window ever ended on the stream's last token")


@pytest.mark.parametrize("names", [(llm.DATA_AXIS, llm.SEQ_AXIS),
                                   (llm.DATA_AXIS,)])
def test_dp_sp_mesh_training_step(names):
    """(data 2, seq 4): ring attention inside the step, gradients through
    the rotation, the single-device loss trajectory (and plain data
    parallelism over 2 devices too)."""
    texts = [f"agent hello customer {i} this is a training transcript " * 3
             for i in range(20)]
    cfg = llm.TransformerConfig(d_model=32, n_heads=4, n_layers=1, d_ff=64,
                                max_seq=128)
    tcfg = LLMTrainConfig(steps=3, batch_size=4, seq_len=32, seed=5)
    _, base = fit(texts, cfg, tcfg)
    mesh = mesh2d(names) if len(names) == 2 else Mesh(CPU8[:2], names)
    _, sp = fit(texts, cfg, tcfg, mesh=mesh)
    assert all(np.isfinite(sp))
    np.testing.assert_allclose(sp, base, rtol=3e-4, atol=3e-4)


def test_sp_seq_len_divisibility_rejected():
    cfg = llm.TransformerConfig(d_model=32, n_heads=4, n_layers=1, d_ff=64,
                                max_seq=128)
    with pytest.raises(ValueError, match="seq_len"):
        fit(["some text to train on " * 10], cfg,
            LLMTrainConfig(steps=1, batch_size=2, seq_len=30),
            mesh=mesh2d((llm.DATA_AXIS, llm.SEQ_AXIS)))
    with pytest.raises(ValueError, match="batch_size 3"):
        fit(["some text to train on " * 10], cfg,
            LLMTrainConfig(steps=1, batch_size=3, seq_len=32),
            mesh=mesh2d((llm.DATA_AXIS, llm.SEQ_AXIS)))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 11])
def test_initial_weights_equal_jax(seed):
    cfg = jllm.TransformerConfig(d_model=32, n_heads=4, n_layers=2, d_ff=64,
                                 max_seq=128, tie_embeddings=False,
                                 n_kv_heads=2)
    want = jllm.init_params(jax.random.PRNGKey(seed), cfg)
    got = llm.init_params_threefry(port_llm_config(cfg), seed, "cpu")
    assert sorted(want) == sorted(got.param_names())
    for k, v in want.items():
        np.testing.assert_allclose(got.param(k).detach().numpy(),
                                   np.asarray(v), rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_optimizer_steps_equal_optax(clip, dtype):
    """Three updates of the port's AdamW against optax's chain on the same
    params and gradients: once clipped (global norm above 1.0), once not,
    across the warmup and into the cosine decay; in float32 and in
    bfloat16 (the moments in the params' dtype, as optax keeps them)."""
    tcfg = LLMTrainConfig(learning_rate=1e-2, warmup_steps=1, decay_steps=4,
                          grad_clip=clip, weight_decay=0.05)
    rng = np.random.default_rng(3)
    params = {"b": rng.normal(size=(3, 5)).astype(np.float32),
              "a": rng.normal(size=(7,)).astype(np.float32)}
    jopt = jtl.make_optimizer(jtl.LLMTrainConfig(**tcfg.__dict__))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jparams = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    jstate = jopt.init(jparams)
    opt = make_optimizer(tcfg)
    assert isinstance(opt, AdamW)
    pparams = {k: [torch.from_numpy(v.copy()).to(tdt)]
               for k, v in params.items()}
    state = opt.init(pparams)

    def host(t):
        return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
            else t.float().numpy()

    for step in range(3):
        grads = {k: (3 * rng.normal(size=v.shape)).astype(np.float32)
                 for k, v in params.items()}
        upd, jstate = jopt.update(
            {k: jnp.asarray(v).astype(jdt) for k, v in grads.items()},
            jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        state = opt.update(pparams, {k: [torch.from_numpy(v).to(tdt)]
                                     for k, v in grads.items()}, state)
        assert isinstance(state, OptState) and state.count == step + 1
        for k in params:
            np.testing.assert_allclose(host(pparams[k][0]), host(jparams[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} step {step}")
    leaves = jax.tree_util.tree_leaves(jstate)
    np.testing.assert_allclose(host(state.mu["a"][0]), host(leaves[1]),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(host(state.nu["b"][0]), host(leaves[4]),
                               rtol=1e-6, atol=1e-9)
    assert int(leaves[0]) == state.count and int(leaves[-1]) == state.sched_count


def test_loss_trajectory_and_snapshot_names_equal_jax(tmp_path):
    tcfg = jtl.LLMTrainConfig(steps=6, batch_size=4, seq_len=32,
                              learning_rate=1e-2, warmup_steps=2, seed=1)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _, want = jtl.fit_language_model(CORPUS, JTINY, tcfg, checkpoint_dir=jdir,
                                     checkpoint_every=3)
    _, got = fit(CORPUS, tcfg=LLMTrainConfig(**tcfg.__dict__),
                 checkpoint_dir=pdir, checkpoint_every=3)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    with np.load(f"{jdir}/arrays.npz") as j, np.load(f"{pdir}/arrays.npz") as p:
        assert sorted(j.files) == sorted(p.files)
        for k in j.files:
            assert j[k].shape == p[k].shape, k
            np.testing.assert_allclose(p[k], j[k], rtol=1e-3, atol=1e-5,
                                       err_msg=k)
