"""The explanation LLM at one process per device, on the CPU: two real
``torch.distributed`` processes over ``gloo`` on localhost (the harness of
``tests/test_torch_mesh_multihost.py``, each subprocess under its own
timeout), two CPU entries of a mesh each.

* ``fit_language_model`` over meshes whose first axis spans both processes
  — ("model",), ("data",), ("data", "model"), ("data", "seq") with the ring
  and with Ulysses, and ("seq",) with both — gives the losses and final
  weights of the one-process fit on the same global mesh within the mesh
  fits' 3e-4 (``tests/test_torch_train_llm.py``), and those of the JAX
  package's fit on the same mesh shape (its ring for Ulysses: the
  reference trains on the ring) within the same bound; every weight,
  split ones gathered, is the same bits on both processes. The fits take
  full steps (lr 1e-2 from the first step), and since AdamW and the global
  clip do not see a gradient's scale, the first step's raw gradients
  (every leaf, after the step's sums over the processes) are held against
  the one-process mesh's too;
* a two-process fit cut and resumed equals the uninterrupted one bit for
  bit, and its snapshot is refused by a one-process fit;
* ``forward(seq_mesh=)`` and ``ulysses_attention`` with the batch axis and
  with the sequence axis across the processes equal one process's within
  the reference's 3e-4 and 2e-5, and the JAX package's.

The two processes run while this process computes the references.
"""

import json
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from fraud_detection_tpu.models import llm as jllm
from fraud_detection_tpu.models import train_llm as jtl
from fraud_detection_tpu_torch.models import llm
from fraud_detection_tpu_torch.models import train_llm as TL
from fraud_detection_tpu_torch.models.llm import Sharded
from fraud_detection_tpu_torch.models.train_llm import (LLMTrainConfig,
                                                        fit_language_model)
from fraud_detection_tpu_torch.parallel.mesh import Mesh
from tests.test_torch_mesh_multihost import _run_two_process

FIT_TOL, MODE_TOL, ATTN_TOL = 3e-4, 3e-4, 2e-5
CORPUS = [
    "agent: hello this is the prize department calling about your winnings",
    "customer: i did not enter any lottery please remove me from your list",
    "agent: we just need a small processing fee paid with gift cards today",
    "customer: that sounds like a scam i am hanging up now goodbye",
] * 4
# 2 K/V heads: split over a 2-way model axis, replicated over a 4-way one
CFG = dict(d_model=32, n_heads=4, n_kv_heads=2, n_layers=1, d_ff=64,
           max_seq=128)
# warmup 0 and the cosine over the run: each step moves the weights by about
# the learning rate, 1e-2, far beyond FIT_TOL
TCFG = dict(steps=3, batch_size=4, seq_len=16, seed=2, learning_rate=1e-2,
            warmup_steps=0, decay_steps=3)
# the first step's gradients against the one-process mesh's: within
# GRAD_TOL of each leaf's largest |gradient| (f32 sums in another order)
GRAD_TOL = 1e-5
# (label, axis names, one process's grid, sp_impl): each mesh spans both
# processes along its first axis
FITS = (("model", ("model",), (2,), "ring"),
        ("model_kv_split", ("model",), (1,), "ring"),
        ("data", ("data",), (2,), "ring"),
        ("data_model", ("data", "model"), (1, 2), "ring"),
        ("data_seq_ring", ("data", "seq"), (1, 2), "ring"),
        ("data_seq_ulysses", ("data", "seq"), (1, 2), "ulysses"),
        ("seq_ring", ("seq",), (2,), "ring"),
        ("seq_ulysses", ("seq",), (2,), "ulysses"))
RESUME = (("model", ("model",), (2,)), ("data", ("data",), (2,)))
FWD_T = 32
# (label, axis names, one process's grid, batch axis): the sequence-parallel
# forward with the batch axis, then the sequence axis, across the processes
SP_CASES = (("batch", ("data", "seq"), (1, 2), "data"),
            ("seq", ("seq",), (2,), None))

_CHILD = r'''
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from fraud_detection_tpu_torch.models import llm
from fraud_detection_tpu_torch.models import train_llm as TL
from fraud_detection_tpu_torch.models.llm import Sharded
from fraud_detection_tpu_torch.models.train_llm import (LLMTrainConfig,
                                                        fit_language_model)
from fraud_detection_tpu_torch.parallel.mesh import Mesh, initialize_distributed

assert initialize_distributed(timeout_s=60)
rank = torch.distributed.get_rank()
spec = json.loads(sys.argv[1])
out = spec["dir"]
cfg = llm.TransformerConfig(**spec["cfg"])


def mesh(names, local):
    grid = np.array(["cpu"] * int(np.prod(local)), object).reshape(local)
    return Mesh(grid, names, process_count=2, process_index=rank,
                group=torch.distributed.group.WORLD)


def save(name, lm):
    np.savez(f"{out}/{name}.{rank}.npz", **{
        k: (v.gather() if isinstance(v, Sharded) else v).float().numpy()
        for k, v in ((k, lm.params.param(k)) for k in lm.params.param_names())})


def first_grads(corpus, cfg, tcfg, m, impl):
    """The first step's gradient of every leaf, split ones gathered."""
    rows = TL._rows(m, "cpu")
    master = TL._init_master(cfg, tcfg, m, rows)
    windows = TL.batch_for_step(TL.pack_corpus(corpus, cfg), 0, tcfg)
    grads, _ = TL._step_grads(master, windows, cfg, tcfg, rows, m, impl)
    return {k: TL._whole(g, master[k]).float().numpy()
            for k, g in grads.items()}


res = {}
tcfg = LLMTrainConfig(**spec["tcfg"])
for label, names, local, impl in spec["fits"]:
    lm, res[label] = fit_language_model(spec["corpus"], cfg, tcfg,
                                        mesh=mesh(names, local), sp_impl=impl)
    save(label, lm)
    np.savez(f"{out}/grads_{label}.{rank}.npz",
             **first_grads(spec["corpus"], cfg, tcfg, mesh(names, local), impl))

# cut after one step and resumed, against the uninterrupted fit
for label, names, local in spec["resume"]:
    ckpt = f"{out}/ckpt_{label}"
    m = mesh(names, local)
    full, _ = fit_language_model(spec["corpus"], cfg, tcfg, mesh=m)
    fit_language_model(spec["corpus"], cfg,
                       LLMTrainConfig(**{**spec["tcfg"], "steps": 1}),
                       mesh=m, checkpoint_dir=ckpt, checkpoint_every=1)
    again, tail = fit_language_model(spec["corpus"], cfg, tcfg, mesh=m,
                                     checkpoint_dir=ckpt, checkpoint_every=1)
    same = len(tail) == tcfg.steps - 1
    for k in full.params.param_names():
        a, b = full.params.param(k), again.params.param(k)
        a, b = (a.parts, b.parts) if isinstance(a, Sharded) else ([a], [b])
        same = same and all(torch.equal(x, y) for x, y in zip(a, b))
    res[f"resume_{label}"] = same

# sum_in_rank_order in buckets of 7 elements: tensors that share one, a
# tensor wider than one, and a second dtype
import fraud_detection_tpu_torch.parallel.mesh as M
M.SUM_BUCKET = 7
ts = [torch.arange(n).to(dt) * (rank + 1) + 0.5
      for n, dt in ((3, torch.float32), (5, torch.float32),
                    (20, torch.float32), (4, torch.bfloat16))]
M.sum_in_rank_order(ts, mesh(("data",), (1,)))
res["rank_order_sums"] = [t.float().tolist() for t in ts]

params = llm.init_params_threefry(cfg, 0, "cpu")
rng = np.random.default_rng(4)
toks = torch.from_numpy(rng.integers(0, 256, (4, spec["T"])))
q = torch.from_numpy(rng.normal(size=(4, spec["T"], 4, 8)).astype(np.float32))
k, v = (torch.from_numpy(rng.normal(size=(4, spec["T"], 2, 8))
                         .astype(np.float32)) for _ in range(2))
arrays = {}
for label, names, local, b_axis in spec["sp"]:
    m = mesh(names, local)
    for impl in ("ring", "ulysses"):
        with torch.inference_mode():
            arrays[f"{label}_{impl}"] = llm.forward(
                params, toks, cfg, seq_mesh=m, sp_impl=impl)[0].numpy()
    arrays[f"{label}_attn"] = llm.ulysses_attention(
        q, k, v, m, batch_axis=b_axis).numpy()
np.savez(f"{out}/forward.{rank}.npz", **arrays)
print("RESULT", json.dumps(res), flush=True)
torch.distributed.destroy_process_group()
'''


def _port_mesh(names, local):
    """The one-process twin of a two-process mesh: the global grid."""
    grid = (2 * local[0],) + tuple(local[1:])
    return Mesh(np.array(["cpu"] * int(np.prod(grid)), object).reshape(grid),
                names)


def _first_grads(names, local, impl) -> dict:
    """The first step's gradient of every leaf on the one-process mesh, as
    the child's ``first_grads`` takes it on the two-process one."""
    cfg, tcfg = llm.TransformerConfig(**CFG), LLMTrainConfig(**TCFG)
    mesh = _port_mesh(names, local)
    rows = TL._rows(mesh, "cpu")
    master = TL._init_master(cfg, tcfg, mesh, rows)
    windows = TL.batch_for_step(TL.pack_corpus(CORPUS, cfg), 0, tcfg)
    grads, _ = TL._step_grads(master, windows, cfg, tcfg, rows, mesh, impl)
    return {k: TL._whole(g, master[k]).float().numpy()
            for k, g in grads.items()}


def _jax_mesh(names, local):
    grid = (2 * local[0],) + tuple(local[1:])
    return JMesh(np.array(jax.devices()[:int(np.prod(grid))]).reshape(grid),
                 names)


def _sp_inputs():
    """The sequence-parallel cases' tokens and q, k, v (narrow GQA k/v),
    as the two processes draw them."""
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (4, FWD_T))
    q = rng.normal(size=(4, FWD_T, 4, 8)).astype(np.float32)
    k, v = (rng.normal(size=(4, FWD_T, 2, 8)).astype(np.float32)
            for _ in range(2))
    return toks, q, k, v


def _jax_sp(names, local, b_axis) -> dict:
    """The JAX package's ring and Ulysses forwards and its
    ``ulysses_attention`` on a mesh of the case's shape."""
    toks, q, k, v = _sp_inputs()
    jcfg = jllm.TransformerConfig(**CFG)
    jparams = jllm.init_params(jax.random.PRNGKey(0), jcfg)
    jmesh = _jax_mesh(names, local)
    out = {impl: np.asarray(jllm.forward(
        jparams, jnp.asarray(toks, jnp.int32), jcfg, seq_mesh=jmesh,
        sp_impl=impl)[0]) for impl in ("ring", "ulysses")}
    out["attn"] = np.asarray(jllm.ulysses_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jmesh, batch_axis=b_axis))
    return out


def _whole(lm):
    return {k: (v.gather() if isinstance(v, Sharded) else v).float().numpy()
            for k, v in ((k, lm.params.param(k))
                         for k in lm.params.param_names())}


@pytest.fixture(scope="module")
def two_process():
    """The two processes' results and saved arrays, and this process's
    references computed while they run."""
    with tempfile.TemporaryDirectory() as out, \
            ThreadPoolExecutor(1) as pool:
        spec = dict(dir=out, cfg=CFG, tcfg=TCFG, corpus=CORPUS, fits=FITS,
                    resume=RESUME, T=FWD_T, sp=SP_CASES)
        child = _CHILD.replace("json.loads(sys.argv[1])",
                               f"json.loads({json.dumps(spec)!r})")
        running = pool.submit(_run_two_process, child, 150)
        cfg = llm.TransformerConfig(**CFG)
        tcfg = LLMTrainConfig(**TCFG)
        port = {label: fit_language_model(CORPUS, cfg, tcfg,
                                          mesh=_port_mesh(names, local),
                                          sp_impl=impl)
                for label, names, local, impl in FITS}
        grads = {label: _first_grads(names, local, impl)
                 for label, names, local, impl in FITS}
        jcfg = jllm.TransformerConfig(**CFG)
        jtcfg = jtl.LLMTrainConfig(**TCFG)
        # the reference trains on the ring; its compiles overlap in threads
        with ThreadPoolExecutor(3) as jpool:
            jfits = {label: jpool.submit(
                jtl.fit_language_model, CORPUS, jcfg, jtcfg,
                mesh=_jax_mesh(names, local))
                for label, names, local, _ in FITS
                if not label.endswith("ulysses")}
            jsp = {label: jpool.submit(_jax_sp, names, local, b_axis)
                   for label, names, local, b_axis in SP_CASES}
            jfits = {k: f.result() for k, f in jfits.items()}
            jsp = {k: f.result() for k, f in jsp.items()}
        lines = running.result()
        results = [json.loads(ln.split(" ", 1)[1]) for ln in lines]
        saved = {}
        for name in os.listdir(out):
            if name.endswith(".npz"):
                with np.load(os.path.join(out, name)) as z:
                    saved[name[:-4]] = {k: z[k] for k in z.files}
        yield dict(results=results, saved=saved, port=port, grads=grads,
                   jax=jfits,
                   jax_sp=jsp, snapshot=os.path.join(out, "ckpt_model"))


@pytest.mark.parametrize("label", [f[0] for f in FITS])
def test_two_process_fit_equals_one_process_and_jax(two_process, label):
    got = [r[label] for r in two_process["results"]]
    assert got[0] == got[1]                      # the same loss on each rank
    lm, want = two_process["port"][label]
    np.testing.assert_allclose(got[0], want, rtol=FIT_TOL, atol=FIT_TOL)
    jlm, jlosses = two_process["jax"][label.replace("ulysses", "ring")]
    np.testing.assert_allclose(got[0], jlosses, rtol=FIT_TOL, atol=FIT_TOL)
    ranks = [two_process["saved"][f"{label}.{r}"] for r in range(2)]
    whole = _whole(lm)
    for k, w in whole.items():
        # every leaf, split ones gathered, is the same bits on both ranks
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
        for ref in (w, np.asarray(jlm.params[k], np.float32)):
            np.testing.assert_allclose(ranks[0][k], ref, rtol=FIT_TOL,
                                       atol=FIT_TOL, err_msg=k)


@pytest.mark.parametrize("label", [f[0] for f in FITS])
def test_two_process_gradients_equal_one_process(two_process, label):
    """The first step's raw gradients, every leaf after the step's sums over
    the processes: a collective whose backward scales a gradient (an
    all-reduce where the gradient passes through doubles it on 2 ranks)
    shows here, where AdamW's normalisation hides it from the weights."""
    want = two_process["grads"][label]
    ranks = [two_process["saved"][f"grads_{label}.{r}"] for r in range(2)]
    assert sorted(ranks[0]) == sorted(want)
    for k, w in want.items():
        assert np.abs(w).max() > 0, k
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
        np.testing.assert_allclose(ranks[0][k], w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max(), err_msg=k)


def test_sum_in_rank_order_over_buckets(two_process):
    """Each tensor summed in place over the two processes, in buckets of 7
    elements (two tensors in one, a 20-element tensor alone, bf16 apart):
    rank r holds arange(n) * (r + 1) + 0.5, so every sum is 3 i + 1."""
    for r in two_process["results"]:
        assert r["rank_order_sums"] == [[3.0 * i + 1 for i in range(n)]
                                        for n in (3, 5, 20, 4)]


@pytest.mark.parametrize("label", [r[0] for r in RESUME])
def test_two_process_resume_is_bit_identical(two_process, label):
    assert all(r[f"resume_{label}"] is True for r in two_process["results"])


def test_two_process_snapshot_refused_by_one_process(two_process):
    names, local = RESUME[0][1], RESUME[0][2]
    with pytest.raises(ValueError, match="different setup"):
        fit_language_model(CORPUS, llm.TransformerConfig(**CFG),
                           LLMTrainConfig(**TCFG),
                           mesh=_port_mesh(names, local),
                           checkpoint_dir=two_process["snapshot"])


@pytest.mark.parametrize("case", SP_CASES, ids=[c[0] for c in SP_CASES])
def test_seq_parallel_across_processes_equals_one_process_and_jax(
        two_process, case):
    """``forward(seq_mesh=)`` (ring and Ulysses) and ``ulysses_attention``
    with narrow GQA k/v, with the batch axis (data 2 x seq 2) or the
    sequence axis (seq 4) across the processes."""
    label, names, local, b_axis = case
    got = [two_process["saved"][f"forward.{r}"] for r in range(2)]
    jax_want = two_process["jax_sp"][label]
    cfg = llm.TransformerConfig(**CFG)
    params = llm.init_params_threefry(cfg, 0, "cpu")
    toks, q, k, v = _sp_inputs()
    mesh = _port_mesh(names, local)
    for impl in ("ring", "ulysses"):
        with torch.inference_mode():
            want = llm.forward(params, torch.from_numpy(toks), cfg,
                               seq_mesh=mesh, sp_impl=impl)[0].numpy()
        for g in got:
            for ref in (want, jax_want[impl]):
                np.testing.assert_allclose(g[f"{label}_{impl}"], ref,
                                           rtol=MODE_TOL, atol=MODE_TOL)
    want = llm.ulysses_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 mesh, batch_axis=b_axis).numpy()
    for g in got:
        for ref in (want, jax_want["attn"]):
            np.testing.assert_allclose(g[f"{label}_attn"], ref,
                                       rtol=ATTN_TOL, atol=ATTN_TOL)
