"""The port's multi-process mesh helpers (``parallel/mesh.py``) on the CPU —
twins of ``tests/test_mesh_multihost.py``.

Two layers, as in the reference: the single-process paths (the
environment no-ops, the hybrid mesh's fallback, the global batch on one
process), each beside the JAX package's answer, and a REAL 2-process
``torch.distributed`` rendezvous over localhost with the ``gloo`` backend,
in subprocesses of 4 CPU shards each: ``initialize_distributed`` ->
``make_hybrid_mesh`` -> ``global_batch_from_local`` -> the data-axis sum,
and a decision tree fit across the two processes. The subprocesses run
under one deadline, so a wedged rendezvous fails instead of hanging.
"""

import hashlib
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from fraud_detection_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FEATURE_AXIS,
    data_sum,
    global_batch_from_local,
    initialize_distributed,
    make_hybrid_mesh,
    make_mesh,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8
DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
            "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


def test_initialize_distributed_is_noop_without_env(monkeypatch):
    from fraud_detection_tpu.parallel.mesh import \
        initialize_distributed as jinit

    for var in DIST_ENV:
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() is False
    assert jinit() is False


def test_initialize_distributed_noop_for_single_process(monkeypatch):
    from fraud_detection_tpu.parallel.mesh import \
        initialize_distributed as jinit

    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    assert initialize_distributed() is False
    assert jinit() is False


def test_initialize_distributed_forwards_env(monkeypatch):
    calls = {}

    def fake_init(backend, init_method=None, world_size=None, rank=None,
                  timeout=None):
        calls.update(backend=backend, init_method=init_method,
                     world_size=world_size, rank=rank)

    monkeypatch.setattr(torch.distributed, "init_process_group", fake_init)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "9000")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert initialize_distributed() is True
    assert calls == {"backend": "gloo", "init_method": "tcp://10.0.0.1:9000",
                     "world_size": 4, "rank": 2}
    # torch has no rank auto-detection: a multi-process job needs one
    monkeypatch.delenv("RANK")
    with pytest.raises(ValueError, match="rank"):
        initialize_distributed()


def test_make_hybrid_mesh_single_process_fallback():
    from fraud_detection_tpu.parallel.mesh import \
        make_hybrid_mesh as jhybrid

    mesh = make_hybrid_mesh(devices=CPU8)
    assert mesh.shape == make_mesh(devices=CPU8).shape == dict(jhybrid().shape)
    assert set(mesh.axis_names) == {DATA_AXIS, FEATURE_AXIS}
    mesh2 = make_hybrid_mesh(feature_parallel=2, devices=CPU8)
    assert mesh2.shape[FEATURE_AXIS] == 2
    assert mesh2.shape == dict(jhybrid(feature_parallel=2).shape)
    with pytest.raises(ValueError, match="feature_parallel"):
        make_hybrid_mesh(feature_parallel=3, devices=CPU8)


@pytest.mark.parametrize("ndim", [1, 2])
def test_global_batch_from_local_single_process(ndim):
    mesh = make_hybrid_mesh(devices=CPU8)
    n = mesh.shape[DATA_AXIS]
    shape = (n,) if ndim == 1 else (n, 3)
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    g = global_batch_from_local(x, mesh)
    assert g.shape == shape
    np.testing.assert_array_equal(g.gather().numpy(), x)
    assert {s.shape[0] for s in g.shards} == {n // mesh.shape[DATA_AXIS]}
    assert float(data_sum([s.sum() for s in g.shards], mesh)) == float(x.sum())


#: Appended to every child: once its source has run (destroy_process_group
#: included), the child leaves by ``os._exit``. This torch's interpreter
#: teardown after a gloo job sometimes aborts ("terminate called without an
#: active exception", SIGABRT) after both ranks printed their results: 8 of
#: 120 two-process runs of this file, 6 at a time on one host, against 0 of
#: 120 with this line. An exception in the child's own code still exits
#: non-zero: it never reaches this line.
_CHILD_EXIT = ("\nimport os as _os, sys as _sys\n_sys.stdout.flush()\n"
               "_sys.stderr.flush()\n_os._exit(0)\n")


def _run_two_process(child_src: str, timeout: float = 90):
    """Run ``child_src`` as TWO torch.distributed processes (gloo) and return
    each one's RESULT line.

    This process hosts the rendezvous store on a port it holds bound for the
    whole run, and the children reach it as clients, as under torchrun's
    agent (``TORCHELASTIC_USE_AGENT_STORE``). A port picked free and closed
    before rank 0 bound it could be taken in between by another job on the
    machine: under a loaded parallel test run two two-process jobs then met
    in one store, and a rank crashed or waited out its timeout. The
    children write to files, so neither blocks on a full pipe while the
    other waits in a collective; both run under one deadline and are killed
    at the end."""
    store = torch.distributed.TCPStore("127.0.0.1", 0, is_master=True,
                                       wait_for_workers=False)
    files = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
             for _ in range(2)]
    procs = []
    try:
        for rank, (out, err) in enumerate(files):
            env = dict(os.environ, PYTHONPATH=ROOT, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(store.port), WORLD_SIZE="2",
                       RANK=str(rank), OMP_NUM_THREADS="1",
                       TORCHELASTIC_USE_AGENT_STORE="True")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", child_src + _CHILD_EXIT], env=env,
                cwd=ROOT, stdout=out, stderr=err, text=True))
        deadline = time.monotonic() + timeout
        while (time.monotonic() < deadline
               and any(p.poll() is None for p in procs)):
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        del store
    texts = []
    for out, err in files:
        out.seek(0)
        err.seek(0)
        texts.append((out.read(), err.read()))
        out.close()
        err.close()
    rcs = [p.returncode for p in procs]
    assert rcs == [0, 0], f"ranks exited {rcs}" + "".join(
        f"\nrank {r} stdout: {o[-500:]}\nrank {r} stderr: {e[-2000:]}"
        for r, (o, e) in enumerate(texts))
    return [[ln for ln in o.splitlines() if ln.startswith("RESULT")][0]
            for o, _ in texts]


_CHILD = r'''
import torch
torch.set_num_threads(1)
import numpy as np
from fraud_detection_tpu_torch.parallel.mesh import (
    data_sum, global_batch_from_local, initialize_distributed,
    make_hybrid_mesh)

assert initialize_distributed(timeout_s=30) is True
rank = torch.distributed.get_rank()
mesh = make_hybrid_mesh(devices=["cpu"] * 4)
x_local = np.full((4, 3), float(rank), np.float32)
g = global_batch_from_local(x_local, mesh)
total = float(data_sum([s.sum() for s in g.shards], mesh))
rows = g.gather()[:, 0].tolist()
print("RESULT", rank, mesh.shape, total, tuple(g.shape), rows, flush=True)
torch.distributed.destroy_process_group()
'''


def test_two_process_rendezvous_and_global_batch():
    """2 processes x 4 CPU shards -> one 8-shard data axis; each process's
    rows assemble into the global batch in process order, and the data-axis
    sum crosses the process boundary."""
    for line in _run_two_process(_CHILD):
        assert "'data': 8" in line and " 12.0 " in line and "(8, 3)" in line
        assert "[0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0]" in line


def _tree_data():
    rng = np.random.default_rng(17)
    X = rng.normal(size=(512, 24)).astype(np.float32)
    w = rng.normal(size=24).astype(np.float32)
    y = (X @ w + 0.3 * rng.normal(size=512) > 0).astype(np.int32)
    return X, y


_TRAIN_CHILD = r'''
import hashlib
import torch
torch.set_num_threads(1)
import numpy as np
from fraud_detection_tpu_torch.parallel.mesh import (initialize_distributed,
                                                     make_hybrid_mesh)
from fraud_detection_tpu_torch.models.train_trees import fit_decision_tree
from fraud_detection_tpu_torch.models.trees import predict

assert initialize_distributed(timeout_s=30)
mesh = make_hybrid_mesh(devices=["cpu"] * 4)
rng = np.random.default_rng(17)
X = rng.normal(size=(512, 24)).astype(np.float32)
w = rng.normal(size=24).astype(np.float32)
y = (X @ w + 0.3 * rng.normal(size=512) > 0).astype(np.int32)
ens = fit_decision_tree(X, y, mesh=mesh)
parts = [t.numpy() for t in (ens.feature, ens.threshold, ens.left, ens.right,
                             ens.leaf)]
digest = hashlib.sha256(b"".join(p.tobytes() for p in parts)).hexdigest()
acc = float((predict(ens, torch.from_numpy(X))[0].numpy() == y).mean())
print("RESULT", torch.distributed.get_rank(), digest, "%.4f" % acc, flush=True)
torch.distributed.destroy_process_group()
'''


def test_two_process_tree_training_parity():
    """Data-parallel histogram training across two processes: the gini
    histograms' data-axis sum crosses the process boundary through gloo.
    Both processes build the same tree, and (the gini histogram is exact)
    the same one an 8-shard fit in one process builds; its training
    accuracy is within a point of the JAX package's single-process fit, the
    reference's own bar."""
    import jax.numpy as jnp

    from fraud_detection_tpu.models.train_trees import \
        fit_decision_tree as jfit
    from fraud_detection_tpu.models.trees import predict as jpredict
    from fraud_detection_tpu_torch.models.train_trees import fit_decision_tree

    results = [ln.split() for ln in _run_two_process(_TRAIN_CHILD)]
    assert results[0][2:] == results[1][2:], results
    X, y = _tree_data()
    ens = fit_decision_tree(X, y, mesh=make_mesh(devices=CPU8))
    parts = [t.numpy() for t in (ens.feature, ens.threshold, ens.left,
                                 ens.right, ens.leaf)]
    assert results[0][2] == hashlib.sha256(
        b"".join(p.tobytes() for p in parts)).hexdigest()
    jens = jfit(X, y)
    single_acc = float((np.asarray(jpredict(jens, jnp.asarray(X))[0])
                        == y).mean())
    assert abs(float(results[0][3]) - single_acc) < 0.01


_LLM_TP_CHILD = r'''
import hashlib
import torch
torch.set_num_threads(1)
import numpy as np
from fraud_detection_tpu_torch.models.llm import (
    MODEL_AXIS, TransformerConfig, forward, init_params_threefry, shard_params)
from fraud_detection_tpu_torch.parallel.mesh import Mesh, initialize_distributed

assert initialize_distributed(timeout_s=30)
rank = torch.distributed.get_rank()
cfg = TransformerConfig(d_model=32, n_heads=8, n_layers=2, d_ff=64, max_seq=64)
params = init_params_threefry(cfg, 0, "cpu")
mesh = Mesh(np.array(["cpu"] * 4, object), (MODEL_AXIS,), process_count=2,
            process_index=rank, group=torch.distributed.group.WORLD)
sp = shard_params(params, cfg, mesh)      # params split ACROSS PROCESSES
parts = [tuple(p.shape) for p in sp.param("l0.w_up").parts]
toks = torch.arange(16)[None, :] % 250
with torch.inference_mode():
    logits = forward(sp, toks, cfg)[0]
digest = hashlib.sha256(logits.numpy().tobytes()).hexdigest()
sample = " ".join("%.6f" % v for v in logits[0, -1, :5].tolist())
print("RESULT", rank, len(parts), parts[0], digest, "|", sample, flush=True)
torch.distributed.destroy_process_group()
'''


def test_two_process_llm_tensor_parallel_forward():
    """The LLM's tensor parallelism across the PROCESS boundary: each of two
    processes holds 4 of the 8 model-axis parts (disjoint halves), the
    row-parallel sums all-reduce over gloo, and both see the SAME logits,
    those of a one-process forward (the twin of
    ``tests/test_mesh_multihost.py``'s two-process TP forward, held to the
    TP forward's 3e-4 here instead of its 5e-3)."""
    import jax
    import jax.numpy as jnp

    from fraud_detection_tpu.models import llm as jllm
    from fraud_detection_tpu_torch.models import llm

    results = _run_two_process(_LLM_TP_CHILD)
    heads = [ln.split("|")[0].split() for ln in results]
    assert heads[0][2:] == heads[1][2:], results   # same parts, same digest
    assert heads[0][2] == "4" and "(32, 8)" in results[0]
    cfg = llm.TransformerConfig(d_model=32, n_heads=8, n_layers=2, d_ff=64,
                                max_seq=64)
    toks = torch.arange(16)[None, :] % 250
    want = llm.forward(llm.init_params_threefry(cfg, 0, "cpu"), toks,
                       cfg)[0][0, -1, :5].numpy()
    got = [float(x) for x in results[0].split("|")[1].split()]
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)
    jcfg = jllm.TransformerConfig(d_model=32, n_heads=8, n_layers=2, d_ff=64,
                                  max_seq=64)
    jwant = jllm.forward(jllm.init_params(jax.random.PRNGKey(0), jcfg),
                         jnp.asarray(toks.numpy(), jnp.int32), jcfg)[0]
    np.testing.assert_allclose(got, np.asarray(jwant)[0, -1, :5], atol=5e-3)


_LLM_SP_CHILD = r'''
import torch
torch.set_num_threads(1)
import numpy as np
from fraud_detection_tpu_torch.models.llm import (
    SEQ_AXIS, TransformerConfig, forward, init_params_threefry)
from fraud_detection_tpu_torch.parallel.mesh import Mesh, initialize_distributed

assert initialize_distributed(timeout_s=30)
rank = torch.distributed.get_rank()
cfg = TransformerConfig(d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq=64)
params = init_params_threefry(cfg, 0, "cpu")
mesh = Mesh(np.array(["cpu"] * 4, object), (SEQ_AXIS,), process_count=2,
            process_index=rank, group=torch.distributed.group.WORLD)
toks = (torch.arange(32)[None, :] * 7) % 250
with torch.inference_mode():
    logits = forward(params, toks, cfg, seq_mesh=mesh)[0]
start = rank * 16       # this process's blocks: positions [16 r, 16 r + 16)
sample = " ".join("%.6f" % v for v in logits[0, start + 15, :5].tolist())
print("RESULT", rank, start, 16, "|", sample, flush=True)
torch.distributed.destroy_process_group()
'''


def test_two_process_llm_ring_attention_forward():
    """Ring attention across the PROCESS boundary: the K/V block leaving a
    process's last device goes to the next process by send/recv over gloo,
    each process computes its half of the sequence, and every rank's
    positions match a one-process forward (the twin of
    ``tests/test_mesh_multihost.py``'s two-process ring forward)."""
    from fraud_detection_tpu_torch.models import llm

    got = {}
    for line in _run_two_process(_LLM_SP_CHILD):
        head, sample = line.split("|")
        _, _, start, n_local = head.split()
        got[int(start)] = (int(n_local), [float(x) for x in sample.split()])
    assert sorted(got) == [0, 16] and all(n == 16 for n, _ in got.values())
    cfg = llm.TransformerConfig(d_model=32, n_heads=2, n_layers=2, d_ff=64,
                                max_seq=64)
    toks = (torch.arange(32)[None, :] * 7) % 250
    ref = llm.forward(llm.init_params_threefry(cfg, 0, "cpu"), toks,
                      cfg)[0].numpy()
    for start, (n_local, sample) in got.items():
        np.testing.assert_allclose(sample, ref[0, start + n_local - 1, :5],
                                   rtol=3e-4, atol=3e-4)
