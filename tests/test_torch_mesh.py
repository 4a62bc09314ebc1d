"""The port's mesh data parallelism (``parallel/``, the pipeline's and the
trainers' ``mesh=``) against the JAX package's, on the CPU.

The port's mesh here is 8 shards on the CPU (``make_mesh(devices=["cpu"] *
8)``, the port's stand-in for the 8 virtual XLA devices of
``tests/conftest.py``, which the JAX side uses). Tolerances are the
reference's own:

* serving (twins of ``tests/test_fleet.py``'s mesh cases and its
  ``test_serve_cli_mesh_demo``): labels equal, |dp| <= 1e-6 against the
  single-device pipeline and the JAX mesh pipeline; the 1-device fallback
  byte-identical;
* LR (``tests/test_train_linear.py``'s mesh case): weights within rtol and
  atol 1e-3 of the single-device fit and of the JAX mesh fit;
* trees (``tests/test_trees.py``'s mesh case): dt features equal, thresholds
  allclose, leaves rtol 1e-5; xgb ``predict_proba`` atol 1e-4; the forest
  equal tree for tree to the JAX mesh forest;
* checkpoints (``tests/test_train_checkpoint.py``'s mesh case): a snapshot
  refuses to resume across meshes.
"""

import json
import threading

import numpy as np
import pytest
import torch

from fraud_detection_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
from fraud_detection_tpu_torch.parallel.serving import MeshServingPipeline
from torch_parity import port_featurizer, port_model, warmed

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def pipelines():
    """The JAX fleet tests' pipeline and the port's twin of its arrays."""
    from fraud_detection_tpu.models.pipeline import synthetic_demo_pipeline
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline

    jp = synthetic_demo_pipeline(batch_size=64, n=300, seed=3,
                                 num_features=1024,
                                 corpus_kwargs=dict(hard_fraction=0.0,
                                                    label_noise=0.0))
    tp = ServingPipeline(port_featurizer(jp.featurizer), port_model(jp.model),
                         batch_size=64, device="cpu")
    return jp, warmed(tp)


def _mesh_twin(pipe, per_chip=16, devices=CPU8):
    return MeshServingPipeline.from_pipeline(
        pipe, per_chip_batch=per_chip, mesh=make_mesh(devices=devices))


TEXTS = [f"hello dialogue {i} urgent verify account" for i in range(200)]


def test_mesh_shape_and_names_equal_jax():
    from fraud_detection_tpu import parallel as jpar
    from fraud_detection_tpu_torch import parallel as tpar

    assert tpar.__all__ == jpar.__all__
    mesh = make_mesh(devices=CPU8)
    assert mesh.shape == dict(jpar.make_mesh().shape) == {"data": 8,
                                                          "feature": 1}
    assert mesh.axis_names == jpar.make_mesh().axis_names
    m2 = make_mesh(devices=CPU8, feature_parallel=2)
    assert m2.shape == dict(jpar.make_mesh(feature_parallel=2).shape)
    with pytest.raises(ValueError, match="feature_parallel"):
        make_mesh(devices=CPU8, feature_parallel=3)
    sh = tpar.shard_rows(np.arange(21, dtype=np.float32).reshape(7, 3), mesh)
    assert sh.shape == (8, 3) and len(sh.shards) == 8
    assert sh.gather()[7].tolist() == [0.0, 0.0, 0.0]      # zero padding
    assert tpar.pad_to_multiple(13, 8) == jpar.pad_to_multiple(13, 8) == 16


def test_mesh_pipeline_parity(pipelines):
    jp, tp = pipelines
    from fraud_detection_tpu.parallel.serving import \
        MeshServingPipeline as JMesh

    mesh_pipe = _mesh_twin(tp)
    jmesh = JMesh.from_pipeline(jp, per_chip_batch=16)
    assert mesh_pipe.data_parallel == jmesh.data_parallel == 8
    assert mesh_pipe.batch_size == jmesh.batch_size == 128
    ref, got, jgot = tp.predict(TEXTS), mesh_pipe.predict(TEXTS), \
        jmesh.predict(TEXTS)
    assert np.array_equal(ref.labels, got.labels)
    assert np.abs(ref.probabilities - got.probabilities).max() <= 1e-6
    assert np.array_equal(jgot.labels, got.labels)
    assert np.abs(jgot.probabilities - got.probabilities).max() <= 1e-6
    # the raw-JSON path (the engine's hot path)
    values = [json.dumps({"text": t}).encode() for t in TEXTS]
    fr, fg = tp.predict_json_async(values), mesh_pipe.predict_json_async(values)
    r, g = fr[0].resolve(), fg[0].resolve()
    assert np.array_equal(r.labels, g.labels)
    assert np.abs(r.probabilities - g.probabilities).max() <= 1e-6
    snap, jsnap = (mesh_pipe.device_stats.snapshot(),
                   jmesh.device_stats.snapshot())
    assert snap["mesh_devices"] == jsnap["mesh_devices"] == 8
    assert snap["per_chip_rungs"] == jsnap["per_chip_rungs"] == [16]
    # one host->device copy a shard
    assert snap["uploads_per_chunk"] == 8


def test_mesh_single_device_fallback_byte_identical(pipelines):
    _, tp = pipelines
    single = MeshServingPipeline(tp.featurizer, tp.model, per_chip_batch=64,
                                 mesh=make_mesh(n_devices=1, devices=CPU8))
    assert single.mesh is None and single.data_parallel == 1
    texts = [f"hello dialogue {i}" for i in range(50)]
    ref, got = tp.predict(texts), single.predict(texts)
    assert np.array_equal(ref.labels, got.labels)
    assert np.array_equal(ref.probabilities, got.probabilities)
    assert single.device_stats.snapshot()["mesh_devices"] == 1


def test_mesh_pad_rows_stay_shardable(pipelines):
    _, tp = pipelines
    mesh_pipe = _mesh_twin(tp)
    dp = mesh_pipe.data_parallel
    mesh_pipe.pad_ladder = (16, 64, 256)
    for n in (1, 3, 17, 65, 100, mesh_pipe.batch_size):
        target = mesh_pipe._pad_rows(n)
        assert target % dp == 0 and target >= n


def test_mesh_device_featurize_and_trees_parity(pipelines):
    """Device featurize (the plain scan here) shards with scoring: one
    ``featurize_bytes`` call a shard; a forest scores the same through the
    mesh."""
    from fraud_detection_tpu_torch.models import train_trees as pt
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline

    _, tp = pipelines
    single = ServingPipeline(tp.featurizer, tp.model, batch_size=128,
                             featurize_device=True, device="cpu")
    mesh_pipe = MeshServingPipeline(tp.featurizer, tp.model,
                                    per_chip_batch=16,
                                    mesh=make_mesh(devices=CPU8),
                                    featurize_device=True)
    a, b = single.predict(TEXTS), mesh_pipe.predict(TEXTS)
    assert np.array_equal(a.labels, b.labels)
    assert np.abs(a.probabilities - b.probabilities).max() <= 1e-6
    assert mesh_pipe.device_stats.featurize_path == "torch"
    X = tp.featurizer.featurize_dense(TEXTS[:64], device="cpu").numpy()
    y = (np.arange(64) % 3 == 0).astype(np.int64)
    forest = pt.fit_random_forest(X, y, n_trees=4, tree_chunk=2, device="cpu",
                                  config=pt.TreeTrainConfig(max_depth=3))
    fs = ServingPipeline(tp.featurizer, forest, batch_size=128, device="cpu")
    fm = MeshServingPipeline(tp.featurizer, forest, per_chip_batch=16,
                             mesh=make_mesh(devices=CPU8))
    a, b = fs.predict(TEXTS), fm.predict(TEXTS)
    assert np.array_equal(a.labels, b.labels)
    assert np.array_equal(a.probabilities, b.probabilities)


def test_mesh_prewarm_fills_per_chip_rungs(pipelines):
    """The scheduler's prewarm dispatches every candidate rung through the
    mesh before traffic: health's per-chip rungs are the JAX package's."""
    from fraud_detection_tpu.parallel.serving import \
        MeshServingPipeline as JMesh
    from fraud_detection_tpu.sched import AdaptiveScheduler as JSched
    from fraud_detection_tpu.sched import SchedulerConfig as JConfig
    from fraud_detection_tpu_torch.sched import (AdaptiveScheduler,
                                                 SchedulerConfig)

    jp, tp = pipelines
    mesh_pipe = _mesh_twin(tp)
    jmesh = JMesh.from_pipeline(jp, per_chip_batch=16)
    sched = AdaptiveScheduler(SchedulerConfig(batch_deadline_ms=10,
                                              cost_aware=False),
                              mesh_pipe.batch_size)
    jsched = JSched(JConfig(batch_deadline_ms=10, cost_aware=False),
                    jmesh.batch_size)
    sched.prewarm(mesh_pipe)
    jsched.prewarm(jmesh)
    assert mesh_pipe.pad_ladder == jmesh.pad_ladder
    per_chip = mesh_pipe.device_stats.snapshot()["per_chip_rungs"]
    assert per_chip == jmesh.device_stats.snapshot()["per_chip_rungs"]
    assert {-(-r // 8) for r in mesh_pipe.pad_ladder} <= set(per_chip)


def test_mesh_pins_and_threads(pipelines):
    """N threads pin and score through one mesh pipeline at once: one pin,
    every thread's labels equal the single-device pipeline's."""
    _, tp = pipelines
    mesh_pipe = _mesh_twin(tp)
    want = tp.predict(TEXTS).labels
    got, errors = [], []

    def work():
        try:
            mesh_pipe.pin_device()
            got.append(mesh_pipe.predict(TEXTS).labels)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(got) == 4
    assert all(np.array_equal(g, want) for g in got)
    snap = mesh_pipe.device_stats.snapshot()
    assert snap["model_pins"] == 1 and snap["pinned_bytes"] > 0


def test_mesh_fleet_drain_and_health_device_block(pipelines):
    from fraud_detection_tpu_torch.stream import (InProcessBroker,
                                                  StreamingClassifier)

    _, tp = pipelines
    mesh_pipe = _mesh_twin(tp)
    broker = InProcessBroker(num_partitions=4)
    producer = broker.producer()
    for i in range(300):
        producer.produce("in", json.dumps({"text": f"hello dialogue {i}",
                                           "id": i}).encode(),
                         key=str(i).encode())
    consumer = broker.assigned_consumer([("in", p) for p in range(4)], "g")
    engine = StreamingClassifier(mesh_pipe, consumer, broker.producer(),
                                 "out", batch_size=64)
    engine.run(max_messages=300, idle_timeout=1.0)
    assert sorted(m.key for m in broker.messages("out")) == sorted(
        str(i).encode() for i in range(300))
    assert engine._json_fast is True
    dev = engine.health()["device"]
    assert dev["mesh_devices"] == mesh_pipe.data_parallel
    assert dev["per_chip_rungs"]


def test_serve_cli_mesh_demo(capsys):
    """serve --mesh on the CPU: every local device (one here) on the data
    axis, so the plain pipeline under the mesh lane's name."""
    from fraud_detection_tpu_torch.app import serve

    rc = serve.main(["--device", "cpu", "--model", "synthetic", "--demo",
                     "200", "--batch-size", "64", "--mesh"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "(mesh x1)" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    stats = json.loads(lines[-1])
    assert stats["processed"] == 200
    dev = stats["health"]["device"]
    assert dev["mesh_devices"] == 1
    assert dev["per_chip_rungs"]


def test_serve_cli_mesh_registry_refusal_equals_jax(tmp_path):
    from fraud_detection_tpu.app import serve as jserve
    from fraud_detection_tpu_torch.app import serve as tserve

    argv = ["--registry", str(tmp_path), "--demo", "5", "--mesh"]
    with pytest.raises(SystemExit) as je:
        jserve.main(argv)
    with pytest.raises(SystemExit) as te:
        tserve.main(["--device", "cpu", *argv])
    assert str(te.value) == str(je.value)
    assert "--mesh is not supported with --registry" in str(te.value)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _toy_lr(n=333, f=16, seed=2):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(0, 2.0, f)
    X = rng.normal(0, 1.0, (n, f)).astype(np.float32)
    logits = X @ w_true - 0.5
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return X, y


def test_mesh_lr_matches_single_device_and_jax():
    from fraud_detection_tpu.models.train_linear import \
        fit_logistic_regression as jfit
    from fraud_detection_tpu.parallel import make_mesh as jmesh
    from fraud_detection_tpu_torch.models.train_linear import \
        fit_logistic_regression as tfit

    X, y = _toy_lr()                      # odd n exercises the padding
    single = tfit(X, y, max_iter=50, device="cpu")
    sharded, info = tfit(X, y, mesh=make_mesh(devices=CPU8), max_iter=50,
                         return_info=True)
    jsharded = jfit(X, y, mesh=jmesh(), max_iter=50)
    np.testing.assert_allclose(single.weights.numpy(),
                               sharded.weights.numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(jsharded.weights),
                               sharded.weights.numpy(), rtol=1e-3, atol=1e-3)
    assert info.converged


@pytest.fixture(scope="module")
def tree_data():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(301, 6)).astype(np.float32)  # odd n: padding
    y = (X[:, 1] - X[:, 4] > 0).astype(np.int64)
    return X, y


def test_mesh_tree_training_matches_single_device(tree_data):
    from fraud_detection_tpu_torch.models import train_trees as pt
    from fraud_detection_tpu_torch.models.trees import predict_proba

    X, y = tree_data
    cfg = pt.TreeTrainConfig(max_depth=4)
    mesh = make_mesh(devices=CPU8)
    single = pt.fit_decision_tree(X, y, config=cfg, device="cpu")
    sharded = pt.fit_decision_tree(X, y, config=cfg, mesh=mesh)
    assert torch.equal(single.feature, sharded.feature)
    np.testing.assert_allclose(single.threshold.numpy(),
                               sharded.threshold.numpy())
    np.testing.assert_allclose(single.leaf.numpy(), sharded.leaf.numpy(),
                               rtol=1e-5)
    g1 = pt.fit_gradient_boosting(X, y, n_rounds=5, config=cfg, device="cpu")
    g2 = pt.fit_gradient_boosting(X, y, n_rounds=5, config=cfg, mesh=mesh)
    xs = torch.from_numpy(X)
    np.testing.assert_allclose(predict_proba(g1, xs).numpy(),
                               predict_proba(g2, xs).numpy(), atol=1e-4)
    assert pt.resolve_config(None, mesh) == pt.TreeTrainConfig()


def test_mesh_xgb_at_the_cli_shape_matches_single_device():
    """At the training CLI's shape (1,600 dialogues, HashingTF 10,000 + IDF,
    depth 5, 32 bins, 3 rounds) deep nodes hold a few rows, and features
    that split them alike tie: a 4-shard fit stays within the reference's
    1e-4 in p of the single-device fit (the child totals carry no
    cancellation error for the shards' order to move)."""
    from fraud_detection_tpu_torch.data import (generate_corpus,
                                                train_val_test_split)
    from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
    from fraud_detection_tpu_torch.models import train_trees as pt
    from fraud_detection_tpu_torch.models.trees import predict_proba

    corpus = [(d.text, d.label) for d in generate_corpus(n=1600, seed=42)]
    train, _, _ = train_val_test_split(corpus, seed=42)
    feat = HashingTfIdfFeaturizer(num_features=10_000)
    feat.fit_idf([t for t, _ in train])
    X = feat.featurize_dense([t for t, _ in train], device="cpu").numpy()
    y = np.asarray([l for _, l in train], np.float32)
    cfg = pt.TreeTrainConfig(max_depth=5, n_bins=32, criterion="xgb")
    single = pt.fit_gradient_boosting(X, y, n_rounds=3, config=cfg,
                                      device="cpu")
    sharded = pt.fit_gradient_boosting(X, y, n_rounds=3, config=cfg,
                                       mesh=make_mesh(devices=["cpu"] * 4))
    xs = torch.from_numpy(X)
    np.testing.assert_allclose(predict_proba(single, xs).numpy(),
                               predict_proba(sharded, xs).numpy(), atol=1e-4)


def test_mesh_tree_training_matches_jax_mesh(tree_data):
    """Against the JAX package's mesh fits (its XLA segment-sum path, the
    one its mesh forces): the same tolerances, and the forest — drawn over
    the padded rows as the reference's mesh path draws — tree for tree."""
    import jax.numpy as jnp

    from fraud_detection_tpu.models import train_trees as jt
    from fraud_detection_tpu.models.trees import predict_proba as jpp
    from fraud_detection_tpu.parallel import make_mesh as jmesh
    from fraud_detection_tpu_torch.models import train_trees as pt
    from fraud_detection_tpu_torch.models.trees import predict_proba

    X, y = tree_data
    mesh, jm = make_mesh(devices=CPU8), jmesh()
    jd = jt.fit_decision_tree(X, y, config=jt.TreeTrainConfig(max_depth=4),
                              mesh=jm)
    td = pt.fit_decision_tree(X, y, config=pt.TreeTrainConfig(max_depth=4),
                              mesh=mesh)
    np.testing.assert_array_equal(np.asarray(jd.feature), td.feature.numpy())
    np.testing.assert_allclose(np.asarray(jd.threshold), td.threshold.numpy())
    np.testing.assert_allclose(np.asarray(jd.leaf), td.leaf.numpy(),
                               rtol=1e-5)
    jg = jt.fit_gradient_boosting(X, y, n_rounds=5,
                                  config=jt.TreeTrainConfig(max_depth=4),
                                  mesh=jm)
    tg = pt.fit_gradient_boosting(X, y, n_rounds=5,
                                  config=pt.TreeTrainConfig(max_depth=4),
                                  mesh=mesh)
    np.testing.assert_allclose(np.asarray(jpp(jg, jnp.asarray(X))),
                               predict_proba(tg, torch.from_numpy(X)).numpy(),
                               atol=1e-4)
    jf = jt.fit_random_forest(X, y, n_trees=4, tree_chunk=2, mesh=jm,
                              config=jt.TreeTrainConfig(max_depth=4))
    tf = pt.fit_random_forest(X, y, n_trees=4, tree_chunk=2, mesh=mesh,
                              config=pt.TreeTrainConfig(max_depth=4))
    np.testing.assert_array_equal(np.asarray(jf.feature), tf.feature.numpy())
    np.testing.assert_allclose(np.asarray(jf.leaf), tf.leaf.numpy(),
                               rtol=1e-5)


def test_mesh_extra_and_mismatched_mesh_refuses_resume(tree_data, tmp_path):
    from fraud_detection_tpu_torch.checkpoint import train_state as ts
    from fraud_detection_tpu_torch.models import train_trees as pt

    X, y = tree_data
    mesh = make_mesh(devices=CPU8)
    assert ts.mesh_extra(None) == {}
    assert ts.mesh_extra(mesh) == {"mesh": {
        "shape": {"data": 8, "feature": 1}, "devices": ["cpu"] * 8}}
    cfg = pt.TreeTrainConfig(max_depth=2, criterion="xgb")
    ckpt = str(tmp_path / "mesh_fp")
    pt.fit_gradient_boosting(X, y, n_rounds=4, config=cfg, device="cpu",
                             checkpoint_dir=ckpt, checkpoint_every=2)
    with pytest.raises(ValueError, match="different setup"):
        pt.fit_gradient_boosting(X, y, n_rounds=6, config=cfg, mesh=mesh,
                                 checkpoint_dir=ckpt)
    ckpt_rf = str(tmp_path / "mesh_fp_rf")
    pt.fit_random_forest(X, y, n_trees=4, config=pt.TreeTrainConfig(max_depth=2),
                         tree_chunk=2, seed=3, device="cpu",
                         checkpoint_dir=ckpt_rf)
    with pytest.raises(ValueError, match="different setup"):
        pt.fit_random_forest(X, y, n_trees=6,
                             config=pt.TreeTrainConfig(max_depth=2),
                             tree_chunk=2, seed=3, mesh=mesh,
                             checkpoint_dir=ckpt_rf)
    # on-mesh snapshots resume on the same mesh, not on another one
    ckpt_m = str(tmp_path / "on_mesh")
    full = pt.fit_gradient_boosting(X, y, n_rounds=4, config=cfg, mesh=mesh)
    pt.fit_gradient_boosting(X, y, n_rounds=2, config=cfg, mesh=mesh,
                             checkpoint_dir=ckpt_m, checkpoint_every=2)
    resumed = pt.fit_gradient_boosting(X, y, n_rounds=4, config=cfg,
                                       mesh=mesh, checkpoint_dir=ckpt_m)
    assert torch.equal(full.leaf, resumed.leaf)
    with pytest.raises(ValueError, match="different setup"):
        pt.fit_gradient_boosting(X, y, n_rounds=6, config=cfg,
                                 mesh=make_mesh(devices=["cpu"] * 4),
                                 checkpoint_dir=ckpt_m)


def test_train_cli_mesh_equals_plain_run(tmp_path):
    """train --mesh on the CPU (one device: the plain layout) reports its
    mesh and the same metrics as the run without it."""
    from fraud_detection_tpu_torch.app import train

    outs = {}
    for name, extra in (("plain", []), ("mesh", ["--mesh"])):
        path = tmp_path / f"{name}.json"
        assert train.main(["--device", "cpu", "--n", "200", "--num-features",
                           "256", "--models", "dt,xgb,lr", "--n-rounds", "4",
                           "--metrics-out", str(path), *extra]) == 0
        outs[name] = json.loads(path.read_text())
    assert outs["mesh"]["meta"]["mesh"] == {"data": 1, "feature": 1}
    assert outs["plain"]["meta"]["mesh"] is None
    assert outs["mesh"]["metrics"] == outs["plain"]["metrics"]


def test_mesh_shape_axis_is_data_axis():
    mesh = make_mesh(devices=CPU8)
    assert mesh.shape[DATA_AXIS] == 8 and mesh.local_data_parallel == 8
    assert [str(d) for d in mesh.data_devices] == ["cpu"] * 8


def test_mesh_defaults_to_the_card():
    """Without a device list a mesh is built over the card's devices, and
    without a card that raises instead of meshing the CPU."""
    from fraud_detection_tpu_torch.parallel.serving import local_device_count

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        local_device_count()
    assert local_device_count("cpu") == 1
    assert make_mesh(device_type="cpu").shape == {"data": 1, "feature": 1}


@pytest.mark.parametrize("module", ["featurize_kernel", "histogram",
                                    "attention", "int8_matmul"])
def test_kernel_self_test_runs_once_a_card(module, monkeypatch):
    """A mesh's devices name one card as "cuda" or "cuda:0": the self-test
    caches by card (``cache_per_card``), so its launches land once, not in
    a caller's later launch-count window."""
    import importlib
    from functools import lru_cache

    ops = importlib.import_module(f"fraud_detection_tpu_torch.ops.{module}")
    runs = []

    @lru_cache(maxsize=None)
    def counted(device):
        runs.append(device)
        return True

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(ops.kernel_self_test, "cached", counted)
    for spelling in ("cuda", "cuda:0", torch.device("cuda"),
                     torch.device("cuda", 0)):
        assert ops.kernel_self_test(spelling) is True
    ops.kernel_self_test("cpu")
    assert runs == [torch.device("cuda", 0), torch.device("cpu")]
