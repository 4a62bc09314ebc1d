"""The PyTorch port stands alone: importing every module of
``fraud_detection_tpu_torch`` (and ``chip_smoke``, and every example twin
``examples/torch_*.py``) loads neither jax, nor optax, nor pyarrow, nor any
module of the JAX package; flightcheck and the sanitizer driver do not even
load torch; reading and writing Spark artifacts loads no pyarrow; and
without a CUDA device its entry points, the example twins' among them,
refuse to run unless the caller asks for the CPU."""

import importlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import fraud_detection_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "optax" or m.startswith("optax.")
             or m == "pyarrow" or m.startswith("pyarrow.")
             or m == "fraud_detection_tpu" or m.startswith("fraud_detection_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


EXAMPLE_TWINS = ("torch_serve_quickstart", "torch_streaming_demo",
                 "torch_train_quickstart", "torch_convert_hf_checkpoint",
                 "torch_hot_swap_demo", "torch_drift_loop_demo",
                 "torch_game_day_demo")

_IMPORT_EXAMPLES = """
import importlib, json, pathlib, sys
names = sorted(p.stem for p in pathlib.Path("examples").glob("torch_*.py"))
for n in names:
    importlib.import_module("examples." + n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax",
                                    "fraud_detection_tpu"))
print(json.dumps({"examples": names, "bad": bad}))
"""


def _run(args, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT) if cwd == ROOT else "")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_no_jax_and_no_jax_package():
    proc = _run(["-c", _IMPORT_ALL], ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "fraud_detection_tpu_torch.ops.featurize_kernel" in out["modules"]
    assert "fraud_detection_tpu_torch.stream.engine" in out["modules"]
    for name in ("ops.histogram", "models.train_trees", "app.train",
                 "checkpoint.native", "data.loader", "eval.metrics",
                 "ops.attention", "models.llm", "explain.onpod",
                 "explain.agent", "explain.history", "explain.circuit",
                 "app.serve", "featurize.native", "featurize.parallel",
                 "sched.scheduler", "sched.batcher", "utils.config",
                 "models.train_linear", "checkpoint.train_state",
                 "eval.word_associations", "registry.registry",
                 "utils.atomicio", "registry.hotswap", "registry.shadow",
                 "registry.promote", "learn.loop", "learn.store",
                 "stream.feedback", "scenarios.traffic",
                 "explain.slotserve", "explain.slotserve.decode",
                 "explain.slotserve.service", "stream.annotations",
                 "checkpoint.hf_convert", "ops.int8_matmul",
                 "stream.faults", "obs", "obs.trace", "obs.metrics",
                 "obs.export", "obs.sentinel", "obs.sentinel.rules",
                 "obs.sentinel.engine", "obs.sentinel.bundle",
                 "utils.tracing", "scenarios", "scenarios.clock",
                 "scenarios.slo", "scenarios.labels", "scenarios.record",
                 "scenarios.replay", "scenarios.gameday", "analysis",
                 "analysis.core", "analysis.entrypoints",
                 "analysis.conformance", "analysis.callgraph",
                 "analysis.checker", "analysis.concurrency",
                 "analysis.health", "analysis.model", "analysis.protocol",
                 "analysis.synclint", "analysis.threads", "analysis.traces",
                 "analysis.sarif", "analysis.fixer", "analysis.cache",
                 "analysis.__main__", "stream.kafka", "parallel",
                 "parallel.mesh", "parallel.serving", "checkpoint.parquet",
                 "checkpoint.spark_artifact", "checkpoint.spark_writer",
                 "eval.report", "app.ui", "app.ui_helpers", "app.chat"):
        assert f"fraud_detection_tpu_torch.{name}" in out["modules"]
    assert out["bad"] == []


def test_example_twins_import_no_jax_and_no_jax_package():
    proc = _run(["-c", _IMPORT_EXAMPLES], ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"examples": sorted(EXAMPLE_TWINS), "bad": []}


@pytest.mark.parametrize("name", EXAMPLE_TWINS)
def test_example_twin_refuses_without_cuda(name, capsys):
    """A twin run with its JAX example's arguments (none) asks for the
    card, and refuses; ``--device cpu`` is the way to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    twin = importlib.import_module(f"examples.{name}")
    with pytest.raises(RuntimeError, match="cuda"):
        twin.main([])


_ANALYSIS_AND_SAN_DRIVER = """
import contextlib, io, json, runpy, sys
from fraud_detection_tpu_torch.analysis import run_analysis
from fraud_detection_tpu_torch.analysis.__main__ import main
findings, suppressed, n_files = run_analysis()
with contextlib.redirect_stdout(io.StringIO()):
    rc_model = main(["model", "--json", "--keys", "1"])
sys.argv = ["san_driver.py", "--threads", "2", "--rounds", "1",
            "--rows", "64"]
out = io.StringIO()
with contextlib.redirect_stdout(out):
    try:
        runpy.run_path(SAN_DRIVER, run_name="__main__")
    except SystemExit as e:
        rc_san = e.code
print(json.dumps({
    "findings": len(findings), "rc_model": rc_model, "rc_san": rc_san,
    "passed": "all checks passed" in out.getvalue(),
    "bad": sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "torch",
                                         "fraud_detection_tpu"))}))
"""


def test_analysis_and_san_driver_load_no_jax_and_no_torch():
    """flightcheck (the analyzers, the model checker) and the sanitizer
    driver run without jax, the JAX package or even torch."""
    driver = ROOT / "fraud_detection_tpu_torch" / "native" / "san_driver.py"
    code = _ANALYSIS_AND_SAN_DRIVER.replace("SAN_DRIVER", repr(str(driver)))
    proc = _run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"findings": 0, "rc_model": 0, "rc_san": 0,
                   "passed": True, "bad": []}


_SPARK_ROUND_TRIP = """
import json, sys
from fraud_detection_tpu_torch.checkpoint import (load_spark_pipeline,
                                                  save_spark_pipeline)
from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
art = load_spark_pipeline(sys.argv[1])
pipe = ServingPipeline.from_spark_artifact(art, device="cpu")
save_spark_pipeline(sys.argv[2], pipe.featurizer, pipe.model)
again = load_spark_pipeline(sys.argv[2])
print(json.dumps({"stages": len(again.stages),
                  "pyarrow": sorted(m for m in sys.modules
                                    if m.split(".")[0] == "pyarrow")}))
"""


def test_spark_artifacts_load_no_pyarrow(tmp_path):
    """The Spark modules read the committed fixture (pyarrow's bytes) and
    write and re-read an artifact with the port's own parquet codec."""
    fixture = ROOT / "tests" / "data" / "torch_spark_fixture"
    proc = _run(["-c", _SPARK_ROUND_TRIP, str(fixture), str(tmp_path / "out")],
                ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"stages": 5, "pyarrow": []}


def test_no_cuda_means_no_silent_cpu_serving():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from fraud_detection_tpu_torch import convert
    from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline

    feat = HashingTfIdfFeaturizer(num_features=64)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.logistic_from_arrays(np.zeros(64), 0.0)
    model = convert.logistic_from_arrays(np.zeros(64), 0.0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingPipeline(feat, model)
    with pytest.raises(RuntimeError, match="cuda"):
        ServingPipeline(feat, model, featurize_device=True)
    assert ServingPipeline(feat, model, device="cpu").predict(["hi"]).labels.shape == (1,)


def test_no_cuda_means_no_silent_cpu_training(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from fraud_detection_tpu_torch.app import train
    from fraud_detection_tpu_torch.checkpoint.native import load_checkpoint
    from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
    from fraud_detection_tpu_torch.models import train_trees

    from fraud_detection_tpu_torch.models.pipeline import synthetic_demo_pipeline
    from fraud_detection_tpu_torch.models.train_linear import (
        fit_logistic_regression)
    from fraud_detection_tpu_torch.registry import ModelRegistry

    X = np.random.default_rng(0).random((20, 4)).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.float32)
    for fit in (train_trees.fit_decision_tree, train_trees.fit_random_forest,
                train_trees.fit_gradient_boosting, fit_logistic_regression):
        with pytest.raises(RuntimeError, match="cuda"):
            fit(X, y)
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--n", "20", "--models", "dt"])
    with pytest.raises(RuntimeError, match="cuda"):
        synthetic_demo_pipeline(n=20, num_features=16)
    registry = ModelRegistry(str(tmp_path / "registry"))
    registry.publish(HashingTfIdfFeaturizer(num_features=4),
                     fit_logistic_regression(X, y, device="cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        registry.load(1)
    with pytest.raises(RuntimeError, match="cuda"):
        load_checkpoint(str(tmp_path))


def test_no_cuda_means_no_silent_cpu_llm():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from fraud_detection_tpu_torch import convert
    from fraud_detection_tpu_torch.explain.history import HistoricalCaseStore
    from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
    from fraud_detection_tpu_torch.models.llm import (LanguageModel,
                                                      TransformerConfig)

    cfg = TransformerConfig(d_model=16, n_heads=2, n_layers=1, d_ff=32)
    with pytest.raises(RuntimeError, match="cuda"):
        LanguageModel.init_random(cfg)
    lm = LanguageModel.init_random(cfg, device="cpu")
    arrays = {n: lm.params.param(n).numpy() for n in lm.params.param_names()}
    with pytest.raises(RuntimeError, match="cuda"):
        convert.llm_params_from_arrays(cfg, arrays)
    assert convert.llm_params_from_arrays(cfg, arrays, device="cpu").device.type == "cpu"
    assert lm.generate_tokens_batch([[cfg.BOS, 65]], max_new_tokens=2).shape == (1, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        HistoricalCaseStore(HashingTfIdfFeaturizer(num_features=16), ["a"], [0])


def test_no_cuda_means_no_silent_cpu_checkpoint_load(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from fraud_detection_tpu_torch.checkpoint.hf_convert import (
        load_hf_checkpoint)
    from fraud_detection_tpu_torch.explain import OnPodBackend

    for load in (load_hf_checkpoint, OnPodBackend.from_hf_checkpoint):
        with pytest.raises(RuntimeError, match="cuda"):
            load(str(tmp_path), tokenizer="byte")


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = _run([str(ROOT / "chip_smoke.py")], ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = _run(["chip_smoke.py"], tmp_path)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout
