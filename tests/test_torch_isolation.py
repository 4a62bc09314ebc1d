"""The PyTorch port stands alone: importing every module of
``fraud_detection_tpu_torch`` (and ``chip_smoke``) loads neither jax nor any
module of the JAX package, and without a CUDA device its entry points
refuse to run unless the caller asks for the CPU."""

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
             or m == "fraud_detection_tpu" or m.startswith("fraud_detection_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
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
                 "sched.scheduler", "sched.batcher", "utils.config"):
        assert f"fraud_detection_tpu_torch.{name}" in out["modules"]
    assert out["bad"] == []


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
    from fraud_detection_tpu_torch.models import train_trees

    X = np.random.default_rng(0).random((20, 4)).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.float32)
    for fit in (train_trees.fit_decision_tree, train_trees.fit_random_forest,
                train_trees.fit_gradient_boosting):
        with pytest.raises(RuntimeError, match="cuda"):
            fit(X, y)
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--n", "20", "--models", "dt"])
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


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = _run([str(ROOT / "chip_smoke.py")], ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = _run(["chip_smoke.py"], tmp_path)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout
