"""The port's serve CLI against the JAX package's, on the CPU.

A checkpoint written by the JAX trainer (``synthetic_demo_pipeline``'s LR,
``save_checkpoint``) is served by both CLIs over ``--demo 150``: each exits
0, classifies every message, and prints the same stats keys. The port's
CLI also runs with ``--featurize-device`` and with ``--async-dispatch
--int8`` under the adaptive scheduler, refuses bad flag combinations with
the reference's messages, and refuses every reference flag it does not
offer yet by naming its ROADMAP item.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from fraud_detection_tpu.app import serve as jserve
from fraud_detection_tpu.checkpoint.native import save_checkpoint
from fraud_detection_tpu.models.pipeline import synthetic_demo_pipeline
from fraud_detection_tpu_torch.app import serve as tserve

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    pipe = synthetic_demo_pipeline(batch_size=64, n=200, seed=7,
                                   num_features=2048)
    path = tmp_path_factory.mktemp("serve") / "lr"
    save_checkpoint(str(path), pipe.featurizer, pipe.model)
    return str(path)


def _serve(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    stats = json.loads(out[-2])
    assert out[-1].startswith("classified messages on dialogues-classified: ")
    return rc, stats, int(out[-1].rsplit(":", 1)[1])


@pytest.mark.parametrize("extra", [[], ["--dlq", "--batch-size", "64"],
                                   ["--explain", "canned",
                                    "--pipeline-depth", "1"]])
def test_cli_matches_jax(ckpt, capsys, extra):
    argv = ["--model", ckpt, "--demo", "150", *extra]
    jrc, jstats, jn = _serve(jserve.main, argv, capsys)
    trc, tstats, tn = _serve(tserve.main, ["--device", "cpu", *argv], capsys)
    assert jrc == trc == 0
    assert jn == tn == 150
    assert set(tstats) == set(jstats)
    assert tstats["processed"] == jstats["processed"] == 150
    assert tstats["malformed"] == jstats["malformed"] == 0
    health = tstats["health"]
    if "--explain" in extra:
        assert health["device"]["featurize_path"] == "host"
    else:
        assert health["device"]["uploads_per_batch"] == 1.0


@pytest.mark.parametrize("extra", [
    ["--featurize-device", "--featurize-width", "4096"],
    ["--async-dispatch", "--int8", "--batch-deadline-ms", "20",
     "--shed-policy", "adaptive", "--target-p99-ms", "500",
     "--batch-size", "64"],
])
def test_cli_variants(ckpt, capsys, extra):
    rc, stats, n = _serve(tserve.main, ["--device", "cpu", "--model", ckpt,
                                        "--demo", "150", *extra], capsys)
    assert rc == 0
    device = stats["health"]["device"]
    if "--featurize-device" in extra:
        assert n == stats["processed"] == 150
        assert device["featurize_path"] == "torch"
        assert device["truncated_rows"] == 0
    else:
        # shed rows go to the DLQ as records: out + shed == fed
        assert n + stats["shed"] == stats["processed"] == 150
        assert device["async_dispatch"] is True and device["int8"] is True
        assert device["lane_batches"] == stats["batches"]
        sched = stats["health"]["sched"]
        assert sched["admission"]["policy"] == "adaptive"
        assert sched["ladder_cost_ms"] and sched["buckets"][-1] == 64


@pytest.mark.parametrize("argv", [
    ["--demo", "5", "--pipeline-depth", "0"],
    ["--demo", "5", "--kafka"],
    ["--demo", "5", "--featurize-width", "64"],
    ["--demo", "5", "--shed-policy", "adaptive"],
    ["--demo", "5", "--dlq-max-attempts", "0"],
    ["--demo", "5", "--explain-tokens", "0"],
    ["--demo", "5", "--partitions", "0"],
    [],
])
def test_validation_errors_equal_jax(ckpt, argv):
    argv = ["--model", ckpt, *argv]
    with pytest.raises(SystemExit) as je:
        jserve.main(argv)
    with pytest.raises(SystemExit) as te:
        tserve.main(["--device", "cpu", *argv])
    assert str(te.value) == str(je.value)


def test_synthetic_model_names_the_missing_trainer():
    with pytest.raises(SystemExit, match=r"train_linear.*Queue 1 item 4"):
        tserve.main(["--device", "cpu", "--model", "synthetic", "--demo", "5"])
    with pytest.raises(SystemExit, match=r"pyarrow.*Queue 1 item 6"):
        tserve.main(["--device", "cpu", "--model", "spark:x", "--demo", "5"])
    with pytest.raises(SystemExit, match=r"Queue 1 item 7"):
        tserve.main(["--device", "cpu", "--model", "x", "--demo", "5",
                     "--explain", "onpod:/nowhere"])


@pytest.mark.parametrize("flag,takes_value,item", tserve._UNPORTED)
def test_unported_flag_refuses_cleanly(ckpt, flag, takes_value, item):
    argv = ["--device", "cpu", "--model", ckpt, flag]
    if takes_value:
        argv.append("1")
    with pytest.raises(SystemExit, match=f"{flag} is not ported .*Queue 1 "
                                         f"item {item}"):
        tserve.main(argv)


def _flags(main, monkeypatch):
    """The option strings ``main``'s parser defines."""
    import argparse

    seen = set()

    def grab(self, *a, **kw):
        seen.update(s for act in self._actions for s in act.option_strings)
        raise SystemExit(0)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(SystemExit):
            main([])
    return seen


def test_every_reference_flag_is_offered_or_refused(monkeypatch):
    """No silent ignore: the port's parser knows every reference flag (the
    unported ones refuse) and adds only --device."""
    tflags, jflags = _flags(tserve.main, monkeypatch), _flags(jserve.main,
                                                              monkeypatch)
    assert tflags - jflags == {"--device"}
    assert jflags <= tflags


def test_default_device_is_the_card(ckpt):
    """Without --device the CLI serves on cuda, and without a card it raises
    instead of serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--model", ckpt, "--demo", "5"])


def test_module_entry_point_serves_on_cpu(ckpt):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "fraud_detection_tpu_torch.app.serve",
         "--device", "cpu", "--model", ckpt, "--demo", "150"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "classified messages on dialogues-classified: 150"
    health = json.loads(lines[-2])["health"]
    assert health["device"]["featurize_path"] == "host"
