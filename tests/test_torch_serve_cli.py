"""The port's serve CLI against the JAX package's, on the CPU.

A checkpoint written by the JAX trainer (``synthetic_demo_pipeline``'s LR,
``save_checkpoint``) is served by both CLIs over ``--demo 150``: each exits
0, classifies every message, and prints the same stats keys. The port's
CLI also runs with ``--featurize-device`` and with ``--async-dispatch
--int8`` under the adaptive scheduler and refuses bad flag combinations
with the reference's messages; its parser offers every reference flag and
adds only ``--device``. ``--model synthetic`` trains the
demo LR at startup (scoring like the JAX package's demo pipeline) and
serves it under each flag variant. The explanation lane's flags
(``--explain-slots``, ``--explain-queue``, ``--explain-paged``,
``--explain-kv-pages``, ``--explain-async``, ``--annotations-topic``,
``--breaker``, ``--breaker-probe``) refuse bad values with the JAX CLI's
messages, and the slot lane serves end to end on the CPU, contiguous and
paged. ``--explain onpod:<dir>`` and ``onpod-int8:<dir>`` serve a Hugging
Face checkpoint written in the test (with a word-level tokenizer) with the
JAX CLI's classified output, analyses on exactly the flagged rows, and
refuse a missing or unloadable directory with its messages; ``--explain
deepseek`` needs a key and then builds the reference's backend. The
supervision and observability flags (``--supervise``, ``--chaos``,
``--chaos-seed``, ``--health-file``, ``--health-interval``,
``--metrics-file``, ``--metrics-interval``, ``--metrics-port``,
``--alerts``, ``--alert-rules``, ``--alert-interval``, ``--incident-dir``,
``--trace``, ``--trace-sample``, ``--profile-dir``, ``--profile-batches``)
refuse bad values with the JAX CLI's messages, ``--chaos`` implies
``--supervise 25``, and a chaos demo with every one of them on prints the
JAX CLI's stats keys. The scale-out flags (``--workers``, ``--fleet``,
``--fleet-health-file``, ``--fleet-candidates``, ``--autoscale``,
``--min-workers``, ``--max-workers``, ``--scale-cooldown``) serve the demo
with every message classified and the JAX CLI's stats keys (the fleet
view's, the autoscale and succession blocks' too), and refuse every bad
combination with the JAX CLI's message. ``--scenario NAME[:seed]`` gates a
live run on the scenario's SLOs with the JAX CLI's verdicts (exit 4 on a
violation), ``--trace-record`` dumps a complete recording that both
packages replay to the exact key set, and their bad combinations refuse
with the JAX CLI's messages.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
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
                                    "--pipeline-depth", "1"],
                                   ["--explain", "canned", "--explain-async",
                                    "--breaker", "2"]])
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


@pytest.mark.parametrize("argv", [
    ["--explain", "canned", "--explain-slots", "2"],
    ["--explain", "onpod-demo", "--explain-slots", "-1"],
    ["--explain", "onpod-demo", "--explain-slots", "2", "--explain-queue",
     "0"],
    ["--explain", "onpod-demo", "--explain-paged"],
    ["--explain", "onpod-demo", "--explain-slots", "2", "--explain-kv-pages",
     "-1"],
    ["--explain", "onpod-demo", "--explain-slots", "2", "--explain-kv-pages",
     "32"],
    ["--explain-async"],
    ["--explain", "canned", "--annotations-topic", "side"],
    ["--explain", "canned", "--breaker", "-1"],
    ["--breaker", "2"],
    ["--explain", "canned", "--breaker", "2", "--breaker-probe", "0"],
])
def test_explain_lane_refusals_equal_jax(ckpt, argv):
    argv = ["--model", ckpt, "--demo", "5", *argv]
    with pytest.raises(SystemExit) as je:
        jserve.main(argv)
    with pytest.raises(SystemExit) as te:
        tserve.main(["--device", "cpu", *argv])
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("extra", [[], ["--explain-paged", "--breaker", "3",
                                        "--annotations-topic", "side"]])
def test_slot_lane_serves_end_to_end_on_cpu(ckpt, capsys, extra):
    rc, stats, n = _serve(tserve.main, [
        "--device", "cpu", "--model", ckpt, "--demo", "120", "--batch-size",
        "64", "--max-wait", "0.01", "--explain", "onpod-demo",
        "--explain-slots", "2", "--explain-tokens", "6", *extra], capsys)
    assert rc == 0 and n == stats["processed"] == 120
    ex, lane = stats["explain"], stats["annotations"]
    assert ex["admitted"] == ex["completed"] + ex["dropped"] > 0
    assert lane["submitted"] == lane["annotated"] + lane["dropped"]
    assert ex["completed"] == lane["annotated"]
    health = stats["health"]
    assert health["device"]["featurize_path"] == "host"
    assert (health["breaker"] is not None) == ("--breaker" in extra)
    assert (ex["kv_pages"] > 0) == ("--explain-paged" in extra)


def test_synthetic_model_names_the_missing_trainer(capsys):
    # The LR trainer is ported: --model synthetic trains one at startup and
    # serves, a Spark artifact serves, and a missing artifact or checkpoint
    # directory refuses with the reference's errors.
    assert tserve.main(["--device", "cpu", "--model", "synthetic",
                        "--demo", "5"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        "classified messages on dialogues-classified: 5"
    # a Spark artifact serves (the committed fixture: bytes pyarrow wrote)
    fixture = pathlib.Path(__file__).resolve().parent / "data" / "torch_spark_fixture"
    assert tserve.main(["--device", "cpu", "--model", f"spark:{fixture}",
                        "--demo", "5"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        "classified messages on dialogues-classified: 5"
    with pytest.raises(FileNotFoundError):
        tserve.main(["--device", "cpu", "--model", "spark:x", "--demo", "5"])
    with pytest.raises(SystemExit,
                       match=r"checkpoint dir '/nowhere' not found"):
        tserve.main(["--device", "cpu", "--model", "x", "--demo", "5",
                     "--explain", "onpod:/nowhere"])


@pytest.mark.parametrize("argv", [
    ["--demo", "5", "--health-interval", "0"],
    ["--demo", "5", "--metrics-interval", "-1"],
    ["--demo", "5", "--metrics-port", "-2"],
    ["--demo", "5", "--trace-sample", "1.5"],
    ["--demo", "5", "--trace", "--trace-sample", "-0.1"],
    ["--demo", "5", "--alerts", "--alert-interval", "0"],
    ["--demo", "5", "--incident-dir", "inc", "--alert-interval", "-1"],
    ["--demo", "5", "--alert-rules", "/nowhere/rules.json"],
    ["--demo", "5", "--profile-dir", "p", "--profile-batches", "0"],
    ["--chaos"],
    ["--chaos", "--chaos-seed", "3", "--supervise", "2"],
])
def test_supervision_and_obs_flag_errors_equal_jax(ckpt, argv):
    argv = ["--model", ckpt, *argv]
    with pytest.raises(SystemExit) as je:
        jserve.main(argv)
    with pytest.raises(SystemExit) as te:
        tserve.main(["--device", "cpu", *argv])
    assert str(te.value) == str(je.value)


def test_bad_alert_rule_file_refuses_like_jax(ckpt, tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([{"name": "x", "kind": "wat"}]))
    argv = ["--model", ckpt, "--demo", "5", "--alert-rules", str(bad)]
    with pytest.raises(SystemExit) as je:
        jserve.main(argv)
    with pytest.raises(SystemExit, match="bad --alert-rules") as te:
        tserve.main(["--device", "cpu", *argv])
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("extra,want", [(["--chaos"], 25),
                                        (["--chaos", "--supervise", "3"], 3),
                                        (["--supervise", "4"], 4)])
def test_chaos_implies_supervision(ckpt, capsys, monkeypatch, extra, want):
    """``--chaos`` without ``--supervise`` supervises with 25 restarts, as
    the JAX CLI does; an explicit ``--supervise`` wins."""
    from fraud_detection_tpu_torch.stream import engine as tengine

    seen = {}
    real = tengine.run_supervised

    def spy(make_engine, **kw):
        seen.update(kw)
        return real(make_engine, **kw)

    monkeypatch.setattr(tengine, "run_supervised", spy)
    rc, stats, n = _serve(tserve.main, ["--device", "cpu", "--model", ckpt,
                                        "--demo", "300", "--batch-size", "64",
                                        "--max-wait", "0.01", "--dlq", *extra],
                          capsys)
    assert rc == 0 and seen["max_restarts"] == want
    assert ("chaos" in stats) == ("--chaos" in extra)


def test_chaos_demo_with_every_obs_flag_matches_jax_keys(ckpt, capsys,
                                                         tmp_path):
    """``--demo 300 --chaos --trace --alerts --metrics-file --health-file``
    (and the profile window) on both CLIs: exit 0, every message classified
    or dead-lettered, the same stats keys, the same health keys, and the
    port's metrics, health file and spans accounted."""
    def argv(tag):
        d = tmp_path / tag
        return ["--model", ckpt, "--demo", "300", "--batch-size", "64",
                "--max-wait", "0.01", "--dlq", "--chaos", "--chaos-seed", "7",
                "--trace", "--alerts", "--incident-dir", str(d / "inc"),
                "--metrics-file", str(d / "m.prom"),
                "--health-file", str(d / "h.json"),
                "--profile-dir", str(d / "prof"), "--profile-batches", "2"]

    jrc, jstats, _ = _serve(jserve.main, argv("jax"), capsys)
    trc, tstats, tn = _serve(tserve.main, ["--device", "cpu", *argv("port")],
                             capsys)
    assert jrc == trc == 0
    assert set(tstats) == set(jstats)
    assert set(tstats["health"]) == set(jstats["health"])
    assert tstats["restarts"] > 0 and tstats["chaos"]["total"] > 0
    assert tstats["profile"]["error"] is None
    trace = tstats["health"]["trace"]
    assert trace["spans_begun"] == trace["spans_ended"]
    assert trace["batches_traced"] == trace["batches_closed"]
    d = tmp_path / "port"
    from fraud_detection_tpu_torch.obs.metrics import (leaf_paths,
                                                       metric_name,
                                                       parse_prometheus)

    parsed = parse_prometheus((d / "m.prom").read_text())
    for path in leaf_paths(tstats["health"], ("engine",)):
        name = metric_name("fraud", path)
        assert name in parsed or name + "_count" in parsed, path
    health = json.loads((d / "h.json").read_text())
    assert health["chaos"] == tstats["chaos"]
    assert health["engines"][0]["processed"] == tstats["health"]["processed"]
    alerts = tstats["alerts"]
    bundles = [p for p in (d / "inc").iterdir() if p.is_dir()] \
        if (d / "inc").exists() else []
    assert len(bundles) == alerts["fired"]


def _block_keys(stats):
    """The stats JSON's keys, and those of its fleet-level blocks."""
    out = {"": sorted(stats)}
    for name in ("fleet", "autoscale", "succession", "death_plan"):
        if isinstance(stats.get(name), dict):
            out[name] = sorted(stats[name])
    fleet = stats.get("fleet") or {}
    for name in ("coordinator", "autoscale"):
        if isinstance(fleet.get(name), dict):
            out[f"fleet.{name}"] = sorted(fleet[name])
    alerts = stats.get("alerts")
    if isinstance(alerts, dict):
        out["alerts"] = sorted(alerts)
    elif isinstance(alerts, list):
        out["alerts"] = [sorted(a) for a in alerts]
    if stats.get("per_worker"):
        out["per_worker"] = sorted(stats["per_worker"][0])
    return out


@pytest.mark.fleet
@pytest.mark.parametrize("extra", [
    ["--fleet", "2", "--partitions", "4"],
    ["--fleet", "2", "--partitions", "4", "--fleet-candidates", "2"],
    ["--fleet", "2", "--partitions", "4", "--autoscale", "--min-workers",
     "2", "--max-workers", "3", "--scale-cooldown", "5"],
    ["--fleet", "3", "--partitions", "4", "--alerts", "--trace", "--dlq",
     "--batch-deadline-ms", "20", "--shed-policy", "reject",
     "--max-queue", "100000"],
    ["--workers", "2"],
    ["--workers", "3", "--partitions", "3", "--supervise", "2", "--alerts",
     "--trace", "--dlq"],
], ids=["fleet", "candidates", "autoscale", "fleet-obs", "workers",
        "workers-obs"])
def test_scale_out_cli_matches_jax(ckpt, capsys, extra):
    argv = ["--model", ckpt, "--demo", "300", "--batch-size", "64", *extra]
    jrc, jstats, jn = _serve(jserve.main, argv, capsys)
    trc, tstats, tn = _serve(tserve.main, ["--device", "cpu", *argv], capsys)
    assert jrc == trc == 0
    assert jn == tn == 300
    assert tstats["processed"] == jstats["processed"] == 300
    assert _block_keys(tstats) == _block_keys(jstats)
    workers = int(extra[extra.index("--fleet" if "--fleet" in extra
                                    else "--workers") + 1])
    assert tstats["workers"] >= workers
    if "--workers" in extra:
        assert sum(tstats["per_worker_processed"]) == 300
        assert len(tstats["health"]) == workers
    else:
        assert tstats["errors"] == [] and tstats["deaths"] == []
    if "--autoscale" in extra:
        scale = tstats["autoscale"]
        assert scale["provisioner"] == "thread"
        assert (scale["min"], scale["max"]) == (2, 3)
        assert scale["desired"] == 2 and scale["scale_ins"] == 0
    if "--fleet-candidates" in extra:
        succ = tstats["succession"]
        assert succ["term"] == 1 and succ["elections"] == 0
        assert succ["candidates"] == {"c0": "leading", "c1": "standby"}


@pytest.mark.fleet
def test_fleet_health_file_and_metrics_collector(ckpt, tmp_path, capsys):
    health = tmp_path / "fleet.json"
    metrics = tmp_path / "m.json"
    rc, stats, n = _serve(tserve.main, [
        "--device", "cpu", "--model", ckpt, "--demo", "300",
        "--batch-size", "64", "--fleet", "2", "--partitions", "4",
        "--fleet-health-file", str(health), "--autoscale",
        "--min-workers", "2", "--max-workers", "3", "--alerts",
        "--metrics-file", str(metrics)], capsys)
    assert rc == 0 and n == 300
    doc = json.loads(health.read_text())
    assert set(doc) == {"time", "fleet", "alerts", "workers"}
    assert set(doc["fleet"]["autoscale"]) == set(
        k for k in stats["autoscale"] if k not in ("provisioner",
                                                   "decisions"))
    assert isinstance(doc["alerts"], dict)
    assert "fleet" in json.loads(metrics.read_text())["collectors"]


@pytest.mark.fleet
@pytest.mark.parametrize("argv", [
    ["--fleet", "2"],
    ["--demo", "10", "--fleet", "-1"],
    ["--demo", "10", "--workers", "0"],
    ["--demo", "10", "--fleet", "2", "--workers", "3"],
    ["--demo", "10", "--fleet", "2", "--supervise", "3"],
    ["--demo", "10", "--fleet", "2", "--max-messages", "5"],
    ["--demo", "10", "--fleet", "2", "--chaos"],
    ["--demo", "10", "--fleet", "2", "--explain", "canned"],
    ["--demo", "10", "--workers", "2", "--max-messages", "5"],
    ["--demo", "10", "--fleet-health-file", "f.json"],
    ["--demo", "10", "--fleet-candidates", "0"],
    ["--demo", "10", "--fleet-candidates", "2"],
    ["--demo", "10", "--min-workers", "2"],
    ["--demo", "10", "--fleet", "2", "--max-workers", "3"],
    ["--demo", "10", "--autoscale"],
    ["--demo", "10", "--fleet", "2", "--autoscale", "--min-workers", "3"],
    ["--demo", "10", "--fleet", "2", "--autoscale", "--max-workers", "1"],
    ["--demo", "10", "--fleet", "2", "--autoscale", "--min-workers", "0"],
    ["--demo", "10", "--fleet", "2", "--autoscale", "--scale-cooldown",
     "-1"],
])
def test_scale_out_refusals_equal_jax(ckpt, argv):
    argv = ["--model", ckpt, *argv]
    with pytest.raises(SystemExit) as je:
        jserve.main(argv)
    with pytest.raises(SystemExit) as te:
        tserve.main(["--device", "cpu", *argv])
    assert str(te.value) == str(je.value)


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


SYNTHETIC_P_TOL = 1e-3   # demo LR probabilities, port vs JAX, at n=200


def test_synthetic_demo_pipeline_equals_jax():
    """The demo pipeline (the same corpus, featurizer and 50-iteration
    L-BFGS fit) scores like the JAX package's: labels equal, probabilities
    within SYNTHETIC_P_TOL."""
    from fraud_detection_tpu.data import generate_corpus
    from fraud_detection_tpu_torch.models.pipeline import (
        synthetic_demo_pipeline as port_demo)

    texts = [d.text for d in generate_corpus(n=400, seed=123)]
    want = synthetic_demo_pipeline(batch_size=64, n=200).predict(texts)
    port = port_demo(batch_size=64, n=200, device="cpu")
    got = port.predict(texts)
    assert port.model.weights.shape == (10000,)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_allclose(got.probabilities, want.probabilities, rtol=0,
                               atol=SYNTHETIC_P_TOL)


@pytest.mark.parametrize("extra", [["--int8"], ["--featurize-device"],
                                   ["--async-dispatch"]])
def test_synthetic_model_serves_with_each_variant(capsys, extra):
    rc, stats, n = _serve(tserve.main, ["--device", "cpu", "--model",
                                        "synthetic", "--demo", "64",
                                        "--batch-size", "32", *extra], capsys)
    assert rc == 0 and n == 64 and stats["processed"] == 64
    device = stats["health"]["device"]
    assert device["featurize_path"] == ("torch" if "--featurize-device" in extra
                                        else "host")
    assert device["int8"] is ("--int8" in extra)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A tiny Llama checkpoint (``tests/test_hf_convert.py``'s layout) with
    a word-level tokenizer that ``transformers`` loads from its files."""
    from tests.test_torch_hf_convert import state, write_dir, write_tokenizer

    path = tmp_path_factory.mktemp("hf")
    hf, st = state("llama_gqa", seed=21)
    write_dir(path, hf, st)
    write_tokenizer(path)
    return str(path)


def _recording_brokers(monkeypatch):
    """Record every demo broker the two CLIs build."""
    from fraud_detection_tpu import stream as jstream
    from fraud_detection_tpu_torch import stream as tstream

    made = {}
    for name, mod in (("jax", jstream), ("port", tstream)):
        base = mod.InProcessBroker

        class Recording(base):
            def __init__(self, *a, _name=name, **kw):
                super().__init__(*a, **kw)
                made[_name] = self

        monkeypatch.setattr(mod, "InProcessBroker", Recording)
    return made


@pytest.mark.parametrize("spec", ["onpod", "onpod-int8"])
def test_explain_hf_checkpoint_matches_jax_cli(ckpt, hf_dir, capsys,
                                               monkeypatch, spec):
    """Both CLIs serve the same checkpoint directory (bf16 on the CPU):
    exit 0, every message classified with equal labels and confidences, and
    an analysis on exactly the flagged rows. The analyses' tokens may differ:
    bf16 products of XLA and torch can round a near-tie apart (token
    equality is held in f32 by tests/test_torch_int8.py and
    tests/test_torch_llm.py)."""
    brokers = _recording_brokers(monkeypatch)
    argv = ["--model", ckpt, "--demo", "60", "--explain",
            f"{spec}:{hf_dir}", "--explain-tokens", "4"]
    jrc, jstats, jn = _serve(jserve.main, argv, capsys)
    trc, tstats, tn = _serve(tserve.main, ["--device", "cpu", *argv], capsys)
    assert jrc == trc == 0 and jn == tn == 60
    assert set(tstats) == set(jstats)
    frames = {name: {m.key: json.loads(m.value)
                     for m in b.messages("dialogues-classified")}
              for name, b in brokers.items()}
    assert frames["port"].keys() == frames["jax"].keys()
    flagged = 0
    for key, jf in frames["jax"].items():
        tf = frames["port"][key]
        assert (tf["prediction"], tf["label"], tf["original_text"]) == \
            (jf["prediction"], jf["label"], jf["original_text"])
        assert abs(tf["confidence"] - jf["confidence"]) <= 1e-5
        for f in (jf, tf):
            assert ("analysis" in f) == (f["prediction"] != 0)
            assert isinstance(f.get("analysis", ""), str)
        flagged += jf["prediction"] != 0
    assert flagged > 0


def test_explain_checkpoint_refusals_equal_jax(ckpt, tmp_path, monkeypatch):
    """A missing directory, one without a checkpoint and one without a
    tokenizer refuse with the JAX CLI's messages; so does deepseek without
    its key."""
    from tests.test_torch_hf_convert import state, write_dir

    monkeypatch.delenv("DEEPSEEK_API_KEY", raising=False)
    no_tok = tmp_path / "no_tokenizer"
    no_tok.mkdir()
    write_dir(no_tok, *state("llama_gqa"))
    for spec in ("onpod:/nowhere", "onpod-int8:", f"onpod:{tmp_path}",
                 f"onpod-int8:{no_tok}", "deepseek"):
        argv = ["--model", ckpt, "--demo", "5", "--explain", spec]
        with pytest.raises(SystemExit) as je:
            jserve.main(argv)
        with pytest.raises(SystemExit) as te:
            tserve.main(["--device", "cpu", *argv])
        assert str(te.value) == str(je.value), spec
    assert "needs DEEPSEEK_API_KEY" in str(te.value)


def test_explain_deepseek_builds_the_reference_backend(ckpt, capsys,
                                                       monkeypatch):
    """With a key, ``--explain deepseek`` builds the backend of
    ``LLMConfig.make_backend`` (the reference's base URL and model) at the
    reference agent's temperature, 1.0. No request is made: the backend's
    transport is replaced by one that answers in-process."""
    from fraud_detection_tpu.utils.config import LLMConfig as JLLMConfig
    from fraud_detection_tpu_torch.explain.backends import OpenAIChatBackend
    from fraud_detection_tpu_torch.utils.config import LLMConfig

    monkeypatch.setenv("DEEPSEEK_API_KEY", "k-test")
    monkeypatch.delenv("LLM_TEMPERATURE", raising=False)
    monkeypatch.delenv("LLM_BASE_URL", raising=False)
    monkeypatch.delenv("LLM_MODEL", raising=False)
    want = JLLMConfig.from_env().make_backend(transport=lambda *a, **k: None)
    got = LLMConfig.from_env().make_backend(transport=lambda *a, **k: None)
    assert isinstance(got, OpenAIChatBackend)
    for field in ("base_url", "model", "api_key", "timeout", "max_attempts"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.base_url, got.model) == ("https://api.deepseek.com/v1",
                                         "deepseek-chat")

    calls = []

    class Reply:
        status_code = 200

        def raise_for_status(self):
            pass

        def json(self):
            return {"choices": [{"message": {"content": "an analysis"}}]}

    def transport(url, **kw):
        calls.append((url, kw["json"]["model"], kw["json"]["temperature"]))
        return Reply()

    real = LLMConfig.make_backend
    monkeypatch.setattr(LLMConfig, "make_backend",
                        lambda self, **kw: real(self, transport=transport))
    rc, stats, n = _serve(tserve.main, [
        "--device", "cpu", "--model", ckpt, "--demo", "40", "--explain",
        "deepseek", "--explain-tokens", "8"], capsys)
    assert rc == 0 and n == 40
    assert calls and all(c == ("https://api.deepseek.com/v1/chat/completions",
                               "deepseek-chat", 1.0) for c in calls)


# ---------------------------------------------------------------------------
# --scenario and --trace-record
# ---------------------------------------------------------------------------

def _scenario_run(main, argv, capsys):
    rc = main(argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    return rc, json.loads(lines[-1])


def test_scenario_and_trace_record_replay_exactly(ckpt, tmp_path, capsys):
    """A live --scenario run gates on the scenario's SLOs and its
    --trace-record recording replays to the exact key set in both
    packages; the scenario block reads like the JAX CLI's."""
    from fraud_detection_tpu.models.pipeline import ServingPipeline as JPipe
    from fraud_detection_tpu.scenarios import run_replay as jreplay
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from fraud_detection_tpu_torch.scenarios import run_replay

    argv = ["--model", ckpt, "--demo", "1", "--batch-size", "256",
            "--scenario", "diurnal_hotkey:3", "--scenario-scale", "0.25",
            "--scenario-time-scale", "0"]
    rec = tmp_path / "run.jsonl"
    rc, out = _scenario_run(tserve.main, ["--device", "cpu", *argv,
                                          "--trace-record", str(rec)],
                            capsys)
    assert rc == 0
    sc = out["scenario"]
    assert sc["name"] == "diurnal_hotkey" and sc["seed"] == 3
    assert sc["ok"] is True and sc["fed"] == sc["planned"] > 0
    assert {"exact_accounting", "spans_exact"} <= {v["name"]
                                                   for v in sc["verdicts"]}
    assert out["trace_record"]["complete"] is True
    assert out["trace_record"]["spans"] > sc["planned"]
    jrc, jout = _scenario_run(jserve.main, [*argv, "--trace"], capsys)
    assert jrc == 0
    jsc = jout["scenario"]
    assert ([(v["name"], v["ok"], v["skipped"]) for v in sc["verdicts"]]
            == [(v["name"], v["ok"], v["skipped"]) for v in jsc["verdicts"]])
    assert (sc["fed"], sc["planned"]) == (jsc["fed"], jsc["planned"])
    tpipe = ServingPipeline.from_checkpoint(ckpt, device="cpu",
                                            batch_size=256)
    jpipe = JPipe.from_checkpoint(ckpt, batch_size=256)
    for report in (run_replay(str(rec), tpipe), jreplay(str(rec), jpipe)):
        assert report["keys_exact"] is True
        assert report["rows"] == report["fed"] == sc["planned"]


def test_scenario_slo_failure_exits_4_like_jax(ckpt, capsys):
    """flash_crowd without any shed flags: the admission_shed_bit gate
    fails and both CLIs exit 4."""
    argv = ["--model", ckpt, "--demo", "1", "--batch-size", "256",
            "--scenario", "flash_crowd:3", "--scenario-scale", "0.2",
            "--scenario-time-scale", "0"]
    results = []
    for main, extra in ((jserve.main, []), (tserve.main,
                                            ["--device", "cpu"])):
        rc, out = _scenario_run(main, [*extra, *argv], capsys)
        sc = out["scenario"]
        failed = {v["name"] for v in sc["verdicts"]
                  if not v["ok"] and not v["skipped"]}
        results.append((rc, sc["ok"], failed, sc["planned"]))
    assert results[1] == results[0]
    rc, ok, failed, _ = results[1]
    assert rc == 4 and ok is False and "admission_shed_bit" in failed


@pytest.mark.parametrize("argv", [
    ["--scenario", "flash_crowd"],
    ["--demo", "100", "--workers", "2", "--scenario", "flash_crowd"],
    ["--demo", "100", "--fleet", "2", "--scenario", "flash_crowd"],
    ["--demo", "100", "--scenario", "no_such_scenario"],
    ["--demo", "100", "--scenario", "flash_crowd:x"],
    ["--demo", "100", "--scenario", "flash_crowd", "--scenario-scale", "0"],
    ["--demo", "100", "--scenario", "flash_crowd",
     "--scenario-time-scale", "-1"],
    ["--demo", "100", "--fleet", "2", "--trace-record", "/tmp/x.jsonl"],
    ["--demo", "100", "--workers", "2", "--trace-record", "/tmp/x.jsonl"],
])
def test_scenario_refusals_equal_jax(ckpt, argv):
    """The JAX CLI's messages; where one names the game-day CLI's module,
    the port's names its own."""
    argv = ["--model", ckpt, *argv]
    with pytest.raises(SystemExit) as je:
        jserve.main(argv)
    with pytest.raises(SystemExit) as te:
        tserve.main(["--device", "cpu", *argv])
    assert str(te.value) == str(je.value).replace(
        "fraud_detection_tpu.", "fraud_detection_tpu_torch.")


def test_scenario_with_kafka_refuses_naming_its_item(ckpt):
    """Both packages refuse --scenario with --kafka with the same message:
    the scenario feeds the in-process broker, so it needs --demo."""
    with pytest.raises(SystemExit, match="--scenario needs --demo") as je:
        jserve.main(["--model", ckpt, "--kafka", "--scenario",
                     "flash_crowd"])
    with pytest.raises(SystemExit, match="--scenario needs --demo") as te:
        tserve.main(["--device", "cpu", "--model", ckpt, "--kafka",
                     "--scenario", "flash_crowd"])
    assert str(te.value) == str(je.value)
