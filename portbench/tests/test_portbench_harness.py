"""The harness finds everything by the names in BENCHMARK.json, the file
keeps to the benchmark's contract, and nothing it loads is JAX."""

import json
import re
import subprocess
import sys

import pytest

import harness
from reference.imports import FORBIDDEN, forbidden_modules

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_has_exactly_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for n in names + [m["name"] for m in metrics]:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_setup_another_e2e_metric_and_a_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in harness.cell_metrics(BENCH, w["name"], False)]
        layer = harness.cell_metrics(BENCH, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_configs_traffic_drivers_and_readers_are_found_by_name():
    for w in BENCH["workloads"]:
        cfg = harness.config(BENCH, w["config"])
        assert cfg["reduced"] == []
        mix = harness.traffic(w["traffic"])
        assert hasattr(harness.driver(mix["driver"]), "run")
        assert (harness.BENCH_DIR / "limits" / f"{w['name']}.json").exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]).read), m["name"]


def test_readers_return_none_when_nothing_was_recorded():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert harness.reader(m["name"]).read({}) is None, m["name"]


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        harness.workload(BENCH, "no_such_cell")
    with pytest.raises(KeyError):
        harness.config(BENCH, "no_such_config")


def test_config_files_hold_every_width():
    for c in BENCH["configs"]:
        cfg = harness.config(BENCH, c["name"])
        for key in ("hidden_size", "num_hidden_layers", "num_attention_heads",
                    "num_key_value_heads", "head_dim", "intermediate_size",
                    "vocab_size", "max_position_embeddings", "dtype"):
            assert key in cfg, (c["name"], key)
        assert cfg["source"] == c["source"]
        assert cfg["head_dim"] * cfg["num_attention_heads"] == cfg["hidden_size"]


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("fraud_detection_tpu", True),
    ("fraud_detection_tpu.models", True), ("fraud_detection_tpu_torch", False),
    ("fraud_detection_tpu_torch.models.llm", False), ("jaxtyping", False),
    ("numpy", False)])
def test_import_check_compares_whole_top_level_names(name, bad):
    assert (forbidden_modules([name]) == [name]) is bad
    assert FORBIDDEN >= {"jax", "jaxlib", "flax", "fraud_detection_tpu"}


def test_nothing_the_benchmark_runs_loads_jax():
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "import harness, run, calibrate, served, program, weights\n"
        "import drivers.slot_batch\n"
        "from reference import decoder\n"
        "import fraud_detection_tpu_torch.explain.slotserve\n"
        "import fraud_detection_tpu_torch.stream.engine\n"
        "from reference.imports import forbidden_modules\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code, str(harness.BENCH_DIR),
                          str(harness.ROOT)], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path[:0] = [sys.argv[1]]\n"
        "from reference import decoder\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0].startswith('fraud_detection')))\n")
    out = subprocess.run([sys.executable, "-c", code, str(harness.BENCH_DIR)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
    importing = re.compile(r"^\s*(from|import)\s+fraud_detection", re.M)
    for path in (harness.BENCH_DIR / "reference").glob("*.py"):
        assert not importing.search(path.read_text()), path


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cell = BENCH["workloads"][0]["name"]
    out = subprocess.run([sys.executable, str(harness.BENCH_DIR / "run.py"),
                          "--workload", cell, "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_result_line_keys_and_checks_last():
    ctx = harness.Context(cell=BENCH["workloads"][0], cfg={}, mix={}, seed=1,
                          seconds=1.0, trace=False, device=_cpu(), started=0.0)
    ctx.rec.update(setup_s=3.0)
    ctx.check("gap", 0.1, 0.2)
    line = harness.result(ctx, BENCH)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"]["setup_s"] == {"value": 3.0, "unit": "s"}
    ctx.check("gap2", 0.3, 0.2)
    assert harness.result(ctx, BENCH)["correct"] is False
    json.dumps(line)


def _cpu():
    import torch
    return torch.device("cpu")
