"""The port's single-engine game days on the CPU, beside the JAX package's.

Warp runs (``time_scale`` 0) of the catalog's single-engine scenarios at
small scales on the JAX demo pipeline's arrays carried into the port (the
same model in both packages): flash_crowd, campaign_breaker, chaos_storm
and diurnal_hotkey. Each asserts what the JAX package's own test of it
asserts, and the gates whose verdict does not hang on timing (accounting,
spans, errors, the breaker's trip) read the same as the JAX run's on the
same seed and scale, over the same gate names. The
game-day CLI's exit code gates (a broken SLO exits 1), and the port's
``evaluate`` judges evidence captured from a JAX run as the JAX package
does.
"""

import json

import pytest

from fraud_detection_tpu.scenarios import gameday as Jgd
from fraud_detection_tpu.scenarios import slo as Jslo
from fraud_detection_tpu_torch.scenarios import gameday as Tgd
from fraud_detection_tpu_torch.scenarios import slo as Tslo

from torch_parity import gameday_pipelines, gameday_twins


@pytest.fixture(scope="module")
def pipelines():
    return gameday_pipelines()


def test_flash_crowd_sheds_and_detects_the_burn(pipelines):
    _, result = gameday_twins("flash_crowd", 0, 0.4, pipelines)
    assert result.ok, result.table()
    verdicts = {v.name: v for v in result.report.verdicts}
    assert verdicts["detects_shed_burn"].ok
    assert verdicts["admission_shed_bit"].ok
    assert result.evidence["stats"]["shed"] >= 1
    assert result.evidence["dlq_rows"] == result.evidence["stats"]["shed"]
    alerts = result.evidence["alerts"]
    assert alerts["fired"] == alerts["resolved"] + alerts["still_firing"]


def test_campaign_breaker_trips_while_classification_flows(pipelines):
    _, result = gameday_twins("campaign_breaker", 5, 0.3, pipelines)
    assert result.ok, result.table()
    assert result.evidence["breaker"]["opens"] >= 1
    assert result.evidence["breaker"]["state"] == "open"
    assert result.evidence["flaky_backend_calls"] >= 1
    assert result.evidence["out_rows"] == result.evidence["planned"]


def test_chaos_storm_converges_with_zero_loss(pipelines):
    _, result = gameday_twins("chaos_storm", 0, 0.3, pipelines)
    assert result.ok, result.table()
    ev = result.evidence
    assert ev["chaos"]["total"] >= 1 and ev["stats"]["restarts"] >= 1
    assert {v.name for v in result.report.verdicts} >= {
        "zero_loss", "chaos_bit", "detects_restart_churn"}


def test_diurnal_hotkey_control_arm_zero_incidents(pipelines):
    _, result = gameday_twins("diurnal_hotkey", 0, 0.25, pipelines)
    assert result.ok, result.table()
    assert result.evidence["alerts"]["fired"] == 0
    assert {v.name for v in result.report.verdicts} >= {"zero_incidents"}
    d = result.as_dict()
    assert d["ok"] is True and d["mode"] == "single" and d["slo"]["verdicts"]
    json.dumps(d)


def test_gameday_cli_broken_slo_exits_nonzero(pipelines, capsys,
                                              monkeypatch):
    """The CLI gate's contract: an impossible SLO drives the exit code to
    1; the same scenario without it passes."""
    _, tp = pipelines
    monkeypatch.setattr(Tgd, "_default_pipeline", lambda *a, **k: tp)
    argv = ["--name", "diurnal_hotkey", "--seed", "3", "--scale", "0.25",
            "--json", "--device", "cpu"]
    assert Tgd.main(argv) == 0
    assert Tgd.main(argv + ["--slo",
                            "stats.p99_batch_latency_sec<=0.000001"]) == 1
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    verdict = json.loads(lines[-1])
    assert verdict["ok"] is False
    failed = [v for v in verdict["slo"]["verdicts"] if not v["ok"]]
    assert failed and failed[0]["name"].startswith("stats.p99")


@pytest.mark.parametrize("argv", [
    ["--name", "no_such_scenario"], ["--name", "flash_crowd", "--scale", "0"],
    ["--name", "flash_crowd", "--slo", "not an slo"],
    ["--name", "flash_crowd", "--learn-policy", "min_rows=1"],
    ["--name", "drift_shift", "--learn-policy", "bogus=1"]])
def test_gameday_cli_refusals_equal_jax(argv):
    with pytest.raises(SystemExit) as je:
        Jgd.main(argv)
    with pytest.raises(SystemExit) as te:
        Tgd.main([*argv, "--device", "cpu"])
    assert str(te.value) == str(je.value)


def test_gameday_runner_needs_a_card_unless_told_cpu(pipelines):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal is for hosts without")
    gd = Tgd.get_scenario("diurnal_hotkey", 0, scale=0.1)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Tgd.run_gameday(gd)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Tgd.main(["--name", "diurnal_hotkey", "--scale", "0.1"])
    _, tp = pipelines
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Tgd.run_gameday(gd, pipeline=tp, device="cuda")


def test_port_evaluate_judges_a_jax_run_as_jax_does(pipelines, monkeypatch):
    """Evidence captured from a JAX game day (the runner's full evidence:
    key multisets, traces, alerts) gets the same verdicts from the port's
    ``evaluate`` and specs as from the JAX package's."""
    jp, _ = pipelines
    seen = []
    real = Jgd.evaluate

    def capture(slos, evidence, scope="gameday"):
        seen.append((slos, evidence))
        return real(slos, evidence, scope=scope)

    monkeypatch.setattr(Jgd, "evaluate", capture)
    Jgd.run_gameday(Jgd.get_scenario("flash_crowd", 2, scale=0.2),
                    pipeline=jp)
    (jslos, evidence), = seen
    tslos = [Tslo.SloSpec(s.name, kind=s.kind, path=s.path, op=s.op,
                          limit=s.limit, scope=s.scope) for s in jslos]
    tgd = Tgd.get_scenario("flash_crowd", 2, scale=0.2)
    assert [s.name for s in tgd.slos] == [s.name for s in jslos][
        :len(tgd.slos)]
    for scope in ("gameday", "serve"):
        assert (Tslo.evaluate(tslos, evidence, scope=scope).as_dict()
                == Jslo.evaluate(jslos, evidence, scope=scope).as_dict())
