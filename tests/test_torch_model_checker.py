"""The port's protocol model checker (``analysis/checker.py`` with
``traces.py`` and the ``model`` CLI) against the JAX package's.

The checker is deterministic, so equality is exact: the same states,
transitions, depth and action coverage for the default, autoscale and
succession configurations; the same shortest counterexample for every
safety mutation; the same lasso (stem and cycle) for every livelock
mutation; the same verdicts for configuration errors and budgets. Each
reference result is computed once per module. What the reference marks
slow (the succession configuration) is slow here too.
"""

import dataclasses
import json
import re

import pytest

from fraud_detection_tpu.analysis import checker as J
from fraud_detection_tpu.analysis import traces as Jtraces
from fraud_detection_tpu_torch.analysis import checker as T
from fraud_detection_tpu_torch.analysis import sarif as Tsarif
from fraud_detection_tpu_torch.analysis import traces as Ttraces

#: The counts the port's checker must reproduce (the reference's, on the
#: CPU of the container the port was built in).
DEFAULT_COUNTS = (58_074, 190_517)
AUTOSCALE_COUNTS = (49_212, 174_482)
LIVENESS_SCCS = 57_504

#: Per-mutation topologies, as tests/test_model_checker.py runs them.
_MUTATION_KW = {
    "forget_barrier_holds": dict(workers=3, partitions=3,
                                 keys_per_partition=1),
    "forget_holds_on_failover": dict(workers=2, partitions=2,
                                     keys_per_partition=1, max_lapses=0,
                                     candidates=2, max_coord_crashes=1),
    "drop_coordinator_lease": dict(workers=2, partitions=2,
                                   keys_per_partition=2, max_lapses=0,
                                   candidates=2, max_coord_lapses=1),
    "stale_term_fence_accepted": dict(workers=2, partitions=2,
                                      keys_per_partition=2, max_lapses=0,
                                      candidates=2, max_coord_lapses=1),
    "release_before_drain": dict(workers=2, partitions=2,
                                 keys_per_partition=1, max_crashes=0,
                                 max_lapses=0, max_scale_ins=1),
}
_LIVELOCK_KW = {
    "election_ping_pong": dict(workers=2, partitions=2,
                               keys_per_partition=1, max_crashes=0,
                               max_lapses=0, candidates=2,
                               max_coord_crashes=1),
    "zero_cooldown_flap": dict(workers=2, partitions=2,
                               keys_per_partition=1, max_crashes=0,
                               max_lapses=0, max_scale_ins=1),
    "drain_requeues_revoke": {},
}

_CONFIGS = {
    "default": {},
    "autoscale": dict(J.AUTOSCALE_CONFIG),
    "succession": dict(J.SUCCESSION_CONFIG),
}


@pytest.fixture(scope="module")
def ref():
    """Reference results, each computed once for the module."""
    cache = {}

    def get(kind, key, **kw):
        if (kind, key) not in cache:
            run = J.check if kind == "safety" else J.check_liveness
            cache[(kind, key)] = run(J.CheckConfig(**kw))
        return cache[(kind, key)]

    return get


def _steps(steps):
    return [(s.actor, s.action, s.detail) for s in steps]


def _safety_summary(result):
    return dict(ok=result.ok, states=result.states,
                transitions=result.transitions, depth=result.depth,
                coverage=dict(result.coverage),
                budget_exhausted=result.budget_exhausted,
                budget_reason=result.budget_reason)


# ---------------------------------------------------------------------------
# catalogs
# ---------------------------------------------------------------------------

def test_catalogs_equal_jax():
    for name in ("MUTATIONS", "SAFETY_MUTATIONS", "LIVELOCK_MUTATIONS",
                 "INVARIANTS", "EVENTUALLY_INVARIANTS", "ACTION_IMPLEMENTS",
                 "SUCCESSION_ACTIONS", "AUTOSCALE_ACTIONS",
                 "SUCCESSION_CONFIG", "AUTOSCALE_CONFIG"):
        assert getattr(T, name) == getattr(J, name), name
    assert dataclasses.asdict(T.CheckConfig()) == dataclasses.asdict(
        J.CheckConfig())
    assert set(_MUTATION_KW) <= set(T.SAFETY_MUTATIONS)
    assert set(_LIVELOCK_KW) == set(T.LIVELOCK_MUTATIONS)


def test_checker_actions_cover_every_spec_transition():
    spec = T.spec_transition_names()
    implemented = {q for quals in T.ACTION_IMPLEMENTS.values()
                   for q in quals}
    assert implemented == spec == J.spec_transition_names()


# ---------------------------------------------------------------------------
# safety
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", [
    "default", "autoscale",
    pytest.param("succession", marks=pytest.mark.slow)])
def test_safety_verdict_and_counts_equal_jax(ref, config):
    kw = _CONFIGS[config]
    got = T.check(T.CheckConfig(**kw))
    want = ref("safety", config, **kw)
    assert got.ok and not got.budget_exhausted
    assert _safety_summary(got) == _safety_summary(want)
    if config == "default":
        assert (got.states, got.transitions) == DEFAULT_COUNTS
        assert set(got.coverage) == (set(T.ACTION_IMPLEMENTS)
                                     - set(T.SUCCESSION_ACTIONS)
                                     - set(T.AUTOSCALE_ACTIONS))
    if config == "autoscale":
        assert (got.states, got.transitions) == AUTOSCALE_COUNTS
        for action in T.AUTOSCALE_ACTIONS:
            assert got.coverage.get(action, 0) > 0, action


def test_succession_composition_equals_jax():
    """tests/test_succession.py's small exhaustive configuration, which
    fires every spec action but the autoscaler's: worker crash and lapse
    chaos composed with coordinator crash, lapse and election."""
    kw = dict(workers=2, partitions=2, keys_per_partition=1, max_crashes=1,
              max_lapses=1, candidates=3, max_coord_crashes=1,
              max_coord_lapses=1)
    got = T.check(T.CheckConfig(**kw))
    assert got.ok and got.states > 50_000
    assert _safety_summary(got) == _safety_summary(J.check(J.CheckConfig(**kw)))
    fired = {a for a, n in got.coverage.items() if n > 0}
    assert fired == set(T.ACTION_IMPLEMENTS) - set(T.AUTOSCALE_ACTIONS)


@pytest.mark.parametrize("mutation", T.SAFETY_MUTATIONS)
def test_mutation_counterexample_equals_jax(mutation):
    """The same shortest counterexample, with the worker symmetry on and
    off (the CLI re-searches without it for stable worker labels)."""
    kw = _MUTATION_KW.get(mutation, {})
    for symmetry in (True, False):
        cfg = dict(mutations=frozenset({mutation}), symmetry=symmetry, **kw)
        got = T.check(T.CheckConfig(**cfg))
        want = J.check(J.CheckConfig(**cfg))
        assert got.violation is not None, mutation
        assert got.violation.invariant == want.violation.invariant
        assert _steps(got.violation.trace) == _steps(want.violation.trace)
        assert got.violation.detail == want.violation.detail
        assert (got.states, got.transitions, got.depth) == (
            want.states, want.transitions, want.depth)
        tcfg, jcfg = T.CheckConfig(**cfg), J.CheckConfig(**cfg)
        assert (Ttraces.render_trace(got.violation)
                == Jtraces.render_trace(want.violation))
        assert Ttraces.to_finding(got.violation) == _as_port_finding(
            Jtraces.to_finding(want.violation))
        assert _untimed(Ttraces.render(got, tcfg)) == _untimed(
            Jtraces.render(want, jcfg))


def _untimed(report):
    """A rendered report without its wall-clock seconds."""
    return re.sub(r" in [0-9.]+s", " in <t>s", report)


def _as_port_finding(f):
    from fraud_detection_tpu_torch.analysis.core import Finding

    return Finding(f.rule, f.path, f.line, f.message)


def test_config_validation_equals_jax():
    bad = [dict(workers=2, max_crashes=2),
           dict(mutations=frozenset({"nope"})),
           dict(workers=9),
           dict(workers=2, spares=2),
           dict(workers=2, max_crashes=1, max_scale_ins=1)]
    for kw in bad:
        with pytest.raises(ValueError) as got:
            T.CheckConfig(**kw).validate()
        with pytest.raises(ValueError) as want:
            J.CheckConfig(**kw).validate()
        assert str(got.value) == str(want.value), kw


def test_budget_exhaustion_equals_jax():
    got = T.check(T.CheckConfig(max_states=200))
    want = J.check(J.CheckConfig(max_states=200))
    assert not got.ok and got.budget_exhausted and got.violation is None
    assert _safety_summary(got) == _safety_summary(want)
    report = Ttraces.render(got, T.CheckConfig(max_states=200))
    assert "BUDGET EXHAUSTED" in report and "incomplete" in report
    lgot = T.check_liveness(T.CheckConfig(max_states=200))
    lwant = J.check_liveness(J.CheckConfig(max_states=200))
    assert lgot.budget_exhausted and lgot.lasso is None
    assert (lgot.states, lgot.budget_reason) == (lwant.states,
                                                 lwant.budget_reason)


def test_symmetry_reduction_counts_equal_jax():
    for symmetry in (True, False):
        kw = dict(keys_per_partition=1, symmetry=symmetry)
        assert _safety_summary(T.check(T.CheckConfig(**kw))) == \
            _safety_summary(J.check(J.CheckConfig(**kw)))


# ---------------------------------------------------------------------------
# liveness
# ---------------------------------------------------------------------------

def _liveness_summary(result):
    return dict(ok=result.ok, states=result.states,
                transitions=result.transitions, sccs=result.sccs,
                checked=tuple(result.checked),
                budget_exhausted=result.budget_exhausted)


@pytest.mark.parametrize("config", [
    "default", "autoscale",
    pytest.param("succession", marks=pytest.mark.slow)])
def test_liveness_verdict_equals_jax(ref, config):
    kw = _CONFIGS[config]
    got = T.check_liveness(T.CheckConfig(**kw))
    assert got.ok and not got.budget_exhausted
    if config == "autoscale":
        # Held against the reference's safety run of the same space (one
        # reference exploration fewer): liveness explores it whole.
        want = ref("safety", config, **kw)
        assert (got.states, got.transitions) == (want.states,
                                                 want.transitions)
        assert got.sccs > 0
        return
    want = ref("liveness", config, **kw)
    assert _liveness_summary(got) == _liveness_summary(want)
    if config == "default":
        assert (got.states, got.transitions) == DEFAULT_COUNTS
        assert got.sccs == LIVENESS_SCCS
        assert tuple(got.checked) == tuple(T.EVENTUALLY_INVARIANTS)


@pytest.mark.parametrize("mutation", T.LIVELOCK_MUTATIONS)
def test_livelock_lasso_equals_jax(mutation):
    kw = dict(mutations=frozenset({mutation}), **_LIVELOCK_KW[mutation])
    got = T.check_liveness(T.CheckConfig(**kw))
    want = J.check_liveness(J.CheckConfig(**kw))
    assert got.lasso is not None, mutation
    assert got.lasso.invariant == want.lasso.invariant
    assert _steps(got.lasso.stem) == _steps(want.lasso.stem)
    assert _steps(got.lasso.cycle) == _steps(want.lasso.cycle)
    assert len(got.lasso.cycle) >= 1
    assert (Ttraces.render_lasso(got.lasso)
            == Jtraces.render_lasso(want.lasso))
    assert Ttraces.lasso_to_finding(got.lasso) == _as_port_finding(
        Jtraces.lasso_to_finding(want.lasso))


# ---------------------------------------------------------------------------
# the model CLI
# ---------------------------------------------------------------------------

def _cli_json(main, argv, capsys):
    rc = main(argv)
    payload = json.loads(capsys.readouterr().out)
    payload.pop("elapsed_s")
    return rc, payload


def test_cli_model_mutant_equals_jax(tmp_path, capsys):
    """``model --autoscale --mutate release_before_drain`` exits 1 with a
    trace naming revoke_barrier, as the reference's does; its SARIF FC504
    validates."""
    from fraud_detection_tpu.analysis.__main__ import main as jmain
    from fraud_detection_tpu_torch.analysis.__main__ import main as tmain

    argv = ["model", "--json", "--autoscale", "--mutate",
            "release_before_drain"]
    got = _cli_json(tmain, argv, capsys)
    want = _cli_json(jmain, argv, capsys)
    assert got == want
    assert got[0] == 1 and got[1]["invariant_violated"] == "revoke_barrier"
    sarif_file = tmp_path / "model.sarif"
    assert tmain(["model", "--mutate", "expire_before_renew",
                  "--sarif", str(sarif_file)]) == 1
    assert "no_self_expiry" in capsys.readouterr().out
    doc = json.loads(sarif_file.read_text())
    assert Tsarif.validate(doc) == []
    assert doc["runs"][0]["results"][0]["ruleId"] == "FC504"


def test_cli_model_liveness_and_exit_codes_equal_jax(capsys):
    from fraud_detection_tpu.analysis.__main__ import main as jmain
    from fraud_detection_tpu_torch.analysis.__main__ import main as tmain

    small = ["--workers", "2", "--partitions", "2", "--keys", "1",
             "--max-crashes", "0", "--max-lapses", "0"]
    for argv in (["model", "--liveness", "--json", *small],
                 ["model", "--liveness", "--json", "--mutate",
                  "zero_cooldown_flap", "--max-scale-ins", "1", *small],
                 ["model", "--json", "--keys", "1"],
                 ["model", "--mutate", "drop_coordinator_lease",
                  "--candidates", "2", "--coord-lapses", "1",
                  "--max-lapses", "0", "--keys", "2", "--json"]):
        got, want = _cli_json(tmain, argv, capsys), _cli_json(jmain, argv,
                                                                capsys)
        assert got == want, argv
    for argv, rc in ((["model", "--max-states", "150"], 2),
                     (["model", "--liveness", "--max-states", "150"], 2),
                     (["model", "--mutate", "bogus"], 2),
                     (["model", "--workers", "2", "--max-crashes", "2"], 2),
                     (["model", "--succession", "--autoscale"], 2)):
        assert tmain(argv) == rc == jmain(argv), argv
        capsys.readouterr()
    assert tmain(["model", "--list-mutations"]) == 0
    assert capsys.readouterr().out.split() == list(T.MUTATIONS)


def _drain_cycle(sender="w0"):
    from tests.test_conformance import _drain_cycle as jdrain

    return jdrain(sender)


def test_cli_conform_equals_jax(tmp_path, capsys):
    """``conform`` replays a journal with the reference's verdict, exit
    code and report; a doctored log is rejected as FC505."""
    from fraud_detection_tpu.analysis.__main__ import main as jmain
    from fraud_detection_tpu_torch.analysis.__main__ import main as tmain

    clean = tmp_path / "clean.json"
    clean.write_text(json.dumps({"records": _drain_cycle()}))
    recs = _drain_cycle()
    del recs[2]
    doctored = tmp_path / "doctored.json"
    doctored.write_text(json.dumps(recs))
    for path, rc in ((clean, 0), (doctored, 1)):
        for flags in ([], ["--json"]):
            argv = ["conform", "--input", str(path), *flags]
            assert tmain(argv) == rc
            got = capsys.readouterr().out
            assert jmain(argv) == rc
            assert got == capsys.readouterr().out
    sarif_file = tmp_path / "conform.sarif"
    assert tmain(["conform", "--input", str(doctored), "--sarif",
                  str(sarif_file)]) == 1
    capsys.readouterr()
    doc = json.loads(sarif_file.read_text())
    assert Tsarif.validate(doc) == []
    assert doc["runs"][0]["results"][0]["ruleId"] == "FC505"
    assert tmain(["conform", "--input", str(tmp_path / "missing.json")]) == 2
