"""The port's fleet game days on the CPU, beside the JAX package's.

Warp runs of the catalog's fleet scenarios: campaign_kill_swap (a campaign
spike, a seeded worker kill and a hot swap at once), coordinator_kill (a
crash-mode coordinator kill under three candidates while a crashed worker
pins committed lag) and its clean arm, and elastic_control (the autoscaler
armed with every signal quiet). Each asserts what the JAX package's own
test of it asserts; the gates whose verdict does not hang on timing read
the same as the JAX run's on the same seed and scale. The control-lane
journal of a JAX run and of a port run each pass the other package's
conformance audit with the verdict their own run recorded.
"""

import json
from dataclasses import replace

import pytest

from fraud_detection_tpu.analysis import conformance as Jconf
from fraud_detection_tpu.fleet import coordinator as Jcoord
from fraud_detection_tpu.scenarios import gameday as Jgd
from fraud_detection_tpu_torch.analysis import conformance as Tconf
from fraud_detection_tpu_torch.fleet import coordinator as Tcoord
from fraud_detection_tpu_torch.scenarios import gameday as Tgd

from torch_parity import gameday_pipelines, gameday_twins


@pytest.fixture(scope="module")
def pipelines():
    return gameday_pipelines()


def _audit(conf, succession):
    records, ctx = conf.extract_trace(succession)
    violations = conf.check_records(
        records, handoffs=ctx.get("handoffs"), lost=ctx.get("lost", 0),
        reordered=ctx.get("reordered", 0))
    return conf.summarize(violations, len(records))


def _journals(monkeypatch):
    """Capture the raw succession evidence (with its journal) each
    package's runner audits."""
    seen = {"jax": [], "port": []}
    for key, mod in (("jax", Jgd), ("port", Tgd)):
        real = mod._conformance_block

        def capture(succ, real=real, key=key):
            seen[key].append(succ)
            return real(succ)

        monkeypatch.setattr(mod, "_conformance_block", capture)
    return seen


def _expiry_lags(monkeypatch):
    """Capture, per package, the fleet's committed lag in the first view
    the coordinator builds after it expired a lease (in a tick or in a
    peer's heartbeat): the view in which a crashed worker's absence first
    reaches the fleet watchdog."""
    lags = {"jax": [], "port": []}
    for key, mod in (("jax", Jcoord), ("port", Tcoord)):
        cls = mod.FleetCoordinator
        expire, tick = cls._expire_locked, cls.tick

        def expire_locked(self, now, expire=expire):
            expired = expire(self, now)
            if expired:
                self._expired_unseen = True
            return expired

        def seen_tick(self, tick=tick, key=key):
            view = tick(self)
            if getattr(self, "_expired_unseen", False):
                self._expired_unseen = False
                lags[key].append(view.get("committed_lag"))
            return view

        monkeypatch.setattr(cls, "_expire_locked", expire_locked)
        monkeypatch.setattr(cls, "tick", seen_tick)
    return lags


@pytest.mark.parametrize("seed", [9, 11])
def test_campaign_kill_swap_flagship(pipelines, monkeypatch, seed):
    """Campaign spike + seeded worker kill + hot swap: zero-loss/zero-dup
    accounting and a machine-readable verdict; both journals conform under
    both audits. Seed 11 is the JAX test's: its crash lands at the victim's
    6th poll, and a crash is seen only when its lease expires, so whether
    work still remains then races the drain (the catalog entry's own
    comment). When the hot swap returns before the victim's first batch
    ends, the rest of the timeline lands at once, the victim consumes and
    commits all of it before its revoke lands, nothing remains, and the
    watchdog rightly stays quiet: the JAX package on warm pipelines takes
    that branch too, with the same evidence. So for
    both packages the detection gate must read exactly whether committed
    work remained at the expiry, and every other gate must pass. Seed 9
    draws a crash at the victim's 2nd poll, which always leaves work: the
    whole verdict passes."""
    seen = _journals(monkeypatch)
    lags = _expiry_lags(monkeypatch)
    jres, result = gameday_twins("campaign_kill_swap", seed, 0.4, pipelines)
    for key, res in (("jax", jres), ("port", result)):
        by = {v.name: v for v in res.report.verdicts}
        assert all(v.ok for v in res.report.verdicts
                   if v.name != "detects_worker_absence"), res.table()
        lag = lags[key][0]
        assert lag is not None
        assert by["detects_worker_absence"].ok == (lag > 0), (key, lag)
    if seed == 9:
        assert result.ok, result.table()
    by = {v.name: v for v in result.report.verdicts}
    assert by["exact_accounting"].ok and by["spec_conformance"].ok
    assert result.evidence["deaths"] == 1
    assert result.evidence["swaps"] >= 1
    d = result.as_dict()
    assert d["ok"] is result.ok and d["slo"]["verdicts"]
    json.dumps(d)
    for key, res in (("jax", jres), ("port", result)):
        (succ,) = seen[key]
        own = res.evidence["conformance"]
        assert own["violation_count"] == 0 and own["records"] > 0
        assert _audit(Jconf, succ) == _audit(Tconf, succ) == own


def test_same_seed_same_timeline_and_death_schedule(pipelines):
    def run(seed):
        return Tgd.run_gameday(
            Tgd.get_scenario("campaign_kill_swap", seed, scale=0.3),
            pipeline=pipelines[1])

    a, b, c = run(21), run(21), run(22)
    assert a.evidence["planned"] == b.evidence["planned"]
    assert a.evidence["death_plan"] == b.evidence["death_plan"]
    assert (c.evidence["planned"] != a.evidence["planned"]
            or c.evidence["death_plan"] != a.evidence["death_plan"])


def test_coordinator_kill_survives_brain_death(pipelines, monkeypatch):
    """A crash-mode coordinator kill mid-campaign while a crashed worker
    pins committed lag: every row accounted, a successor elected within
    the bound, zero control records lost, the dead brain detected; the
    journal conforms under both packages' audits."""
    seen = _journals(monkeypatch)
    _, result = gameday_twins("coordinator_kill", 0, 0.4, pipelines,
                              jax=False)
    assert result.ok, result.table()
    by = {v.name: v for v in result.report.verdicts}
    for name in ("exact_accounting", "worker_killed", "coordinator_killed",
                 "election_won", "term_advanced", "failover_bounded_s",
                 "control_zero_loss", "detects_coordinator_absence",
                 "spec_conformance"):
        assert by[name].ok, name
    succ = result.evidence["succession"]
    assert succ["kill_plan"]["killed"][0]["mode"] == "crash"
    (handoff,) = succ["handoffs"]
    assert handoff["from"] == succ["kill_plan"]["killed"][0]["coordinator"]
    assert handoff["to"] == succ["leader"]
    assert result.evidence["deaths"] == 1
    (raw,) = seen["port"]
    assert (_audit(Jconf, raw) == _audit(Tconf, raw)
            == result.evidence["conformance"])
    assert result.evidence["conformance"]["violation_count"] == 0


def test_coordinator_kill_clean_arm_zero_incidents(pipelines):
    """The same topology with nobody killed holds a steady term, elects no
    one and ends with zero incidents fired."""
    def clean(mod, gd_mod, slo_mod):
        gd = gd_mod.get_scenario("coordinator_kill", 0, scale=0.25)
        return replace(
            gd, name="coordinator_kill_clean", coordinator_kills=None,
            kills=None, sentinel=gd_mod.SentinelSpec(zero_incidents=True),
            slos=(slo_mod.SloSpec("exact_accounting",
                                  kind="exact_accounting"),
                  slo_mod.SloSpec("steady_term", path="succession.term",
                                  op="==", limit=1, scope="gameday"),
                  slo_mod.SloSpec("no_elections",
                                  path="succession.elections", op="==",
                                  limit=0, scope="gameday"),
                  slo_mod.SloSpec("control_zero_loss",
                                  path="succession.control.lost", op="==",
                                  limit=0, scope="gameday"),
                  slo_mod.SloSpec("no_errors", kind="no_errors")))

    from fraud_detection_tpu.scenarios import slo as Jslo
    from fraud_detection_tpu_torch.scenarios import slo as Tslo

    tgd = clean(None, Tgd, Tslo)
    assert repr(tgd) == repr(clean(None, Jgd, Jslo)).replace(
        "fraud_detection_tpu.", "fraud_detection_tpu_torch.")
    result = Tgd.run_gameday(tgd, pipeline=pipelines[1])
    assert result.ok, result.table()
    assert result.evidence["alerts"]["fired"] == 0


def test_elastic_control_never_scales(pipelines):
    """The elastic control arm: the autoscaler armed with every signal
    quiet does not scale, replace or flap, and the fleet pack ends with
    zero incidents."""
    _, result = gameday_twins("elastic_control", 0, 0.4, pipelines)
    assert result.ok, result.table()
    a = result.evidence["autoscale"]
    assert (a["scale_outs"], a["scale_ins"], a["replacements"]) == (0, 0, 0)
    assert result.evidence["alerts"]["fired"] == 0


def test_record_path_journal_reads_in_both_packages(pipelines, tmp_path):
    """The game-day CLI's --record file (the control-lane journal plus its
    verdict) is read by both packages' ``extract_trace`` and audits clean."""
    path = tmp_path / "journal.json"
    result = Tgd.run_gameday(
        Tgd.get_scenario("campaign_kill_swap", 3, scale=0.2),
        pipeline=pipelines[1], record_path=str(path))
    doc = json.loads(path.read_text())
    assert doc["scenario"] == "campaign_kill_swap" and doc["seed"] == 3
    assert doc["evidence"]["conformance"] == result.evidence["conformance"]
    assert Jconf.extract_trace(doc) == Tconf.extract_trace(doc)
    assert _audit(Jconf, doc) == _audit(Tconf, doc) == doc["evidence"][
        "conformance"]
