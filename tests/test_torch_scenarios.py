"""The port's scenario layer against the JAX package's, on the CPU.

The deterministic half of ``scenarios/``: the clock and seed derivation;
every catalog scenario's composed timeline, event for event (virtual t,
key, value bytes, truth family, and the partition the broker deals each
row to), at two seeds and two scales; the catalog's specs field for field;
the ``GameDay`` refusals, the spec refusals and the lookup errors with the
JAX messages; ``parse_slo`` and ``evaluate`` verdicts on shared evidence;
recordings made by either package replayed by the other to the same key
set, and the replay CLI's exit codes and refusals; ``LabelFeeder``'s
feedback records; the scheduler's game-day fields (validation messages,
``resolved_max_batch_sec``, the token burst, the ladder ``prewarm`` keeps
or derives at given costs); the protocol role machines
(``FLEET_PROTOCOLS``) and ``check_records`` on doctored journals.
"""

import dataclasses
import json

import pytest

from fraud_detection_tpu import scenarios as J
from fraud_detection_tpu.analysis import conformance as Jconf
from fraud_detection_tpu.analysis import entrypoints as Jentry
from fraud_detection_tpu.scenarios import gameday as Jgd
from fraud_detection_tpu.scenarios import labels as Jlabels
from fraud_detection_tpu.scenarios import record as Jrecord
from fraud_detection_tpu.scenarios import replay as Jreplay
from fraud_detection_tpu.scenarios import slo as Jslo
from fraud_detection_tpu.scenarios import traffic as Jtraffic
from fraud_detection_tpu.stream import InProcessBroker as JBroker
from fraud_detection_tpu_torch import scenarios as T
from fraud_detection_tpu_torch.analysis import conformance as Tconf
from fraud_detection_tpu_torch.analysis import entrypoints as Tentry
from fraud_detection_tpu_torch.scenarios import gameday as Tgd
from fraud_detection_tpu_torch.scenarios import labels as Tlabels
from fraud_detection_tpu_torch.scenarios import record as Trecord
from fraud_detection_tpu_torch.scenarios import replay as Treplay
from fraud_detection_tpu_torch.scenarios import slo as Tslo
from fraud_detection_tpu_torch.scenarios import traffic as Ttraffic
from fraud_detection_tpu_torch.stream import InProcessBroker as TBroker

CATALOG = sorted(Jgd.CATALOG)


def plain(obj):
    """A comparable form of nested spec data: dataclasses become (class
    name, fields), sequences lists; everything else as is."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                {f.name: plain(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)):
        return [plain(x) for x in obj]
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    return obj


def _raises_equal(jfn, tfn, exc=ValueError):
    with pytest.raises(exc) as je:
        jfn()
    with pytest.raises(exc) as te:
        tfn()
    assert str(te.value) == str(je.value)
    return str(te.value)


# ---------------------------------------------------------------------------
# clock
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,name", [(0, "faults"), (7, "deaths"),
                                       (2 ** 40, "traffic"), (-3, "")])
def test_derive_seed_and_rng_equal_jax(seed, name):
    assert T.derive_seed(seed, name) == J.derive_seed(seed, name)
    assert Ttraffic.derive_seed is T.derive_seed      # re-exported there
    jc, tc = J.ScenarioClock(seed), T.ScenarioClock(seed)
    assert tc.derive_seed(name) == jc.derive_seed(name)
    assert ([tc.rng(name).random() for _ in range(3)]
            == [jc.rng(name).random() for _ in range(3)])


def test_clock_warp_moves_the_cursor_without_sleeping():
    calls = []
    c = T.ScenarioClock(0, time_scale=0.0, sleep=calls.append)
    c.start()
    c.advance_to(100.0)
    assert c.now() == 100.0 and calls == []
    c.advance_to(50.0)                  # never goes backwards
    assert c.now() == 100.0


def test_clock_paced_sleeps_the_scaled_remainder():
    for mod in (J, T):
        slept, wall = [], [10.0]
        c = mod.ScenarioClock(0, time_scale=0.5, sleep=slept.append,
                              wall=lambda: wall[0])
        c.start()
        c.advance_to(2.0)               # 2 virtual s x 0.5 = 1 wall s
        wall[0] = 10.25
        c.advance_to(3.0)               # 1.5 s target, 0.25 s gone
        assert slept == [pytest.approx(1.0), pytest.approx(1.25)]
    _raises_equal(lambda: J.ScenarioClock(0, time_scale=-1),
                  lambda: T.ScenarioClock(0, time_scale=-1))


# ---------------------------------------------------------------------------
# traffic: timelines event for event
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 0.25])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", CATALOG)
def test_catalog_timeline_equals_jax(name, seed, scale):
    jgd = J.get_scenario(name, seed, scale=scale)
    tgd = T.get_scenario(name, seed, scale=scale)
    jev = J.compose(jgd.traffic, J.ScenarioClock(jgd.seed))
    tev = T.compose(tgd.traffic, T.ScenarioClock(tgd.seed))
    assert len(tev) == len(jev) > 0
    assert [tuple(e) for e in tev] == [tuple(e) for e in jev]
    # the truth label (drift days) and the partition each row lands on
    assert ([json.loads(e.value).get("truth") for e in tev]
            == [json.loads(e.value).get("truth") for e in jev])
    jb, tb = (JBroker(num_partitions=jgd.partitions),
              TBroker(num_partitions=tgd.partitions))
    jb.producer().produce_batch("in", [(e.value, e.key) for e in jev])
    tb.producer().produce_batch("in", [(e.value, e.key) for e in tev])
    assert ([(m.key, m.partition, m.offset) for m in tb.messages("in")]
            == [(m.key, m.partition, m.offset) for m in jb.messages("in")])


@pytest.mark.parametrize("spec", [
    ("SteadyLoad", dict(name="s", rate=120.0, duration_s=1.3,
                        scam_fraction=0.4, hot_fraction=0.3, hot_keys=2)),
    ("DiurnalLoad", dict(name="d", base_rate=10.0, peak_rate=300.0,
                         period_s=2.0, duration_s=2.0, emit_truth=True)),
    ("FlashCrowd", dict(name="f", base_rate=20.0, peak_rate=900.0,
                        ramp_at_s=0.2, ramp_s=0.3, hold_s=0.4, decay_s=0.2,
                        duration_s=1.5)),
    ("CampaignWave", dict(name="c", wave_rate=400.0, waves=2, wave_s=0.3,
                          gap_s=0.2, duration_s=1.2)),
    ("DriftCampaign", dict(name="x", wave_rate=300.0, waves=1, wave_s=0.5,
                           gap_s=0.1, duration_s=0.8)),
])
def test_generate_and_rate_curves_equal_jax(spec):
    cls, kw = spec
    js, ts = getattr(Jtraffic, cls)(**kw), getattr(Ttraffic, cls)(**kw)
    assert plain(ts)[1] == plain(js)[1]
    grid = [i * 0.037 for i in range(60)]
    assert [ts.rate_at(t) for t in grid] == [js.rate_at(t) for t in grid]
    for seed in (0, 42):
        assert ([tuple(e) for e in Ttraffic.generate(ts, seed)]
                == [tuple(e) for e in Jtraffic.generate(js, seed)])


@pytest.mark.parametrize("kw", [dict(duration_s=0), dict(scam_fraction=1.5),
                                dict(hot_fraction=-0.1), dict(hot_keys=0)])
def test_traffic_spec_refusals_equal_jax(kw):
    _raises_equal(lambda: Jtraffic.SteadyLoad(**kw),
                  lambda: Ttraffic.SteadyLoad(**kw))


def test_compose_refuses_duplicate_names_and_draws_independently():
    base = Ttraffic.SteadyLoad(name="base", rate=80, duration_s=1.0)
    wave = Ttraffic.CampaignWave(name="wave", at_s=0.3, duration_s=0.7,
                                 wave_rate=300, waves=1, wave_s=0.4,
                                 gap_s=0.2)
    alone = T.compose([base], T.ScenarioClock(5))
    together = T.compose([base, wave], T.ScenarioClock(5))
    assert [e for e in together
            if json.loads(e.value)["scenario"] == "base"] == alone
    _raises_equal(
        lambda: J.compose([Jtraffic.SteadyLoad(name="a"),
                           Jtraffic.SteadyLoad(name="a")], J.ScenarioClock(0)),
        lambda: T.compose([Ttraffic.SteadyLoad(name="a"),
                           Ttraffic.SteadyLoad(name="a")], T.ScenarioClock(0)))


def test_feeder_fires_actions_in_timeline_order():
    events = T.generate(Ttraffic.SteadyLoad(name="s", rate=100,
                                            duration_s=1.0), 3)
    out = []
    for mod, broker in ((J, JBroker(num_partitions=2)),
                        (T, TBroker(num_partitions=2))):
        seen = []
        actions = [mod.TimelineAction(0.5, "mid", lambda: seen.append("m")),
                   mod.TimelineAction(99.0, "end", lambda: seen.append("e")),
                   mod.TimelineAction(0.2, "boom", lambda: 1 / 0)]
        feeder = mod.TrafficFeeder(broker.producer(), "in", events,
                                   mod.ScenarioClock(0), actions=actions)
        feeder.run_inline()
        assert feeder.error is None and seen == ["m", "e"]
        assert broker.topic_size("in") == len(events)
        out.append(feeder.stats())
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# the catalog: specs, refusals, lookups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,scale", [(0, 1.0), (3, 0.3)])
@pytest.mark.parametrize("name", CATALOG)
def test_catalog_specs_equal_jax(name, seed, scale):
    jgd = J.get_scenario(name, seed, scale=scale)
    tgd = T.get_scenario(name, seed, scale=scale)
    assert plain(tgd) == plain(jgd)
    assert tgd.fleet_mode == jgd.fleet_mode
    assert tgd.duration_s() == jgd.duration_s()
    if tgd.sentinel is not None:
        for fleet in (False, True):
            assert (plain(tgd.sentinel.resolve_rules(fleet))
                    == plain(jgd.sentinel.resolve_rules(fleet)))


def test_catalog_and_exports_equal_jax():
    assert sorted(T.CATALOG) == CATALOG and len(CATALOG) == 12
    assert sorted(T.__all__) == sorted(J.__all__)
    assert all(hasattr(T, n) for n in T.__all__)


def _traffic(mod):
    return (mod.SteadyLoad(name="s", rate=10.0, duration_s=1.0),)


_GAMEDAY_REFUSALS = [
    dict(traffic=()),
    dict(workers=0),
    dict(workers=1, kills="KillSpec"),
    dict(workers=2, breaker_threshold=3),
    dict(workers=2, explain_slots=4),
    dict(workers=2, chaos="lethal"),
    dict(workers=1, candidates=2),
    dict(workers=2, candidates=0),
    dict(workers=2, candidates=1, coordinator_kills="CoordKillSpec"),
    dict(workers=2, candidates=2, coordinator_kills="CoordKillSpec:2"),
    dict(breaker_threshold=2, explain_slots=4),
    dict(explain_slots=0),
    dict(explain_paged=True),
    dict(explain_slots=4, explain_kv_pages=37),
    dict(explain_slots=4, explain_paged=True, explain_kv_pages=0),
    dict(learn="LearnSpec", workers=2),
    dict(learn="LearnSpec", hot_swap_at=1.0, model="xgb"),
    dict(learn="LearnSpec"),
    dict(autoscale="AutoscaleSpec"),
    dict(autoscale="AutoscaleSpec", workers=2),
    dict(autoscale="AutoscaleSpec:3", workers=2, sentinel="SentinelSpec"),
    dict(time_scale=0.0),
    dict(sentinel="SentinelSpec:expect"),
]


_SPEC_FIELDS = ("kills", "coordinator_kills", "learn", "autoscale",
                "sentinel", "chaos")


def _build(mod, gd_mod, kw):
    def spec(v):
        if not isinstance(v, str):
            return v
        kind, _, arg = v.partition(":")
        if kind == "KillSpec":
            return gd_mod.KillSpec()
        if kind == "CoordKillSpec":
            return gd_mod.CoordKillSpec(kills=int(arg or 1))
        if kind == "LearnSpec":
            return gd_mod.LearnSpec()
        if kind == "AutoscaleSpec":
            return gd_mod.AutoscaleSpec(min_workers=int(arg or 1),
                                        max_workers=4)
        if kind == "SentinelSpec":
            return gd_mod.SentinelSpec(expect=(gd_mod.ExpectedDetection(
                "no_such_rule"),) if arg else ())
        if kind == "lethal":
            return gd_mod.ChaosSpec(poll_error_rate=0.1)
        raise AssertionError(v)

    args = dict(name="x", description="d", traffic=_traffic(mod),
                slos=(mod.SloSpec("no_errors", kind="no_errors"),))
    args.update({k: spec(v) if k in _SPEC_FIELDS else v
                 for k, v in kw.items()})
    return gd_mod.GameDay(**args)


@pytest.mark.parametrize("kw", _GAMEDAY_REFUSALS)
def test_gameday_refusals_equal_jax(kw):
    _raises_equal(lambda: _build(J, Jgd, kw), lambda: _build(T, Tgd, kw))


@pytest.mark.parametrize("which", ["sentinel_interval", "sentinel_both",
                                   "learn_settle", "scale", "unknown",
                                   "ref"])
def test_spec_and_lookup_refusals_equal_jax(which):
    def call(mod, gd_mod):
        if which == "sentinel_interval":
            return gd_mod.SentinelSpec(interval_s=0)
        if which == "sentinel_both":
            return gd_mod.SentinelSpec(
                zero_incidents=True,
                expect=(gd_mod.ExpectedDetection("shed_burn"),))
        if which == "learn_settle":
            return gd_mod.LearnSpec(settle_s=0)
        if which == "scale":
            return mod.get_scenario("flash_crowd", scale=0)
        if which == "unknown":
            return mod.get_scenario("no_such_scenario")
        return mod.parse_scenario_ref("flash_crowd:x")

    exc = KeyError if which == "unknown" else ValueError
    _raises_equal(lambda: call(J, Jgd), lambda: call(T, Tgd), exc)


@pytest.mark.parametrize("ref", ["flash_crowd", "drift_shift:11", "x:0"])
def test_parse_scenario_ref_equals_jax(ref):
    assert T.parse_scenario_ref(ref) == J.parse_scenario_ref(ref)


def test_gameday_cli_list_equals_jax(capsys):
    assert Jgd.main(["--list"]) == 0
    jout = capsys.readouterr().out
    assert Tgd.main(["--list"]) == 0
    assert capsys.readouterr().out == jout
    assert len(jout.splitlines()) == 12


# ---------------------------------------------------------------------------
# SLOs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("expr", [
    "stats.p99_batch_latency_sec<=0.5", "deaths==1", "breaker.state==open",
    "exact_accounting", "spans_exact", "a.b>=2.5", "x!=none", "y<true",
    " zero_dup ", "p>1e-3"])
def test_parse_slo_equals_jax(expr):
    for scope in ("any", "gameday"):
        assert (plain(T.parse_slo(expr, scope=scope))[1]
                == plain(J.parse_slo(expr, scope=scope))[1])


@pytest.mark.parametrize("make", [
    lambda m: m.parse_slo("not an expression"),
    lambda m: m.SloSpec("x", kind="nope"),
    lambda m: m.SloSpec("x", kind="metric"),
    lambda m: m.SloSpec("x", path="a", op="=~"),
    lambda m: m.SloSpec("x", kind="detects_within"),
    lambda m: m.SloSpec("x", kind="detects_within", path="r", limit=0),
    lambda m: m.SloSpec("x", kind="detects_within", path="r", limit=True),
    lambda m: m.SloSpec("x", path="a", scope="serve"),
])
def test_slo_refusals_equal_jax(make):
    _raises_equal(lambda: make(Jslo), lambda: make(Tslo))


def _slos(mod):
    S = mod.SloSpec
    return [S("loss", kind="zero_loss"), S("dup", kind="zero_dup"),
            S("acct", kind="exact_accounting"), S("spans", kind="spans_exact"),
            S("errs", kind="no_errors"),
            S("shed_ok", path="stats.shed", op="<=", limit=5),
            S("missing", path="stats.nope", op="<=", limit=5),
            S("typed", path="stats.state", op="<", limit=3),
            S("listed", path="traces.0.spans_open", op="==", limit=0),
            S("fleet_only", path="deaths", op="==", limit=1,
              scope="gameday"),
            S("detect", kind="detects_within", path="shed_burn", limit=2.0),
            S("never", kind="detects_within", path="breaker_open",
              limit=2.0)]


_EVIDENCE = [
    {"fed_keys": ["a", "b", "b", "c"], "out_keys": ["a", "b", "b"],
     "dlq_keys": ["c", "c"], "stats": {"shed": 3, "state": "open"},
     "traces": [{"worker": "w0", "spans_open": 0, "batches_traced": 2,
                 "batches_closed": 2}],
     "alerts": {"evaluations": 9, "firing": [],
                "incidents": [{"rule": "shed_burn", "fired_at": 2.5},
                              {"rule": "shed_burn", "fired_at": 4.0}]},
     "fault_times": {"shed_burn": 1.0},
     "feeder": {"action_errors": [["swap", "ValueError()"]]}},
    {"fed_keys": ["a"], "out_keys": ["a"], "traces": [], "tracing": False,
     "stats": {"shed": 9}, "errors": ["w1: boom"]},
    {"traces": [], "stats": {}},
    {"fed_keys": list("abc"), "out_keys": list("abc"), "stats": {"shed": 0},
     "traces": [{"worker": "w0", "spans_open": 2, "batches_traced": 3,
                 "batches_closed": 1}], "alerts": "not a dict"},
]


@pytest.mark.parametrize("scope", ["gameday", "serve"])
@pytest.mark.parametrize("evidence", _EVIDENCE)
def test_evaluate_verdicts_equal_jax(evidence, scope):
    jrep = J.evaluate(_slos(J), evidence, scope=scope)
    trep = T.evaluate(_slos(T), evidence, scope=scope)
    assert trep.as_dict() == jrep.as_dict()
    assert trep.table() == jrep.table()
    assert [v.name for v in trep.failed] == [v.name for v in jrep.failed]


# ---------------------------------------------------------------------------
# recordings and replay, across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipelines():
    """The JAX demo pipeline and the port's twin of its arrays."""
    from fraud_detection_tpu.models.pipeline import (ServingPipeline,
                                                     synthetic_demo_pipeline)
    from fraud_detection_tpu_torch.models.pipeline import \
        ServingPipeline as TPipeline

    from torch_parity import port_featurizer, port_model

    jp = synthetic_demo_pipeline(batch_size=128, n=300, seed=3,
                                 num_features=1024,
                                 corpus_kwargs=dict(hard_fraction=0.0,
                                                    label_noise=0.0))
    assert isinstance(jp, ServingPipeline)
    tp = TPipeline(port_featurizer(jp.featurizer), port_model(jp.model),
                   batch_size=128, device="cpu")
    return jp, tp


def _record(mod, stream_mod, obs_mod, pipe, path, *, seed=13,
            record_rows=True):
    clock = mod.ScenarioClock(seed)
    events = mod.compose([mod.SteadyLoad(name="rec", rate=400,
                                         duration_s=1.0, scam_fraction=0.4)],
                         clock)
    broker = stream_mod.InProcessBroker(num_partitions=3)
    tracer = obs_mod.RowTracer(worker="w0", sample=1.0, capacity=8192,
                               record_rows=record_rows)
    engine = stream_mod.StreamingClassifier(
        pipe, broker.consumer(["in"], "rec"), broker.producer(), "out",
        batch_size=128, max_wait=0.02, rowtrace=tracer)
    mod.TrafficFeeder(broker.producer(), "in", events, clock).run_inline()
    engine.run(max_messages=len(events), idle_timeout=2.0)
    engine.consumer.close()
    header = mod.dump_tracer(tracer, str(path))
    return header, len(events)


def _record_jax(pipe, path, **kw):
    from fraud_detection_tpu import obs, stream

    return _record(J, stream, obs, pipe, path, **kw)


def _record_port(pipe, path, **kw):
    from fraud_detection_tpu_torch import obs, stream

    return _record(T, stream, obs, pipe, path, **kw)


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_recording_replays_across_packages(pipelines, tmp_path, maker):
    jp, tp = pipelines
    path = tmp_path / f"{maker}.jsonl"
    header, n = (_record_jax(jp, path) if maker == "jax"
                 else _record_port(tp, path))
    assert header["complete"] is True and header["spans"] > n
    jh, jspans = Jrecord.load_recording(str(path))
    th, tspans = Trecord.load_recording(str(path))
    assert (th, tspans) == (jh, jspans)
    assert Trecord.recording_rows(tspans) == Jrecord.recording_rows(jspans)
    assert len(Trecord.recording_rows(tspans)) == n
    tsched = Trecord.batch_schedule(tspans)
    assert tsched == Jrecord.batch_schedule(jspans)
    assert ([tuple(e) for e in Treplay.replay_events(th, tspans, seed=4)]
            == [tuple(e) for e in Jreplay.replay_events(jh, jspans, seed=4)])
    jrep = J.run_replay(str(path), jp)
    trep = T.run_replay(str(path), tp)
    for rep in (jrep, trep):
        assert rep["keys_exact"] is True and rep["rows"] == rep["fed"] == n
        assert rep["missing"] == rep["duplicated_or_extra"] == 0
    drop = ("wall_s", "stats")
    assert ({k: v for k, v in trep.items() if k not in drop}
            == {k: v for k, v in jrep.items() if k not in drop})


def test_incomplete_recording_refused_like_jax(pipelines, tmp_path):
    jp, tp = pipelines
    path = tmp_path / "partial.jsonl"
    header, n = _record_port(tp, path, record_rows=False)
    assert header["complete"] is False
    _raises_equal(lambda: J.run_replay(str(path), jp),
                  lambda: T.run_replay(str(path), tp))
    jrep = J.run_replay(str(path), jp, force=True)
    trep = T.run_replay(str(path), tp, force=True)
    assert trep["rows"] == jrep["rows"] < n
    assert trep["keys_exact"] is jrep["keys_exact"] is True


def test_load_recording_refusals_equal_jax(tmp_path):
    bad = tmp_path / "bad.jsonl"
    for text in ('{"format": "something_else"}\n', "",
                 '{"format": "fraud_tpu_trace", "version": 9}\n'):
        bad.write_text(text)
        _raises_equal(lambda: Jrecord.load_recording(str(bad)),
                      lambda: Trecord.load_recording(str(bad)))
    for cid in ("w0-1:2:17", "w0-1", "a:b:c", "x:1:2:3"):
        assert Trecord.row_coordinate(cid) == Jrecord.row_coordinate(cid)


def test_replay_cli_exit_codes_equal_jax(pipelines, tmp_path, capsys,
                                         monkeypatch):
    from fraud_detection_tpu.models import pipeline as jpipe_mod
    from fraud_detection_tpu_torch.models import pipeline as tpipe_mod

    jp, tp = pipelines
    monkeypatch.setattr(jpipe_mod, "synthetic_demo_pipeline",
                        lambda *a, **k: jp)
    monkeypatch.setattr(tpipe_mod, "synthetic_demo_pipeline",
                        lambda *a, **k: tp)
    path = tmp_path / "rec.jsonl"
    _record_port(tp, path)
    outs = []
    for main, extra in ((Jreplay.main, []), (Treplay.main,
                                              ["--device", "cpu"])):
        assert main([str(path), *extra]) == 0
        outs.append(json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1]))
    assert outs[1]["keys_exact"] is outs[0]["keys_exact"] is True
    partial = tmp_path / "partial.jsonl"
    _record_port(tp, partial, record_rows=False)
    for argv in ([str(partial)], [str(path), "--time-scale", "-1"],
                 [str(path), "--batch-size", "0"],
                 [str(tmp_path / "missing.jsonl")]):
        _raises_equal(lambda: Jreplay.main(argv),
                      lambda: Treplay.main([*argv, "--device", "cpu"]),
                      SystemExit)
    for main, extra in ((Jreplay.main, []), (Treplay.main,
                                              ["--device", "cpu"])):
        assert main([str(partial), "--force", *extra]) == 0
    capsys.readouterr()


def test_replay_cli_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    import torch

    from fraud_detection_tpu_torch.models import pipeline as tpipe_mod

    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal is for hosts without")
    real = tpipe_mod.synthetic_demo_pipeline
    seen = []
    monkeypatch.setattr(tpipe_mod, "synthetic_demo_pipeline",
                        lambda *a, **k: seen.append(k) or real(
                            *a, n=40, num_features=64, **k))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Treplay.main([str(tmp_path / "any.jsonl")])
    assert seen[0]["device"] == "cuda"


# ---------------------------------------------------------------------------
# the labels oracle
# ---------------------------------------------------------------------------

def test_label_feeder_records_equal_jax():
    spec_j = Jtraffic.DriftCampaign(name="d", wave_rate=300.0, waves=2,
                                    wave_s=0.3, gap_s=0.1, duration_s=0.9)
    spec_t = Ttraffic.DriftCampaign(name="d", wave_rate=300.0, waves=2,
                                    wave_s=0.3, gap_s=0.1, duration_s=0.9)
    plain_rows = Ttraffic.generate(Ttraffic.SteadyLoad(name="s", rate=40.0,
                                                       duration_s=0.5), 2)
    ev = sorted(Ttraffic.generate(spec_t, 9) + plain_rows,
                key=lambda e: (e.t, e.key))
    assert ([tuple(e) for e in Jtraffic.generate(spec_j, 9)]
            == [tuple(e) for e in Ttraffic.generate(spec_t, 9)])
    out = []
    for labels_mod, broker in ((Jlabels, JBroker(num_partitions=3)),
                               (Tlabels, TBroker(num_partitions=3))):
        prod = broker.producer()
        prod.produce_batch("in", [(e.value, e.key) for e in ev])
        prod.produce("in", b"{not json", key=b"bad")
        clock = T.ScenarioClock(0)
        clock.advance_to(5.0)
        lf = labels_mod.LabelFeeder(broker.consumer(["in"], "labels"),
                                    broker.producer(), "fb", clock=clock,
                                    delay_s=0.2)
        lf.start()
        import time

        deadline = time.monotonic() + 30.0
        while (lf.fed + lf.stats()["skipped"] + lf.stats()["malformed"]
               < len(ev) + 1 and time.monotonic() < deadline):
            time.sleep(0.01)
        lf.join(timeout=10.0)
        assert lf.error is None
        out.append((lf.stats(),
                    sorted(m.value for m in broker.messages("fb"))))
    assert out[1] == out[0]
    stats, records = out[1]
    truthful = sum(1 for e in ev if "truth" in json.loads(e.value))
    assert stats == {"fed": truthful, "skipped": len(ev) - truthful,
                     "malformed": 1} and len(records) == truthful


# ---------------------------------------------------------------------------
# the scheduler's game-day fields
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(window_sec=0), dict(window_sec=-1.0), dict(cost_ratio=1.0),
    dict(cost_ratio=0.5), dict(max_rate=100.0, burst=0),
    dict(max_rate=100.0, burst=-5.0)])
def test_scheduler_game_day_refusals_equal_jax(kw):
    from fraud_detection_tpu import sched as Jsched
    from fraud_detection_tpu_torch import sched as Tsched

    _raises_equal(
        lambda: Jsched.AdaptiveScheduler(Jsched.SchedulerConfig(**kw), 256),
        lambda: Tsched.AdaptiveScheduler(Tsched.SchedulerConfig(**kw), 256))


@pytest.mark.parametrize("kw", [
    {}, dict(max_batch_sec=0.3), dict(target_p99_ms=900.0),
    dict(target_p99_ms=900.0, max_batch_sec=5.0),
    dict(max_rate=50.0, burst=7.0, window_sec=2.5)])
def test_scheduler_game_day_fields_equal_jax(kw):
    from fraud_detection_tpu import sched as Jsched
    from fraud_detection_tpu_torch import sched as Tsched

    jcfg, tcfg = Jsched.SchedulerConfig(**kw), Tsched.SchedulerConfig(**kw)
    assert plain(tcfg)[1] == plain(jcfg)[1]
    assert tcfg.resolved_max_batch_sec() == jcfg.resolved_max_batch_sec()
    js = Jsched.AdaptiveScheduler(jcfg, 256)
    ts = Tsched.AdaptiveScheduler(tcfg, 256)
    assert ts.governor.snapshot() == js.governor.snapshot()
    assert ts.slo.window_sec == js.slo.window_sec == kw.get("window_sec",
                                                            10.0)
    jb, tb = js.admission.bucket, ts.admission.bucket
    assert (tb and tb.burst) == (jb and jb.burst)


class _Ladder:
    """A pipeline stand-in that reports fixed rung costs and records the
    ladder the scheduler configures."""

    def __init__(self, costs):
        self.costs, self.configured = costs, None

    def measure_ladder(self, candidates, texts=None):
        return {b: self.costs[b] for b in candidates}

    def configure_ladder(self, buckets, prewarm=True, costs=None):
        self.configured = tuple(buckets)


_COSTS = {b: 1e-4 * (1 + b / 64) for b in (1, 2, 4, 8, 16, 32, 64, 128, 256,
                                            512, 1024)}


@pytest.mark.parametrize("kw", [
    {}, dict(cost_aware=False), dict(cost_ratio=1.05), dict(cost_ratio=3.0),
    dict(buckets=(64, 256)), dict(buckets=(64, 256), cost_aware=False)])
def test_scheduler_prewarm_ladder_equals_jax(kw):
    from fraud_detection_tpu import sched as Jsched
    from fraud_detection_tpu_torch import sched as Tsched

    got = []
    for mod in (Jsched, Tsched):
        s = mod.AdaptiveScheduler(mod.SchedulerConfig(**kw), 256)
        fake = _Ladder(_COSTS)
        n = s.prewarm(fake)
        got.append((n, tuple(s.buckets), fake.configured,
                    s.governor.min_budget, sorted(s.ladder_costs)))
    assert got[1] == got[0]
    if kw.get("cost_aware") is False and "buckets" not in kw:
        from fraud_detection_tpu_torch.sched.batcher import default_ladder

        assert got[1][1] == tuple(default_ladder(256))


# ---------------------------------------------------------------------------
# the protocol role machines and trace conformance
# ---------------------------------------------------------------------------

def test_fleet_protocols_and_vocabulary_equal_jax():
    from fraud_detection_tpu_torch.fleet import control as Tcontrol

    assert plain(Tentry.FLEET_PROTOCOLS) == plain(Jentry.FLEET_PROTOCOLS)
    assert ([s.qualnames() for s in Tentry.FLEET_PROTOCOLS]
            == [s.qualnames() for s in Jentry.FLEET_PROTOCOLS])
    assert Tconf.CONTROL_KINDS == Jconf.CONTROL_KINDS
    assert Tconf.WORKER_OPS == Tcontrol.WORKER_OPS
    assert Tconf.CANDIDATE_KINDS == Tcontrol.CANDIDATE_KINDS
    assert Tconf.CONTROL_KINDS == Tcontrol.CONTROL_KINDS


def _rec(kind, sender, seq, term=1, lamport=None):
    return {"kind": kind, "sender": sender, "seq": seq, "term": term,
            "lamport": lamport if lamport is not None else seq,
            "payload": {}}


_DRAIN = [_rec("join", "w0", 1), _rec("sync", "w0", 2), _rec("ack", "w0", 3),
          _rec("leave", "w0", 4)]
_SUCC = [_rec("beacon", "c0", 1), _rec("snapshot", "c0", 2),
         _rec("claim", "c1", 1, term=2), _rec("beacon", "c1", 2, term=2)]

_JOURNALS = [
    (_DRAIN + _SUCC, {}),
    ([_rec("join", "w0", 1), _rec("ack", "w0", 3)], {}),            # gap
    ([_rec("join", "w0", 1), _rec("ack", "w0", 3)], dict(lost=1)),
    ([_rec("join", "w0", 2), _rec("sync", "w0", 1)], {}),           # reorder
    ([_rec("join", "w0", 2), _rec("sync", "w0", 1)], dict(reordered=1)),
    ([_rec("join", "w0", 1), _rec("join", "w0", 1)], {}),           # dup
    ([_rec("commit", "w0", 1)], {}),                                # phantom
    ([_rec("join", "w0", 1), _rec("beacon", "w0", 2)], {}),         # roles
    ([_rec("claim", "c1", 1, term=2), _rec("beacon", "c0", 1, term=1)], {}),
    ([_rec("claim", "c1", 1, term=1)], {}),                         # fence
    ([_rec("ack", "w0", 1)], {}),                                   # step
    (["not a record", {"kind": "join", "sender": "w0", "seq": "x",
                       "term": 1}], {}),
    (_SUCC, dict(handoffs=[{"to": "c1", "term": 2},
                           {"to": "c2", "term": 2}])),
]


@pytest.mark.parametrize("journal,kw", _JOURNALS)
def test_check_records_equals_jax(journal, kw):
    jv = Jconf.check_records(journal, **kw)
    tv = Tconf.check_records(journal, **kw)
    assert [v.render() for v in tv] == [v.render() for v in jv]
    assert (Tconf.summarize(tv, len(journal))
            == Jconf.summarize(jv, len(journal)))
    assert ([f.render() for f in Tconf.to_findings(tv)]
            == [f.render() for f in Jconf.to_findings(jv)])
    assert (Tconf.render_report(tv, len(journal), "x")
            == Jconf.render_report(jv, len(journal), "x"))


@pytest.mark.parametrize("shape", ["list", "records", "succession",
                                   "evidence", "result", "bad"])
def test_extract_trace_equals_jax(shape):
    succ = {"trace": _DRAIN, "control": {"lost": 2, "reordered": 1},
            "handoffs": [{"to": "c1", "term": 2}]}
    obj = {"list": _DRAIN, "records": {"records": _DRAIN},
           "succession": succ, "evidence": {"evidence": {"succession": succ}},
           "result": {"succession": succ}, "bad": {"nothing": 1}}[shape]
    if shape == "bad":
        _raises_equal(lambda: Jconf.extract_trace(obj),
                      lambda: Tconf.extract_trace(obj))
    else:
        assert Tconf.extract_trace(obj) == Jconf.extract_trace(obj)


def _auto_slos(mod, gd):
    """The gates ``run_gameday`` derives from a declaration (the sentinel's
    detections and zero-incident arm, the conformance audit)."""
    out = []
    if gd.sentinel is not None:
        out += [mod.SloSpec(f"detects_{e.rule}", kind="detects_within",
                            path=e.rule, limit=e.within_s)
                for e in gd.sentinel.expect]
        if gd.sentinel.zero_incidents:
            out.append(mod.SloSpec("zero_incidents", path="alerts.fired",
                                   op="==", limit=0))
    out.append(mod.SloSpec("spec_conformance",
                           path="conformance.violation_count", op="==",
                           limit=0))
    return out


_GAMEDAY_EVIDENCE = [
    {"fed_keys": ["a", "b"], "out_keys": ["a", "b"], "dlq_keys": [],
     "stats": {"shed": 3, "p99_batch_latency_sec": 0.2, "restarts": 2},
     "shed_fraction": 0.3, "deaths": 1, "swaps": 1, "chaos": {"total": 4},
     "traces": [{"worker": "w0", "spans_open": 0, "batches_traced": 1,
                 "batches_closed": 1}],
     "alerts": {"fired": 0, "evaluations": 40, "firing": [],
                "incidents": [{"rule": r, "fired_at": 3.0} for r in (
                    "shed_burn", "breaker_open", "worker_absence",
                    "coordinator_absence", "restart_churn",
                    "fleet_watermark_burn", "shadow_disagreement_burn")]},
     "fault_times": {"shed_burn": 0.6, "fleet_watermark_burn": 2.0},
     "autoscale": {"scale_outs": 1, "scale_ins": 2, "replacements": 0},
     "autoscale_reaction_s": 6.0,
     "breaker": {"opens": 1, "fast_fails": 9},
     "succession": {"elections": 1, "term": 2, "control": {"lost": 0},
                    "handoffs": [{"failover_s": 3.1}],
                    "kill_plan": {"killed": [{"mode": "crash"}]}},
     "conformance": {"violation_count": 0},
     "explain_coverage": 1.0, "explain_accounting_exact": True,
     "annotations": {"annotated": 4},
     "explain": {"latency_ms": {"p99": 90.0}, "prefix_hits": 3,
                 "kv_pages": 37, "kv_bytes_saved_vs_contiguous": 10},
     "learn": {"primary_window_error_rate": 0.5, "published": 1,
               "promoted": 1, "candidate_window_error_rate": 0.0,
               "window": {"accounting_exact": True, "joined": 9}},
     "learn_promotion_latency_s": 70.0,
     "lifecycle": {"audit_ok": True}},
    {"fed_keys": ["a", "a"], "out_keys": ["a"], "stats": {},
     "traces": [], "autoscale": {"scale_outs": 0}, "alerts": None,
     "errors": ["w0: boom"], "conformance": {"violation_count": 2}},
]


@pytest.mark.parametrize("evidence", [0, 1])
@pytest.mark.parametrize("name", CATALOG)
def test_catalog_slos_judge_like_jax(name, evidence):
    """Every catalog day's gates (its declared SLOs and the ones the runner
    derives), paced days included, give the JAX verdicts on shared
    evidence, in both runner scopes."""
    jgd, tgd = J.get_scenario(name), T.get_scenario(name)
    ev = _GAMEDAY_EVIDENCE[evidence]
    for scope in ("gameday", "serve"):
        jrep = J.evaluate(tuple(jgd.slos) + tuple(_auto_slos(J, jgd)), ev,
                          scope=scope)
        trep = T.evaluate(tuple(tgd.slos) + tuple(_auto_slos(T, tgd)), ev,
                          scope=scope)
        assert trep.as_dict() == jrep.as_dict()
