"""The port's sentinel (``obs/sentinel/``) against the JAX package's, on the
CPU.

Held equal to the reference: the default and fleet rule packs field for
field, ``resolve_path`` and the rule-file parser, the incident sequence
(event, rule, fire and resolve times) that one health timeline fires under
``VirtualCadence``, the alerts block's schema, and the incident bundles'
keys and implicated trace chains. The rest mirrors ``tests/test_sentinel.py``
on the port: burn rates need both windows, ``for_s``/``resolve_s``
hysteresis, counter resets, deltas and gauges, absence/staleness, a failing
source, the engine's alerts block, the flight recorder, exact incident
accounting across a supervised chaos chain, ``/healthz``, and the serve
CLI's alerting. Every clock here is injected or virtual; no test waits on a
real deadline.

Cases of ``tests/test_sentinel.py`` that rest on ``scenarios/``:
``test_warp_and_paced_runs_fire_identical_incident_sequences`` is mirrored
here over the port's ``ScenarioClock``; ``test_detects_within_slo_gate`` is
``tests/test_torch_scenarios.py``'s ``test_evaluate_verdicts_equal_jax`` and
``test_slo_refusals_equal_jax``; ``test_gameday_flash_crowd_detects_shed_burn``
and ``test_gameday_control_arm_zero_incidents`` are
``tests/test_torch_gameday_single.py``'s
``test_flash_crowd_sheds_and_detects_the_burn`` and
``test_diurnal_hotkey_control_arm_zero_incidents``.
"""

import dataclasses
import json
import urllib.error
import urllib.request

import pytest

from fraud_detection_tpu.obs import sentinel as jsentinel
from fraud_detection_tpu.obs.trace import RowTracer as JRowTracer
from fraud_detection_tpu_torch.obs import sentinel as tsentinel
from fraud_detection_tpu_torch.obs.sentinel import (AlertRule,
                                                    ChainedHealthSource,
                                                    IncidentRecorder, Sentinel,
                                                    VirtualCadence,
                                                    default_rule_pack,
                                                    fleet_rule_pack,
                                                    implicated_chains,
                                                    load_rules, metric_deltas,
                                                    parse_rules, resolve_path)
from fraud_detection_tpu_torch.obs.trace import RowTracer


class ScriptedSource:
    """A mutable snapshot source tests drive step by step."""

    def __init__(self, **state):
        self.state = dict(state)
        self.fail = False

    def __call__(self):
        if self.fail:
            raise RuntimeError("scripted source failure")
        return json.loads(json.dumps(self.state))

    def bump(self, **deltas):
        for k, v in deltas.items():
            self.state[k] = self.state.get(k, 0) + v


def burn_rule(limit=0.05, fast=2.0, slow=8.0, mod=tsentinel, **kw):
    return mod.AlertRule("burn", "burn_rate", num="bad", den="total", op=">",
                         limit=limit, fast_s=fast, slow_s=slow, **kw)


# ---------------------------------------------------------------------------
# rules against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pack,kw", [
    ("default_rule_pack", {}),
    ("default_rule_pack", dict(fast_s=1.0, slow_s=4.0, resolve_s=0.5,
                               p99_ms=250.0)),
    ("fleet_rule_pack", {}),
    ("fleet_rule_pack", dict(fast_s=5.0, slow_s=10.0)),
])
def test_rule_packs_equal_jax_field_for_field(pack, kw):
    got = [dataclasses.asdict(r) for r in getattr(tsentinel, pack)(**kw)]
    want = [dataclasses.asdict(r) for r in getattr(jsentinel, pack)(**kw)]
    assert got == want and got


def test_resolve_path_and_parse_rules_equal_jax(tmp_path):
    snap = {"a": {"b": 3}, "c": [10, {"d": 4}], "e": None, "f": 2}
    for path in ("a.b", "c.1.d", "a.b+f", "e", "a.z", "a.b+missing", "c.0",
                 "c.9"):
        assert resolve_path(snap, path) == jsentinel.resolve_path(snap, path)
    spec = [{"name": "dlq", "kind": "burn_rate", "num": "dead_lettered",
             "den": "processed", "limit": 0.01, "fast_s": 5, "slow_s": 20},
            {"name": "stall", "kind": "stale", "path": "processed",
             "while_path": "running", "severity": "warning"}]
    path = tmp_path / "rules.json"
    path.write_text(json.dumps({"rules": spec}))
    assert ([dataclasses.asdict(r) for r in load_rules(str(path))]
            == [dataclasses.asdict(r) for r in jsentinel.load_rules(str(path))])


def test_rule_validation_errors():
    with pytest.raises(ValueError, match="unknown kind"):
        AlertRule("x", "nope", path="a")
    with pytest.raises(ValueError, match="severity"):
        AlertRule("x", "static", path="a", severity="page")
    with pytest.raises(ValueError, match="needs a path"):
        AlertRule("x", "static")
    with pytest.raises(ValueError, match="num and den"):
        AlertRule("x", "burn_rate", num="a")
    with pytest.raises(ValueError, match="slow_s"):
        AlertRule("x", "burn_rate", num="a", den="b", fast_s=10, slow_s=5)
    with pytest.raises(ValueError, match="op"):
        AlertRule("x", "static", path="a", op="~=")


def test_parse_rules_rejects_unknown_fields_and_duplicates():
    with pytest.raises(ValueError, match="unknown fields"):
        parse_rules([{"name": "r", "kind": "static", "path": "a",
                      "treshold": 3}])
    with pytest.raises(ValueError, match="duplicate"):
        parse_rules([{"name": "r", "kind": "static", "path": "a"},
                     {"name": "r", "kind": "static", "path": "b"}])


def test_default_and_fleet_packs_cover_the_failure_modes():
    names = {r.name for r in default_rule_pack()}
    assert {"shed_burn", "breaker_open", "explain_coverage_drop",
            "p99_slo_burn", "dlq_rate", "dispatch_stall", "spans_leak",
            "fence_events", "restart_churn"} <= names
    assert {"fleet_watermark_burn", "worker_absence",
            "worker_alerts"} <= {r.name for r in fleet_rule_pack()}


# ---------------------------------------------------------------------------
# one timeline, both sentinels
# ---------------------------------------------------------------------------

def _timeline(t):
    """Engine-health-shaped counters as a pure function of virtual time:
    a shed burst, a DLQ burst, a restart, a stalled stretch."""
    processed = int(t * 200) if t < 14 else 2800
    return {"processed": processed,
            "shed": int(max(0.0, min(t, 9.0) - 4.0) * 40),
            "dead_lettered": int(max(0.0, min(t, 12.0) - 7.0) * 15),
            "rebalanced_commits": 1 if t >= 6 else 0,
            "commits_skipped": 0,
            "running": True,
            "in_flight_depth": 1,
            "row_latency_ms": {"p50": 5.0, "p99": 50.0 if t < 10 else 900.0},
            "trace": {"spans_open": 0},
            "breaker": None, "explain": None, "model": None,
            "supervisor": {"restarts": 0 if t < 11 else 2}}


@pytest.mark.parametrize("step", [0.25, 0.5])
def test_virtual_cadence_timeline_fires_same_incidents_as_jax(tmp_path, step):
    """The default pack (scaled windows) over one health timeline, driven by
    ``VirtualCadence`` on a feed that stops advancing: the same transitions
    at the same virtual times, the same incident log and bundle keys."""
    def run(mod, out):
        feed = {"t": 0.0}
        clock = mod.VirtualCadence(lambda: feed["t"], step=step)
        rec = mod.IncidentRecorder(str(out))
        s = mod.Sentinel(lambda: _timeline(clock_now["t"]),
                         mod.default_rule_pack(fast_s=1.0, slow_s=3.0,
                                               resolve_s=1.0, p99_ms=500.0,
                                               stall_s=2.0),
                         clock=clock, recorder=rec, worker="w0")
        transitions = []
        for i in range(80):
            feed["t"] = min(i * 0.25, 15.0)      # the feed stops at 15 s
            clock_now["t"] = clock()
            transitions += [(tr["event"], tr["rule"], tr.get("fired_at"),
                             tr.get("resolved_at"))
                            for tr in s.evaluate(now=clock_now["t"])]
        lines = [json.loads(x) for x in
                 (out / "incidents.jsonl").read_text().splitlines()]
        bundles = {p.name: sorted(json.loads(
            (p / "bundle.json").read_text())) for p in out.iterdir()
            if p.is_dir()}
        snap = s.snapshot()
        return (transitions, [(x["event"], x["rule"], x["id"]) for x in lines],
                bundles, {k: snap[k] for k in ("fired", "resolved",
                                               "still_firing", "firing")})

    clock_now = {"t": 0.0}
    got = run(tsentinel, tmp_path / "port")
    want = run(jsentinel, tmp_path / "jax")
    assert got == want
    assert got[0], "the timeline fired nothing"


def test_evaluate_timeline_equals_jax():
    class Clock:
        def __init__(self):
            self.t = 0.0

        def advance_to(self, t):
            self.t = t

    def run(mod):
        clock = Clock()

        def source():
            t = clock.t
            return {"total": int(t * 100),
                    "bad": int(max(0.0, min(t, 12.0) - 5.0) * 30)}

        s = mod.Sentinel(source, [burn_rule(limit=0.1, fast=1.0, slow=3.0,
                                            resolve_s=1.0, mod=mod)])
        trs = mod.evaluate_timeline(s, clock, until_s=20.0, interval_s=0.5)
        return [(tr["event"], tr["rule"], tr.get("fired_at"),
                 tr.get("resolved_at")) for tr in trs]

    got = run(tsentinel)
    assert got == run(jsentinel) and len(got) == 2


def _scripted_run(clocks, mod, time_scale: float):
    """``tests/test_sentinel.py``'s scripted run over a ``ScenarioClock``:
    the burn starts at virtual t=5 and stops at t=12, rules evaluated every
    0.5 virtual seconds; returns the transitions and the snapshot."""
    clock = clocks.ScenarioClock(7, time_scale=time_scale)
    real_now = clock.now

    def source():
        t = real_now()
        return {"total": int(t * 100),
                "bad": int(max(0.0, min(t, 12.0) - 5.0) * 30)}

    s = mod.Sentinel(source, [burn_rule(limit=0.1, fast=1.0, slow=3.0,
                                        resolve_s=1.0, mod=mod)])
    clock.start()
    trs = mod.evaluate_timeline(s, clock, until_s=20.0, interval_s=0.5)
    return [(tr["event"], tr["rule"], tr.get("fired_at"),
             tr.get("resolved_at")) for tr in trs], s.snapshot()


def test_warp_and_paced_runs_fire_identical_incident_sequences():
    """A warp run (time_scale 0) and a paced one evaluate the rules at the
    same virtual times and fire the same incident sequence, in the port as
    in the JAX package (exact: virtual times are arithmetic on the clock's
    cursor)."""
    from fraud_detection_tpu import scenarios as jscen
    from fraud_detection_tpu_torch import scenarios as tscen

    warp, warp_snap = _scripted_run(tscen, tsentinel, 0.0)
    paced, paced_snap = _scripted_run(tscen, tsentinel, 0.005)
    assert warp == paced
    assert warp                                  # it actually fired
    assert warp_snap["fired"] == paced_snap["fired"] == 1
    assert warp_snap["resolved"] == paced_snap["resolved"] == 1
    assert warp == _scripted_run(jscen, jsentinel, 0.0)[0]


def test_virtual_cadence_never_stalls():
    vals = iter([0.0, 3.0, 3.0, 3.0])
    vc = VirtualCadence(lambda: next(vals), step=0.5)
    assert [vc(), vc(), vc(), vc()] == [0.0, 3.0, 3.5, 4.0]
    with pytest.raises(ValueError):
        VirtualCadence(lambda: 0.0, step=0.0)


# ---------------------------------------------------------------------------
# burn rates and hysteresis (tests/test_sentinel.py's unit suite)
# ---------------------------------------------------------------------------

def test_burn_rate_needs_both_windows():
    src = ScriptedSource(bad=0, total=0)
    s = Sentinel(src, [burn_rule(limit=0.05, fast=2.0, slow=20.0)])
    t = 0.0
    for _ in range(30):
        src.bump(total=100)
        s.evaluate(now=t)
        t += 1.0
    for _ in range(2):
        src.bump(total=100, bad=20)
        assert s.evaluate(now=t) == []
        t += 1.0
    assert s.firing() == []
    fired = []
    for _ in range(25):
        src.bump(total=100, bad=20)
        fired += s.evaluate(now=t)
        t += 1.0
    assert [f["event"] for f in fired] == ["fired"]
    assert s.firing() == ["burn"]


def test_burn_rate_abstains_without_traffic():
    src = ScriptedSource(bad=0, total=0)
    s = Sentinel(src, [burn_rule(limit=0.05, min_den=10)])
    for t in range(10):
        src.bump(bad=1)
        s.evaluate(now=float(t))
    assert s.firing() == []


def test_for_s_hysteresis_prevents_flap_fire():
    src = ScriptedSource(v=0)
    s = Sentinel(src, [AlertRule("hot", "static", path="v", op=">", limit=10,
                                 for_s=3.0, fast_s=1.0, slow_s=4.0)])
    t = 0.0
    for _ in range(5):
        src.state["v"] = 20
        s.evaluate(now=t)
        s.evaluate(now=t + 1)
        src.state["v"] = 0
        s.evaluate(now=t + 2)
        s.evaluate(now=t + 3)
        t += 4.0
    assert s.fired == 0
    src.state["v"] = 20
    for i in range(4):
        s.evaluate(now=t + i)
    assert s.firing() == ["hot"] and s.fired == 1


def test_resolve_s_hysteresis_prevents_flap_resolve():
    src = ScriptedSource(v=20)
    s = Sentinel(src, [AlertRule("hot", "static", path="v", op=">", limit=10,
                                 resolve_s=5.0, fast_s=1.0, slow_s=4.0)])
    s.evaluate(now=0.0)
    src.state["v"] = 0
    s.evaluate(now=1.0)
    s.evaluate(now=2.0)
    src.state["v"] = 20
    s.evaluate(now=3.0)
    assert s.fired == 1 and s.resolved == 0
    src.state["v"] = 0
    for t in (4.0, 6.0, 9.5):
        s.evaluate(now=t)
    assert s.resolved == 1 and s.firing() == []
    assert s.snapshot()["incidents"][0]["resolved_at"] == 9.5


def test_counter_reset_reads_as_restart_not_negative_burn():
    src = ScriptedSource(bad=40, total=400)
    s = Sentinel(src, [burn_rule(limit=0.05, fast=2.0, slow=4.0)])
    s.evaluate(now=0.0)
    src.state.update(bad=0, total=0)
    src.bump(total=100, bad=10)
    assert [o["event"] for o in s.evaluate(now=2.0)] == ["fired"]


def test_delta_decrease_watches_gauges_from_the_high_water():
    rule = [r for r in fleet_rule_pack(fast_s=8.0, slow_s=16.0)
            if r.name == "worker_absence"]
    src = ScriptedSource()
    src.state = {"fleet": {"n_workers": 1, "committed_lag": 50}}
    s = Sentinel(src, rule)
    s.evaluate(now=0.0)
    src.state["fleet"]["n_workers"] = 2
    s.evaluate(now=0.5)
    src.state["fleet"]["n_workers"] = 1
    assert [o["event"] for o in s.evaluate(now=1.0)] == ["fired"]
    src2 = ScriptedSource()
    src2.state = {"fleet": {"n_workers": 2, "committed_lag": 0}}
    s2 = Sentinel(src2, rule)
    s2.evaluate(now=0.0)
    src2.state["fleet"]["n_workers"] = 0
    assert s2.evaluate(now=1.0) == []


def test_absence_and_stale_rules():
    src = ScriptedSource(progress=0, busy=True)
    s = Sentinel(src, [AlertRule("gone", "absence", path="missing_block",
                                 fast_s=1.0, slow_s=2.0),
                       AlertRule("stuck", "stale", path="progress",
                                 while_path="busy", fast_s=2.0, slow_s=4.0)])
    s.evaluate(now=0.0)
    assert "gone" in s.firing()
    for t in (1.0, 2.0, 3.0):
        s.evaluate(now=t)
    assert "stuck" in s.firing()
    src.bump(progress=5)
    src.state["missing_block"] = {"ok": 1}
    s.evaluate(now=4.0)
    assert s.firing() == []


def test_source_failure_counts_never_raises():
    src = ScriptedSource(v=0)
    s = Sentinel(src, [AlertRule("r", "static", path="v", op=">", limit=1,
                                 fast_s=1.0, slow_s=2.0)])
    src.fail = True
    assert s.evaluate(now=0.0) == []
    assert s.snapshot()["eval_errors"] == 1


# ---------------------------------------------------------------------------
# the alerts block, the engine, the flight recorder
# ---------------------------------------------------------------------------

def _alerts_snapshot(mod):
    src = ScriptedSource(v=20)
    s = mod.Sentinel(src, [
        mod.AlertRule("a", "static", path="v", op=">", limit=10, fast_s=1.0,
                      slow_s=2.0),
        mod.AlertRule("b", "static", path="v", op=">", limit=5,
                      severity="warning", fast_s=1.0, slow_s=2.0)])
    s.evaluate(now=0.0)
    src.state["v"] = 8
    s.evaluate(now=1.0)
    return s, s.snapshot()


# The alerts block's exact key set and types: a module-level dict literal so
# flightcheck's health-schema lint (analysis/health.py, FC301) checks
# Sentinel.snapshot() against it statically.
ALERTS_BLOCK_SCHEMA = {
    "worker": (str,),
    "rules": (int,),
    "evaluations": (int,),
    "eval_errors": (int,),
    "last_eval_at": (type(None), int, float),
    "ring_depth": (int,),
    "firing": (list,),
    "critical_firing": (list,),
    "pending": (list,),
    "fired": (int,),
    "resolved": (int,),
    "still_firing": (int,),
    "incidents": (list,),
    "recorder": (type(None), dict),
}


def test_alerts_block_schema_and_accounting_equal_jax():
    from tests.test_sentinel import ALERTS_BLOCK_SCHEMA as JSCHEMA

    assert set(ALERTS_BLOCK_SCHEMA) == set(JSCHEMA)
    s, snap = _alerts_snapshot(tsentinel)
    _, jsnap = _alerts_snapshot(jsentinel)
    assert snap == jsnap
    assert set(snap) == set(ALERTS_BLOCK_SCHEMA)
    for key, types in ALERTS_BLOCK_SCHEMA.items():
        assert isinstance(snap[key], types), (key, type(snap[key]))
    json.dumps(snap)
    assert snap["fired"] == snap["resolved"] + snap["still_firing"]
    assert snap["critical_firing"] == [] and snap["firing"] == ["b"]
    assert s.healthz() == (True, [])


def test_engine_health_carries_alerts_block():
    from fraud_detection_tpu_torch import convert
    from fraud_detection_tpu_torch.featurize.tfidf import (
        HashingTfIdfFeaturizer)
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from fraud_detection_tpu_torch.stream import (InProcessBroker,
                                                  StreamingClassifier)

    import numpy as np

    pipe = ServingPipeline(HashingTfIdfFeaturizer(num_features=64),
                           convert.logistic_from_arrays(np.zeros(64), -8.0,
                                                        device="cpu"),
                           batch_size=16, device="cpu")
    broker = InProcessBroker()
    feeder = broker.producer()
    for i in range(16):
        feeder.produce("in", json.dumps({"text": f"hello {i}"}).encode(),
                       key=str(i).encode())
    source = ChainedHealthSource()
    sentinel = Sentinel(source, default_rule_pack())
    engine = StreamingClassifier(pipe, broker.consumer(["in"], "g"),
                                 broker.producer(), "out", batch_size=16,
                                 sentinel=sentinel)
    source.attach(engine)
    engine.run(max_messages=16, idle_timeout=2.0)
    sentinel.evaluate()
    h = engine.health()
    assert set(h["alerts"]) == set(_alerts_snapshot(jsentinel)[1])
    assert h["alerts"]["fired"] == 0
    assert source()["supervisor"]["restarts"] == 0


def test_incident_log_and_bundle(tmp_path):
    src = ScriptedSource(bad=0, total=0)
    rec = IncidentRecorder(str(tmp_path / "inc"))
    s = Sentinel(src, [burn_rule(limit=0.05, fast=2.0, slow=4.0,
                                 resolve_s=1.0)], recorder=rec, worker="t0")
    s.evaluate(now=0.0)
    src.bump(total=100, bad=20)
    s.evaluate(now=1.0)
    assert s.firing() == ["burn"]
    for t in (3.0, 6.0, 9.0):
        src.bump(total=100)
        s.evaluate(now=t)
    assert s.firing() == []
    lines = [json.loads(x) for x in
             (tmp_path / "inc" / "incidents.jsonl").read_text().splitlines()]
    assert [x["event"] for x in lines] == ["fired", "resolved"]
    bundle_dir = tmp_path / "inc" / lines[0]["id"]
    bundle = json.loads((bundle_dir / "bundle.json").read_text())
    assert bundle["rule"]["name"] == "burn"
    assert bundle["evidence_window"][0]["value"] == {"fast": 0.2, "slow": 0.2}
    assert bundle["ring"]["deltas"]["bad"] == 20
    assert bundle["health"]["total"] == 100
    assert json.loads((bundle_dir / "resolution.json").read_text())[
        "incident"]["resolved_at"] is not None
    assert rec.snapshot()["recorded"] == 2


def test_bundle_keys_and_implicated_chains_equal_jax(tmp_path):
    """A DLQ'd row on the tracer, a firing rule: the port's bundle has the
    JAX bundle's keys, and the same implicated chain."""
    def run(mod, tracer_cls, out):
        tracer = tracer_cls(worker="w0", sample=1.0, seed=0,
                            wall=lambda: 0.0)
        bt = tracer.batch_begin(4)
        cid = f"{bt.cid}:0:7"
        bt.event("dlq", cid, ok=False, detail="poison")
        tracer.commit(bt)
        rec = mod.IncidentRecorder(str(out), rowtrace=tracer)
        s = mod.Sentinel(ScriptedSource(v=20),
                         [mod.AlertRule("a", "static", path="v", op=">",
                                        limit=1, fast_s=1.0, slow_s=2.0)],
                         recorder=rec)
        s.evaluate(now=0.0)
        incident = s.snapshot()["incidents"][0]
        bundle = json.loads((out / incident["id"] / "bundle.json").read_text())
        chains = [{k: (v if k != "chain" else
                       [{kk: vv for kk, vv in sp.items()
                         if kk != "duration_ms"} for sp in v])
                   for k, v in c.items()} for c in bundle["chains"]]
        return sorted(bundle), chains, cid

    keys, chains, cid = run(tsentinel, RowTracer, tmp_path / "p")
    jkeys, jchains, _ = run(jsentinel, JRowTracer, tmp_path / "j")
    assert keys == jkeys and chains == jchains
    assert chains[0]["cid"] == cid and chains[0]["event"] == "dlq"
    assert {"poll", "dlq"} <= {sp["stage"] for sp in chains[0]["chain"]}


def test_metric_deltas_and_implicated_chains_equal_jax():
    old = {"a": 1, "b": {"c": 2, "d": 5}, "s": "x", "gone": 3}
    new = {"a": 4, "b": {"c": 1, "d": 5}, "s": "y", "fresh": 9}
    assert metric_deltas(old, new) == jsentinel.metric_deltas(old, new) == {
        "a": 3, "b.c": -1}
    tr, jtr = (RowTracer(worker="w", seed=0, wall=lambda: 0.0),
               JRowTracer(worker="w", seed=0, wall=lambda: 0.0))
    for t in (tr, jtr):
        bt = t.batch_begin(2)
        bt.event("shed", f"{bt.cid}:1:3", ok=False, detail="shed_rate")
        t.commit(bt)

    def shape(chains):
        return [(c["cid"], c["event"], [(s["stage"], s["ok"], s["detail"])
                                        for s in c["chain"]]) for c in chains]

    assert shape(implicated_chains(tr)) == shape(
        jsentinel.implicated_chains(jtr))


# ---------------------------------------------------------------------------
# exact accounting across a supervised chaos chain
# ---------------------------------------------------------------------------

def test_incident_accounting_exact_across_supervised_chaos(tmp_path):
    """One sentinel over the chain-cumulative source, evaluated on every
    poll on a virtual clock while a seeded plan kills incarnations: the
    restart churn is detected and ``fired == resolved + still_firing`` at
    every observation."""
    import numpy as np

    from fraud_detection_tpu_torch import convert
    from fraud_detection_tpu_torch.featurize.tfidf import (
        HashingTfIdfFeaturizer)
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from fraud_detection_tpu_torch.stream import InProcessBroker
    from fraud_detection_tpu_torch.stream.engine import (StreamingClassifier,
                                                         run_supervised)
    from fraud_detection_tpu_torch.stream.faults import FaultPlan

    pipe = ServingPipeline(HashingTfIdfFeaturizer(num_features=64),
                           convert.logistic_from_arrays(np.zeros(64), -8.0,
                                                        device="cpu"),
                           batch_size=32, device="cpu")
    broker = InProcessBroker(num_partitions=2)
    feeder = broker.producer()
    for i in range(400):
        feeder.produce("in", json.dumps({"text": f"msg {i}"}).encode(),
                       key=str(i).encode())
    plan = FaultPlan(seed=3, poll_error_rate=0.12, flush_crash_rate=0.05,
                     corrupt_rate=0.05, max_faults=25, sleep=lambda s: None)
    source = ChainedHealthSource()
    rec = IncidentRecorder(str(tmp_path))
    clock = VirtualCadence(lambda: 0.0, step=0.1)
    sentinel = Sentinel(source, default_rule_pack(fast_s=0.5, slow_s=2.0,
                                                  resolve_s=0.5),
                        clock=clock, recorder=rec, worker="w0")
    sentinel.prime()

    class Watched:
        """The consumer, with the sentinel evaluated before every poll."""

        def __init__(self, inner):
            self.inner = inner

        def poll_batch(self, n, timeout):
            sentinel.evaluate()
            snap = sentinel.snapshot()
            assert snap["fired"] == snap["resolved"] + snap["still_firing"]
            return self.inner.poll_batch(n, timeout)

        def __getattr__(self, name):
            return getattr(self.inner, name)

    dlq_attempts: dict = {}

    def make_engine():
        engine = StreamingClassifier(
            pipe, Watched(plan.consumer(broker.consumer(["in"], "g"))),
            plan.producer(broker.producer()), "out", batch_size=32,
            max_wait=0.01, dlq_topic="dlq", dlq_attempts=dlq_attempts,
            sentinel=sentinel)
        source.attach(engine)
        return engine

    stats = run_supervised(make_engine, max_restarts=40, idle_timeout=0.2,
                           backoff=0.0, sleep=lambda s: None)
    assert stats.restarts > 0
    sentinel.evaluate()
    snap = sentinel.snapshot()
    assert snap["fired"] == snap["resolved"] + snap["still_firing"]
    assert "restart_churn" in {i["rule"] for i in snap["incidents"]}
    lines = [json.loads(x) for x in
             (tmp_path / "incidents.jsonl").read_text().splitlines()]
    assert len([x for x in lines if x["event"] == "fired"]) == snap["fired"]
    assert (len([x for x in lines if x["event"] == "resolved"])
            == snap["resolved"])


# ---------------------------------------------------------------------------
# /healthz
# ---------------------------------------------------------------------------

def test_healthz_flips_503_on_critical_alert():
    from fraud_detection_tpu_torch.obs import MetricsRegistry
    from fraud_detection_tpu_torch.obs.export import MetricsServer

    src = ScriptedSource(v=0)
    s = Sentinel(src, [AlertRule("crit", "static", path="v", op=">",
                                 limit=10, fast_s=1.0, slow_s=2.0),
                       AlertRule("warn", "static", path="v", op=">",
                                 limit=5, severity="warning",
                                 fast_s=1.0, slow_s=2.0)])
    registry = MetricsRegistry()
    server = MetricsServer(registry, 0, healthz_fn=s.healthz)
    url = f"http://127.0.0.1:{server.port}/healthz"
    try:
        assert json.loads(urllib.request.urlopen(url).read()) == {
            "ok": True, "alerts": True, "firing": []}
        src.state["v"] = 8
        s.evaluate(now=0.0)
        assert json.loads(urllib.request.urlopen(url).read())["ok"] is True
        src.state["v"] = 20
        s.evaluate(now=1.0)
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(url)
        assert exc.value.code == 503
        doc = json.loads(exc.value.read())
        assert doc["ok"] is False and doc["firing"] == ["crit"]
        flat = registry.render_json()["metrics"]
        assert flat["fraud_metrics_scrapes_total"] >= 3
    finally:
        server.close()


def test_healthz_without_sentinel_reports_unwatched():
    from fraud_detection_tpu_torch.obs import MetricsRegistry
    from fraud_detection_tpu_torch.obs.export import MetricsServer

    server = MetricsServer(MetricsRegistry(), 0)
    try:
        assert json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/healthz").read()) == {
            "ok": True, "alerts": False, "firing": []}
    finally:
        server.close()


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

def _serve_stats(capsys):
    out = capsys.readouterr().out
    return json.loads([x for x in out.splitlines() if x.startswith("{")][-1])


def test_serve_cli_alerts_chaos_fires_and_records(tmp_path, capsys):
    from fraud_detection_tpu_torch.app.serve import main

    inc = tmp_path / "incidents"
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps([
        {"name": "dlq_rate", "kind": "burn_rate", "num": "dead_lettered",
         "den": "processed", "limit": 0.0005, "fast_s": 5, "slow_s": 10},
        {"name": "fence_events", "kind": "delta",
         "path": "rebalanced_commits", "op": ">=", "limit": 1,
         "fast_s": 5, "slow_s": 10},
        {"name": "restart_churn", "kind": "delta",
         "path": "supervisor.restarts", "op": ">=", "limit": 1,
         "severity": "warning", "fast_s": 5, "slow_s": 10}]))
    rc = main(["--device", "cpu", "--model", "synthetic", "--demo", "600",
               "--batch-size", "64", "--max-wait", "0.01",
               "--chaos", "--chaos-seed", "5", "--dlq",
               "--alert-rules", str(rules), "--incident-dir", str(inc),
               "--alert-interval", "0.05"])
    assert rc == 0
    alerts = _serve_stats(capsys)["alerts"]
    assert alerts["fired"] >= 1, alerts
    assert alerts["fired"] == alerts["resolved"] + alerts["still_firing"]
    lines = [json.loads(x) for x in
             (inc / "incidents.jsonl").read_text().splitlines()]
    first = next(x for x in lines if x["event"] == "fired")
    bundle = json.loads((inc / first["id"] / "bundle.json").read_text())
    assert bundle["rule"]["name"] == first["rule"]
    assert bundle["health"] is not None


def test_serve_cli_clean_run_zero_incidents(tmp_path, capsys):
    from fraud_detection_tpu_torch.app.serve import main

    inc = tmp_path / "incidents"
    rc = main(["--device", "cpu", "--model", "synthetic", "--demo", "600",
               "--batch-size", "64", "--max-wait", "0.01", "--alerts",
               "--incident-dir", str(inc), "--alert-interval", "0.05"])
    assert rc == 0
    stats = _serve_stats(capsys)
    assert stats["alerts"]["fired"] == 0, stats["alerts"]
    assert stats["alerts"]["evaluations"] >= 1
    assert not (inc / "incidents.jsonl").exists()
