"""The port's closed-loop autoscaling (``fleet/autoscale/``) against the JAX
package's, on the CPU.

Everything that decides is driven on injected clocks and explicit calls,
and is held EQUAL to the reference: ``ScalePolicy.decide`` over one seeded
signal sequence gives equal ``ScaleDecision.as_dict()`` and denial counts,
and ``Autoscaler.step`` with fake provisioner, coordinator, control lane and
recorder over a stepped clock gives equal decisions, launches, releases,
published records, recorded evidence and ``stats()``. The rest mirrors
``tests/test_autoscale.py``'s unit cases on the port (hysteresis, cooldown,
clamps, replace precedence and the work gate, fresh worker ids, pending
launches as live capacity, newest-first scale-in, the stats block schema,
the thread provisioner). A real fleet grows under a forced burn signal and
shrinks back by a voluntary leave with every key classified exactly once;
it asserts only what a loaded run still guarantees. The reference's
wall-clock scale-out/scale-in loop (0.02 s ticks, 0.25 s windows) is not
copied: it is one of its timing tests that flake under load.
"""

import json
import random

import pytest

from fraud_detection_tpu.fleet import autoscale as jauto
from fraud_detection_tpu.models.pipeline import synthetic_demo_pipeline
from fraud_detection_tpu_torch.fleet import Fleet
from fraud_detection_tpu_torch.fleet import autoscale as tauto
from fraud_detection_tpu_torch.fleet.autoscale import (Autoscaler,
                                                       ScalePolicy,
                                                       ThreadProvisioner,
                                                       WorkerProvisioner)
from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
from fraud_detection_tpu_torch.stream import InProcessBroker
from tests.torch_parity import port_featurizer, port_model, warmed

pytestmark = pytest.mark.fleet

# The fleet view's "autoscale" block: the reference's keys and types.
AUTOSCALE_BLOCK_SCHEMA = {
    "desired": (int,),
    "live": (int,),
    "min": (int,),
    "max": (int,),
    "scale_outs": (int,),
    "scale_ins": (int,),
    "replacements": (int,),
    "denied": (int,),
    "cooldown_remaining_s": (int, float),
    "last_decision": (dict, type(None)),
}

BURN = ["fleet_watermark_burn"]
IDLE = ["fleet_idle"]


def assert_autoscale_block(block):
    assert set(block) == set(AUTOSCALE_BLOCK_SCHEMA)
    for key, types in AUTOSCALE_BLOCK_SCHEMA.items():
        assert isinstance(block[key], types), (key, block[key])


@pytest.fixture(scope="module")
def pipe():
    jp = synthetic_demo_pipeline(batch_size=64, n=300, seed=3,
                                 num_features=1024,
                                 corpus_kwargs=dict(hard_fraction=0.0,
                                                    label_noise=0.0))
    return warmed(ServingPipeline(port_featurizer(jp.featurizer),
                                  port_model(jp.model), batch_size=64,
                                  device="cpu"))


def feed(broker, n, topic="in"):
    producer = broker.producer()
    for i in range(n):
        producer.produce(topic,
                         json.dumps({"text": f"hello dialogue {i}",
                                     "id": i}).encode(),
                         key=str(i).encode())


# ---------------------------------------------------------------------------
# ScalePolicy: the port's own cases
# ---------------------------------------------------------------------------

def test_policy_validates_configuration():
    with pytest.raises(ValueError, match="min_workers"):
        ScalePolicy(min_workers=0, max_workers=2)
    with pytest.raises(ValueError, match="max_workers"):
        ScalePolicy(min_workers=3, max_workers=2)
    with pytest.raises(ValueError, match="cooldown_s"):
        ScalePolicy(min_workers=1, max_workers=2, cooldown_s=-1)
    with pytest.raises(ValueError, match="out_for_s"):
        ScalePolicy(min_workers=1, max_workers=2, out_for_s=-1)
    with pytest.raises(ValueError, match="step"):
        ScalePolicy(min_workers=1, max_workers=2, step=0)


def test_policy_scale_out_hysteresis():
    p = ScalePolicy(min_workers=1, max_workers=4, out_for_s=5.0,
                    cooldown_s=0.0)
    assert p.decide(0.0, firing=BURN, live=2, desired=2) is None
    assert p.decide(4.9, firing=BURN, live=2, desired=2) is None
    assert p.decide(5.0, firing=[], live=2, desired=2) is None
    assert p.decide(6.0, firing=BURN, live=2, desired=2) is None
    d = p.decide(11.0, firing=BURN, live=2, desired=2)
    assert d is not None and d.kind == "scale_out"
    assert d.reason == "fleet_watermark_burn"
    assert (d.desired_before, d.desired_after) == (2, 3)


def test_policy_scale_in_hysteresis_and_burn_wins():
    p = ScalePolicy(min_workers=1, max_workers=4, in_for_s=5.0,
                    cooldown_s=0.0)
    assert p.decide(0.0, firing=IDLE, live=3, desired=3) is None
    d = p.decide(3.0, firing=BURN + IDLE, live=3, desired=3)
    assert d is not None and d.kind == "scale_out"
    p2 = ScalePolicy(min_workers=1, max_workers=4, in_for_s=5.0,
                     cooldown_s=0.0)
    p2.decide(0.0, firing=IDLE, live=3, desired=3)
    d = p2.decide(5.0, firing=IDLE, live=3, desired=3)
    assert d is not None and d.kind == "scale_in"
    assert (d.desired_before, d.desired_after) == (3, 2)


def test_policy_cooldown_suppresses_and_credits_hysteresis():
    p = ScalePolicy(min_workers=1, max_workers=4, cooldown_s=30.0,
                    out_for_s=5.0)
    p.decide(0.0, firing=BURN, live=2, desired=2)
    assert p.decide(5.0, firing=BURN, live=2, desired=2).kind == "scale_out"
    assert p.decide(10.0, firing=BURN, live=3, desired=3) is None
    assert p.decide(34.9, firing=BURN, live=3, desired=3) is None
    d = p.decide(35.1, firing=BURN, live=3, desired=3)
    assert d is not None and d.kind == "scale_out"


def test_policy_clamps_deny_once_per_cooldown_window():
    p = ScalePolicy(min_workers=2, max_workers=3, cooldown_s=10.0)
    assert p.decide(0.0, firing=BURN, live=3, desired=3) is None
    assert p.denied == 1
    assert p.decide(1.0, firing=BURN, live=3, desired=3) is None
    assert p.decide(9.0, firing=BURN, live=3, desired=3) is None
    assert p.denied == 1
    assert p.decide(10.5, firing=BURN, live=3, desired=3) is None
    assert p.denied == 2
    assert p.decide(21.0, firing=IDLE, live=2, desired=2) is None
    assert p.denied == 3


def test_policy_replace_precedence_and_work_gate():
    p = ScalePolicy(min_workers=1, max_workers=4, cooldown_s=30.0,
                    out_for_s=5.0)
    p.decide(0.0, firing=BURN, live=3, desired=3)
    assert p.decide(5.0, firing=BURN, live=3, desired=3) is not None
    d = p.decide(6.0, firing=BURN, live=3, desired=4)
    assert d is not None and d.kind == "replace"
    assert (d.desired_before, d.desired_after) == (4, 4)
    assert p.decide(7.0, firing=[], live=3, desired=4,
                    work_remaining=False) is None


def test_policy_snapshot_shape():
    p = ScalePolicy(min_workers=1, max_workers=4, cooldown_s=10.0)
    p.decide(0.0, firing=BURN, live=2, desired=2)
    assert p.snapshot(4.0) == {"min": 1, "max": 4, "denied": 0,
                               "cooldown_remaining_s": 6.0}


# ---------------------------------------------------------------------------
# ScalePolicy: one signal sequence in both packages
# ---------------------------------------------------------------------------

def _signals(seed, n=400):
    rng = random.Random(seed)
    seq, t, live, desired = [], 0.0, 2, 2
    for _ in range(n):
        t = round(t + rng.choice([0.1, 0.5, 1.0, 2.5]), 6)
        firing = rng.choice([[], BURN, IDLE, BURN + IDLE, ["other"]])
        live = max(0, live + rng.choice([-1, 0, 0, 0, 1]))
        desired = max(1, min(6, desired + rng.choice([-1, 0, 0, 1])))
        seq.append((t, firing, live, desired, rng.random() < 0.9))
    return seq


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("knobs", [
    dict(min_workers=1, max_workers=4, cooldown_s=3.0, out_for_s=1.0,
         in_for_s=2.0),
    dict(min_workers=2, max_workers=5, cooldown_s=0.0, step=2),
], ids=["hysteresis", "step2"])
def test_policy_decisions_equal_jax(seed, knobs):
    pols = [tauto.ScalePolicy(**knobs), jauto.ScalePolicy(**knobs)]
    for t, firing, live, desired, work in _signals(seed):
        got = [p.decide(t, firing=firing, live=live, desired=desired,
                        work_remaining=work) for p in pols]
        assert [None if d is None else d.as_dict() for d in got][0] == \
            [None if d is None else d.as_dict() for d in got][1], t
        if t % 7 < 0.5:
            for p in pols:
                p.note_denied(t)
        assert pols[0].snapshot(t) == pols[1].snapshot(t)


# ---------------------------------------------------------------------------
# Autoscaler: fakes shared by both packages
# ---------------------------------------------------------------------------

class FakeCoordinator:
    def __init__(self, members=("w0", "w1"), lag=10):
        self.members = list(members)
        self.lag = lag
        self.term = 3
        self.released = []
        self.refuse_release = False

    def last_view(self):
        return {"workers": list(self.members),
                "n_workers": len(self.members),
                "global_backlog": 0, "backlog_per_worker": 0.0,
                "committed_lag": self.lag}

    def request_release(self, worker_id):
        if self.refuse_release or worker_id not in self.members:
            return False
        self.released.append(worker_id)
        return True


def _provisioner(base):
    class FakeProvisioner(base):
        kind = "fake"

        def __init__(self, accept=True):
            self.accept = accept
            self.launched = []

        def launch(self, worker_id):
            if not self.accept:
                return False
            self.launched.append(worker_id)
            return True

    return FakeProvisioner


FakeProvisioner = _provisioner(WorkerProvisioner)


class FakeControl:
    def __init__(self):
        self.published = []

    def publish(self, kind, sender, payload, *, term=0):
        self.published.append((kind, sender, payload, term))


class FakeRecorder:
    def __init__(self):
        self.scales = []

    def record_scale(self, decision, evidence_window=()):
        self.scales.append((decision, list(evidence_window)))
        return True


def _autoscaler(coord, prov, *, firing, control=None, recorder=None, **pol):
    policy = ScalePolicy(**{"min_workers": 1, "max_workers": 4,
                            "cooldown_s": 0.0, **pol})
    return Autoscaler(policy, prov, coord, initial_workers=2,
                      firing=firing, control=control, recorder=recorder,
                      launch_grace_s=5.0)


def test_autoscaler_validates_initial_workers():
    with pytest.raises(ValueError, match="bounds"):
        Autoscaler(ScalePolicy(min_workers=3, max_workers=4),
                   FakeProvisioner(), FakeCoordinator(), initial_workers=2)


def test_autoscaler_scale_out_fresh_ids_and_pending_counts_as_live():
    coord = FakeCoordinator()
    prov = FakeProvisioner()
    signals = {"firing": BURN}
    a = _autoscaler(coord, prov, firing=lambda: signals["firing"])
    d = a.step(now=1.0)
    assert d is not None and d.kind == "scale_out"
    assert prov.launched == ["w2"]
    signals["firing"] = []
    assert a.step(now=1.1) is None
    assert prov.launched == ["w2"]
    st = a.stats()
    assert st["desired"] == 3 and st["live"] == 3 and st["scale_outs"] == 1
    coord.members.append("w2")
    a.step(now=1.2)
    assert a.stats()["live"] == 3


def test_autoscaler_replaces_after_launch_grace_with_fresh_id():
    coord = FakeCoordinator()
    prov = FakeProvisioner()
    a = _autoscaler(coord, prov, firing=lambda: BURN)
    a.step(now=1.0)
    d = a.step(now=7.0)
    assert d is not None and d.kind == "replace"
    assert prov.launched == ["w2", "w3"]
    assert a.stats()["replacements"] == 1 and a.stats()["desired"] == 3


def test_autoscaler_no_replace_when_work_done():
    prov = FakeProvisioner()
    a = _autoscaler(FakeCoordinator(members=("w0",), lag=0), prov,
                    firing=lambda: [])
    assert a.step(now=1.0) is None
    assert prov.launched == []


def test_autoscaler_scale_in_newest_first_and_refusal_denies():
    coord = FakeCoordinator(members=("w0", "w1", "w2"))
    t = [1.0]
    a = Autoscaler(ScalePolicy(min_workers=1, max_workers=4,
                               cooldown_s=10.0),
                   FakeProvisioner(), coord, initial_workers=3,
                   firing=lambda: IDLE, clock=lambda: t[0])
    d = a.step()
    assert d is not None and d.kind == "scale_in"
    assert coord.released == ["w2"]
    coord.refuse_release = True
    t[0] = 12.0
    assert a.step() is None
    assert a.policy.denied == 1
    assert a.stats()["cooldown_remaining_s"] > 0


def test_autoscaler_publishes_term_stamped_and_records_evidence():
    control, recorder = FakeControl(), FakeRecorder()
    a = _autoscaler(FakeCoordinator(), FakeProvisioner(),
                    firing=lambda: BURN, control=control, recorder=recorder)
    a.step(now=1.0)
    (kind, sender, payload, term), = control.published
    assert (kind, sender, term, payload["term"]) == \
        ("scale", "autoscaler", 3, 3)
    assert payload["kind"] == "scale_out"
    (decision, window), = recorder.scales
    (at, sample), = window
    assert at == 1.0 and sample["firing"] == ["fleet_watermark_burn"]


def test_autoscaler_stats_block_schema_and_report():
    a = _autoscaler(FakeCoordinator(), FakeProvisioner(),
                    firing=lambda: BURN)
    assert_autoscale_block(a.stats())
    a.step(now=1.0)
    assert_autoscale_block(a.stats())
    assert a.stats()["last_decision"]["kind"] == "scale_out"
    rep = a.report()
    assert rep["provisioner"] == "fake"
    assert [d["kind"] for d in rep["decisions"]] == ["scale_out"]


def test_thread_provisioner_idempotent_ledger():
    calls = []

    def spawn(wid):
        calls.append(wid)
        return wid != "nope"

    p = ThreadProvisioner(spawn)
    assert p.kind == "thread"
    assert p.launch("w2") and p.launch("w2")
    assert calls == ["w2"]
    assert not p.launch("nope")
    assert p.launched() == ["w2"]


# ---------------------------------------------------------------------------
# Autoscaler: one stepped run in both packages
# ---------------------------------------------------------------------------

def _stepped_run(mod, seed, steps=120):
    """Autoscaler.step over a stepped clock, with members that join, die and
    leave and a provisioner that sometimes refuses; everything observable."""
    rng = random.Random(seed)
    coord = FakeCoordinator(members=("w0", "w1"))
    prov = _provisioner(mod.WorkerProvisioner)()
    control, recorder = FakeControl(), FakeRecorder()
    signal = {"firing": []}
    t = [0.0]
    a = mod.Autoscaler(
        mod.ScalePolicy(min_workers=1, max_workers=4, cooldown_s=2.0,
                        out_for_s=0.5, in_for_s=1.0),
        prov, coord, initial_workers=2, firing=lambda: signal["firing"],
        control=control, recorder=recorder, clock=lambda: t[0],
        launch_grace_s=3.0)
    trail = []
    for _ in range(steps):
        t[0] = round(t[0] + rng.choice([0.25, 0.5, 1.0]), 6)
        signal["firing"] = rng.choice([[], BURN, BURN, IDLE, BURN + IDLE])
        coord.lag = rng.choice([0, 5, 50])
        prov.accept = rng.random() < 0.85
        coord.refuse_release = rng.random() < 0.2
        for wid in list(prov.launched):
            if wid not in coord.members and rng.random() < 0.5:
                coord.members.append(wid)
        for wid in list(coord.released):
            if wid in coord.members and rng.random() < 0.5:
                coord.members.remove(wid)
        if coord.members and rng.random() < 0.05:
            coord.members.pop(rng.randrange(len(coord.members)))
        d = a.step()
        trail.append((None if d is None else d.as_dict(), a.stats(),
                      list(prov.launched), list(coord.released)))
    return trail, a.report(), control.published, recorder.scales


@pytest.mark.parametrize("seed", range(4))
def test_autoscaler_stepped_run_equals_jax(seed):
    port, ref = _stepped_run(tauto, seed), _stepped_run(jauto, seed)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2] and port[3] == ref[3]
    assert any(s[0] is not None for s in port[0])   # the run decided things


# ---------------------------------------------------------------------------
# a real fleet breathes out and back in
# ---------------------------------------------------------------------------

def test_fleet_scales_out_and_back_in_exactly_once(pipe):
    """A forced burn grows a real 2-worker fleet (a fresh worker w2 joins
    through the ordinary path); the idle signal after it shrinks the fleet
    by a voluntary leave on the revoke barrier; every key is classified
    exactly once. Threads make the number of ticks depend on the load, so
    only what a loaded run guarantees is asserted."""
    broker = InProcessBroker(num_partitions=4)
    feed(broker, 1200)
    fleet = Fleet.in_process(
        broker, pipe, "in", "out", 2, batch_size=64, lease_ttl=3.0,
        heartbeat_interval=0.02, tick_interval=0.02,
        autoscale=dict(min_workers=2, max_workers=3, cooldown_s=0.0))
    scaler = fleet.autoscaler
    # burn until the fleet grew once, then idle for good
    scaler.firing = lambda: BURN if scaler.scale_outs == 0 else IDLE
    out = fleet.run(idle_timeout=1.0, join_timeout=120.0)
    assert sorted(m.key for m in broker.messages("out")) == \
        sorted(str(i).encode() for i in range(1200))
    assert out["errors"] == []
    scale = out["autoscale"]
    assert_autoscale_block({k: v for k, v in scale.items()
                            if k not in ("provisioner", "decisions")})
    assert scale["provisioner"] == "thread"
    assert scale["scale_outs"] == 1
    # a tick that finds a worker not yet joined replaces it first
    kinds = [d["kind"] for d in scale["decisions"] if d["kind"] != "replace"]
    assert kinds[0] == "scale_out" and set(kinds) <= {"scale_out",
                                                      "scale_in"}
    assert len(out["per_worker"]) >= 3     # the scaled-out worker joined
    assert_autoscale_block(fleet.coordinator.last_view()["autoscale"])
