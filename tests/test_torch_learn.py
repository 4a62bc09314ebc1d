"""The port's closed learning loop (``learn/``, ``stream/feedback.py``,
``scenarios/traffic.drift_scam_pool``) on the CPU, against the JAX package.

* Feedback records are byte-equal to the JAX records, and malformed ones
  parse to None in both.
* The window store driven with the same operations as the JAX store gives
  the same join outcomes and snapshots (a hypothesis property), and the
  reference's accounting invariant holds.
* ``drift_scam_pool`` equals the JAX pool at three seeds.
* The reference's inline learn-loop tests run on the port: drifted rows and
  their labels trigger a refresh, which publishes, stages, replays the
  window to the shadow and promotes through the real controller; an
  impossible policy leaves the candidate staged.
* ``health()["learn"]`` has the JAX engine's keys; a fault of the card stops
  the lane, a failed retrain of any other kind is counted.
"""

import json

import numpy as np
import pytest

from fraud_detection_tpu.learn import LearnConfig as JConfig
from fraud_detection_tpu.learn import WindowStore as JStore
from fraud_detection_tpu.scenarios.traffic import drift_scam_pool as jpool
from fraud_detection_tpu.stream import feedback as jfb
from fraud_detection_tpu_torch.learn import LearnConfig, LearnLoop, WindowStore
from fraud_detection_tpu_torch.scenarios import drift_scam_pool
from fraud_detection_tpu_torch.stream import feedback as pfb
from fraud_detection_tpu_torch.stream import InProcessBroker

IN = "learn-in"


# ---------------------------------------------------------------------------
# feedback records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topic,partition,offset,label", [
    ("t", 3, 41, 1), ("customer-dialogues-raw", 0, 0, 0),
    ("ünïcode topic", 7, 2 ** 40, 2), ("", 0, 5, 1)])
def test_label_records_are_byte_equal_to_jax(topic, partition, offset, label):
    rec = pfb.label_record(topic, partition, offset, label)
    assert rec == jfb.label_record(topic, partition, offset, label)
    parsed = pfb.parse_label(rec)
    assert parsed == jfb.parse_label(rec)
    assert parsed.key == (topic, partition, offset) and parsed.label == label


@pytest.mark.parametrize("raw", [
    b"not json",
    b"[1, 2]",
    b'{"label": 1}',
    b'{"source": {"topic": "t", "partition": 0}, "label": 1}',
    b'{"source": {"topic": "t", "partition": 0, "offset": 1}, "label": "x"}',
    b'{"source": {"topic": "t", "partition": 0, "offset": 1}, "label": true}',
    b'{"source": {"topic": "t", "partition": "0", "offset": 1}, "label": 1}',
    b'{"source": {"topic": 5, "partition": 0, "offset": 1}, "label": 1}',
    b'{"source": {"topic": "t", "partition": 0, "offset": false}, "label": 1}',
    b"\xff\xfe",
])
def test_malformed_labels_parse_to_none_as_in_jax(raw):
    assert pfb.parse_label(raw) is None and jfb.parse_label(raw) is None


# ---------------------------------------------------------------------------
# window store
# ---------------------------------------------------------------------------

def _row(i, partition=0, topic="in"):
    return ((topic, partition, i), np.array([i % 7], np.int16),
            np.array([1], np.uint16))


def _invariant(snap):
    return (snap["joined"] + snap["expired"] + snap["missed"]
            + snap["pending_labels"] == snap["labels_seen"])


def test_store_join_eviction_and_accounting():
    t = {"now": 0.0}
    store = WindowStore(capacity=4, max_age_s=10.0, clock=lambda: t["now"])
    for i in range(8):
        store.insert(*_row(i), pred_label=0, prob=0.1, version=1)
    assert len(store) == 4 and store.snapshot()["evicted"] == 4
    assert store.join(("in", 0, 1), 1) == "expired"
    assert store.join(("in", 0, 6), 1) == "joined"
    assert store.join(("in", 0, 6), 0) == "joined"    # latest verdict wins
    assert store.join(("in", 0, 100), 1) == "pending"
    store.insert(*_row(100), pred_label=0, prob=0.2, version=2)
    snap = store.snapshot()
    assert snap["pending_labels"] == 0 and snap["labeled"] == 2
    assert _invariant(snap) and snap["accounting_exact"]
    store.insert(*_row(6), pred_label=0, prob=0.1, version=1)   # replay
    assert [r.label for r in store.labeled_rows()] == [1, 0]
    assert store.error_stats() == (2, 1)
    assert store.error_by_version() == {
        "1": {"labeled": 1, "errors": 0, "error_rate": 0.0},
        "2": {"labeled": 1, "errors": 1, "error_rate": 1.0}}
    store.join(("in", 0, 200), 1)
    t["now"] = 11.0
    store.sweep()
    snap = store.snapshot()
    assert snap["rows"] == 0 and snap["missed"] == 1 and _invariant(snap)


def test_store_matches_jax_under_any_interleaving():
    """Hypothesis property: the port's store and the JAX store, driven with
    the same inserts, joins and sweeps on the same clock, give the same
    join outcomes, snapshots, error stats and labeled rows after every
    step, and the accounting invariant holds throughout."""
    from hypothesis import given, settings
    from hypothesis import strategies as st

    ops = st.lists(st.tuples(st.sampled_from(["insert", "join", "sweep"]),
                             st.integers(0, 30), st.integers(0, 1),
                             st.integers(1, 3)), max_size=120)

    @settings(max_examples=60, deadline=None)
    @given(ops=ops, capacity=st.integers(1, 8))
    def check(ops, capacity):
        t = {"now": 0.0}
        stores = [cls(capacity=capacity, max_age_s=5.0,
                      clock=lambda: t["now"]) for cls in (JStore, WindowStore)]
        for op, i, part, version in ops:
            t["now"] += 0.5
            outs = []
            for store in stores:
                if op == "insert":
                    outs.append(store.insert(*_row(i, part), i % 2, 0.5,
                                             version))
                elif op == "join":
                    outs.append(store.join(("in", part, i), i % 2))
                else:
                    outs.append(store.sweep())
            want, got = stores
            assert outs[1] == outs[0]
            snap = got.snapshot()
            assert snap == want.snapshot()
            assert _invariant(snap) and snap["rows"] <= capacity
            assert got.error_stats(last_n=3) == want.error_stats(last_n=3)
            assert got.error_stats(version=1) == want.error_stats(version=1)
            assert got.error_by_version() == want.error_by_version()
            assert ([(r.key, r.label, r.version) for r in got.labeled_rows()]
                    == [(r.key, r.label, r.version)
                        for r in want.labeled_rows()])

    check()


def test_store_bounds_refuse_as_jax():
    for kw in ({"capacity": 0}, {"capacity": 4, "max_age_s": 0}):
        with pytest.raises(ValueError) as je:
            JStore(**kw)
        with pytest.raises(ValueError) as pe:
            WindowStore(**kw)
        assert str(pe.value) == str(je.value)


# ---------------------------------------------------------------------------
# drift pool and config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 11])
def test_drift_scam_pool_equals_jax(seed):
    assert drift_scam_pool(seed, 48) == jpool(seed, 48)


def test_learn_config_equals_jax():
    assert LearnConfig().__dict__ == JConfig().__dict__
    for kw in ({"sample": 0.0}, {"min_labeled": 1}, {"error_threshold": 0},
               {"refresh_rounds": 0}):
        with pytest.raises(ValueError) as je:
            JConfig(**kw)
        with pytest.raises(ValueError) as pe:
            LearnConfig(**kw)
        assert str(pe.value) == str(je.value)


# ---------------------------------------------------------------------------
# the learn loop (inline tick driver)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def xgb_pipe():
    """The reference's game-day xgb pipeline on the port (separable corpus,
    2,048 features), on the CPU."""
    from fraud_detection_tpu_torch.models.pipeline import synthetic_demo_pipeline

    return synthetic_demo_pipeline(
        batch_size=64, n=300, seed=7, num_features=2048, model="xgb",
        corpus_kwargs=dict(hard_fraction=0.0, label_noise=0.0), device="cpu")


def _loop_fixture(xgb_pipe, tmp_path, policy_spec=None):
    from fraud_detection_tpu_torch.registry import (HotSwapPipeline,
                                                    LifecycleController,
                                                    ModelRegistry,
                                                    PromotionPolicy,
                                                    ShadowScorer)

    broker = InProcessBroker(num_partitions=2)
    registry = ModelRegistry(str(tmp_path / "reg"))
    registry.publish(xgb_pipe.featurizer, xgb_pipe.model)
    hot = HotSwapPipeline(xgb_pipe, version=1)
    shadow = ShadowScorer(max_queue=64, window_batches=8)
    loop = LearnLoop(
        feedback_consumer=broker.consumer(["fb"], "learn"),
        registry=registry, hotswap=hot, shadow=shadow,
        config=LearnConfig(min_labeled=32, min_new_labels=8,
                           error_threshold=0.2, error_window=64,
                           refresh_rounds=3, cooldown_s=0.0),
        start=False)
    controller = LifecycleController(
        registry, hot, shadow=shadow,
        # The inline window is ALL drift rows, so the candidate disagrees
        # with the drifted primary on every one (the reference's spec).
        policy=PromotionPolicy.parse(
            policy_spec or "min_batches=1,min_rows=16,max_disagreement=1.0,"
                           "max_psi=50.0,max_flag_rate_delta=1.0"),
        on_transition=loop.on_transition)
    loop.bind_controller(controller)
    return broker, registry, hot, shadow, loop, controller


def _score_and_label(hot, loop, broker, pool):
    preds = hot.predict(pool)
    coords = [(IN, 0, i) for i in range(len(pool))]
    assert loop.submit(coords, pool, preds.labels, preds.probabilities,
                       raw=False, version=1)
    fb = broker.producer()
    for _, p, o in coords:
        fb.produce("fb", pfb.label_record(IN, p, o, 1))
    fb.flush()
    return preds


def test_learn_loop_closes_the_loop_inline(xgb_pipe, tmp_path):
    """Scored drift rows + labels -> drift trigger -> publish -> stage ->
    encoded window replay -> auto-promote, all through the real
    controller, every transition audited."""
    from fraud_detection_tpu_torch.ops import histogram as H

    broker, registry, hot, shadow, loop, controller = _loop_fixture(
        xgb_pipe, tmp_path)
    try:
        pool = drift_scam_pool(3, 48)
        preds = _score_and_label(hot, loop, broker, pool)
        assert np.mean(preds.labels) < 0.2    # the primary is blind to drift
        loop.tick()                            # ingest + join + retrain
        snap = loop.snapshot()
        assert snap["window"]["joined"] == len(pool)
        assert snap["published"] == 1 and snap["last_trigger"] == "drift"
        assert snap["failed"] == 0 and loop.fault is None
        mv = registry.latest()
        assert mv.version == 2
        learn = mv.manifest["learn"]
        assert learn["trigger"] == "drift" and learn["warm_started_from"] == 1
        assert learn["rounds"] == 3 and learn["padded_rows"] == 512
        assert learn["base_trees"] == 20 and learn["total_trees"] == 23
        assert mv.manifest["parent"] == 1
        assert H.node_feature_bin_histogram_multi.launches == 0  # CPU: plain
        controller.tick()
        assert hot.staged_version == 2
        assert loop.tick()                     # window replay to the shadow
        assert shadow.drain(30.0)
        controller.tick()
        assert hot.active_version == 2 and hot.staged_version is None
        snap = loop.snapshot()
        assert snap["promoted"] == 1 and snap["promoted_at_s"] is not None
        assert snap["candidate_window_error_rate"] < 0.1
        events = [e["event"] for e in controller.events]
        assert events == ["stage", "promote"]
        assert np.mean(hot.predict(pool).labels) > 0.9
        assert np.mean(hot.predict(drift_scam_pool(5, 64)).labels) > 0.9
    finally:
        loop.close(10.0)
        shadow.close(10.0)


def test_learn_loop_impossible_policy_refuses(xgb_pipe, tmp_path):
    """The gate gates: an impossible promotion policy leaves the candidate
    staged — published but never promoted."""
    broker, registry, hot, shadow, loop, controller = _loop_fixture(
        xgb_pipe, tmp_path, policy_spec="min_batches=100000")
    try:
        _score_and_label(hot, loop, broker, drift_scam_pool(3, 48))
        loop.tick()
        controller.tick()
        loop.tick()
        assert shadow.drain(30.0)
        controller.tick()
        snap = loop.snapshot()
        assert snap["published"] == 1 and snap["promoted"] == 0
        assert hot.active_version == 1 and hot.staged_version == 2
    finally:
        loop.close(10.0)
        shadow.close(10.0)


def test_learn_loop_counts_malformed_and_encode_errors(xgb_pipe, tmp_path):
    from fraud_detection_tpu_torch.registry import (HotSwapPipeline,
                                                    ModelRegistry)

    broker = InProcessBroker()
    loop = LearnLoop(feedback_consumer=broker.consumer(["fb"], "learn"),
                     registry=ModelRegistry(str(tmp_path / "reg2")),
                     hotswap=HotSwapPipeline(xgb_pipe, version=1),
                     config=LearnConfig(min_labeled=10 ** 6), start=False)
    fb = broker.producer()
    fb.produce("fb", b"not a label")
    fb.flush()
    loop.submit([(IN, 0, 0)], [b"\xff bad"], np.array([0]),
                np.array([0.5]), raw=True, version=1)
    loop.tick()
    snap = loop.snapshot()
    assert snap["window"]["malformed_labels"] == 1
    assert snap["window"]["rows"] == 0 and snap["labels_polled"] == 1


def _failing_loop(xgb_pipe, tmp_path, monkeypatch, exc):
    from fraud_detection_tpu_torch.models import train_trees

    def boom(*a, **kw):
        raise exc

    monkeypatch.setattr(train_trees, "refresh_gradient_boosting", boom)
    broker, registry, hot, shadow, loop, controller = _loop_fixture(
        xgb_pipe, tmp_path)
    _score_and_label(hot, loop, broker, drift_scam_pool(3, 48))
    return loop, shadow


def test_learn_loop_counts_a_failed_retrain(xgb_pipe, tmp_path, monkeypatch):
    loop, shadow = _failing_loop(xgb_pipe, tmp_path, monkeypatch,
                                 ValueError("window too small"))
    try:
        loop.tick()
        snap = loop.snapshot()
        assert snap["failed"] == 1 and snap["published"] == 0
        assert loop.fault is None and not snap["in_flight"]
    finally:
        loop.close(10.0)
        shadow.close(10.0)


def test_learn_lane_stops_on_a_device_fault(xgb_pipe, tmp_path, monkeypatch):
    """A kernel that fails to build or launch is not a failed retrain to
    count and serve past: an inline tick raises it, and the lane thread's
    body returns with the fault recorded."""
    from fraud_detection_tpu_torch.ops._build import KernelError

    fault = KernelError("histogram kernel launch failed: cudaError 700")
    for inline in (True, False):
        loop, shadow = _failing_loop(xgb_pipe, tmp_path / str(inline),
                                     monkeypatch, fault)
        try:
            if inline:
                with pytest.raises(KernelError):
                    loop.tick()
            else:
                loop._run()        # the thread body: returns on the fault
            assert loop.fault is fault and loop.snapshot()["failed"] == 1
        finally:
            loop.close(10.0)
            shadow.close(10.0)


# ---------------------------------------------------------------------------
# engine wiring + health
# ---------------------------------------------------------------------------

def _jax_learn_health(tmp_path):
    from fraud_detection_tpu.learn import LearnLoop as JLoop
    from fraud_detection_tpu.models.pipeline import (
        synthetic_demo_pipeline as jdemo)
    from fraud_detection_tpu.registry import HotSwapPipeline as JHot
    from fraud_detection_tpu.registry import ModelRegistry as JRegistry
    from fraud_detection_tpu.stream import InProcessBroker as JBroker
    from fraud_detection_tpu.stream import StreamingClassifier as JEngine

    pipe = jdemo(batch_size=16, n=120, seed=7, num_features=256)
    broker = JBroker()
    feeder = broker.producer()
    for i in range(16):
        feeder.produce(IN, json.dumps({"text": f"hello row {i}"}).encode(),
                       key=str(i).encode())
    hot = JHot(pipe, version=1)
    loop = JLoop(feedback_consumer=broker.consumer(["fb"], "learn"),
                 registry=JRegistry(str(tmp_path / "jreg")), hotswap=hot,
                 config=JConfig(min_labeled=10 ** 6), start=False)
    engine = JEngine(hot, broker.consumer([IN], "g"), broker.producer(),
                     "out", batch_size=16, learn=loop)
    engine.run(max_messages=16, idle_timeout=2.0)
    loop.tick()
    try:
        return engine.health()
    finally:
        loop.close(10.0)


# The learn block's and its window's exact key sets and types: module-level
# dict literals so flightcheck's health-schema lint (analysis/health.py,
# FC301) checks LearnLoop.snapshot() and WindowStore.snapshot() statically.
LEARN_WINDOW_SCHEMA = {
    "rows": (int,),
    "labeled": (int,),
    "capacity": (int,),
    "inserted": (int,),
    "evicted": (int,),
    "evicted_labeled": (int,),
    "labels_seen": (int,),
    "joined": (int,),
    "expired": (int,),
    "missed": (int,),
    "pending_labels": (int,),
    "malformed_labels": (int,),
    "accounting_exact": (bool,),
}

LEARN_BLOCK_SCHEMA = {
    "window": (dict,),
    "queue_depth": (int,),
    "submitted": (int,),
    "dropped": (int,),
    "sampled_out": (int,),
    "encode_errors": (int,),
    "labels_polled": (int,),
    "triggered": (int,),
    "published": (int,),
    "failed": (int,),
    "in_flight": (bool,),
    "promoted": (int,),
    "rejected": (int,),
    "rolled_back": (int,),
    "published_versions": (list,),
    "last_trigger": (type(None), str),
    "first_trigger_at_s": (type(None), int, float),
    "promoted_at_s": (type(None), int, float),
    "last_retrain_wall_s": (type(None), int, float),
    "retrain_wall_s_total": (int, float),
    "recent_error_rate": (type(None), int, float),
    "primary_window_error_rate": (type(None), int, float),
    "candidate_window_error_rate": (type(None), int, float),
    "error_by_version": (dict,),
}


def _assert_schema(obj, schema, where):
    assert set(obj) == set(schema), (
        f"{where}: keys changed — update the schema test AND the pollers "
        f"(extra: {set(obj) - set(schema)}, "
        f"missing: {set(schema) - set(obj)})")
    for key, types in schema.items():
        assert isinstance(obj[key], types), (where, key, type(obj[key]))


def test_engine_learn_block_has_the_jax_keys(xgb_pipe, tmp_path):
    from fraud_detection_tpu_torch.registry import (HotSwapPipeline,
                                                    ModelRegistry)
    from fraud_detection_tpu_torch.stream import StreamingClassifier

    want = _jax_learn_health(tmp_path)
    broker = InProcessBroker()
    feeder = broker.producer()
    for i in range(16):
        feeder.produce(IN, json.dumps({"text": f"hello row {i}"}).encode(),
                       key=str(i).encode())
    hot = HotSwapPipeline(xgb_pipe, version=1)
    loop = LearnLoop(feedback_consumer=broker.consumer(["fb"], "learn"),
                     registry=ModelRegistry(str(tmp_path / "reg3")),
                     hotswap=hot, config=LearnConfig(min_labeled=10 ** 6),
                     start=False)
    engine = StreamingClassifier(hot, broker.consumer([IN], "g"),
                                 broker.producer(), "out", batch_size=16,
                                 learn=loop)
    engine.run(max_messages=16, idle_timeout=2.0)
    loop.tick()
    got = engine.health()
    loop.close(10.0)
    assert set(got["learn"]) == set(want["learn"])
    assert set(got["learn"]["window"]) == set(want["learn"]["window"])
    _assert_schema(got["learn"], LEARN_BLOCK_SCHEMA, "learn")
    _assert_schema(got["learn"]["window"], LEARN_WINDOW_SCHEMA, "learn.window")
    assert set(got["model"]) == set(want["model"])
    assert got["model"]["shadow"] is None and want["model"]["shadow"] is None
    assert got["learn"]["window"]["rows"] == want["learn"]["window"]["rows"] == 16
    assert got["learn"]["submitted"] >= 1
    json.dumps(got)


def test_serve_cli_learn_lane_on_cpu(xgb_pipe, tmp_path, capsys):
    """``serve --registry --watch --shadow --promote-policy --learn`` runs
    the learn lane beside the engine and reports its block."""
    from fraud_detection_tpu_torch.app.serve import main
    from fraud_detection_tpu_torch.registry import ModelRegistry

    root = str(tmp_path / "reg4")
    ModelRegistry(root).publish(xgb_pipe.featurizer, xgb_pipe.model)
    rc = main(["--device", "cpu", "--registry", root, "--demo", "600",
               "--batch-size", "64", "--watch", "--watch-interval", "0.05",
               "--shadow", "--promote-policy", "min_batches=1", "--learn"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    stats = json.loads(out[-2])
    assert stats["processed"] == 600
    learn = stats["lifecycle"]["learn"]
    assert learn["window"]["rows"] == 600 and learn["published"] == 0
    assert stats["health"]["learn"]["submitted"] >= 1
