"""The port's ``obs/`` (row tracing, metrics, export) against the JAX
package's, on the CPU.

The same seeded inputs go through both packages: ``LatencySketch`` wires
are byte-equal and round-trip; a ``RowTracer`` at one seed and one injected
wall clock keeps the same chains — span for span, stage, ok flag and detail
— when the port's engine and the JAX engine serve one stream (dead-letter
and flagged rows included); ``health()["trace"]`` has the same schema;
and one health dict renders to byte-equal Prometheus text in both
registries. The rest mirrors ``tests/test_obs.py`` on the port: ring
honesty, head sampling with forced keeps, exact span accounting under
seeded chaos, the exporter's coverage of every ``health()`` leaf, the HTTP
endpoint (bound to port 0, the bound port read back), the metrics file
writer, the serve CLI with tracing and a metrics file, and the
``torch.profiler`` window (started and stopped on its watcher thread).

Cases of ``tests/test_obs.py`` that wait for other items:
``test_span_accounting_exact_under_fleet_worker_kills`` and
``test_coordinator_tick_merges_live_workers_stage_wires`` need ``fleet/``
(Queue 1 item 5.3); the merge they rest on,
``aggregate_stage_wires``, is held equal here.
"""

import json
import urllib.request

import numpy as np
import pytest

from fraud_detection_tpu.models.pipeline import synthetic_demo_pipeline
from fraud_detection_tpu.obs import metrics as jmetrics
from fraud_detection_tpu.obs import trace as jtrace
from fraud_detection_tpu.sched.sketch import LatencySketch as JSketch
from fraud_detection_tpu.stream import InProcessBroker as JBroker
from fraud_detection_tpu.stream import StreamingClassifier as JEngine
from fraud_detection_tpu.utils import tracing as jtracing
from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
from fraud_detection_tpu_torch.obs import export as texport
from fraud_detection_tpu_torch.obs.metrics import (MetricsRegistry,
                                                   leaf_paths, metric_name,
                                                   parse_prometheus)
from fraud_detection_tpu_torch.obs.trace import (RowTracer, Span, SpanRing,
                                                 aggregate_stage_wires,
                                                 fleet_stage_latency)
from fraud_detection_tpu_torch.sched import AdaptiveScheduler, SchedulerConfig
from fraud_detection_tpu_torch.sched.sketch import LatencySketch
from fraud_detection_tpu_torch.stream import InProcessBroker, StreamingClassifier
from fraud_detection_tpu_torch.utils import tracing as ttracing
from tests.fixtures import BENIGN_DIALOGUE, SCAM_DIALOGUE
from tests.torch_parity import port_featurizer, port_model


@pytest.fixture(scope="module")
def jpipe():
    return synthetic_demo_pipeline(batch_size=64, n=400, seed=3,
                                   num_features=2048,
                                   corpus_kwargs=dict(hard_fraction=0.0,
                                                      label_noise=0.0))


@pytest.fixture(scope="module")
def pipe(jpipe):
    return ServingPipeline(port_featurizer(jpipe.featurizer),
                           port_model(jpipe.model), batch_size=64,
                           device="cpu")


def _feed(broker, n, topic="in", scam_every=None):
    prod = broker.producer()
    for i in range(n):
        text = (SCAM_DIALOGUE if scam_every and i % scam_every == 0
                else BENIGN_DIALOGUE)
        prod.produce(topic, json.dumps({"text": text, "id": i}).encode(),
                     key=str(i).encode())


def _engine(broker, pipeline, tracer, engine_cls=StreamingClassifier, **kw):
    return engine_cls(
        pipeline, broker.consumer(["in"], kw.pop("group", "obs")),
        broker.producer(), "out", batch_size=kw.pop("batch_size", 32),
        max_wait=0.01, rowtrace=tracer, **kw)


def _chain_shape(tracer):
    """The ring without its durations: (cid, stage, start, ok, detail)."""
    return [(s.cid, s.stage, s.start, s.ok, s.detail)
            for s in tracer.ring.snapshot()]


# ---------------------------------------------------------------------------
# ring honesty, sampling
# ---------------------------------------------------------------------------

def test_ring_overflow_drops_oldest_and_counts():
    ring = SpanRing(capacity=8)
    for i in range(11):
        ring.extend([Span(f"c{i}", "s", 0.0, 1.0)])
    assert len(ring) == 8
    assert ring.recorded == 11 and ring.dropped == 3
    assert [s.cid for s in ring.snapshot()] == [f"c{i}" for i in range(3, 11)]


def test_ring_counts_compact_row_blocks_per_span():
    tr = RowTracer(worker="w", capacity=2, sample=1.0, seed=0)
    for _ in range(3):
        bt = tr.batch_begin(4)
        bt.events_rows("flag", [(0, 1), (0, 2), (0, 3)])
        tr.commit(bt)
    assert tr.ring.recorded == 3 * (1 + 3)
    assert tr.ring.dropped == tr.ring.recorded - len(tr.ring) > 0
    assert all(isinstance(s, Span) for s in tr.ring.snapshot())


def test_head_sampling_discards_clean_batches_keeps_interesting():
    tr = RowTracer(worker="w", sample=0.0, seed=7)
    tr.commit(tr.batch_begin(8))
    shed = tr.batch_begin(8)

    class M:
        partition, offset = 0, 5

    shed.shed(M, "shed_queue_full")
    tr.commit(shed)
    snap = tr.snapshot()
    assert snap["sampled_out"] == 1 and snap["kept"] == 1
    spans = tr.ring.snapshot()
    assert all(s.cid.startswith(shed.cid) for s in spans)
    assert any(s.stage == "shed" for s in spans)


@pytest.mark.parametrize("seed,sample", [(0, 0.3), (5, 0.05)])
def test_head_sampling_draws_equal_jax(seed, sample):
    """One seed, one sample fraction: the same batches kept and sampled out,
    the same ids, as the JAX tracer."""
    def run(mod):
        tr = mod.RowTracer(worker="w1", sample=sample, seed=seed,
                           wall=lambda: 0.0)
        for i in range(64):
            bt = tr.batch_begin(4)
            if i % 9 == 0:
                bt.dlq(type("M", (), {"partition": 1, "offset": i}), "x")
            tr.commit(bt)
        snap = tr.snapshot()
        return ([(s.cid, s.stage, s.ok, s.detail) for s in tr.ring.snapshot()],
                {k: snap[k] for k in ("kept", "sampled_out", "spans_begun",
                                      "ring_recorded")})

    assert run(jtrace) == run(__import__(
        "fraud_detection_tpu_torch.obs.trace", fromlist=["RowTracer"]))


# ---------------------------------------------------------------------------
# chains: the port's engine against the JAX engine
# ---------------------------------------------------------------------------

def _stream_with_bad(broker, n=20, scam_every=4):
    _feed(broker, n, scam_every=scam_every)
    bad = broker.producer()
    bad.produce("in", b"not json at all", key=b"bad0")
    bad.produce("in", b'{"nope": 1}', key=b"bad1")


@pytest.mark.parametrize("dlq", [True, False])
def test_chains_equal_jax(jpipe, pipe, dlq):
    """The same stream (flagged rows and malformed rows) through both
    engines with a tracer at one seed and one wall clock: the same spans,
    row events and details, in the same order."""
    def run(broker_cls, engine_cls, tracer_mod, p):
        broker = broker_cls(num_partitions=3)
        _stream_with_bad(broker)
        tr = tracer_mod.RowTracer(worker="w0", sample=0.5, seed=3,
                                  wall=lambda: 0.0)
        engine = _engine(broker, p, tr, engine_cls,
                         dlq_topic="out-dlq" if dlq else None)
        engine.run(max_messages=22, idle_timeout=1.0)
        recs = [json.loads(m.value) for m in broker.messages("out-dlq")]
        return _chain_shape(tr), recs, sorted(tr.snapshot()["stages"])

    from fraud_detection_tpu_torch.obs import trace as ttrace

    assert (run(InProcessBroker, StreamingClassifier, ttrace, pipe)
            == run(JBroker, JEngine, jtrace, jpipe))


def test_dlq_record_carries_trace_id_and_chain_is_complete(pipe):
    broker = InProcessBroker(num_partitions=3)
    _feed(broker, 20)
    bad = broker.producer()
    bad.produce("in", b"not json at all", key=b"bad0")
    bad.produce("in", b'{"nope": 1}', key=b"bad1")
    tr = RowTracer(worker="w0", sample=1.0, seed=0)
    engine = _engine(broker, pipe, tr, dlq_topic="out-dlq")
    engine.run(max_messages=22, idle_timeout=1.0)
    recs = [json.loads(m.value) for m in broker.messages("out-dlq")]
    assert len(recs) == 2
    for rec in recs:
        cid = rec["trace"]
        assert cid.split(":")[1:] == [str(rec["source"]["partition"]),
                                      str(rec["source"]["offset"])]
        stages = [s.stage for s in tr.chain(cid)]
        assert "poll" in stages and "deliver" in stages and "dlq" in stages
        assert any(s.cid == cid and s.stage == "dlq" for s in tr.chain(cid))


def test_shed_rows_chain_and_trace_id(pipe):
    """Admission-shed rows: each shed record names its rule and joins back
    to a complete chain (the event is recorded at the shed site)."""
    broker = InProcessBroker(num_partitions=3)
    _feed(broker, 60)
    sched = AdaptiveScheduler(SchedulerConfig(shed_policy="reject",
                                              max_rate=1.0), batch_size=32)
    tr = RowTracer(worker="w0", sample=1.0, seed=0)
    engine = _engine(broker, pipe, tr, dlq_topic="out-dlq", scheduler=sched)
    engine.run(max_messages=60, idle_timeout=1.0)
    recs = [json.loads(m.value) for m in broker.messages("out-dlq")]
    shed = [r for r in recs if r["reason"].startswith("shed_")]
    assert shed, "the rate limit never shed"
    assert engine.stats.shed == len(shed)
    for rec in shed:
        chain = tr.chain(rec["trace"])
        assert {"poll", "deliver"} <= {s.stage for s in chain}
        ev = [s for s in chain if s.cid == rec["trace"] and s.stage == "shed"]
        assert ev and ev[0].detail == rec["reason"]


def test_flagged_rows_always_kept_with_chain(pipe):
    broker = InProcessBroker(num_partitions=3)
    _feed(broker, 40, scam_every=8)
    tr = RowTracer(worker="w0", sample=0.0, seed=0)
    engine = _engine(broker, pipe, tr)
    engine.run(max_messages=40, idle_timeout=1.0)
    flags = [s for s in tr.ring.snapshot() if s.stage == "flag"]
    assert flags, "no row flagged"
    assert len({m.key for m in broker.messages("out")}) == 40
    for f in flags:
        assert {"poll", "launch", "device", "deliver"} <= {
            s.stage for s in tr.chain(f.cid)}


def test_annotation_lane_spans_ride_flagged_chains(pipe):
    calls = {"n": 0}

    def hook(texts, labels, confs):
        calls["n"] += 1
        if calls["n"] == 1:
            return [f"analysis {i}" for i in range(len(texts))]
        raise RuntimeError("backend died")

    broker = InProcessBroker(num_partitions=3)
    _feed(broker, 32, scam_every=4)
    tr = RowTracer(worker="w0", sample=1.0, seed=0)
    engine = StreamingClassifier(
        pipe, broker.consumer(["in"], "obs"), broker.producer(), "out",
        batch_size=8, max_wait=0.01, rowtrace=tr,
        explain_batch_fn=hook, explain_async=True,
        annotations_producer=broker.producer())
    # Two runs with a drain between: the first batch's call succeeds, the
    # second run's call fails, whatever the lane's timing.
    engine.run(max_messages=16, idle_timeout=1.0)
    assert engine._annotation_lane.drain(timeout=10.0)
    engine.run(max_messages=32, idle_timeout=1.0)
    engine.close_annotations(timeout=10.0)
    spans = tr.ring.snapshot()
    ann = [s for s in spans if s.stage == "annotate"]
    assert any(s.ok for s in ann) and any(not s.ok for s in ann)
    ok_ann = next(s for s in ann if s.ok)
    assert {"poll", "deliver"} <= {x.stage for x in tr.chain(ok_ann.cid)}
    assert any(s.stage == "explain" for s in spans)


def test_annotation_drop_records_carry_trace_ids(pipe):
    """An overflowing lane's drop records carry their rows' trace ids, and
    each dropped row's chain shows the flag and a failed annotate."""
    import threading

    gate = threading.Event()

    def hook(texts, labels, confs):
        gate.wait(10.0)
        return ["a"] * len(texts)

    broker = InProcessBroker(num_partitions=1)
    _feed(broker, 48, scam_every=1)
    tr = RowTracer(worker="w0", sample=1.0, seed=0)
    engine = StreamingClassifier(
        pipe, broker.consumer(["in"], "obs"), broker.producer(), "out",
        batch_size=8, max_wait=0.01, rowtrace=tr, explain_batch_fn=hook,
        explain_async=True, annotations_producer=broker.producer(),
        annotations_queue=4)
    engine.run(max_messages=48, idle_timeout=0.5)
    gate.set()
    engine.close_annotations(timeout=10.0)
    drops = [json.loads(m.value) for m in broker.messages("out-annotations")
             if json.loads(m.value).get("dropped")]
    assert drops and engine.annotation_stats()["drop_records"] == len(drops)
    for rec in drops:
        chain = tr.chain(rec["trace"])
        assert any(s.stage == "flag" for s in chain)
        assert any(s.stage == "annotate" and not s.ok
                   and s.detail == "dropped:queue_overflow" for s in chain)


# ---------------------------------------------------------------------------
# exact accounting under chaos
# ---------------------------------------------------------------------------

def _assert_exact_accounting(tr):
    snap = tr.snapshot()
    assert snap["spans_begun"] == snap["spans_ended"], snap
    assert snap["spans_open"] == 0
    assert snap["batches_traced"] == snap["batches_closed"], snap
    assert snap["kept"] + snap["sampled_out"] == snap["batches_closed"]


@pytest.mark.parametrize("async_dispatch", [False, True])
def test_span_accounting_exact_under_seeded_chaos(pipe, async_dispatch):
    """begun == ended and traced == closed across a supervised chaos run
    with every abort path (poll errors, flush crashes and failures,
    fences), one tracer over all incarnations."""
    from fraud_detection_tpu_torch.stream.engine import run_supervised
    from fraud_detection_tpu_torch.stream.faults import (ChaosConsumer,
                                                         ChaosProducer,
                                                         FaultPlan)

    plan = FaultPlan(seed=1, poll_error_rate=0.08, duplicate_rate=0.08,
                     corrupt_rate=0.05, flush_fail_rate=0.08,
                     flush_crash_rate=0.06, commit_fence_rate=0.08,
                     max_faults=60, sleep=lambda s: None)
    broker = InProcessBroker(num_partitions=3)
    _feed(broker, 150)
    tr = RowTracer(worker="w0", sample=1.0, seed=0)
    attempts: dict = {}

    def make_engine():
        return StreamingClassifier(
            pipe, ChaosConsumer(broker.consumer(["in"], "chaos"), plan),
            ChaosProducer(broker.producer(), plan), "out",
            batch_size=32, max_wait=0.01, dlq_topic="out-dlq",
            dlq_attempts=attempts, rowtrace=tr,
            async_dispatch=async_dispatch)

    stats = run_supervised(make_engine, max_restarts=300, backoff=0.0,
                           idle_timeout=0.2, sleep=lambda s: None)
    assert plan.injected.get("flush_crash", 0) > 0 and stats.restarts > 0
    _assert_exact_accounting(tr)


# ---------------------------------------------------------------------------
# sketches: wire parity, lossless merge
# ---------------------------------------------------------------------------

def test_sketch_wire_byte_equal_jax_and_roundtrip():
    rng = np.random.default_rng(0)
    samples = rng.exponential(0.01, 1000)
    sk, jsk = LatencySketch(), JSketch()
    sk.add_many(samples)
    jsk.add_many(samples)
    sk.add(0.5)
    jsk.add(0.5)
    assert json.dumps(sk.to_wire()) == json.dumps(jsk.to_wire())
    assert sk.mean == jsk.mean
    back = LatencySketch.from_wire(jsk.to_wire())
    assert np.array_equal(back._counts, sk._counts)
    assert back.count == sk.count and back.sum == sk.sum and back.max == sk.max
    assert LatencySketch.from_wire({"v": 2}) is None
    assert LatencySketch.from_wire("junk") is None
    assert LatencySketch.from_wire({"v": 1, "idx": [999999], "counts": [1],
                                    "count": 1, "sum": 1, "max": 1}) is None


def test_stage_sketch_merge_equals_single_process():
    rng = np.random.default_rng(1)
    samples = [rng.exponential(0.02, 500) for _ in range(3)]
    wires = []
    for i, part in enumerate(samples):
        tr = RowTracer(worker=f"w{i}", sample=1.0, seed=0)
        tr._observe_stage("device", 0.0)
        tr._stages["device"].add_many(part)
        wires.append(tr.stages_wire())
    merged = aggregate_stage_wires(wires)["device"]
    single = LatencySketch()
    for _ in range(3):
        single.add(0.0)
    for part in samples:
        single.add_many(part)
    assert np.array_equal(merged._counts, single._counts)
    assert fleet_stage_latency(wires) == jtrace.fleet_stage_latency(wires)


# ---------------------------------------------------------------------------
# the exporter: ONE schema, parseable, byte-equal to the JAX rendering
# ---------------------------------------------------------------------------

TRACE_BLOCK_SCHEMA = {
    "worker": (str,), "sample": (int, float), "spans_begun": (int,),
    "spans_ended": (int,), "spans_open": (int,), "batches_traced": (int,),
    "batches_closed": (int,), "kept": (int,), "sampled_out": (int,),
    "ring_depth": (int,), "ring_capacity": (int,), "ring_recorded": (int,),
    "ring_dropped": (int,), "stages": (dict,),
}


def test_trace_block_schema_equals_jax(jpipe, pipe):
    def run(broker_cls, engine_cls, tracer_mod, p):
        broker = broker_cls(num_partitions=3)
        _feed(broker, 16)
        tr = tracer_mod.RowTracer(worker="w0", sample=1.0, seed=0)
        engine = _engine(broker, p, tr, engine_cls, batch_size=16)
        engine.run(max_messages=16, idle_timeout=1.0)
        return engine.health()

    from fraud_detection_tpu_torch.obs import trace as ttrace

    h = run(InProcessBroker, StreamingClassifier, ttrace, pipe)
    jh = run(JBroker, JEngine, jtrace, jpipe)
    snap = h["trace"]
    assert set(snap) == set(jh["trace"]) == set(TRACE_BLOCK_SCHEMA)
    for key, types in TRACE_BLOCK_SCHEMA.items():
        assert isinstance(snap[key], types), (key, type(snap[key]))
    assert set(snap["stages"]) == set(jh["trace"]["stages"])
    for stage, block in snap["stages"].items():
        assert set(block) == set(jh["trace"]["stages"][stage])
        assert block["count"] == jh["trace"]["stages"][stage]["count"]
    json.dumps(h)


def test_prometheus_text_of_one_health_dict_byte_equal_jax(jpipe):
    """One health dict (the JAX engine's, after a traced run with a DLQ)
    through both registries: the same Prometheus text and JSON metrics."""
    broker = JBroker(num_partitions=3)
    _stream_with_bad(broker)
    engine = _engine(broker, jpipe, jtrace.RowTracer(worker="w0", seed=0),
                     JEngine, dlq_topic="out-dlq")
    engine.run(max_messages=22, idle_timeout=1.0)
    health = json.loads(json.dumps(engine.health()))
    regs = []
    for mod in (jmetrics, __import__("fraud_detection_tpu_torch.obs.metrics",
                                     fromlist=["MetricsRegistry"])):
        reg = mod.MetricsRegistry(wall=lambda: 0.0)
        reg.counter("demo_events", "native instrument").inc(3)
        reg.gauge("up", fn=lambda: 1.0)
        reg.histogram("demo_latency", "native sketch").observe_many(
            [0.01, 0.02])
        reg.add_collector("engine", lambda: health)
        reg.add_collector("workers", lambda: [health, health])
        regs.append(reg)
    assert regs[0].render_prometheus() == regs[1].render_prometheus()
    assert regs[0].render_json() == regs[1].render_json()
    assert leaf_paths(health) == jmetrics.leaf_paths(health)


def test_prometheus_output_parses_and_covers_every_health_key(pipe):
    broker = InProcessBroker(num_partitions=3)
    _feed(broker, 32)
    tr = RowTracer(worker="w0", sample=1.0, seed=0)
    engine = _engine(broker, pipe, tr, dlq_topic="out-dlq")
    engine.run(max_messages=32, idle_timeout=1.0)
    reg = MetricsRegistry()
    reg.counter("demo_events", "native instrument").inc(3)
    reg.histogram("demo_latency", "native sketch").observe_many([0.01, 0.02])
    reg.add_collector("engine", engine.health)
    parsed = parse_prometheus(reg.render_prometheus())
    for path in leaf_paths(engine.health(), ("engine",)):
        name = metric_name(reg.prefix, path)
        assert name in parsed or name + "_count" in parsed, path
    assert parsed["fraud_demo_events_total"][0][1] == 3.0
    assert parsed["fraud_demo_latency_count"][0][1] == 2.0
    assert reg.render_json()["collectors"]["engine"]["processed"] == 32


def test_metrics_http_endpoint_serves_both_formats():
    reg = MetricsRegistry()
    reg.gauge("up", fn=lambda: 1.0)
    srv = texport.MetricsServer(reg, port=0)
    try:
        assert srv.port > 0
        base = f"http://127.0.0.1:{srv.port}"
        text = urllib.request.urlopen(f"{base}/metrics").read().decode()
        assert parse_prometheus(text)["fraud_up"][0][1] == 1.0
        j = json.loads(urllib.request.urlopen(
            f"{base}/metrics.json").read().decode())
        assert j["metrics"]["fraud_up"] == 1.0
        assert reg.counter("metrics_scrapes").value == 2
    finally:
        srv.close()


def test_metrics_file_writer_formats(tmp_path):
    reg = MetricsRegistry()
    reg.gauge("up", fn=lambda: 1.0)
    prom, js = str(tmp_path / "m.prom"), str(tmp_path / "m.json")
    assert texport.write_metrics(prom, reg) and texport.write_metrics(js, reg)
    assert parse_prometheus(open(prom).read())["fraud_up"][0][1] == 1.0
    assert json.load(open(js))["metrics"]["fraud_up"] == 1.0
    finish = texport.start_metrics_writer(str(tmp_path / "w.prom"), 3600.0,
                                          reg)
    finish()      # the final write happens at finish, not on a deadline
    assert reg.counter("metrics_file_writes").value == 1
    assert "fraud_up 1" in open(tmp_path / "w.prom").read()


# ---------------------------------------------------------------------------
# profiling and the aggregate tracer
# ---------------------------------------------------------------------------

def test_profile_window_stops_on_its_watcher_thread(tmp_path):
    """The capture starts before the function returns and stops on the
    watcher thread once the batch count is reached; the trace file is
    written, and a disabled window is free."""
    import torch

    batches = {"n": 0}
    finish = texport.start_profile_window(str(tmp_path / "p"), 3,
                                          lambda: batches["n"], device="cpu",
                                          poll_interval=0.001)
    for _ in range(4):
        torch.ones(8) + 1
        batches["n"] += 1
    report = finish()
    assert report["error"] is None and report["target_batches"] == 3
    assert report["batches"] >= 3
    doc = json.load(open(report["trace"]))
    assert "traceEvents" in doc
    assert texport.start_profile_window(None, 3, lambda: 0)() is None
    assert [a.name for a in texport.profiler_activities("cpu")] == ["CPU"]


def test_device_trace_writes_only_when_asked(tmp_path, monkeypatch):
    import torch

    monkeypatch.delenv("FRAUD_TPU_PROFILE_DIR", raising=False)
    with ttracing.device_trace("off"):
        torch.ones(2)
    with ttracing.device_trace("region", str(tmp_path), device="cpu"):
        torch.ones(2) + 1
    assert sorted(p.name for p in tmp_path.iterdir()) == ["region.trace.json"]


def test_tracer_and_rate_counter_equal_jax():
    for mod in (ttracing, jtracing):
        rc = mod.RateCounter(window=10.0)
        for t in range(12):
            rc.add(5, now=float(t))
        tr = mod.Tracer()
        tr.record("a", 0.5)
        tr.record("a", 1.5)
        mod._got = (rc.rate(now=12.0), tr.as_dict())
    assert ttracing._got == jtracing._got


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

def test_serve_cli_trace_and_metrics_file(tmp_path, capsys):
    from fraud_detection_tpu_torch.app.serve import main

    metrics = str(tmp_path / "metrics.json")
    rc = main(["--device", "cpu", "--model", "synthetic", "--demo", "200",
               "--batch-size", "64", "--trace", "--trace-sample", "1.0",
               "--metrics-file", metrics, "--dlq"])
    assert rc == 0
    doc = json.load(open(metrics))
    eng = doc["collectors"]["engine"]
    assert eng["processed"] == 200
    snap = eng["trace"]
    assert snap["spans_begun"] == snap["spans_ended"]
    assert snap["batches_traced"] == snap["batches_closed"] > 0
    line = json.loads(capsys.readouterr().out.splitlines()[-2])
    assert line["health"]["trace"]["spans_open"] == 0
