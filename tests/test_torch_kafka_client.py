"""The port's ``stream/kafka.py`` against the JAX package's, on the CPU,
over a stand-in ``confluent_kafka`` (``tests/torch_fake_kafka.py``).

Neither the wheel nor a broker is here, so a fake module is put in
``sys.modules`` and both packages' adapter modules are reloaded around it,
as ``tests/test_kafka_client.py`` does for the JAX package. Each of that
file's 22 cases runs here on BOTH packages (``pkg`` jax and torch) with the
reference's assertions, and the cases with an output compare the two
packages' (exact: the adapter does no arithmetic). The engine runs end to
end over the recording fakes and over ``FakeCluster`` (partitions, group
offsets, compaction): keys, committed offsets (last offset + 1 per
partition), the raw-JSON path (``engine._json_fast``), the fleet's
``KafkaControlBus`` and the serve CLI's ``--kafka``.
"""

import importlib
import json
import sys

import pytest

import torch_fake_kafka as fk
from fraud_detection_tpu.utils.config import KafkaConfig as JKafkaConfig
from fraud_detection_tpu_torch.utils.config import KafkaConfig as TKafkaConfig
from torch_parity import port_featurizer, port_model, warmed

MODS = {"jax": "fraud_detection_tpu.stream.kafka",
        "torch": "fraud_detection_tpu_torch.stream.kafka"}
CFG = {"jax": JKafkaConfig(bootstrap_servers="broker:9092", input_topic="raw",
                           output_topic="classified", consumer_group="grp"),
       "torch": TKafkaConfig(bootstrap_servers="broker:9092", input_topic="raw",
                             output_topic="classified", consumer_group="grp")}
PKGS = pytest.mark.parametrize("pkg", ["jax", "torch"])


def _broker_mod(pkg):
    return importlib.import_module(
        "fraud_detection_tpu.stream.broker" if pkg == "jax"
        else "fraud_detection_tpu_torch.stream.broker")


def _install(monkeypatch, fake):
    monkeypatch.setitem(sys.modules, "confluent_kafka", fake)
    return {p: importlib.reload(importlib.import_module(m))
            for p, m in MODS.items()}


@pytest.fixture()
def kafka_mods(monkeypatch):
    mods = _install(monkeypatch, fk.module())
    yield mods
    monkeypatch.delitem(sys.modules, "confluent_kafka")
    for m in MODS.values():
        importlib.reload(importlib.import_module(m))


@pytest.fixture()
def cluster(monkeypatch):
    c = fk.FakeCluster(num_partitions=3)
    mods = _install(monkeypatch, fk.module(c))
    yield c, mods
    monkeypatch.delitem(sys.modules, "confluent_kafka")
    for m in MODS.values():
        importlib.reload(importlib.import_module(m))


# ---------------------------------------------------------------------------
# the adapter contract (tests/test_kafka_client.py's cases, both packages)
# ---------------------------------------------------------------------------

@PKGS
def test_consumer_config_matches_reference(kafka_mods, pkg):
    c = kafka_mods[pkg].KafkaConsumer(config=CFG[pkg])
    conf = c._consumer.config
    assert conf["bootstrap.servers"] == "broker:9092"
    assert conf["group.id"] == "grp"
    assert conf["auto.offset.reset"] == "earliest"
    assert conf["enable.auto.commit"] is False
    assert "security.protocol" not in conf
    assert c._consumer.subscribed == ["raw"]
    c.close()
    assert c._consumer.closed
    other = "torch" if pkg == "jax" else "jax"
    assert conf == kafka_mods[other].KafkaConsumer(
        config=CFG[other])._consumer.config


@PKGS
def test_sasl_ssl_config_assembly(kafka_mods, pkg):
    cls = JKafkaConfig if pkg == "jax" else TKafkaConfig
    cfg = cls(bootstrap_servers="b:9092", input_topic="raw",
              output_topic="out", consumer_group="g",
              security_protocol="sasl_ssl", username="u", password="p")
    c = kafka_mods[pkg].KafkaConsumer(config=cfg)
    conf = c._consumer.config
    assert conf["security.protocol"] == "SASL_SSL"
    assert conf["sasl.mechanisms"] == "PLAIN"
    assert conf["sasl.username"] == "u"
    assert conf["sasl.password"] == "p"
    p = kafka_mods[pkg].KafkaProducer(config=cfg)
    assert p._producer.config["security.protocol"] == "SASL_SSL"


@PKGS
def test_poll_maps_to_broker_message(kafka_mods, pkg):
    c = kafka_mods[pkg].KafkaConsumer(topics=["a"], config=CFG[pkg])
    c._consumer.queue = [fk.FakeKafkaMessage("a", b"hello", b"key1", 2, 7)]
    m = c.poll(0.1)
    assert isinstance(m, _broker_mod(pkg).Message)
    assert (m.topic, m.value, m.key, m.partition, m.offset) == \
        ("a", b"hello", b"key1", 2, 7)
    assert c.poll(0.1) is None  # empty queue -> None


@PKGS
def test_poll_and_batch_drop_error_messages(kafka_mods, pkg):
    c = kafka_mods[pkg].KafkaConsumer(config=CFG[pkg])
    c._consumer.queue = [fk.FakeKafkaMessage(error="boom")]
    assert c.poll(0.1) is None
    c._consumer.queue = [fk.FakeKafkaMessage("t", b"1", offset=0),
                         fk.FakeKafkaMessage(error="boom"),
                         fk.FakeKafkaMessage("t", b"2", offset=1)]
    out = c.poll_batch(10, 0.1)
    assert [m.value for m in out] == [b"1", b"2"]


@PKGS
def test_commit_offsets_builds_topic_partitions(kafka_mods, pkg):
    c = kafka_mods[pkg].KafkaConsumer(config=CFG[pkg])
    c.commit_offsets({("raw", 0): 5, ("raw", 2): 11})
    (tps, asynchronous), = c._consumer.commits
    assert asynchronous is False
    got = sorted((tp.topic, tp.partition, tp.offset) for tp in tps)
    assert got == [("raw", 0, 5), ("raw", 2, 11)]
    c.commit()
    assert c._consumer.commits[-1] == (None, False)


@PKGS
def test_produce_batch_retries_on_buffer_full(kafka_mods, pkg):
    p = kafka_mods[pkg].KafkaProducer(config=CFG[pkg])
    p._producer.buffer_errors_left = 3  # first message needs 3 retries
    p.produce_batch("out", [(b"v1", b"k1"), (b"v2", None)])
    assert p._producer.produced == [("out", b"v1", b"k1"), ("out", b"v2", None)]
    assert p._producer.polls == 3  # one poll per BufferError to drain


@PKGS
def test_produce_batch_gives_up_when_queue_stays_full(kafka_mods, pkg):
    p = kafka_mods[pkg].KafkaProducer(config=CFG[pkg])
    p._producer.buffer_errors_left = 10_000
    with pytest.raises(BufferError, match="queue full"):
        p.produce_batch("out", [(b"v", None)])
    assert p._producer.polls == 100


@PKGS
def test_flush_counts_queued_plus_terminal_failures(kafka_mods, pkg):
    p = kafka_mods[pkg].KafkaProducer(config=CFG[pkg])
    p.produce("out", b"ok")
    p.produce("out", b"fail")
    cb = p._producer.pending_callbacks.pop()
    cb(RuntimeError("msg too large"), None)
    p._producer.flush_remaining = 2  # still queued at timeout
    assert p.flush(0.1) == 3  # 2 undelivered + 1 terminally failed
    p._producer.flush_remaining = 0
    assert p.flush(0.1) == 0


def _backlog_consumer(pkg, client, clock):
    # client= needs no wheel: what is under test is backlog()'s caching
    # and summing
    kmod = importlib.import_module(MODS[pkg])
    return kmod.KafkaConsumer(client=client, backlog_interval=1.0,
                              clock=clock)


@PKGS
def test_backlog_sums_watermark_deltas_across_partitions(pkg):
    now = [0.0]
    client = fk.FakeBacklogClient({0: (0, 100, 40), 1: (10, 50, 10),
                                   2: (0, 30, 30)})
    c = _backlog_consumer(pkg, client, lambda: now[0])
    assert c.backlog() == (100 - 40) + (50 - 10) + 0


@PKGS
def test_backlog_is_cached_and_rate_limited(pkg):
    now = [0.0]
    client = fk.FakeBacklogClient({0: (0, 100, 0)})
    c = _backlog_consumer(pkg, client, lambda: now[0])
    assert c.backlog() == 100
    calls = client.watermark_calls
    client.partitions[0] = (0, 500, 0)
    now[0] = 0.5
    assert c.backlog() == 100
    assert client.watermark_calls == calls
    now[0] = 1.5
    assert c.backlog() == 500
    assert client.watermark_calls > calls


@PKGS
def test_backlog_invalid_position_counts_retained_range(pkg):
    now = [0.0]
    client = fk.FakeBacklogClient({0: (20, 120, -1001), 1: (-1001, -1001, 5)})
    c = _backlog_consumer(pkg, client, lambda: now[0])
    assert c.backlog() == 100


@PKGS
def test_backlog_error_degrades_to_none_then_recovers(pkg):
    now = [0.0]
    client = fk.FakeBacklogClient({0: (0, 10, 0)})
    c = _backlog_consumer(pkg, client, lambda: now[0])

    def boom():
        raise RuntimeError("broker down")

    client.assignment = boom
    assert c.backlog() is None
    now[0] = 2.0
    client.assignment = lambda: list(client.partitions)
    assert c.backlog() == 10


@PKGS
def test_backlog_feeds_scheduler_watermark_shedding(pkg):
    sched_mod = importlib.import_module(
        "fraud_detection_tpu.sched" if pkg == "jax"
        else "fraud_detection_tpu_torch.sched")
    now = [0.0]
    client = fk.FakeBacklogClient({0: (0, 5000, 0)})
    c = _backlog_consumer(pkg, client, lambda: now[0])
    sched = sched_mod.AdaptiveScheduler(
        sched_mod.SchedulerConfig(shed_policy="reject", max_queue=100),
        batch_size=64)
    assert sched.backlog_of(c) == 5000
    keep, shed = sched.admit(list(range(100)), sched.backlog_of(c))
    assert shed


@PKGS
def test_unavailable_without_wheel(pkg):
    kmod = importlib.import_module(MODS[pkg])
    if kmod.kafka_available():
        pytest.skip("confluent_kafka installed in this environment")
    with pytest.raises(RuntimeError, match="confluent_kafka is not installed"):
        kmod.KafkaConsumer(config=CFG[pkg])
    with pytest.raises(RuntimeError, match="confluent_kafka is not installed"):
        kmod.KafkaProducer(config=CFG[pkg])


@pytest.fixture(scope="module")
def twin_pipelines():
    from fraud_detection_tpu.models.pipeline import synthetic_demo_pipeline
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline

    jp = synthetic_demo_pipeline(batch_size=16, n=200, seed=3,
                                 num_features=1024)
    tp = ServingPipeline(port_featurizer(jp.featurizer), port_model(jp.model),
                         batch_size=16, device="cpu")
    return {"jax": jp, "torch": warmed(tp)}


def _engine_cls(pkg):
    return importlib.import_module(
        "fraud_detection_tpu.stream.engine" if pkg == "jax"
        else "fraud_detection_tpu_torch.stream.engine").StreamingClassifier


def test_engine_end_to_end_over_stubbed_kafka(kafka_mods, twin_pipelines):
    """Both engines over the recording fakes: consume, classify, produce,
    flush, commit through TopicPartition objects; the two packages produce
    the same records byte for byte and commit the same offsets."""
    texts = [f"hello agent this is customer number {i} calling about a prize"
             for i in range(10)]
    runs = {}
    for pkg in ("jax", "torch"):
        consumer = kafka_mods[pkg].KafkaConsumer(CFG[pkg])
        producer = kafka_mods[pkg].KafkaProducer(CFG[pkg])
        consumer._consumer.queue = [
            fk.FakeKafkaMessage(topic="raw",
                                value=json.dumps({"text": t}).encode(),
                                key=str(i).encode(), partition=i % 3,
                                offset=i // 3)
            for i, t in enumerate(texts)
        ] + [fk.FakeKafkaMessage(topic="raw", value=b"broken", key=b"bad",
                                 partition=0, offset=99)]
        engine = _engine_cls(pkg)(twin_pipelines[pkg], consumer, producer,
                                  "classified", batch_size=16, max_wait=0.01)
        stats = engine.run(max_messages=11, idle_timeout=0.3)
        assert stats.processed == 11 and stats.malformed == 1
        fake_prod = producer._producer
        assert len(fake_prod.produced) == 11
        outs = {key: json.loads(val) for _, val, key in fake_prod.produced}
        for i, t in enumerate(texts):
            assert outs[str(i).encode()]["original_text"] == t
            assert outs[str(i).encode()]["prediction"] in (0, 1)
        assert outs[b"bad"]["error"] == "malformed message"
        commits = consumer._consumer.commits
        assert commits, "no offsets committed"
        tps = [tp for offsets, _ in commits for tp in offsets]
        assert {(tp.topic, tp.partition) for tp in tps} <= {
            ("raw", 0), ("raw", 1), ("raw", 2)}
        runs[pkg] = (sorted((k, v) for _, v, k in fake_prod.produced),
                     sorted((tp.topic, tp.partition, tp.offset) for tp in tps))
    assert runs["torch"] == runs["jax"]


@PKGS
def test_poll_transient_transport_errors_raise_retriable(kafka_mods, pkg):
    c = kafka_mods[pkg].KafkaConsumer(config=CFG[pkg])
    c._consumer.queue = [fk.FakeKafkaMessage(
        error=fk.FakeKafkaError(fk.FakeKafkaError._TRANSPORT))]
    transient = _broker_mod(pkg).TransientBrokerError
    with pytest.raises(transient, match="transient broker"):
        c.poll(0.1)
    c._consumer.queue = [
        fk.FakeKafkaMessage("t", b"1", offset=0),
        fk.FakeKafkaMessage(error=fk.FakeKafkaError(
            fk.FakeKafkaError._ALL_BROKERS_DOWN)),
    ]
    with pytest.raises(transient):
        c.poll_batch(10, 0.1)


@PKGS
def test_poll_informational_errors_still_dropped(kafka_mods, pkg):
    c = kafka_mods[pkg].KafkaConsumer(config=CFG[pkg])
    c._consumer.queue = [fk.FakeKafkaMessage(
        error=fk.FakeKafkaError(fk.FakeKafkaError._PARTITION_EOF))]
    assert c.poll(0.1) is None
    c._consumer.queue = [
        fk.FakeKafkaMessage("t", b"1", offset=0),
        fk.FakeKafkaMessage(error=fk.FakeKafkaError(
            fk.FakeKafkaError._PARTITION_EOF)),
        fk.FakeKafkaMessage("t", b"2", offset=1)]
    assert [m.value for m in c.poll_batch(10, 0.1)] == [b"1", b"2"]


@PKGS
def test_commit_rebalance_error_translates(kafka_mods, pkg):
    c = kafka_mods[pkg].KafkaConsumer(config=CFG[pkg])
    failed = _broker_mod(pkg).CommitFailedError

    def fenced(offsets=None, asynchronous=True):
        raise fk.FakeKafkaException(
            fk.FakeKafkaError(fk.FakeKafkaError.ILLEGAL_GENERATION))

    c._consumer.commit = fenced
    with pytest.raises(failed, match="fenced"):
        c.commit_offsets({("raw", 0): 5})
    with pytest.raises(failed, match="fenced"):
        c.commit()

    def broken(offsets=None, asynchronous=True):
        raise fk.FakeKafkaException(fk.FakeKafkaError(fk.FakeKafkaError._STATE))

    c._consumer.commit = broken
    with pytest.raises(fk.FakeKafkaException):
        c.commit_offsets({("raw", 0): 5})


@PKGS
def test_assigned_consumer_resumes_from_committed(kafka_mods, pkg):
    client = fk.FakeConsumer({})
    client.committed_offsets = {("raw", 0): 42}
    c = kafka_mods[pkg].KafkaAssignedConsumer(
        [("raw", 0), ("raw", 1)], config=CFG[pkg], client=client)
    got = sorted((tp.topic, tp.partition, tp.offset) for tp in client.assigned)
    assert got == [("raw", 0, 42), ("raw", 1, -2)]
    assert c.assignment() == [("raw", 0), ("raw", 1)]
    assert client.subscribed is None


@PKGS
def test_assigned_consumer_fence_blocks_commit(kafka_mods, pkg):
    client = fk.FakeConsumer({})
    client.committed_offsets = {}
    fenced_calls = []

    def fence(pairs):
        fenced_calls.append(list(pairs))
        return [("raw", 1)]

    c = kafka_mods[pkg].KafkaAssignedConsumer(
        [("raw", 0), ("raw", 1)], config=CFG[pkg], client=client, fence=fence)
    failed = _broker_mod(pkg).CommitFailedError
    with pytest.raises(failed):
        c.commit_offsets({("raw", 0): 5, ("raw", 1): 9})
    with pytest.raises(failed):
        c.commit()
    assert client.commits == []
    assert fenced_calls[0] == [("raw", 0), ("raw", 1)]


@PKGS
def test_assigned_consumer_fence_pass_commits_through(kafka_mods, pkg):
    client = fk.FakeConsumer({})
    client.committed_offsets = {}
    c = kafka_mods[pkg].KafkaAssignedConsumer(
        [("raw", 0)], config=CFG[pkg], client=client, fence=lambda pairs: [])
    c.commit_offsets({("raw", 0): 7})
    (tps, asynchronous), = client.commits
    assert asynchronous is False
    assert [(tp.topic, tp.partition, tp.offset) for tp in tps] == \
        [("raw", 0, 7)]
    c2 = kafka_mods[pkg].KafkaAssignedConsumer(
        [("raw", 0)], config=CFG[pkg], client=fk.FakeConsumer({}))
    c2.commit()
    assert c2._consumer.commits == [(None, False)]


@PKGS
def test_assigned_consumer_polls_like_group_consumer(kafka_mods, pkg):
    client = fk.FakeConsumer({})
    client.committed_offsets = {}
    c = kafka_mods[pkg].KafkaAssignedConsumer([("raw", 0)], config=CFG[pkg],
                                              client=client)
    client.queue = [fk.FakeKafkaMessage("raw", b"v", b"k", 0, 3)]
    m = c.poll(0.1)
    assert (m.topic, m.value, m.key, m.partition, m.offset) == \
        ("raw", b"v", b"k", 0, 3)


# ---------------------------------------------------------------------------
# over the in-memory cluster: the engine, the control bus, the serve CLI
# ---------------------------------------------------------------------------

def _feed(c: fk.FakeCluster, n: int, topic="raw"):
    for i in range(n):
        value = (b'{"text": "unterminated' if i % 37 == 5
                 else json.dumps({"text": f"hello dialogue {i} verify your "
                                          "account urgent prize"}).encode())
        c.append(topic, value, f"k{i}".encode())


def test_engine_over_cluster_commits_last_offset_plus_one(cluster,
                                                          twin_pipelines):
    """The port's engine over ``FakeCluster``: every key out once, each
    partition's committed offset = its last offset + 1, the raw-JSON path
    taken; the JAX engine's output over the same records is equal."""
    c, mods = cluster
    _feed(c, 150)
    high = c.high_watermarks("raw")
    outs = {}
    for pkg in ("jax", "torch"):
        out_topic = f"out-{pkg}"
        consumer = mods[pkg].KafkaConsumer(["raw"], CFG[pkg])
        engine = _engine_cls(pkg)(twin_pipelines[pkg], consumer,
                                  mods[pkg].KafkaProducer(CFG[pkg]),
                                  out_topic, batch_size=16, max_wait=0.01)
        stats = engine.run(max_messages=150, idle_timeout=0.5)
        consumer.close()
        assert stats.processed == 150
        recs = c.records(out_topic)
        assert sorted(m.key() for m in recs) == sorted(
            f"k{i}".encode() for i in range(150))
        outs[pkg] = {m.key(): m.value() for m in recs}
        if pkg == "torch":
            assert engine._json_fast is True
            committed = {p: c.committed[("grp", "raw", p)] for p in high}
            assert committed == high
            # an offset is committed only once its batch's outputs flushed
            assert all(off >= 1 for (_, _, _, off) in c.commit_log)
        # the next package's group starts from the beginning again
        for p in high:
            c.committed.pop(("grp", "raw", p), None)
    assert outs["torch"] == outs["jax"]


def test_kafka_control_bus_round_trip_compacted(cluster):
    """``KafkaControlBus`` over the cluster: a lease record published by one
    bus is read back by another, and after compaction of the control topic
    only the newest record per ``kind:sender`` key is left."""
    from fraud_detection_tpu_torch.fleet import KafkaControlBus

    c, _ = cluster
    cfg = TKafkaConfig(bootstrap_servers="broker:9092",
                       consumer_group="fleet-a")
    pub = KafkaControlBus(cfg)
    for term in (1, 2, 3):
        pub.publish("lease", "coordinator", {"partition": 0, "owner": "w1",
                                             "epoch": term}, term=term)
    pub.publish("heartbeat", "w1", {"batches": 7})
    assert c.compact("__fleet_control") == 2
    reader = KafkaControlBus(TKafkaConfig(bootstrap_servers="broker:9092",
                                          consumer_group="fleet-b"))
    got = reader.poll()
    # partitions are read in turn, so only the set is fixed
    assert sorted((r.kind, r.sender, r.term) for r in got) == \
        [("heartbeat", "w1", 0), ("lease", "coordinator", 3)]
    lease = next(r for r in got if r.kind == "lease")
    assert lease.payload == {"partition": 0, "owner": "w1", "epoch": 3}


def test_kafka_control_bus_refuses_like_jax_without_wheel():
    from fraud_detection_tpu import fleet as jfleet
    from fraud_detection_tpu_torch import fleet as tfleet

    with pytest.raises(RuntimeError, match="requires confluent_kafka") as te:
        tfleet.KafkaControlBus()
    with pytest.raises(RuntimeError, match="requires confluent_kafka") as je:
        jfleet.KafkaControlBus()
    assert str(te.value) == str(je.value)


def test_serve_cli_kafka_refusals_equal_jax(tmp_path):
    from fraud_detection_tpu.app import serve as jserve
    from fraud_detection_tpu_torch.app import serve as tserve

    for argv in (["--model", "synthetic", "--kafka"],
                 ["--model", "synthetic", "--kafka", "--demo", "5"],
                 ["--model", "synthetic", "--kafka", "--fleet", "2"],
                 ["--model", "synthetic", "--kafka", "--chaos"]):
        with pytest.raises(SystemExit) as je:
            jserve.main(argv)
        with pytest.raises(SystemExit) as te:
            tserve.main(["--device", "cpu", *argv])
        assert str(te.value) == str(je.value), argv


def test_serve_cli_kafka_over_cluster(cluster, tmp_path, capsys,
                                      twin_pipelines):
    """``serve --kafka`` end to end over the stand-in cluster: every fed key
    comes out (malformed ones as error records), each partition commits its
    last offset + 1, on the raw-JSON path."""
    from fraud_detection_tpu_torch.app import serve as tserve
    from fraud_detection_tpu_torch.checkpoint.native import save_checkpoint

    c, _ = cluster
    tp = twin_pipelines["torch"]
    save_checkpoint(str(tmp_path / "ckpt"), tp.featurizer, tp.model)
    _feed(c, 120, topic="customer-dialogues-raw")
    rc = tserve.main(["--device", "cpu", "--model", str(tmp_path / "ckpt"),
                      "--kafka", "--max-messages", "120",
                      "--batch-size", "32"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["processed"] == 120
    assert out["malformed"] == sum(1 for i in range(120) if i % 37 == 5)
    keys = sorted(m.key() for m in c.records("dialogues-classified"))
    assert keys == sorted(f"k{i}".encode() for i in range(120))
    high = c.high_watermarks("customer-dialogues-raw")
    assert {p: c.committed[("dialogue-classifier-group",
                            "customer-dialogues-raw", p)]
            for p in high} == high
    assert out["health"]["device"]["featurize_path"] == "host"
