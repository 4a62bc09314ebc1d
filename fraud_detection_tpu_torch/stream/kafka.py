"""Kafka clients for the engine (confluent_kafka) — twin of
``fraud_detection_tpu/stream/kafka.py``.

Takes a typed ``KafkaConfig`` (``utils/config.py``) whose ``from_env`` reads
the reference deployment's variables (``KAFKA_BOOTSTRAP_SERVERS``,
``KAFKA_INPUT_TOPIC``, ``KAFKA_OUTPUT_TOPIC``, ``KAFKA_CONSUMER_GROUP``,
``KAFKA_SECURITY_PROTOCOL``, ``KAFKA_USERNAME``, ``KAFKA_PASSWORD``). The
clients are configured as the reference's are — earliest offsets,
auto-commit off, an optional SASL_SSL block — and the engine commits each
batch's offsets after its outputs are delivered.

confluent_kafka (librdkafka) is import-gated: ``kafka_available()`` says
whether it is installed, and without it the engine stays on the in-process
broker (``stream/broker.py``). The consumer hands the engine
``broker.Message`` records whose ``value`` is the record's bytes, which is
what the engine's raw-JSON path reads.
"""

from __future__ import annotations

import time
from typing import List, Optional

from fraud_detection_tpu_torch.stream.broker import (CommitFailedError,
                                                     Message,
                                                     TransientBrokerError)
from fraud_detection_tpu_torch.utils.config import KafkaConfig

try:  # pragma: no cover - present only where the wheel is installed
    import confluent_kafka as _ck
except ImportError:  # pragma: no cover
    _ck = None

# Group-rebalance commit failures surface as the in-process broker's
# CommitFailedError: the engine treats that as a routine fenced commit and
# keeps polling under the new assignment, while any other commit error stays
# fatal. _STATE ("Local: Erroneous state") is left out on purpose: it also
# covers fatal consumer states, which must crash into the supervisor rather
# than loop on uncommitted offsets.
_REBALANCE_CODE_NAMES = ("ILLEGAL_GENERATION", "UNKNOWN_MEMBER_ID",
                         "REBALANCE_IN_PROGRESS")


def _rebalance_codes():
    ke = getattr(_ck, "KafkaError", None)
    return {getattr(ke, n) for n in _REBALANCE_CODE_NAMES
            if ke is not None and hasattr(ke, n)}


def _translate_commit_error(e: Exception) -> None:
    """Raise CommitFailedError for fenced commits; re-raise anything else."""
    kafka_exc = getattr(_ck, "KafkaException", None)
    if kafka_exc is not None and isinstance(e, kafka_exc):
        err = e.args[0] if e.args else None
        code = err.code() if hasattr(err, "code") else None
        if code in _rebalance_codes():
            raise CommitFailedError(
                f"commit fenced by group rebalance: {e}") from e
    raise e


# Transport-class poll errors (the link is down, librdkafka retries
# underneath) surface as TransientBrokerError, so the supervisor restarts
# the incarnation with backoff instead of the engine spinning on a dead
# link. Fatal client states must crash through untranslated, and
# _PARTITION_EOF is not an error at all, so neither is listed.
_TRANSIENT_POLL_CODE_NAMES = ("_TRANSPORT", "_ALL_BROKERS_DOWN",
                              "_TIMED_OUT", "_RESOLVE")


def _transient_poll_codes():
    ke = getattr(_ck, "KafkaError", None)
    return {getattr(ke, n) for n in _TRANSIENT_POLL_CODE_NAMES
            if ke is not None and hasattr(ke, n)}


def _translate_poll_error(err) -> None:
    """Handle a non-None ``message.error()`` from poll/consume: raise
    TransientBrokerError for transport-class codes, pass for anything else
    (the caller drops the event)."""
    code = err.code() if hasattr(err, "code") else None
    if code in _transient_poll_codes():
        raise TransientBrokerError(
            f"transient broker transport failure while polling: {err}")


def kafka_available() -> bool:
    return _ck is not None


def _require():
    if _ck is None:
        raise RuntimeError(
            "confluent_kafka is not installed; use stream.broker.InProcessBroker "
            "or install librdkafka's python client")


def _security_config(cfg: KafkaConfig) -> dict:
    if (cfg.security_protocol or "").upper() == "SASL_SSL":
        return {
            "security.protocol": "SASL_SSL",
            "sasl.mechanisms": "PLAIN",
            "sasl.username": cfg.username or "",
            "sasl.password": cfg.password or "",
        }
    return {}


def _consumer_config(cfg: KafkaConfig) -> dict:
    return {
        "bootstrap.servers": cfg.bootstrap_servers,
        "group.id": cfg.consumer_group,
        "auto.offset.reset": "earliest",
        "enable.auto.commit": False,
        **_security_config(cfg),
    }


def _msg_timestamp(m) -> float:
    """The record's timestamp in epoch seconds, or 0.0 when it has none
    (the engine then stamps the row at poll)."""
    try:
        ts_type, ts_ms = m.timestamp()
    except Exception:  # noqa: BLE001 — latency accounting is best-effort
        return 0.0
    # type 0 = TIMESTAMP_NOT_AVAILABLE; 1/2 = create/log-append time.
    return ts_ms / 1e3 if ts_type and ts_ms and ts_ms > 0 else 0.0


def _to_message(m) -> Message:
    return Message(m.topic(), m.value(), m.key(), m.partition(), m.offset(),
                   _msg_timestamp(m))


class KafkaConsumer:
    """confluent_kafka consumer behind the engine's ``poll_batch`` protocol.

    ``client`` injects a consumer object built elsewhere (tests drive the
    adapter with no wheel and no broker); ``backlog_interval`` rate-limits
    the watermark queries behind :meth:`backlog`."""

    def __init__(self, topics: Optional[List[str]] = None,
                 config: Optional[KafkaConfig] = None, *,
                 client=None, backlog_interval: float = 1.0,
                 clock=time.monotonic):
        if client is not None:
            self._consumer = client
            if topics:
                client.subscribe(topics)
        else:
            _require()
            cfg = config or KafkaConfig.from_env()
            self._consumer = _ck.Consumer(_consumer_config(cfg))
            self._consumer.subscribe(topics or [cfg.input_topic])
        self._clock = clock
        self._backlog_interval = backlog_interval
        self._backlog_at: Optional[float] = None
        self._backlog_val: Optional[int] = None

    def backlog(self) -> Optional[int]:
        """Rows queued behind the consumer's position over its assigned
        partitions (``high watermark - position``), the queue depth the
        scheduler's ``--max-queue`` shed policy reads. At most one round of
        watermark queries per ``backlog_interval`` seconds, the cached
        value in between. A partition with no watermark yet adds 0; one
        with no position yet adds its whole retained range (the consumer
        starts at the earliest offset). Any client error caches None, so
        lag reporting never stops serving."""
        now = self._clock()
        if (self._backlog_at is not None
                and now - self._backlog_at < self._backlog_interval):
            return self._backlog_val
        self._backlog_at = now
        try:
            total = 0
            for tp in self._consumer.assignment():
                lo, hi = self._consumer.get_watermark_offsets(
                    tp, timeout=0.2, cached=True)
                if hi is None or hi < 0:
                    continue
                pos = self._consumer.position([tp])[0].offset
                if pos is None or pos < 0:
                    pos = lo
                total += max(0, hi - max(pos, lo))
            self._backlog_val = total
        except Exception:  # noqa: BLE001 — see docstring
            self._backlog_val = None
        return self._backlog_val

    def poll(self, timeout: float = 1.0) -> Optional[Message]:
        msg = self._consumer.poll(timeout)
        if msg is None:
            return None
        if msg.error():
            _translate_poll_error(msg.error())
            return None
        return _to_message(msg)

    def poll_batch(self, max_messages: int, timeout: float) -> List[Message]:
        out = []
        for m in self._consumer.consume(num_messages=max_messages,
                                        timeout=timeout):
            if m is None:
                continue
            if m.error():
                _translate_poll_error(m.error())
                continue
            out.append(_to_message(m))
        return out

    def commit(self) -> None:
        try:
            self._consumer.commit(asynchronous=False)
        except Exception as e:  # noqa: BLE001 — translated or re-raised
            _translate_commit_error(e)

    def commit_offsets(self, offsets) -> None:
        """Commit explicit next offsets (last consumed + 1) per (topic,
        partition): the engine's per-batch commit."""
        tps = [_ck.TopicPartition(topic, part, off)
               for (topic, part), off in offsets.items()]
        try:
            self._consumer.commit(offsets=tps, asynchronous=False)
        except Exception as e:  # noqa: BLE001 — translated or re-raised
            _translate_commit_error(e)

    def close(self) -> None:
        self._consumer.close()


class KafkaAssignedConsumer(KafkaConsumer):
    """confluent_kafka consumer in manual-assignment (``assign()``) mode:
    the fleet's transport on real Kafka, the twin of the in-process
    broker's ``assigned_consumer``.

    * It reads exactly the given (topic, partition) pairs and never joins
      the group's assignor (the fleet coordinator's leases own them).
    * It resumes each pair at the group's committed offset, or at the
      beginning where the group never committed: what a dead owner did not
      commit is what the next owner reads again.
    * ``fence``, when given, is called with the pairs before every commit;
      a non-empty return means the lease was revoked, and the commit raises
      ``CommitFailedError`` instead of advancing a partition someone else
      now owns.

    ``client`` injects a consumer built elsewhere; the group id reaches a
    real client through ``config`` (``KafkaConfig.consumer_group``)."""

    def __init__(self, partitions, config: Optional[KafkaConfig] = None, *,
                 fence=None, client=None, backlog_interval: float = 1.0,
                 clock=time.monotonic):
        self.partitions = [tuple(p) for p in partitions]
        self._fence = fence
        if client is not None:
            self._consumer = client
        else:
            _require()
            cfg = config or KafkaConfig.from_env()
            self._consumer = _ck.Consumer(_consumer_config(cfg))
        self._clock = clock
        self._backlog_interval = backlog_interval
        self._backlog_at: Optional[float] = None
        self._backlog_val: Optional[int] = None
        # assign() skips auto.offset.reset until the first fetch, so a pair
        # the group never committed is assigned OFFSET_BEGINNING explicitly.
        tps = [self._tp(t, p) for t, p in self.partitions]
        begin = getattr(_ck, "OFFSET_BEGINNING", -2) if _ck is not None \
            else -2
        try:
            committed = self._consumer.committed(tps, timeout=10.0)
        except TypeError:       # pragma: no cover - older client signature
            committed = self._consumer.committed(tps)
        for tp in committed:
            if tp.offset is None or tp.offset < 0:
                tp.offset = begin
        self._consumer.assign(committed)

    @staticmethod
    def _tp(topic: str, partition: int, offset: Optional[int] = None):
        if _ck is not None:
            if offset is None:
                return _ck.TopicPartition(topic, partition)
            return _ck.TopicPartition(topic, partition, offset)
        raise RuntimeError("confluent_kafka unavailable")  # pragma: no cover

    def assignment(self):
        return sorted(self.partitions)

    def _check_fence(self, pairs) -> None:
        fence = self._fence
        if fence is None or not pairs:
            return
        lost = fence(sorted(pairs))
        if lost:
            raise CommitFailedError(
                f"lease for {sorted(lost)} was revoked from this worker; "
                "offsets stay uncommitted — the partitions' new owner "
                "reprocesses")

    def commit(self) -> None:
        self._check_fence(self.partitions)
        super().commit()

    def commit_offsets(self, offsets) -> None:
        self._check_fence(list(offsets))
        super().commit_offsets(offsets)


class KafkaProducer:
    def __init__(self, config: Optional[KafkaConfig] = None):
        _require()
        cfg = config or KafkaConfig.from_env()
        self._producer = _ck.Producer({
            "bootstrap.servers": cfg.bootstrap_servers,
            **_security_config(cfg),
        })
        self._delivery_failures = 0

    def _on_delivery(self, err, msg) -> None:
        if err is not None:
            self._delivery_failures += 1

    def produce(self, topic: str, value: bytes, key: Optional[bytes] = None) -> None:
        self._producer.produce(topic, value=value, key=key,
                               on_delivery=self._on_delivery)

    def produce_batch(self, topic: str, items) -> None:
        """Produce (value, key) pairs. librdkafka's ``produce`` only
        enqueues; on a full local queue ``poll`` serves delivery callbacks
        to free room and the enqueue is tried again, up to 100 times (~10
        s, the flush default). A queue still full after that means the
        broker is down: BufferError reaches the engine, whose offsets stay
        uncommitted, and the supervisor drives the batch again."""
        produce = self._producer.produce
        for value, key in items:
            for _ in range(100):
                try:
                    produce(topic, value=value, key=key,
                            on_delivery=self._on_delivery)
                    break
                except BufferError:
                    self._producer.poll(0.1)
            else:
                raise BufferError(
                    f"librdkafka queue full for 10s producing to {topic!r}")

    def flush(self, timeout: float = 10.0) -> int:
        """The number of messages NOT durably delivered: still queued plus
        terminally failed. A terminal failure (a message too large) leaves
        librdkafka's queue but must still hold back the engine's offset
        commit, or the lost output would never be produced again."""
        remaining = int(self._producer.flush(timeout))
        failed, self._delivery_failures = self._delivery_failures, 0
        return remaining + failed
