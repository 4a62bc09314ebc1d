"""The port's slotserve service, on the CPU — the counterpart of
``tests/test_slotserve.py``, plus the slice's parity with the JAX service.

The model is the JAX test's (d 64, 2 layers, 4 heads, d_ff 128, max_seq
1024, seed 3), carried across with ``tests/torch_parity.port_llm``:

* **parity** — the JAX ``SlotServeService.explain_rows`` and the port's,
  contiguous and paged, give equal greedy analyses text for text;
* **decode parity** — greedy replies through the slot pool equal the
  fixed-batch path's (``OnPodBackend.generate_batch``), including after
  slot reuse;
* **honest accounting** — ``admitted == completed + dropped`` under queue
  overflow, close residue and decoder death; annotation-lane drop records
  account every drop;
* **degradation** — a dead decoder fails requests with BackendError and the
  lane recovers; a fault of the card stops the lane, fails everything
  loudly and leaves ``fault`` set; the slot hook turns failures into
  accounted markers behind the breaker;
* **schema** — ``snapshot()`` has the JAX service's keys
  (``tests/test_slotserve.py``'s ``SLOTSERVE_BLOCK_SCHEMA``) plus the port's
  ``kv_bytes_per_device``;
* **tracing** — explained rows' "explain" spans carry their slot, drop
  records carry trace ids that join back to the rows' chains, and under
  seeded broker chaos every flagged row is explained or accounted;
* **end to end** — the serve CLI with ``--explain-slots``.

``test_campaign_explain_gameday_passes`` and
``test_gameday_validation_rejects_bad_configs`` (``scenarios/gameday``) are
mirrored in ``tests/test_torch_gameday_lanes.py``
(``test_slot_lane_game_days_cover_every_flagged_row``, campaign_explain) and
``tests/test_torch_scenarios.py`` (``test_gameday_refusals_equal_jax``).
"""

import json
import threading

import jax
import numpy as np
import pytest
import torch

from fraud_detection_tpu.explain.slotserve import (
    SlotServeService as JaxSlotServeService)
from fraud_detection_tpu.models import llm as jllm
from fraud_detection_tpu_torch.app import serve as tserve
from fraud_detection_tpu_torch.explain.backends import (BackendError,
                                                        frame_prompt)
from fraud_detection_tpu_torch.explain.circuit import (BreakerOpenError,
                                                       CircuitBreakerBackend)
from fraud_detection_tpu_torch.explain.onpod import OnPodBackend, flatten_chat
from fraud_detection_tpu_torch.explain.slotserve import (DROPPED_MARKER,
                                                         UNAVAILABLE_MARKER,
                                                         SlotServeService,
                                                         make_slot_explain_hook)
from fraud_detection_tpu_torch.stream import (InProcessBroker,
                                              StreamingClassifier)
from tests.test_slotserve import SLOTSERVE_BLOCK_SCHEMA as JSLOT_SCHEMA
from tests.torch_parity import port_llm


@pytest.fixture(scope="module")
def models():
    cfg = jllm.TransformerConfig(d_model=64, n_layers=2, n_heads=4, d_ff=128,
                                 max_seq=1024)
    jlm = jllm.LanguageModel.init_random(cfg, seed=3)
    return jlm, port_llm(jlm)


@pytest.fixture(scope="module")
def lm(models):
    return models[1]


def make_service(lm, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("max_new_tokens", 24)
    kw.setdefault("prompt_width", 448)
    kw.setdefault("decode_window", 8)
    kw.setdefault("wait_timeout", 120.0)
    return SlotServeService(lm, **kw)


def prompts_varied(n, base=0):
    return [f"Analyze dialogue {base + i}: the caller claims to be the "
            "bank fraud department and demands gift cards. "
            + "Customer hesitates. " * (i % 4) for i in range(n)]


DIALOGUES = ["Caller: this is your bank security department, read me the "
             "one-time code now or the account is frozen. "
             + "Customer hesitates. " * (i % 4) for i in range(6)]


# ---------------------------------------------------------------------------
# the slice against the JAX service
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_explain_rows_equal_jax(models, paged):
    jlm, plm = models
    kw = dict(slots=3, max_new_tokens=16, prompt_width=448, decode_window=8,
              wait_timeout=300.0)
    if paged:
        kw.update(paged=True)
    labels = [1, 0, 1, 1, 0, 1]
    confs = [0.5 + 0.07 * i for i in range(6)]
    jsvc = JaxSlotServeService(jlm, **kw)
    try:
        want = jsvc.explain_rows(DIALOGUES, labels, confs, max_tokens=16)
    finally:
        jsvc.close()
    psvc = SlotServeService(plm, **kw)
    try:
        got = psvc.explain_rows(DIALOGUES, labels, confs, max_tokens=16)
        snap = psvc.snapshot()
    finally:
        assert psvc.close()
    assert got == want
    assert snap["completed"] == 6 and snap["dropped"] == 0
    if paged:
        assert snap["prefix_hits"] == 6 and snap["cow_copies"] == 6


# ---------------------------------------------------------------------------
# decode parity + FIFO + slot reuse
# ---------------------------------------------------------------------------

def test_slot_outputs_match_fixed_batch_greedy(lm):
    """12 prompts through 4 slots forces reuse: every slot serves ~3 rows,
    so equality with the fixed-batch path is also the cross-slot
    KV-contamination pin."""
    svc = make_service(lm)
    try:
        prompts = prompts_varied(12)
        got = svc.generate_batch(prompts, temperature=0.0, max_tokens=24)
        want = OnPodBackend.from_model(lm).generate_batch(
            prompts, temperature=0.0, max_tokens=24)
        assert got == list(want)
        snap = svc.snapshot()
        assert snap["admitted"] == snap["completed"] == snap["prefills"] == 12
        assert snap["dropped"] == 0 and snap["truncated"] == 0
    finally:
        assert svc.close()


def test_slot_reuse_never_leaks_prior_kv(lm):
    svc = make_service(lm, slots=2)
    try:
        probe = "Analyze dialogue 999: urgent wire transfer demanded now."
        fresh = svc.generate_batch([probe], temperature=0.0, max_tokens=24)
        svc.generate_batch(prompts_varied(6, base=50), temperature=0.0,
                           max_tokens=24)       # churn both slots
        again = svc.generate_batch([probe], temperature=0.0, max_tokens=24)
        assert fresh == again
    finally:
        svc.close()


def test_explain_rows_positional(lm):
    """Replies align with their rows, trace ids (cids) riding along."""
    svc = make_service(lm)
    try:
        texts = ["scam text A", "scam text B", "scam text C"]
        out = svc.explain_rows(texts, [1, 1, 1], [0.9, 0.8, 0.7],
                               cids=["t0-1:0:5", None, "t0-1:0:7"],
                               max_tokens=8)
        singles = [svc.explain_rows([t], [1], [c], max_tokens=8)[0]
                   for t, c in zip(texts, (0.9, 0.8, 0.7))]
        assert out == singles and all(isinstance(s, str) for s in out)
    finally:
        svc.close()


def test_explain_rows_positional_and_traced(lm):
    """Every traced row gets exactly one ok "explain" span naming its
    slot; an untraced row (cid None) records nothing."""
    from fraud_detection_tpu_torch.obs.trace import RowTracer

    tracer = RowTracer(worker="t0", sample=1.0)
    svc = make_service(lm, rowtrace=tracer)
    try:
        cids = ["t0-1:0:5", None, "t0-1:0:7"]
        out = svc.explain_rows(["scam text A", "scam text B", "scam text C"],
                               [1, 1, 1], [0.9, 0.8, 0.7], cids=cids,
                               max_tokens=8)
        assert len(out) == 3 and all(isinstance(s, str) for s in out)
        for cid in ("t0-1:0:5", "t0-1:0:7"):
            spans = [s for s in tracer.chain(cid) if s.stage == "explain"]
            assert len(spans) == 1 and spans[0].ok
            assert "slot=" in spans[0].detail
        assert tracer.snapshot()["spans_begun"] == 2
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# admission accounting
# ---------------------------------------------------------------------------

def test_queue_overflow_drops_oldest_with_accounting(lm):
    svc = make_service(lm, slots=1, max_queue=2, max_new_tokens=8)
    try:
        reqs = [svc.submit(flatten_chat(frame_prompt(p)), max_tokens=8)
                for p in prompts_varied(8)]
        texts = [r.wait(120.0) for r in reqs]
        dropped = [t for t in texts
                   if t == DROPPED_MARKER.format(reason="queue_overflow")]
        assert dropped, "overflow should have dropped the oldest requests"
        snap = svc.snapshot()
        assert snap["admitted"] == 8
        assert snap["admitted"] == snap["completed"] + snap["dropped"]
        assert snap["dropped"] == len(dropped)
    finally:
        svc.close()


def test_close_residual_counts_dropped(lm):
    svc = make_service(lm, slots=1, max_queue=64, max_new_tokens=24)
    reqs = [svc.submit(flatten_chat(frame_prompt(p)), max_tokens=24)
            for p in prompts_varied(6)]
    svc.close(timeout=0.05)
    texts = [r.wait(120.0) for r in reqs]
    assert any(t == DROPPED_MARKER.format(reason="closed") for t in texts)
    snap = svc.snapshot()
    assert snap["admitted"] == 6
    assert snap["admitted"] == snap["completed"] + snap["dropped"]
    late = svc.submit("late", max_tokens=4)
    assert late.wait(5.0) == DROPPED_MARKER.format(reason="closed")
    snap = svc.snapshot()
    assert snap["admitted"] == snap["completed"] + snap["dropped"]


def test_truncation_counted(lm):
    svc = make_service(lm, prompt_width=64, max_new_tokens=4)
    try:
        svc.generate_batch(["x" * 500], temperature=0.0, max_tokens=4)
        assert svc.snapshot()["truncated"] == 1
    finally:
        svc.close()


def test_geometry_refused_past_max_seq(lm):
    with pytest.raises(ValueError, match="cfg.max_seq"):
        make_service(lm, prompt_width=1000, max_new_tokens=64)
    with pytest.raises(ValueError, match="paged=True"):
        make_service(lm, kv_pages=8)


# ---------------------------------------------------------------------------
# degradation: decoder death, a fault of the card, breaker, markers
# ---------------------------------------------------------------------------

def test_decoder_failure_fails_requests_then_recovers(lm):
    svc = make_service(lm, slots=2, max_new_tokens=8)
    try:
        real_prefill = svc._decoder.prefill

        def boom(*a, **k):
            raise RuntimeError("device lost")

        svc._decoder.prefill = boom
        with pytest.raises(BackendError, match="decoder failed"):
            svc.generate_batch(["will fail"], max_tokens=4)
        snap = svc.snapshot()
        assert snap["errors"] >= 1
        assert snap["admitted"] == snap["completed"] + snap["dropped"]
        svc._decoder.prefill = real_prefill
        out = svc.generate_batch(["recovers"], temperature=0.0, max_tokens=4)
        assert len(out) == 1 and isinstance(out[0], str)
        snap = svc.snapshot()
        assert snap["admitted"] == snap["completed"] + snap["dropped"]
        assert svc.fault is None
    finally:
        svc.close()


def test_device_fault_stops_the_lane_loudly(lm):
    """A CUDA error in a decode window fails every request, sets ``fault``
    and stops the lane: later requests fail at once (accounted), nothing
    retries."""
    svc = make_service(lm, slots=2, max_new_tokens=8)
    fault = RuntimeError("CUDA error: an illegal memory access was "
                         "encountered")

    def boom(*a, **k):
        raise fault

    svc._decoder.step = boom
    with pytest.raises(BackendError, match="illegal memory access"):
        svc.generate_batch(["a", "b", "c"], max_tokens=4)
    svc._thread.join(timeout=10.0)
    assert not svc._thread.is_alive() and svc.fault is fault
    with pytest.raises(BackendError, match="illegal memory access"):
        svc.generate_batch(["late"], max_tokens=4)
    snap = svc.snapshot()
    assert snap["admitted"] == 4 and snap["errors"] == 4
    assert snap["admitted"] == snap["completed"] + snap["dropped"]
    assert svc.close(timeout=1.0)


def test_breaker_wraps_slotserve_and_hook_emits_markers(lm):
    clock = type("C", (), {"t": 0.0})()
    svc = make_service(lm, slots=2, max_new_tokens=8)
    try:
        svc._decoder.prefill = lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("device lost"))
        breaker = CircuitBreakerBackend(svc, failure_threshold=1,
                                        probe_interval=30.0,
                                        clock=lambda: clock.t)
        hook = make_slot_explain_hook(breaker, max_tokens=4)
        out = hook(["a", "b"], [1, 1], [0.9, 0.9], cids=[None, None])
        assert out == [UNAVAILABLE_MARKER.format(reason="BackendError")] * 2
        assert breaker.snapshot()["state"] == "open"
        out = hook(["c"], [1], [0.5])
        assert out == [UNAVAILABLE_MARKER.format(reason="BreakerOpenError")]
        assert breaker.snapshot()["fast_fails"] >= 1
        with pytest.raises(BreakerOpenError):
            breaker.explain_rows(["d"], [1], [0.5])
    finally:
        svc.close()


def test_slot_hook_explains_flagged_rows_only(lm):
    svc = make_service(lm, slots=2, max_new_tokens=4)
    try:
        hook = make_slot_explain_hook(svc, max_tokens=4)
        assert hook.accepts_cids is True
        out = hook(["benign", "scam"], [0, 1], [0.9, 0.8])
        assert out[0] is None and isinstance(out[1], str)
        assert hook(["benign"], [0], [0.9]) == [None]
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# annotation-lane drop records
# ---------------------------------------------------------------------------

def _feed(broker, n, scam_every=3):
    from tests.fixtures import BENIGN_DIALOGUE, SCAM_DIALOGUE

    prod = broker.producer()
    for i in range(n):
        text = SCAM_DIALOGUE if i % scam_every == 0 else BENIGN_DIALOGUE
        prod.produce("in", json.dumps({"text": text, "id": i}).encode(),
                     key=str(i).encode())


@pytest.fixture(scope="module")
def pipeline():
    from fraud_detection_tpu_torch.models.pipeline import (
        synthetic_demo_pipeline)

    return synthetic_demo_pipeline(batch_size=64, n=400, seed=3,
                                   num_features=2048,
                                   corpus_kwargs=dict(hard_fraction=0.0,
                                                      label_noise=0.0),
                                   device="cpu")


def test_lane_drop_records_account_every_drop(pipeline):
    """Drop-OLDEST in the annotation lane is not a bare counter: every
    eviction lands a structured record on the side topic."""
    broker = InProcessBroker(num_partitions=2)
    _feed(broker, 48, scam_every=2)
    slow = threading.Event()

    def hook(texts, labels, confs, cids=None):
        slow.wait(0.25)          # a slow backend so the queue overflows
        return ["ok"] * len(texts)

    hook.accepts_cids = True
    engine = StreamingClassifier(
        pipeline, broker.consumer(["in"], "g"), broker.producer(), "out",
        batch_size=16, max_wait=0.01,
        explain_batch_fn=hook, explain_async=True,
        annotations_producer=broker.producer(), annotations_queue=4)
    engine.run(max_messages=48, idle_timeout=1.0)
    engine.close_annotations(timeout=30.0)
    stats = engine.annotation_stats()
    assert stats["dropped"] > 0
    assert stats["drop_records"] == stats["dropped"]
    assert stats["submitted"] == stats["annotated"] + stats["dropped"]
    records = [json.loads(m.value)
               for m in broker.messages("out-annotations")]
    drops = [r for r in records if r.get("dropped")]
    assert len(drops) == stats["drop_records"]
    for rec in drops:
        assert rec["reason"] == "queue_overflow" and rec["analysis"] is None


def test_lane_drop_records_carry_trace_ids(pipeline):
    """Every eviction's record on the side topic carries a ``trace`` id that
    joins back to the row's chain: flagged at classification, then the
    failed annotate the drop recorded."""
    from fraud_detection_tpu_torch.obs.trace import RowTracer

    tracer = RowTracer(worker="w0", sample=1.0)
    broker = InProcessBroker(num_partitions=2)
    _feed(broker, 48, scam_every=2)
    slow = threading.Event()

    def hook(texts, labels, confs, cids=None):
        slow.wait(0.25)          # a slow backend so the queue overflows
        return ["ok"] * len(texts)

    hook.accepts_cids = True
    engine = StreamingClassifier(
        pipeline, broker.consumer(["in"], "g"), broker.producer(), "out",
        batch_size=16, max_wait=0.01,
        explain_batch_fn=hook, explain_async=True,
        annotations_producer=broker.producer(), annotations_queue=4,
        rowtrace=tracer)
    engine.run(max_messages=48, idle_timeout=1.0)
    engine.close_annotations(timeout=30.0)
    stats = engine.annotation_stats()
    assert stats["dropped"] > 0
    assert stats["drop_records"] == stats["dropped"]
    drops = [r for r in (json.loads(m.value)
                         for m in broker.messages("out-annotations"))
             if r.get("dropped")]
    assert len(drops) == stats["drop_records"]
    for rec in drops:
        chain = tracer.chain(rec["trace"])
        assert {"flag", "annotate"} <= {s.stage for s in chain}
        assert any(s.stage == "annotate" and not s.ok
                   and "dropped" in (s.detail or "") for s in chain)


def test_chaos_every_flagged_row_explained_or_accounted(lm, pipeline):
    """Seeded broker chaos on the classification path with slotserve behind
    the lane: no lost classification, the lane's coverage invariant
    (submitted == annotated + drop_records), exact slot accounting and no
    open span."""
    from fraud_detection_tpu_torch.obs.trace import RowTracer
    from fraud_detection_tpu_torch.stream.faults import FaultPlan

    tracer = RowTracer(worker="w0", sample=1.0)
    svc = make_service(lm, slots=2, max_new_tokens=6, rowtrace=tracer)
    try:
        hook = make_slot_explain_hook(svc, max_tokens=6)
        broker = InProcessBroker(num_partitions=2)
        _feed(broker, 60, scam_every=3)
        plan = FaultPlan(seed=11, duplicate_rate=0.1, corrupt_rate=0.05,
                         flush_fail_rate=0.05, max_faults=12)
        engine = StreamingClassifier(
            pipeline, plan.consumer(broker.consumer(["in"], "g")),
            plan.producer(broker.producer()), "out",
            batch_size=16, max_wait=0.01,
            explain_batch_fn=hook, explain_async=True,
            annotations_producer=broker.producer(), annotations_queue=8,
            explain_service=svc, dlq_topic="dlq", rowtrace=tracer)
        engine.run(max_messages=60, idle_timeout=1.0)
        engine.close_annotations(timeout=60.0)
        fed = {str(i).encode() for i in range(60)}
        out_keys = {m.key for m in broker.messages("out")}
        dlq_keys = {m.key for m in broker.messages("dlq")}
        assert fed <= (out_keys | dlq_keys)
        stats = engine.annotation_stats()
        assert stats["submitted"] > 0
        assert stats["submitted"] == stats["annotated"] + stats["dropped"]
        assert stats["drop_records"] == stats["dropped"]
        snap = svc.snapshot()
        assert snap["admitted"] == snap["completed"] + snap["dropped"]
        h = engine.health()
        assert h["explain"]["slots"] == 2
        assert h["trace"]["spans_open"] == 0
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# health schema
# ---------------------------------------------------------------------------

# The JAX service's schema plus the port's per-device split of kv_bytes; a
# module-level dict literal so flightcheck's health-schema lint
# (analysis/health.py, FC301) checks snapshot() against it statically.
SLOTSERVE_BLOCK_SCHEMA = {
    "slots": (int,),
    "busy": (int,),
    "free": (int,),
    "queue_depth": (int,),
    "admitted": (int,),
    "completed": (int,),
    "dropped": (int,),
    "errors": (int,),
    "truncated": (int,),
    "expl_per_s": (type(None), int, float),
    "latency_ms": (dict,),
    "admit_to_first_token_ms": (dict,),
    "occupancy": (type(None), int, float),
    "iterations": (int,),
    "prefills": (int,),
    "decode_steps": (int,),
    "tokens_out": (int,),
    "kv_bytes": (int,),
    # The port's own key: kv_bytes split by the device each cache lies on.
    "kv_bytes_per_device": (dict,),
    # Paged-pool block: zeros in contiguous mode so the schema is
    # mode-independent — FC301 pins these against snapshot()'s literal.
    "kv_pages": (int,),
    "page_bytes": (int,),
    "pages_free": (int,),
    "prefix_pages": (int,),
    "prefix_hits": (int,),
    "cow_copies": (int,),
    "kv_bytes_saved_vs_contiguous": (int,),
}


def test_snapshot_schema_contract(lm):
    svc = make_service(lm, slots=2, max_new_tokens=4)
    try:
        svc.generate_batch(["one row"], temperature=0.0, max_tokens=4)
        snap = svc.snapshot()
        assert set(SLOTSERVE_BLOCK_SCHEMA) == set(JSLOT_SCHEMA) | {
            "kv_bytes_per_device"}
        assert set(snap) == set(SLOTSERVE_BLOCK_SCHEMA)
        for key, types in SLOTSERVE_BLOCK_SCHEMA.items():
            assert isinstance(snap[key], types), (key, type(snap[key]))
        assert sum(snap["kv_bytes_per_device"].values()) == snap["kv_bytes"]
        for sub in ("latency_ms", "admit_to_first_token_ms"):
            assert set(snap[sub]) == {"p50", "p99"}
        assert snap["expl_per_s"] is not None
        assert snap["latency_ms"]["p50"] is not None
        assert snap["admit_to_first_token_ms"]["p99"] is not None
        json.dumps(snap)
    finally:
        svc.close()


def test_engine_health_explain_block(lm, pipeline):
    svc = make_service(lm, slots=2, max_new_tokens=4)
    try:
        broker = InProcessBroker()
        _feed(broker, 8, scam_every=4)
        breaker = CircuitBreakerBackend(svc, failure_threshold=3)
        engine = StreamingClassifier(
            pipeline, broker.consumer(["in"], "g"), broker.producer(),
            "out", batch_size=8, max_wait=0.01,
            explain_batch_fn=make_slot_explain_hook(breaker, max_tokens=4),
            explain_async=True, annotations_producer=broker.producer(),
            breaker=breaker, explain_service=svc)
        engine.run(max_messages=8, idle_timeout=1.0)
        engine.close_annotations(timeout=30.0)
        h = engine.health()
        assert set(h["explain"]) == set(SLOTSERVE_BLOCK_SCHEMA)
        assert h["breaker"]["state"] == "closed"
        assert h["annotations"]["submitted"] == h["annotations"]["annotated"]
        assert h["explain"]["completed"] == h["annotations"]["annotated"] > 0
        json.dumps(h)
    finally:
        svc.close()


def test_sampled_decode_deterministic_per_seed(lm):
    outs = []
    for _ in range(2):
        svc = make_service(lm, slots=2, max_new_tokens=8, seed=5)
        try:
            outs.append(svc.generate_batch(["sample me"], temperature=0.8,
                                           max_tokens=8))
        finally:
            svc.close()
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# serve CLI e2e
# ---------------------------------------------------------------------------

def test_serve_cli_explain_slots_e2e(capsys):
    rc = tserve.main(["--device", "cpu", "--model", "synthetic", "--demo",
                      "120", "--batch-size", "64", "--max-wait", "0.01",
                      "--explain", "onpod-demo", "--explain-slots", "2",
                      "--explain-tokens", "8"])
    assert rc == 0
    out = capsys.readouterr().out
    stats = json.loads([l for l in out.splitlines()
                        if l.startswith("{")][0])
    snap = stats["explain"]
    assert snap["slots"] == 2
    assert snap["admitted"] == snap["completed"] + snap["dropped"]
    assert snap["completed"] > 0
    lane = stats["annotations"]
    assert lane["submitted"] == lane["annotated"] + lane["dropped"]
    assert stats["health"]["explain"]["slots"] == 2


def test_serve_cli_explain_slots_validation():
    with pytest.raises(SystemExit, match="onpod-family"):
        tserve.main(["--device", "cpu", "--model", "synthetic", "--demo",
                     "10", "--explain", "canned", "--explain-slots", "2"])
    with pytest.raises(SystemExit, match="explain-slots must be"):
        tserve.main(["--device", "cpu", "--model", "synthetic", "--demo",
                     "10", "--explain", "onpod-demo", "--explain-slots", "-1"])


def test_int8_model_serves_through_slots(lm):
    """The int8 model rides the same slot programs (``Q8`` weights through
    ``_mm`` and the int8 head), with the fixed-batch path's greedy replies."""
    q = lm.quantized()
    svc = make_service(q, slots=2, max_new_tokens=6)
    try:
        prompts = ["int8 row A", "int8 row B", "int8 row C"]
        out = svc.generate_batch(prompts, temperature=0.0, max_tokens=6)
        assert out == list(OnPodBackend.from_model(q).generate_batch(
            prompts, temperature=0.0, max_tokens=6))
        assert svc.snapshot()["completed"] == 3
    finally:
        assert svc.close()
