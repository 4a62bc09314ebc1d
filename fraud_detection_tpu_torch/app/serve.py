"""Streaming serve CLI — twin of ``fraud_detection_tpu/app/serve.py``: run
the micro-batching classifier against a broker on ``--device`` (the card
unless ``--device cpu``).

    # self-contained demo: an in-process broker fed with synthetic traffic
    python -m fraud_detection_tpu_torch.app.serve --model ./fraud_model \\
        --demo 5000 --batch-size 1024

    # real Kafka (the reference deployment's variables: KAFKA_BOOTSTRAP_SERVERS,
    # KAFKA_INPUT_TOPIC, KAFKA_CONSUMER_GROUP, KAFKA_SECURITY_PROTOCOL, ...)
    python -m fraud_detection_tpu_torch.app.serve --model ./fraud_model --kafka

    # three partition-owning workers behind the lease coordinator
    python -m fraud_detection_tpu_torch.app.serve --model synthetic \\
        --demo 8192 --fleet 3 --partitions 4

``--model`` is a native checkpoint directory (``checkpoint/native.py``,
written by either package), ``spark:<dir>``, a Spark ``PipelineModel``
save directory (``checkpoint/spark_artifact.py``, read with the port's own
parquet codec), or ``synthetic``: a logistic regression trained at startup
on the synthetic corpus. ``--registry`` serves a version
of a model registry instead (``registry/``): ``--watch`` hot-swaps newer
versions in, ``--shadow`` stages them beside the active model for shadow
scoring, ``--promote-policy`` promotes or rejects them, and ``--learn``
closes the loop (``learn/``: feedback labels joined against the scored
window, drift-triggered refreshes on the card published into the same
registry). ``--explain`` attaches analyses of flagged messages from a
language model on the card, inline or (``--explain-async``) onto an
annotations topic; ``--explain-slots`` serves them through the slotserve
continuous-batching lane (``--explain-paged``: over a paged KV pool with
the shared preamble prefilled once), and ``--breaker`` puts a circuit
breaker in front of the backend. ``--supervise N`` restarts a failed engine
from the committed offsets (``--chaos``: under a seeded fault plan, which
implies ``--supervise 25``); ``--trace`` traces rows from poll to terminal,
``--metrics-file``/``--metrics-port`` export every ``health()`` key
(Prometheus text or JSON, plus ``/healthz``), ``--health-file`` dumps the
engine's health, ``--alerts`` runs the sentinel's alert rules (incident
bundles under ``--incident-dir``), and ``--profile-dir`` captures a
``torch.profiler`` trace of the card's kernels over the first
``--profile-batches`` batches. ``--workers N`` runs N engines in one
consumer group; ``--fleet N`` runs N workers that own partition leases
behind the fleet coordinator (``fleet/``: ``--fleet-candidates`` for
coordinator succession, ``--autoscale`` between ``--min-workers`` and
``--max-workers``). ``--scenario NAME[:seed]`` feeds a catalog game day's
seeded traffic live instead of the uniform ``--demo`` preload and gates on
its SLOs (exit 4 on a violation); ``--trace-record FILE`` dumps the run as
a replayable recording (``scenarios/``). Every worker scores on the one shared pipeline, so on
the card N threads dispatch onto it at once. ``--mesh`` shards every
micro-batch over all local devices' data axis (``parallel/serving.py``;
one device falls back to the plain pipeline). ``--kafka`` consumes from
and produces to Kafka through ``stream/kafka.py`` (confluent_kafka, the
``KAFKA_*`` variables) instead of the in-process demo broker. By default the host featurizes
with the native C++ featurizer and the engine takes the raw-JSON path with
C++ frame assembly; ``--featurize-device`` ships raw bytes to the CUDA featurize
kernel instead.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time



def start_health_writer(path, interval, current_engines, fault_plan=None):
    """Launch the ``--health-file`` dumper: every ``interval`` seconds the
    current engines' ``health()`` snapshots are written to ``path`` by an
    atomic replace (readers never see a torn file). Returns ``finish()``,
    which stops the thread and writes the FINAL state — call it on every
    exit path, so the file on disk reflects how the run finished. A no-op
    finish when ``path`` is None."""
    if path is None:
        return lambda: None
    from fraud_detection_tpu_torch.utils.atomicio import atomic_write_json

    def dump():
        snap = {"time": time.time(),
                "engines": [e.health() for e in list(current_engines())
                            if e is not None]}
        if fault_plan is not None:
            snap["chaos"] = fault_plan.report()
        # A failed write is swallowed inside: health reporting never kills
        # serving.
        atomic_write_json(path, snap)

    stop = threading.Event()

    def loop():
        while not stop.wait(interval):
            dump()

    thread = threading.Thread(target=loop, daemon=True, name="health-writer")
    thread.start()

    def finish():
        stop.set()
        thread.join(timeout=5.0)
        dump()

    return finish


def build_pipeline(spec: str, batch_size: int, int8: bool = False,
                   featurize_device: bool = False, featurize_width=None,
                   device="cuda"):
    """A serving pipeline over the checkpoint directory ``spec``, the Spark
    ``PipelineModel`` directory of ``spark:<dir>``, or a logistic regression
    trained at startup on the synthetic corpus (``synthetic``)."""
    from fraud_detection_tpu_torch.models.pipeline import (
        ServingPipeline, synthetic_demo_pipeline)

    if spec.startswith("spark:"):
        from fraud_detection_tpu_torch.checkpoint.spark_artifact import (
            load_spark_pipeline)

        return ServingPipeline.from_spark_artifact(
            load_spark_pipeline(spec[len("spark:"):]), batch_size=batch_size,
            device=device, int8=int8, featurize_device=featurize_device,
            featurize_width=featurize_width)
    if spec == "synthetic":
        demo = synthetic_demo_pipeline(batch_size, device=device)
        return ServingPipeline(demo.featurizer, demo.model,
                               batch_size=batch_size, int8=int8,
                               featurize_device=featurize_device,
                               featurize_width=featurize_width, device=device)
    return ServingPipeline.from_checkpoint(
        spec, device=device, batch_size=batch_size, int8=int8,
        featurize_device=featurize_device, featurize_width=featurize_width)


def _judge_scenario(scenario, events, feeder, broker, args, out,
                    tracers) -> dict:
    """Evaluate a --scenario run's SLO gates from the serve-side evidence
    (broker key multisets + the exit stats/health). Scope is "serve":
    fleet-only gates (worker kills, hot swaps) report skipped — the full
    game-day runner owns those."""
    from fraud_detection_tpu_torch.scenarios import evaluate

    health = out.get("health") or {}
    dlq_topic = ((args.dlq_topic or f"{args.output_topic}-dlq")
                 if args.dlq else None)
    stats = {k: v for k, v in out.items() if isinstance(v, (int, float))}
    evidence = {
        "planned": len(events),
        "fed": feeder.fed,
        "fed_keys": [e.key.decode() for e in events],
        "out_keys": [m.key.decode()
                     for m in broker.messages(args.output_topic)
                     if m.key is not None],
        "dlq_keys": ([m.key.decode() for m in broker.messages(dlq_topic)
                      if m.key is not None] if dlq_topic else []),
        "stats": stats,
        "health": health,
        "sched": health.get("sched"),
        "breaker": health.get("breaker"),
        "chaos": out.get("chaos"),
        "traces": [t.snapshot() for t in tracers.values()],
        "tracing": bool(args.trace),
        "feeder": feeder.stats(),
        "errors": ([f"feeder: {feeder.error!r}"]
                   if feeder.error is not None else []),
    }
    evidence["shed_fraction"] = round(
        stats.get("shed", 0) / max(1, len(events)), 4)
    report = evaluate(scenario.slos, evidence, scope="serve")
    return {"name": scenario.name, "seed": scenario.seed, "ok": report.ok,
            "fed": feeder.fed, "planned": len(events),
            "verdicts": [v.as_dict() for v in report.verdicts]}


def _explain_lane(args):
    """The engine's ``explain_batch_fn`` for ``--explain``, the circuit
    breaker (``--breaker``) and the slotserve service (``--explain-slots``)
    behind it: ``(hook, breaker, service)``, None where off."""
    if args.explain == "off":
        return None, None, None
    from fraud_detection_tpu_torch.explain import make_stream_explain_hook
    from fraud_detection_tpu_torch.utils.config import LLMConfig

    try:
        llm_cfg = LLMConfig.from_env()
    except ValueError as e:
        raise SystemExit(f"bad LLM_* environment value: {e}")
    # An explicit LLM_TEMPERATURE wins; unset, deepseek keeps the reference
    # agent's 1.0 and local backends decode greedy.
    temp = (llm_cfg.temperature
            if args.explain == "deepseek" or "LLM_TEMPERATURE" in os.environ
            else 0.0)
    slot_lm = None     # the models/llm.py model --explain-slots serves
    if args.explain == "canned":
        from fraud_detection_tpu_torch.explain import CannedBackend

        backend = CannedBackend(responses=[
            "(offline analysis stub — run --explain onpod:<dir> or "
            "--explain deepseek for a real model)"])
    elif args.explain == "onpod-demo":
        # A tiny random-init on-device model: the real decode path, no
        # checkpoint; its analyses are noise (the name says so).
        from fraud_detection_tpu_torch.explain import OnPodBackend
        from fraud_detection_tpu_torch.models.llm import (LanguageModel,
                                                          TransformerConfig)

        slot_lm = LanguageModel.init_random(
            TransformerConfig(d_model=128, n_layers=2, n_heads=8, d_ff=256,
                              max_seq=2048), seed=0, device=args.device)
        backend = OnPodBackend.from_model(slot_lm)
    elif args.explain.startswith(("onpod:", "onpod-int8:")):
        from fraud_detection_tpu_torch.explain import OnPodBackend

        spec, _, ckpt = args.explain.partition(":")
        if not ckpt or not os.path.isdir(ckpt):
            raise SystemExit(
                f"--explain {spec}: checkpoint dir {ckpt!r} not found")
        try:
            from fraud_detection_tpu_torch.checkpoint.hf_convert import (
                load_hf_checkpoint)

            # loaded as the model, so that the slot lane serves the same
            # weights the backend does
            slot_lm = load_hf_checkpoint(ckpt, max_seq=4096,
                                         int8=spec == "onpod-int8",
                                         device=args.device)
            backend = OnPodBackend.from_model(slot_lm)
        except (OSError, ValueError, KeyError, NotImplementedError) as e:
            # a directory without config, weights or tokenizer is a
            # configuration error, not a crash
            raise SystemExit(f"--explain {spec}: cannot load {ckpt!r}: {e}")
    elif args.explain == "deepseek":
        if not llm_cfg.api_key:
            raise SystemExit("--explain deepseek needs DEEPSEEK_API_KEY")
        backend = llm_cfg.make_backend()
    else:
        raise SystemExit(f"unknown --explain spec {args.explain!r}")
    service = breaker = None
    if args.explain_slots > 0:
        # The service REPLACES the fixed-batch backend — same LLMBackend
        # surface, so the breaker below wraps it unchanged.
        from fraud_detection_tpu_torch.explain.slotserve import (
            SlotServeService)

        try:
            backend = service = SlotServeService(
                slot_lm, slots=args.explain_slots,
                max_queue=args.explain_queue,
                max_new_tokens=args.explain_tokens,
                paged=args.explain_paged,
                **({"kv_pages": args.explain_kv_pages}
                   if args.explain_kv_pages > 0 else {}))
        except ValueError as e:
            raise SystemExit(f"--explain-slots: {e}")
    if args.breaker > 0:
        # Wrapped BEFORE the hook is built, so every call path shares one
        # breaker and a dead backend fast-fails instead of stalling.
        from fraud_detection_tpu_torch.explain import CircuitBreakerBackend

        backend = breaker = CircuitBreakerBackend(
            backend, failure_threshold=args.breaker,
            probe_interval=args.breaker_probe)
    if service is not None:
        # Backend failures become accounted per-row markers: every flagged
        # row is explained or accounted on the annotations topic.
        from fraud_detection_tpu_torch.explain.slotserve import (
            make_slot_explain_hook)

        hook = make_slot_explain_hook(backend, temperature=temp,
                                      max_tokens=args.explain_tokens)
    else:
        hook = make_stream_explain_hook(backend, temperature=temp,
                                        max_tokens=args.explain_tokens)
    return hook, breaker, service


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None,
                    help="native checkpoint dir (checkpoint/native.py) | "
                         "spark:<artifact dir> | synthetic (train a demo LR "
                         "at startup)")
    ap.add_argument("--registry", default=None, metavar="DIR",
                    help="serve from a model registry "
                         "(registry/registry.py layout) instead of a fixed "
                         "--model; loads are content-hash verified")
    ap.add_argument("--model-version", type=int, default=None, metavar="N",
                    help="registry version to serve (--registry; "
                         "default: latest)")
    ap.add_argument("--watch", action="store_true",
                    help="poll --registry for new versions and hot-swap "
                         "them in with zero downtime (pre-warmed RCU swap "
                         "between batches; registry/hotswap.py)")
    ap.add_argument("--watch-interval", type=float, default=2.0,
                    help="seconds between registry polls (--watch)")
    ap.add_argument("--shadow", action="store_true",
                    help="stage new versions as shadow candidates instead "
                         "of swapping immediately: each micro-batch is "
                         "also scored by the candidate asynchronously and "
                         "divergence stats accumulate in health() "
                         "(registry/shadow.py; requires --watch)")
    ap.add_argument("--shadow-sample", type=float, default=1.0,
                    help="fraction of micro-batches shadow-scored "
                         "(--shadow)")
    ap.add_argument("--shadow-queue", type=int, default=8,
                    help="bounded shadow queue depth; overflow drops + "
                         "counts, never blocks the primary (--shadow)")
    ap.add_argument("--learn", action="store_true",
                    help="close the learning loop (learn/): join feedback "
                         "labels against a sliding window of scored rows, "
                         "retrain boosted trees on drift (on the card), "
                         "publish to --registry, auto-promote through the "
                         "--shadow/--promote-policy gates (requires all "
                         "three)")
    ap.add_argument("--learn-feedback-topic", default=None, metavar="TOPIC",
                    help="ground-truth label topic (stream/feedback.py "
                         "records; default <input-topic>-feedback)")
    ap.add_argument("--learn-window", type=int, default=8192,
                    help="learn window capacity in rows (--learn)")
    ap.add_argument("--learn-min-rows", type=int, default=256,
                    help="labeled rows required before any retrain")
    ap.add_argument("--learn-error-threshold", type=float, default=0.15,
                    help="drift trigger: recent label-error rate of the "
                         "live model above this fires a retrain")
    ap.add_argument("--learn-rounds", type=int, default=8,
                    help="warm-start boosting rounds per windowed retrain")
    ap.add_argument("--learn-interval", type=float, default=0.0,
                    help="retrain cadence in seconds (0 = drift/row "
                         "triggers only)")
    ap.add_argument("--promote-policy", default=None, metavar="SPEC",
                    help="auto promote/reject the staged candidate, e.g. "
                         "'min_batches=5,min_rows=200,max_disagreement="
                         "0.02,max_psi=0.25' (--shadow; every transition "
                         "is audited to <registry>/audit.jsonl)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; 'cpu' "
                         "runs the kernels' plain torch versions)")
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--max-wait", type=float, default=0.05,
                    help="micro-batch assembly deadline (seconds)")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="device batches kept in flight")
    ap.add_argument("--async-dispatch", action="store_true",
                    help="featurize+upload+launch batch N+1 on a dispatch "
                         "lane thread while batch N is delivered "
                         "(sched/batcher.py DispatchLane; counters in "
                         "health()['device'])")
    ap.add_argument("--int8", action="store_true",
                    help="int8 scoring (LogisticRegression models only)")
    ap.add_argument("--featurize-device", action="store_true",
                    help="ship raw UTF-8 bytes and featurize on the card "
                         "(the CUDA featurize_packed kernel, one launch a "
                         "chunk) instead of the native host featurizer")
    ap.add_argument("--featurize-width", type=int, default=None,
                    metavar="BYTES",
                    help="byte width of the --featurize-device staging "
                         "tensor (default 2048); longer rows truncate and "
                         "count in health()['device']['truncated_rows']")
    ap.add_argument("--batch-deadline-ms", type=float, default=None,
                    help="adaptive scheduler: ship a partial micro-batch "
                         "this many ms after its first row; partial batches "
                         "pad to a warmed bucket ladder")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="queue-depth high watermark (rows backlogged at "
                         "the broker) for a shedding --shed-policy")
    ap.add_argument("--shed-policy", default="none",
                    choices=["none", "reject", "adaptive"],
                    help="load shedding: 'none' never sheds (--max-rate "
                         "then paces polls), 'reject' sheds over "
                         "--max-queue/--max-rate, 'adaptive' also sheds "
                         "while p99 exceeds --target-p99-ms; shedding "
                         "implies --dlq")
    ap.add_argument("--target-p99-ms", type=float, default=None,
                    help="SLO target for per-row enqueue->produce p99")
    ap.add_argument("--max-rate", type=float, default=None,
                    help="token-bucket admission limit, rows/s")
    ap.add_argument("--kafka", action="store_true",
                    help="use real Kafka via confluent_kafka + KAFKA_* env vars")
    ap.add_argument("--demo", type=int, metavar="N", default=0,
                    help="feed N synthetic messages through an in-process "
                         "broker and exit")
    ap.add_argument("--input-topic", default=os.getenv("KAFKA_INPUT_TOPIC", "customer-dialogues-raw"))
    ap.add_argument("--output-topic", default=os.getenv("KAFKA_OUTPUT_TOPIC", "dialogues-classified"))
    ap.add_argument("--max-messages", type=int, default=None)
    ap.add_argument("--supervise", type=int, metavar="N", default=0,
                    help="restart the engine up to N times on crash/flush "
                         "failure (resumes from committed offsets; see "
                         "stream.engine.run_supervised; a fault of the card "
                         "is never restarted around)")
    ap.add_argument("--workers", type=int, default=1,
                    help="engines sharing ONE consumer group: each owns a "
                         "disjoint partition subset (the reference's "
                         "--partitions 3 scale-out unit); every worker "
                         "scores on the one shared pipeline")
    ap.add_argument("--fleet", type=int, metavar="N", default=0,
                    help="fleet serving lane (fleet/): N partition-OWNING "
                         "workers behind a lease coordinator — "
                         "revoke->drain->commit->reassign rebalance on "
                         "worker death, health on the fleet bus, shedding "
                         "coordinated on the GLOBAL backlog watermark "
                         "(demo mode; against real Kafka use --workers, "
                         "whose group assignor is broker-side)")
    ap.add_argument("--partitions", type=int, default=3,
                    help="in-process demo broker partition count (the "
                         "reference provisions --partitions 3; a fleet "
                         "scales to min(partitions, workers))")
    ap.add_argument("--fleet-health-file", default=None,
                    help="periodically dump the aggregated fleet view + "
                         "every worker's health to this path (atomic "
                         "replace; --fleet)")
    ap.add_argument("--fleet-candidates", type=int, metavar="K", default=1,
                    help="coordinator succession: K candidates contend on "
                         "the leased coordinator role over the control "
                         "lane, so the fleet survives its own coordinator "
                         "dying (K >= 2 arms standby successors; 1 = the "
                         "classic single coordinator; --fleet)")
    ap.add_argument("--autoscale", action="store_true",
                    help="closed-loop autoscaling: the fleet sizes itself "
                         "from its own sentinel signals — scale-out on "
                         "fleet_watermark_burn, voluntary-leave scale-in on "
                         "sustained fleet_idle, dead capacity replaced — "
                         "bounded by --min-workers/--max-workers. Needs "
                         "--fleet N (the starting size); without --alerts "
                         "there is no signal plane and the loop only "
                         "replaces dead workers")
    ap.add_argument("--min-workers", type=int, metavar="N", default=None,
                    help="autoscale floor (default: 1; --autoscale)")
    ap.add_argument("--max-workers", type=int, metavar="N", default=None,
                    help="autoscale ceiling (default: the larger of "
                         "--fleet and --partitions — a worker past the "
                         "partition count would sit idle; --autoscale)")
    ap.add_argument("--scale-cooldown", type=float, metavar="S",
                    default=30.0,
                    help="seconds between resizes — the anti-flap window; "
                         "hysteresis credits a burn that started during "
                         "it (--autoscale)")
    ap.add_argument("--explain", default="off", metavar="SPEC",
                    help="attach LLM analyses to flagged messages, batched "
                         "per micro-batch: 'off' | 'canned' (offline stub) | "
                         "'onpod-demo' (a tiny random model) | "
                         "'onpod:<hf checkpoint dir>' (on the card, "
                         "checkpoint/hf_convert.py; needs the dir's "
                         "tokenizer files and transformers) | "
                         "'onpod-int8:<dir>' (the same, weight-only int8) | "
                         "'deepseek' (env DEEPSEEK_API_KEY, the reference's "
                         "backend)")
    ap.add_argument("--explain-tokens", type=int, default=128,
                    help="max new tokens per analysis (--explain)")
    ap.add_argument("--explain-slots", type=int, metavar="N", default=0,
                    help="serve explanations through the slot-based "
                         "continuous-batching lane with N decode slots "
                         "over one persistent KV cache (0 = off; needs an "
                         "onpod-family --explain backend; implies "
                         "--explain-async — docs/explain_serving.md). "
                         "Every flagged row is explained or accounted, "
                         "and health() gains the 'explain' block")
    ap.add_argument("--explain-queue", type=int, default=1024,
                    help="slotserve admission-queue bound (--explain-slots; "
                         "overflow drops OLDEST with honest accounting)")
    ap.add_argument("--explain-paged", action="store_true",
                    help="page the slot lane's KV cache: fixed-size KV "
                         "pages behind a refcounted allocator, with the "
                         "shared explain preamble prefilled ONCE and "
                         "copy-on-write per admit (--explain-slots; "
                         "greedy outputs stay bit-equal to contiguous — "
                         "docs/explain_serving.md \"Paged KV and prefix "
                         "sharing\")")
    ap.add_argument("--explain-kv-pages", type=int, metavar="N", default=0,
                    help="cap the paged pool at N pages (--explain-paged; "
                         "0 = slots * pages-per-slot, the zero-preemption "
                         "default; smaller pools preempt the NEWEST admit "
                         "with a kv_pages_exhausted drop record)")
    ap.add_argument("--explain-async", action="store_true",
                    help="annotate flagged rows in the background onto "
                         "--annotations-topic instead of inline: "
                         "classification never waits for LLM decode "
                         "(bounded queue, drop-oldest under overload; "
                         "stream/annotations.py)")
    ap.add_argument("--annotations-topic", default=None,
                    help="side topic for --explain-async records "
                         "(default: <output-topic>-annotations)")
    ap.add_argument("--dlq", action="store_true",
                    help="route malformed and repeatedly failing messages "
                         "to <output-topic>-dlq as structured records")
    ap.add_argument("--dlq-topic", default=None,
                    help="dead-letter topic name (implies --dlq)")
    ap.add_argument("--dlq-max-attempts", type=int, default=3,
                    help="re-deliveries before a row is dead-lettered")
    ap.add_argument("--breaker", type=int, metavar="N", default=0,
                    help="wrap the --explain backend in a circuit breaker "
                         "that opens after N consecutive failures (0 = off; "
                         "open = explanations fast-fail instead of paying "
                         "the backend's timeout/retry budget)")
    ap.add_argument("--breaker-probe", type=float, default=30.0,
                    help="seconds an open breaker waits before probing the "
                         "backend again (--breaker)")
    ap.add_argument("--health-file", default=None,
                    help="periodically dump an engine-health JSON snapshot "
                         "to this path (atomic replace; final state written "
                         "at exit)")
    ap.add_argument("--health-interval", type=float, default=2.0,
                    help="seconds between --health-file dumps")
    ap.add_argument("--metrics-file", default=None,
                    help="periodically dump the unified metrics exporter "
                         "to this path (atomic replace, final state at "
                         "exit, exactly like --health-file): Prometheus "
                         "text for .prom/.txt paths, JSON otherwise — "
                         "every health() key maps in, ONE schema")
    ap.add_argument("--metrics-interval", type=float, default=2.0,
                    help="seconds between --metrics-file dumps")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve /metrics (Prometheus text), /metrics.json, "
                         "and /healthz (readiness: 200, or 503 with the "
                         "firing rule names while a critical alert fires — "
                         "--alerts) on this local port (stdlib HTTP, "
                         "daemon thread; 0 picks a free port, printed at "
                         "startup)")
    ap.add_argument("--alerts", action="store_true",
                    help="run the sentinel alerting engine (obs/sentinel/): "
                         "the default rule pack (shed/DLQ burn rates, "
                         "breaker opens, p99 SLO burn, dispatch stall, span "
                         "leaks, fence events, restart churn) evaluates "
                         "against live engine health; firing state rides "
                         "health()['alerts'], the exit stats JSON, "
                         "/metrics, and /healthz")
    ap.add_argument("--alert-rules", default=None, metavar="FILE",
                    help="JSON alert-rule file replacing the default pack; "
                         "implies --alerts")
    ap.add_argument("--alert-interval", type=float, default=1.0,
                    help="seconds between sentinel evaluations (--alerts)")
    ap.add_argument("--incident-dir", default=None, metavar="DIR",
                    help="flight-recorder output (implies --alerts): every "
                         "alert transition appends to DIR/incidents.jsonl "
                         "and a firing incident captures a bundle dir "
                         "(evidence window, metric deltas, health, "
                         "implicated trace chains)")
    ap.add_argument("--trace", action="store_true",
                    help="row/batch tracing (obs/trace.py): correlation "
                         "ids minted at poll ride every row to its "
                         "terminal; flagged/shed/DLQ rows always keep "
                         "their span chain, clean batches head-sample at "
                         "--trace-sample; per-stage p50/p99 in health() "
                         "and the exporter")
    ap.add_argument("--trace-sample", type=float, default=0.05,
                    help="fraction of CLEAN batches whose spans are kept "
                         "(--trace; interesting batches are always kept)")
    ap.add_argument("--trace-record", default=None, metavar="FILE",
                    help="record this run for replay: tracing runs in "
                         "record mode (sample forced to 1.0 + a per-batch "
                         "row census) and the SpanRing dumps to FILE as "
                         "JSONL at exit via the atomic writer; replay with "
                         "python -m fraud_detection_tpu_torch.scenarios."
                         "replay. Implies --trace; single worker only")
    ap.add_argument("--scenario", default=None, metavar="NAME[:seed]",
                    help="drive a named scenario's seeded traffic against "
                         "this live serve run instead of the uniform "
                         "--demo preload, then gate on the scenario's "
                         "SLOs (exit 4 on violation; scenario catalog: "
                         "python -m fraud_detection_tpu_torch.scenarios."
                         "gameday --list). Engine config still comes from "
                         "the serve flags; fleet-only gates (worker kills, "
                         "hot swaps) report as skipped — run the full "
                         "game day via the gameday CLI. Needs --demo")
    ap.add_argument("--scenario-scale", type=float, default=1.0,
                    help="traffic-rate multiplier for --scenario")
    ap.add_argument("--scenario-time-scale", type=float, default=1.0,
                    help="timeline pacing for --scenario: 1 = the "
                         "scenario's real-time curve (default), 0 = warp "
                         "(feed as fast as the engine drains)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture torch.profiler traces (the card's kernels "
                         "and the host's ops): one around prewarm/ladder "
                         "measurement, one over the first --profile-batches "
                         "serving batches (Chrome/Perfetto .trace.json)")
    ap.add_argument("--profile-batches", type=int, default=50,
                    help="batches in the serving-window profiler capture "
                         "(--profile-dir)")
    ap.add_argument("--chaos", action="store_true",
                    help="demo mode only: run the in-process broker under a "
                         "seeded fault plan (poll errors, lossy flushes, "
                         "commit fences, duplicates, corruption) to "
                         "demonstrate graceful degradation; implies "
                         "supervision (stream/faults.py)")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="fault-plan seed (--chaos; same seed = same "
                         "fault schedule)")
    ap.add_argument("--mesh", action="store_true",
                    help="mesh data-parallel scoring (parallel/serving.py "
                         "MeshServingPipeline): shard every micro-batch "
                         "across all local devices' data axis — one worker "
                         "drives the whole mesh; one device falls back to "
                         "the plain pipeline")
    args = ap.parse_args(argv)

    if args.kafka and args.demo:
        raise SystemExit("--kafka and --demo are mutually exclusive")
    if (args.model is None) == (args.registry is None):
        raise SystemExit("choose exactly one of --model or --registry")
    if args.registry is None and (args.model_version is not None or args.watch
                                  or args.shadow):
        raise SystemExit("--model-version/--watch/--shadow need --registry")
    if args.shadow and not args.watch:
        raise SystemExit("--shadow needs --watch (candidates arrive via "
                         "registry polling)")
    if args.promote_policy is not None and not args.shadow:
        raise SystemExit("--promote-policy needs --shadow (there is no "
                         "candidate to judge without shadow scoring)")
    if args.learn:
        # The loop's whole contract is publish -> stage -> shadow-judge ->
        # auto-promote, so every leg must be wired explicitly.
        if not (args.registry and args.watch and args.shadow
                and args.promote_policy):
            raise SystemExit(
                "--learn closes the loop through the registry lifecycle: "
                "it requires --registry, --watch, --shadow AND "
                "--promote-policy (docs/online_learning.md)")
        if args.learn_min_rows < 2 or args.learn_rounds < 1 \
                or args.learn_window < 2:
            raise SystemExit("--learn-min-rows/--learn-rounds/"
                             "--learn-window must be positive")
    if args.watch_interval <= 0:
        raise SystemExit(
            f"--watch-interval must be > 0, got {args.watch_interval}")
    if not 0.0 < args.shadow_sample <= 1.0:
        raise SystemExit(
            f"--shadow-sample must be in (0, 1], got {args.shadow_sample}")
    if args.shadow_queue < 1:
        raise SystemExit(
            f"--shadow-queue must be >= 1, got {args.shadow_queue}")
    promote_policy = None
    if args.promote_policy is not None:
        from fraud_detection_tpu_torch.registry import PromotionPolicy

        try:
            promote_policy = PromotionPolicy.parse(args.promote_policy)
        except ValueError as e:
            raise SystemExit(f"bad --promote-policy: {e}")
    if args.int8 and args.registry:
        # Registry candidates (watch/hot-swap) are rebuilt by the watcher,
        # which would silently serve them fp32 — refuse rather than mix
        # scoring variants across swaps.
        raise SystemExit("--int8 is not supported with --registry yet "
                         "(hot-swap candidates would load fp32)")
    if args.featurize_device and args.registry:
        # Same reasoning as --int8: the watcher rebuilds candidates without
        # the flag, which would silently flip the featurize path at swap.
        raise SystemExit("--featurize-device is not supported with "
                         "--registry yet (hot-swap candidates would load "
                         "host-featurizing)")
    if args.featurize_width is not None and not args.featurize_device:
        raise SystemExit("--featurize-width needs --featurize-device")
    if args.pipeline_depth < 1:
        raise SystemExit(f"--pipeline-depth must be >= 1, got {args.pipeline_depth}")
    if args.workers < 1:
        raise SystemExit(f"--workers must be >= 1, got {args.workers}")
    if args.explain_tokens < 1:
        raise SystemExit(f"--explain-tokens must be >= 1, got {args.explain_tokens}")
    if args.explain_slots < 0:
        raise SystemExit(
            f"--explain-slots must be >= 0, got {args.explain_slots}")
    if args.explain_queue < 1:
        raise SystemExit(
            f"--explain-queue must be >= 1, got {args.explain_queue}")
    if args.explain_slots > 0:
        if not args.explain.startswith("onpod"):
            raise SystemExit(
                "--explain-slots needs an onpod-family --explain backend "
                "(onpod:<dir>, onpod-int8:<dir>, or onpod-demo) — the slot "
                "lane serves a models/llm.py model from this pod")
        # The slot lane IS the async configuration: classification never
        # waits for decode, annotations ride the side topic.
        args.explain_async = True
    if args.explain_paged and args.explain_slots < 1:
        raise SystemExit(
            "--explain-paged pages the slotserve lane's KV cache — it "
            "needs --explain-slots")
    if args.explain_kv_pages < 0:
        raise SystemExit(
            f"--explain-kv-pages must be >= 0, got {args.explain_kv_pages}")
    if args.explain_kv_pages > 0 and not args.explain_paged:
        raise SystemExit(
            "--explain-kv-pages caps the paged pool; set --explain-paged")
    if args.explain_async and args.explain == "off":
        raise SystemExit("--explain-async needs an --explain backend")
    if args.annotations_topic is not None and not args.explain_async:
        raise SystemExit("--annotations-topic only applies with "
                         "--explain-async (inline analyses ride the "
                         "output frames)")
    if args.fleet < 0:
        raise SystemExit(f"--fleet must be >= 0, got {args.fleet}")
    if args.partitions < 1:
        raise SystemExit(f"--partitions must be >= 1, got {args.partitions}")
    if args.fleet > 0:
        if not args.demo:
            raise SystemExit(
                "--fleet needs --demo N (the lease coordinator drives the "
                "in-process broker's manual-assignment mode; against real "
                "Kafka use --workers — its group assignor is broker-side)")
        if args.workers > 1:
            raise SystemExit("--fleet and --workers > 1 are mutually "
                             "exclusive (two assignment authorities)")
        if args.registry or args.explain != "off" or args.chaos:
            raise SystemExit("--fleet does not combine with --registry/"
                             "--explain/--chaos yet (docs/fleet.md)")
        if args.supervise:
            raise SystemExit("--fleet supervises itself (lease expiry + "
                             "rebalance); drop --supervise")
        if args.max_messages is not None:
            raise SystemExit("--max-messages cannot be split across a "
                             "fleet; workers drain until the group's "
                             "committed lag clears")
    if args.mesh and args.registry is not None:
        raise SystemExit("--mesh is not supported with --registry yet "
                         "(hot-swap candidates would load single-device)")
    if args.fleet_health_file is not None and args.fleet == 0:
        raise SystemExit("--fleet-health-file needs --fleet N")
    if args.fleet_candidates < 1:
        raise SystemExit(f"--fleet-candidates must be >= 1, "
                         f"got {args.fleet_candidates}")
    if args.fleet_candidates > 1 and args.fleet == 0:
        raise SystemExit("--fleet-candidates needs --fleet N")
    if (args.min_workers is not None or args.max_workers is not None) \
            and not args.autoscale:
        raise SystemExit("--min-workers/--max-workers need --autoscale")
    autoscale_config = None
    if args.autoscale:
        # Closed-loop elasticity rides the in-process fleet lane only: the
        # provisioner spawns THREADS against the demo broker.
        if args.fleet == 0:
            raise SystemExit("--autoscale needs --fleet N (the elastic "
                             "lane; docs/autoscaling.md)")
        lo = args.min_workers if args.min_workers is not None else 1
        hi = (args.max_workers if args.max_workers is not None
              else max(args.fleet, args.partitions))
        if lo < 1:
            raise SystemExit(f"--min-workers must be >= 1, got {lo}")
        if not lo <= args.fleet <= hi:
            raise SystemExit(
                f"--fleet {args.fleet} must sit within the autoscale "
                f"bounds [{lo}, {hi}] (--min-workers/--max-workers)")
        if args.scale_cooldown < 0:
            raise SystemExit(f"--scale-cooldown must be >= 0, "
                             f"got {args.scale_cooldown}")
        autoscale_config = dict(min_workers=lo, max_workers=hi,
                                cooldown_s=args.scale_cooldown)
    if args.workers > 1 and args.max_messages is not None:
        # A global message cap cannot be split across workers: refuse before
        # the pipeline build, like every other config conflict above.
        raise SystemExit(
            "--max-messages cannot be split across --workers > 1; "
            "drop one of the two (workers drain until idle)")
    if args.chaos and not args.demo:
        raise SystemExit("--chaos needs --demo N (faults are injected into "
                         "the in-process broker; against real Kafka use a "
                         "real chaos tool)")
    sched_config = None
    if (args.batch_deadline_ms is not None or args.max_queue is not None
            or args.shed_policy != "none" or args.target_p99_ms is not None
            or args.max_rate is not None):
        from fraud_detection_tpu_torch.sched import SchedulerConfig

        try:
            sched_config = SchedulerConfig(
                batch_deadline_ms=args.batch_deadline_ms,
                max_queue=args.max_queue,
                shed_policy=args.shed_policy,
                target_p99_ms=args.target_p99_ms,
                max_rate=args.max_rate)
        except ValueError as e:
            raise SystemExit(f"bad scheduler config: {e}")
        if args.shed_policy != "none":
            # shed rows are DLQ records by contract
            args.dlq = True
    if args.dlq_topic is not None:
        args.dlq = True
    if args.dlq_max_attempts < 1:
        raise SystemExit(
            f"--dlq-max-attempts must be >= 1, got {args.dlq_max_attempts}")
    if args.breaker < 0:
        raise SystemExit(f"--breaker must be >= 0, got {args.breaker}")
    if args.breaker > 0 and args.explain == "off":
        raise SystemExit("--breaker needs an --explain backend")
    if args.breaker_probe <= 0:
        raise SystemExit(
            f"--breaker-probe must be > 0, got {args.breaker_probe}")
    if args.health_interval <= 0:
        raise SystemExit(
            f"--health-interval must be > 0, got {args.health_interval}")
    if args.metrics_interval <= 0:
        raise SystemExit(
            f"--metrics-interval must be > 0, got {args.metrics_interval}")
    if args.metrics_port is not None and args.metrics_port < 0:
        raise SystemExit(
            f"--metrics-port must be >= 0, got {args.metrics_port}")
    if not 0.0 <= args.trace_sample <= 1.0:
        raise SystemExit(
            f"--trace-sample must be in [0, 1], got {args.trace_sample}")
    if args.alert_rules is not None or args.incident_dir is not None:
        args.alerts = True
    if args.alert_interval <= 0:
        raise SystemExit(
            f"--alert-interval must be > 0, got {args.alert_interval}")
    alert_rules = None
    if args.alerts:
        from fraud_detection_tpu_torch.obs.sentinel import (default_rule_pack,
                                                            load_rules)

        if args.alert_rules is not None:
            try:
                alert_rules = load_rules(args.alert_rules)
            except (OSError, ValueError) as e:
                raise SystemExit(f"bad --alert-rules: {e}")
        else:
            alert_rules = default_rule_pack()
    if args.trace_record is not None:
        # Record mode: full sampling + the per-batch row census, one ring.
        if args.workers > 1 or args.fleet > 0:
            raise SystemExit("--trace-record supports a single worker "
                             "only (one recording = one worker's ring)")
        args.trace = True
    scenario = None
    if args.scenario is not None:
        if not args.demo:
            raise SystemExit("--scenario needs --demo N (traffic is fed "
                             "into the in-process broker; N is ignored — "
                             "the scenario defines the rows)")
        if args.workers > 1 or args.fleet > 0:
            raise SystemExit("--scenario drives a single serve worker; "
                             "run multi-worker scenarios via "
                             "python -m fraud_detection_tpu_torch.scenarios."
                             "gameday")
        if args.scenario_scale <= 0:
            raise SystemExit(f"--scenario-scale must be > 0, "
                             f"got {args.scenario_scale}")
        if args.scenario_time_scale < 0:
            raise SystemExit(f"--scenario-time-scale must be >= 0, "
                             f"got {args.scenario_time_scale}")
        from fraud_detection_tpu_torch.scenarios import (get_scenario,
                                                         parse_scenario_ref)

        try:
            name, scenario_seed = parse_scenario_ref(args.scenario)
            scenario = get_scenario(name, scenario_seed,
                                    scale=args.scenario_scale)
        except (KeyError, ValueError) as e:
            raise SystemExit(f"bad --scenario: {e}")
    if args.profile_batches < 1:
        raise SystemExit(
            f"--profile-batches must be >= 1, got {args.profile_batches}")
    if args.chaos and args.supervise == 0:
        # Chaos without supervision dies on the first injected fault by
        # design; enough restarts for the demo plan's budget.
        args.supervise = 25
    if not args.kafka and args.demo <= 0:
        raise SystemExit("choose --kafka or --demo N (no broker specified)")

    from fraud_detection_tpu_torch.stream import (InProcessBroker,
                                                  StreamingClassifier)
    from fraud_detection_tpu_torch.stream.kafka import kafka_available
    from fraud_detection_tpu_torch.utils.tracing import device_trace

    if args.kafka and not kafka_available():
        raise SystemExit("confluent_kafka is not installed; cannot use --kafka")

    explain_hook, breaker, explain_service = _explain_lane(args)
    registry = shadow = None
    if args.registry is not None:
        from fraud_detection_tpu_torch.registry import (HotSwapPipeline,
                                                        ModelRegistry,
                                                        RegistryError,
                                                        ShadowScorer)

        registry = ModelRegistry(args.registry)
        try:
            mv, inner = registry.load(args.model_version,
                                      batch_size=args.batch_size,
                                      device=args.device)
        except RegistryError as e:   # RegistryIntegrityError included
            raise SystemExit(f"--registry: {e}")
        pipe = HotSwapPipeline(inner, version=mv.version)
        model_desc = f"registry:{args.registry}@{mv.name}"
        if args.shadow:
            shadow = ShadowScorer(max_queue=args.shadow_queue,
                                  sample=args.shadow_sample)
    else:
        pipe = build_pipeline(args.model, args.batch_size, int8=args.int8,
                              featurize_device=args.featurize_device,
                              featurize_width=args.featurize_width,
                              device=args.device)
        model_desc = args.model
    if args.mesh:
        # Shard micro-batches over every local device's data axis
        # (parallel/serving.py). --batch-size stays the GLOBAL micro-batch;
        # each device scores its 1/dp share. One device builds the plain
        # pipeline, so --mesh is safe to leave on everywhere.
        from fraud_detection_tpu_torch.parallel.serving import (
            MeshServingPipeline, local_device_count)

        dp = local_device_count(pipe.device.type)
        pipe = MeshServingPipeline.from_pipeline(
            pipe, per_chip_batch=max(1, args.batch_size // max(1, dp)))
        model_desc = f"{model_desc} (mesh x{pipe.data_parallel or 1})"
    model_desc = (f"{model_desc} "
                  f"(featurize={pipe.device_stats.featurize_path})")

    sched_ladder_costs = None
    if sched_config is not None:
        import dataclasses

        from fraud_detection_tpu_torch.sched import AdaptiveScheduler

        # Measure the candidate rungs and warm the selected ladder ONCE,
        # before any engine runs (off the hot path). The measured ladder is
        # pinned back into the config, so every worker's scheduler (built
        # later, one per worker) agrees with the shapes the pipeline warmed,
        # and each gets a copy of the cost table for health(). A
        # HotSwapPipeline keeps the ladder and cost table for every later
        # swap candidate. --profile-dir gives the measurement a profiler
        # capture of its own.
        prewarmer = AdaptiveScheduler(sched_config, args.batch_size)
        with device_trace("prewarm", args.profile_dir, device=pipe.device):
            prewarmer.prewarm(pipe)
        sched_config = dataclasses.replace(sched_config,
                                           buckets=tuple(prewarmer.buckets))
        sched_ladder_costs = prewarmer.ladder_costs

    from fraud_detection_tpu_torch.data import generate_corpus

    broker = None
    scenario_events = scenario_feeder = None
    if args.kafka:
        from fraud_detection_tpu_torch.stream.kafka import (KafkaConsumer,
                                                            KafkaProducer)

        def make_clients():
            return KafkaConsumer([args.input_topic]), KafkaProducer()

        make_producer = KafkaProducer
        max_messages, idle = args.max_messages, None
    elif scenario is not None:
        broker = InProcessBroker(num_partitions=args.partitions)
        # Scenario traffic: the seeded timeline feeds the broker LIVE from
        # the scenario-feeder thread while the engine serves — shaped
        # curves and campaign waves instead of a uniform preload. Chaos
        # (--chaos) composes on top.
        from fraud_detection_tpu_torch.scenarios import (ScenarioClock,
                                                         TrafficFeeder,
                                                         compose)

        scenario_clock = ScenarioClock(
            scenario.seed, time_scale=args.scenario_time_scale)
        scenario_events = compose(scenario.traffic, scenario_clock)
        scenario_feeder = TrafficFeeder(
            broker.producer(), args.input_topic, scenario_events,
            scenario_clock)
        scenario_feeder.start()
        max_messages = args.max_messages
        gaps = [b - a for a, b in zip([e.t for e in scenario_events],
                                      [e.t for e in scenario_events][1:])]
        idle = max(1.0, 2.0 * args.scenario_time_scale
                   * max(gaps, default=0.0))
    else:
        broker = InProcessBroker(num_partitions=args.partitions)
        feeder = broker.producer()
        corpus = generate_corpus(n=min(args.demo, 2000), seed=123)
        for i in range(args.demo):
            d = corpus[i % len(corpus)]
            feeder.produce(args.input_topic,
                           json.dumps({"text": d.text, "id": i}).encode(),
                           key=str(i).encode())
        max_messages = (args.max_messages if args.max_messages is not None
                        else args.demo)
        idle = 1.0
    dlq_topic = ((args.dlq_topic or f"{args.output_topic}-dlq")
                 if args.dlq else None)

    if broker is not None:
        def make_clients():
            return (broker.consumer([args.input_topic], "serve-demo"),
                    broker.producer())

        make_producer = broker.producer

    fault_plan = None
    if args.chaos:
        # One plan shared by every incarnation: its single seeded draw
        # stream is what makes the fault schedule reproducible, and its
        # budget guarantees convergence once spent.
        from fraud_detection_tpu_torch.stream.faults import FaultPlan

        fault_plan = FaultPlan.demo(seed=args.chaos_seed)
        plain_clients = make_clients

        def make_clients():
            cons, prod = plain_clients()
            return fault_plan.consumer(cons), fault_plan.producer(prod)

    learn_loop = None
    if args.learn:
        # Closed learning loop (learn/): the learn-lane thread joins
        # feedback labels against the scored-row window and publishes
        # drift-corrected candidates into the SAME registry the --watch
        # lifecycle promotes from.
        from fraud_detection_tpu_torch.learn import LearnConfig, LearnLoop

        feedback_topic = (args.learn_feedback_topic
                          or f"{args.input_topic}-feedback")
        if args.kafka:
            from fraud_detection_tpu_torch.stream.kafka import KafkaConsumer

            feedback_consumer = KafkaConsumer([feedback_topic])
        else:
            feedback_consumer = broker.consumer([feedback_topic], "learn")
        learn_loop = LearnLoop(
            feedback_consumer=feedback_consumer,
            registry=registry, hotswap=pipe, shadow=shadow,
            config=LearnConfig(
                window=args.learn_window,
                min_labeled=args.learn_min_rows,
                error_threshold=args.learn_error_threshold,
                refresh_rounds=args.learn_rounds,
                interval_s=(args.learn_interval
                            if args.learn_interval > 0 else None)))

    # Unified metrics exporter: one registry, health() mapped in as a
    # collector, published by file and/or HTTP.
    metrics_registry = None
    if args.metrics_file is not None or args.metrics_port is not None:
        from fraud_detection_tpu_torch.obs import MetricsRegistry

        metrics_registry = MetricsRegistry()

    def start_metrics(healthz_fn=None):
        """Start the --metrics-file writer and the --metrics-port endpoint;
        returns finish(). ``healthz_fn`` wires the sentinel's readiness
        verdict into /healthz."""
        if metrics_registry is None:
            return lambda: None
        from fraud_detection_tpu_torch.obs.export import (MetricsServer,
                                                          start_metrics_writer)

        server = None
        if args.metrics_port is not None:
            server = MetricsServer(metrics_registry, args.metrics_port,
                                   healthz_fn=healthz_fn)
            print(f"metrics: http://127.0.0.1:{server.port}/metrics",
                  flush=True)
        finish_file = start_metrics_writer(args.metrics_file,
                                           args.metrics_interval,
                                           metrics_registry)

        def finish():
            finish_file()
            if server is not None:
                server.close()

        return finish

    # Row tracing and alerting: one tracer and one sentinel per worker,
    # shared across that worker's supervised incarnations (like its DLQ
    # poison tracker and its scheduler), so chains and incident accounting
    # survive restarts, but never across workers, which own disjoint
    # partitions. Each sentinel reads a chain-cumulative health source whose
    # counters survive restarts and whose supervisor.restarts feeds the
    # restart-churn rule. The fleet wires its own coordinator-level
    # sentinel through Fleet.in_process instead.
    trace_per_worker: dict = {}
    sentinel_per_worker: dict = {}
    sentinel_sources: dict = {}

    def rowtrace_for(worker: int):
        if not args.trace:
            return None
        from fraud_detection_tpu_torch.obs import RowTracer

        tr = trace_per_worker.get(worker)
        if tr is None:
            record = args.trace_record is not None
            tr = trace_per_worker[worker] = RowTracer(
                worker=f"w{worker}",
                # Record mode: keep everything (sample 1.0 + row census)
                # in a ring sized for a whole demo run, so the dumped
                # recording is complete and exactly replayable.
                sample=1.0 if record else args.trace_sample,
                capacity=65536 if record else 4096,
                record_rows=record)
        return tr

    def sentinel_for(worker: int):
        if alert_rules is None or args.fleet > 0:
            return None
        from fraud_detection_tpu_torch.obs.sentinel import (
            ChainedHealthSource, IncidentRecorder, Sentinel)

        s = sentinel_per_worker.get(worker)
        if s is None:
            source = sentinel_sources[worker] = ChainedHealthSource()
            recorder = (IncidentRecorder(args.incident_dir,
                                         rowtrace=rowtrace_for(worker))
                        if args.incident_dir is not None else None)
            s = sentinel_per_worker[worker] = Sentinel(
                source, alert_rules, recorder=recorder, worker=f"w{worker}")
        return s

    def sentinels_healthz():
        """Readiness across every worker's sentinel: not ready while ANY
        critical alert fires anywhere."""
        firing = []
        for s in sentinel_per_worker.values():
            firing.extend(s.critical_firing())
        return (not firing, sorted(set(firing)))

    if explain_service is not None and args.trace and args.workers == 1:
        # Completed explanations land per-row "explain" spans (slot id and
        # admission wait) on the single worker's chains. Multi-worker runs
        # keep lane-level spans only: one service serves every worker, and
        # a row's span must not land on another worker's tracer.
        explain_service.set_rowtrace(rowtrace_for(0))

    def lane_faults():
        """Device faults that stopped a lifecycle or explanation lane (the
        run then exits 1)."""
        faults = [(name, lane.fault) for name, lane in (
            ("learn", learn_loop), ("watcher", lifecycle), ("shadow", shadow),
            ("slotserve", explain_service))
            if lane is not None and lane.fault is not None]
        for name, fault in faults:
            print(f"the {name} lane stopped on a device fault: {fault!r}",
                  file=sys.stderr)
        return faults

    lifecycle = None
    if args.fleet > 0:
        # Fleet serving lane (fleet/): N partition-owning workers under the
        # lease coordinator, health on the fleet bus, shedding on the global
        # backlog watermark, every worker scoring on the one shared
        # pipeline. Drains until the group's committed lag clears, then
        # exits with the merged fleet stats.
        from fraud_detection_tpu_torch.featurize import native
        from fraud_detection_tpu_torch.fleet import Fleet

        # Build the native featurizer's library now (g++ at first use):
        # a worker stuck in that build would stop heartbeating, lose its
        # lease and see its first batch replayed by the next owner.
        native.available()
        fleet_sentinel_kw = {}
        if args.alerts:
            # Coordinator-level fleet rules + per-worker engine sentinels
            # riding the bus.
            from fraud_detection_tpu_torch.obs.sentinel import (
                IncidentRecorder, fleet_rule_pack)

            fleet_sentinel_kw = dict(
                sentinel_rules=(alert_rules if args.alert_rules is not None
                                else fleet_rule_pack()),
                sentinel_recorder=(
                    IncidentRecorder(args.incident_dir)
                    if args.incident_dir is not None else None))
        fleet = Fleet.in_process(
            broker, pipe, args.input_topic, args.output_topic, args.fleet,
            batch_size=args.batch_size, max_wait=args.max_wait,
            pipeline_depth=args.pipeline_depth,
            async_dispatch=args.async_dispatch,
            sched_config=sched_config, dlq_topic=dlq_topic,
            health_file=args.fleet_health_file,
            candidates=args.fleet_candidates,
            autoscale=autoscale_config,
            trace=args.trace, trace_sample=args.trace_sample,
            **fleet_sentinel_kw)
        if metrics_registry is not None:
            metrics_registry.add_collector("fleet", fleet.fleet_health)
        finish_metrics = start_metrics(
            healthz_fn=(fleet.sentinel.healthz
                        if fleet.sentinel is not None else None))
        print(f"serving: model={model_desc} in={args.input_topic} "
              f"out={args.output_topic} batch={args.batch_size} "
              f"fleet={args.fleet} partitions={args.partitions} "
              f"device={pipe.device}", flush=True)
        try:
            out = fleet.run(idle_timeout=1.0)
        finally:
            finish_metrics()
        print(json.dumps(out))
        n_out = broker.topic_size(args.output_topic)
        print(f"classified messages on {args.output_topic}: {n_out}")
        return 1 if out["errors"] else 0

    engines_built = []   # LIVE engines only: a replaced one is harvested
    # Lane counters of engines already replaced and closed.
    annotations_harvested = {"submitted": 0, "annotated": 0, "dropped": 0,
                             "drop_records": 0, "backend_errors": 0}
    dlq_trackers: dict = {}
    sched_per_worker: dict = {}

    def make_engine(replacing=None, worker=0):
        """Build an engine; ``replacing`` is the previous incarnation on a
        supervised restart: its async annotation lane is drained (briefly)
        and stopped so restarts do not accumulate lane threads, its lane
        counters are harvested into the exit aggregate and the dead engine
        is dropped. The DLQ poison tracker, the scheduler, the tracer and
        the sentinel are shared across one WORKER's incarnations (which run
        one after another, so the one-thread contracts hold) but never
        across workers."""
        if replacing is not None:
            replacing.close_annotations(timeout=5.0)
            harvested = replacing.annotation_stats()
            if harvested:
                for k in annotations_harvested:
                    annotations_harvested[k] += harvested.get(k, 0)
            try:
                engines_built.remove(replacing)
            except ValueError:
                pass
        dlq_attempts = (dlq_trackers.setdefault(worker, {})
                        if dlq_topic is not None else None)
        scheduler = None
        if sched_config is not None:
            from fraud_detection_tpu_torch.sched import AdaptiveScheduler

            scheduler = sched_per_worker.get(worker)
            if scheduler is None:
                scheduler = AdaptiveScheduler(sched_config, args.batch_size)
                # The startup measurement's per-rung cost table, reported
                # in each worker's health().
                scheduler.ladder_costs = (dict(sched_ladder_costs)
                                          if sched_ladder_costs else None)
                sched_per_worker[worker] = scheduler
        consumer, producer = make_clients()
        engine = StreamingClassifier(
            pipe, consumer, producer, args.output_topic,
            batch_size=args.batch_size, max_wait=args.max_wait,
            pipeline_depth=args.pipeline_depth, explain_batch_fn=explain_hook,
            dlq_topic=dlq_topic, dlq_max_attempts=args.dlq_max_attempts,
            dlq_attempts=dlq_attempts,
            scheduler=scheduler, async_dispatch=args.async_dispatch,
            shadow=shadow, learn=learn_loop, explain_async=args.explain_async,
            annotations_topic=args.annotations_topic,
            annotations_producer=(make_producer() if args.explain_async
                                  else None),
            breaker=breaker, explain_service=explain_service,
            rowtrace=rowtrace_for(worker), sentinel=sentinel_for(worker))
        engines_built.append(engine)
        source = sentinel_sources.get(worker)
        if source is not None:
            # Fold the replaced incarnation's counters into the chain.
            source.attach(engine)
        return engine

    def live_health():
        return engines_built[-1].health() if engines_built else None

    def start_alerting():
        """Build every worker's sentinel and start the ONE "sentinel"
        evaluation thread; returns finish() (a no-op without --alerts)."""
        if alert_rules is None:
            return lambda: None
        from fraud_detection_tpu_torch.obs.sentinel import start_sentinel

        return start_sentinel([sentinel_for(i) for i in range(args.workers)],
                              args.alert_interval)

    def alerts_out():
        """The exit stats' 'alerts' block: one snapshot (one worker) or a
        per-worker list."""
        if alert_rules is None or not sentinel_per_worker:
            return None
        snaps = [sentinel_per_worker[w].snapshot()
                 for w in sorted(sentinel_per_worker)]
        return snaps[0] if args.workers == 1 else snaps

    watch_stop = watch_thread = None
    if args.watch:
        # One watcher for the whole process (every worker shares ``pipe``,
        # so a swap lands everywhere at once): poll the registry, verify +
        # pre-warm new versions, swap or stage+judge per the flags, on a
        # daemon thread; tick() failures log and never kill serving (a
        # device fault stops the watcher and fails the run below).
        from fraud_detection_tpu_torch.registry import LifecycleController

        lifecycle = LifecycleController(
            registry, pipe, shadow=shadow, policy=promote_policy,
            batch_size=args.batch_size, health_fn=live_health,
            on_transition=(learn_loop.on_transition
                           if learn_loop is not None else None))
        if learn_loop is not None:
            learn_loop.bind_controller(lifecycle)
        watch_thread, watch_stop = lifecycle.run_in_thread(
            args.watch_interval)

    def finish_lifecycle():
        """Stop the learn lane, the watcher and the shadow worker (the
        learn lane first: a retrain mid-flight finishes and its publish
        shows in the final state); returns the stats JSON's lifecycle
        block, or None when not serving from a registry."""
        if learn_loop is not None:
            learn_loop.close(timeout=30.0)
        if watch_stop is not None:
            watch_stop.set()
            watch_thread.join(timeout=5.0)
        if shadow is not None:
            shadow.close(timeout=5.0)
        if registry is None:
            return None
        out = {"active_version": pipe.active_version,
               "staged_version": pipe.staged_version,
               "swaps": pipe.swaps,
               "events": lifecycle.events if lifecycle is not None else []}
        if learn_loop is not None:
            out["learn"] = learn_loop.snapshot()
        return out

    def finish_annotations():
        """Drain every live engine's async lane, then close the slotserve
        service (the lane's worker blocks inside explain_rows, so a drained
        lane means an idle slot lane); returns the stats JSON's annotations
        block (replaced incarnations' counters included), or None
        inline."""
        if not args.explain_async:
            return None
        agg = dict(annotations_harvested)
        for e in engines_built:
            e.close_annotations(timeout=30.0)
            s = e.annotation_stats() or {}
            for k in agg:
                agg[k] += s.get(k, 0)
        if explain_service is not None:
            explain_service.close(timeout=30.0)
        return agg

    scenario_failed: list = []    # the scenario's name once its gates fail

    def finish_run(out):
        """Close every lane and watcher, add their blocks to the exit stats
        ``out`` and print it; returns the device faults of the lanes."""
        if fault_plan is not None:
            out["chaos"] = fault_plan.report()
        annotations = finish_annotations()
        if annotations is not None:
            out["annotations"] = annotations
        if explain_service is not None:
            # Post-drain snapshot (the health block may predate it).
            out["explain"] = explain_service.snapshot()
        lifecycle_out = finish_lifecycle()
        if lifecycle_out is not None:
            out["lifecycle"] = lifecycle_out
        profile = finish_profile()
        if profile is not None:
            out["profile"] = profile
        finish_sentinel()
        alerts = alerts_out()
        if alerts is not None:
            out["alerts"] = alerts
        finish_metrics()
        finish_health()
        if args.trace_record is not None and trace_per_worker:
            # Atomic JSONL dump of the ring at exit (scenarios/record.py):
            # the run is now a replayable regression input.
            from fraud_detection_tpu_torch.scenarios import dump_tracer

            header = dump_tracer(trace_per_worker[0], args.trace_record,
                                 now=time.time())
            out["trace_record"] = {"path": args.trace_record,
                                   "spans": header["spans"],
                                   "complete": header["complete"]}
        if scenario is not None:
            scenario_feeder.join(timeout=120.0)
            out["scenario"] = _judge_scenario(
                scenario, scenario_events, scenario_feeder, broker, args,
                out, trace_per_worker)
            if not out["scenario"]["ok"]:
                scenario_failed.append(scenario.name)
                failed = [v["name"] for v in out["scenario"]["verdicts"]
                          if not v["ok"] and not v["skipped"]]
                print(f"scenario {scenario.name!r} FAILED its SLO gates "
                      f"(exit 4): {failed}", file=sys.stderr, flush=True)
        print(json.dumps(out))
        if broker is not None:
            print(f"classified messages on {args.output_topic}: "
                  f"{broker.topic_size(args.output_topic)}")
        return lane_faults()

    from fraud_detection_tpu_torch.obs.export import start_profile_window

    print(f"serving: model={model_desc} in={args.input_topic} "
          f"out={args.output_topic} batch={args.batch_size} "
          f"workers={args.workers} device={pipe.device}", flush=True)
    if args.workers > 1:
        # Horizontal scale-out: N engines, ONE consumer group — the broker
        # deals each a disjoint partition subset; a worker's exit rebalances
        # ONLY its partitions to the survivors (balanced-sticky assignor).
        # Every worker scores on the one shared pipeline (on the card, N
        # threads dispatch onto it at once; its counters are exact under
        # threads). --max-messages was already refused above.
        from fraud_detection_tpu_torch.stream.engine import (StreamStats,
                                                             _merge_stats,
                                                             run_supervised)

        results = [None] * args.workers
        errors = [None] * args.workers
        live = [None] * args.workers     # current engine, for Ctrl-C stop
        finish_health = start_health_writer(
            args.health_file, args.health_interval, lambda: live, fault_plan)
        if metrics_registry is not None:
            # One collector, every live worker's full health(), flattened
            # with an index label per worker at render time.
            metrics_registry.add_collector(
                "engine", lambda: [e.health() for e in live if e is not None])
        finish_metrics = start_metrics(
            healthz_fn=sentinels_healthz if args.alerts else None)
        finish_sentinel = start_alerting()
        finish_profile = start_profile_window(
            args.profile_dir, args.profile_batches,
            lambda: sum(e.stats.batches for e in live if e is not None),
            device=pipe.device)
        # Cooperative shutdown: KeyboardInterrupt reaches only the main
        # thread, so an engine built after the operator's Ctrl-C is stopped
        # before it runs.
        shutdown = threading.Event()
        # On the demo broker every worker's engine is built BEFORE any
        # consumes: group members join at consumer construction, so the
        # group settles at its final generation first (staggered joins
        # would let worker 0 drain the topic and then have its commit
        # fenced by the late joiners' rebalance — duplicates a settled
        # group never produces). --kafka builds each lazily INSIDE its
        # supervisor: a client that fails to construct must stay a
        # retryable incarnation, and must not abort its siblings.
        prebuilt = [make_engine(worker=i) if broker is not None else None
                    for i in range(args.workers)]

        def run_worker(i: int) -> None:
            def make():
                if prebuilt[i] is not None:
                    live[i], prebuilt[i] = prebuilt[i], None
                else:
                    live[i] = make_engine(replacing=live[i], worker=i)
                if shutdown.is_set():
                    live[i].stop()
                return live[i]

            try:
                if args.supervise > 0:
                    results[i] = run_supervised(
                        make, max_restarts=args.supervise,
                        max_messages=None, idle_timeout=idle)
                else:
                    engine = make()
                    try:
                        results[i] = engine.run(max_messages=None,
                                                idle_timeout=idle)
                    finally:
                        engine.consumer.close()
            except BaseException as e:  # noqa: BLE001 — surfaced via exit code
                errors[i] = e
                print(f"worker {i} died: {e!r} (survivors keep their "
                      f"partitions; exit code will be nonzero)",
                      file=sys.stderr, flush=True)

        threads = [threading.Thread(target=run_worker, args=(i,),
                                    daemon=True, name=f"serve-w{i}")
                   for i in range(args.workers)]
        for t in threads:
            t.start()
        try:
            for t in threads:
                t.join()
        except KeyboardInterrupt:
            # Graceful drain: stop every live engine (its run() returns and
            # the worker's close/supervisor path leaves the group).
            shutdown.set()
            for engine in live:
                if engine is not None:
                    engine.stop()
            for t in threads:
                t.join(timeout=30)
        total = StreamStats()
        for r in results:
            if r is not None:
                _merge_stats(total, r)
        done = [r for r in results if r is not None]
        # Workers overlap: the wall clock is the slowest worker's, not the
        # sum _merge_stats makes of it; restarts are the supervisors' sums.
        total.elapsed = max((r.elapsed for r in done), default=0.0)
        total.restarts = sum(r.restarts for r in done)
        merged = {**total.as_dict(), "workers": args.workers,
                  "per_worker_processed": [r.processed if r else None
                                           for r in results],
                  "health": [e.health() if e is not None else None
                             for e in live]}
        faults = finish_run(merged)
        failures = [e for e in errors if e is not None]
        if failures:
            print(f"{len(failures)} worker(s) failed; first: {failures[0]!r}",
                  file=sys.stderr)
            return 1
        return 1 if faults else 0

    finish_health = start_health_writer(
        args.health_file, args.health_interval, lambda: engines_built[-1:],
        fault_plan)
    if metrics_registry is not None:
        metrics_registry.add_collector("engine", live_health)
    finish_metrics = start_metrics(
        healthz_fn=sentinels_healthz if args.alerts else None)
    finish_sentinel = start_alerting()
    finish_profile = start_profile_window(
        args.profile_dir, args.profile_batches,
        lambda: engines_built[-1].stats.batches if engines_built else 0,
        device=pipe.device)
    gave_up = None
    if args.supervise > 0:
        # The supervisor builds and closes every consumer/producer itself
        # (on Ctrl-C too, where it returns the aggregated stats).
        from fraud_detection_tpu_torch.stream.engine import (StreamStats,
                                                             run_supervised)

        try:
            stats = run_supervised(
                lambda: make_engine(
                    replacing=engines_built[-1] if engines_built else None),
                max_restarts=args.supervise, max_messages=max_messages,
                idle_timeout=idle)
        except Exception as e:  # noqa: BLE001 — give-up surfaced as exit code
            # Restarts exhausted (or a fault of the card, which is never
            # restarted around): report the partial progress plus the
            # final health and exit non-zero.
            gave_up = e
            stats = getattr(e, "supervisor_stats", None) or StreamStats()
            print(f"supervised run gave up after {args.supervise} restarts: "
                  f"{e!r} (offsets stay at the last commit; a restarted "
                  f"serve resumes there)", file=sys.stderr, flush=True)
    else:
        engine = make_engine()
        try:
            stats = engine.run(max_messages=max_messages, idle_timeout=idle)
        except KeyboardInterrupt:
            engine.stop()
            stats = engine.stats
        finally:
            engine.consumer.close()
    out = stats.as_dict()
    out["health"] = live_health()
    faults = finish_run(out)
    if gave_up is not None:
        return 3
    if faults:
        return 1
    return 4 if scenario_failed else 0

if __name__ == "__main__":
    sys.exit(main())
