"""Streaming serve CLI — twin of ``fraud_detection_tpu/app/serve.py`` for one
worker: run the micro-batching classifier against a broker on ``--device``
(the card unless ``--device cpu``).

    # self-contained demo: an in-process broker fed with synthetic traffic
    python -m fraud_detection_tpu_torch.app.serve --model ./fraud_model \\
        --demo 5000 --batch-size 1024

``--model`` is a native checkpoint directory (``checkpoint/native.py``,
written by either package), or ``synthetic``: a logistic regression
trained at startup on the synthetic corpus. ``--registry`` serves a version
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
``--profile-batches`` batches. By default the host featurizes
with the native C++ featurizer and the engine takes the raw-JSON path with
C++ frame assembly; ``--featurize-device`` ships raw bytes to the CUDA featurize
kernel instead. The flags of the reference CLI that the port does not offer
yet exit with the ROADMAP queue item that holds them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

from fraud_detection_tpu_torch.app import unported

# Reference flags the port does not offer yet: (flag, takes a value,
# ROADMAP.md Queue 1 item that holds its module).
_UNPORTED = (
    ("--kafka", False, "5.5"),
    ("--workers", True, "5.3"), ("--fleet", True, "5.3"),
    ("--fleet-health-file", True, "5.3"), ("--fleet-candidates", True, "5.3"),
    ("--autoscale", False, "5.3"), ("--min-workers", True, "5.3"),
    ("--max-workers", True, "5.3"), ("--scale-cooldown", True, "5.3"),
    ("--mesh", False, "5.6"),
    ("--trace-record", True, "5.4"), ("--scenario", True, "5.4"),
    ("--scenario-scale", True, "5.4"), ("--scenario-time-scale", True, "5.4"),
)


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
    """A serving pipeline over the checkpoint directory ``spec``, or over a
    logistic regression trained at startup on the synthetic corpus
    (``synthetic``)."""
    from fraud_detection_tpu_torch.models.pipeline import (
        ServingPipeline, synthetic_demo_pipeline)

    if spec.startswith("spark:"):
        raise unported("--model spark:<dir> (reading a Spark artifact needs "
                       "pyarrow, absent on the GPU machine)", 6)
    if spec == "synthetic":
        demo = synthetic_demo_pipeline(batch_size, device=device)
        return ServingPipeline(demo.featurizer, demo.model,
                               batch_size=batch_size, int8=int8,
                               featurize_device=featurize_device,
                               featurize_width=featurize_width, device=device)
    return ServingPipeline.from_checkpoint(
        spec, device=device, batch_size=batch_size, int8=int8,
        featurize_device=featurize_device, featurize_width=featurize_width)


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
                    help="native checkpoint dir (checkpoint/native.py), or "
                         "'synthetic' (train a demo LR at startup)")
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
    ap.add_argument("--partitions", type=int, default=3,
                    help="in-process demo broker partition count")
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
    for flag, takes_value, item in _UNPORTED:
        ap.add_argument(flag, default=None,
                        **({"metavar": "X"} if takes_value
                           else {"action": "store_const", "const": True}),
                        help=f"not ported yet (ROADMAP Queue 1 item {item})")
    args = ap.parse_args(argv)

    if args.kafka and args.demo:
        raise SystemExit("--kafka and --demo are mutually exclusive")
    for flag, _, item in _UNPORTED:
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            raise unported(flag, item)
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
    if args.partitions < 1:
        raise SystemExit(f"--partitions must be >= 1, got {args.partitions}")
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
    if args.profile_batches < 1:
        raise SystemExit(
            f"--profile-batches must be >= 1, got {args.profile_batches}")
    if args.chaos and args.supervise == 0:
        # Chaos without supervision dies on the first injected fault by
        # design; enough restarts for the demo plan's budget.
        args.supervise = 25
    if args.demo <= 0:
        raise SystemExit("choose --kafka or --demo N (no broker specified)")

    from fraud_detection_tpu_torch.stream import (InProcessBroker,
                                                  StreamingClassifier)
    from fraud_detection_tpu_torch.utils.tracing import device_trace

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
    model_desc = (f"{model_desc} "
                  f"(featurize={pipe.device_stats.featurize_path})")

    scheduler = None
    if sched_config is not None:
        from fraud_detection_tpu_torch.sched import AdaptiveScheduler

        # Measure the candidate rungs and warm the selected ladder ONCE,
        # before the engine runs (off the hot path); every incarnation of
        # this worker's engine drives the same scheduler. A HotSwapPipeline
        # keeps the ladder and cost table for every later swap candidate.
        # --profile-dir gives the measurement a profiler capture of its own.
        scheduler = AdaptiveScheduler(sched_config, args.batch_size)
        with device_trace("prewarm", args.profile_dir, device=pipe.device):
            scheduler.prewarm(pipe)

    from fraud_detection_tpu_torch.data import generate_corpus

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

    def make_clients():
        return (broker.consumer([args.input_topic], "serve-demo"),
                broker.producer())

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
        learn_loop = LearnLoop(
            feedback_consumer=broker.consumer([feedback_topic], "learn"),
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

    # Row tracing and alerting: ONE tracer and ONE sentinel for the worker,
    # shared across its supervised incarnations (like the DLQ poison
    # tracker), so chains and incident accounting survive restarts. The
    # sentinel reads a chain-cumulative health source whose counters survive
    # restarts and whose supervisor.restarts feeds the restart-churn rule.
    rowtrace = sentinel = sentinel_source = None
    if args.trace:
        from fraud_detection_tpu_torch.obs import RowTracer

        rowtrace = RowTracer(worker="w0", sample=args.trace_sample,
                             capacity=4096)
    if alert_rules is not None:
        from fraud_detection_tpu_torch.obs.sentinel import (
            ChainedHealthSource, IncidentRecorder, Sentinel)

        sentinel_source = ChainedHealthSource()
        recorder = (IncidentRecorder(args.incident_dir, rowtrace=rowtrace)
                    if args.incident_dir is not None else None)
        sentinel = Sentinel(sentinel_source, alert_rules, recorder=recorder,
                            worker="w0")
    if explain_service is not None and rowtrace is not None:
        # Completed explanations land per-row "explain" spans (slot id and
        # admission wait) on the rows' chains.
        explain_service.set_rowtrace(rowtrace)

    engines_built = []   # the live engine only: a replaced one is harvested
    # Lane counters of engines already replaced and closed.
    annotations_harvested = {"submitted": 0, "annotated": 0, "dropped": 0,
                             "drop_records": 0, "backend_errors": 0}
    dlq_attempts = {} if dlq_topic is not None else None

    def make_engine(replacing=None):
        """Build an engine; ``replacing`` is the previous incarnation on a
        supervised restart: its async annotation lane is drained (briefly)
        and stopped so restarts do not accumulate lane threads, its lane
        counters are harvested into the exit aggregate and the dead engine
        is dropped. The DLQ poison tracker, the scheduler, the tracer and
        the sentinel are shared across incarnations."""
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
            annotations_producer=(broker.producer() if args.explain_async
                                  else None),
            breaker=breaker, explain_service=explain_service,
            rowtrace=rowtrace, sentinel=sentinel)
        engines_built.append(engine)
        if sentinel_source is not None:
            # Fold the replaced incarnation's counters into the chain.
            sentinel_source.attach(engine)
        return engine

    def live_health():
        return engines_built[-1].health() if engines_built else None

    lifecycle = watch_stop = watch_thread = None
    if args.watch:
        # Poll the registry, verify + pre-warm new versions, swap or
        # stage+judge per the flags, on a daemon thread; tick() failures
        # log and never kill serving (a device fault stops the watcher and
        # fails the run below).
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
        """Drain the live engine's async lane, then close the slotserve
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

    print(f"serving: model={model_desc} in={args.input_topic} "
          f"out={args.output_topic} batch={args.batch_size} workers=1 "
          f"device={pipe.device}", flush=True)
    finish_health = start_health_writer(
        args.health_file, args.health_interval, lambda: engines_built[-1:],
        fault_plan)
    if metrics_registry is not None:
        metrics_registry.add_collector("engine", live_health)
    finish_metrics = start_metrics(
        healthz_fn=sentinel.healthz if sentinel is not None else None)
    finish_sentinel = lambda: None  # noqa: E731
    if sentinel is not None:
        from fraud_detection_tpu_torch.obs.sentinel import start_sentinel

        finish_sentinel = start_sentinel([sentinel], args.alert_interval)
    from fraud_detection_tpu_torch.obs.export import start_profile_window

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
    if fault_plan is not None:
        out["chaos"] = fault_plan.report()
    annotations = finish_annotations()
    if annotations is not None:
        out["annotations"] = annotations
    if explain_service is not None:
        # Post-drain snapshot (the health block above may predate it).
        out["explain"] = explain_service.snapshot()
    lifecycle_out = finish_lifecycle()
    if lifecycle_out is not None:
        out["lifecycle"] = lifecycle_out
    profile = finish_profile()
    if profile is not None:
        out["profile"] = profile
    finish_sentinel()
    if sentinel is not None:
        out["alerts"] = sentinel.snapshot()
    finish_metrics()
    finish_health()
    print(json.dumps(out))
    print(f"classified messages on {args.output_topic}: "
          f"{broker.topic_size(args.output_topic)}")
    faults = [(name, lane.fault) for name, lane in (
        ("learn", learn_loop), ("watcher", lifecycle), ("shadow", shadow),
        ("slotserve", explain_service))
        if lane is not None and lane.fault is not None]
    for name, fault in faults:
        print(f"the {name} lane stopped on a device fault: {fault!r}",
              file=sys.stderr)
    if gave_up is not None:
        return 3
    return 1 if faults else 0

if __name__ == "__main__":
    sys.exit(main())
