"""Streaming serve CLI — twin of ``fraud_detection_tpu/app/serve.py`` for one
worker: run the micro-batching classifier against a broker on ``--device``
(the card unless ``--device cpu``).

    # self-contained demo: an in-process broker fed with synthetic traffic
    python -m fraud_detection_tpu_torch.app.serve --model ./fraud_model \\
        --demo 5000 --batch-size 1024

``--model`` is a native checkpoint directory (``checkpoint/native.py``,
written by either package). By default the host featurizes with the native
C++ featurizer and the engine takes the raw-JSON path with C++ frame
assembly; ``--featurize-device`` ships raw bytes to the CUDA featurize
kernel instead. The flags of the reference CLI that the port does not offer
yet exit with the ROADMAP queue item that holds them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# Reference flags the port does not offer yet: (flag, takes a value,
# ROADMAP.md Queue 1 item that holds its module).
_UNPORTED = (
    ("--registry", True, 5), ("--model-version", True, 5),
    ("--watch", False, 5), ("--watch-interval", True, 5),
    ("--shadow", False, 5), ("--shadow-sample", True, 5),
    ("--shadow-queue", True, 5), ("--learn", False, 5),
    ("--learn-feedback-topic", True, 5), ("--learn-window", True, 5),
    ("--learn-min-rows", True, 5), ("--learn-error-threshold", True, 5),
    ("--learn-rounds", True, 5), ("--learn-interval", True, 5),
    ("--promote-policy", True, 5), ("--kafka", False, 5),
    ("--supervise", True, 5), ("--workers", True, 5), ("--fleet", True, 5),
    ("--fleet-health-file", True, 5), ("--fleet-candidates", True, 5),
    ("--autoscale", False, 5), ("--min-workers", True, 5),
    ("--max-workers", True, 5), ("--scale-cooldown", True, 5),
    ("--mesh", False, 5), ("--explain-slots", True, 7),
    ("--explain-queue", True, 7), ("--explain-paged", False, 7),
    ("--explain-kv-pages", True, 7), ("--explain-async", False, 7),
    ("--annotations-topic", True, 7), ("--breaker", True, 7),
    ("--breaker-probe", True, 7), ("--health-file", True, 5),
    ("--health-interval", True, 5), ("--metrics-file", True, 5),
    ("--metrics-interval", True, 5), ("--metrics-port", True, 5),
    ("--alerts", False, 5), ("--alert-rules", True, 5),
    ("--alert-interval", True, 5), ("--incident-dir", True, 5),
    ("--trace", False, 5), ("--trace-sample", True, 5),
    ("--trace-record", True, 5), ("--scenario", True, 5),
    ("--scenario-scale", True, 5), ("--scenario-time-scale", True, 5),
    ("--profile-dir", True, 5), ("--profile-batches", True, 5),
    ("--chaos", False, 5), ("--chaos-seed", True, 5),
)


def _refuse(what: str, item: int) -> SystemExit:
    return SystemExit(f"{what} is not ported to fraud_detection_tpu_torch "
                      f"yet (ROADMAP.md Queue 1 item {item})")


def build_pipeline(spec: str, batch_size: int, int8: bool = False,
                   featurize_device: bool = False, featurize_width=None,
                   device="cuda"):
    """A serving pipeline over the checkpoint directory ``spec``."""
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline

    if spec.startswith("spark:"):
        raise _refuse("--model spark:<dir> (reading a Spark artifact needs "
                      "pyarrow, absent on the GPU machine)", 6)
    if spec == "synthetic":
        raise _refuse("--model synthetic trains a logistic regression at "
                      "startup; the LR trainer (models/train_linear.py)", 4)
    return ServingPipeline.from_checkpoint(
        spec, device=device, batch_size=batch_size, int8=int8,
        featurize_device=featurize_device, featurize_width=featurize_width)


def _explain_hook(args):
    """The engine's ``explain_batch_fn`` for ``--explain``, or None."""
    if args.explain == "off":
        return None
    from fraud_detection_tpu_torch.explain import make_stream_explain_hook
    from fraud_detection_tpu_torch.utils.config import LLMConfig

    try:
        llm_cfg = LLMConfig.from_env()
    except ValueError as e:
        raise SystemExit(f"bad LLM_* environment value: {e}")
    # An explicit LLM_TEMPERATURE wins; unset, local backends decode greedy.
    temp = llm_cfg.temperature if "LLM_TEMPERATURE" in os.environ else 0.0
    if args.explain == "canned":
        from fraud_detection_tpu_torch.explain import CannedBackend

        backend = CannedBackend(responses=[
            "(offline analysis stub — run --explain onpod-demo on the card "
            "for a model's analysis)"])
    elif args.explain == "onpod-demo":
        # A tiny random-init on-device model: the real decode path, no
        # checkpoint; its analyses are noise (the name says so).
        from fraud_detection_tpu_torch.explain import OnPodBackend
        from fraud_detection_tpu_torch.models.llm import (LanguageModel,
                                                          TransformerConfig)

        lm = LanguageModel.init_random(
            TransformerConfig(d_model=128, n_layers=2, n_heads=8, d_ff=256,
                              max_seq=2048), seed=0, device=args.device)
        backend = OnPodBackend.from_model(lm)
    elif args.explain.startswith(("onpod:", "onpod-int8:", "deepseek")):
        raise _refuse(f"--explain {args.explain.partition(':')[0]} (HF "
                      "checkpoints, int8 weights and the HTTP backend's "
                      "spec)", 7)
    else:
        raise SystemExit(f"unknown --explain spec {args.explain!r}")
    return make_stream_explain_hook(backend, temperature=temp,
                                    max_tokens=args.explain_tokens)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None,
                    help="native checkpoint dir (checkpoint/native.py)")
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
    ap.add_argument("--partitions", type=int, default=3,
                    help="in-process demo broker partition count")
    ap.add_argument("--explain", default="off", metavar="SPEC",
                    help="attach LLM analyses to flagged messages, batched "
                         "per micro-batch: 'off' | 'canned' | 'onpod-demo'")
    ap.add_argument("--explain-tokens", type=int, default=128,
                    help="max new tokens per analysis (--explain)")
    ap.add_argument("--dlq", action="store_true",
                    help="route malformed and repeatedly failing messages "
                         "to <output-topic>-dlq as structured records")
    ap.add_argument("--dlq-topic", default=None,
                    help="dead-letter topic name (implies --dlq)")
    ap.add_argument("--dlq-max-attempts", type=int, default=3,
                    help="re-deliveries before a row is dead-lettered")
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
            raise _refuse(flag, item)
    if args.model is None:
        raise SystemExit("choose exactly one of --model or --registry")
    if args.featurize_width is not None and not args.featurize_device:
        raise SystemExit("--featurize-width needs --featurize-device")
    if args.pipeline_depth < 1:
        raise SystemExit(f"--pipeline-depth must be >= 1, got {args.pipeline_depth}")
    if args.explain_tokens < 1:
        raise SystemExit(f"--explain-tokens must be >= 1, got {args.explain_tokens}")
    if args.partitions < 1:
        raise SystemExit(f"--partitions must be >= 1, got {args.partitions}")
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
    if args.demo <= 0:
        raise SystemExit("choose --kafka or --demo N (no broker specified)")

    from fraud_detection_tpu_torch.stream import (InProcessBroker,
                                                  StreamingClassifier)

    explain_hook = _explain_hook(args)
    pipe = build_pipeline(args.model, args.batch_size, int8=args.int8,
                          featurize_device=args.featurize_device,
                          featurize_width=args.featurize_width,
                          device=args.device)
    model_desc = f"{args.model} (featurize={pipe.device_stats.featurize_path})"

    scheduler = None
    if sched_config is not None:
        from fraud_detection_tpu_torch.sched import AdaptiveScheduler

        # Measure the candidate rungs and warm the selected ladder ONCE,
        # before the engine runs (off the hot path); this worker's engine
        # drives the same scheduler.
        scheduler = AdaptiveScheduler(sched_config, args.batch_size)
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
    dlq_topic = ((args.dlq_topic or f"{args.output_topic}-dlq")
                 if args.dlq else None)

    print(f"serving: model={model_desc} in={args.input_topic} "
          f"out={args.output_topic} batch={args.batch_size} workers=1 "
          f"device={pipe.device}", flush=True)
    engine = StreamingClassifier(
        pipe, broker.consumer([args.input_topic], "serve-demo"),
        broker.producer(), args.output_topic,
        batch_size=args.batch_size, max_wait=args.max_wait,
        pipeline_depth=args.pipeline_depth, explain_batch_fn=explain_hook,
        dlq_topic=dlq_topic, dlq_max_attempts=args.dlq_max_attempts,
        scheduler=scheduler, async_dispatch=args.async_dispatch)
    try:
        stats = engine.run(max_messages=max_messages, idle_timeout=1.0)
    except KeyboardInterrupt:
        engine.stop()
        stats = engine.stats
    finally:
        engine.consumer.close()
    out = stats.as_dict()
    out["health"] = engine.health()
    print(json.dumps(out))
    print(f"classified messages on {args.output_topic}: "
          f"{broker.topic_size(args.output_topic)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
