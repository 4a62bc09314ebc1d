"""End-to-end streaming classification through the in-process broker on the
PyTorch port — twin of ``examples/streaming_demo.py``.

The same engine drives real Kafka via fraud_detection_tpu_torch.stream.kafka
— the broker here is the injection seam (SURVEY.md §4 point 3).

Run:  python examples/torch_streaming_demo.py [--device cpu]

The pipeline runs on the card unless ``--device cpu`` is given; it
featurizes on the host, as the JAX example does, so it launches no kernel.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def run(argv=None) -> dict:
    """Stream 500 dialogues and one malformed message; returns the stats'
    counts, each output key's label and confidence, the annotated keys and
    the exit code."""
    from examples.torch_serve_quickstart import build_pipeline, device_arg
    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.stream import (InProcessBroker,
                                                  StreamingClassifier)

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    device_arg(ap)
    args = ap.parse_args(argv)
    # match the engine's micro-batch
    pipe = build_pipeline(batch_size=128, device=args.device)
    broker = InProcessBroker(num_partitions=3)
    producer = broker.producer()
    corpus = generate_corpus(n=500, seed=11)
    for i, d in enumerate(corpus):
        producer.produce("customer-dialogues-raw",
                         json.dumps({"text": d.text, "id": i}).encode(),
                         key=str(i).encode())
    producer.produce("customer-dialogues-raw", b"not json", key=b"oops")

    consumer = broker.consumer(["customer-dialogues-raw"], "demo-group")
    # Async annotation lane: flagged rows get an LLM-style analysis on a
    # keyed side topic while classification runs at full rate (a canned
    # backend stands in for the on-device LLM; swap in
    # make_stream_explain_hook(OnPodBackend.from_hf_checkpoint(...)) for
    # real analyses).
    engine = StreamingClassifier(
        pipe, consumer, broker.producer(), "dialogues-classified",
        batch_size=128, max_wait=0.01, pipeline_depth=2,
        explain_batch_fn=lambda texts, labels, confs:
            [f"flagged: {len(t.split())}-word dialogue" for t in texts],
        explain_async=True, annotations_producer=broker.producer())
    stats = engine.run(max_messages=501, idle_timeout=2.0)
    engine.close_annotations(timeout=10.0)

    outs = broker.messages("dialogues-classified")
    annos = broker.messages("dialogues-classified-annotations")
    print(f"processed={stats.processed} malformed={stats.malformed} "
          f"rate={stats.msgs_per_sec:.0f} msgs/sec "
          f"p50={stats.latency_percentile(50)*1e3:.0f}ms")
    print(f"async annotations on side topic: {len(annos)} "
          f"({engine.annotation_stats()})")
    print("sample output:", outs[0].value.decode()[:120], "...")
    if annos:
        print("sample annotation:", annos[0].value.decode()[:120], "...")
    frames = {m.key: json.loads(m.value) for m in outs}
    return {"processed": stats.processed, "malformed": stats.malformed,
            "labels": {k: f.get("prediction") for k, f in frames.items()},
            "confidences": {k: f.get("confidence") for k, f in frames.items()},
            "annotated": sorted(m.key for m in annos), "exit_code": 0}


def main(argv=None) -> int:
    return run(argv)["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
