"""Zero-downtime model hot swap through the loopback broker, on the PyTorch
port — twin of ``examples/hot_swap_demo.py``.

Trains v1, starts the streaming engine, publishes a v2 to the registry
MID-STREAM, and watches the lifecycle machinery stage it, shadow-score it
against the live primary, promote it once the divergence stats clear the
policy, and land the swap — with every message delivered exactly once.

Run:  python examples/torch_hot_swap_demo.py [--device cpu]

Everything runs on the card unless ``--device cpu`` is given; serving
featurizes on the host, so no kernel launches. Where the policy rejects v2
(the two versions disagree on ~5% of the feeder corpus, the policy's bar),
this stops waiting for the promotion at the reject, where the JAX example
waits out its 60 s deadline; what it prints after is the same.
"""
import argparse
import json
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def train(seed: int, n: int = 600, device: str = "cuda"):
    """A quick LR on the synthetic corpus — two seeds, two model versions."""
    import numpy as np

    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
    from fraud_detection_tpu_torch.models.train_linear import (
        fit_logistic_regression)

    corpus = generate_corpus(n=n, seed=seed)
    feat = HashingTfIdfFeaturizer(num_features=4096)
    feat.fit_idf([d.text for d in corpus])
    X = feat.featurize_dense([d.text for d in corpus], device=device)
    y = np.asarray([d.label for d in corpus], np.float32)
    return feat, fit_logistic_regression(X, y, max_iter=30, device=device)


def rejected(registry, version: int) -> bool:
    """The registry's audit log holds the policy's reject of ``version``."""
    return any(e["event"] == "reject" and e.get("version") == version
               for e in registry.read_audit())


def run(argv=None) -> dict:
    """The demo; returns the active version, the swaps, the delivered and
    unique key counts, the audit events and the exit code."""
    from examples.torch_serve_quickstart import device_arg
    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.registry import (HotSwapPipeline,
                                                    LifecycleController,
                                                    ModelRegistry,
                                                    PromotionPolicy,
                                                    ShadowScorer)
    from fraud_detection_tpu_torch.stream import (InProcessBroker,
                                                  StreamingClassifier)
    from fraud_detection_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    root = tempfile.mkdtemp(prefix="model-registry-")
    registry = ModelRegistry(root)

    print("training + publishing v1 ...")
    feat, model_v1 = train(seed=7, device=device)
    registry.publish(feat, model_v1, metrics={"train_seed": 7})
    mv, pipeline = registry.load(batch_size=128, device=device)  # verified load
    hot = HotSwapPipeline(pipeline, version=mv.version)
    shadow = ShadowScorer(max_queue=8)
    controller = LifecycleController(
        registry, hot, shadow=shadow,
        policy=PromotionPolicy(min_shadow_batches=3, min_shadow_rows=200,
                               max_disagreement=0.05, max_psi=0.25),
        batch_size=128)
    watcher, stop = controller.run_in_thread(interval=0.1)

    broker = InProcessBroker(num_partitions=3)
    engine = StreamingClassifier(
        hot, broker.consumer(["customer-dialogues-raw"], "hot-swap-demo"),
        broker.producer(), "dialogues-classified",
        batch_size=128, max_wait=0.01, shadow=shadow)

    n = 30_000
    feeder_corpus = generate_corpus(n=1000, seed=11)

    def feed():
        producer = broker.producer()
        for i in range(n):
            d = feeder_corpus[i % len(feeder_corpus)]
            producer.produce("customer-dialogues-raw",
                             json.dumps({"text": d.text, "id": i}).encode(),
                             key=str(i).encode())
            if i % 2000 == 1999:
                time.sleep(0.05)     # keep the stream alive past the swap

    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    runner = threading.Thread(
        target=lambda: engine.run(max_messages=n, idle_timeout=10.0),
        daemon=True)
    runner.start()

    while engine.stats.processed < n // 4:
        time.sleep(0.01)
    print(f"mid-stream ({engine.stats.processed} processed): "
          "training + publishing v2 ...")
    feat2, model_v2 = train(seed=8, device=device)
    registry.publish(feat2, model_v2, metrics={"train_seed": 8})

    # the controller never stages a rejected version again
    deadline = time.monotonic() + 60
    while (hot.active_version != 2 and time.monotonic() < deadline
           and not rejected(registry, 2)):
        snap = shadow.snapshot()
        if snap["rows"]:
            print(f"  shadow: {snap['rows']} rows, agreement "
                  f"{snap['agreement_rate']:.4f}, PSI {snap['psi']:.4f}, "
                  f"dropped {snap['dropped']}")
        time.sleep(0.25)

    feeder.join()
    runner.join(timeout=60)
    stop.set()
    watcher.join(timeout=5)
    shadow.close(timeout=10)

    outs = broker.messages("dialogues-classified")
    keys = {m.key for m in outs}
    print(f"\nactive version: v{hot.active_version:04d} "
          f"(swaps: {hot.swaps})")
    print(f"delivered {len(outs)} / {n} messages, "
          f"{len(keys)} unique keys -> "
          f"{'ZERO dropped, zero duplicated' if len(keys) == n == len(outs) else 'LOSS!'}")
    print("audit log:")
    audit = registry.read_audit()
    for e in audit:
        extras = {k: v for k, v in e.items()
                  if k in ("version", "previous", "reasons")}
        print(f"  {e['event']:>8}  {extras}")
    print(f"registry at {root} (layout: docs/model_lifecycle.md)")
    return {"active_version": hot.active_version, "swaps": hot.swaps,
            "delivered": len(outs), "unique_keys": len(keys), "fed": n,
            "audit_events": [e["event"] for e in audit], "exit_code": 0}


def main(argv=None) -> int:
    return run(argv)["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
