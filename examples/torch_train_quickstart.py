"""Train, evaluate, save, and re-serve a tree model on the synthetic corpus
on the PyTorch port — twin of ``examples/train_quickstart.py``.

(The real dataset streams from HuggingFace in the reference — SURVEY.md Q10;
the synthetic corpus has the same schema and difficulty shape.)

Run:  python examples/torch_train_quickstart.py [--device cpu]

On the card the boosting fit launches the hand-written histogram and
split-gain kernels once per split level of each round; ``--device cpu``
runs their plain torch versions.
"""
import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def run(argv=None, *, n: int = 1200, n_train: int = 840, n_rounds: int = 30,
        num_features: int = 10000) -> dict:
    """Fit ``n_rounds`` boosting rounds on ``n_train`` of ``n`` rows and
    score the rest; returns the model, the test predictions and scores, the
    metrics, whether the reloaded checkpoint predicts the same, and the exit
    code.
    The keywords are the JAX example's sizes (tests cut them)."""
    from examples.torch_serve_quickstart import device_arg
    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.eval.metrics import evaluate_classification
    from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
    from fraud_detection_tpu_torch.models.train_trees import fit_gradient_boosting
    from fraud_detection_tpu_torch.models.trees import predict
    from fraud_detection_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    corpus = generate_corpus(n=n, seed=42)
    texts = [d.text for d in corpus]
    y = np.asarray([d.label for d in corpus], np.int32)

    feat = HashingTfIdfFeaturizer(num_features=num_features)
    feat.fit_idf(texts)
    X = feat.featurize_dense(texts, device=dev)

    # n_train: 70/30, matching the reference's seeded split shape
    model = fit_gradient_boosting(X[:n_train], y[:n_train], n_rounds=n_rounds,
                                  device=dev)

    preds, proba = predict(model, X[n_train:])
    preds, scores = preds.cpu().numpy(), proba.cpu().numpy()
    rep = evaluate_classification(y[n_train:], preds, scores)
    metrics = {k: round(float(v), 4) for k, v in rep.as_dict().items()
               if k in ("accuracy", "f1", "auc")}
    print(metrics)

    from fraud_detection_tpu_torch.checkpoint.native import (load_checkpoint,
                                                             save_checkpoint)

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model")
        save_checkpoint(path, feat, model)
        feat2, model2 = load_checkpoint(path, device=dev)
        p2 = predict(model2, X[n_train:])[0].cpu().numpy()
        reloaded_equal = np.array_equal(preds, p2)
        assert reloaded_equal
        print("save/load round-trip: OK")
    return {"model": model, "preds": preds, "scores": scores,
            "metrics": metrics,
            "report": rep.as_dict(), "reloaded_equal": reloaded_equal,
            "exit_code": 0}


def main(argv=None) -> int:
    return run(argv)["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
