"""Native checkpoint format — twin of ``fraud_detection_tpu/checkpoint/native.py``,
same files on disk, so a checkpoint written by either package loads in the
other:

    <dir>/manifest.json      {"format": "fraud_detection_tpu", "version": 1,
                              "model_kind": ..., "featurizer": {...}}
    <dir>/arrays.npz         all numpy arrays, flat key namespace

Round-trips the serving stack: the hashing or vocabulary featurizer
(config, vocabulary, idf / doc_freq, stop list) and a LogisticRegression or
TreeEnsemble.
"""

from __future__ import annotations

import json
import os
from typing import Tuple, Union

import numpy as np

from fraud_detection_tpu_torch import convert
from fraud_detection_tpu_torch.featurize.text import StopWordFilter
from fraud_detection_tpu_torch.featurize.tfidf import (HashingTfIdfFeaturizer,
                                                       VocabTfIdfFeaturizer)
from fraud_detection_tpu_torch.models.linear import LogisticRegression
from fraud_detection_tpu_torch.models.trees import TreeEnsemble
from fraud_detection_tpu_torch.utils.device import resolve_device

FORMAT_NAME = "fraud_detection_tpu"
FORMAT_VERSION = 1

Model = Union[LogisticRegression, TreeEnsemble]

_TREE_ARRAYS = ("feature", "threshold", "left", "right", "leaf", "tree_weights")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_checkpoint(path: str, featurizer: HashingTfIdfFeaturizer,
                    model: Model) -> None:
    if featurizer.legacy:
        raise ValueError(
            "the native format has no field for the legacy murmur tail; a "
            "legacy featurizer would load back hashing differently")
    os.makedirs(path, exist_ok=True)
    arrays = {}
    meta = {
        "format": FORMAT_NAME,
        "version": FORMAT_VERSION,
        "featurizer": {
            "num_features": featurizer.num_features,
            "binary_tf": featurizer.binary_tf,
            "remove_stopwords": featurizer.remove_stopwords,
            "num_docs": getattr(featurizer, "num_docs", None),
            "stopwords": featurizer.stop_filter.words,
            "case_sensitive": featurizer.stop_filter.case_sensitive,
        },
    }
    if isinstance(featurizer, VocabTfIdfFeaturizer):
        meta["featurizer"]["kind"] = "vocab"
        meta["featurizer"]["min_tf"] = featurizer.min_tf
        # Fixed-width unicode array: npz-safe without pickle.
        arrays["featurizer.vocabulary"] = np.asarray(featurizer.vocabulary,
                                                     np.str_)
    else:
        meta["featurizer"]["kind"] = "hashing"
    if featurizer.idf is not None:
        arrays["featurizer.idf"] = np.asarray(featurizer.idf, np.float32)
    if getattr(featurizer, "doc_freq", None) is not None:
        arrays["featurizer.doc_freq"] = np.asarray(featurizer.doc_freq, np.int64)

    if isinstance(model, LogisticRegression):
        meta["model_kind"] = "logistic_regression"
        meta["model"] = {"threshold": model.threshold}
        arrays["model.weights"] = _host(model.weights).astype(np.float32)
        arrays["model.intercept"] = _host(model.intercept).astype(np.float32)
    elif isinstance(model, TreeEnsemble):
        meta["model_kind"] = "tree_ensemble"
        meta["model"] = {"kind": model.kind, "max_depth": model.max_depth,
                         "bias": model.bias}
        for name in _TREE_ARRAYS:
            arrays[f"model.{name}"] = _host(getattr(model, name))
    else:
        raise TypeError(f"unsupported model type {type(model).__name__}")

    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as fh:
        json.dump(meta, fh, indent=2)


def load_checkpoint(path: str, device="cuda"
                    ) -> Tuple[HashingTfIdfFeaturizer, Model]:
    """(featurizer, model) with the model's tensors on ``device``."""
    dev = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as fh:
        meta = json.load(fh)
    if meta.get("format") != FORMAT_NAME:
        raise ValueError(f"{path} is not a {FORMAT_NAME} checkpoint")
    arrays = np.load(os.path.join(path, "arrays.npz"))

    fz = meta["featurizer"]
    idf = arrays["featurizer.idf"] if "featurizer.idf" in arrays else None
    if fz.get("kind") == "vocab":
        featurizer: HashingTfIdfFeaturizer = VocabTfIdfFeaturizer(
            vocabulary=[str(t) for t in arrays["featurizer.vocabulary"]],
            min_tf=float(fz.get("min_tf", 1.0)), idf=idf,
            binary_tf=bool(fz["binary_tf"]),
            stop_filter=StopWordFilter(fz["stopwords"],
                                       bool(fz["case_sensitive"])),
            remove_stopwords=bool(fz["remove_stopwords"]))
    else:
        featurizer = convert.featurizer_from_arrays(
            int(fz["num_features"]), idf,
            binary_tf=bool(fz["binary_tf"]), stopwords=fz["stopwords"],
            case_sensitive=bool(fz["case_sensitive"]),
            remove_stopwords=bool(fz["remove_stopwords"]))
    if "featurizer.doc_freq" in arrays:
        featurizer.doc_freq = arrays["featurizer.doc_freq"]
    if fz.get("num_docs") is not None:
        featurizer.num_docs = int(fz["num_docs"])

    if meta["model_kind"] == "logistic_regression":
        model: Model = convert.logistic_from_arrays(
            arrays["model.weights"], arrays["model.intercept"],
            float(meta["model"]["threshold"]), device=dev)
    elif meta["model_kind"] == "tree_ensemble":
        model = convert.trees_from_arrays(
            *(arrays[f"model.{name}"] for name in _TREE_ARRAYS),
            kind=meta["model"]["kind"],
            max_depth=int(meta["model"]["max_depth"]),
            bias=float(meta["model"].get("bias", 0.0)), device=dev)
    else:
        raise ValueError(f"unknown model_kind {meta['model_kind']!r}")
    return featurizer, model
