"""Spark ML PipelineModel writer — twin of
``fraud_detection_tpu/checkpoint/spark_writer.py``: exports the port's
featurizers and models to the layout Spark's ``PipelineModel.save`` writes
(JSON metadata + snappy-parquet weights per stage), the one
``checkpoint/spark_artifact.py`` reads. Its parquet goes through the port's
own codec (``checkpoint/parquet.py``), in the column types pyarrow infers
from the same rows, so the JAX package's reader loads it too.

Stage chain mirrors the reference's shipped artifact (clean_text -> words ->
filtered_words -> raw_features -> features):

    Tokenizer, StopWordsRemover, HashingTF | CountVectorizerModel,
    [IDFModel], LogisticRegressionModel | DecisionTree/RandomForest/
    GBTClassificationModel
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import List, Optional, Union

import numpy as np

from fraud_detection_tpu_torch.checkpoint.parquet import write_rows
from fraud_detection_tpu_torch.featurize.tfidf import (HashingTfIdfFeaturizer,
                                                       VocabTfIdfFeaturizer)
from fraud_detection_tpu_torch.models.linear import LogisticRegression
from fraud_detection_tpu_torch.models.trees import TreeEnsemble

SPARK_VERSION = "3.5.5"  # layout version replicated (the shipped artifact's)

Model = Union[LogisticRegression, TreeEnsemble]


def _uid(cls_name: str, salt: str) -> str:
    return f"{cls_name}_{hashlib.sha1(salt.encode()).hexdigest()[:12]}"


def _dense_vec(values: np.ndarray) -> dict:
    return {"type": 1, "size": None, "indices": None,
            "values": [float(v) for v in np.asarray(values).reshape(-1)]}


def _dense_matrix_row(values: np.ndarray) -> dict:
    """A 1×F dense ml.linalg Matrix struct (column-major == row order here)."""
    flat = [float(v) for v in np.asarray(values).reshape(-1)]
    return {"type": 1, "numRows": 1, "numCols": len(flat), "colPtrs": None,
            "rowIndices": None, "values": flat, "isTransposed": False}


def _write_stage(root: str, idx: int, cls: str, params: dict,
                 data_rows: Optional[List[dict]] = None,
                 extra_meta: Optional[dict] = None,
                 trees_meta: Optional[List[dict]] = None) -> str:
    short = cls.rsplit(".", 1)[-1]
    uid = _uid(short, f"{root}:{idx}:{short}")
    d = os.path.join(root, "stages", f"{idx}_{uid}")
    os.makedirs(os.path.join(d, "metadata"), exist_ok=True)
    meta = {"class": cls, "timestamp": int(time.time() * 1000),
            "sparkVersion": SPARK_VERSION, "uid": uid,
            "paramMap": params, "defaultParamMap": {}}
    if extra_meta:
        meta.update(extra_meta)
    with open(os.path.join(d, "metadata", "part-00000"), "w") as fh:
        fh.write(json.dumps(meta) + "\n")
    for sub, rows in (("data", data_rows), ("treesMetadata", trees_meta)):
        if rows is not None:
            os.makedirs(os.path.join(d, sub), exist_ok=True)
            write_rows(os.path.join(d, sub, "part-00000.snappy.parquet"), rows)
    return uid


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _tree_node_rows(ensemble: TreeEnsemble, t: int,
                    leaf_shift: float = 0.0) -> List[dict]:
    feature = _host(ensemble.feature[t])
    threshold = _host(ensemble.threshold[t])
    left = _host(ensemble.left[t])
    right = _host(ensemble.right[t])
    leaf = _host(ensemble.leaf[t])
    is_margin = ensemble.kind in ("gbt", "xgboost")
    rows = []
    # Only nodes reachable from the root exist in a Spark save; our flat
    # arrays may contain unused padding slots.
    reachable = set()
    stack = [0]
    while stack:
        i = stack.pop()
        if i in reachable:
            continue
        reachable.add(i)
        if left[i] >= 0:
            stack.extend((int(left[i]), int(right[i])))
    for i in sorted(reachable):
        internal = left[i] >= 0
        if is_margin:
            prediction = float(leaf[i, 0]) + leaf_shift
            stats = [prediction]
        else:
            prediction = float(np.argmax(leaf[i]))
            stats = [float(v) for v in leaf[i]]
        rows.append({
            "id": int(i),
            "prediction": prediction,
            "impurity": 0.0,          # not tracked post-training
            "impurityStats": stats,   # classifiers: per-class counts (exact payload)
            "gain": -1.0,             # not tracked post-training
            "leftChild": int(left[i]) if internal else -1,
            "rightChild": int(right[i]) if internal else -1,
            "split": {
                "featureIndex": int(feature[i]) if internal else -1,
                "leftCategoriesOrThreshold": [float(threshold[i])] if internal else [],
                "numCategories": -1,
            },
        })
    return rows


def save_spark_pipeline(path: str,
                        featurizer: HashingTfIdfFeaturizer,
                        model: Model) -> None:
    """Write a Spark PipelineModel save directory for featurizer + model."""
    os.makedirs(os.path.join(path, "metadata"), exist_ok=True)
    has_idf = featurizer.idf is not None
    raw_col = "raw_features" if has_idf else "features"
    uids = []
    idx = 0

    uids.append(_write_stage(
        path, idx, "org.apache.spark.ml.feature.Tokenizer",
        {"inputCol": "clean_text", "outputCol": "words"}))
    idx += 1
    # A StopWordsRemover stage is written ONLY when the featurizer actually
    # filters — the reader infers remove_stopwords from the stage's presence,
    # so an unconditional stage would flip a remove_stopwords=False model's
    # serve-time behavior after a round trip.
    tokens_col = "words"
    if featurizer.remove_stopwords:
        uids.append(_write_stage(
            path, idx, "org.apache.spark.ml.feature.StopWordsRemover",
            {"inputCol": "words", "outputCol": "filtered_words",
             "stopWords": list(featurizer.stop_filter.words),
             "caseSensitive": featurizer.stop_filter.case_sensitive,
             "locale": "en"}))
        idx += 1
        tokens_col = "filtered_words"
    if isinstance(featurizer, VocabTfIdfFeaturizer):
        uids.append(_write_stage(
            path, idx, "org.apache.spark.ml.feature.CountVectorizerModel",
            {"inputCol": tokens_col, "outputCol": raw_col,
             "minTF": featurizer.min_tf, "binary": featurizer.binary_tf,
             "vocabSize": len(featurizer.vocabulary)},
            data_rows=[{"vocabulary": list(featurizer.vocabulary)}]))
        n_features = len(featurizer.vocabulary)
    else:
        uids.append(_write_stage(
            path, idx, "org.apache.spark.ml.feature.HashingTF",
            {"inputCol": tokens_col, "outputCol": raw_col,
             "numFeatures": featurizer.num_features,
             "binary": featurizer.binary_tf}))
        n_features = featurizer.num_features
    idx += 1
    if has_idf:
        doc_freq = getattr(featurizer, "doc_freq", None)
        if doc_freq is None:
            doc_freq = np.zeros(featurizer.num_features, np.int64)
        uids.append(_write_stage(
            path, idx, "org.apache.spark.ml.feature.IDFModel",
            {"inputCol": raw_col, "outputCol": "features", "minDocFreq": 0},
            data_rows=[{
                "idf": _dense_vec(np.asarray(featurizer.idf, np.float64)),
                "docFreq": [int(v) for v in doc_freq],
                "numDocs": int(getattr(featurizer, "num_docs", 0)),
            }]))
        idx += 1

    if isinstance(model, LogisticRegression):
        uids.append(_write_stage(
            path, idx, "org.apache.spark.ml.classification.LogisticRegressionModel",
            {"featuresCol": "features", "labelCol": "label",
             "threshold": model.threshold},
            data_rows=[{
                "numClasses": 2,
                "numFeatures": int(model.weights.shape[0]),
                "interceptVector": _dense_vec(
                    _host(model.intercept).astype(np.float64).reshape(1)),
                "coefficientMatrix": _dense_matrix_row(
                    _host(model.weights).astype(np.float64)),
                "isMultinomial": False,
            }]))
    elif isinstance(model, TreeEnsemble):
        uids.append(_write_tree_model(path, idx, model, n_features))
    else:
        raise TypeError(f"unsupported model type {type(model).__name__}")

    with open(os.path.join(path, "metadata", "part-00000"), "w") as fh:
        fh.write(json.dumps({
            "class": "org.apache.spark.ml.PipelineModel",
            "timestamp": int(time.time() * 1000),
            "sparkVersion": SPARK_VERSION,
            "uid": _uid("PipelineModel", path),
            "paramMap": {"stageUids": uids},
            "defaultParamMap": {},
        }) + "\n")


def _write_tree_model(path: str, idx: int, model: TreeEnsemble,
                      n_feat: int) -> str:
    common = {"featuresCol": "features", "labelCol": "label",
              "maxDepth": model.max_depth}
    num_classes = max(model.num_outputs, 2)
    if model.kind == "decision_tree":
        return _write_stage(
            path, idx,
            "org.apache.spark.ml.classification.DecisionTreeClassificationModel",
            {**common, "numFeatures": n_feat, "numClasses": num_classes},
            data_rows=_tree_node_rows(model, 0))
    if model.kind == "random_forest":
        rows = []
        for t in range(model.num_trees):
            for r in _tree_node_rows(model, t):
                rows.append({"treeID": t, "nodeData": r})
        weights = [float(w) for w in _host(model.tree_weights)]
        return _write_stage(
            path, idx,
            "org.apache.spark.ml.classification.RandomForestClassificationModel",
            {**common, "numFeatures": n_feat, "numClasses": num_classes,
             "numTrees": model.num_trees},
            data_rows=rows,
            trees_meta=[{"treeID": t, "metadata": "{}", "weights": w}
                        for t, w in enumerate(weights)])
    if model.kind in ("gbt", "xgboost"):
        # Spark GBT applies sigmoid(2 * margin) and has no margin bias; our
        # "xgboost" ensembles use sigmoid(bias + margin). Halving the tree
        # weights converts the link exactly, and the base-score bias folds
        # into tree 0's leaves (margin = Σ w_t·leaf_t, so shifting every
        # leaf of tree 0 by bias/w_0 reproduces the bias for every input).
        scale = 0.5 if model.kind == "xgboost" else 1.0
        weights_arr = _host(model.tree_weights).astype(np.float64)
        shift0 = 0.0
        if model.kind == "xgboost" and abs(model.bias) > 1e-12:
            if abs(weights_arr[0]) < 1e-12:
                raise NotImplementedError(
                    "cannot fold the margin bias into tree 0 (its weight is 0); "
                    f"refit with base_score=0.5 (bias={model.bias})")
            shift0 = float(model.bias) / float(weights_arr[0])
        rows = []
        for t in range(model.num_trees):
            for r in _tree_node_rows(model, t, leaf_shift=shift0 if t == 0 else 0.0):
                rows.append({"treeID": t, "nodeData": r})
        weights = [float(w) * scale for w in _host(model.tree_weights)]
        return _write_stage(
            path, idx, "org.apache.spark.ml.classification.GBTClassificationModel",
            {**common, "numFeatures": n_feat, "numTrees": model.num_trees},
            data_rows=rows,
            trees_meta=[{"treeID": t, "metadata": "{}", "weights": w}
                        for t, w in enumerate(weights)])
    raise ValueError(f"unknown ensemble kind {model.kind!r}")
