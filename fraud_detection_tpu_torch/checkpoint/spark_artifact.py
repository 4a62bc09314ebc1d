"""Reader for Spark ML ``PipelineModel`` save directories — twin of
``fraud_detection_tpu/checkpoint/spark_artifact.py``, reading the weight
tables with the port's own parquet codec (``checkpoint/parquet.py``).

The on-disk format is per-stage directories with a single-line JSON
metadata file plus optional snappy-parquet weight tables:

    <root>/metadata/part-00000                      pipeline class + stage uids
    <root>/stages/<i>_<Class>_<uid>/metadata/...    stage params (JSON)
    <root>/stages/<i>_<Class>_<uid>/data/*.parquet  stage weights (if any)

Supported stages (matching both the shipped artifact and what the reference
training script would save — fraud_detection_spark.py:389-393):
  Tokenizer, RegexTokenizer (params carried; serving rejects non-default
  semantics), StopWordsRemover, HashingTF, CountVectorizerModel, IDFModel,
  StringIndexerModel (label map only), LogisticRegressionModel,
  DecisionTreeClassificationModel, RandomForestClassificationModel,
  GBTClassificationModel.

Everything is decoded into plain numpy / python structures; the models/
layer turns them into tensors on the card
(``ServingPipeline.from_spark_artifact``, ``trees.from_spark_stage``).
"""

from __future__ import annotations

import glob
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from fraud_detection_tpu_torch.checkpoint.parquet import read_rows


# ---------------------------------------------------------------------------
# Low-level helpers
# ---------------------------------------------------------------------------

def _read_metadata(stage_dir: str) -> Dict[str, Any]:
    parts = sorted(glob.glob(os.path.join(stage_dir, "metadata", "part-*")))
    if not parts:
        raise FileNotFoundError(f"no metadata part file under {stage_dir}")
    with open(parts[0]) as f:
        return json.loads(f.readline())


def _read_parquet(stage_dir: str) -> List[Dict[str, Any]]:
    """The rows of every part file under ``<stage_dir>/data``, in order."""
    files = sorted(
        f for f in glob.glob(os.path.join(stage_dir, "data", "part-*"))
        if not os.path.basename(f).startswith(".")
    )
    if not files:
        raise FileNotFoundError(f"no parquet data under {stage_dir}")
    rows: List[Dict[str, Any]] = []
    for f in files:
        rows.extend(read_rows(f))
    return rows


def _params(meta: Dict[str, Any]) -> Dict[str, Any]:
    """Effective params: defaults overlaid with explicitly-set params."""
    merged = dict(meta.get("defaultParamMap", {}))
    merged.update(meta.get("paramMap", {}))
    return merged


def _decode_vector(struct: Dict[str, Any], size_hint: Optional[int] = None) -> np.ndarray:
    """Decode a Spark ml.linalg Vector struct {type, size, indices, values}.

    type 0 = sparse, type 1 = dense.
    """
    if struct["type"] == 1:
        return np.asarray(struct["values"], np.float64)
    size = struct["size"] if struct["size"] is not None else size_hint
    out = np.zeros(int(size), np.float64)
    idx = np.asarray(struct["indices"], np.int64)
    out[idx] = np.asarray(struct["values"], np.float64)
    return out


def _decode_matrix(struct: Dict[str, Any]) -> np.ndarray:
    """Decode a Spark ml.linalg Matrix struct (dense or CSC sparse)."""
    rows, cols = int(struct["numRows"]), int(struct["numCols"])
    transposed = bool(struct.get("isTransposed", False))
    if struct["type"] == 1:  # dense, column-major unless transposed
        vals = np.asarray(struct["values"], np.float64)
        mat = vals.reshape((cols, rows)).T if not transposed else vals.reshape((rows, cols))
        return mat
    # sparse CSC (CSR when transposed)
    col_ptrs = np.asarray(struct["colPtrs"], np.int64)
    row_idx = np.asarray(struct["rowIndices"], np.int64)
    vals = np.asarray(struct["values"], np.float64)
    mat = np.zeros((rows, cols), np.float64)
    if transposed:  # stored as CSR over (rows, cols)
        for r in range(rows):
            lo, hi = col_ptrs[r], col_ptrs[r + 1]
            mat[r, row_idx[lo:hi]] = vals[lo:hi]
    else:
        for c in range(cols):
            lo, hi = col_ptrs[c], col_ptrs[c + 1]
            mat[row_idx[lo:hi], c] = vals[lo:hi]
    return mat


# ---------------------------------------------------------------------------
# Stage dataclasses
# ---------------------------------------------------------------------------

@dataclass
class TokenizerStage:
    input_col: str
    output_col: str


@dataclass
class RegexTokenizerStage:
    """Spark RegexTokenizer — carried with its full params; serving layers that
    only implement plain-Tokenizer semantics must reject this stage rather
    than silently mis-tokenizing."""
    pattern: str
    gaps: bool
    min_token_length: int
    to_lowercase: bool
    input_col: str
    output_col: str


@dataclass
class StopWordsStage:
    stopwords: List[str]
    case_sensitive: bool
    input_col: str
    output_col: str


@dataclass
class HashingTFStage:
    num_features: int
    binary: bool
    input_col: str
    output_col: str


@dataclass
class CountVectorizerStage:
    vocabulary: List[str]
    min_tf: float
    binary: bool
    input_col: str
    output_col: str


@dataclass
class IDFStage:
    idf: np.ndarray          # (F,) float64
    doc_freq: np.ndarray     # (F,) int64
    num_docs: int
    min_doc_freq: int
    input_col: str
    output_col: str


@dataclass
class StringIndexerStage:
    labels: List[str]
    input_col: str
    output_col: str


@dataclass
class LogisticRegressionStage:
    coefficients: np.ndarray   # (F,) binary or (C, F) multinomial
    intercept: np.ndarray      # scalar array () or (C,)
    threshold: float
    num_classes: int
    is_multinomial: bool
    features_col: str
    label_col: str


@dataclass
class TreeNode:
    """Flat Spark tree node row (see models/trees.py for the flat encoding).

    Only continuous splits are supported (num_categories < 0); the loader
    rejects categorical splits rather than silently mis-decoding them.
    """
    id: int
    prediction: float
    impurity: float
    impurity_stats: np.ndarray
    gain: float
    left: int
    right: int
    split_feature: int
    split_threshold: float
    num_categories: int = -1


@dataclass
class TreeEnsembleStage:
    kind: str                   # "decision_tree" | "random_forest" | "gbt"
    trees: List[List[TreeNode]]
    tree_weights: np.ndarray
    num_features: int
    num_classes: int
    features_col: str
    label_col: str


# ---------------------------------------------------------------------------
# Stage parsers
# ---------------------------------------------------------------------------

def _read_tree_weights(stage_dir: str) -> Optional[np.ndarray]:
    """Ensemble tree weights from the ``treesMetadata`` parquet Spark persists.

    Layout: rows of (treeID, metadata JSON string, weights double). Absent for
    single DecisionTree stages.
    """
    files = sorted(
        f for f in glob.glob(os.path.join(stage_dir, "treesMetadata", "part-*"))
        if not os.path.basename(f).startswith(".") and f.endswith(".parquet")
    )
    if not files:
        return None
    rows: List[Dict[str, Any]] = []
    for f in files:
        rows.extend(read_rows(f))
    rows.sort(key=lambda r: int(r["treeID"]))
    return np.asarray([float(r["weights"]) for r in rows], np.float64)


def _parse_tree_stage(stage_dir: str, meta: Dict[str, Any], kind: str) -> TreeEnsembleStage:
    p = _params(meta)
    table = _read_parquet(stage_dir)
    trees_nodes: Dict[int, List[TreeNode]] = {}
    for row in table:
        tree_id = int(row.get("treeID", 0))
        node = row.get("nodeData", row)
        split = node.get("split", {}) or {}
        thresh_list = split.get("leftCategoriesOrThreshold") or []
        num_categories = int(split.get("numCategories", -1))
        if num_categories >= 0 and int(split.get("featureIndex", -1)) >= 0:
            raise NotImplementedError(
                f"categorical split on feature {split['featureIndex']} "
                f"({num_categories} categories): only continuous splits are "
                "supported — decoding the category list as a threshold would "
                "silently corrupt predictions")
        node_obj = TreeNode(
            id=int(node["id"]),
            prediction=float(node["prediction"]),
            impurity=float(node.get("impurity", 0.0)),
            impurity_stats=np.asarray(node.get("impurityStats") or [], np.float64),
            gain=float(node.get("gain", -1.0)),
            left=int(node.get("leftChild", -1)),
            right=int(node.get("rightChild", -1)),
            split_feature=int(split.get("featureIndex", -1)),
            split_threshold=float(thresh_list[0]) if thresh_list else 0.0,
            num_categories=num_categories,
        )
        trees_nodes.setdefault(tree_id, []).append(node_obj)
    trees = [sorted(trees_nodes[k], key=lambda n: n.id) for k in sorted(trees_nodes)]
    tree_weights = _read_tree_weights(stage_dir)
    if tree_weights is None:
        tree_weights = np.ones(len(trees))
    elif len(tree_weights) != len(trees):
        raise ValueError(
            f"treesMetadata has {len(tree_weights)} weights for {len(trees)} trees")
    return TreeEnsembleStage(
        kind=kind,
        trees=trees,
        tree_weights=tree_weights,
        num_features=int(meta.get("numFeatures", p.get("numFeatures", 0)) or 0),
        num_classes=int(meta.get("numClasses", p.get("numClasses", 2)) or 2),
        features_col=p.get("featuresCol", "features"),
        label_col=p.get("labelCol", "label"),
    )


def _parse_stage(stage_dir: str) -> Any:
    meta = _read_metadata(stage_dir)
    cls = meta["class"].rsplit(".", 1)[-1]
    p = _params(meta)

    if cls == "Tokenizer":
        return TokenizerStage(input_col=p["inputCol"], output_col=p["outputCol"])

    if cls == "RegexTokenizer":
        return RegexTokenizerStage(
            pattern=str(p.get("pattern", "\\s+")),
            gaps=bool(p.get("gaps", True)),
            min_token_length=int(p.get("minTokenLength", 1)),
            to_lowercase=bool(p.get("toLowercase", True)),
            input_col=p["inputCol"],
            output_col=p["outputCol"],
        )

    if cls == "StopWordsRemover":
        return StopWordsStage(
            stopwords=list(p["stopWords"]),
            case_sensitive=bool(p.get("caseSensitive", False)),
            input_col=p["inputCol"],
            output_col=p["outputCol"],
        )

    if cls == "HashingTF":
        return HashingTFStage(
            num_features=int(p.get("numFeatures", 1 << 18)),
            binary=bool(p.get("binary", False)),
            input_col=p["inputCol"],
            output_col=p["outputCol"],
        )

    if cls == "CountVectorizerModel":
        row = _read_parquet(stage_dir)[0]
        return CountVectorizerStage(
            vocabulary=list(row["vocabulary"]),
            min_tf=float(p.get("minTF", 1.0)),
            binary=bool(p.get("binary", False)),
            input_col=p["inputCol"],
            output_col=p["outputCol"],
        )

    if cls == "IDFModel":
        row = _read_parquet(stage_dir)[0]
        idf = _decode_vector(row["idf"])
        doc_freq = np.asarray(row.get("docFreq", np.zeros_like(idf)), np.int64)
        return IDFStage(
            idf=idf,
            doc_freq=doc_freq,
            num_docs=int(row.get("numDocs", 0)),
            min_doc_freq=int(p.get("minDocFreq", 0)),
            input_col=p["inputCol"],
            output_col=p["outputCol"],
        )

    if cls == "StringIndexerModel":
        row = _read_parquet(stage_dir)[0]
        labels = row.get("labelsArray", [row.get("labels", [])])
        if labels and isinstance(labels[0], list):
            labels = labels[0]
        return StringIndexerStage(
            labels=list(labels), input_col=p.get("inputCol", ""), output_col=p.get("outputCol", ""))

    if cls == "LogisticRegressionModel":
        row = _read_parquet(stage_dir)[0]
        coef = _decode_matrix(row["coefficientMatrix"])
        intercept = _decode_vector(row["interceptVector"], size_hint=coef.shape[0])
        is_multi = bool(row["isMultinomial"])
        if not is_multi:
            coef = coef.reshape(-1)
            intercept = intercept.reshape(())
        return LogisticRegressionStage(
            coefficients=coef,
            intercept=intercept,
            threshold=float(p.get("threshold", 0.5)),
            num_classes=int(row["numClasses"]),
            is_multinomial=is_multi,
            features_col=p.get("featuresCol", "features"),
            label_col=p.get("labelCol", "label"),
        )

    if cls == "DecisionTreeClassificationModel":
        return _parse_tree_stage(stage_dir, meta, "decision_tree")
    if cls == "RandomForestClassificationModel":
        return _parse_tree_stage(stage_dir, meta, "random_forest")
    if cls == "GBTClassificationModel":
        return _parse_tree_stage(stage_dir, meta, "gbt")

    raise NotImplementedError(f"unsupported Spark stage class: {meta['class']}")


# ---------------------------------------------------------------------------
# Pipeline artifact
# ---------------------------------------------------------------------------

@dataclass
class SparkPipelineArtifact:
    """A decoded Spark PipelineModel: ordered stages + convenience accessors."""

    path: str
    spark_version: str
    stages: List[Any] = field(default_factory=list)

    def _first(self, kind) -> Optional[Any]:
        for s in self.stages:
            if isinstance(s, kind):
                return s
        return None

    @property
    def stopwords(self) -> Optional[StopWordsStage]:
        return self._first(StopWordsStage)

    @property
    def hashing_tf(self) -> Optional[HashingTFStage]:
        return self._first(HashingTFStage)

    @property
    def count_vectorizer(self) -> Optional[CountVectorizerStage]:
        return self._first(CountVectorizerStage)

    @property
    def idf(self) -> Optional[IDFStage]:
        return self._first(IDFStage)

    @property
    def logistic_regression(self) -> Optional[LogisticRegressionStage]:
        return self._first(LogisticRegressionStage)

    @property
    def tree_ensemble(self) -> Optional[TreeEnsembleStage]:
        return self._first(TreeEnsembleStage)


def load_spark_pipeline(path: str) -> SparkPipelineArtifact:
    """Load a Spark ML PipelineModel save directory into numpy structures."""
    meta = _read_metadata(path)
    if meta.get("class") != "org.apache.spark.ml.PipelineModel":
        raise ValueError(f"{path} is not a Spark PipelineModel (class={meta.get('class')})")
    stage_uids: Sequence[str] = meta["paramMap"]["stageUids"]
    stages: List[Any] = []
    for i, uid in enumerate(stage_uids):
        matches = glob.glob(os.path.join(path, "stages", f"{i}_*{uid.split('_')[-1]}*"))
        if not matches:
            matches = glob.glob(os.path.join(path, "stages", f"{i}_*"))
        if not matches:
            raise FileNotFoundError(f"stage {i} ({uid}) missing under {path}/stages")
        stages.append(_parse_stage(matches[0]))
    return SparkPipelineArtifact(
        path=path, spark_version=meta.get("sparkVersion", "unknown"), stages=stages)
