"""Evaluation metrics with Spark-evaluator-matching definitions — a copy of
``fraud_detection_tpu/eval/metrics.py`` (numpy only).

Mirrors the reference's evaluation block (fraud_detection_spark.py:93-123):
accuracy / weightedPrecision / weightedRecall / F1 via Spark's
``MulticlassClassificationEvaluator`` semantics (per-class metrics weighted by
true-class frequency; 0/0 treated as 0), AUC via
``BinaryClassificationEvaluator``'s areaUnderROC (trapezoidal ROC with score
ties grouped — computed here as the tie-corrected Mann-Whitney statistic,
which is algebraically identical), and confusion matrices (crosstab
equivalent).

Implementations are numpy (host): evaluation of a few-thousand-row test split
is not device-bound work; the streaming metric counters live in stream/.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


@dataclass
class ClassificationReport:
    accuracy: float
    weighted_precision: float
    weighted_recall: float
    f1: float
    auc: Optional[float]
    confusion: np.ndarray  # (C, C), rows = true label, cols = predicted

    def as_dict(self) -> Dict[str, float]:
        out = {
            "accuracy": self.accuracy,
            "weighted_precision": self.weighted_precision,
            "weighted_recall": self.weighted_recall,
            "f1": self.f1,
        }
        if self.auc is not None:
            out["auc"] = self.auc
        return out


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray, num_classes: int = 2) -> np.ndarray:
    y_true = np.asarray(y_true, np.int64)
    y_pred = np.asarray(y_pred, np.int64)
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def _weighted_prf(cm: np.ndarray):
    """Spark MulticlassClassificationEvaluator: per-class P/R/F1 weighted by
    true-class counts; empty denominators contribute 0."""
    true_counts = cm.sum(axis=1).astype(np.float64)
    pred_counts = cm.sum(axis=0).astype(np.float64)
    diag = np.diag(cm).astype(np.float64)
    total = cm.sum()
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_counts > 0, diag / pred_counts, 0.0)
        recall = np.where(true_counts > 0, diag / true_counts, 0.0)
        f1 = np.where(precision + recall > 0, 2 * precision * recall / (precision + recall), 0.0)
    weights = true_counts / total
    return float(weights @ precision), float(weights @ recall), float(weights @ f1)


def roc_auc(y_true: np.ndarray, scores: np.ndarray) -> float:
    """Area under ROC, trapezoidal with tied scores grouped.

    Tie-corrected Mann-Whitney: AUC = (R1 - n1(n1+1)/2) / (n1*n0) with average
    ranks — identical to Spark's areaUnderROC, which walks score-descending
    threshold groups.
    """
    y_true = np.asarray(y_true)
    scores = np.asarray(scores, np.float64)
    n1 = int(np.sum(y_true == 1))
    n0 = len(y_true) - n1
    if n1 == 0 or n0 == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0  # average rank, 1-based
        i = j + 1
    r1 = float(np.sum(ranks[np.asarray(y_true) == 1]))
    return (r1 - n1 * (n1 + 1) / 2.0) / (n1 * n0)


def evaluate_classification(
    y_true, y_pred, scores=None, num_classes: int = 2
) -> ClassificationReport:
    """Full Spark-parity evaluation block (accuracy/wP/wR/F1/AUC/confusion)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    cm = confusion_matrix(y_true, y_pred, num_classes)
    wp, wr, f1 = _weighted_prf(cm)
    auc = roc_auc(y_true, scores) if scores is not None and num_classes == 2 else None
    return ClassificationReport(
        accuracy=float(np.mean(y_true == y_pred)),
        weighted_precision=wp,
        weighted_recall=wr,
        f1=f1,
        auc=auc,
        confusion=cm,
    )
