"""Result visualization: metric comparisons, confusion matrices, associations —
twin of ``fraud_detection_tpu/eval/report.py``.

Matplotlib equivalents of the reference's plotting block
(fraud_detection_spark.py:125-222: annotated metric bars per dataset saved to
metrics_comparison.png, per-model confusion-matrix heatmaps) and the word-
association plots (fraud_detection_spark.py:279-324: occurrence counts per
label + scam-ratio-vs-importance). Pure host-side output rendering — all
figures use the Agg backend so headless runs work. matplotlib is imported
when the first figure is drawn, not with this module: the training CLI asks
for it only under ``--plots``, and a machine without it imports the rest of
the package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from fraud_detection_tpu_torch.eval.metrics import ClassificationReport
from fraud_detection_tpu_torch.eval.word_associations import WordAssociation

METRIC_KEYS = ["accuracy", "weighted_precision", "weighted_recall", "f1", "auc"]


def _pyplot():
    """matplotlib's pyplot on the Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_metrics_comparison(
    results: Dict[str, Dict[str, ClassificationReport]],
    path: str = "metrics_comparison.png",
    metrics: Sequence[str] = METRIC_KEYS,
) -> str:
    """Grouped, annotated metric bars — one panel per dataset.

    ``results`` maps model name -> dataset name -> report (the same nesting
    the reference prints at fraud_detection_spark.py:361-367).
    """
    plt = _pyplot()
    datasets: List[str] = sorted({d for per_model in results.values() for d in per_model})
    models = list(results)
    fig, axes = plt.subplots(1, max(len(datasets), 1),
                             figsize=(6 * max(len(datasets), 1), 4.5), squeeze=False)
    width = 0.8 / max(len(models), 1)
    for ax, ds in zip(axes[0], datasets):
        xs = np.arange(len(metrics))
        for mi, model in enumerate(models):
            rep = results[model].get(ds)
            if rep is None:
                continue
            vals = [getattr(rep, m) if getattr(rep, m) is not None else 0.0
                    for m in metrics]
            bars = ax.bar(xs + mi * width, vals, width, label=model)
            for rect, v in zip(bars, vals):
                ax.annotate(f"{v:.3f}", (rect.get_x() + rect.get_width() / 2, v),
                            ha="center", va="bottom", fontsize=7, rotation=90)
        ax.set_title(ds)
        ax.set_xticks(xs + width * (len(models) - 1) / 2)
        ax.set_xticklabels(metrics, rotation=30, ha="right", fontsize=8)
        ax.set_ylim(0, 1.1)
        ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_confusion_matrices(
    results: Dict[str, Dict[str, ClassificationReport]],
    path_prefix: str = "confusion_matrices",
    class_names: Sequence[str] = ("non-scam", "scam"),
) -> List[str]:
    """One heatmap figure per model (datasets as columns), annotated counts."""
    plt = _pyplot()
    paths = []
    for model, per_ds in results.items():
        datasets = list(per_ds)
        fig, axes = plt.subplots(1, max(len(datasets), 1),
                                 figsize=(4 * max(len(datasets), 1), 3.6), squeeze=False)
        for ax, ds in zip(axes[0], datasets):
            cm = np.asarray(per_ds[ds].confusion)
            im = ax.imshow(cm, cmap="Blues")
            for i in range(cm.shape[0]):
                for j in range(cm.shape[1]):
                    ax.text(j, i, f"{int(cm[i, j])}", ha="center", va="center",
                            color="white" if cm[i, j] > cm.max() / 2 else "black")
            ax.set_title(f"{model} — {ds}", fontsize=9)
            ax.set_xlabel("predicted")
            ax.set_ylabel("true")
            ax.set_xticks(range(len(class_names)), class_names, fontsize=8)
            ax.set_yticks(range(len(class_names)), class_names, fontsize=8)
            fig.colorbar(im, ax=ax, shrink=0.8)
        fig.tight_layout()
        out = f"{path_prefix}_{model.lower().replace(' ', '_')}.png"
        fig.savefig(out, dpi=120)
        plt.close(fig)
        paths.append(out)
    return paths


def plot_shadow_comparison(
    snapshot: dict,
    path: str = "shadow_comparison.png",
) -> Optional[str]:
    """Render a ShadowScorer snapshot (registry/shadow.py) — the candidate
    vs primary comparison an operator reads before trusting an
    auto-promotion: overlaid score-distribution histograms (the PSI's
    input), the agreement/flag-rate bars, and the headline divergence
    numbers. Returns None when the snapshot holds no scored rows."""
    rows = snapshot.get("rows") or 0
    if rows == 0:
        return None
    plt = _pyplot()
    p_hist = np.asarray(snapshot["score_hist_primary"], np.float64)
    c_hist = np.asarray(snapshot["score_hist_candidate"], np.float64)
    n_bins = len(p_hist)
    edges = np.linspace(0.0, 1.0, n_bins + 1)[:-1]
    width = 1.0 / n_bins

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.2))
    ax1.bar(edges, p_hist / max(p_hist.sum(), 1), width, align="edge",
            alpha=0.6, label="primary", color="#5bc0de")
    ax1.bar(edges, c_hist / max(c_hist.sum(), 1), width, align="edge",
            alpha=0.6, label=f"candidate v{snapshot.get('candidate_version')}",
            color="#d9534f")
    ax1.set_xlabel("p(scam)")
    ax1.set_ylabel("fraction of rows")
    ax1.set_title(f"score distribution (PSI = {snapshot.get('psi'):.4f})")
    ax1.legend(fontsize=8)

    labels = ["agreement", "flag rate\n(primary)", "flag rate\n(candidate)"]
    vals = [snapshot.get("agreement_rate") or 0.0,
            snapshot.get("flag_rate_primary") or 0.0,
            snapshot.get("flag_rate_candidate") or 0.0]
    bars = ax2.bar(labels, vals, color=["#5cb85c", "#5bc0de", "#d9534f"])
    for rect, v in zip(bars, vals):
        ax2.annotate(f"{v:.4f}", (rect.get_x() + rect.get_width() / 2, v),
                     ha="center", va="bottom", fontsize=8)
    ax2.set_ylim(0, 1.1)
    ax2.set_title(f"{rows} rows / {snapshot.get('batches')} batches — "
                  f"mean |Δp| = {snapshot.get('mean_abs_dp'):.4f}, "
                  f"dropped = {snapshot.get('dropped')}", fontsize=9)

    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_word_associations(
    associations: Sequence[WordAssociation],
    path: str = "word_associations.png",
    model_name: str = "model",
) -> Optional[str]:
    """Counts-per-label bars + scam-ratio-vs-importance scatter
    (fraud_detection_spark.py:279-324 equivalents)."""
    if not associations:
        return None
    plt = _pyplot()
    words = [a.word for a in associations]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(13, 0.45 * len(words) + 2.5))

    ys = np.arange(len(words))
    ax1.barh(ys - 0.2, [a.scam_docs for a in associations], 0.4,
             label="scam docs", color="#d9534f")
    ax1.barh(ys + 0.2, [a.non_scam_docs for a in associations], 0.4,
             label="non-scam docs", color="#5bc0de")
    ax1.set_yticks(ys, words, fontsize=8)
    ax1.invert_yaxis()
    ax1.set_title(f"{model_name}: top-feature document counts by label")
    ax1.legend(fontsize=8)

    ax2.scatter([a.importance for a in associations],
                [a.scam_ratio for a in associations], color="#d9534f")
    for a in associations:
        ax2.annotate(a.word, (a.importance, a.scam_ratio), fontsize=7,
                     xytext=(3, 3), textcoords="offset points")
    ax2.set_xlabel("feature importance")
    ax2.set_ylabel("scam ratio")
    ax2.set_ylim(-0.05, 1.05)
    ax2.set_title("scam ratio vs importance")

    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
