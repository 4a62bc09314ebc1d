"""The port's figures (``fraud_detection_tpu_torch/eval/report.py``) against
the JAX package's ``fraud_detection_tpu.eval.report`` on the same reports:
each figure is compared as PNG bytes (matplotlib's Agg output is the same
across calls in one process, which the first test pins), and the training
CLI's ``--plots`` writes the reference's figures."""

import importlib.util
import json

import numpy as np
import pytest

from fraud_detection_tpu.eval import report as jreport
from fraud_detection_tpu.eval.metrics import evaluate_classification as jeval
from fraud_detection_tpu.eval.word_associations import WordAssociation as JWA
from fraud_detection_tpu_torch.eval import report as preport
from fraud_detection_tpu_torch.eval.metrics import evaluate_classification as peval
from fraud_detection_tpu_torch.eval.word_associations import WordAssociation as PWA


def _reports(evaluate):
    rng = np.random.default_rng(4)
    out = {}
    for model in ("dt", "rf", "xgb boost"):
        out[model] = {}
        for ds in ("Validation", "Test"):
            y = rng.integers(0, 2, 80)
            p = np.clip(y * 0.6 + rng.random(80) * 0.5, 0, 1)
            out[model][ds] = evaluate(y, (p > 0.5).astype(np.int32), p)
    return out


SHADOW = {"rows": 4096, "batches": 16, "candidate_version": 2,
          "score_hist_primary": list(range(20)),
          "score_hist_candidate": list(range(20, 0, -1)), "psi": 0.0125,
          "agreement_rate": 0.97, "flag_rate_primary": 0.31,
          "flag_rate_candidate": 0.29, "mean_abs_dp": 0.0213, "dropped": 0}


def _associations(cls):
    rows = (("urgent", 0.31, 40, 2), ("prize", 0.2, 33, 1),
            ("appointment", 0.11, 3, 50), ("verify", 0.07, 25, 9))
    return [cls(bucket=i, word=w, terms=[w], importance=imp, scam_docs=s,
                non_scam_docs=n)
            for i, (w, imp, s, n) in enumerate(rows)]


def _png(path):
    with open(path, "rb") as fh:
        data = fh.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    return data


def test_figures_are_stable_across_calls(tmp_path):
    reps = _reports(peval)
    a = _png(preport.plot_metrics_comparison(reps, str(tmp_path / "a.png")))
    b = _png(preport.plot_metrics_comparison(reps, str(tmp_path / "b.png")))
    assert a == b


def test_metrics_comparison_equals_the_reference(tmp_path):
    ours = preport.plot_metrics_comparison(_reports(peval),
                                           str(tmp_path / "port.png"))
    theirs = jreport.plot_metrics_comparison(_reports(jeval),
                                             str(tmp_path / "jax.png"))
    assert _png(ours) == _png(theirs)


def test_confusion_matrices_equal_the_reference(tmp_path):
    ours = preport.plot_confusion_matrices(_reports(peval),
                                           str(tmp_path / "port"))
    theirs = jreport.plot_confusion_matrices(_reports(jeval),
                                             str(tmp_path / "jax"))
    assert [p.rsplit("/", 1)[1][4:] for p in ours] == \
        [p.rsplit("/", 1)[1][3:] for p in theirs]
    assert ours[-1].endswith("_xgb_boost.png")
    for a, b in zip(ours, theirs):
        assert _png(a) == _png(b)


def test_shadow_comparison_equals_the_reference(tmp_path):
    ours = preport.plot_shadow_comparison(SHADOW, str(tmp_path / "port.png"))
    theirs = jreport.plot_shadow_comparison(SHADOW, str(tmp_path / "jax.png"))
    assert _png(ours) == _png(theirs)
    assert preport.plot_shadow_comparison({"rows": 0}) is None


def test_word_associations_equal_the_reference(tmp_path):
    ours = preport.plot_word_associations(_associations(PWA),
                                          str(tmp_path / "port.png"), "rf")
    theirs = jreport.plot_word_associations(_associations(JWA),
                                            str(tmp_path / "jax.png"), "rf")
    assert _png(ours) == _png(theirs)
    assert preport.plot_word_associations([]) is None


def test_train_cli_plots(tmp_path, capsys):
    """``train --plots`` writes the reference's figures; the comparison
    figure equals the JAX package's drawn from the CLI's own reported
    metrics."""
    from fraud_detection_tpu_torch.app import train as ptrain

    plots, metrics = tmp_path / "plots", tmp_path / "m.json"
    assert ptrain.main(["--device", "cpu", "--n", "120", "--num-features",
                        "64", "--models", "dt,lr", "--plots", str(plots),
                        "--associations", "3",
                        "--metrics-out", str(metrics)]) == 0
    names = sorted(p.name for p in plots.iterdir())
    assert names == ["confusion_matrices_dt.png", "confusion_matrices_lr.png",
                     "metrics_comparison.png", "word_associations_dt.png",
                     "word_associations_lr.png"]
    assert "plots: " in capsys.readouterr().out
    report = json.loads(metrics.read_text())["metrics"]

    class Rep:
        def __init__(self, d):
            self.__dict__.update(d)

    reps = {m: {ds: Rep(v) for ds, v in per.items()}
            for m, per in report.items()}
    theirs = jreport.plot_metrics_comparison(reps, str(tmp_path / "jax.png"))
    assert _png(plots / "metrics_comparison.png") == _png(theirs)


def test_plots_without_matplotlib_fail_before_training(monkeypatch):
    from fraud_detection_tpu_torch.app import train as ptrain

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib"
                        else real(name, *a))
    fits = []
    monkeypatch.setattr(ptrain, "load_corpus",
                        lambda args: fits.append(args) or [])
    with pytest.raises(SystemExit, match="--plots needs matplotlib"):
        ptrain.main(["--device", "cpu", "--models", "dt", "--plots", "x"])
    assert fits == []
