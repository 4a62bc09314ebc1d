"""Mid-training checkpoint/resume of the port's forests and boosting
(``checkpoint/train_state.py``) on the CPU, against the JAX package.

* A fit interrupted at a snapshot and resumed equals the uninterrupted fit
  array for array (forest chunks draw from (seed, chunk start) alone;
  boosting replays the margin from the saved trees in round order).
* A snapshot taken under another setup refuses to resume: changed edges
  (X), labels, seed, ``tree_chunk``, bootstrap padding, config or kind.
* Snapshots read across packages: the layout, format name and array names
  are the JAX package's, and a forest's arrays equal the JAX kernel path's.
"""

import os

import numpy as np
import pytest
import torch

from fraud_detection_tpu.checkpoint import train_state as jts
from fraud_detection_tpu.models import train_trees as jt
from fraud_detection_tpu_torch.checkpoint import train_state as ts
from fraud_detection_tpu_torch.models import train_trees as pt


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    X = rng.normal(0, 1, (200, 12)).astype(np.float32)
    y = ((X[:, 0] + 0.5 * X[:, 3] + 0.2 * rng.normal(size=200)) > 0).astype(np.int32)
    return X, y


def _trees_equal(a, b):
    for name in ("feature", "threshold", "left", "right", "leaf", "tree_weights"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.kind == b.kind and a.bias == b.bias


def _gbt(X, y, n, **kw):
    return pt.fit_gradient_boosting(
        X, y, n_rounds=n, config=pt.TreeTrainConfig(max_depth=3, criterion="xgb"),
        device="cpu", **kw)


def _rf(X, y, n, seed=5, chunk=3, **kw):
    return pt.fit_random_forest(X, y, n_trees=n, seed=seed, tree_chunk=chunk,
                                config=pt.TreeTrainConfig(max_depth=3),
                                device="cpu", **kw)


@pytest.mark.parametrize("kind", ["xgb", "rf"])
def test_resume_equals_uninterrupted_fit(data, tmp_path, kind):
    X, y = data
    fit, name = (_gbt, "gradient_boosting") if kind == "xgb" else (_rf, "random_forest")
    full = fit(X, y, 10)
    ckpt = str(tmp_path / kind)
    fit(X, y, 6, checkpoint_dir=ckpt, checkpoint_every=3)   # "interrupted"
    snap = ts.load_train_state(ckpt)
    assert snap[0] == name and snap[1] == 6
    _trees_equal(fit(X, y, 10, checkpoint_dir=ckpt, checkpoint_every=3), full)


def test_gbt_resume_from_mid_cadence_snapshot(data, tmp_path):
    X, y = data
    full = _gbt(X, y, 7)
    ckpt = str(tmp_path / "mid")
    _gbt(X, y, 5, checkpoint_dir=ckpt, checkpoint_every=4)
    kind, progress, fp, arrays = ts.load_train_state(ckpt)
    assert progress == 5
    ts.save_train_state(ckpt, kind, 4, fp, {k: v[:4] for k, v in arrays.items()})
    _trees_equal(_gbt(X, y, 7, checkpoint_dir=ckpt, checkpoint_every=4), full)


def test_gbt_longer_snapshot_clamps_to_n_rounds(data, tmp_path):
    X, y = data
    ckpt = str(tmp_path / "long")
    _gbt(X, y, 8, checkpoint_dir=ckpt, checkpoint_every=4)
    short = _gbt(X, y, 5, checkpoint_dir=ckpt)
    assert short.num_trees == 5
    _trees_equal(short, _gbt(X, y, 5))


def test_rf_extension_snaps_to_chunk_grid(data, tmp_path):
    """n_trees=7 at chunk 3 saves progress 7 (off the grid); extending to
    11 rebuilds the tail from chunk start 6 and equals a fresh 11-tree
    forest."""
    X, y = data
    ckpt = str(tmp_path / "extend")
    _rf(X, y, 7, seed=11, checkpoint_dir=ckpt)
    assert ts.load_train_state(ckpt)[1] == 7
    _trees_equal(_rf(X, y, 11, seed=11, checkpoint_dir=ckpt),
                 _rf(X, y, 11, seed=11))


def test_rf_snapshot_cadence(data, tmp_path, monkeypatch):
    X, y = data
    ckpt = str(tmp_path / "cadence")
    saved = []
    save = ts.save_train_state
    monkeypatch.setattr(ts, "save_train_state",
                        lambda p, k, progress, *a: (saved.append(progress),
                                                    save(p, k, progress, *a)))
    _rf(X, y, 8, chunk=2, checkpoint_dir=ckpt, checkpoint_every=6)
    assert saved == [6, 8]


def test_crashed_save_falls_back_to_old_snapshot(data, tmp_path):
    X, y = data
    ckpt = str(tmp_path / "crashy")
    _gbt(X, y, 4, checkpoint_dir=ckpt, checkpoint_every=2)
    os.rename(ckpt, ckpt + ".old")          # the mid-rename crash state
    assert ts.load_train_state(ckpt)[1] == 4
    _trees_equal(_gbt(X, y, 6, checkpoint_dir=ckpt, checkpoint_every=2),
                 _gbt(X, y, 6))


def test_snapshot_write_is_atomic_and_cold_start(data, tmp_path):
    X, y = data
    ckpt = str(tmp_path / "atomic")
    assert ts.load_train_state(ckpt) is None
    _gbt(X, y, 4, checkpoint_dir=ckpt, checkpoint_every=2)
    kind, p1, fp, arrays = ts.load_train_state(ckpt)
    ts.save_train_state(ckpt, kind, p1, fp, arrays)
    _, p2, _, arrays2 = ts.load_train_state(ckpt)
    assert p2 == p1
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], arrays2[k])
    assert not os.path.exists(ckpt + ".tmp") and not os.path.exists(ckpt + ".old")


@pytest.mark.parametrize("change", ["edges", "labels", "seed", "tree_chunk",
                                    "bootstrap_padding", "config", "kind"])
def test_changed_setup_refuses_to_resume(data, tmp_path, monkeypatch, change):
    X, y = data
    ckpt = str(tmp_path / change)
    _rf(X, y, 6, checkpoint_dir=ckpt)
    kw = dict(n=9, checkpoint_dir=ckpt)
    match = "different setup"
    if change == "edges":
        kw["X"] = X + 1.0
    elif change == "labels":
        kw["y"] = 1 - y
    elif change == "seed":
        kw["seed"] = 6
    elif change == "tree_chunk":
        kw["chunk"] = 2
    elif change == "bootstrap_padding":
        monkeypatch.setattr(pt, "_BOOTSTRAP_ROW_TILE", 512)
    elif change == "config":
        with pytest.raises(ValueError, match=match):
            pt.fit_random_forest(X, y, n_trees=9, seed=5, tree_chunk=3,
                                 config=pt.TreeTrainConfig(max_depth=2),
                                 device="cpu", checkpoint_dir=ckpt)
        return
    else:
        with pytest.raises(ValueError, match="snapshot"):
            _gbt(X, y, 9, checkpoint_dir=ckpt)
        return
    args = {"X": X, "y": y, **kw}
    with pytest.raises(ValueError, match=match):
        _rf(args.pop("X"), args.pop("y"), args.pop("n"), **args)


def test_checkpoint_every_validated(data, tmp_path):
    X, y = data
    for fit in (_gbt, _rf):
        with pytest.raises(ValueError, match="checkpoint_every"):
            fit(X, y, 4, checkpoint_dir=str(tmp_path / "z"), checkpoint_every=0)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshots_read_across_packages(tmp_path, writer):
    arrays = {"feature": np.arange(6, dtype=np.int32).reshape(2, 3),
              "leaf_values": np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)}
    fp = {"config": {"max_depth": 3}, "n_rows": 10, "n_features": 4}
    save, load = ((jts.save_train_state, ts.load_train_state) if writer == "jax"
                  else (ts.save_train_state, jts.load_train_state))
    save(str(tmp_path / "s"), "gradient_boosting", 2, fp, arrays)
    kind, progress, got_fp, got = load(str(tmp_path / "s"))
    assert (kind, progress, got_fp) == ("gradient_boosting", 2, fp)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v)
    assert ts.FORMAT_NAME == jts.FORMAT_NAME
    assert ts.FORMAT_VERSION == jts.FORMAT_VERSION


def test_forest_snapshot_equals_jax_snapshot(data, tmp_path):
    """The same forest (the port draws the JAX package's threefry streams)
    saves the same arrays; resuming the other package's snapshot refuses,
    because each fingerprint names its own package's config fields."""
    X, y = data
    _rf(X, y, 6, checkpoint_dir=str(tmp_path / "port"))
    jt.fit_random_forest(X, y, n_trees=6, seed=5, tree_chunk=3,
                         config=jt.TreeTrainConfig(max_depth=3, use_pallas=True),
                         checkpoint_dir=str(tmp_path / "jax"))
    _, p_progress, _, p_arrays = jts.load_train_state(str(tmp_path / "port"))
    _, j_progress, _, j_arrays = ts.load_train_state(str(tmp_path / "jax"))
    assert p_progress == j_progress == 6
    assert set(p_arrays) == set(j_arrays)
    for k in ("feature", "split_bin", "left", "right"):
        np.testing.assert_array_equal(p_arrays[k], j_arrays[k], err_msg=k)
    np.testing.assert_allclose(p_arrays["node_stats"], j_arrays["node_stats"],
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="different setup"):
        _rf(X, y, 9, checkpoint_dir=str(tmp_path / "jax"))
