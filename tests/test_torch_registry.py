"""The port's model registry (``registry/registry.py``) on the CPU: its own
contract (versioned layout, atomic publish, integrity, watch, audit), and a
version published by either package verifying and loading in the other
with the same labels; the training CLI's ``--publish``."""

import json
import os
import shutil
import threading

import jax.numpy as jnp
import numpy as np
import pytest

from fraud_detection_tpu.featurize.tfidf import HashingTfIdfFeaturizer as JFeat
from fraud_detection_tpu.models.linear import LogisticRegression as JLR
from fraud_detection_tpu.registry import ModelRegistry as JRegistry
from fraud_detection_tpu_torch.app import train as ptrain
from fraud_detection_tpu_torch.checkpoint.native import save_checkpoint
from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
from fraud_detection_tpu_torch.models import linear as plinear
from fraud_detection_tpu_torch.registry import (ModelRegistry, RegistryError,
                                                RegistryIntegrityError)
from tests.fixtures import BENIGN_DIALOGUE, SCAM_DIALOGUE
from tests.torch_parity import port_featurizer, port_model

TEXTS = [SCAM_DIALOGUE, BENIGN_DIALOGUE, "hello there", "", "urgent prize"]


def make_featurizer(num_features=256):
    feat = HashingTfIdfFeaturizer(num_features=num_features)
    feat.fit_idf([SCAM_DIALOGUE, BENIGN_DIALOGUE])
    return feat


def const_model(logit, num_features=256):
    """LR with zero weights: every input scores sigmoid(logit)."""
    return plinear.LogisticRegression.from_arrays(
        np.zeros(num_features, np.float32), float(logit), device="cpu")


@pytest.fixture()
def registry(tmp_path):
    return ModelRegistry(str(tmp_path / "registry"))


def test_publish_versioned_layout_and_manifest(registry):
    feat = make_featurizer()
    mv1 = registry.publish(feat, const_model(-5.0), metrics={"auc": 0.91})
    registry.publish(feat, const_model(5.0))
    assert registry.list_versions() == [1, 2]
    assert registry.latest().version == 2
    assert mv1.name == "v0001" and os.path.isdir(mv1.checkpoint_path)
    m = registry.get(1).manifest
    assert m["schema_version"] == 1
    assert m["model_kind"] == "logistic_regression"
    assert m["metrics"] == {"auc": 0.91} and m["parent"] is None
    assert isinstance(m["created_at"], float)
    assert set(m["files"]) >= {"checkpoint/manifest.json", "checkpoint/arrays.npz"}
    for meta in m["files"].values():
        assert len(meta["sha256"]) == 64 and meta["bytes"] > 0
    assert registry.get(2).manifest["parent"] == 1


def test_load_round_trips_servable_pipeline(registry, tmp_path):
    feat = make_featurizer()
    registry.publish(feat, const_model(-8.0))
    save_checkpoint(str(tmp_path / "ckpt"), feat, const_model(8.0))
    registry.publish_dir(str(tmp_path / "ckpt"), metrics={"note": "copied"})
    mv, pipe = registry.load(1, device="cpu", batch_size=8)
    assert mv.version == 1 and pipe.batch_size == 8
    assert pipe.predict_one(SCAM_DIALOGUE)[0] == 0
    mv, pipe = registry.load(device="cpu")           # latest
    assert mv.version == 2 and pipe.predict_one(BENIGN_DIALOGUE)[0] == 1
    assert registry.get(2).manifest["metrics"] == {"note": "copied"}
    with pytest.raises(RegistryError, match="not a native checkpoint"):
        registry.publish_dir(str(tmp_path))


def test_torn_publish_never_visible(registry):
    registry.publish(make_featurizer(), const_model(-5.0))
    leftover = os.path.join(registry.root, ".publish-crashed", "checkpoint")
    os.makedirs(leftover)
    with open(os.path.join(leftover, "arrays.npz"), "wb") as fh:
        fh.write(b"partial bytes")
    shutil.copytree(os.path.join(registry.root, "v0001", "checkpoint"),
                    os.path.join(registry.root, "v0002", "checkpoint"))
    assert registry.list_versions() == [1]
    assert registry.latest().version == 1
    assert [mv.version for mv in registry.poll_new(0)] == [1]
    with pytest.raises(RegistryError, match="does not exist"):
        registry.get(2)


@pytest.mark.parametrize("damage,match", [("flip", "hash mismatch"),
                                          ("truncate", "truncated"),
                                          ("remove", "missing")])
def test_damaged_checkpoint_fails_verification(registry, damage, match):
    mv = registry.publish(make_featurizer(), const_model(-5.0))
    arrays = os.path.join(mv.checkpoint_path, "arrays.npz")
    blob = bytearray(open(arrays, "rb").read())
    if damage == "remove":
        os.remove(arrays)
    else:
        if damage == "flip":
            blob[len(blob) // 2] ^= 0xFF
        else:
            blob = blob[: len(blob) // 2]
        with open(arrays, "wb") as fh:
            fh.write(bytes(blob))
    with pytest.raises(RegistryIntegrityError, match=match):
        registry.verify(1)
    with pytest.raises(RegistryIntegrityError, match="arrays.npz"):
        registry.load(1, device="cpu")


def test_version_number_race_retries(registry, monkeypatch):
    feat = make_featurizer()
    registry.publish(feat, const_model(-5.0))
    monkeypatch.setattr(registry, "list_versions", lambda: [])
    mv = registry._publish_with(
        lambda d: save_checkpoint(d, feat, const_model(5.0)),
        metrics=None, parent=None, extra=None)
    assert mv.version == 2
    monkeypatch.undo()
    assert registry.list_versions() == [1, 2]
    registry.verify(2)


def test_empty_registry_load_is_clear_error(registry):
    with pytest.raises(RegistryError, match="no published versions"):
        registry.load(device="cpu")


def test_watch_yields_new_versions(registry):
    feat = make_featurizer()
    registry.publish(feat, const_model(-5.0))
    stop = threading.Event()
    gen = registry.watch(interval=0.01, after=0, stop=stop)
    seen = [next(gen).version]
    registry.publish(feat, const_model(5.0))
    seen.append(next(gen).version)
    stop.set()
    assert seen == [1, 2] and list(gen) == []


def test_audit_log_append_and_read(registry):
    registry.publish(make_featurizer(), const_model(-5.0), metrics={"auc": 0.9})
    registry.audit("rollback", version=1, previous=2)
    events = registry.read_audit()
    assert [e["event"] for e in events] == ["publish", "rollback"]
    assert events[0]["version"] == 1 and events[0]["metrics"] == {"auc": 0.9}
    assert events[1]["previous"] == 2 and all("ts" in e for e in events)
    with open(os.path.join(registry.root, "audit.jsonl")) as fh:
        assert [json.loads(line)["event"] for line in fh] == ["publish",
                                                              "rollback"]


def _jax_pair():
    jfeat = JFeat(num_features=512)
    jfeat.fit_idf(TEXTS)
    w = np.random.default_rng(2).normal(0, 3, 512).astype(np.float32)
    return jfeat, JLR(weights=jnp.asarray(w), intercept=jnp.float32(-0.5))


@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_version_from_either_package_verifies_and_loads_in_both(tmp_path,
                                                                publisher):
    jfeat, jlr = _jax_pair()
    root = str(tmp_path / "shared")
    if publisher == "jax":
        JRegistry(root).publish(jfeat, jlr, metrics={"auc": 0.5})
    else:
        ModelRegistry(root).publish(port_featurizer(jfeat), port_model(jlr),
                                    metrics={"auc": 0.5})
    jmv, jpipe = JRegistry(root).load(1)
    pmv, ppipe = ModelRegistry(root).load(1, device="cpu")
    assert pmv.manifest == jmv.manifest
    assert ModelRegistry(root).verify(1).manifest["metrics"] == {"auc": 0.5}
    got, want = ppipe.predict(TEXTS), jpipe.predict(TEXTS)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_allclose(got.probabilities, want.probabilities,
                               atol=1e-6)
    assert [e["event"] for e in JRegistry(root).read_audit()] == ["publish"]


def test_train_cli_publish(tmp_path, capsys):
    root = str(tmp_path / "registry")
    assert ptrain.main(["--device", "cpu", "--n", "240", "--num-features",
                        "1024", "--models", "lr", "--publish", f"lr={root}"]) == 0
    reg = ModelRegistry(root)
    assert reg.list_versions() == [1]
    m = reg.get(1).manifest
    assert m["model_kind"] == "logistic_regression"
    assert set(m["metrics"]) == {"Validation", "Test"}
    assert m["trained_with"] == {"model": "lr", "data": "synthetic",
                                 "seed": 42, "featurizer": "hashing"}
    _, pipe = reg.load(1, device="cpu")
    assert pipe.predict_one(SCAM_DIALOGUE)[0] in (0, 1)
    _, jpipe = JRegistry(root).load(1)
    assert jpipe.predict([SCAM_DIALOGUE, BENIGN_DIALOGUE]).labels.tolist() == \
        pipe.predict([SCAM_DIALOGUE, BENIGN_DIALOGUE]).labels.tolist()
    assert "published lr ->" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--publish expects"):
        ptrain.main(["--device", "cpu", "--n", "100", "--models", "lr",
                     "--publish", "dt=somewhere"])
