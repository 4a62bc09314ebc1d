"""The port's ServingPipeline against the JAX package's, on the CPU.

A JAX ``synthetic_demo_pipeline(batch_size=32, n=200, seed=7)`` (LR and a
decision tree) is carried across with ``convert``. The port featurizes on
its device path (``featurize_device=True, device="cpu"``: the scan kernel's
plain torch version) and the reference is the JAX
``ServingPipeline(featurize_device="interpret")``. Labels must be equal and
|Δp| < 1e-6 for fp32 LR, int8 LR and the tree (the JAX package's own pin
for device vs host featurize; margins sum in another order than XLA's).
"""

import numpy as np
import pytest
import torch

from fraud_detection_tpu.data import generate_corpus
from fraud_detection_tpu.models.pipeline import ServingPipeline as JPipe
from fraud_detection_tpu.models.pipeline import synthetic_demo_pipeline
from fraud_detection_tpu_torch.models import linear as tlinear
from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
from tests.torch_parity import pallas_store  # noqa: F401 — fixture
from tests.torch_parity import port_featurizer, port_model

pytestmark = pytest.mark.usefixtures("pallas_store")

_TOL = 1e-6


@pytest.fixture(scope="module")
def texts():
    return [d.text for d in generate_corpus(n=64, seed=5)] + ["", "!!!"]


@pytest.fixture(scope="module")
def lr_pipe():
    return synthetic_demo_pipeline(batch_size=32, n=200, seed=7)


@pytest.fixture(scope="module")
def dt_pipe():
    return synthetic_demo_pipeline(batch_size=32, n=200, seed=7, model="dt")


def _port(jpipe, **kw):
    return ServingPipeline(port_featurizer(jpipe.featurizer),
                           port_model(jpipe.model), batch_size=32,
                           device="cpu", **kw)


def _assert_close(got, want):
    np.testing.assert_array_equal(got.labels, want.labels)
    assert float(np.abs(got.probabilities - want.probabilities).max()) < _TOL


@pytest.mark.parametrize("int8", [False, True])
def test_lr_device_featurize_matches_jax(lr_pipe, texts, int8):
    jdev = JPipe(lr_pipe.featurizer, lr_pipe.model, batch_size=32, int8=int8,
                 featurize_device="interpret")
    port = _port(lr_pipe, int8=int8, featurize_device=True)
    assert port.device_stats.featurize_path == "torch"
    _assert_close(port.predict(texts), jdev.predict(texts))
    snap, jsnap = port.device_stats.snapshot(), jdev.device_stats.snapshot()
    assert snap["uploads_per_chunk"] == 1.0
    # staged bytes over real rows: 3 chunks of 32 padded rows, 66 texts
    assert snap["bytes_in_per_row"] == jsnap["bytes_in_per_row"] == round(
        (2048 + 4) * 96 / len(texts), 1)
    assert snap["truncated_rows"] == jsnap["truncated_rows"]
    assert snap["int8"] is int8


def test_tree_device_featurize_matches_jax(dt_pipe, texts):
    jdev = JPipe(dt_pipe.featurizer, dt_pipe.model, batch_size=32,
                 featurize_device="interpret")
    port = _port(dt_pipe, featurize_device=True)
    _assert_close(port.predict(texts), jdev.predict(texts))


@pytest.mark.parametrize("kind", ["lr", "lr-int8", "dt"])
def test_host_featurize_matches_jax(lr_pipe, dt_pipe, texts, kind):
    """The host-encode leg (featurize_device=False) scores the same."""
    jpipe = dt_pipe if kind == "dt" else lr_pipe
    int8 = kind == "lr-int8"
    jhost = JPipe(jpipe.featurizer, jpipe.model, batch_size=32, int8=int8)
    port = _port(jpipe, int8=int8)
    assert port.device_stats.featurize_path == "host"
    _assert_close(port.predict(texts), jhost.predict(texts))


def test_device_stats_snapshot_keys_match_jax(lr_pipe, texts):
    port = _port(lr_pipe, featurize_device=True)
    jdev = JPipe(lr_pipe.featurizer, lr_pipe.model, batch_size=32,
                 featurize_device="interpret")
    port.predict(texts[:5])
    jdev.predict(texts[:5])
    assert set(port.device_stats.snapshot()) == set(jdev.device_stats.snapshot())
    assert port.device_stats.snapshot()["donation_hits"] == 0


def test_int8_weights_match_jax_quantization(lr_pipe):
    from fraud_detection_tpu.models import linear as jlinear

    port = _port(lr_pipe, int8=True)
    jq, js = jlinear.quantize_weights(lr_pipe.fused_model)
    np.testing.assert_array_equal(port._q8[0].numpy(), np.asarray(jq))
    np.testing.assert_array_equal(port._q8[1].numpy(), np.asarray(js))
    with pytest.raises(ValueError, match="int8"):
        ServingPipeline(port.featurizer, port_model(synthetic_demo_pipeline(
            batch_size=8, n=40, seed=1, model="dt").model), int8=True,
            device="cpu")


def test_predict_encoded_and_one_agree_with_predict(lr_pipe, texts):
    port = _port(lr_pipe)
    enc = port.featurizer.encode(texts[:10])
    by_text = port.predict(texts[:10])
    by_enc = port.predict_encoded(enc.ids, enc.counts)
    np.testing.assert_array_equal(by_enc.labels, by_text.labels)
    np.testing.assert_array_equal(by_enc.probabilities, by_text.probabilities)
    label, p = port.predict_one(texts[0])
    assert (label, np.float32(p)) == (int(by_text.labels[0]),
                                       by_text.probabilities[0])
    with pytest.raises(ValueError):
        port.predict_encoded(enc.ids, enc.counts[:, :1])


def test_pad_ladder_and_pin_device(lr_pipe, texts):
    port = _port(lr_pipe, featurize_device=True)
    want = port.predict(texts[:5])
    port.pad_ladder = (8, 32)
    got = port.predict(texts[:5])
    np.testing.assert_array_equal(got.probabilities, want.probabilities)
    assert port.device_stats.per_chip_rungs() == [8, 32]
    plain = _port(lr_pipe)
    assert (port.pin_device()["pinned_bytes"]
            == plain.pin_device()["pinned_bytes"]
            + port._dev_feat.stop_table_np.nbytes)
    assert port.pin_device()["model_pins"] == 1          # idempotent
    assert port.predict_json_async([b'{"text": "x"}']) is None


def test_pipeline_refuses_feature_space_past_int16(lr_pipe):
    from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer

    model = port_model(lr_pipe.model)
    with pytest.raises(ValueError, match="int16"):
        ServingPipeline(HashingTfIdfFeaturizer(num_features=40000), model,
                        device="cpu")


def test_prob_packed_unpacks_uint16_counts():
    w = torch.arange(5, dtype=torch.float32)
    model = tlinear.LogisticRegression(w, torch.tensor(0.0))
    packed = torch.tensor([[[1, 4], [-1, 2]]], dtype=torch.int16)  # count 65535
    p = tlinear.prob_packed(model, packed)
    assert torch.allclose(p, torch.sigmoid(torch.tensor([65535.0 + 8.0])))
