"""The last public names of the JAX package ported beside their modules,
each against the JAX name on the same inputs, on the CPU:
``ServingPipeline.fused_model``, ``HashingTF.transform_batch``,
``idf_from_doc_freq`` (bit-equal in float64), ``EncodedBatch.batch_size``,
``racecheck.clear_violations``, the native featurizer's capability probes
(``supports_json``, ``supports_shards``, ``supports_json_shards``,
``frames_available``) and the ``prompt=`` argument of the slot decoders'
``warm``. The JAX names the port leaves out by design are listed in the
docstrings of ``ops/featurize_kernel.py``, ``ops/histogram.py``,
``models/linear.py``, ``models/pipeline.py`` and ``models/llm.py``.
"""

import threading

import jax
import numpy as np
import pytest

from fraud_detection_tpu.featurize import hashing as jhashing
from fraud_detection_tpu.featurize import native as jnative
from fraud_detection_tpu.featurize import tfidf as jtfidf
from fraud_detection_tpu.models import llm as jllm
from fraud_detection_tpu.models.pipeline import ServingPipeline as JPipe
from fraud_detection_tpu.models.pipeline import synthetic_demo_pipeline
from fraud_detection_tpu.utils import racecheck as jracecheck
from fraud_detection_tpu_torch.featurize import hashing as thashing
from fraud_detection_tpu_torch.featurize import native as tnative
from fraud_detection_tpu_torch.featurize import tfidf as ttfidf
from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
from fraud_detection_tpu_torch.utils import racecheck as tracecheck
from tests.test_torch_llm import CFG, _jinit
from tests.torch_parity import port_featurizer, port_llm, port_model

DOCS = [["urgent", "prize", "urgent", "verify", "account"], [],
        ["hello", "world", "hello", "ñandú", "日本"], ["a"] * 40]


@pytest.fixture(scope="module")
def pipes():
    return {m: synthetic_demo_pipeline(batch_size=16, n=80, seed=3,
                                       num_features=512, model=m)
            for m in ("lr", "dt")}


def test_fused_model_equals_jax(pipes):
    """The LR pipeline's IDF-folded model equals the JAX one's; a tree
    pipeline has none, in both packages."""
    jpipe = pipes["lr"]
    port = ServingPipeline(port_featurizer(jpipe.featurizer),
                           port_model(jpipe.model), device="cpu")
    np.testing.assert_array_equal(port.fused_model.weights.numpy(),
                                  np.asarray(jpipe.fused_model.weights))
    assert float(port.fused_model.intercept) == float(
        jpipe.fused_model.intercept)
    jtree = JPipe(pipes["dt"].featurizer, pipes["dt"].model)
    ttree = ServingPipeline(port_featurizer(jtree.featurizer),
                            port_model(jtree.model), device="cpu")
    for pipe in (jtree, ttree):
        with pytest.raises(TypeError, match="LogisticRegression"):
            pipe.fused_model


@pytest.mark.parametrize("binary,legacy", [(False, False), (True, False),
                                           (False, True)])
def test_transform_batch_equals_jax(binary, legacy):
    want = jhashing.HashingTF(1000, binary=binary,
                              legacy=legacy).transform_batch(DOCS)
    got = thashing.HashingTF(1000, binary=binary,
                             legacy=legacy).transform_batch(iter(DOCS))
    assert len(got) == len(want)
    for (gi, gv), (wi, wv) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)
        assert (gi.dtype, gv.dtype) == (wi.dtype, wv.dtype)


def test_idf_from_doc_freq_bit_equal_jax():
    rng = np.random.default_rng(0)
    for num_docs, dtype in ((1, np.int64), (800, np.int32),
                            (10 ** 6, np.int64)):
        df = rng.integers(0, num_docs + 1, 4096).astype(dtype)
        got, want = (ttfidf.idf_from_doc_freq(df, num_docs),
                     jtfidf.idf_from_doc_freq(df, num_docs))
        assert got.dtype == want.dtype == np.float64
        assert got.tobytes() == want.tobytes()
    texts = ["urgent prize verify", "hello world", "urgent account", ""]
    jfeat = jtfidf.HashingTfIdfFeaturizer(num_features=64).fit_idf(texts)
    tfeat = ttfidf.HashingTfIdfFeaturizer(num_features=64).fit_idf(texts)
    np.testing.assert_array_equal(tfeat.idf, np.asarray(jfeat.idf))


@pytest.mark.parametrize("n,batch", [(3, None), (5, 8), (1, 32)])
def test_encoded_batch_size_equals_jax(pipes, n, batch):
    jfeat = pipes["lr"].featurizer
    texts = [f"urgent prize number {i}" for i in range(n)]
    got = port_featurizer(jfeat).encode(texts, batch_size=batch)
    want = jfeat.encode(texts, batch_size=batch)
    assert got.batch_size == want.batch_size == got.ids.shape[0]


@pytest.mark.parametrize("mod", [tracecheck, jracecheck],
                         ids=["port", "jax"])
def test_clear_violations_empties_the_log(mod):
    """A second thread inside a held region is recorded; clearing the log
    empties it (both packages)."""
    mod.clear_violations()
    region = mod.ExclusiveRegion("test.clear_violations")
    entered, release = threading.Event(), threading.Event()

    def hold():
        with region:
            entered.set()
            release.wait(10)

    holder = threading.Thread(target=hold)
    holder.start()
    try:
        assert entered.wait(10)
        with pytest.raises(mod.RaceError):
            with region:
                pass
    finally:
        release.set()
        holder.join(10)
    assert not holder.is_alive()
    assert [v.region for v in mod.violations()] == ["test.clear_violations"]
    mod.clear_violations()
    assert mod.violations() == []


@pytest.mark.parametrize("probe", ["supports_json", "supports_shards",
                                   "supports_json_shards",
                                   "frames_available"])
def test_native_capability_probes_equal_jax(probe):
    """The port's library binds every entry point, so each probe reads what
    the JAX package's reads of its library (True where g++ built it)."""
    if probe == "frames_available":
        got, want = tnative.frames_available(), jnative.frames_available()
    else:
        args = (["the", "a"], 1024, False, True)
        got = getattr(tnative.NativeFeaturizer(*args), probe)()
        want = getattr(jnative.NativeFeaturizer(*args), probe)()
    assert got is want is True


@pytest.mark.parametrize("paged", [False, True])
def test_warm_takes_a_prompt_like_jax(paged):
    """``warm(steps, prompt=...)`` admits that prompt's tokens, runs one
    window and returns the slot and its pages, in both packages."""
    from fraud_detection_tpu.explain.slotserve import decode as jdecode
    from fraud_detection_tpu_torch.explain.slotserve import decode as tdecode

    jlm = jllm.LanguageModel(CFG, _jinit(jax.random.PRNGKey(0), CFG))
    kw = dict(prompt_width=64, max_new_tokens=8, prompt_bucket=16)
    if paged:
        kw["page_size"] = 16
    prompt = "Caller: this is your bank, read me the code from the text."
    runs = []
    for mod, lm in ((jdecode, jlm), (tdecode, port_llm(jlm))):
        cls = mod.PagedSlotDecoder if paged else mod.SlotDecoder
        dec = cls(lm, 2, **kw)
        free = dec.pages_free
        seen = []
        admit = dec.prefill
        dec.prefill = lambda slot, toks, *a: seen.append(
            (slot, np.asarray(toks).tolist())) or admit(slot, toks, *a)
        dec.warm(4, prompt=prompt)
        dec.warm(4)
        runs.append((seen, dec.prefills, dec.steps,
                     dec.pages_free, free))
    assert runs[0] == runs[1]
    seen, prefills, steps, left, free = runs[1]
    assert [s for s, _ in seen] == [0, 0] and (prefills, steps) == (2, 2)
    assert len(seen[0][1]) > len(seen[1][1])
    assert left == free
