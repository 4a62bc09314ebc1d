"""Host featurization parity between the PyTorch port and the JAX package:
murmur3 / bucket hashing (standard and legacy tail), clean/tokenize/stop
filtering, and ``HashingTfIdfFeaturizer.encode`` — ids and counts must be
BYTE-identical, truncation ties included, and ``fit_idf`` equal to 1e-7
(both compute the same float64 logs and round to float32; the bound only
absorbs a last-ulp difference).
"""

import random

import numpy as np
import pytest

from fraud_detection_tpu.data import generate_corpus
from fraud_detection_tpu.featurize import hashing as jhash
from fraud_detection_tpu.featurize import text as jtext
from fraud_detection_tpu.featurize.tfidf import HashingTfIdfFeaturizer as JFeat
from fraud_detection_tpu_torch.data import generate_corpus as port_corpus
from fraud_detection_tpu_torch.featurize import hashing as thash
from fraud_detection_tpu_torch.featurize import text as ttext
from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer as TFeat
from tests.test_hashing import COMMON_DIALOGUE_WORDS

_MURMUR_INPUTS = [b"", b"\xff\xff\xff\xff", b"!Ce\x87", b"Hello, world!",
                  b"aaaa", b"abc", b"fourfour", b"12345678", b"\x80\x81\xfe",
                  "İstanbul 🚀".encode()]
_SEEDS = [0, 1, 42, 0x9747B28C, 0x5082EDEE, 0xFFFFFFFF]


def _fuzz_words(n=300, seed=11):
    rng = random.Random(seed)
    alphabet = "abcdefghijklmnopqrstuvwxyz"
    return ["".join(rng.choice(alphabet) for _ in range(rng.randrange(0, 17)))
            for _ in range(n)]


@pytest.mark.parametrize("legacy", [False, True])
def test_murmur_parity(legacy):
    jfn = jhash.murmur3_x86_32_legacy_tail if legacy else jhash.murmur3_x86_32
    tfn = thash.murmur3_x86_32_legacy_tail if legacy else thash.murmur3_x86_32
    data = _MURMUR_INPUTS + [w.encode() for w in _fuzz_words()]
    for d in data:
        for s in _SEEDS:
            assert tfn(d, s) == jfn(d, s), (d, s)


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("num_features", [997, 10000])
def test_bucket_parity(legacy, num_features):
    words = COMMON_DIALOGUE_WORDS + _fuzz_words() + ["", "x" * 100]
    for w in words:
        assert (thash.spark_hash_bucket(w, num_features, legacy)
                == jhash.spark_hash_bucket(w, num_features, legacy)), w


def test_non_negative_mod_parity():
    for x in [-2147483648, -10007, -10000, -7, -1, 0, 1, 7, 9999, 2147483647]:
        for mod in (5, 997, 10000):
            assert thash.non_negative_mod(x, mod) == jhash.non_negative_mod(x, mod)


def test_hashing_tf_parity():
    toks = ["a", "b", "a", "c", "a", ""] + _fuzz_words(50)
    for binary in (False, True):
        j = jhash.HashingTF(1000, binary=binary).transform_arrays(toks)
        t = thash.HashingTF(1000, binary=binary).transform_arrays(toks)
        np.testing.assert_array_equal(j[0], t[0])
        np.testing.assert_array_equal(j[1], t[1])


_TEXTS = ["Hello World", "a  b", " a b", "a b  ", "", " ", "tab\tand\nnl",
          "İstanbul K 42 --- !!!", "ALL CAPS MiXeD", "ß é ü ñ",
          "don't stop the a an and of urgent", "x y", "trailing   "]


def test_clean_tokenize_stopwords_parity():
    texts = _TEXTS + [d.text for d in generate_corpus(n=40, seed=3)]
    jstop, tstop = jtext.StopWordFilter(), ttext.StopWordFilter()
    assert tstop.words == jstop.words and len(tstop.words) == 181
    assert ttext.load_default_stopwords() == jtext.load_default_stopwords()
    for t in texts:
        assert ttext.clean_text(t) == jtext.clean_text(t)
        assert ttext.tokenize(t) == jtext.tokenize(t)
        toks = jtext.tokenize(jtext.clean_text(t))
        assert tstop(toks) == jstop(toks)
    cs = ["The", "the", "A"]
    assert (ttext.StopWordFilter(cs, case_sensitive=True)(["The", "the", "a"])
            == jtext.StopWordFilter(cs, case_sensitive=True)(["The", "the", "a"]))


def test_synthetic_corpus_is_a_verbatim_copy():
    for seed in (5, 7):
        a = generate_corpus(n=60, seed=seed)
        b = port_corpus(n=60, seed=seed)
        assert [(d.text, d.label, d.kind) for d in a] == \
               [(d.text, d.label, d.kind) for d in b]


def _python_jfeat(**kw):
    """JAX featurizer forced onto its pure-Python encode (the port's only
    host path; the native C++ path is pinned equal to it by the JAX tests)."""
    f = JFeat(**kw)
    f._native_tried, f._native = True, None
    return f


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("max_tokens", [None, 8])
def test_encode_byte_identical(binary, max_tokens):
    """ids/counts byte-identical, dtypes included; max_tokens=8 forces the
    top-count truncation with ties to the lower bucket id."""
    texts = [d.text for d in generate_corpus(n=24, seed=9)] + _TEXTS
    j = _python_jfeat(num_features=1000, binary_tf=binary)
    t = TFeat(num_features=1000, binary_tf=binary)
    je = j.encode(texts, batch_size=len(texts) + 3, max_tokens=max_tokens)
    te = t.encode(texts, batch_size=len(texts) + 3, max_tokens=max_tokens)
    assert te.ids.dtype == je.ids.dtype and te.counts.dtype == je.counts.dtype
    np.testing.assert_array_equal(te.ids, je.ids)
    np.testing.assert_array_equal(te.counts, je.counts)


def test_encode_truncation_ties_to_lower_id():
    # 40 distinct words once each + a few repeated: the cut at 8 slots falls
    # inside a tie group of count-1 buckets.
    rng = random.Random(7)
    words = ["w" + chr(97 + i) + chr(97 + j) for i in range(8) for j in range(5)]
    texts = [" ".join(words + rng.sample(words, 4)) for _ in range(4)]
    j = _python_jfeat(num_features=1000)
    t = TFeat(num_features=1000)
    je = j.encode(texts, max_tokens=8)
    te = t.encode(texts, max_tokens=8)
    assert (np.count_nonzero(te.counts, axis=1) == 8).all()
    np.testing.assert_array_equal(te.ids, je.ids)
    np.testing.assert_array_equal(te.counts, je.counts)


def test_encode_int32_ids_past_int16():
    texts = _TEXTS[:6]
    je = _python_jfeat(num_features=40000).encode(texts)
    te = TFeat(num_features=40000).encode(texts)
    assert te.ids.dtype == np.int32 == je.ids.dtype
    np.testing.assert_array_equal(te.ids, je.ids)


def test_legacy_encode_parity():
    texts = [d.text for d in generate_corpus(n=12, seed=4)] + _TEXTS
    j = _python_jfeat(num_features=997)
    j._hashing = jhash.HashingTF(997, legacy=True)
    t = TFeat(num_features=997, legacy=True)
    np.testing.assert_array_equal(t.encode(texts).ids, j.encode(texts).ids)
    np.testing.assert_array_equal(t.encode(texts).counts, j.encode(texts).counts)


def test_fit_idf_parity():
    texts = [d.text for d in generate_corpus(n=150, seed=7)]
    for min_df in (0, 3):
        j = _python_jfeat(num_features=10000).fit_idf(texts, min_doc_freq=min_df)
        t = TFeat(num_features=10000).fit_idf(texts, min_doc_freq=min_df)
        np.testing.assert_array_equal(t.doc_freq, j.doc_freq)
        assert t.idf.dtype == np.float32
        np.testing.assert_allclose(t.idf, j.idf, rtol=0, atol=1e-7)
        idf_dev = t.idf_array("cpu")
        assert idf_dev is t.idf_array("cpu")       # cached, not re-copied
        np.testing.assert_array_equal(idf_dev.numpy(), t.idf)


def test_sparse_row_tokens_bucket_parity():
    j = _python_jfeat(num_features=10000)
    t = TFeat(num_features=10000)
    for text in _TEXTS + [d.text for d in generate_corpus(n=10, seed=2)]:
        assert t.tokens(text) == j.tokens(text)
        ji, jv = j.sparse_row(text)
        ti, tv = t.sparse_row(text)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv, jv)
    for w in COMMON_DIALOGUE_WORDS:
        assert t.bucket(w) == j.bucket(w)
