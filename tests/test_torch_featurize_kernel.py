"""The port's device featurize program against the JAX package's.

On the CPU the port runs the plain torch version of the scan kernel
(``tokenize_hash_reference``); the reference is the JAX Pallas kernel in
interpret mode. Every comparison here is EXACT: byte classes, all five scan
output streams, and the packed (B, 2, L) featurize output — on the
adversarial corpus, a seeded fuzz in every (legacy, binary) mode, empty vs
padding rows, overflow truncation and the stop table. Widths stay at
32-128 bytes and rows at 4-16: the JAX interpreter is slow.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fraud_detection_tpu.featurize.device import DeviceFeaturizer as JDev
from fraud_detection_tpu.featurize.device import pack_staged as jpack_staged
from fraud_detection_tpu.featurize.hashing import HashingTF as JHashingTF
from fraud_detection_tpu.featurize.hashing import non_negative_mod
from fraud_detection_tpu.featurize.text import StopWordFilter as JStopWordFilter
from fraud_detection_tpu.featurize.tfidf import HashingTfIdfFeaturizer as JFeat
from fraud_detection_tpu.ops import featurize_kernel as jfk
from fraud_detection_tpu_torch.featurize.device import (
    DeviceFeaturizer, DeviceFeaturizeUnavailable, pack_bytes, pack_staged,
    truncation_cut)
from fraud_detection_tpu_torch.featurize.hashing import spark_hash_bucket
from fraud_detection_tpu_torch.featurize.text import StopWordFilter
from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
from fraud_detection_tpu_torch.ops import featurize_kernel as tfk
from tests.test_featurize_device import ADVERSARIAL
from tests.torch_parity import pallas_store  # noqa: F401 — fixture

pytestmark = pytest.mark.usefixtures("pallas_store")

_ALPHABET = list("abcXYZ  \t\n0!-'") + ["İ", "K", "ß", "é", "🚀"]


def _fuzz_texts(seed, n=5, max_len=90):
    rng = random.Random(seed)
    return ["".join(rng.choice(_ALPHABET) for _ in range(rng.randrange(0, max_len)))
            for _ in range(n)]


def _classes(texts, width, batch_size=None):
    byts, lengths, _ = pack_bytes(texts, width, batch_size)
    return byts, lengths


def _assert_scan_equal(byts, lengths, legacy):
    jc = jfk.byte_classes(jnp.asarray(byts), jnp.asarray(lengths))
    tc = tfk.byte_classes(torch.from_numpy(byts), torch.from_numpy(lengths))
    assert tc.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    want = jfk.tokenize_hash(jc, legacy=legacy, interpret=True)
    got = tfk.tokenize_hash_reference(tc, legacy=legacy)
    for name, g, w in zip(("h", "w0", "w1", "tok_len", "emp"), got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("legacy", [False, True])
def test_scan_reference_matches_jax_kernel_adversarial(legacy):
    byts, lengths = _classes(ADVERSARIAL, 128, batch_size=16)
    _assert_scan_equal(byts, lengths, legacy)


@pytest.mark.parametrize("legacy", [False, True])
def test_scan_reference_matches_jax_kernel_fuzz(legacy):
    texts = _fuzz_texts(99 + legacy, n=12, max_len=70) + [""]
    byts, lengths = _classes(texts, 64, batch_size=16)
    _assert_scan_equal(byts, lengths, legacy)


def test_tokenize_hash_on_cpu_runs_the_plain_version():
    byts, lengths = _classes(ADVERSARIAL[:6], 48)
    cls = tfk.byte_classes(torch.from_numpy(byts), torch.from_numpy(lengths))
    before = tfk.tokenize_hash.launches
    got = tfk.tokenize_hash(cls, legacy=False)
    want = tfk.tokenize_hash_reference(cls, legacy=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tfk.tokenize_hash.launches == before     # no kernel on the CPU


@pytest.mark.parametrize("legacy", [False, True])
def test_self_test_reckoning_matches_plain_version(legacy):
    """The self-test's host reckoning (``expected_scan``) agrees with the
    plain version, so on the card it checks the kernel against both."""
    texts = list(tfk._SELF_TEST_TEXTS)
    byts, lengths = _classes(texts, 24)
    cls = tfk.byte_classes(torch.from_numpy(byts), torch.from_numpy(lengths))
    out = [x.numpy() for x in tfk.tokenize_hash_reference(cls, legacy=legacy)]
    for r, t in enumerate(texts):
        want = tfk.expected_scan(t, legacy, cls.shape[1])
        for k in range(4):
            assert out[k][r].tolist() == list(want[k]), (t, k)
        assert out[4][r, 0] == want[4], t
    assert tfk.kernel_self_test(torch.device("cpu")) is True


def test_featurize_bytes_on_cpu_runs_the_plain_version():
    _, tfeat = _feat_pair()
    tdev = DeviceFeaturizer(tfeat, width=48, tokens=8, device="cpu")
    staged = torch.from_numpy(tdev.pack(ADVERSARIAL[:6], 8)[0])
    before = tfk.featurize_bytes.launches
    got = tfk.featurize_bytes(staged, tdev.stop_table(), spec=tdev.spec)
    want = tfk.featurize_bytes_reference(staged, tdev.stop_table(),
                                         spec=tdev.spec)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[1].dtype == torch.int32 and got[1].shape == (8,)
    assert tfk.featurize_bytes.launches == before   # no kernel on the CPU


def test_featurize_packed_refuses_what_the_kernel_does_not_take():
    """The CUDA wrapper's checks run before any launch (here on CPU tensors,
    so nothing is built)."""
    _, tfeat = _feat_pair()
    tdev = DeviceFeaturizer(tfeat, width=32, tokens=8, device="cpu")
    staged = torch.from_numpy(tdev.pack(["ab"], 2)[0])
    table = tdev.stop_table()
    bad = [(staged.to(torch.int32), table, tdev.spec),
           (staged[:, :4], table, tdev.spec),
           (staged, table[:-1], tdev.spec),
           (staged, table.to(torch.int64), tdev.spec),
           (staged.t(), table, tdev.spec),
           (staged, table, tdev.spec._replace(num_features=40000)),
           (staged, table, tdev.spec._replace(n_slots=0))]
    for args in bad:
        with pytest.raises(ValueError):
            tfk._featurize_packed_cuda(*args)


def test_ctypes_argtypes_match_the_c_signatures():
    """A pointer passed where the C entry takes an int (or the reverse) is
    cut to 32 bits without a word: the argtypes must follow the source."""
    import ctypes
    import re
    from pathlib import Path

    src = (Path(tfk.__file__).parent / "csrc" / "featurize_scan.cu").read_text()
    for name, argtypes in (("featurize_packed", tfk._PACKED_ARGTYPES),
                           ("featurize_scan", tfk._SCAN_ARGTYPES)):
        sig = re.search(r'extern "C" int ' + name + r"\((.*?)\)", src,
                        re.S).group(1)
        params = [p.strip() for p in sig.split(",")]
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
        assert kinds == argtypes, name


def test_uint32_arithmetic_matches_numpy():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64)
    at = torch.from_numpy(a.astype(np.int64))
    for c in (0xCC9E2D51, 0x1B873593, 5, 0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF):
        want = (a * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        np.testing.assert_array_equal(tfk._mul32(at, c).numpy(),
                                      want.astype(np.int64))
    u = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64)
    assert tfk._to_int32(u).tolist() == [0, 1, 2**31 - 1, -2**31, -1]


def test_floor_mod_on_negative_hashes():
    vals = [-2147483648, -10007, -1, 0, 1, 9999, 2147483647]
    got = torch.remainder(torch.tensor(vals, dtype=torch.int32), 10000)
    assert got.tolist() == [non_negative_mod(v, 10000) for v in vals]


def test_stop_table_and_pack_token_parity():
    words = HashingTfIdfFeaturizer().stop_filter.words
    tt, te = tfk.build_stop_table(words)
    jt, je = jfk.build_stop_table(words)
    np.testing.assert_array_equal(tt, jt)
    assert te == je
    for w in ["the", "a", "abcdefghijkl", "don't", "", "abcdefghijklm"]:
        assert tfk.pack_token(w) == jfk.pack_token(w)
    assert tfk.build_stop_table(["abcdefghijklm"]) is None
    assert tfk.build_stop_table(["the", ""])[1] is True
    w0 = torch.tensor([0, 5, 2**30 - 1]); w1 = torch.tensor([3, 0, 7])
    ln = torch.tensor([-1, 2, 12])
    assert (tfk._probe_mix_tensor(w0, w1, ln).tolist()
            == [tfk._probe_mix(0, 3, 2**32 - 1), tfk._probe_mix(5, 0, 2),
                tfk._probe_mix(2**30 - 1, 7, 12)])


def test_pack_staged_and_split_parity():
    texts = ["ab", "", "c" * 50, "ééé" * 20]
    staged, truncated = pack_staged(texts, 32, batch_size=6)
    jstaged, jtrunc = jpack_staged(texts, 32, batch_size=6)
    np.testing.assert_array_equal(staged, jstaged)
    assert truncated == jtrunc == 2
    byts, lengths = tfk.split_staged(torch.from_numpy(staged))
    jb, jl = jfk.split_staged(jnp.asarray(jstaged))
    np.testing.assert_array_equal(byts.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jl))
    assert lengths.tolist()[-1] == -1
    data = "hello ééé".encode()
    for w in range(len(data)):
        assert 0 <= truncation_cut(data, w) <= w


def _feat_pair(num_features=1000, binary=False, legacy=False, **kw):
    jfeat = JFeat(num_features=num_features, binary_tf=binary, **kw)
    if legacy:
        jfeat._hashing = JHashingTF(num_features, binary=binary, legacy=True)
    tfeat = HashingTfIdfFeaturizer(num_features=num_features, binary_tf=binary,
                                   legacy=legacy, **kw)
    return jfeat, tfeat


def _assert_packed_equal(jfeat, tfeat, texts, width, tokens, batch_size=None):
    jdev = JDev(jfeat, width=width, tokens=tokens, interpret=True)
    tdev = DeviceFeaturizer(tfeat, width=width, tokens=tokens, device="cpu")
    assert tdev.path == "torch" and tdev.spec.legacy == jdev.spec.legacy
    assert tdev.spec.empty_bucket == jdev.spec.empty_bucket
    staged, _ = tdev.pack(texts, batch_size)
    got = tdev.encode_packed(staged)
    assert got.dtype == torch.int16
    want = np.asarray(jdev.encode_packed(staged))
    np.testing.assert_array_equal(got.numpy(), want)
    return got.numpy()


def test_featurize_bytes_adversarial():
    jfeat, tfeat = _feat_pair()
    _assert_packed_equal(jfeat, tfeat, ADVERSARIAL, 128, 16)


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("binary", [False, True])
def test_featurize_bytes_fuzz_all_hash_modes(legacy, binary):
    jfeat, tfeat = _feat_pair(997, binary=binary, legacy=legacy)
    for trial in range(3):
        texts = _fuzz_texts(1234 + 4 * trial + 2 * legacy + binary)
        if trial == 0:
            texts[0] = ""           # genuine empty row next to padding rows
        _assert_packed_equal(jfeat, tfeat, texts, 64, 8, batch_size=8)


def test_featurize_bytes_empty_vs_padding():
    jfeat, tfeat = _feat_pair()
    packed = _assert_packed_equal(jfeat, tfeat, [""], 32, 8, batch_size=4)
    assert packed[0, 0, 0] == spark_hash_bucket("", 1000)
    assert packed[0, 1, 0] == 1 and not packed[1:, 1].any()


def test_featurize_bytes_overflow_truncation():
    rng = random.Random(7)
    words = ["w" + chr(97 + i) + chr(97 + j) for i in range(8) for j in range(5)]
    texts = [" ".join(rng.choice(words) for _ in range(30)) for _ in range(4)]
    jfeat, tfeat = _feat_pair()
    packed = _assert_packed_equal(jfeat, tfeat, texts, 128, 8)
    assert (np.count_nonzero(packed[:, 1], axis=1) == 8).all()


def test_featurize_bytes_stop_table():
    jfeat, tfeat = _feat_pair()
    alpha = [w for w in tfeat.stop_filter.words if w.isalpha()]
    texts = [" ".join(alpha[:20]), " ".join(alpha[20:40]),
             "İ myself and ourselves keep fraud", "don't the notastop"]
    packed = _assert_packed_equal(jfeat, tfeat, texts, 128, 16)
    assert not packed[:2, 1].any()                  # pure stop words: nothing
    j2 = JFeat(num_features=100, stop_filter=JStopWordFilter(["", "ab"]))
    t2 = HashingTfIdfFeaturizer(num_features=100,
                                stop_filter=StopWordFilter(["", "ab"]))
    _assert_packed_equal(j2, t2, ["", "ab cd", "  x"], 32, 4)   # "" is a stop word


def test_device_featurizer_matches_host_encode():
    jfeat, tfeat = _feat_pair()
    tdev = DeviceFeaturizer(tfeat, width=128, tokens=16, device="cpu")
    texts = ADVERSARIAL[:8]
    got = tdev.encode(texts, batch_size=10)
    want = tfeat.encode(tdev.decode_truncated(texts), batch_size=10,
                        max_tokens=16)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.counts, want.counts)


def test_device_featurizer_refusals_and_no_silent_cpu():
    with pytest.raises(DeviceFeaturizeUnavailable, match="int16"):
        DeviceFeaturizer(HashingTfIdfFeaturizer(num_features=40000),
                         device="cpu")
    long_stop = HashingTfIdfFeaturizer(
        num_features=100, stop_filter=StopWordFilter(["abcdefghijklmnop"]))
    with pytest.raises(DeviceFeaturizeUnavailable, match="stop list"):
        DeviceFeaturizer(long_stop, device="cpu")

    class Sub(HashingTfIdfFeaturizer):
        pass

    with pytest.raises(DeviceFeaturizeUnavailable):
        DeviceFeaturizer(Sub(num_features=100), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            DeviceFeaturizer(HashingTfIdfFeaturizer(num_features=100))
