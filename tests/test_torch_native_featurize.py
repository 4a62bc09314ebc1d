"""The port's native host featurizer against the JAX package's, bit for bit.

``fraud_detection_tpu_torch/featurize/native.py`` builds the port's own copy
of the C++ source into ``build/native/``; the JAX package builds its copy
next to its source. On the same seeded inputs the two libraries, and the
port's pure-Python encode, must give equal ids and counts (both hash modes,
``binary`` on and off, the int16 ``want16`` fill and the int32 fill), equal
raw-JSON status and literal spans, equal output frames, and the sharded
encodes must equal the serial one.
"""

import ctypes
import json
import re

import numpy as np
import pytest

from fraud_detection_tpu.data import generate_corpus
from fraud_detection_tpu.featurize import native as jnative
from fraud_detection_tpu.featurize.hashing import HashingTF as JHashingTF
from fraud_detection_tpu.featurize.tfidf import HashingTfIdfFeaturizer as JFeat
from fraud_detection_tpu_torch.featurize import native as tnative
from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer as TFeat

ADVERSARIAL = [
    "hello world hello", "", "   ", "the a an and of urgent urgent account",
    "İstanbul K 42 --- !!!", "a  b   c", "tab\tand\nnewline stay joined",
    "ALL CAPS MiXeD", "ß é ü ñ", "x" * 90, "z 9 9 9", "trailing spaces   ",
    "🚀 emoji 🚀🚀 between 🚀", "a" * 12 + " " + "b" * 13,
    "nul \x00 inside", "lone \ud800 surrogate", "don't stop-words i'm it's",
]
_ALPHABET = list("abcXYZ  '.-09\t\n") + ["İ", "K", "é", "🎉", "ß", " "]


def _fuzz(seed: int, n: int = 160):
    """Seeded rows over a nasty alphabet: empty rows, Unicode, and a few
    overlong rows (thousands of distinct tokens)."""
    rng = np.random.default_rng(seed)
    rows = ["".join(rng.choice(_ALPHABET, size=int(rng.integers(0, 80))))
            for _ in range(n)]
    rows[0] = ""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    for i in (5, n - 3):
        rows[i] = " ".join("".join(rng.choice(letters, size=6))
                           for _ in range(3000))
    return rows


_INPUTS = {
    "corpus": lambda: [d.text for d in generate_corpus(n=96, seed=4)],
    "adversarial": lambda: ADVERSARIAL,
    "fuzz": lambda: _fuzz(17),
}


def _jax_feat(num_features, binary, legacy):
    """The JAX package's featurizer; its native library hashes with the
    standard tail only, so a legacy reference runs its Python rows."""
    f = JFeat(num_features=num_features, binary_tf=binary)
    if legacy:
        f._hashing = JHashingTF(num_features, binary=binary, legacy=True)
        f._native_tried, f._native = True, None
    else:
        assert f._native_featurizer() is not None
    return f


def _python_twin(feat: TFeat) -> TFeat:
    twin = TFeat(num_features=feat.num_features, binary_tf=feat.binary_tf,
                 legacy=feat.legacy)
    twin._native_tried, twin._native = True, None
    return twin


def test_library_builds_from_the_ports_source_into_build():
    lib = tnative.load_library()
    assert lib is not None, tnative.build_error
    path = tnative.library_path()
    assert path.is_file() and path.parent.parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.parts[-2:] == ("build", "native")
    assert tnative.SRC.parts[-3:] == ("fraud_detection_tpu_torch", "native",
                                      "fast_featurize.cpp")
    assert tnative.build_command[0] == "g++" and str(tnative.SRC) in tnative.build_command


def test_missing_compiler_returns_none_with_the_reason(tmp_path, monkeypatch):
    """Without g++ the build gives None (the pure-Python encode then runs)
    and keeps why on the module."""
    src = tmp_path / "fast_featurize.cpp"
    src.write_bytes(tnative.SRC.read_bytes() + b"\n// unbuilt copy\n")
    monkeypatch.setattr(tnative, "SRC", src)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    for name in ("build_error", "build_command"):   # restored afterwards
        monkeypatch.setattr(tnative, name, getattr(tnative, name))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert tnative.build() is None
    assert "g++" in tnative.build_error
    assert not list((tmp_path / "build").rglob("*.so"))


def test_ctypes_argtypes_match_the_c_signatures():
    """A pointer declared where the C entry takes an int (or a wrong
    element type) corrupts memory without a word: the argtypes must follow
    the source's signatures."""
    src = tnative.SRC.read_text()
    c_kinds = {"void*": "ptr", "const char**": "charpp", "const char*": "charp",
               "char*": "charp", "int": "int", "long long": "longlong",
               "const int32_t*": "int32", "int32_t*": "int32",
               "float*": "float32", "int16_t*": "int16", "uint16_t*": "uint16",
               "const double*": "float64", "int64_t*": "int64"}
    ret_kinds = {"void*": ctypes.c_void_p, "void": None, "int": ctypes.c_int,
                 "long long": ctypes.c_longlong}

    def kind(t):
        if t is ctypes.c_void_p:
            return "ptr"
        if t is ctypes.c_char_p:
            return "charp"
        if t is ctypes.c_int:
            return "int"
        if t is ctypes.c_longlong:
            return "longlong"
        if t == ctypes.POINTER(ctypes.c_char_p):
            return "charpp"
        return np.dtype(t._dtype_).name

    for name, (restype, argtypes) in tnative.ARGTYPES.items():
        m = re.search(r"\n(void\*|void|int|long long) " + name + r"\((.*?)\)",
                      src, re.S)
        assert m is not None, name
        assert ret_kinds[m.group(1)] is restype, name
        params = [re.sub(r"\s+\w+$", "", p.strip()).replace(" *", "*")
                  for p in m.group(2).split(",")]
        assert [c_kinds[p] for p in params] == [kind(t) for t in argtypes], name


@pytest.mark.parametrize("num_features", [1000, 40000])   # int16 fill / int32
@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("inputs,max_tokens", [("corpus", None),
                                                ("corpus", 8),
                                                ("adversarial", None),
                                                ("fuzz", None)])
def test_encode_equals_jax_and_python(inputs, max_tokens, binary, legacy,
                                      num_features):
    texts = _INPUTS[inputs]()
    feat = TFeat(num_features=num_features, binary_tf=binary, legacy=legacy)
    # the library hashes the standard tail only: legacy encodes in Python
    assert (feat._native_featurizer() is None) == legacy
    got = feat.encode(texts, batch_size=len(texts) + 3, max_tokens=max_tokens)
    want = _jax_feat(num_features, binary, legacy).encode(
        texts, batch_size=len(texts) + 3, max_tokens=max_tokens)
    py = _python_twin(feat).encode(texts, batch_size=len(texts) + 3,
                                   max_tokens=max_tokens)
    assert got.ids.dtype == (np.int16 if num_features < 32768 else np.int32)
    assert got.counts.dtype == np.uint16
    for other in (want, py):
        assert got.ids.dtype == np.asarray(other.ids).dtype
        np.testing.assert_array_equal(got.ids, np.asarray(other.ids))
        np.testing.assert_array_equal(got.counts, np.asarray(other.counts))


_JSON_CASES = [
    b'{"text": "Hello there, your ACCOUNT is suspended", "id": 1}',
    b'{"id": 2, "text": "unicode \\u00e9\\u0130\\u212a and \\ud83c\\udf89"}',
    b'{"text": "escapes \\n\\t\\"quoted\\" \\\\ back"}',
    b'{not json',
    b'\xff\xfe',
    b'{"body": "missing text field"}',
    b'{"text": 42}',
    b'{"text": null}',
    b'{"text": ["a", "b"]}',
    b'[1, 2, 3]',
    b'{"te\\u0078t": "escaped key"}',
    b'{"text": "a", "\\u0074ext": "b"}',
    b'{"text": "nul \x00 here"}',
    b'{"text": ""}',
    b'  {"nested": {"text": "inner"}, "text": "outer"}  ',
    b'{"text": "dup 1", "text": "dup 2"}',
    b'{"text": "unterminated',
]


def _json_values(seed: int):
    values = list(_JSON_CASES)
    values += [json.dumps({"text": t, "id": i}).encode()
               for i, t in enumerate(_fuzz(seed, 60))]
    values += [json.dumps({"text": d.text}, ensure_ascii=False).encode()
               for d in generate_corpus(n=40, seed=seed)]
    return values


def _decode(value: bytes):
    try:
        payload = json.loads(value)
    except ValueError:
        return None
    text = payload.get("text") if isinstance(payload, dict) else None
    return text if isinstance(text, str) else None


@pytest.mark.parametrize("binary", [False, True])
def test_encode_json_equals_jax(binary):
    values = _json_values(23)
    t = TFeat(num_features=1000, binary_tf=binary).encode_json(
        values, "text", batch_size=len(values) + 1)
    j = _jax_feat(1000, binary, False).encode_json(
        values, "text", batch_size=len(values) + 1)
    (tb, *tspans), (jb, *jspans) = t, j
    np.testing.assert_array_equal(tb.ids, np.asarray(jb.ids))
    np.testing.assert_array_equal(tb.counts, np.asarray(jb.counts))
    for got, want in zip(tspans, jspans):     # status, span_start, span_len
        np.testing.assert_array_equal(got, want)
    status, start, length = tspans
    assert status[:len(_JSON_CASES)].tolist() == [
        1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0]
    for i, v in enumerate(values):
        if status[i]:      # an accepted message decodes to its literal
            lit = v[start[i]: start[i] + length[i]]
            assert json.loads(lit.decode("utf-8", "surrogatepass")) == _decode(v)
        else:              # a rejected one is an all-padding row
            assert not tb.counts[i].any()


def test_build_frames_equal_jax_and_the_template():
    """The port's C++ frames equal the JAX package's byte for byte, and the
    Python template path's (labels past the table and -1 rows come back
    empty, for the engine's Python path)."""
    values = _json_values(29)
    n = len(values)
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 2, n).astype(np.int32)
    labels[:4] = [-1, 2, 0, 1]
    confs = rng.random(n)
    table = [json.dumps(x).encode() for x in ("normal", "scam")]
    tfeat = TFeat(num_features=1000)
    _, status, start, length = tfeat.encode_json(values, "text",
                                                 keep_splice_ctx=True)
    tblob, tends = tnative.build_frames(tfeat.pop_json_splice_ctx(), start,
                                        length, labels, confs, table)
    assert tfeat.pop_json_splice_ctx() is None
    jfeat = _jax_feat(1000, False, False)
    _, jstatus, jstart, jlength = jfeat.encode_json(values, "text",
                                                    keep_splice_ctx=True)
    jblob, jends = jnative.build_frames(jfeat.pop_json_splice_ctx(), jstart,
                                        jlength, labels, confs, table)
    assert tblob == jblob
    np.testing.assert_array_equal(tends, jends)
    prev = 0
    for i, end in enumerate(tends.tolist()):
        frame = tblob[prev:end]
        if labels[i] in (0, 1) and status[i]:
            lit = values[i][start[i]: start[i] + length[i]]
            assert frame == (b'{"prediction": %d, "label": %s, "confidence": '
                             b'%.6f, "original_text": %s}'
                             % (labels[i], table[labels[i]], confs[i], lit))
        elif labels[i] not in (0, 1):
            assert frame == b""
        prev = end


@pytest.mark.parametrize("workers", [1, 2, 4])
@pytest.mark.parametrize("legacy", [False, True])
def test_sharded_encode_equals_serial(workers, legacy):
    texts = _fuzz(31, 300) + [d.text for d in generate_corpus(n=40, seed=8)]
    serial = TFeat(num_features=1000, legacy=legacy, parallel_workers=1)
    sharded = TFeat(num_features=1000, legacy=legacy,
                    parallel_workers=workers, parallel_min_rows=8)
    for max_tokens in (None, 16):
        a = serial.encode(texts, batch_size=400, max_tokens=max_tokens)
        b = sharded.encode(texts, batch_size=400, max_tokens=max_tokens)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.counts, b.counts)


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_sharded_encode_json_equals_serial(workers):
    values = _json_values(37) * 3
    serial = TFeat(num_features=1000, parallel_workers=1)
    sharded = TFeat(num_features=1000, parallel_workers=workers,
                    parallel_min_rows=8)
    a = serial.encode_json(values, "text", keep_splice_ctx=True)
    b = sharded.encode_json(values, "text", keep_splice_ctx=True)
    np.testing.assert_array_equal(a[0].ids, b[0].ids)
    np.testing.assert_array_equal(a[0].counts, b[0].counts)
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)
    labels = np.ones(len(values), np.int32)
    confs = np.linspace(0, 1, len(values))
    table = [b'"normal"', b'"scam"']
    fa = tnative.build_frames(serial.pop_json_splice_ctx(), a[2], a[3],
                              labels, confs, table)
    fb = tnative.build_frames(sharded.pop_json_splice_ctx(), b[2], b[3],
                              labels, confs, table)
    assert fa[0] == fb[0]
    np.testing.assert_array_equal(fa[1], fb[1])


def test_shard_bounds_and_workers(monkeypatch):
    from fraud_detection_tpu.featurize import parallel as jpar
    from fraud_detection_tpu_torch.featurize import parallel as tpar

    for n in (0, 1, 7, 256, 1000):
        for w in (1, 2, 3, 8):
            assert tpar.shard_bounds(n, w) == jpar.shard_bounds(n, w)
    monkeypatch.setenv("FRAUD_TPU_FEAT_WORKERS", "3")
    assert tpar.resolve_workers() == jpar.resolve_workers() == 3
    assert tpar.resolve_workers(5) == 5
    monkeypatch.setenv("FRAUD_TPU_FEAT_WORKERS", "junk")
    assert tpar.resolve_workers() == jpar.resolve_workers()
