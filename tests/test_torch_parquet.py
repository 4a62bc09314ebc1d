"""The port's parquet codec (``fraud_detection_tpu_torch/checkpoint/parquet.py``)
held against pyarrow, which the JAX package reads and writes Spark artifacts
with: the reader's records equal ``pq.read_table(f).to_pylist()`` on files
pyarrow writes under every page, codec, dictionary and list-naming option;
pyarrow reads the port's files with the rows and the parquet schema of the
same rows written by ``pa.Table.from_pylist`` (the JAX writer's call)."""

import itertools

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from fraud_detection_tpu_torch.checkpoint import parquet as P

# rows of the shapes the Spark writer emits (spark_writer.py)
_NODE = {"id": 0, "prediction": 1.0, "impurity": 0.0,
         "impurityStats": [3.0, 9.0], "gain": -1.0, "leftChild": 1,
         "rightChild": 2, "split": {"featureIndex": 7,
                                    "leftCategoriesOrThreshold": [0.25],
                                    "numCategories": -1}}
_LEAF = {"id": 1, "prediction": 0.0, "impurity": 0.0,
         "impurityStats": [5.0, 1.0], "gain": -1.0, "leftChild": -1,
         "rightChild": -1, "split": {"featureIndex": -1,
                                     "leftCategoriesOrThreshold": [],
                                     "numCategories": -1}}
WRITER_ROWS = {
    "forest": [{"treeID": t, "nodeData": n} for t in range(3)
               for n in (_NODE, _LEAF, dict(_LEAF, id=2))],
    "tree": [_NODE, _LEAF, dict(_LEAF, id=2, prediction=1.0)],
    "single_leaf_tree": [_LEAF],
    "idf": [{"idf": {"type": 1, "size": None, "indices": None,
                     "values": [0.5, 1.25, 0.0, 3.5]},
             "docFreq": [3, 0, 11, 1], "numDocs": 1150}],
    "lr": [{"numClasses": 2, "numFeatures": 3,
            "interceptVector": {"type": 1, "size": None, "indices": None,
                                "values": [-7.2]},
            "coefficientMatrix": {"type": 1, "numRows": 1, "numCols": 3,
                                  "colPtrs": None, "rowIndices": None,
                                  "values": [0.1, -0.2, 0.0],
                                  "isTransposed": False},
            "isMultinomial": False}],
    "vocabulary": [{"vocabulary": ["urgent", "prize", "", "héllo 🚀"]}],
    "trees_metadata": [{"treeID": t, "metadata": "{}", "weights": 0.5}
                       for t in range(4)],
}
OPTIONS = list(itertools.product(("1.0", "2.0"), ("none", "snappy", "gzip"),
                                 (True, False), (True, False)))


def _pyarrow_file(path, table, version, compression, dictionary, compliant):
    pq.write_table(table, str(path), data_page_version=version,
                   compression=compression, use_dictionary=dictionary,
                   use_compliant_nested_type=compliant)
    return str(path)


@pytest.mark.parametrize("version,compression,dictionary,compliant", OPTIONS)
def test_reader_equals_pyarrow_on_the_writers_rows(tmp_path, version,
                                                   compression, dictionary,
                                                   compliant):
    for name, rows in WRITER_ROWS.items():
        f = _pyarrow_file(tmp_path / f"{name}.parquet",
                          pa.Table.from_pylist(rows), version, compression,
                          dictionary, compliant)
        assert P.read_rows(f) == pq.read_table(f).to_pylist(), name


@pytest.mark.parametrize("name", sorted(WRITER_ROWS))
def test_writer_matches_the_jax_writers_pyarrow_call(tmp_path, name):
    """pyarrow reads the port's file with the rows and the parquet schema
    of ``pq.write_table(pa.Table.from_pylist(rows))``; the port's reader
    reads both files alike."""
    rows = WRITER_ROWS[name]
    ours, theirs = str(tmp_path / "port.parquet"), str(tmp_path / "jax.parquet")
    P.write_rows(ours, rows)
    pq.write_table(pa.Table.from_pylist(rows), theirs, compression="snappy")
    assert pq.read_table(ours).to_pylist() == pq.read_table(theirs).to_pylist()
    assert pq.ParquetFile(ours).schema.equals(pq.ParquetFile(theirs).schema)
    assert P.read_rows(ours) == P.read_rows(theirs) == rows
    meta = pq.ParquetFile(ours).metadata
    assert meta.num_row_groups == 1
    for i in range(meta.num_columns):
        col = meta.row_group(0).column(i)
        assert col.compression == "SNAPPY"
        assert not col.has_dictionary_page


# --- hypothesis: nested tables pyarrow writes ------------------------------

_LEAVES = st.sampled_from([pa.int8(), pa.int16(), pa.int32(), pa.int64(),
                           pa.uint32(), pa.float32(), pa.float64(), pa.bool_(),
                           pa.string(), pa.null()])


def _field(name, t, nullable):
    return pa.field(name, t, nullable=nullable or pa.types.is_null(t))


_TYPES = st.recursive(_LEAVES, lambda inner: st.one_of(
    st.builds(lambda t, n: pa.list_(_field("item", t, n)), inner,
              st.booleans()),
    st.builds(lambda fs: pa.struct([_field(f"f{i}", t, n)
                                    for i, (t, n) in enumerate(fs)]),
              st.lists(st.tuples(inner, st.booleans()), min_size=1,
                       max_size=3))), max_leaves=6)


def _values(t, nullable):
    if pa.types.is_null(t):
        return st.none()
    if pa.types.is_boolean(t):
        base = st.booleans()
    elif pa.types.is_unsigned_integer(t):
        base = st.integers(0, 2 ** 32 - 1)
    elif pa.types.is_integer(t):
        base = st.integers(-2 ** (t.bit_width - 1), 2 ** (t.bit_width - 1) - 1)
    elif pa.types.is_float32(t):
        base = st.floats(width=32, allow_nan=False)
    elif pa.types.is_float64(t):
        base = st.floats(allow_nan=False)
    elif pa.types.is_string(t):
        base = st.text(max_size=5)
    elif pa.types.is_list(t):
        base = st.lists(_values(t.value_type, t.value_field.nullable),
                        max_size=4)
    else:
        base = st.fixed_dictionaries({f.name: _values(f.type, f.nullable)
                                      for f in t})
    return st.one_of(st.none(), base) if nullable else base


@st.composite
def _tables(draw):
    fields = [_field(f"c{i}", draw(_TYPES), draw(st.booleans()))
              for i in range(draw(st.integers(1, 3)))]
    rows = [{f.name: draw(_values(f.type, f.nullable)) for f in fields}
            for _ in range(draw(st.integers(1, 6)))]
    return pa.Table.from_pylist(rows, schema=pa.schema(fields))


@settings(max_examples=60, deadline=None,
          suppress_health_check=list(HealthCheck))
@given(_tables(), st.sampled_from(OPTIONS))
def test_reader_equals_pyarrow_on_drawn_nested_tables(tmp_path_factory, table,
                                                      option):
    f = _pyarrow_file(tmp_path_factory.mktemp("drawn") / "t.parquet", table,
                      *option)
    assert P.read_rows(f) == pq.read_table(f).to_pylist()


_KINDS = st.recursive(
    st.sampled_from(["int", "float", "bool", "str", "null"]),
    lambda inner: st.one_of(
        st.tuples(st.just("list"), inner),
        st.tuples(st.just("struct"), st.lists(inner, min_size=1, max_size=3))),
    max_leaves=6)


def _py_values(kind):
    if kind == "null":
        return st.none()
    if kind == "int":
        base = st.integers(-2 ** 63, 2 ** 63 - 1)
    elif kind == "float":
        base = st.floats(allow_nan=False)
    elif kind == "bool":
        base = st.booleans()
    elif kind == "str":
        base = st.text(max_size=4)
    elif kind[0] == "list":
        base = st.lists(_py_values(kind[1]), max_size=4)
    else:
        base = st.fixed_dictionaries({f"f{i}": _py_values(k)
                                      for i, k in enumerate(kind[1])})
    return st.one_of(st.none(), base)


@st.composite
def _rows(draw):
    kinds = draw(st.lists(_KINDS, min_size=1, max_size=3))
    return [{f"c{i}": draw(_py_values(k)) for i, k in enumerate(kinds)}
            for _ in range(draw(st.integers(1, 6)))]


@settings(max_examples=60, deadline=None,
          suppress_health_check=list(HealthCheck))
@given(_rows())
def test_writer_equals_pyarrow_on_drawn_rows(tmp_path_factory, rows):
    d = tmp_path_factory.mktemp("rows")
    ours, theirs = str(d / "port.parquet"), str(d / "jax.parquet")
    P.write_rows(ours, rows)
    pq.write_table(pa.Table.from_pylist(rows), theirs, compression="snappy")
    assert pq.read_table(ours).to_pylist() == pq.read_table(theirs).to_pylist()
    assert pq.ParquetFile(ours).schema.equals(pq.ParquetFile(theirs).schema)
    assert P.read_rows(ours) == pq.read_table(theirs).to_pylist()


# --- legacy lists, codecs, corruption --------------------------------------

def _legacy_file(path, element_name: str, values):
    """A one-column file in the legacy 2-level list form
    ``optional group a (LIST) { repeated int64 <element_name>; }`` (no
    element wrapper), or, with ``element_name`` None, the bare repeated
    field ``repeated int64 a``; written with the codec's own helpers."""
    T = P
    bare = element_name is None
    top = 0 if bare else 1        # the definition level of a present list
    rep, dfn, flat = [], [], []
    for v in values:
        if v is None:
            rep.append(0), dfn.append(0)
        elif not v:
            rep.append(0), dfn.append(top)
        else:
            for k, x in enumerate(v):
                rep.append(0 if k == 0 else 1), dfn.append(top + 1)
                flat.append(x)
    page = (T._rle_levels(np.asarray(rep), 1)
            + T._rle_levels(np.asarray(dfn), (top + 1).bit_length())
            + np.asarray(flat, "<i8").tobytes())
    hw = T._ThriftWriter()
    hw.struct([(1, T.T_I32, T.DATA_PAGE), (2, T.T_I32, len(page)),
               (3, T.T_I32, len(page)),
               (5, T.T_STRUCT, [(1, T.T_I32, len(dfn)), (2, T.T_I32, T.PLAIN),
                                (3, T.T_I32, T.RLE), (4, T.T_I32, T.RLE)])])
    body = bytearray(T.MAGIC) + hw.out + page
    meta = T._ThriftWriter()
    meta.struct([
        (1, T.T_I32, 1),
        (2, T.T_LIST, (T.T_STRUCT, [
            [(4, T.T_BINARY, "schema"), (5, T.T_I32, 1)],
            *([] if bare else [[(3, T.T_I32, T.OPTIONAL), (4, T.T_BINARY, "a"),
                                (5, T.T_I32, 1), (6, T.T_I32, T.CT_LIST)]]),
            [(1, T.T_I32, T.INT64), (3, T.T_I32, T.REPEATED),
             (4, T.T_BINARY, "a" if bare else element_name)]])),
        (3, T.T_I64, len(values)),
        (4, T.T_LIST, (T.T_STRUCT, [[
            (1, T.T_LIST, (T.T_STRUCT, [[
                (2, T.T_I64, 4),
                (3, T.T_STRUCT, [
                    (1, T.T_I32, T.INT64), (2, T.T_LIST, (T.T_I32, [0, 3])),
                    (3, T.T_LIST, (T.T_BINARY,
                                   ["a"] if bare else ["a", element_name])),
                    (4, T.T_I32, 0), (5, T.T_I64, len(dfn)),
                    (6, T.T_I64, len(body) - 4), (7, T.T_I64, len(body) - 4),
                    (9, T.T_I64, 4)])]])),
            (2, T.T_I64, len(body) - 4), (3, T.T_I64, len(values))]]))])
    body += meta.out + len(meta.out).to_bytes(4, "little") + T.MAGIC
    path.write_bytes(bytes(body))
    return str(path)


@pytest.mark.parametrize("element_name", ["array", "element", "values",
                                          None])
def test_reader_reads_legacy_two_level_lists_as_pyarrow(tmp_path,
                                                        element_name):
    values = [[1, 2, 3], [], [-5], [7, 8]]
    if element_name is not None:     # a bare repeated field is never null
        values.insert(1, None)
    f = _legacy_file(tmp_path / "legacy.parquet", element_name, values)
    assert pq.read_table(f).to_pylist() == [{"a": v} for v in values]
    assert P.read_rows(f) == [{"a": v} for v in values]


@pytest.mark.parametrize("codec", ["zstd", "brotli", "lz4"])
def test_unknown_codec_raises_naming_it(tmp_path, codec):
    f = str(tmp_path / "t.parquet")
    pq.write_table(pa.Table.from_pylist(WRITER_ROWS["idf"]), f,
                   compression=codec)
    want = {"zstd": "ZSTD", "brotli": "BROTLI", "lz4": "LZ4"}[codec]
    with pytest.raises(NotImplementedError, match=want):
        P.read_rows(f)


def test_snappy_against_pyarrow_both_ways():
    rng = np.random.default_rng(3)
    for data in (b"", b"a", bytes(rng.integers(0, 256, 70_000, np.uint8)),
                 b"abcabcabd" * 9000 + b"tail", b"\x00" * 200_000):
        packed = pa.compress(data, codec="snappy", asbytes=True)
        assert P.snappy_decompress(packed) == data
        ours = P.snappy_compress(data)
        assert pa.decompress(ours, decompressed_size=len(data),
                             codec="snappy", asbytes=True) == data
        assert P.snappy_decompress(ours) == data


def test_corrupt_files_raise(tmp_path):
    f = tmp_path / "t.parquet"
    P.write_rows(str(f), WRITER_ROWS["forest"])
    good = f.read_bytes()
    for bad in (good[:100], good[:-5] + b"PAR1"[:0] + good[-5:-4],
                b"PAR1" + good[4:-4] + b"XXXX", b""):
        f.write_bytes(bad)
        with pytest.raises(ValueError):
            P.read_rows(str(f))
    # a footer whose page offsets point past the end of the file
    f.write_bytes(good[:8] + good[-(8 + int.from_bytes(good[-8:-4], "little")):])
    with pytest.raises(ValueError):
        P.read_rows(str(f))
