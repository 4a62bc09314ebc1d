"""A reader and a writer of the parquet subset that Spark ML artifacts use,
in numpy and the standard library (no pyarrow: the GPU machine has none).

The reader takes what Spark 3.5 (parquet-mr) and pyarrow write for the
stages of ``checkpoint/spark_artifact.py``:

* the footer's Thrift compact ``FileMetaData``: schema tree, row groups,
  column chunks;
* data pages v1 and v2 and dictionary pages; encodings PLAIN,
  PLAIN_DICTIONARY and RLE_DICTIONARY, levels in the RLE/bit-packed hybrid;
* codecs UNCOMPRESSED, SNAPPY (decoded here) and GZIP (``zlib``); any other
  codec raises, naming it;
* physical types BOOLEAN, INT32 (any INT(n) annotation), INT64, FLOAT,
  DOUBLE and BYTE_ARRAY (UTF8 to ``str``), and pyarrow's all-null column
  (the Null logical type);
* nested records by definition and repetition levels: optional and
  required structs and fields, lists in the 3-level form (``list/element``
  as Spark writes it, ``list/item`` as older pyarrow does) and the legacy
  2-level forms.

``read_rows(path)`` returns one Python dict a record, equal to pyarrow's
``pq.read_table(path).to_pylist()``.

``write_rows(path, rows)`` writes one row group with PLAIN encoding, no
dictionary, data page v1 and SNAPPY (a stream of literals), column for
column in the physical and logical types that ``pa.Table.from_pylist(rows)``
infers from the same rows (int -> INT64, float -> DOUBLE, bool -> BOOLEAN,
str -> BYTE_ARRAY String, all-None -> INT32 Null, list -> a 3-level
``list/element`` List group, dict -> a struct group; every node optional).
It writes no stored Arrow schema, so a reader that names list items from
one calls them ``element``.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"PAR1"

# parquet.thrift enums
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY = range(8)
TYPE_NAMES = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE",
              "BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY")
REQUIRED, OPTIONAL, REPEATED = range(3)
CODECS = ("UNCOMPRESSED", "SNAPPY", "GZIP", "LZO", "BROTLI", "LZ4", "ZSTD",
          "LZ4_RAW")
ENCODINGS = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
             5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
             7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY",
             9: "BYTE_STREAM_SPLIT"}
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
DATA_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = 0, 2, 3
# ConvertedType values this module reads or writes
CT_UTF8, CT_LIST, CT_ENUM, CT_JSON = 0, 3, 4, 19
CT_UINT = (11, 12, 13, 14)
# LogicalType union members (field ids)
LT_STRING, LT_LIST, LT_ENUM, LT_INTEGER, LT_NULL, LT_JSON = 1, 3, 4, 10, 11, 12
# logical types whose values pyarrow turns into objects this reader does not
# build (dates, times, decimals, ...): refused rather than misread
_UNREAD_LOGICAL = {5: "DECIMAL", 6: "DATE", 7: "TIME", 8: "TIMESTAMP",
                   14: "UUID", 15: "FLOAT16"}
_UNREAD_CONVERTED = {1: "MAP", 2: "MAP_KEY_VALUE", 5: "DECIMAL", 6: "DATE",
                     7: "TIME_MILLIS", 8: "TIME_MICROS", 9: "TIMESTAMP_MILLIS",
                     10: "TIMESTAMP_MICROS", 21: "INTERVAL"}


class ParquetError(ValueError):
    """A file this module cannot read: not parquet, truncated or corrupt."""


# ---------------------------------------------------------------------------
# Thrift compact protocol
# ---------------------------------------------------------------------------

# compact type ids
T_STOP, T_TRUE, T_FALSE, T_BYTE, T_I16, T_I32, T_I64, T_DOUBLE, T_BINARY, \
    T_LIST, T_SET, T_MAP, T_STRUCT = range(13)


class _ThriftReader:
    """Decodes compact-protocol structs into {field id: value} dicts (lists
    as Python lists, binaries as bytes)."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf, self.pos = buf, pos

    def _byte(self) -> int:
        if self.pos >= len(self.buf):
            raise ParquetError("thrift struct runs past the end of its buffer")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self._byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 70:
                raise ParquetError("thrift varint too long")

    def zigzag(self) -> int:
        n = self.varint()
        return (n >> 1) ^ -(n & 1)

    def value(self, t: int):
        if t == T_TRUE:
            return True
        if t == T_FALSE:
            return False
        if t == T_BYTE:
            b = self._byte()
            return b - 256 if b > 127 else b
        if t in (T_I16, T_I32, T_I64):
            return self.zigzag()
        if t == T_DOUBLE:
            end = self.pos + 8
            if end > len(self.buf):
                raise ParquetError("thrift double runs past its buffer")
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos = end
            return v
        if t == T_BINARY:
            n = self.varint()
            end = self.pos + n
            if end > len(self.buf):
                raise ParquetError("thrift binary runs past its buffer")
            v = bytes(self.buf[self.pos:end])
            self.pos = end
            return v
        if t in (T_LIST, T_SET):
            head = self._byte()
            n, et = head >> 4, head & 0x0F
            if n == 15:
                n = self.varint()
            if et in (T_TRUE, T_FALSE):   # bools in a list: one byte each
                return [self._byte() == T_TRUE for _ in range(n)]
            return [self.value(et) for _ in range(n)]
        if t == T_MAP:
            n = self.varint()
            if n == 0:
                return {}
            kv = self._byte()
            return {self.value(kv >> 4): self.value(kv & 0x0F)
                    for _ in range(n)}
        if t == T_STRUCT:
            return self.struct()
        raise ParquetError(f"unknown thrift compact type {t}")

    def struct(self) -> Dict[int, Any]:
        out: Dict[int, Any] = {}
        last = 0
        while True:
            head = self._byte()
            if head == T_STOP:
                return out
            delta, t = head >> 4, head & 0x0F
            fid = last + delta if delta else self.zigzag()
            out[fid] = self.value(t)
            last = fid


class _ThriftWriter:
    """Encodes structs given as [(field id, compact type, value)] lists;
    a struct value is such a list, a list value is (element type, items).
    It writes the integer, binary, list and struct fields of the footer and
    page headers this module writes, nothing else."""

    def __init__(self):
        self.out = bytearray()

    def varint(self, n: int) -> None:
        while True:
            b = n & 0x7F
            n >>= 7
            if n:
                self.out.append(b | 0x80)
            else:
                self.out.append(b)
                return

    def zigzag(self, n: int) -> None:
        self.varint((n << 1) ^ (n >> 63))

    def value(self, t: int, v) -> None:
        if t in (T_I16, T_I32, T_I64):
            self.zigzag(int(v))
        elif t == T_BINARY:
            b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            self.varint(len(b))
            self.out += b
        elif t == T_LIST:
            et, items = v
            n = len(items)
            self.out.append(((n if n < 15 else 15) << 4) | et)
            if n >= 15:
                self.varint(n)
            for item in items:
                self.value(et, item)
        elif t == T_STRUCT:
            self.struct(v)
        else:
            raise ValueError(f"cannot write thrift type {t}")

    def struct(self, fields) -> None:
        last = 0
        for fid, t, v in sorted(fields, key=lambda f: f[0]):
            delta = fid - last
            if 0 < delta <= 15:
                self.out.append((delta << 4) | t)
            else:
                self.out.append(t)
                self.zigzag(fid)
            self.value(t, v)
            last = fid
        self.out.append(T_STOP)


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------

def snappy_decompress(data: bytes) -> bytes:
    """Decode a raw (unframed) snappy block."""
    src = memoryview(data)
    pos = n = shift = 0
    while True:   # the uncompressed length, a varint
        if pos >= len(src):
            raise ParquetError("snappy: truncated length")
        b = src[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray()
    end = len(src)
    while pos < end:
        tag = src[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:                                   # literal
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                ln = int.from_bytes(src[pos:pos + nb], "little")
                pos += nb
            ln += 1
            if pos + ln > end:
                raise ParquetError("snappy: literal runs past the input")
            out += src[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:                                   # copy, 1-byte offset
            ln = ((tag >> 2) & 7) + 4
            off = ((tag >> 5) << 8) | src[pos]
            pos += 1
        elif kind == 2:                                 # copy, 2-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(src[pos:pos + 2], "little")
            pos += 2
        else:                                           # copy, 4-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(src[pos:pos + 4], "little")
            pos += 4
        if off == 0 or off > len(out):
            raise ParquetError("snappy: copy offset outside the output")
        start = len(out) - off
        if off >= ln:
            out += out[start:start + ln]
        else:                                           # overlapping copy
            pattern = bytes(out[start:])
            reps, rem = divmod(ln, off)
            out += pattern * reps + pattern[:rem]
    if len(out) != n:
        raise ParquetError(f"snappy: {len(out)} bytes decoded, header says {n}")
    return bytes(out)


def snappy_compress(data: bytes) -> bytes:
    """A valid snappy block made of literals only (no matching)."""
    w = _ThriftWriter()
    w.varint(len(data))
    out = w.out
    step = 1 << 16
    for i in range(0, len(data), step):
        chunk = data[i:i + step]
        out.append(61 << 2)                  # literal, 2-byte length follows
        out += (len(chunk) - 1).to_bytes(2, "little")
        out += chunk
    return bytes(out)


def _decompress(codec: int, data: bytes, size: int) -> bytes:
    if codec == 0:
        return data
    if codec == 1:
        out = snappy_decompress(data)
    elif codec == 2:
        out = zlib.decompressobj(wbits=47).decompress(data)
    else:
        name = CODECS[codec] if 0 <= codec < len(CODECS) else f"#{codec}"
        raise NotImplementedError(
            f"parquet codec {name} is not supported (UNCOMPRESSED, SNAPPY "
            "and GZIP are)")
    if len(out) != size:
        raise ParquetError(f"page decompressed to {len(out)} bytes, header "
                           f"says {size}")
    return out


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

@dataclass
class Node:
    """One schema element with its place in the tree."""

    name: str
    repetition: int
    physical: Optional[int] = None           # None for groups
    converted: Optional[int] = None
    logical: Optional[int] = None            # LogicalType union member id
    logical_info: Any = None
    children: List["Node"] = field(default_factory=list)
    max_def: int = 0                         # cumulative, this node included
    max_rep: int = 0
    leaf_ids: List[int] = field(default_factory=list)

    @property
    def is_leaf(self) -> bool:
        return self.physical is not None

    @property
    def is_list(self) -> bool:
        return (not self.is_leaf and len(self.children) == 1
                and self.children[0].repetition == REPEATED
                and (self.converted == CT_LIST or self.logical == LT_LIST))


def _build_schema(elements: List[Dict[int, Any]]) -> Tuple[Node, List[Node]]:
    """The schema tree from the flattened element list, and its leaves in
    column order."""
    leaves: List[Node] = []
    pos = 0

    def build(depth_def: int, depth_rep: int, is_root: bool) -> Node:
        nonlocal pos
        if pos >= len(elements):
            raise ParquetError("schema element list ends inside a group")
        e = elements[pos]
        pos += 1
        logical = e.get(10)
        lt = next(iter(logical)) if logical else None
        node = Node(name=e.get(4, b"").decode("utf-8"),
                    repetition=REQUIRED if is_root else e.get(3, REQUIRED),
                    physical=None if e.get(5) is not None else e.get(1),
                    converted=e.get(6), logical=lt,
                    logical_info=logical.get(lt) if logical else None)
        if node.repetition != REQUIRED:
            depth_def += 1
        if node.repetition == REPEATED:
            depth_rep += 1
        node.max_def, node.max_rep = depth_def, depth_rep
        if node.physical is None:
            for _ in range(e.get(5, 0)):
                child = build(depth_def, depth_rep, False)
                node.children.append(child)
                node.leaf_ids.extend(child.leaf_ids)
        else:
            node.leaf_ids.append(len(leaves))
            leaves.append(node)
        return node

    root = build(0, 0, True)
    if pos != len(elements):
        raise ParquetError("schema element list has elements past its root")
    return root, leaves


# ---------------------------------------------------------------------------
# Page decoding
# ---------------------------------------------------------------------------

def _uleb(buf, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        if pos >= len(buf):
            raise ParquetError("varint runs past its buffer")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _rle_hybrid(buf, pos: int, end: int, bit_width: int,
                count: int) -> np.ndarray:
    """``count`` values of the RLE/bit-packed hybrid in buf[pos:end]."""
    out = np.empty(count, np.int64)
    got = 0
    byte_w = (bit_width + 7) // 8
    while got < count:
        if pos >= end:
            raise ParquetError("RLE/bit-packed run past the end of its data")
        header, pos = _uleb(buf, pos)
        if header & 1:                                  # bit-packed groups
            n = (header >> 1) * 8
            nbytes = (header >> 1) * bit_width
            if pos + nbytes > end:
                raise ParquetError("bit-packed run past the end of its data")
            raw = np.frombuffer(bytes(buf[pos:pos + nbytes]), np.uint8)
            pos += nbytes
            if bit_width == 0:
                vals = np.zeros(n, np.int64)
            else:
                bits = np.unpackbits(raw, bitorder="little")[:n * bit_width]
                vals = (bits.reshape(n, bit_width).astype(np.int64)
                        << np.arange(bit_width, dtype=np.int64)).sum(axis=1)
            take = min(n, count - got)
            out[got:got + take] = vals[:take]
            got += take
        else:                                           # one repeated value
            n = header >> 1
            if pos + byte_w > end:
                raise ParquetError("RLE run past the end of its data")
            v = int.from_bytes(bytes(buf[pos:pos + byte_w]), "little")
            pos += byte_w
            take = min(n, count - got)
            out[got:got + take] = v
            got += take
    return out


_NUMPY = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}


def _plain(buf: bytes, pos: int, physical: int, count: int):
    """``count`` PLAIN values from buf[pos:] -> (values, new pos)."""
    if physical in _NUMPY:
        dt = np.dtype(_NUMPY[physical])
        end = pos + count * dt.itemsize
        if end > len(buf):
            raise ParquetError("PLAIN values run past the end of their page")
        return np.frombuffer(buf, dt, count, pos), end
    if physical == BOOLEAN:
        end = pos + (count + 7) // 8
        if end > len(buf):
            raise ParquetError("PLAIN booleans run past the end of their page")
        bits = np.unpackbits(np.frombuffer(buf, np.uint8, end - pos, pos),
                             bitorder="little")[:count]
        return bits.astype(bool), end
    if physical == BYTE_ARRAY:
        out = []
        for _ in range(count):
            if pos + 4 > len(buf):
                raise ParquetError("PLAIN byte array past the end of its page")
            n = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
            if pos + n > len(buf):
                raise ParquetError("PLAIN byte array past the end of its page")
            out.append(bytes(buf[pos:pos + n]))
            pos += n
        return out, pos
    raise NotImplementedError(
        f"parquet physical type {TYPE_NAMES[physical]} is not supported")


def _take(values, idx: np.ndarray):
    if isinstance(values, list):
        return [values[i] for i in idx.tolist()]
    return values[idx]


def _concat(parts, physical: int):
    if physical == BYTE_ARRAY:
        out: list = []
        for p in parts:
            out.extend(p)
        return out
    if not parts:
        return np.empty(0, _NUMPY.get(physical, bool))
    return np.concatenate(parts)


@dataclass
class Column:
    """A leaf column's levels and its non-null values, in order."""

    rep: np.ndarray
    dfn: np.ndarray
    values: Any


def _read_chunk(buf: bytes, chunk: Dict[int, Any], leaf: Node) -> Column:
    meta = chunk.get(3)
    if meta is None:
        raise ParquetError("column chunk without metadata")
    codec, total = meta[4], meta[5]
    # the dictionary page, when there is one, comes first
    pos = min(meta[9], meta.get(11) or meta[9])
    dictionary = None
    reps, defs, vals = [], [], []
    seen = 0
    while seen < total:
        r = _ThriftReader(buf, pos)
        header = r.struct()
        pos = r.pos
        ptype, usize, csize = header[1], header[2], header[3]
        if pos + csize > len(buf):
            raise ParquetError("page runs past the end of the file")
        raw = buf[pos:pos + csize]
        pos += csize
        if ptype == DICTIONARY_PAGE:
            dh = header[7]
            if dh.get(2, PLAIN) not in (PLAIN, PLAIN_DICTIONARY):
                raise NotImplementedError(
                    f"dictionary page encoding "
                    f"{ENCODINGS.get(dh[2], dh[2])} is not supported")
            page = _decompress(codec, raw, usize)
            dictionary, _ = _plain(page, 0, leaf.physical, dh[1])
            continue
        if ptype == DATA_PAGE:
            dh = header[5]
            n, enc = dh[1], dh[2]
            page = _decompress(codec, raw, usize)
            p = 0
            rep = np.zeros(n, np.int64)
            dfn = np.full(n, leaf.max_def, np.int64)
            for lv, arr_max in ((rep, leaf.max_rep), (dfn, leaf.max_def)):
                if arr_max == 0:
                    continue
                ln = int.from_bytes(page[p:p + 4], "little")
                p += 4
                lv[:] = _rle_hybrid(page, p, p + ln, arr_max.bit_length(), n)
                p += ln
            body = page
        elif ptype == DATA_PAGE_V2:
            dh = header[8]
            n, enc = dh[1], dh[4]
            rl, dl = dh.get(6, 0), dh.get(5, 0)
            rep = (_rle_hybrid(raw, 0, rl, leaf.max_rep.bit_length(), n)
                   if leaf.max_rep else np.zeros(n, np.int64))
            dfn = (_rle_hybrid(raw, rl, rl + dl, leaf.max_def.bit_length(), n)
                   if leaf.max_def else np.full(n, leaf.max_def, np.int64))
            rest = raw[rl + dl:]
            if dh.get(7, True):
                rest = _decompress(codec, rest, usize - rl - dl)
            body, p = rest, 0
        else:
            raise NotImplementedError(f"parquet page type {ptype} is not "
                                      "supported")
        present = int(np.count_nonzero(dfn == leaf.max_def))
        if enc == PLAIN:
            v, _ = _plain(body, p, leaf.physical, present)
        elif enc in (PLAIN_DICTIONARY, RLE_DICTIONARY):
            if dictionary is None:
                raise ParquetError("dictionary-encoded page without a "
                                   "dictionary page")
            if present:
                width = body[p]
                idx = _rle_hybrid(body, p + 1, len(body), width, present)
                if idx.size and (idx.min() < 0 or idx.max() >= len(dictionary)):
                    raise ParquetError("dictionary index out of range")
            else:
                idx = np.empty(0, np.int64)
            v = _take(dictionary, idx)
        elif enc == RLE and leaf.physical == BOOLEAN:
            # booleans in the hybrid at bit width 1, after a 4-byte length
            # (pyarrow's data page v2)
            ln = int.from_bytes(body[p:p + 4], "little")
            v = _rle_hybrid(body, p + 4, p + 4 + ln, 1, present).astype(bool)
        else:
            raise NotImplementedError(
                f"parquet encoding {ENCODINGS.get(enc, enc)} is not supported "
                "(PLAIN, PLAIN_DICTIONARY and RLE_DICTIONARY are)")
        reps.append(rep)
        defs.append(dfn)
        vals.append(v)
        seen += n
    return Column(np.concatenate(reps) if reps else np.empty(0, np.int64),
                  np.concatenate(defs) if defs else np.empty(0, np.int64),
                  _concat(vals, leaf.physical))


def _python_values(leaf: Node, values) -> list:
    """Decoded values as the Python objects pyarrow's to_pylist gives."""
    if leaf.logical in _UNREAD_LOGICAL or leaf.converted in _UNREAD_CONVERTED:
        name = _UNREAD_LOGICAL.get(leaf.logical) or _UNREAD_CONVERTED[leaf.converted]
        raise NotImplementedError(f"column {leaf.name!r}: {name} values are "
                                  "not supported")
    if leaf.physical == BYTE_ARRAY:
        text = (leaf.logical in (LT_STRING, LT_ENUM, LT_JSON)
                or leaf.converted in (CT_UTF8, CT_ENUM, CT_JSON))
        return [v.decode("utf-8") for v in values] if text else list(values)
    if leaf.physical in (INT32, INT64) and values.size:
        unsigned = (leaf.converted in CT_UINT or (
            leaf.logical == LT_INTEGER and leaf.logical_info
            and leaf.logical_info.get(2) is False))
        if unsigned:
            values = values.view(np.uint32 if leaf.physical == INT32
                                 else np.uint64)
    return values.tolist()


# ---------------------------------------------------------------------------
# Record assembly
# ---------------------------------------------------------------------------

class _Assembler:
    """Rebuilds nested values from the leaf columns' levels. A node's value
    is assembled from, for each leaf under it, the range of that leaf's
    level entries that belong to it."""

    def __init__(self, leaves: List[Node], columns: List[Column]):
        self.leaves = leaves
        self.rep = [c.rep for c in columns]
        self.dfn = [c.dfn for c in columns]
        self.vals = [_python_values(lf, c.values)
                     for lf, c in zip(leaves, columns)]
        # index of each level entry's value among the leaf's non-null ones
        self.vpos = [np.concatenate([[0], np.cumsum(c.dfn == lf.max_def)])
                     for lf, c in zip(leaves, columns)]

    def _split(self, leaf: int, lo: int, hi: int, level: int) -> List[int]:
        """Starts of the instances in [lo, hi) at repetition ``level``."""
        r = self.rep[leaf][lo + 1:hi]
        return [lo] + (np.flatnonzero(r <= level) + lo + 1).tolist()

    def records(self, root: Node) -> List[Dict[str, Any]]:
        if not self.leaves:
            return []
        starts = {i: self._split(i, 0, len(self.rep[i]), 0)
                  for i in root.leaf_ids}
        n = len(starts[root.leaf_ids[0]])
        if any(len(s) != n for s in starts.values()):
            raise ParquetError("columns disagree on the number of records")
        ends = {i: s[1:] + [len(self.rep[i])] for i, s in starts.items()}
        return [{c.name: self.value(c, {i: (starts[i][k], ends[i][k])
                                        for i in c.leaf_ids})
                 for c in root.children} for k in range(n)]

    def value(self, node: Node, ranges: Dict[int, Tuple[int, int]]):
        """The value of ``node`` over ``ranges``: a bare repeated field is
        the list of its elements, a LIST group the list of its repeated
        child's."""
        first = node.leaf_ids[0]
        lo = ranges[first][0]
        if node.repetition == OPTIONAL and self.dfn[first][lo] < node.max_def:
            return None
        if node.repetition == REPEATED:
            return self.elements(node, ranges, wrapped=False)
        if node.is_leaf:
            return self.vals[first][self.vpos[first][lo]]
        if node.is_list:
            rep = node.children[0]
            return self.elements(rep, ranges, wrapped=self._three_level(rep))
        return {c.name: self.value(c, {i: ranges[i] for i in c.leaf_ids})
                for c in node.children}

    def elements(self, rep: Node, ranges: Dict[int, Tuple[int, int]],
                 wrapped: bool) -> list:
        """The list of a repeated node's elements over ``ranges``; each
        element is the node's one child when ``wrapped`` (the 3-level
        form), else the node itself."""
        first = rep.leaf_ids[0]
        lo, hi = ranges[first]
        if self.dfn[first][lo] < rep.max_def:
            return []
        if rep.is_leaf:                  # a list of primitives: one slice
            d = self.dfn[first][lo:hi]
            v = self.vals[first]
            if bool((d == rep.max_def).all()):
                a = self.vpos[first][lo]
                return v[a:a + hi - lo]
            return [v[self.vpos[first][j]] if d[j - lo] == rep.max_def
                    else None for j in range(lo, hi)]
        if wrapped and rep.children[0].is_leaf:
            # list<primitive> in the 3-level form: one slice when no
            # element is null
            leaf = rep.children[0]
            d = self.dfn[first][lo:hi]
            if bool((d == leaf.max_def).all()):
                a = self.vpos[first][lo]
                return self.vals[first][a:a + hi - lo]
        cuts = {i: self._split(i, *ranges[i], rep.max_rep)
                for i in rep.leaf_ids}
        n = len(cuts[first])
        ends = {i: c[1:] + [ranges[i][1]] for i, c in cuts.items()}
        out = []
        for k in range(n):
            sub = {i: (cuts[i][k], ends[i][k]) for i in rep.leaf_ids}
            if wrapped:
                child = rep.children[0]
                out.append(self.value(child, {i: sub[i]
                                              for i in child.leaf_ids}))
            else:
                out.append(self.element(rep, sub))
        return out

    def element(self, node: Node, ranges: Dict[int, Tuple[int, int]]):
        """One element of a repeated node that is its own element (a legacy
        2-level list or a bare repeated field)."""
        if node.is_leaf:
            first = node.leaf_ids[0]
            return self.vals[first][self.vpos[first][ranges[first][0]]]
        return {c.name: self.value(c, {i: ranges[i] for i in c.leaf_ids})
                for c in node.children}

    @staticmethod
    def _three_level(rep: Node) -> bool:
        """Whether a LIST group's repeated child wraps the element (the
        3-level form) rather than being it (the legacy 2-level forms,
        parquet's backward-compatibility rules)."""
        if rep.is_leaf or len(rep.children) != 1:
            return False
        return not (rep.name == "array" or rep.name.endswith("_tuple"))


# ---------------------------------------------------------------------------
# Public entries
# ---------------------------------------------------------------------------

def read_metadata(buf: bytes) -> Dict[int, Any]:
    """The footer's FileMetaData struct ({field id: value})."""
    if len(buf) < 12 or buf[:4] != MAGIC or buf[-4:] != MAGIC:
        raise ParquetError("not a parquet file (magic bytes missing)")
    n = int.from_bytes(buf[-8:-4], "little")
    if n <= 0 or n > len(buf) - 12:
        raise ParquetError("parquet footer length out of range")
    return _ThriftReader(buf, len(buf) - 8 - n).struct()


def read_rows(path: str) -> List[Dict[str, Any]]:
    """Every record of the parquet file at ``path`` as a dict, equal to
    pyarrow's ``pq.read_table(path).to_pylist()``. A file whose structures
    do not hold together (a field of the wrong type, an offset or index out
    of range, a bad compressed stream) raises ``ParquetError``."""
    with open(path, "rb") as fh:
        buf = fh.read()
    try:
        return _read_bytes(buf)
    except (TypeError, KeyError, IndexError, AttributeError, OverflowError,
            struct.error, zlib.error, UnicodeDecodeError) as e:
        raise ParquetError(f"corrupt parquet file: {type(e).__name__}: {e}"
                           ) from e


def _read_bytes(buf: bytes) -> List[Dict[str, Any]]:
    meta = read_metadata(buf)
    root, leaves = _build_schema(meta[2])
    _check_maps(root)
    out: List[Dict[str, Any]] = []
    for rg in meta.get(4, []):
        chunks = rg[1]
        if len(chunks) != len(leaves):
            raise ParquetError(f"row group has {len(chunks)} column chunks "
                               f"for {len(leaves)} leaf columns")
        columns = [_read_chunk(buf, c, lf) for c, lf in zip(chunks, leaves)]
        rows = _Assembler(leaves, columns).records(root)
        if len(rows) != rg[3]:
            raise ParquetError(f"row group holds {len(rows)} records, its "
                               f"metadata says {rg[3]}")
        out.extend(rows)
    return out


def _check_maps(node: Node) -> None:
    if not node.is_leaf and (node.converted in (1, 2) or node.logical == 2):
        raise NotImplementedError(f"map column {node.name!r} is not supported")
    for c in node.children:
        _check_maps(c)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

@dataclass
class _WType:
    """An inferred column type: 'null' | 'bool' | 'int' | 'float' | 'str' |
    'list' (``item``) | 'struct' (``fields``, name -> type, in order)."""

    kind: str
    item: Optional["_WType"] = None
    fields: Optional[Dict[str, "_WType"]] = None


def _infer(values: Sequence[Any]) -> _WType:
    """pyarrow's inference over one column's Python values."""
    t = _WType("null")
    for v in values:
        t = _unify(t, _infer_one(v))
    return t


def _infer_one(v) -> _WType:
    if v is None:
        return _WType("null")
    if isinstance(v, (bool, np.bool_)):
        return _WType("bool")
    if isinstance(v, (int, np.integer)):
        return _WType("int")
    if isinstance(v, (float, np.floating)):
        return _WType("float")
    if isinstance(v, str):
        return _WType("str")
    if isinstance(v, (list, tuple)):
        return _WType("list", item=_infer(v))
    if isinstance(v, dict):
        fields: Dict[str, _WType] = {}
        for k, x in v.items():
            fields[k] = _infer_one(x)
        return _WType("struct", fields=fields)
    raise TypeError(f"cannot write a value of type {type(v).__name__}")


def _unify(a: _WType, b: _WType) -> _WType:
    if a.kind == "null":
        return b
    if b.kind == "null":
        return a
    if {a.kind, b.kind} == {"int", "float"}:
        return _WType("float")
    if a.kind != b.kind:
        raise TypeError(f"a column mixes {a.kind} and {b.kind} values")
    if a.kind == "list":
        return _WType("list", item=_unify(a.item, b.item))
    if a.kind == "struct":
        fields = dict(a.fields)
        for k, t in b.fields.items():
            fields[k] = _unify(fields[k], t) if k in fields else t
        return _WType("struct", fields=fields)
    return a


# physical type, converted type, logical type (union member, payload) per
# leaf kind
_LEAF = {"null": (INT32, None, (LT_NULL, [])),
         "bool": (BOOLEAN, None, None),
         "int": (INT64, None, None),
         "float": (DOUBLE, None, None),
         "str": (BYTE_ARRAY, CT_UTF8, (LT_STRING, []))}


@dataclass
class _WLeaf:
    path: List[str]
    kind: str
    max_def: int
    max_rep: int
    rep: List[int] = field(default_factory=list)
    dfn: List[int] = field(default_factory=list)
    values: list = field(default_factory=list)


def _schema_elements(name: str, t: _WType, elements: list, leaves: list,
                     path: List[str], d: int, r: int) -> None:
    """Append ``t``'s schema elements (every node optional; lists in the
    3-level form) and its leaves."""
    d += 1                                   # this node is optional
    if t.kind == "list":
        elements.append([(3, T_I32, OPTIONAL), (4, T_BINARY, name),
                         (5, T_I32, 1), (6, T_I32, CT_LIST),
                         (10, T_STRUCT, [(LT_LIST, T_STRUCT, [])])])
        elements.append([(3, T_I32, REPEATED), (4, T_BINARY, "list"),
                         (5, T_I32, 1)])
        _schema_elements("element", t.item, elements, leaves,
                         path + [name, "list"], d + 1, r + 1)
        return
    if t.kind == "struct":
        elements.append([(3, T_I32, OPTIONAL), (4, T_BINARY, name),
                         (5, T_I32, len(t.fields))])
        for k, ft in t.fields.items():
            _schema_elements(k, ft, elements, leaves, path + [name], d, r)
        return
    physical, converted, logical = _LEAF[t.kind]
    el = [(1, T_I32, physical), (3, T_I32, OPTIONAL), (4, T_BINARY, name)]
    if converted is not None:
        el.append((6, T_I32, converted))
    if logical is not None:
        el.append((10, T_STRUCT, [(logical[0], T_STRUCT, logical[1])]))
    elements.append(el)
    leaves.append(_WLeaf(path + [name], t.kind, d, r))


def _count_leaves(t: _WType) -> int:
    if t.kind == "list":
        return _count_leaves(t.item)
    if t.kind == "struct":
        return sum(_count_leaves(f) for f in t.fields.values())
    return 1


def _shred(v, t: _WType, leaves: List[_WLeaf], li: int, r: int, d: int,
           rl: int) -> int:
    """Append ``v``'s levels and values to the leaves of ``t`` (from index
    ``li``; returns the index after them). ``r`` is the repetition level of
    the first entry, ``d`` the definition level of the parent and ``rl``
    the number of lists around ``v``. Every node is optional, so ``v``
    defined is ``d + 1``; a list's repeated group adds one more."""
    if v is None:
        n = _count_leaves(t)
        for lf in leaves[li:li + n]:
            lf.rep.append(r)
            lf.dfn.append(d)
        return li + n
    d += 1
    if t.kind == "list":
        if len(v) == 0:
            n = _count_leaves(t.item)
            for lf in leaves[li:li + n]:
                lf.rep.append(r)
                lf.dfn.append(d)
            return li + n
        nxt = li
        for k, x in enumerate(v):
            nxt = _shred(x, t.item, leaves, li, r if k == 0 else rl + 1,
                         d + 1, rl + 1)
        return nxt
    if t.kind == "struct":
        for k, ft in t.fields.items():
            li = _shred(v.get(k), ft, leaves, li, r, d, rl)
        return li
    lf = leaves[li]
    lf.rep.append(r)
    lf.dfn.append(d)
    lf.values.append(v)
    return li + 1


def _rle_levels(levels: np.ndarray, bit_width: int) -> bytes:
    """Levels as RLE runs of the hybrid encoding, with the 4-byte length
    prefix of data page v1."""
    w = _ThriftWriter()
    byte_w = (bit_width + 7) // 8
    if levels.size:
        cuts = np.flatnonzero(np.diff(levels)) + 1
        starts = np.concatenate([[0], cuts])
        ends = np.concatenate([cuts, [levels.size]])
        for s, e in zip(starts.tolist(), ends.tolist()):
            w.varint((e - s) << 1)
            w.out += int(levels[s]).to_bytes(byte_w, "little")
    return len(w.out).to_bytes(4, "little") + bytes(w.out)


def _plain_bytes(kind: str, values: list) -> bytes:
    if kind == "null" or not values:
        return b""
    if kind == "bool":
        return np.packbits(np.asarray(values, bool), bitorder="little").tobytes()
    if kind == "int":
        return np.asarray(values, "<i8").tobytes()
    if kind == "float":
        return np.asarray(values, "<f8").tobytes()
    out = bytearray()
    for s in values:
        b = s.encode("utf-8")
        out += len(b).to_bytes(4, "little") + b
    return bytes(out)


def write_rows(path: str, rows: Sequence[Dict[str, Any]]) -> None:
    """Write ``rows`` (dicts) as one row group: PLAIN, data page v1,
    SNAPPY, in the types ``pa.Table.from_pylist(rows)`` infers. Top-level
    columns are the first row's keys, as pyarrow takes them."""
    if not rows:
        raise ValueError("write_rows needs at least one row")
    names = list(rows[0].keys())
    types = {k: _infer([r.get(k) for r in rows]) for k in names}
    elements = [[(4, T_BINARY, "schema"), (5, T_I32, len(names))]]
    leaves: List[_WLeaf] = []
    for k in names:
        _schema_elements(k, types[k], elements, leaves, [], 0, 0)
    for row in rows:
        li = 0
        for k in names:
            li = _shred(row.get(k), types[k], leaves, li, 0, 0, 0)
    body = bytearray(MAGIC)
    chunks = []
    total = 0
    for lf in leaves:
        rep = np.asarray(lf.rep, np.int64)
        dfn = np.asarray(lf.dfn, np.int64)
        page = bytearray()
        if lf.max_rep:
            page += _rle_levels(rep, lf.max_rep.bit_length())
        if lf.max_def:
            page += _rle_levels(dfn, lf.max_def.bit_length())
        page += _plain_bytes(lf.kind, lf.values)
        compressed = snappy_compress(bytes(page))
        hw = _ThriftWriter()
        hw.struct([(1, T_I32, DATA_PAGE), (2, T_I32, len(page)),
                   (3, T_I32, len(compressed)),
                   (5, T_STRUCT, [(1, T_I32, len(dfn)), (2, T_I32, PLAIN),
                                  (3, T_I32, RLE), (4, T_I32, RLE)])])
        offset = len(body)
        body += hw.out
        body += compressed
        physical = _LEAF[lf.kind][0]
        size_c = len(hw.out) + len(compressed)
        size_u = len(hw.out) + len(page)
        total += size_u
        chunks.append([
            (2, T_I64, offset),
            (3, T_STRUCT, [
                (1, T_I32, physical),
                (2, T_LIST, (T_I32, [PLAIN, RLE])),
                (3, T_LIST, (T_BINARY, lf.path)),
                (4, T_I32, 1),                               # SNAPPY
                (5, T_I64, len(dfn)),
                (6, T_I64, size_u),
                (7, T_I64, size_c),
                (9, T_I64, offset)])])
    meta = _ThriftWriter()
    meta.struct([
        (1, T_I32, 1),
        (2, T_LIST, (T_STRUCT, elements)),
        (3, T_I64, len(rows)),
        (4, T_LIST, (T_STRUCT, [[(1, T_LIST, (T_STRUCT, chunks)),
                                 (2, T_I64, total),
                                 (3, T_I64, len(rows)),
                                 (5, T_I64, 4),
                                 (6, T_I64, len(body) - 4)]])),
        (6, T_BINARY, "fraud_detection_tpu_torch parquet writer")])
    body += meta.out
    body += len(meta.out).to_bytes(4, "little") + MAGIC
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(body)
    os.replace(tmp, path)
