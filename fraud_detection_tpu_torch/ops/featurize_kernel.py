"""Device-side featurization: raw UTF-8 bytes in, packed (B, 2, L) ids/counts
staging layout out — twin of ``fraud_detection_tpu/ops/featurize_kernel.py``.

The host ships a fixed-width ``(B, W+4)`` uint8 staging tensor (each
dialogue's UTF-8 bytes plus its length) and the device reproduces the exact
Spark-parity pipeline. ``featurize_bytes`` on a CUDA tensor launches ONE
hand-written kernel, ``featurize_packed`` in ``ops/csrc/featurize_scan.cu``,
which does all of it (``featurize_bytes.launches`` counts the launches); on
a CPU tensor it runs the plain torch version ``featurize_bytes_reference``,
the composition of the steps below. There is no fallback from one to the
other: a kernel that fails to build or launch raises.

  * **clean_text** as byte classing (``byte_classes``): ASCII A-Z
    lowercases, a-z and space keep, everything else strips — except the
    two codepoints whose ``str.lower()`` lands in ``[a-z ]`` (SPECIAL_LOWER).
  * **tokenize + murmur3 + identity pack** (``tokenize_hash``): the token
    streams of each row's classes, the reference ``tokenize_hash``'s
    contract. A CUDA tensor launches the kernel's second entry,
    ``featurize_scan`` (``tokenize_hash.launches``); a CPU tensor runs
    ``tokenize_hash_reference`` (a loop over columns, vectorized over rows).
  * **stop words, count, pack** (``assemble_packed``): an exact
    direct-mapped stop-table probe, bucket = nonNegativeMod(hash, F),
    per-row unique-bucket counts via sort + segment-sum, the host truncation
    rule past ``n_slots`` (top counts, ties to the lower bucket id), and the
    packed int16 layout ``models/pipeline._pack_encoded`` produces.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from fraud_detection_tpu_torch.featurize.hashing import (
    SPARK_HASHING_TF_SEED, murmur3_x86_32, murmur3_x86_32_legacy_tail,
    spark_hash_bucket)
from fraud_detection_tpu_torch.ops._build import KernelError, count_launch
from fraud_detection_tpu_torch.utils.device import cache_per_card, device_context

# Character classes produced by byte_classes: 1..26 = 'a'..'z', the rest
# as named below. Everything stripped by clean_text is NOP.
CLS_NOP = 0
CLS_SPACE = 27
CLS_END = 28

#: The only codepoints whose ``str.lower()`` contains chars in ``[a-z ]``:
#: İ (U+0130) lowercases to "i" + combining dot; K (U+212A, Kelvin) to 'k'.
#: Their UTF-8 encodings and the surviving ASCII letter.
SPECIAL_LOWER = ((b"\xc4\xb0", ord("i")), (b"\xe2\x84\xaa", ord("k")))

# Stop-word identity pack: cleaned tokens are [a-z]*, so 5 bits/char and
# two 30-bit words identify any token up to 12 chars exactly (length is
# compared too). The longest word in Spark's default English list is 10.
_STOP_PACK_CHARS = 12
_STOP_TABLE_MAX = 1 << 16

_MASK32 = 0xFFFFFFFF


class FeaturizeSpec(NamedTuple):
    """Static configuration of the device featurize program."""

    num_features: int
    n_slots: int            # token slots L in the packed output
    binary: bool            # HashingTF(binary=True): presence, not counts
    legacy: bool            # murmur legacy sign-extended-tail variant
    empty_bucket: int       # spark_hash_bucket("") — the "" token's bucket
    empty_is_stop: bool     # "" present in the stop list


# ---------------------------------------------------------------------------
# uint32 arithmetic on int64 tensors holding values in [0, 2**32)
# ---------------------------------------------------------------------------

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 without int64 overflow: split c into 16-bit halves
    (each partial product stays below 2**48)."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def _mix_k1(k1):
    return _mul32(_rotl32(_mul32(k1, 0xCC9E2D51), 15), 0x1B873593)


def _mix_h1(h1, k1):
    h1 = _rotl32(h1 ^ k1, 13)
    return (_mul32(h1, 5) + 0xE6546B64) & _MASK32


def _fmix(h1, length):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul32(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def _to_int32(u: torch.Tensor) -> torch.Tensor:
    """[0, 2**32) int64 -> the int32 with the same bits (arithmetically:
    torch has no uint32 -> int32 bit-cast on every backend)."""
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


# ---------------------------------------------------------------------------
# clean_text as byte classing
# ---------------------------------------------------------------------------

def _shifted(b: torch.Tensor, k: int) -> torch.Tensor:
    """b[:, j + k] with zeros past the end (same width as b)."""
    return torch.nn.functional.pad(b[:, k:], (0, min(k, b.shape[1])))


def byte_classes(byts: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, W) uint8 + (B,) lengths -> (B, W+1) int32 char classes.

    Implements clean_text byte-exactly. Position ``lengths[r]`` carries
    CLS_END (the scan's flush trigger); a padding row (length -1) has none,
    so it featurizes to nothing."""
    b = byts.to(torch.int32)
    nxt1 = _shifted(b, 1)
    nxt2 = _shifted(b, 2)
    upper = (b >= 65) & (b <= 90)
    lower = (b >= 97) & (b <= 122)
    cls = torch.where(upper, b - 64, torch.where(lower, b - 96, CLS_NOP))
    cls = torch.where(b == 32, CLS_SPACE, cls)
    (s_i, ch_i), (s_k, ch_k) = SPECIAL_LOWER
    cls = torch.where((b == s_i[0]) & (nxt1 == s_i[1]), ch_i - 96, cls)
    cls = torch.where((b == s_k[0]) & (nxt1 == s_k[1]) & (nxt2 == s_k[2]),
                      ch_k - 96, cls)
    cls = torch.nn.functional.pad(cls, (0, 1))
    pos = torch.arange(cls.shape[1], dtype=torch.int32,
                       device=cls.device)[None, :]
    ln = lengths.to(torch.int32)[:, None]
    out = torch.where(pos < ln, cls,
                      torch.where(pos == ln, CLS_END, CLS_NOP))
    return out.to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# the scan: tokenize + murmur + stop-key pack, one pass over the columns
# ---------------------------------------------------------------------------

def tokenize_hash(classes: torch.Tensor, *, legacy: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor]:
    """Scan a (B, C) int32 class tensor.

    Returns per-position streams ``(h_raw, w0, w1, tok_len)`` — each (B, C)
    int32, ``tok_len`` is -1 where no token ends — plus the per-row count of
    confirmed empty tokens (B, 1). A CUDA tensor launches the kernel's
    ``featurize_scan`` entry (``tokenize_hash.launches`` counts the
    launches); a CPU tensor runs the plain torch version."""
    if classes.device.type == "cpu":
        return tokenize_hash_reference(classes, legacy=legacy)
    if classes.device.type != "cuda":
        raise ValueError(f"tokenize_hash: unsupported device {classes.device}")
    return _tokenize_hash_cuda(classes, legacy)


tokenize_hash.launches = 0

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# the C signatures of featurize_scan.cu's two entry points, in order
_PACKED_ARGTYPES = [_PTR, _PTR, _INT, _PTR, _PTR] + [_INT] * 8 + [_PTR]
_SCAN_ARGTYPES = [_PTR] * 6 + [_INT] * 3 + [_PTR]


@lru_cache(maxsize=None)
def _scan_lib() -> ctypes.CDLL:
    from fraud_detection_tpu_torch.ops import _build

    lib = _build.load("featurize_scan")
    for fn, argtypes in ((lib.featurize_packed, _PACKED_ARGTYPES),
                         (lib.featurize_scan, _SCAN_ARGTYPES)):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check_rc(rc: int, entry: str) -> None:
    if rc != 0:
        raise KernelError(f"{entry} launch failed: cudaError {rc}")


def _tokenize_hash_cuda(classes: torch.Tensor, legacy: bool):
    if classes.dtype != torch.int32 or classes.dim() != 2:
        raise ValueError(f"featurize_scan takes (B, C) int32 classes, got "
                         f"{tuple(classes.shape)} {classes.dtype}")
    if not classes.is_contiguous():
        raise ValueError("featurize_scan takes a contiguous class tensor")
    rows, cols = classes.shape
    h, w0, w1, tl = (torch.empty((rows, cols), dtype=torch.int32,
                                 device=classes.device) for _ in range(4))
    emp = torch.empty((rows, 1), dtype=torch.int32, device=classes.device)
    if rows == 0 or cols == 0:
        tl.fill_(-1)
        emp.zero_()
        return h, w0, w1, tl, emp
    fn = _scan_lib().featurize_scan
    stream = torch.cuda.current_stream(classes.device).cuda_stream
    with device_context(classes.device):
        _check_rc(fn(classes.data_ptr(), h.data_ptr(), w0.data_ptr(),
                     w1.data_ptr(), tl.data_ptr(), emp.data_ptr(), rows, cols,
                     int(legacy), stream), "featurize_scan")
    count_launch(tokenize_hash)
    return h, w0, w1, tl, emp


def tokenize_hash_reference(classes: torch.Tensor, *, legacy: bool = False):
    """Plain torch version of the scan kernel: the same state machine as a
    loop over columns, vectorized over rows, with the murmur arithmetic in
    int64 masked to 32 bits. Columns past the last non-NOP class of every
    row change no state and emit nothing, so the loop stops there."""
    cls = classes.to(torch.int64)
    b, n = cls.shape
    dev = cls.device
    h_out = torch.zeros((b, n), dtype=torch.int64, device=dev)
    w0_out = torch.zeros((b, n), dtype=torch.int64, device=dev)
    w1_out = torch.zeros((b, n), dtype=torch.int64, device=dev)
    tl_out = torch.full((b, n), -1, dtype=torch.int64, device=dev)
    live = torch.nonzero((cls != CLS_NOP).any(dim=0))
    n_live = int(live[-1]) + 1 if live.numel() else 0

    seed = torch.full((b,), SPARK_HASHING_TF_SEED, dtype=torch.int64,
                      device=dev)
    zero = torch.zeros(b, dtype=torch.int64, device=dev)
    h1, k1, nb, w0, w1, pend, emp = seed, zero, zero, zero, zero, zero, zero
    kept = torch.zeros(b, dtype=torch.bool, device=dev)
    for j in range(n_live):
        c = cls[:, j]
        is_let = (c >= 1) & (c <= 26)
        is_space = c == CLS_SPACE
        is_end = c == CLS_END

        vb = torch.where(is_let, c + 96, 0)
        k1n = torch.where(is_let, k1 | (vb << ((nb & 3) * 8)), k1)
        word_full = is_let & ((nb & 3) == 3)
        h1n = torch.where(word_full, _mix_h1(h1, _mix_k1(k1n)), h1)
        k1n = torch.where(word_full, 0, k1n)
        cw = torch.where(is_let, c, 0)
        w0n = torch.where(is_let & (nb < 6),
                          w0 | (cw << (5 * nb.clamp(max=6))), w0)
        w1n = torch.where(is_let & (nb >= 6) & (nb < _STOP_PACK_CHARS),
                          w1 | (cw << (5 * (nb - 6).clamp(0, 6))), w1)
        nbn = torch.where(is_let, nb + 1, nb)

        boundary = is_space | is_end
        emit = boundary & (nbn > 0)
        if legacy:
            hfin = h1n
            tail = nbn & 3
            for t in range(3):
                byte_t = (k1n >> (8 * t)) & 0xFF
                hfin = torch.where(tail > t, _mix_h1(hfin, _mix_k1(byte_t)),
                                   hfin)
        else:
            hfin = h1n ^ _mix_k1(k1n)
        hfin = _fmix(hfin, nbn)

        h_out[:, j] = torch.where(emit, hfin, 0)
        w0_out[:, j] = torch.where(emit, w0n, 0)
        w1_out[:, j] = torch.where(emit, w1n, 0)
        tl_out[:, j] = torch.where(emit, nbn, -1)

        emp = torch.where(emit, emp + pend, emp)
        pend = torch.where(emit, 0, pend)
        pend = torch.where(is_space & (nbn == 0), pend + 1, pend)
        kept = kept | is_let | is_space
        emp = torch.where(is_end & ~kept, 1, emp)

        h1 = torch.where(boundary, SPARK_HASHING_TF_SEED, h1n)
        k1 = torch.where(boundary, 0, k1n)
        nb = torch.where(boundary, 0, nbn)
        w0 = torch.where(boundary, 0, w0n)
        w1 = torch.where(boundary, 0, w1n)
    return (_to_int32(h_out), w0_out.to(torch.int32), w1_out.to(torch.int32),
            tl_out.to(torch.int32), emp.to(torch.int32)[:, None])


# ---------------------------------------------------------------------------
# stop-word table (host build + device probe share one hash)
# ---------------------------------------------------------------------------

def _probe_mix(w0: int, w1: int, ln: int) -> int:
    """The direct-map probe hash, in wrap-around uint32 arithmetic. The
    tensor twin below must stay expression-identical."""
    h = (w0 * 0x9E3779B1 + w1 * 0x85EBCA6B + ln * 0xC2B2AE35) & _MASK32
    h ^= h >> 15
    h = (h * 0x2C1B3C6D) & _MASK32
    h ^= h >> 12
    return h


def _probe_mix_tensor(w0, w1, ln):
    w0u = w0.to(torch.int64) & _MASK32
    w1u = w1.to(torch.int64) & _MASK32
    lnu = ln.to(torch.int64) & _MASK32     # tok_len -1 -> 0xFFFFFFFF
    h = (_mul32(w0u, 0x9E3779B1) + _mul32(w1u, 0x85EBCA6B)
         + _mul32(lnu, 0xC2B2AE35)) & _MASK32
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    return h ^ (h >> 12)


def pack_token(word: str) -> Optional[Tuple[int, int, int]]:
    """(w0, w1, len) identity key of a cleaned token, or None when the word
    can never equal a cleaned token (chars outside [a-z])."""
    if any(not ("a" <= ch <= "z") for ch in word):
        return None
    w0 = w1 = 0
    for i, ch in enumerate(word[:_STOP_PACK_CHARS]):
        v = ord(ch) - 96
        if i < 6:
            w0 |= v << (5 * i)
        else:
            w1 |= v << (5 * (i - 6))
    return w0, w1, len(word)


def build_stop_table(words) -> Optional[Tuple[np.ndarray, bool]]:
    """Direct-mapped (size, 3) int32 stop table [w0, w1, len] + the
    empty-token flag, or None when the list cannot be represented exactly
    (a pure-[a-z] word longer than the pack width).

    Size doubles until every eligible word lands in its own slot, so the
    table is collision-free by construction and one gather + compare per
    token is an EXACT membership test. Empty slots carry len = -1."""
    empty_is_stop = False
    keys = []
    for w in words:
        if w == "":
            empty_is_stop = True
            continue
        key = pack_token(w)
        if key is None:
            continue                    # unmatchable on host too: exact drop
        if len(w) > _STOP_PACK_CHARS:
            return None                 # would ALIAS 12-char prefixes: refuse
        keys.append(key)
    size = 64
    while size <= _STOP_TABLE_MAX:
        slots = {}
        for key in keys:
            idx = _probe_mix(*key) & (size - 1)
            if idx in slots and slots[idx] != key:
                break
            slots[idx] = key
        else:
            tbl = np.full((size, 3), -1, np.int32)
            for idx, (w0, w1, ln) in slots.items():
                tbl[idx] = (w0, w1, ln)
            return tbl, empty_is_stop
        size *= 2
    return None


# ---------------------------------------------------------------------------
# count + pack
# ---------------------------------------------------------------------------

def assemble_packed(h_raw, w0, w1, tok_len, empty_cnt, stop_table,
                    *, spec: FeaturizeSpec
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token streams -> (packed (B, 2, n_slots) int16, per-row (B,) int32
    unique-bucket count before truncation). Ids ascend with zero padding;
    counts ride as uint16 bits in the int16 plane — exactly
    ``_pack_encoded``'s layout."""
    b, n = h_raw.shape
    f = spec.num_features
    dev = h_raw.device

    idx = _probe_mix_tensor(w0, w1, tok_len) & (stop_table.shape[0] - 1)
    probe = stop_table[idx]                              # (B, N, 3) gather
    is_tok = tok_len >= 0
    is_stop = (is_tok & (probe[..., 0] == w0) & (probe[..., 1] == w1)
               & (probe[..., 2] == tok_len))
    keep = is_tok & ~is_stop

    bucket = torch.remainder(h_raw, f)          # floor-mod == nonNegativeMod
    stream = torch.where(keep, bucket, f)       # sentinel f sorts last
    weight = keep.to(torch.int32)

    # The empty token "" rides as one extra (bucket, multiplicity) slot.
    emp = (torch.zeros_like(empty_cnt) if spec.empty_is_stop
           else empty_cnt.to(torch.int32))
    stream = torch.cat(
        [stream, torch.where(emp > 0, spec.empty_bucket, f).to(stream.dtype)],
        dim=1)
    weight = torch.cat([weight, emp], dim=1)

    order = torch.argsort(stream, dim=1, stable=True)
    sb = torch.gather(stream, 1, order)
    sw = torch.gather(weight, 1, order)
    first = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev),
                       sb[:, 1:] != sb[:, :-1]], dim=1)
    seg = torch.cumsum(first.to(torch.int64), dim=1) - 1
    n_seg = n + 2                       # n+1 slots -> at most n+1 segments
    counts = torch.zeros((b, n_seg), dtype=torch.int32, device=dev
                         ).scatter_add_(1, seg, sw)
    ids = torch.zeros((b, n_seg), dtype=torch.int32, device=dev
                      ).scatter_reduce_(1, seg, sb.to(torch.int32), "amax",
                                        include_self=True)
    valid = (ids < f) & (counts > 0)
    counts = torch.where(valid, counts, 0)
    n_unique = valid.sum(dim=1, dtype=torch.int32)

    # Host truncation rule: keep the top-count buckets, ties toward the
    # LOWER bucket id — ids ascend here, so a stable sort on -count is it.
    sel = torch.argsort(-counts, dim=1, stable=True)[:, : spec.n_slots]
    sel_ids = torch.gather(ids, 1, sel)
    sel_cnt = torch.gather(counts, 1, sel)
    resort = torch.argsort(torch.where(sel_cnt > 0, sel_ids, f), dim=1,
                           stable=True)
    out_ids = torch.gather(sel_ids, 1, resort)
    out_cnt = torch.gather(sel_cnt, 1, resort)
    out_ids = torch.where(out_cnt > 0, out_ids, 0)
    if spec.binary:
        out_cnt = torch.clamp(out_cnt, max=1)
    out_cnt = torch.clamp(out_cnt, max=65535)
    if spec.n_slots > out_ids.shape[1]:     # tiny W: pad up to the contract
        pad = spec.n_slots - out_ids.shape[1]
        out_ids = torch.nn.functional.pad(out_ids, (0, pad))
        out_cnt = torch.nn.functional.pad(out_cnt, (0, pad))
    # uint16 -> int16 bit pattern, arithmetically
    cnt16 = torch.where(out_cnt > 32767, out_cnt - 65536, out_cnt)
    packed = torch.stack([out_ids.to(torch.int16), cnt16.to(torch.int16)],
                         dim=1)
    return packed, n_unique


def split_staged(staged: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, W+4) uint8 staging tensor -> ((B, W) bytes, (B,) int32 lengths).

    The per-row byte length rides little-endian in the LAST four columns;
    0xFFFFFFFF (-1) marks a padding row (featurize/device.py ``pack_staged``)."""
    byts = staged[:, :-4]
    tail = staged[:, -4:].to(torch.int64)
    lengths = (tail[:, 0] | (tail[:, 1] << 8) | (tail[:, 2] << 16)
               | (tail[:, 3] << 24))
    return byts, _to_int32(lengths)


def featurize_bytes(staged: torch.Tensor, stop_table: torch.Tensor, *,
                    spec: FeaturizeSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full device featurize program: (B, W+4) uint8 staging tensor ->
    (packed (B, 2, n_slots) int16, (B,) int32 unique count). A CUDA tensor
    launches the ``featurize_packed`` kernel once (counted in
    ``featurize_bytes.launches``); a CPU tensor runs the plain version."""
    if staged.device.type == "cpu":
        return featurize_bytes_reference(staged, stop_table, spec=spec)
    if staged.device.type != "cuda":
        raise ValueError(
            f"featurize_bytes: unsupported device {staged.device}")
    return _featurize_packed_cuda(staged, stop_table, spec)


featurize_bytes.launches = 0


def featurize_bytes_reference(staged: torch.Tensor, stop_table: torch.Tensor,
                              *, spec: FeaturizeSpec
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of ``featurize_packed``: split, byte classes, the
    scan's plain version, count and pack."""
    byts, lengths = split_staged(staged)
    classes = byte_classes(byts, lengths)
    h, w0, w1, tl, emp = tokenize_hash_reference(classes, legacy=spec.legacy)
    return assemble_packed(h, w0, w1, tl, emp, stop_table, spec=spec)


def _featurize_packed_cuda(staged: torch.Tensor, stop_table: torch.Tensor,
                           spec: FeaturizeSpec):
    if staged.dtype != torch.uint8 or staged.dim() != 2 or staged.shape[1] < 5:
        raise ValueError(f"featurize_packed takes a (B, W+4) uint8 staging "
                         f"tensor, got {tuple(staged.shape)} {staged.dtype}")
    size = stop_table.shape[0] if stop_table.dim() == 2 else 0
    if (stop_table.dtype != torch.int32 or stop_table.dim() != 2
            or stop_table.shape[1] != 3 or size < 1 or size & (size - 1)):
        raise ValueError(f"featurize_packed takes a (2**k, 3) int32 stop "
                         f"table, got {tuple(stop_table.shape)} "
                         f"{stop_table.dtype}")
    if stop_table.device != staged.device:
        raise ValueError("the stop table is not on the staging tensor's "
                         "device")
    if not (staged.is_contiguous() and stop_table.is_contiguous()):
        raise ValueError("featurize_packed takes contiguous tensors")
    if not 1 <= spec.num_features <= np.iinfo(np.int16).max:
        raise ValueError(f"num_features={spec.num_features}: the packed ids "
                         "are int16")
    if spec.n_slots < 1 or not 0 <= spec.empty_bucket < spec.num_features:
        raise ValueError(f"bad spec {spec}")
    rows, width = staged.shape[0], staged.shape[1] - 4
    packed = torch.empty((rows, 2, spec.n_slots), dtype=torch.int16,
                         device=staged.device)
    n_unique = torch.empty((rows,), dtype=torch.int32, device=staged.device)
    if rows == 0:
        return packed, n_unique
    fn = _scan_lib().featurize_packed
    stream = torch.cuda.current_stream(staged.device).cuda_stream
    with device_context(staged.device):
        _check_rc(fn(staged.data_ptr(), stop_table.data_ptr(), size,
                     packed.data_ptr(), n_unique.data_ptr(), rows, width,
                     spec.num_features, spec.n_slots, int(spec.binary),
                     int(spec.legacy), spec.empty_bucket,
                     int(spec.empty_is_stop), stream), "featurize_packed")
    count_launch(featurize_bytes)
    return packed, n_unique


# ---------------------------------------------------------------------------
# kernel self-test
# ---------------------------------------------------------------------------

# Cleaned [a-z ]* rows for the self-test: words straddling the murmur word
# size and the pack width, interior/leading/trailing empty fields, the
# empty row ("" -> [""]), a row of spaces (no tokens), a stop word, and a
# row with more unique buckets than the packed self-test's slots, its
# counts tied at the cut.
_SELF_TEST_TEXTS = ("ab cde fghi", " lead  interior x", "trail   ",
                    "abcdefghijklm n", "", "   ", "stop ab stop  cd",
                    "q r s t u v q r s w q x")
_SELF_TEST_STOP = ("stop",)


def expected_scan(text: str, legacy: bool, cols: int):
    """Host-computed scan outputs for one cleaned ``[a-z ]*`` row: the
    Java-split fields of ``text``, hashed with the Python murmur3 and packed
    with ``pack_token``, emitted at the column that closes each token. A
    hand reckoning independent of both the kernel and its torch version."""
    h = [0] * cols
    w0 = [0] * cols
    w1 = [0] * cols
    tl = [-1] * cols
    hash_fn = murmur3_x86_32_legacy_tail if legacy else murmur3_x86_32
    fields = _java_split(text)
    emp = sum(1 for f in fields if f == "")
    pos = 0
    for field in fields:
        end = pos + len(field)        # the space (or CLS_END) closing it
        if field:
            u = hash_fn(field.encode(), SPARK_HASHING_TF_SEED)
            h[end] = u - (1 << 32) if u >= (1 << 31) else u
            w0[end], w1[end], tl[end] = pack_token(field)
        pos = end + 1
    return h, w0, w1, tl, emp


def _java_split(text: str):
    """Spark's tokens of a cleaned row: Java's split, "" -> [""]."""
    if text == "":
        return [""]
    fields = text.split(" ")
    while fields and fields[-1] == "":
        fields.pop()                  # Java split drops trailing empties
    return fields


def expected_packed(text: str, spec: FeaturizeSpec, stop_words):
    """Host-computed packed (2, n_slots) row and unique count for one
    cleaned row: the Java-split tokens less the stop words, Spark's bucket
    of each, counts per bucket, the top ``n_slots`` counts (ties to the
    lower id) in id order, counts clamped for ``binary``."""
    counts = {}
    for tok in _java_split(text):
        if tok in stop_words:
            continue
        b = spark_hash_bucket(tok, spec.num_features, spec.legacy)
        counts[b] = counts.get(b, 0) + 1
    keep = sorted(sorted(counts), key=lambda b: -counts[b])[: spec.n_slots]
    out = np.zeros((2, spec.n_slots), np.int64)
    for i, b in enumerate(sorted(keep)):
        out[0, i] = b
        out[1, i] = min(counts[b], 1) if spec.binary else counts[b]
    return out, len(counts)


def _self_test_rows(dev):
    """The self-test texts and a padding row, staged at a width 3 past the
    longest."""
    from fraud_detection_tpu_torch.featurize.device import pack_staged

    width = max(len(t) for t in _SELF_TEST_TEXTS) + 3
    staged, _ = pack_staged(list(_SELF_TEST_TEXTS), width,
                            len(_SELF_TEST_TEXTS) + 1)
    return torch.from_numpy(staged).to(dev)


@cache_per_card
def kernel_self_test(device) -> bool:
    """Build the featurize kernel and launch both of its entries on
    ``device`` over tiny inputs whose answers are reckoned on the host
    (``expected_scan``, ``expected_packed``), in both hash modes and with
    ``binary`` off and on; raises on any mismatch. Cached per card."""
    dev = torch.device(device)
    staged = _self_test_rows(dev)
    texts = list(_SELF_TEST_TEXTS) + [None]          # None: a padding row
    classes = byte_classes(*split_staged(staged))
    cols = classes.shape[1]
    for legacy in (False, True):
        got = [x.cpu().numpy() for x in tokenize_hash(classes, legacy=legacy)]
        for r, t in enumerate(texts):
            want = (expected_scan(t, legacy, cols) if t is not None
                    else ([0] * cols, [0] * cols, [0] * cols, [-1] * cols, 0))
            for name, g, w in zip(("h", "w0", "w1", "tok_len"), got[:4],
                                  want[:4]):
                if g[r].tolist() != list(w):
                    raise RuntimeError(
                        f"featurize_scan self-test: {name} of row {t!r} "
                        f"(legacy={legacy}) is {g[r].tolist()}, want {w}")
            if int(got[4][r, 0]) != want[4]:
                raise RuntimeError(
                    f"featurize_scan self-test: empty count of row {t!r} "
                    f"(legacy={legacy}) is {int(got[4][r, 0])}, want {want[4]}")
        for binary in (False, True):
            spec = _self_test_spec(legacy, binary)
            table, _ = build_stop_table(_SELF_TEST_STOP)
            packed, n_unique = featurize_bytes(
                staged, torch.from_numpy(table).to(dev), spec=spec)
            packed, n_unique = packed.cpu().numpy(), n_unique.cpu().numpy()
            for r, t in enumerate(texts):
                want, want_n = ((np.zeros((2, spec.n_slots), np.int64), 0)
                                if t is None else
                                expected_packed(t, spec, _SELF_TEST_STOP))
                if (packed[r].astype(np.int64).tolist() != want.tolist()
                        or int(n_unique[r]) != want_n):
                    raise RuntimeError(
                        f"featurize_packed self-test: row {t!r} (legacy="
                        f"{legacy}, binary={binary}) is {packed[r].tolist()} "
                        f"/ {int(n_unique[r])}, want {want.tolist()} / "
                        f"{want_n}")
    return True


def _self_test_spec(legacy: bool, binary: bool) -> FeaturizeSpec:
    """97 buckets and 5 slots, so the self-test's overflow row overflows."""
    return FeaturizeSpec(num_features=97, n_slots=5, binary=binary,
                         legacy=legacy,
                         empty_bucket=spark_hash_bucket("", 97, legacy),
                         empty_is_stop=False)
