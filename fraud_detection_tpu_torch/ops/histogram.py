"""Tree-training kernels: the per-level statistics histogram and the
split-gain scan — twin of ``fraud_detection_tpu/ops/histogram.py``.

* ``node_feature_bin_histogram_multi`` (T trees sharing one bin matrix) and
  its T=1 wrapper ``node_feature_bin_histogram``: (T, L, F, NB, K) sums of
  per-row statistics times a per-tree bootstrap weight, rows whose local node
  lies outside [0, L) skipped, bin ids outside [0, NB) adding nothing. The
  bins are uint8 (the trainer's, a quarter of the bytes) or int32.
  ``exact_int8`` is the gini contract: every per-row product lies in
  [0, 127] (class one-hots times Poisson weights), is clipped there and
  summed as an exact integer.
* ``best_splits``: per node, the (feature, bin) with the largest gini or xgb
  gain over an inclusive bin prefix, first occurrence in row-major order.

On a CUDA tensor each wrapper launches its hand-written kernel and counts
the launch in ``.launches``; on a CPU tensor it runs the plain torch version
beside it (``histogram_reference``, ``best_splits_reference``). There is no
fallback from one to the other: a kernel that fails to build or launch
raises.

* ``ops/csrc/histogram.cu``: a block owns 32 features x a row chunk x a
  group of (tree, node) pairs, all of a tree's nodes (or several trees)
  where shared memory holds them. ``histogram_plan`` sizes the group from
  the shared memory, the sub-chunks and warps from the group, and the row
  chunks so the launch fills the card about twice; it gives the kernel a
  shared-memory budget, whose rest after the accumulators the kernel fills
  with the deepest row-tile ring that fits. Warps share row tiles staged by
  cp.async. On the f32 path a chunk's rows are dealt round-robin into
  sub-chunks, each (pair, sub-chunk) with its own accumulator copy owned by
  one warp (a small level gets 16 / pairs sub-chunks, so its blocks still
  run 16 warps), and lane f owns feature f: each copy's cell adds its rows
  in ascending order, the copies add in sub-chunk order, the chunk partials
  in chunk order; ``histogram_reference`` adds in that order. On the exact
  path the warps split the rows and add with shared-memory atomics (integer
  sums have no order).
* ``ops/csrc/best_splits.cu``: a warp per (node, 32-feature slab), the slab
  staged coalesced into shared memory and each feature's bins walked in
  order by one lane; the slabs' bests reduce under a total order (larger
  gain, then smaller position), so ``feature_tile`` cannot change the answer.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, replace
from functools import lru_cache
from typing import Tuple

import torch

from fraud_detection_tpu_torch.ops._build import KernelError, count_launch
from fraud_detection_tpu_torch.utils.device import cache_per_card, device_context
from fraud_detection_tpu_torch.utils.logging import get_logger

_log = get_logger("ops.histogram")

#: Both kernels give a lane one feature of a 32-feature slab.
_SLAB = 32
#: The histogram's shared-memory words per (pair, bin, stat) row.
_ACC_STRIDE = 33
_MAX_WARPS = 16
#: Shared memory the plan leaves the histogram's row-tile ring beyond its
#: accumulators. The kernel sizes the ring; at up to 8 trees a block and
#: K <= 8 stats this holds at least 32 rows at either bin width.
_STAGE_RESERVE = 24 * 1024
_MAX_TILE_ROWS = 256
_MAX_TREES_PER_BLOCK = 8
#: H100 SXM: SMs, and the shared memory, threads and blocks one SM holds.
_SMS = 132
_SM_SHARED = 233472
_SM_THREADS = 2048
_SM_BLOCKS = 32
#: Row chunks: enough blocks for this many waves, each chunk at least
#: ``_MIN_ROWS_PER_CHUNK`` rows (a warp walks a chunk's rows in turn).
_WAVES = 2
_MIN_ROWS_PER_CHUNK = 256
#: Exact path, at or below this many rows: a block's fixed phases (zeroing
#: and writing out its accumulators) outweigh its adds, so blocks are sized
#: to fit two on an SM, one's adds overlapping the other's write-out. (On
#: the f32 path a smaller block has fewer warps, which costs more.)
_FEW_ROWS = 8192
_MAX_CHUNKS = 64
_MAX_STATS = 8
#: Shared memory a block may hold on sm_90 (227 KB).
_MAX_SHARED = 232448
#: Plain version: (rows x features) pairs per index_add_ call.
_PLAIN_CHUNK_ELEMS = 1 << 24


def _check_device(name: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs lie on different devices "
                         f"{sorted({str(t.device) for t in tensors})}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# histogram
# ---------------------------------------------------------------------------

def node_feature_bin_histogram(bins: torch.Tensor, local: torch.Tensor,
                               stats: torch.Tensor, *, n_nodes: int,
                               n_bins: int, exact_int8: bool = False
                               ) -> torch.Tensor:
    """(n_nodes, F, n_bins, K) histogram of one tree: the T=1 case of
    ``node_feature_bin_histogram_multi`` with unit weights (exact)."""
    ones = torch.ones((1, local.shape[0]), dtype=torch.float32,
                      device=local.device)
    return node_feature_bin_histogram_multi(
        bins, local[None, :], ones, stats, n_nodes=n_nodes, n_bins=n_bins,
        exact_int8=exact_int8)[0]


def node_feature_bin_histogram_multi(bins: torch.Tensor, locals_: torch.Tensor,
                                     weights: torch.Tensor, stats: torch.Tensor,
                                     *, n_nodes: int, n_bins: int,
                                     exact_int8: bool = False) -> torch.Tensor:
    """(T, n_nodes, F, n_bins, K) f32 histograms for T trees sharing ``bins``.

    bins (N, F) uint8 or int32 bin ids; locals_ (T, N) int32 node positions (outside
    [0, n_nodes) = skip); weights (T, N) f32 bootstrap weights; stats (N, K)
    f32 per-row statistics (weights NOT folded in). ``exact_int8``: the
    caller promises non-negative integer stats x weight products below 128;
    they are clipped to [0, 127] either way, and a violation is logged (the
    JAX kernel prints it)."""
    dev = _check_device("node_feature_bin_histogram_multi", bins, locals_,
                        weights, stats)
    if exact_int8:
        _check_int8_contract(weights, stats)
    if dev.type == "cpu":
        return histogram_reference(bins, locals_, weights, stats,
                                   n_nodes=n_nodes, n_bins=n_bins,
                                   exact_int8=exact_int8)
    return _histogram_cuda(bins, locals_, weights, stats, n_nodes, n_bins,
                           exact_int8)


node_feature_bin_histogram_multi.launches = 0


def _check_int8_contract(weights: torch.Tensor, stats: torch.Tensor) -> None:
    """The exact path is exact only for stats*weight products in [0, 127]:
    the per-row bound max_r(max_k stats[r, k] * max_t w[t, r]) and the
    smallest operand, checked in one host read; a violation is logged (the
    values are clipped to [0, 127] regardless). NaN trips the check."""
    if stats.numel() == 0 or weights.numel() == 0:
        return
    bound = torch.max(stats.float().amax(dim=1) * weights.float().amax(dim=0))
    negative = torch.minimum(stats.min(), weights.min()).float()
    bad = ~(bound <= 127.0) | ~(negative >= 0.0)
    if bool(bad):
        _log.warning(
            "ops.histogram exact_int8 contract violated: per-row stats*weight "
            f"bound {float(bound)}, min operand {float(negative)} — products "
            "are clipped to [0, 127] (use the f32 path for unbounded or signed "
            "stats)")


def histogram_reference(bins: torch.Tensor, locals_: torch.Tensor,
                        weights: torch.Tensor, stats: torch.Tensor, *,
                        n_nodes: int, n_bins: int,
                        exact_int8: bool = False) -> torch.Tensor:
    """Plain torch version: per tree and statistic, a segment sum
    (``index_add_``) over the cell id (l*F + f)*NB + b of every (active row,
    feature) pair, in feature-major order so each feature's cells stay
    cache-resident. Bins may be uint8 or int32. The exact path clips each
    product to [0, 127], truncates it and sums int64 (exact). The f32 path
    adds the f32 products in the CUDA kernel's order — each cell over the
    rows of one sub-chunk (row r of a ``histogram_plan`` row chunk falls in
    sub-chunk r % subs) in ascending order (the kernel's row tiles follow
    one another, and one lane owns the cell), then the sub-chunks in order,
    then the chunk partials in chunk order — which on the CPU (a sequential
    ``index_add_``) makes it bit-equal to the kernel."""
    n, f = bins.shape
    t = locals_.shape[0]
    k = stats.shape[1]
    dev = bins.device
    acc = torch.int64 if exact_int8 else torch.float32
    out = torch.zeros((t, k, n_nodes * f * n_bins), dtype=acc, device=dev)
    if not (n and f and t and n_nodes):
        return out.view(t, k, n_nodes, f, n_bins).permute(0, 2, 3, 4, 1).float()
    plan = (HistogramPlan(1, 1, 1, 1) if exact_int8
             else histogram_plan(n, f, t, n_nodes, n_bins, k))
    chunks, subs = plan.chunks, plan.subs
    per_chunk = -(-n // chunks)
    bins_t = bins.t().to(torch.int64)                        # (F, N)
    bad = (bins_t < 0) | (bins_t >= n_bins)
    any_bad = bool(bad.any())
    cols = torch.arange(f, device=dev)[:, None] * n_bins
    for ti in range(t):
        loc = locals_[ti].to(torch.int64)
        vals = stats.to(torch.float32) * weights[ti].to(torch.float32)[:, None]
        if exact_int8:
            vals = torch.trunc(torch.clamp(vals, 0.0, 127.0)).to(torch.int64)
        for c in range(chunks):
            r0, r1 = c * per_chunk, min(n, (c + 1) * per_chunk)
            part = None
            for sub in range(subs):
                copy = (out[ti] if chunks * subs == 1
                        else torch.zeros_like(out[ti]))
                sl = loc[r0 + sub:r1:subs]
                rows = r0 + sub + subs * torch.nonzero((sl >= 0)
                                                       & (sl < n_nodes))[:, 0]
                r = rows.numel()
                step = max(1, _PLAIN_CHUNK_ELEMS // max(r, 1))
                for f0 in range(0, f if r else 0, step):
                    f1 = min(f, f0 + step)
                    key = ((cols[f0:f1] + bins_t[f0:f1][:, rows])
                           + (loc[rows] * (f * n_bins))[None, :])  # (Fc, R)
                    keep = ((~bad[f0:f1][:, rows]).reshape(-1) if any_bad
                            else None)
                    key = key.reshape(-1)
                    for kk in range(k):
                        src = vals[rows, kk][None, :].expand(f1 - f0, r).reshape(-1)
                        if keep is None:
                            copy[kk].index_add_(0, key, src)
                        else:
                            copy[kk].index_add_(0, key[keep], src[keep])
                part = copy if part is None else part + copy
            if chunks * subs > 1:
                out[ti] = part if c == 0 else out[ti] + part
    return (out.view(t, k, n_nodes, f, n_bins).permute(0, 2, 3, 4, 1)
            .to(torch.float32).contiguous())


@dataclass(frozen=True)
class HistogramPlan:
    """How the CUDA histogram cuts one launch: ``trees`` trees per block,
    or (trees == 1) ``nodes`` of a tree's nodes per block; ``warps`` per
    block; ``chunks`` row chunks of ceil(N / chunks) rows; ``subs``
    round-robin row sub-chunks per chunk, each with its own accumulator
    copies (f32 path; 1 on the exact path)."""

    trees: int
    nodes: int
    warps: int
    chunks: int
    subs: int = 1


def _smem_budget(copies: int, n_bins: int, k: int) -> int:
    """The dynamic shared memory a block gets: ``copies`` accumulators of
    NB x K cells of 32 features (16-byte aligned) and the ring's reserve."""
    return -(-copies * n_bins * k * _ACC_STRIDE * 4 // 16) * 16 + _STAGE_RESERVE


@lru_cache(maxsize=256)
def histogram_plan(n: int, f: int, t: int, n_nodes: int, n_bins: int,
                   k: int, exact: bool = False) -> HistogramPlan:
    """The CUDA histogram's plan for (N, F) bins, T trees, L nodes, NB bins
    and K stats. It does not depend on the bins' dtype, so uint8 and int32
    bins add in the same order.

    A block holds all L nodes of as many trees as its shared memory (less
    the row-tile ring; on the exact path at up to 8,192 rows, half an SM's)
    holds, at most 8; where one tree's nodes do not fit, a run of them.
    Groups are balanced (8 trees in two blocks are 4 + 4). On the f32 path
    a block takes as many sub-chunks as keep its accumulator copies within
    16 and the shared memory, and one warp per copy, at most 16 (so a
    level of 1-8 nodes still runs 16 warps); the exact path, whose warps
    split rows, always has 16 warps and one sub-chunk. Row chunks: enough
    blocks for two waves at the blocks one SM holds, each chunk at least
    256 rows, at most 64 chunks. Raises ValueError when NB x K cells of 32
    features for one pair do not fit."""
    per_pair = n_bins * k * _ACC_STRIDE * 4
    fit = (_MAX_SHARED - _STAGE_RESERVE) // per_pair
    if fit < 1:
        raise ValueError(f"n_bins={n_bins} x K={k} exceeds the histogram "
                         "kernel's shared-memory accumulator")
    if exact and n <= _FEW_ROWS:
        fit = max(1, (_SM_SHARED // 2 - 1024 - _STAGE_RESERVE) // per_pair)
    n_nodes, t = max(n_nodes, 1), max(t, 1)
    if n_nodes <= fit:
        most = min(t, fit // n_nodes, _MAX_TREES_PER_BLOCK)
        trees, nodes = -(-t // -(-t // most)), n_nodes
    else:
        trees, nodes = 1, -(-n_nodes // -(-n_nodes // fit))
    pairs = trees * nodes
    subs = 1 if exact else max(1, min(_MAX_WARPS, fit) // pairs)
    warps = _MAX_WARPS if exact else min(_MAX_WARPS, pairs * subs)
    smem = _smem_budget(pairs * subs, n_bins, k)
    per_sm = max(1, min(_SM_SHARED // (smem + 1024),
                        _SM_THREADS // (32 * warps), _SM_BLOCKS))
    blocks = -(-f // _SLAB) * -(-t // trees) * -(-n_nodes // nodes)
    want = -(-_WAVES * _SMS * per_sm // max(blocks, 1))
    chunks = max(1, min(want, _MAX_CHUNKS, n // _MIN_ROWS_PER_CHUNK))
    return HistogramPlan(trees, nodes, warps, chunks, subs)


#: ``histogram_launch``'s C parameters: bins, id_bytes, locals, weights,
#: stats, out, partial, n, f, t, n_nodes, nb, k, tb, nl, warps, subs,
#: smem_budget, max_tile_rows, n_chunks, exact, stream.
HIST_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                 + [ctypes.c_int] * 14 + [ctypes.c_void_p])


@lru_cache(maxsize=None)
def _hist_lib() -> ctypes.CDLL:
    from fraud_detection_tpu_torch.ops import _build

    lib = _build.load("histogram")
    fn = lib.histogram_launch
    fn.argtypes = HIST_ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def _histogram_launch(bins, locals_, weights, stats, out, n_nodes, n_bins,
                      exact, plan: HistogramPlan,
                      max_tile_rows: int = _MAX_TILE_ROWS) -> None:
    """Launch the CUDA histogram into ``out`` with ``plan`` (and, for the
    self-test, a lower cap on the tile height); raises on a refused
    launch."""
    n, f = bins.shape
    t, k = locals_.shape[0], stats.shape[1]
    copies = plan.trees * plan.nodes * plan.subs
    partial = (torch.empty((plan.chunks * out.numel(),),
                           dtype=torch.int32 if exact else torch.float32,
                           device=bins.device) if plan.chunks > 1 else None)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    with device_context(bins.device):
        rc = _hist_lib().histogram_launch(
            bins.data_ptr(), bins.element_size(), locals_.data_ptr(),
            weights.data_ptr(), stats.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            n, f, t, n_nodes, n_bins, k, plan.trees, plan.nodes, plan.warps,
            plan.subs, _smem_budget(copies, n_bins, k), max_tile_rows,
            plan.chunks, int(exact), stream)
    if rc != 0:
        raise KernelError(f"histogram kernel launch failed: cudaError {rc}")


def _histogram_cuda(bins, locals_, weights, stats, n_nodes, n_bins, exact):
    n, f = bins.shape
    t, k = locals_.shape[0], stats.shape[1]
    if (bins.dtype not in (torch.uint8, torch.int32)
            or locals_.dtype != torch.int32 or weights.dtype != torch.float32
            or stats.dtype != torch.float32):
        raise ValueError(
            "histogram kernel takes uint8 or int32 bins, int32 locals and f32 "
            f"weights/stats, got {bins.dtype}/{locals_.dtype}/{weights.dtype}/"
            f"{stats.dtype}")
    if locals_.shape != (t, n) or weights.shape != (t, n) or stats.shape[0] != n:
        raise ValueError(
            f"histogram shapes: bins {tuple(bins.shape)}, locals "
            f"{tuple(locals_.shape)}, weights {tuple(weights.shape)}, stats "
            f"{tuple(stats.shape)}")
    if not all(x.is_contiguous() for x in (bins, locals_, weights, stats)):
        raise ValueError("histogram kernel takes contiguous tensors")
    if not 1 <= k <= _MAX_STATS:
        raise ValueError(f"histogram kernel takes 1..{_MAX_STATS} stats, got {k}")
    plan = histogram_plan(n, f, t, n_nodes, n_bins, k, exact)
    groups = -(-t // plan.trees) * -(-n_nodes // plan.nodes)
    if plan.chunks > 65535 or groups > 65535:
        raise ValueError(f"histogram kernel grid: n_nodes={n_nodes}, T={t}")
    out = torch.empty((t, n_nodes, f, n_bins, k), dtype=torch.float32,
                      device=bins.device)
    if out.numel() == 0:
        return out
    if n == 0:
        return out.zero_()
    _histogram_launch(bins, locals_, weights, stats, out, n_nodes, n_bins,
                      exact, plan)
    count_launch(node_feature_bin_histogram_multi)
    return out


# ---------------------------------------------------------------------------
# split-gain scan
# ---------------------------------------------------------------------------

def best_splits(hist: torch.Tensor, totals: torch.Tensor, *,
                criterion: str = "gini", n_bins: int = 32,
                reg_lambda: float = 1.0, min_child_weight: float = 1e-6,
                feature_tile: int = 1024
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per node of hist (L, F, NB, K) with totals (L, K): (best_feature,
    best_bin, best_gain), each (L,): the first maximum in row-major
    (feature, bin) order. ``feature_tile`` and ``n_bins`` are accepted for
    the JAX signature (whose kernel tiles features, and whose tile rule
    gives the same first maximum); NB comes from ``hist``, and the CUDA
    kernel's order is total, so no tile can change the answer."""
    dev = _check_device("best_splits", hist, totals)
    if criterion not in ("gini", "xgb"):
        raise ValueError(f"unknown criterion {criterion!r}")
    if hist.dim() != 4 or hist.shape[2] < 2:
        raise ValueError(f"best_splits takes (L, F, NB>=2, K) hist, got "
                         f"{tuple(hist.shape)}")
    if dev.type == "cpu":
        return best_splits_reference(
            hist, totals, criterion=criterion, reg_lambda=reg_lambda,
            min_child_weight=min_child_weight)
    return _best_splits_cuda(hist, totals, criterion, reg_lambda,
                             min_child_weight, feature_tile)


best_splits.launches = 0


def best_splits_reference(hist: torch.Tensor, totals: torch.Tensor, *,
                          criterion: str = "gini", reg_lambda: float = 1.0,
                          min_child_weight: float = 1e-6
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version, in the TPU kernel's formulas and operation
    order. The inclusive bin prefix is a sequential loop over bins (a
    cumsum on the card would add in another order), every step one rounded
    f32 elementwise op, so the gains are bit-equal to the CUDA kernel's.
    The flat first-occurrence argmax equals the kernel's tile rule."""
    L, F, NB, K = hist.shape
    h = hist.to(torch.float32)
    tot = totals.to(torch.float32)
    left = torch.empty_like(h)
    run = torch.zeros((L, F, K), dtype=torch.float32, device=h.device)
    for b in range(NB):
        run = run + h[:, :, b, :]
        left[:, :, b, :] = run
    right = tot[:, None, None, :] - left
    eps = torch.tensor(1e-12, dtype=torch.float32, device=h.device)
    if criterion == "gini":
        def gini_sum(s):
            cnt = s[..., 0]
            sq = s[..., 0] * s[..., 0]
            for kk in range(1, s.shape[-1]):
                cnt = cnt + s[..., kk]
                sq = sq + s[..., kk] * s[..., kk]
            return cnt - sq / torch.maximum(cnt, eps), cnt

        g_l, n_l = gini_sum(left)
        g_r, n_r = gini_sum(right)
        g_p, cnt_p = gini_sum(tot)
        den = torch.maximum(cnt_p, eps)[:, None, None]
        gain = (g_p[:, None, None] - g_l - g_r) / den
        valid = (n_l > 0) & (n_r > 0)
    else:
        lam = torch.tensor(reg_lambda, dtype=torch.float32, device=h.device)
        mcw = torch.tensor(min_child_weight, dtype=torch.float32,
                           device=h.device)

        def score(g, hh):
            return (g * g) / (hh + lam)

        sp = score(tot[:, 0], tot[:, 1])[:, None, None]
        gain = 0.5 * ((score(left[..., 0], left[..., 1])
                       + score(right[..., 0], right[..., 1])) - sp)
        valid = ((left[..., 1] >= mcw) & (right[..., 1] >= mcw)
                 & (left[..., 2] > 0) & (right[..., 2] > 0))
    gain = torch.where(valid, gain, torch.tensor(float("-inf"),
                                                 device=h.device))
    flat = gain[:, :, : NB - 1].reshape(L, -1)
    best = torch.argmax(flat, dim=1)
    best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
    return ((best // (NB - 1)).to(torch.int32),
            (best % (NB - 1)).to(torch.int32), best_gain)


#: ``best_splits_launch``'s C parameters: hist, totals, slab_gain,
#: slab_pos, best_f, best_b, best_gain, L, F, NB, K, xgb, reg_lambda,
#: min_child_weight, stream.
GAIN_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                 + [ctypes.c_float] * 2 + [ctypes.c_void_p])


@lru_cache(maxsize=None)
def _gain_lib() -> ctypes.CDLL:
    from fraud_detection_tpu_torch.ops import _build

    lib = _build.load("best_splits")
    fn = lib.best_splits_launch
    fn.argtypes = GAIN_ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def _best_splits_cuda(hist, totals, criterion, reg_lambda, min_child_weight,
                      feature_tile):
    L, F, NB, K = hist.shape
    if hist.dtype != torch.float32 or totals.dtype != torch.float32:
        raise ValueError("best_splits kernel takes f32 hist and totals")
    if totals.shape != (L, K):
        raise ValueError(f"totals {tuple(totals.shape)} != ({L}, {K})")
    if not (hist.is_contiguous() and totals.is_contiguous()):
        raise ValueError("best_splits kernel takes contiguous tensors")
    if not 1 <= K <= _MAX_STATS or (criterion == "xgb" and K != 3):
        raise ValueError(f"best_splits kernel: K={K} for {criterion}")
    if L > 65535 or F * (NB - 1) >= 2 ** 31 or F == 0 or int(feature_tile) < 1:
        raise ValueError(f"best_splits kernel grid: L={L}, F={F}, NB={NB}, "
                         f"feature_tile={feature_tile}")
    if _SLAB * ((NB * K) | 1) * 4 > _MAX_SHARED:
        raise ValueError(f"best_splits kernel: a slab of NB={NB} x K={K} "
                         "exceeds shared memory")
    n_slabs = -(-F // _SLAB)
    dev = hist.device
    slab_gain = torch.empty((L * n_slabs,), dtype=torch.float32, device=dev)
    slab_pos = torch.empty((L * n_slabs,), dtype=torch.int32, device=dev)
    best_f = torch.empty((L,), dtype=torch.int32, device=dev)
    best_b = torch.empty((L,), dtype=torch.int32, device=dev)
    best_gain = torch.empty((L,), dtype=torch.float32, device=dev)
    if L == 0:
        return best_f, best_b, best_gain
    stream = torch.cuda.current_stream(dev).cuda_stream
    with device_context(dev):
        rc = _gain_lib().best_splits_launch(
            hist.data_ptr(), totals.data_ptr(), slab_gain.data_ptr(),
            slab_pos.data_ptr(), best_f.data_ptr(), best_b.data_ptr(),
            best_gain.data_ptr(), L, F, NB, K, int(criterion == "xgb"),
            float(reg_lambda), float(min_child_weight), stream)
    if rc != 0:
        raise KernelError(f"best_splits kernel launch failed: cudaError {rc}")
    count_launch(best_splits)
    return best_f, best_b, best_gain


# ---------------------------------------------------------------------------
# kernel self-test
# ---------------------------------------------------------------------------

def _expected_histogram(bins, locals_, weights, stats, n_nodes, n_bins, exact):
    """Python-loop reckoning of the histogram (independent of torch)."""
    t_count, k = len(locals_), len(stats[0])
    out = [[[[[0.0] * k for _ in range(n_bins)] for _ in range(len(bins[0]))]
            for _ in range(n_nodes)] for _ in range(t_count)]
    for t in range(t_count):
        for r, row in enumerate(bins):
            node = locals_[t][r]
            if not 0 <= node < n_nodes:
                continue
            for f, b in enumerate(row):
                if not 0 <= b < n_bins:
                    continue
                for kk in range(k):
                    v = stats[r][kk] * weights[t][r]
                    if exact:
                        v = float(int(min(max(v, 0.0), 127.0)))
                    out[t][node][f][b][kk] += v
    return out


#: Self-test launches: (trees, nodes, warps, chunks, subs) plans that split
#: the 3 trees x 3 nodes into node groups (ragged), tree groups (ragged, 6
#: pairs on 4 warps) and row chunks, and (f32 path; the exact path runs them
#: with one sub-chunk) the rows into sub-chunks, a warp a copy or 18 copies
#: on 5 warps; with 32-row tiles, so a chunk spans several and a tile starts
#: mid-cycle of the sub-chunks.
SELF_TEST_PLANS = (HistogramPlan(1, 1, 1, 1), HistogramPlan(1, 2, 2, 3),
                   HistogramPlan(2, 3, 4, 2), HistogramPlan(1, 3, 12, 2, 4),
                   HistogramPlan(2, 3, 5, 1, 3))
SELF_TEST_TILE_ROWS = 32


def self_test_histogram_inputs():
    """The self-test's histogram inputs as Python lists: 70 rows x 48
    features (a full slab and a ragged one), 3 trees, 3 nodes, 4 bins, 2
    stats. Bin ids run over [-1, 4] (-1 and 4 add nothing; the uint8 copy
    maps -1 to 255), node ids over [-1, 3] (-1 and 3 skip), one product
    (200 x 1) clips on the exact path, and every f32 sum is exact."""
    n, f, t, n_nodes, nb = 70, 48, 3, 3, 4
    bins = [[(3 * r + 5 * c + r * c) % (nb + 2) - 1 for c in range(f)]
            for r in range(n)]
    locals_ = [[(r * (ti + 2) + ti) % (n_nodes + 2) - 1 for r in range(n)]
               for ti in range(t)]
    weights = [[float((r + ti) % 4) for r in range(n)] for ti in range(t)]
    weights[1][4] = 200.0
    stats = [[[1.0, 0.0], [0.0, 1.0], [0.5, 0.25]][r % 3] for r in range(n)]
    return bins, locals_, weights, stats, n_nodes, nb


@cache_per_card
def kernel_self_test(device) -> bool:
    """Build both kernels and launch them on ``device`` (a CUDA device) over
    tiny inputs whose answers are reckoned on the host with Python loops:
    the histogram (``self_test_histogram_inputs``) on both paths, with uint8
    and int32 bins, under each of ``SELF_TEST_PLANS`` (one sub-chunk on the
    exact path); and best_splits on a
    gini node with a unique best split, an all-invalid node that must return
    (0, 0, -inf), an xgb node (L=1), and a 40-feature node whose best lies
    in its second slab. Raises on any mismatch; cached per card."""
    dev = torch.device(device)
    bins, locals_, weights, stats, n_nodes, nb = self_test_histogram_inputs()
    n, f, t = len(bins), len(bins[0]), len(locals_)
    b32 = torch.tensor(bins, dtype=torch.int32, device=dev)
    b8 = torch.where(b32 < 0, 255, b32).to(torch.uint8)
    tl = torch.tensor(locals_, dtype=torch.int32, device=dev)
    tw = torch.tensor(weights, dtype=torch.float32, device=dev)
    ts = torch.tensor(stats, dtype=torch.float32, device=dev)
    for exact in (True, False):
        want = torch.tensor(_expected_histogram(bins, locals_, weights, stats,
                                                n_nodes, nb, exact))
        for tb in (b8, b32):
            for plan in SELF_TEST_PLANS:
                if exact:
                    plan = replace(plan, subs=1)
                out = torch.full((t, n_nodes, f, nb, 2), float("nan"),
                                 device=dev)
                _histogram_launch(tb, tl, tw, ts, out, n_nodes, nb, exact,
                                  plan, SELF_TEST_TILE_ROWS)
                torch.cuda.synchronize(dev)
                if not torch.equal(out.cpu(), want):
                    diff = (out.cpu() - want).abs().nan_to_num(1e30)
                    raise RuntimeError(
                        f"histogram self-test failed (exact={exact}, bins "
                        f"{tb.dtype}, {plan}): max |diff| {float(diff.max())}")

    # best_splits: node 0 gini (K=2), unique best at feature 1, bin 1
    gini_hist = torch.zeros((3, 3, 4, 2))
    gini_hist[0, 0] = torch.tensor([[2., 2.], [1., 1.], [1., 1.], [0., 0.]])
    gini_hist[0, 1] = torch.tensor([[3., 0.], [1., 0.], [0., 3.], [0., 1.]])
    gini_hist[0, 2] = torch.tensor([[4., 1.], [0., 3.], [0., 0.], [0., 0.]])
    gini_hist[1, :, 0] = torch.tensor([2., 2.])     # all rows in bin 0: invalid
    gini_tot = torch.tensor([[4., 4.], [2., 2.], [0., 0.]])
    f_, b_, g_ = best_splits(gini_hist.to(dev), gini_tot.to(dev))
    # node 0: the split at (1, 1) sends (4, 0) left and (0, 4) right
    want_gain = (8.0 - 32.0 / 8.0 - 0.0 - 0.0) / 8.0
    got = (f_.cpu().tolist(), b_.cpu().tolist(), g_.cpu().tolist())
    if (got[0] != [1, 0, 0] or got[1] != [1, 0, 0]
            or abs(got[2][0] - want_gain) > 1e-6
            or got[2][1] != float("-inf") or got[2][2] != float("-inf")):
        raise RuntimeError(f"best_splits gini self-test: got {got}")
    # xgb: (grad, hess, count); bin 0 holds the negative gradients
    xh = torch.zeros((1, 2, 3, 3))
    xh[0, 0] = torch.tensor([[-2.0, 1.0, 2.0], [2.0, 1.0, 2.0], [0., 0., 0.]])
    xh[0, 1] = torch.tensor([[-1.0, 1.0, 2.0], [1.0, 1.0, 2.0], [0., 0., 0.]])
    xt = torch.tensor([[0.0, 2.0, 4.0]])
    f_, b_, g_ = best_splits(xh.to(dev), xt.to(dev), criterion="xgb",
                             feature_tile=1)
    want_gain = 0.5 * (4.0 / 2.0 + 4.0 / 2.0 - 0.0)
    if (f_.item(), b_.item()) != (0, 0) or abs(g_.item() - want_gain) > 1e-6:
        raise RuntimeError(f"best_splits xgb self-test: got "
                           f"{(f_.item(), b_.item(), g_.item())}")
    # two slabs: feature 5 splits with gain 0, feature 37 (second slab) 0.5
    wide = torch.zeros((1, 40, 4, 2))
    wide[0, 5, :2] = torch.tensor([[1.0, 1.0], [1.0, 1.0]])
    wide[0, 37, :2] = torch.tensor([[2.0, 0.0], [0.0, 2.0]])
    f_, b_, g_ = best_splits(wide.to(dev), torch.tensor([[2.0, 2.0]]).to(dev))
    if (f_.item(), b_.item(), g_.item()) != (37, 0, 0.5):
        raise RuntimeError(f"best_splits two-slab self-test: got "
                           f"{(f_.item(), b_.item(), g_.item())}")
    return True
