"""Tree-training kernels: the per-level statistics histogram and the
split-gain scan — twin of ``fraud_detection_tpu/ops/histogram.py``.

* ``node_feature_bin_histogram_multi`` (T trees sharing one bin matrix) and
  its T=1 wrapper ``node_feature_bin_histogram``: (T, L, F, NB, K) sums of
  per-row statistics times a per-tree bootstrap weight, rows whose local node
  lies outside [0, L) skipped. ``exact_int8`` is the gini contract: every
  per-row product lies in [0, 127] (class one-hots times Poisson weights),
  is clipped there and summed as an exact integer.
* ``best_splits``: per node, the (feature, bin) with the largest gini or xgb
  gain over an inclusive bin prefix, first occurrence in row-major order.

On a CUDA tensor each wrapper launches its hand-written kernel
(``ops/csrc/histogram.cu``, ``ops/csrc/best_splits.cu``) and counts the
launch in ``.launches``; on a CPU tensor it runs the plain torch version
beside it (``histogram_reference``, ``best_splits_reference``). There is no
fallback from one to the other: a kernel that fails to build or launch
raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import torch

from fraud_detection_tpu_torch.utils.logging import get_logger

_log = get_logger("ops.histogram")

#: The CUDA histogram kernel's block owns this many features.
_FEATURE_GROUP = 32
#: Row-chunk split target: at least this many blocks per launch.
_TARGET_BLOCKS = 132 * 8
_MIN_ROWS_PER_CHUNK = 1024
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

    bins (N, F) int32 bin ids; locals_ (T, N) int32 node positions (outside
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
    cache-resident. The exact path clips each product to [0, 127], truncates
    it and sums int64 (exact). The f32 path adds the f32 products in the
    CUDA kernel's order — ascending rows within each of the kernel's row
    chunks (``histogram_chunks``), then the chunk partials in chunk order —
    which on the CPU (a sequential ``index_add_``) makes it bit-equal to the
    kernel."""
    n, f = bins.shape
    t = locals_.shape[0]
    k = stats.shape[1]
    dev = bins.device
    acc = torch.int64 if exact_int8 else torch.float32
    out = torch.zeros((t, k, n_nodes * f * n_bins), dtype=acc, device=dev)
    if not (n and f and t and n_nodes):
        return out.view(t, k, n_nodes, f, n_bins).permute(0, 2, 3, 4, 1).float()
    chunks = 1 if exact_int8 else histogram_chunks(n, f, t, n_nodes)
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
            part = out[ti] if chunks == 1 else torch.zeros_like(out[ti])
            rows = r0 + torch.nonzero((loc[r0:r1] >= 0)
                                      & (loc[r0:r1] < n_nodes))[:, 0]
            r = rows.numel()
            step = max(1, _PLAIN_CHUNK_ELEMS // max(r, 1))
            for f0 in range(0, f if r else 0, step):
                f1 = min(f, f0 + step)
                key = ((cols[f0:f1] + bins_t[f0:f1][:, rows])
                       + (loc[rows] * (f * n_bins))[None, :])  # (Fc, R)
                keep = (~bad[f0:f1][:, rows]).reshape(-1) if any_bad else None
                key = key.reshape(-1)
                for kk in range(k):
                    src = vals[rows, kk][None, :].expand(f1 - f0, r).reshape(-1)
                    if keep is None:
                        part[kk].index_add_(0, key, src)
                    else:
                        part[kk].index_add_(0, key[keep], src[keep])
            if chunks > 1:
                out[ti] = part if c == 0 else out[ti] + part
    return (out.view(t, k, n_nodes, f, n_bins).permute(0, 2, 3, 4, 1)
            .to(torch.float32).contiguous())


@lru_cache(maxsize=None)
def _hist_lib() -> ctypes.CDLL:
    from fraud_detection_tpu_torch.ops import _build

    lib = _build.load("histogram")
    fn = lib.histogram_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def histogram_chunks(n: int, f: int, t: int, n_nodes: int) -> int:
    """Row chunks the CUDA histogram splits N into: enough blocks to fill
    the card, each chunk at least ``_MIN_ROWS_PER_CHUNK`` rows."""
    base = -(-f // _FEATURE_GROUP) * n_nodes * t
    want = -(-_TARGET_BLOCKS // max(base, 1))
    return max(1, min(want, _MAX_CHUNKS, n // _MIN_ROWS_PER_CHUNK))


def _histogram_cuda(bins, locals_, weights, stats, n_nodes, n_bins, exact):
    n, f = bins.shape
    t, k = locals_.shape[0], stats.shape[1]
    if (bins.dtype != torch.int32 or locals_.dtype != torch.int32
            or weights.dtype != torch.float32 or stats.dtype != torch.float32):
        raise ValueError(
            "histogram kernel takes int32 bins/locals and f32 weights/stats, "
            f"got {bins.dtype}/{locals_.dtype}/{weights.dtype}/{stats.dtype}")
    if locals_.shape != (t, n) or weights.shape != (t, n) or stats.shape[0] != n:
        raise ValueError(
            f"histogram shapes: bins {tuple(bins.shape)}, locals "
            f"{tuple(locals_.shape)}, weights {tuple(weights.shape)}, stats "
            f"{tuple(stats.shape)}")
    if not all(x.is_contiguous() for x in (bins, locals_, weights, stats)):
        raise ValueError("histogram kernel takes contiguous tensors")
    if not 1 <= k <= _MAX_STATS:
        raise ValueError(f"histogram kernel takes 1..{_MAX_STATS} stats, got {k}")
    if n_bins * k * 33 * 4 > _MAX_SHARED:
        raise ValueError(f"n_bins={n_bins} x K={k} exceeds the kernel's "
                         "shared-memory accumulator")
    if n_nodes > 65535 or t > 65535:
        raise ValueError(f"histogram kernel grid: n_nodes={n_nodes}, T={t}")
    out = torch.empty((t, n_nodes, f, n_bins, k), dtype=torch.float32,
                      device=bins.device)
    if out.numel() == 0:
        return out
    if n == 0:
        return out.zero_()
    chunks = histogram_chunks(n, f, t, n_nodes)
    partial = (torch.empty((chunks * out.numel(),),
                           dtype=torch.int32 if exact else torch.float32,
                           device=bins.device) if chunks > 1 else None)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    rc = _hist_lib().histogram_launch(
        bins.data_ptr(), locals_.data_ptr(), weights.data_ptr(),
        stats.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        n, f, t, n_nodes, n_bins, k, chunks, int(exact), stream)
    if rc != 0:
        raise RuntimeError(f"histogram kernel launch failed: cudaError {rc}")
    node_feature_bin_histogram_multi.launches += 1
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
    best_bin, best_gain), each (L,). Features are scanned in tiles of
    ``feature_tile``; the winner is the first maximum within a tile and the
    lowest tile on ties, i.e. the first maximum in row-major (feature, bin)
    order. ``n_bins`` is accepted for the JAX signature; NB comes from
    ``hist``."""
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


@lru_cache(maxsize=None)
def _gain_lib() -> ctypes.CDLL:
    from fraud_detection_tpu_torch.ops import _build

    lib = _build.load("best_splits")
    fn = lib.best_splits_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
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
    if L > 65535 or F * (NB - 1) >= 2 ** 31 or F == 0:
        raise ValueError(f"best_splits kernel grid: L={L}, F={F}, NB={NB}")
    ft = max(1, min(int(feature_tile), F))
    n_tiles = -(-F // ft)
    dev = hist.device
    tile_gain = torch.empty((L * n_tiles,), dtype=torch.float32, device=dev)
    tile_pos = torch.empty((L * n_tiles,), dtype=torch.int32, device=dev)
    best_f = torch.empty((L,), dtype=torch.int32, device=dev)
    best_b = torch.empty((L,), dtype=torch.int32, device=dev)
    best_gain = torch.empty((L,), dtype=torch.float32, device=dev)
    if L == 0:
        return best_f, best_b, best_gain
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _gain_lib().best_splits_launch(
        hist.data_ptr(), totals.data_ptr(), tile_gain.data_ptr(),
        tile_pos.data_ptr(), best_f.data_ptr(), best_b.data_ptr(),
        best_gain.data_ptr(), L, F, NB, K, ft, int(criterion == "xgb"),
        float(reg_lambda), float(min_child_weight), stream)
    if rc != 0:
        raise RuntimeError(f"best_splits kernel launch failed: cudaError {rc}")
    best_splits.launches += 1
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


@lru_cache(maxsize=None)
def kernel_self_test(device) -> bool:
    """Build both kernels and launch them on ``device`` (a CUDA device) over
    tiny inputs whose answers are reckoned on the host with Python loops:
    the histogram on both paths (a skipped row, an out-of-range node, a
    product above 127 that clips, 40 features so one block is ragged, three
    row chunks forced through the partial-sum pass), and best_splits on a
    gini node with a unique best split, an xgb node, and an all-invalid node
    that must return (0, 0, -inf). Raises on any mismatch; cached per
    device."""
    dev = torch.device(device)
    n, f, nb, n_nodes = 7, 40, 4, 2
    bins = [[(3 * r + 5 * c) % nb for c in range(f)] for r in range(n)]
    locals_ = [[0, 1, 1, 2, 0, -1, 1], [1, 1, 0, 0, 0, 1, 0]]
    weights = [[1.0, 2.0, 0.0, 1.0, 3.0, 1.0, 1.0],
               [2.0, 1.0, 1.0, 1.0, 200.0, 1.0, 0.5]]
    stats = [[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, 1.0], [1.0, 0.0],
             [0.5, 0.25], [0.0, 1.0]]
    tb = torch.tensor(bins, dtype=torch.int32, device=dev)
    tl = torch.tensor(locals_, dtype=torch.int32, device=dev)
    tw = torch.tensor(weights, dtype=torch.float32, device=dev)
    ts = torch.tensor(stats, dtype=torch.float32, device=dev)
    for exact in (True, False):
        want = torch.tensor(_expected_histogram(bins, locals_, weights, stats,
                                                n_nodes, nb, exact))
        for chunks in (1, 3):
            out = torch.empty((2, n_nodes, f, nb, 2), dtype=torch.float32,
                              device=dev)
            part = torch.empty((chunks * out.numel(),), dtype=torch.int32
                               if exact else torch.float32, device=dev)
            rc = _hist_lib().histogram_launch(
                tb.data_ptr(), tl.data_ptr(), tw.data_ptr(), ts.data_ptr(),
                out.data_ptr(), part.data_ptr(), n, f, 2, n_nodes, nb, 2,
                chunks, int(exact), torch.cuda.current_stream(dev).cuda_stream)
            torch.cuda.synchronize(dev)
            if rc != 0 or not torch.equal(out.cpu(), want):
                raise RuntimeError(
                    f"histogram self-test failed (exact={exact}, chunks="
                    f"{chunks}, rc={rc}): max |diff| "
                    f"{float((out.cpu() - want).abs().max())}")

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
    return True
