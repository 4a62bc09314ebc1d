#!/usr/bin/env python3
"""Where a block of the tree histogram kernel spends its cycles, by phase.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/histogram_spans.py

It copies ``fraud_detection_tpu_torch/ops/csrc/histogram.cu`` into
``build/histogram_spans/`` with ``clock64`` spans added at the phase
boundaries (thread 0 of each block adds its cycles per phase into a global
array), builds it with the port's nvcc flags, runs the kernel's self-test
on it, and launches it once at each shape below on ``chip_smoke.py``'s
inputs: the training CLI's xgb levels at L=1 and 16, its dt level at L=16,
and the bench shape's xgb levels at L=16 and 1 and its forest level. It
prints, per shape, the plan, the device time of the unmodified kernel's
launch (``torch.profiler``), and the cycles per block of each phase with its
share: zeroing the accumulators, the first tile's copies, the wait for a
tile, forming the per-row values, warp 0's row listing and walk (f32 path),
the rest of warp 0's tile (the exact path's atomic walk), the wait for the
other warps at the tile's end, adding the sub-chunk copies, and the
write-out. A phase marker that no longer matches the source stops it.
"""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: (marker in histogram.cu, its replacement). SPAN(k) adds thread 0's cycles
#: since the previous span to slot k; slot 10 counts the blocks.
_SPANS = [
    ("namespace {\n", """__device__ unsigned long long g_spans[11];
#define SPAN(k) if (threadIdx.x == 0) { long long c_ = clock64(); \\
  atomicAdd(&g_spans[k], (unsigned long long)(c_ - c_prev)); c_prev = c_; }
extern "C" int spans_read(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, g_spans, sizeof(g_spans)); }
extern "C" int spans_reset() { unsigned long long z[11] = {0};
  return (int)cudaMemcpyToSymbol(g_spans, z, sizeof(z)); }
namespace {
"""),
    ("  const int tid = threadIdx.x;\n",
     "  const int tid = threadIdx.x;\n  long long c_prev = clock64();\n"),
    ("i += blockDim.x) acc[i] = T(0);\n", "i += blockDim.x) acc[i] = T(0);\n  SPAN(0)\n"),
    ("  if (n_tiles > 0) issue(Stage<Id>(ring, R, tb), r_begin);\n",
     "  if (n_tiles > 0) issue(Stage<Id>(ring, R, tb), r_begin);\n  SPAN(1)\n"),
    ("    __syncthreads();\n    const int rows = min(R, r_end - r0);\n",
     "    __syncthreads();\n    SPAN(2)\n    const int rows = min(R, r_end - r0);\n"),
    ("    __syncthreads();\n    if constexpr (kExact) {",
     "    __syncthreads();\n    SPAN(3)\n    if constexpr (kExact) {"),
    ("        __syncwarp();\n        // walk the list",
     "        __syncwarp();\n        SPAN(8)\n        // walk the list"),
    ("        __syncwarp();   // the list is rewritten",
     "        SPAN(9)\n        __syncwarp();   // the list is rewritten"),
    ("    __syncthreads();   // the next issue overwrites this stage\n",
     "    SPAN(4)\n    __syncthreads();   // the next issue overwrites this stage\n"
     "    SPAN(5)\n"),
    ("  // Write out each pair's", "  SPAN(6)\n  // Write out each pair's"),
    ("\n}\n\n// out[i] = partial[0][i]",
     "\n  SPAN(7)\n  if (threadIdx.x == 0) atomicAdd(&g_spans[10], 1ull);\n}\n\n"
     "// out[i] = partial[0][i]"),
]
PHASES = ["zero", "first copies", "tile wait", "row values", "warp-0 tail",
          "tile-end wait", "copies added", "write-out", "warp-0 listing",
          "warp-0 walk"]


def instrumented_source(src: str) -> str:
    """``histogram.cu`` with the spans added; stops if a marker moved."""
    for marker, new in _SPANS:
        if src.count(marker) != 1:
            raise SystemExit(f"histogram_spans: marker {marker!r} not found once "
                             "in histogram.cu; update _SPANS")
        src = src.replace(marker, new)
    return src


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("histogram_spans: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from fraud_detection_tpu_torch.models import train_trees as tt
    from fraud_detection_tpu_torch.ops import _build
    from fraud_detection_tpu_torch.ops import histogram as H

    out_dir = ROOT / "build" / "histogram_spans"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "histogram_spans.cu"
    src.write_text(instrumented_source(
        (ROOT / "fraud_detection_tpu_torch/ops/csrc/histogram.cu").read_text()))
    lib_path = out_dir / "libhistogram_spans.so"
    built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                            str(lib_path), str(src)], capture_output=True, text=True)
    if built.returncode != 0:
        print(built.stderr[-4000:], file=sys.stderr)
        return 1
    spans = ctypes.CDLL(str(lib_path))
    spans.histogram_launch.argtypes = H.HIST_ARGTYPES
    spans.histogram_launch.restype = ctypes.c_int
    plain_lib = H._hist_lib()

    print(cs.card_line())
    dev = torch.device("cuda")
    xtr, ytr, _, _ = cs.cli_data(dev)
    edges = tt.quantile_bin_edges(xtr, cs.NBINS)
    bc = tt.apply_bins(torch.from_numpy(xtr).to(dev),
                       torch.from_numpy(edges).to(dev)).to(torch.uint8).contiguous()
    yc = torch.from_numpy(ytr).to(dev)
    bb, yb = cs.bench_bins(dev, 21)
    bb = bb.to(torch.uint8).contiguous()
    print(f"bin-0 share of the bins: CLI {float((bc == 0).float().mean()):.4f}, "
          f"bench {float((bb == 0).float().mean()):.4f}")
    n_c, n_b = bc.shape[0], bb.shape[0]
    shapes = {   # name -> (bins, inputs, L, exact); chip_smoke's seeds
        "cli xgb L=1": (bc, cs.level_inputs(n_c, 1, 3, yc, dev, 61, 1), 1, False),
        "cli xgb L=16": (bc, cs.level_inputs(n_c, 1, 3, yc, dev, 76, 16), 16, False),
        "cli dt L=16": (bc, cs.level_inputs(n_c, 1, 2, yc, dev, 76, 16), 16, True),
        "bench xgb L=16": (bb, cs.level_inputs(n_b, 1, 3, yb, dev, 25), 16, False),
        "bench xgb L=1": (bb, cs.level_inputs(n_b, 1, 3, yb, dev, 26, 1), 1, False),
        "bench rf L=16": (bb, cs.level_inputs(n_b, 8, 2, yb, dev, 24), 16, True),
    }
    H._hist_lib = lambda: spans
    H.kernel_self_test.__wrapped__(dev)
    for name, (bins, (loc, w, st), L, exact) in shapes.items():
        kw = dict(n_nodes=L, n_bins=cs.NBINS, exact_int8=exact)

        def call():
            return H.node_feature_bin_histogram_multi(bins, loc, w, st, **kw)

        H._hist_lib = lambda: plain_lib
        ms = cs.kernel_device_ms(call, cs.HIST_KERNELS)
        H._hist_lib = lambda: spans
        call()
        torch.cuda.synchronize()
        spans.spans_reset()
        call()
        torch.cuda.synchronize()
        got = (ctypes.c_ulonglong * 11)()
        spans.spans_read(got)
        blocks = max(got[10], 1)
        total = sum(got[:10])
        plan = H.histogram_plan(*bins.shape, loc.shape[0], L, cs.NBINS,
                                st.shape[1], exact)
        print(f"{name}: {plan}; device {ms * 1e3:.1f} us (uninstrumented); "
              f"{blocks} blocks, {total / blocks:.0f} cycles a block: " + ", ".join(
                  f"{PHASES[i]} {got[i] / blocks:.0f} ({100 * got[i] / max(total, 1):.1f}%)"
                  for i in (0, 1, 2, 3, 8, 9, 4, 5, 6, 7)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
