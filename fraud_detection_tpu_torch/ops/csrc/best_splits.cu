// Split-gain scan kernel for Hopper (sm_90a): for every node, the best
// (feature, bin) split of a level's statistics histogram.
//
// Replaces the Pallas TPU kernel `_gain_kernel` reached through `best_splits`
// in fraud_detection_tpu/ops/histogram.py. Same function: hist (L, F, NB, K)
// f32 and node totals (L, K) f32 -> best feature (L,) int32, best bin (L,)
// int32, best gain (L,) f32. Per (node, feature) an inclusive prefix over
// the bins gives the left child's statistics (right = total - left); the
// gain is gini impurity decrease or the xgb second-order gain, in exactly
// `_gain_kernel`'s formulas and operation order; candidates with an empty
// child, a child under `min_child_weight` (xgb) or on the last bin are -inf;
// the winner is the first maximum in row-major (feature, bin) order within a
// feature tile, and the lowest tile among equal tile maxima. A node whose
// candidates are all invalid returns (0, 0, -inf).
//
// What bounds it on this card: bytes (the histogram is read once, ~1 add,
// compare and a few multiplies per element). Design (simple first): a block
// of 128 threads per (feature tile, node); each thread walks its features'
// bins in order, carrying the K prefix sums in registers and its best
// (gain, position); a warp-shuffle and shared-memory reduction with the
// order "larger gain, then smaller position" (a total order, so the result
// does not depend on the reduction's shape) picks the tile's best, and a
// second kernel, one thread per node, takes the first tile holding the
// largest gain. Every float operation is an explicitly rounded intrinsic
// (__fadd_rn, __fmul_rn, __fdiv_rn, ...), so nvcc contracts nothing into an
// FMA and the gains are bit-equal to the plain torch version's.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStats = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Best {
  float gain;
  int pos;
};

// "a beats b": larger gain, then the earlier position.
__device__ __forceinline__ bool beats(float ga, int pa, float gb, int pb) {
  return ga > gb || (ga == gb && pa < pb);
}

// cnt - sq / max(cnt, 1e-12) over the K class counts, in _gain_kernel's
// order; also returns cnt.
__device__ __forceinline__ float gini_sum(const float* s, int k, float* cnt_out) {
  float cnt = s[0];
  float sq = __fmul_rn(s[0], s[0]);
#pragma unroll
  for (int kk = 1; kk < kMaxStats; ++kk) {
    if (kk < k) {
      cnt = __fadd_rn(cnt, s[kk]);
      sq = __fadd_rn(sq, __fmul_rn(s[kk], s[kk]));
    }
  }
  *cnt_out = cnt;
  return __fsub_rn(cnt, __fdiv_rn(sq, fmaxf(cnt, 1e-12f)));
}

__device__ __forceinline__ float score(float g, float h, float lam) {
  return __fdiv_rn(__fmul_rn(g, g), __fadd_rn(h, lam));
}

// Grid: x = feature tile, y = node. Writes each (node, tile)'s best.
__global__ void __launch_bounds__(kThreads)
gain_tiles(const float* __restrict__ hist, const float* __restrict__ totals,
           float* __restrict__ tile_gain, int* __restrict__ tile_pos, int n_f,
           int nb, int k, int ft, int xgb, float lam, float mcw) {
  const int tile = blockIdx.x;
  const int node = blockIdx.y;
  const int n_tiles = gridDim.x;
  const int f_lo = tile * ft;
  const int f_hi = min(n_f, f_lo + ft);

  float tot[kMaxStats];
#pragma unroll
  for (int kk = 0; kk < kMaxStats; ++kk) {
    tot[kk] = kk < k ? totals[static_cast<size_t>(node) * k + kk] : 0.0f;
  }
  // parent terms (per node)
  float cnt_p = 0.0f, g_p = 0.0f, den_p = 1.0f, score_p = 0.0f;
  if (xgb) {
    score_p = score(tot[0], tot[1], lam);
  } else {
    g_p = gini_sum(tot, k, &cnt_p);
    den_p = fmaxf(cnt_p, 1e-12f);
  }

  float best_g = -CUDART_INF_F;
  int best_p = 0x7FFFFFFF;
  for (int f = f_lo + threadIdx.x; f < f_hi; f += kThreads) {
    const float* h = hist + (static_cast<size_t>(node) * n_f + f) * nb * k;
    float left[kMaxStats], right[kMaxStats];
#pragma unroll
    for (int kk = 0; kk < kMaxStats; ++kk) left[kk] = 0.0f;
    for (int b = 0; b < nb - 1; ++b) {   // the last bin has no right side
#pragma unroll
      for (int kk = 0; kk < kMaxStats; ++kk) {
        if (kk < k) {
          left[kk] = __fadd_rn(left[kk], h[b * k + kk]);
          right[kk] = __fsub_rn(tot[kk], left[kk]);
        }
      }
      float gain;
      bool valid;
      if (xgb) {   // stats (grad, hess, count)
        const float s = __fsub_rn(__fadd_rn(score(left[0], left[1], lam),
                                            score(right[0], right[1], lam)),
                                  score_p);
        gain = __fmul_rn(0.5f, s);
        valid = left[1] >= mcw && right[1] >= mcw && left[2] > 0.0f && right[2] > 0.0f;
      } else {
        float n_l, n_r;
        const float g_l = gini_sum(left, k, &n_l);
        const float g_r = gini_sum(right, k, &n_r);
        gain = __fdiv_rn(__fsub_rn(__fsub_rn(g_p, g_l), g_r), den_p);
        valid = n_l > 0.0f && n_r > 0.0f;
      }
      const float g = valid ? gain : -CUDART_INF_F;
      const int pos = f * (nb - 1) + b;
      if (beats(g, pos, best_g, best_p)) {
        best_g = g;
        best_p = pos;
      }
    }
  }

  // block reduction of (gain, pos) under `beats`
  for (int off = 16; off > 0; off >>= 1) {
    const float og = __shfl_down_sync(kFull, best_g, off);
    const int op = __shfl_down_sync(kFull, best_p, off);
    if (beats(og, op, best_g, best_p)) {
      best_g = og;
      best_p = op;
    }
  }
  __shared__ Best warp_best[kThreads / 32];
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) warp_best[warp] = {best_g, best_p};
  __syncthreads();
  if (threadIdx.x == 0) {
    Best b = warp_best[0];
    for (int w = 1; w < kThreads / 32; ++w) {
      if (beats(warp_best[w].gain, warp_best[w].pos, b.gain, b.pos)) b = warp_best[w];
    }
    // an all -inf tile keeps its first candidate, as the TPU kernel does
    if (b.pos == 0x7FFFFFFF) b.pos = f_lo * (nb - 1);
    tile_gain[static_cast<size_t>(node) * n_tiles + tile] = b.gain;
    tile_pos[static_cast<size_t>(node) * n_tiles + tile] = b.pos;
  }
}

// One thread per node: the first tile whose best gain is the largest.
__global__ void reduce_tiles(const float* __restrict__ tile_gain,
                             const int* __restrict__ tile_pos, int* __restrict__ best_f,
                             int* __restrict__ best_b, float* __restrict__ best_gain,
                             int n_nodes, int n_tiles, int nb) {
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n_nodes) return;
  const float* g = tile_gain + static_cast<size_t>(node) * n_tiles;
  const int* p = tile_pos + static_cast<size_t>(node) * n_tiles;
  float bg = g[0];
  int bp = p[0];
  for (int t = 1; t < n_tiles; ++t) {
    if (g[t] > bg) {
      bg = g[t];
      bp = p[t];
    }
  }
  best_f[node] = bp / (nb - 1);
  best_b[node] = bp % (nb - 1);
  best_gain[node] = bg;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Device pointers to contiguous
// buffers: hist (n_nodes, n_f, nb, k) f32, totals (n_nodes, k) f32,
// scratch tile_gain / tile_pos (n_nodes * n_tiles) f32 / int32, outputs
// best_f, best_b (n_nodes,) int32 and best_gain (n_nodes,) f32, with
// n_tiles = ceil(n_f / ft). criterion: 0 gini, 1 xgb (k == 3). Requires
// nb >= 2, 1 <= k <= 8 and n_f * (nb - 1) < 2^31. Launches on `stream`
// without synchronising; returns the first CUDA error as an int.
extern "C" int best_splits_launch(const float* hist, const float* totals,
                                  float* tile_gain, int* tile_pos, int* best_f,
                                  int* best_b, float* best_gain, int n_nodes,
                                  int n_f, int nb, int k, int ft, int criterion,
                                  float reg_lambda, float min_child_weight,
                                  void* stream) {
  if (nb < 2 || k < 1 || k > kMaxStats || ft < 1 || (criterion == 1 && k != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n_f + ft - 1) / ft;
  const dim3 grid(n_tiles, n_nodes);
  gain_tiles<<<grid, kThreads, 0, s>>>(hist, totals, tile_gain, tile_pos, n_f, nb,
                                       k, ft, criterion, reg_lambda, min_child_weight);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_tiles<<<(n_nodes + 127) / 128, 128, 0, s>>>(tile_gain, tile_pos, best_f,
                                                      best_b, best_gain, n_nodes,
                                                      n_tiles, nb);
  return static_cast<int>(cudaGetLastError());
}
