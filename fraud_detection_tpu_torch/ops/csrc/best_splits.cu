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
// the winner is the first maximum in row-major (feature, bin) order. A node
// whose candidates are all invalid returns (0, 0, -inf).
//
// What bounds it on this card: bytes. The histogram is read once (61 MB at
// L=16, F=10,000, NB=32, K=3), with ~20 operations per element.
//
// Design:
// * A block is one warp and owns a slab of 32 consecutive features of one
//   node: grid (ceil(F / 32), L), so a level has L * F / 32 blocks (313 at
//   L=1, F=10,000; 5,008 at L=16), enough to cover every SM at every level.
// * A slab's 32 * NB * K f32 values are contiguous in the histogram. The
//   warp stages them into shared memory with 16-byte loads (four in flight
//   per lane), neighbouring lanes on neighbouring addresses, and stores
//   feature f's values at row f of a table whose row stride is NB * K
//   rounded up to an odd number of words. Lane f then walks its own row:
//   the 32 lanes' reads of one (bin, stat) fall in 32 different banks.
// * Each (node, feature) is still one thread walking bins 0 .. NB-2 in
//   order, carrying the K prefix sums in registers, so the gains are
//   bit-equal to the plain torch version's sequential prefix. Every float
//   operation is an explicitly rounded intrinsic (__fadd_rn, __fmul_rn,
//   __fdiv_rn, ...): nvcc contracts nothing into an FMA.
// * Each warp reduces its slab's best under "larger gain, then smaller flat
//   position" (`beats`, a total order) and writes one (gain, position) per
//   (node, slab). A second kernel, one warp per node, reduces the slabs
//   under the same order. The result does not depend on the slab size or on
//   the reduction's shape.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxStats = 8;
constexpr int kNoPos = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxShared = 232448;   // bytes a block may hold on sm_90

// "a beats b": larger gain, then the earlier position.
__device__ __forceinline__ bool beats(float ga, int pa, float gb, int pb) {
  return ga > gb || (ga == gb && pa < pb);
}

__device__ __forceinline__ void warp_best(float& g, int& p) {
  for (int off = 16; off > 0; off >>= 1) {
    const float og = __shfl_down_sync(kFull, g, off);
    const int op = __shfl_down_sync(kFull, p, off);
    if (beats(og, op, g, p)) {
      g = og;
      p = op;
    }
  }
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

// Row stride (words) of the staged slab: NB * K rounded up to odd.
__host__ __device__ __forceinline__ int slab_stride(int nbk) { return nbk | 1; }

// Element e of the slab held as (feature q = e / nbk, cell r = e % nbk),
// moved forward without a division in the common case.
struct Cursor {
  int q, r;
  __device__ __forceinline__ void advance(int by, int nbk) {
    r += by;
    if (r >= nbk) {
      const int d = r / nbk;
      q += d;
      r -= d * nbk;
    }
  }
};

// Grid: x = slab of 32 features, y = node. One warp. Dynamic shared memory:
// 32 * slab_stride(NB * K) words. Writes each (node, slab)'s best.
__global__ void __launch_bounds__(kWarp)
gain_slabs(const float* __restrict__ hist, const float* __restrict__ totals,
           float* __restrict__ slab_gain, int* __restrict__ slab_pos, int n_f,
           int nb, int k, int xgb, float lam, float mcw) {
  extern __shared__ __align__(16) float slab[];
  const int lane = threadIdx.x;
  const int s_idx = blockIdx.x;
  const int node = blockIdx.y;
  const int n_slabs = gridDim.x;
  const int f0 = s_idx * kWarp;
  const int nf = min(kWarp, n_f - f0);
  const int nbk = nb * k;
  const int stride = slab_stride(nbk);

  // -- stage the slab: 16-byte loads where aligned, scalar head and tail --
  const float* src = hist + (static_cast<size_t>(node) * n_f + f0) * nbk;
  const int count = nf * nbk;
  int head = static_cast<int>((16u - (reinterpret_cast<uintptr_t>(src) & 15u)) & 15u) / 4;
  head = min(head, count);
  for (int e = lane; e < head; e += kWarp) {
    slab[(e / nbk) * stride + e % nbk] = __ldg(src + e);
  }
  const int n4 = (count - head) / 4;
  const float4* src4 = reinterpret_cast<const float4*>(src + head);
  {
    // lane's first element and its (feature, cell); each step moves 32
    // float4 = 128 elements
    const int e0 = head + 4 * lane;
    Cursor c{e0 / nbk, e0 % nbk};
    for (int i = lane; i < n4; i += 4 * kWarp) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i + u * kWarp < n4) v[u] = __ldg(src4 + i + u * kWarp);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i + u * kWarp < n4) {
          Cursor d = c;
          slab[d.q * stride + d.r] = v[u].x;
          d.advance(1, nbk);
          slab[d.q * stride + d.r] = v[u].y;
          d.advance(1, nbk);
          slab[d.q * stride + d.r] = v[u].z;
          d.advance(1, nbk);
          slab[d.q * stride + d.r] = v[u].w;
        }
        c.advance(4 * kWarp, nbk);
      }
    }
  }
  for (int e = head + 4 * n4 + lane; e < count; e += kWarp) {
    slab[(e / nbk) * stride + e % nbk] = __ldg(src + e);
  }

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
  __syncwarp();

  // -- lane f scans feature f0 + f, bins in order --
  float best_g = -CUDART_INF_F;
  int best_p = kNoPos;
  if (lane < nf) {
    const float* h = slab + lane * stride;
    const int f = f0 + lane;
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
  warp_best(best_g, best_p);
  if (lane == 0) {
    slab_gain[static_cast<size_t>(node) * n_slabs + s_idx] = best_g;
    slab_pos[static_cast<size_t>(node) * n_slabs + s_idx] = best_p;
  }
}

// One warp per node: the best of its slabs under the same total order.
__global__ void reduce_slabs(const float* __restrict__ slab_gain,
                             const int* __restrict__ slab_pos, int* __restrict__ best_f,
                             int* __restrict__ best_b, float* __restrict__ best_gain,
                             int n_nodes, int n_slabs, int nb) {
  const int node = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (node >= n_nodes) return;
  const float* g = slab_gain + static_cast<size_t>(node) * n_slabs;
  const int* p = slab_pos + static_cast<size_t>(node) * n_slabs;
  float bg = -CUDART_INF_F;
  int bp = kNoPos;
  for (int s = lane; s < n_slabs; s += kWarp) {
    if (beats(g[s], p[s], bg, bp)) {
      bg = g[s];
      bp = p[s];
    }
  }
  warp_best(bg, bp);
  if (lane == 0) {
    if (bp == kNoPos) bp = 0;   // every gain NaN: the first candidate, as -inf
    best_f[node] = bp / (nb - 1);
    best_b[node] = bp % (nb - 1);
    best_gain[node] = bg;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Device pointers to contiguous
// buffers: hist (n_nodes, n_f, nb, k) f32, totals (n_nodes, k) f32, scratch
// slab_gain / slab_pos (n_nodes * ceil(n_f / 32)) f32 / int32, outputs
// best_f, best_b (n_nodes,) int32 and best_gain (n_nodes,) f32. criterion:
// 0 gini, 1 xgb (k == 3). Requires nb >= 2, 1 <= k <= 8, n_f >= 1,
// n_f * (nb - 1) < 2^31 and 32 * (nb * k | 1) words <= 227 KB of shared
// memory.
// Launches on `stream` without synchronising; returns the first CUDA error
// as an int.
extern "C" int best_splits_launch(const float* hist, const float* totals,
                                  float* slab_gain, int* slab_pos, int* best_f,
                                  int* best_b, float* best_gain, int n_nodes,
                                  int n_f, int nb, int k, int criterion,
                                  float reg_lambda, float min_child_weight,
                                  void* stream) {
  const int smem = kWarp * slab_stride(nb * k) * static_cast<int>(sizeof(float));
  if (nb < 2 || k < 1 || k > kMaxStats || n_f < 1 || (criterion == 1 && k != 3) ||
      smem > kMaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gain_slabs, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_slabs = (n_f + kWarp - 1) / kWarp;
  gain_slabs<<<dim3(n_slabs, n_nodes), kWarp, smem, s>>>(
      hist, totals, slab_gain, slab_pos, n_f, nb, k, criterion, reg_lambda,
      min_child_weight);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int kNodesPerBlock = 4;
  reduce_slabs<<<(n_nodes + kNodesPerBlock - 1) / kNodesPerBlock,
                 kNodesPerBlock * kWarp, 0, s>>>(slab_gain, slab_pos, best_f, best_b,
                                                 best_gain, n_nodes, n_slabs, nb);
  return static_cast<int>(cudaGetLastError());
}
