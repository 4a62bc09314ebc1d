// Statistics histogram kernel for Hopper (sm_90a): per (tree, node, feature,
// bin) sums of per-row statistics times a per-tree bootstrap weight, the
// tree trainer's per-level hot op.
//
// Replaces the Pallas TPU kernel `_hist_kernel_multi` reached through
// `node_feature_bin_histogram_multi` in fraud_detection_tpu/ops/histogram.py.
// Same function: bins (N, F) int32 in [0, NB), locals (T, N) int32 (a row
// whose local node is outside [0, n_nodes) is skipped), weights (T, N) f32,
// stats (N, K) f32 -> out (T, L, F, NB, K) f32. `exact` is the gini path:
// each per-row value stats * weight is clipped to [0, 127] and truncated to
// an integer, and the sums are exact int32. Otherwise the sums are f32.
//
// The TPU kernel is a multihot matmul on the MXU. Hopper has no reason to
// build the multihot: this kernel adds each row's statistics straight into
// its bin. What bounds it on this card: bytes. Each (row, feature) bin id is
// read once per tree (4 bytes) for a handful of adds, and the output is
// written once.
//
// Design (simple and deterministic first):
// * A block is one warp and owns 32 consecutive features of one node of one
//   tree, over one chunk of rows. Lane i owns feature f0 + i, so no two
//   threads ever add into the same cell: no atomics, and each cell's sum runs
//   over its rows in ascending order. Two launches give the same bits.
// * The block's accumulators (NB x K cells for each of its 32 features) live
//   in shared memory, laid out [bin][stat][lane] with a row stride of 33
//   words so that both the per-row adds (lanes on consecutive words) and the
//   coalesced write-out (consecutive (bin, stat) of one feature) avoid bank
//   conflicts.
// * The warp walks its row chunk 32 rows at a time: each lane loads one
//   row's node id, weight and statistics (coalesced), a ballot picks the
//   rows of this block's node, and each picked row is broadcast by shuffle
//   while every lane reads its own feature's bin id (one coalesced 128-byte
//   line per row). Up to four picked rows are read before they are added, to
//   keep loads in flight.
// * With several row chunks, each chunk writes a partial histogram and a
//   second kernel adds the partials in chunk order (fixed, so still
//   deterministic). With one chunk the block writes the output directly.
// Products and sums use __fmul_rn / __fadd_rn so that nvcc cannot contract
// them into an FMA: the f32 path then rounds as the plain torch version does
// (stats * weight rounded, then added).

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kStride = 33;   // shared-memory words per (bin, stat) row
constexpr int kMaxStats = 8;
constexpr int kBatch = 4;     // picked rows whose bin ids are read together
constexpr unsigned kFull = 0xFFFFFFFFu;

template <bool kExact>
struct Acc;

template <>
struct Acc<true> {
  using T = int32_t;
  __device__ static T value(float s, float w) {
    // the TPU kernel's clip to [0, 127] and cast (truncation toward zero)
    const float v = fminf(fmaxf(__fmul_rn(s, w), 0.0f), 127.0f);
    return static_cast<T>(__float2int_rz(v));
  }
  __device__ static T add(T a, T b) { return a + b; }
};

template <>
struct Acc<false> {
  using T = float;
  __device__ static T value(float s, float w) { return __fmul_rn(s, w); }
  __device__ static T add(T a, T b) { return __fadd_rn(a, b); }
};

// Grid: x = feature group (32 features) * n_chunks + chunk, y = node,
// z = tree. 32 threads. Dynamic shared memory: NB * K * 33 words.
template <bool kExact>
__global__ void __launch_bounds__(kWarp)
hist_kernel(const int32_t* __restrict__ bins, const int32_t* __restrict__ locals,
            const float* __restrict__ weights, const float* __restrict__ stats,
            float* __restrict__ out, typename Acc<kExact>::T* __restrict__ partial,
            int n, int f, int n_nodes, int nb, int k, int n_chunks,
            int rows_per_chunk) {
  using T = typename Acc<kExact>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);

  const int lane = threadIdx.x;
  const int fgroup = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x % n_chunks;
  const int node = blockIdx.y;
  const int tree = blockIdx.z;
  const int feat = fgroup * kWarp + lane;
  const bool fvalid = feat < f;
  const int cells = nb * k;

  for (int i = lane; i < cells * kStride; i += kWarp) acc[i] = T(0);
  __syncwarp();

  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(n, r_begin + rows_per_chunk);
  const int32_t* loc_t = locals + static_cast<size_t>(tree) * n;
  const float* w_t = weights + static_cast<size_t>(tree) * n;

  for (int r0 = r_begin; r0 < r_end; r0 += kWarp) {
    const int r = r0 + lane;
    const bool in_chunk = r < r_end;
    const int my_local = in_chunk ? __ldg(loc_t + r) : -1;
    unsigned picked = __ballot_sync(kFull, my_local == node);
    if (picked == 0u) continue;
    float my_w = 0.0f;
    float my_s[kMaxStats];
#pragma unroll
    for (int kk = 0; kk < kMaxStats; ++kk) my_s[kk] = 0.0f;
    if (in_chunk && my_local == node) {
      my_w = __ldg(w_t + r);
#pragma unroll
      for (int kk = 0; kk < kMaxStats; ++kk) {
        if (kk < k) my_s[kk] = __ldg(stats + static_cast<size_t>(r) * k + kk);
      }
    }
    while (picked) {
      // up to kBatch picked rows, ascending; the mask is warp-uniform
      int js[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (picked) {
          js[u] = __ffs(picked) - 1;
          picked &= picked - 1u;
        } else {
          js[u] = -1;
        }
      }
      int bs[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        bs[u] = (js[u] >= 0 && fvalid)
                    ? __ldg(bins + static_cast<size_t>(r0 + js[u]) * f + feat)
                    : -1;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (js[u] < 0) break;
        const float w = __shfl_sync(kFull, my_w, js[u]);
        const bool ok = static_cast<unsigned>(bs[u]) < static_cast<unsigned>(nb);
        T* row = acc + (ok ? bs[u] : 0) * k * kStride + lane;
#pragma unroll
        for (int kk = 0; kk < kMaxStats; ++kk) {
          if (kk < k) {
            const float s = __shfl_sync(kFull, my_s[kk], js[u]);
            if (ok) {
              T* cell = row + kk * kStride;
              *cell = Acc<kExact>::add(*cell, Acc<kExact>::value(s, w));
            }
          }
        }
      }
    }
  }
  __syncwarp();

  // Write out this block's (32 features x NB x K) slice; for fixed (tree,
  // node) the (F, NB, K) block is contiguous, so consecutive threads write
  // consecutive words.
  const int nf = min(kWarp, f - fgroup * kWarp);
  const size_t base =
      ((static_cast<size_t>(tree) * n_nodes + node) * f + static_cast<size_t>(fgroup) * kWarp) *
      cells;
  if (n_chunks == 1) {
    for (int i = lane; i < nf * cells; i += kWarp) {
      const int fl = i / cells;
      const int c = i - fl * cells;
      out[base + i] = static_cast<float>(acc[c * kStride + fl]);
    }
  } else {
    const size_t total = static_cast<size_t>(gridDim.z) * n_nodes * f * cells;
    T* dst = partial + static_cast<size_t>(chunk) * total;
    for (int i = lane; i < nf * cells; i += kWarp) {
      const int fl = i / cells;
      const int c = i - fl * cells;
      dst[base + i] = acc[c * kStride + fl];
    }
  }
}

// out[i] = partial[0][i] + partial[1][i] + ... in chunk order.
template <bool kExact>
__global__ void reduce_chunks(const typename Acc<kExact>::T* __restrict__ partial,
                              float* __restrict__ out, size_t total, int n_chunks) {
  using T = typename Acc<kExact>::T;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    T s = partial[i];
    for (int c = 1; c < n_chunks; ++c) s = Acc<kExact>::add(s, partial[c * total + i]);
    out[i] = static_cast<float>(s);
  }
}

template <bool kExact>
int launch(const int32_t* bins, const int32_t* locals, const float* weights,
           const float* stats, float* out, void* partial, int n, int f, int t,
           int n_nodes, int nb, int k, int n_chunks, cudaStream_t s) {
  using T = typename Acc<kExact>::T;
  const size_t smem = static_cast<size_t>(nb) * k * kStride * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_kernel<kExact>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int fgroups = (f + kWarp - 1) / kWarp;
  const int rows_per_chunk = (n + n_chunks - 1) / n_chunks;
  const dim3 grid(fgroups * n_chunks, n_nodes, t);
  hist_kernel<kExact><<<grid, kWarp, smem, s>>>(
      bins, locals, weights, stats, out, static_cast<T*>(partial), n, f, n_nodes,
      nb, k, n_chunks, rows_per_chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_chunks == 1) return static_cast<int>(e);
  const size_t total = static_cast<size_t>(t) * n_nodes * f * nb * k;
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  reduce_chunks<kExact><<<blocks, threads, 0, s>>>(static_cast<const T*>(partial),
                                                  out, total, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). All pointers are device pointers
// to contiguous buffers: bins (n, f) int32, locals (t, n) int32, weights
// (t, n) f32, stats (n, k) f32, out (t, n_nodes, f, nb, k) f32. `partial`
// holds n_chunks * t * n_nodes * f * nb * k int32 (exact) or f32 words when
// n_chunks > 1, and may be null otherwise. k <= 8. Launches on `stream`
// without synchronising and returns the first CUDA error as an int
// (0 = launched).
extern "C" int histogram_launch(const int32_t* bins, const int32_t* locals,
                                const float* weights, const float* stats,
                                float* out, void* partial, int n, int f, int t,
                                int n_nodes, int nb, int k, int n_chunks,
                                int exact, void* stream) {
  if (k < 1 || k > kMaxStats || n_chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (exact) {
    return launch<true>(bins, locals, weights, stats, out, partial, n, f, t,
                        n_nodes, nb, k, n_chunks, s);
  }
  return launch<false>(bins, locals, weights, stats, out, partial, n, f, t,
                       n_nodes, nb, k, n_chunks, s);
}
