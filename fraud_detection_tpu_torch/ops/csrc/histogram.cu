// Statistics histogram kernel for Hopper (sm_90a): per (tree, node, feature,
// bin) sums of per-row statistics times a per-tree bootstrap weight, the
// tree trainer's per-level hot op.
//
// Replaces the Pallas TPU kernel `_hist_kernel_multi` reached through
// `node_feature_bin_histogram_multi` in fraud_detection_tpu/ops/histogram.py.
// Same function: bins (N, F) uint8 or int32 (a bin id outside [0, NB) adds
// nothing), locals (T, N) int32 (a row whose local node is outside
// [0, n_nodes) is skipped), weights (T, N) f32, stats (N, K) f32 -> out
// (T, L, F, NB, K) f32. `exact` is the gini path: each per-row value
// stats * weight is clipped to [0, 127] and truncated to an integer, and the
// sums are exact int32. Otherwise the sums are f32.
//
// The TPU kernel is a multihot matmul on the MXU. Here each row's
// statistics are added straight into its bin: the multihot operand is 31/32
// zeros, and the f32 products would not fit int8 or bf16 exactly. What
// bounds it on this card: bytes (the bin ids, read once, and the output),
// and behind them the shared-memory add rate (the adds, and the loads of
// each row's bin ids and values, are shared-memory instructions).
//
// Design:
// * A block owns a slab of 32 consecutive features, one chunk of rows, and
//   a group of (tree, node) pairs: whole trees when a tree's L nodes fit in
//   shared memory (several trees where they fit together), else a run of
//   one tree's nodes. So each row's node id is read once per slab and tree
//   group. The host plans the group (pairs per block), the sub-chunks (see
//   the f32 path) and the row chunks, so the launch fills the card twice
//   over, and gives the block a shared-memory budget; the kernel carves its
//   accumulators from it and fills the rest with the deepest row-tile ring
//   that fits.
// * Its accumulators hold NB x K cells for each of the 32 features of each
//   pair, laid out [pair][bin][stat][feature] with a row stride of 33
//   words: lane f owns feature f0 + f, so the per-row adds of a warp stay in
//   32 banks when the lanes' bins agree, and the coalesced write-out
//   (consecutive (bin, stat) of one feature, 16 bytes a store) is free of
//   bank conflicts.
// * Up to 16 warps share row tiles staged in shared memory by cp.async into
//   a 2-stage ring: the slab's bin ids (32 bytes a row for uint8), the node
//   ids and weights of the group's trees, and the stats. Tile i+1 loads
//   while tile i is added (deeper rings, at the same bytes, measured
//   slower: fewer rows a tile). Each (tree, row)'s K values stats * weight
//   are formed once per tile, for all lanes, and read with one vector load.
// * f32 path: the chunk's rows are dealt round-robin into `subs` sub-chunks
//   (row r of the chunk to sub-chunk r % subs), and each (pair, sub-chunk)
//   has its own copy of the pair's accumulators. Warp w owns the copies
//   q with q % warps == w (one each when a small level gets 16 / pairs
//   sub-chunks, so a tree's root still runs 16 warps), so no two threads
//   ever add into the same cell: no atomics, and each copy's cell sums its
//   rows in ascending order. After the last tile the copies of a pair add
//   in sub-chunk order. Two launches give the same bits. Per tile and copy a
//   warp lists the rows of its node and sub-chunk (ballots, 32 rows at a
//   time) and walks them in order with two rows in flight: the next row's
//   bin id, values and cell are read before this row's sum is written back.
//   Bin 0's cells stay in registers for the tile, so a row in bin 0 (most
//   rows of a zero-inflated TF-IDF column) costs K register adds.
// * Exact (integer) path: sums do not depend on their order, so the warps
//   split the rows (balanced, whatever the nodes' sizes) and each lane adds
//   into its feature's bin with a shared-memory atomic.
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
constexpr int kStride = 33;     // shared-memory words per (pair, bin, stat) row
constexpr int kMaxStats = 8;
constexpr int kMaxWarps = 16;
constexpr int kMaxShared = 232448;   // bytes a block may hold on sm_90
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ __forceinline__ size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// Byte sizes of the accumulators (`copies` of NB x K x 32 cells), of one
// stage of the ring, and of the whole ring (two stages, one tile of
// per-tree row values and each warp's list of its rows).
__host__ __device__ __forceinline__ size_t acc_bytes(int copies, int nbk) {
  return align16(static_cast<size_t>(copies) * nbk * kStride * 4);
}
__host__ __device__ __forceinline__ size_t stage_bytes(int rows, int id_bytes, int tb,
                                                       int k) {
  return static_cast<size_t>(rows) * (kWarp * id_bytes + 8 * tb + 4 * k);
}
// Per-row values are stored K rounded up to 1, 2, 4 or 8 words, so one
// vector load fetches a row's K values.
__host__ __device__ constexpr int padded_stats(int k) {
  return k <= 1 ? 1 : k <= 2 ? 2 : k <= 4 ? 4 : 8;
}
__host__ __device__ __forceinline__ size_t ring_bytes(int rows, int id_bytes, int tb,
                                                      int k) {
  return 2 * stage_bytes(rows, id_bytes, tb, k) +
         static_cast<size_t>(rows) * (tb * padded_stats(k) * 4 + kMaxWarps);
}

template <typename T>
__device__ __forceinline__ T from_bits(int x);
template <>
__device__ __forceinline__ float from_bits<float>(int x) { return __int_as_float(x); }
template <>
__device__ __forceinline__ int32_t from_bits<int32_t>(int x) { return x; }

// A row's K values from a 16-byte-aligned slot of padded_stats(K) words.
template <int K, typename T>
__device__ __forceinline__ void load_vals(const T* src, T (&v)[K]) {
  constexpr int kp = padded_stats(K);
  if constexpr (kp == 1) {
    v[0] = src[0];
  } else if constexpr (kp == 2) {
    const int2 q = *reinterpret_cast<const int2*>(src);
    const T w[2] = {from_bits<T>(q.x), from_bits<T>(q.y)};
#pragma unroll
    for (int kk = 0; kk < K; ++kk) v[kk] = w[kk];
  } else {
#pragma unroll
    for (int h = 0; h < kp / 4; ++h) {
      const int4 q = reinterpret_cast<const int4*>(src)[h];
      const T w[4] = {from_bits<T>(q.x), from_bits<T>(q.y), from_bits<T>(q.z),
                      from_bits<T>(q.w)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * h + e < K) v[4 * h + e] = w[e];
      }
    }
  }
}

// One stage of the ring, carved from shared memory.
template <typename Id>
struct Stage {
  Id* bins;       // [rows][32]
  int32_t* loc;   // [tb][rows]
  float* w;       // [tb][rows]
  float* st;      // [rows][k]
  __device__ Stage(unsigned char* base, int rows, int tb) {
    bins = reinterpret_cast<Id*>(base);
    loc = reinterpret_cast<int32_t*>(base + static_cast<size_t>(rows) * kWarp * sizeof(Id));
    w = reinterpret_cast<float*>(loc + static_cast<size_t>(tb) * rows);
    st = w + static_cast<size_t>(tb) * rows;
  }
};

// Grid: x = feature slab (32 features), y = row chunk, z = pair group
// (tree group * node groups + node group). 32 * warps threads. Dynamic
// shared memory: acc_bytes(pairs * subs) + ring_bytes. K stats (1-8) are a template
// parameter, so the per-row loops carry no predicated-off statistics.
template <bool kExact, typename Id, int K>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
hist_kernel(const Id* __restrict__ bins, const int32_t* __restrict__ locals,
            const float* __restrict__ weights, const float* __restrict__ stats,
            float* __restrict__ out, typename Acc<kExact>::T* __restrict__ partial,
            int n, int f, int t_count, int n_nodes, int nb, int tb, int nl,
            int subs, int rows_per_tile, int rows_per_chunk, int vec) {
  using T = typename Acc<kExact>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int f0 = blockIdx.x * kWarp;
  const int nf = min(kWarp, f - f0);
  const int chunk = blockIdx.y;
  const int node_groups = (n_nodes + nl - 1) / nl;
  const int t0 = (blockIdx.z / node_groups) * tb;
  const int n0 = (blockIdx.z % node_groups) * nl;
  const int pairs = tb * nl;
  const int nbk = nb * K;
  const int R = rows_per_tile;
  const bool vec_bins = vec && nf == kWarp;

  const size_t copy_words = static_cast<size_t>(pairs) * nbk * kStride;
  T* acc = reinterpret_cast<T*>(smem_raw);
  unsigned char* ring = smem_raw + acc_bytes(pairs * subs, nbk);
  const size_t sbytes = stage_bytes(R, sizeof(Id), tb, K);
  constexpr int KP = padded_stats(K);
  T* vals = reinterpret_cast<T*>(ring + 2 * sbytes);   // [tb][rows][KP]
  uint8_t* list = reinterpret_cast<uint8_t*>(vals + static_cast<size_t>(tb) * R * KP) +
                  warp * R;                             // this warp's rows

  for (size_t i = tid; i < copy_words * subs; i += blockDim.x) acc[i] = T(0);

  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(n, r_begin + rows_per_chunk);
  const int n_tiles = r_end > r_begin ? (r_end - r_begin + R - 1) / R : 0;
  // f32 path, kept without divisions in the tile loop: this warp's first
  // copy (pair, sub-chunk), the sub-chunk of the tile's first row (phase),
  // and lane's offset within 32 rows, all modulo subs
  const int q_first = warp;
  const int p_first = q_first % pairs, sub_first = q_first / pairs;
  const int lane_res = lane % subs, step32 = kWarp % subs, step_tile = R % subs;
  int phase = 0;

  // Stage rows [r0, r0 + R) of the chunk: cp.async where the layout allows,
  // plain copies for a ragged slab or an unaligned bin matrix; rows past the
  // chunk and trees past T get node id -1 (skipped).
  auto issue = [&](const Stage<Id>& s, int r0) {
    const int rows = min(R, r_end - r0);
    if (vec_bins) {
      constexpr int kPerRow = kWarp * static_cast<int>(sizeof(Id)) / 16;
      for (int i = tid; i < rows * kPerRow; i += blockDim.x) {
        const int row = i / kPerRow, c = i % kPerRow;
        cp_async16(reinterpret_cast<unsigned char*>(s.bins + row * kWarp) + c * 16,
                   reinterpret_cast<const unsigned char*>(
                       bins + static_cast<size_t>(r0 + row) * f + f0) + c * 16);
      }
    } else {
      for (int i = tid; i < rows * kWarp; i += blockDim.x) {
        const int row = i / kWarp, fl = i % kWarp;
        s.bins[i] = fl < nf ? bins[static_cast<size_t>(r0 + row) * f + f0 + fl] : Id(0);
      }
    }
    for (int i = tid; i < tb * R; i += blockDim.x) {
      const int tl = i / R, j = i % R;
      const int tree = t0 + tl;
      if (j < rows && tree < t_count) {
        const size_t g = static_cast<size_t>(tree) * n + r0 + j;
        cp_async4(s.loc + i, locals + g);
        cp_async4(s.w + i, weights + g);
      } else {
        s.loc[i] = -1;
      }
    }
    for (int i = tid; i < rows * K; i += blockDim.x) {
      cp_async4(s.st + i, stats + static_cast<size_t>(r0) * K + i);
    }
    cp_async_commit();
  };

  if (n_tiles > 0) issue(Stage<Id>(ring, R, tb), r_begin);
  for (int it = 0; it < n_tiles; ++it) {
    const Stage<Id> s(ring + (it & 1) * sbytes, R, tb);
    const int r0 = r_begin + it * R;
    if (it + 1 < n_tiles) {
      issue(Stage<Id>(ring + ((it + 1) & 1) * sbytes, R, tb), r0 + R);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int rows = min(R, r_end - r0);
    // each (tree, row)'s K values stats * weight, once for all lanes
    for (int i = tid; i < tb * R; i += blockDim.x) {
      const int j = i % R;
      if (j < rows) {
        const float w = s.w[i];
#pragma unroll
        for (int kk = 0; kk < K; ++kk) vals[i * KP + kk] = Acc<kExact>::value(s.st[j * K + kk], w);
      }
    }
    __syncthreads();
    if constexpr (kExact) {
      // Integer sums do not depend on their order: the warps split the
      // rows, and each lane adds into its feature's bin with a
      // shared-memory atomic.
      for (int j = warp; j < rows; j += n_warps) {
        const int raw = static_cast<int>(s.bins[j * kWarp + lane]);
        for (int tl = 0; tl < tb; ++tl) {
          const int node = s.loc[tl * R + j] - n0;
          if (static_cast<unsigned>(node) >= static_cast<unsigned>(nl)) continue;
          const int p = tl * nl + node;
          T v[K];
          load_vals<K>(vals + (static_cast<size_t>(tl) * R + j) * KP, v);
          if (lane >= nf || static_cast<unsigned>(raw) >= static_cast<unsigned>(nb)) continue;
          T* cells = acc + (static_cast<size_t>(p) * nbk + raw * K) * kStride + lane;
#pragma unroll
          for (int kk = 0; kk < K; ++kk) atomicAdd(cells + kk * kStride, v[kk]);
        }
      }
    } else {
      // copy q: pair q % pairs over sub-chunk q / pairs (the chunk's rows
      // r with r % subs == q / pairs); p and sub follow q without dividing
      int p = p_first - n_warps, sub = sub_first;
      for (int q = q_first; q < pairs * subs; q += n_warps) {
        for (p += n_warps; p >= pairs; p -= pairs) ++sub;
        const int tl = p / nl;
        const int node = n0 + p - tl * nl;
        if (t0 + tl >= t_count || node >= n_nodes) continue;   // warp-uniform
        T* cells = acc + static_cast<size_t>(q) * nbk * kStride + lane;
        const int32_t* loc = s.loc + tl * R;
        const T* v_t = vals + static_cast<size_t>(tl) * R * KP;
        const bool lane_ok = lane < nf;
        // bin 0's cells live in registers for the tile (zero-inflated bins
        // put most rows there); the others are read, added and written back
        T zero[K];
#pragma unroll
        for (int kk = 0; kk < K; ++kk) zero[kk] = cells[kk * kStride];
        // the node's rows of the tile in this sub-chunk, ascending, into
        // this warp's list
        int count = 0;
        int m = phase + lane_res;   // (row of the chunk) % subs for row j
        if (m >= subs) m -= subs;
        for (int r32 = 0; r32 < rows; r32 += kWarp) {
          const int j = r32 + lane;
          const bool sel = j < rows && loc[j] == node && m == sub;
          const unsigned mask = __ballot_sync(kFull, sel);
          if (sel) list[count + __popc(mask & ((1u << lane) - 1u))] = static_cast<uint8_t>(j);
          count += __popc(mask);
          m += step32;
          if (m >= subs) m -= subs;
        }
        __syncwarp();
        // walk the list with two rows in flight: the next row's bin id,
        // values and cell are read before this row's sum is written back (a
        // next row in the same cell takes this row's sum instead)
        auto fetch = [&](int i, int& b, T (&v)[K], T (&c)[K]) {
          const int jj = list[i];
          const int raw = static_cast<int>(s.bins[jj * kWarp + lane]);
          b = lane_ok && static_cast<unsigned>(raw) < static_cast<unsigned>(nb) ? raw : -1;
          load_vals<K>(v_t + jj * KP, v);
          if (b > 0) {
#pragma unroll
            for (int kk = 0; kk < K; ++kk) c[kk] = cells[(b * K + kk) * kStride];
          }
        };
        if (count > 0) {
          int b0;
          T v0[K], c0[K];
          fetch(0, b0, v0, c0);
          for (int i = 1; i <= count; ++i) {
            int b1 = -1;
            T v1[K], c1[K];
            if (i < count) fetch(i, b1, v1, c1);
            if (b0 == 0) {
#pragma unroll
              for (int kk = 0; kk < K; ++kk) zero[kk] = Acc<kExact>::add(zero[kk], v0[kk]);
            } else if (b0 > 0) {
#pragma unroll
              for (int kk = 0; kk < K; ++kk) {
                const T sum = Acc<kExact>::add(c0[kk], v0[kk]);
                cells[(b0 * K + kk) * kStride] = sum;
                if (b1 == b0) c1[kk] = sum;
              }
            }
            b0 = b1;
#pragma unroll
            for (int kk = 0; kk < K; ++kk) {
              v0[kk] = v1[kk];
              c0[kk] = c1[kk];
            }
          }
        }
        __syncwarp();   // the list is rewritten for the warp's next copy
#pragma unroll
        for (int kk = 0; kk < K; ++kk) cells[kk * kStride] = zero[kk];
      }
    }
    __syncthreads();   // the next issue overwrites this stage
    phase += step_tile;
    if (phase >= subs) phase -= subs;
  }
  __syncthreads();
  if (subs > 1) {   // each pair's copies, added in sub-chunk order into copy 0
    for (size_t i = tid; i < copy_words; i += blockDim.x) {
      T v = acc[i];
      for (int q = 1; q < subs; ++q) v = Acc<kExact>::add(v, acc[q * copy_words + i]);
      acc[i] = v;
    }
    __syncthreads();
  }

  // Write out each pair's (32 features x NB x K) slice; for fixed (tree,
  // node) the (F, NB, K) block is contiguous, so consecutive threads write
  // consecutive words.
  const size_t total = static_cast<size_t>(t_count) * n_nodes * f * nbk;
  for (int p = 0; p < pairs; ++p) {
    const int tree = t0 + p / nl;
    const int node = n0 + p % nl;
    if (tree >= t_count || node >= n_nodes) continue;
    const T* cells = acc + static_cast<size_t>(p) * nbk * kStride;
    const size_t base =
        ((static_cast<size_t>(tree) * n_nodes + node) * f + f0) * nbk;
    if (nbk % 4 == 0) {   // four cells of one feature per 16-byte store
      for (int i = 4 * tid; i < nf * nbk; i += 4 * blockDim.x) {
        const int fl = i / nbk;
        const int c = i - fl * nbk;
        const T* src = cells + c * kStride + fl;
        if (partial == nullptr) {
          *reinterpret_cast<float4*>(out + base + i) =
              make_float4(static_cast<float>(src[0]), static_cast<float>(src[kStride]),
                          static_cast<float>(src[2 * kStride]),
                          static_cast<float>(src[3 * kStride]));
        } else {
          T* dst = partial + static_cast<size_t>(chunk) * total + base + i;
          dst[0] = src[0];
          dst[1] = src[kStride];
          dst[2] = src[2 * kStride];
          dst[3] = src[3 * kStride];
        }
      }
    } else {
      for (int i = tid; i < nf * nbk; i += blockDim.x) {
        const int fl = i / nbk;
        const int c = i - fl * nbk;
        const T v = cells[c * kStride + fl];
        if (partial == nullptr) {
          out[base + i] = static_cast<float>(v);
        } else {
          partial[static_cast<size_t>(chunk) * total + base + i] = v;
        }
      }
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

template <bool kExact, typename Id, int K>
int launch(const void* bins, const int32_t* locals, const float* weights,
           const float* stats, float* out, void* partial, int n, int f, int t, int n_nodes,
           int nb, int tb, int nl, int warps, int subs, int smem_budget, int max_tile_rows,
           int n_chunks, cudaStream_t s) {
  using T = typename Acc<kExact>::T;
  // the accumulators first; the rest of the budget holds the deepest ring
  // (a multiple of 32 rows, at most max_tile_rows) that fits
  const size_t acc = acc_bytes(tb * nl * subs, nb * K);
  const size_t per_row = ring_bytes(1, sizeof(Id), tb, K);
  if (smem_budget <= 0 || smem_budget > kMaxShared ||
      acc + kWarp * per_row > static_cast<size_t>(smem_budget)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t fit = (smem_budget - acc) / per_row / kWarp * kWarp;
  const int rows_per_tile = static_cast<int>(fit < static_cast<size_t>(max_tile_rows)
                                                 ? fit : max_tile_rows);
  const size_t smem = acc + ring_bytes(rows_per_tile, sizeof(Id), tb, K);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(hist_kernel<kExact, Id, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int slabs = (f + kWarp - 1) / kWarp;
  const int groups = ((t + tb - 1) / tb) * ((n_nodes + nl - 1) / nl);
  if (n_chunks > 65535 || groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_chunk = (n + n_chunks - 1) / n_chunks;
  const int vec = (reinterpret_cast<uintptr_t>(bins) % 16 == 0) &&
                  (static_cast<size_t>(f) * sizeof(Id)) % 16 == 0;
  hist_kernel<kExact, Id, K><<<dim3(slabs, n_chunks, groups), warps * kWarp, smem, s>>>(
      static_cast<const Id*>(bins), locals, weights, stats, out,
      n_chunks > 1 ? static_cast<T*>(partial) : nullptr, n, f, t, n_nodes, nb, tb, nl, subs,
      rows_per_tile, rows_per_chunk, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_chunks == 1) return static_cast<int>(e);
  const size_t total = static_cast<size_t>(t) * n_nodes * f * nb * K;
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  reduce_chunks<kExact><<<blocks, threads, 0, s>>>(static_cast<const T*>(partial), out,
                                                  total, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <bool kExact, typename Id>
int launch_k(int k, const void* bins, const int32_t* locals, const float* weights,
             const float* stats, float* out, void* partial, int n, int f, int t,
             int n_nodes, int nb, int tb, int nl, int warps, int subs, int smem_budget,
             int max_tile_rows, int n_chunks, cudaStream_t s) {
#define HIST_K(KK)                                                                     \
  case KK:                                                                             \
    return launch<kExact, Id, KK>(bins, locals, weights, stats, out, partial, n, f, t, \
                                  n_nodes, nb, tb, nl, warps, subs, smem_budget,       \
                                  max_tile_rows, n_chunks, s);
  switch (k) {
    HIST_K(1) HIST_K(2) HIST_K(3) HIST_K(4) HIST_K(5) HIST_K(6) HIST_K(7) HIST_K(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HIST_K
}

}  // namespace

// Plain C entry point (loaded with ctypes). All pointers are device pointers
// to contiguous buffers: bins (n, f) of id_bytes 1 (uint8) or 4 (int32),
// locals (t, n) int32, weights (t, n) f32, stats (n, k) f32, out
// (t, n_nodes, f, nb, k) f32. The plan: tb trees per block, or (tb == 1) nl
// of a tree's nodes per block (tb > 1 requires nl == n_nodes); warps (1-16)
// per block; subs row sub-chunks per chunk, each with its own accumulator
// copies (f32 path; 1 on the exact path); n_chunks row chunks of
// ceil(n / n_chunks) rows. smem_budget: the dynamic shared memory the block
// may take; after the accumulators it holds the row-tile ring at the most
// rows that fit, a multiple of 32 and at most max_tile_rows (<= 256: a warp
// lists a tile's rows as bytes); a budget that leaves no room for 32 rows is
// refused. `partial` holds n_chunks * t * n_nodes * f * nb * k int32 (exact)
// or f32 words when n_chunks > 1, and may be null otherwise. 1 <= k <= 8.
// Launches on `stream` without synchronising and returns the first CUDA
// error as an int (0 = launched).
extern "C" int histogram_launch(const void* bins, int id_bytes, const int32_t* locals,
                                const float* weights, const float* stats, float* out,
                                void* partial, int n, int f, int t, int n_nodes, int nb,
                                int k, int tb, int nl, int warps, int subs, int smem_budget,
                                int max_tile_rows, int n_chunks, int exact, void* stream) {
  if (k < 1 || k > kMaxStats || n_chunks < 1 || tb < 1 || nl < 1 || warps < 1 ||
      warps > kMaxWarps || subs < 1 || (exact && subs != 1) || max_tile_rows < kWarp ||
      max_tile_rows > 256 || (tb > 1 && nl != n_nodes) || (id_bytes != 1 && id_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HIST_ARGS                                                                          \
  k, bins, locals, weights, stats, out, partial, n, f, t, n_nodes, nb, tb, nl, warps, subs, \
      smem_budget, max_tile_rows, n_chunks, s
  if (id_bytes == 1) {
    return exact ? launch_k<true, uint8_t>(HIST_ARGS) : launch_k<false, uint8_t>(HIST_ARGS);
  }
  return exact ? launch_k<true, int32_t>(HIST_ARGS) : launch_k<false, int32_t>(HIST_ARGS);
#undef HIST_ARGS
}
