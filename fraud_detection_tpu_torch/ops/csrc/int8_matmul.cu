// Weight-only int8 matrix product for Hopper (sm_90a): W8A16.
//
// No Pallas counterpart. The reference multiplies by an int8 weight in
// `_mm` and in the int8 head of fraud_detection_tpu/models/llm.py (`:271`,
// `:762`, `:793`) and leaves the product to XLA, which fuses the int8 -> dtype
// convert into the dot so that the weight is read from device memory at int8
// width. Eager PyTorch cannot fuse it: `x @ q.to(bf16)` writes a bf16 copy of
// the weight and reads it back, ~3 bytes a weight against plain bf16's 2.
// This kernel keeps the reference's contract by hand.
//
// Function. x (M, K) bf16 or f32; q int8 in one of two layouts; scale f32
// over the N output channels:
//   kn: q (K, N), N contiguous (the layer weights wq/wk/wv/wo/w_gate/w_up/
//       w_down): y (M, N) in x's type, y = round(round(x . q) * scale);
//   nk: q (N, K), K contiguous (the output head): y (M, N) f32,
//       y = f32(round(x . q^T)) * scale,
// where round is to x's type and the dot is an f32 sum, the reference's
// rounding points.
//
// What bounds it on this card: bytes, the int8 weight read. At Gemma-2B's
// widths one decode step reads 2,506,096,640 weight bytes at int8, 0.748 ms
// at 3.35 TB/s, against 1.496 ms for the bf16 weights; x and y are a few KB.
//
// Design (simple and right first; wgmma and TMA are later work). The weight
// never reaches device memory at any width but int8: cp.async stages raw
// int8 tiles (and x tiles) into a ring of shared-memory stages, and each warp
// turns the bytes it needs into bf16 in registers (exact for |q| <= 127, by
// the 2^23 float trick) as the B fragments of `mma.sync` m16n8k16 with f32
// accumulation. A block owns 16-64 rows x 32 G output channels (G = 1, or 4
// for large launches, where one x tile then serves four times the channels)
// and walks K in chunks of 128 with 4 G warps: warp (w, g) takes k [32w,
// 32w + 32) of every chunk for channel group g, and the four k warps'
// partial sums are added in shared memory in order (((p0 + p1) + p2) + p3).
// So an output's sum has one order, fixed by K alone: it does not depend on
// M, on the block's shape (picked from M and N) or on the other rows of the
// launch. No atomics, so two launches are bit-equal, and a row's
// output equals its output in any other launch, which keeps paged decode
// bit-equal to contiguous and the suffix prefill equal to the full prompt's.
// The k order inside an m16n8k16 step is permuted the same way for A and B
// (thread t holds k 4t..4t+3), so each thread reads 4 k of one row of x in
// one 8-byte load and, in the kn layout, 4 channels at one k in one 4-byte
// load; the 4 n8 tiles of the kn layout interleave channels for that reason.
// Row pitches are padded so that these loads are free of bank conflicts.
// f32 x takes a SIMT route in the same source: a 32 x 64 tile per block,
// FMAs in ascending k, the same row independence.

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;              // warps that split each chunk's k
constexpr int kBK = kWarps * 32;       // k per chunk: two k16 steps per warp
constexpr int kGroupN = 32;            // output channels per warp: 4 n8 tiles
constexpr int kXPitch = kBK + 16;      // bf16 per staged x row (288 B)
constexpr int kQPitchNK = kBK + 16;    // bytes per staged q row (n), nk (144 B)
constexpr int kKN = 0;
constexpr int kNK = 1;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Byte t of a word whose bytes hold q + 128, as the float q: 2^23 + (q + 128)
// built in the bits, minus 2^23 + 128. Exact.
__device__ __forceinline__ float biased_byte(uint32_t biased, int t) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + t)) - 8388736.0f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MT, int L, int G>
struct Tile {
  static constexpr int kBM = MT * 16;
  static constexpr int kBN = G * kGroupN;
  static constexpr int kThreads = G * kWarps * 32;
  static constexpr int kQPitchKN = kBN + 8;   // bytes per staged q row (k), kn
  static constexpr int kXBytes = kBM * kXPitch * 2;
  static constexpr int kQBytes = L == kKN ? kBK * kQPitchKN : kBN * kQPitchNK;
  static constexpr int kStageBytes = kXBytes + kQBytes;
};

// Block: rows [m0, m0 + 16 MT) x channels [n0, n0 + 32 G), 4 G warps.
template <int MT, int L, int G, int STAGES>
__global__ void __launch_bounds__(Tile<MT, L, G>::kThreads)
    w8_mma(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ scale, void* __restrict__ out, int M, int N, int K) {
  using T = Tile<MT, L, G>;
  constexpr int BM = T::kBM, kBN = T::kBN, kThreads = T::kThreads;
  constexpr int kQPitchKN = T::kQPitchKN;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) & (kWarps - 1), group = tid >> 7;   // k warp, channel group
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int ng = group * kGroupN;   // the warp's channels in the block
  const int chunks = (K + kBK - 1) / kBK;

  auto load = [&](int stage, int c) {
    unsigned char* base = smem + stage * T::kStageBytes;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base);
    int8_t* qs = reinterpret_cast<int8_t*>(base + T::kXBytes);
    const int k0 = c * kBK;
    for (int i = tid; i < BM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), ch = i % (kBK / 8);
      const int gm = m0 + r, gk = k0 + ch * 8;
      const bool ok = gm < M && gk < K;
      cp_async16(xs + r * kXPitch + ch * 8, ok ? x + static_cast<size_t>(gm) * K + gk : x, ok);
    }
    if (L == kKN) {
      for (int i = tid; i < kBK * (kBN / 8); i += kThreads) {
        const int r = i / (kBN / 8), ch = i % (kBN / 8);
        const int gk = k0 + r, gn = n0 + ch * 8;
        const bool ok = gk < K && gn < N;
        cp_async8(qs + r * kQPitchKN + ch * 8, ok ? q + static_cast<size_t>(gk) * N + gn : q,
                  ok);
      }
    } else {
      for (int i = tid; i < kBN * (kBK / 16); i += kThreads) {
        const int r = i / (kBK / 16), ch = i % (kBK / 16);
        const int gn = n0 + r, gk = k0 + ch * 16;
        const bool ok = gn < N && gk < K;
        cp_async16(qs + r * kQPitchNK + ch * 16, ok ? q + static_cast<size_t>(gn) * K + gk : q,
                   ok);
      }
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // chunk c landed; every warp is done with chunk c - 1
    if (c + STAGES - 1 < chunks) load((c + STAGES - 1) % STAGES, c + STAGES - 1);
    cp_async_commit();
    const unsigned char* base = smem + (c % STAGES) * T::kStageBytes;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(base);
    const int8_t* qs = reinterpret_cast<const int8_t*>(base + T::kXBytes);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = warp * 32 + h * 16;
      // A: thread (gid, tig) holds k kk+4tig..+3 of rows gid and gid+8.
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* r0 = xs + (mt * 16 + gid) * kXPitch + kk + 4 * tig;
        const uint2 lo = *reinterpret_cast<const uint2*>(r0);
        const uint2 hi = *reinterpret_cast<const uint2*>(r0 + 8 * kXPitch);
        a[mt][0] = lo.x;
        a[mt][1] = hi.x;
        a[mt][2] = lo.y;
        a[mt][3] = hi.y;
      }
      // B: the same 4 k for the thread's column gid of each n8 tile.
      uint32_t b[4][2];
      if (L == kKN) {
        // tile t, column j is channel n0 + ng + 4j + t: one word holds 4 tiles
        uint32_t w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          w[r] = *reinterpret_cast<const uint32_t*>(qs + (kk + 4 * tig + r) * kQPitchKN + ng +
                                                    4 * gid) ^
                 0x80808080u;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          b[t][0] = pack_bf16(biased_byte(w[0], t), biased_byte(w[1], t));
          b[t][1] = pack_bf16(biased_byte(w[2], t), biased_byte(w[3], t));
        }
      } else {
        // tile t, column j is channel n0 + ng + 8t + j
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint32_t w =
              *reinterpret_cast<const uint32_t*>(qs + (ng + 8 * t + gid) * kQPitchNK + kk +
                                                 4 * tig) ^
              0x80808080u;
          b[t][0] = pack_bf16(biased_byte(w, 0), biased_byte(w, 1));
          b[t][1] = pack_bf16(biased_byte(w, 2), biased_byte(w, 3));
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int t = 0; t < 4; ++t) mma_bf16(acc[mt][t], a[mt], b[t][0], b[t][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it becomes the warps' partial sums

  float* red = reinterpret_cast<float*>(smem);   // [k warp][BM][kBN]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mt * 16 + gid + (e >= 2 ? 8 : 0);
        const int j = 2 * tig + (e & 1);
        const int col = ng + (L == kKN ? 4 * j + t : 8 * t + j);
        red[(warp * BM + row) * kBN + col] = acc[mt][t][e];
      }
  __syncthreads();
  for (int i = tid; i < BM * kBN; i += kThreads) {
    const int row = i / kBN, col = i % kBN;
    const int gm = m0 + row, gn = n0 + col;
    if (gm >= M || gn >= N) continue;
    float s = red[row * kBN + col];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, red[(w * BM + row) * kBN + col]);
    const float r = __bfloat162float(__float2bfloat16_rn(s));
    const size_t o = static_cast<size_t>(gm) * N + gn;
    if (L == kKN) {
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(__fmul_rn(r, scale[gn]));
    } else {
      static_cast<float*>(out)[o] = __fmul_rn(r, scale[gn]);
    }
  }
}

// f32 x: a 32 x 64 output tile per block of 256 threads, each thread 2 rows x
// 4 channels, FMAs over k in ascending order through 32-k tiles in shared
// memory (q converted to f32 as it is staged).
constexpr int kSimtBM = 32, kSimtBN = 64, kSimtBK = 32, kSimtThreads = 256;

template <int L>
__global__ void __launch_bounds__(kSimtThreads)
    w8_simt(const float* __restrict__ x, const int8_t* __restrict__ q,
            const float* __restrict__ scale, float* __restrict__ out, int M, int N, int K) {
  __shared__ float xs[kSimtBM][kSimtBK + 1];
  __shared__ float qs[kSimtBK][kSimtBN + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kSimtBM, n0 = blockIdx.x * kSimtBN;
  float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
  for (int k0 = 0; k0 < K; k0 += kSimtBK) {
    for (int i = tid; i < kSimtBM * kSimtBK; i += kSimtThreads) {
      const int r = i / kSimtBK, c = i % kSimtBK;
      const int gm = m0 + r, gk = k0 + c;
      xs[r][c] = (gm < M && gk < K) ? x[static_cast<size_t>(gm) * K + gk] : 0.0f;
    }
    for (int i = tid; i < kSimtBK * kSimtBN; i += kSimtThreads) {
      // read along the contiguous axis of q's layout
      const int kr = L == kKN ? i / kSimtBN : i % kSimtBK;
      const int nc = L == kKN ? i % kSimtBN : i / kSimtBK;
      const int gk = k0 + kr, gn = n0 + nc;
      float v = 0.0f;
      if (gk < K && gn < N)
        v = static_cast<float>(q[L == kKN ? static_cast<size_t>(gk) * N + gn
                                          : static_cast<size_t>(gn) * K + gk]);
      qs[kr][nc] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kSimtBK; ++kk) {
      const float x0 = xs[2 * ty][kk], x1 = xs[2 * ty + 1][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float qv = qs[kk][tx + 16 * j];
        acc[0][j] = __fmaf_rn(x0, qv, acc[0][j]);
        acc[1][j] = __fmaf_rn(x1, qv, acc[1][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + 2 * ty + i, gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) out[static_cast<size_t>(gm) * N + gn] = __fmul_rn(acc[i][j], scale[gn]);
    }
}

template <int MT, int L, int G, int STAGES>
int launch_mma(const void* x, const void* q, const float* scale, void* out, int m, int n, int k,
               cudaStream_t s) {
  using T = Tile<MT, L, G>;
  constexpr int smem = STAGES * T::kStageBytes;
  static_assert(smem >= kWarps * T::kBM * T::kBN * 4, "the partial sums must fit in the ring");
  auto kern = w8_mma<MT, L, G, STAGES>;
  static bool opted_in = false;   // per instance; setting it twice is harmless
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid((n + T::kBN - 1) / T::kBN, (m + T::kBM - 1) / T::kBM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<grid, T::kThreads, smem, s>>>(static_cast<const __nv_bfloat16*>(x),
                                    static_cast<const int8_t*>(q), scale, out, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int launch_bf16(const void* x, const void* q, const float* scale, void* out, int m, int n, int k,
                cudaStream_t s) {
  // The block's shape only changes which outputs share a block: an output's
  // sum is the same chain of k16 steps and k-warp partials under every
  // instance. Four channel groups a block (x read a quarter as often) where
  // that still leaves two blocks per SM's worth of blocks.
  if (m <= 16) return launch_mma<1, L, 1, 8>(x, q, scale, out, m, n, k, s);
  if (m <= 32) return launch_mma<2, L, 1, 6>(x, q, scale, out, m, n, k, s);
  const long long wide = static_cast<long long>((n + 127) / 128) * ((m + 63) / 64);
  if (wide >= 264) return launch_mma<4, L, 4, 4>(x, q, scale, out, m, n, k, s);
  return launch_mma<4, L, 1, 4>(x, q, scale, out, m, n, k, s);
}

template <int L>
int launch_f32(const void* x, const void* q, const float* scale, void* out, int m, int n, int k,
               cudaStream_t s) {
  const dim3 grid((n + kSimtBN - 1) / kSimtBN, (m + kSimtBM - 1) / kSimtBM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  w8_simt<L><<<grid, kSimtThreads, 0, s>>>(static_cast<const float*>(x),
                                           static_cast<const int8_t*>(q), scale,
                                           static_cast<float*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (m, k) of `dtype` (0 f32, 1 bf16), q int8 (k, n) for layout 0 (kn) or
// (n, k) for layout 1 (nk), scale f32 (n,), out (m, n): x's type for kn, f32
// for nk. All contiguous. The bf16 route needs k and n multiples of 8 for kn,
// k a multiple of 16 for nk, and x and q 16-byte aligned. Returns a
// cudaError_t (0 on a launch that was accepted).
extern "C" int w8_matmul_launch(const void* x, const void* q, const void* scale, void* out,
                                int m, int n, int k, int dtype, int layout, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (m < 1 || n < 1 || k < 1 || (dtype != 0 && dtype != 1) || (layout != kKN && layout != kNK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0) {
    return layout == kKN ? launch_f32<kKN>(x, q, sc, out, m, n, k, s)
                         : launch_f32<kNK>(x, q, sc, out, m, n, k, s);
  }
  const bool shape_ok = layout == kKN ? (k % 8 == 0 && n % 8 == 0) : (k % 16 == 0);
  if (!shape_ok || !aligned(x) || !aligned(q)) return static_cast<int>(cudaErrorInvalidValue);
  return layout == kKN ? launch_bf16<kKN>(x, q, sc, out, m, n, k, s)
                       : launch_bf16<kNK>(x, q, sc, out, m, n, k, s);
}
