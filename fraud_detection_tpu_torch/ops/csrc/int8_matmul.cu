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
// What bounds it on this card: at decode (M = 8) bytes, the int8 weight read
// (Gemma-2B's 127 products of a step: 2,506,096,640 bytes, 0.748 ms at
// 3.35 TB/s); at prefill (M = 2,048) operations, 2MNK at 989 TFLOP/s bf16.
//
// Design.
// - One accumulation order per (K, N, layout, dtype), whatever M is.
//   ops/int8_matmul.py `_plan` fixes from those alone the channel tile, the
//   number of K splits S and the k chunk: split s covers k [s L, min(K,
//   (s + 1) L)), L a whole number of chunks. An output is, inside each split,
//   one chain of products in ascending k (k16 wgmma steps, or f32 FMAs), and
//   the S split sums added in order, ((p0 + p1) + p2) + ..., before the
//   reference's rounding points. How the splits are spread is chosen per
//   launch and changes no bit: at small M ("across") each block takes one
//   split and writes its f32 sum into the partials (S, M, N), which a second,
//   ordered pass adds; at large M ("within") each block walks all S splits
//   and adds them in registers in the same order. No atomics: two launches
//   are bit-equal, and a row's output does not depend on M or on the other
//   rows of the launch (the token tile, 8, 32, 128 or 256 rows, is wgmma's
//   instruction N, which does not change an element's value; chip_smoke.py
//   phase 3 holds rows across every boundary). Paged decode stays bit-equal
//   to contiguous, and the suffix prefill to the full prompt's.
// - bf16 is "swap-AB" on wgmma: the weight tile is the A operand (64 output
//   channels x k16 a warpgroup), turned from int8 into bf16 in registers
//   (exact for |q| <= 127, by the 2^23 float trick) in A's register layout;
//   the x tile is B (k16 x tokens) in shared memory, K-major. Tokens are the
//   instruction's N, so a decode step wastes no rows of a 16- or 64-row tile
//   and a prefill converts a weight byte once per 128 or 256 tokens.
// - A block is one or two consumer warpgroups (a 64- or 128-channel tile) and
//   one producer warp. The producer stages int8 weight tiles and x tiles
//   into a ring in shared memory with TMA (128-byte swizzle), each stage
//   completed on an mbarrier with expect_tx. A consumer converts step j's A
//   while step j - 1's wgmma runs, issues step j, then waits until only it
//   is in flight; a stage is released once the wgmma that read it is done.
//   (Issuing a stage's four wgmma behind one fence measured slower: with A
//   in registers the next group's conversion stops overlapping.) Blocks of
//   8 or 32 tokens, and 128-token blocks that hold one split, fit two or
//   three to an SM, so that one block's ring fills while another computes;
//   a 128-token block that adds splits in registers, and a 256-token block
//   (one split only: its accumulators take the registers), runs alone. kn
//   weights whose rows TMA cannot take (N not a multiple of 16: a global
//   stride TMA refuses) are staged by the producer warp with cp.async in the
//   same swizzled layout, completing on the same mbarrier: the same plan and
//   the same order.
// - kn (a stage is 64 k rows x 128 channels): lane (g = lane / 4) of warp w
//   takes channels 16 w + 2 g and 16 w + 2 g + 1 as A's rows g and g + 8, so
//   each k row gives it one 16-bit word. nk (128 channel rows x 128 k): rows g
//   and g + 8 are channels g and g + 8, two 16-bit words a row per k16 step.
//   Both swizzled reads are free of bank conflicts.
// - f32 x takes a SIMT route in the same source: FMAs in ascending k inside a
//   split through double-buffered 32-k tiles in shared memory (the next
//   tile's loads in flight over this one's FMAs), an 8-row (decode) or
//   32-row x 64-channel tile a block, the same plan and the same passes.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kKN = 0;
constexpr int kNK = 1;
constexpr int kRowBytes = 128;   // one swizzled shared-memory row

// A block: one or two consumer warpgroups (64 or 128 channels) and the producer warp. Only a
// 128-token block that keeps split sums beside its chain (168 registers) runs alone on an SM;
// the others leave room for two or three blocks an SM, so that one block's ring fills while
// another computes.
template <int L, int TN, bool SPLIT>
struct Cfg {
  static constexpr bool kAlone = TN == 256 || (TN == 128 && SPLIT);
  static constexpr int kThreads = 2 * 128 + 32;
  static constexpr int kBK = L == kKN ? 64 : 128;                      // k per stage
  // the int8 weight tile: kn, kBK k rows x 128 channels; nk, 128 channel rows x 128 k
  static constexpr int kQBytes = (L == kKN ? kBK : 128) * kRowBytes;
  static constexpr int kXBox = TN * kRowBytes;                         // TN tokens x 64 k
  static constexpr int kXBytes = kBK / 64 * kXBox;
  static constexpr int kStageBytes = kQBytes + kXBytes;
  static constexpr int kBudget = kAlone ? 200 * 1024 : 96 * 1024;
  static constexpr int kStages = kBudget / kStageBytes > 8 ? 8 : kBudget / kStageBytes;
  static constexpr int kBarOffset = kStages * kStageBytes;
  static constexpr int kSmem = kBarOffset + 16 * kStages + 1024;      // barriers, alignment
};

__device__ __forceinline__ float round_bf16(float s) {
  return __bfloat162float(__float2bfloat16_rn(s));
}

// The reference's rounding points on the f32 sum s of a channel with scale sc.
__device__ __forceinline__ __nv_bfloat16 finish_kn_bf16(float s, float sc) {
  return __float2bfloat16_rn(__fmul_rn(round_bf16(s), sc));
}
__device__ __forceinline__ float finish_nk_bf16(float s, float sc) {
  return __fmul_rn(round_bf16(s), sc);
}

// Byte t of a word whose bytes hold q + 128, as the float q: 2^23 + (q + 128)
// built in the bits, minus 2^23 + 128. Exact.
__device__ __forceinline__ float biased_byte(uint32_t biased, int t) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + t)) - 8388736.0f;
}

// Bytes lo and hi of such a word as a bf16 pair (lo in the low half): small
// integers, exact in bf16, so each is its float's high half.
__device__ __forceinline__ uint32_t bf16_pair(uint32_t biased, int lo, int hi) {
  return __byte_perm(__float_as_uint(biased_byte(biased, lo)),
                     __float_as_uint(biased_byte(biased, hi)), 0x7632);
}

__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}

// The barrier's phase also waits for this thread's cp.async copies so far.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

// A (64 channels x k16 of stage step j) for warp `warp` of warpgroup `wg`,
// lane (g, t), from the swizzled int8 weight tile at `qs`.
template <int L>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t qs, int wg, int warp, int g,
                                       int t, int j) {
  if (L == kKN) {
    // rows are k; this lane's two channels are one 16-bit word of 16-byte chunk 4 wg + warp
    const int k0 = 16 * j + 2 * t;
    const uint32_t col = 2 * g, chunk = 4 * wg + warp;
    const auto at = [&](int kr) {
      return qs + kr * kRowBytes + ((chunk ^ (kr & 7)) << 4) + col;
    };
    const uint32_t w01 = __byte_perm(lds_u16(at(k0)), lds_u16(at(k0 + 1)), 0x5410) ^ 0x80808080u;
    const uint32_t w89 =
        __byte_perm(lds_u16(at(k0 + 8)), lds_u16(at(k0 + 9)), 0x5410) ^ 0x80808080u;
    a[0] = bf16_pair(w01, 0, 2);   // channel 2g (row g): k0, k0 + 1
    a[1] = bf16_pair(w01, 1, 3);   // channel 2g + 1 (row g + 8)
    a[2] = bf16_pair(w89, 0, 2);   // k0 + 8, k0 + 9
    a[3] = bf16_pair(w89, 1, 3);
  } else {
    // rows are channels; k16 step j is 16-byte chunk j of the row
    const int r0 = 64 * wg + 16 * warp + g;
    const uint32_t sw = (j ^ g) << 4;   // r0 & 7 == (r0 + 8) & 7 == g
    const uint32_t lo = qs + r0 * kRowBytes + sw + 2 * t, hi = lo + 8 * kRowBytes;
    const uint32_t w0 = __byte_perm(lds_u16(lo), lds_u16(lo + 8), 0x5410) ^ 0x80808080u;
    const uint32_t w1 = __byte_perm(lds_u16(hi), lds_u16(hi + 8), 0x5410) ^ 0x80808080u;
    a[0] = bf16_pair(w0, 0, 1);    // row g: k 2t, 2t + 1
    a[1] = bf16_pair(w1, 0, 1);    // row g + 8
    a[2] = bf16_pair(w0, 2, 3);    // row g: k 2t + 8, 2t + 9
    a[3] = bf16_pair(w1, 2, 3);
  }
}

// Block (token tile x, channel tile y, split z when `across`): channels
// [n0, n0 + tile) x tokens [m0, m0 + TN), k over splits [s_lo, s_hi). SPLIT:
// the block walks more than one split and keeps their running sum beside the
// split's own chain.
template <int L, int TN, bool SPLIT>
__global__ void __launch_bounds__(Cfg<L, TN, SPLIT>::kThreads, Cfg<L, TN, SPLIT>::kAlone ? 1 : 2)
    w8_wgmma(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_q,
             const int8_t* __restrict__ q, const float* __restrict__ scale,
             void* __restrict__ out, float* __restrict__ part, int M, int N, int K, int tile,
             int split_len, int splits, int across, int q_tma) {
  using C = Cfg<L, TN, SPLIT>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_full = base + C::kBarOffset;
  const uint32_t bar_empty = bar_full + 8 * C::kStages;
  const int nwg = tile / 64;
  const int m0 = blockIdx.x * TN, n0 = blockIdx.y * tile;
  const int s_lo = across ? blockIdx.z : 0, s_hi = across ? s_lo + 1 : splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, nwg * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= nwg * 128) {
    // ---- producer warp: lane 0 issues the TMA loads (every lane the cp.async ones) ------------
    const int lane = threadIdx.x & 31;
    int it = 0;
    for (int s = s_lo; s < s_hi; ++s) {
      const int ke = min(K, (s + 1) * split_len);
      for (int k0 = s * split_len; k0 < ke; k0 += C::kBK, ++it) {
        const int st = it % C::kStages;
        const uint32_t stage = base + st * C::kStageBytes, full = bar_full + 8 * st;
        mbar_wait(bar_empty + 8 * st, ((it / C::kStages) & 1) ^ 1);   // round 0 passes at once
        if (!q_tma) {
          for (int p = lane; p < C::kBK * 16; p += 32) {   // kn: 8-byte pieces of kBK k rows
            const int r = p >> 4, c = (p & 15) * 8;
            const int gk = k0 + r, gn = n0 + c;
            const bool ok = gk < K && gn < N;
            cp_async8(stage + r * kRowBytes + (((c >> 4) ^ (r & 7)) << 4) + (c & 8),
                      ok ? q + static_cast<size_t>(gk) * N + gn : q, ok);
          }
          cp_async_arrive(full);
          __syncwarp();
        }
        if (lane == 0) {
          mbar_expect_tx(full, (q_tma ? C::kQBytes : 0) + C::kXBytes);
          if (q_tma) {
            if (L == kKN) tma_load_2d(stage, &tm_q, full, n0, k0);
            else tma_load_2d(stage, &tm_q, full, k0, n0);
          }
          for (int b = 0; b < C::kBK / 64; ++b)
            tma_load_2d(stage + C::kQBytes + b * C::kXBox, &tm_x, full, k0 + 64 * b, m0);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 channels each ------------------------------------------------
  // Per k16 step: convert this step's A (its stage has landed), issue its wgmma, then wait until
  // only it is in flight, so the previous step's A buffer (and, at a stage's first step, the
  // previous stage) is free. Every offset inside a stage is a constant.
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[TN / 2], tot[SPLIT ? TN / 2 : 1];
  uint32_t a[2][4];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (SPLIT ? TN / 2 : 1); ++i) tot[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) a[0][i] = a[1][i] = 0u;

  int it = 0;
  for (int s = s_lo; s < s_hi; ++s) {
    const int ks = s * split_len, ke = min(K, ks + split_len);
    int pending = -1;   // the stage whose last wgmma may still be in flight
    for (int k0 = ks; k0 < ke; k0 += C::kBK, ++it) {
      const int st = it % C::kStages;
      const uint32_t stage = base + st * C::kStageBytes;
      mbar_wait(bar_full + 8 * st, (it / C::kStages) & 1);
      const int steps = min(C::kBK, ke - k0 + 15) / 16;   // the split may end inside the stage
#pragma unroll
      for (int j = 0; j < C::kBK / 16; ++j) {
        if (j < steps) {
          load_a<L>(a[j & 1], stage, wg, warp, g, t, j);
          fence_regs(acc);
          fence_regs(a[j & 1]);
          wgmma_fence();
          const uint32_t xb = stage + C::kQBytes + (j / 4) * C::kXBox + (j % 4) * 32;
          wgmma_rs<TN, 0>(acc, a[j & 1], desc_sw128(xb, 16, 1024), k0 > ks || j > 0);
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(a[(j + 1) & 1]);
          if (j == 0 && pending >= 0) {
            mbar_arrive(bar_empty + 8 * pending);
            pending = -1;
          }
        }
      }
      pending = st;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a);
    mbar_arrive(bar_empty + 8 * pending);
    if constexpr (SPLIT) {
      // ((p0 + p1) + p2) + ...: the second pass's order
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) tot[i] = s == s_lo ? acc[i] : __fadd_rn(tot[i], acc[i]);
    }
  }
  if constexpr (SPLIT) {
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = tot[i];
  }

  // ---- epilogue: acc[4i + e] is row g + 8 (e >> 1), token m0 + 8i + 2t + (e & 1) -------------
  const bool final_out = !across || splits == 1;
  const int row0 = n0 + 64 * wg + 16 * warp;
#pragma unroll
  for (int i = 0; i < TN / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tok = m0 + 8 * i + 2 * t + h;
      if (tok >= M) continue;
      const float v0 = acc[4 * i + h], v1 = acc[4 * i + 2 + h];
      const size_t o = static_cast<size_t>(tok) * N;
      float* pp = final_out ? nullptr : part + static_cast<size_t>(s_lo) * M * N + o;
      if (L == kKN) {
        const int c = row0 + 2 * g;   // rows g, g + 8: channels c, c + 1 (N is even)
        if (c >= N) continue;
        if (!final_out) {
          pp[c] = v0;
          pp[c + 1] = v1;
        } else {
          __nv_bfloat162 y;
          y.x = finish_kn_bf16(v0, scale[c]);
          y.y = finish_kn_bf16(v1, scale[c + 1]);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o + c) = y;
        }
      } else {
        const int c0 = row0 + g, c1 = c0 + 8;
        float* y = static_cast<float*>(out) + o;
        if (c0 < N) {
          if (final_out) y[c0] = finish_nk_bf16(v0, scale[c0]);
          else pp[c0] = v0;
        }
        if (c1 < N) {
          if (final_out) y[c1] = finish_nk_bf16(v1, scale[c1]);
          else pp[c1] = v1;
        }
      }
    }
}

// The ordered second pass: out = finish(((p0 + p1) + p2) + ...) over the partials (S, M, N).
// DT: x's type, 0 f32, 1 bf16.
template <int L, int DT>
__global__ void w8_reduce(const float* __restrict__ part, const float* __restrict__ scale,
                          void* __restrict__ out, int M, int N, int splits) {
  const size_t mn = static_cast<size_t>(M) * N;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < mn;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int j = 1; j < splits; ++j) s = __fadd_rn(s, part[j * mn + i]);
    const float sc = scale[i % N];
    if (DT == 0) static_cast<float*>(out)[i] = __fmul_rn(s, sc);
    else if (L == kKN) static_cast<__nv_bfloat16*>(out)[i] = finish_kn_bf16(s, sc);
    else static_cast<float*>(out)[i] = finish_nk_bf16(s, sc);
  }
}

// f32 x: a TM x 64 output tile per block (TM = 8: 128 threads, one row each; TM = 32: 256
// threads, two rows each), thread (tx, ty) takes channels 4 tx .. 4 tx + 3 (one float4 read of
// the staged tile a k) and rows R ty .. R ty + R - 1. FMAs over k in ascending order inside each
// split through double-buffered 32-k tiles in shared memory (q converted to f32 as it is staged,
// from 32-bit words where the rows allow, else bytes); split sums added in order as above.
constexpr int kSimtBN = 64, kSimtBK = 32;

template <int L, int TM>
__global__ void __launch_bounds__(TM == 8 ? 128 : 256)
    w8_simt(const float* __restrict__ x, const int8_t* __restrict__ q,
            const float* __restrict__ scale, float* __restrict__ out, float* __restrict__ part,
            int M, int N, int K, int split_len, int splits, int across, int words) {
  constexpr int kThreads = TM == 8 ? 128 : 256;
  constexpr int R = TM * 16 / kThreads;                         // rows a thread
  constexpr int XL = TM * kSimtBK / kThreads;                   // x values a thread stages
  constexpr int QL = kSimtBK * kSimtBN / kThreads;              // q bytes a thread stages
  __shared__ float xs[2][TM][kSimtBK + 1];
  __shared__ __align__(16) float qs[2][kSimtBK][kSimtBN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * kSimtBN;
  const int s_lo = across ? blockIdx.z : 0, s_hi = across ? s_lo + 1 : splits;
  float xr[XL], qr[QL];

  // one 32-k tile into registers (zero past the split's end), read along q's contiguous axis;
  // with `words`, four bytes at a time (kn: four channels of a k row; nk: four k of a channel)
  const auto fetch = [&](int k0, int ke) {
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int idx = tid + i * kThreads, r = idx / kSimtBK, c = idx % kSimtBK;
      const int gm = m0 + r, gk = k0 + c;
      xr[i] = gm < M && gk < ke ? x[static_cast<size_t>(gm) * K + gk] : 0.f;
    }
    if (words) {
#pragma unroll
      for (int i = 0; i < QL / 4; ++i) {
        const int w = tid + i * kThreads;
        const int kr = L == kKN ? w / (kSimtBN / 4) : (w % (kSimtBK / 4)) * 4;
        const int nc = L == kKN ? (w % (kSimtBN / 4)) * 4 : w / (kSimtBK / 4);
        const int gk = k0 + kr, gn = n0 + nc;
        uint32_t v = 0;
        if (gk < ke && gn < N)
          v = *reinterpret_cast<const uint32_t*>(
              q + (L == kKN ? static_cast<size_t>(gk) * N + gn : static_cast<size_t>(gn) * K + gk));
#pragma unroll
        for (int b = 0; b < 4; ++b)
          qr[4 * i + b] = static_cast<float>(static_cast<int8_t>(v >> (8 * b)));
      }
    } else {
#pragma unroll
      for (int i = 0; i < QL; ++i) {
        const int idx = tid + i * kThreads;
        const int kr = L == kKN ? idx / kSimtBN : idx % kSimtBK;
        const int nc = L == kKN ? idx % kSimtBN : idx / kSimtBK;
        const int gk = k0 + kr, gn = n0 + nc;
        qr[i] = gk < ke && gn < N
                    ? static_cast<float>(q[L == kKN ? static_cast<size_t>(gk) * N + gn
                                                    : static_cast<size_t>(gn) * K + gk])
                    : 0.f;
      }
    }
  };
  const auto stash = [&](int b) {
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int idx = tid + i * kThreads;
      xs[b][idx / kSimtBK][idx % kSimtBK] = xr[i];
    }
    if (words) {
#pragma unroll
      for (int i = 0; i < QL / 4; ++i) {
        const int w = tid + i * kThreads;
        const int kr = L == kKN ? w / (kSimtBN / 4) : (w % (kSimtBK / 4)) * 4;
        const int nc = L == kKN ? (w % (kSimtBN / 4)) * 4 : w / (kSimtBK / 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (L == kKN) qs[b][kr][nc + e] = qr[4 * i + e];
          else qs[b][kr + e][nc] = qr[4 * i + e];
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < QL; ++i) {
        const int idx = tid + i * kThreads;
        const int kr = L == kKN ? idx / kSimtBN : idx % kSimtBK;
        const int nc = L == kKN ? idx % kSimtBN : idx / kSimtBK;
        qs[b][kr][nc] = qr[i];
      }
    }
  };

  float tot[R][4], acc[R][4];
  for (int s = s_lo; s < s_hi; ++s) {
    const int ks = s * split_len, ke = min(K, ks + split_len);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
    fetch(ks, ke);
    stash(0);
    __syncthreads();
    int b = 0;
    for (int k0 = ks; k0 < ke; k0 += kSimtBK) {
      const bool more = k0 + kSimtBK < ke;
      if (more) fetch(k0 + kSimtBK, ke);
#pragma unroll 8
      for (int kk = 0; kk < kSimtBK; ++kk) {
        const float4 qv = *reinterpret_cast<const float4*>(&qs[b][kk][4 * tx]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float xv = xs[b][ty * R + r][kk];
          acc[r][0] = __fmaf_rn(xv, qv.x, acc[r][0]);
          acc[r][1] = __fmaf_rn(xv, qv.y, acc[r][1]);
          acc[r][2] = __fmaf_rn(xv, qv.z, acc[r][2]);
          acc[r][3] = __fmaf_rn(xv, qv.w, acc[r][3]);
        }
      }
      if (more) stash(b ^ 1);
      __syncthreads();
      b ^= 1;
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tot[r][j] = s == s_lo ? acc[r][j] : __fadd_rn(tot[r][j], acc[r][j]);
  }
  const bool final_out = !across || splits == 1;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty * R + r, gn = n0 + 4 * tx + j;
      if (gm >= M || gn >= N) continue;
      const size_t o = static_cast<size_t>(gm) * N + gn;
      if (final_out) out[o] = __fmul_rn(tot[r][j], scale[gn]);
      else part[static_cast<size_t>(s_lo) * M * N + o] = tot[r][j];
    }
}

// ---- host -----------------------------------------------------------------------------------

// A 2-D map (inner, outer) of a packed tensor, rows of `row_bytes`, box (box_inner, box_outer),
// 128-byte swizzled; out-of-range elements read as zeros.
bool make_map_2d(EncodeTiled enc, CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                 int inner, int outer, size_t row_bytes, int box_inner, int box_outer) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int L, int DT>
int launch_reduce(const float* part, const float* scale, void* out, int m, int n, int splits,
                  cudaStream_t s) {
  const size_t mn = static_cast<size_t>(m) * n;
  const size_t blocks = (mn + 255) / 256;
  w8_reduce<L, DT><<<static_cast<unsigned>(blocks < 1056 ? blocks : 1056), 256, 0, s>>>(
      part, scale, out, m, n, splits);
  return static_cast<int>(cudaGetLastError());
}

template <int L, int TN, bool SPLIT>
int launch_wgmma(const void* x, const void* q, const float* scale, void* out, float* part, int m,
                 int n, int k, int tile, int split_len, int splits, int across, cudaStream_t s) {
  using C = Cfg<L, TN, SPLIT>;
  auto kern = w8_wgmma<L, TN, SPLIT>;
  int card = 0;
  cudaError_t e = current_card(&card);
  if (e != cudaSuccess) return static_cast<int>(e);
  static bool opted_in[kMaxCards] = {};   // per instance and card; setting it twice is harmless
  if (!opted_in[card]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in[card] = true;
  }
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const bool q_tma = L == kNK || n % 16 == 0;
  CUtensorMap tx, tq;
  std::memset(&tq, 0, sizeof tq);
  if (!make_map_2d(enc, &tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, k, m,
                   static_cast<size_t>(k) * 2, 64, TN))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_tma && !(L == kKN ? make_map_2d(enc, &tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, n, k, n, 128,
                                        C::kBK)
                          : make_map_2d(enc, &tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, k, n, k, 128,
                                        128)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + TN - 1) / TN, (n + tile - 1) / tile, across ? splits : 1);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<grid, tile * 2 + 32, C::kSmem, s>>>(tx, tq, static_cast<const int8_t*>(q), scale,
                                                    out, part, m, n, k, tile, split_len, splits,
                                                    across, q_tma ? 1 : 0);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || !across || splits == 1) return rc;
  return launch_reduce<L, 1>(part, scale, out, m, n, splits, s);
}

template <int L, int TM>
int launch_simt(const void* x, const void* q, const float* scale, void* out, float* part, int m,
                int n, int k, int split_len, int splits, int across, cudaStream_t s) {
  const dim3 grid((m + TM - 1) / TM, (n + kSimtBN - 1) / kSimtBN, across ? splits : 1);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // 32-bit words of q where every staged word is whole and aligned: kn rows of a multiple of 4
  // bytes, nk rows likewise (the split length is a multiple of 32)
  const bool words = reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
                     (L == kKN ? n % 4 == 0 : k % 4 == 0 && split_len % 4 == 0);
  w8_simt<L, TM><<<grid, TM == 8 ? 128 : 256, 0, s>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q), scale,
      static_cast<float*>(out), part, m, n, k, split_len, splits, across, words ? 1 : 0);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || !across || splits == 1) return rc;
  return launch_reduce<L, 0>(part, scale, out, m, n, splits, s);
}

template <int L, int TN>
int launch_tokens(const void* x, const void* q, const float* scale, void* out, float* part, int m,
                  int n, int k, int tile, int split_len, int splits, int across, cudaStream_t s) {
  if (!across && splits > 1) {
    if constexpr (TN == 256) {
      return static_cast<int>(cudaErrorInvalidValue);   // no registers for the split sums
    } else {
      return launch_wgmma<L, TN, true>(x, q, scale, out, part, m, n, k, tile, split_len, splits,
                                       across, s);
    }
  }
  return launch_wgmma<L, TN, false>(x, q, scale, out, part, m, n, k, tile, split_len, splits,
                                    across, s);
}

template <int L>
int launch_bf16(const void* x, const void* q, const float* scale, void* out, float* part, int m,
                int n, int k, int tile, int split_len, int splits, int tokens, int across,
                cudaStream_t s) {
  switch (tokens) {
    case 8:
      return launch_tokens<L, 8>(x, q, scale, out, part, m, n, k, tile, split_len, splits,
                                 across, s);
    case 32:
      return launch_tokens<L, 32>(x, q, scale, out, part, m, n, k, tile, split_len, splits,
                                  across, s);
    case 128:
      return launch_tokens<L, 128>(x, q, scale, out, part, m, n, k, tile, split_len, splits,
                                   across, s);
    case 256:
      return launch_tokens<L, 256>(x, q, scale, out, part, m, n, k, tile, split_len, splits,
                                   across, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int L>
int launch_f32(const void* x, const void* q, const float* scale, void* out, float* part, int m,
               int n, int k, int split_len, int splits, int tokens, int across, cudaStream_t s) {
  if (tokens == 8)
    return launch_simt<L, 8>(x, q, scale, out, part, m, n, k, split_len, splits, across, s);
  if (tokens == 32)
    return launch_simt<L, 32>(x, q, scale, out, part, m, n, k, split_len, splits, across, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (m, k) of `dtype` (0 f32, 1 bf16), q int8 (k, n) for layout 0 (kn) or (n, k) for layout 1
// (nk), scale f32 (n,), out (m, n): x's type for kn, f32 for nk. All contiguous. The plan
// (ops/int8_matmul.py `_plan`): `tile` output channels a block (bf16: 64 or 128, nk 128; f32:
// 64), `splits` K splits of `split_len` k (the last takes the rest; bf16: a multiple of 16);
// `tokens` rows a block (bf16: 8, 32, 128, or 256 for a block of one split; f32: 8 or 32);
// `across` puts one split in each block and needs `part`, f32 (splits, m, n), when
// splits > 1. The bf16 route needs k and n
// multiples of 8 for kn, k a multiple of 16 for nk, and x and q 16-byte aligned. Launches on
// `stream` without synchronising; returns a cudaError_t (0 on launches that were accepted).
extern "C" int w8_matmul_launch(const void* x, const void* q, const void* scale, void* out,
                                void* part, int m, int n, int k, int dtype, int layout, int tile,
                                int split_len, int splits, int tokens, int across, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (m < 1 || n < 1 || k < 1 || (dtype != 0 && dtype != 1) || (layout != kKN && layout != kNK) ||
      splits < 1 || split_len < 1 || static_cast<long long>(splits - 1) * split_len >= k ||
      static_cast<long long>(splits) * split_len < k || (across && splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* p = static_cast<float*>(part);
  if (dtype == 0) {
    if (tile != kSimtBN) return static_cast<int>(cudaErrorInvalidValue);
    return layout == kKN ? launch_f32<kKN>(x, q, sc, out, p, m, n, k, split_len, splits, tokens,
                                           across, s)
                         : launch_f32<kNK>(x, q, sc, out, p, m, n, k, split_len, splits, tokens,
                                           across, s);
  }
  const bool shape_ok = layout == kKN ? (k % 8 == 0 && n % 8 == 0) : (k % 16 == 0);
  const bool tile_ok = tile == 128 || (tile == 64 && layout == kKN);
  if (!shape_ok || !tile_ok || split_len % 16 != 0 || !aligned(x) || !aligned(q))
    return static_cast<int>(cudaErrorInvalidValue);
  return layout == kKN ? launch_bf16<kKN>(x, q, sc, out, p, m, n, k, tile, split_len, splits,
                                          tokens, across, s)
                       : launch_bf16<kNK>(x, q, sc, out, p, m, n, k, tile, split_len, splits,
                                          tokens, across, s);
}
