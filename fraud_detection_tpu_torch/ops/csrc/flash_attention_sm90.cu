// Causal flash-attention forward for Hopper (sm_90a): bf16 on the tensor cores.
//
// Replaces the Pallas TPU kernel `_flash_kernel` (fraud_detection_tpu/ops/attention.py:33,
// reached through `flash_attention` at :75) for bfloat16 q/k/v at head dim d in {64, 128, 256}.
// Same function: q (B, T, H, d), k/v (B, T, Hkv, d) with H % Hkv == 0 -> out (B, T, H, d),
// out[t] = softmax_{s <= t}(q[t] . k[s] / sqrt(d)) . v. Query head h reads K/V head
// h / (H / Hkv) at its native width; nothing is expanded. Every other dtype and head dim
// runs flash_attention.cu.
//
// Rounding points of the TPU kernel, kept: the q.k dot is an f32 sum of bf16 products (the
// tensor cores' f32 accumulator), multiplied by `scale` in f32; masked scores are -1e30, so
// their exp underflows to exactly 0; the running max m, normalizer l and output accumulator
// are f32, and l sums the unrounded f32 p; p is rounded to bf16 only as the p.v operand; acc / l
// is rounded to bf16 once. exp(x) is computed as ex2.approx(x * log2(e)) (the scale is not
// folded into it). Each thread keeps a partial l for its share of a row's keys; the four
// partials are summed once at the end. Sums run in another order than on the TPU (f32
// round-off), but in one fixed order: no atomics, no split over keys, so two launches are
// bit-equal, and the key tiles do not depend on the head grouping, so native-width K/V give bit
// for bit what expanded K/V give.
//
// What bounds it on this card: operations. At the main path's shape (T 2048, H 8, d 256, one
// K/V head) the causal half of q.k and p.v is 4 (T^2/2) H d = 17.2 GFLOP, ~17 us at the
// 989 TFLOP/s bf16 tensor-core rate, against ~19 MB of q, k, v and out (~6 us at 3.35 TB/s).
//
// Design:
// - Both products on the tensor cores with `wgmma.mma_async`: S = Q.K^T with Q and K from
//   shared memory (both K-major), and O += P.V with P as the register A operand (the S
//   accumulator's layout is the A fragment's, so P never leaves registers) and V from shared
//   memory in its natural (keys x d) layout, read MN-major (the transpose bit).
// - A block owns 128 query rows of one (batch, head): two consumer warpgroups of 64 rows each,
//   plus one producer warpgroup whose first thread issues every load. The block walks key
//   tiles of 64 keys (d = 256) or 128 keys (d <= 128) from 0 up to its diagonal; tiles wholly
//   above a block's last row are never loaded, and a warpgroup skips the compute of a tile
//   wholly above its own rows (an exact no-op in the online softmax). The causal mask is
//   applied only on tiles that cross the diagonal or the end of the sequence.
// - TMA loads into a 2-stage K/V ring, each stage signalled on an mbarrier with expect_tx; the
//   consumers release a stage on its empty barrier once their p.v has read it. Tensor maps
//   describe q/out as 4-D (d, H, T, B) and k/v as (d, Hkv, T, B), each packed;
//   with the 128-byte swizzle a box row is 64 bf16 columns, so a row of d columns arrives as
//   d / 64 boxes. TMA zero-fills rows past T (masked or never stored), so ragged T needs no
//   padding copy. Shared memory at d = 256: Q 64 KB + K/V 2 x 2 x 32 KB = 192 KB.
// - setmaxnreg: the producer warpgroup drops to 24 registers and the consumers rise to 240.
//   At d = 256 a consumer thread holds 128 f32 of O, 32 of S and 16 registers of P.
// - The online softmax stays in registers: a row's max is reduced over the 4 lanes that share
//   it with two shuffles; scores never touch shared memory.
// - The output, normalised and rounded to bf16, is written into the warpgroup's own rows of
//   Q's stage (swizzled as TMA expects) and stored with a TMA store, which clips rows past T.
// - The grid is ordered longest first: all heads of the last query block, then the one
//   before it, and so on.
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled, reached through the
// CUDA runtime's driver entry point (cudaGetDriverEntryPoint), so nothing links libcuda. The
// mbarrier, TMA and wgmma wrappers live in sm90.cuh, shared with int8_matmul.cu.

#include <cstddef>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kBlockM = 128;             // query rows per block: two consumer warpgroups
constexpr int kStages = 2;               // K/V ring depth
constexpr int kThreads = 384;            // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kRowBytes = 128;           // one swizzled smem row: 64 bf16 columns
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kBlockN = D == 256 ? 64 : 128;        // keys per tile
  static constexpr int kCols = D / 64;                       // 128-byte column blocks per row
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kTileBytes = kBlockN * D * 2;         // one K or one V tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kSmem = kBarOffset + 64 + 1024;       // barriers, 1024-byte alignment
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
               int t_len, int n_heads, int n_kv, int n_bh, int n_qb, float scale) {
  using C = Cfg<D>;
  constexpr int BN = C::kBlockN;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;                                   // [kCols][kBlockM rows][128 B]
  const uint32_t sk = base + C::kQBytes;                      // [kStages][kCols][BN][128 B]
  const uint32_t sv = sk + kStages * C::kTileBytes;
  const uint32_t bar_q = base + C::kBarOffset;
  const uint32_t bar_k = bar_q + 8;                           // full, one per stage
  const uint32_t bar_v = bar_k + 8 * kStages;                 // full, one per stage
  const uint32_t bar_e = bar_v + 8 * kStages;                 // empty, one per stage

  const int qb = n_qb - 1 - static_cast<int>(blockIdx.x) / n_bh;   // longest blocks first
  const int bh = static_cast<int>(blockIdx.x) % n_bh;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int hk = h / (n_heads / n_kv);
  const int q0 = qb * kBlockM;
  const int k_end = min(t_len, q0 + kBlockM);                 // keys past it are above the block
  const int n_tiles = (k_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 2 * 128);   // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load --------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, C::kQBytes);
      for (int c = 0; c < C::kCols; ++c)
        tma_load(sq + c * kBlockM * kRowBytes, &tm_q, bar_q, 64 * c, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t parity = (j / kStages) & 1;
        mbar_wait(bar_e + 8 * s, parity ^ 1);   // the first round passes at once
        const uint32_t dk = sk + s * C::kTileBytes, dv = sv + s * C::kTileBytes;
        mbar_expect_tx(bar_k + 8 * s, C::kTileBytes);
        for (int c = 0; c < C::kCols; ++c)
          tma_load(dk + c * BN * kRowBytes, &tm_k, bar_k + 8 * s, 64 * c, hk, j * BN, b);
        mbar_expect_tx(bar_v + 8 * s, C::kTileBytes);
        for (int c = 0; c < C::kCols; ++c)
          tma_load(dv + c * BN * kRowBytes, &tm_v, bar_v + 8 * s, 64 * c, hk, j * BN, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ---------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int first = q0 + 64 * cw, last = first + 63;         // this warpgroup's rows
    const int row = first + 16 * warp + lane / 4;              // this thread's rows: row, row + 8
    const uint32_t q_rows = sq + 64 * cw * kRowBytes;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const int k0 = j * BN;
      // Waiting for the tile also orders this warpgroup's release after the previous round's.
      mbar_wait(bar_k + 8 * s, parity);
      if (k0 <= last && first < t_len) {
        // S = Q . K^T (64 x BN, f32)
        float sc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
        const uint32_t kt = sk + s * C::kTileBytes;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4), sub = (kk % 4) * 32;
          wgmma_ss<BN, 0, 0>(sc, desc_sw128(q_rows + off * kBlockM * kRowBytes + sub, 16, 1024),
                             desc_sw128(kt + off * BN * kRowBytes + sub, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // online softmax; sc[4i + e] is row (row + 8 * (e >> 1)), key k0 + 8i + 2(lane % 4) + (e & 1)
        const bool edge = k0 + BN - 1 > first || k0 + BN > t_len;
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[4 * i + e] * scale;
            if (edge) {
              const int key = k0 + 8 * i + 2 * (lane % 4) + (e & 1);
              const int r = row + 8 * (e >> 1);
              if (key > r || key >= t_len) x = kNeg;
            }
            sc[4 * i + e] = x;
            if (e < 2) mx0 = fmaxf(mx0, x);
            else mx1 = fmaxf(mx1, x);
          }
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, 2));
        const float a0 = ex2((m0 - mx0) * kLog2e), a1 = ex2((m1 - mx1) * kLog2e);
        m0 = mx0;
        m1 = mx1;
        const float ml0 = mx0 * kLog2e, ml1 = mx1 * kLog2e;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          sc[4 * i + 0] = ex2(fmaf(sc[4 * i + 0], kLog2e, -ml0));
          sc[4 * i + 1] = ex2(fmaf(sc[4 * i + 1], kLog2e, -ml0));
          sc[4 * i + 2] = ex2(fmaf(sc[4 * i + 2], kLog2e, -ml1));
          sc[4 * i + 3] = ex2(fmaf(sc[4 * i + 3], kLog2e, -ml1));
          sum0 += sc[4 * i + 0] + sc[4 * i + 1];
          sum1 += sc[4 * i + 2] + sc[4 * i + 3];
        }
        l0 = a0 * l0 + sum0;
        l1 = a1 * l1 + sum1;
        // P as the A operand: k-step t covers keys 16t .. 16t + 15 (accumulator blocks 2t, 2t + 1)
        uint32_t pa[BN / 16][4];
#pragma unroll
        for (int t = 0; t < BN / 16; ++t) {
          pa[t][0] = pack_bf16(sc[8 * t + 0], sc[8 * t + 1]);
          pa[t][1] = pack_bf16(sc[8 * t + 2], sc[8 * t + 3]);
          pa[t][2] = pack_bf16(sc[8 * t + 4], sc[8 * t + 5]);
          pa[t][3] = pack_bf16(sc[8 * t + 6], sc[8 * t + 7]);
        }
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          acc[4 * i + 0] *= a0;
          acc[4 * i + 1] *= a0;
          acc[4 * i + 2] *= a1;
          acc[4 * i + 3] *= a1;
        }

        // O += P . V (64 x D, f32); V read MN-major: LBO steps 64 columns, SBO 8 keys
        mbar_wait(bar_v + 8 * s, parity);
        const uint32_t vt = sv + s * C::kTileBytes;
        fence_regs(acc);
        fence_regs(pa);
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < BN / 16; ++t)
          wgmma_rs<D, 1>(acc, pa[t], desc_sw128(vt + t * 16 * kRowBytes, BN * kRowBytes, 1024),
                         1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }
      mbar_arrive(bar_e + 8 * s);
    }

    // ---- epilogue: out = acc / l in bf16, through this warpgroup's rows of Q's stage ----------
    l0 += __shfl_xor_sync(0xFFFFFFFFu, l0, 1);
    l0 += __shfl_xor_sync(0xFFFFFFFFu, l0, 2);
    l1 += __shfl_xor_sync(0xFFFFFFFFu, l1, 1);
    l1 += __shfl_xor_sync(0xFFFFFFFFu, l1, 2);
    const int r = 16 * warp + lane / 4;                        // row within the warpgroup
    const uint32_t row_lo = q_rows + r * kRowBytes + (lane % 4) * 4;
    const uint32_t row_hi = row_lo + 8 * kRowBytes;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const uint32_t col = (i / 8) * kBlockM * kRowBytes + (((i % 8) ^ (r % 8)) * 16);
      asm volatile("st.shared.u32 [%0], %1;" ::"r"(row_lo + col),
                   "r"(pack_bf16(acc[4 * i + 0] / l0, acc[4 * i + 1] / l0)));
      asm volatile("st.shared.u32 [%0], %1;" ::"r"(row_hi + col),
                   "r"(pack_bf16(acc[4 * i + 2] / l1, acc[4 * i + 3] / l1)));
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
    if (tid == 0 && first < t_len) {
#pragma unroll
      for (int c = 0; c < C::kCols; ++c)
        tma_store(&tm_o, q_rows + c * kBlockM * kRowBytes, 64 * c, h, first, b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    }
  }
}

// ---- host -----------------------------------------------------------------------------------

// A 4-D (d, heads, T, B) map of a packed bf16 tensor with a box of 64 columns x `rows`
// positions of one head, 128-byte swizzled.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int d, int heads, int t_len,
              int batch, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(t_len), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(d) * 2;   // bytes per (position, head)
  const cuuint64_t strides[3] = {row, row * heads, row * heads * t_len};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch, int t_len,
           int n_heads, int n_kv, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  auto kern = flash_fwd_sm90<D>;
  int card = 0;
  cudaError_t e = current_card(&card);
  if (e != cudaSuccess) return static_cast<int>(e);
  // per instance and card: shared memory opted in, register budget checked
  static bool ready[kMaxCards] = {};
  if (!ready[card]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kern);
    if (e != cudaSuccess) return static_cast<int>(e);
    // setmaxnreg moves registers between warpgroups of the block's own allocation: launching
    // with fewer than the rebalanced total would stall the consumers' setmaxnreg.inc.
    if (attr.numRegs * kThreads < kProducerRegs * 128 + kConsumerRegs * 256)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    ready[card] = true;
  }
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv, to;
  if (!make_map(enc, &tq, q, D, n_heads, t_len, batch, kBlockM) ||
      !make_map(enc, &tk, k, D, n_kv, t_len, batch, C::kBlockN) ||
      !make_map(enc, &tv, v, D, n_kv, t_len, batch, C::kBlockN) ||
      !make_map(enc, &to, out, D, n_heads, t_len, batch, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_qb = (t_len + kBlockM - 1) / kBlockM;
  const int n_bh = batch * n_heads;
  kern<<<n_qb * n_bh, kThreads, C::kSmem, stream>>>(tq, tk, tv, to, t_len, n_heads, n_kv, n_bh,
                                                     n_qb, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). Device pointers to contiguous bfloat16 q (batch,
// t_len, n_heads, d), k and v (batch, t_len, n_kv, d), and out of q's shape. Requires d in
// {64, 128, 256}, n_heads % n_kv == 0 and every pointer 16-byte aligned (TMA). Launches on `stream`
// without synchronising; returns the first CUDA error as an int (cudaErrorInvalidValue for
// arguments it does not take).
extern "C" int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                           void* out, int batch, int t_len, int n_heads,
                                           int n_kv, int d, float scale, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (batch < 1 || t_len < 1 || n_kv < 1 || n_heads < 1 || n_heads % n_kv != 0 ||
      !aligned(q) || !aligned(k) || !aligned(v) || !aligned(out) ||
      static_cast<long long>((t_len + kBlockM - 1) / kBlockM) * batch * n_heads >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(q, k, v, out, batch, t_len, n_heads, n_kv, scale, s);
    case 128:
      return launch<128>(q, k, v, out, batch, t_len, n_heads, n_kv, scale, s);
    case 256:
      return launch<256>(q, k, v, out, batch, t_len, n_heads, n_kv, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
