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
// CUDA runtime's driver entry point (cudaGetDriverEntryPoint), so nothing links libcuda.

#include <cstddef>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier -------------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` to complete. (A watchdog here, clock64 and __trap,
// made ptxas spill the d = 256 consumer and serialize its wgmma.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}

// ---- TMA ------------------------------------------------------------------------------------

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------------------------

// Shared-memory matrix descriptor for a 128-byte-swizzled operand: start address, leading and
// stride byte offsets (16-byte units), layout type 1 (SWIZZLE_128B) in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma operand registers across the
// fence / wait instructions, which it cannot see are tied to them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x N, f32) = or += A (64 x 16, smem, K-major) . B (16 x N, smem, K-major).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d);
// D (64 x N, f32) += A (64 x 16, bf16 registers) . B (16 x N, smem, MN-major).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void
wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void
wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void
wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void
wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void
wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- the kernel -----------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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
          wgmma_ss<BN>(sc, desc_sw128(q_rows + off * kBlockM * kRowBytes + sub, 16, 1024),
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
          wgmma_rs<D>(acc, pa[t], desc_sw128(vt + t * 16 * kRowBytes, BN * kRowBytes, 1024));
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

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
  static int ready = -1;   // per instance: shared memory opted in, register budget checked
  if (ready < 0) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kern);
    if (e != cudaSuccess) return static_cast<int>(e);
    // setmaxnreg moves registers between warpgroups of the block's own allocation: launching
    // with fewer than the rebalanced total would stall the consumers' setmaxnreg.inc.
    if (attr.numRegs * kThreads < kProducerRegs * 128 + kConsumerRegs * 256)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    ready = 1;
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
