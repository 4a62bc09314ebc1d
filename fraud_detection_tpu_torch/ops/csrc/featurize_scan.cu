// Byte-scan featurize kernel for Hopper (sm_90a): tokenize + murmur3_x86_32
// + stop-word identity pack, one sequential pass over each row's character
// classes.
//
// Replaces the Pallas TPU kernel `_scan_kernel` reached through
// `tokenize_hash` in fraud_detection_tpu/ops/featurize_kernel.py. Same
// semantics, column for column: Java split("\\s") field boundaries (interior
// and leading empty fields kept, trailing dropped, "" -> [""]), murmur3 with
// seed 42 (standard tail, or the legacy sign-extended tail with a full mix
// round per byte), the 5-bit identity words w0/w1 of a token's first 12
// chars, an emission at the column that closes each token, and a per-row
// count of confirmed empty tokens.
//
// What bounds it: bytes. Per element it reads one int32 class and writes
// four int32 streams (h, w0, w1, tok_len) — 20 bytes for some tens of
// integer operations, far below the card's operations-per-byte balance.
// Design (simple first): one thread per row, carrying the scan state
// (h1, k1, nb, w0, w1, pend, emp, kept) in registers and walking the row's
// columns in order; 128 threads per block. Neighbouring threads touch
// addresses one row apart, so loads and stores coalesce poorly (each class
// load is served from the L1 line the thread fetched for its 32-column
// neighbourhood). A later redesign stages column tiles in shared memory,
// reads bytes instead of int32 classes and fuses the count/pack post-pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kClsSpace = 27;
constexpr int kClsEnd = 28;
constexpr uint32_t kSeed = 42;       // Spark HashingTF's murmur seed
constexpr int kPackChars = 12;       // identity pack width (2 x 6 chars)
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_k1(uint32_t k1) {
  k1 *= 0xCC9E2D51u;
  k1 = rotl32(k1, 15);
  return k1 * 0x1B873593u;
}

__device__ __forceinline__ uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  return h1 * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix(uint32_t h1, uint32_t length) {
  h1 ^= length;
  h1 ^= h1 >> 16;
  h1 *= 0x85EBCA6Bu;
  h1 ^= h1 >> 13;
  h1 *= 0xC2B2AE35u;
  return h1 ^ (h1 >> 16);
}

template <bool kLegacy>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const int32_t* __restrict__ cls, int32_t* __restrict__ h_out,
            int32_t* __restrict__ w0_out, int32_t* __restrict__ w1_out,
            int32_t* __restrict__ tl_out, int32_t* __restrict__ emp_out,
            int rows, int cols) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const size_t base = static_cast<size_t>(r) * cols;
  const int32_t* row = cls + base;

  uint32_t h1 = kSeed, k1 = 0;
  int nb = 0, w0 = 0, w1 = 0, pend = 0, emp = 0;
  bool kept = false;

  for (int j = 0; j < cols; ++j) {
    const int c = __ldg(row + j);
    const bool is_let = c >= 1 && c <= 26;
    const bool is_space = c == kClsSpace;
    const bool is_end = c == kClsEnd;

    if (is_let) {
      // stream the byte ('a'..'z') into the murmur word; a body word
      // completes every 4th byte
      k1 |= static_cast<uint32_t>(c + 96) << ((nb & 3) * 8);
      if ((nb & 3) == 3) {
        h1 = mix_h1(h1, mix_k1(k1));
        k1 = 0;
      }
      if (nb < 6) {
        w0 |= c << (5 * nb);
      } else if (nb < kPackChars) {
        w1 |= c << (5 * (nb - 6));
      }
      ++nb;
    }

    const bool boundary = is_space || is_end;
    int out_h = 0, out_w0 = 0, out_w1 = 0, out_tl = -1;
    if (boundary && nb > 0) {
      // this column closes a non-empty field: finalize and emit
      uint32_t hfin = h1;
      const int tail = nb & 3;
      if (kLegacy) {
        // hashUnsafeBytes: each tail byte gets a full mix round (token
        // bytes are < 0x80, so Java's sign extension is the identity)
        for (int t = 0; t < tail; ++t) {
          hfin = mix_h1(hfin, mix_k1((k1 >> (8 * t)) & 0xFFu));
        }
      } else {
        // hashUnsafeBytes2: the pending tail word mixes in once
        // (mix_k1(0) == 0 covers the aligned case)
        hfin ^= mix_k1(k1);
      }
      hfin = fmix(hfin, static_cast<uint32_t>(nb));
      out_h = static_cast<int32_t>(hfin);
      out_w0 = w0;
      out_w1 = w1;
      out_tl = nb;
      emp += pend;   // the pending empty fields were interior: confirmed
      pend = 0;
    }
    if (is_space && nb == 0) ++pend;
    kept = kept || is_let || is_space;
    // cleaned row kept NOTHING: Java split("") returns [""]
    if (is_end && !kept) emp = 1;
    if (boundary) {
      h1 = kSeed;
      k1 = 0;
      nb = 0;
      w0 = 0;
      w1 = 0;
    }
    h_out[base + j] = out_h;
    w0_out[base + j] = out_w0;
    w1_out[base + j] = out_w1;
    tl_out[base + j] = out_tl;
  }
  emp_out[r] = emp;
}

}  // namespace

// Plain C entry point (loaded with ctypes). All pointers are device
// pointers to contiguous int32 buffers: cls/h/w0/w1/tl are (rows, cols),
// emp is (rows,). Launches on `stream` without synchronising and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int featurize_scan(const int32_t* cls, int32_t* h, int32_t* w0,
                              int32_t* w1, int32_t* tl, int32_t* emp,
                              int rows, int cols, int legacy, void* stream) {
  const dim3 grid((rows + kThreads - 1) / kThreads);
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (legacy) {
    scan_kernel<true><<<grid, block, 0, s>>>(cls, h, w0, w1, tl, emp, rows, cols);
  } else {
    scan_kernel<false><<<grid, block, 0, s>>>(cls, h, w0, w1, tl, emp, rows, cols);
  }
  return static_cast<int>(cudaGetLastError());
}
