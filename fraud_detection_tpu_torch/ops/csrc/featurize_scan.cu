// Device featurization for Hopper (sm_90a): raw staged bytes in, packed
// (B, 2, n_slots) int16 ids/counts out, in one kernel.
//
// Replaces the Pallas TPU kernel `_scan_kernel` reached through
// `tokenize_hash` (fraud_detection_tpu/ops/featurize_kernel.py:266 / :170)
// and, on the serving path, the XLA work `featurize_bytes` (:488) runs around
// it: `byte_classes` (:139) and `assemble_packed` (:398). Two C entry points
// share the device code:
//
//   featurize_packed  (B, W+4) uint8 staging rows -> packed (B, 2, n_slots)
//                     int16 and the (B,) int32 unique-bucket count; nothing
//                     else touches device memory.
//   featurize_scan    (B, C) int32 classes -> h, w0, w1, tok_len (B, C) int32
//                     and the (B, 1) empty count: tokenize_hash's streams.
//
// Semantics, column for column, as the reference: clean_text as byte
// classes (ASCII letters lowercased, space kept, everything else stripped
// but the two codepoints U+0130 and U+212A, whose lowercase lands on 'i' and
// 'k'; CLS_END at the row's length), Java split("\\s") fields (interior and
// leading empty fields kept, trailing ones dropped, "" -> [""]), murmur3
// x86_32 with seed 42 (standard tail, or the legacy tail with a full mix
// round per byte), the 5-bit identity words of a token's first 12 letters,
// an exact direct-mapped stop-table probe, bucket = floor-mod(hash, F), the
// "" token as one (bucket, multiplicity) entry, per-bucket counts, and past
// n_slots unique buckets the top counts with ties to the lower bucket id.
// Every step is integer arithmetic, so the result is exact.
//
// What bounds it: at (256, 2052) the fused entry must read the 0.53 MB of
// rows and write 0.26 MB, ~0.24 us at 3.35 TB/s (the stop table is probed
// once a token, not read whole); some tens of integer operations a byte take
// about as long.
// So its time is the launch and each row's chain of block-wide steps (about
// 40 us on an H100), not bandwidth. The first kernel (one thread per row,
// four int32 streams stored 8 KB apart) ran 256 rows on 2 SMs and left
// ~165 small torch ops around it.
//
// Design: one 256-thread block per row, so a 256-row chunk covers every
// SM. The row's bytes are staged in shared memory with 16-byte loads (the
// shared copy keeps the global address's alignment mod 16). Columns are
// dealt to threads in contiguous runs of up to 16 (one pass over a
// 2,049-column row). Per chunk of columns: each thread classes its columns;
// block-wide max-scans give, for every column, the last boundary and the
// last letter before it (a boundary emits when a letter lies between), and
// a sum-scan places the empty fields; the thread owning an emitting boundary
// walks back to the previous boundary and hashes the token (O(W) per row in
// all; one 2,048-letter token serialises one thread). The fused entry then
// probes the stop table and adds the token to a per-row counter array of F
// int32 in shared memory (shared atomics): run-length by bucket id without
// a sort, ids ascending by construction. The unique count is a block sum;
// an overflow row finds its count threshold by binary search over block
// counts and takes the tied ids lowest first. A block-wide sum-scan gives
// each selected bucket its slot. Rows wider than the shared budget are read
// from device memory through the same generic pointer. The stream entry
// stages each chunk's four output streams in shared memory and stores them
// with neighbouring lanes on neighbouring columns.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kClsSpace = 27;
constexpr int kClsEnd = 28;
constexpr uint32_t kSeed = 42;       // Spark HashingTF's murmur seed
constexpr int kPackChars = 12;       // identity pack width (2 x 6 chars)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsMax = 16;         // columns a thread owns per chunk
constexpr int kChunkMax = kThreads * kColsMax;
// Column types, two bits each in a thread's packed word.
constexpr uint32_t kNop = 0, kLetter = 1, kSpace = 2, kEnd = 3;
// Shared memory a block may take (of the SM's 227 KB), so that a row of
// the serving path's width fits five blocks to an SM.
constexpr int kSmemBudget = 200 * 1024;

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

__device__ __forceinline__ uint32_t col_type(int c) {
  if (c >= 1 && c <= 26) return kLetter;
  if (c == kClsSpace) return kSpace;
  if (c == kClsEnd) return kEnd;
  return kNop;
}

// ---------------------------------------------------------------------------
// block-wide scans (256 threads)
// ---------------------------------------------------------------------------

struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct MinOp {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};
struct SumOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

template <class Op>
__device__ __forceinline__ int warp_inclusive(int v, Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = op(v, o);
  }
  return v;
}

// Exclusive scan of one value per thread in thread order (``identity``
// before thread 0); ``*total`` gets the whole block's. ``sm`` holds
// 2 * kWarps ints. Every thread must call it; it ends with a barrier, so
// ``sm`` may be reused straight away.
template <class Op>
__device__ int block_exclusive(int v, int identity, Op op, int* sm,
                               int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int inc = warp_inclusive(v, op);
  if (lane == 31) sm[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_inclusive(lane < kWarps ? sm[lane] : identity, op);
    if (lane < kWarps) sm[kWarps + lane] = w;
  }
  __syncthreads();
  int before = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) before = identity;
  const int prefix = warp == 0 ? identity : sm[kWarps + warp - 1];
  *total = sm[2 * kWarps - 1];
  __syncthreads();
  return op(prefix, before);
}

template <class Op>
__device__ __forceinline__ int block_reduce(int v, int identity, Op op,
                                            int* sm) {
  int total;
  block_exclusive(v, identity, op, sm, &total);
  return total;
}

// ---------------------------------------------------------------------------
// column sources: the class of a column, for the scan and the token walks
// ---------------------------------------------------------------------------

// Staged bytes: byte_classes of one row (clean_text, CLS_END at the length).
// ``b`` is a generic pointer: the row's shared-memory copy, or the row in
// device memory when it is wider than the shared budget.
struct ByteSource {
  const uint8_t* b;
  int width;    // W: bytes in the row (its W+1 columns end on a pad column)
  int length;   // the row's byte length; -1 marks a padding row

  __device__ __forceinline__ int byte_at(int i) const {
    return i < width ? static_cast<int>(b[i]) : 0;
  }
  __device__ int cls(int col) const {
    if (col == length) return kClsEnd;
    if (length < 0 || col > length || col >= width) return 0;
    const int c = b[col];
    if (c >= 'A' && c <= 'Z') return c - 64;
    if (c >= 'a' && c <= 'z') return c - 96;
    if (c == ' ') return kClsSpace;
    // the two codepoints whose lowercase survives clean_text as a letter
    if (c == 0xC4 && byte_at(col + 1) == 0xB0) return 'i' - 96;
    if (c == 0xE2 && byte_at(col + 1) == 0x84 && byte_at(col + 2) == 0xAA)
      return 'k' - 96;
    return 0;
  }
};

// Precomputed classes (the stream entry).
struct ClassSource {
  const int32_t* c;
  __device__ __forceinline__ int cls(int col) const { return __ldg(c + col); }
};

struct Token {
  int32_t h, w0, w1, len;
};

// Hash the token whose letters lie in columns [start, end): the scan's
// per-field state machine, letters streamed in order, everything else
// skipped.
template <bool kLegacy, class Src>
__device__ Token hash_field(const Src& src, int start, int end) {
  uint32_t h1 = kSeed, k1 = 0;
  int nb = 0, w0 = 0, w1 = 0;
  for (int col = start; col < end; ++col) {
    const int c = src.cls(col);
    if (c < 1 || c > 26) continue;
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
  uint32_t hfin = h1;
  if (kLegacy) {
    // hashUnsafeBytes: each tail byte gets a full mix round (token bytes
    // are < 0x80, so Java's sign extension is the identity)
    for (int t = 0; t < (nb & 3); ++t) {
      hfin = mix_h1(hfin, mix_k1((k1 >> (8 * t)) & 0xFFu));
    }
  } else {
    hfin ^= mix_k1(k1);   // mix_k1(0) == 0 covers the aligned case
  }
  return Token{static_cast<int32_t>(fmix(hfin, static_cast<uint32_t>(nb))),
               w0, w1, nb};
}

// Scan one row's ``cols`` columns. ``sink.emit(col, token)`` runs for each
// column that closes a non-empty field, ``sink.chunk_done(base, n)`` after
// each chunk (behind a barrier). Returns the row's count of confirmed empty
// tokens: the empty fields before the last emitting boundary, plus one when
// a CLS_END comes before any letter or space (Java's split("") == [""]).
template <bool kLegacy, class Src, class Sink>
__device__ int scan_row(const Src& src, int cols, Sink& sink, int* sm,
                        int* s_emp) {
  const int t = threadIdx.x;
  const int per = min(kColsMax, (cols + kThreads - 1) / kThreads);
  const int chunk = per * kThreads;
  int carry_b = -1, carry_l = -1;   // last boundary / letter before the chunk
  int carry_e = 0;                  // empty fields before the chunk
  int first_kept = INT_MAX, first_end = INT_MAX;
  if (t == 0) *s_emp = 0;
  // s_emp's first write is ordered before any atomicMax by the barriers
  // inside the first chunk's scans
  for (int base = 0; base < cols; base += chunk) {
    const int c0 = base + t * per;
    const int n = max(0, min(per, cols - c0));
    // pass 1: class each column; the last boundary and letter of the run
    uint32_t types = 0;
    int last_b = -1, last_l = -1, kept = INT_MAX, end = INT_MAX;
#pragma unroll
    for (int k = 0; k < kColsMax; ++k) {
      if (k < n) {
        const int col = c0 + k;
        const uint32_t ty = col_type(src.cls(col));
        types |= ty << (2 * k);
        if (ty == kLetter) last_l = col;
        if (ty == kSpace || ty == kEnd) last_b = col;
        if ((ty == kLetter || ty == kSpace) && kept == INT_MAX) kept = col;
        if (ty == kEnd && end == INT_MAX) end = col;
      }
    }
    int tot_b, tot_l, tot_k, tot_e;
    int pb = max(carry_b, block_exclusive(last_b, -1, MaxOp(), sm, &tot_b));
    int ll = max(carry_l, block_exclusive(last_l, -1, MaxOp(), sm, &tot_l));
    block_exclusive(kept, INT_MAX, MinOp(), sm, &tot_k);
    block_exclusive(end, INT_MAX, MinOp(), sm, &tot_e);
    first_kept = min(first_kept, tot_k);
    first_end = min(first_end, tot_e);
    carry_b = max(carry_b, tot_b);
    carry_l = max(carry_l, tot_l);
    // pass 2: emitting boundaries hash their tokens; empty fields counted
    int empties = 0, before_emit = -1;
#pragma unroll
    for (int k = 0; k < kColsMax; ++k) {
      if (k < n) {
        const int col = c0 + k;
        const uint32_t ty = (types >> (2 * k)) & 3u;
        if (ty == kLetter) {
          ll = col;
        } else if (ty == kSpace || ty == kEnd) {
          if (ll > pb) {
            sink.emit(col, hash_field<kLegacy>(src, pb + 1, col));
            before_emit = empties;
          } else if (ty == kSpace) {
            ++empties;
          }
          pb = col;
        }
      }
    }
    int tot;
    const int excl = block_exclusive(empties, 0, SumOp(), sm, &tot);
    if (before_emit >= 0) atomicMax(s_emp, carry_e + excl + before_emit);
    carry_e += tot;
    sink.chunk_done(base, min(chunk, cols - base));
  }
  __syncthreads();
  return *s_emp + (first_end < first_kept ? 1 : 0);
}

// ---------------------------------------------------------------------------
// featurize_packed: bytes -> packed ids/counts
// ---------------------------------------------------------------------------

struct PackedSink {
  int* counts;               // shared, one per bucket
  const int32_t* stop;       // (stop_size, 3) [w0, w1, len], len -1 = empty
  uint32_t stop_mask;
  int num_features;

  __device__ void emit(int, const Token& tok) {
    uint32_t h = static_cast<uint32_t>(tok.w0) * 0x9E3779B1u +
                 static_cast<uint32_t>(tok.w1) * 0x85EBCA6Bu +
                 static_cast<uint32_t>(tok.len) * 0xC2B2AE35u;
    h ^= h >> 15;
    h *= 0x2C1B3C6Du;
    h ^= h >> 12;
    const int32_t* e = stop + 3 * static_cast<size_t>(h & stop_mask);
    if (__ldg(e) == tok.w0 && __ldg(e + 1) == tok.w1 &&
        __ldg(e + 2) == tok.len)
      return;                                   // a stop word
    int r = tok.h % num_features;
    if (r < 0) r += num_features;               // floor-mod
    atomicAdd(counts + r, 1);
  }
  __device__ void chunk_done(int, int) {}
};

// Count the buckets with count >= v over this thread's id range.
__device__ __forceinline__ int count_ge(const int* counts, int lo, int hi,
                                        int v) {
  int n = 0;
  for (int i = lo; i < hi; ++i) n += counts[i] >= v;
  return n;
}

template <bool kLegacy>
__global__ void __launch_bounds__(kThreads)
packed_kernel(const uint8_t* __restrict__ staged,
              const int32_t* __restrict__ stop, uint32_t stop_mask,
              int16_t* __restrict__ packed, int32_t* __restrict__ n_unique,
              int width, int num_features, int n_slots, int binary,
              int empty_bucket, int empty_is_stop, int stage_row) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sm[2 * kWarps];
  __shared__ int s_emp;
  const int t = threadIdx.x;
  const int row = blockIdx.x;
  const int pitch = width + 4;
  const uint8_t* grow = staged + static_cast<size_t>(row) * pitch;
  int* counts = reinterpret_cast<int*>(smem);

  for (int i = t; i < num_features; i += kThreads) counts[i] = 0;
  const uint8_t* rowp = grow;
  if (stage_row) {
    // copy the row with 16-byte loads: the shared copy starts at the same
    // offset mod 16 as the row in device memory
    const size_t cbytes = (static_cast<size_t>(num_features) * 4 + 15) & ~15;
    unsigned char* buf = smem + cbytes;
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(grow) & 15);
    unsigned char* dst = buf + mis;
    const int head = min(pitch, (16 - mis) & 15);
    const int body = (pitch - head) / 16;
    for (int i = t; i < head; i += kThreads) dst[i] = grow[i];
    const int4* src4 = reinterpret_cast<const int4*>(grow + head);
    int4* dst4 = reinterpret_cast<int4*>(dst + head);
    for (int i = t; i < body; i += kThreads) dst4[i] = __ldg(src4 + i);
    for (int i = head + 16 * body + t; i < pitch; i += kThreads)
      dst[i] = grow[i];
    rowp = dst;
  }
  __syncthreads();
  const int length = static_cast<int>(
      static_cast<uint32_t>(rowp[width]) |
      (static_cast<uint32_t>(rowp[width + 1]) << 8) |
      (static_cast<uint32_t>(rowp[width + 2]) << 16) |
      (static_cast<uint32_t>(rowp[width + 3]) << 24));
  const ByteSource src{rowp, width, length};
  PackedSink sink{counts, stop, stop_mask, num_features};
  const int emp = scan_row<kLegacy>(src, width + 1, sink, sm, &s_emp);
  if (t == 0 && !empty_is_stop && emp > 0) counts[empty_bucket] += emp;
  __syncthreads();

  // each thread owns a contiguous run of bucket ids
  const int per = (num_features + kThreads - 1) / kThreads;
  const int lo = min(num_features, t * per);
  const int hi = min(num_features, lo + per);
  int nz = 0, mx = 0;
  for (int i = lo; i < hi; ++i) {
    nz += counts[i] > 0;
    mx = max(mx, counts[i]);
  }
  const int unique = block_reduce(nz, 0, SumOp(), sm);
  // select counts > thr, and of the counts == thr the first ``need`` ids
  int thr = 0, need = 0;
  if (unique > n_slots) {
    int a = 1, b = block_reduce(mx, 0, MaxOp(), sm);
    while (a < b) {   // the largest v with n_slots or more counts >= v
      const int mid = (a + b + 1) >> 1;
      if (block_reduce(count_ge(counts, lo, hi, mid), 0, SumOp(), sm) >=
          n_slots) {
        a = mid;
      } else {
        b = mid - 1;
      }
    }
    thr = a;
    need = n_slots -
           block_reduce(count_ge(counts, lo, hi, thr + 1), 0, SumOp(), sm);
  }
  int rank = 0;
  if (need > 0) {
    int eq = 0, tot;
    for (int i = lo; i < hi; ++i) eq += counts[i] == thr;
    rank = block_exclusive(eq, 0, SumOp(), sm, &tot);
  }
  int sel = 0;
  {
    int r = rank;
    for (int i = lo; i < hi; ++i) {
      const int c = counts[i];
      if (c > thr) {
        ++sel;
      } else if (need > 0 && c == thr) {
        sel += r < need;
        ++r;
      }
    }
  }
  int n_out;
  int slot = block_exclusive(sel, 0, SumOp(), sm, &n_out);
  int16_t* ids_out = packed + static_cast<size_t>(row) * 2 * n_slots;
  int16_t* cnt_out = ids_out + n_slots;
  {
    int r = rank;
    for (int i = lo; i < hi; ++i) {
      const int c = counts[i];
      bool take = c > thr;
      if (!take && need > 0 && c == thr) take = r++ < need;
      if (take) {
        int v = binary ? min(c, 1) : c;
        v = min(v, 65535);
        ids_out[slot] = static_cast<int16_t>(i);
        cnt_out[slot] = static_cast<int16_t>(static_cast<uint16_t>(v));
        ++slot;
      }
    }
  }
  for (int s = n_out + t; s < n_slots; s += kThreads) {
    ids_out[s] = 0;
    cnt_out[s] = 0;
  }
  if (t == 0) n_unique[row] = unique;
}

// ---------------------------------------------------------------------------
// featurize_scan: classes -> the four token streams
// ---------------------------------------------------------------------------

struct StreamSink {
  int32_t* stage;   // shared: 4 planes of kChunkMax columns
  int chunk_base;   // the current chunk's first column (set per chunk)
  int32_t *h, *w0, *w1, *tl;   // this row's outputs in device memory

  __device__ void emit(int col, const Token& tok) {
    const int j = col - chunk_base;
    stage[j] = tok.h;
    stage[kChunkMax + j] = tok.w0;
    stage[2 * kChunkMax + j] = tok.w1;
    stage[3 * kChunkMax + j] = tok.len;
  }
  // behind the chunk's last barrier: store the staged streams, neighbouring
  // lanes on neighbouring columns, then reset the stage for the next chunk
  __device__ void chunk_done(int base, int n) {
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      h[base + j] = stage[j];
      w0[base + j] = stage[kChunkMax + j];
      w1[base + j] = stage[2 * kChunkMax + j];
      tl[base + j] = stage[3 * kChunkMax + j];
    }
    __syncthreads();
    reset(base + n);
  }
  __device__ void reset(int base) {
    for (int j = threadIdx.x; j < kChunkMax; j += kThreads) {
      stage[j] = 0;
      stage[kChunkMax + j] = 0;
      stage[2 * kChunkMax + j] = 0;
      stage[3 * kChunkMax + j] = -1;
    }
    chunk_base = base;
    __syncthreads();
  }
};

template <bool kLegacy>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const int32_t* __restrict__ cls, int32_t* __restrict__ h_out,
              int32_t* __restrict__ w0_out, int32_t* __restrict__ w1_out,
              int32_t* __restrict__ tl_out, int32_t* __restrict__ emp_out,
              int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sm[2 * kWarps];
  __shared__ int s_emp;
  const size_t off = static_cast<size_t>(blockIdx.x) * cols;
  StreamSink sink{reinterpret_cast<int32_t*>(smem), 0, h_out + off,
                  w0_out + off, w1_out + off, tl_out + off};
  sink.reset(0);
  const ClassSource src{cls + off};
  const int emp = scan_row<kLegacy>(src, cols, sink, sm, &s_emp);
  if (threadIdx.x == 0) emp_out[blockIdx.x] = emp;
}

// Dynamic shared memory above 48 KB has to be allowed per kernel.
template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// Plain C entry points (loaded with ctypes). All pointers are device
// pointers to contiguous buffers; each launches on ``stream`` without
// synchronising and returns cudaGetLastError() as an int (0 = launched).

// staged (rows, width+4) uint8 -> packed (rows, 2, n_slots) int16 and
// n_unique (rows,) int32. stop: (stop_size, 3) int32, stop_size a power of
// two. 1 <= num_features <= 32767, n_slots >= 1.
extern "C" int featurize_packed(const uint8_t* staged, const int32_t* stop,
                                int stop_size, int16_t* packed,
                                int32_t* n_unique, int rows, int width,
                                int num_features, int n_slots, int binary,
                                int legacy, int empty_bucket,
                                int empty_is_stop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t cbytes = (static_cast<size_t>(num_features) * 4 + 15) & ~15;
  const size_t rbytes = ((static_cast<size_t>(width) + 4 + 15) & ~15) + 16;
  const int stage_row = cbytes + rbytes <= kSmemBudget;
  const size_t smem = cbytes + (stage_row ? rbytes : 0);
  const uint32_t mask = static_cast<uint32_t>(stop_size - 1);
  cudaError_t e;
  if (legacy) {
    e = allow_smem(packed_kernel<true>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    packed_kernel<true><<<rows, kThreads, smem, s>>>(
        staged, stop, mask, packed, n_unique, width, num_features, n_slots,
        binary, empty_bucket, empty_is_stop, stage_row);
  } else {
    e = allow_smem(packed_kernel<false>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    packed_kernel<false><<<rows, kThreads, smem, s>>>(
        staged, stop, mask, packed, n_unique, width, num_features, n_slots,
        binary, empty_bucket, empty_is_stop, stage_row);
  }
  return static_cast<int>(cudaGetLastError());
}

// cls/h/w0/w1/tl are (rows, cols) int32, emp is (rows,) int32.
extern "C" int featurize_scan(const int32_t* cls, int32_t* h, int32_t* w0,
                              int32_t* w1, int32_t* tl, int32_t* emp,
                              int rows, int cols, int legacy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 4 * kChunkMax * sizeof(int32_t);
  cudaError_t e;
  if (legacy) {
    e = allow_smem(stream_kernel<true>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    stream_kernel<true><<<rows, kThreads, smem, s>>>(cls, h, w0, w1, tl, emp,
                                                     cols);
  } else {
    e = allow_smem(stream_kernel<false>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    stream_kernel<false><<<rows, kThreads, smem, s>>>(cls, h, w0, w1, tl, emp,
                                                      cols);
  }
  return static_cast<int>(cudaGetLastError());
}
