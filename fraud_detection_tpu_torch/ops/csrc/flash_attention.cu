// Causal flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` reached through
// `flash_attention` in fraud_detection_tpu/ops/attention.py. Same function:
// q (B, T, H, d), k/v (B, T, Hkv, d) with H % Hkv == 0 -> out (B, T, H, d) in
// q's type, out[t] = softmax_{s <= t}(q[t] . k[s] / sqrt(d)) . v. Query head
// h reads K/V head h / (H / Hkv) at its native width (GQA/MQA, nothing is
// expanded). Rounding points follow the TPU kernel: the q.k dot is an f32
// sum of the input values, scaled in f32; masked scores are -1e30 (so
// exp(s - m) of a masked score is exactly 0); the running row max,
// normalizer and output accumulator are f32; p is rounded to v's type before
// p.v; acc / l is rounded to the output type once. The tiles are smaller than
// the TPU kernel's, so sums are taken in another order (f32 round-off).
//
// What bounds it on this card: operations. At the main path's shape (T 2048,
// H 8, d 256, bf16) the causal half of q.k and p.v is 4 (T^2/2) H d = 17.2
// GFLOP, ~17 us at the 989 TFLOP/s bf16 tensor-core rate, against ~19 MB of
// q, k, v and out (~6 us at 3.35 TB/s). Design (simple and right first; the
// wgmma/TMA redesign is later work): this kernel does its arithmetic as f32
// FMAs on the CUDA cores, not on the tensor cores. A block of 8 warps owns
// 64 query rows of one (batch, head), 8 rows per warp; tiles are walked in
// reverse so the longest (bottom) rows start first. The loop over 32-key
// tiles stops at the block's diagonal, and a warp skips a tile that lies
// wholly above its own rows (an exact no-op in the online softmax). Lane c
// of a warp holds columns c, c+32, ... of its 8 query rows and of their
// output accumulators in registers, so q.k needs only K from shared memory
// (a transposing butterfly sums the 8 row partials across the lanes with 9
// shuffles per key), and p.v reads V rows and broadcast p values from shared
// memory. K and V tiles are staged in shared memory in the input type. No
// atomics: every sum has one order, so two launches are bit-equal.

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 8;                    // query rows per warp
constexpr int kBlockQ = kWarps * kRows;     // 64 query rows per block
constexpr int kBlockK = 32;                 // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr int kSStride = kBlockK + 1;       // per-warp score tile row stride
constexpr int kMaxHeadDim = 256;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Sum each of the 8 per-lane partials p[r] over the warp. Each step halves
// the rows a lane keeps and sends the other half to its partner, so on
// return a lane holds the total of one row, (lane & 16 ? 4 : 0) +
// (lane & 8 ? 2 : 0) + (lane & 4 ? 1 : 0) (`reduced_row`); the 4 lanes that
// differ only in bits 0-1 hold the same total.
__device__ __forceinline__ float transpose_sum8(const float (&p)[kRows], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float t4[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = b4 ? p[i] : p[i + 4];
    const float keep = b4 ? p[i + 4] : p[i];
    t4[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
  float t2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = b3 ? t4[i] : t4[i + 2];
    const float keep = b3 ? t4[i + 2] : t4[i];
    t2[i] = keep + __shfl_xor_sync(kFull, send, 8);
  }
  float t1 = (b2 ? t2[1] : t2[0]) + __shfl_xor_sync(kFull, b2 ? t2[0] : t2[1], 4);
  t1 += __shfl_xor_sync(kFull, t1, 2);
  t1 += __shfl_xor_sync(kFull, t1, 1);
  return t1;
}

__device__ __forceinline__ int reduced_row(int lane) {
  return ((lane & 16) ? 4 : 0) + ((lane & 8) ? 2 : 0) + ((lane & 4) ? 1 : 0);
}

// NC = columns per lane: ceil(d / 32), d <= 32 * NC.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ out, int t_len, int n_heads, int n_kv, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);                   // [kBlockK][d]
  T* vs = ks + kBlockK * d;                                 // [kBlockK][d]
  float* sp = reinterpret_cast<float*>(vs + kBlockK * d);   // [kWarps][kRows][kSStride]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_qt = (t_len + kBlockQ - 1) / kBlockQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBlockQ;
  const int b = blockIdx.y / n_heads;
  const int h = blockIdx.y - b * n_heads;
  const int hk = h / (n_heads / n_kv);
  const int row0 = q0 + warp * kRows;
  const size_t q_step = static_cast<size_t>(n_heads) * d;   // t -> t + 1
  const size_t kv_step = static_cast<size_t>(n_kv) * d;
  const T* qb = q + (static_cast<size_t>(b) * t_len * n_heads + h) * d;
  const T* kb = k + (static_cast<size_t>(b) * t_len * n_kv + hk) * d;
  const T* vb = v + (static_cast<size_t>(b) * t_len * n_kv + hk) * d;
  T* ob = out + (static_cast<size_t>(b) * t_len * n_heads + h) * d;
  float* ssm = sp + warp * kRows * kSStride;

  float qr[kRows][NC], acc[kRows][NC], m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = row0 + r;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      qr[r][c] = (t < t_len && col < d) ? to_f(qb[t * q_step + col]) : 0.f;
      acc[r][c] = 0.f;
    }
    m[r] = kNeg;
    l[r] = 0.f;
  }

  // Keys past the block's last row lie above the diagonal for every row.
  const int k_end = min(t_len, q0 + kBlockQ);
  const int row_r = reduced_row(lane);
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed by every warp
    for (int j = warp; j < kBlockK; j += kWarps) {
      const int s = k0 + j;
      for (int col = lane; col < d; col += 32) {
        T kx = from_f<T>(0.f), vx = from_f<T>(0.f);
        if (s < t_len) {
          kx = kb[s * kv_step + col];
          vx = vb[s * kv_step + col];
        }
        ks[j * d + col] = kx;
        vs[j * d + col] = vx;
      }
    }
    __syncthreads();
    if (k0 > row0 + kRows - 1) continue;  // wholly above this warp's rows

    // scores: ssm[r][j] = q[row0 + r] . k[k0 + j]
#pragma unroll 2
    for (int j = 0; j < kBlockK; ++j) {
      float kf[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        kf[c] = col < d ? to_f(ks[j * d + col]) : 0.f;
      }
      float p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float x = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) x = fmaf(qr[r][c], kf[c], x);
        p[r] = x;
      }
      const float total = transpose_sum8(p, lane);
      if ((lane & 3) == 0) ssm[row_r * kSStride + j] = total;
    }
    __syncwarp();

    // online softmax over this tile; lane = key
    const int key = k0 + lane;
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float x = ssm[r * kSStride + lane] * scale;
      s[r] = (key <= row0 + r && key < t_len) ? x : kNeg;
    }
    __syncwarp();  // every score read before p overwrites it
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float m_new = fmaxf(m[r], warp_max(s[r]));
      const float pr = expf(s[r] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(pr);
      m[r] = m_new;
      ssm[r * kSStride + lane] = to_f(from_f<T>(pr));  // p in v's type
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    // acc += p . v
#pragma unroll 2
    for (int j = 0; j < kBlockK; ++j) {
      float vf[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        vf[c] = col < d ? to_f(vs[j * d + col]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pr = ssm[r * kSStride + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pr, vf[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = row0 + r;
    if (t >= t_len) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) ob[t * q_step + col] = from_f<T>(acc[r][c] / l[r]);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* out, int batch, int t_len,
           int n_heads, int n_kv, int d, float scale, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(kBlockK) * d * sizeof(T) +
                      static_cast<size_t>(kWarps) * kRows * kSStride * sizeof(float);
  auto kern = flash_fwd<T, NC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((t_len + kBlockQ - 1) / kBlockQ, batch * n_heads);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), t_len, n_heads, n_kv, d, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int batch, int t_len,
             int n_heads, int n_kv, int d, float scale, cudaStream_t stream) {
  if (d <= 32) return launch<T, 1>(q, k, v, out, batch, t_len, n_heads, n_kv, d, scale, stream);
  if (d <= 64) return launch<T, 2>(q, k, v, out, batch, t_len, n_heads, n_kv, d, scale, stream);
  if (d <= 128) return launch<T, 4>(q, k, v, out, batch, t_len, n_heads, n_kv, d, scale, stream);
  return launch<T, 8>(q, k, v, out, batch, t_len, n_heads, n_kv, d, scale, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Device pointers to contiguous
// q (batch, t_len, n_heads, d), k and v (batch, t_len, n_kv, d) and out (the
// shape of q), all of one type: dtype 0 = float32, 1 = bfloat16. Requires
// 1 <= d <= 256, n_heads % n_kv == 0, batch * n_heads <= 65535 and
// t_len * n_heads * d < 2^31. Launches on `stream` without synchronising;
// returns the first CUDA error as an int (cudaErrorInvalidValue for
// arguments it does not take).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int batch, int t_len, int n_heads, int n_kv, int d,
                                      int dtype, float scale, void* stream) {
  if (batch < 1 || t_len < 1 || n_kv < 1 || n_heads % n_kv != 0 || d < 1 ||
      d > kMaxHeadDim || batch * n_heads > 65535 ||
      static_cast<int64_t>(t_len) * n_heads * d >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(q, k, v, out, batch, t_len, n_heads, n_kv, d, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, batch, t_len, n_heads, n_kv, d, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
