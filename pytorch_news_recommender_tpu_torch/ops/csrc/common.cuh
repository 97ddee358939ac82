// Helpers shared by the fused encoder's forward (fused_encoder.cu) and
// backward (fused_encoder_bwd.cu) kernels: type conversion at the TPU
// kernel's rounding points, warp reductions, the block-level products the
// kernels are built from, and the dropout hash.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows of a thread's tile in the block products

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and widened back to f32
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// four consecutive values (16-byte aligned for f32, 8-byte for bf16)
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]), b = __bfloat1622float2(q[1]);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// C[r][n] = sum_k A[r][k] * B[k][col(n)] for r < Rp, n < N, accumulated in
// f32 and handed to epi(r, n, C[r][n], C[r][n+1]). A lies in shared memory
// (row stride lda, a multiple of 4); B in global memory (row stride ldb).
// Needs Rp % 4 == 0, K % 4 == 0, N even, and col(n + 1) == col(n) + 1 for
// even n. kRoundA rounds each A value to T first.
template <typename T, bool kRoundA, typename ColFn, typename EpiFn>
__device__ __forceinline__ void block_product(const float* __restrict__ A, int lda, int Rp,
                                              int K, const T* __restrict__ B, int ldb, int N,
                                              ColFn col, EpiFn epi) {
  const int pairs = N >> 1;
  const int items = (Rp / kRows) * pairs;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int r0 = (it / pairs) * kRows;
    const int n = (it % pairs) * 2;
    const T* bp = B + col(n);
    float acc[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i][0] = acc[i][1] = 0.f;
    for (int k = 0; k < K; k += 4) {
      float a[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(A + (r0 + i) * lda + k);
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
        if (kRoundA) {
#pragma unroll
          for (int j = 0; j < 4; ++j) a[i][j] = rnd<T>(a[i][j]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float2 b = load2(bp + (long)(k + kk) * ldb);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][0] = fmaf(a[i][kk], b.x, acc[i][0]);
          acc[i][1] = fmaf(a[i][kk], b.y, acc[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) epi(r0 + i, n, acc[i][0], acc[i][1]);
  }
}

// C[r][n] = sum_k A[r][k] * Bt[n][k]: the product with a transposed B (row
// n of Bt, stride ldb, is column n of B). A may lie in shared or global
// memory (row stride lda, a multiple of 4, 16-byte aligned); rows at or past
// `rows` read as 0. Needs Rp % 4 == 0, K % 4 == 0, ldb % 4 == 0, N even.
template <typename T, typename EpiFn>
__device__ __forceinline__ void block_product_t(const float* A, int lda, int Rp, int rows, int K,
                                                const T* __restrict__ Bt, int ldb, int N,
                                                EpiFn epi) {
  const int pairs = N >> 1;
  const int items = (Rp / kRows) * pairs;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int r0 = (it / pairs) * kRows;
    const int n = (it % pairs) * 2;
    const T* b0p = Bt + (long)n * ldb;
    const T* b1p = b0p + ldb;
    float acc[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i][0] = acc[i][1] = 0.f;
    for (int k = 0; k < K; k += 4) {
      float a[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (r0 + i < rows) {
          load4(A + (long)(r0 + i) * lda + k, a[i]);
        } else {
          a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
        }
      }
      float b0[4], b1[4];
      load4(b0p + k, b0);
      load4(b1p + k, b1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][0] = fmaf(a[i][kk], b0[kk], acc[i][0]);
          acc[i][1] = fmaf(a[i][kk], b1[kk], acc[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) epi(r0 + i, n, acc[i][0], acc[i][1]);
  }
}

// Dropout keep bit of token row `grow` (over all items) and column `col`:
// the murmur3 finalizer of the JAX package's interpret-mode mask
// (_interp_dropout_bits), keyed on (seed + block, row within the block,
// col) with blocks of `block_rows` token rows, so forward and backward
// regenerate the same mask and it equals host_dropout_keep bit for bit.
// uint32 arithmetic wraps as the hash needs.
__device__ __forceinline__ bool dropout_keep(unsigned seed, int block_rows, long grow, int col,
                                             unsigned threshold) {
  const unsigned blk = (unsigned)(grow / block_rows), row = (unsigned)(grow % block_rows);
  unsigned v = (row * 0x9E3779B1u) ^ ((unsigned)col * 0x85EBCA77u) ^ ((seed + blk) * 0xC2B2AE3Du);
  v ^= v >> 16;
  v *= 0x85EBCA6Bu;
  v ^= v >> 13;
  v *= 0xC2B2AE35u;
  v ^= v >> 16;
  return v >= threshold;
}

// Inverted dropout of one projected value: kept values scaled by
// keep_scale = 1 / (1 - rate), dropped ones 0; rate 0 passes v through.
__device__ __forceinline__ float dropout(float v, unsigned seed, int block_rows, long grow,
                                         int col, unsigned threshold, float keep_scale) {
  if (threshold == 0u && keep_scale == 1.f) return v;
  return dropout_keep(seed, block_rows, grow, col, threshold) ? v * keep_scale : 0.f;
}

}  // namespace
