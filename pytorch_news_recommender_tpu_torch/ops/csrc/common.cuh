// Helpers shared by the fused encoder's forward (fused_encoder.cu),
// backward (fused_encoder_bwd.cu) and stage ablation (ablate_encoder.cu)
// kernels: type conversion at the TPU kernel's rounding points, warp
// reductions, the block-level products the kernels are built from, the
// dropout hash, and the forward's staging of an item and its pooling tail.

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

// Stages the L token rows of one news item (token rows row0 .. row0 + L - 1
// of x [*, D]) into xs ([round4(L), D] f32, the padding rows zeroed) and
// their mask into mk ([round4(L)]).
template <typename T>
__device__ __forceinline__ void stage_item(const T* __restrict__ x, const float* __restrict__ mask,
                                           long row0, int L, int D, float* xs, float* mk) {
  const int Rp = round4(L);
  const T* xm = x + row0 * D;
  for (int i = threadIdx.x; i < Rp * D; i += blockDim.x) xs[i] = i < L * D ? to_f(xm[i]) : 0.f;
  for (int i = threadIdx.x; i < Rp; i += blockDim.x) mk[i] = i < L ? mask[row0 + i] : 0.f;
}

// The encoder's tail for one news item, from the heads' output o1 ([Rp,
// W1] in shared memory, Rp = round4(L), W1 = round4(max(D, Q))):
//   o2 = o1 @ Wo + bo in f32, inverted dropout on the real rows, over xs
//   a = tanh(T(o2) @ aw + ab) @ aq, masked to -1e9, softmax over the item
//   out = sum_l w_l o2_l / max(sum_l w_l, 1e-30), rounded to T
// The softmax shifts by the item's own max (the TPU kernel shifts by one max
// over a block of items: the same result, and no item can underflow whole),
// so an item with no real token pools to 0. o1 is overwritten; mk holds the
// mask, pw ([Rp]) and rs ([1]) are scratch. Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void pool_tail(float* xs, float* o1, const float* mk, float* pw,
                                          float* rs, const T* __restrict__ wo,
                                          const T* __restrict__ bo, const T* __restrict__ aw,
                                          const T* __restrict__ ab, const T* __restrict__ aq,
                                          T* __restrict__ out, int L, int D, int Q, long row0,
                                          unsigned seed, int block_rows, unsigned threshold,
                                          float keep_scale) {
  const int Rp = round4(L), W1 = round4(D > Q ? D : Q);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  // o2 = o1 @ Wo + bo, kept in f32 (the tokens are no longer needed), then
  // inverted dropout on the item's real rows
  block_product<T, false>(
      o1, W1, Rp, D, wo, D, D, [](int n) { return n; },
      [=](int r, int n, float a0, float a1) {
        float v0 = a0 + to_f(bo[n]), v1 = a1 + to_f(bo[n + 1]);
        if (r < L) {
          v0 = dropout(v0, seed, block_rows, row0 + r, n, threshold, keep_scale);
          v1 = dropout(v1, seed, block_rows, row0 + r, n + 1, threshold, keep_scale);
        }
        xs[r * D + n] = v0;
        xs[r * D + n + 1] = v1;
      });
  __syncthreads();
  // tanh(T(o2) @ aw + ab) * aq, summed per row below
  block_product<T, true>(
      xs, D, Rp, D, aw, Q, Q, [](int n) { return n; },
      [=](int r, int n, float a0, float a1) {
        o1[r * W1 + n] = tanhf(a0 + to_f(ab[n])) * to_f(aq[n]);
        o1[r * W1 + n + 1] = tanhf(a1 + to_f(ab[n + 1])) * to_f(aq[n + 1]);
      });
  __syncthreads();
  for (int i = warp; i < L; i += nwarps) {
    float s = 0.f;
    for (int q = lane; q < Q; q += 32) s += o1[i * W1 + q];
    s = warp_sum(s);
    if (lane == 0) pw[i] = mk[i] > 0.f ? s : -1e9f;
  }
  __syncthreads();
  if (warp == 0) {
    float mx = -INFINITY;
    for (int i = lane; i < L; i += 32) mx = fmaxf(mx, pw[i]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int i = lane; i < L; i += 32) {
      const float e = mk[i] > 0.f ? expf(pw[i] - mx) : 0.f;
      pw[i] = e;
      den += e;
    }
    den = warp_sum(den);
    if (lane == 0) rs[0] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  for (int d = tid; d < D; d += blockDim.x) {
    float num = 0.f;
    for (int i = 0; i < L; ++i) num = fmaf(pw[i], xs[i * D + d], num);
    out[d] = from_f<T>(num / rs[0]);
  }
}

}  // namespace
