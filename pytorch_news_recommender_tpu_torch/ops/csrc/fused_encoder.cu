// Fused NRMS news encoder, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_encoder_kernel` (called through
// `fused_news_encoder`) in the JAX package's ops/pallas/fused_encoder.py,
// for serving: no dropout, no saved attention output.
//
// What it computes, per news item m of x [M, L, D] with token mask [M, L]:
//   qkv = x @ Wqkv + bqkv                        (f32 accumulation)
//   q  *= 1/sqrt(dh); q, k, v rounded to T       (T = input dtype)
//   per head: s = q k^T + (mask_i * mask_j - 1) * 1e9
//             e = exp(s - rowmax) rounded to T, o1 = (e @ v) / rowsum(e)
//   o1 rounded to T; o2 = o1 @ Wo + bo           (f32)
//   a = tanh(T(o2) @ aw + ab) @ aq, masked to -1e9, softmax over the item
//   out = sum_l w_l o2_l, 0 for an item with no real token, rounded to T
// These are the TPU kernel's rounding points, so bf16 results stay close to
// it. Its pooling softmax shifts by one max over a whole block of items;
// here the shift is each item's own max, which gives the same result and
// cannot underflow a whole item.
//
// Layout. One block of 256 threads per news item; the item's rows stay in
// shared memory from the first product to the pooled output, and the
// weights (0.84 MB in bf16 at D=300, Q=200) are read through L2 by every
// block. The TPU kernel's packing of several items into one block-diagonal
// attention tile exists for the TPU's 128x128 matrix unit and is not
// carried over. The three projections run as a shared-memory x global
// product in which each thread owns 4 rows x 2 adjacent columns and walks K
// in steps of 4 (one 16-byte shared load per row per step); attention runs
// head by head, so only one head's q, k, v ([L, dh] each) are staged.
//
// Bound. At L=20 an item needs 2*L*D*(3D+D+Q) + 4*H*L^2*dh = 17.3 MFLOP
// and moves 12 KB (bf16 tokens in, one vector out), so the work is bound by
// operations: 1.13 TFLOP for a 65,238-news corpus. This first version runs
// on the CUDA cores in f32 (odd widths: D=300, dh=30, Q=200 fit no tensor
// core tile without padding); wgmma with zero-padded tiles is the next step.

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Floats of shared memory one block uses; the carve-up is in the kernel.
__host__ __device__ inline long smem_floats(int L, int D, int H, int Q) {
  const int Rp = round4(L), W1 = round4(D > Q ? D : Q), dh = D / H;
  return (long)Rp * D + (long)Rp * W1 + 3L * Rp * dh + (long)L * L + 3L * Rp;
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_encoder_fwd_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                         const T* __restrict__ wqkv, const T* __restrict__ bqkv,
                         const T* __restrict__ wo, const T* __restrict__ bo,
                         const T* __restrict__ aw, const T* __restrict__ ab,
                         const T* __restrict__ aq, T* __restrict__ out,
                         int L, int D, int H, int Q, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int Rp = round4(L), W1 = round4(D > Q ? D : Q), dh = D / H;
  float* xs = smem;               // [Rp, D]  tokens; later o2 (f32)
  float* o1 = xs + Rp * D;        // [Rp, W1] attention output; later tanh(.) * aq
  float* qh = o1 + Rp * W1;       // [Rp, dh] one head's q, k, v (T-rounded)
  float* kh = qh + Rp * dh;
  float* vh = kh + Rp * dh;
  float* sc = vh + Rp * dh;       // [L, L]   scores, then T-rounded exp
  float* rs = sc + L * L;         // [Rp]     softmax row sums
  float* mk = rs + Rp;            // [Rp]     token mask
  float* pw = mk + Rp;            // [Rp]     pooling logits, then weights

  const int m = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const T* xm = x + (long)m * L * D;
  for (int i = tid; i < Rp * D; i += blockDim.x) xs[i] = i < L * D ? to_f(xm[i]) : 0.f;
  for (int i = tid; i < Rp * W1; i += blockDim.x) o1[i] = 0.f;
  for (int i = tid; i < Rp; i += blockDim.x) mk[i] = i < L ? mask[(long)m * L + i] : 0.f;
  __syncthreads();

  for (int h = 0; h < H; ++h) {
    // q | k | v of head h: output column n is column (n / dh) * D + h * dh + n % dh
    block_product<T, false>(
        xs, D, Rp, D, wqkv, 3 * D, 3 * dh,
        [=](int n) { return (n / dh) * D + h * dh + n % dh; },
        [=](int r, int n, float a0, float a1) {
          const int seg = n / dh, d = n % dh, c = seg * D + h * dh + d;
          float v0 = a0 + to_f(bqkv[c]), v1 = a1 + to_f(bqkv[c + 1]);
          if (seg == 0) { v0 *= scale; v1 *= scale; }
          float* dst = seg == 0 ? qh : (seg == 1 ? kh : vh);
          dst[r * dh + d] = rnd<T>(v0);
          dst[r * dh + d + 1] = rnd<T>(v1);
        });
    __syncthreads();
    for (int e = tid; e < L * L; e += blockDim.x) {
      const int i = e / L, j = e % L;
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qh[i * dh + d], kh[j * dh + d], s);
      sc[e] = s + (mk[i] * mk[j] - 1.f) * 1e9f;
    }
    __syncthreads();
    for (int i = warp; i < L; i += nwarps) {
      float mx = -INFINITY;
      for (int j = lane; j < L; j += 32) mx = fmaxf(mx, sc[i * L + j]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < L; j += 32) {
        const float e = expf(sc[i * L + j] - mx);
        sum += e;
        sc[i * L + j] = rnd<T>(e);
      }
      sum = warp_sum(sum);
      if (lane == 0) rs[i] = sum;
    }
    __syncthreads();
    for (int e = tid; e < L * dh; e += blockDim.x) {
      const int i = e / dh, d = e % dh;
      float acc = 0.f;
      for (int j = 0; j < L; ++j) acc = fmaf(sc[i * L + j], vh[j * dh + d], acc);
      o1[i * W1 + h * dh + d] = rnd<T>(acc / rs[i]);
    }
    __syncthreads();
  }

  // o2 = o1 @ Wo + bo, kept in f32 (the tokens are no longer needed)
  block_product<T, false>(
      o1, W1, Rp, D, wo, D, D, [](int n) { return n; },
      [=](int r, int n, float a0, float a1) {
        xs[r * D + n] = a0 + to_f(bo[n]);
        xs[r * D + n + 1] = a1 + to_f(bo[n + 1]);
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
    out[(long)m * D + d] = from_f<T>(num / rs[0]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* mask, const void* wqkv, const void* bqkv,
                   const void* wo, const void* bo, const void* aw, const void* ab,
                   const void* aq, void* out, int M, int L, int D, int H, int Q, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(L, D, H, Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_encoder_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_encoder_fwd_kernel<T><<<M, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mask), static_cast<const T*>(wqkv),
      static_cast<const T*>(bqkv), static_cast<const T*>(wo), static_cast<const T*>(bo),
      static_cast<const T*>(aw), static_cast<const T*>(ab), static_cast<const T*>(aq),
      static_cast<T*>(out), L, D, H, Q, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, weights and out); mask is float32.
// All operands contiguous on one device. Returns a cudaError_t code.
int newsrec_fused_encoder_fwd(int dtype, const void* x, const void* mask, const void* wqkv,
                              const void* bqkv, const void* wo, const void* bo, const void* aw,
                              const void* ab, const void* aq, void* out, int M, int L, int D,
                              int H, int Q, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, mask, wqkv, bqkv, wo, bo, aw, ab, aq, out, M, L, D, H, Q, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, mask, wqkv, bqkv, wo, bo, aw, ab, aq, out, M, L, D, H, Q,
                                 scale, s);
  return cudaErrorInvalidValue;
}

long newsrec_fused_encoder_smem_bytes(int L, int D, int H, int Q) {
  return smem_floats(L, D, H, Q) * (long)sizeof(float);
}

const char* newsrec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
