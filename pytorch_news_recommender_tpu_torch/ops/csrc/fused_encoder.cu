// Fused NRMS news encoder, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_encoder_kernel` (called through
// `fused_news_encoder`) in the JAX package's ops/pallas/fused_encoder.py,
// with its in-kernel inverted dropout and its optional o1 residual.
//
// What it computes, per news item m of x [M, L, D] with token mask [M, L]:
//   qkv = x @ Wqkv + bqkv                        (f32 accumulation)
//   q  *= 1/sqrt(dh); q, k, v rounded to T       (T = input dtype)
//   per head: s = q k^T + (mask_i * mask_j - 1) * 1e9
//             e = exp(s - rowmax) rounded to T, o1 = (e @ v) / rowsum(e)
//   o1 rounded to T (written out when asked: the backward's residual)
//   o2 = o1 @ Wo + bo                            (f32)
//   training: o2 = keep ? o2 / (1 - rate) : 0, the hashed mask of common.cuh
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

#include "common.cuh"

namespace {

// Floats of shared memory one block uses; the carve-up is in the kernel.
__host__ __device__ inline long smem_floats(int L, int D, int H, int Q) {
  const int Rp = round4(L), W1 = round4(D > Q ? D : Q), dh = D / H;
  return (long)Rp * D + (long)Rp * W1 + 3L * Rp * dh + (long)L * L + 3L * Rp;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_encoder_fwd_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                         const T* __restrict__ wqkv, const T* __restrict__ bqkv,
                         const T* __restrict__ wo, const T* __restrict__ bo,
                         const T* __restrict__ aw, const T* __restrict__ ab,
                         const T* __restrict__ aq, T* __restrict__ out, T* __restrict__ o1_out,
                         int L, int D, int H, int Q, float scale, unsigned seed,
                         int block_rows, unsigned threshold, float keep_scale) {
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
  const long row0 = (long)m * L;  // first token row of the item
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  stage_item(x, mask, row0, L, D, xs, mk);
  for (int i = tid; i < Rp * W1; i += blockDim.x) o1[i] = 0.f;
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
  if (o1_out != nullptr) {
    for (int e = tid; e < L * D; e += blockDim.x)
      o1_out[row0 * D + e] = from_f<T>(o1[(e / D) * W1 + e % D]);
  }
  pool_tail(xs, o1, mk, pw, rs, wo, bo, aw, ab, aq, out + (long)m * D, L, D, Q, row0, seed,
            block_rows, threshold, keep_scale);
}

template <typename T>
cudaError_t launch(const void* x, const void* mask, const void* wqkv, const void* bqkv,
                   const void* wo, const void* bo, const void* aw, const void* ab,
                   const void* aq, void* out, void* o1, int M, int L, int D, int H, int Q,
                   float scale, unsigned seed, int block_rows, unsigned threshold,
                   float keep_scale, cudaStream_t stream) {
  const size_t smem = smem_floats(L, D, H, Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_encoder_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_encoder_fwd_kernel<T><<<M, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mask), static_cast<const T*>(wqkv),
      static_cast<const T*>(bqkv), static_cast<const T*>(wo), static_cast<const T*>(bo),
      static_cast<const T*>(aw), static_cast<const T*>(ab), static_cast<const T*>(aq),
      static_cast<T*>(out), static_cast<T*>(o1), L, D, H, Q, scale, seed, block_rows,
      threshold, keep_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, weights, out and o1); mask is
// float32. o1 may be null (no residual written). Dropout: seed, token rows
// per hash block, threshold = rate * 2^32, keep_scale = 1 / (1 - rate);
// threshold 0 and keep_scale 1 mean no dropout. All operands contiguous on
// one device. Returns a cudaError_t code.
int newsrec_fused_encoder_fwd(int dtype, const void* x, const void* mask, const void* wqkv,
                              const void* bqkv, const void* wo, const void* bo, const void* aw,
                              const void* ab, const void* aq, void* out, void* o1, int M, int L,
                              int D, int H, int Q, float scale, unsigned seed, int block_rows,
                              unsigned threshold, float keep_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, mask, wqkv, bqkv, wo, bo, aw, ab, aq, out, o1, M, L, D, H, Q, scale,
                         seed, block_rows, threshold, keep_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, mask, wqkv, bqkv, wo, bo, aw, ab, aq, out, o1, M, L, D, H,
                                 Q, scale, seed, block_rows, threshold, keep_scale, s);
  return cudaErrorInvalidValue;
}

long newsrec_fused_encoder_smem_bytes(int L, int D, int H, int Q) {
  return smem_floats(L, D, H, Q) * (long)sizeof(float);
}

const char* newsrec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
