// Stage-by-stage ablation of the fused news encoder's forward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `build` of the JAX package's
// benchmarks/ablate_encoder.py:30 (its bodies k_passthrough, k_qkv, k_attn,
// k_tail, k_attn_slices, k_attn_nosoftmax): six truncations of the fused
// encoder's forward, built from the CUDA-core pieces that the first
// forward kernel used (stage_item, block_product and pool_tail of
// common.cuh, 256 threads a block, one block per item). The forward itself
// (fused_encoder.cu) now runs on the tensor cores over tiles of whole
// items, so the difference of two stages reads as what one part of that
// CUDA-core design costs, not as a part of today's forward. Inputs in the
// harness's layout: x [M*L, D], mask [M*L] f32,
// weights in x's dtype T; out [M, D] in T. qkv = x @ Wqkv + bqkv in f32,
// over all 3D columns in every stage but V0: the stages time that work, so
// k and v are computed and stored even where only q reaches the output.
//
//   V0 passthrough    out_m = T(sum_l x_l)           (a sum, mask not read)
//   V1 qkv            out_m = T(sum_l T(q_l))        (q unscaled)
//   V2a attn_slices   out_m = T(sum_l T(q_l + k_l + v_l))
//   V3 tail           o1 = T(q), then the CUDA-core tail (pool_tail) with no
//                     dropout: o2 = o1 @ Wo + bo, additive pooling
//   V2 attn           per 160-row subtile (kSub rows = 8 items at L = 20) and
//                     head: s = q_h k_h^T, where(mask_i mask_j [same item] >
//                     0, s * scale, -1e9), f32 softmax, o = p @ v_h; then
//                     out_m = T(sum_l T(o_l)). A row whose mask is 0 has
//                     every score at -1e9, so it attends uniformly over the
//                     whole subtile, across items, as in the TPU kernel.
//   V2b attn_nosoftmax per subtile and head: o = (q_h k_h^T * scale) @ v_h,
//                     no mask, no block diagonal (the subtile's items mix)
//
// Layout. V0, V1, V2a and V3 run the CUDA-core layout: one block per item,
// the item's rows staged in shared memory as f32, the projection head by
// head (3 * dh columns of Wqkv each, read through L2). V2 and V2b need the
// subtile: one block per 160 rows. For each head it stages the subtile's
// items one at a time and projects their q_h, k_h, v_h into shared memory
// ([160, dh] each, f32); then each warp takes whole items and streams their
// rows: a row's 160 scores lie in registers (5 a lane), its probabilities
// in a per-warp row buffer, lane d < dh accumulates o[d] and the item's
// T-rounded sum, so no 160 x 160 tile sits in shared memory and the item
// sums are taken in a fixed order.
//
// Bounds, at L = 20, D = 300, H = 10, Q = 200 (chip_smoke.py's
// `ablation_bound` computes them from the shapes): V0 moves x once (bytes);
// the rest are bound by operations: 2 * L * D * 3D FLOP per item for the
// projection (V1, V2a), + 4 * H * L^2 * dh for V2's attention within items,
// + two 160 x 160 x dh products per subtile and head for V2b, + 2 * L * D *
// (D + Q) for V3's Wo and aw products. These stages run on the CUDA cores
// in f32.

#include "common.cuh"

namespace {

constexpr int kSub = 160;  // rows of an attention subtile (the TPU kernel's SUB)

enum Stage : int {
  kPassthrough = 0,
  kQkv = 1,
  kAttn = 2,
  kTail = 3,
  kAttnSlices = 4,
  kAttnNoSoftmax = 5,
};

__host__ __device__ inline bool per_subtile(int stage) {
  return stage == kAttn || stage == kAttnNoSoftmax;
}

// Floats of shared memory one block of `stage` uses; the carve-ups are in
// the kernels.
__host__ __device__ inline long smem_floats(int stage, int L, int D, int H, int Q) {
  const int Rp = round4(L), W1 = round4(D > Q ? D : Q), dh = D / H, ld = dh | 1;
  if (per_subtile(stage)) return (long)Rp * D + 3L * kSub * ld + kSub + (kThreads / 32) * kSub;
  if (stage == kPassthrough) return (long)Rp * D + Rp;
  return (long)Rp * D + 3L * Rp + (long)Rp * W1 + 3L * Rp * dh;
}

// out[d] = T(sum_{l < L} src[l * ld + d]) for d < D: the TPU kernel's
// pooling by an indicator product, f32 sums
template <typename T>
__device__ __forceinline__ void sum_rows(const float* src, int ld, int L, int D,
                                         T* __restrict__ out) {
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float s = 0.f;
    for (int l = 0; l < L; ++l) s += src[l * ld + d];
    out[d] = from_f<T>(s);
  }
}

// V0, V1, V2a and V3: one block per news item.
template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
ablate_item_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                   const T* __restrict__ wqkv, const T* __restrict__ bqkv,
                   const T* __restrict__ wo, const T* __restrict__ bo, const T* __restrict__ aw,
                   const T* __restrict__ ab, const T* __restrict__ aq, T* __restrict__ out, int L,
                   int D, int H, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int Rp = round4(L), W1 = round4(D > Q ? D : Q), dh = D / H;
  float* xs = smem;             // [Rp, D]  tokens; V3: later o2 (f32)
  float* mk = xs + Rp * D;      // [Rp]     token mask
  float* pw = mk + Rp;          // [Rp]     V3: pooling logits, then weights
  float* rs = pw + Rp;          // [Rp]     V3: the pooling's denominator
  float* o1 = rs + Rp;          // [Rp, W1] heads' output stand-in (T-rounded)
  float* qh = o1 + Rp * W1;     // [Rp, dh] one head's q, k, v (f32)
  float* kh = qh + Rp * dh;
  float* vh = kh + Rp * dh;

  const int m = blockIdx.x;
  const long row0 = (long)m * L;
  T* out_m = out + (long)m * D;
  stage_item(x, mask, row0, L, D, xs, mk);
  __syncthreads();
  if (S == kPassthrough) {
    sum_rows(xs, D, L, D, out_m);
    return;
  }
  for (int i = threadIdx.x; i < Rp * W1; i += blockDim.x) o1[i] = 0.f;
  for (int h = 0; h < H; ++h) {
    // q | k | v of head h: output column n is column (n / dh) * D + h * dh + n % dh
    block_product<T, false>(
        xs, D, Rp, D, wqkv, 3 * D, 3 * dh,
        [=](int n) { return (n / dh) * D + h * dh + n % dh; },
        [=](int r, int n, float a0, float a1) {
          const int seg = n / dh, d = n % dh, c = seg * D + h * dh + d;
          float* dst = seg == 0 ? qh : (seg == 1 ? kh : vh);
          dst[r * dh + d] = a0 + to_f(bqkv[c]);
          dst[r * dh + d + 1] = a1 + to_f(bqkv[c + 1]);
        });
    __syncthreads();
    for (int e = threadIdx.x; e < L * dh; e += blockDim.x) {
      const int i = e / dh, d = e % dh;
      const float v = S == kAttnSlices ? qh[e] + kh[e] + vh[e] : qh[e];
      o1[i * W1 + h * dh + d] = rnd<T>(v);
    }
    __syncthreads();
  }
  if (S == kTail) {
    pool_tail(xs, o1, mk, pw, rs, wo, bo, aw, ab, aq, out_m, L, D, Q, row0, 0u, 1, 0u, 1.f);
  } else {
    sum_rows(o1, W1, L, D, out_m);
  }
}

// V2 (kSoftmax) and V2b: one block per kSub-row subtile.
template <typename T, bool kSoftmax>
__global__ void __launch_bounds__(kThreads)
ablate_subtile_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                      const T* __restrict__ wqkv, const T* __restrict__ bqkv,
                      T* __restrict__ out, int L, int D, int H, float scale) {
  constexpr int kPerLane = kSub / 32;
  extern __shared__ __align__(16) float smem[];
  const int Rp = round4(L), dh = D / H, ld = dh | 1;  // odd stride: no bank conflicts on k
  const int items = kSub / L, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* xs = smem;              // [Rp, D]     one item's tokens
  float* qs = xs + Rp * D;       // [kSub, ld]  the head's q, k, v over the subtile (f32)
  float* ks = qs + kSub * ld;
  float* vs = ks + kSub * ld;
  float* mk = vs + kSub * ld;    // [kSub]      token mask
  float* pb = mk + kSub;         // [nwarps, kSub] one row's probabilities per warp

  const long row0 = (long)blockIdx.x * kSub;
  for (int i = threadIdx.x; i < kSub; i += blockDim.x) mk[i] = mask[row0 + i];
  float* prow = pb + warp * kSub;
  for (int h = 0; h < H; ++h) {
    for (int g = 0; g < items; ++g) {
      const T* xg = x + (row0 + (long)g * L) * D;
      __syncthreads();
      for (int e = threadIdx.x; e < Rp * D; e += blockDim.x) xs[e] = e < L * D ? to_f(xg[e]) : 0.f;
      __syncthreads();
      block_product<T, false>(
          xs, D, Rp, D, wqkv, 3 * D, 3 * dh,
          [=](int n) { return (n / dh) * D + h * dh + n % dh; },
          [=](int r, int n, float a0, float a1) {
            if (r >= L) return;
            const int seg = n / dh, d = n % dh, c = seg * D + h * dh + d;
            float* dst = (seg == 0 ? qs : (seg == 1 ? ks : vs)) + (g * L + r) * ld;
            dst[d] = a0 + to_f(bqkv[c]);
            dst[d + 1] = a1 + to_f(bqkv[c + 1]);
          });
    }
    __syncthreads();
    for (int g = warp; g < items; g += nwarps) {
      float acc = 0.f;  // lane d < dh: the item's sum of T(o[d])
      for (int l = 0; l < L; ++l) {
        const int i = g * L + l;
        const float* q = qs + i * ld;
        float s[kPerLane];
#pragma unroll
        for (int t = 0; t < kPerLane; ++t) {
          const int j = lane + 32 * t;
          const float* k = ks + j * ld;
          float dot = 0.f;
          for (int d = 0; d < dh; ++d) dot = fmaf(q[d], k[d], dot);
          if (kSoftmax) {
            const bool pair = mk[i] * mk[j] > 0.f && j / L == g;
            s[t] = pair ? dot * scale : -1e9f;
          } else {
            s[t] = dot * scale;
          }
        }
        if (kSoftmax) {
          float mx = s[0];
#pragma unroll
          for (int t = 1; t < kPerLane; ++t) mx = fmaxf(mx, s[t]);
          mx = warp_max(mx);
          float sum = 0.f;
#pragma unroll
          for (int t = 0; t < kPerLane; ++t) {
            s[t] = expf(s[t] - mx);
            sum += s[t];
          }
          sum = warp_sum(sum);
#pragma unroll
          for (int t = 0; t < kPerLane; ++t) s[t] = s[t] / sum;
        }
#pragma unroll
        for (int t = 0; t < kPerLane; ++t) prow[lane + 32 * t] = s[t];
        __syncwarp();
        if (lane < dh) {
          float o = 0.f;
          for (int j = 0; j < kSub; ++j) o = fmaf(prow[j], vs[j * ld + lane], o);
          acc += rnd<T>(o);
        }
        __syncwarp();
      }
      if (lane < dh) out[((long)blockIdx.x * items + g) * D + h * dh + lane] = from_f<T>(acc);
    }
  }
}

template <typename Kernel, typename... Args>
cudaError_t run(Kernel kernel, long grid, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int stage, const void* xv, const float* mask, const void* wqkvv,
                   const void* bqkvv, const void* wov, const void* bov, const void* awv,
                   const void* abv, const void* aqv, void* outv, int M, int L, int D, int H, int Q,
                   float scale, cudaStream_t stream) {
  const T *x = static_cast<const T*>(xv), *wqkv = static_cast<const T*>(wqkvv),
          *bqkv = static_cast<const T*>(bqkvv), *wo = static_cast<const T*>(wov),
          *bo = static_cast<const T*>(bov), *aw = static_cast<const T*>(awv),
          *ab = static_cast<const T*>(abv), *aq = static_cast<const T*>(aqv);
  T* out = static_cast<T*>(outv);
  const size_t smem = smem_floats(stage, L, D, H, Q) * sizeof(float);
  const long subtiles = (long)M * L / kSub;
  switch (stage) {
    case kPassthrough:
      return run(ablate_item_kernel<T, kPassthrough>, M, smem, stream, x, mask, wqkv, bqkv, wo,
                 bo, aw, ab, aq, out, L, D, H, Q);
    case kQkv:
      return run(ablate_item_kernel<T, kQkv>, M, smem, stream, x, mask, wqkv, bqkv, wo, bo, aw,
                 ab, aq, out, L, D, H, Q);
    case kTail:
      return run(ablate_item_kernel<T, kTail>, M, smem, stream, x, mask, wqkv, bqkv, wo, bo, aw,
                 ab, aq, out, L, D, H, Q);
    case kAttnSlices:
      return run(ablate_item_kernel<T, kAttnSlices>, M, smem, stream, x, mask, wqkv, bqkv, wo,
                 bo, aw, ab, aq, out, L, D, H, Q);
    case kAttn:
      return run(ablate_subtile_kernel<T, true>, subtiles, smem, stream, x, mask, wqkv, bqkv,
                 out, L, D, H, scale);
    case kAttnNoSoftmax:
      return run(ablate_subtile_kernel<T, false>, subtiles, smem, stream, x, mask, wqkv, bqkv,
                 out, L, D, H, scale);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// stage: 0 passthrough, 1 qkv, 2 attn, 3 tail, 4 attn_slices, 5
// attn_nosoftmax. dtype: 0 = float32, 1 = bfloat16 (x, weights and out);
// mask is float32. The subtile stages need kSub % L == 0 and M * L % kSub ==
// 0, and a head width of at most 32. All operands contiguous on one device.
// Returns a cudaError_t code.
int newsrec_ablate_encoder(int stage, int dtype, const void* x, const void* mask,
                           const void* wqkv, const void* bqkv, const void* wo, const void* bo,
                           const void* aw, const void* ab, const void* aq, void* out, int M, int L,
                           int D, int H, int Q, float scale, void* stream) {
  if (stage < 0 || stage > kAttnNoSoftmax) return cudaErrorInvalidValue;
  if (per_subtile(stage) && (kSub % L || ((long)M * L) % kSub || D / H > 32))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (dtype == 0)
    return launch<float>(stage, x, m, wqkv, bqkv, wo, bo, aw, ab, aq, out, M, L, D, H, Q, scale,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(stage, x, m, wqkv, bqkv, wo, bo, aw, ab, aq, out, M, L, D, H, Q,
                                 scale, s);
  return cudaErrorInvalidValue;
}

long newsrec_ablate_encoder_smem_bytes(int stage, int L, int D, int H, int Q) {
  return smem_floats(stage, L, D, H, Q) * (long)sizeof(float);
}

}  // extern "C"
