// Fused NRMS news encoder, backward, and the weight-gradient reduction, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_encoder_bwd_kernel` (called through
// `_bwd_pallas_call`) in the JAX package's ops/pallas/fused_encoder.py. From
// the forward's o1 residual it recomputes o2, regenerates the dropout mask
// (common.cuh), recomputes q, k, v and the attention probabilities, and
// emits dx and the gradients of Wqkv, bqkv, Wo, bo, aw, ab, aq, with the TPU
// kernel's rounding points: q, k, v and dO1 staged in T (the input dtype),
// the probabilities rounded to T before dV, dS rounded to T, q pre-scaled
// (dq times scale, dk from the scaled q), o2, t, dpre and the pooling terms
// in f32, dx rounded to T, the weight gradients in f32.
//
// Layout. A [L, D] item fits in shared memory, but x, qkv, o2, dqkv and t
// together do not (about 520 KB in f32 at L=50), so the backward runs as
// three kernels of one 256-thread block per item, with the per-token
// intermediates in device memory (L2 serves each item's rows):
//   pool_bwd:  o2 = o1 Wo + bo (dropout), t = tanh(T(o2) aw + ab), pooling
//              weights, d(logit), dpre, do2 = w g + dpre aw^T (dropout),
//              do1 = T(do2 Wo^T); writes o2, t, dpre, do2, d(logit), do1.
//   attn_bwd:  per head, q/k/v recomputed from x, probabilities, dV, dP,
//              dS, dQ, dK; writes dqkv.
//   dx:        dx = T(dqkv Wqkv^T).
// The TPU kernel adds each grid step's weight gradients into one output
// block, which is right only because a TPU grid runs in order. Here they
// are products over all M*L token rows (dWqkv = x^T dqkv, dWo = o1^T do2,
// daw = o2^T dpre, daq = t^T d(logit), and the bias column sums), computed
// by weight_grad: a split-K kernel over a fixed partition of the rows into
// per-split partial tiles, then a sum of the partials in a fixed order, so
// the result is the same on every run.
//
// Bound. Per item about 6*L*D*(3D+D+Q) + 10*H*L^2*dh FLOP (the forward's
// projections twice more, for the input and the weight gradients, and the
// attention products), 51.6 MFLOP at L=20, against a few tens of KB of
// bytes: bound by operations. Like the forward, this first version runs on
// the CUDA cores in f32.

#include "common.cuh"

namespace {

constexpr int kWgTile = 64;  // weight_grad: output tile (64 x 64)
constexpr int kWgRows = 16;  // weight_grad: token rows staged per step

__host__ __device__ inline long pool_smem_floats(int L, int D, int Q) {
  const int Rp = round4(L);
  return 2L * Rp * D + (long)Rp * round4(Q) + D + 4L * Rp;
}

__host__ __device__ inline long attn_smem_floats(int L, int D, int H) {
  const int Rp = round4(L), dh = D / H;
  return (long)Rp * D + 4L * Rp * dh + 2L * L * L + Rp;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_bwd_kernel(const float* __restrict__ g, const float* __restrict__ mask,
                const T* __restrict__ o1, const T* __restrict__ wo, const T* __restrict__ bo,
                const T* __restrict__ aw, const T* __restrict__ ab, const T* __restrict__ aq,
                float* __restrict__ o2_g, float* __restrict__ t_g, float* __restrict__ dpre_g,
                float* __restrict__ do2_g, float* __restrict__ ds_g, T* __restrict__ do1_g,
                int L, int D, int Q, unsigned seed, int block_rows, unsigned threshold,
                float keep_scale) {
  extern __shared__ __align__(16) float smem[];
  const int Rp = round4(L), Qp = round4(Q);
  float* as = smem;               // [Rp, D]  o1, later do2
  float* o2s = as + Rp * D;       // [Rp, D]  o2 after dropout
  float* ts = o2s + Rp * D;       // [Rp, Qp] tanh(.), later dpre
  float* gs = ts + Rp * Qp;       // [D]      this item's cotangent
  float* mk = gs + D;             // [Rp]     token mask
  float* pw = mk + Rp;            // [Rp]     pooling logits, later weights w
  float* dwf = pw + Rp;           // [Rp]     o2 . g per row
  float* ds = dwf + Rp;           // [Rp]     d(pooling logit)

  const int m = blockIdx.x;
  const long row0 = (long)m * L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  for (int i = tid; i < Rp * D; i += blockDim.x) as[i] = i < L * D ? to_f(o1[row0 * D + i]) : 0.f;
  for (int i = tid; i < D; i += blockDim.x) gs[i] = g[(long)m * D + i];
  for (int i = tid; i < Rp; i += blockDim.x) mk[i] = i < L ? mask[row0 + i] : 0.f;
  __syncthreads();

  // o2 = o1 @ Wo + bo, then dropout
  block_product<T, false>(
      as, D, Rp, D, wo, D, D, [](int n) { return n; },
      [=](int r, int n, float a0, float a1) {
        float v0 = a0 + to_f(bo[n]), v1 = a1 + to_f(bo[n + 1]);
        if (r < L) {
          v0 = dropout(v0, seed, block_rows, row0 + r, n, threshold, keep_scale);
          v1 = dropout(v1, seed, block_rows, row0 + r, n + 1, threshold, keep_scale);
          o2_g[(row0 + r) * D + n] = v0;
          o2_g[(row0 + r) * D + n + 1] = v1;
        }
        o2s[r * D + n] = v0;
        o2s[r * D + n + 1] = v1;
      });
  __syncthreads();
  // t = tanh(T(o2) @ aw + ab)
  block_product<T, true>(
      o2s, D, Rp, D, aw, Q, Q, [](int n) { return n; },
      [=](int r, int n, float a0, float a1) {
        const float t0 = tanhf(a0 + to_f(ab[n])), t1 = tanhf(a1 + to_f(ab[n + 1]));
        ts[r * Qp + n] = t0;
        ts[r * Qp + n + 1] = t1;
        if (r < L) {
          t_g[(row0 + r) * Q + n] = t0;
          t_g[(row0 + r) * Q + n + 1] = t1;
        }
      });
  __syncthreads();
  // pooling logits t . aq and o2 . g, one warp per row
  for (int i = warp; i < L; i += nwarps) {
    float s = 0.f, dw = 0.f;
    for (int q = lane; q < Q; q += 32) s = fmaf(ts[i * Qp + q], to_f(aq[q]), s);
    for (int d = lane; d < D; d += 32) dw = fmaf(o2s[i * D + d], gs[d], dw);
    s = warp_sum(s);
    dw = warp_sum(dw);
    if (lane == 0) {
      pw[i] = mk[i] > 0.f ? s : -1e9f;
      dwf[i] = dw;
    }
  }
  __syncthreads();
  // softmax over the item, w = e / max(sum e, 1e-30) (0 for an all-pad
  // item), d(logit) = w (o2.g - sum_l w o2.g)
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
    den = fmaxf(warp_sum(den), 1e-30f);
    float ip = 0.f;
    for (int i = lane; i < L; i += 32) {
      pw[i] = pw[i] / den;
      ip += pw[i] * dwf[i];
    }
    ip = warp_sum(ip);
    for (int i = lane; i < Rp; i += 32) {
      if (i < L) {
        ds[i] = pw[i] * (dwf[i] - ip);
      } else {
        pw[i] = 0.f;
        ds[i] = 0.f;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < L; i += blockDim.x) ds_g[row0 + i] = ds[i];
  // dpre = d(logit) aq (1 - t^2)
  for (int e = tid; e < Rp * Q; e += blockDim.x) {
    const int r = e / Q, q = e % Q;
    const float t = ts[r * Qp + q];
    const float v = r < L ? (ds[r] * to_f(aq[q])) * (1.f - t * t) : 0.f;
    ts[r * Qp + q] = v;
    if (r < L) dpre_g[(row0 + r) * Q + q] = v;
  }
  __syncthreads();
  // do2 = w g + dpre @ aw^T, then the dropout scale (o1 is no longer needed)
  block_product_t<T>(
      ts, Qp, Rp, Rp, Q, aw, Q, D,
      [=](int r, int n, float a0, float a1) {
        float v0 = 0.f, v1 = 0.f;
        if (r < L) {
          v0 = dropout(pw[r] * gs[n] + a0, seed, block_rows, row0 + r, n, threshold,
                       keep_scale);
          v1 = dropout(pw[r] * gs[n + 1] + a1, seed, block_rows, row0 + r, n + 1, threshold,
                       keep_scale);
          do2_g[(row0 + r) * D + n] = v0;
          do2_g[(row0 + r) * D + n + 1] = v1;
        }
        as[r * D + n] = v0;
        as[r * D + n + 1] = v1;
      });
  __syncthreads();
  // do1 = T(do2 @ Wo^T)
  block_product_t<T>(
      as, D, Rp, Rp, D, wo, D, D,
      [=](int r, int n, float a0, float a1) {
        if (r < L) {
          do1_g[(row0 + r) * D + n] = from_f<T>(a0);
          do1_g[(row0 + r) * D + n + 1] = from_f<T>(a1);
        }
      });
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                const T* __restrict__ wqkv, const T* __restrict__ bqkv,
                const T* __restrict__ do1_g, float* __restrict__ dqkv_g, int L, int D, int H,
                float scale) {
  extern __shared__ __align__(16) float smem[];
  const int Rp = round4(L), dh = D / H;
  float* xs = smem;               // [Rp, D]  tokens
  float* qh = xs + Rp * D;        // [Rp, dh] one head's q, k, v, dO1 (T-rounded)
  float* kh = qh + Rp * dh;
  float* vh = kh + Rp * dh;
  float* gh = vh + Rp * dh;
  float* pr = gh + Rp * dh;       // [L, L]   probabilities (f32)
  float* sd = pr + L * L;         // [L, L]   dP, then T(dS)
  float* mk = sd + L * L;         // [Rp]     token mask

  const int m = blockIdx.x;
  const long row0 = (long)m * L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const long ld = 3L * D;
  for (int i = tid; i < Rp * D; i += blockDim.x) xs[i] = i < L * D ? to_f(x[row0 * D + i]) : 0.f;
  for (int i = tid; i < Rp; i += blockDim.x) mk[i] = i < L ? mask[row0 + i] : 0.f;
  __syncthreads();

  for (int h = 0; h < H; ++h) {
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
    for (int e = tid; e < Rp * dh; e += blockDim.x) {
      const int r = e / dh, d = e % dh;
      gh[e] = r < L ? to_f(do1_g[(row0 + r) * D + h * dh + d]) : 0.f;
    }
    __syncthreads();
    // scores and dP = dO1 v^T
    for (int e = tid; e < L * L; e += blockDim.x) {
      const int i = e / L, j = e % L;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < dh; ++d) {
        s = fmaf(qh[i * dh + d], kh[j * dh + d], s);
        dp = fmaf(gh[i * dh + d], vh[j * dh + d], dp);
      }
      pr[e] = s + (mk[i] * mk[j] - 1.f) * 1e9f;
      sd[e] = dp;
    }
    __syncthreads();
    // probabilities, then dS = T(P dP - P sum_j(P dP)), one warp per row
    for (int i = warp; i < L; i += nwarps) {
      float mx = -INFINITY;
      for (int j = lane; j < L; j += 32) mx = fmaxf(mx, pr[i * L + j]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < L; j += 32) {
        const float e = expf(pr[i * L + j] - mx);
        pr[i * L + j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      float rsum = 0.f;
      for (int j = lane; j < L; j += 32) {
        const float p = pr[i * L + j] / sum;
        pr[i * L + j] = p;
        sd[i * L + j] = p * sd[i * L + j];
        rsum += sd[i * L + j];
      }
      rsum = warp_sum(rsum);
      for (int j = lane; j < L; j += 32)
        sd[i * L + j] = rnd<T>(sd[i * L + j] - pr[i * L + j] * rsum);
    }
    __syncthreads();
    // dq = dS k * scale, dk = dS^T q, dv = T(P)^T dO1
    for (int e = tid; e < L * dh; e += blockDim.x) {
      const int i = e / dh, d = e % dh;
      float dq = 0.f, dk = 0.f, dv = 0.f;
      for (int j = 0; j < L; ++j) {
        dq = fmaf(sd[i * L + j], kh[j * dh + d], dq);
        dk = fmaf(sd[j * L + i], qh[j * dh + d], dk);
        dv = fmaf(rnd<T>(pr[j * L + i]), gh[j * dh + d], dv);
      }
      float* out = dqkv_g + (row0 + i) * ld + h * dh + d;
      out[0] = dq * scale;
      out[D] = dk;
      out[2 * D] = dv;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dx_kernel(const float* __restrict__ dqkv_g, const T* __restrict__ wqkv, T* __restrict__ dx,
          int L, int D) {
  const long row0 = (long)blockIdx.x * L;
  block_product_t<T>(
      dqkv_g + row0 * 3 * D, 3 * D, round4(L), L, 3 * D, wqkv, 3 * D, D,
      [=](int r, int n, float a0, float a1) {
        if (r < L) {
          dx[(row0 + r) * D + n] = from_f<T>(a0);
          dx[(row0 + r) * D + n + 1] = from_f<T>(a1);
        }
      });
}

// partial[s][k][n] = sum over split s's rows r of A[r][k] * B[r][n] (A null:
// a column of ones, K = 1). 256 threads own a 64 x 64 tile, 4 x 4 each.
template <typename TA>
__global__ void __launch_bounds__(kThreads)
weight_grad_partial_kernel(const TA* __restrict__ A, int lda, const float* __restrict__ B,
                           int ldb, int R, int K, int N, int rows_per_split,
                           float* __restrict__ partial) {
  __shared__ __align__(16) float as[kWgRows][kWgTile];
  __shared__ __align__(16) float bs[kWgRows][kWgTile];
  const int n0 = blockIdx.x * kWgTile, k0 = blockIdx.y * kWgTile, s = blockIdx.z;
  const long r_begin = (long)s * rows_per_split;
  const long r_end = r_begin + rows_per_split < R ? r_begin + rows_per_split : R;
  const int tn = threadIdx.x % 16, tk = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (long r0 = r_begin; r0 < r_end; r0 += kWgRows) {
    for (int i = threadIdx.x; i < kWgRows * kWgTile; i += blockDim.x) {
      const int rr = i / kWgTile, c = i % kWgTile;
      const long r = r0 + rr;
      const bool in = r < r_end;
      as[rr][c] = (in && k0 + c < K) ? (A != nullptr ? to_f(A[r * lda + k0 + c]) : 1.f) : 0.f;
      bs[rr][c] = (in && n0 + c < N) ? B[r * ldb + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kWgRows; ++rr) {
      float a[4], b[4];
      load4(&as[rr][tk * 4], a);
      load4(&bs[rr][tn * 4], b);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + tk * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (k < K && n < N) partial[((long)s * K + k) * N + n] = acc[i][j];
    }
  }
}

// out[i] = sum_s partial[s][i], s in order
__global__ void weight_grad_reduce_kernel(const float* __restrict__ partial, int splits, long kn,
                                          float* __restrict__ out) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < kn;
       i += (long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += partial[p * kn + i];
    out[i] = s;
  }
}

int weight_grad_splits(int R) {
  const int s = (R + 4095) / 4096;
  return s < 1 ? 1 : (s > 64 ? 64 : s);
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* x, const void* mask, const void* o1,
                       const void* wqkv, const void* bqkv, const void* wo, const void* bo,
                       const void* aw, const void* ab, const void* aq, void* dx, void* o2_s,
                       void* t_s, void* dpre_s, void* do2_s, void* ds_s, void* dqkv_s,
                       void* do1_s, int M, int L, int D, int H, int Q, float scale,
                       unsigned seed, int block_rows, unsigned threshold, float keep_scale,
                       cudaStream_t stream) {
  const size_t pool_smem = pool_smem_floats(L, D, Q) * sizeof(float);
  const size_t attn_smem = attn_smem_floats(L, D, H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(pool_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)pool_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)attn_smem);
  if (err != cudaSuccess) return err;
  pool_bwd_kernel<T><<<M, kThreads, pool_smem, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(mask),
      static_cast<const T*>(o1), static_cast<const T*>(wo), static_cast<const T*>(bo),
      static_cast<const T*>(aw), static_cast<const T*>(ab), static_cast<const T*>(aq),
      static_cast<float*>(o2_s), static_cast<float*>(t_s), static_cast<float*>(dpre_s),
      static_cast<float*>(do2_s), static_cast<float*>(ds_s), static_cast<T*>(do1_s), L, D, Q,
      seed, block_rows, threshold, keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_kernel<T><<<M, kThreads, attn_smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mask), static_cast<const T*>(wqkv),
      static_cast<const T*>(bqkv), static_cast<const T*>(do1_s), static_cast<float*>(dqkv_s),
      L, D, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dx_kernel<T><<<M, kThreads, 0, stream>>>(static_cast<const float*>(dqkv_s),
                                           static_cast<const T*>(wqkv), static_cast<T*>(dx),
                                           L, D);
  return cudaGetLastError();
}

template <typename TA>
cudaError_t launch_weight_grad(const void* a, int lda, const void* b, int ldb, int R, int K,
                               int N, void* partial, void* out, cudaStream_t stream) {
  const int splits = weight_grad_splits(R);
  int rows = (R + splits - 1) / splits;
  rows = (rows + kWgRows - 1) / kWgRows * kWgRows;
  const dim3 grid((N + kWgTile - 1) / kWgTile, (K + kWgTile - 1) / kWgTile, splits);
  weight_grad_partial_kernel<TA><<<grid, kThreads, 0, stream>>>(
      static_cast<const TA*>(a), lda, static_cast<const float*>(b), ldb, R, K, N, rows,
      static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long kn = (long)K * N;
  const int blocks = (int)((kn + kThreads - 1) / kThreads < 4096 ? (kn + kThreads - 1) / kThreads
                                                                  : 4096);
  weight_grad_reduce_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(partial), splits, kn, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, o1, weights, dx, do1_s); g, mask and
// the scratch buffers (o2_s [M*L, D], t_s and dpre_s [M*L, Q], do2_s
// [M*L, D], ds_s [M*L], dqkv_s [M*L, 3D]) are float32. Dropout arguments as
// for newsrec_fused_encoder_fwd, and equal to the forward's. All operands
// contiguous on one device. Returns a cudaError_t code.
int newsrec_fused_encoder_bwd(int dtype, const void* g, const void* x, const void* mask,
                              const void* o1, const void* wqkv, const void* bqkv, const void* wo,
                              const void* bo, const void* aw, const void* ab, const void* aq,
                              void* dx, void* o2_s, void* t_s, void* dpre_s, void* do2_s,
                              void* ds_s, void* dqkv_s, void* do1_s, int M, int L, int D, int H,
                              int Q, float scale, unsigned seed, int block_rows,
                              unsigned threshold, float keep_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(g, x, mask, o1, wqkv, bqkv, wo, bo, aw, ab, aq, dx, o2_s, t_s,
                             dpre_s, do2_s, ds_s, dqkv_s, do1_s, M, L, D, H, Q, scale, seed,
                             block_rows, threshold, keep_scale, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(g, x, mask, o1, wqkv, bqkv, wo, bo, aw, ab, aq, dx, o2_s,
                                     t_s, dpre_s, do2_s, ds_s, dqkv_s, do1_s, M, L, D, H, Q,
                                     scale, seed, block_rows, threshold, keep_scale, s);
  return cudaErrorInvalidValue;
}

long newsrec_fused_encoder_bwd_smem_bytes(int L, int D, int H, int Q) {
  const long p = pool_smem_floats(L, D, Q), a = attn_smem_floats(L, D, H);
  return (p > a ? p : a) * (long)sizeof(float);
}

int newsrec_weight_grad_splits(int R) { return weight_grad_splits(R); }

// out [K, N] = a^T b over R rows (a [R, K] with row stride lda, dtype 0 =
// float32, 1 = bfloat16, -1 = no a: column sums of b, K = 1); b [R, N]
// float32 with row stride ldb; partial holds newsrec_weight_grad_splits(R)
// x K x N floats. Returns a cudaError_t code.
int newsrec_weight_grad(int a_dtype, const void* a, int lda, const void* b, int ldb, int R,
                        int K, int N, void* partial, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == 0 || a_dtype == -1)
    return launch_weight_grad<float>(a_dtype == 0 ? a : nullptr, lda, b, ldb, R, K, N,
                                     partial, out, s);
  if (a_dtype == 1)
    return launch_weight_grad<__nv_bfloat16>(a, lda, b, ldb, R, K, N, partial, out, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
