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
// daw = o2^T dpre, daq = t^T d(logit)), computed by weight_grad, which also
// returns the bias gradients (the column sums of dqkv, do2, dpre) from the
// same read of b: four launches per backward call.
//
// Bound. Per item about 6*L*D*(3D+D+Q) + 10*H*L^2*dh FLOP (the forward's
// projections twice more, for the input and the weight gradients, and the
// attention products), 51.6 MFLOP at L=20, against a few tens of KB of
// bytes: bound by operations. Like the forward, the three per-item kernels
// run on the CUDA cores in f32.
//
// weight_grad: out[K+1, N] = [a | 1]^T b over R token rows, in f32 (a [R, K]
// bf16 or f32, b [R, N] f32; row K, the ones column, is b's column sums and
// is left out without the bias). Bound by bytes: at R=81,920, K=300, N=900
// it reads 344 MB (0.103 ms at 3.35 TB/s) for 44 GFLOP (0.045 ms at the
// bf16 tensor-core peak). Design:
// * Tensor cores at f32 accuracy. Each f32 operand is split into a bf16
//   high part (rounded toward zero, so it never overflows) and a bf16 low
//   part (the rounded rest), and mma.sync m16n8k16 sums the partial
//   products in f32: a*b_hi + a*b_lo for a bf16 a (2 passes), plus
//   a_lo*b_hi for an f32 a (3 passes). The dropped a_lo*b_lo and the low
//   parts' rounding are some 2^-16 of each product; one bf16 or TF32 pass
//   keeps 8 or 11 bits and misses 1e-4 of the largest output at these R.
// * b is split once per block: each 32-row tile of b is turned into bf16
//   high and low tiles in shared memory (double-buffered), which the MMA
//   warps read with ldmatrix.trans. a needs no split in bf16; in f32 each
//   warp splits its fragments in registers.
// * a transposed on the fly: a's tile lies in shared memory as [rows][K],
//   the MMA's A operand stored by columns; ldmatrix.trans (bf16) or scalar
//   loads (f32) build the fragments. Row strides of 328 bf16, 324 floats
//   and 136 bf16 keep those loads free of bank conflicts.
// * cp.async in a ring of 4 (bf16 a) or 3 (f32 a) stages of 32-row tiles.
//   Copies are 16, 8 or 4 bytes, the widest that the operand's pointer, row
//   stride and width allow (a bf16 row of 300 values is 600 bytes, so 8).
//   Rows past the end are zero-filled by the copy; a's columns past K and
//   b's past N are set once (the ones column at K, zeros after it) and never
//   copied. One barrier per tile: between two barriers the block starts the
//   copies of tile c + stages - 1, splits tile c + 1 and runs tile c's MMAs;
//   half the warps start their copies before their MMAs and half after, so
//   that MMAs issue while copies wait.
// * Block tile 320 x 128 of the output (16 warps of 80 x 32): K+1 = 301
//   fits one tile along K, so b is read once; a is read once per 128
//   columns (8 times at N = 900, from L2).
// * Split-K over a fixed partition of R: the number of splits is a
//   function of R and the tile count only (at most 132 blocks, one per SM
//   of an H100, at least 256 rows each), never of the card; each split
//   writes its partial tile, and a second kernel sums the partials in split
//   order. Two launches give the same bits.

#include <cstdint>

#include "common.cuh"

namespace {

// weight_grad geometry (see the head of this file)
constexpr int kWgThreads = 512;      // 16 warps: 4 along K x 4 along N
constexpr int kWgBM = 320;           // output rows (a's columns and the ones column) per block
constexpr int kWgBN = 128;           // output columns (b's columns) per block
constexpr int kWgBR = 32;            // token rows per stage
constexpr int kWgMI = kWgBM / 4 / 16;            // m16 tiles per warp (5)
constexpr int kWgNI = kWgBN / 4 / 8;             // n8 tiles per warp (4)
constexpr int kWgStrideB = kWgBN + 4;            // floats per staged b row
constexpr int kWgStrideS = kWgBN + 8;            // bf16 per row of b's split tiles (272 B)
constexpr int kWgTargetBlocks = 132;
constexpr int kWgMinRows = 256;
static_assert(kWgThreads / 32 * 2 == kWgBR, "each warp copies two rows of a stage");

// Per a's type: elements per staged a row, 324 floats (scalar fragment
// loads free of bank conflicts) or 328 bf16 (656-byte rows: ldmatrix free
// of conflicts), and the stages of the ring that fit in shared memory.
template <typename TA> struct WgA {
  static constexpr int stride = kWgBM + 4, stages = 3;
};
template <> struct WgA<__nv_bfloat16> {
  static constexpr int stride = kWgBM + 8, stages = 4;
};

template <typename TA>
__host__ __device__ constexpr int wg_stage_bytes() {
  return kWgBR * WgA<TA>::stride * (int)sizeof(TA) + kWgBR * kWgStrideB * 4;
}

// the ring of staged a and b tiles, then two pairs of b's high and low
// bf16 tiles (this chunk's and the next one's)
template <typename TA>
__host__ __device__ constexpr int wg_smem_bytes() {
  return WgA<TA>::stages * wg_stage_bytes<TA>() + 4 * kWgBR * kWgStrideS * 2;
}

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

// `bytes` (16, 8 or 4) from global to shared memory, asynchronously; with
// valid false the destination is zero-filled and nothing is read
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

// x0, x1 -> bf16x2 high parts (toward zero) and low parts (x - high,
// rounded); x0 in the lower half, as the MMA fragments take them
__device__ __forceinline__ void split_bf16x2(float x0, float x1, unsigned& hi, unsigned& lo) {
  asm("cvt.rz.bf16x2.f32 %0, %1, %2;\n" : "=r"(hi) : "f"(x1), "f"(x0));
  const float h0 = __uint_as_float(hi << 16), h1 = __uint_as_float(hi & 0xffff0000u);
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(lo) : "f"(x1 - h1), "f"(x0 - h0));
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8 x 8 bf16 matrices from shared memory, transposed; lane l gives
// the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// partial[split][k][n] = sum over the split's rows r of [a | 1][r][k] * b[r][n]
// for k < Kout (K, or K + 1 with the ones column), n < N. Grid (tiles,
// splits); warp w owns rows (w / 4) * 80 and columns (w % 4) * 32 of the
// block's 320 x 128 tile. a null: no columns but the ones.
//
// Per 32-row chunk c, between two barriers: start the copies of chunk c +
// stages - 1 (into the stage chunk c - 1 used), split chunk c + 1's b tile
// into bf16 high and low tiles, and run chunk c's MMAs: a from the staged
// tile (ldmatrix.trans for bf16; for f32, scalar loads split in
// registers), b from chunk c's split tiles (ldmatrix.trans).
template <typename TA>
__global__ void __launch_bounds__(kWgThreads, 1)
weight_grad_mma_kernel(const TA* __restrict__ A, long lda, int a_bytes,
                       const float* __restrict__ B, long ldb, int b_bytes, long R, int K,
                       int Kout, int N, long rows_per_split, int tiles_n,
                       float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  constexpr int SA = WgA<TA>::stride, kStages = WgA<TA>::stages;
  constexpr int kABytes = kWgBR * SA * (int)sizeof(TA);
  constexpr int kStage = wg_stage_bytes<TA>();
  constexpr bool kF32 = sizeof(TA) == 4;
  const int k0 = (blockIdx.x / tiles_n) * kWgBM, n0 = (blockIdx.x % tiles_n) * kWgBN;
  const long r_begin = (long)blockIdx.y * rows_per_split;
  const long r_end = r_begin + rows_per_split < R ? r_begin + rows_per_split : R;
  const int chunks = r_end > r_begin ? (int)((r_end - r_begin + kWgBR - 1) / kWgBR) : 0;
  const int tid = threadIdx.x;
  auto a_tile = [&](int st) { return reinterpret_cast<TA*>(wg_smem + st * kStage); };
  auto b_tile = [&](int st) { return reinterpret_cast<float*>(wg_smem + st * kStage + kABytes); };
  // b's split tiles of chunk c: hi at split_tile(c, 0), lo at split_tile(c, 1)
  auto split_tile = [&](int chunk, int part) {
    return reinterpret_cast<__nv_bfloat16*>(wg_smem + kStages * kStage) +
           ((chunk & 1) * 2 + part) * kWgBR * kWgStrideS;
  };

  // what no copy writes: a's columns from K on (1 in the ones column, else
  // 0) and b's columns from N on (0)
  for (int st = 0; st < kStages; ++st) {
    TA* as = a_tile(st);
    float* bs = b_tile(st);
    for (int i = tid; i < kWgBR * SA; i += kWgThreads) {
      const int k = k0 + i % SA;
      if (k >= K) as[i] = from_f<TA>(k < Kout ? 1.f : 0.f);
    }
    for (int i = tid; i < kWgBR * kWgStrideB; i += kWgThreads)
      if (n0 + i % kWgStrideB >= N) bs[i] = 0.f;
  }

  // the copies of a stage: warp w takes rows 2w and 2w + 1, its lanes the
  // row's copy units in turn
  const int a_vec = a_bytes / (int)sizeof(TA), b_vec = b_bytes / 4;
  const int a_cols = A != nullptr && K - k0 > 0 ? (K - k0 < kWgBM ? K - k0 : kWgBM) : 0;
  const int b_cols = N - n0 < kWgBN ? N - n0 : kWgBN;
  const int a_per_row = a_cols / a_vec, b_per_row = b_cols / b_vec;
  const int copy_row = (tid >> 5) * 2, copy_lane = tid & 31;
  auto load = [&](int chunk, int st) {
    const long r0 = r_begin + (long)chunk * kWgBR;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = copy_row + h;
      const bool valid = r0 + rr < r_end;
      const long row = valid ? r0 + rr : r_begin;
      const TA* ga = A + row * lda + k0;
      TA* sa = a_tile(st) + rr * SA;
      for (int c = copy_lane; c < a_per_row; c += 32)
        cp_async(sa + c * a_vec, ga + c * a_vec, a_bytes, valid);
      const float* gb = B + row * ldb + n0;
      float* sb = b_tile(st) + rr * kWgStrideB;
      for (int c = copy_lane; c < b_per_row; c += 32)
        cp_async(sb + c * b_vec, gb + c * b_vec, b_bytes, valid);
    }
  };

  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * (kWgMI * 16), wn = (warp & 3) * (kWgNI * 8);
  // a warp whose rows all lie past Kout, or columns past N, skips the MMAs
  // (the others run all of theirs: b's split tiles are 0 past N, so a tile
  // past the edge adds 0)
  const bool live = k0 + wm < Kout && n0 + wn < N;
  // the split: 8 consecutive values of one row per thread
  const int split_r = tid >> 4, split_c = (tid & 15) * 8;
  auto split = [&](int chunk) {
    const float* p = b_tile(chunk % kStages) + split_r * kWgStrideB + split_c;
    const float4 x = *reinterpret_cast<const float4*>(p);
    const float4 y = *reinterpret_cast<const float4*>(p + 4);
    uint4 hi, lo;
    split_bf16x2(x.x, x.y, hi.x, lo.x);
    split_bf16x2(x.z, x.w, hi.y, lo.y);
    split_bf16x2(y.x, y.y, hi.z, lo.z);
    split_bf16x2(y.z, y.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(split_tile(chunk, 0) + split_r * kWgStrideS + split_c) = hi;
    *reinterpret_cast<uint4*>(split_tile(chunk, 1) + split_r * kWgStrideS + split_c) = lo;
  };
  float acc[kWgMI][kWgNI][4];
#pragma unroll
  for (int i = 0; i < kWgMI; ++i)
#pragma unroll
    for (int j = 0; j < kWgNI; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < chunks) load(st, st);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  if (chunks > 0) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();
    split(0);
  }
  // chunk's MMAs: a from its staged tile, b from its split tiles
  auto mma = [&](int chunk) {
    const TA* as = a_tile(chunk % kStages);
    const __nv_bfloat16* b_hi = split_tile(chunk, 0);
    const __nv_bfloat16* b_lo = split_tile(chunk, 1);
#pragma unroll
    for (int ks = 0; ks < kWgBR; ks += 16) {
      // b fragments, two n8 tiles per ldmatrix: matrices (k 0-7, n j),
      // (k 8-15, n j), (k 0-7, n j+1), (k 8-15, n j+1)
      unsigned bhi[kWgNI][2], blo[kWgNI][2];
#pragma unroll
      for (int jj = 0; jj < kWgNI / 2; ++jj) {
        const int off = (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * kWgStrideS + wn + jj * 16 +
                        (lane >> 4) * 8;
        unsigned r[4];
        ldmatrix_x4_trans(r, b_hi + off);
        bhi[2 * jj][0] = r[0]; bhi[2 * jj][1] = r[1]; bhi[2 * jj + 1][0] = r[2]; bhi[2 * jj + 1][1] = r[3];
        ldmatrix_x4_trans(r, b_lo + off);
        blo[2 * jj][0] = r[0]; blo[2 * jj][1] = r[1]; blo[2 * jj + 1][0] = r[2]; blo[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kWgMI; ++i) {
        const int m = wm + i * 16;
        unsigned ahi[4], alo[4];
        if constexpr (kF32) {
          // A[m][k] = a[k][m]: registers (m g, k 2t), (m g+8, k 2t),
          // (m g, k 2t+8), (m g+8, k 2t+8), two k each
          const float* p = reinterpret_cast<const float*>(as) + (ks + 2 * t) * SA + m + g;
          split_bf16x2(p[0], p[SA], ahi[0], alo[0]);
          split_bf16x2(p[8], p[SA + 8], ahi[1], alo[1]);
          split_bf16x2(p[8 * SA], p[9 * SA], ahi[2], alo[2]);
          split_bf16x2(p[8 * SA + 8], p[9 * SA + 8], ahi[3], alo[3]);
        } else {
          // matrices (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7),
          // (k 8-15, m 8-15)
          ldmatrix_x4_trans(ahi, as + (ks + (lane & 7) + ((lane >> 4) << 3)) * SA + m +
                                     ((lane >> 3) & 1) * 8);
        }
        // the passes in a fixed order; each accumulator's next MMA is
        // four MMAs away
#pragma unroll
        for (int j = 0; j < kWgNI; ++j) mma_bf16(acc[i][j], ahi, bhi[j]);
#pragma unroll
        for (int j = 0; j < kWgNI; ++j) mma_bf16(acc[i][j], ahi, blo[j]);
        if constexpr (kF32) {
#pragma unroll
          for (int j = 0; j < kWgNI; ++j) mma_bf16(acc[i][j], alo, bhi[j]);
        }
      }
    }
  };
  // half the warps start the copies before their MMAs, the other half
  // after them, so that some warps issue MMAs while others wait on copies
  const bool copies_first = (warp & 1) == 0;
  for (int chunk = 0; chunk < chunks; ++chunk) {
    // chunk + 1 landed (groups 0 .. chunk + 1 of the stages - 1 + chunk
    // committed)
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 3));
    __syncthreads();  // chunk's split tiles written; chunk - 1's MMAs done
    auto copies = [&] {
      if (chunk + kStages - 1 < chunks)
        load(chunk + kStages - 1, (chunk + kStages - 1) % kStages);
      asm volatile("cp.async.commit_group;\n" ::);
    };
    if (copies_first) copies();
    if (chunk + 1 < chunks) split(chunk + 1);
    if (live) mma(chunk);
    if (!copies_first) copies();
  }

  float* out = partial + (long)blockIdx.y * Kout * N;
#pragma unroll
  for (int i = 0; i < kWgMI; ++i) {
#pragma unroll
    for (int j = 0; j < kWgNI; ++j) {
      const int n = n0 + wn + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + wm + i * 16 + g + 8 * h;
        if (k >= Kout) continue;
        if (n < N) out[(long)k * N + n] = acc[i][j][2 * h];
        if (n + 1 < N) out[(long)k * N + n + 1] = acc[i][j][2 * h + 1];
      }
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

struct WgPlan {
  int tiles_n, tiles, splits;
  long rows;  // per split, a multiple of kWgBR
};

// The fixed partition of R: a function of R and the tile count only
WgPlan weight_grad_plan(long R, int Kout, int N) {
  WgPlan p;
  p.tiles_n = (N + kWgBN - 1) / kWgBN;
  p.tiles = (Kout + kWgBM - 1) / kWgBM * p.tiles_n;
  long s = kWgTargetBlocks / p.tiles;
  const long by_rows = (R + kWgMinRows - 1) / kWgMinRows;
  s = s < by_rows ? s : by_rows;
  s = s < 1 ? 1 : s;
  p.rows = ((R + s - 1) / s + kWgBR - 1) / kWgBR * kWgBR;
  p.splits = p.rows > 0 ? (int)((R + p.rows - 1) / p.rows) : 1;
  return p;
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

// the widest copy (16, 8 or 4 bytes) that the pointer, the row stride and
// the width allow; 0 if none does
int copy_bytes(const void* p, long ld, int cols, int elem) {
  for (int v = 16; v >= 4; v /= 2)
    if ((reinterpret_cast<uintptr_t>(p) % v) == 0 && (ld * elem) % v == 0 && (cols * elem) % v == 0)
      return v;
  return 0;
}

template <typename TA>
cudaError_t launch_weight_grad(const void* a, long lda, const void* b, long ldb, long R, int K,
                               int Kout, int N, void* partial, void* out, cudaStream_t stream) {
  const WgPlan p = weight_grad_plan(R, Kout, N);
  const int a_bytes = a != nullptr ? copy_bytes(a, lda, K, sizeof(TA)) : (int)sizeof(TA);
  const int b_bytes = copy_bytes(b, ldb, N, 4);
  if (a_bytes == 0 || b_bytes == 0) return cudaErrorInvalidValue;
  constexpr int smem = wg_smem_bytes<TA>();
  cudaError_t err = cudaFuncSetAttribute(weight_grad_mma_kernel<TA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  float* dst = static_cast<float*>(p.splits > 1 ? partial : out);
  weight_grad_mma_kernel<TA><<<dim3(p.tiles, p.splits), kWgThreads, smem, stream>>>(
      static_cast<const TA*>(a), lda, a_bytes, static_cast<const float*>(b), ldb, b_bytes, R, K,
      Kout, N, p.rows, p.tiles_n, dst);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const long kn = (long)Kout * N;
  const long want = (kn + kThreads - 1) / kThreads;
  weight_grad_reduce_kernel<<<(int)(want < 4096 ? want : 4096), kThreads, 0, stream>>>(
      static_cast<const float*>(partial), p.splits, kn, static_cast<float*>(out));
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

// partial tiles newsrec_weight_grad needs room for: splits x Kout x N
// floats (1 split: none, the kernel writes out directly)
int newsrec_weight_grad_splits(long R, int Kout, int N) {
  return weight_grad_plan(R, Kout, N).splits;
}

// out [K + bias, N] = [a | 1]^T b over R rows, in f32: a [R, K] with row
// stride lda (a_dtype 0 = float32, 1 = bfloat16, -1 = no a: K = 0 and only
// the ones column), b [R, N] float32 with row stride ldb; with bias (or no
// a) row K is the column sums of b. partial holds
// newsrec_weight_grad_splits(R, K + bias, N) x (K + bias) x N floats when
// that is above 1. Needs Kout, N >= 1; the copies need a's and b's widths,
// row strides and pointers to be multiples of 4 bytes. Returns a
// cudaError_t code.
int newsrec_weight_grad(int a_dtype, const void* a, long lda, const void* b, long ldb, long R,
                        int K, int bias, int N, void* partial, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == -1)
    return launch_weight_grad<__nv_bfloat16>(nullptr, 0, b, ldb, R, 0, 1, N, partial, out, s);
  const int Kout = K + (bias ? 1 : 0);
  if (a_dtype == 0)
    return launch_weight_grad<float>(a, lda, b, ldb, R, K, Kout, N, partial, out, s);
  if (a_dtype == 1)
    return launch_weight_grad<__nv_bfloat16>(a, lda, b, ldb, R, K, Kout, N, partial, out, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
