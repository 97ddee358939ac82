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
// Layout: tiles of whole items on the tensor cores. A block of pool_bwd
// and attn_bwd takes floor(64 / L) whole items (R_t = 64 token rows: 5
// items at L=12, 3 at L=20, 1 at L=50; one item of round16(L) rows past
// 64), its rows past the last item zero (newsrec_fused_encoder_bwd_tile).
// A small kernel first writes the weights in the layout the copies read
// (stage_weights_kernel, WsLayout); then three kernels with the per-token
// intermediates in device memory:
//   pool_bwd:  o2 = o1 Wo + bo (dropout), t = tanh(T(o2) aw + ab), the
//              pooling softmax per item (one warp per item, max(den, 1e-30)),
//              d(logit), dpre, do2 = w g + dpre aw^T (dropout), do1 =
//              T(do2 Wo^T); writes o2, t, dpre, do2, d(logit), do1.
//   attn_bwd:  per head, q|k|v = T(x Wqkv + b) over the head's columns (each
//              of q, k, v padded from dh to round16(dh) with zeros), scores
//              and dP over the tile, the softmax and dS (8 lanes a row), dQ,
//              dK, dV; writes dqkv.
//   dx:        dx = T(dqkv Wqkv^T), row by row: one block per 64 token
//              rows, whatever the items.
// * Every product is mma.sync m16n8k16 bf16 with f32 sums (tile_product for
//   the weight products, the attention's five inline). Operands the TPU
//   kernel's rounding leaves in bf16 (x, o1, T(o2), q, k, v, dO1, T(P), dS)
//   take one pass; the f32 operands dpre, do2 and dqkv are split into bf16
//   high and low parts (two passes, A_hi B + A_lo B). In f32 (T = float)
//   every operand is split and the weights too (their parts written once
//   per call): three passes, A_hi B_hi + A_lo B_hi + A_hi B_lo, about 2^-16
//   of each product, as in weight_grad.
// * The weights go through shared memory: 64-deep tiles of Wo, aw, a head's
//   q|k|v columns of Wqkv, and the transposes of Wo, aw and Wqkv (stored by
//   columns, read with ldmatrix without .trans), in a cp.async ring of 2-3
//   stages, the copies of the next tiles under the MMAs of this one. Each
//   warp takes 16-row units of the 64-row tile (Cfg): pool_bwd (bf16) runs
//   16 warps on 128-column chunks (16 x 32 units), dx 16 on all of D at
//   once (16 x 80), attn_bwd 8 on a head's 96 columns (16 x 48), two blocks
//   per SM. Each staged tile serves all 64
//   rows of the block, not one item's L; weight reads from L2 fall by 64 / L
//   against one block per item (R_t = 128 would halve them again, but
//   pool_bwd's f32 intermediates and operand tiles take 160 KB of shared
//   memory at 64 rows). Rows of D = 300 bf16 are 600 bytes, so copies
//   straight from the weights could be 8 bytes at most, and a head's
//   columns start at h * 30: 4 bytes. The copy of the weights in WsLayout
//   starts every row and every head's block 16 bytes aligned, so every copy
//   is one 16-byte cp.async, a quarter or an eighth as many copies to
//   issue. Depth and width pads (D = 300 -> 304, Q = 200 -> 208, dh = 30 ->
//   32) are zeros written once in shared memory or zero-filled by the
//   copies, which read only a unit's valid values; no pad is read from
//   device memory.
// * Shared memory limits L. Past 64 rows pool_bwd takes narrower weight
//   tiles (Cfg's PoolWide), attn_bwd's T(P) and dS overwrite its scores
//   and dP row by row, and dx's blocks do not depend on L, so that at
//   D = 300, Q = 200 the kernels take L up to 80. The attention's Rt^2
//   scores and pool_bwd's operand tiles bound it elsewhere (L up to 144
//   at D = 64 in bf16, 128 in f32); newsrec_fused_encoder_bwd_smem_bytes
//   gives the need, and the wrapper raises past 227 KB.
// * The attention runs over the tile's block diagonal: one Rt x Rt score
//   tile per head, with the TPU kernel's penalty (m_i m_j - 1) * 1e9 within
//   an item and -1e9 between items. exp(-1e9 - max) is 0 in f32, so a real
//   row's probabilities are its item's; a pad row's spread over the tile,
//   but its dO1 is 0 (w = ds = dpre = 0 there), so its dP and dS rows are 0
//   and its T(P) meets only zeros in dV. Every dqkv row equals the per-item
//   one up to summation order, and an all-pad item's dx is exactly 0.
//   At L=20 this is 64^2 scores where the items need 3 x 20^2; the
//   attention is some 3% of the FLOP.
// * No atomics; every sum has a fixed order, so two launches agree bit for
//   bit. The dropout mask is the hash of the global token row, which no
//   tiling changes.
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
// bytes: bound by operations. The per-item kernels do two thirds of it,
// 2*L*D*(8D+2Q) (the weight gradients the rest), and must also write the f32
// intermediates the weight gradients read, about 1.2 GB per call at M=4096,
// L=20: 0.35 ms at 3.35 TB/s.
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

#include "tiles.cuh"

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

// ---- the per-item backward: kernels ----------------------------------------

// shared memory of pool_bwd: o1 / T(o2) / dpre as A tiles (high and low);
// o2, then t in f32, then do2's A tiles; the weight ring; five [Rt] rows;
// bo, ab, aq
template <bool kF32, bool kWide> __host__ __device__ inline long pool_smem_bytes_of(int L, int D, int Q) {
  using C = PoolCfg<kF32, kWide>;
  const long Rt = tile_rows(L);
  return 4 * Rt * lda_of(imax(D, Q)) + Rt * imax(imax(4 * D, 4 * Q), 4 * lda_of(D)) +
         C::ST * b_stage_bytes<C::NT>(kF32) + 20 * Rt + 4L * (D + 2 * Q);
}
template <bool kF32> __host__ __device__ inline long pool_smem_bytes(int L, int D, int Q) {
  return tile_rows(L) > kTileRows ? pool_smem_bytes_of<kF32, true>(L, D, Q)
                                  : pool_smem_bytes_of<kF32, false>(L, D, Q);
}

// attn_bwd's scores and dP (f32), [Rt, Rt + 4] each; T(P) and dS (high
// and, in f32, low) overwrite them row by row
__host__ __device__ inline long attn_scratch_bytes(long Rt) { return 2 * Rt * (Rt + 4) * 4; }

// shared memory of attn_bwd: x's A tiles; a head's q, k, v and dO1 tiles
// (high and, in f32, low); the weight ring, aliased by the scratch above
template <bool kF32> __host__ __device__ inline long attn_smem_bytes(int L, int D, int H) {
  const long Rt = tile_rows(L), ldh = round16(D / H) + 8, parts = kF32 ? 2 : 1;
  const long att = attn_scratch_bytes(Rt);
  const long ring = Cfg<kF32>::Attn::ST * b_stage_bytes<Cfg<kF32>::Attn::NT>(kF32);
  return parts * (2 * Rt * lda_of(D) + 8 * Rt * ldh) + (att > ring ? att : ring) + 8 * Rt +
         12 * round16(D / H);
}

template <bool kF32> __host__ __device__ inline long dx_smem_bytes() {
  using C = typename Cfg<kF32>::Dx;
  return C::ST * (AStream::stage_bytes(kTileRows) + b_stage_bytes<C::NT>(kF32));
}

// One block per tile of whole items: o2 = o1 Wo + bo (dropout), t =
// tanh(T(o2) aw + ab), the pooling softmax per item, d(logit), dpre, do2 =
// w g + dpre aw^T (dropout), do1 = T(do2 Wo^T); writes o2, t, dpre, do2,
// d(logit) (f32) and do1 (T). wo and aw are the products with Wo and aw;
// the products with their transposes read the same matrices by columns.
template <typename T, bool kWide>
__global__ void __launch_bounds__(512, 1)
pool_bwd_kernel(const float* __restrict__ g, const float* __restrict__ mask,
                const T* __restrict__ o1, BOp wo, BOp aw,
                const T* __restrict__ bo, const T* __restrict__ ab, const T* __restrict__ aq,
                float* __restrict__ o2_g, float* __restrict__ t_g, float* __restrict__ dpre_g,
                float* __restrict__ do2_g, float* __restrict__ ds_g, T* __restrict__ do1_g,
                int M, int L, int D, int Q, unsigned seed, int block_rows, unsigned threshold,
                float keep_scale) {
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Rt = tile_rows(L), ipt = items_per_tile(L);
  const int ldA = lda_of(imax(D, Q)), ldD = lda_of(D), D16 = round16(D), Q16 = round16(Q);
  __nv_bfloat16* a_hi = reinterpret_cast<__nv_bfloat16*>(smem);   // [Rt, ldA]
  __nv_bfloat16* a_lo = a_hi + Rt * ldA;
  unsigned char* r2 = smem + 4L * Rt * ldA;
  float* o2s = reinterpret_cast<float*>(r2);                       // [Rt, D]  o2
  float* ts = o2s;                                                 // [Rt, Q]  t
  __nv_bfloat16* d_hi = reinterpret_cast<__nv_bfloat16*>(r2);     // [Rt, ldD] do2
  __nv_bfloat16* d_lo = d_hi + Rt * ldD;
  unsigned char* ring = r2 + (long)Rt * imax(imax(4 * D, 4 * Q), 4 * ldD);
  using C = PoolCfg<kF32, kWide>;
  float* mk = reinterpret_cast<float*>(ring + C::ST * b_stage_bytes<C::NT>(kF32));
  float* pw = mk + Rt;    // pooling logits, then weights w
  float* dwf = pw + Rt;   // o2 . g per row
  float* ds = dwf + Rt;   // d(logit)
  int* gi = reinterpret_cast<int*>(ds + Rt);  // [Rt] the row's item, for g
  float* bos = reinterpret_cast<float*>(gi + Rt);  // bo, ab, aq in f32
  float* abs_ = bos + D;
  float* aqs = abs_ + Q;

  const int item0 = blockIdx.x * ipt;
  const int nitems = M - item0 < ipt ? M - item0 : ipt, nrows = nitems * L;
  const long row0 = (long)item0 * L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto gval = [=](int r, int n) { return g[(long)gi[r] * D + n]; };
  stage_tile<4>(o1 + row0 * D, D, nrows, D, Rt, D16, a_hi, a_lo, ldA, kF32);
  for (int r = tid; r < Rt; r += blockDim.x) {
    mk[r] = r < nrows ? mask[row0 + r] : 0.f;
    gi[r] = item0 + (r < nrows ? r / L : 0);
  }
  for (int i = tid; i < D; i += blockDim.x) bos[i] = to_f(bo[i]);
  for (int i = tid; i < Q; i += blockDim.x) {
    abs_[i] = to_f(ab[i]);
    aqs[i] = to_f(aq[i]);
  }

  // o2 = o1 @ Wo + bo, then dropout
  tile_product<C::NT, C::UJ, C::ST, C::W, false, kF32, kF32>(
      ASmem{a_hi, a_lo, ldA}, wo, Rt, ring, [=](int r, int n, float a0, float a1) {
        float v0 = 0.f, v1 = 0.f;
        if (r < nrows) {
          v0 = dropout(a0 + bos[n], seed, block_rows, row0 + r, n, threshold, keep_scale);
          v1 = dropout(a1 + bos[n + 1], seed, block_rows, row0 + r, n + 1, threshold,
                       keep_scale);
          store2(o2_g + (row0 + r) * D + n, v0, v1);
        }
        store2(o2s + r * D + n, v0, v1);
      });
  // o2 . g per row; T(o2) as the next A
  for (int r = warp; r < nrows; r += C::W) {
    float dw = 0.f;
    for (int d = lane; d < D; d += 32) dw = fmaf(o2s[r * D + d], gval(r, d), dw);
    dw = warp_sum(dw);
    if (lane == 0) dwf[r] = dw;
  }
  for (int i = tid; i < Rt * D16; i += blockDim.x) {
    const int r = i / D16, c = i % D16;
    put(a_hi, a_lo, r * ldA + c, c < D ? rnd<T>(o2s[r * D + c]) : 0.f, kF32);
  }
  __syncthreads();
  // t = tanh(T(o2) @ aw + ab)
  tile_product<C::NT, C::UJ, C::ST, C::W, false, kF32, kF32>(
      ASmem{a_hi, a_lo, ldA}, aw, Rt, ring, [=](int r, int n, float a0, float a1) {
        const float t0 = tanhf(a0 + abs_[n]), t1 = tanhf(a1 + abs_[n + 1]);
        store2(ts + r * Q + n, t0, t1);
        if (r < nrows) {
          store2(t_g + (row0 + r) * Q + n, t0, t1);
        }
      });
  // pooling logits t . aq, one warp per row
  for (int r = warp; r < nrows; r += C::W) {
    float s = 0.f;
    for (int q = lane; q < Q; q += 32) s = fmaf(ts[r * Q + q], aqs[q], s);
    s = warp_sum(s);
    if (lane == 0) pw[r] = mk[r] > 0.f ? s : -1e9f;
  }
  __syncthreads();
  // softmax over each item, one warp per item: w = e / max(sum e, 1e-30)
  // (0 for an all-pad item), d(logit) = w (o2.g - sum_l w o2.g)
  for (int it = warp; it < nitems; it += C::W) {
    float* p = pw + it * L;
    const float* m = mk + it * L;
    float mx = -INFINITY;
    for (int i = lane; i < L; i += 32) mx = fmaxf(mx, p[i]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int i = lane; i < L; i += 32) {
      const float e = m[i] > 0.f ? expf(p[i] - mx) : 0.f;
      p[i] = e;
      den += e;
    }
    den = fmaxf(warp_sum(den), 1e-30f);
    float ip = 0.f;
    for (int i = lane; i < L; i += 32) {
      p[i] = p[i] / den;
      ip += p[i] * dwf[it * L + i];
    }
    ip = warp_sum(ip);
    for (int i = lane; i < L; i += 32) ds[it * L + i] = p[i] * (dwf[it * L + i] - ip);
  }
  for (int r = nrows + tid; r < Rt; r += blockDim.x) pw[r] = ds[r] = 0.f;
  __syncthreads();
  for (int r = tid; r < nrows; r += blockDim.x) ds_g[row0 + r] = ds[r];
  // dpre = d(logit) aq (1 - t^2), split as the next A
  for (int i = tid; i < Rt * Q16; i += blockDim.x) {
    const int r = i / Q16, q = i % Q16;
    float v = 0.f;
    if (r < nrows && q < Q) {
      const float t = ts[r * Q + q];
      v = (ds[r] * aqs[q]) * (1.f - t * t);
      dpre_g[(row0 + r) * Q + q] = v;
    }
    put(a_hi, a_lo, r * ldA + q, v, true);
  }
  __syncthreads();
  // t is spent: do2's tiles take its place, their columns past D zeroed
  for (int i = tid; i < Rt * (D16 - D); i += blockDim.x) {
    const int r = i / (D16 - D), c = D + i % (D16 - D);
    d_hi[r * ldD + c] = d_lo[r * ldD + c] = __float2bfloat16_rn(0.f);
  }
  // do2 = w g + dpre @ aw^T, then the dropout scale
  tile_product<C::NT, C::UJ, C::ST, C::W, true, true, kF32>(
      ASmem{a_hi, a_lo, ldA}, transposed(aw), Rt, ring, [=](int r, int n, float a0, float a1) {
        float v0 = 0.f, v1 = 0.f;
        if (r < nrows) {
          v0 = dropout(pw[r] * gval(r, n) + a0, seed, block_rows, row0 + r, n, threshold,
                       keep_scale);
          v1 = dropout(pw[r] * gval(r, n + 1) + a1, seed, block_rows, row0 + r, n + 1,
                       threshold, keep_scale);
          store2(do2_g + (row0 + r) * D + n, v0, v1);
        }
        put(d_hi, d_lo, r * ldD + n, v0, true);
        put(d_hi, d_lo, r * ldD + n + 1, v1, true);
      });
  // do1 = T(do2 @ Wo^T)
  tile_product<C::NT, C::UJ, C::ST, C::W, true, true, kF32>(
      ASmem{d_hi, d_lo, ldD}, transposed(wo), Rt, ring, [=](int r, int n, float a0, float a1) {
        if (r < nrows) {
          store2(do1_g + (row0 + r) * D + n, a0, a1);
        }
      });
}

// One block per tile of whole items, head by head: q|k|v of the head
// recomputed from x (x Wqkv on the tensor cores), the attention over the
// tile's block diagonal (a penalty of 1e9 between items, and on pad tokens
// within one, as the TPU kernel masks), dS, and dq, dk, dv; writes dqkv (f32).
template <typename T>
__global__ void __launch_bounds__(256, 1)
attn_bwd_kernel(const T* __restrict__ x, const float* __restrict__ mask, BOp wqkv,
                const T* __restrict__ bqkv, const T* __restrict__ do1_g,
                float* __restrict__ dqkv_g, int M, int L, int D, int H, float scale) {
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Rt = tile_rows(L), ipt = items_per_tile(L);
  const int dh = D / H, dhp = round16(dh), ldh = dhp + 8, ldX = lda_of(D), D16 = round16(D);
  // T(P) and dS take the rows of the scores and dP: a row's f32 values
  // are read before its bf16 ones are written (by the same lanes), high
  // parts at 0, low parts at Rt + 8 (16-byte aligned) of the row
  const int ldS = Rt + 4, ldP = 2 * ldS;
  using C = typename Cfg<kF32>::Attn;
  constexpr int parts = kF32 ? 2 : 1;  // low parts in f32 only
  __nv_bfloat16* x_hi = reinterpret_cast<__nv_bfloat16*>(smem);  // [Rt, ldX]
  __nv_bfloat16* x_lo = x_hi + Rt * ldX;
  // q, k, v, dO1 of one head, [Rt, ldh] each: high parts, then low parts
  __nv_bfloat16* hd = x_hi + parts * Rt * ldX;
  auto head_hi = [=](int i) { return hd + i * Rt * ldh; };
  auto head_lo = [=](int i) { return hd + (4 + i) * Rt * ldh; };
  unsigned char* ring = reinterpret_cast<unsigned char*>(hd + parts * 4 * Rt * ldh);
  float* S = reinterpret_cast<float*>(ring);  // [Rt, ldS] scores
  float* DP = S + Rt * ldS;                   // [Rt, ldS] dP
  __nv_bfloat16* p_hi = reinterpret_cast<__nv_bfloat16*>(S);  // [Rt, ldP] T(P)
  __nv_bfloat16* p_lo = p_hi + Rt + 8;
  __nv_bfloat16* s_hi = reinterpret_cast<__nv_bfloat16*>(DP);  // [Rt, ldP] dS
  __nv_bfloat16* s_lo = s_hi + Rt + 8;
  const long att = attn_scratch_bytes(Rt), rb = C::ST * b_stage_bytes<C::NT>(kF32);
  float* mk = reinterpret_cast<float*>(ring + (att > rb ? att : rb));  // [Rt] mask
  int* itm = reinterpret_cast<int*>(mk + Rt);                          // [Rt] item of a row
  float* hb = reinterpret_cast<float*>(itm + Rt);  // [3 dhp] the head's q|k|v biases

  const int item0 = blockIdx.x * ipt;
  const int nitems = M - item0 < ipt ? M - item0 : ipt, nrows = nitems * L;
  const long row0 = (long)item0 * L, ld3 = 3L * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  stage_tile<4>(x + row0 * D, D, nrows, D, Rt, D16, x_hi, x_lo, ldX, kF32);
  for (int r = tid; r < Rt; r += blockDim.x) {
    mk[r] = r < nrows ? mask[row0 + r] : 0.f;
    itm[r] = r / L;  // rows past the last item fall in items of their own
  }
  // the penalty of the TPU kernel within an item; between items the same 1e9
  auto pen = [=](int i, int j) {
    return itm[i] == itm[j] ? (mk[i] * mk[j] - 1.f) * 1e9f : -1e9f;
  };
  const int nm = Rt / 16, nn = (Rt + 31) / 32, nd = dhp / 16;

  for (int h = 0; h < H; ++h) {
    // this head's dO1, from the pooling kernel: copies that land under the
    // projection below (bf16), or loads split into high and low parts (f32)
    if (kF32) {
      stage_tile<2>(do1_g + row0 * D + h * dh, D, nrows, dh, Rt, dhp, head_hi(3), head_lo(3),
                    ldh, true);
    } else {
      for (int i = tid; i < Rt * (dhp / 2); i += blockDim.x) {
        const int r = i / (dhp / 2), d = i % (dhp / 2) * 2;
        const bool valid = r < nrows && d < dh;
        cp_async(head_hi(3) + r * ldh + d, valid ? do1_g + (row0 + r) * D + h * dh + d : do1_g,
                 4, valid ? 4 : 0);
      }
    }
    // q (scaled), k, v = T(x Wqkv + bqkv) over the head's columns, each
    // padded from dh to dhp with zeros
    for (int i = tid; i < 3 * dhp; i += blockDim.x) {
      const int seg = i / dhp, d = i % dhp;
      hb[i] = d < dh ? to_f(bqkv[seg * D + h * dh + d]) : 0.f;
    }
    BOp b = wqkv;
    b.hi += h * 3 * dhp;
    if (kF32) b.lo += h * 3 * dhp;
    tile_product<C::NT, C::UJ, C::ST, C::W, false, kF32, kF32, true>(
        ASmem{x_hi, x_lo, ldX}, b, Rt, ring, [=](int r, int n, float a0, float a1) {
          const int seg = n >= 2 * dhp ? 2 : (n >= dhp ? 1 : 0), d = n - seg * dhp;
          float v0 = 0.f, v1 = 0.f;
          if (d < dh) {
            v0 = a0 + hb[n];
            v1 = a1 + hb[n + 1];
            if (seg == 0) { v0 *= scale; v1 *= scale; }
          }
          put(head_hi(seg), head_lo(seg), r * ldh + d, rnd<T>(v0), kF32);
          put(head_hi(seg), head_lo(seg), r * ldh + d + 1, rnd<T>(v1), kF32);
        });
    // scores q k^T + penalty and dP = dO1 v^T over the tile, 16 x 32 units
    for (int u = warp; u < nm * nn; u += C::W) {
      const int m0 = u / nn * 16, n0 = u % nn * 32;
      float sa[4][4] = {}, pa[4][4] = {};
      for (int k = 0; k < dhp; k += 16) {
        unsigned qh[4], ql[4], gh[4], gl[4];
        frag_a(qh, head_hi(0), ldh, m0, k);
        frag_a(gh, head_hi(3), ldh, m0, k);
        if (kF32) {
          frag_a(ql, head_lo(0), ldh, m0, k);
          frag_a(gl, head_lo(3), ldh, m0, k);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int n = n0 + 16 * jj;
          if (n >= Rt) break;
          unsigned kb[2][2], vb[2][2];
          frag_b_t(kb, head_hi(1), ldh, n, k);
          frag_b_t(vb, head_hi(2), ldh, n, k);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            mma_bf16(sa[2 * jj + e], qh, kb[e]);
            mma_bf16(pa[2 * jj + e], gh, vb[e]);
          }
          if (kF32) {
            unsigned kl[2][2], vl[2][2];
            frag_b_t(kl, head_lo(1), ldh, n, k);
            frag_b_t(vl, head_lo(2), ldh, n, k);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              mma_bf16(sa[2 * jj + e], ql, kb[e]);
              mma_bf16(sa[2 * jj + e], qh, kl[e]);
              mma_bf16(pa[2 * jj + e], gl, vb[e]);
              mma_bf16(pa[2 * jj + e], gh, vl[e]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + j * 8 + 2 * t;
        if (n >= Rt) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = m0 + g + 8 * hh;
          S[i * ldS + n] = sa[j][2 * hh] + pen(i, n);
          S[i * ldS + n + 1] = sa[j][2 * hh + 1] + pen(i, n + 1);
          DP[i * ldS + n] = pa[j][2 * hh];
          DP[i * ldS + n + 1] = pa[j][2 * hh + 1];
        }
      }
    }
    __syncthreads();
    // probabilities, then dS = T(P dP - P sum_j(P dP)), a row's scores and
    // dP in registers: G lanes a row (8 up to Rt = 64, else 32), up to 8
    // values a lane (Rt <= 256: the scores of a larger tile do not fit in
    // shared memory, which the wrapper checks); at G = 8 a pass takes rows 2
    // apart (a stride of 2 ldS floats, 8 banks: the 4 rows fall in distinct
    // banks)
    {
      const int G = Rt <= 64 ? 8 : 32, R = 32 / G, j0 = lane % G;
      for (int b = warp * 2 * R; b < Rt; b += C::W * 2 * R) {
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const int i = b + 2 * (lane / G) + par;
          float sv[8], dv[8];
          float mx = -INFINITY;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int j = j0 + G * c;
            sv[c] = j < Rt ? S[i * ldS + j] : -INFINITY;
            dv[c] = j < Rt ? DP[i * ldS + j] : 0.f;
            mx = fmaxf(mx, sv[c]);
          }
          mx = group_max(mx, G);
          float sum = 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            sv[c] = j0 + G * c < Rt ? expf(sv[c] - mx) : 0.f;
            sum += sv[c];
          }
          const float inv = 1.f / group_sum(sum, G);
          float rsum = 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            sv[c] *= inv;
            dv[c] *= sv[c];
            rsum += dv[c];
          }
          rsum = group_sum(rsum, G);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int j = j0 + G * c;
            if (j < Rt) {
              put(p_hi, p_lo, i * ldP + j, rnd<T>(sv[c]), kF32);
              put(s_hi, s_lo, i * ldP + j, rnd<T>(dv[c] - sv[c] * rsum), kF32);
            }
          }
        }
      }
    }
    __syncthreads();
    // dq = dS k * scale, dk = dS^T q, dv = T(P)^T dO1, 16 x 16 units (24
    // at dh = 30: three for each warp)
    for (int u = warp; u < 3 * nm * nd; u += C::W) {
      const int prod = u / (nm * nd), rem = u % (nm * nd);
      const int m0 = rem / nd * 16, n0 = rem % nd * 16;
      const __nv_bfloat16* a_h = prod == 2 ? p_hi : s_hi;
      const __nv_bfloat16* a_l = prod == 2 ? p_lo : s_lo;
      const int bi = prod == 0 ? 1 : (prod == 1 ? 0 : 3);  // k, q, dO1
      float acc[2][4] = {};
      for (int k = 0; k < Rt; k += 16) {
        unsigned ah[4], al[4], bh[2][2];
        if (prod == 0) {
          frag_a(ah, a_h, ldP, m0, k);
          if (kF32) frag_a(al, a_l, ldP, m0, k);
        } else {
          frag_a_t(ah, a_h, ldP, m0, k);
          if (kF32) frag_a_t(al, a_l, ldP, m0, k);
        }
        frag_b(bh, head_hi(bi), ldh, n0, k);
#pragma unroll
        for (int e = 0; e < 2; ++e) mma_bf16(acc[e], ah, bh[e]);
        if (kF32) {
          unsigned bl[2][2];
          frag_b(bl, head_lo(bi), ldh, n0, k);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            mma_bf16(acc[e], al, bh[e]);
            mma_bf16(acc[e], ah, bl[e]);
          }
        }
      }
      const float f = prod == 0 ? scale : 1.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = n0 + j * 8 + 2 * t;
        if (d >= dh) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = m0 + g + 8 * hh;
          if (i < nrows) {
            float* o = dqkv_g + (row0 + i) * ld3 + prod * D + h * dh + d;
            store2(o, acc[j][2 * hh] * f, acc[j][2 * hh + 1] * f);
          }
        }
      }
    }
    __syncthreads();  // the head's tiles and the ring are free again
  }
}

// dx = T(dqkv Wqkv^T), row by row: one block per 64 token rows (and per
// 320 columns of dx), whatever the items, dqkv's f32 rows staged with the
// weights, read once, and split in registers. An all-pad item's dqkv rows
// are 0, and so are its dx rows.
template <typename T>
__global__ void __launch_bounds__(512, 1)
dx_kernel(const float* __restrict__ dqkv_g, BOp wqkv_t, T* __restrict__ dx, long rows, int D) {
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int Rt = kTileRows;
  const long row0 = (long)blockIdx.x * Rt;
  const int nrows = rows - row0 < Rt ? (int)(rows - row0) : Rt;
  using C = typename Cfg<kF32>::Dx;
  const int n0 = blockIdx.y * C::NT;
  BOp b = wqkv_t;
  b.hi += (long)n0 * b.ld;
  if (b.lo != nullptr) b.lo += (long)n0 * b.ld;
  b.N = D - n0 < C::NT ? D - n0 : C::NT;
  tile_product<C::NT, C::UJ, C::ST, C::W, true, true, kF32>(
      AStream{dqkv_g + row0 * 3 * D, 3L * D, nrows, 3 * D, Rt}, b, Rt, smem,
      [=](int r, int n, float a0, float a1) {
        if (r < nrows) {
          store2(dx + (row0 + r) * D + n0 + n, a0, a1);
        }
      });
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
        cp_async(sa + c * a_vec, ga + c * a_vec, a_bytes, valid ? a_bytes : 0);
      const float* gb = B + row * ldb + n0;
      float* sb = b_tile(st) + rr * kWgStrideB;
      for (int c = copy_lane; c < b_per_row; c += 32)
        cp_async(sb + c * b_vec, gb + c * b_vec, b_bytes, valid ? b_bytes : 0);
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
                       void* do1_s, void* ws, int M, int L, int D, int H, int Q, float scale,
                       unsigned seed, int block_rows, unsigned threshold, float keep_scale,
                       cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr bool kF32 = sizeof(T) == 4;
  // the weights as the kernels read them, in ws (WsLayout), once per call
  const WsLayout wl = ws_layout(D, H, Q);
  bf16* w_hi = static_cast<bf16*>(ws);
  bf16* w_lo = kF32 ? w_hi + wl.total : nullptr;
  const long n_w = 3L * D * D + (long)D * D + (long)D * Q;
  stage_weights_kernel<T><<<(int)((n_w + 255) / 256 < 2048 ? (n_w + 255) / 256 : 2048), 256, 0,
                            stream>>>(static_cast<const T*>(wqkv), static_cast<const T*>(wo),
                                      static_cast<const T*>(aw), D, H, Q, w_hi, w_lo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto lo_of = [&](long off) { return kF32 ? w_lo + off : nullptr; };
  const int tiles = (M + items_per_tile(L) - 1) / items_per_tile(L);
  const int dhp = round16(D / H);
  const BOp wo_b = plain_b(w_hi + wl.o, lo_of(wl.o), wl.ld_o, D, D);
  const BOp aw_b = plain_b(w_hi + wl.aw, lo_of(wl.aw), wl.ld_aw, D, Q);
  const BOp qkv_t = transposed(plain_b(w_hi + wl.qkv, lo_of(wl.qkv), wl.ld_qkv, D, 3 * D));
  // head 0's q|k|v columns, each padded to dhp (the kernel moves to head h)
  const BOp qkv_head{w_hi + wl.head, lo_of(wl.head), wl.ld_head, D, 3 * dhp, dhp, D / H};

  const bool wide = tile_rows(L) > kTileRows;
  auto pool_kernel = wide ? pool_bwd_kernel<T, true> : pool_bwd_kernel<T, false>;
  const int pool_smem = (int)pool_smem_bytes<kF32>(L, D, Q);
  const int attn_smem = (int)attn_smem_bytes<kF32>(L, D, H), dx_smem = (int)dx_smem_bytes<kF32>();
  if ((err = cudaFuncSetAttribute(pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  pool_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(attn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  attn_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dx_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  dx_smem)) != cudaSuccess)
    return err;
  static_assert(Cfg<kF32>::Pool::W == Cfg<kF32>::PoolWide::W, "one block size for pool_bwd");
  pool_kernel<<<tiles, 32 * Cfg<kF32>::Pool::W, pool_smem, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(mask), static_cast<const T*>(o1),
      wo_b, aw_b, static_cast<const T*>(bo), static_cast<const T*>(ab),
      static_cast<const T*>(aq), static_cast<float*>(o2_s), static_cast<float*>(t_s),
      static_cast<float*>(dpre_s), static_cast<float*>(do2_s), static_cast<float*>(ds_s),
      static_cast<T*>(do1_s), M, L, D, Q, seed, block_rows, threshold, keep_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_kernel<T><<<tiles, 32 * Cfg<kF32>::Attn::W, attn_smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mask), qkv_head,
      static_cast<const T*>(bqkv), static_cast<const T*>(do1_s), static_cast<float*>(dqkv_s), M,
      L, D, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr int dx_cols = Cfg<kF32>::Dx::NT;
  const long rows = (long)M * L;
  dx_kernel<T><<<dim3((int)((rows + kTileRows - 1) / kTileRows), (D + dx_cols - 1) / dx_cols),
                 32 * Cfg<kF32>::Dx::W, dx_smem, stream>>>(
      static_cast<const float*>(dqkv_s), qkv_t, static_cast<T*>(dx), rows, D);
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
// [M*L, D], ds_s [M*L], dqkv_s [M*L, 3D]) are float32. ws: room for
// newsrec_fused_encoder_bwd_ws_elems(D, H, Q) bfloat16 values, twice that
// for float32 (the weights as the kernels read them). Dropout arguments as
// for newsrec_fused_encoder_fwd, and equal to the forward's. All operands
// contiguous on one device. Returns a cudaError_t code.
int newsrec_fused_encoder_bwd(int dtype, const void* g, const void* x, const void* mask,
                              const void* o1, const void* wqkv, const void* bqkv, const void* wo,
                              const void* bo, const void* aw, const void* ab, const void* aq,
                              void* dx, void* o2_s, void* t_s, void* dpre_s, void* do2_s,
                              void* ds_s, void* dqkv_s, void* do1_s, void* ws, int M, int L,
                              int D, int H,
                              int Q, float scale, unsigned seed, int block_rows,
                              unsigned threshold, float keep_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(g, x, mask, o1, wqkv, bqkv, wo, bo, aw, ab, aq, dx, o2_s, t_s,
                             dpre_s, do2_s, ds_s, dqkv_s, do1_s, ws, M, L, D, H, Q, scale, seed,
                             block_rows, threshold, keep_scale, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(g, x, mask, o1, wqkv, bqkv, wo, bo, aw, ab, aq, dx, o2_s,
                                     t_s, dpre_s, do2_s, ds_s, dqkv_s, do1_s, ws, M, L, D, H, Q,
                                     scale, seed, block_rows, threshold, keep_scale, s);
  return cudaErrorInvalidValue;
}

// the most shared memory one block of the backward's kernels needs (dtype
// as for newsrec_fused_encoder_bwd)
long newsrec_fused_encoder_bwd_smem_bytes(int dtype, int L, int D, int H, int Q) {
  const bool f32 = dtype == 0;
  const long p = f32 ? pool_smem_bytes<true>(L, D, Q) : pool_smem_bytes<false>(L, D, Q);
  const long a = f32 ? attn_smem_bytes<true>(L, D, H) : attn_smem_bytes<false>(L, D, H);
  const long d = f32 ? dx_smem_bytes<true>() : dx_smem_bytes<false>();
  return p > a ? (p > d ? p : d) : (a > d ? a : d);
}

// the tiles of pool_bwd and attn_bwd at item length L: whole items per
// block, and the block's token rows
void newsrec_fused_encoder_bwd_tile(int L, int* items, int* rows) {
  *items = items_per_tile(L);
  *rows = tile_rows(L);
}

// bfloat16 values of the weights' layout for the per-item kernels (ws of
// newsrec_fused_encoder_bwd holds this many, twice for float32)
long newsrec_fused_encoder_bwd_ws_elems(int D, int H, int Q) { return ws_layout(D, H, Q).total; }

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
