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
//             e = exp(s - rowmax), o1 = (T(e) @ v) / rowsum(e)
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
// Layout: tiles of whole items on the tensor cores, as in the backward
// (tiles.cuh: 64 token rows, 5 items at L=12, 3 at L=20, 1 at L=50; one
// item of round16(L) rows past 64). Three launches per call:
//   stage_weights_kernel: the weights re-laid into ws (WsLayout: head-major
//              Wqkv with dh padded to 16, every row 16-byte aligned), so
//              that every weight copy is one 16-byte cp.async;
//   fwd_attn:  per tile and head, q|k|v = T(x Wqkv + b) over the head's
//              columns (tile_product), the scores over the tile's block
//              diagonal, the softmax in registers (the row sum in f32 before
//              e is rounded to T), o1 = T((T(e) v) / rowsum); writes o1;
//   fwd_tail:  per tile, o2 = o1 Wo + bo and the dropout into f32 rows in
//              shared memory, tanh(T(o2) aw + ab) aq (T(o2) rounded or split
//              while its fragments are loaded), summed per row in a fixed
//              order, the pooling softmax per item with max(den, 1e-30) and
//              out = T(sum_l w_l o2_l / den).
// * Every product is mma.sync m16n8k16 bf16 with f32 sums. In bf16 every
//   operand is already bf16 at the TPU kernel's rounding points (x, q, k, v,
//   T(e), o1, T(o2)): one pass. In f32 (T = float) operands and weights are
//   split into bf16 high and low parts, three passes (A_hi B_hi + A_lo B_hi +
//   A_hi B_lo), some 2^-16 of each product, as in the backward.
// * A tile's rows (x, then o1) are staged by 8-byte cp.async copies all in
//   flight at once in bf16 (600-byte rows allow no wider copy), and by
//   loads split into high and low parts in f32.
// * o1 always goes through device memory between the two kernels (a scratch
//   buffer when the caller does not ask for it): the attention's operand
//   tiles and the tail's f32 rows do not fit one block's shared memory
//   together at 64 rows in f32. At M=4096, L=20 in bf16 that is 49 MB
//   written and read once.
// * Small M: fwd_attn takes every head of a tile in one block when there are
//   at least kAllHeadsTiles tiles, else one head per block (M=1 and M=32 at
//   L=50 give 10 and 320 blocks, not 1 and 32); a head's results are the
//   same bits either way.
// * Penalty between items. Within an item the TPU kernel's (m_i m_j - 1)
//   1e9; between items of a tile -2e9. Exactness: a real row's max is one of
//   its item's real scores, and exp(-1e9 - max) and exp(-2e9 - max) are 0 in
//   f32, so its probabilities are its item's. A pad row's scores within its
//   item are s - 1e9, the rest s - 2e9: its max lies in its own item (|s| <<
//   1e9) and exp(-1e9) is 0, so it too spreads over its own item only, and
//   every row of o1, pad rows included, is the per-item kernel's up to the
//   order of the f32 sums. (With -1e9 between items a pad row would spread
//   over the whole tile; the backward's tiles may do so because a pad row's
//   dO1 is 0, but the forward writes o1 for every row and the backward reads
//   it.) Rows past the tile's last item form items of their own and are
//   written nowhere.
// * No atomics; every sum has a fixed order (the pooling logit: pairs of
//   columns from the product's epilogue, then a warp's strided sum), so two
//   launches give the same bits. The dropout mask is the hash of the global
//   token row, which no tiling changes.
// * Shared memory limits L: at D=300, Q=200 every L up to 80 fits in both
//   dtypes (newsrec_fused_encoder_smem_bytes; the wrapper raises past 227 KB).
//
// Bound. At L=20 an item needs 2*L*D*(3D+D+Q) + 4*H*L^2*dh = 17.3 MFLOP
// and moves 12 KB (bf16 tokens in, one vector out), so the work is bound by
// operations: 1.13 TFLOP for a 65,238-news corpus, 1.1 ms at the bf16 peak.
// At L=20 a 64-row tile issues some 15 k m16n8k16 MMAs (QKV 9,120, Wo 2,888,
// aw 1,976, attention 1,280, the block diagonal's 64^2 scores included).

#include "tiles.cuh"

namespace {

// tiles at or past which one block takes every head of its tile
constexpr int kAllHeadsTiles = 264;

// fwd_attn's scores [Rt, Rt + 4] f32; T(e) (high and, in f32, low) takes
// their rows, as attn_bwd's T(P)
__host__ __device__ inline long fwd_scores_bytes(long Rt) { return Rt * (Rt + 4) * 4; }

// shared memory of fwd_attn: x's A tiles; a head's q, k, v tiles (high and,
// in f32, low); the weight ring, aliased by the scores; the mask, the rows'
// items, the row sums; the head's biases
template <bool kF32> __host__ __device__ inline long attn_fwd_smem_bytes(int L, int D, int H) {
  using C = typename Cfg<kF32>::Attn;
  const long Rt = tile_rows(L), ldh = round16(D / H) + 8, parts = kF32 ? 2 : 1;
  const long sc = fwd_scores_bytes(Rt);
  const long ring = C::ST * b_stage_bytes<C::NT>(kF32);
  return parts * (2 * Rt * lda_of(D) + 6 * Rt * ldh) + (sc > ring ? sc : ring) + 12 * Rt +
         12 * round16(D / H);
}

// shared memory of fwd_tail: o1's A tiles (high and low), later the
// pooling terms [Rt, Q / 2]; o2 in f32 [Rt, lda_of(D)]; the weight ring;
// the mask, the logits, the items' denominators; bo, ab, aq
template <bool kF32, bool kWide> __host__ __device__ inline long tail_fwd_smem_bytes_of(int L, int D, int Q) {
  using C = PoolCfg<kF32, kWide>;
  const long Rt = tile_rows(L), parts = kF32 ? 2 : 1;
  const long a = parts * 2 * Rt * lda_of(D), terms = 2L * Rt * Q;
  return (a > terms ? a : terms) + 4 * Rt * lda_of(D) + C::ST * b_stage_bytes<C::NT>(kF32) +
         12 * Rt + 4L * (D + 2 * Q);
}
template <bool kF32> __host__ __device__ inline long tail_fwd_smem_bytes(int L, int D, int Q) {
  return tile_rows(L) > kTileRows ? tail_fwd_smem_bytes_of<kF32, true>(L, D, Q)
                                  : tail_fwd_smem_bytes_of<kF32, false>(L, D, Q);
}

// An f32 A operand held whole in shared memory (rows of ld floats, ld % 32
// 8 or 24, so that the float2 loads of a half warp fall in distinct banks):
// rounded to bf16 (one pass), or split into high and low parts, while the
// fragments are loaded
struct ASmemF32 {
  const float* a;
  int ld;
  __host__ __device__ static int stage_bytes(int) { return 0; }
  __device__ void load(unsigned char*, int) const {}
  __device__ void frag(const unsigned char*, int m0, int k, int, unsigned* h, unsigned* l,
                       bool split) const {
    const int lane = threadIdx.x & 31;
    const float* p = a + (m0 + (lane >> 2)) * ld + k + 2 * (lane & 3);
    const float2 v[4] = {*reinterpret_cast<const float2*>(p),
                         *reinterpret_cast<const float2*>(p + 8 * ld),
                         *reinterpret_cast<const float2*>(p + 8),
                         *reinterpret_cast<const float2*>(p + 8 * ld + 8)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (split) {
        split_bf16x2(v[i].x, v[i].y, h[i], l[i]);
      } else {
        const __nv_bfloat162 b = __floats2bfloat162_rn(v[i].x, v[i].y);
        h[i] = *reinterpret_cast<const unsigned*>(&b);
      }
    }
  }
};

// A tile's rows of a bf16 matrix in device memory (row stride ld, cols % 4
// == 0) into an operand tile of Rt rows and cols16 columns (row stride
// ldt), zeros past rows and cols, by 8-byte cp.async in one group: all the
// copies are in flight at once. The first wait of the tile_product that
// reads the tile covers the group (groups complete in order).
__device__ __forceinline__ void copy_tile(const __nv_bfloat16* __restrict__ src, long ld,
                                          int rows, int cols, int Rt, int cols16,
                                          __nv_bfloat16* dst, int ldt) {
  const int per = cols16 / 4;
  for (int i = threadIdx.x; i < Rt * per; i += blockDim.x) {
    const int r = i / per, c = i % per * 4;
    const bool valid = r < rows && c < cols;
    cp_async(dst + r * ldt + c, valid ? src + r * ld + c : src, 8, valid ? 8 : 0);
  }
  cp_async_commit();
}

// the staging of a tile's T rows: copied as they are in bf16, split into
// high and low parts in f32
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int rows, int D, int Rt,
                                           __nv_bfloat16* hi, __nv_bfloat16* lo, int ldt) {
  if constexpr (sizeof(T) == 4)
    stage_tile<4>(src, D, rows, D, Rt, round16(D), hi, lo, ldt, true);
  else
    copy_tile(src, D, rows, D, Rt, round16(D), hi, ldt);
}

// One block per tile of whole items and group of hpb heads: per head, q|k|v
// = T(x Wqkv + b) over the head's columns (each of q, k, v padded from dh to
// round16(dh) with zeros), the scores over the tile's block diagonal, the
// softmax (8 lanes a row up to 64 rows), o1 = T((T(e) v) / rowsum); writes
// the head's columns of o1 for the tile's rows.
template <typename T>
__global__ void __launch_bounds__(256, 1)
fwd_attn_kernel(const T* __restrict__ x, const float* __restrict__ mask, BOp wqkv,
                const T* __restrict__ bqkv, T* __restrict__ o1_g, int M, int L, int D, int H,
                int hpb, float scale) {
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Rt = tile_rows(L), ipt = items_per_tile(L);
  const int dh = D / H, dhp = round16(dh), ldh = dhp + 8, ldX = lda_of(D);
  // T(e) takes the rows of the scores: a row's f32 values are read before
  // its bf16 ones are written (by the same lanes), high parts at 0, low
  // parts at Rt + 8 (16-byte aligned) of the row
  const int ldS = Rt + 4, ldP = 2 * ldS;
  using C = typename Cfg<kF32>::Attn;
  constexpr int parts = kF32 ? 2 : 1;  // low parts in f32 only
  __nv_bfloat16* x_hi = reinterpret_cast<__nv_bfloat16*>(smem);  // [Rt, ldX]
  __nv_bfloat16* x_lo = x_hi + Rt * ldX;
  // q, k, v of one head, [Rt, ldh] each: high parts, then low parts
  __nv_bfloat16* hd = x_hi + parts * Rt * ldX;
  auto head_hi = [=](int i) { return hd + i * Rt * ldh; };
  auto head_lo = [=](int i) { return hd + (3 + i) * Rt * ldh; };
  unsigned char* ring = reinterpret_cast<unsigned char*>(hd + parts * 3 * Rt * ldh);
  float* S = reinterpret_cast<float*>(ring);                   // [Rt, ldS] scores
  __nv_bfloat16* p_hi = reinterpret_cast<__nv_bfloat16*>(S);  // [Rt, ldP] T(e)
  __nv_bfloat16* p_lo = p_hi + Rt + 8;
  const long sc = fwd_scores_bytes(Rt), rb = C::ST * b_stage_bytes<C::NT>(kF32);
  float* mk = reinterpret_cast<float*>(ring + (sc > rb ? sc : rb));  // [Rt] mask
  int* itm = reinterpret_cast<int*>(mk + Rt);                        // [Rt] item of a row
  float* rs = reinterpret_cast<float*>(itm + Rt);                    // [Rt] softmax row sums
  float* hb = rs + Rt;  // [3 dhp] the head's q|k|v biases

  const int item0 = blockIdx.x * ipt;
  const int nitems = M - item0 < ipt ? M - item0 : ipt, nrows = nitems * L;
  const long row0 = (long)item0 * L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  stage_rows(x + row0 * D, nrows, D, Rt, x_hi, x_lo, ldX);
  for (int r = tid; r < Rt; r += blockDim.x) {
    mk[r] = r < nrows ? mask[row0 + r] : 0.f;
    itm[r] = r / L;  // rows past the last item fall in items of their own
  }
  // the TPU kernel's penalty within an item; twice it between items, so
  // that a pad row spreads over its own item only
  auto pen = [=](int i, int j) {
    return itm[i] == itm[j] ? (mk[i] * mk[j] - 1.f) * 1e9f : -2e9f;
  };
  const int nm = Rt / 16, nn = (Rt + 31) / 32, nd = dhp / 16;

  const int h0 = (int)blockIdx.y * hpb, h_end = h0 + hpb < H ? h0 + hpb : H;
  for (int h = h0; h < h_end; ++h) {
    // q (scaled), k, v = T(x Wqkv + bqkv) over the head's columns
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
    // scores q k^T + penalty over the tile, 16 x 32 units
    for (int u = warp; u < nm * nn; u += C::W) {
      const int m0 = u / nn * 16, n0 = u % nn * 32;
      float sa[4][4] = {};
      for (int k = 0; k < dhp; k += 16) {
        unsigned qh[4], ql[4];
        frag_a(qh, head_hi(0), ldh, m0, k);
        if (kF32) frag_a(ql, head_lo(0), ldh, m0, k);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int n = n0 + 16 * jj;
          if (n >= Rt) break;
          unsigned kb[2][2];
          frag_b_t(kb, head_hi(1), ldh, n, k);
#pragma unroll
          for (int e = 0; e < 2; ++e) mma_bf16(sa[2 * jj + e], qh, kb[e]);
          if (kF32) {
            unsigned kl[2][2];
            frag_b_t(kl, head_lo(1), ldh, n, k);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              mma_bf16(sa[2 * jj + e], ql, kb[e]);
              mma_bf16(sa[2 * jj + e], qh, kl[e]);
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
        }
      }
    }
    __syncthreads();
    // e = exp(s - rowmax), its row sum in f32, then T(e): G lanes a row (8
    // up to Rt = 64, else 32), up to 8 values a lane; at G = 8 a pass takes
    // rows 2 apart, as in attn_bwd
    {
      const int G = Rt <= 64 ? 8 : 32, R = 32 / G, j0 = lane % G;
      for (int b0 = warp * 2 * R; b0 < Rt; b0 += C::W * 2 * R) {
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const int i = b0 + 2 * (lane / G) + par;
          float sv[8];
          float mx = -INFINITY;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int j = j0 + G * c;
            sv[c] = j < Rt ? S[i * ldS + j] : -INFINITY;
            mx = fmaxf(mx, sv[c]);
          }
          mx = group_max(mx, G);
          float sum = 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            sv[c] = j0 + G * c < Rt ? expf(sv[c] - mx) : 0.f;
            sum += sv[c];
          }
          sum = group_sum(sum, G);
          if (j0 == 0) rs[i] = sum;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int j = j0 + G * c;
            if (j < Rt) put(p_hi, p_lo, i * ldP + j, rnd<T>(sv[c]), kF32);
          }
        }
      }
    }
    __syncthreads();
    // o1 = T((T(e) v) / rowsum), 16 x 16 units (8 at dh = 30: one a warp)
    for (int u = warp; u < nm * nd; u += C::W) {
      const int m0 = u / nd * 16, n0 = u % nd * 16;
      float acc[2][4] = {};
      for (int k = 0; k < Rt; k += 16) {
        unsigned ah[4], al[4], bh[2][2];
        frag_a(ah, p_hi, ldP, m0, k);
        if (kF32) frag_a(al, p_lo, ldP, m0, k);
        frag_b(bh, head_hi(2), ldh, n0, k);
#pragma unroll
        for (int e = 0; e < 2; ++e) mma_bf16(acc[e], ah, bh[e]);
        if (kF32) {
          unsigned bl[2][2];
          frag_b(bl, head_lo(2), ldh, n0, k);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            mma_bf16(acc[e], al, bh[e]);
            mma_bf16(acc[e], ah, bl[e]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = n0 + j * 8 + 2 * t;
        if (d >= dh) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = m0 + g + 8 * hh;
          if (i < nrows) {
            store2(o1_g + (row0 + i) * D + h * dh + d, acc[j][2 * hh] / rs[i],
                   acc[j][2 * hh + 1] / rs[i]);
          }
        }
      }
    }
    __syncthreads();  // the head's tiles, the scores and the ring are free again
  }
}

// One block per tile of whole items: o2 = o1 Wo + bo (dropout) into f32
// rows, the pooling terms tanh(T(o2) aw + ab) aq summed per row, the pooling
// softmax per item and out = T(sum_l w_l o2_l / max(den, 1e-30)).
template <typename T, bool kWide>
__global__ void __launch_bounds__(512, 1)
fwd_tail_kernel(const float* __restrict__ mask, const T* __restrict__ o1, BOp wo, BOp aw,
                const T* __restrict__ bo, const T* __restrict__ ab, const T* __restrict__ aq,
                T* __restrict__ out, int M, int L, int D, int Q, unsigned seed, int block_rows,
                unsigned threshold, float keep_scale) {
  constexpr bool kF32 = sizeof(T) == 4;
  using C = PoolCfg<kF32, kWide>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Rt = tile_rows(L), ipt = items_per_tile(L);
  const int ldA = lda_of(D), D16 = round16(D), Qh = Q / 2;
  constexpr int parts = kF32 ? 2 : 1;
  __nv_bfloat16* a_hi = reinterpret_cast<__nv_bfloat16*>(smem);  // [Rt, ldA] o1
  __nv_bfloat16* a_lo = a_hi + Rt * ldA;
  float* terms = reinterpret_cast<float*>(smem);                  // [Rt, Qh], after o1
  const long a_bytes = (long)parts * 2 * Rt * ldA, t_bytes = 4L * Rt * Qh;
  float* o2s = reinterpret_cast<float*>(smem + (a_bytes > t_bytes ? a_bytes : t_bytes));
  unsigned char* ring = reinterpret_cast<unsigned char*>(o2s + Rt * ldA);  // o2 [Rt, ldA]
  float* mk = reinterpret_cast<float*>(ring + C::ST * b_stage_bytes<C::NT>(kF32));
  float* pw = mk + Rt;    // pooling logits, then exp(logit - max)
  float* dn = pw + Rt;    // [Rt] an item's max(den, 1e-30)
  float* bos = dn + Rt;   // bo, ab, aq in f32
  float* abs_ = bos + D;
  float* aqs = abs_ + Q;

  const int item0 = blockIdx.x * ipt;
  const int nitems = M - item0 < ipt ? M - item0 : ipt, nrows = nitems * L;
  const long row0 = (long)item0 * L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  stage_rows(o1 + row0 * D, nrows, D, Rt, a_hi, a_lo, ldA);
  for (int r = tid; r < Rt; r += blockDim.x) mk[r] = r < nrows ? mask[row0 + r] : 0.f;
  for (int i = tid; i < D; i += blockDim.x) bos[i] = to_f(bo[i]);
  for (int i = tid; i < Q; i += blockDim.x) {
    abs_[i] = to_f(ab[i]);
    aqs[i] = to_f(aq[i]);
  }
  // o2's columns past D are the next product's zero depth pad
  for (int i = tid; i < Rt * (D16 - D); i += blockDim.x)
    o2s[i / (D16 - D) * ldA + D + i % (D16 - D)] = 0.f;

  // o2 = o1 @ Wo + bo, then dropout on the items' rows (rows past them 0)
  tile_product<C::NT, C::UJ, C::ST, C::W, false, kF32, kF32>(
      ASmem{a_hi, a_lo, ldA}, wo, Rt, ring, [=](int r, int n, float a0, float a1) {
        float v0 = 0.f, v1 = 0.f;
        if (r < nrows) {
          v0 = dropout(a0 + bos[n], seed, block_rows, row0 + r, n, threshold, keep_scale);
          v1 = dropout(a1 + bos[n + 1], seed, block_rows, row0 + r, n + 1, threshold,
                       keep_scale);
        }
        store2(o2s + r * ldA + n, v0, v1);
      });
  // tanh(T(o2) @ aw + ab) * aq, two columns summed per term (o1 is spent)
  tile_product<C::NT, C::UJ, C::ST, C::W, false, kF32, kF32>(
      ASmemF32{o2s, ldA}, aw, Rt, ring, [=](int r, int n, float a0, float a1) {
        if (r < nrows)
          terms[r * Qh + n / 2] =
              tanhf(a0 + abs_[n]) * aqs[n] + tanhf(a1 + abs_[n + 1]) * aqs[n + 1];
      });
  // pooling logits, one warp per row, the terms in a fixed order
  for (int r = warp; r < nrows; r += C::W) {
    float s = 0.f;
    for (int q = lane; q < Qh; q += 32) s += terms[r * Qh + q];
    s = warp_sum(s);
    if (lane == 0) pw[r] = mk[r] > 0.f ? s : -1e9f;
  }
  __syncthreads();
  // softmax over each item, one warp per item: the item's own max, pad
  // tokens 0, den = max(sum e, 1e-30) (an all-pad item pools to 0)
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
    den = warp_sum(den);
    if (lane == 0) dn[it] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  for (int e = tid; e < nitems * D; e += blockDim.x) {
    const int it = e / D, d = e % D;
    const float* p = pw + it * L;
    const float* o = o2s + (long)it * L * ldA + d;
    float num = 0.f;
    for (int i = 0; i < L; ++i) num = fmaf(p[i], o[i * ldA], num);
    out[(long)(item0 + it) * D + d] = from_f<T>(num / dn[it]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* mask, const void* wqkv, const void* bqkv,
                   const void* wo, const void* bo, const void* aw, const void* ab,
                   const void* aq, void* out, void* o1, void* ws, int M, int L, int D, int H,
                   int Q, float scale, unsigned seed, int block_rows, unsigned threshold,
                   float keep_scale, cudaStream_t stream) {
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
  // head 0's q|k|v columns, each padded to dhp (the kernel moves to head h)
  const BOp qkv_head{w_hi + wl.head, lo_of(wl.head), wl.ld_head, D, 3 * dhp, dhp, D / H};

  const bool wide = tile_rows(L) > kTileRows;
  auto tail_kernel = wide ? fwd_tail_kernel<T, true> : fwd_tail_kernel<T, false>;
  const int attn_smem = (int)attn_fwd_smem_bytes<kF32>(L, D, H);
  const int tail_smem = (int)tail_fwd_smem_bytes<kF32>(L, D, Q);
  if ((err = cudaFuncSetAttribute(fwd_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  attn_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  tail_smem)) != cudaSuccess)
    return err;
  const int hpb = tiles >= kAllHeadsTiles ? H : 1;
  fwd_attn_kernel<T><<<dim3(tiles, (H + hpb - 1) / hpb), 32 * Cfg<kF32>::Attn::W, attn_smem,
                       stream>>>(static_cast<const T*>(x), static_cast<const float*>(mask),
                                 qkv_head, static_cast<const T*>(bqkv), static_cast<T*>(o1), M,
                                 L, D, H, hpb, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  static_assert(Cfg<kF32>::Pool::W == Cfg<kF32>::PoolWide::W, "one block size for fwd_tail");
  tail_kernel<<<tiles, 32 * Cfg<kF32>::Pool::W, tail_smem, stream>>>(
      static_cast<const float*>(mask), static_cast<const T*>(o1), wo_b, aw_b,
      static_cast<const T*>(bo), static_cast<const T*>(ab), static_cast<const T*>(aq),
      static_cast<T*>(out), M, L, D, Q, seed, block_rows, threshold, keep_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, weights, out and o1); mask is
// float32. o1 [M, L, D] is always written (the caller's scratch when it
// does not want the residual). ws: room for
// newsrec_fused_encoder_fwd_ws_elems(D, H, Q) bfloat16 values, twice that
// for float32 (the weights as the kernels read them). Dropout: seed, token
// rows per hash block, threshold = rate * 2^32, keep_scale = 1 / (1 - rate);
// threshold 0 and keep_scale 1 mean no dropout. Needs Q % 2 == 0 and an
// even head width. All operands contiguous on one device, 16-byte aligned.
// Returns a cudaError_t code.
int newsrec_fused_encoder_fwd(int dtype, const void* x, const void* mask, const void* wqkv,
                              const void* bqkv, const void* wo, const void* bo, const void* aw,
                              const void* ab, const void* aq, void* out, void* o1, void* ws,
                              int M, int L, int D, int H, int Q, float scale, unsigned seed,
                              int block_rows, unsigned threshold, float keep_scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, mask, wqkv, bqkv, wo, bo, aw, ab, aq, out, o1, ws, M, L, D, H, Q,
                         scale, seed, block_rows, threshold, keep_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, mask, wqkv, bqkv, wo, bo, aw, ab, aq, out, o1, ws, M, L, D,
                                 H, Q, scale, seed, block_rows, threshold, keep_scale, s);
  return cudaErrorInvalidValue;
}

// the most shared memory one block of the forward's kernels needs
long newsrec_fused_encoder_smem_bytes(int dtype, int L, int D, int H, int Q) {
  const bool f32 = dtype == 0;
  const long a = f32 ? attn_fwd_smem_bytes<true>(L, D, H) : attn_fwd_smem_bytes<false>(L, D, H);
  const long t = f32 ? tail_fwd_smem_bytes<true>(L, D, Q) : tail_fwd_smem_bytes<false>(L, D, Q);
  return a > t ? a : t;
}

// the forward's tiles at item length L: whole items per block, and the
// block's token rows
void newsrec_fused_encoder_fwd_tile(int L, int* items, int* rows) {
  *items = items_per_tile(L);
  *rows = tile_rows(L);
}

// bfloat16 values of the weights' layout (ws of newsrec_fused_encoder_fwd
// holds this many, twice for float32)
long newsrec_fused_encoder_fwd_ws_elems(int D, int H, int Q) { return ws_layout(D, H, Q).total; }

const char* newsrec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
