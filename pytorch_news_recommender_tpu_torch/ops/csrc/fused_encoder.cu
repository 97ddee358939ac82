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
//   stage_weights_kernel: the weights re-laid into ws: for wgmma (bf16,
//              tiles of at most 64 rows) TlLayout's K-major core matrices,
//              a head's q|k|v columns with dh padded to 16 and pads written
//              as zeros, each 64-deep weight tile one bulk copy; for
//              mma.sync WsLayout (head-major Wqkv with dh padded to 16,
//              every row 16-byte aligned, every copy one 16-byte cp.async);
//   fwd_attn:  per tile and head, q|k|v = T(x Wqkv + b) over the head's
//              columns (tile_product), the scores over the tile's block
//              diagonal, the softmax in registers (the row sum in f32 before
//              e is rounded to T), o1 = T((T(e) v) / rowsum); writes o1;
//   fwd_tail:  per tile, o2 = o1 Wo + bo and the dropout into f32 rows in
//              shared memory, tanh(T(o2) aw + ab) aq (T(o2) rounded or split
//              while its fragments are loaded), summed per row in a fixed
//              order, the pooling softmax per item with max(den, 1e-30) and
//              out = T(sum_l w_l o2_l / den).
// * Every product is bf16 on the tensor cores with f32 sums. The weight
//   products (QKV, Wo, aw) go through tile_product: in bf16, at tiles of at
//   most 64 rows, on wgmma m64nNk16 (tiles.cuh: a head's 96 columns as two
//   warpgroups of 48 in fwd_attn, 128-column chunks as four of 32 in
//   fwd_tail); the attention's scores and P v stay on mma.sync m16n8k16. In
//   bf16 every operand is already bf16 at the TPU kernel's rounding points
//   (x, q, k, v, T(e), o1, T(o2)): one pass. In f32 (T = float) operands and
//   weights are split into bf16 high and low parts, three passes (A_hi B_hi
//   + A_lo B_hi + A_hi B_lo), some 2^-16 of each product, as in the
//   backward, all on mma.sync, as is one item of L > 64.
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
// * Wide D (NAML's user tower: D=800, 10 heads of 80, Q=400, L=50). There
//   fwd_tail's f32 o2 rows alone take 206,848 B (372,736 B in all in bf16)
//   and, in f32, fwd_attn's x tiles another 206,848 B (331,456 B in all).
//   A kernel whose layout does not fit one block takes its wide variant
//   (fwd_variant; tiles.cuh's kVar* bits), for tiles of at most 64 rows:
//   fwd_tail writes o2 to device memory (the caller's f32 scratch [M*L, D])
//   in the Wo product's epilogue and reads it back for T(o2) and for the
//   pooled sum, the same f32 values summed in the same order; in bf16 o1's
//   tile, then T(o2)'s, stays in shared memory (217,088 B), in f32 both
//   are streamed through the ring (132,096 B). fwd_attn in f32 streams x
//   through the ring (AStream, split in registers; 161,472 B) and keeps its
//   bf16 layout (180,416 B). At D=300 every kernel keeps its layout,
//   launches and bits. dh = 80 needs no other change: a head's q|k|v
//   columns are three 96-wide chunks (Cfg::Attn), the o1 product five
//   16-column units per row block. The same variants serve the user towers
//   of nrms_bert (D=512, dh=128, Q=400: 179,072 B in bf16, 198,912 B in
//   f32) and disan (D=600, dh=60 padded to 64, Q=200: 164,512 B, 148,992 B).
//
// Bound. At L=20 an item needs 2*L*D*(3D+D+Q) + 4*H*L^2*dh = 17.3 MFLOP
// and moves 12 KB (bf16 tokens in, one vector out), so the work is bound by
// operations: 1.13 TFLOP for a 65,238-news corpus, 1.1 ms at the bf16 peak.
// At L=20 a 64-row tile holds some 15 k m16n8k16 MMAs' work (QKV 9,120, Wo
// 2,888, aw 1,976, attention 1,280, the block diagonal's 64^2 scores
// included); on wgmma the weight products are 703 m64nNk16 a tile.
// Measured on an H100 80GB HBM3 at 700 W, M=28,672, L=20, bf16: the forward
// 5.54 ms (7.42 on mma.sync), its QKV product (the ablation's V1) 1.78 ms
// (3.20) against a 0.313 ms bound: the wgmma engine is bound by its issue
// and latency, not by the tensor cores (tiles.cuh).

#include "tiles.cuh"

namespace {

// tiles at or past which one block takes every head of its tile
constexpr int kAllHeadsTiles = 264;

// fwd_attn's scores [Rt, Rt + 4] f32; T(e) (high and, in f32, low) takes
// their rows, as attn_bwd's T(P)
__host__ __device__ inline long fwd_scores_bytes(long Rt) { return Rt * (Rt + 4) * 4; }

// shared memory of fwd_attn: x's A tiles (none when x is streamed); a
// head's q, k, v tiles (high and, in f32, low); the weight ring (with x's
// stages when streamed), aliased by the scores; the mask, the rows' items,
// the row sums; the head's biases
template <bool kF32, bool kStream = false>
__host__ __device__ inline long attn_fwd_smem_bytes(int L, int D, int H) {
  using C = typename Cfg<kF32>::Attn;
  const long Rt = tile_rows(L), ldh = round16(D / H) + 8, parts = kF32 ? 2 : 1;
  const long sc = fwd_scores_bytes(Rt);
  const long ring = C::ST * ((kStream ? AStream::stage_bytes(Rt) : 0) + b_stage_bytes<C::NT>(kF32));
  return (kStream ? 0 : parts * 2 * Rt * lda_of(D)) + parts * 6 * Rt * ldh +
         (sc > ring ? sc : ring) + 12 * Rt + 12 * round16(D / H);
}

// shared memory of fwd_tail: o1's A tiles (high and low), later the
// pooling terms [Rt, Q / 2]; o2 in f32 [Rt, lda_of(D)]; the weight ring;
// the mask, the logits, the items' denominators; bo, ab, aq. The wide
// variant (kWideD) keeps o2 in device memory: in bf16 o1's tile, then
// T(o2)'s, one part, beside the terms; in f32 both streamed through the ring.
template <bool kF32, bool kWide, bool kWideD = false>
__host__ __device__ inline long tail_fwd_smem_bytes_of(int L, int D, int Q) {
  using C = PoolCfg<kF32, kWide>;
  const long Rt = tile_rows(L), parts = kF32 ? 2 : 1;
  const long terms = 2L * Rt * Q, small = 12 * Rt + 4L * (D + 2 * Q);
  if (kWideD)
    return (kF32 ? 0 : 2 * Rt * lda_of(D)) + terms +
           C::ST * ((kF32 ? AStream::stage_bytes(Rt) : 0) + b_stage_bytes<C::NT>(kF32)) + small;
  const long a = parts * 2 * Rt * lda_of(D);
  return (a > terms ? a : terms) + 4 * Rt * lda_of(D) + C::ST * b_stage_bytes<C::NT>(kF32) + small;
}
template <bool kF32> __host__ __device__ inline long tail_fwd_smem_bytes(int L, int D, int Q) {
  return tile_rows(L) > kTileRows ? tail_fwd_smem_bytes_of<kF32, true>(L, D, Q)
                                  : tail_fwd_smem_bytes_of<kF32, false>(L, D, Q);
}

// The forward's wide variants at these shapes (kVarFwdAttn, kVarFwdTail):
// only where a kernel's layout does not fit one block, for tiles of at
// most 64 rows; x is streamed in f32 only
template <bool kF32> int fwd_variant(int L, int D, int H, int Q) {
  if (tile_rows(L) > kTileRows) return 0;
  return (kF32 && attn_fwd_smem_bytes<kF32>(L, D, H) > kMaxSmem ? kVarFwdAttn : 0) |
         (tail_fwd_smem_bytes<kF32>(L, D, Q) > kMaxSmem ? kVarFwdTail : 0);
}

// the most shared memory one block of the forward's kernels needs, in the
// variants fwd_variant chooses
template <bool kF32> long fwd_smem_bytes(int L, int D, int H, int Q) {
  const int v = fwd_variant<kF32>(L, D, H, Q);
  const long a = v & kVarFwdAttn ? attn_fwd_smem_bytes<kF32, true>(L, D, H)
                                 : attn_fwd_smem_bytes<kF32>(L, D, H);
  const long t = v & kVarFwdTail ? tail_fwd_smem_bytes_of<kF32, false, true>(L, D, Q)
                                 : tail_fwd_smem_bytes<kF32>(L, D, Q);
  return a > t ? a : t;
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

// One block per tile of whole items and group of hpb heads: per head, q|k|v
// = T(x Wqkv + b) over the head's columns (each of q, k, v padded from dh to
// round16(dh) with zeros), the scores over the tile's block diagonal, the
// softmax (8 lanes a row up to 64 rows), o1 = T((T(e) v) / rowsum); writes
// the head's columns of o1 for the tile's rows. kStream (f32 only): x's
// rows are streamed from device memory with the weights, not held whole.
template <typename T, bool kStream>
__global__ void __launch_bounds__(256, 1)
fwd_attn_kernel(const T* __restrict__ x, const float* __restrict__ mask, BOp wqkv,
                const T* __restrict__ bqkv, T* __restrict__ o1_g, int M, int L, int D, int H,
                int hpb, float scale) {
  constexpr bool kF32 = sizeof(T) == 4;
  static_assert(!kStream || kF32, "x is streamed in f32 only");
  extern __shared__ __align__(16) unsigned char smem[];
  const int Rt = tile_rows(L), ipt = items_per_tile(L);
  const int dh = D / H, dhp = round16(dh), ldh = dhp + 8, ldX = lda_of(D);
  // T(e) takes the rows of the scores: a row's f32 values are read before
  // its bf16 ones are written (by the same lanes), high parts at 0, low
  // parts at Rt + 8 (16-byte aligned) of the row
  const int ldS = Rt + 4, ldP = 2 * ldS;
  using C = typename Cfg<kF32>::Attn;
  constexpr int parts = kF32 ? 2 : 1;  // low parts in f32 only
  __nv_bfloat16* x_hi = reinterpret_cast<__nv_bfloat16*>(smem);  // [Rt, ldX], unless kStream
  __nv_bfloat16* x_lo = x_hi + Rt * ldX;
  // q, k, v of one head, [Rt, ldh] each: high parts, then low parts
  __nv_bfloat16* hd = x_hi + (kStream ? 0 : parts * Rt * ldX);
  auto head_hi = [=](int i) { return hd + i * Rt * ldh; };
  auto head_lo = [=](int i) { return hd + (3 + i) * Rt * ldh; };
  unsigned char* ring = reinterpret_cast<unsigned char*>(hd + parts * 3 * Rt * ldh);
  float* S = reinterpret_cast<float*>(ring);                   // [Rt, ldS] scores
  __nv_bfloat16* p_hi = reinterpret_cast<__nv_bfloat16*>(S);  // [Rt, ldP] T(e)
  __nv_bfloat16* p_lo = p_hi + Rt + 8;
  const long sc = fwd_scores_bytes(Rt),
             rb = C::ST * ((kStream ? AStream::stage_bytes(Rt) : 0) + b_stage_bytes<C::NT>(kF32));
  float* mk = reinterpret_cast<float*>(ring + (sc > rb ? sc : rb));  // [Rt] mask
  int* itm = reinterpret_cast<int*>(mk + Rt);                        // [Rt] item of a row
  float* rs = reinterpret_cast<float*>(itm + Rt);                    // [Rt] softmax row sums
  float* hb = rs + Rt;  // [3 dhp] the head's q|k|v biases

  const int item0 = blockIdx.x * ipt;
  const int nitems = M - item0 < ipt ? M - item0 : ipt, nrows = nitems * L;
  const long row0 = (long)item0 * L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  if (!kStream) stage_rows(x + row0 * D, nrows, D, Rt, x_hi, x_lo, ldX);
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
    const BOp b = from_col<false>(wqkv, h * 3 * dhp);
    auto qkv_epi = [=](int r, int n, float a0, float a1) {
      const int seg = n >= 2 * dhp ? 2 : (n >= dhp ? 1 : 0), d = n - seg * dhp;
      float v0 = 0.f, v1 = 0.f;
      if (d < dh) {
        v0 = a0 + hb[n];
        v1 = a1 + hb[n + 1];
        if (seg == 0) { v0 *= scale; v1 *= scale; }
      }
      put(head_hi(seg), head_lo(seg), r * ldh + d, rnd<T>(v0), kF32);
      put(head_hi(seg), head_lo(seg), r * ldh + d + 1, rnd<T>(v1), kF32);
    };
    if constexpr (kStream)
      tile_product<C::NT, C::UJ, C::ST, C::W, false, kF32, kF32, true>(
          AStream{reinterpret_cast<const float*>(x) + row0 * D, D, nrows, D, Rt}, b, Rt, ring,
          qkv_epi);
    else
      tile_product<C::NT, C::UJ, C::ST, C::W, false, kF32, kF32, true>(
          ASmem{x_hi, x_lo, ldX}, b, Rt, ring, qkv_epi);
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
// softmax per item and out = T(sum_l w_l o2_l / max(den, 1e-30)). kWideD:
// o2's f32 rows go to device memory (o2_g) and are read back from there,
// the same values in the same order of sums; in bf16 o1's tile, then
// T(o2)'s, stays in shared memory, in f32 both are streamed.
template <typename T, bool kWide, bool kWideD>
__global__ void __launch_bounds__(512, 1)
fwd_tail_kernel(const float* __restrict__ mask, const T* __restrict__ o1, BOp wo, BOp aw,
                const T* __restrict__ bo, const T* __restrict__ ab, const T* __restrict__ aq,
                T* __restrict__ out, float* __restrict__ o2_g, int M, int L, int D, int Q,
                unsigned seed, int block_rows, unsigned threshold, float keep_scale) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr bool kStreamA = kWideD && kF32;  // the A operands streamed from device memory
  using C = PoolCfg<kF32, kWide>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Rt = tile_rows(L), ipt = items_per_tile(L);
  const int ldA = lda_of(D), D16 = round16(D), Qh = Q / 2;
  constexpr int parts = kF32 ? 2 : 1;
  __nv_bfloat16* a_hi = reinterpret_cast<__nv_bfloat16*>(smem);  // [Rt, ldA] o1 (kWideD: T(o2))
  __nv_bfloat16* a_lo = a_hi + Rt * ldA;
  const long a_bytes = kWideD ? (kF32 ? 0 : 2L * Rt * ldA) : (long)parts * 2 * Rt * ldA;
  const long t_bytes = 4L * Rt * Qh;
  // [Rt, Qh] after o1, or beside T(o2)
  float* terms = reinterpret_cast<float*>(kWideD ? smem + a_bytes : smem);
  float* o2s = reinterpret_cast<float*>(  // o2 [Rt, ldA], unless kWideD
      smem + (kWideD ? a_bytes + t_bytes : (a_bytes > t_bytes ? a_bytes : t_bytes)));
  unsigned char* ring = reinterpret_cast<unsigned char*>(o2s + (kWideD ? 0 : Rt * ldA));
  float* mk = reinterpret_cast<float*>(
      ring + C::ST * ((kStreamA ? AStream::stage_bytes(Rt) : 0) + b_stage_bytes<C::NT>(kF32)));
  float* pw = mk + Rt;    // pooling logits, then exp(logit - max)
  float* dn = pw + Rt;    // [Rt] an item's max(den, 1e-30)
  float* bos = dn + Rt;   // bo, ab, aq in f32
  float* abs_ = bos + D;
  float* aqs = abs_ + Q;

  const int item0 = blockIdx.x * ipt;
  const int nitems = M - item0 < ipt ? M - item0 : ipt, nrows = nitems * L;
  const long row0 = (long)item0 * L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (!kStreamA) stage_rows(o1 + row0 * D, nrows, D, Rt, a_hi, a_lo, ldA);
  for (int r = tid; r < Rt; r += blockDim.x) mk[r] = r < nrows ? mask[row0 + r] : 0.f;
  for (int i = tid; i < D; i += blockDim.x) bos[i] = to_f(bo[i]);
  for (int i = tid; i < Q; i += blockDim.x) {
    abs_[i] = to_f(ab[i]);
    aqs[i] = to_f(aq[i]);
  }
  // o2's columns past D are the next product's zero depth pad
  if (!kWideD)
    for (int i = tid; i < Rt * (D16 - D); i += blockDim.x)
      o2s[i / (D16 - D) * ldA + D + i % (D16 - D)] = 0.f;

  // o2 = o1 @ Wo + bo, then dropout on the items' rows (rows past them 0)
  auto o2_epi = [=](int r, int n, float a0, float a1) {
    float v0 = 0.f, v1 = 0.f;
    if (r < nrows) {
      v0 = dropout(a0 + bos[n], seed, block_rows, row0 + r, n, threshold, keep_scale);
      v1 = dropout(a1 + bos[n + 1], seed, block_rows, row0 + r, n + 1, threshold, keep_scale);
    }
    if (!kWideD)
      store2(o2s + r * ldA + n, v0, v1);
    else if (r < nrows)
      store2(o2_g + (row0 + r) * D + n, v0, v1);
  };
  if constexpr (kStreamA)
    tile_product<C::NT, C::UJ, C::ST, C::W, false, kF32, kF32>(
        AStream{reinterpret_cast<const float*>(o1) + row0 * D, D, nrows, D, Rt}, wo, Rt, ring,
        o2_epi);
  else
    tile_product<C::NT, C::UJ, C::ST, C::W, false, kF32, kF32>(ASmem{a_hi, a_lo, ldA}, wo, Rt,
                                                                ring, o2_epi);
  // tanh(T(o2) @ aw + ab) * aq, two columns summed per term
  auto term_epi = [=](int r, int n, float a0, float a1) {
    if (r < nrows)
      terms[r * Qh + n / 2] = tanhf(a0 + abs_[n]) * aqs[n] + tanhf(a1 + abs_[n + 1]) * aqs[n + 1];
  };
  if constexpr (!kWideD) {
    tile_product<C::NT, C::UJ, C::ST, C::W, false, kF32, kF32>(ASmemF32{o2s, ldA}, aw, Rt, ring,
                                                                term_epi);
  } else if constexpr (kF32) {
    tile_product<C::NT, C::UJ, C::ST, C::W, false, kF32, kF32>(
        AStream{o2_g + row0 * D, D, nrows, D, Rt}, aw, Rt, ring, term_epi);
  } else {
    // T(o2) into o1's tile (o1 is spent), from the rows just written
    stage_tile<4>(o2_g + row0 * D, D, nrows, D, Rt, D16, a_hi, a_lo, ldA, false);
    tile_product<C::NT, C::UJ, C::ST, C::W, false, kF32, kF32>(ASmem{a_hi, a_lo, ldA}, aw, Rt,
                                                                ring, term_epi);
  }
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
  // o2's rows, from shared or device memory
  const float* o2r = kWideD ? o2_g + row0 * D : o2s;
  const int ldo = kWideD ? D : ldA;
  for (int e = tid; e < nitems * D; e += blockDim.x) {
    const int it = e / D, d = e % D;
    const float* p = pw + it * L;
    const float* o = o2r + (long)it * L * ldo + d;
    float num = 0.f;
    for (int i = 0; i < L; ++i) num = fmaf(p[i], o[i * ldo], num);
    out[(long)(item0 + it) * D + d] = from_f<T>(num / dn[it]);
  }
}

// fwd_tail over o1 ([M * L, D] in T) with the weights already in ws
template <typename T>
cudaError_t launch_tail(const void* mask, const void* o1, const void* ws, const void* bo,
                        const void* ab, const void* aq, void* out, void* o2, int M, int L, int D,
                        int H, int Q, unsigned seed, int block_rows, unsigned threshold,
                        float keep_scale, cudaStream_t stream) {
  constexpr bool kF32 = sizeof(T) == 4;
  const WeightOps w = weight_ops<T>(ws, D, H, Q, wgmma_engine(kF32, L));
  const int tiles = (M + items_per_tile(L) - 1) / items_per_tile(L);
  const bool wide = tile_rows(L) > kTileRows;
  const int var = fwd_variant<kF32>(L, D, H, Q);
  if ((var & kVarFwdTail) && o2 == nullptr) return cudaErrorInvalidValue;
  auto tail_kernel = wide ? fwd_tail_kernel<T, true, false>
                          : (var & kVarFwdTail ? fwd_tail_kernel<T, false, true>
                                               : fwd_tail_kernel<T, false, false>);
  const int tail_smem = (int)(var & kVarFwdTail ? tail_fwd_smem_bytes_of<kF32, false, true>(L, D, Q)
                                                : tail_fwd_smem_bytes<kF32>(L, D, Q));
  cudaError_t err = cudaFuncSetAttribute(tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         tail_smem);
  if (err != cudaSuccess) return err;
  static_assert(Cfg<kF32>::Pool::W == Cfg<kF32>::PoolWide::W, "one block size for fwd_tail");
  tail_kernel<<<tiles, 32 * Cfg<kF32>::Pool::W, tail_smem, stream>>>(
      static_cast<const float*>(mask), static_cast<const T*>(o1), w.wo, w.aw,
      static_cast<const T*>(bo), static_cast<const T*>(ab), static_cast<const T*>(aq),
      static_cast<T*>(out), static_cast<float*>(o2), M, L, D, Q, seed, block_rows, threshold,
      keep_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* mask, const void* wqkv, const void* bqkv,
                   const void* wo, const void* bo, const void* aw, const void* ab,
                   const void* aq, void* out, void* o1, void* ws, void* o2, int M, int L, int D,
                   int H, int Q, float scale, unsigned seed, int block_rows, unsigned threshold,
                   float keep_scale, cudaStream_t stream) {
  constexpr bool kF32 = sizeof(T) == 4;
  const int var = fwd_variant<kF32>(L, D, H, Q);
  if ((var & kVarFwdTail) && o2 == nullptr) return cudaErrorInvalidValue;
  // the weights as the kernels read them, in ws, once per call
  const bool wg = wgmma_engine(kF32, L);
  cudaError_t err = stage_weights<T>(wqkv, wo, aw, ws, D, H, Q, wg, kTlFwd, stream);
  if (err != cudaSuccess) return err;
  const WeightOps w = weight_ops<T>(ws, D, H, Q, wg);
  const int tiles = (M + items_per_tile(L) - 1) / items_per_tile(L);
  auto attn_kernel = fwd_attn_kernel<T, false>;
  if constexpr (kF32)
    if (var & kVarFwdAttn) attn_kernel = fwd_attn_kernel<T, true>;
  const int attn_smem = (int)(var & kVarFwdAttn ? attn_fwd_smem_bytes<kF32, true>(L, D, H)
                                                : attn_fwd_smem_bytes<kF32>(L, D, H));
  if ((err = cudaFuncSetAttribute(attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  attn_smem)) != cudaSuccess)
    return err;
  const int hpb = tiles >= kAllHeadsTiles ? H : 1;
  attn_kernel<<<dim3(tiles, (H + hpb - 1) / hpb), 32 * Cfg<kF32>::Attn::W, attn_smem,
                stream>>>(static_cast<const T*>(x), static_cast<const float*>(mask),
                                 w.qkv_head, static_cast<const T*>(bqkv), static_cast<T*>(o1), M,
                                 L, D, H, hpb, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_tail<T>(mask, o1, ws, bo, ab, aq, out, o2, M, L, D, H, Q, seed, block_rows,
                        threshold, keep_scale, stream);
}

}  // namespace

extern "C" {

// the backward's wide variants (fused_encoder_bwd.cu)
int newsrec_fused_encoder_bwd_variant(int dtype, int L, int D, int H, int Q);

// dtype: 0 = float32, 1 = bfloat16 (x, weights, out and o1); mask is
// float32. o1 [M, L, D] is always written (the caller's scratch when it
// does not want the residual). ws: room for
// newsrec_fused_encoder_fwd_ws_elems(D, H, Q) bfloat16 values, twice that
// for float32 (the weights as the kernels read them). o2: float32 scratch of
// newsrec_fused_encoder_fwd_o2_elems(...) values; where that is 0, unused
// and may be null. Dropout: seed, token
// rows per hash block, threshold = rate * 2^32, keep_scale = 1 / (1 - rate);
// threshold 0 and keep_scale 1 mean no dropout. Needs Q % 2 == 0 and an
// even head width. All operands contiguous on one device, 16-byte aligned.
// Returns a cudaError_t code.
int newsrec_fused_encoder_fwd(int dtype, const void* x, const void* mask, const void* wqkv,
                              const void* bqkv, const void* wo, const void* bo, const void* aw,
                              const void* ab, const void* aq, void* out, void* o1, void* ws,
                              void* o2, int M, int L, int D, int H, int Q, float scale,
                              unsigned seed, int block_rows, unsigned threshold, float keep_scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, mask, wqkv, bqkv, wo, bo, aw, ab, aq, out, o1, ws, o2, M, L, D, H, Q,
                         scale, seed, block_rows, threshold, keep_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, mask, wqkv, bqkv, wo, bo, aw, ab, aq, out, o1, ws, o2, M, L,
                                 D, H, Q, scale, seed, block_rows, threshold, keep_scale, s);
  return cudaErrorInvalidValue;
}

// fwd_tail alone, with no dropout, over o1 [M, L, D] (dtype as above) and
// the weights that an earlier launch on the same stream wrote into ws
// (WsLayout): the tail of newsrec_fused_encoder_fwd. The stage ablation
// (ablate_encoder.cu) runs it after its own o1. o2 as above. Returns a
// cudaError_t code.
int newsrec_fused_encoder_fwd_tail(int dtype, const void* mask, const void* o1, const void* ws,
                                   const void* bo, const void* ab, const void* aq, void* out,
                                   void* o2, int M, int L, int D, int H, int Q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_tail<float>(mask, o1, ws, bo, ab, aq, out, o2, M, L, D, H, Q, 0u, 1, 0u, 1.f, s);
  if (dtype == 1)
    return launch_tail<__nv_bfloat16>(mask, o1, ws, bo, ab, aq, out, o2, M, L, D, H, Q, 0u, 1, 0u,
                                      1.f, s);
  return cudaErrorInvalidValue;
}

// the most shared memory one block of the forward's kernels needs, in the
// variants they take at these shapes
long newsrec_fused_encoder_smem_bytes(int dtype, int L, int D, int H, int Q) {
  return dtype == 0 ? fwd_smem_bytes<true>(L, D, H, Q) : fwd_smem_bytes<false>(L, D, H, Q);
}

// the wide variants the forward's and the backward's kernels take at these
// shapes, as tiles.cuh's kVar* bits (0 at every shape where each kernel's
// layout fits one block)
int newsrec_fused_encoder_variant(int dtype, int L, int D, int H, int Q) {
  const int f = dtype == 0 ? fwd_variant<true>(L, D, H, Q) : fwd_variant<false>(L, D, H, Q);
  return f | newsrec_fused_encoder_bwd_variant(dtype, L, D, H, Q);
}

// the name of the wide variant of bit 1 << i, null past the last
const char* newsrec_fused_encoder_variant_name(int i) {
  constexpr int n = sizeof(kVarNames) / sizeof(kVarNames[0]);
  return i >= 0 && i < n ? kVarNames[i] : nullptr;
}

// float32 values of the forward's o2 scratch at these shapes: [M * L, D]
// where the tail takes its wide variant (kVarFwdTail), else 0
long newsrec_fused_encoder_fwd_o2_elems(int dtype, long M, int L, int D, int H, int Q) {
  const int f = dtype == 0 ? fwd_variant<true>(L, D, H, Q) : fwd_variant<false>(L, D, H, Q);
  return f & kVarFwdTail ? M * L * D : 0;
}

// the forward's tiles at item length L: whole items per block, and the
// block's token rows
void newsrec_fused_encoder_fwd_tile(int L, int* items, int* rows) {
  *items = items_per_tile(L);
  *rows = tile_rows(L);
}

// bfloat16 values of the weights' layouts (ws of newsrec_fused_encoder_fwd
// holds this many, twice for float32)
long newsrec_fused_encoder_fwd_ws_elems(int D, int H, int Q) { return ws_elems(D, H, Q); }

// the engine of the per-item kernels' weight products at these shapes
// (tiles.cuh's wgmma_engine): 1 wgmma, 0 mma.sync
int newsrec_fused_encoder_engine(int dtype, int L, int D, int H, int Q) {
  (void)D, (void)H, (void)Q;
  return wgmma_engine(dtype == 0, L) ? 1 : 0;
}

const char* newsrec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
