// Stage-by-stage ablation of the fused news encoder's forward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `build` of the JAX package's
// benchmarks/ablate_encoder.py:30 (its bodies k_passthrough, k_qkv, k_attn,
// k_tail, k_attn_slices, k_attn_nosoftmax): six truncations of the fused
// encoder's forward. Each is built from the pieces of today's forward
// (fused_encoder.cu on tiles.cuh: stage_weights_kernel and WsLayout, the
// tile of whole items, tile_product over the cp.async ring on mma.sync
// m16n8k16 with f32 sums, ASmem / AStream, and fwd_tail itself), so the
// difference of two stages reads as the cost of one part of that forward.
// Inputs in the harness's layout: x [M*L, D], mask [M*L] f32, weights in
// x's dtype T; out [M, D] in T.
//
//   V0 passthrough    out_m = T(sum_l x_l)           (a sum, mask not read)
//   V1 qkv            out_m = T(sum_l T(q_l))        (q unscaled)
//   V2a attn_slices   out_m = T(sum_l T(q_l + k_l + v_l))
//   V3 tail           o1 = T(q), then fwd_tail with no dropout: o2 = o1 @
//                     Wo + bo, additive pooling (each item's own max)
//   V2 attn           per 160-row subtile (kSub rows = 8 items at L = 20) and
//                     head: s = q_h k_h^T, where(mask_i mask_j [same item] >
//                     0, s * scale, -1e9), f32 softmax, o = p @ v_h; then
//                     out_m = T(sum_l T(o_l)). A row whose mask is 0 has
//                     every score at -1e9, so it attends uniformly over the
//                     whole subtile, across items, as in the TPU kernel.
//   V2b attn_nosoftmax per subtile and head: o = (q_h k_h^T * scale) @ v_h,
//                     no mask, no block diagonal (the subtile's items mix)
// qkv = x @ Wqkv + bqkv in f32 over all 3D columns in every stage but V0:
// k and v are computed and stored (to shared memory) even where only q
// reaches the output, as the TPU body computes them.
//
// Layout. Every stage but V0 first re-lays the weights (stage_weights_kernel
// into ws, as each forward call does), then:
//   V1, V2a, V3 (ablate_items_kernel): fwd_attn's tile and head loop. Per
//     64-row tile of whole items (3 items at L = 20) and head, x held whole
//     in shared memory, q|k|v = x Wqkv_h by tile_product on the head-major
//     weights (dh = 30 padded to 32); the epilogue adds the bias in f32 into
//     an f32 tile [Rt, 3 dhp]. Then V1 / V2a sum T(q) / T(q + k + v) per
//     item, a thread per (item, column) over the item's rows in order; V3
//     writes T(q) to o1 in device memory instead, and fwd_tail (the
//     forward's own kernel, newsrec_fused_encoder_fwd_tail) runs on it. So
//     V1 is fwd_attn without scores, softmax and P v, and V3 - V1 is
//     today's tail with its o1 round trip.
//   V2, V2b (ablate_subtile_kernel): the TPU body's 160-row subtile is the
//     tile (it carries the semantics: a pad row spreads over the subtile,
//     V2b mixes its items). Per head: q (scaled) | k | v = T(x Wqkv_h + b)
//     into bf16 tiles, as fwd_attn, by one tile_product over the 160 rows as
//     a single group, so that each weight tile is staged once for all of
//     them (SubCfg: 16 warps, 16 x 16 units); then per half of the rows
//     (80): the scores over all 160 columns by mma.sync into f32 rows with
//     the pair mask, the f32 softmax a warp per two rows in registers (row
//     sum in f32, then T(e) into the row's own bytes, as fwd_attn), o =
//     T((T(e) v) / rowsum) into an f32 tile; then the items' sums. V2b
//     writes T(s) for T(e) and divides by 1.
//   V0 (ablate_sum_kernel): bound by bytes. An item is one flat run of
//     16-byte chunks (it is 16-byte aligned when x is: L * D * sizeof(T) %
//     16 == 0), whose columns repeat every P chunks (75 at D = 300, two rows
//     in bf16). A thread per chunk of that period, 4 items a block: it loads
//     chunks j, j + P, ... (16-byte loads, 5 in flight) and keeps one f32
//     sum per column of its chunk, over the rows it meets in order; the
//     partial sums of a column (2 in bf16, 1 in f32) add up in shared memory
//     in a fixed order. No staging of x: the loads go to registers.
// Shared memory (newsrec_ablate_encoder_smem_bytes): at D = 300, 10 heads,
// L = 20, V1 / V2a take 108,416 B in bf16 (x 39,936, the ring 41,472, the f32
// q|k|v tile 26,624), two blocks an SM as fwd_attn, and 162,176 B in f32
// (x's high and low parts); V2 / V2b take 218,624 B in bf16: x whole
// (99,840), q|k|v (38,400), the mask, rows' items, row sums and biases, and
// a region that holds the ring during the product and then a half's scores
// [80, 164] f32 (52,480) beside the f32 output tile [160, 40] (25,600). A
// whole 160 x 164 f32 score tile would not fit beside x, hence the halves.
// In f32 x does not fit whole: it is streamed through the ring (AStream,
// split in registers), as fwd_attn's f32 variant does: 226,560 B. V3 adds
// fwd_tail's own.
// Precision. bf16: every tensor-core operand is bf16 at the TPU kernel's
// rounding points (x, the weights), and q, k, v and p are rounded to bf16
// for the attention products, as today's bf16 forward does and as a
// default-precision f32 jnp.dot does on the TPU's MXU. The plain version
// keeps q, k, v and p in f32: each rounding moves a product by some 2^-9 of
// its terms, sums of 30-160 terms of random sign keep that relative size,
// and the output sums 20 rows, so the stages stay well inside 2e-2 of the
// largest output (ABLATION_TOL; a value at a rounding edge of T(q) or T(o)
// may land one bf16 step away). f32: every operand is split into bf16 high
// and low parts (three passes, some 2^-16 of each product), as today's f32
// forward does.
// No atomics; every sum has a fixed order, so two launches give the same
// bits.
//
// Bounds, at L = 20, D = 300, H = 10, Q = 200 (chip_smoke.py's
// `ablation_bound` computes them from the shapes): V0 moves x once (bytes);
// the rest are bound by operations: 2 * L * D * 3D FLOP per item for the
// projection (V1, V2a), + 4 * H * L^2 * dh for V2's attention within items,
// + two 160 x 160 x dh products per subtile and head for V2b, + 2 * L * D *
// (D + Q) for V3's Wo and aw products, over the bf16 tensor-core peak.

#include "tiles.cuh"

extern "C" {
// fused_encoder.cu: the forward's tail alone, and its shared memory
int newsrec_fused_encoder_fwd_tail(int dtype, const void* mask, const void* o1, const void* ws,
                                   const void* bo, const void* ab, const void* aq, void* out,
                                   void* o2, int M, int L, int D, int H, int Q, void* stream);
long newsrec_fused_encoder_smem_bytes(int dtype, int L, int D, int H, int Q);
}

namespace {

constexpr int kSub = 160;          // rows of an attention subtile (the TPU kernel's SUB)
constexpr int kHalf = kSub / 2;    // rows of scores held at once
constexpr int kAllHeadsBlocks = 264;  // as the forward: past this, a block takes every head
constexpr int kSumThreads = 320;     // V0: a block's threads, about

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

// row stride (floats) of the f32 q|k|v tile: 3 dhp + 8, so that the
// epilogue's float2 stores of a half warp fall in distinct banks
__host__ __device__ inline int qkv_ld(int dhp) { return 3 * dhp + 8; }

// ---- V0 ---------------------------------------------------------------------

// An item's 16-byte chunks (V values of T each) repeat their columns every P
// chunks, which cover Rp rows: P = D / gcd(D, V), Rp = V / gcd(D, V) (75
// chunks and 2 rows in bf16 at D = 300, 75 and 1 in f32).
struct SumGeom {
  int P, Rp;
};
__host__ __device__ inline SumGeom sum_geom(int D, int esize) {
  int a = D, b = 16 / esize;
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return SumGeom{D / a, 16 / esize / a};
}
// items per block (a thread per chunk of a period of each), and the block
__host__ __device__ inline int sum_items(int D, int esize) {
  return imax(1, kSumThreads / sum_geom(D, esize).P);
}
__host__ __device__ inline int sum_block(int D, int esize) {
  return (sum_items(D, esize) * sum_geom(D, esize).P + 31) / 32 * 32;
}

// c's V values of T added to acc
__device__ __forceinline__ void add_chunk(float* acc, uint4 c, float) {
  acc[0] += __uint_as_float(c.x);
  acc[1] += __uint_as_float(c.y);
  acc[2] += __uint_as_float(c.z);
  acc[3] += __uint_as_float(c.w);
}
__device__ __forceinline__ void add_chunk(float* acc, uint4 c, __nv_bfloat16) {
  const unsigned w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] += __uint_as_float(w[i] << 16);
    acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
  }
}

// out_m = T(sum_l x_l), ipb items a block. Thread j < P of an item reads
// chunks j, j + P, j + 2P, ... of it (16-byte loads, kSumBatch in flight)
// and sums each of its V columns over the rows it meets, in order; the Rp
// partial sums of a column then add up in order of their first row.
template <typename T>
__global__ void __launch_bounds__(1024)
ablate_sum_kernel(const T* __restrict__ x, T* __restrict__ out, int M, int L, int D, int ipb) {
  constexpr int V = 16 / sizeof(T), kSumBatch = 5;
  extern __shared__ __align__(16) float part[];  // [ipb, Rp * D] partial sums
  const SumGeom sg = sum_geom(D, sizeof(T));
  const int nk = L / sg.Rp, it = threadIdx.x / sg.P, j = threadIdx.x % sg.P;
  const long item0 = (long)blockIdx.x * ipb;
  if (it < ipb && item0 + it < M) {
    const uint4* src = reinterpret_cast<const uint4*>(x + (item0 + it) * L * D) + j;
    float acc[V] = {};
    for (int k0 = 0; k0 < nk; k0 += kSumBatch) {
      uint4 c[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u)
        if (k0 + u < nk) c[u] = src[(long)(k0 + u) * sg.P];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u)
        if (k0 + u < nk) add_chunk(acc, c[u], T());
    }
    float* p = part + (long)it * sg.Rp * D + j * V;
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = acc[e];
  }
  __syncthreads();
  const int pairs = D / 2;
  for (int e = threadIdx.x; e < ipb * pairs; e += blockDim.x) {
    const int i = e / pairs, d = 2 * (e % pairs);
    if (item0 + i >= M) break;
    const float* p = part + (long)i * sg.Rp * D + d;
    float s0 = 0.f, s1 = 0.f;
    for (int r = 0; r < sg.Rp; ++r) {
      s0 += p[r * D];
      s1 += p[r * D + 1];
    }
    store2(out + (item0 + i) * D + d, s0, s1);
  }
}

// ---- V1, V2a, V3 ------------------------------------------------------------

template <bool kF32> __host__ __device__ inline long items_smem_bytes(int L, int D, int H) {
  using C = typename Cfg<kF32>::Attn;
  const long Rt = tile_rows(L), dhp = round16(D / H), parts = kF32 ? 2 : 1;
  return parts * 2 * Rt * lda_of(D) + 4 * Rt * qkv_ld(dhp) + 12 * dhp +
         C::ST * b_stage_bytes<C::NT>(kF32);
}

// One block per tile of whole items and group of hpb heads (fwd_attn's
// grid): per head, q|k|v + b in f32 over the head's columns (tile_product),
// then S = kQkv / kAttnSlices: out's head columns of each item = T(sum_l
// T(q_l)) / T(sum_l T(q_l + k_l + v_l)); S = kTail: o1's head columns =
// T(q) for the tile's rows.
template <typename T, int S>
__global__ void __launch_bounds__(256, 1)
ablate_items_kernel(const T* __restrict__ x, BOp wqkv, const T* __restrict__ bqkv,
                    T* __restrict__ out, T* __restrict__ o1, int M, int L, int D, int H,
                    int hpb) {
  constexpr bool kF32 = sizeof(T) == 4;
  using C = typename Cfg<kF32>::Attn;
  constexpr int parts = kF32 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Rt = tile_rows(L), ipt = items_per_tile(L);
  const int dh = D / H, dhp = round16(dh), ldX = lda_of(D), ldq = qkv_ld(dhp);
  __nv_bfloat16* x_hi = reinterpret_cast<__nv_bfloat16*>(smem);  // [Rt, ldX]
  __nv_bfloat16* x_lo = x_hi + Rt * ldX;
  float* qf = reinterpret_cast<float*>(x_hi + parts * Rt * ldX);  // [Rt, ldq] q | k | v + b
  float* hb = qf + Rt * ldq;                                      // [3 dhp] the head's biases
  unsigned char* ring = reinterpret_cast<unsigned char*>(hb + 3 * dhp);

  const int item0 = blockIdx.x * ipt;
  const int nitems = M - item0 < ipt ? M - item0 : ipt, nrows = nitems * L;
  const long row0 = (long)item0 * L;
  const int tid = threadIdx.x;
  stage_rows(x + row0 * D, nrows, D, Rt, x_hi, x_lo, ldX);
  const int h0 = (int)blockIdx.y * hpb, h_end = h0 + hpb < H ? h0 + hpb : H;
  for (int h = h0; h < h_end; ++h) {
    for (int i = tid; i < 3 * dhp; i += blockDim.x) {
      const int seg = i / dhp, d = i % dhp;
      hb[i] = d < dh ? to_f(bqkv[seg * D + h * dh + d]) : 0.f;
    }
    BOp b = wqkv;
    b.hi += h * 3 * dhp;
    if (kF32) b.lo += h * 3 * dhp;
    tile_product<C::NT, C::UJ, C::ST, C::W, false, kF32, kF32, true>(
        ASmem{x_hi, x_lo, ldX}, b, Rt, ring, [=](int r, int n, float a0, float a1) {
          store2(qf + r * ldq + n, a0 + hb[n], a1 + hb[n + 1]);
        });
    if constexpr (S == kTail) {
      const int hp = dh / 2;
      for (int e = tid; e < nrows * hp; e += blockDim.x) {
        const int r = e / hp, d = 2 * (e % hp);
        store2(o1 + (row0 + r) * D + h * dh + d, qf[r * ldq + d], qf[r * ldq + d + 1]);
      }
    } else {
      for (int e = tid; e < nitems * dh; e += blockDim.x) {
        const int it = e / dh, d = e % dh;
        const float* p = qf + it * L * ldq + d;
        float s = 0.f;
        for (int l = 0; l < L; ++l, p += ldq)
          s += rnd<T>(S == kAttnSlices ? p[0] + p[dhp] + p[2 * dhp] : p[0]);
        out[(long)(item0 + it) * D + h * dh + d] = from_f<T>(s);
      }
    }
    __syncthreads();  // qf and the ring are free again
  }
}

// ---- V2, V2b ----------------------------------------------------------------

// The subtile kernel's geometry. A block of 160 rows holds x whole in bf16
// (99,840 B), so one block fills an SM: it takes 16 warps, not fwd_attn's 8
// (Cfg::Attn), its QKV product walks the 160 rows as one group (G), so each
// weight tile is staged once for all of them, and the product's units are
// 16 x 16 (UJ = 2), so that every warp has work. The ring is fwd_attn's (in
// f32 it holds x's stages too); a deeper one changed nothing on the H100.
template <bool kF32> struct SubCfg {
  using A = typename Cfg<kF32>::Attn;
  static constexpr int NT = A::NT, UJ = 2, ST = A::ST, W = 16, G = kSub;
};

// the region after the head tiles: the ring during the product, then a
// half's scores [kHalf, kSub + 4] f32 and the output tile [kSub, dhp + 8] f32
template <bool kF32> __host__ __device__ inline long subtile_region_bytes(int dhp) {
  using C = SubCfg<kF32>;
  const long ring = C::ST * ((kF32 ? AStream::stage_bytes(kSub) : 0) + b_stage_bytes<C::NT>(kF32));
  const long att = 4L * kHalf * (kSub + 4) + 4L * kSub * (dhp + 8);
  return ring > att ? ring : att;
}

template <bool kF32> __host__ __device__ inline long subtile_smem_bytes(int D, int H) {
  const long dhp = round16(D / H), ldh = dhp + 8, parts = kF32 ? 2 : 1;
  return (kF32 ? 0 : 2L * kSub * lda_of(D)) + parts * 6 * kSub * ldh +
         subtile_region_bytes<kF32>((int)dhp) + 12 * kSub + 12 * dhp;
}

// One block per 160-row subtile and group of hpb heads. kF32: x streamed
// through the ring (AStream), not held whole.
template <typename T, bool kSoftmax>
__global__ void __launch_bounds__(512, 1)
ablate_subtile_kernel(const T* __restrict__ x, const float* __restrict__ mask, BOp wqkv,
                      const T* __restrict__ bqkv, T* __restrict__ out, int L, int D, int H,
                      int hpb, float scale) {
  constexpr bool kF32 = sizeof(T) == 4;
  using C = SubCfg<kF32>;
  constexpr int parts = kF32 ? 2 : 1, Rt = kSub;
  constexpr int ldS = kSub + 4, ldP = 2 * ldS;  // T(e) takes its row of the scores
  extern __shared__ __align__(16) unsigned char smem[];
  const int dh = D / H, dhp = round16(dh), ldh = dhp + 8, ldX = lda_of(D), ldo = dhp + 8;
  const int items = kSub / L;
  __nv_bfloat16* x_hi = reinterpret_cast<__nv_bfloat16*>(smem);  // [Rt, ldX], bf16 only
  __nv_bfloat16* hd = x_hi + (kF32 ? 0 : Rt * ldX);
  auto head_hi = [=](int i) { return hd + i * Rt * ldh; };
  auto head_lo = [=](int i) { return hd + (3 + i) * Rt * ldh; };
  unsigned char* ring = reinterpret_cast<unsigned char*>(hd + parts * 3 * Rt * ldh);
  float* Sh = reinterpret_cast<float*>(ring);                  // [kHalf, ldS] scores
  __nv_bfloat16* p_hi = reinterpret_cast<__nv_bfloat16*>(Sh);  // [kHalf, ldP] T(e)
  __nv_bfloat16* p_lo = p_hi + Rt + 8;
  float* os = Sh + kHalf * ldS;                                // [Rt, ldo] T(o)
  float* mk = reinterpret_cast<float*>(ring + subtile_region_bytes<kF32>(dhp));  // [Rt]
  int* itm = reinterpret_cast<int*>(mk + Rt);          // [Rt] item of a row
  float* rs = reinterpret_cast<float*>(itm + Rt);      // [Rt] softmax row sums
  float* hb = rs + Rt;                                 // [3 dhp] the head's q|k|v biases

  const long row0 = (long)blockIdx.x * Rt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  if constexpr (!kF32) stage_rows(x + row0 * D, Rt, D, Rt, x_hi, x_hi, ldX);
  for (int r = tid; r < Rt; r += blockDim.x) {
    mk[r] = mask[row0 + r];
    itm[r] = r / L;
  }
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
    if constexpr (kF32)
      tile_product<C::NT, C::UJ, C::ST, C::W, false, true, true, true, C::G>(
          AStream{reinterpret_cast<const float*>(x) + row0 * D, D, Rt, D, Rt}, b, Rt, ring,
          qkv_epi);
    else
      tile_product<C::NT, C::UJ, C::ST, C::W, false, false, false, true, C::G>(
          ASmem{x_hi, x_hi, ldX}, b, Rt, ring, qkv_epi);
    for (int i0 = 0; i0 < Rt; i0 += kHalf) {
      // scores of rows i0 .. i0 + kHalf - 1 over the subtile, 16 x 32 units
      constexpr int nm = kHalf / 16, nn = kSub / 32;
      for (int u = warp; u < nm * nn; u += C::W) {
        const int m0 = u / nn * 16, n0 = u % nn * 32;
        float sa[4][4] = {};
        for (int k = 0; k < dhp; k += 16) {
          unsigned qh[4], ql[4];
          frag_a(qh, head_hi(0), ldh, i0 + m0, k);
          if (kF32) frag_a(ql, head_lo(0), ldh, i0 + m0, k);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            unsigned kb[2][2];
            frag_b_t(kb, head_hi(1), ldh, n0 + 16 * jj, k);
#pragma unroll
            for (int e = 0; e < 2; ++e) mma_bf16(sa[2 * jj + e], qh, kb[e]);
            if (kF32) {
              unsigned kl[2][2];
              frag_b_t(kl, head_lo(1), ldh, n0 + 16 * jj, k);
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                mma_bf16(sa[2 * jj + e], ql, kb[e]);
                mma_bf16(sa[2 * jj + e], qh, kl[e]);
              }
            }
          }
        }
        // the pair mask's operands in registers first: the score stores may
        // alias them for all the compiler knows
        float mr[2], mc[4][2];
        int ir[2], ic[4][2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mr[hh] = mk[i0 + m0 + g + 8 * hh];
          ir[hh] = itm[i0 + m0 + g + 8 * hh];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            mc[j][e] = mk[n0 + j * 8 + 2 * t + e];
            ic[j][e] = itm[n0 + j * 8 + 2 * t + e];
          }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              v[e] = sa[j][2 * hh + e];
              if (kSoftmax && !(mr[hh] * mc[j][e] > 0.f && ir[hh] == ic[j][e])) v[e] = -1e9f;
            }
            store2(Sh + (m0 + g + 8 * hh) * ldS + n0 + j * 8 + 2 * t, v[0], v[1]);
          }
        }
      }
      __syncthreads();
      // V2: e = exp(s - rowmax), its row sum in f32, then T(e); V2b: T(s). A
      // warp per two rows (i and i + kHalf / 2, interleaved), 5 values a
      // lane, read before the rows' T(e) are written
      constexpr int kPair = kHalf / 2;
      for (int i = warp; i < kPair; i += C::W) {
        constexpr int kPer = kSub / 32;
        float sv[2][kPer], sum[2] = {1.f, 1.f};
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < kPer; ++c) sv[r][c] = Sh[(i + r * kPair) * ldS + lane + 32 * c];
        if (kSoftmax) {
          float mx[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mx[r] = sv[r][0];
#pragma unroll
            for (int c = 1; c < kPer; ++c) mx[r] = fmaxf(mx[r], sv[r][c]);
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            sum[r] = 0.f;
#pragma unroll
            for (int c = 0; c < kPer; ++c) {
              sv[r][c] = expf(sv[r][c] - mx[r]);
              sum[r] += sv[r][c];
            }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
#pragma unroll
            for (int r = 0; r < 2; ++r) sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], o);
        }
        if (lane == 0) {
          rs[i0 + i] = sum[0];
          rs[i0 + i + kPair] = sum[1];
        }
        __syncwarp();
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < kPer; ++c)
            put(p_hi, p_lo, (i + r * kPair) * ldP + lane + 32 * c, rnd<T>(sv[r][c]), kF32);
      }
      __syncthreads();
      // o = T((T(e) v) / rowsum) for the half's rows, 16 x 16 units
      const int nd = dhp / 16;
      for (int u = warp; u < nm * nd; u += C::W) {
        const int m0 = u / nd * 16, n0 = u % nd * 16;
        float acc[2][4] = {};
        for (int k = 0; k < kSub; k += 16) {
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
            const int i = i0 + m0 + g + 8 * hh;
            store2(os + i * ldo + d, rnd<T>(acc[j][2 * hh] / rs[i]),
                   rnd<T>(acc[j][2 * hh + 1] / rs[i]));
          }
        }
      }
      __syncthreads();  // the half's scores are free again
    }
    // out's head columns of each item = T(sum_l T(o_l)), rows in order
    for (int e = tid; e < items * dh; e += blockDim.x) {
      const int it = e / dh, d = e % dh;
      const float* p = os + it * L * ldo + d;
      float s = 0.f;
      for (int l = 0; l < L; ++l) s += p[l * ldo];
      out[((long)blockIdx.x * items + it) * D + h * dh + d] = from_f<T>(s);
    }
    __syncthreads();  // the ring and the output tile are free again
  }
}

// ---- host -------------------------------------------------------------------

template <bool kF32> long smem_bytes(int stage, int L, int D, int H, int Q) {
  if (stage == kPassthrough) {
    const int es = kF32 ? 4 : 2;
    return 4L * sum_items(D, es) * sum_geom(D, es).Rp * D;
  }
  if (per_subtile(stage)) return subtile_smem_bytes<kF32>(D, H);
  const long own = items_smem_bytes<kF32>(L, D, H);
  if (stage != kTail) return own;
  const long tail = newsrec_fused_encoder_smem_bytes(kF32 ? 0 : 1, L, D, H, Q);
  return own > tail ? own : tail;
}

template <typename Kernel, typename... Args>
cudaError_t run(Kernel kernel, dim3 grid, int threads, long smem, cudaStream_t stream,
                Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int stage, const void* xv, const float* mask, const void* wqkv,
                   const void* bqkv, const void* wo, const void* bo, const void* aw,
                   const void* ab, const void* aq, void* outv, void* ws, void* o1v, void* o2,
                   int M, int L, int D, int H, int Q, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr bool kF32 = sizeof(T) == 4;
  const T* x = static_cast<const T*>(xv);
  const T* bq = static_cast<const T*>(bqkv);
  T* out = static_cast<T*>(outv);
  const long smem = smem_bytes<kF32>(stage, L, D, H, Q);
  if (stage == kPassthrough) {
    const int ipb = sum_items(D, sizeof(T));
    return run(ablate_sum_kernel<T>, dim3((M + ipb - 1) / ipb), sum_block(D, sizeof(T)),
               smem, stream, x, out, M, L, D, ipb);
  }
  // the weights as the forward's kernels read them, in ws (WsLayout)
  const WsLayout wl = ws_layout(D, H, Q);
  bf16* w_hi = static_cast<bf16*>(ws);
  bf16* w_lo = kF32 ? w_hi + wl.total : nullptr;
  const long n_w = 3L * D * D + (long)D * D + (long)D * Q;
  stage_weights_kernel<T><<<(int)((n_w + 255) / 256 < 2048 ? (n_w + 255) / 256 : 2048), 256, 0,
                            stream>>>(static_cast<const T*>(wqkv), static_cast<const T*>(wo),
                                      static_cast<const T*>(aw), D, H, Q, w_hi, w_lo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int dhp = round16(D / H);
  // head 0's q|k|v columns, each padded to dhp (the kernels move to head h)
  const BOp qkv_head{w_hi + wl.head, kF32 ? w_lo + wl.head : nullptr, wl.ld_head, D, 3 * dhp,
                     dhp, D / H};
  if (per_subtile(stage)) {
    const int blocks = (int)((long)M * L / kSub), hpb = blocks >= kAllHeadsBlocks ? H : 1;
    const dim3 grid(blocks, (H + hpb - 1) / hpb);
    if (stage == kAttn)
      return run(ablate_subtile_kernel<T, true>, grid, 32 * SubCfg<kF32>::W, smem, stream, x,
                 mask, qkv_head, bq, out, L, D, H, hpb, scale);
    return run(ablate_subtile_kernel<T, false>, grid, 32 * SubCfg<kF32>::W, smem, stream, x,
               mask, qkv_head, bq, out, L, D, H, hpb, scale);
  }
  const int tiles = (M + items_per_tile(L) - 1) / items_per_tile(L);
  const int hpb = tiles >= kAllHeadsBlocks ? H : 1;
  const dim3 grid(tiles, (H + hpb - 1) / hpb);
  const long own = items_smem_bytes<kF32>(L, D, H);
  T* o1 = static_cast<T*>(o1v);
  if (stage == kQkv)
    return run(ablate_items_kernel<T, kQkv>, grid, 256, own, stream, x, qkv_head, bq, out, o1, M,
               L, D, H, hpb);
  if (stage == kAttnSlices)
    return run(ablate_items_kernel<T, kAttnSlices>, grid, 256, own, stream, x, qkv_head, bq, out,
               o1, M, L, D, H, hpb);
  if ((err = run(ablate_items_kernel<T, kTail>, grid, 256, own, stream, x, qkv_head, bq, out, o1,
                 M, L, D, H, hpb)) != cudaSuccess)
    return err;
  return static_cast<cudaError_t>(newsrec_fused_encoder_fwd_tail(
      kF32 ? 0 : 1, mask, o1, ws, bo, ab, aq, out, o2, M, L, D, H, Q, stream));
}

}  // namespace

extern "C" {

// stage: 0 passthrough, 1 qkv, 2 attn, 3 tail, 4 attn_slices, 5
// attn_nosoftmax. dtype: 0 = float32, 1 = bfloat16 (x, weights and out);
// mask is float32. ws: room for newsrec_fused_encoder_fwd_ws_elems(D, H, Q)
// bfloat16 values, twice that for float32 (every stage but passthrough);
// o1: [M * L, D] in x's dtype (tail only); o2: the forward's o2 scratch
// (newsrec_fused_encoder_fwd_o2_elems; tail only, null where that is 0).
// Needs D % H == 0 and an even head width; passthrough an item of a multiple
// of 16 bytes; the subtile stages kSub % L == 0 and M * L % kSub == 0. All
// operands contiguous on one device, 16-byte aligned. Returns a cudaError_t
// code.
int newsrec_ablate_encoder(int stage, int dtype, const void* x, const void* mask,
                           const void* wqkv, const void* bqkv, const void* wo, const void* bo,
                           const void* aw, const void* ab, const void* aq, void* out, void* ws,
                           void* o1, void* o2, int M, int L, int D, int H, int Q, float scale,
                           void* stream) {
  if (stage < 0 || stage > kAttnNoSoftmax || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  if (D % H || (D / H) % 2) return cudaErrorInvalidValue;
  if (stage == kPassthrough) {
    const int es = dtype == 0 ? 4 : 2;
    const SumGeom sg = sum_geom(D, es);
    if (((long)L * D * es) % 16 || L % sg.Rp || sum_block(D, es) > 1024)
      return cudaErrorInvalidValue;
  }
  if (per_subtile(stage) && (kSub % L || ((long)M * L) % kSub)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (dtype == 0)
    return launch<float>(stage, x, m, wqkv, bqkv, wo, bo, aw, ab, aq, out, ws, o1, o2, M, L, D, H,
                         Q, scale, s);
  return launch<__nv_bfloat16>(stage, x, m, wqkv, bqkv, wo, bo, aw, ab, aq, out, ws, o1, o2, M, L,
                               D, H, Q, scale, s);
}

// the most shared memory one block of the stage's kernels needs
long newsrec_ablate_encoder_smem_bytes(int stage, int dtype, int L, int D, int H, int Q) {
  return dtype == 0 ? smem_bytes<true>(stage, L, D, H, Q) : smem_bytes<false>(stage, L, D, H, Q);
}

}  // extern "C"
