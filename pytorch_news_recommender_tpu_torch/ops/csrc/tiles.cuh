// Tensor-core pieces shared by the fused encoder's forward
// (fused_encoder.cu) and backward (fused_encoder_bwd.cu): the tiles of
// whole items (tile_rows, items_per_tile), the weights re-laid once per call
// into 16-byte aligned rows (WsLayout, stage_weights_kernel), the weight
// operand (BOp) and the A operands (ASmem, AStream), and tile_product, the
// block's product with a weight over a cp.async ring of 64-deep weight
// tiles on mma.sync m16n8k16 (bf16 operands, f32 sums, high/low split of
// f32 operands). The backward's head note says how they were designed.

#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

// ---- the per-item backward: geometry and the tile product ------------------

constexpr int kTileRows = 64;     // R_t: token rows of whole items per block

constexpr int kKT = 64;           // depth of a staged weight tile
// Per kernel and dtype: the width of a staged weight tile (NT columns), a
// warp's unit (16 rows x UJ n8 tiles), the tiles in flight (ST), and the
// block's warps. pool_bwd's 16 warps take a 64 x 128 chunk, one 16 x 32
// unit each (in f32, where the weights' low parts double a tile, 8 warps
// on 64-column chunks); measured on the H100, all of D = 300 at once in
// 16 x 80 units from 32-deep tiles, as much as shared memory leaves room
// for, was slower. dx's 16 warps take all of D in 16 x 80 units, one block
// per tile, so dqkv is read once (three 128-column blocks, which read it
// three times, were slower). attn_bwd takes a head's 3 x 32 columns as
// 16 x 48 units, one for each of its 8 warps, two blocks per SM in bf16.
// A tile past 64 rows (one item of L > 64) has larger operand tiles
// beside the ring: pool_bwd then takes 64-column chunks (32 in f32) in
// 16 x 16 units, so that L up to 80 fits at D = 300, Q = 200 (PoolWide).
// attn_bwd's streamed variant (kVarAttnBwd, f32) takes 64-column chunks in
// 16 x 32 units (AttnStream): beside the 8 head tiles of dh = 128 (D = 512,
// 4 heads) a 96-wide ring overflows one block by 1,024 bytes. The width of
// a chunk changes no sum: each output's MMAs run over k in the same order.
template <bool kF32> struct Cfg {
  struct Pool { static constexpr int NT = kF32 ? 64 : 128, UJ = 4, ST = kF32 ? 2 : 3, W = kF32 ? 8 : 16; };
  struct PoolWide { static constexpr int NT = kF32 ? 32 : 64, UJ = 2, ST = Pool::ST, W = Pool::W; };
  struct Attn { static constexpr int NT = 96, UJ = 6, ST = kF32 ? 2 : 3, W = 8; };
  struct AttnStream { static constexpr int NT = 64, UJ = 4, ST = Attn::ST, W = Attn::W; };
  struct Dx { static constexpr int NT = 320, UJ = 10, ST = kF32 ? 2 : 3, W = 16; };
};

// a staged weight tile of NT columns, in bf16: kKT x (NT + 8)
// stored by rows, NT x (kKT + 8) by columns (8 more so that the rows of an
// ldmatrix fall in distinct banks); a stage holds the high and, for f32
// weights, the low tile
template <int NT> __host__ __device__ constexpr int b_part() {
  return kKT * (NT + 8) > NT * (kKT + 8) ? kKT * (NT + 8) : NT * (kKT + 8);
}
template <int NT> __host__ __device__ constexpr int b_stage_bytes(bool lo) {
  return 2 * b_part<NT>() * (lo ? 2 : 1);
}

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }
// whole items per block, and the block's rows rounded up to the MMA's 16
__host__ __device__ inline int items_per_tile(int L) { return L <= kTileRows ? kTileRows / L : 1; }
__host__ __device__ inline int tile_rows(int L) { return round16(items_per_tile(L) * L); }
// row stride (bf16) of an operand tile of depth K: K padded to 16, plus 8
// so that the eight rows of an ldmatrix fall in distinct banks
__host__ __device__ inline int lda_of(int K) { return round16(K) + 8; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline int round8(int v) { return (v + 7) & ~7; }

// The dynamic shared memory of one block on Hopper (bytes)
constexpr long kMaxSmem = 232448;

// The wide variants of the per-item kernels, one bit each. A kernel whose
// layout does not fit kMaxSmem at the shapes (D = 800, Q = 400 in NAML's
// user tower) takes its wide variant, for tiles of at most 64 rows; at
// every shape where it fits it keeps its layout, launches and bits.
//   kVarFwdAttn, kVarAttnBwd (f32 only): x is not held whole in shared
//     memory but streamed through the weight ring (AStream), 64 columns a
//     stage, and split into high and low parts in registers; attn_bwd's
//     weight tiles are then 64 columns wide (Cfg::AttnStream).
//   kVarFwdTail, kVarPoolBwd: the f32 rows (o2; in pool_bwd also t, dpre,
//     do2) live in device memory, not in shared memory. In bf16 the A
//     operands that fit stay whole in shared memory, one part wide (o1,
//     T(o2), and dpre's high and low parts), and do2 is streamed; in f32
//     every A operand is streamed.
enum : int { kVarFwdAttn = 1, kVarFwdTail = 2, kVarPoolBwd = 4, kVarAttnBwd = 8 };
// their names, bit i's at [i] (newsrec_fused_encoder_variant_name)
constexpr const char* kVarNames[] = {"fwd_attn", "fwd_tail", "pool_bwd", "attn_bwd"};

// The weights as the per-item kernels read them, written once per call
// into `ws` (bf16: the weights, or for f32 weights their high parts, then
// as many low parts): Wqkv with each head's q, k and v columns side by
// side, each padded from dh to dhp ([D][H * 3 * dhp]), then Wqkv, Wo and
// aw with rows padded to a multiple of 8. Every row and every head's block
// starts 16 bytes aligned, so each copy of a weight tile is 16 bytes; the
// pads are never written and never read (a copy reads only a unit's valid
// values, cp.async's source size).
struct WsLayout {
  int ld_head, ld_qkv, ld_o, ld_aw;
  long head, qkv, o, aw, total;  // element offsets of each matrix, and the size of a part
};
__host__ __device__ inline WsLayout ws_layout(int D, int H, int Q) {
  WsLayout w;
  w.ld_head = H * 3 * round16(D / H);
  w.ld_qkv = round8(3 * D);
  w.ld_o = round8(D);
  w.ld_aw = round8(Q);
  w.head = 0;
  w.qkv = (long)D * w.ld_head;
  w.o = w.qkv + (long)D * w.ld_qkv;
  w.aw = w.o + (long)D * w.ld_o;
  w.total = w.aw + (long)D * w.ld_aw;
  return w;
}

// A weight operand in device memory, bf16, laid out as in WsLayout.
struct BOp {
  const __nv_bfloat16* hi;
  const __nv_bfloat16* lo;  // null unless the weights are f32
  long ld;                  // row stride of the stored matrix
  int K, N;                 // the product's depth and width
  // B stored by rows: column n of the product is column n of the stored
  // matrix, and 0 where n % seg_w >= seg_n (a head's q|k|v columns, each
  // padded to seg_w); plain: seg_w = seg_n = N. B stored by columns (W^T):
  // row n, column k of the matrix.
  int seg_w, seg_n;
};

BOp plain_b(const __nv_bfloat16* hi, const __nv_bfloat16* lo, long ld, int K, int N) {
  return BOp{hi, lo, ld, K, N, N, N};
}
// the product with the transpose of b's stored matrix (read by columns)
__host__ __device__ inline BOp transposed(BOp b) {
  const int k = b.K;
  b.K = b.N;
  b.N = b.seg_w = b.seg_n = k;
  return b;
}

// The A operand held whole in shared memory as bf16 tiles [rows][ld]:
// the value, or its high and low parts
struct ASmem {
  const __nv_bfloat16* hi;
  const __nv_bfloat16* lo;
  int ld;
  __host__ __device__ static int stage_bytes(int) { return 0; }
  __device__ void load(unsigned char*, int) const {}
  __device__ void frag(const unsigned char*, int m0, int k, int, unsigned* h, unsigned* l,
                       bool split) const {
    frag_a(h, hi, ld, m0, k);
    if (split) frag_a(l, lo, ld, m0, k);
  }
};

// An f32 A operand in device memory (rows row0 .. row0 + rows - 1, stride
// ld, depth K), staged with the weights, KT columns a stage, and split
// into high and low parts in registers
struct AStream {
  static constexpr int KT = kKT;
  const float* a;
  long ld;
  int rows, K, Rt;
  static constexpr int kLd = KT + 8;  // 288-byte rows: float2 loads free of bank conflicts
  __host__ __device__ static int stage_bytes(int Rt) { return Rt * kLd * 4; }
  __device__ void load(unsigned char* st, int k0) const {
    float* s = reinterpret_cast<float*>(st);
    for (int i = threadIdx.x; i < Rt * (KT / 4); i += blockDim.x) {
      const int r = i / (KT / 4), c = (i % (KT / 4)) * 4;
      const bool valid = r < rows && k0 + c < K;
      cp_async(s + r * kLd + c, valid ? a + r * ld + k0 + c : a, 16, valid ? 16 : 0);
    }
  }
  __device__ void frag(const unsigned char* st, int m0, int, int kk, unsigned* h, unsigned* l,
                       bool) const {
    const int lane = threadIdx.x & 31;
    const float* p = reinterpret_cast<const float*>(st) + (m0 + (lane >> 2)) * kLd + kk +
                     2 * (lane & 3);
    const float2 v0 = *reinterpret_cast<const float2*>(p);
    const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * kLd);
    const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
    const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * kLd + 8);
    split_bf16x2(v0.x, v0.y, h[0], l[0]);
    split_bf16x2(v1.x, v1.y, h[1], l[1]);
    split_bf16x2(v2.x, v2.y, h[2], l[2]);
    split_bf16x2(v3.x, v3.y, h[3], l[3]);
  }
};

// v into a bf16 operand tile: rounded (a value already in bf16), or split
// into high and low parts
__device__ __forceinline__ void put(__nv_bfloat16* hi, __nv_bfloat16* lo, int i, float v,
                                    bool split) {
  if (split)
    split_bf16(v, hi[i], lo[i]);
  else
    hi[i] = __float2bfloat16_rn(v);
}

// V consecutive values (V = 2 or 4; 4V-byte aligned) as f32
template <int V> __device__ __forceinline__ void load_v(const float* p, float* o) {
  if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    o[0] = a.x; o[1] = a.y;
  }
}
template <int V> __device__ __forceinline__ void load_v(const __nv_bfloat16* p, float* o) {
#pragma unroll
  for (int e = 0; e < V; e += 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + e));
    o[e] = a.x; o[e + 1] = a.y;
  }
}

// rows x cols of a row-major matrix in device memory (row stride ld; cols
// a multiple of V) into an operand tile of Rt rows and cols16 columns (row
// stride ldt), zeros past rows and cols: V values a load
template <int V, typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src, long ld, int rows, int cols,
                                           int Rt, int cols16, __nv_bfloat16* hi,
                                           __nv_bfloat16* lo, int ldt, bool split) {
  const int per = cols16 / V;
  for (int i = threadIdx.x; i < Rt * per; i += blockDim.x) {
    const int r = i / per, c = (i % per) * V;
    float v[V];
    if (r < rows && c < cols) {
      load_v<V>(src + r * ld + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) put(hi, lo, r * ldt + c + e, v[e], split);
  }
}

// The copies of one staged weight tile: depth k0 .. k0 + KT - 1, columns
// n0 .. n0 + NT - 1 of the product, 8 values a copy; what lies past K or N
// (or past seg_n in a segment) is zero-filled, not read.
template <int NT, bool kByCols, bool kGather>
__device__ __forceinline__ void load_b(const BOp& b, const __nv_bfloat16* src,
                                       __nv_bfloat16* dst, int k0, int n0) {
  constexpr int KT = kKT;
  auto clamp8 = [](int v) { return v < 0 ? 0 : (v > 8 ? 8 : v); };
  if (kByCols) {
    constexpr int per = KT / 8;
    for (int i = threadIdx.x; i < NT * per; i += blockDim.x) {
      const int r = i / per, c = (i % per) * 8, n = n0 + r, k = k0 + c;
      const int nv = n < b.N ? clamp8(b.K - k) : 0;
      cp_async(dst + r * (KT + 8) + c, nv ? src + n * b.ld + k : src, 16, 2 * nv);
    }
  } else {
    constexpr int per = NT / 8;
    for (int i = threadIdx.x; i < KT * per; i += blockDim.x) {
      const int r = i / per, c = (i % per) * 8, n = n0 + c, k = k0 + r;
      int lim = b.N - n;
      if (kGather) {
        const int d = n % b.seg_w, left = b.seg_n - d;
        lim = left < lim ? left : lim;
      }
      const int nv = k < b.K ? clamp8(lim) : 0;
      cp_async(dst + r * (NT + 8) + c, nv ? src + k * b.ld + n : src, 16, 2 * nv);
    }
  }
}

// C = A B over the block's Rt rows (a multiple of 16) and B's N columns, on
// the tensor cores, handed to epi(r, n, C[r][n], C[r][n + 1]) for even n <
// N. The passes: A_hi B_hi, then A_lo B_hi where A is split (kASplit), then
// A_hi B_lo where the weights are f32 (kBLo). The block walks 64-row groups
// x NT-column chunks x kKT-deep weight tiles in one sequence, ST tiles in
// flight in a cp.async ring (`ring`, ST x (A's stage + B's)); warp w of W
// takes the 16 x 8UJ units w, w + W of a 64 x NT chunk. Every thread of the
// block calls it; it ends with a barrier.
template <int NT, int UJ, int ST, int W, bool kByCols, bool kASplit, bool kBLo,
          bool kGather = false, typename AOp, typename EpiFn>
__device__ void tile_product(const AOp& A, const BOp& B, int Rt, unsigned char* ring, EpiFn epi) {
  static_assert(UJ % 2 == 0 && NT % (8 * UJ) == 0, "units of whole n16 pairs");
  constexpr int NU = NT / (8 * UJ);          // units across a chunk
  constexpr int kU = (4 * NU + W - 1) / W;  // units per warp at most
  constexpr int ldb = kByCols ? kKT + 8 : NT + 8;
  const int a_bytes = AOp::stage_bytes(Rt);
  const int stage = a_bytes + b_stage_bytes<NT>(kBLo);
  const int K16 = round16(B.K);
  const int kts = (K16 + kKT - 1) / kKT, chunks = (B.N + NT - 1) / NT;
  const int steps = (Rt + 63) / 64 * chunks * kts;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  auto b_hi = [&](unsigned char* st) { return reinterpret_cast<__nv_bfloat16*>(st + a_bytes); };
  // the k-tile and chunk of the next step to load, counted on (no division)
  int lk = 0, lc = 0;
  auto load = [&](int s) {
    unsigned char* st = ring + (s % ST) * stage;
    const int k0 = lk * kKT, n0 = lc * NT;
    A.load(st, k0);
    load_b<NT, kByCols, kGather>(B, B.hi, b_hi(st), k0, n0);
    if (kBLo) load_b<NT, kByCols, kGather>(B, B.lo, b_hi(st) + b_part<NT>(), k0, n0);
    if (++lk == kts) {
      lk = 0;
      if (++lc == chunks) lc = 0;
    }
  };
  float acc[kU][UJ][4];
#pragma unroll
  for (int u = 0; u < kU; ++u)
#pragma unroll
    for (int j = 0; j < UJ; ++j) acc[u][j][0] = acc[u][j][1] = acc[u][j][2] = acc[u][j][3] = 0.f;
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  int kt = 0, chunk = 0, grp = 0;  // of the step computed
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // step s landed; step s - 1's reads of its stage done
    if (s + ST - 1 < steps) load(s + ST - 1);
    cp_async_commit();
    const unsigned char* st = ring + (s % ST) * stage;
    const __nv_bfloat16* bh = reinterpret_cast<const __nv_bfloat16*>(st + a_bytes);
    const __nv_bfloat16* bl = bh + b_part<NT>();
    const int rows = Rt - grp * 64 < 64 ? Rt - grp * 64 : 64;
    const int units = rows / 16 * NU;
#pragma unroll
    for (int ui = 0; ui < kU; ++ui) {
      const int u = warp + ui * W;
      if (u >= units) continue;
      const int m0 = grp * 64 + u / NU * 16, nl = u % NU * 8 * UJ;
      if (chunk * NT + nl >= B.N) continue;
#pragma unroll
      for (int ks = 0; ks < kKT; ks += 16) {
        const int k = kt * kKT + ks;
        if (k >= K16) break;
        unsigned ah[4], al[4], bhf[UJ][2], blf[UJ][2];
        A.frag(st, m0, k, ks, ah, al, kASplit);
#pragma unroll
        for (int jj = 0; jj < UJ / 2; ++jj) {
          if (kByCols) {
            frag_b_t(bhf + 2 * jj, bh, ldb, nl + 16 * jj, ks);
            if (kBLo) frag_b_t(blf + 2 * jj, bl, ldb, nl + 16 * jj, ks);
          } else {
            frag_b(bhf + 2 * jj, bh, ldb, nl + 16 * jj, ks);
            if (kBLo) frag_b(blf + 2 * jj, bl, ldb, nl + 16 * jj, ks);
          }
        }
        // the passes in turn, so that an accumulator's next MMA is UJ away
#pragma unroll
        for (int j = 0; j < UJ; ++j) mma_bf16(acc[ui][j], ah, bhf[j]);
        if (kASplit) {
#pragma unroll
          for (int j = 0; j < UJ; ++j) mma_bf16(acc[ui][j], al, bhf[j]);
        }
        if (kBLo) {
#pragma unroll
          for (int j = 0; j < UJ; ++j) mma_bf16(acc[ui][j], ah, blf[j]);
        }
      }
    }
    if (kt == kts - 1) {
#pragma unroll
      for (int ui = 0; ui < kU; ++ui) {
        const int u = warp + ui * W;
        if (u < units) {
          const int m0 = grp * 64 + u / NU * 16, nl = u % NU * 8 * UJ;
#pragma unroll
          for (int j = 0; j < UJ; ++j) {
            const int n = chunk * NT + nl + j * 8 + 2 * t;
            if (n < B.N) {
              epi(m0 + g, n, acc[ui][j][0], acc[ui][j][1]);
              epi(m0 + g + 8, n, acc[ui][j][2], acc[ui][j][3]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < UJ; ++j) acc[ui][j][0] = acc[ui][j][1] = acc[ui][j][2] = acc[ui][j][3] = 0.f;
      }
    }
    if (++kt == kts) {
      kt = 0;
      if (++chunk == chunks) {
        chunk = 0;
        ++grp;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// pool_bwd's geometry: PoolWide for a tile past 64 rows
template <bool kF32, bool kWide>
using PoolCfg = std::conditional_t<kWide, typename Cfg<kF32>::PoolWide, typename Cfg<kF32>::Pool>;

// The weights into ws as WsLayout lays them out (their high and low parts
// for f32 weights), one thread per value of Wqkv, Wo, aw in turn
template <typename T>
__global__ void stage_weights_kernel(const T* __restrict__ wqkv, const T* __restrict__ wo,
                                     const T* __restrict__ aw, int D, int H, int Q,
                                     __nv_bfloat16* __restrict__ hi,
                                     __nv_bfloat16* __restrict__ lo) {
  const WsLayout w = ws_layout(D, H, Q);
  const int dh = D / H, dhp = round16(dh);
  const long n_qkv = 3L * D * D, n_o = (long)D * D, n = n_qkv + n_o + (long)D * Q;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    float v;
    long at, at2 = -1;
    if (i < n_qkv) {
      const int k = (int)(i / (3 * D)), c = (int)(i % (3 * D));
      const int seg = c / D, h = c % D / dh, d = c % dh;
      v = to_f(wqkv[i]);
      at = w.qkv + (long)k * w.ld_qkv + c;
      at2 = w.head + (long)k * w.ld_head + (h * 3 + seg) * dhp + d;
    } else if (i < n_qkv + n_o) {
      const long j = i - n_qkv;
      v = to_f(wo[j]);
      at = w.o + j / D * w.ld_o + j % D;
    } else {
      const long j = i - n_qkv - n_o;
      v = to_f(aw[j]);
      at = w.aw + j / Q * w.ld_aw + j % Q;
    }
    __nv_bfloat16 h_, l_;
    split_bf16(v, h_, l_);
    if (sizeof(T) == 2) h_ = __float2bfloat16_rn(v);  // a bf16 weight is its own high part
    hi[at] = h_;
    if (at2 >= 0) hi[at2] = h_;
    if (sizeof(T) == 4) {
      lo[at] = l_;
      if (at2 >= 0) lo[at2] = l_;
    }
  }
}

}  // namespace
