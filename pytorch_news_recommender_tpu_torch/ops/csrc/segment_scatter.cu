// Row scatter-add for Hopper (sm_90a): out[u] = sum of g[s] over idx[s] == u.
//
// Replaces the TPU kernel `_scatter_kernel` (called through
// `scatter_add_rows`) in the JAX package's ops/pallas/segment_scatter.py:
// the backward of the dedup inverse gathers (`dedup_gather`), whose indices
// are heavily skewed (the pad news holds about half the history slots of a
// batch, so one destination row has some 12,800 sources while most have a
// handful).
//
// What it computes: idx [S] int32, g [S, D] (float32 or bfloat16) ->
// out [U, D] float32, out[u] = sum_{s: idx[s] = u} g[s] in f32, rows with
// no source 0. An entry of idx outside [0, U) matches no row (the TPU
// kernel pads with such an id).
//
// Bound. The TPU kernel gets the sum from one-hot [BU, BS] x [BS, D] matrix
// products, 2*U*S*D FLOP whatever the data. Here the work is bytes: g read
// once, idx read once, out written once, (S*D*itemsize + 4*S + 4*U*D) bytes
// over 3.35 TB/s; about 8 us for the browsed gather of a batch-512 NRMS
// step (S = 25,600, U = 9,216, D = 300, bf16) and 4 us for its candidate
// gather (S = 3,072). No one-hot product is carried over.
//
// Design. A stable counting sort of idx, done by the kernel's own passes,
// gives every row its sources in ascending s; a fixed partition of the
// sorted positions then sums them, and nothing depends on the order in
// which blocks run, so two launches give the same bits (no float atomics,
// no integer atomics either). Six launches, the fixup only where the
// reduction has more than one block:
//   1. count:  per chunk c of kChunk sources, cnt[c][u] = the chunk's
//              sources of row u (written by the chunk's first such source,
//              found by comparing against the chunk's ids in shared memory),
//              after the block has zeroed its row of cnt;
//   2. column scan: per row, the prefix of cnt over chunks, and the row's
//              total;
//   3. row scan: one block turns the totals into row starts rs[U + 1];
//   4. place:  source s of chunk c goes to position rs[u] + cnt[c][u] +
//              (earlier sources of u in the chunk): perm[pos] = s,
//              key[pos] = u;
//   5. reduce: block j sums the g rows of positions [j*seg, (j+1)*seg) in
//              order, each thread over two adjacent columns (one 4-byte
//              bf16x2 or 8-byte float2 load a row). A row whose positions
//              all lie in the block is written out; a row that crosses a
//              block edge (the skewed ones) leaves its part in one of the
//              block's two partial slots, which keeps the long rows from
//              serialising on one block. Block j also writes 0 to the rows
//              with no source among its share of U (the output is dense);
//   6. fixup:  one block per row that crosses an edge adds its parts: warp w
//              takes the parts j0 + w, j0 + w + 32, ..., then the 32 warp
//              sums are added in warp order.
// The segment length seg is a function of S alone (seg_of): the power of
// two that gives the reduction about kTargetBlocks blocks, two per SM of an
// H100, between kMinSeg and kMaxSeg positions. Each thread sums seg rows in
// rounds of kBatch independent loads, so a short segment is a short chain:
// at the candidate gather (S = 3,072) seg = 16 gives 192 blocks of two
// rounds, where 128 gave 24 blocks of sixteen. The sums are f32 in a fixed
// order; only that order differs from a sequential sum. What the launches
// cost, measured on an H100, is in PERF.md (chip_smoke.py's phase 7a).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 256;    // sources per block of the counting passes (= its threads)
// sorted positions per block of the reduction: a power of two from S
constexpr int kMinSeg = 16, kMaxSeg = 128, kTargetBlocks = 264;
constexpr int kScanThreads = 1024;
constexpr int kFixWarps = 32;
// loads a thread issues before it uses the first of them: the sums and
// scans below run in order, so their loads are taken kBatch at a time
// instead of one latency each
constexpr int kBatch = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

long chunks(long S, int per) { return (S + per - 1) / per; }

// the reduction's segment length for S sources
int seg_of(long S) {
  int seg = kMinSeg;
  while (seg < kMaxSeg && (long)seg * kTargetBlocks < S) seg *= 2;
  return seg;
}

// Loads the ids of chunk c into shared memory; returns the chunk's size.
__device__ __forceinline__ int load_chunk(const int* __restrict__ idx, long S, int* ids) {
  const long s = (long)blockIdx.x * kChunk + threadIdx.x;
  ids[threadIdx.x] = s < S ? idx[s] : -1;
  __syncthreads();
  const long left = S - (long)blockIdx.x * kChunk;
  return left < kChunk ? (int)left : kChunk;
}

__global__ void __launch_bounds__(kChunk)
ss_count_kernel(const int* __restrict__ idx, long S, int U, int* __restrict__ cnt) {
  __shared__ int ids[kChunk];
  int* row = cnt + (long)blockIdx.x * U;
  for (int u = threadIdx.x; u < U; u += blockDim.x) row[u] = 0;
  const int n = load_chunk(idx, S, ids);  // its barrier orders the zeros first
  const int t = threadIdx.x;
  if (t >= n) return;
  const int u = ids[t];
  if (u < 0 || u >= U) return;
  int before = 0, total = 0;
  for (int j = 0; j < n; ++j) {
    const int e = ids[j] == u;
    total += e;
    before += e & (j < t);
  }
  if (before == 0) row[u] = total;
}

// cnt[c][u] -> sources of row u in chunks before c; rs[u] = row u's total
__global__ void ss_column_scan_kernel(int* __restrict__ cnt, long C, int U, int* __restrict__ rs) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= U) return;
  int run = 0;
  for (long c0 = 0; c0 < C; c0 += kBatch) {
    int v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) v[k] = c0 + k < C ? cnt[(c0 + k) * U + u] : 0;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k < C) cnt[(c0 + k) * U + u] = run;
      run += v[k];
    }
  }
  rs[u] = run;
}

// rs[0..U) totals -> exclusive prefix, rs[U] = all sources in range.
// One block of kScanThreads threads, each owning a run of rows.
__global__ void __launch_bounds__(kScanThreads) ss_row_scan_kernel(int* __restrict__ rs, int U) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int per = (U + kScanThreads - 1) / kScanThreads;
  const int b = min(t * per, U), e = min(b + per, U);
  int local = 0;
  for (int i = b; i < e; ++i) local += rs[i];
  int incl = local;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[w] = incl;
  __syncthreads();
  if (w == 0) {
    const int v = warp_sums[lane];
    int wi = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += x;
    }
    warp_sums[lane] = wi - v;
  }
  __syncthreads();
  int run = warp_sums[w] + incl - local;
  for (int i = b; i < e; ++i) {
    const int v = rs[i];
    rs[i] = run;
    run += v;
  }
  if (t == kScanThreads - 1) rs[U] = run;
}

__global__ void __launch_bounds__(kChunk)
ss_place_kernel(const int* __restrict__ idx, long S, int U, const int* __restrict__ cnt,
                const int* __restrict__ rs, int* __restrict__ perm, int* __restrict__ key) {
  __shared__ int ids[kChunk];
  const int n = load_chunk(idx, S, ids);
  const int t = threadIdx.x;
  if (t >= n) return;
  const int u = ids[t];
  if (u < 0 || u >= U) return;
  int before = 0;
  for (int j = 0; j < t; ++j) before += ids[j] == u;
  const int pos = rs[u] + cnt[(long)blockIdx.x * U + u] + before;
  perm[pos] = (int)((long)blockIdx.x * kChunk + t);
  key[pos] = u;
}

// two adjacent columns c, c + 1 of row s (c + 1 < D or not); a vector
// load where D is even, so that every row is aligned for it
__device__ __forceinline__ float2 load_pair(const float* g, long s, int D, int c) {
  const float* p = g + s * D + c;
  if (!(D & 1)) return *reinterpret_cast<const float2*>(p);
  return make_float2(p[0], c + 1 < D ? p[1] : 0.f);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* g, long s, int D, int c) {
  const __nv_bfloat16* p = g + s * D + c;
  if (!(D & 1)) return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return make_float2(to_f(p[0]), c + 1 < D ? to_f(p[1]) : 0.f);
}
__device__ __forceinline__ void store_pair(float* p, int D, int c, float2 v) {
  p[c] = v.x;
  if (c + 1 < D) p[c + 1] = v.y;
}

// partial[j][0]: block j's part of the row at its first position, when that
// row started before or at the block's start and does not end in it;
// partial[j][1]: its part of the row at its last position, when that row
// started inside the block and goes on past it. Then the rows with no
// source among rows [j * rows_per, (j + 1) * rows_per) are written 0.
template <typename T>
__global__ void ss_reduce_kernel(const T* __restrict__ g, int D, int U, int seg, int rows_per,
                                 const int* __restrict__ rs, const int* __restrict__ perm,
                                 const int* __restrict__ key, float* __restrict__ partial,
                                 float* __restrict__ out) {
  __shared__ int sp[kMaxSeg], sk[kMaxSeg];
  const int n = rs[U];
  const int p0 = blockIdx.x * seg;
  const int m = p0 < n ? min(seg, n - p0) : 0;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    sp[i] = perm[p0 + i];
    sk[i] = key[p0 + i];
  }
  __syncthreads();
  for (int col = 2 * threadIdx.x; col < D; col += 2 * blockDim.x) {
    float2 acc = make_float2(0.f, 0.f);
    int start = 0;
    for (int i0 = 0; i0 < m; i0 += kBatch) {
      float2 v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        v[k] = i0 + k < m ? load_pair(g, sp[i0 + k], D, col) : make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = i0 + k;
        if (i >= m) break;
        acc.x += v[k].x;
        acc.y += v[k].y;
        if (i + 1 == m || sk[i + 1] != sk[i]) {
          const int u = sk[i], r0 = rs[u], r1 = rs[u + 1];
          if (p0 + start == r0 && p0 + i + 1 == r1) {
            store_pair(out + (long)u * D, D, col, acc);
          } else {
            store_pair(partial + ((long)blockIdx.x * 2 + (r0 <= p0 ? 0 : 1)) * D, D, col, acc);
          }
          acc = make_float2(0.f, 0.f);
          start = i + 1;
        }
      }
    }
  }
  // rows with no source, threads over their columns
  const int u0 = blockIdx.x * rows_per, u1 = min(u0 + rows_per, U);
  for (int u = u0; u < u1; ++u) {
    if (rs[u] != rs[u + 1]) continue;
    for (int col = threadIdx.x; col < D; col += blockDim.x) out[(long)u * D + col] = 0.f;
  }
}

// Block b - 1 handles the row that contains position b*seg and starts in
// the reduction block before it: each row that crosses an edge exactly once.
__global__ void __launch_bounds__(kFixWarps * 32)
ss_fixup_kernel(int D, int U, int seg, const int* __restrict__ rs, const int* __restrict__ key,
                const float* __restrict__ partial, float* __restrict__ out) {
  extern __shared__ float wsum[];   // [kFixWarps][D]
  const int n = rs[U];
  const int edge = (blockIdx.x + 1) * seg;
  if (edge >= n) return;
  const int u = key[edge], r0 = rs[u], r1 = rs[u + 1];
  if (!(r0 < edge && r0 >= edge - seg)) return;
  const int j0 = r0 / seg, j1 = (r1 - 1) / seg;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int col = lane; col < D; col += 32) {
    float acc = 0.f;
    for (int j = j0 + w; j <= j1; j += kFixWarps)
      acc += partial[((long)j * 2 + (r0 <= j * seg ? 0 : 1)) * D + col];
    wsum[w * D + col] = acc;
  }
  __syncthreads();
  for (int col = threadIdx.x; col < D; col += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < kFixWarps; ++k) acc += wsum[k * D + col];
    out[(long)u * D + col] = acc;
  }
}

long workspace_ints(long S, int U) {
  return chunks(S, kChunk) * U + (U + 1) + 2 * S;
}

template <typename T>
cudaError_t launch(const int* idx, const T* g, long S, int D, int U, int* ws, float* partial,
                   float* out, cudaStream_t stream) {
  const int seg = seg_of(S);
  const long C = chunks(S, kChunk), J = chunks(S, seg);
  int* cnt = ws;
  int* rs = cnt + C * U;
  int* perm = rs + U + 1;
  int* key = perm + S;
  cudaError_t err = cudaSuccess;
  // with no source there is no chunk to count or place (a grid of 0 blocks
  // is an invalid launch); the scans then give every row an empty range
  if (C > 0) {
    ss_count_kernel<<<(unsigned)C, kChunk, 0, stream>>>(idx, S, U, cnt);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  ss_column_scan_kernel<<<(U + 255) / 256, 256, 0, stream>>>(cnt, C, U, rs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ss_row_scan_kernel<<<1, kScanThreads, 0, stream>>>(rs, U);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (C > 0) {
    ss_place_kernel<<<(unsigned)C, kChunk, 0, stream>>>(idx, S, U, cnt, rs, perm, key);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // at least one block, which writes the empty rows when there is no source
  const long blocks = J > 0 ? J : 1;
  const int threads = ((D + 1) / 2 + 31) / 32 * 32;
  ss_reduce_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      g, D, U, seg, (int)((U + blocks - 1) / blocks), rs, perm, key, partial, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (J > 1) {
    const size_t smem = sizeof(float) * kFixWarps * D;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(ss_fixup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
    }
    ss_fixup_kernel<<<(unsigned)(J - 1), kFixWarps * 32, smem, stream>>>(D, U, seg, rs, key,
                                                                        partial, out);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// int32 scratch that newsrec_segment_scatter needs for S sources and U rows
long newsrec_segment_scatter_ws_ints(long S, int U) { return workspace_ints(S, U); }

// float32 scratch for the partial sums of the rows that cross a block edge
long newsrec_segment_scatter_partial_floats(long S, int D) { return chunks(S, seg_of(S)) * 2 * D; }

// sorted positions per block of the reduction for S sources
int newsrec_segment_scatter_seg(long S) { return seg_of(S); }

// out [U, D] float32 = sum of g [S, D] rows (dtype 0 = float32, 1 =
// bfloat16) by destination idx [S] int32; ws and partial as sized above,
// D <= 1024, U >= 1. All operands contiguous on one device; launches on
// `stream` and returns a cudaError_t code.
int newsrec_segment_scatter(int dtype, const void* idx, const void* g, long S, int D, int U,
                            void* ws, void* partial, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(idx);
  int* w = static_cast<int*>(ws);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (D < 1 || D > 1024 || U < 1 || S < 0) return cudaErrorInvalidValue;
  if (dtype == 0) return launch(i, static_cast<const float*>(g), S, D, U, w, p, o, s);
  if (dtype == 1) return launch(i, static_cast<const __nv_bfloat16*>(g), S, D, U, w, p, o, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
