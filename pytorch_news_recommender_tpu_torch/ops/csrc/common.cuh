// Helpers shared by the fused encoder's forward (fused_encoder.cu),
// backward (fused_encoder_bwd.cu) and stage ablation (ablate_encoder.cu)
// kernels: type conversion at the TPU kernel's rounding points, warp
// reductions, the tensor-core primitives (cp.async, the high/low bf16
// split, mma.sync m16n8k16 and its ldmatrix fragment loads; tiles.cuh
// builds the tile product on them), Hopper's bulk copies on an mbarrier and
// its warpgroup MMA (wgmma) with A in registers, and the dropout hash.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// two adjacent values (8-byte aligned for f32, 4-byte for bf16) in one store
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// v rounded to T and widened back to f32
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
// the same over the G lanes (a power of two up to 32) of an aligned group
__device__ __forceinline__ float group_sum(float v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float group_max(float v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---- tensor-core pieces (mma.sync m16n8k16, bf16 operands, f32 sums) ----

// `bytes` (16, 8 or 4) from global to shared memory, asynchronously, of
// which only the first src_bytes (0 .. bytes) are read and the rest
// zero-filled; src_bytes 0 reads nothing
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x0, x1 -> bf16x2 high parts (toward zero) and low parts (x - high,
// rounded); x0 in the lower half, as the MMA fragments take them. hi + lo
// keeps some 16 bits of each value: the products of high and low parts
// summed in f32 give f32 accuracy to about 2^-16.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, unsigned& hi, unsigned& lo) {
  asm("cvt.rz.bf16x2.f32 %0, %1, %2;\n" : "=r"(hi) : "f"(x1), "f"(x0));
  const float h0 = __uint_as_float(hi << 16), h1 = __uint_as_float(hi & 0xffff0000u);
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(lo) : "f"(x1 - h1), "f"(x0 - h0));
}

// c += a b over one m16n8k16 tile: a four bf16x2 registers (rows g, g+8 x
// k 2t, 2t+8), b two (k 2t, 2t+8 x column g), c four f32 (rows g, g+8 x
// columns 2t, 2t+1), with g = lane / 4, t = lane % 4
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. The plain load hands thread (g, t) the values
// (row g, columns 2t, 2t+1); the transposed one (rows 2t, 2t+1, column g).
__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The A fragment of rows m0 .. m0+15, columns k .. k+15 of a row-major bf16
// tile (row stride ld elements, rows 16-byte aligned)
__device__ __forceinline__ void frag_a(unsigned* a, const __nv_bfloat16* s, int ld, int m0,
                                       int k) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, s + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + k + (lane >> 4) * 8);
}
// the same from a tile stored transposed: A[m][k] = s[k][m]
__device__ __forceinline__ void frag_a_t(unsigned* a, const __nv_bfloat16* s, int ld, int m0,
                                         int k) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(a, s + (k + (lane & 7) + (lane >> 4) * 8) * ld + m0 + ((lane >> 3) & 1) * 8);
}
// The B fragments of two n8 tiles, columns n0 .. n0+15, depth k .. k+15:
// b[0] for columns n0 .., b[1] for n0+8 ... frag_b reads B stored by rows
// (s[k][n], ldmatrix.trans), frag_b_t B stored by columns (s[n][k]).
__device__ __forceinline__ void frag_b(unsigned (*b)[2], const __nv_bfloat16* s, int ld, int n0,
                                       int k) {
  const int lane = threadIdx.x & 31;
  unsigned r[4];
  ldmatrix_x4_trans(r, s + (k + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
  b[0][0] = r[0]; b[0][1] = r[1]; b[1][0] = r[2]; b[1][1] = r[3];
}
__device__ __forceinline__ void frag_b_t(unsigned (*b)[2], const __nv_bfloat16* s, int ld,
                                         int n0, int k) {
  const int lane = threadIdx.x & 31;
  unsigned r[4];
  ldmatrix_x4(r, s + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k + ((lane >> 3) & 1) * 8);
  b[0][0] = r[0]; b[0][1] = r[1]; b[1][0] = r[2]; b[1][1] = r[3];
}

// ---- Hopper pieces: bulk copies on an mbarrier, and wgmma ----

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// The mbarrier at `bar` (8 bytes of shared memory) for `count` arrivals
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_inval(unsigned long long* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// the barrier inits visible to the other threads and to the async proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// orders this thread's earlier generic-proxy accesses of shared memory
// before later async-proxy ones (bulk copies, wgmma operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// one arrival that also expects `bytes` of transfers on the barrier
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global
// to shared memory by the copy engine, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of v across a wgmma fence or wait
__device__ __forceinline__ void reg_fence(float& v) { asm volatile("" : "+f"(v)::"memory"); }

// The shared-memory descriptor of a K-major bf16 B operand without swizzle
// whose 8 x 8 core matrices (8 columns of the product, each 8 deep, 128
// contiguous bytes) lie 128 bytes apart along k and 1,024 bytes apart
// along n: a 64-deep staged weight tile as tiles.cuh lays it out.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32);
}

// d (+)= a b over m64nNk16 on the warpgroup: a in registers, each warp's 16
// rows as mma_bf16's A fragment (rows 16 w .. 16 w + 15 for warp w of the
// warpgroup), b from shared memory through `desc`; d per warp is N / 8
// m16n8 C fragments side by side (d[4j .. 4j + 3] for columns 8j ..);
// acc 0 overwrites d. Asynchronous: wgmma_commit, then wgmma_wait.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float* d, const unsigned* a, uint64_t desc, int acc);
template <>
__device__ __forceinline__ void wgmma_bf16<32>(float* d, const unsigned* a, uint64_t desc,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<48>(float* d, const unsigned* a, uint64_t desc,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<80>(float* d, const unsigned* a, uint64_t desc,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// v as a bf16 high part and, where the operand is split, a low part
__device__ __forceinline__ void split_bf16(float v, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  unsigned h, l;
  split_bf16x2(v, 0.f, h, l);
  hi = __ushort_as_bfloat16((unsigned short)(h & 0xffffu));
  lo = __ushort_as_bfloat16((unsigned short)(l & 0xffffu));
}

// Dropout keep bit of token row `grow` (over all items) and column `col`:
// the murmur3 finalizer of the JAX package's interpret-mode mask
// (_interp_dropout_bits), keyed on (seed + block, row within the block,
// col) with blocks of `block_rows` token rows, so forward and backward
// regenerate the same mask and it equals host_dropout_keep bit for bit.
// uint32 arithmetic wraps as the hash needs.
__device__ __forceinline__ bool dropout_keep(unsigned seed, int block_rows, long grow, int col,
                                             unsigned threshold) {
  const unsigned blk = (unsigned)(grow / block_rows), row = (unsigned)(grow % block_rows);
  unsigned v = (row * 0x9E3779B1u) ^ ((unsigned)col * 0x85EBCA77u) ^ ((seed + blk) * 0xC2B2AE3Du);
  v ^= v >> 16;
  v *= 0x85EBCA6Bu;
  v ^= v >> 13;
  v *= 0xC2B2AE35u;
  v ^= v >> 16;
  return v >= threshold;
}

// Inverted dropout of one projected value: kept values scaled by
// keep_scale = 1 / (1 - rate), dropped ones 0; rate 0 passes v through.
__device__ __forceinline__ float dropout(float v, unsigned seed, int block_rows, long grow,
                                         int col, unsigned threshold, float keep_scale) {
  if (threshold == 0u && keep_scale == 1.f) return v;
  return dropout_keep(seed, block_rows, grow, col, threshold) ? v * keep_scale : 0.f;
}

}  // namespace
