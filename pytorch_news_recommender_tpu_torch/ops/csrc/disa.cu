// DiSA's token-pair chain for Hopper (sm_90a), forward and backward: the
// per-dimension directional self-attention of the DiSAN news tower
// (models/disan.py, DiSA.forward), from w1's and w2's products to
// res = sum_j att_ij * rep_j.
//
// Replaces no TPU kernel: the JAX package's DiSA is plain jnp
// (pytorch_news_recommender_tpu/models/disan.py). It was added because the
// plain PyTorch chain makes float32 [M, L, L, d] tensors (the pair sums,
// the logits, the masked fill, the softmax, two dtype copies and att*rep),
// streams each through device memory and keeps them for the backward:
// 96% of a DiSAN training step's device time, 33.5 GB of peak memory.
//
// What it computes, per item m, hidden column c, query row i and key j in
// the pair set P_i = {j : j > i (fw) or j < i (bw), mask[j] > 0}, with the
// plain chain's rounding points (T the compute dtype, float32 or bf16):
//   s_ij   = float(T(dep[j] + head[i])) + b1        (the sum rounds in T)
//   t_ij   = tanhf(s_ij / 5),  logit_ij = 5 t_ij    (accurate tanhf, expf)
//   a_ij   = exp(logit_ij) / sum_{k in P_i} exp(logit_ik)
//   res_i  = T(sum_{j in P_i} float(T(a_ij)) * rep[j])    (f32 sum)
// The logits lie within +-5, so the exponentials need no running maximum;
// the result is the max-subtracted softmax's up to f32 rounding. A row
// with an empty P_i gives 0, as the plain chain's pair-mask product does.
// One documented difference: a pad query row (mask[i] == 0) is written as
// 0, where the plain chain gives it a value that DiSA's output mask then
// zeroes (every gradient through it is 0).
// The backward recomputes each row's a_ij from the inputs (the forward keeps
// no pair value for it) and, from g = dres:
//   drep[j] += T(a_ij) g_i,  dz_ij = a_ij g_i (rep[j] - r_i) with
//   r_i = sum_k a_ik rep[k] (f32, unrounded a), ds_ij = dz_ij (1 - t_ij^2),
//   dhead[i] = sum_j ds_ij,  ddep[j] = sum_i ds_ij,  db1 = sum ds,
// every sum f32 (the plain chain rounds ds to T before its broadcast sums;
// this is finer), the three row gradients rounded to T at the end.
//
// Bound. Per pair value about 10 FP32 operations and 2 transcendentals
// forward (tanh, exp), about twice the operations backward: at the
// training step's real lengths some 410M values a step forward, 0.12 ms on
// the FP32 units and 0.20 ms on the SFUs (PERF.md section 3). The bytes are
// the real rows of dep, head and rep (backward: and g) and the mask read
// once, and every row of res (backward: of the three gradients, and each
// item's db1 partials) written once. At a batch's shapes (a direction, one
// length block) the forward's bytes and SFU floors are both about 0.04-0.05
// ms and the backward's bytes floor about 0.08-0.09 ms, and none grows with
// L^2 as the plain chain's traffic does, since no pair value reaches device
// memory.
//
// Design. One thread per (item, column): block (item m, 64 columns), so the
// loads of a row are 64 neighbouring columns, coalesced, and the last
// column block is ragged. Warp 0 first lists the item's real positions in
// shared memory (ballots), so every loop runs over real pairs only and no
// thread diverges from its warp on the mask. Each thread then keeps its
// column of dep and rep (and, backward, its f32 sums of ddep and drep) in
// shared memory laid out [position][column]: a thread touches only its own
// column, so no barrier follows and no bank conflicts. For each real query
// row it runs two passes over P_i: the first makes t and exp(5t) (kept in
// shared memory for the second) and their sum, the second the products.
// Every sum runs in a fixed order inside one thread, except db1: each block
// writes its item's column partials, which the caller sums over the items
// (a reduction without atomics), so two launches give the same bits.
// Shared memory is (3 forward, 6 backward) x L x 64 x 4 bytes + L ints, so
// L goes up to kMaxL = 128 (197 KB backward).

#include "common.cuh"

namespace {

constexpr int kCols = 64;     // hidden columns of a block (= its threads)
constexpr int kMaxL = 128;    // the longest item the kernels take
constexpr float kScale = 5.0f;  // DiSA's logit scale c

// Warp 0 writes the ascending real positions of the item's mask row to pos
// and their count to *n; the block waits for it.
__device__ __forceinline__ void real_positions(const float* __restrict__ mrow, int L,
                                               int* pos, int* n) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int count = 0;
    for (int base = 0; base < L; base += 32) {
      const int j = base + lane;
      const bool real = j < L && mrow[j] > 0.f;
      const unsigned bits = __ballot_sync(0xffffffffu, real);
      if (real) pos[count + __popc(bits & ((1u << lane) - 1u))] = j;
      count += __popc(bits);
    }
    if (lane == 0) *n = count;
  }
  __syncthreads();
}

// s_ij's logit pieces for one key: t = tanh(s / c) and e = exp(c t)
template <typename T>
__device__ __forceinline__ void pair_logit(float dep_j, float head_i, float bias, float& t,
                                           float& e) {
  const float s = rnd<T>(dep_j + head_i) + bias;
  t = tanhf(s / kScale);
  e = expf(kScale * t);
}

template <typename T, bool kFw>
__global__ void __launch_bounds__(kCols) disa_fwd_kernel(
    const T* __restrict__ dep, const T* __restrict__ head, const T* __restrict__ rep,
    const float* __restrict__ mask, const float* __restrict__ b1, T* __restrict__ res,
    int L, int d) {
  extern __shared__ float smem[];
  float* s_dep = smem;                 // [n][kCols], this thread's column
  float* s_rep = s_dep + L * kCols;
  float* s_e = s_rep + L * kCols;
  int* s_pos = reinterpret_cast<int*>(s_e + L * kCols);
  __shared__ int s_n;
  const long m = blockIdx.x;
  const int tid = threadIdx.x;
  const int c = blockIdx.y * kCols + tid;
  const float* mrow = mask + m * L;
  real_positions(mrow, L, s_pos, &s_n);
  if (c >= d) return;
  const int n = s_n;
  const long row0 = m * L;
  for (int k = 0; k < n; ++k) {
    const long at = (row0 + s_pos[k]) * d + c;
    s_dep[k * kCols + tid] = to_f(dep[at]);
    s_rep[k * kCols + tid] = to_f(rep[at]);
  }
  for (int i = 0; i < L; ++i)
    if (!(mrow[i] > 0.f)) res[(row0 + i) * d + c] = from_f<T>(0.f);
  const float bias = b1[c];
  for (int ki = 0; ki < n; ++ki) {
    const int j0 = kFw ? ki + 1 : 0, j1 = kFw ? n : ki;
    const float h = to_f(head[(row0 + s_pos[ki]) * d + c]);
    float sum = 0.f;
#pragma unroll 4
    for (int kj = j0; kj < j1; ++kj) {
      float t, e;
      pair_logit<T>(s_dep[kj * kCols + tid], h, bias, t, e);
      s_e[kj * kCols + tid] = e;
      sum += e;
    }
    float acc = 0.f;
    if (sum > 0.f) {
#pragma unroll 4
      for (int kj = j0; kj < j1; ++kj)
        acc += rnd<T>(s_e[kj * kCols + tid] / sum) * s_rep[kj * kCols + tid];
    }
    res[(row0 + s_pos[ki]) * d + c] = from_f<T>(acc);
  }
}

template <typename T, bool kFw>
__global__ void __launch_bounds__(kCols) disa_bwd_kernel(
    const T* __restrict__ g, const T* __restrict__ dep, const T* __restrict__ head,
    const T* __restrict__ rep, const float* __restrict__ mask, const float* __restrict__ b1,
    T* __restrict__ ddep, T* __restrict__ dhead, T* __restrict__ drep,
    float* __restrict__ db1_part, int L, int d) {
  extern __shared__ float smem[];
  float* s_dep = smem;                 // [n][kCols], this thread's column
  float* s_rep = s_dep + L * kCols;
  float* s_e = s_rep + L * kCols;
  float* s_t = s_e + L * kCols;
  float* s_ddep = s_t + L * kCols;
  float* s_drep = s_ddep + L * kCols;
  int* s_pos = reinterpret_cast<int*>(s_drep + L * kCols);
  __shared__ int s_n;
  const long m = blockIdx.x;
  const int tid = threadIdx.x;
  const int c = blockIdx.y * kCols + tid;
  const float* mrow = mask + m * L;
  real_positions(mrow, L, s_pos, &s_n);
  if (c >= d) return;
  const int n = s_n;
  const long row0 = m * L;
  for (int k = 0; k < n; ++k) {
    const long at = (row0 + s_pos[k]) * d + c;
    s_dep[k * kCols + tid] = to_f(dep[at]);
    s_rep[k * kCols + tid] = to_f(rep[at]);
    s_ddep[k * kCols + tid] = 0.f;
    s_drep[k * kCols + tid] = 0.f;
  }
  for (int i = 0; i < L; ++i) {
    if (!(mrow[i] > 0.f)) {
      const long at = (row0 + i) * d + c;
      ddep[at] = dhead[at] = drep[at] = from_f<T>(0.f);
    }
  }
  const float bias = b1[c];
  float db = 0.f;
  for (int ki = 0; ki < n; ++ki) {
    const int j0 = kFw ? ki + 1 : 0, j1 = kFw ? n : ki;
    const long at_i = (row0 + s_pos[ki]) * d + c;
    const float h = to_f(head[at_i]);
    const float gi = to_f(g[at_i]);
    float sum = 0.f, er = 0.f;
#pragma unroll 4
    for (int kj = j0; kj < j1; ++kj) {
      float t, e;
      pair_logit<T>(s_dep[kj * kCols + tid], h, bias, t, e);
      s_t[kj * kCols + tid] = t;
      s_e[kj * kCols + tid] = e;
      sum += e;
      er += e * s_rep[kj * kCols + tid];
    }
    float dh = 0.f;
    if (sum > 0.f) {
      const float r = er / sum;
#pragma unroll 4
      for (int kj = j0; kj < j1; ++kj) {
        const int o = kj * kCols + tid;
        const float a = s_e[o] / sum;
        s_drep[o] += rnd<T>(a) * gi;
        const float t = s_t[o];
        const float ds = a * gi * (s_rep[o] - r) * (1.f - t * t);
        dh += ds;
        s_ddep[o] += ds;
      }
    }
    db += dh;
    dhead[at_i] = from_f<T>(dh);
  }
  for (int k = 0; k < n; ++k) {
    const long at = (row0 + s_pos[k]) * d + c;
    ddep[at] = from_f<T>(s_ddep[k * kCols + tid]);
    drep[at] = from_f<T>(s_drep[k * kCols + tid]);
  }
  db1_part[m * d + c] = db;
}

size_t fwd_smem(int L) { return sizeof(float) * 3 * L * kCols + sizeof(int) * L; }
size_t bwd_smem(int L) { return sizeof(float) * 6 * L * kCols + sizeof(int) * L; }

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
cudaError_t launch_fwd(bool fw, const T* dep, const T* head, const T* rep, const float* mask,
                       const float* b1, T* res, long M, int L, int d, cudaStream_t stream) {
  const dim3 grid((unsigned)M, (unsigned)((d + kCols - 1) / kCols));
  const size_t smem = fwd_smem(L);
  auto kernel = fw ? disa_fwd_kernel<T, true> : disa_fwd_kernel<T, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kCols, smem, stream>>>(dep, head, rep, mask, b1, res, L, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(bool fw, const T* g, const T* dep, const T* head, const T* rep,
                       const float* mask, const float* b1, T* ddep, T* dhead, T* drep,
                       float* part, long M, int L, int d, cudaStream_t stream) {
  const dim3 grid((unsigned)M, (unsigned)((d + kCols - 1) / kCols));
  const size_t smem = bwd_smem(L);
  auto kernel = fw ? disa_bwd_kernel<T, true> : disa_bwd_kernel<T, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kCols, smem, stream>>>(g, dep, head, rep, mask, b1, ddep, dhead, drep, part,
                                        L, d);
  return cudaGetLastError();
}

bool shapes_ok(long M, int L, int d) {
  return M >= 1 && M < (1L << 31) && L >= 1 && L <= kMaxL && d >= 1 &&
         (d + kCols - 1) / kCols <= 65535;
}

}  // namespace

extern "C" {

// the longest item (L) the kernels take
int newsrec_disa_max_len() { return kMaxL; }

// res [M, L, d] = DiSA's pair chain over dep, head, rep [M, L, d] (dtype 0 =
// float32, 1 = bfloat16), mask [M, L] float32 and b1 [d] float32, in the
// forward (fw != 0) or backward direction. All operands contiguous on one
// device; launches on `stream` and returns a cudaError_t code.
int newsrec_disa_fwd(int dtype, int fw, const void* dep, const void* head, const void* rep,
                     const void* mask, const void* b1, void* res, long M, int L, int d,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mk = static_cast<const float*>(mask);
  const float* b = static_cast<const float*>(b1);
  if (!shapes_ok(M, L, d)) return cudaErrorInvalidValue;
  if (dtype == 0) {
    using T = float;
    return launch_fwd(fw != 0, static_cast<const T*>(dep), static_cast<const T*>(head),
                      static_cast<const T*>(rep), mk, b, static_cast<T*>(res), M, L, d, s);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return launch_fwd(fw != 0, static_cast<const T*>(dep), static_cast<const T*>(head),
                      static_cast<const T*>(rep), mk, b, static_cast<T*>(res), M, L, d, s);
  }
  return cudaErrorInvalidValue;
}

// The backward from g = dres [M, L, d]: ddep, dhead, drep [M, L, d] in the
// operands' dtype, and part [M, d] float32, each item's column sums of ds
// (db1 is their sum over the items). One launch on `stream`.
int newsrec_disa_bwd(int dtype, int fw, const void* g, const void* dep, const void* head,
                     const void* rep, const void* mask, const void* b1, void* ddep,
                     void* dhead, void* drep, void* part, long M, int L, int d,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mk = static_cast<const float*>(mask);
  const float* b = static_cast<const float*>(b1);
  float* p = static_cast<float*>(part);
  if (!shapes_ok(M, L, d)) return cudaErrorInvalidValue;
  if (dtype == 0) {
    using T = float;
    return launch_bwd(fw != 0, static_cast<const T*>(g), static_cast<const T*>(dep),
                      static_cast<const T*>(head), static_cast<const T*>(rep), mk, b,
                      static_cast<T*>(ddep), static_cast<T*>(dhead), static_cast<T*>(drep), p,
                      M, L, d, s);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return launch_bwd(fw != 0, static_cast<const T*>(g), static_cast<const T*>(dep),
                      static_cast<const T*>(head), static_cast<const T*>(rep), mk, b,
                      static_cast<T*>(ddep), static_cast<T*>(dhead), static_cast<T*>(drep), p,
                      M, L, d, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
