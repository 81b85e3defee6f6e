// Shared pieces of the port's kernels (knn.cu, orl.cu, hs_surface.cu,
// hs_support.cu, hs_surface_train.cu, hs_support_train.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace hs {

// True for the bf16 tier's operand type.
template <typename T>
constexpr bool is_bf16 = std::is_same_v<T, __nv_bfloat16>;

constexpr int SMEM_DEFAULT = 48 * 1024;

// An operand element as fp32, from fp32 or bf16 storage.
__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Store an fp32 value into fp32 storage, or round it (to nearest even) into bf16.
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The value x takes as a bf16 operand (round to nearest even), as fp32.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x / S as the bf16 tier forms it before rounding to bf16 (FAST): XLA turns
// a division by a constant into a product with its reciprocal rounded to
// fp32, so the TPU kernels' gb / S is x * (1 / S), which can differ from a
// true division by one fp32 ulp and so move the rounding.  fp32 divides.
template <bool FAST>
__device__ __forceinline__ float div_s(float x, int S) {
  return FAST ? x * (1.f / S) : x / S;
}

// One entry of stage_rf: the unit direction of neighbour v from centre c, and
// raw = v - c, the rf that the backwards' chain differentiates (FAST: on xyz
// rounded to bf16, unrounded).
template <bool FAST>
__device__ __forceinline__ void unit_rf(const float* v, const float* c, float* raw, float* unit) {
  float r0, r1, r2;
  if constexpr (FAST) {
    r0 = bf16_round(v[0]) - bf16_round(c[0]);
    r1 = bf16_round(v[1]) - bf16_round(c[1]);
    r2 = bf16_round(v[2]) - bf16_round(c[2]);
    raw[0] = r0;
    raw[1] = r1;
    raw[2] = r2;
    const float sq = __fadd_rn(__fadd_rn(__fmul_rn(r0, r0), __fmul_rn(r1, r1)), __fmul_rn(r2, r2));
    const float inv = __fdiv_rn(1.f, fmaxf(__fsqrt_rn(sq), 1e-12f));
    unit[0] = bf16_round(__fmul_rn(r0, inv));
    unit[1] = bf16_round(__fmul_rn(r1, inv));
    unit[2] = bf16_round(__fmul_rn(r2, inv));
  } else {
    r0 = v[0] - c[0];
    r1 = v[1] - c[1];
    r2 = v[2] - c[2];
    raw[0] = r0;
    raw[1] = r1;
    raw[2] = r2;
    const float den = fmaxf(sqrtf(r0 * r0 + r1 * r1 + r2 * r2), 1e-12f);
    unit[0] = r0 / den;
    unit[1] = r1 / den;
    unit[2] = r2 / den;
  }
}

// Stage the unit receptive-field directions of queries q0 .. q0 + tq - 1 into
// shared memory: srf[(t * K + j) * 3 + d] = normalize(v[idx[q, j]] - v[q])[d],
// with the norm clamped at 1e-12 so a duplicated point gives exactly 0
// (hspose_tpu/ops/knn.py::neighbor_directions_normalized).  When sidx is not
// null it also receives the neighbour indices.  Rows past N are zero.  PACK4
// writes four floats per entry instead, srf[e * 4 + 3] holding the bits of the
// neighbour index, so that one 16-byte read returns both.
//
// FAST is the bf16 tier (hspose_tpu/ops/pallas_hs_fused.py, exact=False):
// xyz rounded to bf16 (_xyz_parts), rf = v - c, norm = sqrt((r0^2 + r1^2) +
// r2^2), rfn = rf * (1 / max(norm, 1e-12)) in fp32 (_rf_chain), then rfn
// rounded to bf16 for the one-pass theta (_theta_relu).  A bf16 ulp of rfn
// can move the max over k, so each step is a correctly rounded operation that
// the compiler may not fuse into another (__f*_rn where a product meets a
// sum), in the order of the plain version
// (ops/cuda_hs_fused.py::_rf_fast); centre and neighbour round alike, so a
// duplicated point still gives exactly 0.
//
// The query-sharded form takes the centres from vq (B, NQ, 3) and idx (B, NQ,
// K), the neighbours from the N source rows of verts; the single-source form
// is it with vq = verts and NQ = N.
template <bool FAST = false, bool PACK4 = false>
__device__ inline void stage_rf(const float* __restrict__ verts, const float* __restrict__ vq,
                                const int* __restrict__ idx, float* srf, int* sidx, int b, int q0,
                                int tq, int NQ, int N, int K) {
  for (int e = threadIdx.x; e < tq * K; e += blockDim.x) {
    const int t = e / K, j = e % K, q = q0 + t;
    float raw[3], r[3] = {0.f, 0.f, 0.f};
    int nb = 0;
    if (q < NQ) {
      nb = idx[((size_t)b * NQ + q) * K + j];
      unit_rf<FAST>(verts + ((size_t)b * N + nb) * 3, vq + ((size_t)b * NQ + q) * 3, raw, r);
    }
    if constexpr (PACK4) {
      *reinterpret_cast<float4*>(srf + e * 4) = make_float4(r[0], r[1], r[2], __int_as_float(nb));
    } else {
      srf[e * 3 + 0] = r[0];
      srf[e * 3 + 1] = r[1];
      srf[e * 3 + 2] = r[2];
      if (sidx) sidx[e] = nb;
    }
  }
}

template <bool FAST = false, bool PACK4 = false>
__device__ inline void stage_rf(const float* __restrict__ verts, const int* __restrict__ idx,
                                float* srf, int* sidx, int b, int q0, int tq, int N, int K) {
  stage_rf<FAST, PACK4>(verts, verts, idx, srf, sidx, b, q0, tq, N, N, K);
}

// Copy the (3, n) direction matrix into shared memory; FAST rounds each
// direction to bf16 (_w_parts).  With bf16 rfn and directions every product
// of theta = r0 d0 + r1 d1 + r2 d2 is exact in fp32, so the compiler's fused
// multiply-adds give the same sums as the plain version's ordered adds.
template <bool FAST>
__device__ inline void stage_dirs(const float* __restrict__ dirs, float* sd, int n) {
  for (int e = threadIdx.x; e < 3 * n; e += blockDim.x) sd[e] = FAST ? bf16_round(dirs[e]) : dirs[e];
}

// Asynchronous 16-byte copy from device to shared memory (cp.async, L2 only);
// !valid fills the 16 bytes with zeros and reads nothing.  Groups of copies
// are closed by cp_async_commit; cp_async_wait<n> waits until at most n of
// this thread's groups are in flight (a __syncthreads must follow before
// other threads read the data).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
// The same for 4 bytes (cp.async.ca: through L1), for rows staged at a
// stride that is no multiple of 16 bytes.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// True when p lies on a 16-byte boundary (cp.async and float4 access).
__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// Two adjacent bf16 values as one 32-bit word (an mma.sync operand register).
__device__ __forceinline__ unsigned ld_b32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// c (4 fp32) += a (16 x 16 bf16, row-major) b (16 x 8 bf16, column-major) on the
// tensor cores: products exact, sums in fp32.  Fragments as PTX's
// mma.m16n8k16 lays them out: with g = lane / 4, t = lane % 4, a holds rows
// g and g + 8 at columns 2t, 2t + 1 and 2t + 8, 2t + 9; b holds column g at
// rows 2t, 2t + 1 and 2t + 8, 2t + 9; c holds rows g, g + 8 at columns 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16_16816(float* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Allow a kernel more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= (size_t)SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Second pass of a deterministic reduction: out[e] = sum over p of
// partial[p, e], added in the order of p.  The backward kernels write one
// row of partial sums per block instead of adding into out with atomics.
static __global__ void sum_partials_kernel(const float* __restrict__ partial,
                                           float* __restrict__ out, int parts, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += partial[(size_t)p * E + e];
  out[e] = s;
}

static inline cudaError_t sum_partials(const float* partial, float* out, int parts, int E,
                                cudaStream_t stream) {
  sum_partials_kernel<<<(E + 255) / 256, 256, 0, stream>>>(partial, out, parts, E);
  return cudaGetLastError();
}

// The same sum, staged: out[e] = the sum of partial[p, e] over p in
// increasing order, from 0.f.  A block per SUM_COLS columns: the threads
// stage SUM_ROWS rows of those columns with coalesced loads (the next
// round's loads issued before the current round is summed), one warp's
// first SUM_COLS lanes chain through them, so the rows are read at L2 rate
// instead of by one dependent load a row.  K15's and K9's partial sums.
constexpr int SUM_COLS = 16;
constexpr int SUM_ROWS = 256;  // rows staged per round
constexpr int SUM_THREADS = 256;
constexpr int SUM_LOADS = SUM_ROWS * SUM_COLS / SUM_THREADS;

static __global__ void __launch_bounds__(SUM_THREADS)
sum_tiles_kernel(const float* __restrict__ partial, float* __restrict__ out, int parts, int E) {
  __shared__ float rows[SUM_ROWS * SUM_COLS];
  const int e0 = blockIdx.x * SUM_COLS;
  float v[SUM_LOADS];
  auto fetch = [&](int p0) {
#pragma unroll
    for (int i = 0; i < SUM_LOADS; ++i) {
      const int f = threadIdx.x + i * SUM_THREADS;
      const int p = min(p0 + f / SUM_COLS, parts - 1), e = min(e0 + f % SUM_COLS, E - 1);
      v[i] = partial[(size_t)p * E + e];
    }
  };
  fetch(0);
  float s = 0.f;
  for (int p0 = 0; p0 < parts; p0 += SUM_ROWS) {
    __syncthreads();  // the previous round is summed
#pragma unroll
    for (int i = 0; i < SUM_LOADS; ++i) rows[threadIdx.x + i * SUM_THREADS] = v[i];
    __syncthreads();
    if (p0 + SUM_ROWS < parts) fetch(p0 + SUM_ROWS);
    if (threadIdx.x < SUM_COLS) {
      const int n = min(SUM_ROWS, parts - p0);
#pragma unroll 8
      for (int p = 0; p < n; ++p) s += rows[p * SUM_COLS + threadIdx.x];
    }
  }
  if (threadIdx.x < SUM_COLS && e0 + threadIdx.x < E) out[e0 + threadIdx.x] = s;
}

static inline cudaError_t sum_tiles(const float* partial, float* out, int parts, int E,
                                    cudaStream_t stream) {
  sum_tiles_kernel<<<(E + SUM_COLS - 1) / SUM_COLS, SUM_THREADS, 0, stream>>>(partial, out, parts,
                                                                              E);
  return cudaGetLastError();
}

}  // namespace hs
