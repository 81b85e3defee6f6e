// Shared pieces of the HS kernels (hs_surface.cu, hs_support.cu,
// hs_surface_train.cu, hs_support_train.cu).
#pragma once

#include <cuda_runtime.h>

namespace hs {

constexpr int SMEM_DEFAULT = 48 * 1024;

// Stage the unit receptive-field directions of queries q0 .. q0 + tq - 1 into
// shared memory: srf[(t * K + j) * 3 + d] = normalize(v[idx[q, j]] - v[q])[d],
// with the norm clamped at 1e-12 so a duplicated point gives exactly 0
// (hspose_tpu/ops/knn.py::neighbor_directions_normalized).  When sidx is not
// null it also receives the neighbour indices.  Rows past N are zero.
__device__ inline void stage_rf(const float* __restrict__ verts, const int* __restrict__ idx,
                                float* srf, int* sidx, int b, int q0, int tq, int N, int K) {
  for (int e = threadIdx.x; e < tq * K; e += blockDim.x) {
    const int t = e / K, j = e % K, q = q0 + t;
    float r0 = 0.f, r1 = 0.f, r2 = 0.f;
    int nb = 0;
    if (q < N) {
      nb = idx[((size_t)b * N + q) * K + j];
      const float* c = verts + ((size_t)b * N + q) * 3;
      const float* v = verts + ((size_t)b * N + nb) * 3;
      r0 = v[0] - c[0];
      r1 = v[1] - c[1];
      r2 = v[2] - c[2];
      const float den = fmaxf(sqrtf(r0 * r0 + r1 * r1 + r2 * r2), 1e-12f);
      r0 /= den;
      r1 /= den;
      r2 /= den;
    }
    srf[e * 3 + 0] = r0;
    srf[e * 3 + 1] = r1;
    srf[e * 3 + 2] = r2;
    if (sidx) sidx[e] = nb;
  }
}

// Copy the (3, n) direction matrix into shared memory.
__device__ inline void stage_dirs(const float* __restrict__ dirs, float* sd, int n) {
  for (int e = threadIdx.x; e < 3 * n; e += blockDim.x) sd[e] = dirs[e];
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

}  // namespace hs
