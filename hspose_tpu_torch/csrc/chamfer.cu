// Chamfer distance between two clouds: the nearest-point search in one
// direction, with or without its argmin, and the gradient for one cloud.
//
// Replaces hspose_tpu/ops/chamfer.py:
// * _chamfer_kernel (:85; K16): per point of a, min over b of
//   |a|^2 + |b|^2 - 2 a.b -> chamfer_min_kernel<false>;
// * _chamfer_fwd_idx_kernel (:167; K17): the same minimum and its argmin,
//   ties to the lowest index -> chamfer_min_kernel<true>;
// * _chamfer_bwd_kernel (:216; K18): ga_i = 2 (a_i - b_{ia_i}) gda_i
//   + 2 sum_{j: ib_j = i} gdb_j (a_i - b_j) -> chamfer_grad_kernel.
// Semantics are those of the plain versions in hspose_tpu_torch/ops/chamfer.py
// (chamfer_min, chamfer_min_argmin, chamfer_grad).
//
// What bounds them on an H100: at the recon tier's shape, (24, 1028) x (24,
// 1028), the search is 25 M point pairs per direction at 3 fp32 multiply-adds
// each, a few microseconds at the card's fp32 rate, and the clouds (300 KB)
// stay in L2.  Nothing of the N x M distance matrix is stored.  The gradient
// reads each cloud and its argmins once.
//
// Design.  The search: one block per (batch, 64 queries), four adjacent
// lanes per query.  Tiles of 512 source points stream through shared memory
// as (x, y, z, |b|^2); each lane scans every fourth point of the tile in
// increasing index order with a strict '<', so it keeps the lowest index of
// its minimum, and the four lanes merge by warp shuffles, taking the smaller
// distance or, on a tie, the lower index: the result is the first minimum
// over the whole cloud, as argmin gives it.  The distance is formed as
// ops/knn.py::pairwise_sq_dist forms it, |a|^2 + |b|^2 - 2 a.b in fp32, and
// its small negative values at coincident points are kept.  The gradient: no
// atomics.  The inverse lists of ib (the points of b whose nearest point in
// a is a_i, in increasing j) come from hs_fused_bwd.cuh's counting sort, and
// one thread per point of a adds its list's terms in that order onto the
// direct term, each product rounded before its add as index_add_ adds
// (__fmul_rn, __fadd_rn), so the result repeats bit for bit.

#include <cmath>

#include "hs_fused_bwd.cuh"

namespace {

constexpr int TQ = 64;                // queries per block
constexpr int LANES = 4;              // adjacent lanes per query
constexpr int THREADS = TQ * LANES;   // 256
constexpr int TS = 512;               // source points per shared-memory tile
constexpr int GRAD_THREADS = 128;

template <bool WANT_IDX>
__global__ void __launch_bounds__(THREADS)
chamfer_min_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ dist, int* __restrict__ arg, int N, int M) {
  __shared__ float4 sb[TS];  // x, y, z, |b|^2
  const int bi = blockIdx.y;
  const int lane = threadIdx.x % LANES;
  const int q = blockIdx.x * TQ + threadIdx.x / LANES;
  const bool valid = q < N;
  const float* ap = a + ((size_t)bi * N + (valid ? q : 0)) * 3;
  const float ax = ap[0], ay = ap[1], az = ap[2];
  const float asq = ax * ax + ay * ay + az * az;
  const float* bb = b + (size_t)bi * M * 3;

  float best = INFINITY;
  int best_i = 0;
  for (int s0 = 0; s0 < M; s0 += TS) {
    const int ts = min(TS, M - s0);
    __syncthreads();  // the previous tile's reads are done
    for (int j = threadIdx.x; j < ts; j += THREADS) {
      const float* p = bb + (size_t)(s0 + j) * 3;
      const float x = p[0], y = p[1], z = p[2];
      sb[j] = make_float4(x, y, z, x * x + y * y + z * z);
    }
    __syncthreads();
    for (int j = lane; j < ts; j += LANES) {
      const float4 p = sb[j];
      const float d = asq + p.w - 2.f * (ax * p.x + ay * p.y + az * p.z);
      if (d < best) {
        best = d;
        best_i = s0 + j;
      }
    }
  }
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (od < best || (od == best && oi < best_i)) {
      best = od;
      best_i = oi;
    }
  }
  if (valid && lane == 0) {
    dist[(size_t)bi * N + q] = best;
    if (WANT_IDX) arg[(size_t)bi * N + q] = best_i;
  }
}

// ga (B, N, 3); rowptr (B, N + 1) / ent (B, M) the inverse lists of ib.
__global__ void __launch_bounds__(GRAD_THREADS)
chamfer_grad_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const int* __restrict__ ia, const int* __restrict__ rowptr,
                    const int* __restrict__ ent, const float* __restrict__ gda,
                    const float* __restrict__ gdb, float* __restrict__ ga, int N, int M) {
  const int bi = blockIdx.y;
  const int i = blockIdx.x * GRAD_THREADS + threadIdx.x;
  if (i >= N) return;
  const size_t row = (size_t)bi * N + i;
  const float* ap = a + row * 3;
  const float* bp = b + ((size_t)bi * M + ia[row]) * 3;
  const float g = gda[row];
  float acc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) acc[c] = __fmul_rn(2.f * __fsub_rn(ap[c], bp[c]), g);
  const int* rp = rowptr + (size_t)bi * (N + 1);
  const int* eb = ent + (size_t)bi * M;
  for (int e = rp[i]; e < rp[i + 1]; ++e) {
    const int j = eb[e];
    const float* bj = b + ((size_t)bi * M + j) * 3;
    const float gj = gdb[(size_t)bi * M + j];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      acc[c] = __fadd_rn(acc[c], -__fmul_rn(2.f * __fsub_rn(bj[c], ap[c]), gj));
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) ga[row * 3 + c] = acc[c];
}

template <bool WANT_IDX>
int launch_min(const float* a, const float* b, float* dist, int* arg, int B, int N, int M,
               void* stream) {
  if (B < 1 || N < 1 || M < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + TQ - 1) / TQ, B);
  chamfer_min_kernel<WANT_IDX><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, dist, arg, N, M);
  return (int)cudaGetLastError();
}

}  // namespace

// K16: a (B, N, 3), b (B, M, 3) fp32 -> dist (B, N) fp32.
extern "C" int hs_chamfer_min(const float* a, const float* b, float* dist, int B, int N, int M,
                              void* stream) {
  return launch_min<false>(a, b, dist, nullptr, B, N, M, stream);
}

// K17: as hs_chamfer_min, and arg (B, N) int32, the first index of the minimum.
extern "C" int hs_chamfer_min_argmin(const float* a, const float* b, float* dist, int* arg,
                                     int B, int N, int M, void* stream) {
  return launch_min<true>(a, b, dist, arg, B, N, M, stream);
}

// K18: a (B, N, 3), b (B, M, 3), ia (B, N) in [0, M), ib (B, M) in [0, N),
// gda (B, N), gdb (B, M) -> ga (B, N, 3).  Scratch: rowptr (B, N + 1), ent (B, M).
extern "C" int hs_chamfer_grad(const float* a, const float* b, const int* ia, const int* ib,
                               const float* gda, const float* gdb, int* rowptr, int* ent,
                               float* ga, int B, int N, int M, void* stream) {
  if (B < 1 || N < 1 || M < 1 || B > 65535 || (size_t)N * sizeof(int) > 200 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = hsb::inverse_index(ib, rowptr, ent, B, N, M, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + GRAD_THREADS - 1) / GRAD_THREADS, B);
  chamfer_grad_kernel<<<grid, GRAD_THREADS, 0, s>>>(a, b, ia, rowptr, ent, gda, gdb, ga, N, M);
  return (int)cudaGetLastError();
}
