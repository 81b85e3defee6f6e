// ORL global branch: out (B, 1, C) = mean_n max_k feat[idx[n, k]].
//
// Replaces: hspose_tpu/ops/pallas_hs_fused.py::_orl_fwd_kernel, reached through
// orl_global_fused.  Plain version: hspose_tpu_torch/ops/cuda_hs_fused.py::
// orl_global_plain.
//
// What bounds it on an H100: it reads K rows of C floats per point (at conv_1,
// B=24: 24*1028*20*128*4 B = 253 MB, mostly from L2) and does no arithmetic
// beyond max and add.  The plain version writes and rereads the whole
// (B, N, K, C) gather; here only a (B, tiles, C) partial sum reaches memory.
//
// Design: a first launch, one block per (batch, 32-point tile), threads over
// channels: each thread takes the max over k of its channel for each point of
// the tile, with coalesced row loads, and adds the maxima in point order into
// partial[b, tile, c].  A second small launch sums the tiles in order and
// divides by N.  Both sums have a fixed order, with no atomics, so the result
// is the same from run to run.

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int TQ = 32;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
orl_partial_kernel(const float* __restrict__ feat, const int* __restrict__ idx,
                   float* __restrict__ partial, int N, int K, int C) {
  extern __shared__ int sidx[];  // (TQ, K)
  const int b = blockIdx.y, tile = blockIdx.x, q0 = tile * TQ;
  const int tq = min(TQ, N - q0);
  for (int e = threadIdx.x; e < tq * K; e += blockDim.x)
    sidx[e] = idx[((size_t)b * N + q0) * K + e];
  __syncthreads();

  const float* Fb = feat + (size_t)b * N * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float sum = 0.f;
    for (int t = 0; t < tq; ++t) {
      float m = -FLT_MAX;
      for (int j = 0; j < K; ++j) m = fmaxf(m, Fb[(size_t)sidx[t * K + j] * C + c]);
      sum += m;
    }
    partial[((size_t)b * gridDim.x + tile) * C + c] = sum;
  }
}

__global__ void __launch_bounds__(THREADS)
orl_finish_kernel(const float* __restrict__ partial, float* __restrict__ out, int tiles,
                  int N, int C) {
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float sum = 0.f;
    for (int t = 0; t < tiles; ++t) sum += partial[((size_t)b * tiles + t) * C + c];
    out[(size_t)b * C + c] = sum / N;
  }
}

}  // namespace

// Tiles of the first launch: the partial-sum scratch is (B, hs_orl_tiles(N), C).
extern "C" int hs_orl_tiles(int N) { return (N + TQ - 1) / TQ; }

// feat (B, N, C), idx (B, N, K) int32, partial (B, hs_orl_tiles(N), C) scratch -> out (B, 1, C).
extern "C" int hs_orl(const float* feat, const int* idx, float* partial, float* out, int B,
                      int N, int K, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = hs_orl_tiles(N);
  const size_t smem = sizeof(int) * (size_t)TQ * K;
  orl_partial_kernel<<<dim3(tiles, B), THREADS, smem, s>>>(feat, idx, partial, N, K, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  orl_finish_kernel<<<B, THREADS, 0, s>>>(partial, out, tiles, N, C);
  return (int)cudaGetLastError();
}
