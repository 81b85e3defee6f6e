// HS surface reduction (conv_0): out = mean_s max_k relu(normalize(v[idx] - v) . dir_s).
//
// Replaces: hspose_tpu/ops/pallas_hs_fused.py::_surface_fwd_kernel, reached
// through hs_surface_fused.  Plain version: hspose_tpu_torch/ops/
// cuda_hs_fused.py::hs_surface_plain.
//
// What bounds it on an H100: at conv_0 (B=24, N=1028, K=20, S=7, Co=128) it
// does about 1.3e9 multiply-adds and reads only the (B, N, 3) points and the
// (B, N, K) indices; the (B, N, K, Co) theta tensor that the plain version
// writes per support (253 MB) never exists.  The limit is issue rate on shared memory and FMA.
//
// Design: one block per (batch, 16-query tile), 128 threads.  The block stages
// the normalised directions of its 16 x K neighbours and the (3, S*Co)
// support directions in shared memory; each thread owns output channels,
// holds one support's direction in registers while it runs the max over k,
// and sums the supports in order.  The Pallas one-hot MXU gather is a plain
// indexed load here.
//
// FAST is the bf16 tier (exact=False of the same TPU kernel): the staged
// directions and rf rows are rounded as hs_common.cuh says, the rest is
// unchanged; accumulation and output stay fp32.

#include "hs_common.cuh"

namespace {

constexpr int TQ = 16;
constexpr int THREADS = 128;

template <bool FAST>
__global__ void __launch_bounds__(THREADS)
surface_kernel(const float* __restrict__ verts, const int* __restrict__ idx,
               const float* __restrict__ dirs, float* __restrict__ out,
               int N, int K, int S, int Co) {
  extern __shared__ float smem[];
  const int SC = S * Co;
  float* sd = smem;           // (3, S*Co)
  float* srf = smem + 3 * SC;  // (TQ, K, 3)
  const int b = blockIdx.y, q0 = blockIdx.x * TQ;

  hs::stage_dirs<FAST>(dirs, sd, SC);
  hs::stage_rf<FAST>(verts, idx, srf, nullptr, b, q0, TQ, N, K);
  __syncthreads();

  const int tq = min(TQ, N - q0);
  for (int c = threadIdx.x; c < Co; c += blockDim.x) {
    for (int t = 0; t < tq; ++t) {
      float total = 0.f;
      for (int s = 0; s < S; ++s) {
        const float d0 = sd[s * Co + c], d1 = sd[SC + s * Co + c], d2 = sd[2 * SC + s * Co + c];
        float m = 0.f;  // every relu term is >= 0, so the max may start at 0
        for (int j = 0; j < K; ++j) {
          const float* r = srf + (t * K + j) * 3;
          m = fmaxf(m, r[0] * d0 + r[1] * d1 + r[2] * d2);
        }
        total += m;
      }
      out[((size_t)b * N + q0 + t) * Co + c] = total / S;
    }
  }
}

template <bool FAST>
int launch(const float* verts, const int* idx, const float* dirs, float* out, int B, int N,
           int K, int S, int Co, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * (size_t)S * Co + (size_t)TQ * K * 3);
  cudaError_t err = hs::allow_smem(surface_kernel<FAST>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TQ - 1) / TQ, B);
  surface_kernel<FAST><<<grid, THREADS, smem, stream>>>(verts, idx, dirs, out, N, K, S, Co);
  return (int)cudaGetLastError();
}

}  // namespace

// verts (B, N, 3), idx (B, N, K) int32, dirs (3, S*Co) -> out (B, N, Co);
// fast != 0 runs the bf16 tier.
extern "C" int hs_surface(const float* verts, const int* idx, const float* dirs, float* out,
                          int B, int N, int K, int S, int Co, int fast, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch<true>(verts, idx, dirs, out, B, N, K, S, Co, s)
              : launch<false>(verts, idx, dirs, out, B, N, K, S, Co, s);
}
