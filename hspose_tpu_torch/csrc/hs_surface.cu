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
//
// WIN is the forward of the differentiable op, either tier (want_win=True of the same
// TPU kernel, pallas_hs_fused.py:318-330): it also records, per (point,
// support column), the first k that reaches the max of relu(theta) (a strict
// > from -FLT_MAX), for the backward.  The serving instantiations (WIN false)
// are compiled from the same lines as before.
//
// The backward (K9, hs_surface_fused_bwd below) replaces
// hspose_tpu/ops/pallas_hs_fused.py::_surface_bwd_kernel (exact=True, and
// exact=False with fast != 0, the FAST pieces of hs_fused_bwd.cuh): dverts
// and dd from win and the output cotangent, through the shared pieces of
// hs_fused_bwd.cuh.  Plain versions: hspose_tpu_torch/ops/cuda_hs_fused.py::
// hs_surface_fused_fwd_plain and hs_surface_fused_bwd_plain.  What bounds it:
// it reads the (B, N, S*Co) winners and cotangents a few times and does about
// 10 operations per (point, column); the scatter to source rows follows the
// inverse neighbour lists, with no atomics.

#include <cfloat>

#include "hs_fused_bwd.cuh"

namespace {

constexpr int TQ = 16;
constexpr int THREADS = 128;

template <bool FAST, bool WIN>
__global__ void __launch_bounds__(THREADS)
surface_kernel(const float* __restrict__ verts, const int* __restrict__ idx,
               const float* __restrict__ dirs, float* __restrict__ out, int* __restrict__ win,
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
        if constexpr (WIN) {
          float m = -FLT_MAX;
          int kb = 0;
          for (int j = 0; j < K; ++j) {
            const float* r = srf + (t * K + j) * 3;
            const float v = fmaxf(r[0] * d0 + r[1] * d1 + r[2] * d2, 0.f);
            if (v > m) {
              m = v;
              kb = j;
            }
          }
          win[((size_t)b * N + q0 + t) * SC + s * Co + c] = kb;
          total += m;
        } else {
          float m = 0.f;  // every relu term is >= 0, so the max may start at 0
          for (int j = 0; j < K; ++j) {
            const float* r = srf + (t * K + j) * 3;
            m = fmaxf(m, r[0] * d0 + r[1] * d1 + r[2] * d2);
          }
          total += m;
        }
      }
      out[((size_t)b * N + q0 + t) * Co + c] = total / S;
    }
  }
}

template <bool FAST, bool WIN = false>
int launch(const float* verts, const int* idx, const float* dirs, float* out, int* win, int B,
           int N, int K, int S, int Co, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * (size_t)S * Co + (size_t)TQ * K * 3);
  cudaError_t err = hs::allow_smem(surface_kernel<FAST, WIN>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TQ - 1) / TQ, B);
  surface_kernel<FAST, WIN><<<grid, THREADS, smem, stream>>>(verts, idx, dirs, out, win, N, K, S,
                                                             Co);
  return (int)cudaGetLastError();
}

}  // namespace

// verts (B, N, 3), idx (B, N, K) int32, dirs (3, S*Co) -> out (B, N, Co);
// fast != 0 runs the bf16 tier.
extern "C" int hs_surface(const float* verts, const int* idx, const float* dirs, float* out,
                          int B, int N, int K, int S, int Co, int fast, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch<true>(verts, idx, dirs, out, nullptr, B, N, K, S, Co, s)
              : launch<false>(verts, idx, dirs, out, nullptr, B, N, K, S, Co, s);
}

// The forward of the differentiable op: as hs_surface, and win (B, N, S*Co)
// int32, the first k reaching each column's max.
extern "C" int hs_surface_win(const float* verts, const int* idx, const float* dirs, float* out,
                              int* win, int B, int N, int K, int S, int Co, int fast,
                              void* stream) {
  if (hsb::supported(N, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch<true, true>(verts, idx, dirs, out, win, B, N, K, S, Co, s)
              : launch<false, true>(verts, idx, dirs, out, win, B, N, K, S, Co, s);
}

// K9: verts (B, N, 3), idx (B, N, K), dirs (3, S*Co), win (B, N, S*Co), gb (B, N, Co)
// -> dverts (B, N, 3) and red (3, S*Co) = dd; fast != 0 runs the bf16 tier.  Scratch:
// rowptr (B, N + 1), ent (B, N*K) int32; dz (B, N, S*Co), drf (B, N, K, 3), dvq
// (B, N, 3), partial (hs_fused_bwd_parts(B, N), 3, S*Co) fp32.
extern "C" int hs_surface_fused_bwd(const float* verts, const int* idx, const float* dirs,
                                    const int* win, const float* gb, int* rowptr, int* ent,
                                    float* dz, float* drf, float* dvq, float* partial,
                                    float* dverts, float* red, int B, int N, int K, int S, int Co,
                                    int fast, void* stream) {
  if (hsb::supported(N, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(fast ? hsb::fused_bwd<false, true>(verts, idx, dirs, win, gb, nullptr, rowptr, ent,
                                                  dz, nullptr, drf, dvq, partial, red, nullptr,
                                                  dverts, B, N, K, S, Co, s)
                    : hsb::fused_bwd<false, false>(verts, idx, dirs, win, gb, nullptr, rowptr,
                                                   ent, dz, nullptr, drf, dvq, partial, red,
                                                   nullptr, dverts, B, N, K, S, Co, s));
}

// Rows of the fused backwards' dd (and db) partial-sum scratch.
extern "C" int hs_fused_bwd_parts(int B, int N) { return hsb::parts(B, N); }
