// HS surface reduction (conv_0): out = mean_s max_k relu(normalize(v[idx] - v) . dir_s).
//
// Replaces: hspose_tpu/ops/pallas_hs_fused.py::_surface_fwd_kernel, reached
// through hs_surface_fused.  Plain version: hspose_tpu_torch/ops/
// cuda_hs_fused.py::hs_surface_plain.
//
// What bounds it on an H100: at conv_0 (B=24, N=1028, K=20, S=7, Co=128) it
// does about 1.3e9 multiply-adds and reads only the (B, N, 3) points and the
// (B, N, K) indices; the (B, N, K, Co) theta tensor that the plain version
// writes per support (253 MB) never exists.  Per (query, k, channel, support)
// theta is three fp32 operations and the max a fourth, so the limit is the
// rate at which the SMs issue them (0.040 ms of fp32 peak counts only the
// multiply-adds).  The kernel this one replaced paid a shared-memory load
// per multiply-add: it reloaded the rf row for every support and the
// support's directions for every query.
//
// Design: one block per (batch, TQ-query tile), 128 threads.  The block
// stages the unit rf rows of its TQ x K neighbours with their index as one
// float4 each (hs::stage_rf, PACK4), then runs the reduction body it shares
// with the training path's forward K12 (hs_surface.cuh): each thread holds
// one output channel's 3 x S directions in registers and reads each
// neighbour's rf row once per query, updating S running maxima; the
// replaced kernel reloaded the rf row for every support and the support's
// directions for every query.  The Pallas one-hot MXU gather is a plain
// indexed load here.
//
// FAST is the bf16 tier (exact=False of the same TPU kernel): the staged rf
// rows and the directions are rounded as hs_common.cuh says, the rest is
// unchanged; every product is then exact, accumulation and output stay fp32.
//
// WIN is the forward of the differentiable op, either tier (want_win=True of
// the same TPU kernel, pallas_hs_fused.py:318-330): it also records, per
// (point, support column), the first k that reaches the max of relu(theta),
// for the backward (hs_surface.cuh says how).  The serving instantiations
// (WIN false) are compiled from the same lines.
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

#include "hs_fused_bwd.cuh"
#include "hs_surface.cuh"

namespace {

constexpr int TQ = 32;  // queries per block
constexpr int THREADS = 128;

// One block per (query tile, batch): the block stages its queries' unit rf
// rows, then hs_surface.cuh's body reduces them.  KT = K and ST = S unrolled
// (0: read at run time).
template <bool FAST, bool WIN, int KT, int ST>
__global__ void __launch_bounds__(THREADS)
surface_kernel(const float* __restrict__ verts, const int* __restrict__ idx,
               const float* __restrict__ dirs, float* __restrict__ out, int* __restrict__ win,
               int N, int K_arg, int S_arg, int Co) {
  extern __shared__ __align__(16) float4 srf[];  // (TQ, K): unit rf, index bits
  const int K = KT ? KT : K_arg;
  const int b = blockIdx.y, q0 = blockIdx.x * TQ;
  hs::stage_rf<FAST, true>(verts, idx, reinterpret_cast<float*>(srf), nullptr, b, q0, TQ, N, K);
  __syncthreads();
  hss::reduce_rows<FAST, WIN, KT, ST, THREADS>(srf, dirs, out, win, (size_t)b * N + q0,
                                               min(TQ, N - q0), K, S_arg, Co);
}

template <bool FAST, bool WIN, int KT, int ST>
int launch_k(const float* verts, const int* idx, const float* dirs, float* out, int* win, int B,
             int N, int K, int S, int Co, cudaStream_t stream) {
  auto kernel = surface_kernel<FAST, WIN, KT, ST>;
  const size_t smem = sizeof(float4) * (size_t)TQ * K;
  cudaError_t err = hs::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((N + TQ - 1) / TQ, B), THREADS, smem, stream>>>(verts, idx, dirs, out, win, N, K,
                                                                S, Co);
  return (int)cudaGetLastError();
}

template <bool FAST, bool WIN = false>
int launch(const float* verts, const int* idx, const float* dirs, float* out, int* win, int B,
           int N, int K, int S, int Co, cudaStream_t stream) {
  if (K == 20 && S == 7)  // the model's conv_0
    return launch_k<FAST, WIN, 20, 7>(verts, idx, dirs, out, win, B, N, K, S, Co, stream);
  return launch_k<FAST, WIN, 0, 0>(verts, idx, dirs, out, win, B, N, K, S, Co, stream);
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
