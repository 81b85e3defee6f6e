// HS surface reduction of the training path (conv_0): forward with winners,
// and its backward.
//   out (B, N, Co)   = mean_s max_k relu(rf[b, n, k] . dir_s)
//   win (B, N, S*Co) = the first k that reaches that max
//   drf (B, N, K, 3) = sum_sc [k == win][theta_win > 0] gb/S * dir_sc
//   dd  (3, S*Co)    = sum_{b, n} [theta_win > 0] gb/S * rf[b, n, win]
//
// Replaces: hspose_tpu/ops/pallas_hs.py::_surface_kernel with want_win (K12)
// and ::_surface_bwd_kernel (K15), reached through hs_surface_reduce.  Plain
// versions: hspose_tpu_torch/ops/cuda_hs.py::hs_surface_fwd_plain and
// hs_surface_bwd_plain.
//
// What bounds it on an H100: at conv_0 (B=16, N=1028, K=20, S=7, Co=128) the
// forward does about 9e8 multiply-adds and writes the (B, N, S*Co) int32
// winners (59 MB), which is what limits it; the plain version writes a
// (B, N, K, Co) theta tensor per support instead.  The backward reads the
// winners once and does about 3e8 compares to route them.
//
// Design.  Forward: one block per (batch, 16-query tile), threads over output
// channels; the block stages its queries' rf rows and the (3, S*Co)
// directions in shared memory, each thread runs the max over k for each
// support with a strict > so the first maximal k wins, as the TPU kernel's
// min over the k that reach the max does.  Backward: one block per (batch,
// 16-query tile), walking the S*Co columns in chunks of 32.  Per chunk it
// stages each query's winner and gated cotangent; threads over the (query,
// k) rows add the routed directions into drf rows held in shared memory
// (each row has one owner, so no atomics), and 96 threads write the block's
// partial of dd.  A second launch adds the partials in block order, so dd is
// the same from run to run.

#include "hs_common.cuh"

namespace {

constexpr int TQ = 16;  // queries per block
constexpr int FWD_THREADS = 128;
constexpr int BWD_THREADS = 256;
constexpr int CH = 32;  // columns per chunk in the backward

__global__ void __launch_bounds__(FWD_THREADS)
surface_fwd_kernel(const float* __restrict__ rf, const float* __restrict__ dirs,
                   float* __restrict__ out, int* __restrict__ win, int N, int K, int S,
                   int Co) {
  extern __shared__ float smem[];
  const int SC = S * Co;
  float* sd = smem;            // (3, S*Co)
  float* srf = smem + 3 * SC;  // (TQ, K, 3)
  const int b = blockIdx.y, q0 = blockIdx.x * TQ;
  const int tq = min(TQ, N - q0);

  hs::stage_dirs(dirs, sd, SC);
  const float* rfb = rf + ((size_t)b * N + q0) * K * 3;
  for (int e = threadIdx.x; e < tq * K * 3; e += blockDim.x) srf[e] = rfb[e];
  __syncthreads();

  for (int c = threadIdx.x; c < Co; c += blockDim.x) {
    for (int t = 0; t < tq; ++t) {
      const size_t row = (size_t)b * N + q0 + t;
      const float* r = srf + t * K * 3;
      float total = 0.f;
      for (int s = 0; s < S; ++s) {
        const int col = s * Co + c;
        const float d0 = sd[col], d1 = sd[SC + col], d2 = sd[2 * SC + col];
        float m = fmaxf(r[0] * d0 + r[1] * d1 + r[2] * d2, 0.f);
        int kb = 0;
        for (int j = 1; j < K; ++j) {
          const float v = fmaxf(r[j * 3] * d0 + r[j * 3 + 1] * d1 + r[j * 3 + 2] * d2, 0.f);
          if (v > m) {
            m = v;
            kb = j;
          }
        }
        win[row * SC + col] = kb;
        total += m;
      }
      out[row * Co + c] = total / S;
    }
  }
}

__global__ void __launch_bounds__(BWD_THREADS)
surface_bwd_kernel(const float* __restrict__ rf, const float* __restrict__ dirs,
                   const int* __restrict__ win, const float* __restrict__ gb,
                   float* __restrict__ drf, float* __restrict__ partial, int N, int K, int S,
                   int Co) {
  extern __shared__ float smem[];
  const int SC = S * Co;
  float* srf = smem;                        // (TQ, K, 3)
  float* sdrf = srf + TQ * K * 3;           // (TQ, K, 3)
  float* su = sdrf + TQ * K * 3;            // (TQ, CH) gated cotangent at the winner
  int* sw = reinterpret_cast<int*>(su + TQ * CH);  // (TQ, CH) winner
  float* sd = reinterpret_cast<float*>(sw + TQ * CH);  // (3, CH)
  const int b = blockIdx.y, q0 = blockIdx.x * TQ;
  const int tq = min(TQ, N - q0);
  const size_t blk = (size_t)b * gridDim.x + blockIdx.x;

  const float* rfb = rf + ((size_t)b * N + q0) * K * 3;
  for (int e = threadIdx.x; e < tq * K * 3; e += blockDim.x) {
    srf[e] = rfb[e];
    sdrf[e] = 0.f;
  }
  __syncthreads();

  for (int c0 = 0; c0 < SC; c0 += CH) {
    const int nc = min(CH, SC - c0);
    for (int e = threadIdx.x; e < TQ * CH; e += blockDim.x) {
      const int t = e / CH, j = e % CH;
      int k = 0;
      float u = 0.f;
      if (t < tq && j < nc) {
        const int col = c0 + j;
        const size_t row = (size_t)b * N + q0 + t;
        k = win[row * SC + col];
        const float* r = srf + (t * K + k) * 3;
        const float theta = r[0] * dirs[col] + r[1] * dirs[SC + col] + r[2] * dirs[2 * SC + col];
        if (theta > 0.f) u = gb[row * Co + col % Co] / S;
      }
      sw[e] = k;
      su[e] = u;
    }
    for (int e = threadIdx.x; e < 3 * CH; e += blockDim.x) {
      const int a = e / CH, j = e % CH;
      sd[e] = j < nc ? dirs[a * SC + c0 + j] : 0.f;
    }
    __syncthreads();

    // this block's partial of dd, its queries added in order
    for (int e = threadIdx.x; e < 3 * nc; e += blockDim.x) {
      const int a = e / nc, j = e % nc;
      float acc = 0.f;
      for (int t = 0; t < tq; ++t)
        acc += su[t * CH + j] * srf[(t * K + sw[t * CH + j]) * 3 + a];
      partial[(blk * 3 + a) * SC + c0 + j] = acc;
    }
    // drf: each (query, k) row collects the columns it won
    for (int r = threadIdx.x; r < tq * K; r += blockDim.x) {
      const int t = r / K, k = r % K;
      float a0 = sdrf[r * 3], a1 = sdrf[r * 3 + 1], a2 = sdrf[r * 3 + 2];
      for (int j = 0; j < nc; ++j) {
        if (sw[t * CH + j] == k) {
          const float u = su[t * CH + j];
          a0 += u * sd[j];
          a1 += u * sd[CH + j];
          a2 += u * sd[2 * CH + j];
        }
      }
      sdrf[r * 3] = a0;
      sdrf[r * 3 + 1] = a1;
      sdrf[r * 3 + 2] = a2;
    }
    __syncthreads();
  }

  float* drfb = drf + ((size_t)b * N + q0) * K * 3;
  for (int e = threadIdx.x; e < tq * K * 3; e += blockDim.x) drfb[e] = sdrf[e];
}

size_t bwd_smem(int K) {
  return sizeof(float) * (2 * (size_t)TQ * K * 3 + 2 * TQ * CH + 3 * CH);
}

}  // namespace

// Blocks of the backward: the dd partial-sum scratch is (hs_surface_bwd_parts(B, N), 3, S*Co).
extern "C" int hs_surface_bwd_parts(int B, int N) { return B * ((N + TQ - 1) / TQ); }

// rf (B, N, K, 3), dirs (3, S*Co) -> out (B, N, Co), win (B, N, S*Co) int32.
extern "C" int hs_surface_fwd(const float* rf, const float* dirs, float* out, int* win, int B,
                              int N, int K, int S, int Co, void* stream) {
  const size_t smem = sizeof(float) * (3 * (size_t)S * Co + (size_t)TQ * K * 3);
  cudaError_t err = hs::allow_smem(surface_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TQ - 1) / TQ, B);
  surface_fwd_kernel<<<grid, FWD_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      rf, dirs, out, win, N, K, S, Co);
  return (int)cudaGetLastError();
}

// rf (B, N, K, 3), dirs (3, S*Co), win (B, N, S*Co), gb (B, N, Co), partial scratch
// (hs_surface_bwd_parts(B, N), 3, S*Co) -> drf (B, N, K, 3), dd (3, S*Co).
extern "C" int hs_surface_bwd(const float* rf, const float* dirs, const int* win,
                              const float* gb, float* drf, float* partial, float* dd, int B,
                              int N, int K, int S, int Co, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_smem(K);
  cudaError_t err = hs::allow_smem(surface_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TQ - 1) / TQ, B);
  surface_bwd_kernel<<<grid, BWD_THREADS, smem, st>>>(rf, dirs, win, gb, drf, partial, N, K,
                                                      S, Co);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)hs::sum_partials(partial, dd, hs_surface_bwd_parts(B, N), 3 * S * Co, st);
}
