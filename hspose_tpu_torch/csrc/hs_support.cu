// HS support reduction (conv_1 .. conv_4), project then gather:
//   P   = feat @ W + b                                   (B, N, S*Co)
//   out = mean_s max_k relu(rf_k . dir_s) * P[idx_k, s]  (B, N, Co)
//
// Replaces: hspose_tpu/ops/pallas_hs_fused.py::_support_fwd_kernel, reached
// through hs_support_fused.  Plain version: hspose_tpu_torch/ops/
// cuda_hs_fused.py::hs_support_plain, which follows the reference's own order
// (hspose_tpu/models/layers.py, the project-then-gather branch).
//
// What bounds it on an H100: projecting first costs N*Cin*S*Co multiply-adds,
// gathering first K times as many (about 8.5e9 against 1.5e11 per forward at
// B=24).  The projection is a dense fp32 product; the reduction reads K rows
// of P per query, about 1.8 GB at conv_1 (B=24), most of it from L2, and
// writes only (B, N, Co).
//
// Design: two kernels.  (i) project_kernel, a shared-memory-tiled fp32 GEMM:
// 64x64 output tiles, 256 threads each owning a 4x4 block, the reduction axis
// staged 16 deep; the bias is added at the store.  W may be a column slice of
// a wider matrix (row stride ldw).  (ii) reduce_kernel, one block per (batch,
// 8-query tile), 128 threads over channels: the block stages the queries'
// normalised neighbour directions, neighbour indices and the (3, S*Co) support
// directions in shared memory; each thread runs, per support, the max over k
// of relu(theta) * P[neighbour] with coalesced loads of P rows, then sums the
// supports in order.  No (B, N, K, ...) tensor exists.

#include <cfloat>

#include "hs_common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int GEMM_THREADS = 256;
constexpr int APAD = BM + 4;  // row stride of the transposed A tile

__global__ void __launch_bounds__(GEMM_THREADS)
project_kernel(const float* __restrict__ A, const float* __restrict__ W, int ldw,
               const float* __restrict__ bias, float* __restrict__ C, int M, int Kd, int Nc) {
  __shared__ __align__(16) float As[BK][APAD];  // As[k][m]
  __shared__ __align__(16) float Ws[BK][BN];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Kd; k0 += BK) {
    for (int e = tid; e < BM * BK; e += GEMM_THREADS) {
      const int r = e / BK, c = e % BK;
      As[c][r] = (m0 + r < M && k0 + c < Kd) ? A[(size_t)(m0 + r) * Kd + k0 + c] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += GEMM_THREADS) {
      const int r = e / BN, c = e % BN;
      Ws[r][c] = (k0 + r < Kd && n0 + c < Nc) ? W[(size_t)(k0 + r) * ldw + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[c][ty * 4]);
      const float4 w4 = *reinterpret_cast<const float4*>(&Ws[c][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * w[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < Nc) C[(size_t)r * Nc + col] = acc[i][j] + bias[col];
    }
  }
}

constexpr int TQ = 8;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
reduce_kernel(const float* __restrict__ proj, const float* __restrict__ verts,
              const int* __restrict__ idx, const float* __restrict__ dirs,
              float* __restrict__ out, int N, int K, int S, int Co) {
  extern __shared__ float smem[];
  const int SC = S * Co;
  float* sd = smem;                                   // (3, S*Co)
  float* srf = smem + 3 * SC;                         // (TQ, K, 3)
  int* sidx = reinterpret_cast<int*>(srf + TQ * K * 3);  // (TQ, K)
  const int b = blockIdx.y, q0 = blockIdx.x * TQ;

  hs::stage_dirs(dirs, sd, SC);
  hs::stage_rf(verts, idx, srf, sidx, b, q0, TQ, N, K);
  __syncthreads();

  const float* Pb = proj + (size_t)b * N * SC;
  const int tq = min(TQ, N - q0);
  for (int c = threadIdx.x; c < Co; c += blockDim.x) {
    for (int t = 0; t < tq; ++t) {
      float total = 0.f;
      for (int s = 0; s < S; ++s) {
        const int col = s * Co + c;
        const float d0 = sd[col], d1 = sd[SC + col], d2 = sd[2 * SC + col];
        float m = -FLT_MAX;
        for (int j = 0; j < K; ++j) {
          const float* r = srf + (t * K + j) * 3;
          const float theta = fmaxf(r[0] * d0 + r[1] * d1 + r[2] * d2, 0.f);
          m = fmaxf(m, theta * Pb[(size_t)sidx[t * K + j] * SC + col]);
        }
        total += m;
      }
      out[((size_t)b * N + q0 + t) * Co + c] = total / S;
    }
  }
}

}  // namespace

// feat (rows, Cin) @ W (Cin, Cout; row stride ldw) + b (Cout) -> proj (rows, Cout).
extern "C" int hs_support_project(const float* feat, const float* w, int ldw, const float* b,
                                  float* proj, int rows, int Cin, int Cout, void* stream) {
  const dim3 grid((Cout + BN - 1) / BN, (rows + BM - 1) / BM);
  project_kernel<<<grid, GEMM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      feat, w, ldw, b, proj, rows, Cin, Cout);
  return (int)cudaGetLastError();
}

// proj (B, N, S*Co), verts (B, N, 3), idx (B, N, K) int32, dirs (3, S*Co) -> out (B, N, Co).
extern "C" int hs_support_reduce(const float* proj, const float* verts, const int* idx,
                                 const float* dirs, float* out, int B, int N, int K, int S,
                                 int Co, void* stream) {
  const size_t smem = sizeof(float) * (3 * (size_t)S * Co + (size_t)TQ * K * 3) +
                      sizeof(int) * (size_t)TQ * K;
  cudaError_t err = hs::allow_smem(reduce_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TQ - 1) / TQ, B);
  reduce_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      proj, verts, idx, dirs, out, N, K, S, Co);
  return (int)cudaGetLastError();
}
