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
//
// The bf16 tier (exact=False of the same TPU kernel) instantiates both with
// bf16 operands: the GEMM reads bf16 features and rounds each weight to bf16
// as it stages it (_w_parts), so every product is exact and the sum is fp32,
// as the TPU kernel's one-pass bf16 product with fp32 accumulation (_mm);
// P stays fp32 with the fp32 bias.  The reduction stages bf16-rounded rf
// rows and directions (hs_common.cuh).  Projecting before the gather gives
// each gathered row the same value as the TPU kernel's gather-then-project.
// The GEMM runs on the CUDA cores; tensor cores are later work.
//
// The differentiable fp32 op (K3 with want_win, and its backward K8):
// * hs_support_reduce_win is the reduction with WIN: it also records, per
//   (point, support column), the first k reaching the max of theta * P (a
//   strict > from -FLT_MAX, pallas_hs_fused.py:248-261).  The serving
//   instantiations (WIN false) are compiled from the same lines as before.
// * hs_support_fused_bwd (K8) replaces hspose_tpu/ops/pallas_hs_fused.py::
//   _support_bwd_kernel with exact=True: dfeat, dverts, dW, db and dd from
//   win, the forward's projection P (kept as a residual instead of
//   recomputed) and the output cotangent.  The routed cotangents, dd, db,
//   dverts and dproj scattered to its source rows (dproj_src) come from
//   hs_fused_bwd.cuh; then the TPU kernel's products (_mm_g / _mm_gp,
//   :478-482) are two passes of the same tiled GEMM as the projection:
//   dfeat = dproj_src W^T and dW = feat^T dproj_src, the latter split over
//   row chunks into partial sums added in order.  Plain versions:
//   hspose_tpu_torch/ops/cuda_hs_fused.py::hs_support_fused_fwd_plain and
//   hs_support_fused_bwd_plain.  What bounds it: the two GEMMs, 2 * B*N*Cin*S*Co
//   fp32 multiply-adds on the CUDA cores (1.9e9 at conv_3, B=16); the rest
//   reads the (B, N, S*Co) winners, P and cotangents a few times.

#include <cfloat>
#include <type_traits>

#include "hs_fused_bwd.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int GEMM_THREADS = 256;
constexpr int APAD = BM + 4;  // row stride of the transposed A tile

// C (M, Nc) = A (M, Kd) W (Kd, Nc) (+ bias).  A[m, k] is A[m * lda + k], or with
// AT (A read transposed) A[k * lda + m]; W[k, n] is W[k * ldw + n], or with WT
// W[n * ldw + k]; neighbouring threads walk the unit stride.  blockIdx.z sums
// the k slice [z * kchunk, (z + 1) * kchunk) into C + z * M * Nc (split-k
// partial sums); bias may be null.  The projection is <TA, false, false>.
template <typename TA, bool AT = false, bool WT = false>
__global__ void __launch_bounds__(GEMM_THREADS)
project_kernel(const TA* __restrict__ A, int lda, const float* __restrict__ W, int ldw,
               const float* __restrict__ bias, float* __restrict__ C, int M, int Kd, int Nc,
               int kchunk) {
  __shared__ __align__(16) float As[BK][APAD];  // As[k][m]
  __shared__ __align__(16) float Ws[BK][BN];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kb = blockIdx.z * kchunk, ke = min(Kd, kb + kchunk);
  C += (size_t)blockIdx.z * M * Nc;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += BK) {
    for (int e = tid; e < BM * BK; e += GEMM_THREADS) {
      const int r = AT ? e % BM : e / BK, c = AT ? e / BM : e % BK;
      As[c][r] = (m0 + r < M && k0 + c < ke)
                     ? hs::load_f(AT ? A + (size_t)(k0 + c) * lda + m0 + r
                                     : A + (size_t)(m0 + r) * lda + k0 + c)
                     : 0.f;
    }
    for (int e = tid; e < BK * BN; e += GEMM_THREADS) {
      const int r = WT ? e % BK : e / BN, c = WT ? e / BK : e % BN;
      const float w = (k0 + r < ke && n0 + c < Nc)
                          ? (WT ? W[(size_t)(n0 + c) * ldw + k0 + r] : W[(size_t)(k0 + r) * ldw + n0 + c])
                          : 0.f;
      Ws[r][c] = std::is_same_v<TA, __nv_bfloat16> ? hs::bf16_round(w) : w;
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
      if (col < Nc) C[(size_t)r * Nc + col] = bias ? acc[i][j] + bias[col] : acc[i][j];
    }
  }
}

constexpr int TQ = 8;
constexpr int THREADS = 128;

template <bool FAST, bool WIN>
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const float* __restrict__ proj, const float* __restrict__ verts,
              const int* __restrict__ idx, const float* __restrict__ dirs,
              float* __restrict__ out, int* __restrict__ win, int N, int K, int S, int Co) {
  extern __shared__ float smem[];
  const int SC = S * Co;
  float* sd = smem;                                   // (3, S*Co)
  float* srf = smem + 3 * SC;                         // (TQ, K, 3)
  int* sidx = reinterpret_cast<int*>(srf + TQ * K * 3);  // (TQ, K)
  const int b = blockIdx.y, q0 = blockIdx.x * TQ;

  hs::stage_dirs<FAST>(dirs, sd, SC);
  hs::stage_rf<FAST>(verts, idx, srf, sidx, b, q0, TQ, N, K);
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
        int kb = 0;
        for (int j = 0; j < K; ++j) {
          const float* r = srf + (t * K + j) * 3;
          const float theta = fmaxf(r[0] * d0 + r[1] * d1 + r[2] * d2, 0.f);
          if constexpr (WIN) {
            const float v = theta * Pb[(size_t)sidx[t * K + j] * SC + col];
            if (v > m) {
              m = v;
              kb = j;
            }
          } else {
            m = fmaxf(m, theta * Pb[(size_t)sidx[t * K + j] * SC + col]);
          }
        }
        if constexpr (WIN) win[((size_t)b * N + q0 + t) * SC + col] = kb;
        total += m;
      }
      out[((size_t)b * N + q0 + t) * Co + c] = total / S;
    }
  }
}

template <typename TA>
int project(const TA* feat, const float* w, int ldw, const float* b, float* proj, int rows,
            int Cin, int Cout, cudaStream_t stream) {
  const dim3 grid((Cout + BN - 1) / BN, (rows + BM - 1) / BM);
  project_kernel<TA><<<grid, GEMM_THREADS, 0, stream>>>(feat, Cin, w, ldw, b, proj, rows, Cin,
                                                        Cout, Cin);
  return (int)cudaGetLastError();
}

template <bool FAST, bool WIN = false>
int reduce(const float* proj, const float* verts, const int* idx, const float* dirs, float* out,
           int* win, int B, int N, int K, int S, int Co, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * (size_t)S * Co + (size_t)TQ * K * 3) +
                      sizeof(int) * (size_t)TQ * K;
  cudaError_t err = hs::allow_smem(reduce_kernel<FAST, WIN>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TQ - 1) / TQ, B);
  reduce_kernel<FAST, WIN><<<grid, THREADS, smem, stream>>>(proj, verts, idx, dirs, out, win, N,
                                                            K, S, Co);
  return (int)cudaGetLastError();
}

constexpr int DW_KC = 256;  // rows per split-k slice of the dW product

}  // namespace

// feat (rows, Cin) @ W (Cin, Cout; row stride ldw) + b (Cout) -> proj (rows, Cout).
// fast != 0: feat is bf16 and W is rounded to bf16 (the bf16 tier); else both fp32.
extern "C" int hs_support_project(const void* feat, int fast, const float* w, int ldw,
                                  const float* b, float* proj, int rows, int Cin, int Cout,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? project(static_cast<const __nv_bfloat16*>(feat), w, ldw, b, proj, rows, Cin,
                        Cout, s)
              : project(static_cast<const float*>(feat), w, ldw, b, proj, rows, Cin, Cout, s);
}

// proj (B, N, S*Co), verts (B, N, 3), idx (B, N, K) int32, dirs (3, S*Co) -> out (B, N, Co);
// fast != 0 runs the bf16 tier.
extern "C" int hs_support_reduce(const float* proj, const float* verts, const int* idx,
                                 const float* dirs, float* out, int B, int N, int K, int S,
                                 int Co, int fast, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? reduce<true>(proj, verts, idx, dirs, out, nullptr, B, N, K, S, Co, s)
              : reduce<false>(proj, verts, idx, dirs, out, nullptr, B, N, K, S, Co, s);
}

// The forward of the differentiable fp32 op: as hs_support_reduce, and win
// (B, N, S*Co) int32, the first k reaching each column's max.
extern "C" int hs_support_reduce_win(const float* proj, const float* verts, const int* idx,
                                     const float* dirs, float* out, int* win, int B, int N, int K,
                                     int S, int Co, void* stream) {
  if (hsb::supported(N, K)) return (int)cudaErrorInvalidValue;
  return reduce<false, true>(proj, verts, idx, dirs, out, win, B, N, K, S, Co,
                             static_cast<cudaStream_t>(stream));
}

// Slices of the dW product: its partial-sum scratch is (hs_support_fused_dw_parts(B * N),
// Cin, S*Co).
extern "C" int hs_support_fused_dw_parts(int rows) { return (rows + DW_KC - 1) / DW_KC; }

// K8: feat (B, N, Cin), w (Cin, S*Co; row stride ldw), verts (B, N, 3), idx (B, N, K),
// dirs (3, S*Co), win (B, N, S*Co), proj (B, N, S*Co) the forward's projection,
// gb (B, N, Co) -> dfeat (B, N, Cin), dverts (B, N, 3), dw (Cin, S*Co), red (4, S*Co)
// = [dd; db].  Scratch: rowptr (B, N + 1), ent (B, N*K) int32; dz, dproj, dproj_src
// (B, N, S*Co), drf (B, N, K, 3), dvq (B, N, 3), partial (hs_fused_bwd_parts(B, N), 4,
// S*Co), dw_partial (hs_support_fused_dw_parts(B * N), Cin, S*Co) fp32.
extern "C" int hs_support_fused_bwd(const float* feat, const float* w, int ldw,
                                    const float* verts, const int* idx, const float* dirs,
                                    const int* win, const float* proj, const float* gb,
                                    int* rowptr, int* ent, float* dz, float* dproj,
                                    float* dproj_src, float* drf, float* dvq, float* partial,
                                    float* dw_partial, float* dfeat, float* dverts, float* dw,
                                    float* red, int B, int N, int K, int Cin, int S, int Co,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hsb::supported(N, K)) return (int)cudaErrorInvalidValue;
  const int SC = S * Co, rows = B * N;
  cudaError_t err = hsb::fused_bwd<true>(verts, idx, dirs, win, gb, proj, rowptr, ent, dz, dproj,
                                         drf, dvq, partial, red, dproj_src, dverts, B, N, K, S,
                                         Co, st);
  if (err != cudaSuccess) return (int)err;
  // dfeat (rows, Cin) = dproj_src (rows, SC) W^T
  project_kernel<float, false, true>
      <<<dim3((Cin + BN - 1) / BN, (rows + BM - 1) / BM), GEMM_THREADS, 0, st>>>(
          dproj_src, SC, w, ldw, nullptr, dfeat, rows, SC, Cin, SC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // dW (Cin, SC) = feat^T (Cin, rows) dproj_src (rows, SC), in row slices
  const int parts = (rows + DW_KC - 1) / DW_KC;
  project_kernel<float, true, false>
      <<<dim3((SC + BN - 1) / BN, (Cin + BM - 1) / BM, parts), GEMM_THREADS, 0, st>>>(
          feat, Cin, dproj_src, SC, nullptr, dw_partial, Cin, rows, SC, DW_KC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)hs::sum_partials(dw_partial, dw, parts, Cin * SC, st);
}
