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
// The differentiable op (K3 with want_win, and its backward K8), both tiers:
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
// * With exact=False (the bf16 tier: bf16 features, fast != 0) the TPU kernel
//   rounds each (query, k) row's dg = bf16(dproj) bf16(W)^T to bf16 before
//   the source-row sum (_mm_gp, _scatter_rows), so dfeat is no longer one
//   product of the scattered dproj: dg_rows_kernel buckets each query's
//   columns by winner and sums, per k, bf16(dproj) times a bf16 copy of W^T
//   (hs_support_train.cu's rows kernel, on dproj), writing (B, N, K, Cin)
//   bf16 rows; dfeat_source_kernel sums each source row's inverse list of
//   them in order and rounds to bf16.  dW = feat^T dproj_src stays one GEMM
//   (bf16 feat, the source-row sums of bf16(dproj) not rounded again).  What
//   bounds it: the same B*N*Cin*S*Co multiply-adds for dg; a copy of W^T
//   per query from L2 (bf16, SC*Cin*2 bytes); the (B, N, K, Cin) rows once
//   each way.

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
// WR rounds W to bf16 as it is staged: the bf16 tier's W operand, by default
// when A is bf16.
template <typename TA, bool AT = false, bool WT = false,
          bool WR = std::is_same_v<TA, __nv_bfloat16>>
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
      Ws[r][c] = WR ? hs::bf16_round(w) : w;
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
constexpr int ROWS_THREADS = 128;

// The bf16 tier's dg rows (pallas_hs_fused.py:482-483, exact=False): one block
// per query q; its SC columns are bucketed by winner (hs::bucket_by_winner),
// and thread i sums bf16(dproj[q, c]) * wt[c, i] over each bucket k in column
// order and writes dg[q, k, i] rounded to bf16, the row's cotangent as the
// TPU kernel rounds it before the source-row sum.  The exact products are
// summed in fp64 and rounded to fp32, then to bf16, so that the row's
// rounding does not depend on the order of the sum (ops/cuda_hs_fused.py::
// _support_fused_bwd_fast forms the same row from a product in another order).
__global__ void __launch_bounds__(ROWS_THREADS)
dg_rows_kernel(const float* __restrict__ dproj, const int* __restrict__ win,
               const __nv_bfloat16* __restrict__ wt, __nv_bfloat16* __restrict__ dg, int K,
               int Cin, int SC) {
  extern __shared__ __align__(16) float smem[];
  float2* spair = reinterpret_cast<float2*>(smem);  // (SC) bucket order: (column bits, value)
  int* sk = reinterpret_cast<int*>(spair + SC);      // (SC) winner
  int* srank = sk + SC;                              // (SC) place within its bucket
  int* scnt = srank + SC;                            // (32) bucket sizes
  int* soff = scnt + 32;                             // (33) bucket offsets
  const size_t q = blockIdx.x;
  for (int c = threadIdx.x; c < SC; c += blockDim.x) sk[c] = win[q * SC + c];
  __syncthreads();
  hs::bucket_by_winner(sk, srank, scnt, soff, SC);
  __syncthreads();
  for (int c = threadIdx.x; c < SC; c += blockDim.x)
    spair[soff[sk[c]] + srank[c]] =
        make_float2(__int_as_float(c), hs::bf16_round(dproj[q * SC + c]));
  __syncthreads();
  __nv_bfloat16* dgq = dg + q * K * Cin;
  for (int i = threadIdx.x; i < Cin; i += blockDim.x) {
    for (int k = 0; k < K; ++k) {
      double acc = 0.0;
      const int pe = soff[k + 1];
#pragma unroll 4
      for (int p = soff[k]; p < pe; ++p) {
        const float2 e = spair[p];
        acc += (double)e.y * (double)__bfloat162float(wt[(size_t)__float_as_int(e.x) * Cin + i]);
      }
      dgq[k * Cin + i] = __float2bfloat16_rn((float)acc);
    }
  }
}

// dfeat[b, r, i] = the sum over r's inverse list of dg[entry, i] (bf16 values,
// fp32 sum in list order), rounded to bf16.  One block per source row.
__global__ void __launch_bounds__(ROWS_THREADS)
dfeat_source_kernel(const int* __restrict__ rowptr, const int* __restrict__ ent,
                    const __nv_bfloat16* __restrict__ dg, __nv_bfloat16* __restrict__ dfeat, int N,
                    int K, int Cin) {
  const size_t row = blockIdx.x;
  const int b = (int)(row / N), r = (int)(row % N);
  const int* rp = rowptr + (size_t)b * (N + 1);
  const int* eb = ent + (size_t)b * N * K;
  const int lo = rp[r], hi = rp[r + 1];
  for (int i = threadIdx.x; i < Cin; i += blockDim.x) {
    float acc = 0.f;
    for (int p = lo; p < hi; ++p)
      acc += __bfloat162float(dg[((size_t)b * N * K + eb[p]) * Cin + i]);
    dfeat[row * Cin + i] = __float2bfloat16_rn(acc);
  }
}

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

// The forward of the differentiable op: as hs_support_reduce, and win
// (B, N, S*Co) int32, the first k reaching each column's max.
extern "C" int hs_support_reduce_win(const float* proj, const float* verts, const int* idx,
                                     const float* dirs, float* out, int* win, int B, int N, int K,
                                     int S, int Co, int fast, void* stream) {
  if (hsb::supported(N, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? reduce<true, true>(proj, verts, idx, dirs, out, win, B, N, K, S, Co, s)
              : reduce<false, true>(proj, verts, idx, dirs, out, win, B, N, K, S, Co, s);
}

// Slices of the dW product: its partial-sum scratch is (hs_support_fused_dw_parts(B * N),
// Cin, S*Co).
extern "C" int hs_support_fused_dw_parts(int rows) { return (rows + DW_KC - 1) / DW_KC; }

// K8: feat (B, N, Cin) fp32, or bf16 with fast != 0 (the bf16 tier), w (Cin, S*Co;
// row stride ldw), verts (B, N, 3), idx (B, N, K), dirs (3, S*Co), win (B, N, S*Co),
// proj (B, N, S*Co) the forward's projection, gb (B, N, Co) -> dfeat (B, N, Cin) in
// feat's type, dverts (B, N, 3), dw (Cin, S*Co), red (4, S*Co) = [dd; db].  Scratch:
// rowptr (B, N + 1), ent (B, N*K) int32; dz, dproj, dproj_src (B, N, S*Co), drf
// (B, N, K, 3), dvq (B, N, 3), partial (hs_fused_bwd_parts(B, N), 4, S*Co), dw_partial
// (hs_support_fused_dw_parts(B * N), Cin, S*Co) fp32; with fast, dg (B, N, K, Cin) and
// wt (S*Co, Cin) bf16 (null otherwise).
extern "C" int hs_support_fused_bwd(const void* feat, const float* w, int ldw,
                                    const float* verts, const int* idx, const float* dirs,
                                    const int* win, const float* proj, const float* gb,
                                    int* rowptr, int* ent, float* dz, float* dproj,
                                    float* dproj_src, float* drf, float* dvq, float* partial,
                                    float* dw_partial, void* dg, void* wt, void* dfeat,
                                    float* dverts, float* dw, float* red, int B, int N, int K,
                                    int Cin, int S, int Co, int fast, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hsb::supported(N, K)) return (int)cudaErrorInvalidValue;
  const int SC = S * Co, rows = B * N;
  cudaError_t err =
      fast ? hsb::fused_bwd<true, true>(verts, idx, dirs, win, gb, proj, rowptr, ent, dz, dproj,
                                        drf, dvq, partial, red, dproj_src, dverts, B, N, K, S, Co,
                                        st)
           : hsb::fused_bwd<true, false>(verts, idx, dirs, win, gb, proj, rowptr, ent, dz, dproj,
                                         drf, dvq, partial, red, dproj_src, dverts, B, N, K, S, Co,
                                         st);
  if (err != cudaSuccess) return (int)err;
  const int parts = (rows + DW_KC - 1) / DW_KC;
  if (fast) {
    // dg rows (bf16) from bf16 W^T, then dfeat by source row
    auto* wtb = static_cast<__nv_bfloat16*>(wt);
    auto* dgb = static_cast<__nv_bfloat16*>(dg);
    err = hs::transpose_w<true>(w, ldw, wtb, Cin, SC, st);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = sizeof(float) * 2 * (size_t)SC + sizeof(int) * (2 * (size_t)SC + 65);
    err = hs::allow_smem(dg_rows_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    dg_rows_kernel<<<rows, ROWS_THREADS, smem, st>>>(dproj, win, wtb, dgb, K, Cin, SC);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dfeat_source_kernel<<<rows, ROWS_THREADS, 0, st>>>(rowptr, ent, dgb,
                                                       static_cast<__nv_bfloat16*>(dfeat), N, K,
                                                       Cin);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // dW (Cin, SC) = feat^T (bf16) dproj_src (the sums of bf16(dproj), not rounded again)
    project_kernel<__nv_bfloat16, true, false, false>
        <<<dim3((SC + BN - 1) / BN, (Cin + BM - 1) / BM, parts), GEMM_THREADS, 0, st>>>(
            static_cast<const __nv_bfloat16*>(feat), Cin, dproj_src, SC, nullptr, dw_partial, Cin,
            rows, SC, DW_KC);
  } else {
    // dfeat (rows, Cin) = dproj_src (rows, SC) W^T
    project_kernel<float, false, true>
        <<<dim3((Cin + BN - 1) / BN, (rows + BM - 1) / BM), GEMM_THREADS, 0, st>>>(
            dproj_src, SC, w, ldw, nullptr, static_cast<float*>(dfeat), rows, SC, Cin, SC);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // dW (Cin, SC) = feat^T (Cin, rows) dproj_src (rows, SC), in row slices
    project_kernel<float, true, false>
        <<<dim3((SC + BN - 1) / BN, (Cin + BM - 1) / BM, parts), GEMM_THREADS, 0, st>>>(
            static_cast<const float*>(feat), Cin, dproj_src, SC, nullptr, dw_partial, Cin, rows,
            SC, DW_KC);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)hs::sum_partials(dw_partial, dw, parts, Cin * SC, st);
}
