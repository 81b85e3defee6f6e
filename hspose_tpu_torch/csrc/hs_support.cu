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
// B=24).  The projection is a dense product (0.25 ms of fp32 peak per
// forward).  The reduction gathers K rows of P per query, 928 M fp32 values
// (3.7 GB) per forward, almost all from L2, and writes only (B, N, Co): its
// floor is L2's rate, and before this design it ran at about half of that,
// bound by latency and issue (one 4-byte load in flight per thread, the rf
// row reloaded from shared memory for every element).
//
// Design: two kernels.
// (i) The projection.  fp32: project_f32_kernel, a SIMT GEMM with 128 x 128
// tiles, an 8 x 8 block per thread, the next tiles loaded while this one's products
// run (A through registers into a transposed tile, W by cp.async); each output keeps
// the sequential-k fused multiply-add order and the bias added at the store,
// so P keeps its bits.  bf16: project_bf16_kernel on the tensor cores
// (mma.sync) over bf16 features and W rounded to bf16 as its operand
// fragments are formed (_w_parts), so every product is exact and the sum is
// fp32, as the TPU kernel's one-pass bf16 product with fp32 accumulation
// (_mm); P stays fp32 with the fp32 bias.  W may be a column slice of a wider matrix (row stride
// ldw).  No library GEMM is called.
// (ii) reduce_kernel: one block per (batch, query tile), each thread four
// adjacent columns as float4; the rf row and neighbour index of a (query, k)
// come as one float4 from shared memory and serve all four columns; K is a
// template argument, so a support's K loads of P are in flight together.
// Per column the arithmetic is the replaced kernel's, so the outputs keep
// their bits.  No (B, N, K, ...) tensor exists.  The bf16 tier stages
// bf16-rounded rf rows and directions (hs_common.cuh).  Projecting before
// the gather gives each gathered row the same value as the TPU kernel's
// gather-then-project.
//
// project_kernel, the earlier 64 x 64 CUDA-core GEMM, stays for K8's two
// products below.
//
// The differentiable op (K3 with want_win, and its backward K8), both tiers:
// * hs_support_reduce_win is the reduction with WIN: it also records, per
//   (point, support column), the first k reaching the max of theta * P (a
//   strict > from -FLT_MAX, pallas_hs_fused.py:248-261).  The serving
//   instantiations (WIN false) are compiled from the same lines.
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
// partial sums); bias may be null.  K8's dfeat and dW products.  WR rounds W
// to bf16 as it is staged.
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

// The forward's projection in fp32 (the bf16 tier's is project_bf16_kernel):
// C (M, Nc) = A (M, Kd) W (Kd, Nc; row stride ldw) + bias on the CUDA cores.
// 128 x 128 output tiles, 256 threads each owning 8 rows (two groups of four
// at ty * 4 and 64 + ty * 4) by 8 columns (two float4 groups at tx * 4 and
// 64 + tx * 4), so that per k a thread reads 4 float4 from shared memory for
// 64 fused multiply-adds.  The A tile is stored
// transposed (As[k][m]): its next rows are loaded into registers while this
// tile's products run and written after them; the W tile comes by cp.async
// into the other buffer.  Every output is one fused multiply-add chain in
// increasing k from 0 with the bias added at the store, the arithmetic of
// project_kernel, so P keeps its bits.  Needs Kd, ldw and Nc multiples of 4
// and A, W 16-byte aligned.
constexpr int PM = 128, PN = 128, PK = 16;
constexpr int PAS = PM + 4;  // row stride of the transposed A tile

__global__ void __launch_bounds__(GEMM_THREADS, 2)
project_f32_kernel(const float* __restrict__ A, const float* __restrict__ W, int ldw,
                   const float* __restrict__ bias, float* __restrict__ C, int M, int Kd, int Nc) {
  constexpr int NJ = 2;  // float4 column groups per thread
  constexpr int AV = PM * PK / 4 / GEMM_THREADS;  // float4 of the A tile per thread
  __shared__ __align__(16) float As[2][PK][PAS];
  __shared__ __align__(16) float Ws[2][PK][PN];
  const int m0 = blockIdx.y * PM, n0 = blockIdx.x * PN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  float4 ra[AV];  // the next A tile, rows tid / 4 + 64 v, features (tid % 4) * 4 ..
  auto load_a = [&](int k0) {
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      const int r = tid / 4 + 64 * v, c = tid % 4 * 4;
      ra[v] = m0 + r < M && k0 + c < Kd
                  ? __ldg(reinterpret_cast<const float4*>(A + (size_t)(m0 + r) * Kd + k0 + c))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_a = [&](int buf) {
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      const int r = tid / 4 + 64 * v, c = tid % 4 * 4;
      As[buf][c + 0][r] = ra[v].x;
      As[buf][c + 1][r] = ra[v].y;
      As[buf][c + 2][r] = ra[v].z;
      As[buf][c + 3][r] = ra[v].w;
    }
  };
  auto load_w = [&](int buf, int k0) {
    for (int e = tid; e < PK * PN / 4; e += GEMM_THREADS) {
      const int r = e / (PN / 4), c = e % (PN / 4) * 4;
      const bool ok = k0 + r < Kd && n0 + c < Nc;
      hs::cp_async16(&Ws[buf][r][c], ok ? W + (size_t)(k0 + r) * ldw + n0 + c : W, ok);
    }
    hs::cp_async_commit();
  };

  float acc[8][NJ * 4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ * 4; ++j) acc[i][j] = 0.f;

  const int nk = (Kd + PK - 1) / PK;
  load_a(0);
  load_w(0, 0);
  store_a(0);
  hs::cp_async_wait<0>();
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    if (t + 1 < nk) {
      load_a((t + 1) * PK);
      load_w(buf ^ 1, (t + 1) * PK);
    }
#pragma unroll
    for (int k = 0; k < PK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float w[NJ * 4];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 w4 = *reinterpret_cast<const float4*>(&Ws[buf][k][jj * 64 + tx * 4]);
        w[jj * 4 + 0] = w4.x;
        w[jj * 4 + 1] = w4.y;
        w[jj * 4 + 2] = w4.z;
        w[jj * 4 + 3] = w4.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ * 4; ++j) acc[i][j] += a[i] * w[j];
    }
    if (t + 1 < nk) store_a(buf ^ 1);
    hs::cp_async_wait<0>();
    __syncthreads();  // the next tile is in place; this one may be rewritten
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (r >= M) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = n0 + jj * 64 + tx * 4;
      if (col >= Nc) continue;
      const float* a = acc[i] + jj * 4;
      *reinterpret_cast<float4*>(C + (size_t)r * Nc + col) =
          make_float4(a[0] + bias[col], a[1] + bias[col + 1], a[2] + bias[col + 2],
                      a[3] + bias[col + 3]);
    }
  }
}

// The bf16 tier's projection: C (M, Nc) = A (M, Kd; bf16) W (Kd, Nc; row
// stride ldw) + bias on the tensor cores: mma.sync m16n8k16 over bf16
// features and W rounded to bf16 (to nearest even, as hs::bf16_round) as
// each B fragment is formed from the fp32 tile, so every product is exact
// and the sums are fp32, as the TPU kernel's one-pass bf16 product with fp32
// accumulation (_mm); P is fp32 with the fp32 bias.  64 x 128 output tiles,
// 8 warps of 32 x 32, the A and W tiles 32 deep double-buffered by cp.async;
// outputs leave in pairs of adjacent columns.  Needs Kd % 8 == 0, ldw and Nc
// multiples of 4, A and W 16-byte aligned, bias 8-byte aligned.
constexpr int TM = 64, TN = 128, TK = 32;
constexpr int TKS = TK + 8;  // bf16 row stride of the A tile: fragment reads hit 32 banks
constexpr int TNW = TN + 4;  // fp32 row stride of the W tile: rows 2t, columns g hit 32 banks

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__global__ void __launch_bounds__(GEMM_THREADS)
project_bf16_kernel(const __nv_bfloat16* __restrict__ A, const float* __restrict__ W, int ldw,
                    const float* __restrict__ bias, float* __restrict__ C, int M, int Kd,
                    int Nc) {
  __shared__ __align__(16) __nv_bfloat16 As[2][TM][TKS];
  __shared__ __align__(16) float Ws[2][TK][TNW];
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int wm = warp % 2, wn = warp / 2;  // the warp's tile: rows wm * 32, columns wn * 32

  auto load = [&](int buf, int k0) {
    for (int e = tid; e < TM * TK / 8; e += GEMM_THREADS) {
      const int r = e / (TK / 8), c = e % (TK / 8) * 8;
      const bool ok = m0 + r < M && k0 + c < Kd;
      hs::cp_async16(&As[buf][r][c], ok ? A + (size_t)(m0 + r) * Kd + k0 + c : A, ok);
    }
    for (int e = tid; e < TK * TN / 4; e += GEMM_THREADS) {
      const int r = e / (TN / 4), c = e % (TN / 4) * 4;
      const bool ok = k0 + r < Kd && n0 + c < Nc;
      hs::cp_async16(&Ws[buf][r][c], ok ? W + (size_t)(k0 + r) * ldw + n0 + c : W, ok);
    }
    hs::cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int nk = (Kd + TK - 1) / TK;
  load(0, 0);
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk)
      load((t + 1) & 1, (t + 1) * TK);
    else
      hs::cp_async_commit();
    hs::cp_async_wait<1>();
    __syncthreads();
    const int buf = t & 1;
#pragma unroll
    for (int ks = 0; ks < TK; ks += 16) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* p = &As[buf][wm * 32 + mt * 16 + g][ks + 2 * t4];
        a[mt][0] = hs::ld_b32(p);
        a[mt][1] = hs::ld_b32(p + 8 * TKS);
        a[mt][2] = hs::ld_b32(p + 8);
        a[mt][3] = hs::ld_b32(p + 8 * TKS + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* p = &Ws[buf][ks + 2 * t4][wn * 32 + nt * 8 + g];
        b[nt][0] = bf16_pair(p[0], p[TNW]);
        b[nt][1] = bf16_pair(p[8 * TNW], p[9 * TNW]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) hs::mma_bf16_16816(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();  // the next load rewrites this buffer
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + 2 * t4;
      if (col >= Nc) continue;
      const float2 bb = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm * 32 + mt * 16 + g + h * 8;
        if (r < M)
          *reinterpret_cast<float2*>(C + (size_t)r * Nc + col) =
              make_float2(acc[mt][nt][2 * h] + bb.x, acc[mt][nt][2 * h + 1] + bb.y);
      }
    }
}

constexpr int RTHREADS = 128;

// The reduction: out[q, c] = mean_s max_k relu(rf_k . d_{s,c}) * P[idx_k, s*Co + c].
// One block per (batch, TQ-query tile), 128 threads; each thread owns four
// adjacent columns c4 * 4 .. + 3 and the queries t = ql, ql + QPB, ... of
// the tile (QPB = 128 / min(Co / 4, 128) queries side by side).  The block
// stages the tile's unit rf rows with their neighbour index as float4
// (hs::stage_rf, PACK4); per (query, support) a thread reads its twelve
// directions once, then for each k one float4 of rf and index and one float4
// of P.  K is a template argument (KT; 0 reads it at run time), so the K
// loads of a support are in flight together.  Per column the arithmetic is
// that of the kernel this one replaced: theta from the same expression, the
// max in increasing k (WIN: the first k by strict > from -FLT_MAX, and its
// k recorded), the supports summed in order, then / S; so the fp32 outputs
// keep their bits, and WIN gives the serving kernel's.  Needs Co % 4 == 0 and
// proj, out, win 16-byte aligned.
template <bool FAST, bool WIN, int KT>
__global__ void __launch_bounds__(RTHREADS)
reduce_kernel(const float* __restrict__ proj, const float* __restrict__ verts,
              const int* __restrict__ idx, const float* __restrict__ dirs,
              float* __restrict__ out, int* __restrict__ win, int N, int K_arg, int S, int Co,
              int TQ) {
  extern __shared__ __align__(16) float srf[];  // (TQ, K) float4: rf, index bits
  const int K = KT ? KT : K_arg;
  const int SC = S * Co, C4 = Co / 4;
  const int b = blockIdx.y, q0 = blockIdx.x * TQ;
  hs::stage_rf<FAST, true>(verts, idx, srf, nullptr, b, q0, TQ, N, K);
  __syncthreads();

  const int lanes_c = min(C4, RTHREADS), QPB = RTHREADS / lanes_c;
  const int ql = threadIdx.x / lanes_c;
  if (ql >= QPB) return;
  const float* Pb = proj + (size_t)b * N * SC;
  const float4* rf4 = reinterpret_cast<const float4*>(srf);
  const int tq = min(TQ, N - q0);
  for (int c4 = threadIdx.x % lanes_c; c4 < C4; c4 += lanes_c) {
    for (int t = ql; t < tq; t += QPB) {
      const size_t row = (size_t)b * N + q0 + t;
      float total[4] = {0.f, 0.f, 0.f, 0.f};
      for (int s = 0; s < S; ++s) {
        const int col = s * Co + c4 * 4;
        float d0[4], d1[4], d2[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          d0[c] = __ldg(dirs + col + c);
          d1[c] = __ldg(dirs + SC + col + c);
          d2[c] = __ldg(dirs + 2 * SC + col + c);
          if (FAST) {
            d0[c] = hs::bf16_round(d0[c]);
            d1[c] = hs::bf16_round(d1[c]);
            d2[c] = hs::bf16_round(d2[c]);
          }
        }
        float m[4] = {-FLT_MAX, -FLT_MAX, -FLT_MAX, -FLT_MAX};
        int kb[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float4 r = rf4[t * K + j];
          const float4 p4 =
              __ldg(reinterpret_cast<const float4*>(Pb + (size_t)__float_as_int(r.w) * SC + col));
          const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float theta = fmaxf(r.x * d0[c] + r.y * d1[c] + r.z * d2[c], 0.f);
            if constexpr (WIN) {
              const float v = theta * p[c];
              if (v > m[c]) {
                m[c] = v;
                kb[c] = j;
              }
            } else {
              m[c] = fmaxf(m[c], theta * p[c]);
            }
          }
        }
        if constexpr (WIN)
          *reinterpret_cast<int4*>(win + row * SC + col) = make_int4(kb[0], kb[1], kb[2], kb[3]);
#pragma unroll
        for (int c = 0; c < 4; ++c) total[c] += m[c];
      }
      *reinterpret_cast<float4*>(out + row * Co + c4 * 4) =
          make_float4(total[0] / S, total[1] / S, total[2] / S, total[3] / S);
    }
  }
}

template <typename TA>
int project(const TA* feat, const float* w, int ldw, const float* b, float* proj, int rows,
            int Cin, int Cout, cudaStream_t stream) {
  if (Cin % (hs::is_bf16<TA> ? 8 : 4) || ldw % 4 || Cout % 4 || !hs::aligned16(feat) ||
      !hs::aligned16(w) || reinterpret_cast<size_t>(b) % 8)
    return (int)cudaErrorInvalidValue;
  if constexpr (hs::is_bf16<TA>)
    project_bf16_kernel<<<dim3((Cout + TN - 1) / TN, (rows + TM - 1) / TM), GEMM_THREADS, 0,
                          stream>>>(feat, w, ldw, b, proj, rows, Cin, Cout);
  else
    project_f32_kernel<<<dim3((Cout + PN - 1) / PN, (rows + PM - 1) / PM), GEMM_THREADS, 0,
                         stream>>>(feat, w, ldw, b, proj, rows, Cin, Cout);
  return (int)cudaGetLastError();
}

template <bool FAST, bool WIN, int KT>
int reduce_k(const float* proj, const float* verts, const int* idx, const float* dirs, float* out,
             int* win, int B, int N, int K, int S, int Co, cudaStream_t stream) {
  // two queries per thread and column group
  const int TQ = 2 * (RTHREADS / min(Co / 4, RTHREADS));
  const size_t smem = sizeof(float4) * (size_t)TQ * K;
  auto kernel = reduce_kernel<FAST, WIN, KT>;
  cudaError_t err = hs::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((N + TQ - 1) / TQ, B), RTHREADS, smem, stream>>>(proj, verts, idx, dirs, out, win,
                                                                 N, K, S, Co, TQ);
  return (int)cudaGetLastError();
}

template <bool FAST, bool WIN = false>
int reduce(const float* proj, const float* verts, const int* idx, const float* dirs, float* out,
           int* win, int B, int N, int K, int S, int Co, cudaStream_t stream) {
  if (Co % 4 || !hs::aligned16(proj) || !hs::aligned16(out) || (WIN && !hs::aligned16(win)))
    return (int)cudaErrorInvalidValue;
  switch (K) {  // the model's K = 20 and 8 unrolled
    case 20: return reduce_k<FAST, WIN, 20>(proj, verts, idx, dirs, out, win, B, N, K, S, Co,
                                            stream);
    case 8: return reduce_k<FAST, WIN, 8>(proj, verts, idx, dirs, out, win, B, N, K, S, Co,
                                          stream);
    default: return reduce_k<FAST, WIN, 0>(proj, verts, idx, dirs, out, win, B, N, K, S, Co,
                                           stream);
  }
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
