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
// (i) The projection.  fp32: hs_project.cuh's gemm_kernel, a SIMT GEMM with
// 128 x 128 tiles, an 8 x 8 block per thread, the next tiles loaded while this
// one's products run (A through registers into a transposed tile, W by
// cp.async); each output keeps the sequential-k fused multiply-add order and
// the bias added at the store, so P keeps its bits.  bf16: project_bf16_kernel on the tensor cores
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
//   :478-482) are two passes of the projection's tile (hs_project.cuh), with
//   W read transposed and feat read transposed: dfeat = dproj_src W^T and
//   dW = feat^T dproj_src, the latter split over DW_KC-row chunks into
//   partial sums added in order (part of dW's association).  Plain versions:
//   hspose_tpu_torch/ops/cuda_hs_fused.py::hs_support_fused_fwd_plain and
//   hs_support_fused_bwd_plain.  What bounds it: the two GEMMs, 2 * B*N*Cin*S*Co
//   fp32 multiply-adds on the CUDA cores (1.9e9 at conv_3, B=16); the rest
//   reads the (B, N, S*Co) winners, P and cotangents a few times.
// * With exact=False (the bf16 tier: bf16 features, fast != 0) the TPU kernel
//   rounds each (query, k) row's dg = bf16(dproj) bf16(W)^T to bf16 before
//   the source-row sum (_mm_gp, _scatter_rows), so dfeat is no longer one
//   product of the scattered dproj: dg_rows_kernel (the design of
//   hs_support_train.cu's rows kernel: a warp per query, W^T streamed in
//   32-column chunks per block of queries, a ballot walk per k) sums, per k,
//   bf16(dproj) times bf16(W) in fp64, writing (B, N, K, Cin) bf16 rows;
//   dfeat_source_kernel sums each source row's inverse list of them in order
//   and rounds to bf16.  dW = feat^T dproj_src stays one GEMM (bf16 feat, the
//   source-row sums of bf16(dproj) not rounded again).  What bounds it: the
//   same B*N*Cin*S*Co multiply-adds for dg, in fp64 (half the fp32 rate);
//   the (B, N, K, Cin) rows once each way.

#include <cfloat>
#include <type_traits>

#include "hs_fused_bwd.cuh"
#include "hs_project.cuh"

namespace {

constexpr int GEMM_THREADS = 256;

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
  if constexpr (hs::is_bf16<TA>) {
    project_bf16_kernel<<<dim3((Cout + TN - 1) / TN, (rows + TM - 1) / TM), GEMM_THREADS, 0,
                          stream>>>(feat, w, ldw, b, proj, rows, Cin, Cout);
    return (int)cudaGetLastError();
  } else {
    return (int)hsp::gemm<float>(feat, Cin, w, ldw, b, proj, rows, Cin, Cout, 0, stream);
  }
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
constexpr int DG_NT = 512;    // threads per dg rows block
constexpr int DG_CC = 32;     // columns per staged W^T chunk: one per lane
constexpr int DG_CS = 128;    // input channels per dg rows block: four per lane
// bytes of a block's staged W^T chunks: two buffers of (DG_CC, DG_CS) fp64
constexpr size_t DG_W_BYTES = 2 * sizeof(double) * DG_CC * DG_CS;

// The bf16 tier's dg rows (pallas_hs_fused.py:482-483, exact=False):
// dg[q, k, i] = the sum of bf16(dproj[q, c]) * bf16(W[i, c]) over the columns
// c that k wins, in increasing c, written rounded to bf16: the row's cotangent
// as the TPU kernel rounds it before the source-row sum.  The exact products
// are summed in fp64 and rounded to fp32, then to bf16, so that the row's
// rounding does not depend on the order of the sum (ops/cuda_hs_fused.py::
// _support_fused_bwd_fast forms the same row from a product in another order).
// Block: DG_NT threads, DG_CS input channels (blockIdx.y) and DG_NT / 32 / KS
// queries, each query's winners split over KS warps of KH winners each
// (k = kr * KH .. + KH - 1 for the query's warp kr), lane l holding channels
// 4l .. 4l + 3 and the fp64 sums of its warp's winners in registers.  Per
// chunk of DG_CC columns, W^T[c, channels] is staged in shared memory (loaded
// as float4 rows of W, transposed through registers, rounded to bf16 and held
// as fp64, so that the walk converts nothing; double-buffered), lane j holds
// column j's winner and bf16(dproj), and for each of the warp's k in order a
// ballot gives the columns k wins, walked in column order.  So W is read
// from L2 once per block of queries, not once per (query, column), no column
// is ranked ahead, and each column's walk step feeds four channels.  What
// bounds it: one staged fp64 operand (8 bytes of shared memory) per
// multiply-add.
template <int KH, int KS>
__global__ void __launch_bounds__(DG_NT)
dg_rows_kernel(const float* __restrict__ dproj, const int* __restrict__ win,
               const float* __restrict__ w, int ldw, __nv_bfloat16* __restrict__ dg, int rows,
               int K, int Cin, int SC) {
  constexpr int TQ = DG_NT / 32 / KS;           // queries per block
  constexpr int NW = DG_CS * DG_CC / 4 / DG_NT;  // float4s of W each thread stages per chunk
  constexpr unsigned ALL = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char dg_smem[];
  double* sw = reinterpret_cast<double*>(dg_smem);  // [2][DG_CC][DG_CS]: (column, channel)
  double* sv = reinterpret_cast<double*>(dg_smem + DG_W_BYTES) + (threadIdx.x / 32) * DG_CC;
  const int lane = threadIdx.x % 32, wp = threadIdx.x / 32;
  const int i0 = blockIdx.y * DG_CS, k0 = (wp % KS) * KH;
  const size_t q = (size_t)blockIdx.x * TQ + wp / KS;
  const bool live = q < (size_t)rows && k0 < K;
  const bool w_vec = hs::aligned16(w) && ldw % 4 == 0;

  // element e of a chunk: channel row e / 8, columns (e % 8) * 4 .. + 3, so
  // that 8 lanes read 128 contiguous bytes of a row of W
  float4 wr[NW];
  int kn = -1;
  float vn = 0.f;
  auto fetch = [&](int c0) {
#pragma unroll
    for (int r = 0; r < NW; ++r) {
      const int e = threadIdx.x + r * DG_NT, row = i0 + e / 8, col = c0 + e % 8 * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < Cin && col < SC) {
        const float* p = w + (size_t)row * ldw + col;
        v = w_vec ? *reinterpret_cast<const float4*>(p) : make_float4(p[0], p[1], p[2], p[3]);
      }
      wr[r] = v;
    }
    const int col = c0 + lane;
    kn = -1;
    vn = 0.f;
    if (live && col < SC) {
      kn = win[q * SC + col];
      vn = hs::bf16_round(dproj[q * SC + col]);
    }
  };
  // channel 4l + t of column c's row sits at (t / 2) * 64 + (2l ^ 2((c / 4) %
  // 8)) + t % 2: a lane's two pairs are two aligned 16-byte reads, the lanes'
  // reads of a row fall on different banks, and the XOR (within 16 places)
  // spreads the writes of the 8 column groups a warp stages at once too
  auto stage = [&](int buf) {
#pragma unroll
    for (int r = 0; r < NW; ++r) {
      const int e = threadIdx.x + r * DG_NT, i = e / 8, col = e % 8 * 4;
      const int at = i % 4 / 2 * 64 + ((2 * (i / 4)) ^ (2 * (col / 4 % 8))) + i % 2;
      const float v[4] = {wr[r].x, wr[r].y, wr[r].z, wr[r].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) sw[(buf * DG_CC + col + j) * DG_CS + at] = hs::bf16_round(v[j]);
    }
  };

  double acc[KH][4];
#pragma unroll
  for (int k = 0; k < KH; ++k)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[k][c] = 0.0;

  const int chunks = (SC + DG_CC - 1) / DG_CC;
  fetch(0);
  stage(0);
  __syncthreads();
  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch & 1;
    const int kl = kn;
    const float vn_chunk = vn;
    sv[lane] = (double)vn;
    if (ch + 1 < chunks) fetch((ch + 1) * DG_CC);
    __syncwarp();
    if (live) {
      const double* wb = sw + buf * DG_CC * DG_CS;
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        if (k0 + k >= K) break;
        // columns whose bf16(dproj) is 0 add +-0 to a sum that is never -0: skipped
        unsigned m = __ballot_sync(ALL, kl == k0 + k && vn_chunk != 0.f);
        while (m) {
          const int j = __ffs(m) - 1;
          m &= m - 1;
          const double v = sv[j];
          const double* wj = wb + j * DG_CS + ((2 * lane) ^ (2 * (j / 4 % 8)));
          const double2 a = *reinterpret_cast<const double2*>(wj);
          const double2 c = *reinterpret_cast<const double2*>(wj + 64);
          acc[k][0] += v * a.x;
          acc[k][1] += v * a.y;
          acc[k][2] += v * c.x;
          acc[k][3] += v * c.y;
        }
      }
    }
    if (ch + 1 < chunks) stage(buf ^ 1);
    __syncthreads();
  }
  if (!live) return;
  __nv_bfloat16* out = dg + q * K * Cin + i0 + 4 * lane;
#pragma unroll
  for (int k = 0; k < KH; ++k) {
    if (k0 + k >= K) break;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (i0 + 4 * lane + c < Cin)
        out[(size_t)(k0 + k) * Cin + c] = __float2bfloat16_rn((float)acc[k][c]);
  }
}

template <int KH, int KS>
cudaError_t launch_dg_rows(const float* dproj, const int* win, const float* w, int ldw,
                           __nv_bfloat16* dg, int rows, int K, int Cin, int SC, cudaStream_t st) {
  constexpr int TQ = DG_NT / 32 / KS;
  const size_t smem = DG_W_BYTES + sizeof(double) * DG_NT;
  cudaError_t err = hs::allow_smem(dg_rows_kernel<KH, KS>, smem);
  if (err != cudaSuccess) return err;
  dg_rows_kernel<KH, KS><<<dim3((rows + TQ - 1) / TQ, (Cin + DG_CS - 1) / DG_CS), DG_NT, smem,
                           st>>>(dproj, win, w, ldw, dg, rows, K, Cin, SC);
  return cudaGetLastError();
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
// (hs_support_fused_dw_parts(B * N), Cin, S*Co) fp32; with fast, dg (B, N, K, Cin) bf16
// (null otherwise).
extern "C" int hs_support_fused_bwd(const void* feat, const float* w, int ldw,
                                    const float* verts, const int* idx, const float* dirs,
                                    const int* win, const float* proj, const float* gb,
                                    int* rowptr, int* ent, float* dz, float* dproj,
                                    float* dproj_src, float* drf, float* dvq, float* partial,
                                    float* dw_partial, void* dg, void* dfeat,
                                    float* dverts, float* dw, float* red, int B, int N, int K,
                                    int Cin, int S, int Co, int fast, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hsb::supported(N, K) || Cin % 4) return (int)cudaErrorInvalidValue;
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
    // dg rows (bf16) from W rounded to bf16, then dfeat by source row
    auto* dgb = static_cast<__nv_bfloat16*>(dg);
    err = K <= 8    ? launch_dg_rows<8, 1>(dproj, win, w, ldw, dgb, rows, K, Cin, SC, st)
          : K <= 20 ? launch_dg_rows<10, 2>(dproj, win, w, ldw, dgb, rows, K, Cin, SC, st)
                    : launch_dg_rows<8, 4>(dproj, win, w, ldw, dgb, rows, K, Cin, SC, st);
    if (err != cudaSuccess) return (int)err;
    dfeat_source_kernel<<<rows, ROWS_THREADS, 0, st>>>(rowptr, ent, dgb,
                                                       static_cast<__nv_bfloat16*>(dfeat), N, K,
                                                       Cin);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // dW (Cin, SC) = feat^T (bf16) dproj_src (the sums of bf16(dproj), not rounded again)
    err = hsp::gemm<__nv_bfloat16, true>(static_cast<const __nv_bfloat16*>(feat), Cin, dproj_src,
                                         SC, nullptr, dw_partial, Cin, rows, SC, DW_KC, st);
  } else {
    // dfeat (rows, Cin) = dproj_src (rows, SC) W^T
    err = hsp::gemm<float, false, true>(dproj_src, SC, w, ldw, nullptr,
                                        static_cast<float*>(dfeat), rows, SC, Cin, 0, st);
    if (err != cudaSuccess) return (int)err;
    // dW (Cin, SC) = feat^T (Cin, rows) dproj_src (rows, SC), in row slices
    err = hsp::gemm<float, true>(static_cast<const float*>(feat), Cin, dproj_src, SC, nullptr,
                                 dw_partial, Cin, rows, SC, DW_KC, st);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)hs::sum_partials(dw_partial, dw, parts, Cin * SC, st);
}
