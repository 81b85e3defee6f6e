// HS support reduction of the training path (conv_1 .. conv_4) on
// pre-gathered features g = feat[idx], forward with stored winner values, and
// its backward.
//   P[k, sc]  = g[b, n, k, :] @ W[:, sc] + bias[sc] = P_src[idx[b, n, k], sc]
//   th[k, sc] = relu(rf[b, n, k] . dir_sc)
//   out (B, N, Co) = mean_s max_k th * P;  win, twin, pwin (B, N, S*Co) = the first
//   maximal k and th, P there
// Backward, from the stored winner values (gb = the cotangent of out / S):
//   dpi = [k == win] gb * twin,  du = [k == win][twin > 0] gb * pwin
//   dg = dpi @ W^T, drf = du @ dirs^T (per row);  dW = g^T dpi, db = sum dpi,
//   dd = rf^T du (over all rows).
//
// Replaces: hspose_tpu/ops/pallas_hs.py::_support_kernel with want_win and
// want_vals (K11) and ::_support_bwd_vals_kernel (K13), reached through
// hs_support_reduce(..., bwd_store=True), both branches: exact=True (fp32
// operands) and exact=False (the bf16 train step: bf16 g, rf and dirs,
// T = __nv_bfloat16, with W and b fp32).  Plain versions:
// hspose_tpu_torch/ops/cuda_hs.py::hs_support_fwd_plain and
// hs_support_bwd_plain.
//
// The bf16 branch makes the TPU kernel's one-pass roundings, and only those:
// every operand of a product is rounded to bf16 (W when it is staged, gb*twin
// and gb*pwin when they are staged), so each product of two operands is exact
// in fp32 and the sums are fp32, as a bf16 tensor-core product with fp32
// accumulation gives them; b is added in fp32 and db sums the unrounded
// gb*twin.  dg and drf are rounded to bf16 once, after their sums.
//
// What bounds the forward on an H100.  The rows g are a gather of the
// layer's feature map by the neighbour index (models/layers.py), so each
// gathered row's projection equals its source row's, bit for bit, when both
// are the same fused multiply-add chain: projecting the B*N source rows costs
// B*N*Cin*S*Co multiply-adds (5.7e9 over the four layers at B=16), K times
// fewer than projecting every gathered row (1.0e11, the kernel before this
// design); the (B, N, S*Co) winner values the forward writes (about 0.4 GB a
// step) are then as large a cost.  Forward, two launches:
// (i) P_src (B, N, S*Co) = feat @ W + b by hs_project.cuh's tile, on the CUDA
//     cores in both tiers: fp32, and in the bf16 tier bf16 features widened
//     exactly against W rounded to bf16 where it is staged, so each output is
//     the kernel-before-this's fmaf chain in increasing input channel from
//     0.f with the bias added after (a tensor-core product would sum in
//     another order, and the bf16 winner values are held to their bits);
// (ii) support_fwd_kernel gathers P_src by idx and reduces: one block per
//     (batch, query tile), each thread four adjacent columns as float4; the
//     rf row and neighbour index of a (query, k) are staged as one float4 in
//     shared memory and serve all four columns; K = 20 and 8 are unrolled so
//     that a support's K loads are in flight together.  Per column the
//     arithmetic is the replaced kernel's: theta from the same expression, the
//     winner rule k == 0 || v > m (the first maximal k; NaN compares as
//     K3's strict > from -FLT_MAX does not), the supports added in order,
//     then / S.
// g stays the autograd input (the backwards read it); the forward reads
// the source rows and the index beside it.
//
// The backward.  Each column has one winning row per query, so dg, dW and the
// recomputed P are sparse: B*N*S*Co*Cin multiply-adds each (1.9e9 at conv_1,
// B=16), K times fewer than the TPU kernel's dense products.  Every one of
// them takes one operand gathered by the winner (a row of W^T for dg, a
// winning g row for dW and P), and the fp32 bits fix the order of each sum,
// so no product is shared between lanes: the bound that holds is one
// shared-memory word per multiply-add, a quarter of the fp32 peak (an SM
// reads 32 words a clock and issues 128 fp32 multiply-adds).  The design
// keeps every gathered operand in shared memory, read without bank
// conflicts, and reads each input from L2 once per block:
// * Rows (dg, drf), support_bwd_rows_kernel: a warp per query, TQ queries and
//   128 input channels per block (a float4 per lane; Cin beyond 128 in more
//   blocks).  The block streams W in chunks of 32 columns, transposed
//   through registers into shared memory (the bf16 tier rounds it there), so
//   W is read from L2 once per TQ queries, not once per (query, column).
//   Each lane holds one column of the chunk (winner, gb*twin, gb*pwin); for
//   k = 0 .. K-1 a ballot finds the chunk's columns that k wins and the warp
//   walks them in column order, adding gb*twin[c] * W^T[c] into its k's
//   registers.  So no column is ranked ahead and no transpose launch is
//   needed.  In the first channel block, lane 3k' + d (k' = k mod 10) then
//   walks the columns each of its k's wins (the ballots kept in shared
//   memory) for drf[q, k, d], so the warp-wide walk carries no drf work.
// * Reduction (dW, db, dd), support_bwd_reduce_kernel: a block per (column
//   tile of at most 256, 128 input channels, 128-query chunk), a thread per
//   column holding its 128 dW sums in registers.  Each stage copies RED_QS
//   queries' K g rows (the block's channels; a warp per row) and their
//   winner values into shared memory by cp.async, double-buffered; the rows
//   lie at an odd word stride, so the lanes' different winners read
//   different banks.  Blocks that share a chunk run side by side, so g
//   comes from HBM about once.  The bf16 tier reads two channels a word.
//   Each block writes a row of partial sums and hs::sum_partials adds them
//   in chunk order.
//
// The fp32 bits of every cotangent are those of the kernels before this
// design (hspose_tpu_torch/tools/fp32_bits.py holds them), by keeping each
// sum's order and expression:
// * dg[q, k, i] = fmaf(gb*twin[c], W[i, c], acc) from 0.f over the columns c
//   that k wins, in increasing c; drf[q, k, d] = fmaf(gb*pwin[c] (gated),
//   dirs[d, c], acc) in the same order;
// * dW[i, c] = fmaf(gb*twin[q, c], g[q, win, i], acc), db[c] = acc + gb*twin
//   (unrounded in the bf16 tier) and dd[d, c] = fmaf(gb*pwin, rf[q, win, d],
//   acc), each from 0.f in increasing q within a chunk of RED_QC queries;
//   the chunks' partial sums are then added in chunk order from 0.f;
// * K14's P = fmaf(g[q, win, i], W[i, c], acc) from 0.f in increasing i,
//   then + b[c]; theta by the forward's expression.
// tests/test_torch_support_bwd_order.py models these orders against the
// replaced kernels' on tied inputs.
//
// bwd_store=False, both tiers: the forward without STORE writes win but not
// twin/pwin (K11's no-values launch), and the recompute backward
// (hs_support_bwd_recompute, K14) replaces hspose_tpu/ops/pallas_hs.py::
// _support_bwd_kernel (:240, exact=True and exact=False): recompute_kernel<T>
// forms theta and P at the recorded winners with the forward's arithmetic (W
// rounded to bf16 in the bf16 tier) into scratch twin/pwin, and the
// stored-values backward's kernels above route the cotangents from them.  So
// K14 gives K13's cotangents, bit for bit, from the same inputs.  Plain
// version: hspose_tpu_torch/ops/cuda_hs.py::hs_support_bwd_recompute_plain.
// recompute_kernel: a thread per column of a tile of at most 256, RC_TQ
// queries per block; per stage of RC_CH channels the queries' K g rows (odd
// word stride again, so the lanes' different winners read different banks)
// and the W chunk (16-byte copies where W's rows allow) are copied in by
// cp.async, double-buffered; each W value read feeds RC_TQ multiply-adds.
// 16-channel stages keep a block's shared memory small enough for two
// blocks per SM.
//
// Launches per call: K11 two (projection, reduction), K13 three (rows,
// reduction, sum_partials), K14 four.
#include <algorithm>

#include "hs_project.cuh"

namespace {

constexpr int FWD_THREADS = 128;  // threads per reduction block of the forward
constexpr int ROWS_CS = 128;     // input channels per rows block: a float4 per lane
constexpr int ROWS_CC = 32;      // columns per staged W^T chunk: one per lane
constexpr int ROWS_WS = ROWS_CS + 4;  // row stride (floats) of the staged W^T chunk
constexpr int ROWS_DS = ROWS_CC + 1;  // row stride (floats) of the staged directions
constexpr int RED_QC = 128;      // queries per partial sum: part of the association of dW, db, dd
constexpr int RED_QS = 4;        // queries per stage of the reduction kernel
constexpr int RED_CS = 128;      // input channels per reduction block
constexpr int RED_CT = 256;      // most columns (threads) per reduction block
constexpr int RC_TQ = 16;        // queries per recompute block
constexpr int RC_CH = 16;        // input channels per stage of the recompute kernel
constexpr int RC_CT = 256;       // most columns (threads) per recompute block

// The forward's reduction over the projected source rows:
// out[q, c] = mean_s max_k relu(rf[q, k] . d_{s,c}) * P_src[idx[q, k], s*Co + c],
// with win (and, STORE, twin, pwin) at the first maximal k.  One block per
// (batch, TQ-query tile), FWD_THREADS threads; each thread owns four adjacent
// columns c4 * 4 .. + 3 and the queries t = ql, ql + QPB, ... of the tile
// (QPB = FWD_THREADS / min(Co / 4, FWD_THREADS) queries side by side).  The
// tile's rf rows (in T, read as fp32) and neighbour indices are staged as
// float4 (rf, index bits); per (query, support) a thread reads its twelve
// directions once, then for each k one float4 of rf and index and one
// float4 of P_src.  KT = 0 reads K at run time.  Needs Co % 4 == 0 and
// proj, out, win, twin, pwin 16-byte aligned.
template <typename T, bool STORE, int KT>
__global__ void __launch_bounds__(FWD_THREADS)
support_fwd_kernel(const float* __restrict__ proj, const T* __restrict__ rf,
                   const int* __restrict__ idx, const T* __restrict__ dirs,
                   float* __restrict__ out, int* __restrict__ win, float* __restrict__ twin,
                   float* __restrict__ pwin, int N, int K_arg, int S, int Co, int TQ) {
  extern __shared__ __align__(16) float4 srf4[];  // (TQ, K): rf, index bits
  const int K = KT ? KT : K_arg;
  const int SC = S * Co, C4 = Co / 4;
  const int b = blockIdx.y, q0 = blockIdx.x * TQ;
  const int tq = min(TQ, N - q0);
  for (int e = threadIdx.x; e < TQ * K; e += blockDim.x) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e / K < tq) {
      const size_t at = ((size_t)b * N + q0) * K + e;
      const T* r = rf + at * 3;
      v = make_float4(hs::load_f(r), hs::load_f(r + 1), hs::load_f(r + 2),
                      __int_as_float(idx[at]));
    }
    srf4[e] = v;
  }
  __syncthreads();

  const int lanes_c = min(C4, FWD_THREADS), QPB = FWD_THREADS / lanes_c;
  const int ql = threadIdx.x / lanes_c;
  if (ql >= QPB) return;
  const float* Pb = proj + (size_t)b * N * SC;
  for (int c4 = threadIdx.x % lanes_c; c4 < C4; c4 += lanes_c) {
    for (int t = ql; t < tq; t += QPB) {
      const size_t row = (size_t)b * N + q0 + t;
      float total[4] = {0.f, 0.f, 0.f, 0.f};
      for (int s = 0; s < S; ++s) {
        const int col = s * Co + c4 * 4;
        float d0[4], d1[4], d2[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          d0[c] = hs::load_f(dirs + col + c);
          d1[c] = hs::load_f(dirs + SC + col + c);
          d2[c] = hs::load_f(dirs + 2 * SC + col + c);
        }
        float m[4] = {0.f, 0.f, 0.f, 0.f}, tw[4] = {0.f, 0.f, 0.f, 0.f},
              pw[4] = {0.f, 0.f, 0.f, 0.f};
        int kb[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float4 r = srf4[t * K + j];
          const float4 p4 =
              __ldg(reinterpret_cast<const float4*>(Pb + (size_t)__float_as_int(r.w) * SC + col));
          const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float th = fmaxf(r.x * d0[c] + r.y * d1[c] + r.z * d2[c], 0.f);
            const float v = th * p[c];
            if (j == 0 || v > m[c]) {
              m[c] = v;
              kb[c] = j;
              tw[c] = th;
              pw[c] = p[c];
            }
          }
        }
        *reinterpret_cast<int4*>(win + row * SC + col) = make_int4(kb[0], kb[1], kb[2], kb[3]);
        if constexpr (STORE) {
          *reinterpret_cast<float4*>(twin + row * SC + col) = make_float4(tw[0], tw[1], tw[2], tw[3]);
          *reinterpret_cast<float4*>(pwin + row * SC + col) = make_float4(pw[0], pw[1], pw[2], pw[3]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) total[c] += m[c];
      }
      *reinterpret_cast<float4*>(out + row * Co + c4 * 4) =
          make_float4(total[0] / S, total[1] / S, total[2] / S, total[3] / S);
    }
  }
}

// Threads of a column tile: S*Co split into as few tiles of at most `most`
// columns as will do, each a whole number of warps.
inline int column_tile(int SC, int most) {
  const int tiles = (SC + most - 1) / most;
  return ((SC + tiles - 1) / tiles + 31) / 32 * 32;
}

// Four consecutive values into fp32 storage, or rounded (to nearest even)
// into bf16 storage; p lies on a 4-element boundary.
__device__ __forceinline__ void store4(float* p, const float* a) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* a) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]), hi = __floats2bfloat162_rn(a[2], a[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                            *reinterpret_cast<const unsigned*>(&hi));
}

// Queries (warps) per rows block: KP = 32 holds 128 sums a lane.
template <int KP>
__host__ __device__ constexpr int rows_tq() { return KP > 20 ? 8 : 16; }

// Element e of a staged W chunk (ROWS_CS channel rows x ROWS_CC/4 column
// groups of four): the lanes of a warp cover 16 rows x 2 groups, so that
// their loads fill 32-byte sectors and their transposed stores fall on 32
// different banks (ROWS_WS = 4 mod 32).
__device__ __forceinline__ void w_elem(int e, int& i, int& c4) {
  const int l = e % 32, wp = e / 32;
  i = (wp % 8) * 16 + l % 16;
  c4 = (wp / 8) * 2 + l / 16;
}

// dg and drf.  Block: TQ warps, one query each, and ROWS_CS input channels
// (blockIdx.y), lane l holding channels 4l..4l+3 and the sums of every k in
// registers.  Per chunk of ROWS_CC columns: W^T[c, channels] and the
// directions are staged (double-buffered through registers), lane j holds
// column j's winner, gb*twin and gated gb*pwin, and for each k in order a
// ballot gives the columns k wins, walked in column order.  The bf16 tier
// rounds W, gb*twin and gb*pwin to bf16 (the products' operands) and writes
// dg and drf rounded to bf16 once.
template <int KP, typename T>
__global__ void __launch_bounds__(rows_tq<KP>() * 32, 1)
support_bwd_rows_kernel(const float* __restrict__ w, int ldw, const T* __restrict__ dirs,
                        const int* __restrict__ win, const float* __restrict__ twin,
                        const float* __restrict__ pwin, const float* __restrict__ gb,
                        T* __restrict__ dg, T* __restrict__ drf, int rows, int K, int Cin,
                        int S, int Co) {
  constexpr bool FAST = hs::is_bf16<T>;
  constexpr int TQ = rows_tq<KP>(), NT = TQ * 32;
  constexpr int NW = ROWS_CS * ROWS_CC / 4 / NT;  // float4s of W each thread stages per chunk
  constexpr int NR = (KP + 9) / 10;               // drf sums per lane
  constexpr unsigned ALL = 0xffffffffu;
  __shared__ __align__(16) float sw[2][ROWS_CC * ROWS_WS];  // W^T chunk: (column, channel)
  __shared__ float sd[2][3 * ROWS_DS];                      // directions of the chunk's columns
  __shared__ float su_[TQ][ROWS_CC];      // per warp: the chunk's gated gb*pwin, for drf
  __shared__ unsigned sm_[TQ][32];        // per warp: the chunk's columns that each k wins
  const int SC = S * Co, lane = threadIdx.x % 32;
  const int i0 = blockIdx.y * ROWS_CS;
  const size_t q = (size_t)blockIdx.x * TQ + threadIdx.x / 32;
  const bool live = q < (size_t)rows, with_rf = blockIdx.y == 0;
  const int rk = lane < 30 ? lane / 3 : -1, rd = lane % 3;  // drf[q, rk + 10 s, rd] of this lane
  const bool w_vec = hs::aligned16(w) && ldw % 4 == 0;

  float4 wr[NW];
  float dr = 0.f, twn = 0.f, pwn = 0.f, gbn = 0.f;
  int kn = -1;
  // the chunk at column c0 into registers: W, directions, this lane's winner values
  auto fetch = [&](int c0) {
#pragma unroll
    for (int r = 0; r < NW; ++r) {
      int i, c4;
      w_elem(threadIdx.x + r * NT, i, c4);
      const int row = i0 + i, col = c0 + c4 * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < Cin && col < SC) {
        const float* p = w + (size_t)row * ldw + col;
        v = w_vec ? *reinterpret_cast<const float4*>(p) : make_float4(p[0], p[1], p[2], p[3]);
      }
      wr[r] = v;
    }
    if (threadIdx.x < 3 * ROWS_CC) {
      const int col = c0 + threadIdx.x % ROWS_CC;
      dr = col < SC ? hs::load_f(dirs + (threadIdx.x / ROWS_CC) * SC + col) : 0.f;
    }
    const int col = c0 + lane;
    kn = -1;
    if (live && col < SC) {
      const size_t at = q * SC + col;
      kn = win[at];
      twn = twin[at];
      pwn = pwin[at];
      gbn = gb[q * Co + col % Co];
    }
  };
  // the registers into shared buffer buf, W transposed
  auto stage = [&](int buf) {
#pragma unroll
    for (int r = 0; r < NW; ++r) {
      int i, c4;
      w_elem(threadIdx.x + r * NT, i, c4);
      float* s = sw[buf] + c4 * 4 * ROWS_WS + i;
      const float v[4] = {wr[r].x, wr[r].y, wr[r].z, wr[r].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j * ROWS_WS] = FAST ? hs::bf16_round(v[j]) : v[j];
    }
    if (threadIdx.x < 3 * ROWS_CC)
      sd[buf][(threadIdx.x / ROWS_CC) * ROWS_DS + threadIdx.x % ROWS_CC] = dr;
  };

  float acc[KP][4], racc[NR];
#pragma unroll
  for (int k = 0; k < KP; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;
#pragma unroll
  for (int s = 0; s < NR; ++s) racc[s] = 0.f;

  const int chunks = (SC + ROWS_CC - 1) / ROWS_CC;
  fetch(0);
  stage(0);
  __syncthreads();
  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch & 1;
    const int kl = kn;
    const float gs = hs::div_s<FAST>(gbn, S);
    float vl = gs * twn, ul = twn > 0.f ? gs * pwn : 0.f;
    if constexpr (FAST) {
      vl = hs::bf16_round(vl);
      ul = hs::bf16_round(ul);
    }
    if (ch + 1 < chunks) fetch((ch + 1) * ROWS_CC);
    if (live) {
      const float* wrow = sw[buf] + 4 * lane;
      const float* drow = sd[buf] + rd * ROWS_DS;
      float* su = su_[threadIdx.x / 32];
      unsigned* smask = sm_[threadIdx.x / 32];
      if (with_rf) su[lane] = ul;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        if (k < K) {
          unsigned m = __ballot_sync(ALL, kl == k);
          if (with_rf && lane == 0) smask[k] = m;
          while (m) {
            const int j = __ffs(m) - 1;
            m &= m - 1;
            const float v = __shfl_sync(ALL, vl, j);
            const float4 w4 = *reinterpret_cast<const float4*>(wrow + j * ROWS_WS);
            acc[k][0] = fmaf(v, w4.x, acc[k][0]);
            acc[k][1] = fmaf(v, w4.y, acc[k][1]);
            acc[k][2] = fmaf(v, w4.z, acc[k][2]);
            acc[k][3] = fmaf(v, w4.w, acc[k][3]);
          }
        }
      }
      if (with_rf) {  // drf apart from the warp-wide walk: each lane walks its own k's columns
        __syncwarp();
#pragma unroll
        for (int s = 0; s < NR; ++s) {
          const int k = rk + 10 * s;
          if (rk >= 0 && k < K) {
            unsigned m = smask[k];
            while (m) {
              const int j = __ffs(m) - 1;
              m &= m - 1;
              racc[s] = fmaf(su[j], drow[j], racc[s]);
            }
          }
        }
      }
    }
    if (ch + 1 < chunks) stage(buf ^ 1);
    __syncthreads();
  }
  if (!live) return;
  if (i0 + 4 * lane < Cin) {
    T* out = dg + q * K * Cin + i0 + 4 * lane;
#pragma unroll
    for (int k = 0; k < KP; ++k)
      if (k < K) store4(out + (size_t)k * Cin, acc[k]);
  }
  if (with_rf && rk >= 0) {
#pragma unroll
    for (int s = 0; s < NR; ++s) {
      const int k = rk + 10 * s;
      if (k < K) hs::store_f(drf + (q * K + k) * 3 + rd, racc[s]);
    }
  }
}

// 4-byte words per staged row of n channels of T, plus one so that the
// stride is odd and rows of different k start on different banks.
template <typename T>
__host__ __device__ constexpr int row_words(int n) { return n / (hs::is_bf16<T> ? 2 : 1) + 1; }

// Channel pair (2w, 2w + 1) of a staged bf16 row word, as fp32.
__device__ __forceinline__ float bf16_lo(unsigned x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(unsigned x) { return __uint_as_float(x & 0xffff0000u); }

// Copy N channels (from channel ch0 on) of each of the nrow rows of g that
// follow row0 into shared words st (row stride `stride` words), zeros past
// nvalid rows or Cin channels, by 4-byte cp.async: a warp copies whole rows
// (32 / (words per row) rows at a time where rows are shorter than a warp),
// so each copy's addresses are a row base and the lane.
template <int N, typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ g, unsigned* st, size_t row0,
                                           int nrow, int nvalid, int ch0, int stride, int Cin) {
  constexpr int EPW = hs::is_bf16<T> ? 2 : 1;
  constexpr int NW = N / EPW;                 // words per row
  constexpr int LPR = NW < 32 ? NW : 32;      // lanes per row
  constexpr int RPW = 32 / LPR;               // rows per warp step
  constexpr int WPL = (NW + LPR - 1) / LPR;   // words per lane
  const int lane = threadIdx.x % 32, sub = lane / LPR, l = lane % LPR;
  const int step = (blockDim.x / 32) * RPW;
  for (int row = (threadIdx.x / 32) * RPW + sub; row < nrow; row += step) {
    const T* src = g + (row0 + row) * Cin + ch0;
    unsigned* dst = st + row * stride;
    const bool rv = row < nvalid;
#pragma unroll
    for (int u = 0; u < WPL; ++u) {
      const int wd = l + LPR * u;
      const bool ok = rv && ch0 + wd * EPW < Cin;
      hs::cp_async4(dst + wd, ok ? src + wd * EPW : g, ok);
    }
  }
}

// dW, db, dd.  Block: one column per thread (a tile of blockDim.x columns,
// blockIdx.x), RED_CS input channels (blockIdx.y) and one chunk of RED_QC
// queries (blockIdx.z), whose sums go to its own row of partial.  Per stage
// RED_QS queries' K g rows and winner values are copied in by cp.async,
// double-buffered.  The bf16 tier's dW and dd take the bf16-rounded gb*twin
// and gb*pwin, and db the unrounded gb*twin.
template <typename T>
__global__ void __launch_bounds__(RED_CT, 1)
support_bwd_reduce_kernel(const T* __restrict__ g, const T* __restrict__ rf,
                          const int* __restrict__ win, const float* __restrict__ twin,
                          const float* __restrict__ pwin, const float* __restrict__ gb,
                          float* __restrict__ partial, int rows, int K, int Cin, int S,
                          int Co) {
  constexpr bool FAST = hs::is_bf16<T>;
  constexpr int GW = row_words<T>(RED_CS);
  extern __shared__ __align__(16) unsigned smem_w[];
  const int SC = S * Co, CT = blockDim.x, tid = threadIdx.x;
  const int c = blockIdx.x * CT + tid;
  const int i0 = blockIdx.y * RED_CS;
  const int qa = blockIdx.z * RED_QC, qb = min(rows, qa + RED_QC);
  const bool with_rf = blockIdx.y == 0;
  // a stage: the g rows (RED_QS * K, GW), then win, twin, pwin, gb (RED_QS, CT) each
  const int gwords = RED_QS * K * GW, stage_words = gwords + 4 * RED_QS * CT;

  auto issue = [&](int q0, int buf) {
    unsigned* st = smem_w + buf * stage_words;
    stage_rows<RED_CS>(g, st, (size_t)q0 * K, RED_QS * K, (qb - q0) * K, i0, GW, Cin);
    unsigned* sv = st + gwords;
    for (int t = 0; t < RED_QS; ++t) {
      const bool ok = q0 + t < qb && c < SC;
      const size_t at = (size_t)(q0 + t) * SC + c;
      hs::cp_async4(sv + t * CT + tid, ok ? win + at : win, ok);
      hs::cp_async4(sv + (RED_QS + t) * CT + tid, ok ? twin + at : twin, ok);
      hs::cp_async4(sv + (2 * RED_QS + t) * CT + tid, ok ? pwin + at : pwin, ok);
      hs::cp_async4(sv + (3 * RED_QS + t) * CT + tid,
                    ok ? gb + (size_t)(q0 + t) * Co + c % Co : gb, ok);
    }
    hs::cp_async_commit();
  };

  float acc[RED_CS];
#pragma unroll
  for (int j = 0; j < RED_CS; ++j) acc[j] = 0.f;
  float db = 0.f, dd0 = 0.f, dd1 = 0.f, dd2 = 0.f;
  const int stages = (qb - qa + RED_QS - 1) / RED_QS;
  issue(qa, 0);
  for (int s = 0; s < stages; ++s) {
    hs::cp_async_wait<0>();
    __syncthreads();  // stage s has landed, and stage s - 1's buffer is no longer read
    if (s + 1 < stages) issue(qa + (s + 1) * RED_QS, (s + 1) & 1);
    const unsigned* st = smem_w + (s & 1) * stage_words;
    const unsigned* sv = st + gwords;
    const int q0 = qa + s * RED_QS, nq = min(RED_QS, qb - q0);
    for (int t = 0; t < nq; ++t) {
      const int k = (int)sv[t * CT + tid];
      const float tw = __uint_as_float(sv[(RED_QS + t) * CT + tid]);
      const float gs = hs::div_s<FAST>(__uint_as_float(sv[(3 * RED_QS + t) * CT + tid]), S);
      const float v = gs * tw;
      const float u = tw > 0.f ? gs * __uint_as_float(sv[(2 * RED_QS + t) * CT + tid]) : 0.f;
      const float vo = FAST ? hs::bf16_round(v) : v, uo = FAST ? hs::bf16_round(u) : u;
      float r0 = 0.f, r1 = 0.f, r2 = 0.f;
      if (with_rf) {
        const T* r = rf + ((size_t)(q0 + t) * K + k) * 3;
        r0 = hs::load_f(r);
        r1 = hs::load_f(r + 1);
        r2 = hs::load_f(r + 2);
      }
      const unsigned* row = st + (t * K + k) * GW;
      if constexpr (FAST) {
#pragma unroll
        for (int wd = 0; wd < RED_CS / 2; ++wd) {
          const unsigned x = row[wd];
          acc[2 * wd] = fmaf(vo, bf16_lo(x), acc[2 * wd]);
          acc[2 * wd + 1] = fmaf(vo, bf16_hi(x), acc[2 * wd + 1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < RED_CS; ++j) acc[j] = fmaf(vo, __uint_as_float(row[j]), acc[j]);
      }
      if (with_rf) {
        db += v;
        dd0 = fmaf(uo, r0, dd0);
        dd1 = fmaf(uo, r1, dd1);
        dd2 = fmaf(uo, r2, dd2);
      }
    }
  }
  if (c >= SC) return;
  float* part = partial + (size_t)blockIdx.z * (Cin + 4) * SC + c;
#pragma unroll
  for (int j = 0; j < RED_CS; ++j)
    if (i0 + j < Cin) part[(size_t)(i0 + j) * SC] = acc[j];
  if (with_rf) {
    part[(size_t)Cin * SC] = db;
    part[(size_t)(Cin + 1) * SC] = dd0;
    part[(size_t)(Cin + 2) * SC] = dd1;
    part[(size_t)(Cin + 3) * SC] = dd2;
  }
}

// twin, pwin (rows, S*Co) at the recorded winners, with the forward's
// arithmetic: P = fmaf over i in order of g[q, k, i] * W[i, col], then + b[col];
// theta = relu(rf[q, k] . d[:, col]) by support_fwd_kernel's expression.  The
// bf16 tier (T = __nv_bfloat16) rounds W to bf16 as the forward stages it,
// so each product is exact and P has the forward's bits.
// Block: one column per thread (a tile of blockDim.x columns, blockIdx.x) and
// RC_TQ queries (blockIdx.y); per stage of RC_CH channels the queries' K g
// rows and the W chunk (RC_CH, columns) are copied in by cp.async,
// double-buffered.
template <typename T>
__global__ void __launch_bounds__(RC_CT)
recompute_kernel(const T* __restrict__ g, const T* __restrict__ rf,
                 const float* __restrict__ w, int ldw, const float* __restrict__ bias,
                 const T* __restrict__ dirs, const int* __restrict__ win,
                 float* __restrict__ twin, float* __restrict__ pwin, int rows, int K, int Cin,
                 int S, int Co) {
  constexpr bool FAST = hs::is_bf16<T>;
  constexpr int GW = row_words<T>(RC_CH);
  extern __shared__ __align__(16) unsigned smem_w[];
  const int SC = S * Co, CT = blockDim.x, tid = threadIdx.x;
  const int col = blockIdx.x * CT + tid;
  const int q0 = blockIdx.y * RC_TQ, tq = min(RC_TQ, rows - q0);
  // a stage: the g rows (RC_TQ * K, GW), then W (RC_CH, CT)
  const int gwords = RC_TQ * K * GW, stage_words = gwords + RC_CH * CT;
  const bool w_vec = hs::aligned16(w) && ldw % 4 == 0;
  int kk[RC_TQ];
#pragma unroll
  for (int t = 0; t < RC_TQ; ++t)
    kk[t] = (col < SC && t < tq) ? win[(size_t)(q0 + t) * SC + col] : 0;

  auto issue = [&](int ic, int buf) {
    unsigned* st = smem_w + buf * stage_words;
    stage_rows<RC_CH>(g, st, (size_t)q0 * K, RC_TQ * K, tq * K, ic, GW, Cin);
    unsigned* sw = st + gwords;
    if (w_vec) {
      const int c4s = CT / 4;
      for (int e = tid; e < RC_CH * c4s; e += CT) {
        const int i = ic + e / c4s, c = blockIdx.x * CT + (e % c4s) * 4;
        const bool ok = i < Cin && c < SC;
        hs::cp_async16(sw + (e / c4s) * CT + (e % c4s) * 4, ok ? w + (size_t)i * ldw + c : w, ok);
      }
    } else {
      for (int e = tid; e < RC_CH * CT; e += CT) {
        const int i = ic + e / CT, c = blockIdx.x * CT + e % CT;
        const bool ok = i < Cin && c < SC;
        hs::cp_async4(sw + e, ok ? w + (size_t)i * ldw + c : w, ok);
      }
    }
    hs::cp_async_commit();
  };

  float acc[RC_TQ];
#pragma unroll
  for (int t = 0; t < RC_TQ; ++t) acc[t] = 0.f;
  const int stages = (Cin + RC_CH - 1) / RC_CH;
  issue(0, 0);
  for (int s = 0; s < stages; ++s) {
    hs::cp_async_wait<0>();
    __syncthreads();  // stage s has landed, and stage s - 1's buffer is no longer read
    if (s + 1 < stages) issue((s + 1) * RC_CH, (s + 1) & 1);
    const unsigned* st = smem_w + (s & 1) * stage_words;
    const float* sw = reinterpret_cast<const float*>(st + gwords) + tid;
    const int nch = min(RC_CH, Cin - s * RC_CH);  // a multiple of 4
    if constexpr (FAST) {
#pragma unroll
      for (int wd = 0; wd < RC_CH / 2; ++wd) {
        if (2 * wd < nch) {
          const float w0 = hs::bf16_round(sw[2 * wd * CT]), w1 = hs::bf16_round(sw[(2 * wd + 1) * CT]);
#pragma unroll
          for (int t = 0; t < RC_TQ; ++t) {
            const unsigned x = st[(t * K + kk[t]) * GW + wd];
            acc[t] = fmaf(bf16_lo(x), w0, acc[t]);
            acc[t] = fmaf(bf16_hi(x), w1, acc[t]);
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < RC_CH; ++i) {
        if (i < nch) {
          const float wv = sw[i * CT];
#pragma unroll
          for (int t = 0; t < RC_TQ; ++t)
            acc[t] = fmaf(__uint_as_float(st[(t * K + kk[t]) * GW + i]), wv, acc[t]);
        }
      }
    }
  }
  if (col >= SC) return;
  const float d0 = hs::load_f(dirs + col), d1 = hs::load_f(dirs + SC + col),
              d2 = hs::load_f(dirs + 2 * SC + col);
  const float bb = bias[col];
#pragma unroll
  for (int t = 0; t < RC_TQ; ++t) {
    if (t >= tq) break;
    const size_t at = (size_t)(q0 + t) * SC + col;
    const T* rq = rf + ((size_t)(q0 + t) * K + kk[t]) * 3;
    const float r[3] = {hs::load_f(rq), hs::load_f(rq + 1), hs::load_f(rq + 2)};
    const float th = fmaxf(r[0] * d0 + r[1] * d1 + r[2] * d2, 0.f);
    twin[at] = th;
    pwin[at] = acc[t] + bb;
  }
}

template <typename T, bool STORE, int KT>
cudaError_t launch_reduce(const float* proj, const void* rf, const int* idx, const void* dirs,
                          float* out, int* win, float* twin, float* pwin, int B, int N, int K,
                          int S, int Co, cudaStream_t st) {
  // two queries per thread and column group
  const int TQ = 2 * (FWD_THREADS / std::min(Co / 4, FWD_THREADS));
  const size_t smem = sizeof(float4) * (size_t)TQ * K;
  auto kernel = support_fwd_kernel<T, STORE, KT>;
  cudaError_t err = hs::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((N + TQ - 1) / TQ, B), FWD_THREADS, smem, st>>>(
      proj, static_cast<const T*>(rf), idx, static_cast<const T*>(dirs), out, win, twin, pwin, N,
      K, S, Co, TQ);
  return cudaGetLastError();
}

// The forward: P_src = feat @ W + b into proj (B, N, S*Co), then the
// reduction (K = 20 and 8 unrolled, the rest at run time).
template <typename T, bool STORE = true>
cudaError_t launch_fwd(const void* feat, const int* idx, const void* rf, const float* w, int ldw,
                       const float* b, const void* dirs, float* proj, float* out, int* win,
                       float* twin, float* pwin, int B, int N, int K, int Cin, int S, int Co,
                       cudaStream_t st) {
  if (!hs::aligned16(proj) || !hs::aligned16(out) || !hs::aligned16(win) ||
      (STORE && (!hs::aligned16(twin) || !hs::aligned16(pwin))))
    return cudaErrorInvalidValue;
  const int SC = S * Co;
  cudaError_t err = hsp::gemm<T, false, false, hs::is_bf16<T>>(
      static_cast<const T*>(feat), Cin, w, ldw, b, proj, B * N, Cin, SC, 0, st);
  if (err != cudaSuccess) return err;
  switch (K) {
    case 20: return launch_reduce<T, STORE, 20>(proj, rf, idx, dirs, out, win, twin, pwin, B, N,
                                                K, S, Co, st);
    case 8: return launch_reduce<T, STORE, 8>(proj, rf, idx, dirs, out, win, twin, pwin, B, N, K,
                                              S, Co, st);
    default: return launch_reduce<T, STORE, 0>(proj, rf, idx, dirs, out, win, twin, pwin, B, N,
                                               K, S, Co, st);
  }
}

template <int KP, typename T>
cudaError_t launch_rows(const float* w, int ldw, const void* dirs, const int* win,
                        const float* twin, const float* pwin, const float* gb, void* dg,
                        void* drf, int rows, int K, int Cin, int S, int Co, cudaStream_t st) {
  constexpr int TQ = rows_tq<KP>();
  support_bwd_rows_kernel<KP, T><<<dim3((rows + TQ - 1) / TQ, (Cin + ROWS_CS - 1) / ROWS_CS),
                                   TQ * 32, 0, st>>>(
      w, ldw, static_cast<const T*>(dirs), win, twin, pwin, gb, static_cast<T*>(dg),
      static_cast<T*>(drf), rows, K, Cin, S, Co);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* rf, const float* w, int ldw, const void* dirs,
                       const int* win, const float* twin, const float* pwin, const float* gb,
                       void* dg, void* drf, float* partial, float* red, int B, int N, int K,
                       int Cin, int S, int Co, cudaStream_t st) {
  const int SC = S * Co, rows = B * N;
  cudaError_t err =
      K <= 8    ? launch_rows<8, T>(w, ldw, dirs, win, twin, pwin, gb, dg, drf, rows, K, Cin, S, Co, st)
      : K <= 20 ? launch_rows<20, T>(w, ldw, dirs, win, twin, pwin, gb, dg, drf, rows, K, Cin, S, Co, st)
                : launch_rows<32, T>(w, ldw, dirs, win, twin, pwin, gb, dg, drf, rows, K, Cin, S, Co, st);
  if (err != cudaSuccess) return err;

  const int ct = column_tile(SC, RED_CT), parts = (rows + RED_QC - 1) / RED_QC;
  const size_t smem =
      2 * sizeof(unsigned) * ((size_t)RED_QS * K * row_words<T>(RED_CS) + 4 * RED_QS * ct);
  err = hs::allow_smem(support_bwd_reduce_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  support_bwd_reduce_kernel<T><<<dim3((SC + ct - 1) / ct, (Cin + RED_CS - 1) / RED_CS, parts), ct,
                                 smem, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(rf), win, twin, pwin, gb, partial, rows, K,
      Cin, S, Co);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return hs::sum_partials(partial, red, parts, (Cin + 4) * SC, st);
}

template <typename T>
cudaError_t launch_recompute(const void* g, const void* rf, const float* w, int ldw,
                             const float* b, const void* dirs, const int* win, const float* gb,
                             float* twin, float* pwin, void* dg, void* drf, float* partial,
                             float* red, int B, int N, int K, int Cin, int S, int Co,
                             cudaStream_t st) {
  const int SC = S * Co, rows = B * N, ct = column_tile(SC, RC_CT);
  const size_t smem = 2 * sizeof(unsigned) * ((size_t)RC_TQ * K * row_words<T>(RC_CH) + RC_CH * ct);
  cudaError_t err = hs::allow_smem(recompute_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  recompute_kernel<T><<<dim3((SC + ct - 1) / ct, (rows + RC_TQ - 1) / RC_TQ), ct, smem, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(rf), w, ldw, b,
      static_cast<const T*>(dirs), win, twin, pwin, rows, K, Cin, S, Co);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_bwd<T>(g, rf, w, ldw, dirs, win, twin, pwin, gb, dg, drf, partial, red, B, N, K,
                       Cin, S, Co, st);
}

}  // namespace

// The wrapper's checks, in one place: 0 when the kernels take these sizes
// (K <= 32; Cin and Co multiples of 4), else 1.
extern "C" int hs_support_train_supported(int K, int Cin, int Co) {
  return (K < 1 || K > 32 || Cin % 4 != 0 || Co % 4 != 0) ? 1 : 0;
}

// Chunks of the reduction kernel: the partial-sum scratch is
// (hs_support_bwd_parts(B * N), Cin + 4, S*Co).
extern "C" int hs_support_bwd_parts(int rows) { return (rows + RED_QC - 1) / RED_QC; }

// feat (B, N, Cin), rf (B, N, K, 3), dirs (3, S*Co), fp32 or (fast != 0) bf16;
// idx (B, N, K) int32 in [0, N), the rows of feat that g gathers; w (Cin,
// S*Co; row stride ldw), b (S*Co) fp32; scratch proj (B, N, S*Co) fp32 ->
// out (B, N, Co), win (B, N, S*Co) int32, twin, pwin (B, N, S*Co), fp32.
extern "C" int hs_support_fwd(const void* feat, const int* idx, const void* rf, const float* w,
                              int ldw, const float* b, const void* dirs, float* proj, float* out,
                              int* win, float* twin, float* pwin, int B, int N, int K, int Cin,
                              int S, int Co, int fast, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hs_support_train_supported(K, Cin, Co)) return (int)cudaErrorInvalidValue;
  return (int)(fast ? launch_fwd<__nv_bfloat16>(feat, idx, rf, w, ldw, b, dirs, proj, out, win,
                                                twin, pwin, B, N, K, Cin, S, Co, st)
                    : launch_fwd<float>(feat, idx, rf, w, ldw, b, dirs, proj, out, win, twin,
                                        pwin, B, N, K, Cin, S, Co, st));
}

// bwd_store=False: as hs_support_fwd, writing out and win only.
extern "C" int hs_support_fwd_win(const void* feat, const int* idx, const void* rf,
                                  const float* w, int ldw, const float* b, const void* dirs,
                                  float* proj, float* out, int* win, int B, int N, int K, int Cin,
                                  int S, int Co, int fast, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hs_support_train_supported(K, Cin, Co)) return (int)cudaErrorInvalidValue;
  return (int)(fast ? launch_fwd<__nv_bfloat16, false>(feat, idx, rf, w, ldw, b, dirs, proj, out,
                                                       win, nullptr, nullptr, B, N, K, Cin, S,
                                                       Co, st)
                    : launch_fwd<float, false>(feat, idx, rf, w, ldw, b, dirs, proj, out, win,
                                               nullptr, nullptr, B, N, K, Cin, S, Co, st));
}

// K14: g (B, N, K, Cin), rf (B, N, K, 3), dirs (3, S*Co), fp32 or (fast != 0) bf16;
// w (Cin, S*Co; row stride ldw), b (S*Co), win (B, N, S*Co), gb (B, N, Co); scratch
// twin, pwin (B, N, S*Co) and partial (hs_support_bwd_parts(B * N), Cin + 4, S*Co)
// -> dg, drf (in g's type) and red = [dW; db; dd] as hs_support_bwd.
extern "C" int hs_support_bwd_recompute(const void* g, const void* rf, const float* w, int ldw,
                                        const float* b, const void* dirs, const int* win,
                                        const float* gb, float* twin, float* pwin, void* dg,
                                        void* drf, float* partial, float* red, int B, int N,
                                        int K, int Cin, int S, int Co, int fast, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hs_support_train_supported(K, Cin, Co)) return (int)cudaErrorInvalidValue;
  return (int)(fast ? launch_recompute<__nv_bfloat16>(g, rf, w, ldw, b, dirs, win, gb, twin,
                                                      pwin, dg, drf, partial, red, B, N, K, Cin,
                                                      S, Co, st)
                    : launch_recompute<float>(g, rf, w, ldw, b, dirs, win, gb, twin, pwin, dg,
                                              drf, partial, red, B, N, K, Cin, S, Co, st));
}

// g (B, N, K, Cin), rf (B, N, K, 3), dirs (3, S*Co), fp32 or (fast != 0) bf16;
// w (Cin, S*Co; row stride ldw), win/twin/pwin (B, N, S*Co), gb (B, N, Co), scratch
// partial (hs_support_bwd_parts(B * N), Cin + 4, S*Co) -> dg (B, N, K, Cin) and drf
// (B, N, K, 3) in g's type, red (Cin + 4, S*Co) = [dW; db; dd] fp32.
extern "C" int hs_support_bwd(const void* g, const void* rf, const float* w, int ldw,
                              const void* dirs, const int* win, const float* twin,
                              const float* pwin, const float* gb, void* dg, void* drf,
                              float* partial, float* red, int B, int N, int K, int Cin, int S,
                              int Co, int fast, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hs_support_train_supported(K, Cin, Co)) return (int)cudaErrorInvalidValue;
  return (int)(fast ? launch_bwd<__nv_bfloat16>(g, rf, w, ldw, dirs, win, twin, pwin, gb, dg,
                                                drf, partial, red, B, N, K, Cin, S, Co, st)
                    : launch_bwd<float>(g, rf, w, ldw, dirs, win, twin, pwin, gb, dg, drf,
                                        partial, red, B, N, K, Cin, S, Co, st));
}
