// HS support reduction of the training path (conv_1 .. conv_4) on
// pre-gathered features, forward with stored winner values, and its backward.
//   P[k, sc]  = g[b, n, k, :] @ W[:, sc] + bias[sc]             (per row, in the kernel)
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
// What bounds it on an H100: the forward's projection of every gathered row
// is a dense fp32 product, B*N*K*Cin*S*Co multiply-adds (3.8e10 at conv_1,
// B=16; 1.0e11 over the four layers), on the CUDA cores since fp32 has no
// tensor-core path; the (B, N, S*Co) winner values it writes are small beside
// it.  In the backward each column has one winning row per query, so dg, dW
// and drf are sparse: B*N*S*Co*Cin multiply-adds (K times fewer than the
// dense products of the TPU kernel), bound by the L2 reads that feed them:
// a row of W^T per (query, column) for dg, a winning g row per (query,
// column) for dW.  The bf16 branch reads half the bytes of g, rf and dirs
// but keeps the same CUDA-core multiply-adds on the widened operands, so the
// same 1.0e11 fp32 operations bound it here; on the bf16 tensor cores
// (wgmma, 989 TFLOP/s) the forward's product would be bound by its bytes
// instead, which is the later, faster version this design leaves room for.
//
// Design.
// * Forward: one block per (batch, TQ-query tile), TQ * Co/4 threads; thread
//   (t, cg) owns query t and channels 4cg..4cg+3 for every k, so the max over
//   k and the argmax stay in its registers.  The block stages its queries'
//   g rows (TQ*K x Cin) once in shared memory; per support it streams W in
//   16-row slices and accumulates P in registers (a float4 of g against four
//   float4s of W per step), then applies theta, the max with a strict >
//   (the first maximal k wins) and writes win, twin, pwin.
// * Backward, rows: one block per query.  It buckets the query's S*Co
//   columns by their winning k (a stable counting sort in shared memory, one
//   warp ranking 32 columns at a time), then thread i sums
//   gb*twin[sc] * W[i, sc] over each bucket in a register and writes
//   dg[q, k, i]; threads k < K sum drf over the same buckets.  W is read as
//   its transpose (one contiguous row per column sc, made by a small first
//   launch), from L2.
// * Backward, reductions: one block per (128-query chunk, 64-column tile),
//   thread i over Cin accumulates dW[i, sc] from the winning g rows in
//   registers; 64 threads also carry db and dd.  Each block writes a row of
//   partial sums and a second launch adds the partials in chunk order, so
//   dW, db and dd are the same from run to run.
//
// bwd_store=False, both tiers: the forward without STORE writes win but not
// twin/pwin (K11's no-values launch), and the recompute backward
// (hs_support_bwd_recompute, K14) replaces hspose_tpu/ops/pallas_hs.py::
// _support_bwd_kernel (:240, exact=True and exact=False): recompute_kernel<T>
// forms, per (query, column), theta and P = g[q, win] . W[:, col] + b[col] at
// the recorded winner with the forward's arithmetic (fmaf over Cin in order,
// W rounded to bf16 in the bf16 tier, then + b; theta by the same
// expression), into scratch twin/pwin, and the stored-values backward's
// kernels above route the cotangents from them.  So K14 gives K13's
// cotangents, bit for bit, from the same inputs.  Plain version:
// hspose_tpu_torch/ops/cuda_hs.py::hs_support_bwd_recompute_plain.  What bounds it: besides K13's
// work, B*N*S*Co*Cin fp32 multiply-adds for the recomputed P (K times fewer
// than the forward's), fed by a W column per thread from L2 and g rows staged
// in shared memory for RC_TQ queries at a time.

#include <algorithm>

#include "hs_common.cuh"

namespace {

constexpr int BK = 16;           // rows of W per slice in the forward
constexpr int FWD_THREADS = 256;  // TQ * Co/4
constexpr int ROWS_THREADS = 128;
constexpr int RED_CH = 64;       // columns per block in the reduction kernel
constexpr int RED_QC = 128;      // queries per block in the reduction kernel
constexpr int RED_QS = 16;       // queries staged at once in the reduction kernel
constexpr int RC_TQ = 16;        // queries per block in the recompute kernel
constexpr int RC_CH = 16;        // input channels staged at once in the recompute kernel
constexpr int RC_THREADS = 128;  // columns per block in the recompute kernel

template <int KP, typename T, bool STORE>
__global__ void __launch_bounds__(FWD_THREADS)
support_fwd_kernel(const T* __restrict__ g, const T* __restrict__ rf,
                   const float* __restrict__ w, int ldw, const float* __restrict__ bias,
                   const T* __restrict__ dirs, float* __restrict__ out,
                   int* __restrict__ win, float* __restrict__ twin, float* __restrict__ pwin,
                   int N, int K, int Cin, int S, int Co, int TQ) {
  extern __shared__ __align__(16) float smem[];
  const int SC = S * Co, CG = Co / 4;
  float* sg = smem;                       // (TQ * KP, Cin), rows k >= K are zero
  float* sw = sg + (size_t)TQ * KP * Cin;  // (BK, Co)
  float* srf = sw + BK * Co;              // (TQ * KP, 3)
  const int b = blockIdx.y, q0 = blockIdx.x * TQ;
  const int tq = min(TQ, N - q0);
  const int t = threadIdx.x / CG, cg = threadIdx.x % CG;

  const int c4 = Cin / 4;
  for (int e = threadIdx.x; e < TQ * KP * c4; e += blockDim.x) {
    const int row = e / c4, tt = row / KP, k = row % KP;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tt < tq && k < K) {
      const size_t at = (((size_t)b * N + q0 + tt) * K + k) * c4 + e % c4;
      if constexpr (hs::is_bf16<T>) {  // four bf16 values, widened exactly
        const uint2 raw = reinterpret_cast<const uint2*>(g)[at];
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        v = make_float4(lo.x, lo.y, hi.x, hi.y);
      } else {
        v = reinterpret_cast<const float4*>(g)[at];
      }
    }
    reinterpret_cast<float4*>(sg)[e] = v;
  }
  for (int e = threadIdx.x; e < TQ * KP * 3; e += blockDim.x) {
    const int row = e / 3, tt = row / KP, k = row % KP;
    srf[e] = (tt < tq && k < K)
                 ? hs::load_f(rf + (((size_t)b * N + q0 + tt) * K + k) * 3 + e % 3)
                 : 0.f;
  }

  const bool active = t < tq;
  const size_t qrow = (size_t)b * N + q0 + t;
  float oacc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < S; ++s) {
    float acc[KP][4];
#pragma unroll
    for (int k = 0; k < KP; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;

    for (int k0 = 0; k0 < Cin; k0 += BK) {
      __syncthreads();  // the previous slice is no longer read (and sg, srf are staged)
      for (int e = threadIdx.x; e < BK * Co; e += blockDim.x) {
        const int r = e / Co, c = e % Co;
        const float v = k0 + r < Cin ? w[(size_t)(k0 + r) * ldw + s * Co + c] : 0.f;
        sw[e] = hs::is_bf16<T> ? hs::bf16_round(v) : v;  // the one-pass product's W operand
      }
      __syncthreads();
      const int kmax = min(BK, Cin - k0);
      for (int kk = 0; kk < kmax; kk += 4) {
        float4 w4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w4[i] = *reinterpret_cast<const float4*>(&sw[(kk + i) * Co + cg * 4]);
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(&sg[(size_t)(t * KP + k) * Cin + k0 + kk]);
          acc[k][0] = fmaf(a.w, w4[3].x, fmaf(a.z, w4[2].x, fmaf(a.y, w4[1].x, fmaf(a.x, w4[0].x, acc[k][0]))));
          acc[k][1] = fmaf(a.w, w4[3].y, fmaf(a.z, w4[2].y, fmaf(a.y, w4[1].y, fmaf(a.x, w4[0].y, acc[k][1]))));
          acc[k][2] = fmaf(a.w, w4[3].z, fmaf(a.z, w4[2].z, fmaf(a.y, w4[1].z, fmaf(a.x, w4[0].z, acc[k][2]))));
          acc[k][3] = fmaf(a.w, w4[3].w, fmaf(a.z, w4[2].w, fmaf(a.y, w4[1].w, fmaf(a.x, w4[0].w, acc[k][3]))));
        }
      }
    }

    if (active) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = s * Co + cg * 4 + j;
        const float d0 = hs::load_f(dirs + col), d1 = hs::load_f(dirs + SC + col),
                    d2 = hs::load_f(dirs + 2 * SC + col);
        const float bb = bias[col];
        float m = 0.f, tw = 0.f, pw = 0.f;
        int kb = 0;
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          if (k < K) {
            const float* r = srf + (t * KP + k) * 3;
            const float th = fmaxf(r[0] * d0 + r[1] * d1 + r[2] * d2, 0.f);
            const float p = acc[k][j] + bb;
            const float v = th * p;
            if (k == 0 || v > m) {
              m = v;
              kb = k;
              tw = th;
              pw = p;
            }
          }
        }
        win[qrow * SC + col] = kb;
        if constexpr (STORE) {
          twin[qrow * SC + col] = tw;
          pwin[qrow * SC + col] = pw;
        }
        oacc[j] += m;
      }
    }
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[qrow * Co + cg * 4 + j] = oacc[j] / S;
  }
}

// Stage, for the flattened (b, n) rows row0 .. row0 + nrows - 1 and columns
// c0 .. c0 + nc - 1, the winner, gb*twin and the gated gb*pwin into (nq, width)
// shared arrays; entries past nrows or nc are zero.  FAST (the bf16 tier)
// rounds gb*twin and gb*pwin to bf16 as product operands and also stages the
// unrounded gb*twin into sb, for db.
template <bool FAST>
__device__ inline void stage_winners(const int* __restrict__ win, const float* __restrict__ twin,
                                     const float* __restrict__ pwin, const float* __restrict__ gb,
                                     int* sk, float* sv, float* sb, float* su, size_t row0, int nq,
                                     int nrows, int c0, int nc, int width, int SC, int S, int Co) {
  for (int e = threadIdx.x; e < nq * width; e += blockDim.x) {
    const int t = e / width, j = e % width;
    int k = 0;
    float v = 0.f, u = 0.f;
    if (t < nrows && j < nc) {
      const size_t row = row0 + t;
      const size_t at = row * SC + c0 + j;
      const float gs = hs::div_s<FAST>(gb[row * Co + (c0 + j) % Co], S);
      const float tw = twin[at];
      k = win[at];
      v = gs * tw;
      u = tw > 0.f ? gs * pwin[at] : 0.f;
    }
    sk[e] = k;
    if constexpr (FAST) {
      sb[e] = v;
      sv[e] = hs::bf16_round(v);
      su[e] = hs::bf16_round(u);
    } else {
      sv[e] = v;
      su[e] = u;
    }
  }
}

// One block per query row q.  The row's S*Co columns are bucketed by their
// winning k, stably (hs::bucket_by_winner), so dg[q, k, i] is a sum over k's bucket in
// column order, held in a register by thread i: no shared-memory
// read-modify-write and no atomics.  Threads k < K sum drf over the same
// buckets.  The bf16 tier rounds gb*twin and gb*pwin to bf16 (the products'
// operands) and writes dg and drf rounded to bf16 once.
template <typename T>
__global__ void __launch_bounds__(ROWS_THREADS)
support_bwd_rows_kernel(const float* __restrict__ wt, const T* __restrict__ dirs,
                        const int* __restrict__ win, const float* __restrict__ twin,
                        const float* __restrict__ pwin, const float* __restrict__ gb,
                        T* __restrict__ dg, T* __restrict__ drf, int K, int Cin,
                        int S, int Co) {
  extern __shared__ __align__(16) float smem[];
  const int SC = S * Co;
  float2* spair = reinterpret_cast<float2*>(smem);  // (SC) bucket order: (column bits, gb*twin)
  float* sv = smem + 2 * SC;                         // (SC) gb*twin, column order
  float* su = sv + SC;                               // (SC) gated gb*pwin, column order
  int* sk = reinterpret_cast<int*>(su + SC);         // (SC) winner
  int* srank = sk + SC;                              // (SC) place within its bucket
  int* scnt = srank + SC;                            // (32) bucket sizes
  int* soff = scnt + 32;                             // (33) bucket offsets
  const size_t q = blockIdx.x;

  for (int c = threadIdx.x; c < SC; c += blockDim.x) {
    const size_t at = q * SC + c;
    const float gs = hs::div_s<hs::is_bf16<T>>(gb[q * Co + c % Co], S);
    const float tw = twin[at];
    const float v = gs * tw, u = tw > 0.f ? gs * pwin[at] : 0.f;
    sk[c] = win[at];
    sv[c] = hs::is_bf16<T> ? hs::bf16_round(v) : v;
    su[c] = hs::is_bf16<T> ? hs::bf16_round(u) : u;
  }
  __syncthreads();
  hs::bucket_by_winner(sk, srank, scnt, soff, SC);
  __syncthreads();
  for (int c = threadIdx.x; c < SC; c += blockDim.x)
    spair[soff[sk[c]] + srank[c]] = make_float2(__int_as_float(c), sv[c]);
  __syncthreads();

  T* dgq = dg + q * K * Cin;
  for (int i = threadIdx.x; i < Cin; i += blockDim.x) {
    for (int k = 0; k < K; ++k) {
      float acc = 0.f;
      const int pe = soff[k + 1];
#pragma unroll 4
      for (int p = soff[k]; p < pe; ++p) {
        const float2 e = spair[p];
        acc = fmaf(e.y, wt[(size_t)__float_as_int(e.x) * Cin + i], acc);
      }
      hs::store_f(dgq + k * Cin + i, acc);
    }
  }
  if (threadIdx.x < K) {
    const int k = threadIdx.x;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int p = soff[k]; p < soff[k + 1]; ++p) {
      const int c = __float_as_int(spair[p].x);
      const float u = su[c];
      a0 += u * hs::load_f(dirs + c);
      a1 += u * hs::load_f(dirs + SC + c);
      a2 += u * hs::load_f(dirs + 2 * SC + c);
    }
    T* r = drf + (q * K + k) * 3;
    hs::store_f(r, a0);
    hs::store_f(r + 1, a1);
    hs::store_f(r + 2, a2);
  }
}

// The bf16 tier's dW and dd take the bf16-rounded gb*twin and gb*pwin, and db
// the unrounded gb*twin.
template <typename T>
__global__ void __launch_bounds__(256)
support_bwd_reduce_kernel(const T* __restrict__ g, const T* __restrict__ rf,
                          const int* __restrict__ win, const float* __restrict__ twin,
                          const float* __restrict__ pwin, const float* __restrict__ gb,
                          float* __restrict__ partial, int rows, int K, int Cin, int S,
                          int Co) {
  constexpr bool FAST = hs::is_bf16<T>;
  __shared__ int sk[RED_QS * RED_CH];
  __shared__ float sv[RED_QS * RED_CH];
  __shared__ float su[RED_QS * RED_CH];
  __shared__ float sb[FAST ? RED_QS * RED_CH : 1];  // unrounded gb*twin, for db
  const int SC = S * Co;
  const int chunk = blockIdx.y, c0 = blockIdx.x * RED_CH;
  const int nc = min(RED_CH, SC - c0);
  const int qa = chunk * RED_QC, qb = min(rows, qa + RED_QC);
  const int E = (Cin + 4) * SC;  // one chunk's partial: dW rows, then db, then dd
  float* part = partial + (size_t)chunk * E;

  for (int i0 = 0; i0 < Cin; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool extra = i0 == 0 && threadIdx.x < RED_CH;  // also carries db, dd of column threadIdx.x
    float acc[RED_CH];
#pragma unroll
    for (int j = 0; j < RED_CH; ++j) acc[j] = 0.f;
    float db = 0.f, dd0 = 0.f, dd1 = 0.f, dd2 = 0.f;
    for (int q0 = qa; q0 < qb; q0 += RED_QS) {
      const int nq = min(RED_QS, qb - q0);
      __syncthreads();
      stage_winners<FAST>(win, twin, pwin, gb, sk, sv, sb, su, q0, RED_QS, nq, c0, nc, RED_CH,
                          SC, S, Co);
      __syncthreads();
      for (int t = 0; t < nq; ++t) {
        const size_t q = (size_t)q0 + t;
        if (i < Cin) {
          const T* gq = g + q * K * Cin + i;
#pragma unroll
          for (int j = 0; j < RED_CH; ++j)
            acc[j] = fmaf(sv[t * RED_CH + j], hs::load_f(gq + (size_t)sk[t * RED_CH + j] * Cin),
                          acc[j]);
        }
        if (extra) {
          const int j = threadIdx.x;
          const T* r = rf + (q * K + sk[t * RED_CH + j]) * 3;
          const float u = su[t * RED_CH + j];
          db += (FAST ? sb : sv)[t * RED_CH + j];
          dd0 += u * hs::load_f(r);
          dd1 += u * hs::load_f(r + 1);
          dd2 += u * hs::load_f(r + 2);
        }
      }
    }
    if (i < Cin) {
#pragma unroll
      for (int j = 0; j < RED_CH; ++j)
        if (j < nc) part[(size_t)i * SC + c0 + j] = acc[j];
    }
    if (extra && threadIdx.x < nc) {
      const int col = c0 + threadIdx.x;
      part[(size_t)Cin * SC + col] = db;
      part[(size_t)(Cin + 1) * SC + col] = dd0;
      part[(size_t)(Cin + 2) * SC + col] = dd1;
      part[(size_t)(Cin + 3) * SC + col] = dd2;
    }
  }
}

// twin, pwin (rows, S*Co) at the recorded winners, with the forward's
// arithmetic: P = fmaf over i in order of g[q, k, i] * W[i, col], then + b[col];
// theta = relu(rf[q, k] . d[:, col]) by support_fwd_kernel's expression.  The
// bf16 tier (T = __nv_bfloat16) rounds W to bf16 as the forward stages it,
// so each product is exact and P has the forward's bits.
// Block: RC_THREADS columns (grid.x) of RC_TQ queries (grid.y); the queries'
// g rows are staged RC_CH channels at a time.
template <typename T>
__global__ void __launch_bounds__(RC_THREADS)
recompute_kernel(const T* __restrict__ g, const T* __restrict__ rf,
                 const float* __restrict__ w, int ldw, const float* __restrict__ bias,
                 const T* __restrict__ dirs, const int* __restrict__ win,
                 float* __restrict__ twin, float* __restrict__ pwin, int rows, int K, int Cin,
                 int S, int Co) {
  extern __shared__ float sg[];  // (RC_TQ, K, RC_CH)
  const int SC = S * Co;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int q0 = blockIdx.y * RC_TQ, tq = min(RC_TQ, rows - q0);
  int kk[RC_TQ];
  float acc[RC_TQ];
#pragma unroll
  for (int t = 0; t < RC_TQ; ++t) {
    kk[t] = (col < SC && t < tq) ? win[(size_t)(q0 + t) * SC + col] : 0;
    acc[t] = 0.f;
  }
  for (int i0 = 0; i0 < Cin; i0 += RC_CH) {
    const int nch = min(RC_CH, Cin - i0);
    __syncthreads();  // the previous slice is no longer read
    for (int e = threadIdx.x; e < RC_TQ * K * RC_CH; e += blockDim.x) {
      const int t = e / (K * RC_CH), k = (e / RC_CH) % K, i = e % RC_CH;
      sg[e] = (t < tq && i < nch) ? hs::load_f(g + ((size_t)(q0 + t) * K + k) * Cin + i0 + i)
                                  : 0.f;
    }
    __syncthreads();
    if (col < SC) {
      for (int i = 0; i < nch; ++i) {
        const float wr = w[(size_t)(i0 + i) * ldw + col];
        const float wv = hs::is_bf16<T> ? hs::bf16_round(wr) : wr;
#pragma unroll
        for (int t = 0; t < RC_TQ; ++t)
          acc[t] = fmaf(sg[(t * K + kk[t]) * RC_CH + i], wv, acc[t]);
      }
    }
  }
  if (col >= SC) return;
  const float d0 = hs::load_f(dirs + col), d1 = hs::load_f(dirs + SC + col),
              d2 = hs::load_f(dirs + 2 * SC + col);
  const float bb = bias[col];
  for (int t = 0; t < tq; ++t) {
    const size_t at = (size_t)(q0 + t) * SC + col;
    const T* rq = rf + ((size_t)(q0 + t) * K + kk[t]) * 3;
    const float r[3] = {hs::load_f(rq), hs::load_f(rq + 1), hs::load_f(rq + 2)};
    const float th = fmaxf(r[0] * d0 + r[1] * d1 + r[2] * d2, 0.f);
    twin[at] = th;
    pwin[at] = acc[t] + bb;
  }
}

template <int KP, typename T, bool STORE>
cudaError_t launch_fwd(const void* g, const void* rf, const float* w, int ldw, const float* b,
                       const void* dirs, float* out, int* win, float* twin, float* pwin, int B,
                       int N, int K, int Cin, int S, int Co, cudaStream_t stream) {
  const int TQ = FWD_THREADS / (Co / 4);
  const size_t smem = sizeof(float) * ((size_t)TQ * KP * Cin + BK * Co + (size_t)TQ * KP * 3);
  cudaError_t err = hs::allow_smem(support_fwd_kernel<KP, T, STORE>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TQ - 1) / TQ, B);
  support_fwd_kernel<KP, T, STORE><<<grid, TQ * (Co / 4), smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(rf), w, ldw, b,
      static_cast<const T*>(dirs), out, win, twin, pwin, N, K, Cin, S, Co, TQ);
  return cudaGetLastError();
}

template <typename T, bool STORE = true>
cudaError_t launch_fwd_k(const void* g, const void* rf, const float* w, int ldw, const float* b,
                         const void* dirs, float* out, int* win, float* twin, float* pwin, int B,
                         int N, int K, int Cin, int S, int Co, cudaStream_t st) {
  if (K <= 8)
    return launch_fwd<8, T, STORE>(g, rf, w, ldw, b, dirs, out, win, twin, pwin, B, N, K, Cin, S,
                                   Co, st);
  if (K <= 20)
    return launch_fwd<20, T, STORE>(g, rf, w, ldw, b, dirs, out, win, twin, pwin, B, N, K, Cin,
                                    S, Co, st);
  return launch_fwd<32, T, STORE>(g, rf, w, ldw, b, dirs, out, win, twin, pwin, B, N, K, Cin, S,
                                  Co, st);
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* rf, const float* w, int ldw, const void* dirs,
                       const int* win, const float* twin, const float* pwin, const float* gb,
                       void* dg, void* drf, float* wt, float* partial, float* red, int B, int N,
                       int K, int Cin, int S, int Co, cudaStream_t st) {
  constexpr bool FAST = hs::is_bf16<T>;
  const int SC = S * Co;
  // W^T, so that the rows kernel reads one column of W as a contiguous row;
  // the bf16 tier rounds it (dg's W operand)
  cudaError_t err = hs::transpose_w<FAST>(w, ldw, wt, Cin, SC, st);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * 6 * (size_t)SC + sizeof(int) * 65;
  err = hs::allow_smem(support_bwd_rows_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  support_bwd_rows_kernel<T><<<B * N, ROWS_THREADS, smem, st>>>(
      wt, static_cast<const T*>(dirs), win, twin, pwin, gb, static_cast<T*>(dg),
      static_cast<T*>(drf), K, Cin, S, Co);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int rows = B * N, parts = (rows + RED_QC - 1) / RED_QC;
  const int threads = Cin >= 256 ? 256 : ((Cin + 31) / 32) * 32;
  support_bwd_reduce_kernel<T><<<dim3((SC + RED_CH - 1) / RED_CH, parts),
                                 std::max(threads, RED_CH), 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(rf), win, twin, pwin, gb, partial, rows, K,
      Cin, S, Co);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return hs::sum_partials(partial, red, parts, (Cin + 4) * SC, st);
}


}  // namespace

// The wrapper's checks, in one place: 0 when the kernels take these sizes
// (K <= 32; Co a multiple of 4 with Co/4 dividing 256; Cin a multiple of 4;
// the staged g rows within 160 KB of shared memory), else 1.
extern "C" int hs_support_train_supported(int K, int Cin, int Co) {
  if (K < 1 || K > 32 || Cin % 4 != 0 || Co % 4 != 0 || Co / 4 > FWD_THREADS ||
      FWD_THREADS % (Co / 4) != 0)
    return 1;
  const int TQ = FWD_THREADS / (Co / 4);
  const int KP = K <= 8 ? 8 : (K <= 20 ? 20 : 32);
  return (size_t)TQ * KP * Cin * sizeof(float) > 160 * 1024 ? 1 : 0;
}

// Chunks of the reduction kernel: the partial-sum scratch is
// (hs_support_bwd_parts(B * N), Cin + 4, S*Co).
extern "C" int hs_support_bwd_parts(int rows) { return (rows + RED_QC - 1) / RED_QC; }

// g (B, N, K, Cin), rf (B, N, K, 3), dirs (3, S*Co), fp32 or (fast != 0) bf16;
// w (Cin, S*Co; row stride ldw), b (S*Co) fp32 -> out (B, N, Co), win (B, N, S*Co)
// int32, twin, pwin (B, N, S*Co), fp32.
extern "C" int hs_support_fwd(const void* g, const void* rf, const float* w, int ldw,
                              const float* b, const void* dirs, float* out, int* win,
                              float* twin, float* pwin, int B, int N, int K, int Cin, int S,
                              int Co, int fast, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hs_support_train_supported(K, Cin, Co)) return (int)cudaErrorInvalidValue;
  return (int)(fast ? launch_fwd_k<__nv_bfloat16>(g, rf, w, ldw, b, dirs, out, win, twin, pwin,
                                                  B, N, K, Cin, S, Co, st)
                    : launch_fwd_k<float>(g, rf, w, ldw, b, dirs, out, win, twin, pwin, B, N, K,
                                          Cin, S, Co, st));
}

// bwd_store=False: as hs_support_fwd, writing out and win only.
extern "C" int hs_support_fwd_win(const void* g, const void* rf, const float* w, int ldw,
                                  const float* b, const void* dirs, float* out, int* win, int B,
                                  int N, int K, int Cin, int S, int Co, int fast, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hs_support_train_supported(K, Cin, Co)) return (int)cudaErrorInvalidValue;
  return (int)(fast ? launch_fwd_k<__nv_bfloat16, false>(g, rf, w, ldw, b, dirs, out, win,
                                                         nullptr, nullptr, B, N, K, Cin, S, Co,
                                                         st)
                    : launch_fwd_k<float, false>(g, rf, w, ldw, b, dirs, out, win, nullptr,
                                                 nullptr, B, N, K, Cin, S, Co, st));
}

template <typename T>
cudaError_t launch_recompute(const void* g, const void* rf, const float* w, int ldw,
                             const float* b, const void* dirs, const int* win, const float* gb,
                             float* twin, float* pwin, void* dg, void* drf, float* wt,
                             float* partial, float* red, int B, int N, int K, int Cin, int S,
                             int Co, cudaStream_t st) {
  const int SC = S * Co, rows = B * N;
  const size_t smem = sizeof(float) * (size_t)RC_TQ * K * RC_CH;
  recompute_kernel<T><<<dim3((SC + RC_THREADS - 1) / RC_THREADS, (rows + RC_TQ - 1) / RC_TQ),
                        RC_THREADS, smem, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(rf), w, ldw, b,
      static_cast<const T*>(dirs), win, twin, pwin, rows, K, Cin, S, Co);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_bwd<T>(g, rf, w, ldw, dirs, win, twin, pwin, gb, dg, drf, wt, partial, red, B, N,
                       K, Cin, S, Co, st);
}

// K14: g (B, N, K, Cin), rf (B, N, K, 3), dirs (3, S*Co), fp32 or (fast != 0) bf16;
// w (Cin, S*Co; row stride ldw), b (S*Co), win (B, N, S*Co), gb (B, N, Co); scratch
// twin, pwin (B, N, S*Co), wt (S*Co, Cin) and partial (hs_support_bwd_parts(B * N),
// Cin + 4, S*Co) -> dg, drf (in g's type) and red = [dW; db; dd] as hs_support_bwd.
extern "C" int hs_support_bwd_recompute(const void* g, const void* rf, const float* w, int ldw,
                                        const float* b, const void* dirs, const int* win,
                                        const float* gb, float* twin, float* pwin, void* dg,
                                        void* drf, float* wt, float* partial, float* red, int B,
                                        int N, int K, int Cin, int S, int Co, int fast,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hs_support_train_supported(K, Cin, Co)) return (int)cudaErrorInvalidValue;
  return (int)(fast ? launch_recompute<__nv_bfloat16>(g, rf, w, ldw, b, dirs, win, gb, twin,
                                                      pwin, dg, drf, wt, partial, red, B, N, K,
                                                      Cin, S, Co, st)
                    : launch_recompute<float>(g, rf, w, ldw, b, dirs, win, gb, twin, pwin, dg,
                                              drf, wt, partial, red, B, N, K, Cin, S, Co, st));
}

// g (B, N, K, Cin), rf (B, N, K, 3), dirs (3, S*Co), fp32 or (fast != 0) bf16;
// w (Cin, S*Co; row stride ldw), win/twin/pwin (B, N, S*Co), gb (B, N, Co), scratch
// wt (S*Co, Cin) and partial (hs_support_bwd_parts(B * N), Cin + 4, S*Co) -> dg
// (B, N, K, Cin) and drf (B, N, K, 3) in g's type, red (Cin + 4, S*Co) = [dW; db; dd]
// fp32.
extern "C" int hs_support_bwd(const void* g, const void* rf, const float* w, int ldw,
                              const void* dirs, const int* win, const float* twin,
                              const float* pwin, const float* gb, void* dg, void* drf,
                              float* wt, float* partial, float* red, int B, int N, int K,
                              int Cin, int S, int Co, int fast, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hs_support_train_supported(K, Cin, Co)) return (int)cudaErrorInvalidValue;
  return (int)(fast ? launch_bwd<__nv_bfloat16>(g, rf, w, ldw, dirs, win, twin, pwin, gb, dg,
                                                drf, wt, partial, red, B, N, K, Cin, S, Co, st)
                    : launch_bwd<float>(g, rf, w, ldw, dirs, win, twin, pwin, gb, dg, drf, wt,
                                        partial, red, B, N, K, Cin, S, Co, st));
}
