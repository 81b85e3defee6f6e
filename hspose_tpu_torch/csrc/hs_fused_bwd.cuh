// Backward pieces shared by the fused HS reductions' backwards: the
// support reduction's (K8, hs_support.cu), the surface reduction's (K9,
// hs_surface.cu) and, for the inverse neighbour lists, the ORL branch's (K10,
// orl.cu).  Replaces the bodies of hspose_tpu/ops/pallas_hs_fused.py::
// _support_bwd_kernel (:420-490) and _surface_bwd_kernel (:493-541), both
// branches: exact=True (fp32) and, with FAST, exact=False (the bf16 tier).
//
// The TPU kernels walk the neighbour slots k of a query tile, select by the
// forward's recorded winner, and scatter each cotangent row back to its
// source row by a one-hot transpose product accumulated across the grid.  Here
// every sum has a fixed order and no atomics, so two runs give the same bits:
// * inverse_index: per batch, the (query, slot) entries that gather each
//   source row, in increasing order (a counting sort whose ranks one warp
//   assigns 32 entries at a time);
// * route_kernel: per (query, column), theta at the winner recomputed with
//   the forward's arithmetic, and the routed cotangents dz (into rf and the
//   directions) and, for the support reduction, dproj (into the projection);
// * rf_grad_kernel: per query, drfn[k] summed over the columns won by k in
//   column order, the cotangent of rf through the normalisation (masked where
//   |rf| < 1e-12, so a duplicated point passes nothing), and the query-centre
//   term dvq = -sum_k drf[k];
// * dd_partial_kernel: dd (and db) as per-chunk partial sums, added in chunk
//   order by hs::sum_partials;
// * source_kernel: per source row, the sum over its inverse list of dproj at
//   the entries whose winner is that slot (dproj_src), and dverts = the sum of
//   drf over the list plus dvq, as pallas_hs_fused.py:734 sums them.
//
// FAST makes the TPU kernel's exact=False roundings (pallas_hs_fused.py:
// 123-212): theta from the bf16-rounded rfn and directions the forward
// stages; gs = gb * (1/S) (hs::div_s); dz rounded to bf16 as the operand of
// dd (against the bf16 rfn) and of drfn (against the bf16 directions); the
// rf chain in fp32 on xyz rounded to bf16, in _rf_fast's order; each row of
// drf and of dproj rounded to bf16 before its source-row sum (_scatter_rows,
// and dW's operand); dvq and db summed unrounded.
//
// What bounds them on an H100: each reads the (B, N, S*Co) winners and
// cotangents a few times, from L2 at the pooled sizes; the arithmetic is small.

#pragma once

#include <type_traits>

#include "hs_common.cuh"

namespace hsb {

constexpr int TQ = 8;          // queries per block of route_kernel
constexpr int THREADS = 128;
constexpr int RED_QC = 64;     // queries per chunk of dd_partial_kernel

// rowptr (B, N + 1), ent (B, N * K): the entries e = q * K + k with
// idx[b, q, k] == r are ent[b, rowptr[b, r] .. rowptr[b, r + 1] - 1], in
// increasing e.  One block per batch; smem N ints.
static __global__ void inverse_index_kernel(const int* __restrict__ idx, int* __restrict__ rowptr,
                                            int* __restrict__ ent, int N, int K) {
  extern __shared__ int cnt[];  // counts, then the next free place of each row's list
  const int b = blockIdx.x, E = N * K;
  const int* ib = idx + (size_t)b * E;
  int* rp = rowptr + (size_t)b * (N + 1);
  int* eb = ent + (size_t)b * E;
  for (int r = threadIdx.x; r < N; r += blockDim.x) cnt[r] = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) atomicAdd(&cnt[ib[e]], 1);  // integer counts
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int r = 0; r < N; ++r) {
      const int c = cnt[r];
      rp[r] = run;
      cnt[r] = run;
      run += c;
    }
    rp[N] = run;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      const bool valid = e < E;
      const int r = valid ? ib[e] : -1;
      const unsigned grp = __match_any_sync(0xffffffffu, r);
      const int rank = __popc(grp & ((1u << lane) - 1u));  // earlier lanes with the same row
      const int base = valid ? cnt[r] : 0;
      __syncwarp();
      if (valid) {
        eb[base + rank] = e;
        if (rank == 0) cnt[r] = base + __popc(grp);
      }
      __syncwarp();
    }
  }
}

static inline cudaError_t inverse_index(const int* idx, int* rowptr, int* ent, int B, int N, int K,
                                        cudaStream_t st) {
  const size_t smem = sizeof(int) * (size_t)N;
  cudaError_t err = hs::allow_smem(inverse_index_kernel, smem);
  if (err != cudaSuccess) return err;
  inverse_index_kernel<<<B, 256, smem, st>>>(idx, rowptr, ent, N, K);
  return cudaGetLastError();
}

// Per (query, column): k = win[q, col], theta = relu(rfn[q, k] . d[:, col]) as
// the forward forms it (stage_rf, the same expression), gs = gb[q, col % Co] / S;
// SUPPORT: dz = theta > 0 ? gs * proj[idx[q, k], col] : 0 and dproj = gs * theta;
// else (surface) dz = theta > 0 ? gs : 0, all unrounded.  One block per
// (batch, TQ queries).
template <bool SUPPORT, bool FAST>
__global__ void __launch_bounds__(THREADS)
route_kernel(const float* __restrict__ verts, const int* __restrict__ idx,
             const float* __restrict__ dirs, const int* __restrict__ win,
             const float* __restrict__ gb, const float* __restrict__ proj,
             float* __restrict__ dz, float* __restrict__ dproj, int N, int K, int S, int Co) {
  extern __shared__ float smem[];
  const int SC = S * Co;
  float* sd = smem;                                      // (3, S*Co)
  float* srf = sd + 3 * SC;                              // (TQ, K, 3)
  int* sidx = reinterpret_cast<int*>(srf + TQ * K * 3);  // (TQ, K)
  const int b = blockIdx.y, q0 = blockIdx.x * TQ;
  hs::stage_dirs<FAST>(dirs, sd, SC);
  hs::stage_rf<FAST>(verts, idx, srf, sidx, b, q0, TQ, N, K);
  __syncthreads();

  const int tq = min(TQ, N - q0);
  for (int c = threadIdx.x; c < SC; c += blockDim.x) {
    const float d0 = sd[c], d1 = sd[SC + c], d2 = sd[2 * SC + c];
    for (int t = 0; t < tq; ++t) {
      const size_t q = (size_t)b * N + q0 + t, at = q * SC + c;
      const int k = win[at];
      const float* r = srf + (t * K + k) * 3;
      const float theta = fmaxf(r[0] * d0 + r[1] * d1 + r[2] * d2, 0.f);
      const float gs = hs::div_s<FAST>(gb[q * Co + c % Co], S);
      if constexpr (SUPPORT) {
        const float p = proj[((size_t)b * N + sidx[t * K + k]) * SC + c];
        dz[at] = theta > 0.f ? gs * p : 0.f;
        dproj[at] = gs * theta;
      } else {
        dz[at] = theta > 0.f ? gs : 0.f;
      }
    }
  }
}

template <bool SUPPORT, bool FAST>
cudaError_t route(const float* verts, const int* idx, const float* dirs, const int* win,
                  const float* gb, const float* proj, float* dz, float* dproj, int B, int N, int K,
                  int S, int Co, cudaStream_t st) {
  const size_t smem = sizeof(float) * (3 * (size_t)S * Co + (size_t)TQ * K * 3) +
                      sizeof(int) * (size_t)TQ * K;
  cudaError_t err = hs::allow_smem(route_kernel<SUPPORT, FAST>, smem);
  if (err != cudaSuccess) return err;
  route_kernel<SUPPORT, FAST><<<dim3((N + TQ - 1) / TQ, B), THREADS, smem, st>>>(
      verts, idx, dirs, win, gb, proj, dz, dproj, N, K, S, Co);
  return cudaGetLastError();
}

// One warp per query q (K <= 32): lane k sums drfn = sum of dz[q, col] * d[:, col]
// over the columns whose winner is k, in column order; then drf[q, k] is the
// cotangent of rf = v[idx[q, k]] - v[q] through rfn = rf / max(|rf|, 1e-12)
// (pallas_hs_fused.py::_rf_chain_bwd), and dvq[q] = -sum_k drf[q, k] in k order.
// FAST: dz and the directions as bf16 operands, rf from xyz rounded to bf16.
// Each row of drf is then rounded to bf16 before its source-row sum, so the
// row must not depend on an order of summation: drfn sums its exact products
// in fp64 and is rounded to fp32 once, and the chain takes the fp32 steps of
// ops/cuda_hs_fused.py::_rf_grad_fast in its order (__f*_rn, no fusing).
template <bool FAST>
__global__ void __launch_bounds__(32)
rf_grad_kernel(const float* __restrict__ verts, const int* __restrict__ idx,
               const float* __restrict__ dirs, const int* __restrict__ win,
               const float* __restrict__ dz, float* __restrict__ drf, float* __restrict__ dvq,
               int N, int K, int SC) {
  using Acc = std::conditional_t<FAST, double, float>;
  const size_t q = blockIdx.x;
  const int k = threadIdx.x;
  const int* wq = win + q * SC;
  const float* zq = dz + q * SC;
  Acc a0 = 0, a1 = 0, a2 = 0;
  for (int c = 0; c < SC; ++c) {
    if (wq[c] == k) {
      if constexpr (FAST) {  // exact products of bf16 operands
        const double u = hs::bf16_round(zq[c]);
        a0 += u * hs::bf16_round(dirs[c]);
        a1 += u * hs::bf16_round(dirs[SC + c]);
        a2 += u * hs::bf16_round(dirs[2 * SC + c]);
      } else {
        const float u = zq[c];
        a0 += u * dirs[c];
        a1 += u * dirs[SC + c];
        a2 += u * dirs[2 * SC + c];
      }
    }
  }
  float g0 = 0.f, g1 = 0.f, g2 = 0.f;
  if (k < K) {
    const size_t b = q / N;
    const float* cv = verts + q * 3;
    const float* v = verts + (b * N + idx[q * K + k]) * 3;
    if constexpr (FAST) {  // hs::stage_rf<true>'s rf, norm and inv, unrounded
      const float r0 = hs::bf16_round(v[0]) - hs::bf16_round(cv[0]);
      const float r1 = hs::bf16_round(v[1]) - hs::bf16_round(cv[1]);
      const float r2 = hs::bf16_round(v[2]) - hs::bf16_round(cv[2]);
      const float norm = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(r0, r0), __fmul_rn(r1, r1)),
                                              __fmul_rn(r2, r2)));
      const float inv = __fdiv_rn(1.f, fmaxf(norm, 1e-12f));
      const float b0 = (float)a0, b1 = (float)a1, b2 = (float)a2;
      const float s = __fadd_rn(__fadd_rn(__fmul_rn(b0, r0), __fmul_rn(b1, r1)), __fmul_rn(b2, r2));
      const float h = norm >= 1e-12f ? __fmul_rn(__fmul_rn(__fmul_rn(s, inv), inv), inv) : 0.f;
      g0 = __fsub_rn(__fmul_rn(b0, inv), __fmul_rn(r0, h));
      g1 = __fsub_rn(__fmul_rn(b1, inv), __fmul_rn(r1, h));
      g2 = __fsub_rn(__fmul_rn(b2, inv), __fmul_rn(r2, h));
    } else {
      const float r0 = v[0] - cv[0], r1 = v[1] - cv[1], r2 = v[2] - cv[2];
      const float norm = sqrtf(r0 * r0 + r1 * r1 + r2 * r2);
      const float inv = 1.f / fmaxf(norm, 1e-12f);
      const float s = a0 * r0 + a1 * r1 + a2 * r2;
      const float h = norm >= 1e-12f ? s * inv * inv * inv : 0.f;
      g0 = a0 * inv - r0 * h;
      g1 = a1 * inv - r1 * h;
      g2 = a2 * inv - r2 * h;
    }
    float* out = drf + (q * K + k) * 3;
    out[0] = g0;
    out[1] = g1;
    out[2] = g2;
  }
  float c0 = 0.f, c1 = 0.f, c2 = 0.f;
  for (int j = 0; j < K; ++j) {  // the query-centre term, in k order
    c0 -= __shfl_sync(0xffffffffu, g0, j);
    c1 -= __shfl_sync(0xffffffffu, g1, j);
    c2 -= __shfl_sync(0xffffffffu, g2, j);
  }
  if (k == 0) {
    dvq[q * 3] = c0;
    dvq[q * 3 + 1] = c1;
    dvq[q * 3 + 2] = c2;
  }
}

// Partial sums over chunks of RED_QC queries, one row of E = (3 or 4) * S*Co
// per (batch, chunk): dd[d, col] = sum_q rfn[q, win[q, col]][d] * dz[q, col]
// and (SUPPORT) db[col] = sum_q dproj[q, col].  FAST: rfn (as staged) and dz
// as bf16 operands; db unrounded.
template <bool SUPPORT, bool FAST>
__global__ void __launch_bounds__(THREADS)
dd_partial_kernel(const float* __restrict__ verts, const int* __restrict__ idx,
                  const int* __restrict__ win, const float* __restrict__ dz,
                  const float* __restrict__ dproj, float* __restrict__ partial, int N, int K,
                  int SC) {
  extern __shared__ float srf[];  // (RED_QC, K, 3)
  const int b = blockIdx.z, chunk = blockIdx.y, q0 = chunk * RED_QC;
  hs::stage_rf<FAST>(verts, idx, srf, nullptr, b, q0, RED_QC, N, K);
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= SC) return;
  const int tq = min(RED_QC, N - q0);
  float dd0 = 0.f, dd1 = 0.f, dd2 = 0.f, db = 0.f;
  for (int t = 0; t < tq; ++t) {
    const size_t at = ((size_t)b * N + q0 + t) * SC + c;
    const float* r = srf + (t * K + win[at]) * 3;
    const float u = FAST ? hs::bf16_round(dz[at]) : dz[at];
    dd0 += r[0] * u;
    dd1 += r[1] * u;
    dd2 += r[2] * u;
    if constexpr (SUPPORT) db += dproj[at];
  }
  const int E = (SUPPORT ? 4 : 3) * SC;
  float* part = partial + ((size_t)b * gridDim.y + chunk) * E;
  part[c] = dd0;
  part[SC + c] = dd1;
  part[2 * SC + c] = dd2;
  if constexpr (SUPPORT) part[3 * SC + c] = db;
}

// Chunks of dd_partial_kernel: the partial-sum scratch is (parts(B, N), E).
static inline int parts(int B, int N) { return B * ((N + RED_QC - 1) / RED_QC); }

template <bool SUPPORT, bool FAST>
cudaError_t dd_db(const float* verts, const int* idx, const int* win, const float* dz,
                  const float* dproj, float* partial, float* red, int B, int N, int K, int SC,
                  cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)RED_QC * K * 3;
  cudaError_t err = hs::allow_smem(dd_partial_kernel<SUPPORT, FAST>, smem);
  if (err != cudaSuccess) return err;
  dd_partial_kernel<SUPPORT, FAST><<<dim3((SC + THREADS - 1) / THREADS, (N + RED_QC - 1) / RED_QC, B),
                                     THREADS, smem, st>>>(verts, idx, win, dz, dproj, partial, N, K,
                                                          SC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return hs::sum_partials(partial, red, parts(B, N), (SUPPORT ? 4 : 3) * SC, st);
}

// Per source row r of batch b (grid.x = B * N; grid.y tiles the columns):
// SUPPORT: dproj_src[b, r, col] = sum over r's inverse list of dproj[q, col]
// where win[q, col] is the list entry's slot, in list order.  The blocks of
// the first column tile also write dverts[b, r] = (sum over the list of
// drf[q, k]) + dvq[b, r].  FAST rounds each dproj and drf entry to bf16
// before its sum.
template <bool SUPPORT, bool FAST>
__global__ void __launch_bounds__(THREADS)
source_kernel(const int* __restrict__ rowptr, const int* __restrict__ ent,
              const int* __restrict__ win, const float* __restrict__ dproj,
              const float* __restrict__ drf, const float* __restrict__ dvq,
              float* __restrict__ dproj_src, float* __restrict__ dverts, int N, int K, int SC) {
  const size_t row = blockIdx.x;  // b * N + r
  const int b = (int)(row / N), r = (int)(row % N);
  const int* rp = rowptr + (size_t)b * (N + 1);
  const int* eb = ent + (size_t)b * N * K;
  const int lo = rp[r], hi = rp[r + 1];
  if constexpr (SUPPORT) {
    const int c = blockIdx.y * blockDim.x + threadIdx.x;
    if (c < SC) {
      float acc = 0.f;
      for (int p = lo; p < hi; ++p) {
        const int e = eb[p];
        const size_t at = ((size_t)b * N + e / K) * SC + c;
        if (win[at] == e % K) acc += FAST ? hs::bf16_round(dproj[at]) : dproj[at];
      }
      dproj_src[row * SC + c] = acc;
    }
  }
  if (blockIdx.y == 0 && threadIdx.x < 3) {
    const int d = threadIdx.x;
    float s = 0.f;
    for (int p = lo; p < hi; ++p) {
      const float v = drf[((size_t)b * N * K + eb[p]) * 3 + d];
      s += FAST ? hs::bf16_round(v) : v;
    }
    dverts[row * 3 + d] = s + dvq[row * 3 + d];
  }
}

template <bool SUPPORT, bool FAST>
cudaError_t source(const int* rowptr, const int* ent, const int* win, const float* dproj,
                   const float* drf, const float* dvq, float* dproj_src, float* dverts, int B,
                   int N, int K, int SC, cudaStream_t st) {
  const dim3 grid(B * N, SUPPORT ? (SC + THREADS - 1) / THREADS : 1);
  source_kernel<SUPPORT, FAST><<<grid, THREADS, 0, st>>>(rowptr, ent, win, dproj, drf, dvq,
                                                         dproj_src, dverts, N, K, SC);
  return cudaGetLastError();
}

// The steps both backwards share, up to the source rows: the inverse lists,
// the routed cotangents, drf and dvq, dd (and db) into red, then dverts (and
// dproj_src).  Scratch: rowptr (B, N + 1), ent (B, N*K), dz (and dproj)
// (B, N, S*Co), drf (B, N, K, 3), dvq (B, N, 3), partial (parts(B, N), E).
template <bool SUPPORT, bool FAST>
cudaError_t fused_bwd(const float* verts, const int* idx, const float* dirs, const int* win,
                      const float* gb, const float* proj, int* rowptr, int* ent, float* dz,
                      float* dproj, float* drf, float* dvq, float* partial, float* red,
                      float* dproj_src, float* dverts, int B, int N, int K, int S, int Co,
                      cudaStream_t st) {
  const int SC = S * Co;
  cudaError_t err = inverse_index(idx, rowptr, ent, B, N, K, st);
  if (err == cudaSuccess)
    err = route<SUPPORT, FAST>(verts, idx, dirs, win, gb, proj, dz, dproj, B, N, K, S, Co, st);
  if (err == cudaSuccess) {
    rf_grad_kernel<FAST><<<B * N, 32, 0, st>>>(verts, idx, dirs, win, dz, drf, dvq, N, K, SC);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = dd_db<SUPPORT, FAST>(verts, idx, win, dz, dproj, partial, red, B, N, K, SC, st);
  if (err == cudaSuccess)
    err = source<SUPPORT, FAST>(rowptr, ent, win, dproj, drf, dvq, dproj_src, dverts, B, N, K,
                                SC, st);
  return err;
}

// 0 when the backwards take these sizes (K <= 32, the inverse-list counts of
// one batch in shared memory), else 1.
static inline int supported(int N, int K) {
  return (K < 1 || K > 32 || (size_t)N * sizeof(int) > 200 * 1024) ? 1 : 0;
}

}  // namespace hsb
