// Backward pieces of the fused support reduction's backward (K8,
// hs_support.cu), which replaces the body of hspose_tpu/ops/
// pallas_hs_fused.py::_support_bwd_kernel (:420-490), both branches:
// exact=True (fp32) and, with FAST, exact=False (the bf16 tier).  The
// surface reduction's backward (K9, hs_surface.cu) has a kernel of its own
// and takes only RED_QC, parts and supported from here.  No other kernel uses the inverse lists: K10
// (orl.cu) and K18 (chamfer.cu) find their sources' order themselves.
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
//   directions) and dproj (into the projection);
// * rf_grad_kernel: per query, drfn[k] summed over the columns won by k in
//   column order, the cotangent of rf through the normalisation (masked where
//   |rf| < 1e-12, so a duplicated point passes nothing), and the query-centre
//   term dvq = -sum_k drf[k].  A warp per query, RG_TQ queries a block: per
//   chunk of 32 columns the lanes load the query's winners and dz with
//   coalesced reads and keep, per k, the mask of the columns k wins in shared
//   memory beside the directions (staged once for the block); lane
//   3k' + d (k' = k mod 10) then walks its k's columns in column order into
//   drfn[q, k, d], so each sum keeps the order, and the bits, of a serial walk
//   over all columns;
// * dd_partial_kernel: dd (and db) as per-chunk partial sums, added in chunk
//   order by hs::sum_partials;
// * source_proj_kernel (support only): dproj_src[r, col] = the sum of dproj
//   at the entries of r's inverse list whose slot wins col, in list order.  At
//   most one entry of a query wins a column, so that is the sum over the
//   queries q whose winner's source row idx[q, win[q, col]] is r, in
//   increasing q: a thread per column walks the batch's queries in order and
//   adds into a shared-memory row per source row, reading win and dproj once
//   (the kernel before it read them once per list entry, K times);
// * dverts_kernel: dverts = the sum of drf over each source row's inverse
//   list plus dvq, as pallas_hs_fused.py:734 sums them.
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

#include <algorithm>
#include <type_traits>

#include "hs_common.cuh"

namespace hsb {

constexpr int TQ = 8;          // most queries per block of route_kernel
constexpr int THREADS = 128;
constexpr int RED_QC = 64;     // queries per chunk of dd_partial_kernel
constexpr int RG_TQ = 8;       // queries (warps) per block of rf_grad_kernel
constexpr int DD_UNROLL = 8;   // queries whose loads dd_partial_kernel issues together
constexpr int SRC_CT = 64;     // columns (threads) per block of source_proj_kernel
constexpr int SRC_UNROLL = 16;  // queries in flight per thread of source_proj_kernel
constexpr int SRC_SMEM = 96 * 1024;  // most shared memory for a source_proj_kernel block's sums
constexpr int SRC_IDX_SMEM = 64 * 1024;  // most for its neighbour lists (else read from L2)

// idx (B, E) with values in [0, R) -> rowptr (B, R + 1), ent (B, E): the
// entries e with idx[b, e] == r are ent[b, rowptr[b, r] .. rowptr[b, r + 1] - 1],
// in increasing e.  For a neighbour table (B, N, K), R = N and E = N * K with
// e = q * K + k.  One block per batch, NS warps that each own a slice of the
// entries, in order: the slices' per-row counts (smem NS * R ints), then per
// row the start of each slice's run (the rows' counts scanned by one warp),
// then each warp places its slice's entries, 32 at a time, ranking lanes with
// the same row by __match_any_sync.
static __global__ void inverse_index_kernel(const int* __restrict__ idx, int* __restrict__ rowptr,
                                            int* __restrict__ ent, int R, int E, int NS) {
  extern __shared__ int cnt[];  // (NS, R): counts, then the next free place of each slice's run
  const int b = blockIdx.x, wp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* ib = idx + (size_t)b * E;
  int* rp = rowptr + (size_t)b * (R + 1);
  int* eb = ent + (size_t)b * E;
  const int per = (E + NS - 1) / NS, e_lo = min(E, wp * per), e_hi = min(E, e_lo + per);
  for (int r = threadIdx.x; r < NS * R; r += blockDim.x) cnt[r] = 0;
  __syncthreads();
  if (wp < NS)
    for (int e = e_lo + lane; e < e_hi; e += 32) atomicAdd(&cnt[wp * R + ib[e]], 1);  // integer counts
  __syncthreads();
  if (wp == 0) {  // rows in 32 contiguous runs, one a lane: exclusive scan of the row totals
    const int rows = (R + 31) / 32, r_lo = min(R, lane * rows), r_hi = min(R, r_lo + rows);
    int run = 0;
    for (int r = r_lo; r < r_hi; ++r)
      for (int s = 0; s < NS; ++s) run += cnt[s * R + r];
    int incl = run;
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    run = incl - run;
    for (int r = r_lo; r < r_hi; ++r) {
      rp[r] = run;
      for (int s = 0; s < NS; ++s) {
        const int c = cnt[s * R + r];
        cnt[s * R + r] = run;
        run += c;
      }
    }
    if (lane == 31) rp[R] = run;
  }
  __syncthreads();
  if (wp < NS) {
    int* next = cnt + wp * R;
    for (int e0 = e_lo; e0 < e_hi; e0 += 32) {
      const int e = e0 + lane;
      const bool valid = e < e_hi;
      const int r = valid ? ib[e] : -1;
      const unsigned grp = __match_any_sync(0xffffffffu, r);
      const int rank = __popc(grp & ((1u << lane) - 1u));  // earlier lanes with the same row
      const int base = valid ? next[r] : 0;
      __syncwarp();
      if (valid) {
        eb[base + rank] = e;
        if (rank == 0) next[r] = base + __popc(grp);
      }
      __syncwarp();
    }
  }
}

static inline cudaError_t inverse_index(const int* idx, int* rowptr, int* ent, int B, int R, int E,
                                        cudaStream_t st) {
  // up to 8 slices, as many as 200 KB of counts hold
  const int NS = std::max(1, std::min(8, (int)(200 * 1024 / (sizeof(int) * (size_t)R))));
  const size_t smem = sizeof(int) * (size_t)NS * R;
  cudaError_t err = hs::allow_smem(inverse_index_kernel, smem);
  if (err != cudaSuccess) return err;
  inverse_index_kernel<<<B, 256, smem, st>>>(idx, rowptr, ent, R, E, NS);
  return cudaGetLastError();
}

// Per (query, column): k = win[q, col], theta = relu(rfn[q, k] . d[:, col]) as
// the forward forms it (stage_rf, the same expression), gs = gb[q, col % Co] / S;
// dz = theta > 0 ? gs * proj[idx[q, k], col] : 0 and dproj = gs * theta, all
// unrounded.  One block per (batch, TQB queries); a thread per column issues
// its queries' loads together.
template <bool FAST, int TQB>
__global__ void __launch_bounds__(THREADS)
route_kernel(const float* __restrict__ verts, const int* __restrict__ idx,
             const float* __restrict__ dirs, const int* __restrict__ win,
             const float* __restrict__ gb, const float* __restrict__ proj,
             float* __restrict__ dz, float* __restrict__ dproj, int N, int K, int S, int Co) {
  extern __shared__ float smem[];
  const int SC = S * Co;
  float* sd = smem;                                       // (3, S*Co)
  float* srf = sd + 3 * SC;                               // (TQB, K, 3)
  int* sidx = reinterpret_cast<int*>(srf + TQB * K * 3);  // (TQB, K)
  const int b = blockIdx.y, q0 = blockIdx.x * TQB;
  hs::stage_dirs<FAST>(dirs, sd, SC);
  hs::stage_rf<FAST>(verts, idx, srf, sidx, b, q0, TQB, N, K);
  __syncthreads();

  const int tq = min(TQB, N - q0);
  for (int c = threadIdx.x; c < SC; c += blockDim.x) {
    const float d0 = sd[c], d1 = sd[SC + c], d2 = sd[2 * SC + c];
    // the block's queries' loads together (indices clamped), then their outputs
    int k[TQB];
    float g[TQB], p[TQB];
#pragma unroll
    for (int t = 0; t < TQB; ++t) {
      const size_t q = (size_t)b * N + q0 + min(t, tq - 1);
      k[t] = win[q * SC + c];
      g[t] = gb[q * Co + c % Co];
    }
#pragma unroll
    for (int t = 0; t < TQB; ++t)
      p[t] = proj[((size_t)b * N + sidx[min(t, tq - 1) * K + k[t]]) * SC + c];
#pragma unroll
    for (int t = 0; t < TQB; ++t) {
      if (t >= tq) break;
      const size_t at = ((size_t)b * N + q0 + t) * SC + c;
      const float* r = srf + (t * K + k[t]) * 3;
      const float theta = fmaxf(r[0] * d0 + r[1] * d1 + r[2] * d2, 0.f);
      const float gs = hs::div_s<FAST>(g[t], S);
      dz[at] = theta > 0.f ? gs * p[t] : 0.f;
      dproj[at] = gs * theta;
    }
  }
}

template <bool FAST, int TQB>
cudaError_t route_tq(const float* verts, const int* idx, const float* dirs, const int* win,
                     const float* gb, const float* proj, float* dz, float* dproj, int B, int N,
                     int K, int S, int Co, cudaStream_t st) {
  const size_t smem = sizeof(float) * (3 * (size_t)S * Co + (size_t)TQB * K * 3) +
                      sizeof(int) * (size_t)TQB * K;
  cudaError_t err = hs::allow_smem(route_kernel<FAST, TQB>, smem);
  if (err != cudaSuccess) return err;
  route_kernel<FAST, TQB><<<dim3((N + TQB - 1) / TQB, B), THREADS, smem, st>>>(
      verts, idx, dirs, win, gb, proj, dz, dproj, N, K, S, Co);
  return cudaGetLastError();
}

// TQ queries per block, or 2 where the blocks would not fill the card.
template <bool FAST>
cudaError_t route(const float* verts, const int* idx, const float* dirs, const int* win,
                  const float* gb, const float* proj, float* dz, float* dproj, int B, int N, int K,
                  int S, int Co, cudaStream_t st) {
  if ((long)B * ((N + TQ - 1) / TQ) >= 4 * 132)
    return route_tq<FAST, TQ>(verts, idx, dirs, win, gb, proj, dz, dproj, B, N, K, S, Co, st);
  return route_tq<FAST, 2>(verts, idx, dirs, win, gb, proj, dz, dproj, B, N, K, S, Co, st);
}

// drfn, drf and dvq.  Block: RG_TQ warps, one query each; the block stages
// the directions (FAST: rounded to bf16, held as fp64 like the chunk's dz, so
// that the walk converts nothing) in shared memory once, and then
// each warp walks its query's chunks of 32 columns on its own: lane j holds
// column j's winner and dz (FAST: rounded to bf16) and writes the dz into
// shared memory, and one __match_any_sync gives, for each k, the chunk's
// columns that k wins, kept in shared memory.  Lane 3k' + d (k' < 10) walks,
// for k = k' + 10 s, those columns in column order: drfn[q, k, d] = the sum
// of dz[q, c] * d[d, c] over the columns c that k wins, from 0 in increasing
// c.  Then lane k takes its three sums from shared memory and forms drf[q, k],
// the cotangent of rf = v[idx[q, k]] - v[q] through rfn = rf / max(|rf|,
// 1e-12) (pallas_hs_fused.py::_rf_chain_bwd), and dvq[q] = -sum_k drf[q, k]
// in k order.  FAST: dz and the directions as bf16 operands, rf from xyz
// rounded to bf16.  Each row of drf is then rounded to bf16 before its
// source-row sum, so the row must not depend on an order of summation: drfn
// sums its exact products in fp64 and is rounded to fp32 once, and the chain
// takes the fp32 steps of ops/cuda_hs_fused.py::_rf_grad_fast in its order
// (__f*_rn, no fusing).
template <bool FAST>
__global__ void __launch_bounds__(RG_TQ * 32)
rf_grad_kernel(const float* __restrict__ verts, const int* __restrict__ idx,
               const float* __restrict__ dirs, const int* __restrict__ win,
               const float* __restrict__ dz, float* __restrict__ drf, float* __restrict__ dvq,
               int rows, int N, int K, int SC) {
  using Acc = std::conditional_t<FAST, double, float>;
  constexpr int NR = 4;  // sums per lane: k = k' + 10 s, K <= 32
  constexpr unsigned ALL = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char rg_smem[];
  Acc* sd = reinterpret_cast<Acc*>(rg_smem);  // (3, SC): the directions, as the sums' type
  __shared__ Acc su_[RG_TQ][32];       // per warp: the chunk's dz
  __shared__ unsigned sm_[RG_TQ][32];  // per warp: the chunk's columns that each k wins
  __shared__ float sg_[RG_TQ][96];     // per warp: drfn[k][d], for lane k
  const int lane = threadIdx.x % 32, wp = threadIdx.x / 32;
  const size_t q = (size_t)blockIdx.x * RG_TQ + wp;
  const bool live = q < (size_t)rows;
  const int rk = lane < 30 ? lane / 3 : -1, rd = lane % 3;
  Acc* su = su_[wp];
  unsigned* smask = sm_[wp];
  const Acc* sdd = sd + rd * SC;
  for (int e = threadIdx.x; e < 3 * SC; e += blockDim.x)
    sd[e] = (Acc)(FAST ? hs::bf16_round(dirs[e]) : dirs[e]);
  __syncthreads();
  if (!live) return;
  Acc racc[NR];
#pragma unroll
  for (int s = 0; s < NR; ++s) racc[s] = 0;

  // the chunk at c0 + lane: this lane's winner and dz, loaded a chunk ahead
  int kn = -1;
  float un = 0.f;
  auto fetch = [&](int c0) {
    const int c = c0 + lane;
    kn = -1;
    un = 0.f;
    if (c < SC) {
      kn = win[q * SC + c];
      un = dz[q * SC + c];
    }
  };
  fetch(0);
  for (int c0 = 0; c0 < SC; c0 += 32) {
    const int kl = kn;
    const float u = FAST ? hs::bf16_round(un) : un;
    if (c0 + 32 < SC) fetch(c0 + 32);
    // each k's columns of the chunk: the lanes that hold a winner write the
    // mask of the lanes with the same winner (one match instead of a ballot
    // per k); masks of winners absent from the chunk stay 0
    // a column whose dz is 0 adds +-0 to a sum that is never -0: left out
    const int kz = u != 0.f ? kl : -1;
    const unsigned same = __match_any_sync(ALL, kz);
    __syncwarp();  // the previous chunk is no longer read
    su[lane] = (Acc)u;
    if (lane < K) smask[lane] = 0u;
    __syncwarp();
    if (kz >= 0) smask[kz] = same;
    __syncwarp();
#pragma unroll
    for (int s = 0; s < NR; ++s) {
      const int k = rk + 10 * s;
      if (rk >= 0 && k < K) {
        unsigned m = smask[k];
        while (m) {
          const int j = __ffs(m) - 1;
          m &= m - 1;
          if constexpr (FAST)  // exact products of bf16 operands
            racc[s] += su[j] * sdd[c0 + j];
          else
            racc[s] = fmaf(su[j], sdd[c0 + j], racc[s]);
        }
      }
    }
  }
  float* sg = sg_[wp];
#pragma unroll
  for (int s = 0; s < NR; ++s) {
    const int k = rk + 10 * s;
    if (rk >= 0 && k < K) sg[k * 3 + rd] = (float)racc[s];
  }
  __syncwarp();
  const int k = lane;
  float g0 = 0.f, g1 = 0.f, g2 = 0.f;
  if (k < K) {
    const float a0 = sg[k * 3], a1 = sg[k * 3 + 1], a2 = sg[k * 3 + 2];
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
      const float s = __fadd_rn(__fadd_rn(__fmul_rn(a0, r0), __fmul_rn(a1, r1)), __fmul_rn(a2, r2));
      const float h = norm >= 1e-12f ? __fmul_rn(__fmul_rn(__fmul_rn(s, inv), inv), inv) : 0.f;
      g0 = __fsub_rn(__fmul_rn(a0, inv), __fmul_rn(r0, h));
      g1 = __fsub_rn(__fmul_rn(a1, inv), __fmul_rn(r1, h));
      g2 = __fsub_rn(__fmul_rn(a2, inv), __fmul_rn(r2, h));
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
    c0 -= __shfl_sync(ALL, g0, j);
    c1 -= __shfl_sync(ALL, g1, j);
    c2 -= __shfl_sync(ALL, g2, j);
  }
  if (k == 0) {
    dvq[q * 3] = c0;
    dvq[q * 3 + 1] = c1;
    dvq[q * 3 + 2] = c2;
  }
}

// Partial sums over chunks of RED_QC queries, one row of E = 4 * S*Co per
// (batch, chunk): dd[d, col] = sum_q rfn[q, win[q, col]][d] * dz[q, col] and
// db[col] = sum_q dproj[q, col].  FAST: rfn (as staged) and dz as bf16
// operands; db unrounded.
template <bool FAST>
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
  for (int t0 = 0; t0 < tq; t0 += DD_UNROLL) {
    // the group's loads together (indices clamped), then its adds in order
    int k[DD_UNROLL];
    float u[DD_UNROLL], p[DD_UNROLL];
#pragma unroll
    for (int j = 0; j < DD_UNROLL; ++j) {
      const size_t at = ((size_t)b * N + q0 + min(t0 + j, tq - 1)) * SC + c;
      k[j] = win[at];
      u[j] = dz[at];
      p[j] = dproj[at];
    }
#pragma unroll
    for (int j = 0; j < DD_UNROLL; ++j) {
      if (t0 + j < tq) {
        const float* r = srf + ((t0 + j) * K + k[j]) * 3;
        const float uj = FAST ? hs::bf16_round(u[j]) : u[j];
        dd0 += r[0] * uj;
        dd1 += r[1] * uj;
        dd2 += r[2] * uj;
        db += p[j];
      }
    }
  }
  const int E = 4 * SC;
  float* part = partial + ((size_t)b * gridDim.y + chunk) * E;
  part[c] = dd0;
  part[SC + c] = dd1;
  part[2 * SC + c] = dd2;
  part[3 * SC + c] = db;
}

// Chunks of dd_partial_kernel: the partial-sum scratch is (parts(B, N), E).
static inline int parts(int B, int N) { return B * ((N + RED_QC - 1) / RED_QC); }

template <bool FAST>
cudaError_t dd_db(const float* verts, const int* idx, const int* win, const float* dz,
                  const float* dproj, float* partial, float* red, int B, int N, int K, int SC,
                  cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)RED_QC * K * 3;
  cudaError_t err = hs::allow_smem(dd_partial_kernel<FAST>, smem);
  if (err != cudaSuccess) return err;
  dd_partial_kernel<FAST><<<dim3((SC + THREADS - 1) / THREADS, (N + RED_QC - 1) / RED_QC, B),
                            THREADS, smem, st>>>(verts, idx, win, dz, dproj, partial, N, K, SC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return hs::sum_partials(partial, red, parts(B, N), 4 * SC, st);
}

// dproj_src (B, N, S*Co): see source_proj_kernel above.  Block: SRC_CT
// columns (a thread each), R source rows (blockIdx.y: rows r0 .. r0 + R - 1,
// their sums in shared memory) and one batch (blockIdx.z), whose neighbour
// lists are staged in shared memory too where they fit.  Each thread walks the batch's
// queries in increasing q, SRC_UNROLL at a time (their loads in flight
// together, their adds in order), and adds dproj[q, col] (FAST: rounded to
// bf16) into the row of its winner's source when that lies in the block's
// range.  Each thread reads and writes only its own column of the shared rows.
template <bool FAST, bool STAGE>
__global__ void __launch_bounds__(SRC_CT)
source_proj_kernel(const int* __restrict__ idx, const int* __restrict__ win,
                   const float* __restrict__ dproj, float* __restrict__ dproj_src, int N, int K,
                   int SC, int R) {
  extern __shared__ float acc[];  // (R, SRC_CT), then (STAGE) the batch's lists (N, K)
  int* slist = reinterpret_cast<int*>(acc + (size_t)R * SRC_CT);
  const int b = blockIdx.z, r0 = blockIdx.y * R, nr = min(R, N - r0);
  const int t = threadIdx.x, c = blockIdx.x * SRC_CT + t;
  const size_t base = (size_t)b * N;
  if constexpr (STAGE) {
    for (int e = t; e < N * K; e += SRC_CT) slist[e] = idx[base * K + e];
    __syncthreads();
  }
  if (c >= SC) return;
  for (int r = 0; r < nr; ++r) acc[r * SRC_CT + t] = 0.f;
  for (int q0 = 0; q0 < N; q0 += SRC_UNROLL) {
    // straight-line loads: all winners and values, then their source rows,
    // then the adds in order
    int k[SRC_UNROLL];
    float v[SRC_UNROLL];
#pragma unroll
    for (int u = 0; u < SRC_UNROLL; ++u) {
      const size_t at = (base + min(q0 + u, N - 1)) * SC + c;
      k[u] = __ldg(win + at);
      v[u] = __ldg(dproj + at);
    }
#pragma unroll
    for (int u = 0; u < SRC_UNROLL; ++u) {
      const int e = min(q0 + u, N - 1) * K + k[u];
      k[u] = (STAGE ? slist[e] : __ldg(idx + base * K + e)) - r0;
    }
#pragma unroll
    for (int u = 0; u < SRC_UNROLL; ++u)
      if (q0 + u < N && k[u] >= 0 && k[u] < nr)
        acc[k[u] * SRC_CT + t] += FAST ? hs::bf16_round(v[u]) : v[u];
  }
  for (int r = 0; r < nr; ++r) dproj_src[(base + r0 + r) * SC + c] = acc[r * SRC_CT + t];
}

// Source rows per block of source_proj_kernel: all N where their sums fit
// in SRC_SMEM bytes, else ranges of the most that fit.
static inline int source_rows(int N) {
  const int most = SRC_SMEM / (SRC_CT * (int)sizeof(float));
  return N < most ? N : most;
}

template <bool FAST>
cudaError_t source_proj(const int* idx, const int* win, const float* dproj, float* dproj_src,
                        int B, int N, int K, int SC, cudaStream_t st) {
  const int R = source_rows(N);
  const size_t lists = sizeof(int) * (size_t)N * K;
  const bool stage = lists <= SRC_IDX_SMEM;
  const size_t smem = sizeof(float) * (size_t)R * SRC_CT + (stage ? lists : 0);
  auto kernel = stage ? source_proj_kernel<FAST, true> : source_proj_kernel<FAST, false>;
  cudaError_t err = hs::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((SC + SRC_CT - 1) / SRC_CT, (N + R - 1) / R, B), SRC_CT, smem, st>>>(
      idx, win, dproj, dproj_src, N, K, SC, R);
  return cudaGetLastError();
}

// dverts[b, r, d] = (the sum over r's inverse list of drf[q, k, d]) + dvq[b, r, d],
// in list order; FAST rounds each drf entry to bf16 before its sum.  A thread
// per (row, d).
template <bool FAST>
__global__ void __launch_bounds__(THREADS)
dverts_kernel(const int* __restrict__ rowptr, const int* __restrict__ ent,
              const float* __restrict__ drf, const float* __restrict__ dvq,
              float* __restrict__ dverts, int B, int N, int K) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)B * N * 3) return;
  const size_t row = e / 3;
  const int d = (int)(e % 3), b = (int)(row / N), r = (int)(row % N);
  const int* rp = rowptr + (size_t)b * (N + 1);
  const int* eb = ent + (size_t)b * N * K;
  float s = 0.f;
  for (int p = rp[r]; p < rp[r + 1]; ++p) {
    const float v = drf[((size_t)b * N * K + eb[p]) * 3 + d];
    s += FAST ? hs::bf16_round(v) : v;
  }
  dverts[e] = s + dvq[e];
}

// K8's steps up to the source rows' products: the inverse lists, the routed
// cotangents, drf and dvq, dd and db into red, dproj_src, then dverts.
// Scratch: rowptr (B, N + 1), ent (B, N*K), dz and dproj (B, N, S*Co), drf
// (B, N, K, 3), dvq (B, N, 3), partial (parts(B, N), 4 * S*Co).
template <bool FAST>
cudaError_t fused_bwd(const float* verts, const int* idx, const float* dirs, const int* win,
                      const float* gb, const float* proj, int* rowptr, int* ent, float* dz,
                      float* dproj, float* drf, float* dvq, float* partial, float* red,
                      float* dproj_src, float* dverts, int B, int N, int K, int S, int Co,
                      cudaStream_t st) {
  const int SC = S * Co;
  cudaError_t err = inverse_index(idx, rowptr, ent, B, N, N * K, st);
  if (err == cudaSuccess)
    err = route<FAST>(verts, idx, dirs, win, gb, proj, dz, dproj, B, N, K, S, Co, st);
  if (err == cudaSuccess) {
    // the directions beside the kernel's static shared memory: opt in at any size
    const size_t smem = (FAST ? sizeof(double) : sizeof(float)) * 3 * (size_t)SC;
    err = cudaFuncSetAttribute(rf_grad_kernel<FAST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess) {
      rf_grad_kernel<FAST><<<(B * N + RG_TQ - 1) / RG_TQ, RG_TQ * 32, smem, st>>>(
          verts, idx, dirs, win, dz, drf, dvq, B * N, N, K, SC);
      err = cudaGetLastError();
    }
  }
  if (err == cudaSuccess)
    err = dd_db<FAST>(verts, idx, win, dz, dproj, partial, red, B, N, K, SC, st);
  if (err == cudaSuccess)
    err = source_proj<FAST>(idx, win, dproj, dproj_src, B, N, K, SC, st);
  if (err == cudaSuccess) {
    dverts_kernel<FAST><<<(B * N * 3 + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        rowptr, ent, drf, dvq, dverts, B, N, K);
    err = cudaGetLastError();
  }
  return err;
}

// 0 when the backwards take these sizes (K <= 32, the inverse-list counts of
// one batch in shared memory), else 1.
static inline int supported(int N, int K) {
  return (K < 1 || K > 32 || (size_t)N * sizeof(int) > 200 * 1024) ? 1 : 0;
}

}  // namespace hsb
