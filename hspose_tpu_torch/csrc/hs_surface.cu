// HS surface reduction (conv_0): out = mean_s max_k relu(normalize(v[idx] - v) . dir_s).
//
// Replaces: hspose_tpu/ops/pallas_hs_fused.py::_surface_fwd_kernel, reached
// through hs_surface_fused.  Plain version: hspose_tpu_torch/ops/
// cuda_hs_fused.py::hs_surface_plain.
//
// What bounds it on an H100: at conv_0 (B=24, N=1028, K=20, S=7, Co=128) it
// does about 1.3e9 multiply-adds and reads only the (B, N, 3) points and the
// (B, N, K) indices; the (B, N, K, Co) theta tensor that the plain version
// writes per support (253 MB) never exists.  Per (query, k, channel, support)
// theta is three fp32 operations and the max a fourth, so the limit is the
// rate at which the SMs issue them (0.040 ms of fp32 peak counts only the
// multiply-adds).  The kernel this one replaced paid a shared-memory load
// per multiply-add: it reloaded the rf row for every support and the
// support's directions for every query.
//
// Design: one block per (batch, TQ-query tile), 128 threads.  The block
// stages the unit rf rows of its TQ x K neighbours with their index as one
// float4 each (hs::stage_rf, PACK4), then runs the reduction body it shares
// with the training path's forward K12 (hs_surface.cuh): each thread holds
// one output channel's 3 x S directions in registers and reads each
// neighbour's rf row once per query, updating S running maxima; the
// replaced kernel reloaded the rf row for every support and the support's
// directions for every query.  The Pallas one-hot MXU gather is a plain
// indexed load here.
//
// FAST is the bf16 tier (exact=False of the same TPU kernel): the staged rf
// rows and the directions are rounded as hs_common.cuh says, the rest is
// unchanged; every product is then exact, accumulation and output stay fp32.
//
// The query-sharded branch (hs_surface_qs; sequence-parallel serving,
// pallas_hs_fused.py's vertices_q, _surface_prep :738-762) stages the centres
// from a second pointer of NQ rows and the neighbours from the M gathered
// source rows; only addresses change, so each query's output has the bits
// the one-device launch gives the same row.
//
// WIN is the forward of the differentiable op, either tier (want_win=True of
// the same TPU kernel, pallas_hs_fused.py:318-330): it also records, per
// (point, support column), the first k that reaches the max of relu(theta),
// for the backward (hs_surface.cuh says how).  The serving instantiations
// (WIN false) are compiled from the same lines.
//
// The backward (K9, hs_surface_fused_bwd below) replaces
// hspose_tpu/ops/pallas_hs_fused.py::_surface_bwd_kernel (exact=True, and
// exact=False with fast != 0): dverts and dd from win and the output
// cotangent, in three launches (fused_bwd_kernel, hs::sum_tiles_kernel,
// dverts_rows_kernel; the design is described above them).  Plain versions:
// hspose_tpu_torch/ops/cuda_hs_fused.py::hs_surface_fused_fwd_plain and
// hs_surface_fused_bwd_plain.  What bounds it: one read of the (B, N, S*Co)
// winners (59 MB at B=16, conv_0), about 10 operations per (point, column),
// and the latency of dverts' in-order sums; no atomics on floats, so every
// sum has a fixed order.

#include "hs_fused_bwd.cuh"
#include "hs_surface.cuh"

namespace {

constexpr int TQ = 32;  // queries per block
constexpr int THREADS = 128;

// One block per (query tile, batch): the block stages its queries' unit rf
// rows, then hs_surface.cuh's body reduces them.  KT = K and ST = S unrolled
// (0: read at run time).
template <bool FAST, bool WIN, int KT, int ST>
__global__ void __launch_bounds__(THREADS)
surface_kernel(const float* __restrict__ verts, const float* __restrict__ vq,
               const int* __restrict__ idx, const float* __restrict__ dirs,
               float* __restrict__ out, int* __restrict__ win, int NQ, int N, int K_arg,
               int S_arg, int Co) {
  extern __shared__ __align__(16) float4 srf[];  // (TQ, K): unit rf, index bits
  const int K = KT ? KT : K_arg;
  const int b = blockIdx.y, q0 = blockIdx.x * TQ;
  hs::stage_rf<FAST, true>(verts, vq, idx, reinterpret_cast<float*>(srf), nullptr, b, q0, TQ, NQ,
                           N, K);
  __syncthreads();
  hss::reduce_rows<FAST, WIN, KT, ST, THREADS>(srf, dirs, out, win, (size_t)b * NQ + q0,
                                               min(TQ, NQ - q0), K, S_arg, Co);
}

// vq (B, NQ, 3) holds the query centres; verts (B, N, 3) the source rows
// that idx names (vq = verts, NQ = N but in the query-sharded branch).
template <bool FAST, bool WIN, int KT, int ST>
int launch_k(const float* verts, const float* vq, const int* idx, const float* dirs, float* out,
             int* win, int B, int NQ, int N, int K, int S, int Co, cudaStream_t stream) {
  auto kernel = surface_kernel<FAST, WIN, KT, ST>;
  const size_t smem = sizeof(float4) * (size_t)TQ * K;
  cudaError_t err = hs::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((NQ + TQ - 1) / TQ, B), THREADS, smem, stream>>>(verts, vq, idx, dirs, out, win,
                                                                 NQ, N, K, S, Co);
  return (int)cudaGetLastError();
}

template <bool FAST, bool WIN = false>
int launch(const float* verts, const float* vq, const int* idx, const float* dirs, float* out,
           int* win, int B, int NQ, int N, int K, int S, int Co, cudaStream_t stream) {
  if (K == 20 && S == 7)  // the model's conv_0
    return launch_k<FAST, WIN, 20, 7>(verts, vq, idx, dirs, out, win, B, NQ, N, K, S, Co, stream);
  return launch_k<FAST, WIN, 0, 0>(verts, vq, idx, dirs, out, win, B, NQ, N, K, S, Co, stream);
}

// ---------------------------------------------------------------------------
// K9: the backward of the differentiable surface reduction.
//
// fused_bwd_kernel: one block per (64 queries, batch), the chunk of dd's
// partial sums (hsb::RED_QC), so dd keeps its order; the routed cotangent
// never leaves shared memory.  The block stages its queries' neighbour
// indices (their loads in flight together) and rf rows, unit (hs::unit_rf,
// the code hs::stage_rf runs for the route and dd kernels of the design
// before) and raw, for the chain; fp32 also stages gb/S per (query,
// channel) where it fits SG_MAX.  Then it takes the S*Co columns in chunks
// of BCC, double-buffered: four router warps route the next chunk while two
// walk warps sum the current one.
// * Routing: thread (w, l) takes column l of the chunk for queries 16 w ..
//   16 w + 15: the winner and gb (loaded a chunk ahead, coalesced, so win is
//   read once), theta at the winner as the design before formed it (its
//   SASS: y product first, then fused x and z), and u = [theta > 0] gb/S
//   (hs::div_s; rounded to bf16 under FAST, where the design before rounded
//   its dz), into the chunk's buffer.  Then the
//   chunk's dd rows: dd[d, col] = fma(rfn[q, win][d], u, dd) over the
//   block's queries in order from 0.f, each warp continuing the chain from
//   the warp before (a named barrier hands the three sums on) with the rf
//   values theta read, so dd costs three fused multiply-adds a pair.
// * The walk: lane t of a walk warp adds the chunk's columns into drfn[q, k,
//   d] in column order, one chain per sum from 0 in shared memory, k-major
//   with a query per bank; the sum of the column two ahead is loaded before
//   this column's is stored and taken from registers when one of the two
//   columns stored since has its winner (K15's walk).  fp32: fmaf(u, d, acc);
//   FAST: fp64 sums of the exact products of the bf16 operands, rounded to
//   fp32 once.  A column whose u is 0 adds +-0 to a sum that is never -0, so
//   the sums equal those that leave such columns out.
// Then a thread per (query, k) runs the rf chain to drf (rf_chain below) on
// the staged raw rf, and a thread per (query, d) sums dvq = -sum_k drf in k
// order.  With 168 registers a thread and about 100 KB of shared memory two
// blocks share an SM; the kernel is bound by the latency of the walk's and
// the routing's shared-memory chains, not by its bytes.
// hs::sum_tiles_kernel adds the partial rows in part order, batch-major,
// from 0.f; dverts_rows_kernel adds each source row's drf entries in
// inverse-list order (FAST: each rounded to bf16) onto dvq, with no lists.
//
// The design before it wrote the routed cotangent dz, (B, N, S*Co) fp32, and
// read it back twice, read win three times, built the inverse lists with one
// block per batch, and summed the partial rows by one dependent load a row
// per thread: six launches.

constexpr int BQ = hsb::RED_QC;      // queries per block: dd's partial-sum unit
constexpr int BCC = 32;              // columns per chunk
constexpr int BCP = BCC + 1;         // a chunk buffer's row, padded
constexpr int WALK_WARPS = BQ / 32;  // lane t of walk warp w sums query 32 w + t
constexpr int ROUTE_WARPS = 4;       // route the next chunk, then chain its dd rows
constexpr int A_ROWS = BQ / ROUTE_WARPS;  // queries a router thread routes per chunk
constexpr int SG_MAX = 48 * 1024;    // most bytes of staged gb / S (fp32)
constexpr int BWD_THREADS = 32 * (WALK_WARPS + ROUTE_WARPS);
static_assert(BWD_THREADS >= 3 * BQ, "a thread per (query, d) sums dvq");

constexpr int VR = 256;            // source rows per block of dverts_rows_kernel, a thread each
constexpr int VS = 32;             // its warps: the slices of a window
constexpr int VTHREADS = 32 * VS;
constexpr int VW_MAX = 32 * 1024;  // most entries per window (their list: 128 KB)
constexpr int VU = 8;              // loads in flight per lane in dverts_rows_kernel

// The cotangent of rf = v[idx] - c through rfn = rf / max(|rf|, 1e-12), from
// drfn (a0, a1, a2), as the design before formed it: FAST the fp32 steps of
// ops/cuda_hs_fused.py::_rf_grad_fast (rf on xyz rounded to bf16); fp32 the
// chain as nvcc compiled rf_grad_kernel's expressions (its SASS), each
// contraction written out: |rf|^2 and s = drfn . rf the y product first,
// then fused multiply-adds of x and z; g = fma(a, inv, -(r * h)).
template <bool FAST>
__device__ __forceinline__ void rf_chain(const float* rf, float a0, float a1, float a2, float* g) {
  const float r0 = rf[0], r1 = rf[1], r2 = rf[2];
  if constexpr (FAST) {
    const float norm = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(r0, r0), __fmul_rn(r1, r1)),
                                            __fmul_rn(r2, r2)));
    const float inv = __fdiv_rn(1.f, fmaxf(norm, 1e-12f));
    const float s = __fadd_rn(__fadd_rn(__fmul_rn(a0, r0), __fmul_rn(a1, r1)), __fmul_rn(a2, r2));
    const float h = norm >= 1e-12f ? __fmul_rn(__fmul_rn(__fmul_rn(s, inv), inv), inv) : 0.f;
    g[0] = __fsub_rn(__fmul_rn(a0, inv), __fmul_rn(r0, h));
    g[1] = __fsub_rn(__fmul_rn(a1, inv), __fmul_rn(r1, h));
    g[2] = __fsub_rn(__fmul_rn(a2, inv), __fmul_rn(r2, h));
  } else {
    const float norm = __fsqrt_rn(__fmaf_rn(r2, r2, __fmaf_rn(r0, r0, __fmul_rn(r1, r1))));
    const float inv = __fdiv_rn(1.f, fmaxf(norm, 1e-12f));
    const float s = __fmaf_rn(a2, r2, __fmaf_rn(a0, r0, __fmul_rn(a1, r1)));
    const float h = norm >= 1e-12f ? __fmul_rn(__fmul_rn(__fmul_rn(s, inv), inv), inv) : 0.f;
    g[0] = __fmaf_rn(a0, inv, -__fmul_rn(r0, h));
    g[1] = __fmaf_rn(a1, inv, -__fmul_rn(r1, h));
    g[2] = __fmaf_rn(a2, inv, -__fmul_rn(r2, h));
  }
}

// KT = K unrolled (0: read at run time).
template <bool FAST, bool STAGE_G, int KT>
__global__ void __launch_bounds__(BWD_THREADS)
fused_bwd_kernel(const float* __restrict__ verts, const int* __restrict__ idx,
                 const float* __restrict__ dirs, const int* __restrict__ win,
                 const float* __restrict__ gb, float* __restrict__ drf,
                 float* __restrict__ dvq, float* __restrict__ partial, int N, int K_arg, int S,
                 int Co) {
  const int K = KT ? KT : K_arg;
  using Acc = std::conditional_t<FAST, double, float>;
  extern __shared__ __align__(16) unsigned char fb_smem[];
  Acc* sacc = reinterpret_cast<Acc*>(fb_smem);               // (3, K, BQ): drfn as summed
  float4* sdc = reinterpret_cast<float4*>(sacc + 3 * K * BQ);  // (2, BCC): directions
  float* srf = reinterpret_cast<float*>(sdc + 2 * BCC);      // (BQ, K, 3): unit rf, then drf
  float* sraw = srf + 3 * BQ * K;                            // (BQ, K, 3): rf
  float* su = sraw + 3 * BQ * K;                             // (2, BQ, BCP): gated cotangent
  float* sdd = su + 2 * BQ * BCP;                            // (ROUTE_WARPS - 1, 3, BCC)
  int* sidx = reinterpret_cast<int*>(sdd + (ROUTE_WARPS - 1) * 3 * BCC);  // (BQ, K)
  float* sg = reinterpret_cast<float*>(sidx + BQ * K);       // STAGE_G: (BQ, Co) gb / S
  unsigned char* sk = reinterpret_cast<unsigned char*>(sg + (STAGE_G ? BQ * Co : 0));  // as su
  const int SC = S * Co, nch = (SC + BCC - 1) / BCC, DQ = K * BQ;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, rw = warp - WALK_WARPS;
  const int b = blockIdx.y, q0 = blockIdx.x * BQ, tq = min(BQ, N - q0);
  const size_t row0 = (size_t)b * N + q0;

  // the queries' neighbour indices (their loads in flight together), then
  // their rf rows, unit (as hs::stage_rf stages them) and raw; rows past N 0
#pragma unroll 4
  for (int e = threadIdx.x; e < tq * K; e += BWD_THREADS) sidx[e] = idx[row0 * K + e];
  for (int e = threadIdx.x; e < 3 * DQ; e += BWD_THREADS) sacc[e] = 0;
  if constexpr (STAGE_G) {
    for (int e = threadIdx.x; e < tq * Co; e += BWD_THREADS)
      sg[e] = hs::div_s<FAST>(gb[row0 * Co + e], S);
  }
  __syncthreads();
#pragma unroll 2
  for (int e = threadIdx.x; e < DQ; e += BWD_THREADS) {
    const int t = e / K;
    float raw[3] = {0.f, 0.f, 0.f}, unit[3] = {0.f, 0.f, 0.f};
    if (t < tq)
      hs::unit_rf<FAST>(verts + ((size_t)b * N + sidx[e]) * 3, verts + (row0 + t) * 3, raw, unit);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      srf[e * 3 + d] = unit[d];
      sraw[e * 3 + d] = raw[d];
    }
  }

  // routing, by the router warps: thread (rw, lane) takes column ch * BCC +
  // lane of queries rw * A_ROWS ..; a query past the block reads row tq - 1
  // (its sums are not used), a column past S*Co routes u = 0.  A chunk's
  // winners, gb and directions are loaded a chunk ahead of their use.
  int kw[A_ROWS];
  float gw[STAGE_G ? 1 : A_ROWS];
  float4 dw;
  auto fetch = [&](int ch) {
    const int c = min(ch * BCC + lane, SC - 1), chan = c % Co;
#pragma unroll
    for (int e = 0; e < A_ROWS; ++e) {
      const size_t q = row0 + min(rw * A_ROWS + e, tq - 1);
      kw[e] = win[q * SC + c];
      if constexpr (!STAGE_G) gw[e] = gb[q * Co + chan];
    }
    dw = make_float4(dirs[c], dirs[SC + c], dirs[2 * SC + c], 0.f);
    if constexpr (FAST)
      dw = make_float4(hs::bf16_round(dw.x), hs::bf16_round(dw.y), hs::bf16_round(dw.z), 0.f);
  };
  // route a chunk, then add its dd rows: router warp w continues the chain
  // of dd[d, col] = fma(rfn[q, win][d], u, dd) from warp w - 1's last query
  // (warp 0 from 0.f), over its own queries in order, from the rf values
  // theta read (a query past N adds fma(r, 0, dd) = dd); warp 3 writes the
  // block's row of partial sums
  auto route = [&](int ch, int buf) {
    const int c = ch * BCC + lane, chan = min(c, SC - 1) % Co;
    const float4 d = dw;
    if (rw == 0) sdc[buf * BCC + lane] = d;
    float r0[A_ROWS], r1[A_ROWS], r2[A_ROWS], uu[A_ROWS];
#pragma unroll
    for (int e = 0; e < A_ROWS; ++e) {
      const float* r = srf + (min(rw * A_ROWS + e, tq - 1) * K + kw[e]) * 3;
      r0[e] = r[0];
      r1[e] = r[1];
      r2[e] = r[2];
    }
#pragma unroll
    for (int e = 0; e < A_ROWS; ++e) {
      const int t = rw * A_ROWS + e;
      float u;
      if constexpr (STAGE_G) {
        u = sg[min(t, tq - 1) * Co + chan];
      } else {
        u = hs::div_s<FAST>(gw[e], S);
        if constexpr (FAST) u = hs::bf16_round(u);
      }
      // theta as the design before formed it: its r0 d0 + r1 d1 + r2 d2
      // compiled to the y product first, then fused x and z (FAST's products
      // are exact)
      const float theta = __fmaf_rn(r2[e], d.z, __fmaf_rn(r0[e], d.x, __fmul_rn(r1[e], d.y)));
      u = c < SC && theta > 0.f ? u : 0.f;
      su[(buf * BQ + t) * BCP + lane] = u;
      sk[(buf * BQ + t) * BCP + lane] = (unsigned char)kw[e];
      uu[e] = t < tq ? u : 0.f;
    }
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    if (rw > 0) {  // warp rw - 1's chain so far
      asm volatile("bar.sync %0, 64;" ::"r"(rw));
      const float* h = sdd + (rw - 1) * 3 * BCC;
      a0 = h[lane];
      a1 = h[BCC + lane];
      a2 = h[2 * BCC + lane];
    }
#pragma unroll
    for (int e = 0; e < A_ROWS; ++e) {
      a0 = __fmaf_rn(r0[e], uu[e], a0);
      a1 = __fmaf_rn(r1[e], uu[e], a1);
      a2 = __fmaf_rn(r2[e], uu[e], a2);
    }
    if (rw + 1 < ROUTE_WARPS) {
      float* h = sdd + rw * 3 * BCC;
      h[lane] = a0;
      h[BCC + lane] = a1;
      h[2 * BCC + lane] = a2;
      asm volatile("bar.arrive %0, 64;" ::"r"(rw + 1) : "memory");
    } else if (c < SC) {
      float* part = partial + ((size_t)b * gridDim.x + blockIdx.x) * 3 * SC + c;
      part[0] = a0;
      part[SC] = a1;
      part[2 * SC] = a2;
    }
  };
  // drfn: lane t of a walk warp adds the chunk's columns into sacc[:, win, t]
  // in column order.  The chunk's u, winners and directions are read eight
  // columns at a time; the sum of the column two ahead is loaded before this
  // column's is stored, so a loaded sum is stale when its winner is that of
  // one of the two columns stored since: those come from registers
  auto walk = [&](int buf) {
    const int t = warp * 32 + lane;
    const float* __restrict__ ut = su + (buf * BQ + t) * BCP;
    const unsigned char* __restrict__ kt = sk + (buf * BQ + t) * BCP;
    const float4* __restrict__ dc = sdc + buf * BCC;
    Acc* __restrict__ at = sacc + t;  // drfn[q, k, d] at at[(d * K + k) * BQ]
    int k0 = kt[0], k1 = kt[1], kprev = -1;
    Acc a0 = at[k0 * BQ], a1 = at[DQ + k0 * BQ], a2 = at[2 * DQ + k0 * BQ];
    Acc p0 = at[k1 * BQ], p1 = at[DQ + k1 * BQ], p2 = at[2 * DQ + k1 * BQ];
    Acc b0 = a0, b1 = a1, b2 = a2;  // the sums stored at the column before
#pragma unroll
    for (int g = 0; g < BCC; g += 8) {
      float uv[8];
      int kk[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        uv[e] = ut[g + e];
        kk[e] = g + e + 2 < BCC ? kt[g + e + 2] : k0;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k2 = kk[e];
        const bool ahead = g + e + 2 < BCC;
        const Acc f0 = ahead ? at[k2 * BQ] : 0, f1 = ahead ? at[DQ + k2 * BQ] : 0,
                  f2 = ahead ? at[2 * DQ + k2 * BQ] : 0;
        const float4 d = dc[g + e];
        Acc n0, n1, n2;
        if constexpr (FAST) {  // exact products of bf16 operands, fp64 sums
          n0 = fma((double)uv[e], (double)d.x, a0);
          n1 = fma((double)uv[e], (double)d.y, a1);
          n2 = fma((double)uv[e], (double)d.z, a2);
        } else {
          n0 = fmaf(uv[e], d.x, a0);
          n1 = fmaf(uv[e], d.y, a1);
          n2 = fmaf(uv[e], d.z, a2);
        }
        at[k0 * BQ] = n0;
        at[DQ + k0 * BQ] = n1;
        at[2 * DQ + k0 * BQ] = n2;
        if (k1 == k0) {  // column g + e + 1's sums
          a0 = n0, a1 = n1, a2 = n2;
        } else if (k1 == kprev) {
          a0 = b0, a1 = b1, a2 = b2;
        } else {
          a0 = p0, a1 = p1, a2 = p2;
        }
        kprev = k0;
        b0 = n0, b1 = n1, b2 = n2;
        k0 = k1;
        k1 = k2;
        p0 = f0, p1 = f1, p2 = f2;
      }
    }
  };

  const bool router = rw >= 0;
  if (router) fetch(0);
  __syncthreads();  // srf, sidx, sacc staged
  if (router) {
    route(0, 0);
    if (nch > 1) fetch(1);
  }
  __syncthreads();
  for (int ch = 0; ch < nch; ++ch) {
    const int buf = ch & 1;
    if (!router) {
      walk(buf);
    } else if (ch + 1 < nch) {  // the next chunk routed while this one is summed
      route(ch + 1, buf ^ 1);
      if (ch + 2 < nch) fetch(ch + 2);
    }
    __syncthreads();
  }

  // drf per (query, k), kept in srf (no longer read) for dvq
  for (int e = threadIdx.x; e < tq * K; e += BWD_THREADS) {
    const int t = e / K, k = e % K;
    const size_t q = row0 + t;
    float g[3];
    rf_chain<FAST>(sraw + e * 3, (float)sacc[k * BQ + t], (float)sacc[DQ + k * BQ + t],
                   (float)sacc[2 * DQ + k * BQ + t], g);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      drf[(q * K + k) * 3 + d] = g[d];
      srf[e * 3 + d] = g[d];
    }
  }
  __syncthreads();
  if (threadIdx.x < 3 * tq) {  // dvq = -sum_k drf, in k order
    const int t = threadIdx.x / 3, d = threadIdx.x % 3;
    float c = 0.f;
    for (int k = 0; k < K; ++k) c -= srf[(t * K + k) * 3 + d];
    dvq[(row0 + t) * 3 + d] = c;
  }
}

// Shared memory of fused_bwd_kernel: sacc, sdc, srf, sraw, su, sdd, sidx, (sg), sk.
size_t fused_bwd_smem(int K, int Co, bool fast, bool stage_g) {
  return (fast ? sizeof(double) : sizeof(float)) * 3 * (size_t)K * BQ + sizeof(float4) * 2 * BCC +
         sizeof(float) * (6 * (size_t)BQ * K + 2 * BQ * BCP + (ROUTE_WARPS - 1) * 3 * BCC) +
         sizeof(int) * (size_t)BQ * K + (stage_g ? sizeof(float) * BQ * (size_t)Co : 0) +
         2 * BQ * BCP;
}

// fp32 stages gb / S where it fits SG_MAX (its division then runs once per
// (query, channel), not once per column); the bf16 tier's gb * (1/S) is one
// product and is formed where it is used.
template <bool FAST, bool STAGE_G>
cudaError_t launch_fused(const float* verts, const int* idx, const float* dirs, const int* win,
                         const float* gb, float* drf, float* dvq, float* partial, int B, int N,
                         int K, int S, int Co, cudaStream_t st) {
  const size_t smem = fused_bwd_smem(K, Co, FAST, STAGE_G);
  // the model's conv_0 has K = 20
  auto kernel = K == 20 ? fused_bwd_kernel<FAST, STAGE_G, 20> : fused_bwd_kernel<FAST, STAGE_G, 0>;
  cudaError_t err = hs::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((N + BQ - 1) / BQ, B), BWD_THREADS, smem, st>>>(verts, idx, dirs, win, gb, drf,
                                                                dvq, partial, N, K, S, Co);
  return cudaGetLastError();
}

// dverts[b, r] = (the sum of drf[b, q, k] over the entries (q, k) with
// idx[b, q, k] == r, in increasing q * K + k, from 0.f; FAST each rounded to
// bf16) + dvq[b, r]: the inverse-list order, with no lists in memory.  One
// block per (VR source rows, batch), a thread per row.  The block takes the
// batch's N*K entries in windows of at most VW, in order; per window each of
// the VS warps owns a contiguous slice of it, in order:
// (i)   the slices' counts of each of the block's rows (shared-memory
//       integer atomics: any order, the same counts);
// (ii)  per row, the start of its run in the window's list and of each
//       slice's part of it (a scan over the rows' totals);
// (iii) each warp places its slice's entries 32 at a time, in order, ranking
//       lanes with the same row by __match_any_sync (as hsb::inverse_index
//       ranks them, for the block's rows only);
// (iv)  each row's thread adds its run's drf entries in order.
// Loads are issued VU chunks ahead.  A window holds at most VW entries, so
// its list fits; a row's sum is carried across windows in registers.
template <bool FAST>
__global__ void __launch_bounds__(VTHREADS)
dverts_rows_kernel(const int* __restrict__ idx, const float* __restrict__ drf,
                   const float* __restrict__ dvq, float* __restrict__ dverts, int N, int K,
                   int VW) {
  extern __shared__ int dv_smem[];
  int* cnt = dv_smem;            // (VS, VR): counts, then each slice's next place
  int* ent = cnt + VS * VR;      // (VW): the window's entries, by row
  __shared__ int wsum[VR / 32];  // the row totals' scan, per warp
  const int b = blockIdx.y, r0 = blockIdx.x * VR, t = threadIdx.x;
  const int lane = t % 32, wp = t / 32;
  const int E = N * K;
  const int* ib = idx + (size_t)b * E;
  const float* db = drf + (size_t)b * E * 3;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  int run0 = 0, run1 = 0;  // thread t < VR: its row's run [run0, run1) in ent
  for (int w0 = 0; w0 < E; w0 += VW) {
    const int wn = min(VW, E - w0), per = (wn + VS - 1) / VS;
    const int lo = w0 + min(wn, wp * per), hi = w0 + min(wn, wp * per + per);
    for (int e = t; e < VS * VR; e += VTHREADS) cnt[e] = 0;
    __syncthreads();
    for (int e0 = lo; e0 < hi; e0 += 32 * VU) {  // (i)
      int r[VU];
#pragma unroll
      for (int u = 0; u < VU; ++u) {
        const int e = e0 + 32 * u + lane;
        r[u] = e < hi ? ib[e] - r0 : -1;
      }
#pragma unroll
      for (int u = 0; u < VU; ++u)
        if (r[u] >= 0 && r[u] < VR) atomicAdd(&cnt[wp * VR + r[u]], 1);
    }
    __syncthreads();
    if (t < VR) {  // (ii): the rows' exclusive scan, then the slices' starts
      int tot = 0;
      for (int w = 0; w < VS; ++w) tot += cnt[w * VR + t];
      int incl = tot;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      if (lane == 31) wsum[wp] = incl;
      asm volatile("bar.sync 1, %0;" ::"n"(VR));  // the row threads' warps only
      int start = incl - tot;
      for (int w = 0; w < wp; ++w) start += wsum[w];
      run0 = start;
      run1 = start + tot;
      for (int w = 0; w < VS; ++w) {
        const int c = cnt[w * VR + t];
        cnt[w * VR + t] = start;
        start += c;
      }
    }
    __syncthreads();
    int* next = cnt + wp * VR;  // (iii)
    for (int e0 = lo; e0 < hi; e0 += 32 * VU) {
      int r[VU];
#pragma unroll
      for (int u = 0; u < VU; ++u) {
        const int e = e0 + 32 * u + lane;
        r[u] = e < hi ? ib[e] - r0 : -1;
      }
#pragma unroll
      for (int u = 0; u < VU; ++u) {
        const bool hit = r[u] >= 0 && r[u] < VR;
        const unsigned grp = __match_any_sync(0xffffffffu, hit ? r[u] : -1);
        const int rank = __popc(grp & ((1u << lane) - 1u));
        const int base = hit ? next[r[u]] : 0;
        __syncwarp();
        if (hit) {
          ent[base + rank] = e0 + 32 * u + lane;
          if (rank == 0) next[r[u]] = base + __popc(grp);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    if (t < VR) {  // (iv): VU entries' loads in flight, then their adds in order
      for (int p0 = run0; p0 < run1; p0 += VU) {
        float v0[VU], v1[VU], v2[VU];
#pragma unroll
        for (int u = 0; u < VU; ++u) {
          const float* v = db + (size_t)ent[min(p0 + u, run1 - 1)] * 3;
          v0[u] = v[0];
          v1[u] = v[1];
          v2[u] = v[2];
        }
#pragma unroll
        for (int u = 0; u < VU; ++u) {
          if (p0 + u < run1) {
            s0 += FAST ? hs::bf16_round(v0[u]) : v0[u];
            s1 += FAST ? hs::bf16_round(v1[u]) : v1[u];
            s2 += FAST ? hs::bf16_round(v2[u]) : v2[u];
          }
        }
      }
    }
    __syncthreads();  // ent and cnt are read before the next window writes them
  }
  if (t < VR && r0 + t < N) {
    const size_t row = ((size_t)b * N + r0 + t) * 3;
    dverts[row] = s0 + dvq[row];
    dverts[row + 1] = s1 + dvq[row + 1];
    dverts[row + 2] = s2 + dvq[row + 2];
  }
}

// K9's three launches: the fused kernel, dd's partial sum, dverts.
template <bool FAST>
cudaError_t surface_bwd(const float* verts, const int* idx, const float* dirs, const int* win,
                        const float* gb, float* drf, float* dvq, float* partial, float* dverts,
                        float* red, int B, int N, int K, int S, int Co, cudaStream_t st) {
  cudaError_t err =
      !FAST && sizeof(float) * BQ * (size_t)Co <= SG_MAX
          ? launch_fused<FAST, true>(verts, idx, dirs, win, gb, drf, dvq, partial, B, N, K, S, Co,
                                     st)
          : launch_fused<FAST, false>(verts, idx, dirs, win, gb, drf, dvq, partial, B, N, K, S,
                                      Co, st);
  if (err != cudaSuccess) return err;
  err = hs::sum_tiles(partial, red, hsb::parts(B, N), 3 * S * Co, st);
  if (err != cudaSuccess) return err;
  const int vw = min(N * K, VW_MAX);  // a batch's entries, or windows of VW_MAX
  const size_t vsmem = sizeof(int) * ((size_t)VS * VR + vw);
  err = hs::allow_smem(dverts_rows_kernel<FAST>, vsmem);
  if (err != cudaSuccess) return err;
  dverts_rows_kernel<FAST><<<dim3((N + VR - 1) / VR, B), VTHREADS, vsmem, st>>>(
      idx, drf, dvq, dverts, N, K, vw);
  return cudaGetLastError();
}

}  // namespace

// verts (B, N, 3), idx (B, N, K) int32, dirs (3, S*Co) -> out (B, N, Co);
// fast != 0 runs the bf16 tier.
extern "C" int hs_surface(const float* verts, const int* idx, const float* dirs, float* out,
                          int B, int N, int K, int S, int Co, int fast, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch<true>(verts, verts, idx, dirs, out, nullptr, B, N, N, K, S, Co, s)
              : launch<false>(verts, verts, idx, dirs, out, nullptr, B, N, N, K, S, Co, s);
}

// The query-sharded branch (sequence-parallel serving, pallas_hs_fused.py's
// vertices_q): centres vq (B, NQ, 3), idx (B, NQ, K) into the M source rows of
// verts (B, M, 3) -> out (B, NQ, Co).  Each query's rows are staged and reduced
// as hs_surface does the same row of the source.
extern "C" int hs_surface_qs(const float* verts, const float* vq, const int* idx,
                             const float* dirs, float* out, int B, int NQ, int M, int K, int S,
                             int Co, int fast, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch<true>(verts, vq, idx, dirs, out, nullptr, B, NQ, M, K, S, Co, s)
              : launch<false>(verts, vq, idx, dirs, out, nullptr, B, NQ, M, K, S, Co, s);
}

// The forward of the differentiable op: as hs_surface, and win (B, N, S*Co)
// int32, the first k reaching each column's max.
extern "C" int hs_surface_win(const float* verts, const int* idx, const float* dirs, float* out,
                              int* win, int B, int N, int K, int S, int Co, int fast,
                              void* stream) {
  if (hsb::supported(N, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch<true, true>(verts, verts, idx, dirs, out, win, B, N, N, K, S, Co, s)
              : launch<false, true>(verts, verts, idx, dirs, out, win, B, N, N, K, S, Co, s);
}

// K9: verts (B, N, 3), idx (B, N, K), dirs (3, S*Co), win (B, N, S*Co), gb (B, N, Co)
// -> dverts (B, N, 3) and red (3, S*Co) = dd; fast != 0 runs the bf16 tier.  Scratch:
// drf (B, N, K, 3), dvq (B, N, 3), partial (hs_fused_bwd_parts(B, N), 3, S*Co) fp32.
extern "C" int hs_surface_fused_bwd(const float* verts, const int* idx, const float* dirs,
                                    const int* win, const float* gb, float* drf, float* dvq,
                                    float* partial, float* dverts, float* red, int B, int N,
                                    int K, int S, int Co, int fast, void* stream) {
  if (hsb::supported(N, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(fast ? surface_bwd<true>(verts, idx, dirs, win, gb, drf, dvq, partial, dverts,
                                        red, B, N, K, S, Co, s)
                    : surface_bwd<false>(verts, idx, dirs, win, gb, drf, dvq, partial, dverts,
                                         red, B, N, K, S, Co, s));
}

// Rows of the fused backwards' dd (and db) partial-sum scratch.
extern "C" int hs_fused_bwd_parts(int B, int N) { return hsb::parts(B, N); }
