// HS surface reduction of the training path (conv_0): forward with winners,
// and its backward.
//   out (B, N, Co)   = mean_s max_k relu(rf[b, n, k] . dir_s)
//   win (B, N, S*Co) = the first k that reaches that max
//   drf (B, N, K, 3) = sum_sc [k == win][theta_win > 0] gb/S * dir_sc
//   dd  (3, S*Co)    = sum_{b, n} [theta_win > 0] gb/S * rf[b, n, win]
//
// Replaces: hspose_tpu/ops/pallas_hs.py::_surface_kernel with want_win (K12)
// and ::_surface_bwd_kernel (K15), reached through hs_surface_reduce, both
// branches: exact=True (fp32 rf and dirs) and exact=False (the bf16 train
// step: bf16 rf and dirs, T = __nv_bfloat16).  Plain versions:
// hspose_tpu_torch/ops/cuda_hs.py::hs_surface_fwd_plain and
// hs_surface_bwd_plain.
//
// The bf16 branch makes the TPU kernel's one-pass roundings: theta's
// products of bf16 values are exact in fp32, so the forward is the fp32
// code on widened operands; the backward rounds the routed cotangent gb/S to
// bf16 before both products (drf = bf16(du) d^T, dd = rf^T bf16(du)), sums in
// fp32 and rounds drf to bf16 once (dd is rounded by the wrapper).
//
// What bounds it on an H100: at conv_0 (B=16, N=1028, K=20, S=7, Co=128) the
// forward does about 9e8 multiply-adds and writes the (B, N, S*Co) int32
// winners (59 MB); per (query, k, column) theta is three fp32 operations and
// the running max with its k three compare-unit ones, which issue at half
// the fp32 rate, so the forward is bound by those.  The backward reads the
// winners once (the bytes bound), routes each column's cotangent to its
// winning row, and writes one row of dd partial sums per 16-query tile (11
// MB, read back once).  In bf16 only rf (and drf) halve; the winners, fp32
// outputs and fp32 sums are the same, so the bound and the time barely move:
// the bf16 variant is there for its roundings, not for speed.
//
// Forward (K12): one block per (batch, FWD_TQ-query tile), 128 threads; the
// block stages its queries' rf rows from the tensor as float4 and runs the
// reduction body it shares with the serving kernel K2 (hs_surface.cuh):
// each thread holds one output channel's 3 x S directions in registers,
// reads each rf row once per query and updates S running maxima, so every
// output keeps the bits of the rule before (theta by one expression, the
// first k reaching the max, the supports added in order from 0.f, then / S).
// The kernel this replaced reloaded a query's whole rf row for every
// (support, k): seven shared-memory loads and a dependent max chain per
// multiply-add.
//
// Backward (K15), two launches.
// (i) surface_bwd_kernel: one block per (batch, 32 queries), the columns in
//     chunks of 32, double-buffered in shared memory.  Four router warps
//     route the next chunk while the current one is summed: per (query,
//     column) the winner (loaded a chunk ahead, coalesced), theta at the
//     winner by the forward's expression, and u = [theta > 0] gb/S
//     (hs::div_s; rounded to bf16 in the bf16 tier).  Warp 0 sums drf, lane
//     t for query t: in column order, drf[q, k, d] = fmaf(u, d, drf[q, k,
//     d]) with k the column's winner, one fmaf chain from 0.f per sum, as the
//     replaced kernel's row threads summed them (columns whose u is 0 add
//     fmaf(0, d, acc) = acc, as a sum from +0 is never -0).  The sums live in
//     shared memory k-major, a query per bank, and the sum of the column two
//     ahead is loaded before this column's is stored (taken from registers
//     when one of the two columns stored since has its winner).  Two of the
//     router warps then add each 16-query tile's row of dd partial sums, a
//     column a lane, fmaf(u, rf[q, win], acc) from 0.f over the tile's
//     queries in order.  rf sits in shared memory by dimension, so a warp's
//     reads of one query's row at many k meet no bank conflict.  The bf16
//     tier sums in fp32 too (its products are exact) and rounds drf once
//     when it is stored.
// (ii) hs::sum_tiles_kernel: dd = the tile partials added from 0.f in tile
//     order (batch-major); a block per 16 columns stages 256 tiles' rows at
//     a time with coalesced loads (the next rows in flight while one warp
//     chains through the staged ones), so the partials are read at L2 rate
//     instead of by one dependent load a tile.
// The kernel this replaced walked 32-column chunks with a __syncthreads
// pair each, every (query, k) row thread comparing all 32 winners of the
// chunk (K times the columns), its dd partial on 96 of 256 threads, and its
// partial sum on 2688 threads each walking 1040 tiles.  Every sum keeps its
// order, so drf and dd keep the bits.

#include "hs_surface.cuh"

namespace {

constexpr int FWD_TQ = 16;  // queries per forward block
constexpr int FWD_THREADS = 128;

constexpr int TQ = 16;               // queries per dd tile: the partial-sum unit
constexpr int QB = 32;               // queries per backward block: a warp's lanes, two tiles
constexpr int CC = 32;               // columns per chunk
constexpr int CP = CC + 1;           // a chunk buffer's row, padded
constexpr int ROUTE_WARPS = 4;       // warp 0 sums drf; warps 1-4 route the next chunk
                                     // meanwhile, and 1-2 then add dd's tile partials
constexpr int BWD_THREADS = 32 * (1 + ROUTE_WARPS);
constexpr int A_ROWS = QB / ROUTE_WARPS;  // queries a thread routes per chunk

template <typename T, int KT, int ST>
__global__ void __launch_bounds__(FWD_THREADS)
surface_fwd_kernel(const T* __restrict__ rf, const T* __restrict__ dirs, float* __restrict__ out,
                   int* __restrict__ win, int N, int K_arg, int S, int Co) {
  extern __shared__ __align__(16) float4 srf_fwd[];  // (FWD_TQ, K)
  const int K = KT ? KT : K_arg;
  const int b = blockIdx.y, q0 = blockIdx.x * FWD_TQ, tq = min(FWD_TQ, N - q0);
  const size_t row0 = (size_t)b * N + q0;
  const T* rfb = rf + row0 * K * 3;  // the rf rows as float4
  for (int e = threadIdx.x; e < tq * K; e += blockDim.x)
    srf_fwd[e] = make_float4(hs::load_f(rfb + e * 3), hs::load_f(rfb + e * 3 + 1),
                             hs::load_f(rfb + e * 3 + 2), 0.f);
  __syncthreads();
  hss::reduce_rows<hs::is_bf16<T>, true, KT, ST, FWD_THREADS>(srf_fwd, dirs, out, win, row0, tq,
                                                               K, S, Co);
}

// At most 102 registers a thread, so that four blocks share an SM (at B=16,
// N=1028 the grid's 528 blocks then run in one wave).
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS, 4)
surface_bwd_kernel(const T* __restrict__ rf, const T* __restrict__ dirs,
                   const int* __restrict__ win, const float* __restrict__ gb,
                   T* __restrict__ drf, float* __restrict__ partial, int N, int K, int S,
                   int Co) {
  constexpr bool FAST = hs::is_bf16<T>;
  // Shared memory, laid out so that no access pattern of the kernel has a
  // bank conflict: rf in planes (a warp reads one query's row at many k),
  // the drf sums k-major with a query per bank (lane t reads row t at its
  // own k).
  extern __shared__ __align__(16) float4 sdc[];    // (2, CC): a chunk's directions
  float* srf = reinterpret_cast<float*>(sdc + 2 * CC);  // (3, QB, K): rf rows, by dimension
  float* sacc = srf + 3 * QB * K;                  // (3, K, QB): drf[q, k, d] as it is summed
  float* su = sacc + 3 * K * QB;                   // (2, QB, CP): gated cotangent
  int* sk = reinterpret_cast<int*>(su + 2 * QB * CP);  // (2, QB, CP): winner
  float* sg = reinterpret_cast<float*>(sk + 2 * QB * CP);  // (QB, Co): gb / S as the operand
  const int SC = S * Co, nch = (SC + CC - 1) / CC, QK = QB * K;
  const int lane = threadIdx.x % 32, rw = threadIdx.x / 32 - 1;  // rw: router warp, or -1
  const int b = blockIdx.y, q0 = blockIdx.x * QB, tq = min(QB, N - q0);
  const size_t row0 = (size_t)b * N + q0;

  const T* rfb = rf + row0 * K * 3;
#pragma unroll 8
  for (int e = threadIdx.x; e < 3 * QK; e += BWD_THREADS) {  // e = (t * K + k) * 3 + d
    srf[e % 3 * QK + e / 3] = e < tq * K * 3 ? hs::load_f(rfb + e) : 0.f;
    sacc[e] = 0.f;
  }
#pragma unroll 8
  for (int e = threadIdx.x; e < tq * Co; e += BWD_THREADS) {
    float u = hs::div_s<FAST>(gb[row0 * Co + e], S);
    if constexpr (FAST) u = hs::bf16_round(u);
    sg[e] = u;
  }

  // routing, by the ROUTE_WARPS router warps: thread (rw, lane) takes column
  // ch * CC + lane of queries rw * A_ROWS ..; a query past the block reads
  // row tq - 1 (its results are not used), a column past S*Co routes u = 0.
  // A chunk's winners and directions are loaded a chunk ahead of their use.
  int kw[A_ROWS];
  float4 dw;
  auto fetch = [&](int ch) {
    const int c = min(ch * CC + lane, SC - 1);
#pragma unroll
    for (int e = 0; e < A_ROWS; ++e)
      kw[e] = win[(row0 + min(rw * A_ROWS + e, tq - 1)) * SC + c];
    dw = make_float4(hs::load_f(dirs + c), hs::load_f(dirs + SC + c),
                     hs::load_f(dirs + 2 * SC + c), 0.f);
  };
  auto route = [&](int ch, int buf) {
    const int c = ch * CC + lane, chan = min(c, SC - 1) % Co;
    const float4 d = dw;
    if (rw == 0) sdc[buf * CC + lane] = d;
#pragma unroll
    for (int e = 0; e < A_ROWS; ++e) {
      const int t = rw * A_ROWS + e, tt = min(t, tq - 1), k = kw[e];
      const float* r = srf + tt * K + k;
      const float theta = r[0] * d.x + r[QK] * d.y + r[2 * QK] * d.z;
      su[(buf * QB + t) * CP + lane] = c < SC && theta > 0.f ? sg[tt * Co + chan] : 0.f;
      sk[(buf * QB + t) * CP + lane] = k;
    }
  };
  // drf: lane t of warp 0 adds the chunk's columns into sacc[:, win, t] in
  // column order, one fmaf chain per drf[q, k, d].  The chunk's u, winners
  // and directions are read eight columns at a time; the sum of the column
  // two ahead is loaded before this column's is stored, so a loaded sum is
  // stale when its winner is that of one of the two columns stored since:
  // those are taken from registers (a column whose u is 0 adds
  // fmaf(0, d, acc) = acc: a sum from +0 is never -0)
  auto walk = [&](int buf) {
    const int t = lane;
    const float* __restrict__ ut = su + (buf * QB + t) * CP;
    const int* __restrict__ kt = sk + (buf * QB + t) * CP;
    const float4* __restrict__ dc = sdc + buf * CC;
    float* __restrict__ at = sacc + t;  // drf[q, k, d] at at[(d * K + k) * QB]
    const int DQ = K * QB;
    int k0 = kt[0], k1 = kt[1], kprev = -1;
    float a0 = at[k0 * QB], a1 = at[DQ + k0 * QB], a2 = at[2 * DQ + k0 * QB];
    float p0 = at[k1 * QB], p1 = at[DQ + k1 * QB], p2 = at[2 * DQ + k1 * QB];
    float b0 = a0, b1 = a1, b2 = a2;  // the sums stored at the column before
#pragma unroll
    for (int g = 0; g < CC; g += 8) {
      float uu[8];
      int kk[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        uu[e] = ut[g + e];
        kk[e] = g + e + 2 < CC ? kt[g + e + 2] : k0;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k2 = kk[e];
        const bool ahead = g + e + 2 < CC;
        const float f0 = ahead ? at[k2 * QB] : 0.f, f1 = ahead ? at[DQ + k2 * QB] : 0.f,
                    f2 = ahead ? at[2 * DQ + k2 * QB] : 0.f;
        const float4 d = dc[g + e];
        const float n0 = fmaf(uu[e], d.x, a0), n1 = fmaf(uu[e], d.y, a1),
                    n2 = fmaf(uu[e], d.z, a2);
        at[k0 * QB] = n0;
        at[DQ + k0 * QB] = n1;
        at[2 * DQ + k0 * QB] = n2;
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
  // dd: the chunk's row of one 16-query tile's partial sums, a column a
  // lane, the tile's queries in order (a query past N adds fmaf(0, r, acc))
  auto tile_dd = [&](int ch, int buf, int tl) {
    const int t0 = tl * TQ, n = min(TQ, N - q0 - t0), c = ch * CC + lane;
    if (n <= 0) return;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int e0 = 0; e0 < TQ; e0 += 8) {
      float u[8], r0[8], r1[8], r2[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int t = t0 + e0 + e;
        u[e] = e0 + e < n ? su[(buf * QB + t) * CP + lane] : 0.f;
        const float* r = srf + t * K + sk[(buf * QB + t) * CP + lane];
        r0[e] = r[0];
        r1[e] = r[QK];
        r2[e] = r[2 * QK];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        a0 = fmaf(u[e], r0[e], a0);
        a1 = fmaf(u[e], r1[e], a1);
        a2 = fmaf(u[e], r2[e], a2);
      }
    }
    if (c < SC) {
      const size_t tile = (size_t)b * ((N + TQ - 1) / TQ) + blockIdx.x * (QB / TQ) + tl;
      float* part = partial + tile * 3 * SC + c;
      part[0] = a0;
      part[SC] = a1;
      part[2 * SC] = a2;
    }
  };

  const bool router = rw >= 0;
  if (router) fetch(0);
  __syncthreads();  // srf, sacc, sg staged
  if (router) {
    route(0, 0);
    if (nch > 1) fetch(1);
  }
  __syncthreads();
  for (int ch = 0; ch < nch; ++ch) {
    const int buf = ch & 1;
    if (!router) walk(buf);
    if (router && ch + 1 < nch) {  // the next chunk routed while this one is summed
      route(ch + 1, buf ^ 1);
      if (ch + 2 < nch) fetch(ch + 2);
    }
    if (rw >= 0 && rw < QB / TQ) tile_dd(ch, buf, rw);
    __syncthreads();
  }

  T* out = drf + row0 * K * 3;
  for (int e = threadIdx.x; e < tq * K * 3; e += BWD_THREADS)  // e = (t * K + k) * 3 + d
    hs::store_f(out + e, sacc[(e % 3 * K + e / 3 % K) * QB + e / (3 * K)]);
}

size_t bwd_smem(int K, int Co) {  // sdc, srf, sacc, su, sk, sg
  return sizeof(float4) * 2 * CC +
         sizeof(float) * (6 * QB * (size_t)K + 4 * QB * CP + QB * (size_t)Co);
}

template <typename T, int KT, int ST>
cudaError_t launch_fwd_k(const void* rf, const void* dirs, float* out, int* win, int B, int N,
                         int K, int S, int Co, cudaStream_t stream) {
  auto kernel = surface_fwd_kernel<T, KT, ST>;
  const size_t smem = sizeof(float4) * FWD_TQ * (size_t)K;
  cudaError_t err = hs::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + FWD_TQ - 1) / FWD_TQ, B);
  kernel<<<grid, FWD_THREADS, smem, stream>>>(static_cast<const T*>(rf),
                                              static_cast<const T*>(dirs), out, win, N, K, S, Co);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const void* rf, const void* dirs, float* out, int* win, int B, int N,
                       int K, int S, int Co, cudaStream_t stream) {
  if (K == 20 && S == 7)  // the model's conv_0
    return launch_fwd_k<T, 20, 7>(rf, dirs, out, win, B, N, K, S, Co, stream);
  return launch_fwd_k<T, 0, 0>(rf, dirs, out, win, B, N, K, S, Co, stream);
}

template <typename T>
cudaError_t launch_bwd(const void* rf, const void* dirs, const int* win, const float* gb,
                       void* drf, float* partial, int B, int N, int K, int S, int Co,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem(K, Co);
  cudaError_t err = hs::allow_smem(surface_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + QB - 1) / QB, B);
  surface_bwd_kernel<T><<<grid, BWD_THREADS, smem, stream>>>(
      static_cast<const T*>(rf), static_cast<const T*>(dirs), win, gb, static_cast<T*>(drf),
      partial, N, K, S, Co);
  return cudaGetLastError();
}

}  // namespace

// Tiles of the backward: the dd partial-sum scratch is (hs_surface_bwd_parts(B, N), 3, S*Co).
extern "C" int hs_surface_bwd_parts(int B, int N) { return B * ((N + TQ - 1) / TQ); }

// rf (B, N, K, 3), dirs (3, S*Co), fp32 or (fast != 0) bf16 -> out (B, N, Co),
// win (B, N, S*Co) int32.
extern "C" int hs_surface_fwd(const void* rf, const void* dirs, float* out, int* win, int B,
                              int N, int K, int S, int Co, int fast, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(fast ? launch_fwd<__nv_bfloat16>(rf, dirs, out, win, B, N, K, S, Co, st)
                    : launch_fwd<float>(rf, dirs, out, win, B, N, K, S, Co, st));
}

// rf (B, N, K, 3), dirs (3, S*Co), fp32 or (fast != 0) bf16, win (B, N, S*Co),
// gb (B, N, Co), partial scratch (hs_surface_bwd_parts(B, N), 3, S*Co) -> drf
// (B, N, K, 3) in rf's type, dd (3, S*Co) fp32.
extern "C" int hs_surface_bwd(const void* rf, const void* dirs, const int* win,
                              const float* gb, void* drf, float* partial, float* dd, int B,
                              int N, int K, int S, int Co, int fast, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      fast ? launch_bwd<__nv_bfloat16>(rf, dirs, win, gb, drf, partial, B, N, K, S, Co, st)
           : launch_bwd<float>(rf, dirs, win, gb, drf, partial, B, N, K, S, Co, st);
  if (err != cudaSuccess) return (int)err;
  return (int)hs::sum_tiles(partial, dd, hs_surface_bwd_parts(B, N), 3 * S * Co, st);
}
