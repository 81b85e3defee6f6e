// Chamfer distance between two clouds: the nearest-point search in one
// direction, with or without its argmin, and the gradient for one cloud.
//
// Replaces hspose_tpu/ops/chamfer.py:
// * _chamfer_kernel (:85; K16): per point of a, min over b of
//   |a|^2 + |b|^2 - 2 a.b -> chamfer_min_kernel<false>;
// * _chamfer_fwd_idx_kernel (:167; K17): the same minimum and its argmin,
//   ties to the lowest index -> chamfer_min_kernel<true>;
// * _chamfer_bwd_kernel (:216; K18): ga_i = 2 (a_i - b_{ia_i}) gda_i
//   + 2 sum_{j: ib_j = i} gdb_j (a_i - b_j) -> chamfer_grad_kernel.
// Semantics are those of the plain versions in hspose_tpu_torch/ops/chamfer.py
// (chamfer_min, chamfer_min_argmin, chamfer_grad).
//
// What bounds them on an H100: at the recon tier's shape, (24, 1028) x (24,
// 1028), the search is 25 M point pairs per direction at 3 fp32 multiply-adds
// each, a few microseconds at the card's fp32 rate, and the clouds (300 KB)
// stay in L2.  Nothing of the N x M distance matrix is stored.  The gradient
// reads each cloud and its argmins once.
//
// Design.  The search: one block per (batch, 32 Q queries), CW warps.  Each
// lane holds Q queries in registers (x, y, z, |a|^2, the minimum so far and,
// for K17, the step it fell in), lane l the queries l, l + 32, ...  The
// sources are cut into CW contiguous parts of whole steps of G points, one a
// warp, whose step counts differ by one at most (part_start): the warp stages
// its part, up to CH points at a time, into shared memory as (x, y, z,
// |b|^2), each lane loading CH / 32 points, the next chunk's loads in flight
// while the warp walks this one (__syncwarp only, no block barrier).  Every
// lane walks the same points in increasing index, so each float4 load is a
// broadcast that serves Q pairs, and the Q chains are independent.  Per step
// each query's G distances are reduced by fminf in a chain of their own,
// then taken into the part's minimum: K16 by fminf (the first minimum's
// value is the minimum: a distance is never -0, and a NaN is never taken by
// either rule), K17 by a strict '<' that records the step's first index, so
// a tie keeps the earlier step.  After one barrier a thread per query merges
// the CW parts by the least (distance, step), which is associative and
// commutative and, as the parts are ordered ranges, gives the first step that
// reaches the cloud's minimum; the thread then takes that step's first point
// at the minimum's distance (from the staged points, or from b where the
// step's chunk has left shared memory): the first minimum over the whole
// cloud, as argmin gives it.  The launch picks Q (2 to QMAX) so that the work
// on the busiest SM is least (chamfer_queries): at (24, 1028) Q = 3, 264
// blocks, two on each of the 132 SMs.
//
// Each pair's distance keeps the bits of the kernel this replaced, |a|^2 +
// |b|^2 - 2 a.b as nvcc compiled it there, written out with explicit
// roundings so that no loop shape can change its contraction (sq_norm,
// pair_dist).
// What bounds it: the fp32 pipes, 5 floating-point operations per pair
// (multiply, two fused multiply-adds for a.b, the add |a|^2 + |b|^2 and the
// fused -2 a.b + that) and one fminf, against the bound's 3 multiply-adds;
// K17 adds a compare and two selects per step of G points.
//
// The gradient: one launch, no atomics and no scratch.  A block owns a tile
// of GT rows of a and finds, itself, the points of b whose nearest point
// lies in its tile, in increasing j: it loads a window of GW points (ib_j,
// b_j, gdb_j) at once and compacts the window's entries that fall in the
// tile into a shared-memory list, stably (a ballot per 32 entries, a prefix
// over those counts).  One thread per row of a then adds the list's terms
// that name its row, in list order, onto the direct term, each product
// rounded before its add as index_add_ adds (__fmul_rn, __fadd_rn), so the
// result repeats bit for bit.  The design before it built the inverse lists
// of ib with a counting sort (one block per batch, a second launch and two
// scratch tensors) for the same order.  What bounds it: the latency of its
// few dependent steps (load, compact, walk); it moves about 50 KB per batch.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int CW = 8;               // warps per block: the sources cut in CW parts
constexpr int MIN_THREADS = CW * 32;
constexpr int CH = 256;             // points a warp stages at a time
constexpr int CH_LANE = CH / 32;    // of which each lane loads
constexpr int G = 8;                // points per step of the walk
constexpr int QMAX = 4;             // queries per lane, at most (48 KB of static shared memory)
constexpr int GT = 64;              // rows of a per gradient block, a thread each
constexpr int GTHREADS = 256;       // threads per gradient block
constexpr int GW = 1536;            // points of b per window of the gradient's list
constexpr int GU = 8;               // list entries a row's thread reads at a time

// |p|^2 as the replaced kernel's x*x + y*y + z*z compiled (its SASS): y*y
// first, then fused multiply-adds of x and of z.
__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(x, x, __fmul_rn(y, y)));
}

// The squared distance of one pair.  The replaced kernel's asq + p.w - 2.f *
// (ax*p.x + ay*p.y + az*p.z) compiled (its SASS) to dot = fma(az, p.z,
// fma(ax, p.x, ay*p.y)) and (asq + p.w) - (dot + dot).  dot + dot is exact
// wherever it does not overflow, so fma(-2, dot, asq + p.w) rounds the same
// exact value once and gives the same bits, one operation fewer; the two
// differ only where |dot| > FLT_MAX / 2, where asq + p.w is +inf already.
__device__ __forceinline__ float pair_dist(float ax, float ay, float az, float asq,
                                           const float4& p) {
  const float dot = __fmaf_rn(az, p.z, __fmaf_rn(ax, p.x, __fmul_rn(ay, p.y)));
  return __fmaf_rn(-2.f, dot, __fadd_rn(asq, p.w));
}

// The first source of part w of CW, for M sources in `steps` steps of G.
__device__ __forceinline__ int part_start(int w, int steps, int M) {
  return min(M, G * (w * steps / CW));
}

template <bool WANT_IDX, int Q>
__global__ void __launch_bounds__(MIN_THREADS)
chamfer_min_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ dist, int* __restrict__ arg, int N, int M) {
  __shared__ float4 sb[CW][CH + G - 1];  // each warp's staged points, padded to whole steps
  __shared__ float sd[CW][32 * Q];       // the parts' minima
  __shared__ int ss[WANT_IDX ? CW : 1][32 * Q];
  const int bi = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * 32 * Q;
  const float* ab = a + (size_t)bi * N * 3;
  const float* bb = b + (size_t)bi * M * 3;

  float ax[Q], ay[Q], az[Q], asq[Q], best[Q];
  int step[Q];  // K17: the first index of the step in which best last fell, or -1
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const float* ap = ab + (size_t)min(q0 + lane + 32 * i, N - 1) * 3;
    ax[i] = ap[0];
    ay[i] = ap[1];
    az[i] = ap[2];
    asq[i] = sq_norm(ax[i], ay[i], az[i]);
    best[i] = INFINITY;
    step[i] = -1;
  }

  // this warp's part [p0, p1) of the sources, whole steps of G (the parts'
  // step counts differ by one at most), CH points at a time
  const int steps = (M + G - 1) / G;
  const int p0 = part_start(warp, steps, M), p1 = part_start(warp + 1, steps, M);
  float nx[CH_LANE], ny[CH_LANE], nz[CH_LANE];
  auto fetch = [&](int s0, int n) {  // loads of a chunk, clamped so that they issue together
#pragma unroll
    for (int u = 0; u < CH_LANE; ++u) {
      const float* p = bb + (size_t)(s0 + min(lane + 32 * u, n - 1)) * 3;
      nx[u] = p[0];
      ny[u] = p[1];
      nz[u] = p[2];
    }
  };
  int s0 = p0, n = min(CH, p1 - p0);
  if (n > 0) fetch(s0, n);
  while (n > 0) {
    __syncwarp();  // the warp's reads of the previous chunk are done
#pragma unroll
    for (int u = 0; u < CH_LANE; ++u)
      if (lane + 32 * u < n)
        sb[warp][lane + 32 * u] = make_float4(nx[u], ny[u], nz[u], sq_norm(nx[u], ny[u], nz[u]));
    __syncwarp();
    // G - 1 copies of the last point after it, so that every step takes G
    // points: a repeated point leaves the minimum, and the step it fell in, as they are
    if (lane < G - 1) sb[warp][n + lane] = sb[warp][n - 1];
    __syncwarp();
    const int s1 = s0 + n, n1 = min(CH, p1 - s1);
    if (n1 > 0) fetch(s1, n1);
    for (int j = 0; j < n; j += G) {
      // the step's minimum per query, a chain of its own, then one update of
      // best: a strict '<', so a tie keeps the earlier step
      float m[Q];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 p = sb[warp][j + g];
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          const float d = pair_dist(ax[i], ay[i], az[i], asq[i], p);
          m[i] = g ? fminf(m[i], d) : d;
        }
      }
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        if constexpr (WANT_IDX) {
          if (m[i] < best[i]) {
            best[i] = m[i];
            step[i] = s0 + j;
          }
        } else {
          best[i] = fminf(best[i], m[i]);
        }
      }
    }
    s0 = s1;
    n = n1;
  }

#pragma unroll
  for (int i = 0; i < Q; ++i) {
    sd[warp][lane + 32 * i] = best[i];
    if constexpr (WANT_IDX) ss[warp][lane + 32 * i] = step[i];
  }
  __syncthreads();
  // merge the parts, a thread per query: the least distance, on a tie the
  // earlier step (the parts are ordered ranges, so their steps are too).
  // Thread t = lane + 32 * warp takes query q0 + t, its own query i = warp.
  if (warp < Q && q0 + threadIdx.x < N) {
    const int t = threadIdx.x;
    float d = sd[0][t];
    int st = WANT_IDX ? ss[0][t] : 0, part = 0;
#pragma unroll
    for (int w = 1; w < CW; ++w) {
      const float od = sd[w][t];
      if constexpr (WANT_IDX) {
        const int os = ss[w][t];
        if (od < d || (od == d && os < st)) {
          d = od;
          st = os;
          part = w;
        }
      } else {
        d = fminf(d, od);
      }
    }
    dist[(size_t)bi * N + q0 + t] = d;
    if constexpr (WANT_IDX) {
      // the first point of the winning step at distance d: the walk's
      // earlier steps, and the step's earlier points, lay above it.  Read
      // from the staged points where the step lies in the chunk its part
      // left in shared memory, else from b
      int j = 0;
      if (st >= 0) {
        float qx = ax[0], qy = ay[0], qz = az[0], qsq = asq[0];
#pragma unroll
        for (int i = 1; i < Q; ++i) {
          if (warp == i) {
            qx = ax[i];
            qy = ay[i];
            qz = az[i];
            qsq = asq[i];
          }
        }
        const int wp0 = part_start(part, steps, M), wp1 = part_start(part + 1, steps, M);
        const int last = wp0 + (wp1 - wp0 - 1) / CH * CH;  // the start of its last chunk
        float dg[G];
        if (st >= last) {
#pragma unroll
          for (int g = 0; g < G; ++g)
            dg[g] = pair_dist(qx, qy, qz, qsq, sb[part][st - last + g]);
        } else {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float* bp = bb + (size_t)(st + g) * 3;  // a whole step of a full chunk
            dg[g] = pair_dist(qx, qy, qz, qsq,
                              make_float4(bp[0], bp[1], bp[2], sq_norm(bp[0], bp[1], bp[2])));
          }
        }
#pragma unroll
        for (int g = G - 1; g >= 0; --g)  // descending: the last match is the first point
          if (dg[g] == d) j = min(st + g, wp1 - 1);
      }
      arg[(size_t)bi * N + q0 + t] = j;
    }
  }
}

// ga (B, N, 3): one block per (batch, GT rows of a), GTHREADS threads,
// thread t < GT for row t.  The points of b are taken in windows of GW, in
// increasing j; each thread loads its GW / GTHREADS entries of the window,
// ib_j, b_j and gdb_j, all in flight together (the first window's before the
// direct term's loads).  The entries whose ib_j falls in the block's rows go,
// in increasing j, into a shared-memory list: a stable compaction, a ballot
// per 32-entry slice and, in every warp, a prefix over all the slices'
// counts.  Then each row's thread walks the list in order, GU entries at a
// time, adding the terms of the entries that name its row.  A window holds
// at most GW entries, so the list never overflows; a row's sum is carried
// across windows in registers.  Every product is rounded before its add, as
// index_add_ adds (__fmul_rn, __fadd_rn), and each row's terms come in
// increasing j.
__global__ void __launch_bounds__(GTHREADS)
chamfer_grad_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const int* __restrict__ ia, const int* __restrict__ ib,
                    const float* __restrict__ gda, const float* __restrict__ gdb,
                    float* __restrict__ ga, int N, int M) {
  constexpr int SLICES = GW / 32;        // 32-entry slices of a window
  constexpr int PER = GW / GTHREADS;     // entries a thread loads per window
  constexpr int WARPS = GTHREADS / 32;
  static_assert(SLICES <= 64, "a warp scans the slices' counts in two rounds");
  __shared__ float4 sb[GW];              // the kept points: b_j, gdb_j
  __shared__ int srow[GW + GU];          // their rows of a, from the tile's first; -1 after
  __shared__ int scnt[SLICES];           // the slices' counts
  const int bi = blockIdx.y, t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int i0 = blockIdx.x * GT, i = min(i0 + t % GT, N - 1);
  const size_t row = (size_t)bi * N + i;
  const int* ibb = ib + (size_t)bi * M;
  const float* bb = b + (size_t)bi * M * 3;
  const float* gb = gdb + (size_t)bi * M;
  // entry j0 + u * GTHREADS + t of a window: slice u * WARPS + warp, lane
  int r[PER];
  float4 pb[PER];
  auto load = [&](int j0) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int j = min(j0 + u * GTHREADS + t, M - 1);
      const float* p = bb + (size_t)j * 3;
      r[u] = j0 + u * GTHREADS + t < M ? ibb[j] - i0 : -1;
      pb[u] = make_float4(p[0], p[1], p[2], gb[j]);
    }
  };
  load(0);
  float ax = 0.f, ay = 0.f, az = 0.f, acc[3] = {0.f, 0.f, 0.f};
  if (t < GT) {
    const float* ap = a + row * 3;
    const float* bp = b + ((size_t)bi * M + ia[row]) * 3;
    const float g = gda[row];
    ax = ap[0];
    ay = ap[1];
    az = ap[2];
    acc[0] = __fmul_rn(2.f * __fsub_rn(ax, bp[0]), g);
    acc[1] = __fmul_rn(2.f * __fsub_rn(ay, bp[1]), g);
    acc[2] = __fmul_rn(2.f * __fsub_rn(az, bp[2]), g);
  }
  for (int j0 = 0; j0 < M; j0 += GW) {
    unsigned keep[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      keep[u] = __ballot_sync(0xffffffffu, r[u] >= 0 && r[u] < GT);
      if (lane == 0) scnt[u * WARPS + warp] = __popc(keep[u]);
    }
    __syncthreads();
    // every warp: the exclusive prefix of the slices' counts, in j order,
    // lane l holding slices l and 32 + l
    const int c0 = scnt[lane], c1 = 32 + lane < SLICES ? scnt[32 + lane] : 0;
    int i0s = c0, i1s = c1;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int v0 = __shfl_up_sync(0xffffffffu, i0s, d), v1 = __shfl_up_sync(0xffffffffu, i1s, d);
      if (lane >= d) {
        i0s += v0;
        i1s += v1;
      }
    }
    const int tot0 = __shfl_sync(0xffffffffu, i0s, 31);
    const int start0 = i0s - c0, start1 = tot0 + i1s - c1;
    const int n = tot0 + __shfl_sync(0xffffffffu, i1s, 31);
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int sl = u * WARPS + warp;  // the slice's start, from the lane that holds it
      const int base = __shfl_sync(0xffffffffu, sl < 32 ? start0 : start1, sl % 32);
      if (keep[u] >> lane & 1u) {
        const int e = base + __popc(keep[u] & ((1u << lane) - 1u));
        srow[e] = r[u];
        sb[e] = pb[u];
      }
    }
    if (t < GU) srow[n + t] = -1;  // the walk's last batch reads past the list
    if (j0 + GW < M) load(j0 + GW);
    __syncthreads();
    // each row's terms in list order, which is increasing j: GU rows of the
    // list read together, then the matching entries added in order
    if (t < GT) {
      for (int e0 = 0; e0 < n; e0 += GU) {
        int rr[GU];
#pragma unroll
        for (int u = 0; u < GU; ++u) rr[u] = srow[e0 + u];
#pragma unroll
        for (int u = 0; u < GU; ++u) {
          if (rr[u] == t) {
            const float4 q = sb[e0 + u];
            acc[0] = __fadd_rn(acc[0], -__fmul_rn(2.f * __fsub_rn(q.x, ax), q.w));
            acc[1] = __fadd_rn(acc[1], -__fmul_rn(2.f * __fsub_rn(q.y, ay), q.w));
            acc[2] = __fadd_rn(acc[2], -__fmul_rn(2.f * __fsub_rn(q.z, az), q.w));
          }
        }
      }
    }
    __syncthreads();  // the list is read before the next window writes it
  }
  if (t < GT && i0 + t < N) {
#pragma unroll
    for (int c = 0; c < 3; ++c) ga[row * 3 + c] = acc[c];
  }
}

// Queries per lane for B clouds of N queries on a card of sms SMs: the Q in
// 2 .. QMAX whose blocks put the least work on the busiest SM (blocks per
// SM, rounded up, times Q), the largest Q on a tie.
inline int chamfer_queries(int B, int N, int sms) {
  int best = 2;
  long best_cost = -1;
  for (int q = 2; q <= QMAX; ++q) {
    const long blocks = (long)B * ((N + 32 * q - 1) / (32 * q));
    const long cost = (blocks + sms - 1) / sms * q;
    if (best_cost < 0 || cost <= best_cost) {
      best = q;
      best_cost = cost;
    }
  }
  return best;
}

// The kernel with q queries per lane (2 <= q <= QMAX), one instantiation per q.
template <bool WANT_IDX, int Q = 2>
int launch_min_q(const float* a, const float* b, float* dist, int* arg, int B, int N, int M,
                 int q, cudaStream_t s) {
  if constexpr (Q < QMAX) {
    if (q > Q) return launch_min_q<WANT_IDX, Q + 1>(a, b, dist, arg, B, N, M, q, s);
  }
  const dim3 grid((N + 32 * Q - 1) / (32 * Q), B);
  chamfer_min_kernel<WANT_IDX, Q><<<grid, MIN_THREADS, 0, s>>>(a, b, dist, arg, N, M);
  return (int)cudaGetLastError();
}

template <bool WANT_IDX>
int launch_min(const float* a, const float* b, float* dist, int* arg, int B, int N, int M,
               void* stream) {
  if (B < 1 || N < 1 || M < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  return launch_min_q<WANT_IDX>(a, b, dist, arg, B, N, M, chamfer_queries(B, N, sms),
                                static_cast<cudaStream_t>(stream));
}

}  // namespace

// K16: a (B, N, 3), b (B, M, 3) fp32 -> dist (B, N) fp32.
extern "C" int hs_chamfer_min(const float* a, const float* b, float* dist, int B, int N, int M,
                              void* stream) {
  return launch_min<false>(a, b, dist, nullptr, B, N, M, stream);
}

// K17: as hs_chamfer_min, and arg (B, N) int32, the first index of the minimum.
extern "C" int hs_chamfer_min_argmin(const float* a, const float* b, float* dist, int* arg,
                                     int B, int N, int M, void* stream) {
  return launch_min<true>(a, b, dist, arg, B, N, M, stream);
}

// K18: a (B, N, 3), b (B, M, 3), ia (B, N) in [0, M), ib (B, M) in [0, N),
// gda (B, N), gdb (B, M) -> ga (B, N, 3).  One launch, no scratch.
extern "C" int hs_chamfer_grad(const float* a, const float* b, const int* ia, const int* ib,
                               const float* gda, const float* gdb, float* ga, int B, int N, int M,
                               void* stream) {
  if (B < 1 || N < 1 || M < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + GT - 1) / GT, B);
  chamfer_grad_kernel<<<grid, GTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, ia, ib, gda, gdb, ga, N, M);
  return (int)cudaGetLastError();
}
