// K nearest neighbours, fused: squared distances and the k+1 smallest per query.
//
// Replaces: hspose_tpu/ops/pallas_knn.py::_knn_kernel_tmaj, both branches of
// knn_indices_pallas's flat path:
//
// * exact (the fp32 tier): semantics of the plain version
//   hspose_tpu_torch/ops/knn.py::knn_indices, the k+1 smallest distances in
//   (distance, index) order, ties to the lowest index, column 0 dropped;
// * packed key (the bf16 tier, fast=True, the "thresh" extraction at
//   :213-227): semantics of ops/knn.py::knn_indices_packed, the k+1 smallest
//   keys (bits(max(d, 0)) & ~0x7FF) | index, column 0 dropped.
//   _knn_kernel_fast (:91), the lane-major layout of the same selection,
//   computes the same function, so this kernel ports it too.
//
// What bounds it on an H100: per forward, about 4e9 fp32 multiply-adds of
// distances (almost all at D=128, N=1028) and B*N*N candidates to select
// from.  Neither touches device memory much: the points are read from L2
// and only the (B, N, k) indices are written.  The limits are the issue
// rate of the distance product and of the selection, whose branches diverge
// across a warp: a warp pays for an insertion whenever any lane inserts.
//
// Design: one skeleton, knn_kernel, for both searches.  One block per
// (batch, TQ-query tile), 256 threads, LANES adjacent lanes per query (TQ =
// 256 / LANES; the wrapper picks 4, 8 or 16 per search shape,
// ops/cuda_knn.py::knn_lanes: large query tiles for the distance products
// of D > 8, more blocks for the small searches).
//
// * Staging.  The block's query rows (and their norms) are staged once into
//   dynamic shared memory.  Source points stream in tiles of 64 rows through
//   two buffers filled by cp.async, so the next chunk's copy overlaps this
//   chunk's arithmetic; rows are padded to an odd number of 16-byte units, so
//   eight neighbouring rows read as float4 hit eight bank groups.
// * Distances.  D <= 8: the sum over d of squared differences (DIRECT);
//   above, ||q||^2 + ||x||^2 - 2 q.x.  On the CUDA cores (DIRECT, EXPAND)
//   each thread owns a 4 x 4 (2 x 4, 1 x 4) block of the tile and every sum runs
//   in increasing d with one fused multiply-add per term, the norms too: the
//   arithmetic of the kernel this one replaced, so the fp32 distances and
//   hence the indices keep their bits.  The packed search on bf16 points with
//   D % 16 == 0 (MMA) forms q.x on the tensor cores (mma.sync m16n8k16, bf16
//   products exact, fp32 sums, as the TPU kernel's one-pass bf16 product);
//   its norms sum four partial sums.
// * Selection against a per-query bound.  Each lane keeps a sorted list of
//   the kk smallest of the candidates it scans (every LANES-th column of a
//   tile, in increasing index, a strict '<', so ties stay with the lower
//   index; packed keys are unique ints).  A candidate is queued only if it
//   is below the lane's own kk-th entry and not above the query's bound, the
//   smallest kk-th entry among its lanes as of the previous tile: anything
//   above that bound has kk smaller candidates in one lane already.  The
//   queue is a bit mask over the lane's columns of the tile; the warp then
//   inserts queued candidates, one per lane per round, for as many rounds as
//   its longest queue (as FAISS's WarpSelect merges its thread queues), not
//   once per column.  An insertion is a shift in which every slot is
//   computed from the old list.  At the end the LANES lists merge in
//   (distance, index) order through warp shuffles.  The result is the unique
//   kk smallest in that order, as in the replaced kernel.
//
// No distance matrix reaches device memory and no library is called.
//
// The query-sharded branch (hs_knn_qs, hs_knn_packed_qs; sequence-parallel
// serving, replacing pallas_knn.py::knn_indices_pallas_qs and its streamed
// and packed variants) is the same kernel with its query tile staged from a
// second pointer of NQ rows, while the source tiles stream from the M rows
// of the gathered cloud; only addresses change, so a query's list is the one
// the single-source launch gives the same row of the source.  The packed
// keys hold the source index, so that search takes M <= 2048, and the
// wrapper picks the exact search by M (ops/cuda_knn.py).

#include <climits>
#include <cmath>
#include <type_traits>

#include "hs_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TS = 64;        // source points per tile
constexpr int IDX_BITS = 11;  // packed key: the index in the low bits (pallas_knn.py:32)
constexpr int IDX_MASK = (1 << IDX_BITS) - 1;
constexpr unsigned FULL = 0xffffffffu;

enum Mode : int {
  DIRECT = 0,  // D <= 8: sum of squared differences, CUDA cores
  EXPAND = 1,  // ||q||^2 + ||x||^2 - 2 q.x, CUDA cores
  MMA = 2,     // the same with q.x on the tensor cores: bf16 points, D % 16 == 0
};

// Shared-memory geometry, in elements of the staged type (fp32, or bf16 for
// MMA): the query rows stay resident, source rows stream in chunks of dch
// features, nc chunks per tile, through two buffers.
struct Geometry {
  int dch, nc, qs, xs;  // chunk width, chunks per tile, query and source row strides
};

__host__ __device__ inline Geometry geometry(int mode, int D) {
  if (mode == DIRECT) return {8, 1, 12, 12};
  if (mode == MMA) return {D, 1, D + 8, D + 8};
  const int nc = (D + 63) / 64;
  return {64, nc, 64 * nc + 4, 68};
}

__host__ inline size_t smem_bytes(int mode, int D, int tq, int lanes) {
  const Geometry g = geometry(mode, D);
  const size_t es = mode == MMA ? 2 : 4;
  return es * ((size_t)tq * g.qs + 2 * (size_t)TS * g.xs) +
         sizeof(float) * ((size_t)tq * (TS + lanes) + tq + TS);
}

// Stage rows r0 .. r0 + rows - 1 of P (N x D), features d0 .. d0 + w - 1,
// into dst (row stride ld); rows past N and features past D are zero.  vec:
// 16-byte cp.async copies (D a multiple of the elements per copy, P aligned);
// else loads widened to fp32, written at once.
template <typename T, typename S>
__device__ inline void stage(S* dst, int ld, const T* __restrict__ P, int N, int D, int r0,
                             int rows, int d0, int w, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int per_row = w / V;
    for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
      const int r = e / per_row, c = (e % per_row) * V;
      const bool ok = r0 + r < N && d0 + c < D;
      hs::cp_async16(dst + r * ld + c, ok ? P + (size_t)(r0 + r) * D + d0 + c : P, ok);
    }
  } else if constexpr (std::is_same_v<S, float>) {
    for (int e = threadIdx.x; e < rows * w; e += blockDim.x) {
      const int r = e / w, c = e % w;
      const bool ok = r0 + r < N && d0 + c < D;
      dst[r * ld + c] = ok ? hs::load_f(P + (size_t)(r0 + r) * D + d0 + c) : 0.f;
    }
  }
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// ||row||^2 of a bf16 row of D values (D % 16 == 0) by four adjacent
// threads, each summing a quarter in fp32; all 32 lanes of the warp call it.
__device__ __forceinline__ float norm4(const __nv_bfloat16* row, int D) {
  const int q = threadIdx.x % 4, w = D / 4;
  float s = 0.f;
  for (int d = q * w; d < (q + 1) * w; ++d) {
    const float v = __bfloat162float(row[d]);
    s += v * v;
  }
  s += __shfl_xor_sync(FULL, s, 1);
  return s + __shfl_xor_sync(FULL, s, 2);
}

__device__ __forceinline__ int pack_key(float d, int index) {
  return (__float_as_int(fmaxf(d, 0.f)) & ~IDX_MASK) | index;
}

template <int KMAX, bool EXACT_K, int LANES, int MODE, bool PACKED, typename T>
__global__ void __launch_bounds__(THREADS, EXACT_K && !PACKED ? 2 : 1)
knn_kernel(const T* __restrict__ qpts, const T* __restrict__ pts, int* __restrict__ out, int NQ,
           int N, int D, int kk_arg) {
  constexpr int TQ = THREADS / LANES;  // queries per block
  constexpr int RI = TQ / 16;          // query rows per thread in the CUDA-core product
  constexpr int DSTR = TS + LANES;     // row stride of the distance tile (conflict-free selection)
  constexpr int CH = MODE == DIRECT ? 8 : 64;  // CUDA-core chunk width (geometry's dch)
  using S = std::conditional_t<MODE == MMA, __nv_bfloat16, float>;
  const int kk = EXACT_K ? KMAX : kk_arg;
  const Geometry geo = geometry(MODE, D);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* qs = reinterpret_cast<S*>(smem_raw);             // (TQ, geo.qs) resident query rows
  S* xs = qs + TQ * geo.qs;                           // (2, TS, geo.xs) source chunks
  float* dist = reinterpret_cast<float*>(xs + 2 * TS * geo.xs);  // (TQ, DSTR)
  float* qn = dist + TQ * DSTR;                       // (TQ) ||q||^2
  float* xn = qn + TQ;                                // (TS) ||x||^2

  const int b = blockIdx.y, q0 = blockIdx.x * TQ, tid = threadIdx.x;
  const int sq = tid / LANES, part = tid % LANES;  // selection: query and lane within it
  const int ty = tid / 16, tx = tid % 16;  // CUDA-core product: rows ty + 16 i, cols tx + 16 j
  const T* P = pts + (size_t)b * N * D;  // the N source rows
  const T* Q = qpts + (size_t)b * NQ * D;  // the NQ query rows
  const bool vec = MODE == MMA || (D % 4 == 0 && hs::aligned16(pts) && hs::aligned16(qpts));

  // this lane's sorted list: (distance, index) pairs, or packed keys
  float ld[KMAX];
  int li[KMAX];
#pragma unroll
  for (int p = 0; p < KMAX; ++p) {
    ld[p] = INFINITY;
    li[p] = INT_MAX;
  }
  float wd = INFINITY, td = INFINITY;  // exact: this lane's kk-th distance; the query's bound
  int wk = INT_MAX, tk = INT_MAX;      // packed: the same for keys (the keys live in li)

  stage(qs, geo.qs, Q, NQ, D, q0, TQ, 0, MODE == EXPAND ? geo.dch * geo.nc : geo.dch, vec);
  const int total = (N + TS - 1) / TS * geo.nc;  // chunks over all tiles
  auto issue = [&](int c) {
    if (c < total)
      stage(xs + (c & 1) * TS * geo.xs, geo.xs, P, N, D, c / geo.nc * TS, TS,
            c % geo.nc * geo.dch, geo.dch, vec);
    hs::cp_async_commit();
  };
  issue(0);

  float acc[RI][4];
  constexpr int WM = TQ / 16, WN = 8 / WM, NT = TS / WN / 8;  // MMA: warps over the tile
  float cf[NT][4];
  float nrm = 0.f;  // EXPAND: ||x||^2 of source row tid of the tile, summed over its chunks

  for (int c = 0; c < total; ++c) {
    issue(c + 1);
    hs::cp_async_wait<1>();
    __syncthreads();
    const int ch = c % geo.nc;
    const S* xb = xs + (c & 1) * TS * geo.xs;

    if constexpr (MODE == EXPAND) {
      if (c == 0 && tid < TQ) {
        float s = 0.f;
        for (int d = 0; d < geo.dch * geo.nc; ++d) s += qs[tid * geo.qs + d] * qs[tid * geo.qs + d];
        qn[tid] = s;
      }
      if (ch == 0) nrm = 0.f;
      if (tid < TS) {
#pragma unroll
        for (int d = 0; d < CH; ++d) nrm += xb[tid * geo.xs + d] * xb[tid * geo.xs + d];
      }
    }
    if constexpr (MODE == MMA) {
      if (c == 0) {
        const float s = norm4(qs + min(tid / 4, TQ - 1) * geo.qs, D);
        if (tid % 4 == 0 && tid / 4 < TQ) qn[tid / 4] = s;
      }
      const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
      const int wm = warp % WM, wn = warp / WM;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) cf[nt][e] = 0.f;
      for (int k0 = 0; k0 < D; k0 += 16) {
        const S* qa = qs + (wm * 16 + g) * geo.qs + k0 + 2 * t4;
        const unsigned a[4] = {hs::ld_b32(qa), hs::ld_b32(qa + 8 * geo.qs), hs::ld_b32(qa + 8),
                               hs::ld_b32(qa + 8 * geo.qs + 8)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const S* xa = xb + ((wn * NT + nt) * 8 + g) * geo.xs + k0 + 2 * t4;
          const unsigned bb[2] = {hs::ld_b32(xa), hs::ld_b32(xa + 8)};
          hs::mma_bf16_16816(cf[nt], a, bb);
        }
      }
    } else {
      if (ch == 0) {
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
#pragma unroll
      for (int dd = 0; dd < CH; dd += 4) {
        if (MODE == DIRECT && dd >= D) break;
        float4 a4[RI], x4[4];
#pragma unroll
        for (int i = 0; i < RI; ++i)
          a4[i] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * i) * geo.qs + ch * CH + dd]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          x4[j] = *reinterpret_cast<const float4*>(&xb[(tx + 16 * j) * geo.xs + dd]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < RI; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (MODE == DIRECT) {
                const float u = comp(a4[i], e) - comp(x4[j], e);
                acc[i][j] += u * u;
              } else {
                acc[i][j] += comp(a4[i], e) * comp(x4[j], e);
              }
            }
      }
    }

    if (ch != geo.nc - 1) {
      __syncthreads();  // the next issue rewrites this buffer
      continue;
    }

    // the tile is complete: its distances into shared memory, then selection
    const int s0 = c / geo.nc * TS;
    if constexpr (MODE == MMA) {
      const float s = norm4(xb + (tid / 4) * geo.xs, D);
      if (tid % 4 == 0) xn[tid / 4] = s;
    } else if constexpr (MODE == EXPAND) {
      if (tid < TS) xn[tid] = nrm;
    }
    __syncthreads();
    if constexpr (MODE == MMA) {
      const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
      const int wm = warp % WM, wn = warp / WM;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wm * 16 + g + (e / 2) * 8, col = (wn * NT + nt) * 8 + 2 * t4 + e % 2;
          dist[r * DSTR + col] = (qn[r] + xn[col]) - 2.f * cf[nt][e];
        }
    } else {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, col = tx + 16 * j;
          dist[r * DSTR + col] =
              MODE == DIRECT ? acc[i][j] : (qn[r] + xn[col]) - 2.f * acc[i][j];
        }
    }
    __syncthreads();

    // queue: the lane's columns of the tile below both bounds
    const int jmax = min(TS, N - s0);
    const float* drow = dist + sq * DSTR;
    unsigned mask = 0;
#pragma unroll
    for (int jj = 0; jj < TS / LANES; ++jj) {
      const int j = part + jj * LANES;
      if (j < jmax) {
        if constexpr (PACKED) {
          const int kv = pack_key(drow[j], s0 + j);
          if (kv < wk && kv <= tk) mask |= 1u << jj;
        } else {
          const float d = drow[j];
          if (d < wd && d <= td) mask |= 1u << jj;
        }
      }
    }
    // insert the queued candidates, in increasing index, one per lane per round
    while (__any_sync(FULL, mask != 0)) {
      if (mask) {
        const int j = part + (__ffs(mask) - 1) * LANES;
        mask &= mask - 1;
        if constexpr (PACKED) {
          const int kv = pack_key(drow[j], s0 + j);
          bool lt[KMAX];
#pragma unroll
          for (int p = 0; p < KMAX; ++p) lt[p] = kv < li[p];
#pragma unroll
          for (int p = KMAX - 1; p > 0; --p)
            if (p < kk) li[p] = lt[p - 1] ? li[p - 1] : (lt[p] ? kv : li[p]);
          if (lt[0]) li[0] = kv;
#pragma unroll
          for (int p = 0; p < KMAX; ++p)
            if (p == kk - 1) wk = li[p];
        } else {
          const float d = drow[j];
          const int ci = s0 + j;
          bool lt[KMAX];
#pragma unroll
          for (int p = 0; p < KMAX; ++p) lt[p] = d < ld[p];
          // slot p takes its left neighbour if the candidate goes left of it,
          // the candidate if it goes exactly here, else keeps its entry
#pragma unroll
          for (int p = KMAX - 1; p > 0; --p) {
            if (p < kk) {
              ld[p] = lt[p - 1] ? ld[p - 1] : (lt[p] ? d : ld[p]);
              li[p] = lt[p - 1] ? li[p - 1] : (lt[p] ? ci : li[p]);
            }
          }
          if (lt[0]) {
            ld[0] = d;
            li[0] = ci;
          }
#pragma unroll
          for (int p = 0; p < KMAX; ++p)
            if (p == kk - 1) wd = ld[p];
        }
      }
    }
    // the query's bound for the next tile: the smallest kk-th entry of its lanes
    tk = wk;
    td = wd;
#pragma unroll
    for (int off = 1; off < LANES; off <<= 1) {
      if constexpr (PACKED) {
        tk = min(tk, __shfl_xor_sync(FULL, tk, off));
      } else {
        td = fminf(td, __shfl_xor_sync(FULL, td, off));
      }
    }
    // the next tile's first barrier orders these reads of dist before its rewrite
  }

  // merge the LANES lists of each query in order: kk rounds, each taking the
  // smallest head among the query's lanes and popping it
  const int q = q0 + sq;
  int* o = out + ((size_t)b * NQ + q) * (kk - 1);
  for (int r = 0; r < kk; ++r) {
    float bd = ld[0];
    int bi = li[0];
#pragma unroll
    for (int off = 1; off < LANES; off <<= 1) {
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if constexpr (PACKED) {
        bi = min(bi, oi);
      } else {
        const float od = __shfl_xor_sync(FULL, bd, off);
        if (od < bd || (od == bd && oi < bi)) {
          bd = od;
          bi = oi;
        }
      }
    }
    const bool pop = li[0] == bi;  // indices (and keys) are unique across the lanes
#pragma unroll
    for (int p = 0; p < KMAX - 1; ++p) {
      ld[p] = pop ? ld[p + 1] : ld[p];
      li[p] = pop ? li[p + 1] : li[p];
    }
    if (pop) {
      ld[KMAX - 1] = INFINITY;
      li[KMAX - 1] = INT_MAX;
    }
    if (part == 0 && r > 0 && q < NQ) o[r - 1] = PACKED ? bi & IDX_MASK : bi;
  }
}

template <int KMAX, bool EXACT_K, int LANES, int MODE, bool PACKED, typename T>
cudaError_t launch(const T* q, const T* pts, int* out, int B, int NQ, int N, int D, int kk,
                   cudaStream_t s) {
  constexpr int TQ = THREADS / LANES;
  const size_t smem = smem_bytes(MODE, D, TQ, LANES);
  auto kernel = knn_kernel<KMAX, EXACT_K, LANES, MODE, PACKED, T>;
  cudaError_t err = hs::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((NQ + TQ - 1) / TQ, B), THREADS, smem, s>>>(q, pts, out, NQ, N, D, kk);
  return cudaGetLastError();
}

// the model's list lengths (k = 20, 4, 8) get lists of exactly kk entries;
// any other kk <= 32 a list of 32 with kk read at run time
template <int LANES, int MODE, bool PACKED, typename T>
cudaError_t launch_k(const T* q, const T* pts, int* out, int B, int NQ, int N, int D, int kk,
                     cudaStream_t s) {
  switch (kk) {
    case 5: return launch<5, true, LANES, MODE, PACKED>(q, pts, out, B, NQ, N, D, kk, s);
    case 9: return launch<9, true, LANES, MODE, PACKED>(q, pts, out, B, NQ, N, D, kk, s);
    case 21: return launch<21, true, LANES, MODE, PACKED>(q, pts, out, B, NQ, N, D, kk, s);
    default: return launch<32, false, LANES, MODE, PACKED>(q, pts, out, B, NQ, N, D, kk, s);
  }
}

template <int MODE, bool PACKED, typename T>
cudaError_t launch_lanes(const T* q, const T* pts, int* out, int B, int NQ, int N, int D, int kk,
                         int lanes, cudaStream_t s) {
  switch (lanes) {
    case 4: return launch_k<4, MODE, PACKED>(q, pts, out, B, NQ, N, D, kk, s);
    case 8: return launch_k<8, MODE, PACKED>(q, pts, out, B, NQ, N, D, kk, s);
    default: return launch_k<16, MODE, PACKED>(q, pts, out, B, NQ, N, D, kk, s);
  }
}

bool bad_args(int B, int NQ, int N, int D, int kk, int lanes) {
  return B < 1 || NQ < 1 || kk < 2 || kk > 32 || kk > N || D < 1 ||
         (lanes != 4 && lanes != 8 && lanes != 16);
}

cudaError_t exact(const float* q, const float* pts, int* out, int B, int NQ, int N, int D, int kk,
                  int lanes, cudaStream_t s) {
  return D <= 8 ? launch_lanes<DIRECT, false>(q, pts, out, B, NQ, N, D, kk, lanes, s)
                : launch_lanes<EXPAND, false>(q, pts, out, B, NQ, N, D, kk, lanes, s);
}

cudaError_t packed(const void* q, const void* pts, int is_bf16, int* out, int B, int NQ, int N,
                   int D, int kk, int lanes, cudaStream_t s) {
  if (is_bf16)
    return launch_lanes<MMA, true>(static_cast<const __nv_bfloat16*>(q),
                                   static_cast<const __nv_bfloat16*>(pts), out, B, NQ, N, D, kk,
                                   lanes, s);
  const float* qf = static_cast<const float*>(q);
  const float* p = static_cast<const float*>(pts);
  return D <= 8 ? launch_lanes<DIRECT, true>(qf, p, out, B, NQ, N, D, kk, lanes, s)
                : launch_lanes<EXPAND, true>(qf, p, out, B, NQ, N, D, kk, lanes, s);
}

}  // namespace

// points (B, N, D) fp32 -> out (B, N, kk - 1) int32: the kk smallest, column 0
// dropped; lanes (4, 8 or 16) selecting lanes per query.
extern "C" int hs_knn(const float* pts, int* out, int B, int N, int D, int kk, int lanes,
                      void* stream) {
  if (bad_args(B, N, N, D, kk, lanes)) return (int)cudaErrorInvalidValue;
  return (int)exact(pts, pts, out, B, N, N, D, kk, lanes, static_cast<cudaStream_t>(stream));
}

// points (B, N, D), fp32 or (is_bf16 != 0) bf16 with D % 16 == 0 -> out (B, N,
// kk - 1) int32: the kk smallest packed keys, column 0 dropped; N <= 2048 so
// the index fits the key.
extern "C" int hs_knn_packed(const void* pts, int is_bf16, int* out, int B, int N, int D,
                             int kk, int lanes, void* stream) {
  if (bad_args(B, N, N, D, kk, lanes) || N > IDX_MASK + 1 || (is_bf16 && D % 16 != 0))
    return (int)cudaErrorInvalidValue;
  return (int)packed(pts, pts, is_bf16, out, B, N, N, D, kk, lanes,
                     static_cast<cudaStream_t>(stream));
}

// The query-sharded branch (sequence-parallel serving; replaces
// pallas_knn.py::knn_indices_pallas_qs): queries q (B, NQ, D) against the
// source points (B, M, D), which contain every query row -> out (B, NQ, kk - 1)
// int32, indices into the source, the kk smallest by (distance, index), column
// 0 dropped.  A query is a block's staged row as in hs_knn; only the source
// tiles come from the other pointer, so each query's list is the one hs_knn
// gives that row of the source (the same fp32 distances in the same order).
extern "C" int hs_knn_qs(const float* q, const float* pts, int* out, int B, int NQ, int M,
                         int D, int kk, int lanes, void* stream) {
  if (bad_args(B, NQ, M, D, kk, lanes)) return (int)cudaErrorInvalidValue;
  return (int)exact(q, pts, out, B, NQ, M, D, kk, lanes, static_cast<cudaStream_t>(stream));
}

// The packed-key search of the query-sharded branch: as hs_knn_packed, the
// key's index bits holding the source row, so M <= 2048.
extern "C" int hs_knn_packed_qs(const void* q, const void* pts, int is_bf16, int* out, int B,
                                int NQ, int M, int D, int kk, int lanes, void* stream) {
  if (bad_args(B, NQ, M, D, kk, lanes) || M > IDX_MASK + 1 || (is_bf16 && D % 16 != 0))
    return (int)cudaErrorInvalidValue;
  return (int)packed(q, pts, is_bf16, out, B, NQ, M, D, kk, lanes,
                     static_cast<cudaStream_t>(stream));
}
