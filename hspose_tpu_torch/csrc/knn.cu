// K nearest neighbours, fused: squared distances and the k+1 smallest per query.
//
// Replaces: hspose_tpu/ops/pallas_knn.py::_knn_kernel_tmaj, both branches of
// knn_indices_pallas's flat path:
//
// * exact (knn_kernel; the fp32 tier): semantics of the plain version
//   hspose_tpu_torch/ops/knn.py::knn_indices, the k+1 smallest distances in
//   (distance, index) order, ties to the lowest index, column 0 dropped;
// * packed key (knn_packed_kernel; the bf16 tier, fast=True, the "thresh"
//   extraction at :213-227): semantics of ops/knn.py::knn_indices_packed,
//   the k+1 smallest keys (bits(max(d, 0)) & ~0x7FF) | index, column 0
//   dropped.  _knn_kernel_fast (:91), the lane-major layout of the same
//   selection, computes the same function, so this kernel ports it too.
//
// What bounds it on an H100: per forward it computes about 4e9 fp32
// multiply-adds of distances (almost all at D=128, N=1028) and selects from
// B*N*N candidates.  Neither touches device memory much: the points are read
// from L2, and only the (B, N, k) indices are written.  The limits are the
// shared-memory traffic of the distance tile and the per-query selection,
// whose branches diverge across a warp: a warp pays for an insertion whenever
// any of its lanes inserts.
//
// Design: one block per (batch, 64-query tile), 256 threads.  Source points
// stream through shared memory in tiles of 64; the block computes the 64x64
// distance tile as a small register-blocked product (each thread a 4x4 block,
// the feature axis staged in chunks, bf16 points widened to fp32 as they are
// staged, so products of bf16 values are exact and sums fp32 as in the TPU
// kernel).  For D <= 8 the tile is the sum of squared differences; above,
// ||q||^2 + ||x||^2 - 2 q.x.  The tile goes to shared memory and every thread
// selects: four adjacent lanes share a query, each taking every fourth
// candidate of the tile in increasing index order into its own sorted list in
// registers.  The exact list holds (distance, index) pairs, and a candidate
// enters on a strict '<' (its index is above every listed one, so ties stay
// with the lower index).  The packed list holds one int key per entry: keys
// are unique, so the selection is an integer min with no tie logic, in half
// the registers.  Either way an entry goes in by a shift in which every slot
// is computed from the old list, with no chain of dependent compares, and at
// the end the four lists merge through warp shuffles.  No distance matrix
// reaches device memory and no library is called.

#include <climits>
#include <cmath>

#include "hs_common.cuh"

namespace {

constexpr int TQ = 64;         // queries per block
constexpr int TS = 64;         // source points per tile
constexpr int THREADS = 256;   // 16 x 16 threads, each a 4 x 4 block of the tile
constexpr int PARTS = THREADS / TQ;  // selector lanes per query (adjacent lanes)
constexpr int QPAD = TQ + 4;   // row stride of the staged chunks (keeps float4 alignment)
constexpr int DPAD = TS + 4;   // row stride of the distance tile (conflict-free selection reads)
constexpr int IDX_BITS = 11;   // packed key: the index in the low bits (pallas_knn.py:32)
constexpr int IDX_MASK = (1 << IDX_BITS) - 1;

template <int DC>
struct Tiles {
  __align__(16) float qs[DC][QPAD];
  __align__(16) float xs[DC][QPAD];
  __align__(16) float dist[TQ][DPAD];
  float qn[TQ];
  float xn[TS];
};

// t.dist[r][j] = squared distance from query q0 + r to source s0 + j, for the
// packed kernel.  Every thread of the block calls it; it ends in a barrier,
// and its first barrier orders the previous tile's reads of t.dist before the
// rewrite.  The exact kernel below keeps its own inline copy of the same
// arithmetic: built on this helper it gave the same indices but ran its nine
// searches 9% slower on the H100 (2.04 against 1.88 ms per forward), so the
// fp32 tier keeps the code it was measured with.
template <int DC, bool DIRECT, typename T>
__device__ __forceinline__ void distance_tile(Tiles<DC>& t, const T* __restrict__ P, int N,
                                              int D, int q0, int s0) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;  // ||x||^2 of source s0 + tid, or ||q||^2 of query q0 + tid - TS

  for (int d0 = 0; d0 < D; d0 += DC) {
    for (int e = tid; e < TQ * DC; e += THREADS) {
      const int r = e / DC, c = e % DC, d = d0 + c;
      const int qi = q0 + r, xi = s0 + r;
      t.qs[c][r] = (qi < N && d < D) ? hs::load_f(P + (size_t)qi * D + d) : 0.f;
      t.xs[c][r] = (xi < N && d < D) ? hs::load_f(P + (size_t)xi * D + d) : 0.f;
    }
    __syncthreads();
    if (!DIRECT) {
      if (tid < TS) {
#pragma unroll
        for (int c = 0; c < DC; ++c) nrm += t.xs[c][tid] * t.xs[c][tid];
      } else if (tid < TS + TQ) {
#pragma unroll
        for (int c = 0; c < DC; ++c) nrm += t.qs[c][tid - TS] * t.qs[c][tid - TS];
      }
    }
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const float4 a4 = *reinterpret_cast<const float4*>(&t.qs[c][ty * 4]);
      const float4 x4 = *reinterpret_cast<const float4*>(&t.xs[c][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (DIRECT) {
            const float u = a[i] - x[j];
            acc[i][j] += u * u;
          } else {
            acc[i][j] += a[i] * x[j];
          }
        }
    }
    __syncthreads();
  }

  if (!DIRECT) {
    if (tid < TS) t.xn[tid] = nrm;
    else if (tid < TS + TQ) t.qn[tid - TS] = nrm;
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = DIRECT ? acc[i][j] : (t.qn[r] + t.xn[tx * 4 + j]) - 2.f * acc[i][j];
    *reinterpret_cast<float4*>(&t.dist[r][tx * 4]) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();
}

template <int KMAX, int DC, bool DIRECT>
__global__ void __launch_bounds__(THREADS)
knn_kernel(const float* __restrict__ pts, int* __restrict__ out, int N, int D, int kk) {
  __shared__ __align__(16) float qs[DC][QPAD];
  __shared__ __align__(16) float xs[DC][QPAD];
  __shared__ __align__(16) float dist[TQ][DPAD];
  __shared__ float qn[TQ];
  __shared__ float xn[TS];

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int sq = tid / PARTS, part = tid % PARTS;  // selection: query and lane within it
  const float* P = pts + (size_t)b * N * D;

  // sorted (distance, index) list of this lane's candidates of query q0 + sq
  float ld[KMAX];
  int li[KMAX];
#pragma unroll
  for (int p = 0; p < KMAX; ++p) {
    ld[p] = INFINITY;
    li[p] = INT_MAX;
  }
  float worst = INFINITY;  // ld[kk - 1]

  for (int s0 = 0; s0 < N; s0 += TS) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float nrm = 0.f;  // ||x||^2 of source s0 + tid, or ||q||^2 of query q0 + tid - TS

    for (int d0 = 0; d0 < D; d0 += DC) {
      for (int e = tid; e < TQ * DC; e += THREADS) {
        const int r = e / DC, c = e % DC, d = d0 + c;
        const int qi = q0 + r, xi = s0 + r;
        qs[c][r] = (qi < N && d < D) ? P[(size_t)qi * D + d] : 0.f;
        xs[c][r] = (xi < N && d < D) ? P[(size_t)xi * D + d] : 0.f;
      }
      __syncthreads();
      if (!DIRECT) {
        if (tid < TS) {
#pragma unroll
          for (int c = 0; c < DC; ++c) nrm += xs[c][tid] * xs[c][tid];
        } else if (tid < TS + TQ) {
#pragma unroll
          for (int c = 0; c < DC; ++c) nrm += qs[c][tid - TS] * qs[c][tid - TS];
        }
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float4 a4 = *reinterpret_cast<const float4*>(&qs[c][ty * 4]);
        const float4 x4 = *reinterpret_cast<const float4*>(&xs[c][tx * 4]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (DIRECT) {
              const float t = a[i] - x[j];
              acc[i][j] += t * t;
            } else {
              acc[i][j] += a[i] * x[j];
            }
          }
      }
      __syncthreads();
    }

    if (!DIRECT) {
      if (tid < TS) xn[tid] = nrm;
      else if (tid < TS + TQ) qn[tid - TS] = nrm;
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = DIRECT ? acc[i][j] : (qn[r] + xn[tx * 4 + j]) - 2.f * acc[i][j];
      *reinterpret_cast<float4*>(&dist[r][tx * 4]) = make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();

    const int jmax = min(TS, N - s0);
#pragma unroll 4
    for (int j = part; j < jmax; j += PARTS) {
      const float d = dist[sq][j];
      if (d < worst) {
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
          if (p == kk - 1) worst = ld[p];
      }
    }
    // the next tile's first barrier orders these reads of dist before its rewrite
  }

  // merge the PARTS lists of each query by (distance, index): kk rounds, each
  // taking the smallest head among the query's lanes and popping it
  const int q = q0 + sq;
  int* o = out + ((size_t)b * N + q) * (kk - 1);
  for (int r = 0; r < kk; ++r) {
    float bd = ld[0];
    int bi = li[0];
#pragma unroll
    for (int off = 1; off < PARTS; off <<= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (od < bd || (od == bd && oi < bi)) {
        bd = od;
        bi = oi;
      }
    }
    const bool pop = li[0] == bi;  // indices are unique across the lanes
#pragma unroll
    for (int p = 0; p < KMAX - 1; ++p) {
      ld[p] = pop ? ld[p + 1] : ld[p];
      li[p] = pop ? li[p + 1] : li[p];
    }
    if (pop) {
      ld[KMAX - 1] = INFINITY;
      li[KMAX - 1] = INT_MAX;
    }
    if (part == 0 && r > 0 && q < N) o[r - 1] = bi;
  }
}

template <int KMAX, int DC, bool DIRECT, typename T>
__global__ void __launch_bounds__(THREADS)
knn_packed_kernel(const T* __restrict__ pts, int* __restrict__ out, int N, int D, int kk) {
  __shared__ Tiles<DC> t;

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x;
  const int sq = tid / PARTS, part = tid % PARTS;
  const T* P = pts + (size_t)b * N * D;

  // sorted keys of this lane's candidates of query q0 + sq; distances are
  // >= 0, so a key is a non-negative int and INT_MAX marks an empty slot
  int key[KMAX];
#pragma unroll
  for (int p = 0; p < KMAX; ++p) key[p] = INT_MAX;
  int worst = INT_MAX;  // key[kk - 1]

  for (int s0 = 0; s0 < N; s0 += TS) {
    distance_tile<DC, DIRECT>(t, P, N, D, q0, s0);

    const int jmax = min(TS, N - s0);
#pragma unroll 4
    for (int j = part; j < jmax; j += PARTS) {
      const int kv = (__float_as_int(fmaxf(t.dist[sq][j], 0.f)) & ~IDX_MASK) | (s0 + j);
      if (kv < worst) {
        bool lt[KMAX];
#pragma unroll
        for (int p = 0; p < KMAX; ++p) lt[p] = kv < key[p];
#pragma unroll
        for (int p = KMAX - 1; p > 0; --p)
          if (p < kk) key[p] = lt[p - 1] ? key[p - 1] : (lt[p] ? kv : key[p]);
        if (lt[0]) key[0] = kv;
#pragma unroll
        for (int p = 0; p < KMAX; ++p)
          if (p == kk - 1) worst = key[p];
      }
    }
  }

  // merge: kk rounds, each taking the smallest head key among the query's lanes
  const int q = q0 + sq;
  int* o = out + ((size_t)b * N + q) * (kk - 1);
  for (int r = 0; r < kk; ++r) {
    int best = key[0];
#pragma unroll
    for (int off = 1; off < PARTS; off <<= 1)
      best = min(best, __shfl_xor_sync(0xffffffffu, best, off));
    const bool pop = key[0] == best;  // keys are unique across the lanes
#pragma unroll
    for (int p = 0; p < KMAX - 1; ++p) key[p] = pop ? key[p + 1] : key[p];
    if (pop) key[KMAX - 1] = INT_MAX;
    if (part == 0 && r > 0 && q < N) o[r - 1] = best & IDX_MASK;
  }
}

template <int KMAX>
void launch(const float* pts, int* out, int B, int N, int D, int kk, cudaStream_t s) {
  const dim3 grid((N + TQ - 1) / TQ, B);
  if (D <= 8)
    knn_kernel<KMAX, 8, true><<<grid, THREADS, 0, s>>>(pts, out, N, D, kk);
  else
    knn_kernel<KMAX, 32, false><<<grid, THREADS, 0, s>>>(pts, out, N, D, kk);
}

template <int KMAX, typename T>
void launch_packed(const T* pts, int* out, int B, int N, int D, int kk, cudaStream_t s) {
  const dim3 grid((N + TQ - 1) / TQ, B);
  if (D <= 8)
    knn_packed_kernel<KMAX, 8, true><<<grid, THREADS, 0, s>>>(pts, out, N, D, kk);
  else
    knn_packed_kernel<KMAX, 32, false><<<grid, THREADS, 0, s>>>(pts, out, N, D, kk);
}

template <typename T>
void dispatch_packed(const T* pts, int* out, int B, int N, int D, int kk, cudaStream_t s) {
  if (kk <= 8)
    launch_packed<8>(pts, out, B, N, D, kk, s);
  else if (kk <= 16)
    launch_packed<16>(pts, out, B, N, D, kk, s);
  else if (kk <= 24)
    launch_packed<24>(pts, out, B, N, D, kk, s);
  else
    launch_packed<32>(pts, out, B, N, D, kk, s);
}

}  // namespace

// points (B, N, D) fp32 -> out (B, N, kk - 1) int32: the kk smallest, column 0 dropped.
extern "C" int hs_knn(const float* pts, int* out, int B, int N, int D, int kk, void* stream) {
  if (kk < 2 || kk > 32 || kk > N || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kk <= 8)
    launch<8>(pts, out, B, N, D, kk, s);
  else if (kk <= 16)
    launch<16>(pts, out, B, N, D, kk, s);
  else if (kk <= 24)
    launch<24>(pts, out, B, N, D, kk, s);
  else
    launch<32>(pts, out, B, N, D, kk, s);
  return (int)cudaGetLastError();
}

// points (B, N, D), fp32 or (is_bf16 != 0) bf16 -> out (B, N, kk - 1) int32:
// the kk smallest packed keys, column 0 dropped; N <= 2048 so the index fits the key.
extern "C" int hs_knn_packed(const void* pts, int is_bf16, int* out, int B, int N, int D,
                             int kk, void* stream) {
  if (kk < 2 || kk > 32 || kk > N || N > IDX_MASK + 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    dispatch_packed(static_cast<const __nv_bfloat16*>(pts), out, B, N, D, kk, s);
  else
    dispatch_packed(static_cast<const float*>(pts), out, B, N, D, kk, s);
  return (int)cudaGetLastError();
}
