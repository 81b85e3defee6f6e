// ORL global branch: out (B, 1, C) = mean_n max_k feat[idx[n, k]].
//
// Replaces: hspose_tpu/ops/pallas_hs_fused.py::_orl_fwd_kernel, reached through
// orl_global_fused.  Plain version: hspose_tpu_torch/ops/cuda_hs_fused.py::
// orl_global_plain.
//
// What bounds it on an H100: it reads K rows of C values per point (at conv_1,
// B=24: 24*1028*20*128*4 B = 253 MB of gathered rows) for only the features
// and indices themselves in unique bytes (41 MB over the forward's five
// layers), and does no arithmetic beyond max and add.  Gathered from L2 the
// rows cost L2's rate; the kernel this one replaced reached about a third of
// it (one 4-byte load in flight per thread), in two launches.
//
// Design: one launch, one block per (batch, slice of Cs channels).  The block
// copies feat[b, :, c0:c0+Cs] into shared memory once (cp.async, 16 bytes per
// copy), and its (N, K) neighbour indices beside it where they fit, so
// device and L2 read each feature once and every gather is a 16-byte
// shared-memory load: the block's threads are (32-point tile, 16-byte vector
// of the row) pairs, a row of Cs values read by Cs*size/16 neighbouring
// threads.  Each thread walks its tile's points in order, the next point's
// indices loaded while this one's maxima run (int4 loads, K a template
// argument), takes the max over k of each of its channels and adds the
// maxima in point order from 0.f; the tile sums wait in shared memory, and
// one thread per channel adds them in tile order from 0.f and divides by N.
// That is the order of the replaced kernel's two launches, so the fp32
// result keeps its bits; no atomics, no scratch in device memory.  The
// launch picks the slice width (slice_width, by B, N, C and the card's SM
// count): 128-byte rows read without bank conflicts, narrower rows give
// more blocks to the SMs.  The kernel takes C a multiple of 16 bytes,
// 16-byte aligned features, and N rows of at least 16 bytes with their tile
// sums in 227 KB of shared memory (N up to 14087 in fp32, 13672 in bf16);
// otherwise the launch returns cudaErrorInvalidValue.  What bounds it now:
// at N = 1028, shared memory's rate (a 128-byte wavefront per clock) over
// the gathered rows on the SMs that hold blocks, and the copy in; at N = 257
// and 64, the chain of dependent loads that each thread walks through its
// tile's 32 points, with few threads.
//
// The bf16 tier (exact=False of the same TPU kernel) instantiates it on bf16
// features, which halves the bytes staged and gathered; the maxima are bf16
// values and every sum stays fp32, as the TPU kernel's exact one-hot gather
// of bf16 rows with fp32 accumulation.
//
// The query-sharded branch (hs_orl_qs; sequence-parallel serving,
// pallas_hs_fused.py:830-869 with nq_valid = idx.shape[1]) stages the M
// gathered source rows and walks and averages the NQ local query rows; the
// cross-shard mean is then the caller's all-reduce.
//
// The differentiable op, either tier: hs_orl_win is the same kernel with WIN,
// which also records, per (point, channel), the first k reaching the max (a
// strict > from -FLT_MAX in increasing k, pallas_hs_fused.py:381-389); the
// serving instantiations (WIN false) are compiled from the same lines.  Its
// backward K10, hs_orl_bwd, replaces hspose_tpu/ops/pallas_hs_fused.py::
// _orl_bwd_kernel (exact=True, and exact=False in bf16 with each entry's
// gb * (1/N) rounded to bf16): dfeat[b, r, c] = gb[b, c] / N times the number of (point, k)
// whose neighbour k is row r and whose channel c was won by that k.  Plain
// versions: hspose_tpu_torch/ops/cuda_hs_fused.py::orl_global_fused_fwd_plain
// and orl_global_fused_bwd_plain.  What bounds it: reading win (B, N, C) and
// writing dfeat once (at the v4 step's shapes, 4.2 MB a call in fp32, about
// 1.3 us at device memory's rate).  The kernel before it walked inverse
// neighbour lists (a counting sort, one block per batch, in a launch of its
// own) and read each winner K times through L2; a count needs neither the
// lists nor their order (orl_bwd_kernel below).

#include <cfloat>

#include "hs_fused_bwd.cuh"

namespace {

constexpr int TQ = 32;           // points per tile: the first sum's unit
constexpr int MAX_THREADS = 512;
constexpr int SMEM_MAX = 232448;  // shared memory a block may use (227 KB)

// The shared memory of one block: N source rows of Cs values and the NQ
// query rows' (tiles, Cs) tile sums; the (NQ, K) indices, when staged, lie
// between them.
inline size_t smem_bytes(int NQ, int N, int Cs, int elem) {
  return (size_t)N * Cs * elem + sizeof(float) * (size_t)((NQ + TQ - 1) / TQ) * Cs;
}

// The launch plan: a slice's row is 128 bytes down to 16 (ROW_BYTES).
// ROW_COST is the shared-memory wavefronts per row gathered, from the chance
// that rows read in one phase share banks: 128-byte rows one, 64-byte rows
// two in a phase, 32-byte rows four, 16-byte rows eight.
constexpr int ROW_BYTES[] = {128, 64, 32, 16};
constexpr double ROW_COST[] = {1.0, 0.75, 0.51, 0.33};

// Channels per block for (B, N, C) values of elem bytes on a card of sms
// SMs: the row width whose blocks, spread over the SMs, read the fewest
// wavefronts on the busiest SM (ROW_COST per row times the blocks each SM
// takes), the widest on a tie; 0 where no width divides C with N rows and
// the tile sums in shared memory.
inline int slice_width(int B, int NQ, int N, int C, int elem, int sms) {
  int best = 0;
  double best_cost = 0.0;
  for (int i = 0; i < 4; ++i) {
    const int cs = ROW_BYTES[i] / elem;
    if (C % cs || smem_bytes(NQ, N, cs, elem) > SMEM_MAX) continue;
    const double cost = (double)((B * (C / cs) + sms - 1) / sms) * ROW_COST[i];
    if (!best || cost < best_cost) {
      best = cs;
      best_cost = cost;
    }
  }
  return best;
}

// 16 bytes of features as fp32: four floats, or eight bf16 values (a bf16
// value's bits are the top half of the float's).
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The K neighbour indices of one point into registers, as int4 (p 16-byte
// aligned, KT % 4 == 0), from shared memory (SHARED) or through L1.
template <int KT, bool SHARED>
__device__ __forceinline__ void load_row(const int* __restrict__ p, int (&nb)[KT]) {
  static_assert(KT % 4 == 0, "rows of int4");
  const int4* p4 = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int i = 0; i < KT / 4; ++i) {
    const int4 v = SHARED ? p4[i] : __ldg(p4 + i);
    nb[4 * i] = v.x;
    nb[4 * i + 1] = v.y;
    nb[4 * i + 2] = v.z;
    nb[4 * i + 3] = v.w;
  }
}

// One block per (slice of Cs channels, batch): grid (C / Cs, B), threads over
// (tile, 16-byte vector) items.  KT = K unrolled (0: K read at run time, the
// indices loaded in the k loop); SIDX: the block's (N, K) indices staged in
// shared memory too (KT > 0), else each point's read through L1 while the
// previous point's maxima run.  Needs Cs a multiple of 16 bytes, C % Cs ==
// 0, feat 16-byte aligned, and with WIN win 16-byte aligned.
template <typename T, bool WIN, int KT, bool SIDX>
__global__ void __launch_bounds__(MAX_THREADS)
orl_kernel(const T* __restrict__ feat, const int* __restrict__ idx, float* __restrict__ out,
           int* __restrict__ win, int NQ, int N, int K_arg, int C, int Cs) {
  constexpr int VEC = 16 / sizeof(T);  // channels per 16 bytes
  extern __shared__ __align__(16) uint4 srow[];  // (N, Q): feat[b, :, c0:c0+Cs]
  const int K = KT ? KT : K_arg;
  const int Q = Cs / VEC, tiles = (NQ + TQ - 1) / TQ;
  const int b = blockIdx.y, c0 = blockIdx.x * Cs;
  int* sidx = reinterpret_cast<int*>(srow + (size_t)N * Q);                 // (NQ, K) if SIDX
  float* tsum = reinterpret_cast<float*>(sidx + (SIDX ? (size_t)NQ * K : 0));  // (tiles, Cs)

  const T* Fb = feat + (size_t)b * N * C + c0;
  for (int e = threadIdx.x; e < N * Q; e += blockDim.x)
    hs::cp_async16(srow + e, Fb + (size_t)(e / Q) * C + (e % Q) * VEC, true);
  const int* Ib = idx + (size_t)b * NQ * K;
  if constexpr (SIDX) {
    for (int e = threadIdx.x; e < NQ * K / 4; e += blockDim.x)
      hs::cp_async16(sidx + 4 * e, Ib + 4 * e, true);
    Ib = sidx;
  }
  hs::cp_async_commit();
  hs::cp_async_wait<0>();
  __syncthreads();

  for (int item = threadIdx.x; item < tiles * Q; item += blockDim.x) {
    const int tile = item / Q, v = item % Q, q0 = tile * TQ, tq = min(TQ, NQ - q0);
    float sum[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) sum[c] = 0.f;
    int nxt[KT ? KT : 1];
    if constexpr (KT > 0) load_row<KT, SIDX>(Ib + (size_t)q0 * K, nxt);
    for (int t = 0; t < tq; ++t) {
      int nb[KT ? KT : 1];
      if constexpr (KT > 0) {
#pragma unroll
        for (int j = 0; j < KT; ++j) nb[j] = nxt[j];
        if (t + 1 < tq) load_row<KT, SIDX>(Ib + (size_t)(q0 + t + 1) * K, nxt);
      }
      float m[VEC];
      int kb[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        m[c] = -FLT_MAX;
        kb[c] = 0;
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        int r;
        if constexpr (KT > 0)
          r = nb[j];
        else
          r = __ldg(Ib + (size_t)(q0 + t) * K + j);
        float x[VEC];
        unpack(srow[(size_t)r * Q + v], x);
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          if constexpr (WIN) {
            if (x[c] > m[c]) {
              m[c] = x[c];
              kb[c] = j;
            }
          } else {
            m[c] = fmaxf(m[c], x[c]);
          }
        }
      }
      if constexpr (WIN) {
        int4* w = reinterpret_cast<int4*>(win + ((size_t)b * NQ + q0 + t) * C + c0 + v * VEC);
#pragma unroll
        for (int i = 0; i < VEC / 4; ++i)
          w[i] = make_int4(kb[4 * i], kb[4 * i + 1], kb[4 * i + 2], kb[4 * i + 3]);
      }
#pragma unroll
      for (int c = 0; c < VEC; ++c) sum[c] += m[c];
    }
#pragma unroll
    for (int c = 0; c < VEC; ++c) tsum[tile * Cs + v * VEC + c] = sum[c];
  }
  __syncthreads();

  for (int c = threadIdx.x; c < Cs; c += blockDim.x) {
    float total = 0.f;
    for (int tile = 0; tile < tiles; ++tile) total += tsum[tile * Cs + c];
    out[(size_t)b * C + c0 + c] = total / NQ;
  }
}

// feat (B, N, C) holds the source rows that idx (B, NQ, K) names; the mean is
// over the NQ query rows (NQ = N but in the query-sharded branch).
template <typename T, bool WIN, int KT, bool SIDX>
int launch_k(const T* feat, const int* idx, float* out, int* win, int B, int NQ, int N, int K,
             int C, int Cs, cudaStream_t s) {
  auto kernel = orl_kernel<T, WIN, KT, SIDX>;
  const size_t smem =
      smem_bytes(NQ, N, Cs, sizeof(T)) + (SIDX ? sizeof(int) * (size_t)NQ * K : 0);
  cudaError_t err = hs::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int items = (NQ + TQ - 1) / TQ * (Cs * (int)sizeof(T) / 16);
  const int threads = min(MAX_THREADS, (items + 31) / 32 * 32);
  kernel<<<dim3(C / Cs, B), threads, smem, s>>>(feat, idx, out, win, NQ, N, K, C, Cs);
  return (int)cudaGetLastError();
}

// The indices go to shared memory beside the features where they fit.
template <typename T, bool WIN, int KT>
int launch_kt(const T* feat, const int* idx, float* out, int* win, int B, int NQ, int N, int K,
              int C, int Cs, cudaStream_t s) {
  if (smem_bytes(NQ, N, Cs, sizeof(T)) + sizeof(int) * (size_t)NQ * K <= SMEM_MAX)
    return launch_k<T, WIN, KT, true>(feat, idx, out, win, B, NQ, N, K, C, Cs, s);
  return launch_k<T, WIN, KT, false>(feat, idx, out, win, B, NQ, N, K, C, Cs, s);
}

template <typename T, bool WIN = false>
int launch(const T* feat, const int* idx, float* out, int* win, int B, int NQ, int N, int K,
           int C, cudaStream_t s) {
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int Cs = slice_width(B, NQ, N, C, sizeof(T), sms);
  if (!Cs || NQ < 1 || !hs::aligned16(feat) || (WIN && !hs::aligned16(win)))
    return (int)cudaErrorInvalidValue;
  switch (hs::aligned16(idx) ? K : 0) {  // the model's K = 20 and 8 unrolled
    case 20: return launch_kt<T, WIN, 20>(feat, idx, out, win, B, NQ, N, K, C, Cs, s);
    case 8: return launch_kt<T, WIN, 8>(feat, idx, out, win, B, NQ, N, K, C, Cs, s);
    default: return launch_k<T, WIN, 0, false>(feat, idx, out, win, B, NQ, N, K, C, Cs, s);
  }
}

// K10.  dfeat[b, r, c] = gb[b, c] / N times the count of (q, k) with
// idx[b, q, k] == r and win[b, q, c] == k: each (point, channel) pair names
// one source row, r = idx[b, q, win[b, q, c]], and adds one to its count.  One
// block per (slice of BWD_CS channels, range of R source rows, batch); grid
// (ceil(C / BWD_CS), ceil(N / R), B).  The block stages idx[b] in shared
// memory (SIDX; else it reads the rows through L1), zeroes its (R, BWD_CS)
// int counts, reads win[b, :, slice] once, VEC channels a load with U loads
// of the next items in flight while the current ones add, and adds with
// 32-bit shared-memory atomics; after a barrier it writes its rows of dfeat.
// Integer counts do not depend on the order of the adds, so the result is
// the same in every run, and each row is the replaced kernel's store
// expression: fp32 (float)cnt * (gb / N); bf16 (the TPU kernel's exact=False,
// _scatter_rows' operand) (float)cnt * bf16(gb * (1/N)) rounded to bf16 (the
// product is exact in fp32).  Rows no pair names write 0 * scale, as before.
// Bank use: a count row is BWD_CS words (a multiple of 32), so a count's
// bank is its channel mod 32; a thread adds its VEC channels in an order
// rotated by (lane / 8) % 4, so the 32 lanes of an add hit 32 banks.
constexpr int BWD_THREADS = 256;
constexpr int BWD_CS = 32;  // channels per block: a count row of 32 banks
constexpr int BWD_U = 4;    // items per thread per round of loads

template <int VEC>
struct WinVec;
template <>
struct WinVec<4> {
  using type = int4;
  __device__ static int4 load(const int* p) { return __ldg(reinterpret_cast<const int4*>(p)); }
  __device__ static int get(const int4& w, int j) {
    return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
  }
};
template <>
struct WinVec<1> {
  using type = int;
  __device__ static int load(const int* p) { return __ldg(p); }
  __device__ static int get(const int& w, int) { return w; }
};

// The shared memory of one K10 block: idx[b] (when staged, padded to 16
// bytes), then the (R, BWD_CS) counts.
__host__ __device__ inline size_t bwd_idx_words(int N, int K) { return ((size_t)N * K + 3) / 4 * 4; }
inline size_t bwd_smem_bytes(int N, int K, int R, bool sidx) {
  return sizeof(int) * ((sidx ? bwd_idx_words(N, K) : 0) + (size_t)R * BWD_CS);
}

template <typename T, int VEC, bool SIDX>
__global__ void __launch_bounds__(BWD_THREADS)
orl_bwd_kernel(const int* __restrict__ idx, const int* __restrict__ win,
               const float* __restrict__ gb, T* __restrict__ dfeat, int N, int K, int C, int R) {
  using W = WinVec<VEC>;
  constexpr int QV = BWD_CS / VEC;  // loads per (point, slice)
  extern __shared__ __align__(16) int bsm[];
  const int b = blockIdx.z, c0 = blockIdx.x * BWD_CS, r0 = blockIdx.y * R;
  const int rows = min(R, N - r0);
  int* cnt = bsm + (SIDX ? bwd_idx_words(N, K) : 0);  // (R, BWD_CS)
  const int* Ib = idx + (size_t)b * N * K;
  if constexpr (SIDX) {
    const int e_n = N * K;
    if (e_n % 4 == 0 && hs::aligned16(Ib)) {
      for (int e = 4 * threadIdx.x; e < e_n; e += 4 * BWD_THREADS)
        hs::cp_async16(bsm + e, Ib + e, true);
    } else {
      for (int e = threadIdx.x; e < e_n; e += BWD_THREADS) hs::cp_async4(bsm + e, Ib + e, true);
    }
    hs::cp_async_commit();
    Ib = bsm;
  }
  for (int e = threadIdx.x; e < rows * BWD_CS; e += BWD_THREADS) cnt[e] = 0;

  // items (point q, load v of the slice); v = lane % QV for every item, as
  // BWD_THREADS is a multiple of 32 and QV divides 32
  const int items = N * QV;
  const int v = threadIdx.x % QV, c = c0 + v * VEC;
  const bool live = c < C;  // C % VEC == 0, so a load lies wholly inside or outside
  const int rot = (threadIdx.x / 8) % 4;
  const int* Wb = win + (size_t)b * N * C + (live ? c : 0);
  typename W::type cur[BWD_U], nxt[BWD_U];
  auto load = [&](int base, typename W::type (&w)[BWD_U]) {
#pragma unroll
    for (int u = 0; u < BWD_U; ++u) {
      const int item = base + u * BWD_THREADS + threadIdx.x;
      const int q = min(item, items - 1) / QV;  // clamped: loads issue together
      w[u] = W::load(Wb + (size_t)q * C);
    }
  };
  load(0, cur);
  if constexpr (SIDX) hs::cp_async_wait<0>();
  __syncthreads();

  for (int base = 0; base < items; base += BWD_U * BWD_THREADS) {
    if (base + BWD_U * BWD_THREADS < items) load(base + BWD_U * BWD_THREADS, nxt);
#pragma unroll
    for (int u = 0; u < BWD_U; ++u) {
      const int item = base + u * BWD_THREADS + threadIdx.x;
      if (!live || item >= items) continue;
      const int* ir = Ib + (size_t)(item / QV) * K;
#pragma unroll
      for (int s = 0; s < VEC; ++s) {
        const int j = (s + rot) % VEC;
        const int r = ir[W::get(cur[u], j)] - r0;
        if ((unsigned)r < (unsigned)rows) atomicAdd(cnt + r * BWD_CS + v * VEC + j, 1);
      }
    }
#pragma unroll
    for (int u = 0; u < BWD_U; ++u) cur[u] = nxt[u];
  }
  __syncthreads();

  // rows r0 .. r0 + rows - 1 of dfeat, VEC channels a thread
  const float* gbb = gb + (size_t)b * C;
  float scale[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float g = live ? gbb[c + j] : 0.f;
    scale[j] = hs::is_bf16<T> ? hs::bf16_round(g * (1.f / N)) : g / N;
  }
  if (!live) return;
  for (int e = threadIdx.x; e < rows * QV; e += BWD_THREADS) {
    const int r = e / QV;  // e % QV == v
    T* out = dfeat + ((size_t)b * N + r0 + r) * C + c;
    float d[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) d[j] = (float)cnt[r * BWD_CS + v * VEC + j] * scale[j];
    if constexpr (VEC == 4 && !hs::is_bf16<T>) {
      *reinterpret_cast<float4*>(out) = make_float4(d[0], d[1], d[2], d[3]);
    } else if constexpr (VEC == 4) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(d[0], d[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(d[2], d[3]);
      uint2 pk;
      pk.x = *reinterpret_cast<const unsigned*>(&lo);
      pk.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(out) = pk;
    } else {
      hs::store_f(out, d[0]);
    }
  }
}

// The K10 launch plan: idx[b] staged and every row counted in one block
// where both fit in shared memory; else idx staged where it takes at most
// half, and the rows split over blocks so that their counts fill the rest;
// else idx read through L1 and the rows split.  VEC 4 where C % 4 == 0 and
// win and dfeat lie on 16-byte boundaries.
template <typename T, int VEC, bool SIDX>
int launch_bwd_k(const int* idx, const int* win, const float* gb, T* dfeat, int B, int N, int K,
                 int C, int R, cudaStream_t s) {
  auto kernel = orl_bwd_kernel<T, VEC, SIDX>;
  const size_t smem = bwd_smem_bytes(N, K, R, SIDX);
  cudaError_t err = hs::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + BWD_CS - 1) / BWD_CS, (N + R - 1) / R, B);
  kernel<<<grid, BWD_THREADS, smem, s>>>(idx, win, gb, dfeat, N, K, C, R);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_bwd_v(const int* idx, const int* win, const float* gb, T* dfeat, int B, int N, int K,
                 int C, cudaStream_t s) {
  const size_t row = sizeof(int) * BWD_CS, idx_bytes = sizeof(int) * bwd_idx_words(N, K);
  if (bwd_smem_bytes(N, K, N, true) <= SMEM_MAX)
    return launch_bwd_k<T, VEC, true>(idx, win, gb, dfeat, B, N, K, C, N, s);
  if (idx_bytes <= SMEM_MAX / 2)
    return launch_bwd_k<T, VEC, true>(idx, win, gb, dfeat, B, N, K, C,
                                      (int)((SMEM_MAX - idx_bytes) / row), s);
  return launch_bwd_k<T, VEC, false>(idx, win, gb, dfeat, B, N, K, C, (int)(SMEM_MAX / row), s);
}

template <typename T>
int launch_bwd(const int* idx, const int* win, const float* gb, T* dfeat, int B, int N, int K,
               int C, cudaStream_t s) {
  if (B < 1 || B > 65535 || C < 1) return (int)cudaErrorInvalidValue;
  if (C % 4 == 0 && hs::aligned16(win) && hs::aligned16(dfeat))
    return launch_bwd_v<T, 4>(idx, win, gb, dfeat, B, N, K, C, s);
  return launch_bwd_v<T, 1>(idx, win, gb, dfeat, B, N, K, C, s);
}

}  // namespace

// feat (B, N, C) fp32, or bf16 when fast != 0; idx (B, N, K) int32 -> out
// (B, 1, C) fp32.
extern "C" int hs_orl(const void* feat, int fast, const int* idx, float* out, int B, int N, int K,
                      int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch(static_cast<const __nv_bfloat16*>(feat), idx, out, nullptr, B, N, N, K, C,
                       s)
              : launch(static_cast<const float*>(feat), idx, out, nullptr, B, N, N, K, C, s);
}

// The query-sharded branch (sequence-parallel serving, pallas_hs_fused.py's
// nq_valid = idx.shape[1]): feat (B, M, C) the gathered source rows, idx (B, NQ,
// K) into them -> out (B, 1, C) = mean over the NQ query rows of max_k
// feat[idx]; the block stages the M rows and walks the NQ queries as hs_orl.
extern "C" int hs_orl_qs(const void* feat, int fast, const int* idx, float* out, int B, int NQ,
                         int M, int K, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch(static_cast<const __nv_bfloat16*>(feat), idx, out, nullptr, B, NQ, M, K,
                       C, s)
              : launch(static_cast<const float*>(feat), idx, out, nullptr, B, NQ, M, K, C, s);
}

// The forward of the differentiable op: as hs_orl, and win (B, N, C) int32, the
// first k reaching each channel's max.
extern "C" int hs_orl_win(const void* feat, int fast, const int* idx, float* out, int* win, int B,
                          int N, int K, int C, void* stream) {
  if (hsb::supported(N, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch<__nv_bfloat16, true>(static_cast<const __nv_bfloat16*>(feat), idx, out,
                                            win, B, N, N, K, C, s)
              : launch<float, true>(static_cast<const float*>(feat), idx, out, win, B, N, N, K,
                                    C, s);
}

// K10: idx (B, N, K), win (B, N, C), gb (B, C) the cotangent of out -> dfeat (B, N, C),
// fp32 or (fast != 0) bf16.  One launch, no scratch.
extern "C" int hs_orl_bwd(const int* idx, const int* win, const float* gb, void* dfeat, int B,
                          int N, int K, int C, int fast, void* stream) {
  if (hsb::supported(N, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch_bwd(idx, win, gb, static_cast<__nv_bfloat16*>(dfeat), B, N, K, C, s)
              : launch_bwd(idx, win, gb, static_cast<float*>(dfeat), B, N, K, C, s);
}
