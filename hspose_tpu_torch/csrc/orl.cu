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
// The differentiable op, either tier: hs_orl_win is the same kernel with WIN,
// which also records, per (point, channel), the first k reaching the max (a
// strict > from -FLT_MAX in increasing k, pallas_hs_fused.py:381-389); the
// serving instantiations (WIN false) are compiled from the same lines.  Its
// backward K10, hs_orl_bwd, replaces hspose_tpu/ops/pallas_hs_fused.py::
// _orl_bwd_kernel (exact=True, and exact=False in bf16 with each entry's
// gb * (1/N) rounded to bf16): dfeat[b, r, c] = gb[b, c] / N times the number of (point, k)
// whose neighbour k is row r and whose channel c was won by that k.  The
// count follows r's inverse neighbour list (hs_fused_bwd.cuh), so no atomics
// and no order enter.  Plain versions: hspose_tpu_torch/ops/cuda_hs_fused.py::
// orl_global_fused_fwd_plain and orl_global_fused_bwd_plain.  What bounds it:
// it reads each (point, channel) winner once per neighbour list entry, from
// L2, and writes (B, N, C).

#include <cfloat>

#include "hs_fused_bwd.cuh"

namespace {

constexpr int TQ = 32;           // points per tile: the first sum's unit
constexpr int MAX_THREADS = 512;
constexpr int THREADS = 128;     // K10
constexpr int SMEM_MAX = 232448;  // shared memory a block may use (227 KB)

// The shared memory of one block: N rows of Cs values and the (tiles, Cs)
// tile sums; the (N, K) indices, when staged, lie between them.
inline size_t smem_bytes(int N, int Cs, int elem) {
  return (size_t)N * Cs * elem + sizeof(float) * (size_t)((N + TQ - 1) / TQ) * Cs;
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
inline int slice_width(int B, int N, int C, int elem, int sms) {
  int best = 0;
  double best_cost = 0.0;
  for (int i = 0; i < 4; ++i) {
    const int cs = ROW_BYTES[i] / elem;
    if (C % cs || smem_bytes(N, cs, elem) > SMEM_MAX) continue;
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
           int* __restrict__ win, int N, int K_arg, int C, int Cs) {
  constexpr int VEC = 16 / sizeof(T);  // channels per 16 bytes
  extern __shared__ __align__(16) uint4 srow[];  // (N, Q): feat[b, :, c0:c0+Cs]
  const int K = KT ? KT : K_arg;
  const int Q = Cs / VEC, tiles = (N + TQ - 1) / TQ;
  const int b = blockIdx.y, c0 = blockIdx.x * Cs;
  int* sidx = reinterpret_cast<int*>(srow + (size_t)N * Q);                // (N, K) if SIDX
  float* tsum = reinterpret_cast<float*>(sidx + (SIDX ? (size_t)N * K : 0));  // (tiles, Cs)

  const T* Fb = feat + (size_t)b * N * C + c0;
  for (int e = threadIdx.x; e < N * Q; e += blockDim.x)
    hs::cp_async16(srow + e, Fb + (size_t)(e / Q) * C + (e % Q) * VEC, true);
  const int* Ib = idx + (size_t)b * N * K;
  if constexpr (SIDX) {
    for (int e = threadIdx.x; e < N * K / 4; e += blockDim.x)
      hs::cp_async16(sidx + 4 * e, Ib + 4 * e, true);
    Ib = sidx;
  }
  hs::cp_async_commit();
  hs::cp_async_wait<0>();
  __syncthreads();

  for (int item = threadIdx.x; item < tiles * Q; item += blockDim.x) {
    const int tile = item / Q, v = item % Q, q0 = tile * TQ, tq = min(TQ, N - q0);
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
        int4* w = reinterpret_cast<int4*>(win + ((size_t)b * N + q0 + t) * C + c0 + v * VEC);
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
    out[(size_t)b * C + c0 + c] = total / N;
  }
}

template <typename T, bool WIN, int KT, bool SIDX>
int launch_k(const T* feat, const int* idx, float* out, int* win, int B, int N, int K, int C,
             int Cs, cudaStream_t s) {
  auto kernel = orl_kernel<T, WIN, KT, SIDX>;
  const size_t smem = smem_bytes(N, Cs, sizeof(T)) + (SIDX ? sizeof(int) * (size_t)N * K : 0);
  cudaError_t err = hs::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int items = (N + TQ - 1) / TQ * (Cs * (int)sizeof(T) / 16);
  const int threads = min(MAX_THREADS, (items + 31) / 32 * 32);
  kernel<<<dim3(C / Cs, B), threads, smem, s>>>(feat, idx, out, win, N, K, C, Cs);
  return (int)cudaGetLastError();
}

// The indices go to shared memory beside the features where they fit.
template <typename T, bool WIN, int KT>
int launch_kt(const T* feat, const int* idx, float* out, int* win, int B, int N, int K, int C,
              int Cs, cudaStream_t s) {
  if (smem_bytes(N, Cs, sizeof(T)) + sizeof(int) * (size_t)N * K <= SMEM_MAX)
    return launch_k<T, WIN, KT, true>(feat, idx, out, win, B, N, K, C, Cs, s);
  return launch_k<T, WIN, KT, false>(feat, idx, out, win, B, N, K, C, Cs, s);
}

template <typename T, bool WIN = false>
int launch(const T* feat, const int* idx, float* out, int* win, int B, int N, int K, int C,
           cudaStream_t s) {
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int Cs = slice_width(B, N, C, sizeof(T), sms);
  if (!Cs || !hs::aligned16(feat) || (WIN && !hs::aligned16(win)))
    return (int)cudaErrorInvalidValue;
  switch (hs::aligned16(idx) ? K : 0) {  // the model's K = 20 and 8 unrolled
    case 20: return launch_kt<T, WIN, 20>(feat, idx, out, win, B, N, K, C, Cs, s);
    case 8: return launch_kt<T, WIN, 8>(feat, idx, out, win, B, N, K, C, Cs, s);
    default: return launch_k<T, WIN, 0, false>(feat, idx, out, win, B, N, K, C, Cs, s);
  }
}

// One block per source row r of batch b (grid.x = B * N), threads over channels:
// dfeat[b, r, c] = gb[b, c] / N times the count of r's inverse-list entries
// (q, k) with win[b, q, c] == k.  The bf16 tier (T = __nv_bfloat16) takes each
// entry's gb * (1/N) rounded to bf16 (_scatter_rows' operand): the count times
// it is exact in fp32, and dfeat is that rounded to bf16.
template <typename T>
__global__ void __launch_bounds__(THREADS)
orl_bwd_kernel(const int* __restrict__ rowptr, const int* __restrict__ ent,
               const int* __restrict__ win, const float* __restrict__ gb,
               T* __restrict__ dfeat, int N, int K, int C) {
  const size_t row = blockIdx.x;
  const int b = (int)(row / N), r = (int)(row % N);
  const int* rp = rowptr + (size_t)b * (N + 1);
  const int* eb = ent + (size_t)b * N * K;
  const int lo = rp[r], hi = rp[r + 1];
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    int cnt = 0;
    for (int p = lo; p < hi; ++p) {
      const int e = eb[p];
      cnt += win[((size_t)b * N + e / K) * C + c] == e % K;
    }
    if constexpr (hs::is_bf16<T>)
      hs::store_f(dfeat + row * C + c, (float)cnt * hs::bf16_round(gb[(size_t)b * C + c] * (1.f / N)));
    else
      dfeat[row * C + c] = (float)cnt * (gb[(size_t)b * C + c] / N);
  }
}

}  // namespace

// feat (B, N, C) fp32, or bf16 when fast != 0; idx (B, N, K) int32 -> out
// (B, 1, C) fp32.
extern "C" int hs_orl(const void* feat, int fast, const int* idx, float* out, int B, int N, int K,
                      int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch(static_cast<const __nv_bfloat16*>(feat), idx, out, nullptr, B, N, K, C, s)
              : launch(static_cast<const float*>(feat), idx, out, nullptr, B, N, K, C, s);
}

// The forward of the differentiable op: as hs_orl, and win (B, N, C) int32, the
// first k reaching each channel's max.
extern "C" int hs_orl_win(const void* feat, int fast, const int* idx, float* out, int* win, int B,
                          int N, int K, int C, void* stream) {
  if (hsb::supported(N, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch<__nv_bfloat16, true>(static_cast<const __nv_bfloat16*>(feat), idx, out,
                                            win, B, N, K, C, s)
              : launch<float, true>(static_cast<const float*>(feat), idx, out, win, B, N, K, C,
                                    s);
}

// K10: idx (B, N, K), win (B, N, C), gb (B, C) the cotangent of out -> dfeat (B, N, C),
// fp32 or (fast != 0) bf16.  Scratch: rowptr (B, N + 1), ent (B, N*K) int32.
extern "C" int hs_orl_bwd(const int* idx, const int* win, const float* gb, int* rowptr, int* ent,
                          void* dfeat, int B, int N, int K, int C, int fast, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hsb::supported(N, K)) return (int)cudaErrorInvalidValue;
  cudaError_t err = hsb::inverse_index(idx, rowptr, ent, B, N, N * K, s);
  if (err != cudaSuccess) return (int)err;
  if (fast)
    orl_bwd_kernel<<<B * N, THREADS, 0, s>>>(rowptr, ent, win, gb,
                                             static_cast<__nv_bfloat16*>(dfeat), N, K, C);
  else
    orl_bwd_kernel<<<B * N, THREADS, 0, s>>>(rowptr, ent, win, gb, static_cast<float*>(dfeat), N,
                                             K, C);
  return (int)cudaGetLastError();
}
