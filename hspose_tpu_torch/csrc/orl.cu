// ORL global branch: out (B, 1, C) = mean_n max_k feat[idx[n, k]].
//
// Replaces: hspose_tpu/ops/pallas_hs_fused.py::_orl_fwd_kernel, reached through
// orl_global_fused.  Plain version: hspose_tpu_torch/ops/cuda_hs_fused.py::
// orl_global_plain.
//
// What bounds it on an H100: it reads K rows of C floats per point (at conv_1,
// B=24: 24*1028*20*128*4 B = 253 MB, mostly from L2) and does no arithmetic
// beyond max and add.  The plain version writes and rereads the whole
// (B, N, K, C) gather; here only a (B, tiles, C) partial sum reaches memory.
//
// Design: a first launch, one block per (batch, 32-point tile), threads over
// channels: each thread takes the max over k of its channel for each point of
// the tile, with coalesced row loads, and adds the maxima in point order into
// partial[b, tile, c].  A second small launch sums the tiles in order and
// divides by N.  Both sums have a fixed order, with no atomics, so the result
// is the same from run to run.
//
// The bf16 tier (exact=False of the same TPU kernel) instantiates the first
// launch on bf16 features, which halves the bytes read; the maxima are bf16
// values and every sum stays fp32, as the TPU kernel's exact one-hot gather
// of bf16 rows with fp32 accumulation.
//
// The differentiable op, either tier: hs_orl_win is the first launch with WIN,
// which also records, per (point, channel), the first k reaching the max (a
// strict > from -FLT_MAX, pallas_hs_fused.py:381-389); the serving
// instantiations (WIN false) are compiled from the same lines as before.  Its
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

constexpr int TQ = 32;
constexpr int THREADS = 128;

template <typename T, bool WIN>
__global__ void __launch_bounds__(THREADS)
orl_partial_kernel(const T* __restrict__ feat, const int* __restrict__ idx,
                   float* __restrict__ partial, int* __restrict__ win, int N, int K, int C) {
  extern __shared__ int sidx[];  // (TQ, K)
  const int b = blockIdx.y, tile = blockIdx.x, q0 = tile * TQ;
  const int tq = min(TQ, N - q0);
  for (int e = threadIdx.x; e < tq * K; e += blockDim.x)
    sidx[e] = idx[((size_t)b * N + q0) * K + e];
  __syncthreads();

  const T* Fb = feat + (size_t)b * N * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float sum = 0.f;
    for (int t = 0; t < tq; ++t) {
      float m = -FLT_MAX;
      if constexpr (WIN) {
        int kb = 0;
        for (int j = 0; j < K; ++j) {
          const float v = hs::load_f(Fb + (size_t)sidx[t * K + j] * C + c);
          if (v > m) {
            m = v;
            kb = j;
          }
        }
        win[((size_t)b * N + q0 + t) * C + c] = kb;
      } else {
        for (int j = 0; j < K; ++j) m = fmaxf(m, hs::load_f(Fb + (size_t)sidx[t * K + j] * C + c));
      }
      sum += m;
    }
    partial[((size_t)b * gridDim.x + tile) * C + c] = sum;
  }
}

__global__ void __launch_bounds__(THREADS)
orl_finish_kernel(const float* __restrict__ partial, float* __restrict__ out, int tiles,
                  int N, int C) {
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float sum = 0.f;
    for (int t = 0; t < tiles; ++t) sum += partial[((size_t)b * tiles + t) * C + c];
    out[(size_t)b * C + c] = sum / N;
  }
}

template <typename T, bool WIN = false>
int launch(const T* feat, const int* idx, float* partial, float* out, int* win, int B, int N,
           int K, int C, cudaStream_t s) {
  const int tiles = (N + TQ - 1) / TQ;
  const size_t smem = sizeof(int) * (size_t)TQ * K;
  orl_partial_kernel<T, WIN><<<dim3(tiles, B), THREADS, smem, s>>>(feat, idx, partial, win, N, K,
                                                                   C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  orl_finish_kernel<<<B, THREADS, 0, s>>>(partial, out, tiles, N, C);
  return (int)cudaGetLastError();
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

// Tiles of the first launch: the partial-sum scratch is (B, hs_orl_tiles(N), C).
extern "C" int hs_orl_tiles(int N) { return (N + TQ - 1) / TQ; }

// feat (B, N, C) fp32, or bf16 when fast != 0; idx (B, N, K) int32;
// partial (B, hs_orl_tiles(N), C) scratch -> out (B, 1, C) fp32.
extern "C" int hs_orl(const void* feat, int fast, const int* idx, float* partial, float* out,
                      int B, int N, int K, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch(static_cast<const __nv_bfloat16*>(feat), idx, partial, out, nullptr, B, N,
                       K, C, s)
              : launch(static_cast<const float*>(feat), idx, partial, out, nullptr, B, N, K, C,
                       s);
}

// The forward of the differentiable op: as hs_orl, and win (B, N, C) int32, the
// first k reaching each channel's max.
extern "C" int hs_orl_win(const void* feat, int fast, const int* idx, float* partial, float* out,
                          int* win, int B, int N, int K, int C, void* stream) {
  if (hsb::supported(N, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch<__nv_bfloat16, true>(static_cast<const __nv_bfloat16*>(feat), idx, partial,
                                            out, win, B, N, K, C, s)
              : launch<float, true>(static_cast<const float*>(feat), idx, partial, out, win, B, N,
                                    K, C, s);
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
