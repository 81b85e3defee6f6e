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
// winners (59 MB), which is what limits it; the plain version writes a
// (B, N, K, Co) theta tensor per support instead.  The backward reads the
// winners once and does about 3e8 compares to route them.  In bf16 only rf
// (and drf) halve; the winners, fp32 outputs and fp32 sums are the same, so
// the bound and the time barely move: the bf16 variant is there for its
// roundings, not for speed.
//
// Design.  Forward: one block per (batch, 16-query tile), threads over output
// channels; the block stages its queries' rf rows and the (3, S*Co)
// directions in shared memory, each thread runs the max over k for each
// support with a strict > so the first maximal k wins, as the TPU kernel's
// min over the k that reach the max does.  Backward: one block per (batch,
// 16-query tile), walking the S*Co columns in chunks of 32.  Per chunk it
// stages each query's winner and gated cotangent; threads over the (query,
// k) rows add the routed directions into drf rows held in shared memory
// (each row has one owner, so no atomics), and 96 threads write the block's
// partial of dd.  A second launch adds the partials in block order, so dd is
// the same from run to run.

#include "hs_common.cuh"

namespace {

constexpr int TQ = 16;  // queries per block
constexpr int FWD_THREADS = 128;
constexpr int BWD_THREADS = 256;
constexpr int CH = 32;  // columns per chunk in the backward

template <typename T>
__global__ void __launch_bounds__(FWD_THREADS)
surface_fwd_kernel(const T* __restrict__ rf, const T* __restrict__ dirs,
                   float* __restrict__ out, int* __restrict__ win, int N, int K, int S,
                   int Co) {
  extern __shared__ float smem[];
  const int SC = S * Co;
  float* sd = smem;            // (3, S*Co)
  float* srf = smem + 3 * SC;  // (TQ, K, 3)
  const int b = blockIdx.y, q0 = blockIdx.x * TQ;
  const int tq = min(TQ, N - q0);

  for (int e = threadIdx.x; e < 3 * SC; e += blockDim.x) sd[e] = hs::load_f(dirs + e);
  const T* rfb = rf + ((size_t)b * N + q0) * K * 3;
  for (int e = threadIdx.x; e < tq * K * 3; e += blockDim.x) srf[e] = hs::load_f(rfb + e);
  __syncthreads();

  for (int c = threadIdx.x; c < Co; c += blockDim.x) {
    for (int t = 0; t < tq; ++t) {
      const size_t row = (size_t)b * N + q0 + t;
      const float* r = srf + t * K * 3;
      float total = 0.f;
      for (int s = 0; s < S; ++s) {
        const int col = s * Co + c;
        const float d0 = sd[col], d1 = sd[SC + col], d2 = sd[2 * SC + col];
        float m = fmaxf(r[0] * d0 + r[1] * d1 + r[2] * d2, 0.f);
        int kb = 0;
        for (int j = 1; j < K; ++j) {
          const float v = fmaxf(r[j * 3] * d0 + r[j * 3 + 1] * d1 + r[j * 3 + 2] * d2, 0.f);
          if (v > m) {
            m = v;
            kb = j;
          }
        }
        win[row * SC + col] = kb;
        total += m;
      }
      out[row * Co + c] = total / S;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
surface_bwd_kernel(const T* __restrict__ rf, const T* __restrict__ dirs,
                   const int* __restrict__ win, const float* __restrict__ gb,
                   T* __restrict__ drf, float* __restrict__ partial, int N, int K, int S,
                   int Co) {
  extern __shared__ float smem[];
  const int SC = S * Co;
  float* srf = smem;                        // (TQ, K, 3)
  float* sdrf = srf + TQ * K * 3;           // (TQ, K, 3)
  float* su = sdrf + TQ * K * 3;            // (TQ, CH) gated cotangent at the winner
  int* sw = reinterpret_cast<int*>(su + TQ * CH);  // (TQ, CH) winner
  float* sd = reinterpret_cast<float*>(sw + TQ * CH);  // (3, CH)
  const int b = blockIdx.y, q0 = blockIdx.x * TQ;
  const int tq = min(TQ, N - q0);
  const size_t blk = (size_t)b * gridDim.x + blockIdx.x;

  const T* rfb = rf + ((size_t)b * N + q0) * K * 3;
  for (int e = threadIdx.x; e < tq * K * 3; e += blockDim.x) {
    srf[e] = hs::load_f(rfb + e);
    sdrf[e] = 0.f;
  }
  __syncthreads();

  for (int c0 = 0; c0 < SC; c0 += CH) {
    const int nc = min(CH, SC - c0);
    for (int e = threadIdx.x; e < TQ * CH; e += blockDim.x) {
      const int t = e / CH, j = e % CH;
      int k = 0;
      float u = 0.f;
      if (t < tq && j < nc) {
        const int col = c0 + j;
        const size_t row = (size_t)b * N + q0 + t;
        k = win[row * SC + col];
        const float* r = srf + (t * K + k) * 3;
        const float theta = r[0] * hs::load_f(dirs + col) + r[1] * hs::load_f(dirs + SC + col) +
                            r[2] * hs::load_f(dirs + 2 * SC + col);
        if (theta > 0.f) u = hs::div_s<hs::is_bf16<T>>(gb[row * Co + col % Co], S);
        if constexpr (hs::is_bf16<T>) u = hs::bf16_round(u);
      }
      sw[e] = k;
      su[e] = u;
    }
    for (int e = threadIdx.x; e < 3 * CH; e += blockDim.x) {
      const int a = e / CH, j = e % CH;
      sd[e] = j < nc ? hs::load_f(dirs + a * SC + c0 + j) : 0.f;
    }
    __syncthreads();

    // this block's partial of dd, its queries added in order
    for (int e = threadIdx.x; e < 3 * nc; e += blockDim.x) {
      const int a = e / nc, j = e % nc;
      float acc = 0.f;
      for (int t = 0; t < tq; ++t)
        acc += su[t * CH + j] * srf[(t * K + sw[t * CH + j]) * 3 + a];
      partial[(blk * 3 + a) * SC + c0 + j] = acc;
    }
    // drf: each (query, k) row collects the columns it won
    for (int r = threadIdx.x; r < tq * K; r += blockDim.x) {
      const int t = r / K, k = r % K;
      float a0 = sdrf[r * 3], a1 = sdrf[r * 3 + 1], a2 = sdrf[r * 3 + 2];
      for (int j = 0; j < nc; ++j) {
        if (sw[t * CH + j] == k) {
          const float u = su[t * CH + j];
          a0 += u * sd[j];
          a1 += u * sd[CH + j];
          a2 += u * sd[2 * CH + j];
        }
      }
      sdrf[r * 3] = a0;
      sdrf[r * 3 + 1] = a1;
      sdrf[r * 3 + 2] = a2;
    }
    __syncthreads();
  }

  T* drfb = drf + ((size_t)b * N + q0) * K * 3;
  for (int e = threadIdx.x; e < tq * K * 3; e += blockDim.x) hs::store_f(drfb + e, sdrf[e]);
}

size_t bwd_smem(int K) {
  return sizeof(float) * (2 * (size_t)TQ * K * 3 + 2 * TQ * CH + 3 * CH);
}

template <typename T>
cudaError_t launch_fwd(const void* rf, const void* dirs, float* out, int* win, int B, int N,
                       int K, int S, int Co, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * (size_t)S * Co + (size_t)TQ * K * 3);
  cudaError_t err = hs::allow_smem(surface_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TQ - 1) / TQ, B);
  surface_fwd_kernel<T><<<grid, FWD_THREADS, smem, stream>>>(
      static_cast<const T*>(rf), static_cast<const T*>(dirs), out, win, N, K, S, Co);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* rf, const void* dirs, const int* win, const float* gb,
                       void* drf, float* partial, int B, int N, int K, int S, int Co,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem(K);
  cudaError_t err = hs::allow_smem(surface_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TQ - 1) / TQ, B);
  surface_bwd_kernel<T><<<grid, BWD_THREADS, smem, stream>>>(
      static_cast<const T*>(rf), static_cast<const T*>(dirs), win, gb, static_cast<T*>(drf),
      partial, N, K, S, Co);
  return cudaGetLastError();
}

}  // namespace

// Blocks of the backward: the dd partial-sum scratch is (hs_surface_bwd_parts(B, N), 3, S*Co).
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
  return (int)hs::sum_partials(partial, dd, hs_surface_bwd_parts(B, N), 3 * S * Co, st);
}
