// The CUDA-core GEMM tile shared by the support kernels: K3's fp32
// projection (hs_support.cu), K11's projection of the source rows in both
// tiers (hs_support_train.cu) and K8's products dfeat = dproj_src W^T and
// dW = feat^T dproj_src (hs_support.cu).
//
// C (M, Nc) = A (M, Kd) W (Kd, Nc) (+ bias), fp32 sums on the CUDA cores.
// MT x NT output tiles (128 x 128, or 64 x 64 where the larger tile would
// leave the card's SMs idle), 256 threads each owning MT/16 rows (groups of
// four at ty * 4 + 64 g) by NT/16 columns (float4 groups at tx * 4 + 64 j),
// so that per k a thread reads MT/64 + NT/64 float4 from shared memory for
// (MT/16)(NT/16) fused multiply-adds.  Both tiles are stored k-major (As[k][m],
// Ws[k][n]) and double-buffered: an operand whose rows run along the tile's
// fast index (W, or A read transposed) comes by cp.async into the other
// buffer while this tile's products run; one that must be transposed (A, or
// W read transposed) is loaded into registers then and written after them.
// Every output is one fused multiply-add chain in increasing k from 0.f
// (from the slice's first k with split-k), with the bias added at the store
// or no bias: the arithmetic of the 64 x 64 kernel this tile replaced, so
// every output keeps its bits, whatever the tile.
//
// Template arguments: TA, A's storage (fp32, or bf16 widened exactly); AT
// reads A[m, k] at A[k * lda + m] (else A[m * lda + k]); WT reads W[k, n] at
// W[n * ldw + k] (else W[k * ldw + n]); WR rounds each W value to bf16 (the
// bf16 tier's W operand) where it is staged.  blockIdx.z sums the k slice
// [z * kchunk, (z + 1) * kchunk) into C + z * M * Nc (split-k partial sums,
// added in order by hs::sum_partials); kchunk is a multiple of both tile
// depths.  KT is the tile's k depth (PK, or PK64 for the 64 x 64 tile); zeros
// pad the last stage, which leaves every sum as it was.  Needs
// Nc, Kd (or, with AT, M), lda and ldw multiples of 4 and A, W 16-byte
// aligned (8 bytes for bf16 A); project_supported checks them.
#pragma once

#include "hs_common.cuh"

namespace hsp {

constexpr int PK = 16;        // k depth of a 128 x 128 tile
constexpr int PK64 = 32;      // k depth of a 64 x 64 tile: more work per stage to cover its loads
constexpr int THREADS = 256;

// Four consecutive elements of fp32 or bf16 storage as a float4 (bf16 widened
// exactly), or zeros where !ok.
__device__ __forceinline__ float4 load4(const float* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, bool ok) {
  if (!ok) return make_float4(0.f, 0.f, 0.f, 0.f);
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename TA, bool AT, bool WT, bool WR, int MT, int NT, int KT>
__global__ void __launch_bounds__(THREADS, 2)
gemm_kernel(const TA* __restrict__ A, int lda, const float* __restrict__ W, int ldw,
            const float* __restrict__ bias, float* __restrict__ C, int M, int Kd, int Nc,
            int kchunk) {
  constexpr int RG = MT / 64, NJ = NT / 64;       // row groups, float4 column groups per thread
  constexpr int VA = MT * KT / 4 / THREADS;       // float4 per thread of the A tile
  constexpr int VW = NT * KT / 4 / THREADS;       // float4 per thread of the W tile
  constexpr int AQ = MT / 4;                      // threads per k row of a transposed-read A tile
  __shared__ __align__(16) float As[2][KT][MT + 4];
  __shared__ __align__(16) float Ws[2][KT][NT];
  const int m0 = blockIdx.y * MT, n0 = blockIdx.x * NT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kb = blockIdx.z * kchunk, ke = min(Kd, kb + kchunk);
  C += (size_t)blockIdx.z * M * Nc;

  // A tile: !AT, rows tid / (KT/4) + (THREADS / (KT/4)) v, k (tid % (KT/4)) * 4
  // .. + 3 into registers, stored transposed; AT, k (tid / AQ + (THREADS / AQ) v), m (tid % AQ) * 4
  // .. + 3 into registers (bf16 widened; fp32 the same way, so one path
  // serves both)
  float4 ra[VA];
  auto load_a = [&](int k0) {
#pragma unroll
    for (int v = 0; v < VA; ++v) {
      if constexpr (AT) {
        const int k = tid / AQ + THREADS / AQ * v, m = tid % AQ * 4;
        ra[v] = load4(A + (size_t)(k0 + k) * lda + m0 + m, k0 + k < ke && m0 + m < M);
      } else {
        const int r = tid / (KT / 4) + THREADS / (KT / 4) * v, c = tid % (KT / 4) * 4;
        ra[v] = load4(A + (size_t)(m0 + r) * lda + k0 + c, m0 + r < M && k0 + c < ke);
      }
    }
  };
  auto store_a = [&](int buf) {
#pragma unroll
    for (int v = 0; v < VA; ++v) {
      if constexpr (AT) {
        *reinterpret_cast<float4*>(&As[buf][tid / AQ + THREADS / AQ * v][tid % AQ * 4]) = ra[v];
      } else {
        const int r = tid / (KT / 4) + THREADS / (KT / 4) * v, c = tid % (KT / 4) * 4;
        As[buf][c + 0][r] = ra[v].x;
        As[buf][c + 1][r] = ra[v].y;
        As[buf][c + 2][r] = ra[v].z;
        As[buf][c + 3][r] = ra[v].w;
      }
    }
  };
  // W tile: !WT by cp.async (WR rounds each thread's own copies once they
  // land); WT, column n = tid % NT, k (tid / NT + (THREADS / NT) v) * 4 .. + 3
  // into registers, stored transposed
  float4 rw[WT ? VW : 1];
  auto load_w = [&](int buf, int k0) {
    if constexpr (WT) {
#pragma unroll
      for (int v = 0; v < VW; ++v) {
        const int n = tid % NT, k = (tid / NT + THREADS / NT * v) * 4;
        rw[v] = load4(W + (size_t)(n0 + n) * ldw + k0 + k, n0 + n < Nc && k0 + k < ke);
      }
    } else {
#pragma unroll
      for (int v = 0; v < VW; ++v) {
        const int e = tid + v * THREADS, r = e / (NT / 4), c = e % (NT / 4) * 4;
        const bool ok = k0 + r < ke && n0 + c < Nc;
        hs::cp_async16(&Ws[buf][r][c], ok ? W + (size_t)(k0 + r) * ldw + n0 + c : W, ok);
      }
      hs::cp_async_commit();
    }
  };
  auto land_w = [&](int buf) {  // this thread's part of the W tile is in place
    if constexpr (WT) {
#pragma unroll
      for (int v = 0; v < VW; ++v) {
        const int n = tid % NT, k = (tid / NT + THREADS / NT * v) * 4;
        const float x[4] = {rw[v].x, rw[v].y, rw[v].z, rw[v].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) Ws[buf][k + j][n] = WR ? hs::bf16_round(x[j]) : x[j];
      }
    } else {
      hs::cp_async_wait<0>();
      if constexpr (WR) {
#pragma unroll
        for (int v = 0; v < VW; ++v) {
          const int e = tid + v * THREADS, r = e / (NT / 4), c = e % (NT / 4) * 4;
          float4* p = reinterpret_cast<float4*>(&Ws[buf][r][c]);
          const float4 x = *p;
          *p = make_float4(hs::bf16_round(x.x), hs::bf16_round(x.y), hs::bf16_round(x.z),
                           hs::bf16_round(x.w));
        }
      }
    }
  };

  float acc[RG * 4][NJ * 4];
#pragma unroll
  for (int i = 0; i < RG * 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ * 4; ++j) acc[i][j] = 0.f;

  const int nk = (ke - kb + KT - 1) / KT;
  load_a(kb);
  load_w(0, kb);
  store_a(0);
  land_w(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    if (t + 1 < nk) {
      load_a(kb + (t + 1) * KT);
      load_w(buf ^ 1, kb + (t + 1) * KT);
    }
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      float a[RG * 4];
#pragma unroll
      for (int g = 0; g < RG; ++g) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[buf][k][g * 64 + ty * 4]);
        a[g * 4 + 0] = a4.x;
        a[g * 4 + 1] = a4.y;
        a[g * 4 + 2] = a4.z;
        a[g * 4 + 3] = a4.w;
      }
      float w[NJ * 4];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 w4 = *reinterpret_cast<const float4*>(&Ws[buf][k][jj * 64 + tx * 4]);
        w[jj * 4 + 0] = w4.x;
        w[jj * 4 + 1] = w4.y;
        w[jj * 4 + 2] = w4.z;
        w[jj * 4 + 3] = w4.w;
      }
#pragma unroll
      for (int i = 0; i < RG * 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ * 4; ++j) acc[i][j] += a[i] * w[j];
    }
    if (t + 1 < nk) {
      store_a(buf ^ 1);
      land_w(buf ^ 1);
    }
    __syncthreads();  // the next tile is in place; this one may be rewritten
  }

#pragma unroll
  for (int i = 0; i < RG * 4; ++i) {
    const int r = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (r >= M) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = n0 + jj * 64 + tx * 4;
      if (col >= Nc) continue;
      const float* a = acc[i] + jj * 4;
      *reinterpret_cast<float4*>(C + (size_t)r * Nc + col) =
          bias ? make_float4(a[0] + bias[col], a[1] + bias[col + 1], a[2] + bias[col + 2],
                             a[3] + bias[col + 3])
               : make_float4(a[0], a[1], a[2], a[3]);
    }
  }
}

// True when gemm<TA, AT, WT> takes these operands (see the note above).
template <typename TA, bool AT>
inline bool project_supported(const TA* A, int lda, const float* W, int ldw, int M, int Kd,
                              int Nc) {
  const size_t amask = hs::is_bf16<TA> ? 7 : 15;
  return Nc % 4 == 0 && (AT ? M : Kd) % 4 == 0 && lda % 4 == 0 && ldw % 4 == 0 &&
         (reinterpret_cast<size_t>(A) & amask) == 0 && hs::aligned16(W);
}

// C = A W (+ bias) over k slices of kchunk (the whole of Kd when kchunk <= 0)
// into C + z * M * Nc.  The 128 x 128 tile, unless it would give fewer than
// two blocks per SM (of 132) and the 64 x 64 one more.
template <typename TA, bool AT = false, bool WT = false, bool WR = false>
inline cudaError_t gemm(const TA* A, int lda, const float* W, int ldw, const float* bias,
                        float* C, int M, int Kd, int Nc, int kchunk, cudaStream_t st) {
  if (!project_supported<TA, AT>(A, lda, W, ldw, M, Kd, Nc) || (kchunk > 0 && kchunk % PK64))
    return cudaErrorInvalidValue;
  if (kchunk <= 0) kchunk = Kd;
  const int kz = (Kd + kchunk - 1) / kchunk;
  const long big = (long)((Nc + 127) / 128) * ((M + 127) / 128) * kz;
  if (big < 2 * 132) {
    const dim3 grid((Nc + 63) / 64, (M + 63) / 64, kz);
    gemm_kernel<TA, AT, WT, WR, 64, 64, PK64><<<grid, THREADS, 0, st>>>(A, lda, W, ldw, bias, C, M, Kd,
                                                                  Nc, kchunk);
  } else {
    const dim3 grid((Nc + 127) / 128, (M + 127) / 128, kz);
    gemm_kernel<TA, AT, WT, WR, 128, 128, PK><<<grid, THREADS, 0, st>>>(A, lda, W, ldw, bias, C, M,
                                                                    Kd, Nc, kchunk);
  }
  return cudaGetLastError();
}

}  // namespace hsp
