// The HS surface reduction's body, shared by the serving kernel and the
// differentiable op's forward (K2, hs_surface.cu::surface_kernel) and the
// training path's forward (K12, hs_surface_train.cu::surface_fwd_kernel).
// The two differ only in how a block stages its unit rf rows: K2 gathers and
// normalises them from the points and the neighbour index (hs::stage_rf),
// K12 reads them from the (B, N, K, 3) tensor the layer formed.
//
//   out[q, c] = mean_s max_k relu(rf[q, k] . dir[:, s * Co + c])
//   win[q, s * Co + c] = the first k that reaches that max (WIN)
//
// The layout: each thread owns one output channel and holds that channel's
// 3 x S directions in registers (loaded once, S a template argument; S above
// the template's count is run in groups of eight supports, their directions
// reloaded per query), then per query reads each neighbour's staged rf row
// once (a 16-byte broadcast load) and updates the S running maxima: 3S fp32
// operations and S maxima per shared-memory load.  The loop order over
// (k, s) is free because each support's max is exact; theta keeps one
// expression, r0 * d0 + r1 * d1 + r2 * d2 (so nvcc forms the same
// multiply-add chain wherever it is written), the supports are added in
// increasing s from 0.f and the total is divided by S.
//
// Without WIN the max starts at 0.f (every relu term is >= 0).  With WIN
// each support keeps theta's running max from k = 0 by a strict > in
// increasing k, and its k; relu comes after: when that max is > 0 its first
// k is the first k that reaches the max of relu(theta), and otherwise every
// relu term is 0 and the first k to reach it is 0.  That is the winner a
// strict > from -FLT_MAX over the relu values selects (the rule before this
// body, which paid one more compare-unit operation per (k, support): the
// max, compare and selects run on the SM's half-rate ALU pipe and bound the
// loop), and the max is the same value, so the fp32 outputs keep their bits.
//
// FAST is the bf16 tier: the directions as bf16 operands (rounded where they
// are loaded; a bf16 tensor's values are already so), and the staged rf rows
// bf16 values; every product is then exact, accumulation and output fp32.

#pragma once

#include "hs_common.cuh"

namespace hss {

__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// Queries t of one block (its staged rows srf[t * K + j], t < tq, as float4
// with the rf row in x, y, z) reduced over THREADS threads: threads over
// output channels and, when Co < THREADS, queries side by side.  KT = K and
// ST = S unrolled (0: read at run time, the supports held eight at a time).
// D is the directions' element type (fp32, or bf16 for K12's bf16 tier).
template <bool FAST, bool WIN, int KT, int ST, int THREADS, typename D>
__device__ __forceinline__ void reduce_rows(const float4* __restrict__ srf,
                                            const D* __restrict__ dirs, float* __restrict__ out,
                                            int* __restrict__ win, size_t row0, int tq,
                                            int K_arg, int S_arg, int Co) {
  constexpr int SG = ST ? ST : 8;  // supports whose directions a thread holds
  const int K = KT ? KT : K_arg, S = ST ? ST : S_arg;
  const int SC = S * Co;
  const int lanes_c = min(Co, THREADS), QPB = THREADS / lanes_c;
  const int ql = threadIdx.x / lanes_c;
  if (ql >= QPB) return;
  const bool held = S <= SG;  // one group: the directions stay for every query
  for (int c = threadIdx.x % lanes_c; c < Co; c += lanes_c) {
    float d0[SG], d1[SG], d2[SG];
    auto load_dirs = [&](int g0) {
#pragma unroll
      for (int s = 0; s < SG; ++s) {
        const int col = (g0 + s) * Co + c;
        const bool ok = ST || g0 + s < S;
        d0[s] = ok ? ldg_f(dirs + col) : 0.f;
        d1[s] = ok ? ldg_f(dirs + SC + col) : 0.f;
        d2[s] = ok ? ldg_f(dirs + 2 * SC + col) : 0.f;
        if (FAST) {
          d0[s] = hs::bf16_round(d0[s]);
          d1[s] = hs::bf16_round(d1[s]);
          d2[s] = hs::bf16_round(d2[s]);
        }
      }
    };
    if (held) load_dirs(0);
    for (int t = ql; t < tq; t += QPB) {
      const size_t row = row0 + t;
      float total = 0.f;
      for (int g0 = 0; g0 < S; g0 += SG) {
        if (!held) load_dirs(g0);
        float m[SG];
        int kb[SG];
        if constexpr (WIN) {  // theta's max from k = 0, its first k
          const float4 r = srf[t * K];
#pragma unroll
          for (int s = 0; s < SG; ++s) {
            m[s] = r.x * d0[s] + r.y * d1[s] + r.z * d2[s];
            kb[s] = 0;
          }
        } else {  // every relu term is >= 0, so the max may start at 0
#pragma unroll
          for (int s = 0; s < SG; ++s) m[s] = 0.f;
        }
#pragma unroll
        for (int j = WIN ? 1 : 0; j < K; ++j) {
          const float4 r = srf[t * K + j];
#pragma unroll
          for (int s = 0; s < SG; ++s) {
            const float v = r.x * d0[s] + r.y * d1[s] + r.z * d2[s];
            if constexpr (WIN) {
              if (v > m[s]) {
                m[s] = v;
                kb[s] = j;
              }
            } else {              m[s] = fmaxf(m[s], v);
            }
          }
        }
#pragma unroll
        for (int s = 0; s < SG; ++s) {
          if (ST || g0 + s < S) {
            if constexpr (WIN) {
              win[row * SC + (size_t)(g0 + s) * Co + c] = m[s] > 0.f ? kb[s] : 0;
              total += fmaxf(m[s], 0.f);
            } else {
              total += m[s];
            }
          }
        }
      }
      out[row * Co + c] = total / S;
    }
  }
}

}  // namespace hss
