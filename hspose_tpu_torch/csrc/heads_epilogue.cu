// The serving heads' first layer after its products: gather, add, BatchNorm, ReLU.
//
// h[b, n, c] = relu(bn1(P0[b, n, c] + P1[b, up1[b, n], c] + P2[b, up2[b, n], c]
//                       + wcat[cat[b], c] + (c in the last head ? wxyz[:, c'] . xyz[b, n] : 0)
//                       + bias[c]))
//
// Replaces no TPU kernel.  The heads' first layer multiplies the 1286-d per-point
// feature [fm_0 | fm_1 | fm_2 | fm_3 | fm_4 | one-hot], whose fm_2..fm_4 reach the
// N points only through a 1-NN gather of the N/4- and N/16-point maps.  A product
// commutes with a row gather, so the serving route (models/heads.py::FirstLayers)
// multiplies each map at its own resolution, for the three heads at once: P0 =
// [fm_0|fm_1] W0 (B*N rows), P1 = [fm_2|fm_3] W1 (B*N/4), P2 = fm_4 W2 (B*N/16),
// each (rows, C = 3 * 1024) in fp32.  This kernel gathers and adds them per point,
// adds the one-hot's column of W, the translation head's xyz columns and the bias,
// and applies each head's eval BatchNorm and ReLU.  Plain version:
// hspose_tpu_torch/ops/heads_epilogue.py::heads_epilogue_plain.
//
// Arithmetic, in this order and rounded at every step (no contraction), as the plain
// version does it: s = (((P0 + P1) + P2) + wcat) [+ ((x wx + y wy) + z wz)], then
//   fp32:  y = (((s + bias) - mean) / den) * gamma + beta,  den = sqrt(var + eps);
//   bf16:  t = bf16(s + bias), y = bf16((t - mean) * scale + beta),
//          scale = rsqrt(var + eps) * gamma, bias the bf16 bias (as fp32):
// the product and its bias rounded to bf16 once, as F.linear on bf16 operands
// with a bf16 bias rounds them (cuBLAS's and the CPU's addmm add the bias to the
// fp32 sum), and the eval BatchNorm of models/face_recon.py::batch_norm rounded
// once.  ReLU keeps a NaN.  A category outside [0, obj_c) gives NaN rows (the
// plain version raises).
//
// What bounds it on an H100: bytes.  At B = 96, N = 1028 it reads P0 (1.21 GB) once
// and writes h (1.21 GB fp32, 0.61 GB bf16); P1 (0.30 GB) and P2 (0.08 GB) are read
// by about 4 and 16 rows each, from L2 if their crop's rows stay there; about 2.8 /
// 2.2 GB, 0.83 / 0.65 ms at 3.35 TB/s.
//
// Design: a block of 256 threads covers one head's 1024 columns (a float4 each) for
// 32 points of one crop; blocks run crop by crop (crop-major block index), so a
// crop's rows of P1 (3.2 MB fp32) and P2 (0.8 MB) are read from device memory once
// and then from L2.  The block stages its points' gather indices and xyz in shared
// memory, keeps its columns' constants in registers, and walks its points with the
// three loads of four rows in flight; P0 is read and h written with streaming
// (evict-first) hints so that they do not push P1 and P2 out of L2.  The head is
// uniform per block, so only the translation head's blocks do the xyz term.
// Each element of P0 is read by the thread that writes the same element of h, before
// it writes it, so in fp32 h may be P0 itself (p0 and out are not restrict).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 1024;           // one head's columns: a block's width
constexpr int kThreads = kCols / 4;   // a float4 of columns each
constexpr int kRows = 32;             // points of one crop a block walks

// rows of params (5, C): the bias, then the BatchNorm's mean, den (fp32) or scale
// (bf16), gamma (fp32; unused in bf16) and beta
enum { kBias = 0, kMean = 1, kDen = 2, kGamma = 3, kBeta = 4 };

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float relu(float y) { return y <= 0.f ? 0.f : y; }  // NaN stays

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
heads_epilogue_kernel(const float* p0, const float* __restrict__ p1,
                      const float* __restrict__ p2, const int* __restrict__ up1,
                      const int* __restrict__ up2, const void* __restrict__ cat, int cat64,
                      const void* __restrict__ xyz, const float* __restrict__ wcat,
                      const float* __restrict__ wxyz, const float* __restrict__ params,
                      void* out, int N, int N1, int N2, int C, int obj_c,
                      int groups) {
  const int heads = C / kCols;
  int blk = blockIdx.x;
  const int g = blk % groups;
  blk /= groups;
  const int head = blk % heads;
  const int b = blk / heads;
  const int n0 = g * kRows;
  const int rows = min(kRows, N - n0);
  const int cc = threadIdx.x * 4;  // this thread's first column within the head
  const int c = head * kCols + cc;
  const bool ts = head == heads - 1;

  __shared__ int s_up1[kRows], s_up2[kRows];
  __shared__ float s_xyz[kRows * 3];
  const size_t row0 = (size_t)b * N + n0;
  if (threadIdx.x < rows) {
    s_up1[threadIdx.x] = __ldg(up1 + row0 + threadIdx.x);
    s_up2[threadIdx.x] = __ldg(up2 + row0 + threadIdx.x);
  }
  if (ts && threadIdx.x < rows * 3) {
    const size_t i = row0 * 3 + threadIdx.x;
    s_xyz[threadIdx.x] = BF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(xyz)[i])
                              : static_cast<const float*>(xyz)[i];
  }

  const int k = cat64 ? (int)static_cast<const long long*>(cat)[b]
                      : static_cast<const int*>(cat)[b];
  const float nan = __int_as_float(0x7fc00000);
  const float4 wc = (k >= 0 && k < obj_c) ? ld4(wcat + (size_t)k * C + c)
                                          : make_float4(nan, nan, nan, nan);
  const float4 bias = ld4(params + kBias * C + c), mean = ld4(params + kMean * C + c);
  const float4 den = ld4(params + kDen * C + c), gamma = ld4(params + kGamma * C + c);
  const float4 beta = ld4(params + kBeta * C + c);
  float4 wx = make_float4(0.f, 0.f, 0.f, 0.f), wy = wx, wz = wx;
  if (ts) {
    wx = ld4(wxyz + cc);
    wy = ld4(wxyz + kCols + cc);
    wz = ld4(wxyz + 2 * kCols + cc);
  }
  __syncthreads();

  const float* q0 = p0 + row0 * C + c;
  const float* q1 = p1 + (size_t)b * N1 * C + c;
  const float* q2 = p2 + (size_t)b * N2 * C + c;
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(q0 + (size_t)r * C));
    const float4 u = ld4(q1 + (size_t)s_up1[r] * C);
    const float4 v = ld4(q2 + (size_t)s_up2[r] * C);
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = __fadd_rn(__fadd_rn(__fadd_rn(lane(a, j), lane(u, j)), lane(v, j)), lane(wc, j));
      if (ts) {
        const float x = __fadd_rn(__fadd_rn(__fmul_rn(s_xyz[r * 3], lane(wx, j)),
                                            __fmul_rn(s_xyz[r * 3 + 1], lane(wy, j))),
                                  __fmul_rn(s_xyz[r * 3 + 2], lane(wz, j)));
        s = __fadd_rn(s, x);
      }
      if (BF16) {
        const float t = bf16_round(__fadd_rn(s, lane(bias, j)));
        y[j] = relu(__fadd_rn(__fmul_rn(__fsub_rn(t, lane(mean, j)), lane(den, j)),
                              lane(beta, j)));
      } else {
        const float t = __fsub_rn(__fadd_rn(s, lane(bias, j)), lane(mean, j));
        y[j] = relu(__fadd_rn(__fmul_rn(__fdiv_rn(t, lane(den, j)), lane(gamma, j)),
                              lane(beta, j)));
      }
    }
    const size_t o = (row0 + r) * C + c;
    if (BF16) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
      uint2 w;
      w.x = *reinterpret_cast<unsigned*>(&lo);
      w.y = *reinterpret_cast<unsigned*>(&hi);
      __stcs(reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + o), w);
    } else {
      __stcs(reinterpret_cast<float4*>(static_cast<float*>(out) + o),
             make_float4(y[0], y[1], y[2], y[3]));
    }
  }
}

}  // namespace

// p0 (B, N, C), p1 (B, N1, C), p2 (B, N2, C) fp32; up1, up2 (B, N) int32 into the N1 and
// N2 rows; cat (B,) int32, or int64 with cat64; xyz (B, N, 3) fp32, or bf16 with fast;
// wcat (obj_c, C), wxyz (3, 1024) for the last 1024 columns, params (5, C) fp32 ->
// out (B, N, C) fp32, or bf16 with fast; out may be p0 and overlaps no other input.
// C a multiple of 1024; every tensor contiguous.
extern "C" int hs_heads_epilogue(const float* p0, const float* p1, const float* p2,
                                 const int* up1, const int* up2, const void* cat, int cat64,
                                 const void* xyz, const float* wcat, const float* wxyz,
                                 const float* params, void* out, int B, int N, int N1, int N2,
                                 int C, int obj_c, int fast, void* stream) {
  if (B < 1 || N < 1 || N1 < 1 || N2 < 1 || C < kCols || C % kCols) {
    return (int)cudaErrorInvalidValue;
  }
  const int groups = (N + kRows - 1) / kRows;
  const long long blocks = (long long)B * (C / kCols) * groups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fast) {
    heads_epilogue_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        p0, p1, p2, up1, up2, cat, cat64, xyz, wcat, wxyz, params, out, N, N1, N2, C, obj_c,
        groups);
  } else {
    heads_epilogue_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        p0, p1, p2, up1, up2, cat, cat64, xyz, wcat, wxyz, params, out, N, N1, N2, C, obj_c,
        groups);
  }
  return (int)cudaGetLastError();
}
