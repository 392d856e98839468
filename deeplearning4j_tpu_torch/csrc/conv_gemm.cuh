// Fused conv + BatchNorm-statistics GEMM for Hopper (sm_90a), the f32 path
// of fused_mm.cu (1x1 conv) and fused_c3.cu (3x3 SAME conv); their bf16
// path is mm_fwd.cuh's and c3_fwd.cuh's tensor-core kernel.
//
// Replaces the TPU kernels deeplearning4j_tpu/ops/fused_conv.py:_mm_kernel
// and :_c3_kernel. Both compute, per output pixel row m and channel n,
//
//   e = relu?(x * scale + shift) rounded to the input dtype   (prologue)
//   y[m, n] = sum_k e[m, k] * W[k, n]   in f32, stored in the input dtype
//   partial[tile_m, 0, n] = sum over the tile's rows of y (f32 accumulator)
//   partial[tile_m, 1, n] = sum of y^2                          (epilogue)
//
// The 1x1 conv reads row m of the (optionally strided) input directly:
// the stride is folded into the addressing, so the subsampled input is
// never materialized. The 3x3 conv is an implicit GEMM over K = 9 * Cin
// (tap-major, HWIO weights), the zero border applied AFTER the
// normalize/ReLU, as the TPU kernel pads the normalized plane.
//
// What bounds it on this card: at the served ResNet50's shapes (64x64
// input, batch 32: M = 128..8192 rows, K = 64..4608) the arithmetic is
// bound by operations on paper (K >= 64 products per loaded element), but
// the deep stage-2/3 layers have few rows: a 64x64 output tiling gives
// them 16-32 blocks on 132 SMs, each walking K alone, which leaves most
// of the card idle. So K is split into slices of at most kSplitDepth
// (gridDim.z), each slice's f32 sums go to a workspace and a second
// kernel adds the slices in order and runs the epilogue. Every normalized
// input stays in shared memory and is never written to device memory;
// y is written once; the BN statistics ride the epilogue, so no pass
// re-reads y. It computes with FMA on 64x64 tiles (16x16 threads, 4x4
// outputs each) in f32, no TF32.
//
// Determinism: the number of slices depends on K alone, and each slice is
// one sequential f32 sum, so a row's result does not depend on M or on
// the tile it lands in (padded or split serving batches agree bitwise
// with a direct call). The statistics are reduced in a fixed order inside
// the tile and across tiles by the caller (a sum over the partial
// buffer): no float atomics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dl4j {

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 16;
constexpr int kThreads = 256;
constexpr int kPadM = kTileM + 4;  // staggers the transposed A stores
// deepest K slice one block walks; the split count is ceil(K / this)
constexpr int kSplitDepth = 36 * kTileK;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// x * s + b without FMA contraction (the reference rounds the product),
// ReLU, then rounding to the input dtype before the product.
template <typename T>
__device__ __forceinline__ float prologue(T v, float s, float b, int norm_in,
                                          int relu_in) {
  float x = to_f32<T>(v);
  if (!norm_in) return x;
  float e = __fadd_rn(__fmul_rn(x, s), b);
  if (relu_in) e = fmaxf(e, 0.0f);
  return to_f32<T>(from_f32<T>(e));
}

struct ConvGeom {
  int M;       // output rows (N * Ho * Wo)
  int K;       // Cin (1x1) or 9 * Cin (3x3)
  int N;       // Cout
  int H, W;    // input plane
  int Ho, Wo;  // output plane
  int stride;  // 1x1 only
  int cin;
  int norm_in, relu_in;
  int want_stats;   // write the per-tile partial statistics
  int splits;       // K slices (gridDim.z); > 1 needs the workspace
  int k_per_split;  // a multiple of kTileK
};

// kC3 = false: 1x1 conv (strided rows); true: 3x3 SAME stride-1 conv.
template <bool kC3>
__global__ void __launch_bounds__(kThreads)
    conv_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, float* __restrict__ y,
                     float* __restrict__ partial, float* __restrict__ ws,
                     ConvGeom g) {
  __shared__ __align__(16) float As[kTileK][kPadM];
  __shared__ __align__(16) float Bs[kTileK][kTileN];
  __shared__ float red_s[kThreads / 16][kTileN];
  __shared__ float red_q[kThreads / 16][kTileN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // output columns tx*4 .. tx*4+3
  const int ty = tid >> 4;  // output rows    ty*4 .. ty*4+3
  const int n0 = blockIdx.x * kTileN;
  const int m0 = blockIdx.y * kTileM;
  // this block's K slice (the whole of K unless split)
  const int kb = blockIdx.z * g.k_per_split;
  const int ke = min(g.K, kb + g.k_per_split);

  // A loads: this thread fills column a_k of the tile for rows
  // a_r + 16 * i, i = 0..3; its row geometry is fixed over the K loop.
  const int a_k = tid & 15;
  const int a_r = tid >> 4;
  long long a_base[4];  // 1x1: element offset of the input row; -1 = none
  int a_n[4], a_h[4], a_w[4];  // 3x3: image and output pixel; a_n < 0 = none
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + a_r + 16 * i;
    a_base[i] = -1;
    a_n[i] = -1;
    a_h[i] = 0;
    a_w[i] = 0;
    if (m < g.M) {
      const int plane = g.Ho * g.Wo;
      const int n = m / plane;
      const int r = m - n * plane;
      const int ho = r / g.Wo;
      const int wo = r - ho * g.Wo;
      if (kC3) {
        a_n[i] = n;
        a_h[i] = ho;
        a_w[i] = wo;
      } else {
        a_base[i] = ((long long)n * g.H * g.W +
                     (long long)ho * g.stride * g.W +
                     (long long)wo * g.stride) * g.cin;
      }
    }
  }
  // B loads: column b_c of the tile, rows b_k + 4 * i
  const int b_c = tid & 63;
  const int b_k = tid >> 6;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = kb; k0 < ke; k0 += kTileK) {
    const int k = k0 + a_k;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = 0.0f;
      if (k < ke) {
        if (kC3) {
          if (a_n[i] >= 0) {
            const int tap = k / g.cin;
            const int c = k - tap * g.cin;
            const int hi = a_h[i] + tap / 3 - 1;
            const int wi = a_w[i] + tap % 3 - 1;
            if (hi >= 0 && hi < g.H && wi >= 0 && wi < g.W) {
              const long long off =
                  (((long long)a_n[i] * g.H + hi) * g.W + wi) * g.cin + c;
              v = prologue<float>(x[off], scale[c], shift[c], g.norm_in,
                              g.relu_in);
            }
          }
        } else if (a_base[i] >= 0) {
          v = prologue<float>(x[a_base[i] + k], scale[k], shift[k], g.norm_in,
                          g.relu_in);
        }
      }
      As[a_k][a_r + 16 * i] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = b_k + 4 * i;
      const int n = n0 + b_c;
      float v = 0.0f;
      if (k0 + kk < ke && n < g.N)
        v = w[(long long)(k0 + kk) * g.N + n];
      Bs[kk][b_c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (g.splits > 1) {
    // split K: this slice's f32 sums go to the workspace; the reduction
    // kernel adds the slices in order and runs the epilogue
    float* out = ws + (long long)blockIdx.z * g.M * g.N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m >= g.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < g.N) out[(long long)m * g.N + n] = acc[i][j];
      }
    }
    return;
  }

  // epilogue: y in the input dtype, per-tile column sums of the f32
  // accumulator over the valid rows only
  float cs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float cq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < g.N) y[(long long)m * g.N + n] = acc[i][j];
      cs[j] += acc[i][j];
      cq[j] += acc[i][j] * acc[i][j];
    }
  }
  if (!g.want_stats) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red_s[ty][tx * 4 + j] = cs[j];
    red_q[ty][tx * 4 + j] = cq[j];
  }
  __syncthreads();
  if (tid < kTileN && n0 + tid < g.N) {
    float s = 0.0f, q = 0.0f;
#pragma unroll
    for (int t = 0; t < kThreads / 16; ++t) {
      s += red_s[t][tid];
      q += red_q[t][tid];
    }
    float* p = partial + (long long)blockIdx.y * 2 * g.N;
    p[n0 + tid] = s;
    p[g.N + n0 + tid] = q;
  }
}

// Split-K epilogue: y[m, n] = sum over the K slices in slice order, then
// the same per-tile statistics as the single-pass epilogue. Thread t
// handles column t & 63 for rows (t >> 6) + 4 i of the 64-row tile.
__global__ void __launch_bounds__(kThreads)
    splitk_reduce_kernel(const float* __restrict__ ws, float* __restrict__ y,
                         float* __restrict__ partial, ConvGeom g) {
  __shared__ float red_s[kThreads / kTileN][kTileN];
  __shared__ float red_q[kThreads / kTileN][kTileN];
  const int tid = threadIdx.x;
  const int c = tid & (kTileN - 1);
  const int r0 = tid / kTileN;
  const int n = blockIdx.x * kTileN + c;
  const int m0 = blockIdx.y * kTileM;
  const long long slice = (long long)g.M * g.N;
  float cs = 0.0f, cq = 0.0f;
  if (n < g.N) {
    for (int r = r0; r < kTileM; r += kThreads / kTileN) {
      const int m = m0 + r;
      if (m >= g.M) break;
      const long long off = (long long)m * g.N + n;
      float v = 0.0f;
      for (int s = 0; s < g.splits; ++s) v += ws[s * slice + off];
      y[off] = v;
      cs += v;
      cq += v * v;
    }
  }
  if (!g.want_stats) return;
  red_s[r0][c] = cs;
  red_q[r0][c] = cq;
  __syncthreads();
  if (tid < kTileN && n < g.N) {
    float s = 0.0f, q = 0.0f;
#pragma unroll
    for (int t = 0; t < kThreads / kTileN; ++t) {
      s += red_s[t][tid];
      q += red_q[t][tid];
    }
    float* p = partial + (long long)blockIdx.y * 2 * g.N;
    p[n] = s;
    p[g.N + n] = q;
  }
}

// K slices for a reduction depth of k (a function of K alone, see above)
inline int split_count(int k) { return (k + kSplitDepth - 1) / kSplitDepth; }

inline void set_split(ConvGeom& g) {
  g.splits = split_count(g.K);
  const int per = (g.K + g.splits - 1) / g.splits;
  g.k_per_split = (per + kTileK - 1) / kTileK * kTileK;
}

template <bool kC3>
inline int launch_conv_gemm(const void* x, const void* w, const float* scale,
                            const float* shift, void* y, float* partial,
                            float* ws, const ConvGeom& g,
                            cudaStream_t stream) {
  if ((g.M + kTileM - 1) / kTileM > 65535 || g.splits < 1 ||
      g.splits > 65535 || (g.splits > 1 && ws == nullptr) ||
      g.k_per_split % kTileK != 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((g.N + kTileN - 1) / kTileN, (g.M + kTileM - 1) / kTileM,
                  g.splits);
  conv_gemm_kernel<kC3><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), scale,
      shift, static_cast<float*>(y), partial, ws, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g.splits == 1) return static_cast<int>(err);
  const dim3 rgrid(grid.x, grid.y);
  splitk_reduce_kernel<<<rgrid, kThreads, 0, stream>>>(
      ws, static_cast<float*>(y), partial, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dl4j
