// Shared parts of the fused LSTM kernels (lstm_fwd.cu, lstm_bwd.cu).
//
// Both kernels run a whole recurrence in ONE cooperative launch. The grid
// is (unit slices) x (row tiles): block (s, r) owns hidden units
// [s*U, s*U + U), the four gate columns of each (u, H+u, 2H+u, 3H+u), and
// batch rows [r*RB, r*RB + RB). It keeps its slice of Wh in shared memory
// for the whole sequence (so Wh is read from device memory once per row
// tile) and the f32 carry of its rows and units in shared memory. Per tick
// the blocks trade what every block needs (h in the forward, dz in the
// backward) through a ping-pong exchange buffer in device memory, which
// stays in L2 (read with ld.global.cg, past the SM's L1), and meet at a
// grid-wide barrier (cooperative_groups::this_grid().sync()). A block
// reads only its own rows of the exchange, so the row split cuts the L2
// traffic per tick by the number of row tiles. One barrier per tick is
// enough: a block writes slot t&1 only after every block has passed the
// barrier of tick t-1, by which point all reads of that slot from tick
// t-2 are done.
//
// The plan (U, row tiles) depends only on (N, H) and the SM count: U is
// the widest power of two whose Wh slice fits a shared-memory budget, and
// the row tiles are as many as fill the SMs with one block each. The
// occupancy API then checks that every block can be resident; a shape
// that cannot be made resident returns cudaErrorCooperativeLaunchTooLarge
// (the wrapper raises). No float atomics: every sum runs in a fixed
// order, so two calls give the same bits.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dl4j {
namespace lstm {

constexpr int kThreads = 256;
constexpr size_t kTileBytes = 48 * 1024;   // the forward's staging tile

__device__ __forceinline__ float load(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// v rounded to T and back (round to nearest even, as torch's .to())
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One value, or four consecutive values, of a row as f32: through L2
// only (kCg: the exchange, which other blocks rewrite every tick; the
// SM's L1 is not coherent across SMs) or the read-only path (inputs).
template <bool kCg>
__device__ __forceinline__ float load1(const float* p) {
  return kCg ? __ldcg(p) : __ldg(p);
}
template <bool kCg>
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <bool kCg>
__device__ __forceinline__ float4 load4(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return kCg ? __ldcg(q) : __ldg(q);
}
template <bool kCg>
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2* q = reinterpret_cast<const uint2*>(p);
  const uint2 u = kCg ? __ldcg(q) : __ldg(q);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Copies rows x cols values of `src` (row stride src_ld) into shared `dst`
// (row stride dst_ld) as f32. Such a copy is bound by the latency of L2,
// not its bandwidth, unless many bytes are in flight: each thread issues
// kStage loads before it stores any, of four values at once where the
// rows allow 16-byte (f32) or 8-byte (bf16) loads.
constexpr int kStage = 8;
template <bool kCg, typename T>
__device__ __forceinline__ void stage(float* dst, int dst_ld, const T* src,
                                      size_t src_ld, int rows, int cols) {
  const int nth = blockDim.x;
  const bool vec = cols % 4 == 0 && src_ld % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % (4 * sizeof(T)) == 0;
  if (vec) {
    const int c4 = cols / 4, total = rows * c4;
    for (int base = threadIdx.x; base < total; base += nth * kStage) {
      float4 v[kStage];
#pragma unroll
      for (int b = 0; b < kStage; ++b) {
        const int o = base + b * nth;
        if (o < total)
          v[b] = load4<kCg>(src + (o / c4) * src_ld + 4 * (o % c4));
      }
#pragma unroll
      for (int b = 0; b < kStage; ++b) {
        const int o = base + b * nth;
        if (o < total) {
          float* d = dst + (o / c4) * dst_ld + 4 * (o % c4);
          d[0] = v[b].x;
          d[1] = v[b].y;
          d[2] = v[b].z;
          d[3] = v[b].w;
        }
      }
    }
    return;
  }
  const int total = rows * cols;
  for (int base = threadIdx.x; base < total; base += nth * kStage) {
    float v[kStage];
#pragma unroll
    for (int b = 0; b < kStage; ++b) {
      const int o = base + b * nth;
      if (o < total) v[b] = load1<kCg>(src + (o / cols) * src_ld + o % cols);
    }
#pragma unroll
    for (int b = 0; b < kStage; ++b) {
      const int o = base + b * nth;
      if (o < total) dst[(o / cols) * dst_ld + o % cols] = v[b];
    }
  }
}

// C[m][n] += sum over k < K of A[m * am + k * ak] * B[k * bk + n * bn]
// (C at c[m * cm + n]) for an M x N block product in shared memory. Each
// thread sums a TM x TN tile of C in registers, so one read of A serves TN
// products and one of B serves TM; every output is one f32 chain in k
// order, whatever TM and TN. A thread's rows are contiguous and its
// columns strided by N / TN, so a warp reads neighbouring columns of B.
template <int TM, int TN>
__device__ __forceinline__ void product_tiles(const float* a, int am, int ak,
                                              const float* b, int bk, int bn,
                                              float* c, int cm, int M, int N,
                                              int K) {
  const int tiles_m = (M + TM - 1) / TM, tiles_n = (N + TN - 1) / TN;
  for (int idx = threadIdx.x; idx < tiles_m * tiles_n; idx += blockDim.x) {
    const int mt = idx / tiles_n, nt = idx % tiles_n;
    int m[TM], n[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) m[i] = min(mt * TM + i, M - 1);
#pragma unroll
    for (int j = 0; j < TN; ++j) n[j] = min(nt + j * tiles_n, N - 1);
    float acc[TM][TN] = {};
    for (int k = 0; k < K; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a[m[i] * am + k * ak];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = b[k * bk + n[j] * bn];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += av[i] * bv[j];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (mt * TM + i < M && nt + j * tiles_n < N)
          c[m[i] * cm + n[j]] += acc[i][j];
  }
}

// product_tiles with the widest tile that still gives every thread work.
__device__ __forceinline__ void product(const float* a, int am, int ak,
                                        const float* b, int bk, int bn,
                                        float* c, int cm, int M, int N,
                                        int K) {
  const int outs = M * N, nth = blockDim.x;
  if (outs >= 16 * nth && M >= 4 && N >= 4)
    product_tiles<4, 4>(a, am, ak, b, bk, bn, c, cm, M, N, K);
  else if (outs >= 4 * nth && M >= 2 && N >= 2)
    product_tiles<2, 2>(a, am, ak, b, bk, bn, c, cm, M, N, K);
  else
    product_tiles<1, 1>(a, am, ak, b, bk, bn, c, cm, M, N, K);
}

struct Plan {
  int U;       // hidden units per block
  int slices;  // ceil(H / U): grid x
  int RB;      // batch rows per block
  int RT;      // ceil(N / RB): grid y
};

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// U: the widest power of two (at most H) whose H x 4U f32 slice of Wh
// fits `w_budget` bytes; row tiles: as many as give every SM one block.
inline Plan make_plan(int n, int h, size_t w_budget) {
  Plan p;
  p.U = 1;
  while (2 * p.U <= h &&
         static_cast<size_t>(h) * 4 * (2 * p.U) * sizeof(float) <= w_budget)
    p.U *= 2;
  p.slices = (h + p.U - 1) / p.U;
  int rt = sm_count() / p.slices;
  rt = rt < 1 ? 1 : (rt > n ? n : rt);
  p.RB = (n + rt - 1) / rt;
  p.RT = (n + p.RB - 1) / p.RB;
  return p;
}

// The cooperative launch of `kernel(params)` over plan.slices x plan.RT
// blocks with `smem` bytes of dynamic shared memory each, after checking
// that every block can be resident.
template <typename Params>
cudaError_t launch_cooperative(void (*kernel)(Params), const Plan& plan,
                               size_t smem, Params params,
                               cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > static_cast<size_t>(optin))
    return cudaErrorCooperativeLaunchTooLarge;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (plan.slices * plan.RT > per_sm * sm_count())
    return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&params};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(plan.slices, plan.RT),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace lstm
}  // namespace dl4j
