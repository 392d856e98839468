// Shared parts of the fused LSTM kernels (lstm_fwd.cu, lstm_bwd.cu).
//
// Both kernels run a whole recurrence in ONE launch. The grid is (unit
// slices) x (row tiles): block (s, r) owns hidden units [s*U, s*U + U),
// the four gate columns of each (u, H+u, 2H+u, 3H+u), and batch rows
// [r*RB, r*RB + RB). It keeps its slice of Wh in shared memory for the
// whole sequence (so Wh is read from device memory once per row tile) and
// the f32 carry of its rows and units on chip. Per tick the blocks trade
// what every block needs (h in the forward, dh partials in the backward).
// lstm_bwd, and the forward's grid route, trade it through a ping-pong
// exchange buffer in device memory, which stays in L2 (read past the SM's
// L1), and meet at a grid-wide barrier (cooperative_groups::this_grid()
// .sync()) in a cooperative launch; one barrier per tick is enough, as a
// block writes slot t&1 only after every block has passed the barrier of
// tick t-1, by which point all reads of that slot from tick t-2 are done.
// The forward's cluster route trades h inside a thread-block cluster
// instead (lstm_fwd.cu).
//
// The plans are computed in Python (ops/fused_lstm.py: lstm_fwd_plan,
// lstm_bwd_plan) from the shapes and the SM count alone; the kernels check
// and follow them. launch_cooperative checks that every block of a grid
// route can be resident and returns cudaErrorCooperativeLaunchTooLarge
// where it cannot (the wrapper raises). No float atomics: every sum runs
// in a fixed order, so two calls give the same bits.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dl4j {
namespace lstm {

constexpr int kThreads = 256;
// loads a thread keeps in flight when it copies a slice of Wh (the copy
// is bound by the latency of L2, not its bandwidth)
constexpr int kStage = 8;

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
