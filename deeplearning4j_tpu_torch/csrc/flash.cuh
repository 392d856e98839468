// Shared parts of the flash attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layout. q, k, v and dO are (N, T, H, Dh) views read through the strides
// the wrapper passes (the last dimension contiguous), so the three views
// SelfAttentionLayer cuts from its packed head-major projection are read
// in place, with no transpose or padding copy. Outputs (out, dq, dk, dv)
// are contiguous (N, T, H, Dh) in the inputs' dtype; lse and delta are
// (N, H, T) f32; the key mask is (N, Tk) f32, a key valid where it is > 0,
// or null (every key valid).
//
// Tiles. A block owns one 64-row tile of queries (forward, dq) or keys
// (dk/dv) of one (batch row, head) and loops over the other side's 64-row
// tiles, which replaces the TPU kernels' sequential grid dimension. The
// bf16 forward keeps its tiles in bf16 for the tensor cores (its layout is
// described in flash_fwd.cu). In the f32 forward and the backward a block
// has 256 threads and tiles are staged in shared memory as f32, row stride
// DMAX + 1 (DMAX = Dh rounded up to 32, 64 or 128; the columns past Dh
// and the rows past T are zero), so a warp reads one column of 16 rows or
// 16 columns of one row without a bank conflict. Thread (ty, tx) = (t/16,
// t%16) owns rows ty + 16i and columns tx + 16j of every 64 x 64 product
// and rows ty + 16i, columns tx + 16j of its f32 accumulator. Every sum
// runs in a fixed order (products over Dh in column order, over a tile in
// row order, tiles in order) and no float atomics are used, so a second
// call gives the same bits.
//
// Masking follows the TPU kernels (deeplearning4j_tpu/ops/
// pallas_kernels.py:40-98, 180-277): a masked key, a key past the ragged
// edge and (causal) a key after the query get the score kNeg, a large
// finite value; a row that never saw a valid key gives out = 0 and
// lse = kNeg, and the backward zeroes p where lse <= kNeg / 2.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace dl4j {
namespace flash {

constexpr int kB = 64;             // rows of a query or key tile
constexpr int kThreads = 256;
constexpr int kR = kB / 16;        // rows a thread owns in a tile
constexpr float kNeg = -0.5f * FLT_MAX;   // float32 min / 2
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;   // (N, Tk) or null
  const void* dout;    // backward only
  const float* lse;    // (N, H, Tq): forward output, backward input
  const float* delta;  // (N, H, Tq), backward only
  void* out;           // forward: out; dq kernel: dq; dkv kernel: dk
  void* out2;          // dkv kernel: dv
  float* lse_out;      // forward only
  int n, tq, tk, h, dh, causal;
  long long qs[3], ks[3], vs[3], ds[3];   // (n, t, h) strides, elements
  float scale;
  int vec;   // forward, bf16: q, k, v bases and strides allow 16-byte loads
};

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
  p[i] = __float2bfloat16(v);   // round to nearest even, as torch's .to()
}

// rows [row0, row0 + kB) of batch row b, head hh of a strided (N, T, H, Dh)
// tensor into dst (kB x (DMAX + 1) f32), zero past T and past Dh
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          const long long* s, int b, int hh,
                                          int row0, int t_len, int dh) {
  const size_t base = static_cast<size_t>(b) * s[0] +
                      static_cast<size_t>(hh) * s[2];
  for (int idx = threadIdx.x; idx < kB * DMAX; idx += kThreads) {
    const int r = idx / DMAX, d = idx % DMAX, t = row0 + r;
    float v = 0.0f;
    if (t < t_len && d < dh)
      v = load(src, base + static_cast<size_t>(t) * s[1] + d);
    dst[r * (DMAX + 1) + d] = v;
  }
}

// 1 where key k0 + c is inside Tk and valid in the mask, else 0
__device__ __forceinline__ void load_key_valid(float* kval, const Params& p,
                                               int b, int k0) {
  for (int c = threadIdx.x; c < kB; c += kThreads) {
    const int t = k0 + c;
    bool ok = t < p.tk;
    if (ok && p.mask != nullptr)
      ok = p.mask[static_cast<size_t>(b) * p.tk + t] > 0.0f;
    kval[c] = ok ? 1.0f : 0.0f;
  }
}

// s[i][j] = sum over d of A[ty + 16i][d] * B[tx + 16j][d], d in order
template <int DMAX>
__device__ __forceinline__ void tile_dot(float (&s)[kR][kR], const float* A,
                                         const float* B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j) s[i][j] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < DMAX; ++d) {
    float a[kR], bv[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) a[i] = A[(ty + 16 * i) * (DMAX + 1) + d];
#pragma unroll
    for (int j = 0; j < kR; ++j) bv[j] = B[(tx + 16 * j) * (DMAX + 1) + d];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) s[i][j] = fmaf(a[i], bv[j], s[i][j]);
  }
}

// the score of (query row qi, key column c of the tile at k0): scaled, or
// kNeg where the key is invalid or (causal) after the query
__device__ __forceinline__ float masked_score(float s, const Params& p,
                                              const float* kval, int c,
                                              int k0, int qi) {
  const bool ok = kval[c] > 0.0f && (!p.causal || k0 + c <= qi);
  return ok ? s * p.scale : kNeg;
}

// acc[i][jj] += sum over r of W[r][ty + 16i] * X[r][tx + 16jj], r in order
// (W is kB x (kB + 1), X is kB x (DMAX + 1)): the transposed products of
// the dk/dv pass
template <int DMAX>
__device__ __forceinline__ void acc_tn(float (&acc)[kR][DMAX / 16],
                                       const float* W, const float* X,
                                       int ty, int tx) {
#pragma unroll 4
  for (int r = 0; r < kB; ++r) {
    float w[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) w[i] = W[r * (kB + 1) + ty + 16 * i];
#pragma unroll
    for (int jj = 0; jj < DMAX / 16; ++jj) {
      const float x = X[r * (DMAX + 1) + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < kR; ++i) acc[i][jj] = fmaf(w[i], x, acc[i][jj]);
    }
  }
}

// acc[i][jj] += sum over k of W[ty + 16i][k] * X[k][tx + 16jj], k in order:
// P·V in the forward, dS·K in the dq pass
template <int DMAX>
__device__ __forceinline__ void acc_nn(float (&acc)[kR][DMAX / 16],
                                       const float* W, const float* X,
                                       int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kB; ++k) {
    float w[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) w[i] = W[(ty + 16 * i) * (kB + 1) + k];
#pragma unroll
    for (int jj = 0; jj < DMAX / 16; ++jj) {
      const float x = X[k * (DMAX + 1) + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < kR; ++i) acc[i][jj] = fmaf(w[i], x, acc[i][jj]);
    }
  }
}

// the dynamic shared memory a kernel needs above 48 KB, granted once per
// instantiation
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline float softmax_scale(int dh) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
}

}  // namespace flash
}  // namespace dl4j
