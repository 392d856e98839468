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
// tiles, which replaces the TPU kernels' sequential grid dimension.
//
// bf16 (flash_fwd.cu's fwd_mma_kernel, flash_bwd.cu's dkv_mma_kernel and
// dq_mma_kernel): 4 warps, each owning 16 of the block's rows, multiply on
// mma.sync m16n8k16 (mma.cuh). Tiles stay bf16 in shared memory, rows
// padded to DMAX + 8 elements (DMAX = Dh rounded up to 32, 64 or 128) so
// ldmatrix has no bank conflicts, staged by stage_bf16; a probability (or
// its gradient) that multiplies a tile keeps f32 accuracy as two bf16
// halves (split_p).
//
// f32 (fwd_kernel, dkv_kernel, dq_kernel): a block has 256 threads and
// tiles are staged in shared memory as f32, row stride DMAX + 1 (the
// columns past Dh and the rows past T are zero), so a warp reads one
// column of 16 rows or 16 columns of one row without a bank conflict.
// Thread (ty, tx) = (t/16, t%16) owns rows ty + 16i and columns tx + 16j
// of every 64 x 64 product and rows ty + 16i, columns tx + 16j of its f32
// accumulator.
//
// Both: every sum runs in a fixed order (products over Dh in column order,
// over a tile in row order, tiles in order) and no float atomics are used,
// so a second call gives the same bits.
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

#include "mma.cuh"

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
  int vec;   // bf16: q, k, v (and dO) bases and strides allow 16-byte loads
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

// ---- bf16: tensor-core helpers --------------------------------------------

constexpr int kMmaThreads = 128;   // 4 warps x 16 rows

template <int DMAX>
__host__ __device__ constexpr int mma_row() {   // staged row stride, bf16
  return DMAX + 8;
}

// blocks an SM keeps resident: caps the registers so the staging of some
// blocks hides behind the products of others (3 blocks of 128 threads at
// DMAX 64)
template <int DMAX>
__host__ __device__ constexpr int mma_min_blocks() {
  return DMAX <= 64 ? 3 : 2;
}

// rows [row0, row0 + kB) of batch row b, head hh of a strided bf16
// (N, T, H, Dh) view into dst (kB x mma_row bf16), zero past T and Dh:
// 16-byte cp.async when vec (Dh % 8 == 0, aligned bases and strides; the
// caller commits and waits), else 2-byte loads and stores
template <int DMAX>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           const long long* s, int b, int hh,
                                           int row0, int t_len, int dh,
                                           bool vec) {
  const size_t base = static_cast<size_t>(b) * s[0] +
                      static_cast<size_t>(hh) * s[2];
  if (vec) {
    constexpr int kChunks = DMAX / 8;
    for (int i = threadIdx.x; i < kB * kChunks; i += kMmaThreads) {
      const int r = i / kChunks, d = (i % kChunks) * 8, t = row0 + r;
      const bool ok = t < t_len && d < dh;
      const __nv_bfloat16* g =
          ok ? src + base + static_cast<size_t>(t) * s[1] + d : src;
      mma::cp_async16(dst + r * mma_row<DMAX>() + d, g, ok);
    }
    return;
  }
  for (int i = threadIdx.x; i < kB * DMAX; i += kMmaThreads) {
    const int r = i / DMAX, d = i % DMAX, t = row0 + r;
    __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
    if (t < t_len && d < dh) v = src[base + static_cast<size_t>(t) * s[1] + d];
    dst[r * mma_row<DMAX>() + d] = v;
  }
}

// p's hi and lo bf16 pairs of one A register (two neighbouring columns):
// hi = bf16(p), lo = bf16(p - hi), so hi·B + lo·B keeps p's f32 accuracy
__device__ __forceinline__ void split_p(float p0, float p1, unsigned& hi,
                                        unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = mma::pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
}

// B fragments of k-step ks against rows [n0, n0 + 16) of a staged tile
// taken as columns (the tile transposed: K in S = Q K^T): b[0], b[1] for
// rows n0..n0+7, b[2], b[3] for rows n0+8..n0+15
template <int DMAX>
__device__ __forceinline__ void ldsm_b_rows(unsigned (&b)[4],
                                            const __nv_bfloat16* tile,
                                            int n0, int ks, int lane) {
  mma::ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) *
                             mma_row<DMAX>() +
                         16 * ks + ((lane >> 3) & 1) * 8);
}

// B fragments of the k-step over rows [k0, k0 + 16) of a staged tile
// taken as it is (V in P V), columns [16 dp, 16 dp + 16): b[0], b[1] for
// columns 16 dp..+7, b[2], b[3] for 16 dp + 8..+15
template <int DMAX>
__device__ __forceinline__ void ldsm_b_cols(unsigned (&b)[4],
                                            const __nv_bfloat16* tile,
                                            int k0, int dp, int lane) {
  mma::ldsm_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   mma_row<DMAX>() +
                               16 * dp + (lane >> 4) * 8);
}

// one f32 accumulator row pair of a warp (C fragments of DMAX / 8 column
// tiles; element 2 r + e of tile j is row r, column 8 j + 2 t4 + e) into
// row `row` (element offset) of a contiguous bf16 output, columns past dh
// left out
template <int DMAX>
__device__ __forceinline__ void store_row_bf16(__nv_bfloat16* out,
                                               size_t row,
                                               const float (&acc)[DMAX / 8][4],
                                               int r, int t4, int dh) {
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    const float v0 = acc[j][2 * r], v1 = acc[j][2 * r + 1];
    if (c + 1 < dh && (dh & 1) == 0) {   // both, 4-byte aligned
      *reinterpret_cast<unsigned*>(out + row + c) = mma::pack_bf16(v0, v1);
    } else {
      if (c < dh) store(out, row + c, v0);
      if (c + 1 < dh) store(out, row + c + 1, v1);
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
