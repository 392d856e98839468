// fused_mm in bf16 on Hopper's tensor cores (sm_90a): the 1x1 conv + BatchNorm
// statistics. Replaces, for bf16 inputs, the TPU kernel
// deeplearning4j_tpu/ops/fused_conv.py:_mm_kernel (f32 keeps conv_gemm.cuh's
// FMA tile). Per output pixel m = (n, ho, wo) and channel c:
//
//   e = relu?(x[n, ho s, wo s, :] * scale + shift) rounded to bf16 (prologue)
//   y[m, c] = sum over k < Cin of e[k] W[k, c] in f32, stored as bf16
//   partial[tile, 0, c] = sum over the tile's rows of y (f32 accumulator),
//   partial[tile, 1, c] = sum of y^2                              (epilogue)
//
// What bounds it on this card. 2 M Cin Cout FLOP against the M strided rows
// of x, W and y moved once: at the ResNet50's sixteen 1x1 shapes (batch 32,
// M 128-8192, Cin and Cout 64-2048) 17-270 MFLOP against 0.2-4.5 MB, so
// bytes bound every call (0.1-1.4 us). The FMA version (conv_gemm.cuh) ran
// 40x above that: f32 FMA on 64 x 64 x 16 tiles, a scalar 2-byte load and
// two global scale/shift loads per A element into a transposed f32 tile,
// two barriers a step with nothing in flight, and above K = 576 an f32
// workspace allocated per call and a second launch to add it.
// What this design does about it: it is c3_fwd.cuh's kernel with one tap.
//   * products: mma.sync m16n8k16 (bf16 x bf16, f32 sums) on 64 x 64 output
//     tiles in 32-deep steps, 4 warps of 32 x 32;
//   * A (MmStream below): each row's input pixel (n, ho s, wo s) is decoded
//     once per block; x comes 8 channels (16 bytes) at a time, the prologue
//     runs in registers (no contraction), and the next step's loads are in
//     flight over the current step's products;
//   * B (W, each K row contiguous in Cout): 16-byte cp.async into a 4-stage
//     ring, read by ldmatrix.trans;
//   * split-K: K = Cin is cut into the slices of ops/fused_conv.py:mm_slices,
//     a function of K alone (at most 8, about MM_SLICE_DEPTH deep), so a
//     row's bits do not depend on M (a padded serving batch agrees bitwise
//     with a direct call). The slices of a tile run as one thread-block
//     cluster and are added in slice order through distributed shared
//     memory: one launch, no f32 workspace;
//   * statistics (only when asked) from the f32 sums over valid rows in one
//     fixed order; no float atomics;
//   * 2-byte staging where Cin % 8, Cout % 8 or a pointer's alignment rules
//     out 16-byte copies: the same kernel, selected by a flag.
#pragma once

#include "c3_fwd.cuh"

namespace dl4j {
namespace mm_fwd {

using c3::FwdArgs;
using c3::kARow;
using c3::kDepth;

// This thread's share of the A side of every step: depths k .. k + 7 (k =
// step start + 8 (tid % 4)) of output pixels (tid / 4) + 32 s, s = 0, 1.
struct MmStream {
  long long row[2];    // element offset of the rows' input pixels, -1 past M
  int k;               // the next step's depth (input channel)
  int at;              // shared offset of row s = 0 (s = 1: + 32 rows)
  unsigned ok;         // bit s: chunk s was loaded
  uint4 v[2];          // the loaded chunks (16-byte path)
  float sc[8], sh[8];  // their scale and shift

  __device__ MmStream(const FwdArgs& a, int m0, int kb) {
    const int kc = threadIdx.x & 3;
    const int r = threadIdx.x >> 2;
    at = r * kARow + 8 * kc;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int m = m0 + r + 32 * s;
      row[s] = -1;
      if (m < a.M) {
        const int n = m / a.plane, rem = m - n * a.plane;
        const int ho = rem / a.Wo, wo = rem - ho * a.Wo;
        row[s] = (((long long)n * a.H + ho * a.stride) * a.W +
                  wo * a.stride) * a.cin;
      }
    }
    k = kb + 8 * kc;
    ok = 0u;
  }

  // 16-byte path: start the global loads of the current step's chunks
  __device__ __forceinline__ void load(const FwdArgs& a, int ke) {
    ok = 0u;
    if (!a.a_vec || k >= ke) return;
#pragma unroll
    for (int s = 0; s < 2; ++s)
      if (row[s] >= 0) {
        v[s] = __ldg(reinterpret_cast<const uint4*>(a.x + row[s] + k));
        ok |= 1u << s;
      }
    if (ok && a.norm_in) {
      mma::ldg_f8(sc, a.scale + k);
      mma::ldg_f8(sh, a.shift + k);
    }
  }

  // the current step's chunks into the A buffer As, normalized and rounded
  // to bf16, zeros past M and K; then the next step's depth. The 2-byte
  // path loads here, element by element.
  __device__ __forceinline__ void store(const FwdArgs& a, __nv_bfloat16* As,
                                        int ke) {
    if (a.a_vec) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint4 out = make_uint4(0u, 0u, 0u, 0u);
        if ((ok >> s) & 1u)
          out = a.norm_in ? mma::norm_relu8(v[s], sc, sh, a.relu_in) : v[s];
        *reinterpret_cast<uint4*>(As + at + 32 * s * kARow) = out;
      }
    } else {
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float val = 0.0f;
          const int kk = k + e;
          if (kk < ke && row[s] >= 0) {
            val = __bfloat162float(a.x[row[s] + kk]);
            if (a.norm_in)
              val = mma::norm_relu(val, a.scale[kk], a.shift[kk], a.relu_in);
          }
          As[at + 32 * s * kARow + e] = __float2bfloat16_rn(val);
        }
    }
    k += kDepth;
  }
};

// The bf16 1x1 product on `stream`, K = Cin cut into `slices` slices of
// `slice_depth` (ops/fused_conv.py:mm_slices); returns cudaGetLastError()
// (an invalid shape or plan: cudaErrorInvalidValue, nothing launched).
inline int launch_fwd(FwdArgs a, int n, int h, int wd, int stride,
                      cudaStream_t stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || stride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  a.H = h;
  a.W = wd;
  a.stride = stride;
  a.Wo = (wd + stride - 1) / stride;
  a.plane = ((h + stride - 1) / stride) * a.Wo;
  a.M = n * a.plane;
  a.K = a.cin;
  a.a_vec = a.cin % 8 == 0 && mma::aligned16(a.x) &&
            mma::aligned16(a.scale) && mma::aligned16(a.shift);
  a.b_vec = a.cout % 8 == 0 && mma::aligned16(a.w);
  return c3::launch_product<MmStream>(a, stream);
}

}  // namespace mm_fwd
}  // namespace dl4j
