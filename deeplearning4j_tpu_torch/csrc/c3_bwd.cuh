// fused_c3_bwd in bf16 on Hopper's tensor cores (sm_90a): the one-call
// backward of the 3x3 SAME conv + BatchNorm. Replaces, for bf16 inputs,
// the TPU kernel deeplearning4j_tpu/ops/fused_conv.py:
// _c3_bwd_merged_kernel (f32 keeps conv_bwd.cuh's merged FMA kernel). One
// entry point computes
//
//   dyc = dy + dS + 2 y dS2, rounded to bf16 (written once)
//   dx  = the BN/ReLU backward of de = dyc (x) flipped W       (as
//         c3_bwd_in.cuh's fused_c3_bwd_in), with (dscale, dshift)
//   dW[tap, c, n] = sum over pixels m of e_tap[m, c] dyc[m, n] in f32,
//         e_tap the normalized input shifted by the tap, zero outside the
//         image AFTER the normalize
//
// What bounds it on this card. Two products of 2 M 9 Cin Cout FLOP each
// against dy, y, x, W read once and dx, dW written once: at the
// ResNet50's 3x3 shapes (batch 32) about 1 GFLOP against 1-6 MB, a few
// microseconds. The FMA version (conv_bwd.cuh) took 0.15-0.46 ms a call:
// a dx tile walked the whole 9 Cout depth alone (32 tiles at stage 3),
// dyc was rebuilt per element with an integer division, and both products
// ran f32 FMA. What this design does about it:
//   * dyc once, as bf16, by c3_bwd_in.cuh's dyc_kernel; both products read
//     it by 16-byte cp.async;
//   * dx: c3_bwd_in.cuh's split-K tensor-core product (slices from
//     fused_conv.dx_slices, f32 planes), epilogue and sums kernels;
//   * dW: mma.sync m16n8k16 on 64 x 64 tiles of (9 Cin, Cout), depth = the
//     pixels, cut into slices of `chunk` pixels (a multiple of 32, from the
//     shapes alone) that each write an f32 plane; conv_bwd.cuh's
//     dw_reduce_kernel adds the planes in slice order. A (e, pixels x rows)
//     is recomputed from 16-byte loads of x: a thread's 8 rows are 8
//     channels of one tap, so their scale, shift and image offset are
//     fixed for the block, and the pixel's (row, column) advance by
//     addition; the normalize runs in registers and the border is written
//     as zeros (a zero-filled copy normalized in place would give
//     relu(shift) there). B is dyc by cp.async into a 4-stage ring. Both
//     lie in shared memory with the pixel as the row, so both reach the
//     MMAs by ldmatrix.trans, from rows padded to 144 bytes;
//   * the dx and dW products are two grids, each sized to about two
//     blocks per SM;
//   * 2-byte staging where Cin % 8, Cout % 8 or a pointer's alignment
//     rules out 16-byte copies: the same kernels, selected by flags;
//   * no float atomics: every sum has one fixed order, so two calls on the
//     same inputs give the same bits.
// The dW tile (dw_tile) is a template on its A side: mm_bwd.cuh runs it
// with the 1x1's stride-grid rows in place of the taps.
#pragma once

#include <cstdint>

#include "c3_bwd_in.cuh"

namespace dl4j {
namespace c3_bwd {

constexpr int kTile = 64;         // rows (tap, channel) and columns (Cout)
constexpr int kDepth = 32;        // pixels of one staged step
constexpr int kRow = kTile + 8;   // shared row stride in bf16: 144 bytes
constexpr int kStages = 4;        // depth of dyc's cp.async ring
constexpr int kMmaThreads = 128;  // 4 warps, 2 x 2, each 32 x 32

struct DwArgs {
  const __nv_bfloat16* x;    // (N, H, W, Cin)
  const __nv_bfloat16* dyc;  // (M, Cout)
  const float* scale;        // (Cin,)
  const float* shift;        // (Cin,)
  float* out;                // slice z's plane: out + z * rows * Cout
  int H, W, cin, cout, M, rows;  // rows = 9 Cin
  int norm_in, relu_in;
  int chunk;                 // pixels a slice sums, a multiple of kDepth
  int a_vec;  // 16-byte loads of x (Cin % 8 == 0; x, scale, shift aligned)
  int b_vec;  // 16-byte copies of dyc (Cout % 8 == 0, dyc aligned)
  int Wo, plane, stride;  // 1x1 (mm_bwd.cuh): dy's row width, Ho * Wo
};

// This thread's pixels: p = tid / 8 and p + 16 of each step, tracked as
// (flat index, image row, image column) and advanced by addition.
struct Pixels {
  int m[2], i[2], j[2];
  int di, dj;  // one step of kDepth pixels as (rows, columns) of a plane

  __device__ Pixels(const DwArgs& d, int kb) {
    const int plane = d.H * d.W;
    const int p = threadIdx.x >> 3;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      m[s] = kb + p + 16 * s;
      const int rem = m[s] % plane;
      i[s] = rem / d.W;
      j[s] = rem % d.W;
    }
    const int step = kDepth % plane;
    di = step / d.W;
    dj = step % d.W;
  }

  __device__ __forceinline__ void advance(const DwArgs& d) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      m[s] += kDepth;
      j[s] += dj;
      int carry = 0;
      if (j[s] >= d.W) {
        j[s] -= d.W;
        carry = 1;
      }
      i[s] += di + carry;
      if (i[s] >= d.H) i[s] -= d.H;
    }
  }
};

// The A side of the 3x3's dW tile (rows tap * Cin + c): this thread's rows
// r .. r + 7 (r = r0 + 8 (tid % 8)), one tap's 8 channels when a_vec, at
// its pixels p and p + 16 of each step, shifted by the tap; zeros outside
// the image, written AFTER the normalize.
struct C3ERows {
  int r, ti, tj;
  long long toff;   // element offset of the tap's shift and channel
  bool rows_ok;     // 16-byte path and r inside the rows
  float sc[8], sh[8];
  Pixels px;
  unsigned ok;      // bit s: chunk s was loaded
  uint4 v[2];

  __device__ C3ERows(const DwArgs& d, int r0, int kb) : px(d, kb) {
    r = r0 + 8 * (threadIdx.x & 7);
    const int tap = r / d.cin, c = r - tap * d.cin;
    ti = tap / 3 - 1;
    tj = tap % 3 - 1;
    toff = (long long)(ti * d.W + tj) * d.cin + c;
    rows_ok = d.a_vec && r < d.rows;
    if (rows_ok && d.norm_in) {
      mma::ldg_f8(sc, d.scale + c);
      mma::ldg_f8(sh, d.shift + c);
    }
    ok = 0u;
  }

  // the current step's x chunks (16-byte path), inside the image and slice
  __device__ __forceinline__ void load(const DwArgs& d, int ke) {
    ok = 0u;
    if (!rows_ok) return;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int hi = px.i[s] + ti, wi = px.j[s] + tj;
      if (px.m[s] < ke && hi >= 0 && hi < d.H && wi >= 0 && wi < d.W) {
        v[s] = __ldg(reinterpret_cast<const uint4*>(
            d.x + (long long)px.m[s] * d.cin + toff));
        ok |= 1u << s;
      }
    }
  }

  // the current step's e into A buffer a (zeros outside), then the next
  // step's pixels; the 2-byte path loads here, element by element
  __device__ __forceinline__ void store(const DwArgs& d, __nv_bfloat16* a,
                                        int ke) {
    const int p = threadIdx.x >> 3, q8 = 8 * (threadIdx.x & 7);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      __nv_bfloat16* dst = a + (p + 16 * s) * kRow + q8;
      if (d.a_vec) {
        uint4 out = make_uint4(0u, 0u, 0u, 0u);
        if ((ok >> s) & 1u)
          out = d.norm_in ? mma::norm_relu8(v[s], sc, sh, d.relu_in) : v[s];
        *reinterpret_cast<uint4*>(dst) = out;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float val = 0.0f;
          const int rr = r + e;
          if (rr < d.rows && px.m[s] < ke) {
            const int t = rr / d.cin, cc = rr - t * d.cin;
            const int hi = px.i[s] + t / 3 - 1, wi = px.j[s] + t % 3 - 1;
            if (hi >= 0 && hi < d.H && wi >= 0 && wi < d.W) {
              val = __bfloat162float(
                  d.x[(long long)(px.m[s] + (t / 3 - 1) * d.W + t % 3 - 1) *
                          d.cin + cc]);
              if (d.norm_in)
                val = mma::norm_relu(val, d.scale[cc], d.shift[cc],
                                     d.relu_in);
            }
          }
          dst[e] = __float2bfloat16_rn(val);
        }
      }
    }
    px.advance(d);
  }
};

// Shared memory of one dW tile: e's two buffers, then dyc's ring
constexpr int kDwElems = (2 + kStages) * kDepth * kRow;

// dW: the 64 x 64 tile (bx, by) of (rows, Cout) over pixel slice bz, into
// its plane of d.out. E stages A (C3ERows, or mm_bwd.cuh's 1x1 rows); smem
// holds kDwElems bf16.
template <class E>
__device__ __forceinline__ void dw_tile(const DwArgs& d, __nv_bfloat16* smem,
                                        int bx, int by, int bz) {
  auto As = reinterpret_cast<__nv_bfloat16(*)[kDepth * kRow]>(smem);
  auto Bs = As + 2;
  const int r0 = bx * kTile, n0 = by * kTile;
  const int kb = bz * d.chunk;
  const int ke = min(d.M, kb + d.chunk);
  const int steps = (ke - kb + kDepth - 1) / kDepth;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int p = threadIdx.x >> 3, q8 = 8 * (threadIdx.x & 7);
  E in(d, r0, kb);

  // step st's dyc rows (pixels) into ring stage b, columns n0 + q8 .. + 7
  auto issue = [&](__nv_bfloat16* b, int st) {
    const int n = n0 + q8;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int mm = kb + kDepth * st + p + 16 * s;
      __nv_bfloat16* dst = b + (p + 16 * s) * kRow + q8;
      const __nv_bfloat16* src = d.dyc + (long long)mm * d.cout + n;
      if (d.b_vec) {
        const bool okb = mm < ke && n < d.cout;
        mma::cp_async16(dst, okb ? src : d.dyc, okb);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (mm < ke && n + e < d.cout) ? src[e]
                                               : __float2bfloat16_rn(0.0f);
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) issue(Bs[st], st);
    mma::cp_async_commit();
  }
  in.load(d, ke);
  in.store(d, As[0], ke);
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) in.load(d, ke);  // in flight over the products
    mma::cp_async_wait<kStages - 2>();  // this thread's copies of step st
    __syncthreads();  // step st staged by all; step st - 1's readers done
    if (st + kStages - 1 < steps)
      issue(Bs[(st + kStages - 1) % kStages], st + kStages - 1);
    mma::cp_async_commit();
    const __nv_bfloat16* A = As[st & 1];
    const __nv_bfloat16* B = Bs[st % kStages];
#pragma unroll
    for (int ks = 0; ks < kDepth / 16; ++ks) {
      unsigned af[2][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mma::ldsm_x4_trans(af[i], A + (16 * ks + (lane & 7) +
                                       ((lane >> 4) & 1) * 8) * kRow +
                                      wm + 16 * i + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        mma::ldsm_x4_trans(bf[jp], B + (16 * ks + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * kRow +
                                       wn + 16 * jp + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          mma::mma_bf16(acc[i][2 * jp], af[i], bf[jp][0], bf[jp][1]);
          mma::mma_bf16(acc[i][2 * jp + 1], af[i], bf[jp][2], bf[jp][3]);
        }
    }
    if (st + 1 < steps) in.store(d, As[(st + 1) & 1], ke);
  }
  mma::cp_async_wait<0>();

  float* out = d.out + (long long)bz * d.rows * d.cout;
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (d.cout & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + wm + 16 * i + g + 8 * h;
      if (row >= d.rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + 2 * t;
        float* o = out + (long long)row * d.cout + n;
        if (pairs && n + 1 < d.cout) {
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          if (n < d.cout) o[0] = acc[i][j][2 * h];
          if (n + 1 < d.cout) o[1] = acc[i][j][2 * h + 1];
        }
      }
    }
}

// dW of the 3x3: one 64 x 64 tile of (9 Cin, Cout) over one pixel slice.
__global__ void __launch_bounds__(kMmaThreads) dw_mma_kernel(DwArgs d) {
  __shared__ __align__(16) __nv_bfloat16 smem[kDwElems];
  dw_tile<C3ERows>(d, smem, blockIdx.x, blockIdx.y, blockIdx.z);
}

// The whole bf16 backward on `stream`: dyc and the dx product, the dW
// product, the dx epilogue and sums, then the dW planes added in slice
// order when there are several (dw_ws: (dw_slices, 9 Cin, Cout) f32).
// Returns cudaGetLastError() (an invalid plan or shape:
// cudaErrorInvalidValue, nothing launched).
inline int launch_merged(bwd_in::InArgs a, float* dw, float* dw_ws,
                         int dw_chunk, cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  int err = bwd_in::check_in<__nv_bfloat16>(a);
  if (err != 0) return err;
  const BwdArgs& p = a.p;
  if (dw == nullptr || dw_chunk <= 0 || dw_chunk % kDepth != 0) return bad;
  const int dw_slices = (p.M + dw_chunk - 1) / dw_chunk;
  const long long rows = 9LL * p.cin;
  const long long rt = (rows + kTile - 1) / kTile;
  const long long nt = (p.cout + kTile - 1) / kTile;
  if ((dw_slices > 1 && dw_ws == nullptr) || dw_slices > 65535 ||
      nt > 65535 || rt > 0x7fffffffLL)
    return bad;
  bwd_in::set_flags(a);
  DwArgs d{};
  d.x = static_cast<const __nv_bfloat16*>(p.x);
  d.dyc = a.dyc;
  d.scale = p.scale;
  d.shift = p.shift;
  d.out = dw_slices > 1 ? dw_ws : dw;
  d.H = p.H;
  d.W = p.W;
  d.cin = p.cin;
  d.cout = p.cout;
  d.M = p.M;
  d.rows = static_cast<int>(rows);
  d.norm_in = p.norm_in;
  d.relu_in = p.relu_in;
  d.chunk = dw_chunk;
  d.a_vec = p.cin % 8 == 0 && mma::aligned16(p.x) &&
            mma::aligned16(p.scale) && mma::aligned16(p.shift);
  d.b_vec = p.cout % 8 == 0 && mma::aligned16(a.dyc);

  err = bwd_in::launch_in_product<__nv_bfloat16>(a, stream);
  if (err != 0) return err;
  dw_mma_kernel<<<dim3(static_cast<unsigned>(rt), static_cast<unsigned>(nt),
                       dw_slices),
                  kMmaThreads, 0, stream>>>(d);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  err = bwd_in::launch_in_epilogue<__nv_bfloat16>(a, stream);
  if (err != 0 || dw_slices == 1) return err;
  const long long len = rows * p.cout;
  const long long blocks = (len + kThreads - 1) / kThreads;
  dw_reduce_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                     kThreads, 0, stream>>>(dw_ws, dw, len, dw_slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace c3_bwd
}  // namespace dl4j
