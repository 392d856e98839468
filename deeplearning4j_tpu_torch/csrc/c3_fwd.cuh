// fused_c3 in bf16 on Hopper's tensor cores (sm_90a): the 3x3 SAME
// stride-1 conv + BatchNorm statistics. Replaces, for bf16 inputs, the
// TPU kernel deeplearning4j_tpu/ops/fused_conv.py:_c3_kernel (f32 keeps
// conv_gemm.cuh's FMA tile). Per output pixel m and channel n:
//
//   e = relu?(x * scale + shift) rounded to bf16, zero outside the image
//       (the border is applied AFTER the normalize)            (prologue)
//   y[m, n] = sum over k = tap * Cin + c of e[m + shift(tap), c] W[k, n]
//             in f32, stored as bf16
//   partial[tile, 0, n] = sum over the tile's rows of y (f32 accumulator),
//   partial[tile, 1, n] = sum of y^2                           (epilogue)
//
// What bounds it on this card. 2 M 9 Cin Cout FLOP (taps inside the
// image) against x, W read once and y written once: at the ResNet50's four
// 3x3 shapes (batch 32) 0.3-0.6 GFLOP against 0.7-5 MB, about a
// microsecond either way. What held the FMA version (conv_gemm.cuh) 100x
// above that was its staging: per element and step an integer division
// for the tap and channel, a 2-byte load and the prologue, feeding f32 FMA
// on a 64 x 64 x 16 tile. What this design does about it:
//   * products: mma.sync m16n8k16 (bf16 x bf16, f32 sums) on 64 x 64
//     output tiles in 32-deep steps, 4 warps of 32 x 32;
//   * A (input pixels): each row's image position is decoded once per
//     block into a 9-bit mask of the taps that fall inside the image; tap
//     and channel advance by addition; x comes 8 channels (16 bytes) at a
//     time, the prologue runs in registers (no contraction, as
//     conv_gemm.cuh's), and the bf16 chunk goes to shared rows padded to
//     80 bytes (ldmatrix rows hit distinct banks). The next step's loads
//     are issued before the current step's products;
//   * B (W, HWIO, each K row contiguous in Cout): 16-byte cp.async into a
//     4-stage ring, zero-filled past K and Cout, read by ldmatrix.trans
//     from rows padded to 144 bytes;
//   * split-K: K is cut into at most kMaxSlices slices about kSliceDepth
//     deep, a function of K alone, so a row's bits do not depend on M or
//     on its tile (a padded serving batch agrees bitwise with a direct
//     call). The slices of one output tile run as one thread-block
//     cluster: each leaves its f32 tile in its shared memory and the
//     cluster adds them in slice order through distributed shared memory,
//     each block a band of rows. One launch, no f32 scratch in device
//     memory: at the served shapes the wrapper's host work, not the
//     device, bounds a call, and a second launch and a scratch allocation
//     cost more than the products (f32 keeps conv_gemm.cuh's tile and its
//     reduction of f32 planes, on the same slices);
//   * statistics (only when asked: the served path skips them) from the
//     f32 sums over valid rows, reduced in one fixed order (unsplit:
//     registers, shuffles within the warp, then the two row warps through
//     shared memory in warp order; split: each block's band of rows, then
//     the bands in rank order): no float atomics;
//   * 2-byte staging where Cin % 8, Cout % 8 or a pointer's alignment
//     rules out 16-byte copies: the same kernel, selected by a flag.
// The kernel is a template on the A side's staging: mm_fwd.cuh runs it
// with the 1x1 conv's strided rows in place of the taps.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "conv_gemm.cuh"
#include "mma.cuh"

namespace dl4j {
namespace c3 {

constexpr int kTile = 64;          // output pixels and channels of a block
constexpr int kDepth = 32;         // depth of one staged step
constexpr int kARow = kDepth + 8;  // A row stride in bf16: 80 bytes
constexpr int kBRow = kTile + 8;   // B row stride in bf16: 144 bytes
constexpr int kBStages = 4;        // depth of the weight's cp.async ring
constexpr int kMmaThreads = 128;   // 4 warps, 2 x 2, each 32 x 32
constexpr int kSliceDepth = 576;   // about the depth of a K slice
constexpr int kMaxSlices = 8;      // slices of a tile: a portable cluster
constexpr int kAccRow = kTile + 4;  // f32 row stride of a parked tile
static_assert(kTile == kTileM, "partial statistics per 64-row tile");

// Depth of each K slice (a multiple of kDepth; the last one shorter) and
// their count, for a reduction depth k = 9 Cin: functions of K alone.
inline int slice_depth(int k) {
  int want = (k + kSliceDepth - 1) / kSliceDepth;
  if (want > kMaxSlices) want = kMaxSlices;
  const int per = (k + want - 1) / want;
  return (per + kDepth - 1) / kDepth * kDepth;
}

inline int split_count(int k) {
  const int d = slice_depth(k);
  return (k + d - 1) / d;
}

struct FwdArgs {
  const __nv_bfloat16* x;  // (N, H, W, Cin): row m is output pixel m
  const __nv_bfloat16* w;  // (9 Cin, Cout)
  const float* scale;      // (Cin,)
  const float* shift;      // (Cin,)
  __nv_bfloat16* y;        // (M, Cout)
  float* partial;          // (ceil(M / kTile), 2, Cout) when want_stats
  int H, W, cin, cout, M, K;
  int norm_in, relu_in, want_stats;
  int slices, slice_depth;
  int a_vec;  // 16-byte loads of x (Cin % 8 == 0; x, scale, shift aligned)
  int b_vec;  // 16-byte copies of W (Cout % 8 == 0, W aligned)
  int Wo, plane, stride;  // 1x1 (mm_fwd.cuh): output row width, Ho * Wo
};

// This thread's share of the A side of every step: depths k .. k + 7 (k =
// step start + 8 (tid % 4)) of output pixels (tid / 4) + 32 s, s = 0, 1.
struct AStream {
  int m[2];            // the rows' pixels, -1 past M
  unsigned inside[2];  // bit t: tap t of the row lies inside the image
  int k, tap, c;       // the next step's depth, its tap and channel
  int at;              // shared offset of row s = 0 (s = 1: + 32 rows)
  unsigned ok;         // bit s: chunk s was loaded (inside the image, K)
  uint4 v[2];          // the loaded chunks (16-byte path)
  float sc[8], sh[8];  // their scale and shift

  __device__ AStream(const FwdArgs& a, int m0, int kb) {
    const int kc = threadIdx.x & 3;
    const int r = threadIdx.x >> 2;
    at = r * kARow + 8 * kc;
    const int plane = a.H * a.W;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int mm = m0 + r + 32 * s;
      m[s] = mm < a.M ? mm : -1;
      inside[s] = 0u;
      if (m[s] >= 0) {
        const int rem = mm % plane;
        const int i = rem / a.W, j = rem % a.W;
        for (int t = 0; t < 9; ++t) {
          const int hi = i + t / 3 - 1, wi = j + t % 3 - 1;
          if (hi >= 0 && hi < a.H && wi >= 0 && wi < a.W)
            inside[s] |= 1u << t;
        }
      }
    }
    k = kb + 8 * kc;
    tap = k / a.cin;
    c = k - tap * a.cin;
    ok = 0u;
  }

  // 16-byte path: start the global loads of the current step's chunks
  __device__ __forceinline__ void load(const FwdArgs& a, int ke) {
    ok = 0u;
    if (!a.a_vec || k >= ke) return;
    const int shift = (tap / 3 - 1) * a.W + tap % 3 - 1;
#pragma unroll
    for (int s = 0; s < 2; ++s)
      if (m[s] >= 0 && ((inside[s] >> tap) & 1u)) {
        v[s] = __ldg(reinterpret_cast<const uint4*>(
            a.x + (long long)(m[s] + shift) * a.cin + c));
        ok |= 1u << s;
      }
    if (ok && a.norm_in) {
      mma::ldg_f8(sc, a.scale + c);
      mma::ldg_f8(sh, a.shift + c);
    }
  }

  // the current step's chunks into the A buffer As, normalized and
  // rounded to bf16, zeros outside the image and past K; then the next
  // step's depth. The 2-byte path loads here, element by element.
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
          if (kk < ke && m[s] >= 0) {
            const int t = kk / a.cin, cc = kk - t * a.cin;
            if ((inside[s] >> t) & 1u) {
              const long long off =
                  (long long)(m[s] + (t / 3 - 1) * a.W + t % 3 - 1) * a.cin +
                  cc;
              val = __bfloat162float(a.x[off]);
              if (a.norm_in)
                val = mma::norm_relu(val, a.scale[cc], a.shift[cc],
                                     a.relu_in);
            }
          }
          As[at + 32 * s * kARow + e] = __float2bfloat16_rn(val);
        }
    }
    k += kDepth;
    c += kDepth;
    while (c >= a.cin) {
      c -= a.cin;
      ++tap;
    }
  }
};

// step st's W rows kb + 32 st + (tid / 8) + 16 s, columns n0 + 8 (tid % 8)
// .. + 7, into the ring stage Bs: 16-byte cp.async with zero fill, else
// 2-byte loads and stores
__device__ __forceinline__ void issue_w(const FwdArgs& a, __nv_bfloat16* Bs,
                                        int kb, int ke, int n0, int st) {
  const int row = threadIdx.x >> 3;
  const int col = 8 * (threadIdx.x & 7);
  const int n = n0 + col;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int kr = kb + kDepth * st + row + 16 * s;
    __nv_bfloat16* dst = Bs + (row + 16 * s) * kBRow + col;
    const __nv_bfloat16* src = a.w + (long long)kr * a.cout + n;
    if (a.b_vec) {
      const bool ok = kr < ke && n < a.cout;
      mma::cp_async16(dst, ok ? src : a.w, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (kr < ke && n + e < a.cout) ? src[e]
                                             : __float2bfloat16_rn(0.0f);
    }
  }
}

// Shared memory of fwd_mma_kernel: the A and B staging, which a split
// tile's f32 accumulators reuse once the products are done
constexpr int kStagingBytes =
    2 * (2 * kTile * kARow + kBStages * kDepth * kBRow);
constexpr int kSmemBytes = kStagingBytes > 4 * kTile * kAccRow
                               ? kStagingBytes
                               : 4 * kTile * kAccRow;

// One 64 x 64 output tile over one K slice: y and its statistics. With K
// split, the launch groups a tile's slices into one cluster (blockIdx.z
// is the slice and the block's rank), which adds them in slice order. AS
// stages A: AStream (the 3x3's taps) or mm_fwd.cuh's MmStream (the 1x1's
// strided rows).
template <class AS>
__global__ void __launch_bounds__(kMmaThreads) fwd_mma_kernel(FwdArgs a) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  __shared__ float red[2][2][kTile];
  __shared__ float band_sums[2][kTile];
  auto As = reinterpret_cast<__nv_bfloat16(*)[kTile * kARow]>(smem);
  auto Bs = reinterpret_cast<__nv_bfloat16(*)[kDepth * kBRow]>(
      smem + sizeof(__nv_bfloat16) * 2 * kTile * kARow);
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int kb = blockIdx.z * a.slice_depth;
  const int ke = min(a.K, kb + a.slice_depth);
  const int steps = (ke - kb + kDepth - 1) / kDepth;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  AS in(a, m0, kb);
#pragma unroll
  for (int st = 0; st < kBStages - 1; ++st) {
    if (st < steps) issue_w(a, Bs[st], kb, ke, n0, st);
    mma::cp_async_commit();
  }
  in.load(a, ke);
  in.store(a, As[0], ke);
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) in.load(a, ke);   // in flight over the products
    mma::cp_async_wait<kBStages - 2>();  // this thread's copies of step st
    __syncthreads();  // step st staged by all; step st - 1's readers done
    if (st + kBStages - 1 < steps)
      issue_w(a, Bs[(st + kBStages - 1) % kBStages], kb, ke, n0,
              st + kBStages - 1);
    mma::cp_async_commit();
    const __nv_bfloat16* A = As[st & 1];
    const __nv_bfloat16* B = Bs[st % kBStages];
#pragma unroll
    for (int ks = 0; ks < kDepth / 16; ++ks) {
      unsigned af[2][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mma::ldsm_x4(af[i], A + (wm + 16 * i + (lane & 15)) * kARow +
                                16 * ks + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        mma::ldsm_x4_trans(bf[jp], B + (16 * ks + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * kBRow +
                                       wn + 16 * jp + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          mma::mma_bf16(acc[i][2 * jp], af[i], bf[jp][0], bf[jp][1]);
          mma::mma_bf16(acc[i][2 * jp + 1], af[i], bf[jp][2], bf[jp][3]);
        }
    }
    if (st + 1 < steps) in.store(a, As[(st + 1) & 1], ke);
  }
  mma::cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (a.cout & 1) == 0;
  if (a.slices > 1) {
    // park this slice's f32 tile in shared memory; block `rank` then adds
    // the cluster's tiles in slice order over its band of rows, writes y
    // and the band's column sums, and rank 0 adds the bands in order
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    float* tile = reinterpret_cast<float*>(smem);
    __syncthreads();  // every warp's last read of the staging is done
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float2*>(
              tile + (wm + 16 * i + g + 8 * h) * kAccRow + wn + 8 * j +
              2 * t) = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    cluster.sync();  // every slice's tile is parked
    const int slices = a.slices;
    const int rank = static_cast<int>(cluster.block_rank());
    const float* part[kMaxSlices];
#pragma unroll
    for (int sl = 0; sl < kMaxSlices; ++sl)
      part[sl] = sl < slices ? cluster.map_shared_rank(tile, sl) : tile;
    const int band = (kTile + slices - 1) / slices;
    const int r1 = min(kTile, (rank + 1) * band);
    const int col = threadIdx.x & (kTile - 1), half = threadIdx.x >> 6;
    const int n = n0 + col;
    float su = 0.0f, sq = 0.0f;
    for (int r = rank * band + half; r < r1; r += kMmaThreads / kTile) {
      float v[kMaxSlices];
#pragma unroll
      for (int sl = 0; sl < kMaxSlices; ++sl)
        v[sl] = sl < slices ? part[sl][r * kAccRow + col] : 0.0f;
      float sum = v[0];
#pragma unroll
      for (int sl = 1; sl < kMaxSlices; ++sl)
        if (sl < slices) sum += v[sl];
      const int m = m0 + r;
      if (m < a.M && n < a.cout) {
        a.y[(long long)m * a.cout + n] = __float2bfloat16_rn(sum);
        su += sum;
        sq += sum * sum;
      }
    }
    if (a.want_stats) {
      red[0][half][col] = su;
      red[1][half][col] = sq;
      __syncthreads();
      if (threadIdx.x < kTile) {
        band_sums[0][col] = red[0][0][col] + red[0][1][col];
        band_sums[1][col] = red[1][0][col] + red[1][1][col];
      }
    }
    cluster.sync();  // the tiles are read and the band sums written
    if (!a.want_stats) return;
    if (rank == 0 && threadIdx.x < kTile && n < a.cout) {
      float ts = 0.0f, tq = 0.0f;
      for (int sl = 0; sl < slices; ++sl) {
        const float* b = cluster.map_shared_rank(&band_sums[0][0], sl);
        ts += b[col];
        tq += b[kTile + col];
      }
      float* p = a.partial + (long long)blockIdx.x * 2 * a.cout;
      p[n] = ts;
      p[a.cout + n] = tq;
    }
    cluster.sync();  // rank 0's reads of the band sums are done
    return;
  }

  float cs[4][2], cq[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    cs[j][0] = cs[j][1] = cq[j][0] = cq[j][1] = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= a.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + 2 * t;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        __nv_bfloat16* o = a.y + (long long)m * a.cout + n;
        if (pairs && n + 1 < a.cout) {
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (n < a.cout) o[0] = __float2bfloat16_rn(v0);
          if (n + 1 < a.cout) o[1] = __float2bfloat16_rn(v1);
        }
        cs[j][0] += v0;
        cq[j][0] += v0 * v0;
        cs[j][1] += v1;
        cq[j][1] += v1 * v1;
      }
    }
  if (!a.want_stats) return;
  // the 8 row groups of the warp (lanes 4 g + t), then its two row warps
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        cs[j][b] += __shfl_xor_sync(0xffffffffu, cs[j][b], off);
        cq[j][b] += __shfl_xor_sync(0xffffffffu, cq[j][b], off);
      }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        red[0][warp >> 1][wn + 8 * j + 2 * t + b] = cs[j][b];
        red[1][warp >> 1][wn + 8 * j + 2 * t + b] = cq[j][b];
      }
  }
  __syncthreads();
  const int col = threadIdx.x;
  if (col < kTile && n0 + col < a.cout) {
    float* p = a.partial + (long long)blockIdx.x * 2 * a.cout;
    p[n0 + col] = red[0][0][col] + red[0][1][col];
    p[a.cout + n0 + col] = red[1][0][col] + red[1][1][col];
  }
}

// The product of FwdArgs whose K, slices and slice_depth are set, with AS
// staging A, on `stream`: its K slices as clusters when K is split;
// returns cudaGetLastError() (an invalid shape or plan:
// cudaErrorInvalidValue, nothing launched).
template <class AS>
inline int launch_product(const FwdArgs& a, cudaStream_t stream) {
  if (a.M <= 0 || a.cin <= 0 || a.cout <= 0 || a.K <= 0 ||
      (a.want_stats && a.partial == nullptr) || a.slices < 1 ||
      a.slices > kMaxSlices || a.slice_depth <= 0 ||
      a.slice_depth % kDepth != 0 ||
      (long long)a.slices * a.slice_depth < a.K ||
      (long long)(a.slices - 1) * a.slice_depth >= a.K ||
      (a.cout + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.M + kTile - 1) / kTile, (a.cout + kTile - 1) / kTile,
                  a.slices);
  if (a.slices == 1) {
    fwd_mma_kernel<AS><<<grid, kMmaThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = a.slices;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fwd_mma_kernel<AS>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// bf16 3x3: the product on `stream`, K = 9 Cin cut by slice_depth;
// returns cudaGetLastError() (an invalid shape: cudaErrorInvalidValue,
// nothing launched).
inline int launch_fwd(FwdArgs a, cudaStream_t stream) {
  if (a.H <= 0 || a.W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  a.K = 9 * a.cin;
  a.slice_depth = slice_depth(a.K);
  a.slices = split_count(a.K);
  a.a_vec = a.cin % 8 == 0 && mma::aligned16(a.x) &&
            mma::aligned16(a.scale) && mma::aligned16(a.shift);
  a.b_vec = a.cout % 8 == 0 && mma::aligned16(a.w);
  return launch_product<AStream>(a, stream);
}

}  // namespace c3
}  // namespace dl4j
