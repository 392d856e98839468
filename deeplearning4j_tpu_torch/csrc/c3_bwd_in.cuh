// fused_c3_bwd_in: the backward-input of the 3x3 SAME conv + BatchNorm,
// for Hopper (sm_90a). Replaces the TPU kernel
// deeplearning4j_tpu/ops/fused_conv.py:_c3_bwd_in_kernel (via
// _c3_bwd_pallas). Per input pixel m and channel c it computes
//
//   de[m, c] = sum over tap, n of dyc_pad[m + shift(tap), n]
//                                  * W[8 - tap, c, n]
//     (K = 9 * Cout; dyc = dy + dS + 2 * y * dS2 rounded to dy's dtype,
//      zero where the tap falls outside the image)
//   dpre = de where pre = x * scale + shift > 0 (ReLU), dx = dpre * scale
//   partial[tile, 0, c] = sum dpre * x, partial[tile, 1, c] = sum dpre
//
// exactly as conv_bwd.cuh's dx tile does (norm_in = 0: dx = de, no sums).
//
// What bounds it on this card. 2 * M * 9 * Cout * Cin FLOP against dy, y,
// x and W read once and dx written once. At the ResNet50's stage-4 shape
// (x (B, 2, 2, 512), W (3, 3, 512, 512), bf16) that is 0.6 GFLOP at B 32
// and 2.4 at B 128 against 5-8 MB: bytes bound it (2-3 us). What made the
// first version slow is the shape: M = 4B rows and Cin = 512 columns give
// 16 (B 32) or 64 (B 128) output tiles of 64 x 64 on 132 SMs, each 4608
// deep, and it walked each tile's whole depth in one block with f32 FMA
// on scalar loads.
//
// What the design does about it:
//   * split-K: K is cut into `slices` fixed slices of `slice_depth` (a
//     multiple of 32; ops/fused_conv.py:dx_slices picks both from the
//     shapes alone, for about two blocks per SM); block (row tile, column
//     tile, slice) writes its f32 partial tile to the plane ws[slice];
//   * bf16: mma.sync m16n8k16 (bf16 x bf16, f32 sums) over 64 x 64 x 32
//     steps, 4 warps of 32 x 32. A (dyc) is computed in f32 from 16-byte
//     loads of dy and y, rounded to bf16 as dyc_at does, and stored to
//     shared memory; B (the flipped weight W[8 - tap, c, n], contiguous in
//     n) is copied by 16-byte cp.async. Both reach the MMAs by ldmatrix
//     from rows padded to 80 bytes, so no two of a matrix's 8 rows share a
//     bank. Two stages: the next step's loads are in flight while the
//     current step multiplies;
//   * f32: conv_bwd.cuh's FMA tile (f32 FMA, no TF32) on the same split
//     grid;
//   * a second kernel, in the same entry point, adds the planes in slice
//     order, runs the BN/ReLU backward and writes the sums of each
//     `tile_rows`-row tile (the wrapper sizes `partial` by it);
//   * scalar loads where Cout % 8 or a pointer's alignment rules out
//     16-byte ones: the same kernels, not a fallback;
//   * no float atomics: every sum has one fixed order, so two calls on the
//     same inputs give the same bits.
// The product's main loop (mma_steps) is a template on its staging, shared
// with mm_bwd.cuh's 1x1 dx product; dyc_kernel is shared with it too.
#pragma once

#include <cstdint>
#include <type_traits>

#include "conv_bwd.cuh"
#include "mma.cuh"

namespace dl4j {
namespace bwd_in {

constexpr int kTile = 64;          // rows (pixels) and columns (Cin) a block
constexpr int kDepth = 32;         // depth of one staged step
constexpr int kRow = kDepth + 8;   // shared row stride in bf16: 80 bytes
constexpr int kStages = 4;         // depth of the cp.async ring
constexpr int kMmaThreads = 128;   // 4 warps, 2 x 2, each 32 x 32
constexpr int kEpiCols = 64;       // columns of an epilogue block
constexpr int kEpiGroups = 16;     // its row groups
constexpr int kEpiThreads = kEpiCols / 4 * kEpiGroups;
static_assert(kTile == kTileM && kTile == kTileN, "one tile for both paths");

struct InArgs {
  BwdArgs p;
  __nv_bfloat16* dyc;   // (M, Cout) bf16 scratch of the bf16 path
  float* ws;            // (slices, M, Cin) f32 partial planes
  float* sums;          // (2, Cin) f32: the partial tiles summed in order
  int slices;           // K slices
  int slice_depth;      // depth of each, a multiple of kDepth
  int tile_rows;        // rows of one partial-sum tile
  int vec;              // 16-byte copies of dyc and W (Cout % 8 == 0)
  int dyc_vec;          // 16-byte loads of dy, y and dst
  int epi_vec;          // 16-byte loads of the planes (Cin % 4 == 0)
};

// dyc = dy + dS + 2 y dS2 in f32, rounded to bf16 as dyc_at does, for
// every (pixel, channel), once: the product then reads each value for up
// to 9 taps and every column tile without recomputing it
__global__ void __launch_bounds__(kEpiThreads) dyc_kernel(InArgs a) {
  const BwdArgs& p = a.p;
  const long long total = (long long)p.M * p.cout;
  const long long step = (long long)gridDim.x * kEpiThreads;
  long long i = (long long)blockIdx.x * kEpiThreads + threadIdx.x;
  if (!a.dyc_vec) {
    for (; i < total; i += step)
      a.dyc[i] = __float2bfloat16_rn(
          dyc_at<__nv_bfloat16>(p, i, static_cast<int>(i % p.cout)));
    return;
  }
  const __nv_bfloat16* dy = static_cast<const __nv_bfloat16*>(p.dy);
  const __nv_bfloat16* y = static_cast<const __nv_bfloat16*>(p.y);
  for (i *= 8; i < total; i += 8 * step) {   // Cout % 8 == 0
    const int n = static_cast<int>(i % p.cout);
    const uint4 dv = __ldg(reinterpret_cast<const uint4*>(dy + i));
    const uint4 yv = __ldg(reinterpret_cast<const uint4*>(y + i));
    const __nv_bfloat16* d8 = reinterpret_cast<const __nv_bfloat16*>(&dv);
    const __nv_bfloat16* y8 = reinterpret_cast<const __nv_bfloat16*>(&yv);
    const float4* sp = reinterpret_cast<const float4*>(p.dst + n);
    const float4* qp = reinterpret_cast<const float4*>(p.dst + p.cout + n);
    const float4 s0 = __ldg(sp), s1 = __ldg(sp + 1);
    const float4 q0 = __ldg(qp), q1 = __ldg(qp + 1);
    const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    unsigned out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * e + h;
        v[h] = __fadd_rn(__fadd_rn(__bfloat162float(d8[j]), sv[j]),
                         __fmul_rn(2.0f * __bfloat162float(y8[j]), qv[j]));
      }
      out[e] = mma::pack_bf16(v[0], v[1]);
    }
    *reinterpret_cast<uint4*>(a.dyc + i) =
        make_uint4(out[0], out[1], out[2], out[3]);
  }
}

// One stage of the ring: the A (dyc) and B tiles, kTile rows of kRow bf16
// each; kStages stages fit the 48 KB of static shared memory.
constexpr int kStageElems = 2 * kTile * kRow;
static_assert(sizeof(__nv_bfloat16) * kStages * kStageElems <= 48 * 1024,
              "the ring fits static shared memory");

// This thread's share of every step: depths k .. k + 7 (k = step start +
// 8 (tid % 4)) of A rows and B columns (tid / 4) + 32 s, s = 0, 1. The tap
// and channel of k advance with the steps, so a step costs no division.
struct Stream {
  int m[2];             // the A rows' pixels, -1 past M
  unsigned inside[2];   // bit t: tap t of the row lies inside the image
  long long wc[2];      // c * Cout of the B columns, -1 past Cin
  int k, tap, n;        // the next step's depth, its tap and channel
  int at;               // shared offset of chunk s = 0 (s = 1: + 32 rows)

  __device__ Stream(const BwdArgs& p, int m0, int c0, int kb) {
    const int kc = threadIdx.x & 3;
    const int r = threadIdx.x >> 2;
    at = r * kRow + 8 * kc;
    const int plane = p.Ho * p.Wo;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int mm = m0 + r + 32 * s;
      m[s] = mm < p.M ? mm : -1;
      inside[s] = 0u;
      if (m[s] >= 0) {
        const int rem = mm % plane;
        const int i = rem / p.Wo, j = rem % p.Wo;
        for (int t = 0; t < 9; ++t) {
          const int hi = i + t / 3 - 1, wi = j + t % 3 - 1;
          if (hi >= 0 && hi < p.Ho && wi >= 0 && wi < p.Wo)
            inside[s] |= 1u << t;
        }
      }
      const int c = c0 + r + 32 * s;
      wc[s] = c < p.cin ? (long long)c * p.cout : -1;
    }
    k = kb + 8 * kc;
    tap = k / p.cout;
    n = k - tap * p.cout;
  }

  // start the copies of the next step (depths up to ke) into stage st:
  // 16-byte cp.async with zero fill (vec), else 2-byte loads and stores
  __device__ __forceinline__ void issue(const InArgs& a, __nv_bfloat16* st,
                                        int ke) {
    const BwdArgs& p = a.p;
    const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
    __nv_bfloat16* As = st;
    __nv_bfloat16* Bs = st + kTile * kRow;
    if (a.vec) {
      const bool live = k < ke;
      const int shift = (tap / 3 - 1) * p.Wo + tap % 3 - 1;
      const long long wt = (long long)(8 - tap) * p.cin * p.cout + n;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const bool ok = live && m[s] >= 0 && ((inside[s] >> tap) & 1u);
        mma::cp_async16(
            As + at + 32 * s * kRow,
            ok ? a.dyc + (long long)(m[s] + shift) * p.cout + n : a.dyc, ok);
        const bool okb = live && wc[s] >= 0;
        mma::cp_async16(Bs + at + 32 * s * kRow, okb ? w + wt + wc[s] : w,
                        okb);
      }
    } else {
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          __nv_bfloat16 av = __float2bfloat16_rn(0.0f), bv = av;
          const int kk = k + e;
          if (kk < ke) {
            const int t = kk / p.cout, nn = kk - t * p.cout;
            if (m[s] >= 0 && ((inside[s] >> t) & 1u))
              av = a.dyc[(long long)(m[s] + (t / 3 - 1) * p.Wo + t % 3 - 1) *
                             p.cout + nn];
            if (wc[s] >= 0)
              bv = w[(long long)(8 - t) * p.cin * p.cout + wc[s] + nn];
          }
          As[at + 32 * s * kRow + e] = av;
          Bs[at + 32 * s * kRow + e] = bv;
        }
    }
    k += kDepth;
    n += kDepth;
    while (n >= p.cout) {
      n -= p.cout;
      ++tap;
    }
  }
};

// The products of one 64 x 64 tile over `steps` steps of the stream `in`
// (depths up to ke), into acc (zeroed here): A and B rows of 32 depths
// each, staged by in.issue into a ring of kStages stages, which keeps
// kStages - 1 steps of copies in flight; both reach the MMAs by ldmatrix.
// S is Stream (the 3x3's taps) or mm_bwd.cuh's (the 1x1's rows).
template <class S>
__device__ __forceinline__ void mma_steps(const InArgs& a, S& in,
                                          __nv_bfloat16* ring, int ke,
                                          int steps, float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) in.issue(a, ring + st * kStageElems, ke);
    mma::cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    const __nv_bfloat16* As = ring + (st % kStages) * kStageElems;
    const __nv_bfloat16* Bs = As + kTile * kRow;
    mma::cp_async_wait<kStages - 2>();   // this thread's copies of step st
    __syncthreads();   // step st staged by all; step st - 1's readers done
    if (st + kStages - 1 < steps)
      in.issue(a, ring + ((st + kStages - 1) % kStages) * kStageElems, ke);
    mma::cp_async_commit();
#pragma unroll
    for (int ks = 0; ks < kDepth / 16; ++ks) {
      unsigned af[2][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mma::ldsm_x4(af[i], As + (wm + 16 * i + (lane & 15)) * kRow +
                                16 * ks + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        mma::ldsm_x4(bf[jp], Bs + (wn + 16 * jp + (lane & 7) +
                                   ((lane >> 4) << 3)) * kRow +
                                 16 * ks + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          mma::mma_bf16(acc[i][2 * jp], af[i], bf[jp][0], bf[jp][1]);
          mma::mma_bf16(acc[i][2 * jp + 1], af[i], bf[jp][2], bf[jp][3]);
        }
    }
  }
  mma::cp_async_wait<0>();
}

// bf16: one 64 x 64 tile of de over one K slice, into ws[slice].
__global__ void __launch_bounds__(kMmaThreads) dx_mma_kernel(InArgs a) {
  __shared__ __align__(16) __nv_bfloat16 ring[kStages * kStageElems];
  const BwdArgs& p = a.p;
  const int m0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const int kb = blockIdx.z * a.slice_depth;
  const int ke = min(9 * p.cout, kb + a.slice_depth);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  Stream in(p, m0, c0, kb);
  float acc[2][4][4];
  mma_steps(a, in, ring, ke, (ke - kb + kDepth - 1) / kDepth, acc);

  float* out = a.ws + (long long)blockIdx.z * p.M * p.cin;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + wn + 8 * j + 2 * t;
        float* o = out + (long long)m * p.cin + c;
        if (c + 1 < p.cin && (p.cin & 1) == 0) {
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          if (c < p.cin) o[0] = acc[i][j][2 * h];
          if (c + 1 < p.cin) o[1] = acc[i][j][2 * h + 1];
        }
      }
    }
}

// f32: the same tile and slice with conv_bwd.cuh's f32 FMA tile
__global__ void __launch_bounds__(kThreads) dx_fma_kernel(InArgs a) {
  __shared__ __align__(16) float As[kTileK][kPadM];
  __shared__ __align__(16) float Bs[kTileK][kTileN];
  const BwdArgs& p = a.p;
  const int m0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const int kb = blockIdx.z * a.slice_depth;
  const int ke = min(9 * p.cout, kb + a.slice_depth);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  tile_gemm(p, DycRows<float, true>(p, m0), WtCols<float, true>(p, c0), kb,
            ke, acc, As, Bs);
  float* out = a.ws + (long long)blockIdx.z * p.M * p.cin;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c < p.cin) out[(long long)m * p.cin + c] = acc[i][j];
    }
  }
}

// de = the planes summed in slice order, then the BN/ReLU backward and
// the (sum dpre * x, sum dpre) of each tile_rows-row tile. Thread (group,
// quad) takes columns 4 quad .. + 3 of rows group, group + 16, ... of the
// tile; the groups' sums are added in group order.
template <typename T>
__global__ void __launch_bounds__(kEpiThreads) dx_epilogue_kernel(InArgs a) {
  __shared__ float red[2][kEpiGroups][kEpiCols];
  const BwdArgs& p = a.p;
  const int quad = threadIdx.x % (kEpiCols / 4);
  const int grp = threadIdx.x / (kEpiCols / 4);
  const int cb = blockIdx.y * kEpiCols;
  const int c = cb + 4 * quad;
  const int r0 = blockIdx.x * a.tile_rows;
  const int r1 = min(p.M, r0 + a.tile_rows);
  const long long plane = (long long)p.M * p.cin;
  const T* x = static_cast<const T*>(p.x);
  T* dx = static_cast<T*>(p.dx);
  float sc[4], sh[4], cs[4], cq[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool live = c + j < p.cin && p.norm_in;
    sc[j] = live ? p.scale[c + j] : 0.0f;
    sh[j] = live ? p.shift[c + j] : 0.0f;
    cs[j] = cq[j] = 0.0f;
  }
  for (int m = r0 + grp; m < r1 && c < p.cin; m += kEpiGroups) {
    const long long i = (long long)m * p.cin + c;
    float de[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (a.epi_vec) {   // Cin % 4 == 0: the quad lies inside the row
#pragma unroll 8
      for (int s = 0; s < a.slices; ++s) {
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(a.ws + s * plane + i));
        de[0] += v.x;
        de[1] += v.y;
        de[2] += v.z;
        de[3] += v.w;
      }
    } else {
      for (int s = 0; s < a.slices; ++s)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < p.cin) de[j] += a.ws[s * plane + i + j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c + j >= p.cin) continue;
      if (!p.norm_in) {
        dx[i + j] = from_f32<T>(de[j]);
        continue;
      }
      const float xf = to_f32<T>(x[i + j]);
      const float pre = __fadd_rn(__fmul_rn(xf, sc[j]), sh[j]);
      const float dpre = (p.relu_in && !(pre > 0.0f)) ? 0.0f : de[j];
      dx[i + j] = from_f32<T>(__fmul_rn(dpre, sc[j]));
      cs[j] += dpre * xf;
      cq[j] += dpre;
    }
  }
  if (!p.norm_in) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][grp][4 * quad + j] = cs[j];
    red[1][grp][4 * quad + j] = cq[j];
  }
  __syncthreads();
  const int col = threadIdx.x;
  if (col < kEpiCols && cb + col < p.cin) {
    float s = 0.0f, q = 0.0f;
#pragma unroll
    for (int gi = 0; gi < kEpiGroups; ++gi) {
      s += red[0][gi][col];
      q += red[1][gi][col];
    }
    float* out = p.partial + (long long)blockIdx.x * 2 * p.cin;
    out[cb + col] = s;
    out[p.cin + cb + col] = q;
  }
}

// sums[0, c] and sums[1, c]: the epilogue's row tiles added in order
// (zeros without the normalize)
__global__ void __launch_bounds__(kEpiThreads) dx_sums_kernel(InArgs a) {
  const BwdArgs& p = a.p;
  const int c = blockIdx.x * kEpiThreads + threadIdx.x;
  if (c >= p.cin) return;
  const int tiles = (p.M + a.tile_rows - 1) / a.tile_rows;
  float s = 0.0f, q = 0.0f;
  for (int t = 0; p.norm_in && t < tiles; ++t) {
    s += p.partial[(long long)t * 2 * p.cin + c];
    q += p.partial[(long long)t * 2 * p.cin + p.cin + c];
  }
  a.sums[c] = s;
  a.sums[p.cin + c] = q;
}

using mma::aligned16;

// The plan's and buffers' checks (cudaErrorInvalidValue when they fail,
// else 0) and the copy flags, shared with c3_bwd.cuh's merged launch.
template <typename T>
inline int check_in(const InArgs& a) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs& p = a.p;
  const long long depth = 9LL * p.cout;
  if (p.M <= 0 || p.cin <= 0 || p.cout <= 0 || a.slices < 1 ||
      a.slice_depth <= 0 || a.slice_depth % kDepth != 0 ||
      (long long)a.slices * a.slice_depth < depth ||
      (long long)(a.slices - 1) * a.slice_depth >= depth ||
      a.tile_rows <= 0 || a.slices > 65535)
    return bad;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  if (p.dx == nullptr || a.ws == nullptr || a.sums == nullptr ||
      (p.norm_in && p.partial == nullptr) || (kBf16 && a.dyc == nullptr))
    return bad;
  if ((p.cin + kTile - 1) / kTile > 65535) return bad;
  return 0;
}

inline void set_flags(InArgs& a) {
  const BwdArgs& p = a.p;
  a.vec = p.cout % 8 == 0 && aligned16(a.dyc) && aligned16(p.w);
  a.dyc_vec = p.cout % 8 == 0 && aligned16(p.dy) && aligned16(p.y) &&
              aligned16(p.dst) && aligned16(a.dyc);
  a.epi_vec = p.cin % 4 == 0 && aligned16(a.ws);
}

// dyc (bf16) and the K-sliced product into the planes of ws
template <typename T>
inline int launch_in_product(const InArgs& a, cudaStream_t stream) {
  const BwdArgs& p = a.p;
  const dim3 grid((p.M + kTile - 1) / kTile, (p.cin + kTile - 1) / kTile,
                  a.slices);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const long long chunks = ((long long)p.M * p.cout + 7) / 8;
    const long long blocks = (chunks + kEpiThreads - 1) / kEpiThreads;
    dyc_kernel<<<static_cast<unsigned>(blocks < 1024 ? blocks : 1024),
                 kEpiThreads, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dx_mma_kernel<<<grid, kMmaThreads, 0, stream>>>(a);
  } else {
    dx_fma_kernel<<<grid, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// the planes added in slice order with the BN/ReLU backward, then the sums
template <typename T>
inline int launch_in_epilogue(const InArgs& a, cudaStream_t stream) {
  const BwdArgs& p = a.p;
  const dim3 egrid((p.M + a.tile_rows - 1) / a.tile_rows,
                   (p.cin + kEpiCols - 1) / kEpiCols);
  dx_epilogue_kernel<T><<<egrid, kEpiThreads, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dx_sums_kernel<<<(p.cin + kEpiThreads - 1) / kEpiThreads, kEpiThreads, 0,
                   stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Every kernel on `stream`; returns cudaGetLastError() (an invalid plan or
// shape: cudaErrorInvalidValue, nothing launched).
template <typename T>
inline int launch_bwd_in(InArgs a, cudaStream_t stream) {
  int err = check_in<T>(a);
  if (err != 0) return err;
  set_flags(a);
  err = launch_in_product<T>(a, stream);
  if (err != 0) return err;
  return launch_in_epilogue<T>(a, stream);
}

}  // namespace bwd_in
}  // namespace dl4j
