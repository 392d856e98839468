// fused_mm_bwd in bf16 on Hopper's tensor cores (sm_90a): the backward of
// the 1x1 conv + BatchNorm. Replaces, for bf16 inputs, the TPU kernel
// deeplearning4j_tpu/ops/fused_conv.py:_bwd_merged_kernel (f32 keeps
// conv_bwd.cuh's merged FMA kernel). Per dy row m = (n, ho, wo), input
// pixel (n, ho s, wo s), channel c of Cin and n of Cout:
//
//   dyc = dy + dS + 2 y dS2, rounded to bf16 (written once)
//   de[m, c] = sum over n of dyc[m, n] W[c, n] in f32        (dx product)
//   dpre = de where pre = x * scale + shift > 0 (ReLU), dx = dpre * scale
//     in bf16 at the stride-grid pixel, zeros at the pixels off the grid;
//     partial[tile, 0, c] = sum dpre * x, partial[tile, 1, c] = sum dpre
//   dW[c, n] = sum over m of e[m, c] dyc[m, n] in f32        (dW product)
//     e = relu?(x * scale + shift) at the stride-grid pixel, bf16
//   norm_in = 0 (the block's W1 and Wds): e = x, dx = de, no sums.
//
// What bounds it on this card. Two products of 2 M Cin Cout FLOP each
// against dy, y, the M strided rows of x and W read once and dx, dW written
// once: at the ResNet50's 1x1 shapes (batch 32) 34-540 MFLOP against 0.5-9
// MB, so bytes bound every call (0.2-2.7 us). The FMA version (conv_bwd.cuh)
// ran 49x above that: f32 FMA on 64 x 64 x 16 tiles, dyc rebuilt per element
// from two scalar loads in both products (Cin / 64 times each), and a dx
// tile walking the whole Cout depth alone (32 tiles at the stage-3
// projection, depth 2048, while the other SMs waited).
// What this design does about it, in three launches:
//   * dyc once, as bf16, by c3_bwd_in.cuh's dyc_kernel;
//   * one grid for both products (mma.sync m16n8k16, bf16 x bf16, f32 sums,
//     64 x 64 tiles, 4 warps of 32 x 32):
//     - dx tiles (M x Cin) with the Cout depth cut into the slices of
//       ops/fused_conv.py:mm_bwd_plan (at most 8, about two blocks per SM),
//       the slices of a tile run as one thread-block cluster. A is dyc and B
//       W's rows (each contiguous in Cout), both by 16-byte cp.async into
//       c3_bwd_in.cuh's 4-stage ring (mma_steps). Each slice parks its f32
//       tile in shared memory; each block then adds the cluster's tiles in
//       slice order over a band of rows (distributed shared memory), runs
//       the BN/ReLU backward, writes dx on the stride grid and zeros off it
//       (so the wrapper's dx needs no memset), and rank 0 adds the bands'
//       sums in order into the tile's partial sums. A thread takes 4
//       columns of up to 8 rows and gathers all of them (tiles and x, by
//       8-byte loads) before it writes any: with one row at a time, each a
//       dependent global load and store, the epilogue bound the unsplit
//       calls of batch 128 (M 32768: 0.10 ms a call, 8x their bound);
//     - dW tiles (Cin x Cout) over pixel slices of whole 32-pixel steps
//       (mm_bwd_plan), c3_bwd.cuh's dw_tile with MmERows below: e from
//       16-byte loads of x at the stride-grid pixel, normalized in
//       registers, dyc by cp.async, both through ldmatrix.trans;
//   * a finish kernel adds the dW planes in slice order and the tiles'
//     partial sums in one fixed order (zeros without the normalize);
//   * 2-byte staging where Cin % 8, Cout % 8 or a pointer's alignment rules
//     out 16-byte copies: the same kernels, selected by flags;
//   * no float atomics: every sum has one fixed order, so two calls on the
//     same inputs give the same bits.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "c3_bwd.cuh"

namespace dl4j {
namespace mm_bwd {

using bwd_in::InArgs;
constexpr int kTile = 64;
constexpr int kDepth = bwd_in::kDepth;   // depth of one staged step
constexpr int kRow = bwd_in::kRow;        // dx ring rows: 32 depths + pad
constexpr int kAccRow = kTile + 4;        // f32 row stride of a parked tile
constexpr int kMaxSlices = 8;             // dx slices of a tile: a cluster
constexpr int kThreads = bwd_in::kMmaThreads;
constexpr int kFinThreads = 256;          // finish kernel: 8 warps
constexpr int kSumCols = 32;              // channels of one sums block
constexpr int kQuads = kTile / 4;         // dx epilogue: column quads
constexpr int kGroups = kThreads / kQuads;  // and row groups
constexpr int kRowsMax = kTile / kGroups;   // rows of a thread (unsplit)
static_assert(kTile == bwd_in::kTile && kTile == c3_bwd::kTile,
              "one tile for both products");

// The A (dyc rows) and B (W rows) of the dx product: this thread's depths
// k .. k + 7 (k = step start + 8 (tid % 4)) of rows (tid / 4) + 32 s.
struct DxStream {
  long long am[2];  // element offset m * Cout of the dyc rows, -1 past M
  long long wc[2];  // element offset c * Cout of the W rows, -1 past Cin
  int k, at;        // the next step's depth; shared offset of row s = 0

  __device__ DxStream(const BwdArgs& p, int m0, int c0, int kb) {
    const int kc = threadIdx.x & 3;
    const int r = threadIdx.x >> 2;
    at = r * kRow + 8 * kc;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int m = m0 + r + 32 * s, c = c0 + r + 32 * s;
      am[s] = m < p.M ? (long long)m * p.cout : -1;
      wc[s] = c < p.cin ? (long long)c * p.cout : -1;
    }
    k = kb + 8 * kc;
  }

  // the copies of the next step (depths up to ke) into ring stage st:
  // 16-byte cp.async with zero fill (vec), else 2-byte loads and stores
  __device__ __forceinline__ void issue(const InArgs& a, __nv_bfloat16* st,
                                        int ke) {
    const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.p.w);
    __nv_bfloat16* As = st;
    __nv_bfloat16* Bs = st + kTile * kRow;
    if (a.vec) {
      const bool live = k < ke;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const bool ok = live && am[s] >= 0, okb = live && wc[s] >= 0;
        mma::cp_async16(As + at + 32 * s * kRow,
                        ok ? a.dyc + am[s] + k : a.dyc, ok);
        mma::cp_async16(Bs + at + 32 * s * kRow, okb ? w + wc[s] + k : w,
                        okb);
      }
    } else {
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int kk = k + e;
          As[at + 32 * s * kRow + e] =
              kk < ke && am[s] >= 0 ? a.dyc[am[s] + kk] : zero;
          Bs[at + 32 * s * kRow + e] =
              kk < ke && wc[s] >= 0 ? w[wc[s] + kk] : zero;
        }
    }
    k += kDepth;
  }
};

// The A side of the dW tile (rows: Cin channels): this thread's channels
// c .. c + 7 (c = r0 + 8 (tid % 8)) at its dy pixels p and p + 16 of each
// step (p = tid / 8), read at their stride-grid input pixels. The pixels
// are tracked as (flat index, image, row, column) and advance by addition.
struct MmERows {
  int c;
  bool rows_ok;      // 16-byte path and c inside Cin
  float sc[8], sh[8];
  int m[2], img[2], i[2], j[2];
  int Ho, dimg, di, dj;  // one step of kDepth pixels: images, rows, columns
  unsigned ok;       // bit s: chunk s was loaded
  uint4 v[2];

  __device__ MmERows(const c3_bwd::DwArgs& d, int r0, int kb) {
    c = r0 + 8 * (threadIdx.x & 7);
    rows_ok = d.a_vec && c < d.rows;
    if (rows_ok && d.norm_in) {
      mma::ldg_f8(sc, d.scale + c);
      mma::ldg_f8(sh, d.shift + c);
    }
    Ho = d.plane / d.Wo;
    const int p = threadIdx.x >> 3;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      m[s] = kb + p + 16 * s;
      img[s] = m[s] / d.plane;
      const int rem = m[s] - img[s] * d.plane;
      i[s] = rem / d.Wo;
      j[s] = rem - i[s] * d.Wo;
    }
    dimg = kDepth / d.plane;
    const int step = kDepth - dimg * d.plane;
    di = step / d.Wo;
    dj = step - di * d.Wo;
    ok = 0u;
  }

  // element offset of pixel s's input pixel (channel 0)
  __device__ __forceinline__ long long pixel(const c3_bwd::DwArgs& d,
                                             int s) const {
    return (((long long)img[s] * d.H + i[s] * d.stride) * d.W +
            j[s] * d.stride) * d.cin;
  }

  // the current step's x chunks (16-byte path) inside the slice
  __device__ __forceinline__ void load(const c3_bwd::DwArgs& d, int ke) {
    ok = 0u;
    if (!rows_ok) return;
#pragma unroll
    for (int s = 0; s < 2; ++s)
      if (m[s] < ke) {
        v[s] = __ldg(reinterpret_cast<const uint4*>(d.x + pixel(d, s) + c));
        ok |= 1u << s;
      }
  }

  // the current step's e into A buffer a (zeros past the slice), then the
  // next step's pixels; the 2-byte path loads here, element by element
  __device__ __forceinline__ void store(const c3_bwd::DwArgs& d,
                                        __nv_bfloat16* a, int ke) {
    const int p = threadIdx.x >> 3, q8 = 8 * (threadIdx.x & 7);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      __nv_bfloat16* dst = a + (p + 16 * s) * c3_bwd::kRow + q8;
      if (d.a_vec) {
        uint4 out = make_uint4(0u, 0u, 0u, 0u);
        if ((ok >> s) & 1u)
          out = d.norm_in ? mma::norm_relu8(v[s], sc, sh, d.relu_in) : v[s];
        *reinterpret_cast<uint4*>(dst) = out;
      } else {
        const long long px = m[s] < ke ? pixel(d, s) : -1;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float val = 0.0f;
          const int cc = c + e;
          if (cc < d.rows && px >= 0) {
            val = __bfloat162float(d.x[px + cc]);
            if (d.norm_in)
              val = mma::norm_relu(val, d.scale[cc], d.shift[cc], d.relu_in);
          }
          dst[e] = __float2bfloat16_rn(val);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      m[s] += kDepth;
      j[s] += dj;
      int carry = 0;
      if (j[s] >= d.Wo) {
        j[s] -= d.Wo;
        carry = 1;
      }
      i[s] += di + carry;
      img[s] += dimg;
      if (i[s] >= Ho) {
        i[s] -= Ho;
        ++img[s];
      }
    }
  }
};

__host__ __device__ inline bool aligned8(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 7u) == 0;
}

struct BwdPlan {
  InArgs a;            // the dx product: slices = the cluster's size
  c3_bwd::DwArgs d;    // the dW product
  int dx_tiles_c;      // column tiles of dx (Cin / 64)
  int dx_blocks;       // dx tiles x slices: the grid's first blocks
  int dw_rt, dw_nt;    // dW tiles: rows (Cin), columns (Cout)
  int dw_blocks;       // dW tiles x pixel slices
  int dw_first;        // the dW blocks come first (their slices are deeper)
  int dw_span;         // dw_blocks rounded up to a whole cluster
  int epi_vec;         // 8-byte x and dx in the dx epilogue
};

// Shared memory of a products block: the dx ring (whose first bytes then
// hold the parked f32 tile) or the dW tile's staging
constexpr int kRingBytes =
    sizeof(__nv_bfloat16) * bwd_in::kStages * bwd_in::kStageElems;
constexpr int kDwBytes = sizeof(__nv_bfloat16) * c3_bwd::kDwElems;
constexpr int kSmemBytes = kRingBytes > kDwBytes ? kRingBytes : kDwBytes;
static_assert(4 * kTile * kAccRow <= kSmemBytes, "the parked tile fits");

// One (64-row, 64-column) dx tile over its K slice `rank` of the Cout depth
// (block b of the grid's dx part: tile b / slices), then its epilogue: the
// cluster's f32 tiles added in slice order over this block's band of rows,
// the BN/ReLU backward, dx on and off the stride grid, and the tile's
// (sum dpre x, sum dpre) in one fixed order.
__device__ __forceinline__ void dx_tile(const BwdPlan& q, unsigned char* smem,
                                        float (*red)[kGroups][kTile],
                                        float (*band_sums)[kTile], int b) {
  namespace cg = cooperative_groups;
  const InArgs& a = q.a;
  const BwdArgs& p = a.p;
  const int slices = a.slices;
  const int tile = b / slices, rank = b - tile * slices;
  const int tm = tile / q.dx_tiles_c;
  const int m0 = tm * kTile, c0 = (tile - tm * q.dx_tiles_c) * kTile;
  const int kb = rank * a.slice_depth;
  const int ke = min(p.cout, kb + a.slice_depth);
  DxStream in(p, m0, c0, kb);
  float acc[2][4][4];
  bwd_in::mma_steps(a, in, reinterpret_cast<__nv_bfloat16*>(smem), ke,
                    (ke - kb + kDepth - 1) / kDepth, acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
  float* tile_acc = reinterpret_cast<float*>(smem);
  __syncthreads();  // every warp's last read of the ring is done
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float2*>(
            tile_acc + (wm + 16 * i + g + 8 * h) * kAccRow + wn + 8 * j +
            2 * t) = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  cg::cluster_group cluster = cg::this_cluster();
  const float* part[kMaxSlices];
  if (slices > 1) {
    cluster.sync();  // every slice's tile is parked
#pragma unroll
    for (int sl = 0; sl < kMaxSlices; ++sl)
      part[sl] = sl < slices ? cluster.map_shared_rank(tile_acc, sl)
                             : tile_acc;
  } else {
    __syncthreads();
#pragma unroll
    for (int sl = 0; sl < kMaxSlices; ++sl) part[sl] = tile_acc;
  }

  // thread (group, quad): columns 4 quad .. + 3 of rows band start +
  // group + kGroups i. Each thread gathers all its rows (the slices' f32
  // tiles and x) before it writes any, so their loads overlap.
  const int band = (kTile + slices - 1) / slices;
  const int rb = rank * band, r1 = min(kTile, rb + band);
  const int quad = threadIdx.x % kQuads, grp = threadIdx.x / kQuads;
  const int col = 4 * quad, c = c0 + col;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  __nv_bfloat16* dx = static_cast<__nv_bfloat16*>(p.dx);
  const bool vec = q.epi_vec;   // 8-byte x and dx (Cin % 4 == 0, aligned)
  float sc[4], sh[4], cs[4], cq[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool ok = c + j < p.cin && p.norm_in;
    sc[j] = ok ? p.scale[c + j] : 0.0f;
    sh[j] = ok ? p.shift[c + j] : 0.0f;
    cs[j] = cq[j] = 0.0f;
  }
  const int plane = p.Ho * p.Wo;
  long long off[kRowsMax];   // element offset of (pixel, c), -1: no row
  float de[kRowsMax][4], xf[kRowsMax][4];
#pragma unroll
  for (int i = 0; i < kRowsMax; ++i) {
    const int r = rb + grp + kGroups * i;
    const int m = m0 + r;
    off[i] = -1;
    if (r >= r1 || m >= p.M || c >= p.cin) continue;
    const int n = m / plane, rem = m - n * plane;
    const int ho = rem / p.Wo, wo = rem - ho * p.Wo;
    off[i] = (((long long)n * p.H + ho * p.stride) * p.W + wo * p.stride) *
                 p.cin + c;
    float4 v = *reinterpret_cast<const float4*>(part[0] + r * kAccRow + col);
#pragma unroll
    for (int sl = 1; sl < kMaxSlices; ++sl)
      if (sl < slices) {
        const float4 w4 =
            *reinterpret_cast<const float4*>(part[sl] + r * kAccRow + col);
        v.x += w4.x;
        v.y += w4.y;
        v.z += w4.z;
        v.w += w4.w;
      }
    de[i][0] = v.x;
    de[i][1] = v.y;
    de[i][2] = v.z;
    de[i][3] = v.w;
    if (!p.norm_in) continue;
    if (vec) {
      const uint2 xv = __ldg(reinterpret_cast<const uint2*>(x + off[i]));
      const __nv_bfloat16* x4 = reinterpret_cast<const __nv_bfloat16*>(&xv);
#pragma unroll
      for (int j = 0; j < 4; ++j) xf[i][j] = __bfloat162float(x4[j]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xf[i][j] = c + j < p.cin ? __bfloat162float(__ldg(x + off[i] + j))
                                 : 0.0f;
    }
  }
  const uint2 zeros = make_uint2(0u, 0u);
#pragma unroll
  for (int i = 0; i < kRowsMax; ++i) {
    if (off[i] < 0) continue;
    float out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[j] = de[i][j];
      if (p.norm_in) {
        const float pre = __fadd_rn(__fmul_rn(xf[i][j], sc[j]), sh[j]);
        const float dpre = (p.relu_in && !(pre > 0.0f)) ? 0.0f : de[i][j];
        out[j] = __fmul_rn(dpre, sc[j]);
        if (c + j < p.cin) {
          cs[j] += dpre * xf[i][j];
          cq[j] += dpre;
        }
      }
    }
    // dx at the stride-grid pixel, then zeros at the pixels of its stride
    // cell off the grid
    const int m = m0 + rb + grp + kGroups * i;
    const int rem = m % plane, ho = rem / p.Wo;
    const int hi = ho * p.stride, wi = (rem - ho * p.Wo) * p.stride;
    for (int di = 0; di < p.stride && hi + di < p.H; ++di)
      for (int dj = 0; dj < p.stride && wi + dj < p.W; ++dj) {
        __nv_bfloat16* o = dx + off[i] + ((long long)di * p.W + dj) * p.cin;
        const bool grid = di == 0 && dj == 0;
        if (vec) {
          *reinterpret_cast<uint2*>(o) =
              grid ? make_uint2(mma::pack_bf16(out[0], out[1]),
                                mma::pack_bf16(out[2], out[3]))
                   : zeros;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < p.cin)
              o[j] = __float2bfloat16_rn(grid ? out[j] : 0.0f);
        }
      }
  }
  if (p.norm_in) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[0][grp][col + j] = cs[j];
      red[1][grp][col + j] = cq[j];
    }
    __syncthreads();
    if (threadIdx.x < kTile) {
      const int u = threadIdx.x;
      float su = 0.0f, sq = 0.0f;
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        su += red[0][gi][u];
        sq += red[1][gi][u];
      }
      band_sums[0][u] = su;
      band_sums[1][u] = sq;
    }
  }
  const int u = threadIdx.x;
  const bool live = u < kTile && c0 + u < p.cin;
  if (slices == 1) {
    if (!p.norm_in) return;
    __syncthreads();
    if (live) {
      float* o = p.partial + (long long)tm * 2 * p.cin;
      o[c0 + u] = band_sums[0][u];
      o[p.cin + c0 + u] = band_sums[1][u];
    }
    return;
  }
  cluster.sync();  // the tiles are read and the band sums written
  if (!p.norm_in) return;
  if (rank == 0 && live) {
    float ts = 0.0f, tq = 0.0f;
    for (int sl = 0; sl < slices; ++sl) {
      const float* bs = cluster.map_shared_rank(&band_sums[0][0], sl);
      ts += bs[u];
      tq += bs[kTile + u];
    }
    float* o = p.partial + (long long)tm * 2 * p.cin;
    o[c0 + u] = ts;
    o[p.cin + c0 + u] = tq;
  }
  cluster.sync();  // rank 0's reads of the band sums are done
}

// Both products in one grid: the dx tiles' blocks (in clusters of `slices`
// when the depth is split) and the dW tiles', the part whose blocks walk
// more steps first, so that the deep blocks do not form the grid's tail;
// the dW part is padded to a whole cluster. At most 128 registers a thread,
// so that 4 blocks fit an SM (uncapped, the compiler takes 160: 3 blocks).
__global__ void __launch_bounds__(kThreads, 4) products_kernel(BwdPlan q) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  __shared__ float red[2][kGroups][kTile];
  __shared__ float band_sums[2][kTile];
  int b = blockIdx.x;   // renumbered as if the dx blocks came first
  if (q.dw_first) b = b < q.dw_span ? q.dx_blocks + b : b - q.dw_span;
  if (b < q.dx_blocks) {
    dx_tile(q, smem, red, band_sums, b);
    return;
  }
  b -= q.dx_blocks;
  if (b >= q.dw_blocks) return;
  const int per = q.dw_rt * q.dw_nt;
  const int bz = b / per;
  b -= bz * per;
  c3_bwd::dw_tile<MmERows>(q.d, reinterpret_cast<__nv_bfloat16*>(smem),
                           b % q.dw_rt, b / q.dw_rt, bz);
}

// dw = the dW planes added in slice order (blocks below dw_blocks, when
// there are several planes), then (dscale, dshift) = the dx tiles' partial
// sums added in one fixed order (the others: kSumCols channels a block,
// each warp a contiguous run of tiles, the warps in order; zeros without
// the normalize).
__global__ void __launch_bounds__(kFinThreads)
    finish_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                  long long len, int dw_slices, int dw_blocks,
                  const float* __restrict__ partial, float* __restrict__ sums,
                  int cin, int tiles) {
  if (static_cast<int>(blockIdx.x) < dw_blocks) {
    for (long long i = blockIdx.x * (long long)kFinThreads + threadIdx.x;
         i < len; i += (long long)dw_blocks * kFinThreads) {
      float v = 0.0f;
#pragma unroll 8
      for (int s = 0; s < dw_slices; ++s) v += ws[s * len + i];
      dw[i] = v;
    }
    return;
  }
  __shared__ float red[2][kFinThreads / 32][kSumCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = (blockIdx.x - dw_blocks) * kSumCols + lane;
  constexpr int kWarps = kFinThreads / 32;
  const int per = (tiles + kWarps - 1) / kWarps;
  const int t1 = min(tiles, (warp + 1) * per);
  float s = 0.0f, q = 0.0f;
  if (c < cin) {
#pragma unroll 4
    for (int t = warp * per; t < t1; ++t) {
      s += partial[(long long)t * 2 * cin + c];
      q += partial[(long long)t * 2 * cin + cin + c];
    }
  }
  red[0][warp][lane] = s;
  red[1][warp][lane] = q;
  __syncthreads();
  if (warp == 0 && c < cin) {
    float ts = 0.0f, tq = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ts += red[0][w][lane];
      tq += red[1][w][lane];
    }
    sums[c] = ts;
    sums[cin + c] = tq;
  }
}

// The whole bf16 backward on `stream`: dyc, both products, the finish.
// dw: (Cin, Cout) f32; dw_ws: (ceil(M / dw_chunk), Cin, Cout) f32 planes,
// or null when that is 1; p.partial: (ceil(M / 64), 2, Cin) f32 when
// norm_in; sums: (2, Cin) f32; dyc: (M, Cout) bf16, 16-byte aligned.
// Returns cudaGetLastError() (an invalid plan or shape:
// cudaErrorInvalidValue, nothing launched).
inline int launch_bwd(const BwdArgs& p, float* dw, float* dw_ws, float* sums,
                      __nv_bfloat16* dyc, int dw_chunk, int slices,
                      int slice_depth, cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (p.M <= 0 || p.cin <= 0 || p.cout <= 0 || slices < 1 ||
      slices > kMaxSlices || slice_depth <= 0 || slice_depth % kDepth != 0 ||
      (long long)slices * slice_depth < p.cout ||
      (long long)(slices - 1) * slice_depth >= p.cout || dw_chunk <= 0 ||
      dw_chunk % kDepth != 0)
    return bad;
  const int dw_slices = (p.M + dw_chunk - 1) / dw_chunk;
  if (p.dx == nullptr || dw == nullptr || sums == nullptr ||
      dyc == nullptr || (p.norm_in && p.partial == nullptr) ||
      (dw_slices > 1 && dw_ws == nullptr))
    return bad;
  BwdPlan q{};
  q.a.p = p;
  q.a.dyc = dyc;
  q.a.sums = sums;
  q.a.slices = slices;
  q.a.slice_depth = slice_depth;
  q.a.tile_rows = kTile;
  bwd_in::set_flags(q.a);
  c3_bwd::DwArgs& d = q.d;
  d.x = static_cast<const __nv_bfloat16*>(p.x);
  d.dyc = dyc;
  d.scale = p.scale;
  d.shift = p.shift;
  d.out = dw_slices > 1 ? dw_ws : dw;
  d.H = p.H;
  d.W = p.W;
  d.cin = p.cin;
  d.cout = p.cout;
  d.M = p.M;
  d.rows = p.cin;
  d.norm_in = p.norm_in;
  d.relu_in = p.relu_in;
  d.chunk = dw_chunk;
  d.a_vec = p.cin % 8 == 0 && mma::aligned16(p.x) &&
            mma::aligned16(p.scale) && mma::aligned16(p.shift);
  d.b_vec = p.cout % 8 == 0 && mma::aligned16(dyc);
  d.Wo = p.Wo;
  d.plane = p.Ho * p.Wo;
  d.stride = p.stride;
  const long long tiles_m = (p.M + kTile - 1) / kTile;
  q.dx_tiles_c = (p.cin + kTile - 1) / kTile;
  q.dw_rt = q.dx_tiles_c;
  q.dw_nt = (p.cout + kTile - 1) / kTile;
  const long long dx_blocks = tiles_m * q.dx_tiles_c * slices;
  const long long dw_blocks = (long long)q.dw_rt * q.dw_nt * dw_slices;
  const long long dw_span = (dw_blocks + slices - 1) / slices * slices;
  const long long blocks = dx_blocks + dw_span;
  if (blocks > 0x7fffffffLL) return bad;
  q.dx_blocks = static_cast<int>(dx_blocks);
  q.dw_blocks = static_cast<int>(dw_blocks);
  q.dw_span = static_cast<int>(dw_span);
  q.dw_first = dw_chunk > slice_depth;   // steps of 32 pixels vs depths
  q.epi_vec = p.cin % 4 == 0 && aligned8(p.x) && aligned8(p.dx);

  const int dyc_err = bwd_in::launch_dyc(q.a, stream);
  if (dyc_err != 0) return dyc_err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = slices;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = slices > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, products_kernel, q);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long len = (long long)p.cin * p.cout;
  const long long lb = (len + kFinThreads - 1) / kFinThreads;
  const int fin_dw = dw_slices > 1 ? static_cast<int>(lb < 1024 ? lb : 1024)
                                   : 0;
  const int fin_sums = (p.cin + kSumCols - 1) / kSumCols;
  finish_kernel<<<fin_dw + fin_sums, kFinThreads, 0, stream>>>(
      dw_ws, dw, len, dw_slices, fin_dw, p.partial, sums, p.cin,
      p.norm_in ? static_cast<int>(tiles_m) : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mm_bwd
}  // namespace dl4j
