// lstm_bwd: the reverse-time backward of one fused LSTM layer call in one
// launch.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_lstm.py:_bwd_kernel
// (via _fused_backward): walking t from T-1 down to 0 with f32 (dh, dc),
// dz = the four gate pre-activation gradients from dh + dys[t], dc and the
// saved residuals; dzx[t] = dz; dWh += hprev[t]^T . round(dz, hprev.dtype);
// dh = (1-m)*dh + round(dz, Wh.dtype) . Wh^T; dc = (1-m)*dc + dc_raw*f;
// returns dh0 and dc0. hprev and cprev are built by the caller.
//
// What bounds it on the H100. Inputs read once (dys, tcs, cprev, hprev:
// 4*T*N*H; gates: T*N*4H; Wh) and outputs written once (dzx T*N*4H, dWh
// f32): about 113 MB at T=60, N=128, H=256 in f32, 34 us at 3.35 TB/s.
// Two products of 2*T*N*H*4H FLOP each, 8.1 GFLOP there, 120 us at
// 67 TF/s f32. As in the forward, the T sequential ticks, each ending at
// a grid-wide barrier, set a latency floor beneath both.
//
// What the design does about it. The grid is (unit slices) x (row tiles),
// as in the forward: block (s, r) owns U hidden units (their four gate
// columns q*H + u) and RB batch rows, and the plan (ops/fused_lstm.py:
// lstm_bwd_plan) takes the widest U whose columns of Wh fit in shared
// memory, so few slices exist. Per reverse tick only the recurrence runs:
//   1. dz of the block's rows and units, from inputs that cp.async brought
//      into shared memory during the previous tick; dzx[t] is written;
//   2. the block's partial dh = dz[:, own 4U columns] . Wh[:, own]^T for
//      ALL H units, an f32 register-tiled product (8 rows x 4 units a
//      thread; the 4U depth split over thread groups where the tile is
//      small, the groups added in order), written to the exchange: one
//      (N, H) f32 plane per slice, H wide where the old exchange of dz was
//      4H wide (and each block re-read its rows' whole dz);
//   3. the grid barrier;
//   4. each block adds its units' columns of every slice's plane, in slice
//      order, read through L2 (ld.global.cg).
// dWh no longer rides the ticks: dzx already holds round(dz, T), and T is
// hprev's dtype, so after the last tick the same launch forms
// dWh = hprev^T . dzx over the whole (T*N) depth as tiles shared out over
// every block (128 x 128; bf16: mma.sync m16n8k16 from ldmatrix.trans;
// f32: f32 FMA in 8 x 8 register tiles, no TF32), staged by a
// 4-stage cp.async ring in the shared memory the ticks no longer need;
// where tiles are fewer than blocks the depth is cut into dw_splits slices
// whose f32 planes are added in slice order after one more barrier. No float
// atomics: every sum has one order, so two calls give the same bits.
// Built with nvcc into a shared library with a plain C interface and
// called through ctypes (ops/fused_lstm.py:lstm_bwd). LSTM_PROBE(k) marks
// the phases for tools/port_probe.py's clock64() breakdown (with
// LSTM_PROBE_START and _END); they compile to nothing here.
#include <type_traits>

#include "lstm.cuh"
#include "mma.cuh"

#ifndef LSTM_PROBE
#define LSTM_PROBE_START()
#define LSTM_PROBE(k)
#define LSTM_PROBE_END()
#endif

namespace dl4j {
namespace lstm {

struct BwdParams {
  const void* dys;    // (T, N, H) T
  const void* dhT;    // (N, H) S
  const void* dcT;    // (N, H) S
  const void* gates;  // (T, N, 4H) T
  const void* tcs;    // (T, N, H) T
  const void* cprev;  // (T, N, H) T
  const void* hprev;  // (T, N, H) T
  const void* mask;   // (T, N) T or null
  const void* wh;     // (H, 4H) T
  void* dzx;          // (T, N, 4H) T
  float* dwh;         // (H, 4H) f32
  void* dh0;          // (N, H) S
  void* dc0;          // (N, H) S
  float* xbuf;        // (2, slices, N, HP) f32: each slice's dh partials
  float* ws;          // (dw_splits, H, 4H) f32 dWh planes, when above 1
  int t_len, n, h;
  int U, RB, slices, groups;  // the plan
  int lu;                     // U = 1 << lu
  int dw_chunk, dw_splits;
  int HP, RBP, WS;            // H and RB rounded up to 4 and 8; Wh^T stride
  int vec;     // 16-byte cp.async staging of the tick inputs
  int dw_vec;  // and of dWh's operands
};

constexpr int kRowTile = 8;    // rows of one thread's per-tick product tile
// dWh tiles: rows (k) x columns (4H); each staged (T*N) step's depth and
// the shared row strides (16-byte rows) in f32 and bf16; the cp.async
// ring's depth
constexpr int kDwTile = 128;
constexpr int kDwF32Depth = 16, kDwF32Row = kDwTile + 4;
constexpr int kDwBf16Depth = 32, kDwBf16Row = kDwTile + 8;
constexpr int kDwStages = 4;
constexpr int kDwStep = 32;    // dw_chunk is a multiple of this

// Byte offsets of the shared-memory regions (each 16-byte aligned). The
// dWh staging reuses the memory from offset 0 once the ticks are done.
struct BwdSmem {
  size_t wt, dzl, dh, dc, mk, in, part, total;
};

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) / 16 * 16;
}

template <typename T>
__host__ __device__ inline BwdSmem bwd_smem(int U, int RB, int RBP, int WS,
                                            int HP, int groups) {
  BwdSmem s;
  size_t o = 0;
  s.wt = o;   o += align16(sizeof(float) * 4 * U * static_cast<size_t>(WS));
  s.dzl = o;  o += align16(sizeof(float) * 4 * U * static_cast<size_t>(RBP));
  s.dh = o;   o += align16(sizeof(float) * static_cast<size_t>(RB) * U);
  s.dc = o;   o += align16(sizeof(float) * static_cast<size_t>(RB) * U);
  s.mk = o;   o += align16(sizeof(float) * 2 * static_cast<size_t>(RBP));
  s.in = o;   o += align16(sizeof(T) * 2 * static_cast<size_t>(RB) * 7 * U);
  s.part = o;
  if (groups > 1)
    o += align16(sizeof(float) * groups * static_cast<size_t>(RBP) * HP);
  const size_t dw =
      std::is_same<T, float>::value
          ? sizeof(float) * kDwStages * 2 * kDwF32Depth * kDwF32Row
          : sizeof(__nv_bfloat16) * kDwStages * 2 * kDwBf16Depth * kDwBf16Row;
  s.total = o > dw ? o : dw;
  return s;
}

// a bf16 written earlier in this launch by another block: through L2
__device__ __forceinline__ float load_cg(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// The inputs of tick t (gates, dys, tcs, cprev of the block's rows and
// units) into buffer `dst` as [r][gate q: U | dys: U | tcs: U | cprev: U]:
// 16-byte cp.async when p.vec (every chunk wholly inside or outside the
// block's units), else element by element; zeros outside.
template <typename T>
__device__ __forceinline__ void issue_inputs(const BwdParams& p, T* dst,
                                             int t, int r0, int nr, int u0,
                                             int nu) {
  const int U = p.U, N = p.n, H = p.h;
  const size_t H4 = 4 * static_cast<size_t>(H);
  const T* g = static_cast<const T*>(p.gates);
  auto src_of = [&](int r, int sg, int u) -> const T* {
    const size_t row = static_cast<size_t>(t) * N + r0 + r;
    if (sg < 4) return g + row * H4 + sg * H + u0 + u;
    const void* base = sg == 4 ? p.dys : sg == 5 ? p.tcs : p.cprev;
    return static_cast<const T*>(base) + row * H + u0 + u;
  };
  if (p.vec) {
    constexpr int E = 16 / sizeof(T);
    const int lc = p.lu - (sizeof(T) == 4 ? 2 : 3);   // U / E = 1 << lc
    const int total = p.RB * 7 << lc;
    for (int o = threadIdx.x; o < total; o += blockDim.x) {
      const int rs = o >> lc, r = rs / 7, sg = rs - 7 * r;
      const int u = (o & ((1 << lc) - 1)) * E;
      const bool ok = r < nr && u < nu;
      mma::cp_async16(dst + rs * U + u,
                      ok ? static_cast<const void*>(src_of(r, sg, u)) : g,
                      ok);
    }
    return;
  }
  const int total = p.RB * 7 * U;
  for (int o = threadIdx.x; o < total; o += blockDim.x) {
    const int rs = o >> p.lu, r = rs / 7, sg = rs - 7 * r;
    const int u = o & (U - 1);
    dst[o] = (r < nr && u < nu) ? *src_of(r, sg, u) : T(0.0f);
  }
}

// out[k][j] (or its slice plane) = sum over m in [mb, me) of
// hprev[m][k] * dzx[m][j] for the 128 x 128 tile (tm, tn), f32 FMA: each
// thread an 8 x 8 tile, rows 4 ty + {0..3, 64..67} and columns
// 4 tx + {0..3, 64..67} (ty = tid / 16, tx = tid % 16), so a warp's
// 16-byte shared loads fall in two 256-byte runs; a kDwStages-deep
// cp.async ring of kDwF32Depth-row steps.
__device__ __forceinline__ void dwh_tile(const BwdParams& p,
                                         const float* hprev,
                                         const float* dzx, float* sm, int tm,
                                         int tn, int mb, int me, float* out) {
  constexpr int KD = kDwF32Depth, R = kDwF32Row, TL = kDwTile;
  const int H = p.h, H4 = 4 * p.h;
  const int k0 = tm * TL, j0 = tn * TL;
  auto stage = [&](int b, int m0) {
    float* a = sm + b * 2 * KD * R;
    float* bb = a + KD * R;
    if (p.dw_vec) {
      for (int o = threadIdx.x; o < 2 * KD * (TL / 4); o += blockDim.x) {
        const int side = o / (KD * (TL / 4)), c = o % (KD * (TL / 4));
        const int d = c / (TL / 4), col = 4 * (c % (TL / 4)), m = m0 + d;
        if (side == 0) {
          const bool ok = m < me && k0 + col < H;
          mma::cp_async16(a + d * R + col,
                          ok ? hprev + static_cast<size_t>(m) * H + k0 + col
                             : hprev,
                          ok);
        } else {
          const bool ok = m < me && j0 + col < H4;
          mma::cp_async16(bb + d * R + col,
                          ok ? dzx + static_cast<size_t>(m) * H4 + j0 + col
                             : dzx,
                          ok);
        }
      }
      return;
    }
    for (int o = threadIdx.x; o < KD * TL; o += blockDim.x) {
      const int d = o / TL, col = o % TL, m = m0 + d;
      a[d * R + col] = m < me && k0 + col < H
                           ? hprev[static_cast<size_t>(m) * H + k0 + col]
                           : 0.0f;
      bb[d * R + col] =
          m < me && j0 + col < H4
              ? __ldcg(dzx + static_cast<size_t>(m) * H4 + j0 + col) : 0.0f;
    }
  };
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.0f;
  const int steps = (me - mb + KD - 1) / KD;
#pragma unroll
  for (int s = 0; s < kDwStages - 1; ++s) {
    if (s < steps) stage(s, mb + s * KD);
    mma::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    mma::cp_async_wait<kDwStages - 2>();   // this thread's copies of step s
    __syncthreads();   // step s staged by all; step s - 1's readers done
    if (s + kDwStages - 1 < steps)
      stage((s + kDwStages - 1) % kDwStages, mb + (s + kDwStages - 1) * KD);
    mma::cp_async_commit();
    const float* a = sm + (s % kDwStages) * 2 * KD * R + 4 * ty;
    const float* b = a - 4 * ty + KD * R + 4 * tx;
#pragma unroll 4
    for (int d = 0; d < KD; ++d) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + d * R);
      const float4 a1 = *reinterpret_cast<const float4*>(a + d * R + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(b + d * R);
      const float4 b1 = *reinterpret_cast<const float4*>(b + d * R + 64);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(ar[i], br[e], acc[i][e]);
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();   // the next tile's staging reuses the ring
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = k0 + 4 * ty + (i & 3) + (i >> 2) * 64;
    if (row >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = j0 + 4 * tx + 64 * h;   // H4 is a multiple of 4
      if (col < H4)
        *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * H4 +
                                   col) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

// The same product in bf16 on the tensor cores, 128 x 128 tiles: both
// operands staged with the (T*N) row as the shared row, reaching mma.sync
// by ldmatrix.trans; 8 warps as 2 (k) x 4 (columns), each 64 x 32.
__device__ __forceinline__ void dwh_tile(const BwdParams& p,
                                         const __nv_bfloat16* hprev,
                                         const __nv_bfloat16* dzx,
                                         __nv_bfloat16* sm, int tm, int tn,
                                         int mb, int me, float* out) {
  constexpr int KD = kDwBf16Depth, R = kDwBf16Row, TL = kDwTile;
  const int H = p.h, H4 = 4 * p.h;
  const int k0 = tm * TL, j0 = tn * TL;
  auto stage = [&](int b, int m0) {
    __nv_bfloat16* a = sm + b * 2 * KD * R;
    __nv_bfloat16* bb = a + KD * R;
    if (p.dw_vec) {
      for (int o = threadIdx.x; o < 2 * KD * (TL / 8); o += blockDim.x) {
        const int side = o / (KD * (TL / 8)), c = o % (KD * (TL / 8));
        const int d = c / (TL / 8), col = 8 * (c % (TL / 8)), m = m0 + d;
        if (side == 0) {
          const bool ok = m < me && k0 + col < H;
          mma::cp_async16(a + d * R + col,
                          ok ? hprev + static_cast<size_t>(m) * H + k0 + col
                             : hprev,
                          ok);
        } else {
          const bool ok = m < me && j0 + col < H4;
          mma::cp_async16(bb + d * R + col,
                          ok ? dzx + static_cast<size_t>(m) * H4 + j0 + col
                             : dzx,
                          ok);
        }
      }
      return;
    }
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    for (int o = threadIdx.x; o < KD * TL; o += blockDim.x) {
      const int d = o / TL, col = o % TL, m = m0 + d;
      a[d * R + col] = m < me && k0 + col < H
                           ? hprev[static_cast<size_t>(m) * H + k0 + col]
                           : zero;
      bb[d * R + col] =
          m < me && j0 + col < H4
              ? __float2bfloat16_rn(load_cg(
                    dzx + static_cast<size_t>(m) * H4 + j0 + col))
              : zero;
    }
  };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  const int steps = (me - mb + KD - 1) / KD;
#pragma unroll
  for (int s = 0; s < kDwStages - 1; ++s) {
    if (s < steps) stage(s, mb + s * KD);
    mma::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    mma::cp_async_wait<kDwStages - 2>();
    __syncthreads();
    if (s + kDwStages - 1 < steps)
      stage((s + kDwStages - 1) % kDwStages, mb + (s + kDwStages - 1) * KD);
    mma::cp_async_commit();
    const __nv_bfloat16* A = sm + (s % kDwStages) * 2 * KD * R;
    const __nv_bfloat16* B = A + KD * R;
#pragma unroll
    for (int ks = 0; ks < KD / 16; ++ks) {
      unsigned af[4][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mma::ldsm_x4_trans(af[i], A + (16 * ks + (lane & 7) +
                                       ((lane >> 4) & 1) * 8) * R +
                                      wm + 16 * i + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        mma::ldsm_x4_trans(bf[jp], B + (16 * ks + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * R +
                                       wn + 16 * jp + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          mma::mma_bf16(acc[i][2 * jp], af[i], bf[jp][0], bf[jp][1]);
          mma::mma_bf16(acc[i][2 * jp + 1], af[i], bf[jp][2], bf[jp][3]);
        }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();   // the next tile's staging reuses the ring
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = k0 + wm + 16 * i + g + 8 * h;
      if (row >= H) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = j0 + wn + 8 * j + 2 * t4;   // even; H4 is even
        if (col < H4)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * H4 +
                                     col) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads) lstm_bwd_kernel(BwdParams p) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  LSTM_PROBE_START();
  const BwdSmem L = bwd_smem<T>(p.U, p.RB, p.RBP, p.WS, p.HP, p.groups);
  const int H = p.h, N = p.n, U = p.U, U4 = 4 * p.U;
  const int HP = p.HP, RBP = p.RBP, WS = p.WS, G = p.groups;
  const int LU = p.lu, LU4 = p.lu + 2;   // U and 4U as shifts
  const int tid = threadIdx.x, nth = blockDim.x;
  const int u0 = blockIdx.x * U, nu = min(U, H - u0);
  const int r0 = blockIdx.y * p.RB, nr = min(p.RB, N - r0);
  const size_t H4 = 4 * static_cast<size_t>(H);
  float* wt = reinterpret_cast<float*>(smem + L.wt);    // [q*U + u][k]
  float* dzl = reinterpret_cast<float*>(smem + L.dzl);  // [q*U + u][r]
  float* dh_s = reinterpret_cast<float*>(smem + L.dh);  // [r][u]
  float* dc_s = reinterpret_cast<float*>(smem + L.dc);  // [r][u]
  float* mk = reinterpret_cast<float*>(smem + L.mk);    // [2][r]
  T* in = reinterpret_cast<T*>(smem + L.in);            // [2][r][7U]
  float* part = reinterpret_cast<float*>(smem + L.part);  // [g][r][k]
  const size_t in_elems = static_cast<size_t>(p.RB) * 7 * U;
  const T* mask = static_cast<const T*>(p.mask);
  const T* wh = static_cast<const T*>(p.wh);
  T* dzx = static_cast<T*>(p.dzx);

  // Wh's columns of the block's units, transposed, for all k (zeros past
  // H and past the last slice's units); u runs fastest, so a warp reads
  // U consecutive columns of a row of Wh
  // (kStage loads in flight a thread: the copy is bound by L2's latency)
  for (int base = tid; base < U4 * HP; base += nth * kStage) {
    float v[kStage];
#pragma unroll
    for (int b = 0; b < kStage; ++b) {
      const int o = base + b * nth, k = o >> LU4, j = o & (U4 - 1);
      v[b] = o < U4 * HP && (j & (U - 1)) < nu && k < H
                 ? load(wh, static_cast<size_t>(k) * H4 + (j >> LU) * H +
                                u0 + (j & (U - 1)))
                 : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < kStage; ++b) {
      const int o = base + b * nth;
      if (o < U4 * HP) wt[(o & (U4 - 1)) * WS + (o >> LU4)] = v[b];
    }
  }
  for (int o = tid; o < U4 * RBP; o += nth) dzl[o] = 0.0f;
  for (int o = tid; o < p.RB * U; o += nth) {
    const int r = o >> LU, u = o & (U - 1);
    float dh = 0.0f, dc = 0.0f;
    if (r < nr && u < nu) {
      const size_t i = static_cast<size_t>(r0 + r) * H + u0 + u;
      dh = load(static_cast<const S*>(p.dhT), i);
      dc = load(static_cast<const S*>(p.dcT), i);
    }
    dh_s[o] = dh;
    dc_s[o] = dc;
  }
  // both mask buffers, row r by thread r % nth as in the ticks: 1 without
  // a mask and past the block's rows, tick T-1's rows from the mask
  const int T_last = p.t_len - 1;
  for (int r = tid; r < RBP; r += nth) {
    mk[(T_last & 1) * RBP + r] =
        mask != nullptr && r < nr
            ? load(mask, static_cast<size_t>(T_last) * N + r0 + r) : 1.0f;
    mk[(~T_last & 1) * RBP + r] = 1.0f;
  }
  issue_inputs<T>(p, in + (T_last & 1) * in_elems, T_last, r0, nr, u0, nu);
  mma::cp_async_commit();

  const int kq = HP / 4, units = (RBP / kRowTile) * kq, depth = U4 / G;
  LSTM_PROBE(9);
  for (int t = T_last; t >= 0; --t) {
    const int b = t & 1;
    // the next tick's inputs stream in while this one runs; its mask row
    // `tid` is stored after step 4, rows past the block's threads at once
    // (no thread reads buffer b ^ 1 during tick t)
    float m_next = 1.0f;
    if (t > 0) {
      issue_inputs<T>(p, in + (b ^ 1) * in_elems, t - 1, r0, nr, u0, nu);
      if (mask != nullptr) {
        const size_t mt = static_cast<size_t>(t - 1) * N + r0;
        if (tid < nr) m_next = load(mask, mt + tid);
        for (int r = tid + nth; r < nr; r += nth)
          mk[(b ^ 1) * RBP + r] = load(mask, mt + r);
      }
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    LSTM_PROBE(6);
    // 1. dz of the block's rows and units
    const T* ib = in + b * in_elems;
    for (int o = tid; o < nr * U; o += nth) {
      const int r = o >> LU, u = o & (U - 1);
      if (u >= nu) continue;
      const T* row = ib + static_cast<size_t>(r) * 7 * U;
      const float m = mk[b * RBP + r];
      const float dh = dh_s[o] + load(row, 4 * U + u);
      const float dc = dc_s[o];
      const float i = load(row, u);
      const float f = load(row, U + u);
      const float og = load(row, 2 * U + u);
      const float g = load(row, 3 * U + u);
      const float tc = load(row, 5 * U + u);
      const float cp = load(row, 6 * U + u);
      const float dh_raw = m * dh;
      const float d_o = dh_raw * tc;
      const float dc_raw = m * dc + dh_raw * og * (1.0f - tc * tc);
      float dz[4];
      dz[0] = dc_raw * g * i * (1.0f - i);
      dz[1] = dc_raw * cp * f * (1.0f - f);
      dz[2] = d_o * og * (1.0f - og);
      dz[3] = dc_raw * i * (1.0f - g * g);
      const size_t gb = (static_cast<size_t>(t) * N + r0 + r) * H4 + u0 + u;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        store(dzx, gb + q * H, dz[q]);
        dzl[(q * U + u) * RBP + r] = round_to<T>(dz[q]);
      }
      dh_s[o] = (1.0f - m) * dh;   // the carried part; step 4 adds dz.Wh^T
      dc_s[o] = (1.0f - m) * dc + dc_raw * f;
    }
    __syncthreads();
    LSTM_PROBE(1);
    // 2. this slice's dh partial for all H units: group g of the depth
    // takes columns [g * depth, (g + 1) * depth) of the block's 4U
    float* plane = p.xbuf + (static_cast<size_t>(b) * p.slices + blockIdx.x) *
                                N * HP;
    for (int w = tid; w < units * G; w += nth) {
      const int g = w / units, un = w % units;
      const int rr = (un / kq) * kRowTile, k = (un % kq) * 4;
      float acc[kRowTile][4];
#pragma unroll
      for (int i = 0; i < kRowTile; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
      const float* wj = wt + k;
      const float* zj = dzl + rr;
#pragma unroll 4
      for (int j = g * depth; j < (g + 1) * depth; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(wj + j * WS);
        const float4 a0 = *reinterpret_cast<const float4*>(zj + j * RBP);
        const float4 a1 = *reinterpret_cast<const float4*>(zj + j * RBP + 4);
        const float av[kRowTile] = {a0.x, a0.y, a0.z, a0.w,
                                    a1.x, a1.y, a1.z, a1.w};
        const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < kRowTile; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][e] = fmaf(av[i], bw[e], acc[i][e]);
      }
#pragma unroll
      for (int i = 0; i < kRowTile; ++i) {
        const float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2],
                                     acc[i][3]);
        if (G > 1) {
          *reinterpret_cast<float4*>(
              part + (static_cast<size_t>(g) * RBP + rr + i) * HP + k) = v;
        } else if (rr + i < nr) {
          *reinterpret_cast<float4*>(
              plane + static_cast<size_t>(r0 + rr + i) * HP + k) = v;
        }
      }
    }
    LSTM_PROBE(10);
    if (G > 1) {
      __syncthreads();
      for (int o = tid; o < nr * kq; o += nth) {
        const int r = o / kq, k = 4 * (o % kq);
        float4 s = *reinterpret_cast<const float4*>(part + r * HP + k);
        for (int g = 1; g < G; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(
              part + (static_cast<size_t>(g) * RBP + r) * HP + k);
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
        *reinterpret_cast<float4*>(
            plane + static_cast<size_t>(r0 + r) * HP + k) = s;
      }
    }
    LSTM_PROBE(2);
    // 3. every slice's plane of tick t is written
    grid.sync();
    LSTM_PROBE(3);
    // 4. dh of the block's rows and units += the slices' partials, in
    // slice order
    const float* xr = p.xbuf + static_cast<size_t>(b) * p.slices * N * HP;
    const int uq = (nu + 3) / 4;
    for (int o = tid; o < nr * uq; o += nth) {
      const int r = o / uq, c = 4 * (o % uq);
      const float* src = xr + static_cast<size_t>(r0 + r) * HP + u0 + c;
      float4 s = __ldcg(reinterpret_cast<const float4*>(src));
#pragma unroll 8
      for (int sl = 1; sl < p.slices; ++sl) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(
            src + static_cast<size_t>(sl) * N * HP));
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < nu) dh_s[r * U + c + e] += sv[e];
    }
    if (t > 0 && mask != nullptr && tid < nr)
      mk[(b ^ 1) * RBP + tid] = m_next;
    __syncthreads();
    LSTM_PROBE(4);
  }

  for (int o = tid; o < nr * U; o += nth) {
    const int r = o >> LU, u = o & (U - 1);
    if (u >= nu) continue;
    const size_t i = static_cast<size_t>(r0 + r) * H + u0 + u;
    store(static_cast<S*>(p.dh0), i, dh_s[o]);
    store(static_cast<S*>(p.dc0), i, dc_s[o]);
  }
  __syncthreads();   // the staging below reuses the whole shared memory
  LSTM_PROBE(8);

  // dWh = hprev^T . dzx over the whole (T*N) depth; every dzx[t] was
  // written before tick t's barrier
  const int tiles_m = (H + kDwTile - 1) / kDwTile;
  const int tiles_n = (4 * H + kDwTile - 1) / kDwTile;
  const int tiles = tiles_m * tiles_n, items = tiles * p.dw_splits;
  const int TN = p.t_len * N;
  const int nblk = gridDim.x * gridDim.y;
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t len = static_cast<size_t>(H) * H4;
  for (int it = blk; it < items; it += nblk) {
    const int z = it / tiles, tile = it % tiles;
    const int mb = z * p.dw_chunk, me = min(TN, mb + p.dw_chunk);
    float* out = p.dw_splits > 1 ? p.ws + z * len : p.dwh;
    dwh_tile(p, static_cast<const T*>(p.hprev), dzx,
             reinterpret_cast<T*>(smem), tile / tiles_n, tile % tiles_n, mb,
             me, out);
  }
  LSTM_PROBE(5);
  if (p.dw_splits > 1) {
    grid.sync();
    for (size_t e = static_cast<size_t>(blk) * nth + tid; e < len;
         e += static_cast<size_t>(nblk) * nth) {
      float s = __ldcg(p.ws + e);
      for (int z = 1; z < p.dw_splits; ++z) s += __ldcg(p.ws + z * len + e);
      p.dwh[e] = s;
    }
  }
  LSTM_PROBE(7);
  LSTM_PROBE_END();
}

template <typename T, typename S>
int launch(BwdParams p, cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const int U = p.U, H = p.h, N = p.n;
  if (p.t_len <= 0 || N <= 0 || H <= 0 || U < 4 || (U & (U - 1)) != 0 ||
      p.RB < 1 ||
      p.groups < 1 || (4 * U) % p.groups != 0 || p.dw_chunk <= 0 ||
      p.dw_chunk % kDwStep != 0)
    return bad;
  const long long tn = static_cast<long long>(p.t_len) * N;
  Plan plan;
  plan.U = U;
  plan.slices = (H + U - 1) / U;
  plan.RB = p.RB;
  plan.RT = (N + p.RB - 1) / p.RB;
  p.slices = plan.slices;
  p.lu = 0;
  while ((1 << p.lu) < U) ++p.lu;
  p.dw_splits = static_cast<int>((tn + p.dw_chunk - 1) / p.dw_chunk);
  if (tn > 0x7fffffffLL || (p.dw_splits > 1 && p.ws == nullptr)) return bad;
  p.HP = (H + 3) / 4 * 4;
  p.RBP = (p.RB + kRowTile - 1) / kRowTile * kRowTile;
  p.WS = p.HP + 4;   // spreads a warp's transposing stores over the banks
  constexpr int E = 16 / sizeof(T);
  const auto al = [](const void* q) { return mma::aligned16(q); };
  p.vec = H % E == 0 && U % E == 0 && al(p.gates) && al(p.dys) &&
          al(p.tcs) && al(p.cprev);
  p.dw_vec = H % E == 0 && al(p.hprev) && al(p.dzx);
  if (!al(p.xbuf)) return bad;
  const BwdSmem L = bwd_smem<T>(U, p.RB, p.RBP, p.WS, p.HP, p.groups);
  return static_cast<int>(
      launch_cooperative(lstm_bwd_kernel<T, S>, plan, L.total, p, stream));
}

}  // namespace lstm
}  // namespace dl4j

// dys, tcs, cprev, hprev: (T, N, H); gates, dzx: (T, N, 4H); wh: (H, 4H);
// mask: (T, N) or null, all in one dtype (bf16 when is_bf16); dhT, dcT,
// dh0, dc0: (N, H) in the state dtype (bf16 when state_bf16); dwh: (H, 4H)
// f32; xbuf: (2, ceil(H / units), N, ceil(H / 4) * 4) f32 scratch, 16-byte
// aligned; ws: (dw_splits, H, 4H) f32 scratch, or null when dw_splits is 1
// (dw_splits = ceil(T * N / dw_chunk)). units, rows, groups and dw_chunk
// are ops/fused_lstm.py:lstm_bwd_plan's. Returns the launch's error
// (cudaErrorInvalidValue for a plan it cannot follow,
// cudaErrorCooperativeLaunchTooLarge for a grid it cannot make resident).
extern "C" int dl4j_lstm_bwd(const void* dys, const void* dhT,
                             const void* dcT, const void* gates,
                             const void* tcs, const void* cprev,
                             const void* hprev, const void* mask,
                             const void* wh, void* dzx, float* dwh,
                             void* dh0, void* dc0, float* xbuf, float* ws,
                             int t_len, int n, int h, int is_bf16,
                             int state_bf16, int units, int rows, int groups,
                             int dw_chunk, void* stream) {
  using dl4j::lstm::launch;
  dl4j::lstm::BwdParams p{};
  p.dys = dys;
  p.dhT = dhT;
  p.dcT = dcT;
  p.gates = gates;
  p.tcs = tcs;
  p.cprev = cprev;
  p.hprev = hprev;
  p.mask = mask;
  p.wh = wh;
  p.dzx = dzx;
  p.dwh = dwh;
  p.dh0 = dh0;
  p.dc0 = dc0;
  p.xbuf = xbuf;
  p.ws = ws;
  p.t_len = t_len;
  p.n = n;
  p.h = h;
  p.U = units;
  p.RB = rows;
  p.groups = groups;
  p.dw_chunk = dw_chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return state_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(p, s)
                      : launch<__nv_bfloat16, float>(p, s);
  }
  return state_bf16 ? launch<float, __nv_bfloat16>(p, s)
                    : launch<float, float>(p, s);
}
