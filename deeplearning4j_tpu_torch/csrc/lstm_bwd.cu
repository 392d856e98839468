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
// What the design does about it. Ownership matches the forward
// (lstm.cuh): a block owns U hidden units and RB batch rows. It keeps its
// units' ROWS of Wh (U x 4H) in shared memory for dz . Wh^T, and its
// units' COLUMNS of dWh (H x 4U, f32) in shared memory, summed over its
// rows and over t in reverse order. Per reverse tick it computes dz for
// its rows and units from its own dh/dc carry, writes dzx[t] and the
// exchange copy of dz (rounded to Wh's dtype), adds its rows' hprev^T . dz
// to its dWh columns, meets the other blocks at the grid barrier, then
// forms its dh from all of dz's columns of its rows. One barrier per tick
// is enough, because a block's next dz needs only its own units' dh. At
// the end each row tile's dWh partial goes to a workspace and one pass
// sums the tiles in row-tile order: no float atomics, the same bits on
// every call. f32 FMA on shared-memory tiles; wgmma/TMA come later.
// Built with nvcc into a shared library with a plain C interface and
// called through ctypes (ops/fused_lstm.py:lstm_bwd).
#include "lstm.cuh"

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
  float* xbuf;        // (2, N, 4H) f32: dz rounded to T, ping-pong
  float* ws;          // (RT, H, 4H) f32: each row tile's dWh
  int t_len, n, h;
  int U, RB, JC, RH;
};

constexpr size_t kWBudget = 48 * 1024;
// the staging tile: twice the forward's, since dz rows are 4H wide (fewer
// chunks a tick) and one block per SM is resident either way
constexpr size_t kBwdTileBytes = 96 * 1024;

struct BwdTiles {
  int JC, RH;
  size_t tile;  // floats of the staging tile
};

inline BwdTiles bwd_tiles(int h, int rb) {
  BwdTiles b;
  int jc = static_cast<int>(kBwdTileBytes / (sizeof(float) * rb)) - 1;
  jc = jc > 4 * h ? 4 * h : jc;
  // a multiple of 32, so rows of the tile (stride JC + 1) fall in
  // different banks when a warp reads one column of several rows
  if (jc > 32) jc -= jc % 32;
  b.JC = jc < 1 ? 1 : jc;
  int rh = static_cast<int>(kBwdTileBytes / (sizeof(float) * (h + 1)));
  rh = rh > rb ? rb : rh;
  b.RH = rh < 1 ? 1 : rh;
  const size_t a = static_cast<size_t>(rb) * (b.JC + 1);
  const size_t c = static_cast<size_t>(b.RH) * (h + 1);
  b.tile = a > c ? a : c;
  return b;
}

inline size_t bwd_smem(int h, const Plan& p, const BwdTiles& b) {
  const size_t u4 = 4 * static_cast<size_t>(p.U);
  return sizeof(float) *
         (p.U * (4 * static_cast<size_t>(h) + 1) + h * u4 +
          2 * static_cast<size_t>(p.RB) * p.U + p.RB * u4 + b.tile);
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads) lstm_bwd_kernel(BwdParams p) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  extern __shared__ float smem[];
  const int H = p.h, N = p.n, U = p.U, U4 = 4 * p.U;
  const int JC = p.JC, RH = p.RH;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  const int r0 = blockIdx.y * p.RB;
  const int nr = min(p.RB, N - r0);
  const int H4 = 4 * H;
  float* wr = smem;                                  // [u][4H + 1]
  float* dw = wr + static_cast<size_t>(U) * (H4 + 1);  // [k][g*U + u]
  float* dh_s = dw + static_cast<size_t>(H) * U4;   // [r][u]
  float* dc_s = dh_s + p.RB * U;                     // [r][u]
  float* dzl = dc_s + p.RB * U;                      // [r][g*U + u]
  float* tile = dzl + p.RB * U4;
  const T* dys = static_cast<const T*>(p.dys);
  const T* gates = static_cast<const T*>(p.gates);
  const T* tcs = static_cast<const T*>(p.tcs);
  const T* cprev = static_cast<const T*>(p.cprev);
  const T* hprev = static_cast<const T*>(p.hprev);
  const T* mask = static_cast<const T*>(p.mask);
  const T* wh = static_cast<const T*>(p.wh);
  T* dzx = static_cast<T*>(p.dzx);

  for (int o = tid; o < U * H4; o += nth) {
    const int u = o / H4, j = o % H4;
    wr[u * (H4 + 1) + j] =
        u < nu ? load(wh, static_cast<size_t>(u0 + u) * H4 + j) : 0.0f;
  }
  for (int o = tid; o < H * U4; o += nth) dw[o] = 0.0f;
  for (int o = tid; o < p.RB * U4; o += nth) dzl[o] = 0.0f;
  for (int o = tid; o < nr * U; o += nth) {
    const int r = o / U, u = o % U;
    if (u >= nu) continue;
    const size_t i = static_cast<size_t>(r0 + r) * H + u0 + u;
    dh_s[o] = load(static_cast<const S*>(p.dhT), i);
    dc_s[o] = load(static_cast<const S*>(p.dcT), i);
  }
  __syncthreads();

  for (int t = p.t_len - 1; t >= 0; --t) {
    float* ex = p.xbuf + static_cast<size_t>(t & 1) * N * H4;
    // 1. dz of the block's rows and units
    for (int o = tid; o < nr * U; o += nth) {
      const int r = o / U, u = o % U;
      if (u >= nu) continue;
      const int row = r0 + r, col = u0 + u;
      const size_t hb = (static_cast<size_t>(t) * N + row) * H + col;
      const size_t gb = (static_cast<size_t>(t) * N + row) * H4;
      const float m =
          mask != nullptr ? load(mask, static_cast<size_t>(t) * N + row)
                          : 1.0f;
      const float dh = dh_s[o] + load(dys, hb);
      const float dc = dc_s[o];
      const float i = load(gates, gb + col);
      const float f = load(gates, gb + H + col);
      const float og = load(gates, gb + 2 * H + col);
      const float g = load(gates, gb + 3 * H + col);
      const float tc = load(tcs, hb);
      const float cp = load(cprev, hb);
      const float dh_raw = m * dh;
      const float d_o = dh_raw * tc;
      const float dc_raw = m * dc + dh_raw * og * (1.0f - tc * tc);
      float dz[4];
      dz[0] = dc_raw * g * i * (1.0f - i);
      dz[1] = dc_raw * cp * f * (1.0f - f);
      dz[2] = d_o * og * (1.0f - og);
      dz[3] = dc_raw * i * (1.0f - g * g);
      for (int q = 0; q < 4; ++q) {
        store(dzx, gb + q * H + col, dz[q]);
        const float zr = round_to<T>(dz[q]);
        ex[static_cast<size_t>(row) * H4 + q * H + col] = zr;
        dzl[r * U4 + q * U + u] = zr;
      }
      dh_s[o] = (1.0f - m) * dh;
      dc_s[o] = (1.0f - m) * dc + dc_raw * f;
    }
    // 2. dWh columns += hprev[t]^T . dz over the block's rows
    for (int rc0 = 0; rc0 < nr; rc0 += RH) {
      const int rc = min(RH, nr - rc0);
      __syncthreads();
      stage<false>(tile, H + 1,
                   hprev + (static_cast<size_t>(t) * N + r0 + rc0) * H, H,
                   rc, H);
      __syncthreads();
      product(tile, 1, H + 1, dzl + rc0 * U4, U4, 1, dw, U4, H, U4, rc);
    }
    grid.sync();
    // 3. dh of the block's rows and units += dz . Wh^T over all columns
    for (int j0 = 0; j0 < H4; j0 += JC) {
      const int jc = min(JC, H4 - j0);
      __syncthreads();
      stage<true>(tile, JC + 1, ex + static_cast<size_t>(r0) * H4 + j0, H4,
                  nr, jc);
      __syncthreads();
      product(tile, JC + 1, 1, wr + j0, 1, H4 + 1, dh_s, U, nr, U, jc);
    }
    __syncthreads();
  }

  for (int o = tid; o < nr * U; o += nth) {
    const int r = o / U, u = o % U;
    if (u >= nu) continue;
    const size_t i = static_cast<size_t>(r0 + r) * H + u0 + u;
    store(static_cast<S*>(p.dh0), i, dh_s[o]);
    store(static_cast<S*>(p.dc0), i, dc_s[o]);
  }
  float* part = p.ws + static_cast<size_t>(blockIdx.y) * H * H4;
  for (int o = tid; o < H * U4; o += nth) {
    const int k = o / U4, cl = o % U4, g = cl / U, u = cl % U;
    if (u < nu) part[static_cast<size_t>(k) * H4 + g * H + u0 + u] = dw[o];
  }
  grid.sync();
  // dWh = the row tiles' partials summed in row-tile order
  const size_t total = static_cast<size_t>(H) * H4;
  const size_t nb = static_cast<size_t>(gridDim.x) * gridDim.y;
  const size_t b = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  for (size_t e = b * nth + tid; e < total; e += nb * nth) {
    float s = 0.0f;
    for (int rt = 0; rt < static_cast<int>(gridDim.y); ++rt)
      s += __ldcg(p.ws + rt * total + e);
    p.dwh[e] = s;
  }
}

template <typename T, typename S>
int launch(BwdParams p, cudaStream_t stream) {
  const Plan plan = make_plan(p.n, p.h, kWBudget);
  const BwdTiles tiles = bwd_tiles(p.h, plan.RB);
  p.U = plan.U;
  p.RB = plan.RB;
  p.JC = tiles.JC;
  p.RH = tiles.RH;
  return static_cast<int>(launch_cooperative(
      lstm_bwd_kernel<T, S>, plan, bwd_smem(p.h, plan, tiles), p, stream));
}

}  // namespace lstm
}  // namespace dl4j

// Row tiles of the backward's plan at (n, h): its workspace holds that
// many (H, 4H) f32 planes.
extern "C" int dl4j_lstm_bwd_row_tiles(int n, int h) {
  return dl4j::lstm::make_plan(n, h, dl4j::lstm::kWBudget).RT;
}

// dys, tcs, cprev, hprev: (T, N, H); gates, dzx: (T, N, 4H); wh: (H, 4H);
// mask: (T, N) or null, all in one dtype (bf16 when is_bf16); dhT, dcT,
// dh0, dc0: (N, H) in the state dtype (bf16 when state_bf16); dwh: (H, 4H)
// f32; xbuf: (2, N, 4H) f32 scratch; ws: (row_tiles(n, h), H, 4H) f32
// scratch. Returns the launch's error.
extern "C" int dl4j_lstm_bwd(const void* dys, const void* dhT,
                             const void* dcT, const void* gates,
                             const void* tcs, const void* cprev,
                             const void* hprev, const void* mask,
                             const void* wh, void* dzx, float* dwh,
                             void* dh0, void* dc0, float* xbuf, float* ws,
                             int t_len, int n, int h, int is_bf16,
                             int state_bf16, void* stream) {
  using dl4j::lstm::launch;
  dl4j::lstm::BwdParams p{dys, dhT,  dcT, gates, tcs,   cprev, hprev,
                          mask, wh,  dzx, dwh,   dh0,   dc0,   xbuf,
                          ws,   t_len, n, h,     0,     0,     0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return state_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(p, s)
                      : launch<__nv_bfloat16, float>(p, s);
  }
  return state_bf16 ? launch<float, __nv_bfloat16>(p, s)
                    : launch<float, float>(p, s);
}
