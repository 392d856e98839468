// lstm_fwd: the whole LSTM recurrence of one layer call in one launch.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_lstm.py:_fwd_kernel
// (via _fused_forward): per tick z = zx[t] + round(h, Wh.dtype) @ Wh with
// f32 accumulation, sigmoid i/f/o, tanh g, c = f*c + i*g, h = o*tanh(c); a
// masked tick keeps its f32 carry; writes ys, the post-activation gates,
// tanh(c) and the carried c (rounded to zx's dtype) and hT, cT.
//
// What bounds it on the H100. Each input read once and each output written
// once is (T*N*4H + H*4H) reads and (T*N*7H) writes: about 88 MB at
// T=60, N=128, H=256 in f32, 26 us at 3.35 TB/s. The product is
// 2*T*N*H*4H FLOP, 4.0 GFLOP there, 60 us at 67 TF/s f32 (no tensor
// cores here). Beneath both sits a latency floor: the T ticks are
// sequential, each ends at a grid-wide barrier, so T x (one barrier +
// one tick's dependent chain) bounds a short batch whatever its size.
//
// What the design does about it. The TPU kernel pins all of Wh in VMEM on
// one core; Wh (1 MiB at H=256, 4 MiB at H=512 in f32) fits no SM's
// 227 KB, so the work is split by hidden unit and batch row (lstm.cuh):
// each block keeps an H x 4U slice of Wh in shared memory for all T ticks
// and its rows' f32 (h, c) in shared memory, so per tick device memory
// sees only zx[t] and the outputs, and h crosses blocks through a 2-slot
// exchange that stays in L2. The product is f32 FMA on shared-memory
// tiles (h staged in column chunks, the z partial sums kept in shared
// memory in a fixed order); wgmma/TMA are for a later version.
// Built with nvcc into a shared library with a plain C interface and
// called through ctypes (ops/fused_lstm.py:lstm_fwd).
#include "lstm.cuh"

namespace dl4j {
namespace lstm {

struct FwdParams {
  const void* zx;    // (T, N, 4H) T
  const void* h0;    // (N, H) S
  const void* c0;    // (N, H) S
  const void* wh;    // (H, 4H) T
  const void* mask;  // (T, N) T, or null: every tick live
  void* ys;          // (T, N, H) T
  void* gates;       // (T, N, 4H) T
  void* tcs;         // (T, N, H) T
  void* ccs;         // (T, N, H) T
  void* hT;          // (N, H) S
  void* cT;          // (N, H) S
  float* xbuf;       // (2, N, H) f32: h rounded to T, ping-pong
  int t_len, n, h;
  int U, RB, KC;
};

constexpr size_t kWBudget = 64 * 1024;

inline int fwd_kc(int h, int rb) {
  int kc = static_cast<int>(kTileBytes / (sizeof(float) * rb)) - 1;
  kc = kc > h ? h : kc;
  // a multiple of 32, so rows of the tile (stride KC + 1) fall in
  // different banks when a warp reads one column of several rows
  if (kc > 32) kc -= kc % 32;
  return kc < 1 ? 1 : kc;
}

inline size_t fwd_smem(int h, const Plan& p, int kc) {
  const size_t u4 = 4 * static_cast<size_t>(p.U);
  return sizeof(float) * (h * u4 + 2 * static_cast<size_t>(p.RB) * p.U +
                          p.RB * u4 + static_cast<size_t>(p.RB) * (kc + 1));
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads) lstm_fwd_kernel(FwdParams p) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  extern __shared__ float smem[];
  const int H = p.h, N = p.n, U = p.U, U4 = 4 * p.U, KC = p.KC;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  const int r0 = blockIdx.y * p.RB;
  const int nr = min(p.RB, N - r0);
  const size_t H4 = 4 * static_cast<size_t>(H);
  float* w_s = smem;                  // [k][g*U + u]
  float* hc = w_s + static_cast<size_t>(H) * U4;  // [r][u] f32 carry h
  float* cc = hc + p.RB * U;          // [r][u] f32 carry c
  float* zacc = cc + p.RB * U;        // [r][g*U + u]
  float* tile = zacc + p.RB * U4;     // [r][KC + 1]
  const T* zx = static_cast<const T*>(p.zx);
  const T* wh = static_cast<const T*>(p.wh);
  const T* mask = static_cast<const T*>(p.mask);
  T* ys = static_cast<T*>(p.ys);
  T* gates = static_cast<T*>(p.gates);
  T* tcs = static_cast<T*>(p.tcs);
  T* ccs = static_cast<T*>(p.ccs);

  for (int o = tid; o < H * U4; o += nth) {
    const int k = o / U4, cl = o % U4, g = cl / U, u = cl % U;
    w_s[o] = u < nu ? load(wh, k * H4 + g * H + u0 + u) : 0.0f;
  }
  for (int o = tid; o < nr * U; o += nth) {
    const int r = o / U, u = o % U;
    if (u >= nu) continue;
    const size_t i = static_cast<size_t>(r0 + r) * H + u0 + u;
    const float hv = load(static_cast<const S*>(p.h0), i);
    hc[o] = hv;
    cc[o] = load(static_cast<const S*>(p.c0), i);
    p.xbuf[i] = round_to<T>(hv);
  }
  grid.sync();

  for (int t = 0; t < p.t_len; ++t) {
    const float* src = p.xbuf + static_cast<size_t>(t & 1) * N * H;
    float* dst = p.xbuf + static_cast<size_t>((t + 1) & 1) * N * H;
    for (int o = tid; o < nr * U4; o += nth) zacc[o] = 0.0f;
    // z partial sums over column chunks of the rows' h
    for (int k0 = 0; k0 < H; k0 += KC) {
      const int kc = min(KC, H - k0);
      __syncthreads();
      stage<true>(tile, KC + 1, src + static_cast<size_t>(r0) * H + k0, H,
                  nr, kc);
      __syncthreads();
      product(tile, KC + 1, 1, w_s + static_cast<size_t>(k0) * U4, U4, 1,
              zacc, U4, nr, U4, kc);
    }
    __syncthreads();
    // the cell update of the block's rows and units
    for (int o = tid; o < nr * U; o += nth) {
      const int r = o / U, u = o % U;
      if (u >= nu) continue;
      const int row = r0 + r, col = u0 + u;
      const size_t zb = (static_cast<size_t>(t) * N + row) * H4;
      const float* za = zacc + r * U4;
      const float zi = za[u] + load(zx, zb + col);
      const float zf = za[U + u] + load(zx, zb + H + col);
      const float zo = za[2 * U + u] + load(zx, zb + 2 * H + col);
      const float zg = za[3 * U + u] + load(zx, zb + 3 * H + col);
      const float i = sigmoid(zi), f = sigmoid(zf), og = sigmoid(zo);
      const float g = tanhf(zg);
      const float c_prev = cc[o], h_prev = hc[o];
      const float c_raw = f * c_prev + i * g;
      const float tc = tanhf(c_raw);
      const float h_raw = og * tc;
      float hn = h_raw, cn = c_raw;
      if (mask != nullptr) {
        const float m = load(mask, static_cast<size_t>(t) * N + row);
        hn = m * h_raw + (1.0f - m) * h_prev;
        cn = m * c_raw + (1.0f - m) * c_prev;
      }
      hc[o] = hn;
      cc[o] = cn;
      const size_t hb = (static_cast<size_t>(t) * N + row) * H + col;
      store(ys, hb, hn);
      store(tcs, hb, tc);
      store(ccs, hb, cn);
      store(gates, zb + col, i);
      store(gates, zb + H + col, f);
      store(gates, zb + 2 * H + col, og);
      store(gates, zb + 3 * H + col, g);
      dst[static_cast<size_t>(row) * H + col] = round_to<T>(hn);
    }
    grid.sync();
  }

  for (int o = tid; o < nr * U; o += nth) {
    const int r = o / U, u = o % U;
    if (u >= nu) continue;
    const size_t i = static_cast<size_t>(r0 + r) * H + u0 + u;
    store(static_cast<S*>(p.hT), i, hc[o]);
    store(static_cast<S*>(p.cT), i, cc[o]);
  }
}

template <typename T, typename S>
int launch(FwdParams p, cudaStream_t stream) {
  const Plan plan = make_plan(p.n, p.h, kWBudget);
  p.U = plan.U;
  p.RB = plan.RB;
  p.KC = fwd_kc(p.h, plan.RB);
  return static_cast<int>(launch_cooperative(
      lstm_fwd_kernel<T, S>, plan, fwd_smem(p.h, plan, p.KC), p, stream));
}

// `iters` grid-wide barriers and nothing else, on the forward's grid: the
// per-tick barrier cost behind the recurrence's latency floor.
__global__ void __launch_bounds__(kThreads) barrier_probe_kernel(int iters) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int i = 0; i < iters; ++i) grid.sync();
}

}  // namespace lstm
}  // namespace dl4j

// Launches barrier_probe_kernel on the grid lstm_fwd takes at (n, h) with
// the same shared memory; time it with CUDA events around the call.
extern "C" int dl4j_lstm_barrier_probe(int n, int h, int iters,
                                       void* stream) {
  using namespace dl4j::lstm;
  const Plan plan = make_plan(n, h, kWBudget);
  return static_cast<int>(launch_cooperative(
      barrier_probe_kernel, plan, fwd_smem(h, plan, fwd_kc(h, plan.RB)),
      iters, static_cast<cudaStream_t>(stream)));
}

// zx, gates: (T, N, 4H); ys, tcs, ccs: (T, N, H); wh: (H, 4H); mask:
// (T, N) or null, all in zx's dtype (bf16 when is_bf16); h0, c0, hT, cT:
// (N, H) in the state dtype (bf16 when state_bf16); xbuf: (2, N, H) f32
// scratch. Returns the launch's error (cudaErrorCooperativeLaunchTooLarge
// when the grid cannot be resident).
extern "C" int dl4j_lstm_fwd(const void* zx, const void* h0, const void* c0,
                             const void* wh, const void* mask, void* ys,
                             void* gates, void* tcs, void* ccs, void* hT,
                             void* cT, float* xbuf, int t_len, int n, int h,
                             int is_bf16, int state_bf16, void* stream) {
  using dl4j::lstm::launch;
  dl4j::lstm::FwdParams p{zx, h0,  c0, wh, mask, ys, gates, tcs, ccs,
                          hT, cT,  xbuf, t_len, n, h, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return state_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(p, s)
                      : launch<__nv_bfloat16, float>(p, s);
  }
  return state_bf16 ? launch<float, __nv_bfloat16>(p, s)
                    : launch<float, float>(p, s);
}
