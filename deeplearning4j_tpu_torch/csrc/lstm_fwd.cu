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
// 2*T*N*H*4H FLOP, 4.0 GFLOP there, 60 us at 67 TF/s f32 (4 us at
// 989 TF/s bf16). Beneath both sits a latency floor: the T ticks are
// sequential, each ends at a barrier among the blocks that share h, so
// T x (one barrier + one tick's dependent chain) bounds a short batch
// whatever its size.
//
// What the design does about it. The TPU kernel pins all of Wh in VMEM on
// one core; Wh (1 MiB at H=256, 4 MiB at H=512 in f32) fits no SM's
// 227 KB, so the work is split by hidden unit and batch row (lstm.cuh) by
// a plan computed in Python (ops/fused_lstm.py:lstm_fwd_plan). Each block
// keeps its units' columns of Wh in shared memory, in Wh's own dtype, for
// the whole sequence, and per tick only h is staged:
//   * the product, f32 sums: bf16 on the tensor cores (mma.sync m16n8k16
//     from ldmatrix, as z^T = Wh^T . h^T: Wh's columns are the A operand,
//     h the B operand, so 8 batch rows make a tile and a short batch
//     wastes little; exactly the reference's rounding); f32 by FMA, each
//     thread 8 rows x the 4 gates of one unit, the depth cut into `G`
//     ranges whose partials are added in order (no TF32: it keeps about 3
//     digits; 3xTF32 was slower, see product());
//   * the tick's zx tile (the block's rows and 4U gate columns) arrives by
//     cp.async during the previous tick's exchange and this tick's
//     product, the mask row in a register: the serial chain reads only
//     shared memory;
//   * two routes, one tick body templated on the exchange:
//     - the cluster route (kCluster), wherever one thread-block cluster
//       can hold a row tile's whole Wh: the row tile runs as a cluster of
//       `slices` blocks (16 with the non-portable size); each block writes
//       its units' new h (in T) to its own shared memory, the cluster
//       meets at cluster.sync(), and each block gathers the tile's whole h
//       from its peers by distributed shared memory (16-byte loads). No
//       grid barrier, no cooperative launch, nothing through L2;
//     - the grid route (what no cluster holds: f32 at H 512): one
//       cooperative launch, h exchanged in T through a 2-slot buffer in
//       L2 and a grid barrier a tick; a block stages its rows of the slot
//       by 16-byte cp.async.cg in depth chunks through a ring of
//       `stages` buffers.
// No float atomics: every sum has one order, so two calls give the same
// bits. Built with nvcc into a shared library with a plain C interface and
// called through ctypes (ops/fused_lstm.py:lstm_fwd). LSTM_PROBE(k) marks
// the phases of a tick for tools/port_probe.py's clock64() breakdown (with
// LSTM_PROBE_START and _END); they compile to nothing here.
#include "lstm.cuh"
#include "mma.cuh"

#ifndef LSTM_PROBE
#define LSTM_PROBE_START()
#define LSTM_PROBE(k)
#define LSTM_PROBE_END()
#endif

namespace dl4j {
namespace lstm {

namespace cg = cooperative_groups;

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
  void* xbuf;        // grid route: (2, N, HX) T, h rounded to T; else null
  int t_len, n, h;
  int U, RB, slices, KC, G;  // the plan: units, rows, slices, chunk (a
                             // multiple of 16 in f32, 32 in bf16), groups
  int stages;                // grid route: depth chunks of h in flight + 1
  int lu;                    // U = 1 << lu
  int HP, RBP, HX;           // depth (a multiple of 32), rows (of 8), slices*U
  int vec;                   // 16-byte copies of Wh and of the zx tiles
};

constexpr int kMaxCluster = 16;   // the non-portable cluster size

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) / 16 * 16;
}

// Row stride (elements) of the block's Wh columns: bf16 rows carry 16
// bytes of padding, so ldmatrix.trans's 8 rows fall in distinct banks; a
// warp's f32 FMA loads read one row.
template <typename T>
__host__ __device__ constexpr int wh_stride(int U) {
  return 4 * U + (sizeof(T) == 2 ? 8 : 0);
}

// Byte offsets of the shared-memory regions (each 16-byte aligned). Rows of
// h carry 16 bytes of padding and rows of z 4 floats, so the loads of a
// warp and its stores of z fall in distinct banks; z has one f32 plane
// for each of the f32 product's G depth groups. The same sum as
// ops/fused_lstm.py:lstm_fwd_smem.
struct FwdSmem {
  size_t wh, hs, zp, out, hc, cc, zx, mk, total;
};

template <typename T>
__host__ __device__ inline FwdSmem fwd_smem(bool cluster, int U, int RB,
                                            int RBP, int HP, int KC, int G,
                                            int stages) {
  constexpr int pad = 16 / sizeof(T);
  const size_t U4 = 4 * static_cast<size_t>(U);
  FwdSmem s;
  size_t o = 0;
  s.wh = o;  o += align16(sizeof(T) * HP * wh_stride<T>(U));
  s.hs = o;  o += align16(cluster ? sizeof(T) * RBP * (HP + pad)
                                  : sizeof(T) * stages * RBP * (KC + pad));
  s.zp = o;  o += align16(sizeof(float) * G * RBP * (U4 + 4));
  s.out = o;
  if (cluster) o += align16(sizeof(T) * 2 * RB * static_cast<size_t>(U));
  s.hc = o;  o += align16(sizeof(float) * RB * static_cast<size_t>(U));
  s.cc = o;  o += align16(sizeof(float) * RB * static_cast<size_t>(U));
  s.zx = o;  o += align16(sizeof(T) * RB * U4);
  s.mk = o;  o += align16(sizeof(float) * RBP);
  s.total = o;
  return s;
}

// ws[k][q*U + u] = Wh[k][q*H + u0 + u] for k < HP, zeros past H and past
// the block's nu units: 16-byte cp.async when p.vec, else element-wise.
template <typename T>
__device__ __forceinline__ void stage_wh(const FwdParams& p, T* ws, int u0,
                                         int nu) {
  const int U = p.U, H = p.h, WS = wh_stride<T>(U);
  const size_t H4 = 4 * static_cast<size_t>(H);
  const T* wh = static_cast<const T*>(p.wh);
  if (p.vec) {
    constexpr int E = 16 / sizeof(T);
    const int cpr = U / E, total = p.HP * 4 * cpr;
    for (int o = threadIdx.x; o < total; o += blockDim.x) {
      const int k = o / (4 * cpr), rem = o - k * 4 * cpr;
      const int q = rem / cpr, c = (rem - q * cpr) * E;
      const bool ok = k < H && c < nu;
      mma::cp_async16(ws + k * WS + q * U + c,
                      ok ? wh + k * H4 + q * H + u0 + c : wh, ok);
    }
    return;
  }
  const int total = p.HP * 4 * U;
  for (int o = threadIdx.x; o < total; o += blockDim.x) {
    const int k = o / (4 * U), j = o - k * 4 * U, q = j >> p.lu;
    const int u = j & (U - 1);
    ws[k * WS + j] = k < H && u < nu ? wh[k * H4 + q * H + u0 + u] : T(0.0f);
  }
}

// The zx tile of tick t, zs[r][q*U + u] = zx[t][r0 + r][q*H + u0 + u] for
// the block's rows and units (zeros elsewhere): 16-byte cp.async when
// p.vec, else element-wise loads.
template <typename T>
__device__ __forceinline__ void issue_zx(const FwdParams& p, T* zs, int t,
                                         int r0, int nr, int u0, int nu) {
  const int U = p.U, H = p.h;
  const size_t H4 = 4 * static_cast<size_t>(H);
  const T* zx = static_cast<const T*>(p.zx) +
                (static_cast<size_t>(t) * p.n + r0) * H4 + u0;
  if (p.vec) {
    constexpr int E = 16 / sizeof(T);
    const int cpr = U / E, total = p.RB * 4 * cpr;
    for (int o = threadIdx.x; o < total; o += blockDim.x) {
      const int r = o / (4 * cpr), rem = o - r * 4 * cpr;
      const int q = rem / cpr, c = (rem - q * cpr) * E;
      const bool ok = r < nr && c < nu;
      mma::cp_async16(zs + (r * 4 + q) * U + c,
                      ok ? zx + r * H4 + q * H + c : zx - u0, ok);
    }
    return;
  }
  const int total = p.RB * 4 * U;
  for (int o = threadIdx.x; o < total; o += blockDim.x) {
    const int r = o / (4 * U), j = o - r * 4 * U, q = j >> p.lu;
    const int u = j & (U - 1);
    zs[o] = r < nr && u < nu ? zx[r * H4 + q * H + u] : T(0.0f);
  }
}

// One m-tile x n-tile of z^T from the accumulator layout (c0, c1: column
// 16 mt + g, rows 8 nt + 2 t4 (+1); c2, c3: column + 8) into zp[r][j].
__device__ __forceinline__ void store_z(float* zp, int ZS, int mt, int nt,
                                        int g, int t4, const float (&v)[4],
                                        bool first) {
  float* d = zp + (8 * nt + 2 * t4) * ZS + 16 * mt + g;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float* de = d + (e >> 1) * 8 + (e & 1) * ZS;
    *de = first ? v[e] : *de + v[e];
  }
}

// zp[g][r][q*U + u] (= when `first`, else +=) the block's z over depth
// [0, kc) of hs (RBP rows, row stride hld) against ws (kc rows of Wh's
// columns).
//
// bf16 on the tensor cores as z^T = Wh^T . h^T: m-tiles of 16 of the
// block's 4U columns, n-tiles of 8 rows (one plane). A warp owns one m-tile and up to kNB of its n-tiles at a time (the
// MT m-tiles' n-tiles shared out over the block's warps), so each k-step
// loads the m-tile's A fragment once for all of them; and the next
// k-step's fragments load before this step's products issue, since a warp
// issues in order and a tick's product is too short to hide a
// shared-memory load otherwise.
constexpr int kNB = 4;

// Calls job(mt, nts, nb) for this warp's share: m-tile mt and its n-tiles
// nts[0..nb).
template <typename Job>
__device__ __forceinline__ void warp_jobs(int MT, int NT, Job job) {
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int wpm = nw > MT ? nw / MT : 1;   // warps on one m-tile
  for (int j = warp; j < MT * wpm; j += nw) {
    const int mt = j % MT, part = j / MT;
    for (int n0 = part; n0 < NT; n0 += wpm * kNB) {
      int nts[kNB], nb = 0;
#pragma unroll
      for (int i = 0; i < kNB; ++i) {
        nts[i] = min(n0 + i * wpm, NT - 1);
        nb += n0 + i * wpm < NT;
      }
      job(mt, nts, nb);
    }
  }
}

// Two m16n8k16 products a k-step of 32 (A by ldmatrix.trans from ws, B by
// ldmatrix from hs), h and Wh as they are.
__device__ __forceinline__ void product(const FwdParams& p,
                                        const __nv_bfloat16* hs, int hld,
                                        const __nv_bfloat16* ws, int kc,
                                        float* zp, bool first) {
  const int U = p.U, WS = wh_stride<__nv_bfloat16>(U), ZS = 4 * U + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  warp_jobs(U / 4, p.RBP / 8, [&](int mt, const int (&nts)[kNB], int nb) {
    const __nv_bfloat16* a = ws + ((lane & 7) + ((lane >> 4) & 1) * 8) * WS +
                             16 * mt + ((lane >> 3) & 1) * 8;
    const __nv_bfloat16* b[kNB];
#pragma unroll
    for (int i = 0; i < kNB; ++i)
      b[i] = hs + (8 * nts[i] + (lane & 7)) * hld + (lane >> 3) * 8;
    struct Frag {
      unsigned a[2][4], b[kNB][4];
    } f0, f1;
    auto load = [&](Frag& f, int k) {
      mma::ldsm_x4_trans(f.a[0], a + k * WS);
      mma::ldsm_x4_trans(f.a[1], a + (k + 16) * WS);
#pragma unroll
      for (int i = 0; i < kNB; ++i)
        if (i < nb) mma::ldsm_x4(f.b[i], b[i] + k);
    };
    float acc[kNB][2][4] = {};   // [n-tile][k-step half]
    auto mul = [&](const Frag& f) {
#pragma unroll
      for (int i = 0; i < kNB; ++i)
        if (i < nb) {
          mma::mma_bf16(acc[i][0], f.a[0], f.b[i][0], f.b[i][1]);
          mma::mma_bf16(acc[i][1], f.a[1], f.b[i][2], f.b[i][3]);
        }
    };
    load(f0, 0);
    for (int k = 0; k < kc; k += 64) {
      if (k + 32 < kc) load(f1, k + 32);
      mul(f0);
      if (k + 32 >= kc) break;
      if (k + 64 < kc) load(f0, k + 64);
      mul(f1);
    }
#pragma unroll
    for (int i = 0; i < kNB; ++i)
      if (i < nb) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = acc[i][0][e] + acc[i][1][e];
        store_z(zp, ZS, mt, nts[i], g, t4, v, first);
      }
  });
}

// f32 by FMA: thread item (unit u, row tile rt: rows rt + i*RBP/8, depth
// group g), 8 rows x the 4 gates of u in registers, summed into plane g of
// zp; lanes run over units (or neighbouring row tiles), so a warp's h loads
// broadcast and its Wh loads are consecutive, and the next 4-deep step's
// operands load while this one's FMAs run. (3xTF32 on the tensor cores,
// tried in its place, was slower at every f32 shape: a tick's product is
// one chain of dependent mma.sync a warp, and each tf32 step costs three
// of them and six splits.)
__device__ __forceinline__ void product(const FwdParams& p, const float* hs,
                                        int hld, const float* ws, int kc,
                                        float* zp, bool first) {
  const int U = p.U, G = p.G, RBP = p.RBP, RTL = p.RBP / 8;
  const int WS = wh_stride<float>(U), ZS = 4 * U + 4;
  const int items = U * RTL, steps = kc / 16;
  for (int w = threadIdx.x; w < items * G; w += blockDim.x) {
    const int g = w / items, it = w - g * items;
    const int u = it & (U - 1), rt = it >> p.lu;
    const int kb = 16 * (g * steps / G), ke = 16 * ((g + 1) * steps / G);
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
    const float* hr = hs + rt * hld;
    const float* wr = ws + u;
    float4 hv[8];
    float wv[4][4];
    auto fetch = [&](int k, float4 (&h4)[8], float (&w4)[4][4]) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        h4[i] = *reinterpret_cast<const float4*>(hr + i * RTL * hld + k);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int q = 0; q < 4; ++q) w4[e][q] = wr[(k + e) * WS + q * U];
    };
    if (kb < ke) fetch(kb, hv, wv);
#pragma unroll 2
    for (int k = kb; k < ke; k += 4) {
      float4 hn[8];
      float wn[4][4];
      fetch(k + 4 < ke ? k + 4 : k, hn, wn);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float he[4] = {hv[i].x, hv[i].y, hv[i].z, hv[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[i][q] = fmaf(he[e], wv[e][q], acc[i][q]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) hv[i] = hn[i];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int q = 0; q < 4; ++q) wv[e][q] = wn[e][q];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* d = zp + (g * RBP + rt + i * RTL) * ZS + u;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        d[q * U] = first ? acc[i][q] : d[q * U] + acc[i][q];
    }
  }
}

// The grid route's exchange: rows [r0, r0 + RBP) and depth chunk c of slot
// `slot` into ring buffer `buf` by 16-byte cp.async.cg (zeros past the
// block's rows and past HX).
template <typename T>
__device__ __forceinline__ void stage_chunk(const FwdParams& p, const T* slot,
                                            T* ring, int c, int r0, int nr) {
  constexpr int E = 16 / sizeof(T);
  const int k0 = c * p.KC, kc = min(p.KC, p.HP - k0), cpr = kc / E;
  const int ld = p.KC + E;
  for (int o = threadIdx.x; o < p.RBP * cpr; o += blockDim.x) {
    const int r = o / cpr, k = (o - r * cpr) * E;
    const bool ok = r < nr && k0 + k < p.HX;
    mma::cp_async16(ring + r * ld + k,
                    ok ? slot + static_cast<size_t>(r0 + r) * p.HX + k0 + k
                       : slot,
                    ok);
  }
}

// The cluster route's exchange: hs[r][s*U + u] = slot[r][u] of cluster
// block s for the block's nr rows and every s, by 16-byte loads of
// distributed shared memory, kGather in flight a thread; block `rank`
// starts at its own slot, so the cluster's blocks read different peers at
// once.
constexpr int kGather = 4;
template <typename T>
__device__ __forceinline__ void gather(const FwdParams& p, T* hs, int hld,
                                       T* slot, int nr) {
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int E = 16 / sizeof(T);
  const int C = p.slices, rank = static_cast<int>(cluster.block_rank());
  const int cpr = p.U / E, per = nr * cpr, total = C * per;
  for (int base = threadIdx.x; base < total; base += blockDim.x * kGather) {
    uint4 v[kGather];
    int at[kGather];
#pragma unroll
    for (int b = 0; b < kGather; ++b) {
      const int o = base + b * blockDim.x;
      if (o < total) {
        const int j = o / per, rem = o - j * per, r = rem / cpr;
        const int sl = j + rank < C ? j + rank : j + rank - C;
        const int c = (rem - r * cpr) * E;
        v[b] = *reinterpret_cast<const uint4*>(
            cluster.map_shared_rank(slot, sl) + r * p.U + c);
        at[b] = r * hld + sl * p.U + c;
      }
    }
#pragma unroll
    for (int b = 0; b < kGather; ++b)
      if (base + b * blockDim.x < total)
        *reinterpret_cast<uint4*>(hs + at[b]) = v[b];
  }
}

// sigmoid and tanh from the fast exponential and division: a tick's cell
// update is a serial chain, and these cut it (within 1e-6 of expf and
// tanhf, where the outputs are held to 1e-4; tanh x = 2 sigmoid(2x) - 1)
__device__ __forceinline__ float fast_sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}
__device__ __forceinline__ float fast_tanh(float x) {
  return 2.0f * fast_sigmoid(2.0f * x) - 1.0f;
}

// The f32 cell update of one (row, unit) from its summed z: sigmoid i, f,
// o, tanh g, the carry (kept where the mask is 0); writes the tick's
// outputs and returns the new h.
template <typename T>
__device__ __forceinline__ float cell(const FwdParams& p, const float (&z)[4],
                                      float& hc, float& cc, float m,
                                      size_t hb, size_t zb) {
  const float i = fast_sigmoid(z[0]), f = fast_sigmoid(z[1]);
  const float og = fast_sigmoid(z[2]), g = fast_tanh(z[3]);
  const float c_prev = cc, h_prev = hc;
  const float c_raw = f * c_prev + i * g;
  const float tc = fast_tanh(c_raw);
  const float h_raw = og * tc;
  float hn = h_raw, cn = c_raw;
  if (p.mask != nullptr) {
    hn = m * h_raw + (1.0f - m) * h_prev;
    cn = m * c_raw + (1.0f - m) * c_prev;
  }
  hc = hn;
  cc = cn;
  const int H = p.h;
  store(static_cast<T*>(p.ys), hb, hn);
  store(static_cast<T*>(p.tcs), hb, tc);
  store(static_cast<T*>(p.ccs), hb, cn);
  T* gt = static_cast<T*>(p.gates);
  store(gt, zb, i);
  store(gt, zb + H, f);
  store(gt, zb + 2 * H, og);
  store(gt, zb + 3 * H, g);
  return hn;
}

// cp.async.wait_group with a run-time count of younger groups allowed in
// flight (the grid route's ring: stages - 2)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= 2)
    mma::cp_async_wait<2>();
  else if (n == 1)
    mma::cp_async_wait<1>();
  else
    mma::cp_async_wait<0>();
}

template <typename T, typename S, bool kCluster>
__global__ void __launch_bounds__(kThreads, 1) lstm_fwd_kernel(FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  LSTM_PROBE_START();
  constexpr int pad = 16 / sizeof(T);
  const FwdSmem L =
      fwd_smem<T>(kCluster, p.U, p.RB, p.RBP, p.HP, p.KC, p.G, p.stages);
  const int H = p.h, N = p.n, U = p.U, LU = p.lu, G = p.G;
  const int RB = p.RB, RBP = p.RBP, ZS = 4 * U + 4;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int u0 = blockIdx.x * U, nu = min(U, H - u0);
  const int r0 = blockIdx.y * RB, nr = min(RB, N - r0);
  const size_t H4 = 4 * static_cast<size_t>(H);
  T* ws = reinterpret_cast<T*>(smem + L.wh);        // [k][q*U + u]
  T* hs = reinterpret_cast<T*>(smem + L.hs);        // [r][k] (or a ring)
  float* zp = reinterpret_cast<float*>(smem + L.zp);  // [g][r][q*U + u]
  T* out = reinterpret_cast<T*>(smem + L.out);      // [2][r][u]
  float* hc = reinterpret_cast<float*>(smem + L.hc);  // [r][u] f32 carry
  float* cc = reinterpret_cast<float*>(smem + L.cc);
  T* zs = reinterpret_cast<T*>(smem + L.zx);        // [r][q*U + u]
  float* mk = reinterpret_cast<float*>(smem + L.mk);  // [r]
  const T* mask = static_cast<const T*>(p.mask);
  T* xbuf = static_cast<T*>(p.xbuf);
  const int hld = kCluster ? p.HP + pad : p.KC + pad;
  const int WS = wh_stride<T>(U);

  stage_wh<T>(p, ws, u0, nu);
  mma::cp_async_commit();
  issue_zx<T>(p, zs, 0, r0, nr, u0, nu);
  mma::cp_async_commit();
  // the carry of the block's rows and units, and h0 rounded to T into the
  // exchange (cluster: slot 1, which tick 0 reads as the previous tick's;
  // grid: xbuf slot 0), zeros past them
  for (int o = tid; o < RB * U; o += nth) {
    const int r = o >> LU, u = o & (U - 1);
    const bool ok = r < nr && u < nu;
    const size_t i = static_cast<size_t>(r0 + r) * H + u0 + u;
    const float hv = ok ? load(static_cast<const S*>(p.h0), i) : 0.0f;
    hc[o] = hv;
    cc[o] = ok ? load(static_cast<const S*>(p.c0), i) : 0.0f;
    if (kCluster)
      out[RB * U + o] = T(round_to<T>(hv));
    else if (r < nr)
      xbuf[static_cast<size_t>(r0 + r) * p.HX + u0 + u] = T(round_to<T>(hv));
  }
  // zeros past the block's rows and past HX, which no exchange writes
  if (kCluster)
    for (int o = tid; o < RBP * hld; o += nth) hs[o] = T(0.0f);
  for (int r = tid; r < RBP; r += nth)
    mk[r] = mask != nullptr && r < nr ? load(mask, r0 + r) : 1.0f;
  mma::cp_async_wait<0>();
  __syncthreads();
  if (kCluster) {
    // every peer is running and has written h0's slot; gather the tile's h0
    cg::this_cluster().sync();
    gather<T>(p, hs, hld, out + RB * U, nr);
    __syncthreads();
  } else {
    cg::this_grid().sync();   // xbuf slot 0 is whole
  }
  LSTM_PROBE(0);

  float m_next = 1.0f;   // row tid's mask for the next tick
  for (int t = 0; t < p.t_len; ++t) {
    // 1. z partials of the block's rows and units
    if (kCluster) {
      product(p, hs, hld, ws, p.HP, zp, true);
    } else {
      // h's depth chunks of slot t&1 through a ring of `stages` buffers
      const T* slot = xbuf + static_cast<size_t>(t & 1) * N * p.HX;
      const int chunks = (p.HP + p.KC - 1) / p.KC, nst = p.stages;
      for (int c = 0; c + 1 < nst; ++c) {
        if (c < chunks) stage_chunk<T>(p, slot, hs + c * RBP * hld, c, r0, nr);
        mma::cp_async_commit();
      }
      for (int c = 0; c < chunks; ++c) {
        cp_async_wait_upto(nst - 2);   // chunk c has landed
        __syncthreads();   // for all; chunk c - 1's buffer is read
        const int cn = c + nst - 1;
        if (cn < chunks)
          stage_chunk<T>(p, slot, hs + (cn % nst) * RBP * hld, cn, r0, nr);
        mma::cp_async_commit();
        product(p, hs + (c % nst) * RBP * hld, hld,
                ws + static_cast<size_t>(c) * p.KC * WS,
                min(p.KC, p.HP - c * p.KC), zp, c == 0);
      }
    }
    LSTM_PROBE(1);
    if (t > 0 && mask != nullptr && tid < nr) mk[tid] = m_next;
    mma::cp_async_wait<0>();   // this tick's zx tile
    __syncthreads();
    LSTM_PROBE(6);
    // 2. the cell update of the block's rows and units; its new h, rounded
    // to T, to the exchange (zeros past the block's units)
    T* next = kCluster ? out + (t & 1) * RB * U
                       : xbuf + static_cast<size_t>((t + 1) & 1) * N * p.HX;
    for (int o = tid; o < RB * U; o += nth) {
      const int r = o >> LU, u = o & (U - 1);
      float v = 0.0f;
      if (r < nr && u < nu) {
        float z[4];
        const float* zr = zp + r * ZS + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) z[q] = zr[q * U];
        for (int g = 1; g < G; ++g) {
          const float* zg = zr + g * RBP * ZS;
#pragma unroll
          for (int q = 0; q < 4; ++q) z[q] += zg[q * U];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) z[q] = load(zs, (r * 4 + q) * U + u) + z[q];
        const size_t row = static_cast<size_t>(t) * N + r0 + r;
        v = round_to<T>(cell<T>(p, z, hc[o], cc[o], mk[r], row * H + u0 + u,
                                row * H4 + u0 + u));
      }
      if (kCluster)
        next[o] = T(v);
      else if (r < nr)
        next[static_cast<size_t>(r0 + r) * p.HX + u0 + u] = T(v);
    }
    LSTM_PROBE(2);
    // 3. every block's new h of tick t is written
    if (kCluster)
      cg::this_cluster().sync();
    else
      cg::this_grid().sync();
    LSTM_PROBE(3);
    if (t + 1 == p.t_len) break;
    // 4. the next tick's inputs stream in; its mask row `tid` is stored
    // after the product, rows past the block's threads at once (no thread
    // reads mk before step 2)
    issue_zx<T>(p, zs, t + 1, r0, nr, u0, nu);
    mma::cp_async_commit();
    if (mask != nullptr) {
      const size_t mt = static_cast<size_t>(t + 1) * N + r0;
      if (tid < nr) m_next = load(mask, mt + tid);
      for (int r = tid + nth; r < nr; r += nth) mk[r] = load(mask, mt + r);
    }
    LSTM_PROBE(7);
    if (kCluster) {   // the row tile's whole h of tick t
      gather<T>(p, hs, hld, out + (t & 1) * RB * U, nr);
      __syncthreads();
    }
    LSTM_PROBE(4);
  }

  for (int o = tid; o < nr * U; o += nth) {
    const int r = o >> LU, u = o & (U - 1);
    if (u >= nu) continue;
    const size_t i = static_cast<size_t>(r0 + r) * H + u0 + u;
    store(static_cast<S*>(p.hT), i, hc[o]);
    store(static_cast<S*>(p.cT), i, cc[o]);
  }
  LSTM_PROBE(5);
  LSTM_PROBE_END();
}

// A cluster launch of `kernel(args...)` over grid (gx, gy) in clusters of
// `cluster` blocks along x, with `smem` bytes of dynamic shared memory.
template <typename... Args>
cudaError_t launch_cluster(void (*kernel)(Args...), int gx, int gy,
                           int cluster, size_t smem, cudaStream_t stream,
                           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, typename S>
int launch(FwdParams p, int cluster_route, cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  constexpr int E = 16 / sizeof(T);
  constexpr int kStep = sizeof(T) == 2 ? 32 : 16;   // a product step's depth
  const int U = p.U, H = p.h, N = p.n;
  if (p.t_len <= 0 || N <= 0 || H <= 0 || U < 8 || (U & (U - 1)) != 0 ||
      p.RB < 1 || p.slices != (H + U - 1) / U || p.KC < kStep ||
      p.KC % kStep != 0 || p.G < 1 || (sizeof(T) == 2 && p.G != 1))
    return bad;
  p.lu = 0;
  while ((1 << p.lu) < U) ++p.lu;
  p.HX = p.slices * U;
  p.HP = (p.HX + 31) / 32 * 32;
  p.RBP = (p.RB + 7) / 8 * 8;
  p.vec = H % E == 0 && mma::aligned16(p.wh) && mma::aligned16(p.zx);
  const int RT = (N + p.RB - 1) / p.RB;
  if (cluster_route) {
    if (p.slices > kMaxCluster || p.KC != p.HP) return bad;
    const FwdSmem L =
        fwd_smem<T>(true, U, p.RB, p.RBP, p.HP, p.KC, p.G, 1);
    return static_cast<int>(launch_cluster(lstm_fwd_kernel<T, S, true>,
                                           p.slices, RT, p.slices, L.total,
                                           stream, p));
  }
  if (p.xbuf == nullptr || !mma::aligned16(p.xbuf) || p.stages < 2 ||
      p.stages > 4)
    return bad;
  const FwdSmem L =
      fwd_smem<T>(false, U, p.RB, p.RBP, p.HP, p.KC, p.G, p.stages);
  Plan plan;
  plan.U = U;
  plan.slices = p.slices;
  plan.RB = p.RB;
  plan.RT = RT;
  return static_cast<int>(launch_cooperative(lstm_fwd_kernel<T, S, false>,
                                             plan, L.total, p, stream));
}

// `iters` barriers and nothing else: a cluster barrier (cluster > 0, the
// cluster route's) or a grid barrier (a cooperative launch, the grid
// route's and lstm_bwd's); the per-tick cost behind the latency floor.
__global__ void __launch_bounds__(kThreads) barrier_probe_kernel(int iters,
                                                                 int cluster) {
  if (cluster > 0) {
    cg::cluster_group c = cg::this_cluster();
    for (int i = 0; i < iters; ++i) c.sync();
  } else {
    cg::grid_group grid = cg::this_grid();
    for (int i = 0; i < iters; ++i) grid.sync();
  }
}

}  // namespace lstm
}  // namespace dl4j

// Launches barrier_probe_kernel on a (gx, gy) grid of blocks with `smem`
// bytes of dynamic shared memory each: in clusters of `cluster` blocks
// along x when cluster > 0, else as a cooperative launch. Time it with
// CUDA events around the call.
extern "C" int dl4j_lstm_barrier_probe(int cluster, int gx, int gy, int smem,
                                       int iters, void* stream) {
  using namespace dl4j::lstm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster > 0)
    return static_cast<int>(launch_cluster(barrier_probe_kernel, gx, gy,
                                           cluster, smem, s, iters, cluster));
  // launch_cooperative passes one argument; the probe takes two
  cudaError_t err = cudaFuncSetAttribute(
      barrier_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int zero = 0;
  void* args[] = {&iters, &zero};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(barrier_probe_kernel), dim3(gx, gy),
      dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The most clusters of `cluster` blocks with `smem` bytes each that the
// card keeps resident at once (cudaOccupancyMaxActiveClusters) for the
// cluster route's f32 (or bf16) kernel; a negative CUDA error on failure.
extern "C" int dl4j_lstm_max_clusters(int cluster, int smem, int is_bf16) {
  using namespace dl4j::lstm;
  auto query = [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    if (cluster > 8)
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, 1);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &n, reinterpret_cast<const void*>(kernel), &cfg);
    return err == cudaSuccess ? n : -static_cast<int>(err);
  };
  return is_bf16 ? query(lstm_fwd_kernel<__nv_bfloat16, float, true>)
                 : query(lstm_fwd_kernel<float, float, true>);
}

// zx, gates: (T, N, 4H); ys, tcs, ccs: (T, N, H); wh: (H, 4H); mask:
// (T, N) or null, all in zx's dtype (bf16 when is_bf16); h0, c0, hT, cT:
// (N, H) in the state dtype (bf16 when state_bf16); xbuf: the grid route's
// (2, N, slices * units) scratch in zx's dtype, 16-byte aligned (null on
// the cluster route). cluster_route, slices, units, rows, chunk, groups and
// stages are ops/fused_lstm.py:lstm_fwd_plan's. Returns the launch's error
// (cudaErrorInvalidValue for a plan it cannot follow,
// cudaErrorCooperativeLaunchTooLarge for a grid it cannot make resident).
extern "C" int dl4j_lstm_fwd(const void* zx, const void* h0, const void* c0,
                             const void* wh, const void* mask, void* ys,
                             void* gates, void* tcs, void* ccs, void* hT,
                             void* cT, void* xbuf, int t_len, int n, int h,
                             int is_bf16, int state_bf16, int cluster_route,
                             int slices, int units, int rows, int chunk,
                             int groups, int stages, void* stream) {
  using dl4j::lstm::launch;
  dl4j::lstm::FwdParams p{};
  p.zx = zx;
  p.h0 = h0;
  p.c0 = c0;
  p.wh = wh;
  p.mask = mask;
  p.ys = ys;
  p.gates = gates;
  p.tcs = tcs;
  p.ccs = ccs;
  p.hT = hT;
  p.cT = cT;
  p.xbuf = xbuf;
  p.t_len = t_len;
  p.n = n;
  p.h = h;
  p.U = units;
  p.RB = rows;
  p.slices = slices;
  p.KC = chunk;
  p.G = groups;
  p.stages = stages;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return state_bf16
               ? launch<__nv_bfloat16, __nv_bfloat16>(p, cluster_route, s)
               : launch<__nv_bfloat16, float>(p, cluster_route, s);
  }
  return state_bf16 ? launch<float, __nv_bfloat16>(p, cluster_route, s)
                    : launch<float, float>(p, cluster_route, s);
}
