// Backward of the fused conv + BatchNorm kernels for Hopper (sm_90a),
// shared by fused_mm_bwd.cu (1x1 conv, f32; bf16 is mm_bwd.cuh's) and
// fused_c3_bwd.cu (3x3 SAME conv: f32, and the dW half in both dtypes).
//
// Replaces the TPU kernels deeplearning4j_tpu/ops/fused_conv.py:
// _bwd_merged_kernel (1x1), _c3_bwd_merged_kernel (3x3, one pass) and
// _c3_bwd_w_kernel (the dW half of the 3x3 two-pass route; its dx half,
// _c3_bwd_in_kernel, is c3_bwd_in.cuh's, which keeps this file's dyc rule,
// epilogue and, for f32, its FMA tile). With the forward's saved (x, W,
// scale, shift, y) and the cotangents (dy, dstats) they compute, per dy
// row m (an output pixel) and channel:
//
//   dyc = dy + dS + 2 * y * dS2, rounded to dy's dtype  (statistics chain)
//   e   = relu?(x * scale + shift), rounded to x's dtype (recomputed prologue)
//   de[m, c] = sum_k dyc[m, k] * Wt[k, c]                 dx product, f32
//     (1x1: Wt = W^T; 3x3: K = 9 * Cout over the flipped, IO-swapped taps
//      of the zero-padded dyc)
//   dpre = de where pre > 0 (ReLU), dx = dpre * scale in x's dtype,
//   partial[tile, 0, c] = sum dpre * x, partial[tile, 1, c] = sum dpre
//   dW[r, n] = sum_m e_shift(r)[m] * dyc[m, n]           dW product, f32
//     (1x1: r = Cin channel; 3x3: r = tap * Cin + c, e zero-padded AFTER
//      the normalize)
//
// norm_in = 0 (the block's W1 and Wds): e = x, dx = de, no BN sums.
//
// What bounds it on this card: two products per call, each with M
// (= N * H * W rows) on one side; at the trained ResNet50's shapes (64x64
// input, batch 32-128) M is 128..32768 and the other sides 64..4608, so
// on paper the calls are bound by bytes or near the bf16 ridge. In
// practice three things bound this version: it multiplies with FMA in f32
// (no tensor cores), the deep layers give few output tiles, and dW reduces
// over M, the longest axis. What the design does about that:
//   * one launch holds two kinds of 64x64 tiles over the same dy/y/x:
//     dx tiles (with the BN/ReLU backward and its sums in the epilogue)
//     and dW tiles, so both products fill the card together (the dW
//     launch of the 3x3 split route runs dW tiles alone);
//   * dW cuts M into slices of dw_chunk rows (the caller picks the count
//     from the shapes alone, about two blocks per SM); each slice writes
//     its own f32 plane and a second kernel adds the planes in slice order;
//   * dyc and e are recomputed as their tiles are loaded, never stored;
//   * no float atomics anywhere: every sum has one fixed order, so two
//     calls on the same inputs give the same bits.
// The bf16 tensor-core versions are c3_bwd_in.cuh, c3_bwd.cuh and
// mm_bwd.cuh; this FMA tile keeps f32 (no TF32) and fused_c3_bwd_w.
#pragma once

#include "conv_gemm.cuh"

namespace dl4j {

struct BwdArgs {
  const void* dy;      // (N, Ho, Wo, Cout), x's dtype
  const void* y;       // (N, Ho, Wo, Cout), x's dtype
  const void* x;       // (N, H, W, Cin)
  const void* w;       // (Cin, Cout) or (3, 3, Cin, Cout); unused by dW
  const float* dst;    // (2, Cout): cotangents of (sum y, sum y^2)
  const float* scale;  // (Cin,)
  const float* shift;  // (Cin,)
  void* dx;            // x's shape and dtype; only stride-grid rows written
  float* dw_out;       // dw_splits planes of (dw_rows, Cout) f32
  float* partial;      // (dx_tiles_m, 2, Cin) f32 when norm_in
  int H, W, Ho, Wo, stride, cin, cout;
  int M;               // rows of dy: N * Ho * Wo
  int norm_in, relu_in;
  int dx_tiles_m, dx_tiles_n;
  int dw_rows, dw_tiles_m, dw_tiles_n, dw_chunk, dw_splits;
};

// Element s (0..3) of this thread in a 64 x 16 (rows x depth) tile.
// kRowFast: neighbouring threads take neighbouring rows (the rows are
// contiguous in memory); else neighbouring depths.
template <bool kRowFast>
struct TileMap {
  static __device__ __forceinline__ int row(int tid, int s) {
    return kRowFast ? (tid & 63) : (tid >> 4) + 16 * s;
  }
  static __device__ __forceinline__ int depth(int tid, int s) {
    return kRowFast ? (tid >> 6) + 4 * s : (tid & 15);
  }
};

template <typename T>
__device__ __forceinline__ float dyc_at(const BwdArgs& p, long long off,
                                        int c) {
  const float dy = to_f32<T>(static_cast<const T*>(p.dy)[off]);
  const float y = to_f32<T>(static_cast<const T*>(p.y)[off]);
  const float v = __fadd_rn(__fadd_rn(dy, p.dst[c]),
                            __fmul_rn(2.0f * y, p.dst[p.cout + c]));
  return to_f32<T>(from_f32<T>(v));
}

// A of the dx product: rows are dy pixels, depth k is a Cout channel
// (1x1) or tap * Cout + channel of the zero-padded dyc (3x3).
template <typename T, bool kC3>
struct DycRows {
  using Map = TileMap<false>;
  int img[4], pi[4], pj[4];
  long long m[4];
  __device__ DycRows(const BwdArgs& p, int m0) {
    const int plane = p.Ho * p.Wo;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int r = m0 + Map::row(threadIdx.x, s);
      m[s] = r;
      img[s] = -1;
      pi[s] = pj[s] = 0;
      if (r < p.M) {
        img[s] = r / plane;
        const int rem = r - img[s] * plane;
        pi[s] = rem / p.Wo;
        pj[s] = rem - pi[s] * p.Wo;
      }
    }
  }
  __device__ __forceinline__ float load(const BwdArgs& p, int s,
                                        int k) const {
    if (img[s] < 0) return 0.0f;
    if (!kC3) return dyc_at<T>(p, m[s] * p.cout + k, k);
    const int tap = k / p.cout;
    const int c = k - tap * p.cout;
    const int hi = pi[s] + tap / 3 - 1;
    const int wi = pj[s] + tap % 3 - 1;
    if (hi < 0 || hi >= p.Ho || wi < 0 || wi >= p.Wo) return 0.0f;
    return dyc_at<T>(
        p, (((long long)img[s] * p.Ho + hi) * p.Wo + wi) * p.cout + c, c);
  }
};

// B of the dx product: B[k, c] = W[c, k] (1x1) or the flipped tap
// W[2 - di, 2 - dj, c, k mod Cout] (3x3); columns are Cin channels.
template <typename T, bool kC3>
struct WtCols {
  using Map = TileMap<false>;
  int col[4];
  __device__ WtCols(const BwdArgs& p, int c0) {
#pragma unroll
    for (int s = 0; s < 4; ++s) col[s] = c0 + Map::row(threadIdx.x, s);
  }
  __device__ __forceinline__ float load(const BwdArgs& p, int s,
                                        int k) const {
    if (col[s] >= p.cin) return 0.0f;
    const T* w = static_cast<const T*>(p.w);
    if (!kC3) return to_f32<T>(w[(long long)col[s] * p.cout + k]);
    const int tap = k / p.cout;
    const int n = k - tap * p.cout;
    return to_f32<T>(w[((long long)(8 - tap) * p.cin + col[s]) * p.cout + n]);
  }
};

// A of the dW product: row r is a Cin channel (1x1) or tap * Cin + channel
// (3x3); depth is the dy pixel m, whose input pixel is the stride-grid
// one (1x1) or the tap-shifted one of the zero-padded e (3x3).
template <typename T, bool kC3>
struct ERows {
  using Map = TileMap<true>;
  int c, di, dj;
  bool valid;
  float sc, sh;
  __device__ ERows(const BwdArgs& p, int r0) {
    const int r = r0 + Map::row(threadIdx.x, 0);
    valid = r < p.dw_rows;
    const int tap = kC3 ? r / p.cin : 0;
    c = r - tap * p.cin;
    di = tap / 3 - 1;
    dj = tap % 3 - 1;
    sc = sh = 0.0f;
    if (valid && p.norm_in) {
      sc = p.scale[c];
      sh = p.shift[c];
    }
  }
  __device__ __forceinline__ float load(const BwdArgs& p, int s,
                                        int m) const {
    if (!valid) return 0.0f;
    const int plane = p.Ho * p.Wo;
    const int n = m / plane;
    const int rem = m - n * plane;
    const int i = rem / p.Wo;
    const int j = rem - i * p.Wo;
    int hi, wi;
    if (kC3) {
      hi = i + di;
      wi = j + dj;
      if (hi < 0 || hi >= p.H || wi < 0 || wi >= p.W) return 0.0f;
    } else {
      hi = i * p.stride;
      wi = j * p.stride;
    }
    const T* x = static_cast<const T*>(p.x);
    const long long off = (((long long)n * p.H + hi) * p.W + wi) * p.cin + c;
    return prologue<T>(x[off], sc, sh, p.norm_in, p.relu_in);
  }
};

// B of the dW product: B[m, n] = dyc[m, n]; columns are Cout channels.
template <typename T>
struct DycCols {
  using Map = TileMap<true>;
  int col;
  __device__ DycCols(const BwdArgs& p, int n0) {
    col = n0 + Map::row(threadIdx.x, 0);
  }
  __device__ __forceinline__ float load(const BwdArgs& p, int s,
                                        int m) const {
    if (col >= p.cout) return 0.0f;
    return dyc_at<T>(p, (long long)m * p.cout + col, col);
  }
};

// acc[i][j] (tile rows ty*4+i, columns tx*4+j) += sum over k in [kb, ke),
// in order, of A[row, k] * B[k, col]: FMA on 64x64 tiles, 16 deep.
template <class LA, class LB>
__device__ __forceinline__ void tile_gemm(const BwdArgs& p, const LA& a,
                                          const LB& b, int kb, int ke,
                                          float (&acc)[4][4],
                                          float (*As)[kPadM],
                                          float (*Bs)[kTileN]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  for (int k0 = kb; k0 < ke; k0 += kTileK) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int kk = LA::Map::depth(tid, s);
      As[kk][LA::Map::row(tid, s)] =
          k0 + kk < ke ? a.load(p, s, k0 + kk) : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int kk = LB::Map::depth(tid, s);
      Bs[kk][LB::Map::row(tid, s)] =
          k0 + kk < ke ? b.load(p, s, k0 + kk) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// One 64x64 tile of dx (rows: dy pixels, columns: Cin channels) with the
// BN/ReLU backward and the tile's (sum dpre * x, sum dpre) per channel.
template <typename T, bool kC3>
__device__ void dx_tile(const BwdArgs& p, int tm, int tn, float (*As)[kPadM],
                        float (*Bs)[kTileN],
                        float (*red)[kThreads / 16][kTileN]) {
  const int m0 = tm * kTileM;
  const int c0 = tn * kTileN;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  tile_gemm(p, DycRows<T, kC3>(p, m0), WtCols<T, kC3>(p, c0), 0,
            kC3 ? 9 * p.cout : p.cout, acc, As, Bs);

  const T* x = static_cast<const T*>(p.x);
  T* dx = static_cast<T*>(p.dx);
  const int plane = p.Ho * p.Wo;
  float cs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float cq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= p.M) continue;
    const int n = m / plane;
    const int rem = m - n * plane;
    const int r = rem / p.Wo;
    const int q = rem - r * p.Wo;
    const long long row =
        (((long long)n * p.H + r * p.stride) * p.W + q * p.stride) * p.cin;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c >= p.cin) continue;
      const float de = acc[i][j];
      if (!p.norm_in) {
        dx[row + c] = from_f32<T>(de);
        continue;
      }
      const float xf = to_f32<T>(x[row + c]);
      const float s = p.scale[c];
      const float pre = __fadd_rn(__fmul_rn(xf, s), p.shift[c]);
      const float dpre = (p.relu_in && !(pre > 0.0f)) ? 0.0f : de;
      dx[row + c] = from_f32<T>(__fmul_rn(dpre, s));
      cs[j] += dpre * xf;
      cq[j] += dpre;
    }
  }
  if (!p.norm_in) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][ty][tx * 4 + j] = cs[j];
    red[1][ty][tx * 4 + j] = cq[j];
  }
  __syncthreads();
  if (tid < kTileN && c0 + tid < p.cin) {
    float s = 0.0f, q = 0.0f;
#pragma unroll
    for (int t = 0; t < kThreads / 16; ++t) {
      s += red[0][t][tid];
      q += red[1][t][tid];
    }
    float* out = p.partial + (long long)tm * 2 * p.cin;
    out[c0 + tid] = s;
    out[p.cin + c0 + tid] = q;
  }
}

// One 64x64 tile of dW (rows: dw_rows, columns: Cout) over one slice of M.
template <typename T, bool kC3>
__device__ void dw_tile(const BwdArgs& p, int tm, int tn, int split,
                        float (*As)[kPadM], float (*Bs)[kTileN]) {
  const int r0 = tm * kTileM;
  const int n0 = tn * kTileN;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int kb = split * p.dw_chunk;
  const int ke = min(p.M, kb + p.dw_chunk);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  tile_gemm(p, ERows<T, kC3>(p, r0), DycCols<T>(p, n0), kb, ke, acc, As,
            Bs);
  float* out = p.dw_out + (long long)split * p.dw_rows * p.cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= p.dw_rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < p.cout) out[(long long)r * p.cout + n] = acc[i][j];
    }
  }
}

constexpr int kPartDx = 1;  // dx tiles (+ BN sums)
constexpr int kPartDw = 2;  // dW tiles

// The grid's blocks are the dx tiles first, then the dW tiles of every
// M slice; a block computes one tile of one kind.
template <typename T, bool kC3, int kParts>
__global__ void __launch_bounds__(kThreads) conv_bwd_kernel(BwdArgs p) {
  __shared__ __align__(16) float As[kTileK][kPadM];
  __shared__ __align__(16) float Bs[kTileK][kTileN];
  __shared__ float red[2][kThreads / 16][kTileN];
  int b = blockIdx.x;
  if constexpr ((kParts & kPartDx) != 0) {
    const int n_dx = p.dx_tiles_m * p.dx_tiles_n;
    if (b < n_dx) {
      dx_tile<T, kC3>(p, b / p.dx_tiles_n, b % p.dx_tiles_n, As, Bs, red);
      return;
    }
    b -= n_dx;
  }
  if constexpr ((kParts & kPartDw) != 0) {
    const int per = p.dw_tiles_m * p.dw_tiles_n;
    const int split = b / per;
    b -= split * per;
    dw_tile<T, kC3>(p, b / p.dw_tiles_n, b % p.dw_tiles_n, split, As, Bs);
  }
}

// dw[i] = sum over the M slices, in slice order, of ws[s][i]
__global__ void __launch_bounds__(kThreads)
    dw_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                     long long len, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < len; i += (long long)gridDim.x * blockDim.x) {
    float v = 0.0f;
    for (int s = 0; s < splits; ++s) v += ws[s * len + i];
    dw[i] = v;
  }
}

inline BwdArgs bwd_args(const void* dy, const void* y, const void* x,
                        const void* w, const float* dst, const float* scale,
                        const float* shift, void* dx, float* partial, int n,
                        int h, int wd, int cin, int cout, int stride,
                        int norm_in, int relu_in, int dw_chunk) {
  BwdArgs p;
  p.dy = dy;
  p.y = y;
  p.x = x;
  p.w = w;
  p.dst = dst;
  p.scale = scale;
  p.shift = shift;
  p.dx = dx;
  p.dw_out = nullptr;
  p.partial = partial;
  p.H = h;
  p.W = wd;
  p.stride = stride < 1 ? 1 : stride;
  p.Ho = (h + p.stride - 1) / p.stride;
  p.Wo = (wd + p.stride - 1) / p.stride;
  p.cin = cin;
  p.cout = cout;
  p.M = n * p.Ho * p.Wo;
  p.norm_in = norm_in;
  p.relu_in = relu_in;
  p.dw_chunk = dw_chunk;
  p.dw_splits = 1;
  return p;
}

// Launches the tiles of kParts and, when dW has more than one M slice,
// the slice reduction; returns cudaGetLastError(). dw is (dw_rows, Cout)
// f32, ws (dw_splits, dw_rows, Cout) f32 or null for a single slice.
template <typename T, bool kC3, int kParts>
inline int launch_conv_bwd(BwdArgs p, float* dw, float* ws,
                           cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (p.M <= 0 || p.cin <= 0 || p.cout <= 0 || p.stride < 1) return bad;
  p.dx_tiles_m = (p.M + kTileM - 1) / kTileM;
  p.dx_tiles_n = (p.cin + kTileN - 1) / kTileN;
  p.dw_rows = kC3 ? 9 * p.cin : p.cin;
  p.dw_tiles_m = (p.dw_rows + kTileM - 1) / kTileM;
  p.dw_tiles_n = (p.cout + kTileN - 1) / kTileN;
  long long blocks = 0;
  if (kParts & kPartDx) {
    if (p.dx == nullptr || (p.norm_in && p.partial == nullptr)) return bad;
    blocks += (long long)p.dx_tiles_m * p.dx_tiles_n;
  }
  if (kParts & kPartDw) {
    if (p.dw_chunk <= 0 || dw == nullptr) return bad;
    p.dw_splits = (p.M + p.dw_chunk - 1) / p.dw_chunk;
    if (p.dw_splits > 1 && ws == nullptr) return bad;
    p.dw_out = p.dw_splits > 1 ? ws : dw;
    blocks += (long long)p.dw_tiles_m * p.dw_tiles_n * p.dw_splits;
  }
  if (blocks <= 0 || blocks > 0x7fffffffLL) return bad;
  conv_bwd_kernel<T, kC3, kParts>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !(kParts & kPartDw) || p.dw_splits == 1)
    return static_cast<int>(err);
  const long long len = (long long)p.dw_rows * p.cout;
  const long long rblocks = (len + kThreads - 1) / kThreads;
  dw_reduce_kernel<<<static_cast<unsigned>(rblocks < 4096 ? rblocks : 4096),
                     kThreads, 0, stream>>>(ws, dw, len, p.dw_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dl4j
