// flash_fwd: blockwise attention with an online softmax, forward.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_kernels.py:
// _flash_fwd_kernel (via _flash_forward): per (batch row, head) and query
// tile, s = q k^T / sqrt(Dh) over key tiles, the key mask and (causal) the
// diagonal set to kNeg, running (m, l, acc) in f32, out = acc / l in q's
// dtype and lse = m + log(l) in f32; a row with no valid key gives out 0
// and lse kNeg. Products are of the inputs' values summed in f32 and p
// keeps f32 accuracy, as in the TPU kernel (no TF32).
//
// What bounds it on the H100. 4·N·H·Tq·Tk·Dh FLOP (about half with the
// causal mask) against reading q, k, v and the mask once and writing out
// and lse once: at the BERT-base slice (N 64, T 128, H 12, Dh 64) 3.2
// GFLOP and 50 MB in bf16, so the memory's 3.35 TB/s (15 us) bounds it
// before the tensor cores' 989 TF/s (3.3 us) do. In f32 the FMA units'
// 67 TF/s (48 us) bound it.
//
// bf16 (fwd_mma_kernel), the FlashAttention-2 layout: 4 warps own the
// block's 64 query rows, 16 each, and read their Q fragments from shared
// memory at each step, which leaves the registers to the accumulators.
// S = Q K^T runs on mma.sync m16n8k16 (bf16 products are exact, summed in
// f32); the online softmax runs on the accumulator fragments, the row
// max and sum reduced over each quad of lanes by shuffles (one fixed
// order, so every lane of a row holds the same bits). P·V keeps p at f32
// accuracy: p = hi + lo with hi = bf16(p), lo = bf16(p - hi), and two
// MMAs add hi·V and lo·V into the f32 accumulator (V is exact in bf16;
// the error is near 2^-17 of p). K and V tiles are staged as bf16 by
// 16-byte cp.async into rows padded to DMAX + 8 elements, so ldmatrix
// (K plain as QK^T's B operand, V with .trans as P·V's) has no bank
// conflicts, in two stages: tile k + 1 loads while tile k computes. Where
// the wrapper finds the bases or strides unfit for 16-byte loads (Dh not a
// multiple of 8, say) the same kernel stages with 2-byte loads.
//
// f32 (fwd_kernel, flash.cuh): the products are f32 FMA on f32
// shared-memory tiles; each block stages its query tile once and each key
// tile once, keeps its accumulator in registers (a 4 x Dh/16 register
// tile per thread) and reads every staged value for 4 products.
//
// Both: the (Tq, Tk) scores never reach device memory, causal tiles above
// the diagonal are skipped, every sum has a fixed order and no float
// atomics are used, so a second call gives the same bits. Built with nvcc
// into a shared library with a plain C interface and called through
// ctypes (ops/flash_attention.py:flash_fwd).
#include "flash.cuh"

namespace dl4j {
namespace flash {

template <int DMAX>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kB * (DMAX + 1) + kB * (kB + 1) + kB);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kB * (DMAX + 1);
  float* Vs = Ks + kB * (DMAX + 1);
  float* Ps = Vs + kB * (DMAX + 1);   // kB x (kB + 1): this tile's p
  float* kval = Ps + kB * (kB + 1);
  const int q0 = blockIdx.x * kB, hh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31;
  constexpr int kC = DMAX / 16;

  load_tile<T, DMAX>(Qs, static_cast<const T*>(p.q), p.qs, b, hh, q0, p.tq,
                     p.dh);
  float m[kR], l[kR], acc[kR][kC];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kC; ++jj) acc[i][jj] = 0.0f;
  }
  int nk = (p.tk + kB - 1) / kB;
  if (p.causal) {
    // key tiles that start after the tile's last query hold no live score
    const int last = (q0 + kB - 1) / kB + 1;
    nk = nk < last ? nk : last;
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, DMAX>(Ks, static_cast<const T*>(p.k), p.ks, b, hh, k0,
                       p.tk, p.dh);
    load_tile<T, DMAX>(Vs, static_cast<const T*>(p.v), p.vs, b, hh, k0,
                       p.tk, p.dh);
    load_key_valid(kval, p, b, k0);
    __syncthreads();
    float s[kR][kR];
    tile_dot<DMAX>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        s[i][j] = masked_score(s[i][j], p, kval, tx + 16 * j, k0, q0 + r);
        mx = fmaxf(mx, s[i][j]);
      }
      // the row's 16 threads are one half of a warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const float pij = expf(s[i][j] - m_new);
        Ps[r * (kB + 1) + tx + 16 * j] = pij;
        sum += pij;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      // one lane's sum for the whole row, so every thread of it agrees
      sum = __shfl_sync(kFull, sum, lane & 16);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < kC; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();
    acc_nn<DMAX>(acc, Ps, Vs, ty, tx);
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= p.tq) continue;
    const bool valid = m[i] > kNeg * 0.5f;
    const float l_safe = l[i] > 0.0f ? l[i] : 1.0f;
    const size_t row =
        ((static_cast<size_t>(b) * p.tq + t) * p.h + hh) * p.dh;
#pragma unroll
    for (int jj = 0; jj < kC; ++jj) {
      const int c = tx + 16 * jj;
      if (c < p.dh) store(out, row + c, valid ? acc[i][jj] / l_safe : 0.0f);
    }
    if (tx == 0)
      p.lse_out[(static_cast<size_t>(b) * p.h + hh) * p.tq + t] =
          valid ? m[i] + logf(l_safe) : kNeg;
  }
}

template <int DMAX>
cudaError_t launch_fwd(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<DMAX>();
  static const cudaError_t granted = allow_smem(fwd_kernel<float, DMAX>, smem);
  if (granted != cudaSuccess) return granted;
  const dim3 grid((p.tq + kB - 1) / kB, p.h, p.n);
  fwd_kernel<float, DMAX><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---- bf16: tensor-core body ----------------------------------------------

template <int DMAX>
constexpr size_t mma_smem() {   // Q, two stages of K and V, key validity
  return sizeof(__nv_bfloat16) * 5 * kB * mma_row<DMAX>() +
         sizeof(float) * 2 * kB;
}

template <int DMAX>
__global__ void __launch_bounds__(kMmaThreads, mma_min_blocks<DMAX>())
    fwd_mma_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRow = mma_row<DMAX>();
  constexpr int kD16 = DMAX / 16;   // k-steps of QK^T; pairs of d tiles
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kB * kRow;       // two stages
  __nv_bfloat16* Vs = Ks + 2 * kB * kRow;   // two stages
  float* kval = reinterpret_cast<float*>(Vs + 2 * kB * kRow);   // two stages
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v);
  const int q0 = blockIdx.x * kB, hh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const bool vec = p.vec != 0;
  // this thread's two query rows (fragment rows g and g + 8)
  const int qr[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};

  int nk = (p.tk + kB - 1) / kB;
  if (p.causal) {
    // key tiles that start after the tile's last query hold no live score
    const int last = (q0 + kB - 1) / kB + 1;
    nk = nk < last ? nk : last;
  }
  stage_bf16<DMAX>(Qs, q, p.qs, b, hh, q0, p.tq, p.dh, vec);
  stage_bf16<DMAX>(Ks, k, p.ks, b, hh, 0, p.tk, p.dh, vec);
  stage_bf16<DMAX>(Vs, v, p.vs, b, hh, 0, p.tk, p.dh, vec);
  load_key_valid(kval, p, b, 0);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();

  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
  float o[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {   // tile kt + 1 loads while tile kt computes
      const int nxt = cur ^ 1;
      stage_bf16<DMAX>(Ks + nxt * kB * kRow, k, p.ks, b, hh, (kt + 1) * kB,
                       p.tk, p.dh, vec);
      stage_bf16<DMAX>(Vs + nxt * kB * kRow, v, p.vs, b, hh, (kt + 1) * kB,
                       p.tk, p.dh, vec);
      load_key_valid(kval + nxt * kB, p, b, (kt + 1) * kB);
      mma::cp_async_commit();
    }
    const __nv_bfloat16* Kc = Ks + cur * kB * kRow;
    const __nv_bfloat16* Vc = Vs + cur * kB * kRow;
    const float* kv = kval + cur * kB;
    const int k0 = kt * kB;

    // s = q k^T: 8 key tiles of 8, over Dh in steps of 16
    float s[kB / 8][4];
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kD16; ++ks) {
      // every fragment of the step first (Q's from shared memory again,
      // which leaves its registers to the accumulators), then 8 products
      unsigned qf[4], bf[kB / 16][4];
      mma::ldsm_x4(qf, Qs + (16 * warp + (lane & 15)) * kRow + 16 * ks +
                           (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < kB / 16; ++jp)
        ldsm_b_rows<DMAX>(bf[jp], Kc, 16 * jp, ks, lane);
#pragma unroll
      for (int jp = 0; jp < kB / 16; ++jp) {
        mma::mma_bf16(s[2 * jp], qf, bf[jp][0], bf[jp][1]);
        mma::mma_bf16(s[2 * jp + 1], qf, bf[jp][2], bf[jp][3]);
      }
    }

    // online softmax on the fragments: element e of key tile j is row
    // qr[e / 2], key k0 + 8 j + 2 t4 + e % 2. A tile of valid keys that
    // no causal diagonal reaches is only scaled.
    const bool plain = p.mask == nullptr && k0 + kB <= p.tk &&
                       (!p.causal || k0 + kB - 1 <= q0);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = plain ? s[j][e] * p.scale
                        : masked_score(s[j][e], p, kv,
                                       8 * j + 2 * t4 + (e & 1), k0,
                                       qr[e >> 1]);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
      sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

    // o += p v, p = hi + lo: keys in steps of 16, Dh in pairs of 8-tiles
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      unsigned ah[4], al[4];
      split_p(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      split_p(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      split_p(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
      split_p(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
      // all of the step's V fragments, then the hi products, then the lo
      // ones, so no product waits on the one before it
      unsigned vb[kD16][4];
#pragma unroll
      for (int dp = 0; dp < kD16; ++dp)
        ldsm_b_cols<DMAX>(vb[dp], Vc, 16 * kk, dp, lane);
#pragma unroll
      for (int dp = 0; dp < kD16; ++dp) {
        mma::mma_bf16(o[2 * dp], ah, vb[dp][0], vb[dp][1]);
        mma::mma_bf16(o[2 * dp + 1], ah, vb[dp][2], vb[dp][3]);
      }
#pragma unroll
      for (int dp = 0; dp < kD16; ++dp) {
        mma::mma_bf16(o[2 * dp], al, vb[dp][0], vb[dp][1]);
        mma::mma_bf16(o[2 * dp + 1], al, vb[dp][2], vb[dp][3]);
      }
    }
    mma::cp_async_wait<0>();
    __syncthreads();   // tile kt + 1 is staged; tile kt's readers are done
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = qr[r];
    if (t >= p.tq) continue;
    const bool valid = m[r] > kNeg * 0.5f;
    const float l_safe = l[r] > 0.0f ? l[r] : 1.0f;
    const size_t row =
        ((static_cast<size_t>(b) * p.tq + t) * p.h + hh) * p.dh;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e)
        o[j][e] = valid ? o[j][e] / l_safe : 0.0f;
    store_row_bf16<DMAX>(out, row, o, r, t4, p.dh);
    if (t4 == 0)
      p.lse_out[(static_cast<size_t>(b) * p.h + hh) * p.tq + t] =
          valid ? m[r] + logf(l_safe) : kNeg;
  }
}

template <int DMAX>
cudaError_t launch_fwd_mma(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = mma_smem<DMAX>();
  static const cudaError_t granted = allow_smem(fwd_mma_kernel<DMAX>, smem);
  if (granted != cudaSuccess) return granted;
  const dim3 grid((p.tq + kB - 1) / kB, p.h, p.n);
  fwd_mma_kernel<DMAX><<<grid, kMmaThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

inline cudaError_t dispatch_fwd(const Params& p, bool bf16,
                                cudaStream_t stream) {
  if (p.dh <= 32)
    return bf16 ? launch_fwd_mma<32>(p, stream) : launch_fwd<32>(p, stream);
  if (p.dh <= 64)
    return bf16 ? launch_fwd_mma<64>(p, stream) : launch_fwd<64>(p, stream);
  if (p.dh <= 128)
    return bf16 ? launch_fwd_mma<128>(p, stream) : launch_fwd<128>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace flash
}  // namespace dl4j

extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v,
                              const void* mask, void* out, void* lse, int n,
                              int tq, int tk, int h, int dh, int causal,
                              int bf16, int vec, long long qsn, long long qst,
                              long long qsh, long long ksn, long long kst,
                              long long ksh, long long vsn, long long vst,
                              long long vsh, void* stream) {
  using namespace dl4j::flash;
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const float*>(mask);
  p.out = out;
  p.lse_out = static_cast<float*>(lse);
  p.n = n;
  p.tq = tq;
  p.tk = tk;
  p.h = h;
  p.dh = dh;
  p.causal = causal;
  p.qs[0] = qsn; p.qs[1] = qst; p.qs[2] = qsh;
  p.ks[0] = ksn; p.ks[1] = kst; p.ks[2] = ksh;
  p.vs[0] = vsn; p.vs[1] = vst; p.vs[2] = vsh;
  p.scale = softmax_scale(dh);
  if (n <= 0 || tq <= 0 || tk <= 0 || h <= 0 || dh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.vec = vec;
  return static_cast<int>(
      dispatch_fwd(p, bf16 != 0, static_cast<cudaStream_t>(stream)));
}
