// flash_fwd: blockwise attention with an online softmax, forward.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_kernels.py:
// _flash_fwd_kernel (via _flash_forward): per (batch row, head) and query
// tile, s = q k^T / sqrt(Dh) over key tiles, the key mask and (causal) the
// diagonal set to kNeg, running (m, l, acc) in f32, out = acc / l in q's
// dtype and lse = m + log(l) in f32; a row with no valid key gives out 0
// and lse kNeg. Products are of the inputs' values summed in f32 and p
// stays f32, as in the TPU kernel (no TF32, no bf16 rounding of p).
//
// What bounds it on the H100. 4·N·H·Tq·Tk·Dh FLOP (about half with the
// causal mask) against reading q, k, v and the mask once and writing out
// and lse once: at the BERT-base slice (N 64, T 128, H 12, Dh 64) 3.2
// GFLOP and 50 MB in bf16, so the memory's 3.35 TB/s (15 us) bounds it
// before the tensor cores' 989 TF/s (3.3 us) do; this first version
// does the products as f32 FMA on shared-memory tiles, bound by 67 TF/s
// (48 us there) and in practice by the shared-memory reads each FMA makes.
//
// What the design does about it (flash.cuh): the (Tq, Tk) scores never
// reach device memory; each block stages its query tile once and each key
// tile once, keeps its accumulator in registers (a 4 x Dh/16 register
// tile per thread) and reads every staged value for 4 products. The row
// max and sum are reduced over the 16 threads of a row by warp shuffles.
// Causal tiles above the diagonal are skipped. mma.sync or wgmma on the
// bf16 inputs with TMA-staged tiles is the later, faster version.
// Built with nvcc into a shared library with a plain C interface and
// called through ctypes (ops/flash_attention.py:flash_fwd).
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

template <typename T, int DMAX>
cudaError_t launch_fwd(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<DMAX>();
  static const cudaError_t granted = allow_smem(fwd_kernel<T, DMAX>, smem);
  if (granted != cudaSuccess) return granted;
  const dim3 grid((p.tq + kB - 1) / kB, p.h, p.n);
  fwd_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fwd(const Params& p, cudaStream_t stream) {
  if (p.dh <= 32) return launch_fwd<T, 32>(p, stream);
  if (p.dh <= 64) return launch_fwd<T, 64>(p, stream);
  if (p.dh <= 128) return launch_fwd<T, 128>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace flash
}  // namespace dl4j

extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v,
                              const void* mask, void* out, void* lse, int n,
                              int tq, int tk, int h, int dh, int causal,
                              int bf16, long long qsn, long long qst,
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? dispatch_fwd<__nv_bfloat16>(p, s)
                               : dispatch_fwd<float>(p, s));
}
