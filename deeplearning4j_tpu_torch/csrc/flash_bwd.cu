// flash_bwd_dkv and flash_bwd_dq: the flash attention backward, in two
// passes from the forward's saved lse, with p recomputed and never stored.
//
// Replace the TPU kernels deeplearning4j_tpu/ops/pallas_kernels.py:
// _flash_bwd_dkv_kernel and _flash_bwd_dq_kernel (via
// _flash_backward_pallas). With s the masked, scaled scores as in the
// forward, p = exp(s - lse) (0 on a row whose lse <= kNeg / 2),
// dp = dO v^T and ds = p (dp - delta) / sqrt(Dh), delta = rowsum(dO ⊙ O)
// precomputed by the caller:
//   flash_bwd_dkv, one block per key tile: dv += p^T dO, dk += ds^T q over
//   the query tiles (f32 in registers);
//   flash_bwd_dq, one block per query tile: dq += ds k over the key tiles.
// dq, dk and dv come back in the inputs' dtype. The split into two passes
// is the TPU kernels' and is kept: each output is summed by one block in
// a fixed order, with no atomics, so a second call gives the same bits.
//
// What bounds them on the H100. dk/dv do 8·N·H·Tq·Tk·Dh FLOP (s, dp, dv,
// dk) and dq 6· (s, dp, dq), about half of each with the causal mask,
// against reading q, k, v, dO, lse, delta and the mask once and writing
// the gradients once: at the BERT-base slice in bf16 the bytes (about
// 13 us a pass at 3.35 TB/s) bound both before the tensor cores' 989 TF/s
// (7 and 5 us) do. This first version does the products as f32 FMA on
// shared-memory tiles (flash.cuh), bound by 67 TF/s (96 and 72 us there).
//
// What the design does about it: the (Tq, Tk) matrices p and ds live only
// in one 64 x 64 shared-memory tile at a time; the dk/dv block keeps its
// key and value tiles staged for the whole query loop and both
// accumulators in registers; the dq block keeps its query and dO tiles.
// mma.sync or wgmma on the bf16 inputs is the later, faster version.
// Built with nvcc into a shared library with a plain C interface and
// called through ctypes (ops/flash_attention.py:flash_bwd_dkv,
// flash_bwd_dq).
#include "flash.cuh"

namespace dl4j {
namespace flash {

template <int DMAX>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (4 * kB * (DMAX + 1) + 2 * kB * (kB + 1) + 3 * kB);
}

template <int DMAX>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kB * (DMAX + 1) + kB * (kB + 1) + kB);
}

// p and ds of (query row r, key column c) from the scores s, dp and the
// row's (lse, delta)
__device__ __forceinline__ void p_ds(float s, float dp, float lse,
                                     float delta, float scale, float* pv,
                                     float* dsv) {
  const float pij = lse > kNeg * 0.5f ? expf(s - lse) : 0.0f;
  *pv = pij;
  *dsv = pij * (dp - delta) * scale;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Params p) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kB * (DMAX + 1);
  float* Qs = Vs + kB * (DMAX + 1);
  float* dOs = Qs + kB * (DMAX + 1);
  float* Ps = dOs + kB * (DMAX + 1);     // kB x (kB + 1)
  float* dSs = Ps + kB * (kB + 1);       // kB x (kB + 1)
  float* kval = dSs + kB * (kB + 1);
  float* lse_s = kval + kB;
  float* delta_s = lse_s + kB;
  const int k0 = blockIdx.x * kB, hh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  constexpr int kC = DMAX / 16;

  load_tile<T, DMAX>(Ks, static_cast<const T*>(p.k), p.ks, b, hh, k0, p.tk,
                     p.dh);
  load_tile<T, DMAX>(Vs, static_cast<const T*>(p.v), p.vs, b, hh, k0, p.tk,
                     p.dh);
  load_key_valid(kval, p, b, k0);
  float dk[kR][kC], dv[kR][kC];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int jj = 0; jj < kC; ++jj) dk[i][jj] = dv[i][jj] = 0.0f;
  const int nq = (p.tq + kB - 1) / kB;
  // causal: query tiles that end before the key tile starts see none of it
  const int q_first = p.causal ? k0 / kB : 0;
  const size_t rows = (static_cast<size_t>(b) * p.h + hh) * p.tq;
  for (int qt = q_first; qt < nq; ++qt) {
    const int q0 = qt * kB;
    __syncthreads();
    load_tile<T, DMAX>(Qs, static_cast<const T*>(p.q), p.qs, b, hh, q0,
                       p.tq, p.dh);
    load_tile<T, DMAX>(dOs, static_cast<const T*>(p.dout), p.ds, b, hh, q0,
                       p.tq, p.dh);
    for (int r = threadIdx.x; r < kB; r += kThreads) {
      const bool in = q0 + r < p.tq;
      lse_s[r] = in ? p.lse[rows + q0 + r] : kNeg;
      delta_s[r] = in ? p.delta[rows + q0 + r] : 0.0f;
    }
    __syncthreads();
    float s[kR][kR], dp[kR][kR];
    tile_dot<DMAX>(s, Qs, Ks, ty, tx);
    tile_dot<DMAX>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int c = tx + 16 * j;
        p_ds(masked_score(s[i][j], p, kval, c, k0, q0 + r), dp[i][j],
             lse_s[r], delta_s[r], p.scale, &Ps[r * (kB + 1) + c],
             &dSs[r * (kB + 1) + c]);
      }
    }
    __syncthreads();
    acc_tn<DMAX>(dv, Ps, dOs, ty, tx);
    acc_tn<DMAX>(dk, dSs, Qs, ty, tx);
  }

  T* dk_out = static_cast<T*>(p.out);
  T* dv_out = static_cast<T*>(p.out2);
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= p.tk) continue;
    const size_t row =
        ((static_cast<size_t>(b) * p.tk + t) * p.h + hh) * p.dh;
#pragma unroll
    for (int jj = 0; jj < kC; ++jj) {
      const int c = tx + 16 * jj;
      if (c < p.dh) {
        store(dk_out, row + c, dk[i][jj]);
        store(dv_out, row + c, dv[i][jj]);
      }
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) dq_kernel(Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * (DMAX + 1);
  float* Ks = dOs + kB * (DMAX + 1);
  float* Vs = Ks + kB * (DMAX + 1);
  float* dSs = Vs + kB * (DMAX + 1);     // kB x (kB + 1)
  float* kval = dSs + kB * (kB + 1);
  const int q0 = blockIdx.x * kB, hh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  constexpr int kC = DMAX / 16;

  load_tile<T, DMAX>(Qs, static_cast<const T*>(p.q), p.qs, b, hh, q0, p.tq,
                     p.dh);
  load_tile<T, DMAX>(dOs, static_cast<const T*>(p.dout), p.ds, b, hh, q0,
                     p.tq, p.dh);
  const size_t rows = (static_cast<size_t>(b) * p.h + hh) * p.tq;
  float lse[kR], delta[kR], dq[kR][kC];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int t = q0 + ty + 16 * i;
    lse[i] = t < p.tq ? p.lse[rows + t] : kNeg;
    delta[i] = t < p.tq ? p.delta[rows + t] : 0.0f;
#pragma unroll
    for (int jj = 0; jj < kC; ++jj) dq[i][jj] = 0.0f;
  }
  int nk = (p.tk + kB - 1) / kB;
  if (p.causal) {
    const int last = (q0 + kB - 1) / kB + 1;
    nk = nk < last ? nk : last;
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();
    load_tile<T, DMAX>(Ks, static_cast<const T*>(p.k), p.ks, b, hh, k0,
                       p.tk, p.dh);
    load_tile<T, DMAX>(Vs, static_cast<const T*>(p.v), p.vs, b, hh, k0,
                       p.tk, p.dh);
    load_key_valid(kval, p, b, k0);
    __syncthreads();
    float s[kR][kR], dp[kR][kR];
    tile_dot<DMAX>(s, Qs, Ks, ty, tx);
    tile_dot<DMAX>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int c = tx + 16 * j;
        float pij;
        p_ds(masked_score(s[i][j], p, kval, c, k0, q0 + r), dp[i][j],
             lse[i], delta[i], p.scale, &pij, &dSs[r * (kB + 1) + c]);
      }
    }
    __syncthreads();
    acc_nn<DMAX>(dq, dSs, Ks, ty, tx);
  }

  T* dq_out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= p.tq) continue;
    const size_t row =
        ((static_cast<size_t>(b) * p.tq + t) * p.h + hh) * p.dh;
#pragma unroll
    for (int jj = 0; jj < kC; ++jj) {
      const int c = tx + 16 * jj;
      if (c < p.dh) store(dq_out, row + c, dq[i][jj]);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<DMAX>();
  static const cudaError_t granted = allow_smem(dkv_kernel<T, DMAX>, smem);
  if (granted != cudaSuccess) return granted;
  const dim3 grid((p.tk + kB - 1) / kB, p.h, p.n);
  dkv_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dq_smem<DMAX>();
  static const cudaError_t granted = allow_smem(dq_kernel<T, DMAX>, smem);
  if (granted != cudaSuccess) return granted;
  const dim3 grid((p.tq + kB - 1) / kB, p.h, p.n);
  dq_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool dkv, const Params& p, cudaStream_t stream) {
  if (p.dh <= 32)
    return dkv ? launch_dkv<T, 32>(p, stream) : launch_dq<T, 32>(p, stream);
  if (p.dh <= 64)
    return dkv ? launch_dkv<T, 64>(p, stream) : launch_dq<T, 64>(p, stream);
  if (p.dh <= 128)
    return dkv ? launch_dkv<T, 128>(p, stream)
               : launch_dq<T, 128>(p, stream);
  return cudaErrorInvalidValue;
}

int run(bool dkv, const void* q, const void* k, const void* v,
        const void* mask, const void* dout, const void* lse,
        const void* delta, void* out, void* out2, int n, int tq, int tk,
        int h, int dh, int causal, int bf16, const long long* strides,
        void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const float*>(mask);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out = out;
  p.out2 = out2;
  p.n = n;
  p.tq = tq;
  p.tk = tk;
  p.h = h;
  p.dh = dh;
  p.causal = causal;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.ds[i] = strides[9 + i];
  }
  p.scale = softmax_scale(dh);
  if (n <= 0 || tq <= 0 || tk <= 0 || h <= 0 || dh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? dispatch<__nv_bfloat16>(dkv, p, s)
                               : dispatch<float>(dkv, p, s));
}

}  // namespace flash
}  // namespace dl4j

// strides: (n, t, h) of q, k, v and dO, in elements
extern "C" int dl4j_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    int n, int tq, int tk, int h, int dh, int causal, int bf16,
    long long qsn, long long qst, long long qsh, long long ksn,
    long long kst, long long ksh, long long vsn, long long vst,
    long long vsh, long long dsn, long long dst, long long dsh,
    void* stream) {
  const long long s[12] = {qsn, qst, qsh, ksn, kst, ksh,
                           vsn, vst, vsh, dsn, dst, dsh};
  return dl4j::flash::run(true, q, k, v, mask, dout, lse, delta, dk, dv, n,
                          tq, tk, h, dh, causal, bf16, s, stream);
}

extern "C" int dl4j_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, void* dq, int n,
    int tq, int tk, int h, int dh, int causal, int bf16, long long qsn,
    long long qst, long long qsh, long long ksn, long long kst,
    long long ksh, long long vsn, long long vst, long long vsh,
    long long dsn, long long dst, long long dsh, void* stream) {
  const long long s[12] = {qsn, qst, qsh, ksn, kst, ksh,
                           vsn, vst, vsh, dsn, dst, dsh};
  return dl4j::flash::run(false, q, k, v, mask, dout, lse, delta, dq,
                          nullptr, n, tq, tk, h, dh, causal, bf16, s,
                          stream);
}
