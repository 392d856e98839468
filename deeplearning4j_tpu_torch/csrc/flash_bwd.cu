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
//   the query tiles;
//   flash_bwd_dq, one block per query tile: dq += ds k over the key tiles.
// Sums are f32; dq, dk and dv come back in the inputs' dtype. The split
// into two passes is the TPU kernels' and is kept: each output element is
// summed by one warp in a fixed order, with no atomics, so a second call
// gives the same bits.
//
// What bounds them on the H100. dk/dv do 8·N·H·Tq·Tk·Dh FLOP (s, dp, dv,
// dk) and dq 6· (s, dp, dq), about half of each with the causal mask,
// against reading q, k, v, dO, lse, delta and the mask once and writing
// the gradients once. At bert_train's shape (N 32, T 128, H 12, Dh 64) in
// bf16 the bytes bound both passes (38 and 32 MB: 11.4 and 9.5 us at
// 3.35 TB/s) before the tensor cores do (3.3 and 2.4 us at 989 TF/s; 4.9
// and 3.3 us with the lo products below). At T 4096 (N 4) the products
// bound them: 0.63 and 0.42 ms with the lo products, against 45 and 38 us
// of bytes.
//
// bf16 (dkv_mma_kernel, dq_mma_kernel): FlashAttention-2's backward
// layout on mma.sync m16n8k16 (flash.cuh, mma.cuh). 4 warps own the
// block's 64 rows, 16 each. The dk/dv block computes the transposed
// products S^T = K Q^T and dP^T = V dO^T, 16 queries at a time, so p^T and
// dS^T come out in the accumulator layout, which is the A layout of the
// next product: dV += P^T dO and dK += dS^T Q take them straight from
// registers, and p and dS never reach shared memory. lse and delta are per
// column there and are staged beside Q and dO. The dq block computes
// S = Q K^T, dP = dO V^T and dQ += dS K the same way, 16 keys at a time.
// p and dS keep f32 accuracy, as in the TPU kernel: each product that
// takes them adds hi·B and lo·B with hi = bf16(x), lo = bf16(x - hi) (the
// error is near 2^-17 of x); q, k, v and dO are exact in bf16, so s and
// dp are single products summed in f32. The other side's tiles (Q, dO, lse
// and delta; or K, V and the key validity) stream through a two-stage
// cp.async ring: tile t + 1 loads while tile t computes, 16 bytes a copy
// where the wrapper finds the views aligned (vec), else with 2-byte loads.
// A warp reads its own 16 rows (K and V, or Q and dO) from shared memory
// at each k-step rather than holding them in registers: held, they cost
// the 32 registers that keep a third block off each SM at DMAX 64, and
// three blocks with the reads ran faster than two without (at bert_train's
// shape and at T 4096; PERF.md §6).
//
// f32 (dkv_kernel, dq_kernel): the products are f32 FMA on f32
// shared-memory tiles (flash.cuh's tile_dot, acc_tn, acc_nn), with p and
// ds in one 64 x 64 shared-memory tile at a time; they carry the f32
// gradient checks.
//
// Both: causal tiles that hold no live score are skipped; rows past T and
// columns past Dh are staged as zero and left out of the stores. Built
// with nvcc into a shared library with a plain C interface and called
// through ctypes (ops/flash_attention.py:flash_bwd_dkv, flash_bwd_dq).
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

// ---- bf16: tensor-core bodies --------------------------------------------

// columns of the other side's tile a sub-step takes: its S and dP stay in
// registers beside the accumulators
constexpr int kSub = 16;

// the block's two tiles, two stages of the other side's two tiles and two
// stages of two f32 rows (lse and delta; the dq pass uses one: key validity)
template <int DMAX>
constexpr size_t bwd_mma_smem() {
  return sizeof(__nv_bfloat16) * 6 * kB * mma_row<DMAX>() +
         sizeof(float) * 4 * kB;
}

// this lane's ldmatrix address of the A fragments of the warp's 16 rows in
// a staged tile (k-step ks at + 16 ks)
template <int DMAX>
__device__ __forceinline__ const __nv_bfloat16* a_rows(
    const __nv_bfloat16* tile, int warp, int lane) {
  return tile + (16 * warp + (lane & 15)) * mma_row<DMAX>() + (lane >> 4) * 8;
}

// acc = A B^T over Dh, A the warp's 16 rows of a staged tile (a, from
// a_rows), B rows [c0, c0 + kSub) of another: S (or S^T) and dP (or dP^T)
// of a sub-step
template <int DMAX>
__device__ __forceinline__ void product_nt(float (&acc)[kSub / 8][4],
                                           const __nv_bfloat16* a,
                                           const __nv_bfloat16* tile, int c0,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < DMAX / 16; ++ks) {
    unsigned af[4], bf[kSub / 16][4];
    mma::ldsm_x4(af, a + 16 * ks);
#pragma unroll
    for (int jp = 0; jp < kSub / 16; ++jp)
      ldsm_b_rows<DMAX>(bf[jp], tile, c0 + 16 * jp, ks, lane);
#pragma unroll
    for (int jp = 0; jp < kSub / 16; ++jp) {
      mma::mma_bf16(acc[2 * jp], af, bf[jp][0], bf[jp][1]);
      mma::mma_bf16(acc[2 * jp + 1], af, bf[jp][2], bf[jp][3]);
    }
  }
}

// out += W X: W the warp's 16 x kSub f32 values in the accumulator layout
// (p or dS, or their transposes), added as hi and lo bf16 halves, X rows
// [c0, c0 + kSub) of a staged tile; keys (or queries) in steps of 16, Dh
// in pairs of 8-column tiles
template <int DMAX>
__device__ __forceinline__ void product_nn_split(
    float (&out)[DMAX / 8][4], const float (&w)[kSub / 8][4],
    const __nv_bfloat16* tile, int c0, int lane) {
#pragma unroll
  for (int kk = 0; kk < kSub / 16; ++kk) {
    unsigned ah[4], al[4];
    split_p(w[2 * kk][0], w[2 * kk][1], ah[0], al[0]);
    split_p(w[2 * kk][2], w[2 * kk][3], ah[1], al[1]);
    split_p(w[2 * kk + 1][0], w[2 * kk + 1][1], ah[2], al[2]);
    split_p(w[2 * kk + 1][2], w[2 * kk + 1][3], ah[3], al[3]);
    // every X fragment of the step, then the hi products, then the lo
    // ones, so no product waits on the one before it
    unsigned xb[DMAX / 16][4];
#pragma unroll
    for (int dp = 0; dp < DMAX / 16; ++dp)
      ldsm_b_cols<DMAX>(xb[dp], tile, c0 + 16 * kk, dp, lane);
#pragma unroll
    for (int dp = 0; dp < DMAX / 16; ++dp) {
      mma::mma_bf16(out[2 * dp], ah, xb[dp][0], xb[dp][1]);
      mma::mma_bf16(out[2 * dp + 1], ah, xb[dp][2], xb[dp][3]);
    }
#pragma unroll
    for (int dp = 0; dp < DMAX / 16; ++dp) {
      mma::mma_bf16(out[2 * dp], al, xb[dp][0], xb[dp][1]);
      mma::mma_bf16(out[2 * dp + 1], al, xb[dp][2], xb[dp][3]);
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kMmaThreads, mma_min_blocks<DMAX>())
    dkv_mma_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRow = mma_row<DMAX>();
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kB * kRow;
  __nv_bfloat16* Qs = Vs + kB * kRow;         // two stages
  __nv_bfloat16* dOs = Qs + 2 * kB * kRow;    // two stages
  float* rows_s = reinterpret_cast<float*>(dOs + 2 * kB * kRow);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout);
  const int k0 = blockIdx.x * kB, hh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t4 = lane & 3;
  const bool vec = p.vec != 0;
  // this thread's two keys (fragment rows g and g + 8) and their validity
  const int kr[2] = {k0 + 16 * warp + (lane >> 2),
                     k0 + 16 * warp + (lane >> 2) + 8};
  bool kok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    kok[r] = kr[r] < p.tk &&
             (p.mask == nullptr ||
              p.mask[static_cast<size_t>(b) * p.tk + kr[r]] > 0.0f);
  const int nq = (p.tq + kB - 1) / kB;
  // causal: query tiles that end before the key tile starts see none of it
  const int q_first = p.causal ? k0 / kB : 0;
  const size_t rows = (static_cast<size_t>(b) * p.h + hh) * p.tq;

  // query tile qt into ring stage st: Q, dO, then lse and delta (rows past
  // Tq read 0: their Q and dO rows are 0, so they add nothing)
  auto stage_q = [&](int st, int qt) {
    const int q0 = qt * kB;
    stage_bf16<DMAX>(Qs + st * kB * kRow, q, p.qs, b, hh, q0, p.tq, p.dh,
                     vec);
    stage_bf16<DMAX>(dOs + st * kB * kRow, dout, p.ds, b, hh, q0, p.tq,
                     p.dh, vec);
    float* lse_s = rows_s + st * 2 * kB;
    for (int r = threadIdx.x; r < kB; r += kMmaThreads) {
      const bool in = q0 + r < p.tq;
      const size_t i = in ? rows + q0 + r : 0;
      mma::cp_async4(lse_s + r, p.lse + i, in);
      mma::cp_async4(lse_s + kB + r, p.delta + i, in);
    }
  };

  stage_bf16<DMAX>(Ks, static_cast<const __nv_bfloat16*>(p.k), p.ks, b, hh,
                   k0, p.tk, p.dh, vec);
  stage_bf16<DMAX>(Vs, static_cast<const __nv_bfloat16*>(p.v), p.vs, b, hh,
                   k0, p.tk, p.dh, vec);
  if (q_first < nq) stage_q(0, q_first);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  const __nv_bfloat16* ka = a_rows<DMAX>(Ks, warp, lane);
  const __nv_bfloat16* va = a_rows<DMAX>(Vs, warp, lane);

  float dk[DMAX / 8][4], dv[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;

  for (int qt = q_first; qt < nq; ++qt) {
    const int cur = (qt - q_first) & 1;
    if (qt + 1 < nq) {   // tile qt + 1 loads while tile qt computes
      stage_q(cur ^ 1, qt + 1);
      mma::cp_async_commit();
    }
    const __nv_bfloat16* Qc = Qs + cur * kB * kRow;
    const __nv_bfloat16* dOc = dOs + cur * kB * kRow;
    const float* lse_c = rows_s + cur * 2 * kB;
    const float* delta_c = lse_c + kB;
    const int q0 = qt * kB;
#pragma unroll
    for (int c0 = 0; c0 < kB; c0 += kSub) {
      // S^T = K Q^T and dP^T = V dO^T over kSub queries; element e of
      // column tile j is key kr[e / 2], query q0 + c0 + 8 j + 2 t4 + e % 2
      float pt[kSub / 8][4], dpt[kSub / 8][4];
      product_nt<DMAX>(pt, ka, Qc, c0, lane);
      product_nt<DMAX>(dpt, va, dOc, c0, lane);
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + 8 * j + 2 * t4 + (e & 1);
          const bool ok = kok[e >> 1] && (!p.causal || kr[e >> 1] <= q0 + c);
          p_ds(ok ? pt[j][e] * p.scale : kNeg, dpt[j][e], lse_c[c],
               delta_c[c], p.scale, &pt[j][e], &dpt[j][e]);
        }
      product_nn_split<DMAX>(dv, pt, dOc, c0, lane);   // dV += P^T dO
      product_nn_split<DMAX>(dk, dpt, Qc, c0, lane);   // dK += dS^T Q
    }
    mma::cp_async_wait<0>();
    __syncthreads();   // tile qt + 1 is staged; tile qt's readers are done
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kr[r] >= p.tk) continue;
    const size_t row =
        ((static_cast<size_t>(b) * p.tk + kr[r]) * p.h + hh) * p.dh;
    store_row_bf16<DMAX>(static_cast<__nv_bfloat16*>(p.out), row, dk, r, t4,
                         p.dh);
    store_row_bf16<DMAX>(static_cast<__nv_bfloat16*>(p.out2), row, dv, r,
                         t4, p.dh);
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kMmaThreads, mma_min_blocks<DMAX>())
    dq_mma_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRow = mma_row<DMAX>();
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + kB * kRow;
  __nv_bfloat16* Ks = dOs + kB * kRow;      // two stages
  __nv_bfloat16* Vs = Ks + 2 * kB * kRow;   // two stages
  float* kval = reinterpret_cast<float*>(Vs + 2 * kB * kRow);   // two stages
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v);
  const int q0 = blockIdx.x * kB, hh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t4 = lane & 3;
  const bool vec = p.vec != 0;
  // this thread's two query rows (fragment rows g and g + 8), their lse
  // and delta
  const int qr[2] = {q0 + 16 * warp + (lane >> 2),
                     q0 + 16 * warp + (lane >> 2) + 8};
  const size_t rows = (static_cast<size_t>(b) * p.h + hh) * p.tq;
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse[r] = qr[r] < p.tq ? p.lse[rows + qr[r]] : kNeg;
    delta[r] = qr[r] < p.tq ? p.delta[rows + qr[r]] : 0.0f;
  }
  int nk = (p.tk + kB - 1) / kB;
  if (p.causal) {
    // key tiles that start after the tile's last query hold no live score
    const int last = (q0 + kB - 1) / kB + 1;
    nk = nk < last ? nk : last;
  }
  auto stage_k = [&](int st, int kt) {
    stage_bf16<DMAX>(Ks + st * kB * kRow, k, p.ks, b, hh, kt * kB, p.tk,
                     p.dh, vec);
    stage_bf16<DMAX>(Vs + st * kB * kRow, v, p.vs, b, hh, kt * kB, p.tk,
                     p.dh, vec);
    load_key_valid(kval + st * kB, p, b, kt * kB);
  };

  stage_bf16<DMAX>(Qs, static_cast<const __nv_bfloat16*>(p.q), p.qs, b, hh,
                   q0, p.tq, p.dh, vec);
  stage_bf16<DMAX>(dOs, static_cast<const __nv_bfloat16*>(p.dout), p.ds, b,
                   hh, q0, p.tq, p.dh, vec);
  stage_k(0, 0);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  const __nv_bfloat16* qa = a_rows<DMAX>(Qs, warp, lane);
  const __nv_bfloat16* da = a_rows<DMAX>(dOs, warp, lane);

  float dq[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {   // tile kt + 1 loads while tile kt computes
      stage_k(cur ^ 1, kt + 1);
      mma::cp_async_commit();
    }
    const __nv_bfloat16* Kc = Ks + cur * kB * kRow;
    const __nv_bfloat16* Vc = Vs + cur * kB * kRow;
    const float* kv = kval + cur * kB;
    const int k0 = kt * kB;
#pragma unroll
    for (int c0 = 0; c0 < kB; c0 += kSub) {
      // S = Q K^T and dP = dO V^T over kSub keys; element e of column tile
      // j is query qr[e / 2], key k0 + c0 + 8 j + 2 t4 + e % 2
      float s[kSub / 8][4], ds[kSub / 8][4];
      product_nt<DMAX>(s, qa, Kc, c0, lane);
      product_nt<DMAX>(ds, da, Vc, c0, lane);
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          p_ds(masked_score(s[j][e], p, kv, c0 + 8 * j + 2 * t4 + (e & 1),
                            k0, qr[r]),
               ds[j][e], lse[r], delta[r], p.scale, &s[j][e], &ds[j][e]);
        }
      product_nn_split<DMAX>(dq, ds, Kc, c0, lane);    // dQ += dS K
    }
    mma::cp_async_wait<0>();
    __syncthreads();   // tile kt + 1 is staged; tile kt's readers are done
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qr[r] >= p.tq) continue;
    const size_t row =
        ((static_cast<size_t>(b) * p.tq + qr[r]) * p.h + hh) * p.dh;
    store_row_bf16<DMAX>(static_cast<__nv_bfloat16*>(p.out), row, dq, r, t4,
                         p.dh);
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

template <int DMAX>
cudaError_t launch_mma(bool dkv, const Params& p, cudaStream_t stream) {
  constexpr size_t smem = bwd_mma_smem<DMAX>();
  if (dkv) {
    static const cudaError_t granted =
        allow_smem(dkv_mma_kernel<DMAX>, smem);
    if (granted != cudaSuccess) return granted;
    const dim3 grid((p.tk + kB - 1) / kB, p.h, p.n);
    dkv_mma_kernel<DMAX><<<grid, kMmaThreads, smem, stream>>>(p);
  } else {
    static const cudaError_t granted = allow_smem(dq_mma_kernel<DMAX>, smem);
    if (granted != cudaSuccess) return granted;
    const dim3 grid((p.tq + kB - 1) / kB, p.h, p.n);
    dq_mma_kernel<DMAX><<<grid, kMmaThreads, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch(bool dkv, bool bf16, const Params& p,
                   cudaStream_t stream) {
  if (bf16) return launch_mma<DMAX>(dkv, p, stream);
  return dkv ? launch_dkv<float, DMAX>(p, stream)
             : launch_dq<float, DMAX>(p, stream);
}

inline cudaError_t dispatch(bool dkv, bool bf16, const Params& p,
                            cudaStream_t stream) {
  if (p.dh <= 32) return launch<32>(dkv, bf16, p, stream);
  if (p.dh <= 64) return launch<64>(dkv, bf16, p, stream);
  if (p.dh <= 128) return launch<128>(dkv, bf16, p, stream);
  return cudaErrorInvalidValue;
}

int run(bool dkv, const void* q, const void* k, const void* v,
        const void* mask, const void* dout, const void* lse,
        const void* delta, void* out, void* out2, int n, int tq, int tk,
        int h, int dh, int causal, int bf16, int vec,
        const long long* strides, void* stream) {
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
  p.vec = vec;
  if (n <= 0 || tq <= 0 || tk <= 0 || h <= 0 || dh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(dkv, bf16 != 0, p,
                                   static_cast<cudaStream_t>(stream)));
}

}  // namespace flash
}  // namespace dl4j

// strides: (n, t, h) of q, k, v and dO, in elements; vec: bf16 views that
// allow 16-byte loads (ops/flash_attention.py:vector_loads)
extern "C" int dl4j_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    int n, int tq, int tk, int h, int dh, int causal, int bf16, int vec,
    long long qsn, long long qst, long long qsh, long long ksn,
    long long kst, long long ksh, long long vsn, long long vst,
    long long vsh, long long dsn, long long dst, long long dsh,
    void* stream) {
  const long long s[12] = {qsn, qst, qsh, ksn, kst, ksh,
                           vsn, vst, vsh, dsn, dst, dsh};
  return dl4j::flash::run(true, q, k, v, mask, dout, lse, delta, dk, dv, n,
                          tq, tk, h, dh, causal, bf16, vec, s, stream);
}

extern "C" int dl4j_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, void* dq, int n,
    int tq, int tk, int h, int dh, int causal, int bf16, int vec,
    long long qsn, long long qst, long long qsh, long long ksn, long long kst,
    long long ksh, long long vsn, long long vst, long long vsh,
    long long dsn, long long dst, long long dsh, void* stream) {
  const long long s[12] = {qsn, qst, qsh, ksn, kst, ksh,
                           vsn, vst, vsh, dsn, dst, dsh};
  return dl4j::flash::run(false, q, k, v, mask, dout, lse, delta, dq,
                          nullptr, n, tq, tk, h, dh, causal, bf16, vec, s,
                          stream);
}
