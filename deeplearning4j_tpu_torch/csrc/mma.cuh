// Warp-level tensor-core and asynchronous-copy helpers for sm_90a, as
// inline PTX: mma.sync m16n8k16 with bf16 operands and f32 accumulators,
// ldmatrix (plain and transposed) and 16-byte cp.async with zero fill.
// Shared by c3_fwd.cuh and mm_fwd.cuh (the 3x3 and 1x1 convs' forward),
// c3_bwd_in.cuh, c3_bwd.cuh and mm_bwd.cuh (their backward) and
// flash_fwd.cu (the attention forward).
//
// Fragment layouts of m16n8k16 (lane = 4 * g + t, g = 0..7, t = 0..3):
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
//     a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]
//   B (16 x 8, k x n, "col"): b0 = B[2t..2t+1][g], b1 = B[2t+8..][g]
//   C (16 x 8, f32): c0, c1 = C[g][2t], C[g][2t+1]; c2, c3 = row g + 8
// ldmatrix.x4 loads four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row
// addresses of matrix i, and lane 4g + t receives row g, columns 2t and
// 2t + 1 of each (with .trans: rows 2t and 2t + 1 of column g).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dl4j {
namespace mma {

// whether a pointer allows 16-byte loads and copies
__host__ __device__ inline bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15u) == 0;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src to shared dst without passing through
// registers; zeros (and src not read) where !valid. Both 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of the cp.async groups this thread committed are
// still in flight (N = 0: all of them have landed)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a * b over one 16 x 8 x 16 step, bf16 products summed in f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// relu?(x * s + b) in f32 without FMA contraction (the plain versions
// round the product first): the conv kernels' input prologue
__device__ __forceinline__ float norm_relu(float x, float s, float b,
                                           int relu) {
  const float e = __fadd_rn(__fmul_rn(x, s), b);
  return relu ? fmaxf(e, 0.0f) : e;
}

// 8 consecutive floats from a 16-byte aligned address into registers
__device__ __forceinline__ void ldg_f8(float (&r)[8], const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

// 8 bf16 (one 16-byte chunk) through norm_relu, rounded back to bf16
__device__ __forceinline__ uint4 norm_relu8(uint4 v, const float (&s)[8],
                                            const float (&b)[8], int relu) {
  const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&v);
  unsigned o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    o[e] = pack_bf16(
        norm_relu(__bfloat162float(e8[2 * e]), s[2 * e], b[2 * e], relu),
        norm_relu(__bfloat162float(e8[2 * e + 1]), s[2 * e + 1],
                  b[2 * e + 1], relu));
  return make_uint4(o[0], o[1], o[2], o[3]);
}

}  // namespace mma
}  // namespace dl4j
