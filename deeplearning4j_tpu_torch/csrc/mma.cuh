// Warp-level tensor-core and asynchronous-copy helpers for sm_90a, as
// inline PTX: mma.sync m16n8k16 with bf16 operands and f32 accumulators,
// ldmatrix (plain and transposed) and 16-byte cp.async with zero fill.
// Shared by c3_bwd_in.cuh (the 3x3 conv's backward-input) and
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

namespace dl4j {
namespace mma {

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

}  // namespace mma
}  // namespace dl4j
