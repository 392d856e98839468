// fused_mm_bwd: the 1x1 conv + BN backward in one launch (replaces the TPU
// kernel deeplearning4j_tpu/ops/fused_conv.py:_bwd_merged_kernel). The
// kernel body, what bounds it on the H100 and what its design does about
// that are in conv_bwd.cuh. Built with nvcc into a shared library with a
// plain C interface and called through ctypes
// (ops/fused_conv.py:fused_mm_bwd).
#include "conv_bwd.cuh"

extern "C" int dl4j_tile_m() { return dl4j::kTileM; }

// dy, y: (N, Ho, Wo, Cout) with Ho = ceil(H / stride); x: (N, H, W, Cin);
// w: (Cin, Cout); dst: (2, Cout) f32; scale/shift: (Cin,) f32.
// dx: x's shape and dtype (rows off the stride grid are not written);
// dw: (Cin, Cout) f32; ws: (ceil(M / dw_chunk), Cin, Cout) f32, or null
// when that is 1; partial: (ceil(M / tile_m), 2, Cin) f32 when norm_in.
// Returns cudaGetLastError().
extern "C" int dl4j_fused_mm_bwd(const void* dy, const void* y, const void* x,
                                 const void* w, const float* dst,
                                 const float* scale, const float* shift,
                                 void* dx, float* dw, float* ws,
                                 float* partial, int n, int h, int wd,
                                 int cin, int cout, int stride, int norm_in,
                                 int relu_in, int dw_chunk, int is_bf16,
                                 void* stream) {
  const dl4j::BwdArgs p =
      dl4j::bwd_args(dy, y, x, w, dst, scale, shift, dx, partial, n, h, wd,
                     cin, cout, stride, norm_in, relu_in, dw_chunk);
  constexpr int kBoth = dl4j::kPartDx | dl4j::kPartDw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dl4j::launch_conv_bwd<__nv_bfloat16, false, kBoth>(p, dw, ws, s);
  return dl4j::launch_conv_bwd<float, false, kBoth>(p, dw, ws, s);
}
