// fused_c3: the 3x3 SAME conv + BN-statistics kernel (replaces the TPU
// kernel deeplearning4j_tpu/ops/fused_conv.py:_c3_kernel). The TPU kernel
// kept a whole padded image plane in VMEM, which capped the plane size;
// this one is an implicit GEMM tiled over output pixels, so any plane the
// path uses fits (56x56x64 of the 224x224 ResNet50 included). The kernel
// body, its bound and design are in conv_gemm.cuh; bound with ctypes
// (ops/fused_conv.py:fused_c3).
#include "conv_gemm.cuh"

extern "C" int dl4j_tile_m() { return dl4j::kTileM; }

// K slices of a reduction depth k (here k = 9 * Cin)
extern "C" int dl4j_split_count(int k) { return dl4j::split_count(k); }

// x: (N, H, W, Cin) NHWC, w: (3, 3, Cin, Cout) HWIO, scale/shift: (Cin,)
// f32, y: (N, H, W, Cout), partial: (ceil(M / tile_m), 2, Cout) f32
// (written when want_stats), ws: (split_count(9 Cin), M, Cout) f32 or null
// when split_count is 1. Returns cudaGetLastError().
extern "C" int dl4j_fused_c3(const void* x, const void* w, const float* scale,
                             const float* shift, void* y, float* partial,
                             float* ws, int n, int h, int wd, int cin,
                             int cout, int norm_in, int relu_in,
                             int want_stats, int is_bf16, void* stream) {
  dl4j::ConvGeom g;
  g.Ho = h;
  g.Wo = wd;
  g.M = n * h * wd;
  g.K = 9 * cin;
  g.N = cout;
  g.H = h;
  g.W = wd;
  g.stride = 1;
  g.cin = cin;
  g.norm_in = norm_in;
  g.relu_in = relu_in;
  g.want_stats = want_stats;
  dl4j::set_split(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dl4j::launch_conv_gemm<__nv_bfloat16, true>(x, w, scale, shift, y,
                                                       partial, ws, g, s);
  return dl4j::launch_conv_gemm<float, true>(x, w, scale, shift, y, partial,
                                             ws, g, s);
}
