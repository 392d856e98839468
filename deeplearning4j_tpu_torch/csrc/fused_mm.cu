// fused_mm: the 1x1 conv + BN-statistics kernel (replaces the TPU kernel
// deeplearning4j_tpu/ops/fused_conv.py:_mm_kernel). The kernel body, what
// bounds it on the H100 and what its design does about that are in
// conv_gemm.cuh. Built with nvcc into a shared library with a plain C
// interface and called through ctypes (ops/fused_conv.py:fused_mm).
#include "conv_gemm.cuh"

extern "C" int dl4j_tile_m() { return dl4j::kTileM; }

// K slices of a reduction depth k: the workspace holds this many (M, Cout)
// f32 planes when it is more than one
extern "C" int dl4j_split_count(int k) { return dl4j::split_count(k); }

// x: (N, H, W, Cin) NHWC, w: (Cin, Cout), scale/shift: (Cin,) f32,
// y: (N, Ho, Wo, Cout) with Ho = ceil(H / stride), partial:
// (ceil(M / tile_m), 2, Cout) f32 (written when want_stats), ws:
// (split_count(Cin), M, Cout) f32 or null when split_count is 1.
// Returns cudaGetLastError().
extern "C" int dl4j_fused_mm(const void* x, const void* w, const float* scale,
                             const float* shift, void* y, float* partial,
                             float* ws, int n, int h, int wd, int cin,
                             int cout, int stride, int norm_in, int relu_in,
                             int want_stats, int is_bf16, void* stream) {
  dl4j::ConvGeom g;
  g.Ho = (h + stride - 1) / stride;
  g.Wo = (wd + stride - 1) / stride;
  g.M = n * g.Ho * g.Wo;
  g.K = cin;
  g.N = cout;
  g.H = h;
  g.W = wd;
  g.stride = stride;
  g.cin = cin;
  g.norm_in = norm_in;
  g.relu_in = relu_in;
  g.want_stats = want_stats;
  dl4j::set_split(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dl4j::launch_conv_gemm<__nv_bfloat16, false>(x, w, scale, shift, y,
                                                        partial, ws, g, s);
  return dl4j::launch_conv_gemm<float, false>(x, w, scale, shift, y, partial,
                                              ws, g, s);
}
