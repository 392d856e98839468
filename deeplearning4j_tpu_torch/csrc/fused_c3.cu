// fused_c3: the 3x3 SAME conv + BN-statistics kernel (replaces the TPU
// kernel deeplearning4j_tpu/ops/fused_conv.py:_c3_kernel). The TPU kernel
// kept a whole padded image plane in VMEM, which capped the plane size;
// this one is an implicit GEMM tiled over output pixels, so any plane the
// path uses fits (56x56x64 of the 224x224 ResNet50 included). bf16 runs
// c3_fwd.cuh's tensor-core kernel, f32 conv_gemm.cuh's FMA tile (no TF32);
// both cut K into the same slices (c3::split_count): bf16 adds them in a
// thread-block cluster, f32 from f32 planes in device memory. Their bounds
// and designs are described in those headers; bound with ctypes
// (ops/fused_conv.py:fused_c3).
#include "c3_fwd.cuh"

extern "C" int dl4j_tile_m() { return dl4j::kTileM; }

// K slices of a reduction depth k (here k = 9 * Cin)
extern "C" int dl4j_split_count(int k) { return dl4j::c3::split_count(k); }

// x: (N, H, W, Cin) NHWC, w: (3, 3, Cin, Cout) HWIO, scale/shift: (Cin,)
// f32, y: (N, H, W, Cout), partial: (ceil(M / tile_m), 2, Cout) f32
// (written when want_stats), ws: for f32 (split_count(9 Cin), M, Cout) f32
// or null when split_count is 1; bf16 reads none (its slices meet in a
// cluster's shared memory). Returns cudaGetLastError().
extern "C" int dl4j_fused_c3(const void* x, const void* w, const float* scale,
                             const float* shift, void* y, float* partial,
                             float* ws, int n, int h, int wd, int cin,
                             int cout, int norm_in, int relu_in,
                             int want_stats, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    dl4j::c3::FwdArgs a{};
    a.x = static_cast<const __nv_bfloat16*>(x);
    a.w = static_cast<const __nv_bfloat16*>(w);
    a.scale = scale;
    a.shift = shift;
    a.y = static_cast<__nv_bfloat16*>(y);
    a.partial = partial;
    a.H = h;
    a.W = wd;
    a.cin = cin;
    a.cout = cout;
    a.M = n * h * wd;
    a.norm_in = norm_in;
    a.relu_in = relu_in;
    a.want_stats = want_stats;
    return dl4j::c3::launch_fwd(a, s);
  }
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
  g.splits = dl4j::c3::split_count(g.K);
  g.k_per_split = dl4j::c3::slice_depth(g.K);
  return dl4j::launch_conv_gemm<float, true>(x, w, scale, shift, y, partial,
                                             ws, g, s);
}
