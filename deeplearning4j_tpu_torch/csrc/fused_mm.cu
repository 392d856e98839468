// fused_mm: the 1x1 conv + BN-statistics kernel (replaces the TPU kernel
// deeplearning4j_tpu/ops/fused_conv.py:_mm_kernel). bf16 runs mm_fwd.cuh's
// tensor-core kernel (K slices added in a thread-block cluster), f32
// conv_gemm.cuh's FMA tile (no TF32, K slices added from f32 planes in
// device memory). Their bounds and designs are described in those headers.
// Built with nvcc into a shared library with a plain C interface and called
// through ctypes (ops/fused_conv.py:fused_mm).
#include "conv_gemm.cuh"
#include "mm_fwd.cuh"

extern "C" int dl4j_tile_m() { return dl4j::kTileM; }

// K slices of the f32 kernel for a reduction depth k: its workspace holds
// this many (M, Cout) f32 planes when it is more than one
extern "C" int dl4j_split_count(int k) { return dl4j::split_count(k); }

// x: (N, H, W, Cin) NHWC, w: (Cin, Cout), scale/shift: (Cin,) f32,
// y: (N, Ho, Wo, Cout) with Ho = ceil(H / stride), partial:
// (ceil(M / tile_m), 2, Cout) f32 (written when want_stats). f32: ws is
// (split_count(Cin), M, Cout) f32 or null when split_count is 1, and
// slices and slice_depth are not read. bf16: Cin is cut into `slices`
// slices of `slice_depth` (at most 8, a multiple of 32;
// ops/fused_conv.py:mm_slices) and ws is not read. Returns
// cudaGetLastError().
extern "C" int dl4j_fused_mm(const void* x, const void* w, const float* scale,
                             const float* shift, void* y, float* partial,
                             float* ws, int n, int h, int wd, int cin,
                             int cout, int stride, int norm_in, int relu_in,
                             int slices, int slice_depth, int want_stats,
                             int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    dl4j::c3::FwdArgs a{};
    a.x = static_cast<const __nv_bfloat16*>(x);
    a.w = static_cast<const __nv_bfloat16*>(w);
    a.scale = scale;
    a.shift = shift;
    a.y = static_cast<__nv_bfloat16*>(y);
    a.partial = partial;
    a.cin = cin;
    a.cout = cout;
    a.norm_in = norm_in;
    a.relu_in = relu_in;
    a.want_stats = want_stats;
    a.slices = slices;
    a.slice_depth = slice_depth;
    return dl4j::mm_fwd::launch_fwd(a, n, h, wd, stride, s);
  }
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
  return dl4j::launch_conv_gemm<false>(x, w, scale, shift, y, partial, ws,
                                       g, s);
}
