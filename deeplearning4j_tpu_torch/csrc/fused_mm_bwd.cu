// fused_mm_bwd: the 1x1 conv + BN backward (replaces the TPU kernel
// deeplearning4j_tpu/ops/fused_conv.py:_bwd_merged_kernel). bf16 runs
// mm_bwd.cuh's tensor-core kernels (dyc once, both products in one grid with
// the dx depth's slices in a thread-block cluster, a finish kernel), f32
// conv_bwd.cuh's merged FMA kernel. Their bounds and designs are described
// in those headers. Built with nvcc into a shared library with a plain C
// interface and called through ctypes (ops/fused_conv.py:fused_mm_bwd).
#include "conv_bwd.cuh"
#include "mm_bwd.cuh"

extern "C" int dl4j_tile_m() { return dl4j::kTileM; }

// dy, y: (N, Ho, Wo, Cout) with Ho = ceil(H / stride); x: (N, H, W, Cin);
// w: (Cin, Cout); dst: (2, Cout) f32; scale/shift: (Cin,) f32. dx: x's
// shape and dtype; dw: (Cin, Cout) f32; ws: (ceil(M / dw_chunk), Cin, Cout)
// f32, or null when that is 1; partial: (ceil(M / tile_m), 2, Cin) f32 when
// norm_in. f32 (conv_bwd.cuh): rows of dx off the stride grid are not
// written, and sums, dyc, slices and slice_depth are not read. bf16
// (mm_bwd.cuh): dx is written whole, dw_chunk is a multiple of 32, the Cout
// depth is cut into `slices` slices of `slice_depth` (at most 8, a multiple
// of 32), sums (2, Cin) f32 receives (dscale, dshift), zeros without
// norm_in, and dyc is an (M, Cout) bf16 scratch, 16-byte aligned
// (ops/fused_conv.py:mm_bwd_plan). Returns cudaGetLastError().
extern "C" int dl4j_fused_mm_bwd(const void* dy, const void* y, const void* x,
                                 const void* w, const float* dst,
                                 const float* scale, const float* shift,
                                 void* dx, float* dw, float* ws,
                                 float* partial, float* sums, void* dyc,
                                 int n, int h, int wd, int cin, int cout,
                                 int stride, int norm_in, int relu_in,
                                 int dw_chunk, int slices, int slice_depth,
                                 int is_bf16, void* stream) {
  const dl4j::BwdArgs p =
      dl4j::bwd_args(dy, y, x, w, dst, scale, shift, dx, partial, n, h, wd,
                     cin, cout, stride, norm_in, relu_in, dw_chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dl4j::mm_bwd::launch_bwd(p, dw, ws, sums,
                                    static_cast<__nv_bfloat16*>(dyc),
                                    dw_chunk, slices, slice_depth, s);
  constexpr int kBoth = dl4j::kPartDx | dl4j::kPartDw;
  return dl4j::launch_conv_bwd<float, false, kBoth>(p, dw, ws, s);
}
