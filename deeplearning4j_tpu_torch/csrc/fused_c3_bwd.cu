// fused_c3_bwd, fused_c3_bwd_in, fused_c3_bwd_w: the 3x3 SAME conv + BN
// backward, in one call (replaces the TPU kernel
// deeplearning4j_tpu/ops/fused_conv.py:_c3_bwd_merged_kernel) or as its
// two halves (replace :_c3_bwd_in_kernel and :_c3_bwd_w_kernel). The
// one-call backward is c3_bwd.cuh's for bf16 (split products on the bf16
// tensor cores) and conv_bwd.cuh's merged FMA kernel for f32; the dx half
// is c3_bwd_in.cuh's (split-K, bf16 tensor cores); the dW half is
// c3_bwd.cuh's tensor-core dW tiles for bf16 (launch_split_dw) and
// conv_bwd.cuh's FMA tiles for f32. Their bounds and designs are described
// in those headers. Built with nvcc into a shared library with a plain C
// interface and called through ctypes (ops/fused_conv.py).
#include "c3_bwd.cuh"
#include "c3_bwd_in.cuh"
#include "conv_bwd.cuh"

extern "C" int dl4j_tile_m() { return dl4j::kTileM; }

// dy, y: (N, H, W, Cout); x: (N, H, W, Cin); w: (3, 3, Cin, Cout);
// dst: (2, Cout) f32; scale/shift: (Cin,) f32. dx: x's shape and dtype;
// dw: (3, 3, Cin, Cout) f32; dw_ws: (ceil(M / dw_chunk), 9 * Cin, Cout)
// f32, or null when that is 1. f32 (conv_bwd.cuh's merged kernel):
// partial is (ceil(M / tile_m), 2, Cin) f32 when norm_in, and ws, sums,
// dyc, slices, slice_depth and tile_rows are not read. bf16 (c3_bwd.cuh):
// ws, partial, sums, dyc, slices, slice_depth and tile_rows are the dx
// product's, as for dl4j_fused_c3_bwd_in below, and dw_chunk is a
// multiple of 32. Returns cudaGetLastError().
extern "C" int dl4j_fused_c3_bwd(const void* dy, const void* y, const void* x,
                                 const void* w, const float* dst,
                                 const float* scale, const float* shift,
                                 void* dx, float* dw, float* dw_ws, float* ws,
                                 float* partial, float* sums, void* dyc,
                                 int n, int h, int wd, int cin, int cout,
                                 int norm_in, int relu_in, int dw_chunk,
                                 int slices, int slice_depth, int tile_rows,
                                 int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    const dl4j::BwdArgs p =
        dl4j::bwd_args(dy, y, x, w, dst, scale, shift, dx, partial, n, h, wd,
                       cin, cout, 1, norm_in, relu_in, dw_chunk);
    return dl4j::launch_conv_bwd<float, true,
                                 dl4j::kPartDx | dl4j::kPartDw>(p, dw, dw_ws,
                                                                s);
  }
  dl4j::bwd_in::InArgs a;
  a.p = dl4j::bwd_args(dy, y, x, w, dst, scale, shift, dx, partial, n, h, wd,
                       cin, cout, 1, norm_in, relu_in, 0);
  a.ws = ws;
  a.sums = sums;
  a.dyc = static_cast<__nv_bfloat16*>(dyc);
  a.slices = slices;
  a.slice_depth = slice_depth;
  a.tile_rows = tile_rows;
  return dl4j::c3_bwd::launch_merged(a, dw, dw_ws, dw_chunk, s);
}

// The dx half: dx and the BN sums (arguments as above, but ws is the
// (slices, N * H * W, Cin) f32 scratch of the K slices, each slice_depth
// deep; partial is (ceil(M / tile_rows), 2, Cin) f32 when norm_in; sums
// (2, Cin) f32 receives (dscale, dshift), zeros without norm_in; dyc is an
// (M, Cout) bf16 scratch, 16-byte aligned, for bf16 inputs (else null)).
extern "C" int dl4j_fused_c3_bwd_in(const void* dy, const void* y,
                                    const void* x, const void* w,
                                    const float* dst, const float* scale,
                                    const float* shift, void* dx, float* ws,
                                    float* partial, float* sums, void* dyc,
                                    int n, int h, int wd,
                                    int cin, int cout, int norm_in,
                                    int relu_in, int slices, int slice_depth,
                                    int tile_rows, int is_bf16,
                                    void* stream) {
  dl4j::bwd_in::InArgs a;
  a.p = dl4j::bwd_args(dy, y, x, w, dst, scale, shift, dx, partial, n, h, wd,
                       cin, cout, 1, norm_in, relu_in, 0);
  a.ws = ws;
  a.sums = sums;
  a.dyc = static_cast<__nv_bfloat16*>(dyc);
  a.slices = slices;
  a.slice_depth = slice_depth;
  a.tile_rows = tile_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dl4j::bwd_in::launch_bwd_in<__nv_bfloat16>(a, s);
  return dl4j::bwd_in::launch_bwd_in<float>(a, s);
}

// The dW half (arguments as above; the weight is not read). f32: the FMA
// tiles of conv_bwd.cuh, dw_chunk from fused_conv.dw_chunk and dyc null.
// bf16: c3_bwd.cuh's launch_split_dw, dw_chunk a multiple of 32 and dyc
// an (M, Cout) bf16 scratch (fused_conv.c3_bwd_w_plan). ws: (ceil(M /
// dw_chunk), 9 Cin, Cout) f32, or null when that is 1.
extern "C" int dl4j_fused_c3_bwd_w(const void* dy, const void* y,
                                   const void* x, const float* dst,
                                   const float* scale, const float* shift,
                                   float* dw, float* ws, void* dyc, int n,
                                   int h, int wd, int cin, int cout,
                                   int norm_in, int relu_in, int dw_chunk,
                                   int is_bf16, void* stream) {
  const dl4j::BwdArgs p =
      dl4j::bwd_args(dy, y, x, nullptr, dst, scale, shift, nullptr, nullptr,
                     n, h, wd, cin, cout, 1, norm_in, relu_in, dw_chunk);
  if (is_bf16)
    return dl4j::c3_bwd::launch_split_dw(
        p, static_cast<__nv_bfloat16*>(dyc), dw, ws, dw_chunk,
        static_cast<cudaStream_t>(stream));
  return dl4j::launch_conv_bwd<float, true, dl4j::kPartDw>(
      p, dw, ws, static_cast<cudaStream_t>(stream));
}
