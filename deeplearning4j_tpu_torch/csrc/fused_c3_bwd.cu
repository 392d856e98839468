// fused_c3_bwd, fused_c3_bwd_in, fused_c3_bwd_w: the 3x3 SAME conv + BN
// backward, as one launch (replaces the TPU kernel
// deeplearning4j_tpu/ops/fused_conv.py:_c3_bwd_merged_kernel) or as its
// two halves (replace :_c3_bwd_in_kernel and :_c3_bwd_w_kernel). The
// kernel body, what bounds it on the H100 and what its design does about
// that are in conv_bwd.cuh. Built with nvcc into a shared library with a
// plain C interface and called through ctypes (ops/fused_conv.py).
#include "conv_bwd.cuh"

extern "C" int dl4j_tile_m() { return dl4j::kTileM; }

namespace {

template <int kParts>
int launch(const dl4j::BwdArgs& p, float* dw, float* ws, int is_bf16,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dl4j::launch_conv_bwd<__nv_bfloat16, true, kParts>(p, dw, ws, s);
  return dl4j::launch_conv_bwd<float, true, kParts>(p, dw, ws, s);
}

}  // namespace

// dy, y: (N, H, W, Cout); x: (N, H, W, Cin); w: (3, 3, Cin, Cout);
// dst: (2, Cout) f32; scale/shift: (Cin,) f32. dx: x's shape and dtype;
// dw: (3, 3, Cin, Cout) f32; ws: (ceil(M / dw_chunk), 9 * Cin, Cout) f32,
// or null when that is 1; partial: (ceil(M / tile_m), 2, Cin) f32 when
// norm_in. Returns cudaGetLastError().
extern "C" int dl4j_fused_c3_bwd(const void* dy, const void* y, const void* x,
                                 const void* w, const float* dst,
                                 const float* scale, const float* shift,
                                 void* dx, float* dw, float* ws,
                                 float* partial, int n, int h, int wd,
                                 int cin, int cout, int norm_in, int relu_in,
                                 int dw_chunk, int is_bf16, void* stream) {
  const dl4j::BwdArgs p =
      dl4j::bwd_args(dy, y, x, w, dst, scale, shift, dx, partial, n, h, wd,
                     cin, cout, 1, norm_in, relu_in, dw_chunk);
  return launch<dl4j::kPartDx | dl4j::kPartDw>(p, dw, ws, is_bf16, stream);
}

// The dx half: dx and the BN sums (arguments as above).
extern "C" int dl4j_fused_c3_bwd_in(const void* dy, const void* y,
                                    const void* x, const void* w,
                                    const float* dst, const float* scale,
                                    const float* shift, void* dx,
                                    float* partial, int n, int h, int wd,
                                    int cin, int cout, int norm_in,
                                    int relu_in, int is_bf16, void* stream) {
  const dl4j::BwdArgs p =
      dl4j::bwd_args(dy, y, x, w, dst, scale, shift, dx, partial, n, h, wd,
                     cin, cout, 1, norm_in, relu_in, 0);
  return launch<dl4j::kPartDx>(p, nullptr, nullptr, is_bf16, stream);
}

// The dW half (arguments as above; the weight is not read).
extern "C" int dl4j_fused_c3_bwd_w(const void* dy, const void* y,
                                   const void* x, const float* dst,
                                   const float* scale, const float* shift,
                                   float* dw, float* ws, int n, int h, int wd,
                                   int cin, int cout, int norm_in,
                                   int relu_in, int dw_chunk, int is_bf16,
                                   void* stream) {
  const dl4j::BwdArgs p =
      dl4j::bwd_args(dy, y, x, nullptr, dst, scale, shift, nullptr, nullptr,
                     n, h, wd, cin, cout, 1, norm_in, relu_in, dw_chunk);
  return launch<dl4j::kPartDw>(p, dw, ws, is_bf16, stream);
}
