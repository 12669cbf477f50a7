// The Hermitian combines shared by csrc/fft_glue.cu and csrc/fft_fused.cu.
// `t` is one row (a.re, a.im, b.re, b.im) of a combine table built in
// float64 and rounded once (ops/fft_glue.ab_table). The expressions are
// written in the order of the plain torch versions (ops/fft_glue.py
// glue_fwd_reference / glue_inv_reference), left to right. The double
// overloads (the glue's float64 form) take the float64 table's row as its
// two halves, ta = (a.re, a.im) and tb = (b.re, b.im).

#pragma once

#include <cuda_runtime.h>

// Forward: X = a Z + b conj(Zm), Zm = Z[(M-k) % M]; packed bin 0 carries
// DC (the combine gives Re Z0 + Im Z0) and Nyquist (Re Z0 - Im Z0) in its
// imaginary slot. Every product and sum is rounded on its own (the _rn
// intrinsics, which the compiler never contracts into a fused
// multiply-add), in the plain version's order: the kernel's float32 and
// float64 values are then the plain torch version's bit for bit, and a
// bfloat16 ring written from them is the plain version's cast.
__device__ __forceinline__ float2 bf_untangle(float4 t, float2 z, float2 zm,
                                              bool bin0) {
  const float mr = zm.x, mi = -zm.y;
  const float xr = __fsub_rn(__fadd_rn(__fsub_rn(__fmul_rn(t.x, z.x),
                                                 __fmul_rn(t.y, z.y)),
                                       __fmul_rn(t.z, mr)),
                             __fmul_rn(t.w, mi));
  const float xi = bin0 ? __fsub_rn(z.x, z.y)
                        : __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t.x, z.y),
                                                        __fmul_rn(t.y, z.x)),
                                              __fmul_rn(t.z, mi)),
                                    __fmul_rn(t.w, mr));
  return make_float2(xr, xi);
}

// Inverse: V = a' K + b' R, K = (kr, ki) the bin and R = (rr, ri) the
// conjugated mirror bin (bin 0: K = (DC, 0), R = (Nyquist, 0)).
__device__ __forceinline__ float2 bf_combine_inv(float4 t, float kr, float ki,
                                                 float rr, float ri) {
  return make_float2(t.x * kr - t.y * ki + t.z * rr - t.w * ri,
                     t.x * ki + t.y * kr + t.z * ri + t.w * rr);
}

__device__ __forceinline__ double2 bf_untangle(double2 ta, double2 tb,
                                               double2 z, double2 zm,
                                               bool bin0) {
  const double mr = zm.x, mi = -zm.y;
  const double xr = __dsub_rn(__dadd_rn(__dsub_rn(__dmul_rn(ta.x, z.x),
                                                  __dmul_rn(ta.y, z.y)),
                                        __dmul_rn(tb.x, mr)),
                              __dmul_rn(tb.y, mi));
  const double xi = bin0 ? __dsub_rn(z.x, z.y)
                         : __dadd_rn(__dadd_rn(__dadd_rn(__dmul_rn(ta.x, z.y),
                                                         __dmul_rn(ta.y, z.x)),
                                               __dmul_rn(tb.x, mi)),
                                     __dmul_rn(tb.y, mr));
  return make_double2(xr, xi);
}

__device__ __forceinline__ double2 bf_combine_inv(double2 ta, double2 tb,
                                                  double kr, double ki,
                                                  double rr, double ri) {
  return make_double2(ta.x * kr - ta.y * ki + tb.x * rr - tb.y * ri,
                      ta.x * ki + ta.y * kr + tb.x * ri + tb.y * rr);
}
