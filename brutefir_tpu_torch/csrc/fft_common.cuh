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
// imaginary slot.
__device__ __forceinline__ float2 bf_untangle(float4 t, float2 z, float2 zm,
                                              bool bin0) {
  const float mr = zm.x, mi = -zm.y;
  const float xr = t.x * z.x - t.y * z.y + t.z * mr - t.w * mi;
  const float xi = bin0 ? z.x - z.y
                        : t.x * z.y + t.y * z.x + t.z * mi + t.w * mr;
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
  const double xr = ta.x * z.x - ta.y * z.y + tb.x * mr - tb.y * mi;
  const double xi = bin0 ? z.x - z.y
                         : ta.x * z.y + ta.y * z.x + tb.x * mi + tb.y * mr;
  return make_double2(xr, xi);
}

__device__ __forceinline__ double2 bf_combine_inv(double2 ta, double2 tb,
                                                  double kr, double ki,
                                                  double rr, double ri) {
  return make_double2(ta.x * kr - ta.y * ki + tb.x * rr - tb.y * ri,
                      ta.x * ki + ta.y * kr + tb.x * ri + tb.y * rr);
}
