// Partitioned spectral MAC without the output mix, CUDA C++ for sm_90a.
//
// Replaces four TPU kernels of brutefir_tpu/ops/pallas_mac.py that compute
// one function: `_mac_kernel_rowmajor` (:102, via `_rowmajor_call`),
// `_mac_kernel_uniform` (:149, via `_uniform_call`), `_mac_kernel_chunked_reg`
// (:318, via `_chunked_call`) and `_mac_kernel` (:79, the "tile" grid of
// `_mac_core`). The TPU picks among the last three by its VMEM budget; the
// card has no such budget, so one core serves every shape. It is the MAC
// of the stage loop (filter cascades and single stages that do not take the
// fused MAC + mix), whose per-filter spectra feed the next stage.
//
// What it computes, for each stage filter i < Fs and packed bin k, with
// r = rows[i]:
//   Y[i,:,k] = sum_{b=0}^{B-1} ring[r, (t-b)%B, :, k] (x) bank[e, b, :, k] * m[b]
//   uniform = 1: e = coeff_idx[rows[0]], m = mask[rows[0]]  (kernel 7);
//   uniform = 0: e = coeff_idx[r],       m = mask[r]        (kernels 6, 9, 10).
// The kernel, its layout, what bounds it and its design are
// csrc/mac_core.cuh's, with one coefficient set (NS = 1): a thread owns 4
// bins of a filter and streams its ring and bank runs as 16-byte loads. At
// bench1's first stage (Fs = 4, B = 8, K = 8192) a call must move 4.5 MB,
// 1.3 us at 3.35 TB/s; at a 256-filter stage of 8192 x 16 with 256
// distinct rows 553 MB, 0.165 ms.
//
// bf_mac_f64 is the float64 form (float_bits: 64): the same core on
// doubles, FP64 FMAs in the same order. It is the counterpart of the JAX
// package's dense float64 MAC (`spectral_mac_rollh` / `_uniform` under
// `mac = "jnp"`, brutefir_tpu/ops/partconv.py:480, :528), which its
// float64 graphs run in place of the float32-only kernels above. Every
// byte doubles, so its bound does: 9.0 MB at bench1's first stage, 2.7 us.
//
// The bf16 operand forms of bf_mac (its ring_bf16 / bank_bf16 flags;
// BRUTEFIR_TPU_RING_DTYPE / BRUTEFIR_TPU_BANK_DTYPE = bf16 on a float32
// graph): the ring and/or the bank stored as bfloat16 and widened to
// float32 on load, as the JAX kernels' `.astype` on load
// (pallas_mac.py:86-89); the sums and the output float32. Its bytes are
// the bf16 operands' 2 a value: with both in bf16, 285 MB at the
// 256-filter stage of 8192 x 16 (0.085 ms).
// Alignment: the vector path as in float32, a bf16 operand 8-byte
// aligned; else the scalar path (any K).

#include "mac_core.cuh"

// Both launch on `stream` and return cudaGetLastError() (0 on success). The
// caller allocates `out` and checks shapes; nothing here synchronises.
// `has_bin0`: 1 where local bin 0 is the packed DC/Nyquist bin (an
// unsharded call, the first bin shard of a mesh), else 0. bf_mac's
// ring_bf16 / bank_bf16: 1 where that operand is bfloat16, else float32
// (both 0: the float32 form).
extern "C" int bf_mac(const void* ring, const void* bank, const int* rows,
                      const int* coeff_idx, const float* mask, const int* t,
                      float* out, int F, int Fs, int B, int K, int E,
                      int uniform, int has_bin0, int ring_bf16,
                      int bank_bf16, void* stream) {
  bf_mac_core::Args<1> f{nullptr, nullptr, rows, t, {coeff_idx}, {mask},
                         {out}, F, Fs, B, K, E, uniform, has_bin0};
  return bf_mac_core::launch_typed<1>(f, ring, bank, ring_bf16, bank_bf16,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" int bf_mac_f64(const double* ring, const double* bank,
                          const int* rows, const int* coeff_idx,
                          const double* mask, const int* t, double* out,
                          int F, int Fs, int B, int K, int E, int uniform,
                          int has_bin0, void* stream) {
  bf_mac_core::Args<1, double> a{ring, bank, rows, t, {coeff_idx}, {mask},
                                 {out}, F, Fs, B, K, E, uniform, has_bin0};
  return bf_mac_core::launch<1, double>(a,
                                        static_cast<cudaStream_t>(stream));
}

// The launch that bf_mac (sets = 1, real_bytes = 4), bf_mac_f64 (1, 8)
// or bf_mac_dual (2, 4) make for a stage of Fs filters and K bins, with
// the uniform controls or not, ring and bank values of ring_bytes /
// bank_bytes (2 in a bf16 form, else real_bytes): out[0..1] the grid,
// out[2] threads a block, out[3] partitions a thread loads before their
// FMAs. For reports and tests; launches nothing.
extern "C" int bf_mac_plan(int sets, int Fs, int K, int real_bytes,
                           int uniform, int ring_bytes, int bank_bytes,
                           int* out) {
  const auto p = bf_mac_core::plan(sets, Fs, K, real_bytes, uniform,
                                   ring_bytes, bank_bytes);
  out[0] = static_cast<int>(p.grid.x);
  out[1] = static_cast<int>(p.grid.y);
  out[2] = bf_mac_core::kQuads;
  out[3] = p.group;
  return 0;
}
