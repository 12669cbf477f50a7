// Partitioned spectral MAC without the output mix, CUDA C++ for sm_90a.
//
// Replaces four TPU kernels of brutefir_tpu/ops/pallas_mac.py that compute
// one function: `_mac_kernel_rowmajor` (:102, via `_rowmajor_call`),
// `_mac_kernel_uniform` (:149, via `_uniform_call`), `_mac_kernel_chunked_reg`
// (:318, via `_chunked_call`) and `_mac_kernel` (:79, the "tile" grid of
// `_mac_core`). The TPU picks among the last three by its VMEM budget; the
// card has no such budget, so one kernel serves every shape. It is the MAC
// of the stage loop (filter cascades and single stages that do not take the
// fused MAC + mix), whose per-filter spectra feed the next stage.
//
// What it computes, for each stage filter i < Fs and packed bin k (planes
// 0 = re, 1 = im), with r = rows[i]:
//   Y[i,:,k] = sum_{b=0}^{B-1} ring[r, (t-b)%B, :, k] (x) bank[e, b, :, k] * m[b]
//   uniform = 1: e = coeff_idx[rows[0]], m = mask[rows[0]]  (kernel 7);
//   uniform = 0: e = coeff_idx[r],       m = mask[r]        (kernels 6, 9, 10).
// (x) is a complex multiply, except at bin 0: there DC (plane 0) and Nyquist
// (plane 1) are two independent real products (pallas_mac.py:291-299).
// Sums run b = 0..B-1 in FP32 with FMA (never TF32), like the TPU kernels.
//
// Layout: ring [F, B, 2, K], bank [E, B, 2, K], rows [Fs] int32 (the stage's
// filters: the ring is read in place, never gathered into a copy),
// coeff_idx [F] int32 and mask [F, B] (every filter's controls, read at
// rows[i]), t a device int32 scalar (read here, so the host never waits on
// it), out [Fs, 2, K]; all float32 unless named, contiguous. The caller
// wrote the current block into the ring first. Rows and bank indices are
// clamped into range, so a bad index cannot read out of bounds.
//
// Design: one thread per (filter, bin) with two register accumulators over
// the B partitions; grid (ceil(K / kThreads), Fs). Each thread owns its
// output element: no atomics, and results are the same from run to run.
// Neighbouring threads read neighbouring bins, so every load is coalesced.
//
// What bounds it on an H100: bytes. It must read Fs ring rows and the bank
// rows the stage uses (B * 2 * K * 4 bytes each) and write Fs * 2 * K * 4:
// at bench1's first stage (Fs = 4, B = 8, K = 8192) 4.5 MB, 1.3 us at
// 3.35 TB/s; at a 256-filter stage of 8192 x 16 with 256 distinct rows
// 553 MB, 0.165 ms. The grid holds Fs * K / kThreads blocks (16384 at the
// latter shape), far more than the fused kernel's 128, so enough loads are
// in flight to approach the memory rate at large shapes; at small stages
// the launch itself dominates. The shared bank row of the uniform form is
// read from device memory once and from L2 by the other filters' blocks.
// Vector loads, TMA or a shared-memory ring are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
mac_kernel(const float* __restrict__ ring, const float* __restrict__ bank,
           const int* __restrict__ rows, const int* __restrict__ coeff_idx,
           const float* __restrict__ mask, const int* __restrict__ t_ptr,
           float* __restrict__ out, int F, int B, int K, int E, int uniform) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const int i = blockIdx.y;
  const int t = *t_ptr;
  const size_t plane = (size_t)K;              // re -> im plane
  const size_t part = 2 * (size_t)K;           // one partition
  const size_t row = (size_t)B * part;         // one filter / bank entry
  const int r = min(max(rows[i], 0), F - 1);
  const int sel = uniform ? min(max(rows[0], 0), F - 1) : r;
  const int e = min(max(coeff_idx[sel], 0), E - 1);
  const float* mrow = mask + (size_t)sel * B;
  const float* rf = ring + (size_t)r * row + k;
  const float* hb = bank + (size_t)e * row + k;
  float yr = 0.f, yi = 0.f;
#pragma unroll 4
  for (int b = 0; b < B; ++b) {
    int s = (t - b) % B;
    s += (s < 0) ? B : 0;
    const float m = mrow[b];
    const float* rs = rf + (size_t)s * part;
    const float* hs = hb + (size_t)b * part;
    const float rr = rs[0], ri = rs[plane];
    const float hr = hs[0] * m, hi = hs[plane] * m;
    if (k == 0) {
      // packed bin 0: DC and Nyquist are independent real products
      yr = fmaf(rr, hr, yr);
      yi = fmaf(ri, hi, yi);
    } else {
      yr += rr * hr - ri * hi;
      yi += rr * hi + ri * hr;
    }
  }
  float* o = out + (size_t)i * part + k;
  o[0] = yr;
  o[plane] = yi;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out` and checks shapes; nothing here synchronises.
extern "C" int bf_mac(const float* ring, const float* bank, const int* rows,
                      const int* coeff_idx, const float* mask, const int* t,
                      float* out, int F, int Fs, int B, int K, int E,
                      int uniform, void* stream) {
  if (K <= 0 || Fs <= 0) return 0;
  const dim3 grid((K + kThreads - 1) / kThreads, Fs);
  mac_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ring, bank, rows, coeff_idx, mask, t, out, F, B, K, E, uniform);
  return static_cast<int>(cudaGetLastError());
}
