// Fused partitioned spectral MAC + output mix, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels `_mac_mix_kernel_rowmajor` and
// `_mac_mix_kernel_uniform` (brutefir_tpu/ops/pallas_mac.py:582-643,
// called through `pallas_spectral_mac_mix`). One kernel, two forms:
//   uniform = 1: every filter reads bank row coeff_idx[0] and mask row 0;
//   uniform = 0: filter f reads bank row coeff_idx[f] and mask row f.
//
// What it computes, per packed bin k (planes 0 = re, 1 = im):
//   Y_f[k]     = sum_{b=0}^{B-1} ring[f, (t-b)%B, :, k] (x) bank[e_f, b, :, k] * mask[f, b]
//   out[c,:,k] = sum_{f=0}^{F-1} w[c, f] * Y_f[k]
// where (x) is a complex multiply, except at bin 0: there DC (plane 0)
// and Nyquist (plane 1) are two independent real products (the d1s/d2s
// rule of the reference, pallas_mac.py:291-299). Y_f never reaches device
// memory: it lives in two registers and is mixed into the output at once,
// which is the point of the fused TPU kernel. Sums run b = 0..B-1, then
// f = 0..F-1, in FP32 with FMA (never TF32), like the TPU kernel.
//
// Layout: ring [F, B, 2, K], bank [E, B, 2, K], coeff_idx [F] int32,
// mask [F, B], t a device int32 scalar (read here, so the host never
// synchronises on it), w [C_out, F], out [C_out, 2, K]; all float32,
// contiguous. The caller wrote the current block into the ring first.
//
// Design: one thread per bin, grid-strided over K. Each thread owns its
// bin's column of `out`, so there are no atomics and results are the same
// from run to run. Up to kRegOut output channels the accumulators live in
// registers; above that they accumulate in `out` in device memory (still
// one owner per element). Bank indices are clamped into [0, E) like the
// TPU gather, so a bad index cannot read out of bounds.
//
// What bounds it on an H100: bytes. At the flagship shape (F = C_out = 26,
// B = 16, K = 8192) a call streams the 27 MB ring, one 1 MB shared bank
// row and writes a 1.7 MB output: about 30 MB, i.e. about 9 us at
// 3.35 TB/s. This simple form does not get there. Its grid has only
// K / kThreads = 128 blocks of two warps, so each SM holds two warps of
// the 64 it could, and too few loads are in flight to cover device-memory
// latency: the kernel is latency bound, and 132 SMs' worth of bandwidth
// sits mostly idle. Splitting the filters across blocks with a second
// reduction pass, or streaming ring rows through shared memory with TMA,
// is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;   // 128 blocks at K = 8192: one per SM
constexpr int kRegOut = 32;    // C_out up to this: register accumulators

template <bool kRegs>
__global__ void __launch_bounds__(kThreads)
mac_mix_kernel(const float* __restrict__ ring, const float* __restrict__ bank,
               const int* __restrict__ coeff_idx,
               const float* __restrict__ mask, const int* __restrict__ t_ptr,
               const float* __restrict__ w, float* __restrict__ out,
               int F, int B, int K, int E, int C_out, int uniform) {
  const int t = *t_ptr;
  const size_t plane = (size_t)K;              // re -> im plane
  const size_t part = 2 * (size_t)K;           // one partition
  const size_t row = (size_t)B * part;         // one filter / bank entry
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < K;
       k += gridDim.x * blockDim.x) {
    float accr[kRegs ? kRegOut : 1];
    float acci[kRegs ? kRegOut : 1];
    if (kRegs) {
#pragma unroll
      for (int c = 0; c < kRegOut; ++c) {
        accr[c] = 0.f;
        acci[c] = 0.f;
      }
    } else {
      for (int c = 0; c < C_out; ++c) {
        out[c * part + k] = 0.f;
        out[c * part + plane + k] = 0.f;
      }
    }
    for (int f = 0; f < F; ++f) {
      const int sel = uniform ? 0 : f;
      const int e = min(max(coeff_idx[sel], 0), E - 1);
      const float* mrow = mask + (size_t)sel * B;
      const float* rf = ring + (size_t)f * row;
      const float* hb = bank + (size_t)e * row;
      float yr = 0.f, yi = 0.f;
#pragma unroll 4
      for (int b = 0; b < B; ++b) {
        int s = (t - b) % B;
        s += (s < 0) ? B : 0;
        const float m = mrow[b];
        const float* rs = rf + (size_t)s * part;
        const float* hs = hb + (size_t)b * part;
        const float rr = rs[k], ri = rs[plane + k];
        const float hr = hs[k] * m, hi = hs[plane + k] * m;
        if (k == 0) {
          // packed bin 0: DC and Nyquist are independent real products
          yr += rr * hr;
          yi += ri * hi;
        } else {
          yr += rr * hr - ri * hi;
          yi += rr * hi + ri * hr;
        }
      }
      if (kRegs) {
#pragma unroll
        for (int c = 0; c < kRegOut; ++c) {
          if (c < C_out) {
            const float wc = w[(size_t)c * F + f];
            accr[c] = fmaf(wc, yr, accr[c]);
            acci[c] = fmaf(wc, yi, acci[c]);
          }
        }
      } else {
        for (int c = 0; c < C_out; ++c) {
          const float wc = w[(size_t)c * F + f];
          float* o = out + c * part;
          o[k] = fmaf(wc, yr, o[k]);
          o[plane + k] = fmaf(wc, yi, o[plane + k]);
        }
      }
    }
    if (kRegs) {
#pragma unroll
      for (int c = 0; c < kRegOut; ++c) {
        if (c < C_out) {
          out[c * part + k] = accr[c];
          out[c * part + plane + k] = acci[c];
        }
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out` and checks shapes; nothing here synchronises.
extern "C" int bf_mac_mix(const float* ring, const float* bank,
                          const int* coeff_idx, const float* mask,
                          const int* t, const float* w, float* out, int F,
                          int B, int K, int E, int C_out, int uniform,
                          void* stream) {
  if (K <= 0 || C_out <= 0) return 0;
  const int grid = (K + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C_out <= kRegOut) {
    mac_mix_kernel<true><<<grid, kThreads, 0, s>>>(
        ring, bank, coeff_idx, mask, t, w, out, F, B, K, E, C_out, uniform);
  } else {
    mac_mix_kernel<false><<<grid, kThreads, 0, s>>>(
        ring, bank, coeff_idx, mask, t, w, out, F, B, K, E, C_out, uniform);
  }
  return static_cast<int>(cudaGetLastError());
}
