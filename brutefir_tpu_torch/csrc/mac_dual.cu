// Crossfade dual MAC: the partitioned spectral MAC against two coefficient
// sets in one pass over the ring, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pair of brutefir_tpu/ops/pallas_mac.py that
// `pallas_spectral_mac_dual` reaches through `_dual_core`:
// `_mac_kernel_rowmajor_dual` (:371, per-filter rows) and
// `_mac_kernel_uniform_dual` (:404, one shared bank row for each set). A
// crossfade block needs the block convolved against both the new and the
// previous coefficients (the crossfade branch of the reference's filter
// loop runs its partition loop twice); this kernel reads each ring element
// once and accumulates both products. The TPU falls back to two plain MAC
// passes when three resident rows exceed its VMEM budget; the card has no
// such budget, so one kernel serves every shape, with the sums in the same
// order b = 0..B-1 either way.
//
// What it computes, for each stage filter i < Fs and packed bin k (planes
// 0 = re, 1 = im), with r = rows[i]:
//   Yn[i,:,k] = sum_{b=0}^{B-1} ring[r, (t-b)%B, :, k] (x) bank[e, b, :, k] * m[b]
//   Yo[i,:,k] = sum_{b=0}^{B-1} ring[r, (t-b)%B, :, k] (x) bank[p, b, :, k] * pm[b]
//   uniform = 1: e, m, p, pm are coeff_idx, mask, prev_idx, prev_mask at rows[0];
//   uniform = 0: the same controls at r.
// (x) is a complex multiply, except at bin 0: there DC (plane 0) and Nyquist
// (plane 1) are two independent real products (pallas_mac.py:291-299, the
// `_bin0` patch of `pallas_spectral_mac_dual`). Sums run b = 0..B-1 in FP32
// (never TF32), like csrc/mac.cu, so Yn equals what mac.cu computes for
// (coeff_idx, mask) and Yo what it computes for (prev_idx, prev_mask).
//
// Layout: ring [F, B, 2, K], bank [E, B, 2, K], rows [Fs] int32 (the stage's
// filters: the ring is read in place, never gathered into a copy),
// coeff_idx / prev_idx [F] int32 and mask / prev_mask [F, B] (every filter's
// controls, read at rows[i]), t a device int32 scalar (read here, so the
// host never waits on it), out_new / out_old [Fs, 2, K]; all float32 unless
// named, contiguous. The caller wrote the current block into the ring first.
// Rows and bank indices are clamped into range, so a bad index cannot read
// out of bounds.
//
// Design: csrc/mac.cu's one thread per (filter, bin), with four register
// accumulators (two complex sums) instead of two; grid (ceil(K / kThreads),
// Fs). Each thread loads its ring element of a partition once and feeds it
// to both products. Each thread owns its two output elements: no atomics,
// results the same from run to run. Neighbouring threads read neighbouring
// bins, so every load is coalesced.
//
// What bounds it on an H100: bytes. It must read Fs ring rows and the bank
// rows both sets use (B * 2 * K * 4 bytes each) and write 2 * Fs * 2 * K * 4:
// at bench5's shape (26 filters, 8192 x 8, one shared row per set) 18.1 MB,
// 5.4 us at 3.35 TB/s; at 256 filters of 8192 x 16 with 256 distinct rows
// per set 839 MB, 0.25 ms. Against two mac.cu calls it saves one full read
// of the ring rows. At small stages the launch itself dominates. Vector
// loads, TMA or a shared-memory ring are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
mac_dual_kernel(const float* __restrict__ ring, const float* __restrict__ bank,
                const int* __restrict__ rows,
                const int* __restrict__ coeff_idx,
                const float* __restrict__ mask,
                const int* __restrict__ prev_idx,
                const float* __restrict__ prev_mask,
                const int* __restrict__ t_ptr, float* __restrict__ out_new,
                float* __restrict__ out_old, int F, int B, int K, int E,
                int uniform) {
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
  const int p = min(max(prev_idx[sel], 0), E - 1);
  const float* mrow = mask + (size_t)sel * B;
  const float* pmrow = prev_mask + (size_t)sel * B;
  const float* rf = ring + (size_t)r * row + k;
  const float* hb = bank + (size_t)e * row + k;
  const float* pb = bank + (size_t)p * row + k;
  float yr = 0.f, yi = 0.f, zr = 0.f, zi = 0.f;
#pragma unroll 4
  for (int b = 0; b < B; ++b) {
    int s = (t - b) % B;
    s += (s < 0) ? B : 0;
    const float m = mrow[b];
    const float pm = pmrow[b];
    const float* rs = rf + (size_t)s * part;
    const size_t hoff = (size_t)b * part;
    const float rr = rs[0], ri = rs[plane];
    const float hr = hb[hoff] * m, hi = hb[hoff + plane] * m;
    const float gr = pb[hoff] * pm, gi = pb[hoff + plane] * pm;
    if (k == 0) {
      // packed bin 0: DC and Nyquist are independent real products
      yr = fmaf(rr, hr, yr);
      yi = fmaf(ri, hi, yi);
      zr = fmaf(rr, gr, zr);
      zi = fmaf(ri, gi, zi);
    } else {
      yr += rr * hr - ri * hi;
      yi += rr * hi + ri * hr;
      zr += rr * gr - ri * gi;
      zi += rr * gi + ri * gr;
    }
  }
  float* o = out_new + (size_t)i * part + k;
  o[0] = yr;
  o[plane] = yi;
  float* q = out_old + (size_t)i * part + k;
  q[0] = zr;
  q[plane] = zi;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates both outputs and checks shapes; nothing here
// synchronises.
extern "C" int bf_mac_dual(const float* ring, const float* bank,
                           const int* rows, const int* coeff_idx,
                           const float* mask, const int* prev_idx,
                           const float* prev_mask, const int* t,
                           float* out_new, float* out_old, int F, int Fs,
                           int B, int K, int E, int uniform, void* stream) {
  if (K <= 0 || Fs <= 0) return 0;
  const dim3 grid((K + kThreads - 1) / kThreads, Fs);
  mac_dual_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ring, bank, rows, coeff_idx, mask, prev_idx, prev_mask, t, out_new,
      out_old, F, B, K, E, uniform);
  return static_cast<int>(cudaGetLastError());
}
