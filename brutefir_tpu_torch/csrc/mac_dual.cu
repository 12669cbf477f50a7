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
// once and feeds it to both products. The TPU falls back to two plain MAC
// passes when three resident rows exceed its VMEM budget; the card has no
// such budget, so one core serves every shape.
//
// What it computes, for each stage filter i < Fs and packed bin k, with
// r = rows[i]:
//   Yn[i,:,k] = sum_{b=0}^{B-1} ring[r, (t-b)%B, :, k] (x) bank[e, b, :, k] * m[b]
//   Yo[i,:,k] = sum_{b=0}^{B-1} ring[r, (t-b)%B, :, k] (x) bank[p, b, :, k] * pm[b]
//   uniform = 1: e, m, p, pm are coeff_idx, mask, prev_idx, prev_mask at rows[0];
//   uniform = 0: the same controls at r.
// The kernel, its layout, what bounds it and its design are
// csrc/mac_core.cuh's with two coefficient sets (NS = 2): each ring float4
// feeds both sets' products. So Yn equals
// what csrc/mac.cu computes for (coeff_idx, mask) and Yo what it computes
// for (prev_idx, prev_mask), bit for bit. Against two mac.cu calls it saves
// one full read of the ring rows: at bench5's shape (26 filters, 8192 x 8,
// one shared row a set) a call must move 18.1 MB, 5.4 us at 3.35 TB/s; at
// 256 filters of 8192 x 16 with 256 distinct rows a set 839 MB, 0.25 ms.

#include "mac_core.cuh"

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates both outputs and checks shapes; nothing here
// synchronises.
extern "C" int bf_mac_dual(const float* ring, const float* bank,
                           const int* rows, const int* coeff_idx,
                           const float* mask, const int* prev_idx,
                           const float* prev_mask, const int* t,
                           float* out_new, float* out_old, int F, int Fs,
                           int B, int K, int E, int uniform, void* stream) {
  bf_mac_core::Args<2> a{ring, bank, rows, t,
                         {coeff_idx, prev_idx}, {mask, prev_mask},
                         {out_new, out_old}, F, Fs, B, K, E, uniform};
  return bf_mac_core::launch<2>(a, static_cast<cudaStream_t>(stream));
}
