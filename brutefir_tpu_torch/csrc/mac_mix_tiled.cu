// Bin-tiled fused partitioned spectral MAC + output mix, CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel `_mac_mix_kernel_tiled`
// (brutefir_tpu/ops/pallas_mac.py:665, called through `_tiled_mix_call`
// :714-765), the big-shape route of `pallas_spectral_mac_mix` once
// C_out x bins no longer fits beside the ring and bank rows
// (pallas_mac.py:1304-1317; at the 256-channel scale shape). It computes
// what `mac_mix.cu` computes, per packed bin k (planes 0 = re, 1 = im):
//   Y_f[k]     = sum_{b=0}^{B-1} ring[f, (t-b)%B, :, k] (x) bank[e_f, b, :, k] * mask[f, b]
//   out[c,:,k] = sum_{f=0}^{F-1} w[c, f] * Y_f[k]
// with (x) a complex multiply except at bin 0, where DC (plane 0) and
// Nyquist (plane 1) are two real products. Y never reaches device memory.
//
// Layout: ring [F, B, 2, K], bank [E, B, 2, K], coeff_idx [F] int32,
// mask [F, B], t a device int32 scalar (read here: the host never
// synchronises on it), w [C_out, F], out [C_out, 2, K]; float32,
// contiguous. The caller wrote the current block into the ring first.
//
// Design: one thread block of 256 threads per tile of kTile = 32 bins and
// up to 8 * kRows output channels (gridDim.y covers the rest). The block
// owns the tile's C_out x 2 x 32 accumulators in registers: kRows rows x
// 2 planes a thread, 64 at C_out = 256. It walks the filters in chunks of
// kFc = 8:
//   1. warp w MACs filter f0 + w over all B partitions for its 32 bins
//      (lane = bin: coalesced 128-byte rows) into Y[kFc][2][kTile] in
//      shared memory, and the block copies w[:, f0:f0+kFc] beside it;
//   2. __syncthreads();
//   3. thread (w, lane) adds w[c, f] * Y_f for its rows c = w + 8 r and
//      its bin, f ascending, by FMA.
// No atomics and a fixed order: out[c, :, k] = fma chain over f = 0..F-1
// of Y_f, each Y_f summed over b = 0..B-1, FP32 throughout (never TF32;
// the TPU kernel contracts at HIGHEST precision). Bank indices are
// clamped into [0, E) like the TPU gather.
//
// What bounds it on an H100: bytes. At the scale shape (F = C_out = 256,
// B = 16, K = 8192, 256 distinct bank rows) a call reads the 268 MB ring
// and 268 MB of bank rows and writes 16.8 MB: about 553 MB, 165 us at
// 3.35 TB/s. The mix is 2.1 GFLOP, 32 us at the 67 TFLOP/s FP32 rate.
// The kernel of mac_mix.cu keeps its accumulators in the output in
// device memory above 32 outputs: 256 x 256 read-modify-writes a bin.
// Here the output is written once. The copy of w is re-read from L2 by
// each of the K / 32 tiles (64 MB of L2 traffic at the scale shape).
//
// The bf16 operand forms (the entry's ring_bf16 / bank_bf16 flags;
// BRUTEFIR_TPU_RING_DTYPE / BRUTEFIR_TPU_BANK_DTYPE = bf16 on a float32
// graph): the ring and/or the bank (X, H) bfloat16, each value widened
// to float32 as it is loaded (lane = bin: 64-byte rows), the sums, the
// mix and the output float32.
// With both in bf16 a scale-shape call moves 285 MB (85 us). Any K and
// alignment, as the float32 form. The float32 form is the instantiation
// with X = H = float, the same code as before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// A value as float32 (bf16 -> float32 is exact: the 16 bits are the top
// half of the float).
__device__ __forceinline__ float ldv(const float* p) { return *p; }
__device__ __forceinline__ float ldv(const __nv_bfloat16* p) {
  return __uint_as_float(
      static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(p))
      << 16);
}

constexpr int kThreads = 256;
constexpr int kTile = 32;                    // bins per block (one warp row)
constexpr int kFc = kThreads / kTile;        // filters per chunk: one a warp
constexpr int kPass = kThreads / kTile;      // output rows per pass

template <class X, class H, int kRows>
__global__ void __launch_bounds__(kThreads)
mac_mix_tiled_kernel(const X* __restrict__ ring,
                     const H* __restrict__ bank,
                     const int* __restrict__ coeff_idx,
                     const float* __restrict__ mask,
                     const int* __restrict__ t_ptr,
                     const float* __restrict__ w, float* __restrict__ out,
                     int F, int B, int K, int E, int C_out,
                     int has_bin0) {
  constexpr int kBlockRows = kPass * kRows;
  __shared__ float ys[kFc][2][kTile];
  __shared__ float ws[kFc][kBlockRows + 1];  // +1: no bank conflict on store
  const int t = *t_ptr;
  const int lane = threadIdx.x % kTile;
  const int sub = threadIdx.x / kTile;
  const int k = blockIdx.x * kTile + lane;
  const int c0 = blockIdx.y * kBlockRows;
  const size_t plane = (size_t)K;
  const size_t part = 2 * (size_t)K;
  const size_t row = (size_t)B * part;

  float accr[kRows], acci[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    accr[r] = 0.f;
    acci[r] = 0.f;
  }

  for (int f0 = 0; f0 < F; f0 += kFc) {
    // 1a. this warp's filter over all partitions, for its 32 bins
    const int f = f0 + sub;
    float yr = 0.f, yi = 0.f;
    if (f < F && k < K) {
      const int e = min(max(coeff_idx[f], 0), E - 1);
      const X* rf = ring + (size_t)f * row;
      const H* hb = bank + (size_t)e * row;
      const float* mrow = mask + (size_t)f * B;
      for (int b = 0; b < B; ++b) {
        int s = (t - b) % B;
        s += (s < 0) ? B : 0;
        const float m = mrow[b];
        const X* rs = rf + (size_t)s * part;
        const H* hs = hb + (size_t)b * part;
        const float rr = ldv(rs + k), ri = ldv(rs + plane + k);
        const float hr = ldv(hs + k) * m, hi = ldv(hs + plane + k) * m;
        if (has_bin0 && k == 0) {
          // packed bin 0: DC and Nyquist are independent real products
          yr += rr * hr;
          yi += ri * hi;
        } else {
          yr += rr * hr - ri * hi;
          yi += rr * hi + ri * hr;
        }
      }
    }
    ys[sub][0][lane] = yr;
    ys[sub][1][lane] = yi;
    // 1b. w[c0 .. c0 + kBlockRows, f0 .. f0 + kFc): consecutive threads
    // read consecutive filters of one row (zero outside C_out x F)
    for (int i = threadIdx.x; i < kFc * kBlockRows; i += kThreads) {
      const int j = i % kFc, r = i / kFc;
      const int c = c0 + r, fj = f0 + j;
      ws[j][r] = (c < C_out && fj < F) ? w[(size_t)c * F + fj] : 0.f;
    }
    __syncthreads();
    // 3. the chunk's filters into this thread's rows, f ascending
    const int fc = min(kFc, F - f0);
    for (int j = 0; j < fc; ++j) {
      const float vr = ys[j][0][lane], vi = ys[j][1][lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float wc = ws[j][sub + kPass * r];
        accr[r] = fmaf(wc, vr, accr[r]);
        acci[r] = fmaf(wc, vi, acci[r]);
      }
    }
    __syncthreads();
  }

  if (k < K) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int c = c0 + sub + kPass * r;
      if (c < C_out) {
        out[(size_t)c * part + k] = accr[r];
        out[(size_t)c * part + plane + k] = acci[r];
      }
    }
  }
}

template <class X, class H, int kRows>
int launch(const X* ring, const H* bank, const int* coeff_idx,
           const float* mask, const int* t, const float* w, float* out,
           int F, int B, int K, int E, int C_out, int has_bin0,
           cudaStream_t s) {
  const dim3 grid((K + kTile - 1) / kTile,
                  (C_out + kPass * kRows - 1) / (kPass * kRows));
  mac_mix_tiled_kernel<X, H, kRows><<<grid, kThreads, 0, s>>>(
      ring, bank, coeff_idx, mask, t, w, out, F, B, K, E, C_out, has_bin0);
  return static_cast<int>(cudaGetLastError());
}

// 4 rows a thread (32 outputs a block) for small mixes, else 32 (256)
template <class X, class H>
int launch_rows(const X* ring, const H* bank, const int* coeff_idx,
                const float* mask, const int* t, const float* w, float* out,
                int F, int B, int K, int E, int C_out, int has_bin0,
                cudaStream_t s) {
  if (C_out <= kPass * 4)
    return launch<X, H, 4>(ring, bank, coeff_idx, mask, t, w, out, F, B, K,
                           E, C_out, has_bin0, s);
  return launch<X, H, 32>(ring, bank, coeff_idx, mask, t, w, out, F, B, K,
                          E, C_out, has_bin0, s);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out` and checks shapes; nothing here synchronises.
// `has_bin0` as bf_mac_mix's (csrc/mac_mix.cu). ring_bf16 / bank_bf16: 1
// where that operand is bfloat16, else float32 (both 0: the float32 form).
extern "C" int bf_mac_mix_tiled(const void* ring, const void* bank,
                                const int* coeff_idx, const float* mask,
                                const int* t, const float* w, float* out,
                                int F, int B, int K, int E, int C_out,
                                int has_bin0, int ring_bf16, int bank_bf16,
                                void* stream) {
  if (K <= 0 || C_out <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
#define BF_LAUNCH(X, H)                                                    \
  return launch_rows(static_cast<const X*>(ring),                          \
                     static_cast<const H*>(bank), coeff_idx, mask, t, w,   \
                     out, F, B, K, E, C_out, has_bin0, s)
  if (ring_bf16 && bank_bf16) BF_LAUNCH(bf, bf);
  if (ring_bf16) BF_LAUNCH(bf, float);
  if (bank_bf16) BF_LAUNCH(float, bf);
  BF_LAUNCH(float, float);
#undef BF_LAUNCH
}
