// Grouped partitioned spectral MACs: G consecutive blocks in one pass over
// the spectra ring and the coefficient bank, CUDA C++ for sm_90a.
//
// Replaces two TPU kernels of brutefir_tpu/ops/pallas_mac.py:
//   bf_mac_group      `_mac_kernel_rowmajor_group` :956 (via
//                     `_group_unfused_call` :1025, `pallas_spectral_mac_group`
//                     :1072): G per-filter spectra, the output mix outside;
//   bf_mac_mix_group  `_mac_mix_kernel_tiled_group` :768 (via
//                     `_tiled_mix_group_call` :909,
//                     `pallas_spectral_mac_mix_group` :1176): the same MAC
//                     with the output mix inside, G mixed spectra.
//
// What they compute. Controls are frozen across the group, so blocks
// t .. t+G-1 share the bank row and the mask. `ring` holds block t's write
// and no later one; `xnews` [F, G-1, 2, K] holds blocks t+1 .. t+G-1's
// in-mixed spectra, which the caller writes into the ring only after the
// launch. Block t+g reads at partition b the spectrum V(g - b), where
//   V(d) = xnews[f, d-1-delay[f]]      if d-1-delay[f] >= 0,
//          ring[f, (t+d) % B]          otherwise,
// which is what the ring would hold after the sequential writes (slots
// that differ otherwise are partitions >= B - delay, which the host's
// cblocks clamp always masks). Then, per packed bin k,
//   Y_{g,f}[k] = sum_{b=0}^{B-1} V(g-b)[k] (x) bank[e_f, b, :, k] * mask[f, b]
// with (x) a complex multiply except at bin 0, where DC (plane 0) and
// Nyquist (plane 1) are two real products: the same substitution applies
// to bin 0 as to every other bin (`_group_bin0_rot`, pallas_mac.py:1055).
// bf_mac_group writes Y as out [G, F, 2, K]; bf_mac_mix_group writes
// out[g, c] = sum_f w[c, f] * Y_{g,f} as out [G, C_out, 2, K].
//
// The window. V depends on d = g - b only, so a thread keeps V(g - b) for
// g = 0 .. G-1 in registers: at b + 1 the window shifts by one and only
// V(-(b+1)) = ring[f, (t-b-1) % B] is loaded. Each ring and xnews element
// is read once, and each bank value h * mask once per b for all G blocks.
// Sums run b = 0..B-1 for each block (and f = 0..F-1 in the mix), FP32
// with FMA, never TF32. t is read from device memory; bank indices are
// clamped into [0, E).
//
// Layout: ring [F, B, 2, K], xnews [F, G-1, 2, K], bank [E, B, 2, K],
// coeff_idx [F] int32, mask [F, B], t device int32 scalar, delay [F]
// int32, w [C_out, F]; float32, contiguous. 2 <= G <= kMaxGroup.
//
// What bounds them on an H100: bytes. At the scale shape (F = C_out = 256,
// B = 16, K = 8192, 256 distinct bank rows) bf_mac_group at G = 4 reads
// the 268 MB ring, 268 MB of bank rows and 50 MB of xnews and writes
// 67 MB of Y: about 653 MB, 195 us a call (49 us a block) at 3.35 TB/s.
// bf_mac_mix_group at G = 2 moves about 586 MB: 175 us a call. Its mix is
// 4.3 GFLOP at G = 2, 64 us at 67 TFLOP/s FP32.
//
// Design. bf_mac_group: one thread per (filter, bin), G accumulator pairs
// in registers, 256 bins a block (coalesced rows), grid (K/256, F).
// bf_mac_mix_group: the tile structure of mac_mix_tiled.cu with G output
// sets. The accumulators are G x kRows x 2 a thread, so the bin tile is
// halved to 16 bins (16 filters a chunk, 16 output rows a pass) and kRows
// is 32 / G rounded down to a power of two: 64 accumulators a thread at
// G = 2 and 256 outputs, a block per 16 bins covering all 256 outputs;
// gridDim.y covers wider mixes at larger G.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroup = 8;
constexpr int kThreads = 256;

// Y_{g,f}[k] for g = 0 .. G-1 (the MAC of both kernels).
template <int G>
__device__ __forceinline__ void group_mac(
    const float* __restrict__ ring, const float* __restrict__ xnews,
    const float* __restrict__ bank, const int* __restrict__ coeff_idx,
    const float* __restrict__ mask, const int* __restrict__ delay, int t,
    int f, int k, int B, int K, int E, float (&yr)[G], float (&yi)[G]) {
  const size_t plane = (size_t)K;
  const size_t part = 2 * (size_t)K;
  const size_t row = (size_t)B * part;
  const int dly = delay[f];
  const int e = min(max(coeff_idx[f], 0), E - 1);
  const float* rf = ring + (size_t)f * row;
  const float* xf = xnews + (size_t)f * (G - 1) * part;
  const float* hb = bank + (size_t)e * row;
  const float* mrow = mask + (size_t)f * B;

  // the window at b = 0: vr[g], vi[g] = V(g)
  float vr[G], vi[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int j = g - 1 - dly;
    const float* src;
    if (j >= 0) {
      src = xf + (size_t)j * part;
    } else {
      const int s = (t + g) % B;
      src = rf + (size_t)s * part;
    }
    vr[g] = src[k];
    vi[g] = src[plane + k];
    yr[g] = 0.f;
    yi[g] = 0.f;
  }
  for (int b = 0; b < B; ++b) {
    if (b > 0) {
      // shift: V(g - b) was V((g-1) - (b-1)); load V(-b), always the ring
#pragma unroll
      for (int g = G - 1; g > 0; --g) {
        vr[g] = vr[g - 1];
        vi[g] = vi[g - 1];
      }
      int s = (t - b) % B;
      s += (s < 0) ? B : 0;
      const float* rs = rf + (size_t)s * part;
      vr[0] = rs[k];
      vi[0] = rs[plane + k];
    }
    const float m = mrow[b];
    const float* hs = hb + (size_t)b * part;
    const float hr = hs[k] * m, hi = hs[plane + k] * m;
    if (k == 0) {
      // packed bin 0: DC and Nyquist are independent real products
#pragma unroll
      for (int g = 0; g < G; ++g) {
        yr[g] += vr[g] * hr;
        yi[g] += vi[g] * hi;
      }
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        yr[g] += vr[g] * hr - vi[g] * hi;
        yi[g] += vr[g] * hi + vi[g] * hr;
      }
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
mac_group_kernel(const float* __restrict__ ring,
                 const float* __restrict__ xnews,
                 const float* __restrict__ bank,
                 const int* __restrict__ coeff_idx,
                 const float* __restrict__ mask,
                 const int* __restrict__ t_ptr,
                 const int* __restrict__ delay, float* __restrict__ out,
                 int F, int B, int K, int E) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int f = blockIdx.y;
  if (k >= K) return;
  float yr[G], yi[G];
  group_mac<G>(ring, xnews, bank, coeff_idx, mask, delay, *t_ptr, f, k, B,
               K, E, yr, yi);
  const size_t part = 2 * (size_t)K;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* o = out + ((size_t)g * F + f) * part;
    o[k] = yr[g];
    o[K + k] = yi[g];
  }
}

constexpr int kTile = 16;                    // bins per block
constexpr int kFc = kThreads / kTile;        // filters per chunk
constexpr int kPass = kThreads / kTile;      // output rows per pass

template <int G>
struct RowsFor {                             // kRows: G * kRows <= 32
  static constexpr int value = G <= 2 ? 16 : (G <= 4 ? 8 : 4);
};

template <int G>
__global__ void __launch_bounds__(kThreads)
mac_mix_group_kernel(const float* __restrict__ ring,
                     const float* __restrict__ xnews,
                     const float* __restrict__ bank,
                     const int* __restrict__ coeff_idx,
                     const float* __restrict__ mask,
                     const int* __restrict__ t_ptr,
                     const int* __restrict__ delay,
                     const float* __restrict__ w, float* __restrict__ out,
                     int F, int B, int K, int E, int C_out) {
  constexpr int kRows = RowsFor<G>::value;
  constexpr int kBlockRows = kPass * kRows;
  __shared__ float ys[G][kFc][2][kTile];
  __shared__ float ws[kFc][kBlockRows + 1];  // +1: no bank conflict on store
  const int t = *t_ptr;
  const int lane = threadIdx.x % kTile;
  const int sub = threadIdx.x / kTile;
  const int k = blockIdx.x * kTile + lane;
  const int c0 = blockIdx.y * kBlockRows;
  const size_t plane = (size_t)K;
  const size_t part = 2 * (size_t)K;

  float accr[G][kRows], acci[G][kRows];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      accr[g][r] = 0.f;
      acci[g][r] = 0.f;
    }
  }

  for (int f0 = 0; f0 < F; f0 += kFc) {
    // 1a. thread (sub, lane) MACs filter f0 + sub at its bin, all G blocks
    const int f = f0 + sub;
    float yr[G], yi[G];
    if (f < F && k < K) {
      group_mac<G>(ring, xnews, bank, coeff_idx, mask, delay, t, f, k, B,
                   K, E, yr, yi);
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        yr[g] = 0.f;
        yi[g] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      ys[g][sub][0][lane] = yr[g];
      ys[g][sub][1][lane] = yi[g];
    }
    // 1b. w[c0 .. c0 + kBlockRows, f0 .. f0 + kFc), zero outside C_out x F
    for (int i = threadIdx.x; i < kFc * kBlockRows; i += kThreads) {
      const int j = i % kFc, r = i / kFc;
      const int c = c0 + r, fj = f0 + j;
      ws[j][r] = (c < C_out && fj < F) ? w[(size_t)c * F + fj] : 0.f;
    }
    __syncthreads();
    // 3. the chunk's filters into this thread's rows, f ascending
    const int fc = min(kFc, F - f0);
    for (int j = 0; j < fc; ++j) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float vr = ys[g][j][0][lane], vi = ys[g][j][1][lane];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float wc = ws[j][sub + kPass * r];
          accr[g][r] = fmaf(wc, vr, accr[g][r]);
          acci[g][r] = fmaf(wc, vi, acci[g][r]);
        }
      }
    }
    __syncthreads();
  }

  if (k < K) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int c = c0 + sub + kPass * r;
        if (c < C_out) {
          float* o = out + ((size_t)g * C_out + c) * part;
          o[k] = accr[g][r];
          o[plane + k] = acci[g][r];
        }
      }
    }
  }
}

template <int G>
int launch_group(const float* ring, const float* xnews, const float* bank,
                 const int* coeff_idx, const float* mask, const int* t,
                 const int* delay, float* out, int F, int B, int K, int E,
                 cudaStream_t s) {
  const dim3 grid((K + kThreads - 1) / kThreads, F);
  mac_group_kernel<G><<<grid, kThreads, 0, s>>>(
      ring, xnews, bank, coeff_idx, mask, t, delay, out, F, B, K, E);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_mix_group(const float* ring, const float* xnews,
                     const float* bank, const int* coeff_idx,
                     const float* mask, const int* t, const int* delay,
                     const float* w, float* out, int F, int B, int K, int E,
                     int C_out, cudaStream_t s) {
  constexpr int rows = kPass * RowsFor<G>::value;
  const dim3 grid((K + kTile - 1) / kTile, (C_out + rows - 1) / rows);
  mac_mix_group_kernel<G><<<grid, kThreads, 0, s>>>(
      ring, xnews, bank, coeff_idx, mask, t, delay, w, out, F, B, K, E,
      C_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for a group size outside 2 .. kMaxGroup. The
// caller allocates `out` and checks shapes; nothing here synchronises.
extern "C" int bf_mac_group(const float* ring, const float* xnews,
                            const float* bank, const int* coeff_idx,
                            const float* mask, const int* t,
                            const int* delay, float* out, int F, int B,
                            int K, int E, int G, void* stream) {
  if (K <= 0 || F <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (G) {
#define BF_CASE(g)                                                        \
  case g:                                                                 \
    return launch_group<g>(ring, xnews, bank, coeff_idx, mask, t, delay,  \
                           out, F, B, K, E, s);
    BF_CASE(2) BF_CASE(3) BF_CASE(4) BF_CASE(5) BF_CASE(6) BF_CASE(7)
    BF_CASE(8)
#undef BF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int bf_mac_mix_group(const float* ring, const float* xnews,
                                const float* bank, const int* coeff_idx,
                                const float* mask, const int* t,
                                const int* delay, const float* w, float* out,
                                int F, int B, int K, int E, int C_out, int G,
                                void* stream) {
  if (K <= 0 || C_out <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (G) {
#define BF_CASE(g)                                                        \
  case g:                                                                 \
    return launch_mix_group<g>(ring, xnews, bank, coeff_idx, mask, t,     \
                               delay, w, out, F, B, K, E, C_out, s);
    BF_CASE(2) BF_CASE(3) BF_CASE(4) BF_CASE(5) BF_CASE(6) BF_CASE(7)
    BF_CASE(8)
#undef BF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

static_assert(kMaxGroup == 8, "the launch switches cover G = 2 .. 8");
