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
// bf_mac_mix_group: see the note above mac_mix_group_kernel below. In
// short: 32-bin tiles with all 256 output rows at G = 2 in one block of
// 16 warps, each warp streaming its filter's ring, xnews and bank rows
// through its own cp.async stage ring, the output mix an FP32
// register-tiled outer product from shared memory, each warp's share run
// at its own stage of the next round.
// The form it replaces (PR 2) kept kRows x G x 2 accumulators a thread
// with 16-bin tiles, one dependent round trip of loads a partition and a
// mix of 2 FMAs a shared load, and ran at 31% of the byte bound.
//
// The bf16 operand forms (the entries' ring_bf16 / bank_bf16 flags;
// BRUTEFIR_TPU_RING_DTYPE / BRUTEFIR_TPU_BANK_DTYPE = bf16 on a float32
// graph): the ring and xnews (X, always one type: the caller casts the
// group's spectra to the ring's) and/or the bank (H) are bfloat16, every
// value widened to float32 where it is loaded, as the JAX kernels'
// `.astype` on load; the mask, w, the sums and the outputs float32.
// bf_mac_group's bf16 forms take their own kernel, mac_group_bf16_kernel
// (the note above it): kGVec bins a thread from one 8-byte bf16 load (a
// 16-byte float4 for a float32 operand), kGDepth partitions' loads in
// flight. bf_mac_mix_group's form with both operands in bf16 takes its
// own too, mac_mix_group_bf16_kernel (the note above it): the float32
// form's design with bf16 runs staged densely (64 bytes, 4 chunks; two
// positions of 16 chunks a warp-wide copy), 6 positions a stage, the mix
// staggered over each SM sub-partition's warps. Its forms with one
// float32 operand are the float32 form's kernel staging each bf16 run as
// chunks 0-3 of the run's slot (lanes 4-7 of a bf16 run copy nothing).
// Both bf16 forms take the aligned path only (K % 8 == 0, ring, xnews,
// bank and out 16-byte aligned; the wrapper raises ValueError
// elsewhere). bf_mac_group's
// float32 form is group_mac and mac_group_kernel, the first port's
// code; bf_mac_mix_group's is mac_mix_group_kernel with X = H = float.

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

// A value as float32 (bf16 -> float32 is exact: the 16 bits are the top
// half of the float).
__device__ __forceinline__ float ldv(const float* p) { return *p; }
__device__ __forceinline__ float ldv(const __nv_bfloat16* p) {
  return __uint_as_float(
      static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(p))
      << 16);
}

constexpr int kMaxGroup = 8;
constexpr int kThreads = 256;

// Y_{g,f}[k] for g = 0 .. G-1 (the MAC of bf_mac_group).
template <int G>
__device__ __forceinline__ void group_mac(
    const float* __restrict__ ring, const float* __restrict__ xnews,
    const float* __restrict__ bank, const int* __restrict__ coeff_idx,
    const float* __restrict__ mask, const int* __restrict__ delay, int t,
    int f, int k, int B, int K, int E, bool bin0, float (&yr)[G],
    float (&yi)[G]) {
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
    if (bin0) {
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
                 int F, int B, int K, int E, int has_bin0) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int f = blockIdx.y;
  if (k >= K) return;
  float yr[G], yi[G];
  group_mac<G>(ring, xnews, bank, coeff_idx, mask, delay, *t_ptr, f, k, B,
               K, E, has_bin0 && k == 0, yr, yi);
  const size_t part = 2 * (size_t)K;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* o = out + ((size_t)g * F + f) * part;
    o[k] = yr[g];
    o[K + k] = yi[g];
  }
}

template <int G>
int launch_group(const float* ring, const float* xnews, const float* bank,
                 const int* coeff_idx, const float* mask, const int* t,
                 const int* delay, float* out, int F, int B, int K, int E,
                 int has_bin0, cudaStream_t s) {
  const dim3 grid((K + kThreads - 1) / kThreads, F);
  mac_group_kernel<G><<<grid, kThreads, 0, s>>>(
      ring, xnews, bank, coeff_idx, mask, t, delay, out, F, B, K, E,
      has_bin0);
  return static_cast<int>(cudaGetLastError());
}

// bf_mac_group's bf16 forms. What limited the form this replaces
// (group_mac above with bf16 loads) on an H100: one thread a bin loads 2
// bytes a value, so a warp's load is 64 bytes where float32 moves 128,
// and each thread had one partition's loads in flight. The bytes in
// flight halved with the operand size, and the time stayed near
// float32's (0.2271 against 0.2469 ms at G = 4 at the scale shape, 47%
// of its 0.1077 ms bound).
// This kernel keeps group_mac's register window (each ring and xnews
// value read once for G blocks, the bank value and mask once a
// partition) and its sums (b ascending, the same expressions, bin 0 two
// real products where has_bin0), and changes what a thread moves:
//   - kGVec = 4 consecutive bins a thread: each run is one 8-byte load of
//     4 bf16 values (a 16-byte float4 for a float32 operand), widened in
//     registers; a warp's load is 256 bytes;
//   - the operands of partition b + kGDepth (ring slot, bank partition,
//     mask) are loaded while partition b is summed: kGDepth partitions'
//     loads in flight a thread;
//   - outputs as float4 stores; blocks of kGThreads threads, grid (K /
//     (kGVec kGThreads), F): 4096 blocks at F = 256, K = 8192.
// Registers: 4 G kGVec for the window and sums (64 at G = 4; ptxas: 158
// a thread at G = 4, 254 at G = 8, no spills). On an H100 with both in
// bf16 at the scale shape: 0.144 ms at G = 4, 74% of the bound (the
// replaced form 0.231). chip_mac_bf16_designs.py keeps the forms
// measured beside it: 2 or 8 bins a thread, 1, 3 or 4 partitions in
// flight, 256 threads a block; 8 bins a thread is 6% faster at G = 3-4
// but spills at G = 8 (0.96 ms against 0.22), so one form serves every
// G.

constexpr int kGThreads = 128;
constexpr int kGVec = 4;                     // bins a thread
constexpr int kGDepth = 2;                   // partitions' loads in flight

// kGVec values of T as they lie in memory, in 32-bit words.
template <class T>
struct Raw {
  static constexpr int kWords = kGVec * (int)sizeof(T) / 4;
  unsigned w[kWords];
};

template <class T>
__device__ __forceinline__ Raw<T> ld_raw(const T* p) {
  Raw<T> r;
  constexpr int n = Raw<T>::kWords;
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int i = 0; i < n / 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      r.w[4 * i] = v.x;
      r.w[4 * i + 1] = v.y;
      r.w[4 * i + 2] = v.z;
      r.w[4 * i + 3] = v.w;
    }
  } else if constexpr (n == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    r.w[0] = v.x;
    r.w[1] = v.y;
  } else {
    r.w[0] = *reinterpret_cast<const unsigned*>(p);
  }
  return r;
}

__device__ __forceinline__ void widen(const Raw<float>& r,
                                      float (&v)[kGVec]) {
#pragma unroll
  for (int i = 0; i < kGVec; ++i) v[i] = __uint_as_float(r.w[i]);
}
__device__ __forceinline__ void widen(const Raw<__nv_bfloat16>& r,
                                      float (&v)[kGVec]) {
#pragma unroll
  for (int i = 0; i < kGVec / 2; ++i) {
    v[2 * i] = __uint_as_float(r.w[i] << 16);
    v[2 * i + 1] = __uint_as_float(r.w[i] & 0xffff0000u);
  }
}

// kGVec floats to 16-byte (or, at kGVec = 2, 8-byte) aligned `o`.
__device__ __forceinline__ void st_vec(float* o, const float (&v)[kGVec]) {
  if constexpr (kGVec % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kGVec; i += 4)
      *reinterpret_cast<float4*>(o + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < kGVec; i += 2)
      *reinterpret_cast<float2*>(o + i) = make_float2(v[i], v[i + 1]);
  }
}

template <int G, class X, class H>
__global__ void __launch_bounds__(kGThreads)
mac_group_bf16_kernel(const X* __restrict__ ring,
                      const X* __restrict__ xnews,
                      const H* __restrict__ bank,
                      const int* __restrict__ coeff_idx,
                      const float* __restrict__ mask,
                      const int* __restrict__ t_ptr,
                      const int* __restrict__ delay, float* __restrict__ out,
                      int F, int B, int K, int E, int has_bin0) {
  const int k = (blockIdx.x * kGThreads + threadIdx.x) * kGVec;
  const int f = blockIdx.y;
  if (k >= K) return;
  const size_t plane = (size_t)K;
  const size_t part = 2 * (size_t)K;
  const size_t row = (size_t)B * part;
  const int t = *t_ptr;
  const int dly = delay[f];
  const int e = min(max(coeff_idx[f], 0), E - 1);
  const X* rf = ring + (size_t)f * row + k;
  const X* xf = xnews + (size_t)f * (G - 1) * part + k;
  const H* hb = bank + (size_t)e * row + k;
  const float* mrow = mask + (size_t)f * B;
  const bool bin0 = has_bin0 && k == 0;

  // the window at b = 0: vr[g], vi[g] = V(g)
  float vr[G][kGVec], vi[G][kGVec], yr[G][kGVec], yi[G][kGVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int j = g - 1 - dly;
    const X* src = j >= 0 ? xf + (size_t)j * part
                          : rf + (size_t)((t + g) % B) * part;
    widen(ld_raw(src), vr[g]);
    widen(ld_raw(src + plane), vi[g]);
#pragma unroll
    for (int v = 0; v < kGVec; ++v) yr[g][v] = yi[g][v] = 0.f;
  }
  // partition b's operands, kGDepth partitions ahead: V(-b) =
  // ring[f, (t-b) % B] (b >= 1), the bank partition b, the mask value
  Raw<X> pr[kGDepth], pi[kGDepth];
  Raw<H> qr[kGDepth], qi[kGDepth];
  float pm[kGDepth];
  auto fetch = [&](int b, int d) {
    if (b > 0) {
      int s = (t - b) % B;
      s += (s < 0) ? B : 0;
      const X* rs = rf + (size_t)s * part;
      pr[d] = ld_raw(rs);
      pi[d] = ld_raw(rs + plane);
    }
    const H* hs = hb + (size_t)b * part;
    qr[d] = ld_raw(hs);
    qi[d] = ld_raw(hs + plane);
    pm[d] = mrow[b];
  };
#pragma unroll
  for (int d = 0; d < kGDepth; ++d)
    if (d < B) fetch(d, d);
#pragma unroll 1
  for (int b0 = 0; b0 < B; b0 += kGDepth) {
#pragma unroll
    for (int d = 0; d < kGDepth; ++d) {
      const int b = b0 + d;
      if (b >= B) break;
      float hr[kGVec], hi[kGVec], nr[kGVec], ni[kGVec];
      widen(qr[d], hr);
      widen(qi[d], hi);
      const float m = pm[d];
      if (b > 0) {
        widen(pr[d], nr);
        widen(pi[d], ni);
      }
      if (b + kGDepth < B) fetch(b + kGDepth, d);
      if (b > 0) {
        // shift: V(g - b) was V((g-1) - (b-1)); V(-b) enters at g = 0
#pragma unroll
        for (int g = G - 1; g > 0; --g)
#pragma unroll
          for (int v = 0; v < kGVec; ++v) {
            vr[g][v] = vr[g - 1][v];
            vi[g][v] = vi[g - 1][v];
          }
#pragma unroll
        for (int v = 0; v < kGVec; ++v) {
          vr[0][v] = nr[v];
          vi[0][v] = ni[v];
        }
      }
#pragma unroll
      for (int v = 0; v < kGVec; ++v) {
        hr[v] *= m;
        hi[v] *= m;
      }
#pragma unroll
      for (int v = 0; v < kGVec; ++v) {
        if (v == 0 && bin0) {
          // packed bin 0: DC and Nyquist are independent real products
#pragma unroll
          for (int g = 0; g < G; ++g) {
            yr[g][0] += vr[g][0] * hr[0];
            yi[g][0] += vi[g][0] * hi[0];
          }
        } else {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            yr[g][v] += vr[g][v] * hr[v] - vi[g][v] * hi[v];
            yi[g][v] += vr[g][v] * hi[v] + vi[g][v] * hr[v];
          }
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* o = out + ((size_t)g * F + f) * part + k;
    st_vec(o, yr[g]);
    st_vec(o + K, yi[g]);
  }
}

template <int G, class X, class H>
int launch_group_bf16(const X* ring, const X* xnews, const H* bank,
                      const int* coeff_idx, const float* mask, const int* t,
                      const int* delay, float* out, int F, int B, int K,
                      int E, int has_bin0, cudaStream_t s) {
  const int per = kGVec * kGThreads;
  const dim3 grid((K + per - 1) / per, F);
  mac_group_bf16_kernel<G, X, H><<<grid, kGThreads, 0, s>>>(
      ring, xnews, bank, coeff_idx, mask, t, delay, out, F, B, K, E,
      has_bin0);
  return static_cast<int>(cudaGetLastError());
}

// bf_mac_mix_group. What limits it on an H100: the bytes (the ring and
// bank rows read once for G blocks, 175 us a call at the scale shape),
// but only while the copies stay in flight during the mix, 32768 outputs
// x F filters a 32-bin tile at G = 2 (64 us of the card's FP32 rate a
// call), and while the SM's issue slots, shared-memory bandwidth and 128
// registers a thread suffice for copies, MAC and mix together. The mix
// from shared memory is bound by both the FMA pipes and the shared-memory
// reads, and the copies' own instructions compete with it for issue.
//
// The block: 16 warps per tile of 32 bins (128-byte runs a plane) and
// kRows output rows, one block an SM. Filters come in rounds of 16,
// filter r * 16 + w to warp w. A round walks the B + G - 1 spectra of
// each filter's window in order, V(G-1) down to V(-(B-1)), and beside
// V(-b) the bank row b and the mask value: one "position" each. Each warp
// stages its own filter's positions in a ring of kStages stages of kPos
// positions in shared memory with 16-byte cp.async copies (lane (run,
// chunk): runs V re, V im, bank re, bank im), kStages - 1 stages ahead,
// and waits on its own copies only (a warp barrier, no block barrier a
// stage). Each lane walks a running pointer to its next run (a ring slot
// back, a bank partition forward); only a round's first G - 1 positions,
// which may read xnews, take a general path. Lane l MACs bin l: the window
// V(g - b), g = 0..G-1, shifts through registers as in group_mac; sums
// run b ascending in FP32 FMA, and bin 0 takes two real products. At the
// end of a round each warp's G spectra go to Ys [16][cols] in shared
// memory, and w's chunk for the round, copied into shared memory a round
// ahead by cp.async (each thread the elements it moves on), goes
// transposed beside it (Ws [16][kRows]); one block barrier. During the
// next round warp w mixes that round at stage w % stages, so that the
// warps mix at different stages while the others' copies stream: out +=
// w[:, f] Y_f, FP32 FMA, f ascending, as a register-tiled outer product
// (a thread owns 8 rows x 8 columns (g, plane, 4 bins x 2) and loads two
// 16-byte words of w and two of Y for 64 FMAs). The last round's mix runs
// after the loop. The accumulators are 64 a thread: kRows x padded G x
// 64 = 32768, so kRows = 256 at G = 2, 128 at G = 3-4 and 64 at G = 5-8
// (G padded to 4 or 8; the padding's columns are zero and not stored),
// and gridDim.y covers C_out past kRows (each such block reads the
// tile's ring and bank rows again). At G = 2 and C_out <= 256 the ring,
// bank and xnews bytes of a tile are read once a call. Warps whose rows
// all lie past C_out skip the mix.
//
// Forms measured slower on the card and gone (`chip_mix_group_designs.py`
// rebuilds each as a patch of this file; times in PERF.md): this layout
// with each warp's mix spread over every stage, which leaves every
// warp's copies idle at once; its mix as 3xTF32 mma.sync (each operand
// split into two TF32 halves, three products: its fragments spill, and
// one product misses 1e-5); a copy warp filling the stages with bulk
// copies (cp.async.bulk, one 128-byte run each) behind mbarriers; and
// warpgroups specialized by setmaxnreg into 8 copy + MAC warps and 8 mix
// warps (8 x 16 outputs a thread).

constexpr int kMixThreads = 512;
constexpr int kMixWarps = kMixThreads / 32;
constexpr int kTileBins = 32;                // bins a block: one a lane
constexpr int kFc = kMixWarps;               // filters a round: one a warp
constexpr int kPos = 4;                      // window positions a stage
constexpr int kStages = 3;                   // a warp's stage ring
constexpr int kItem = 4 * kTileBins + 4;     // V re, V im, H re, H im, mask

template <int G>
struct MixShape {
  static constexpr int kGP = G <= 2 ? 2 : (G <= 4 ? 4 : 8);  // padded G
  static constexpr int kCols = kGP * 2 * kTileBins;  // (g, plane, bin)
  static constexpr int kRows = kMixThreads * 64 / kCols;
  static constexpr int kWs = kRows + 4;      // a Ws row, padded (stores)
  static constexpr int kWPer = kFc * kRows / kMixThreads;  // w a thread
  static constexpr size_t kSmemFloats =
      (size_t)kMixWarps * kStages * kPos * kItem + 2 * kFc * kCols +
      2 * kFc * kWs + 2 * kRows * kFc;
};

// kAligned: K % 4 == 0 (8 in bf16) and ring, xnews, bank and out 16-byte
// aligned. X, H: the storage types of ring and xnews, and of the bank.
template <int G, bool kAligned, class X, class H>
__global__ void __launch_bounds__(kMixThreads, 1)
mac_mix_group_kernel(const X* __restrict__ ring,
                     const X* __restrict__ xnews,
                     const H* __restrict__ bank,
                     const int* __restrict__ coeff_idx,
                     const float* __restrict__ mask,
                     const int* __restrict__ t_ptr,
                     const int* __restrict__ delay,
                     const float* __restrict__ w, float* __restrict__ out,
                     int F, int B, int K, int E, int C_out, int has_bin0) {
  using S = MixShape<G>;
  constexpr int kRows = S::kRows, kCols = S::kCols, kWs = S::kWs;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * kTileBins;
  const int nk = min(kTileBins, K - k0);
  const int c0 = blockIdx.y * kRows;
  const size_t part = 2 * (size_t)K;
  const int NP = B + G - 1;                  // window positions a round
  const int nst = (NP + kPos - 1) / kPos;    // stages a round
  const int rounds = (F + kFc - 1) / kFc;
  const int total = rounds * nst;            // stages of a warp's ring
  int t = *t_ptr % B;
  t += t < 0 ? B : 0;

  float* st = sm + warp * (kStages * kPos * kItem);  // this warp's ring
  float* ys = sm + kMixWarps * (kStages * kPos * kItem);  // [2][kFc][kCols]
  float* ws = ys + 2 * kFc * kCols;                       // [2][kFc][kWs]
  float* wraw = ws + 2 * kFc * kWs;                       // [2][kRows][kFc]

  // the padding's columns (g >= G) of both Y buffers stay zero
  for (int i = tid; i < 2 * kFc * kCols; i += kMixThreads)
    if (i % kCols >= G * 2 * kTileBins) ys[i] = 0.f;

  // w[c0 + row, r * 16 + fl] -> wraw[r & 1][row][fl]: element
  // tid + u * kMixThreads, u < kWPer, of the chunk is this thread's
  auto copy_w = [&](int r) {
#pragma unroll
    for (int u = 0; u < S::kWPer; ++u) {
      const int i = tid + u * kMixThreads;
      const int c = c0 + i / kFc, f = r * kFc + i % kFc;
      const bool on = c < C_out && f < F;
      cp_async4(wraw + (r & 1) * kRows * kFc + i,
                on ? w + (size_t)c * F + f : w, on);
    }
  };

  // The copies: lane (run, chunk) = (lane / 8, lane % 8) of its warp's
  // positions; lane q also copies position q's mask value. The issue side
  // walks (round, stage) ahead of the MAC with its own counters: the stage
  // gi and its buffer gb, its index in the round ii, the round's filter fi
  // and delay di, the next round's bank row and delay ne, nd in flight.
  // Each lane keeps a running pointer to its next run: a V lane's ring
  // slot si of its filter (stepping back a slot a position), a bank lane's
  // next partition (stepping forward once the bank rows begin), and the
  // next mask value; only the first G - 1 positions of a round, which may
  // read xnews, take the general path. A lane's pointers are in bytes and
  // its run's values esz bytes each (the ring's type for V, the bank's
  // for H: one constant when the two agree); its chunk of a run lands at
  // byte 16 (lane & 7) of the run's slot.
  const int run = lane >> 3;
  const bool is_v = run < 2;
  const int esz = is_v ? (int)sizeof(X) : (int)sizeof(H);
  const int off = (16 / esz) * (lane & 7);   // its chunk's first bin
  const int doff = 4 * (lane & 7);           // ... in the slot, in floats
  const int nfl = max(0, nk - off);          // this lane's bins in range
  const int top = (t + G - 1) % B;           // slot of V(G-1)
  const ptrdiff_t step = (ptrdiff_t)part * esz,
                  wrap = (ptrdiff_t)(B - 1) * part * esz;
  int gi = 0, gb = 0, ii = 0, si = top, fi = warp, di, ne, nd;
  const char *cur, *xb;
  const float* mcur;
  auto next_ctrl = [&](int f) {
    ne = f < F ? min(max(coeff_idx[f], 0), E - 1) : 0;
    nd = f < F ? delay[f] : 0;
  };
  auto start_round = [&]() {               // filter fi, from ne and nd
    const size_t lane_off = ((size_t)(run & 1) * K + k0 + off) * esz;
    cur = (is_v ? reinterpret_cast<const char*>(
                      ring + ((size_t)fi * B + top) * part)
                : reinterpret_cast<const char*>(
                      bank + (size_t)ne * B * part)) +
          lane_off;
    xb = reinterpret_cast<const char*>(xnews + (size_t)fi * (G - 1) * part) +
         lane_off;
    mcur = mask + (size_t)fi * B;
    si = top;
    di = nd;
    next_ctrl(fi + kFc);
  };
  next_ctrl(fi);
  start_round();
  auto copy_run = [&](float* d, const char* src, bool on) {
    if constexpr (kAligned) {
      cp_async16(d, src, on && nfl >= 16 / esz);
    } else {
      static_assert(std::is_same_v<X, float> && std::is_same_v<H, float>,
                    "unaligned runs: float32 only");
      const float* p = reinterpret_cast<const float*>(src);
      if (on)
        for (int i = 0; i < nfl && i < 4; ++i) cp_async4(d + i, p + i);
    }
  };
  auto issue = [&]() {
    float* dst = st + gb * (kPos * kItem);
    const bool live = fi < F;
    if (ii * kPos < G - 1) {
      // the round's first positions: V(d), d >= 1, may come from xnews
#pragma unroll
      for (int q = 0; q < kPos; ++q) {
        const int pos = ii * kPos + q;
        const int b = pos - (G - 1);         // bank partition, < 0: none
        const int j = min(G - 2 - pos - di, G - 2);      // xnews index
        const bool use_x = is_v && j >= 0;
        const bool in = live && pos < NP;
        copy_run(dst + q * kItem + run * kTileBins + doff,
                 use_x ? xb + max(j, 0) * step : cur,
                 in && (is_v || b >= 0));
        cp_async4_if(dst + q * kItem + 4 * kTileBins, mcur,
                     lane == q && in && b >= 0);
        cur += is_v ? (si ? -step : wrap) : (b >= 0 ? step : 0);
        si = si ? si - 1 : B - 1;
        mcur += b >= 0;
      }
    } else {
#pragma unroll
      for (int q = 0; q < kPos; ++q) {
        const bool in = live && ii * kPos + q < NP;
        copy_run(dst + q * kItem + run * kTileBins + doff, cur, in);
        cp_async4_if(dst + q * kItem + 4 * kTileBins, mcur,
                     lane == q && in);
        cur += is_v ? (si ? -step : wrap) : step;
        si = si ? si - 1 : B - 1;
        ++mcur;
      }
    }
    ++gi;
    gb = gb + 1 == kStages ? 0 : gb + 1;
    if (++ii == nst) {
      ii = 0;
      fi += kFc;
      start_round();
    }
  };
  copy_w(0);
#pragma unroll 1
  for (int p = 0; p < kStages - 1; ++p) {
    if (gi < total) issue();
    cp_async_commit();
  }

  // The mix: thread (rg, cg) owns rows {h * kRows/2 + 4 rg + i} and
  // columns {h * kCols/2 + 4 cg + j}, h in {0, 1}, i, j in 0..3; a warp
  // is 4 rg x 8 cg, so its w loads are 64 and its Y loads 128 contiguous
  // bytes.
  const int cg = (warp % S::kGP) * 8 + (lane & 7);
  const int rg = (warp / S::kGP) * 4 + (lane >> 3);
  const bool mixes = (warp / S::kGP) * 16 < C_out - c0;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  auto mix_step = [&](int buf, int fl) {
    const float* wrow = ws + (buf * kFc + fl) * kWs;
    const float* yrow = ys + (buf * kFc + fl) * kCols;
    const float4 a0 = *reinterpret_cast<const float4*>(wrow + 4 * rg);
    const float4 a1 =
        *reinterpret_cast<const float4*>(wrow + kRows / 2 + 4 * rg);
    const float4 b0 = *reinterpret_cast<const float4*>(yrow + 4 * cg);
    const float4 b1 =
        *reinterpret_cast<const float4*>(yrow + kCols / 2 + 4 * cg);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float v[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
  };

  const bool bin0 = has_bin0 && k0 + lane == 0;
  int g = 0;                                 // the stage the MAC reads
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    float vr[G], vi[G], yr[G], yi[G];
#pragma unroll
    for (int p = 0; p < G; ++p) {
      vr[p] = vi[p] = 0.f;
      yr[p] = yi[p] = 0.f;
    }
#pragma unroll 1
    for (int s = 0; s < nst; ++s) {
      cp_async_wait<kStages - 2>();          // this lane's copies of g
      __syncwarp();                          // ... and the warp's
      if (gi < total) issue();               // refill stage g - 1's buffer
      if (s == 0 && r + 1 < rounds) copy_w(r + 1);
      cp_async_commit();
      const float* sg = st + g * (kPos * kItem);
      g = g + 1 == kStages ? 0 : g + 1;
#pragma unroll
      for (int q = 0; q < kPos; ++q) {
        const int pos = s * kPos + q;
        if (pos >= NP) break;
        const float* item = sg + q * kItem;
#pragma unroll
        for (int p = G - 1; p > 0; --p) {
          vr[p] = vr[p - 1];
          vi[p] = vi[p - 1];
        }
        vr[0] = ldv(reinterpret_cast<const X*>(item) + lane);
        vi[0] = ldv(reinterpret_cast<const X*>(item + kTileBins) + lane);
        if (pos >= G - 1) {
          // V(g - b) against bank row b; at bin 0 DC and Nyquist are
          // two real products (hx = 0, hy = the Nyquist coefficient)
          const float m = item[4 * kTileBins];
          const float hr =
              ldv(reinterpret_cast<const H*>(item + 2 * kTileBins) + lane) *
              m;
          const float hi =
              ldv(reinterpret_cast<const H*>(item + 3 * kTileBins) + lane) *
              m;
          const float hx = bin0 ? 0.f : hi, hy = bin0 ? hi : hr;
#pragma unroll
          for (int p = 0; p < G; ++p) {
            yr[p] = fmaf(vr[p], hr, yr[p]);
            yr[p] = fmaf(-vi[p], hx, yr[p]);
            yi[p] = fmaf(vr[p], hx, yi[p]);
            yi[p] = fmaf(vi[p], hy, yi[p]);
          }
        }
      }
      // the previous round's mix, at stage warp % nst of this round: the
      // warps mix at different stages while the others' copies stream
      if (r > 0 && mixes && s == warp % nst) {
        for (int fl = 0; fl < kFc; ++fl) mix_step((r - 1) & 1, fl);
      }
    }
    const int buf = r & 1;
    const bool live = r * kFc + warp < F;
    float* y = ys + (buf * kFc + warp) * kCols;
#pragma unroll
    for (int p = 0; p < G; ++p) {
      y[2 * kTileBins * p + lane] = live ? yr[p] : 0.f;
      y[2 * kTileBins * p + kTileBins + lane] = live ? yi[p] : 0.f;
    }
    // this thread's copied elements of w's chunk, transposed; its copies
    // of this chunk were issued a round ago (or before round 0) and the
    // waits since have seen them land
    if (nst < kStages) cp_async_wait<0>();
#pragma unroll
    for (int u = 0; u < S::kWPer; ++u) {
      const int i = tid + u * kMixThreads;
      ws[(buf * kFc + i % kFc) * kWs + i / kFc] =
          wraw[buf * kRows * kFc + i];
    }
    __syncthreads();
  }
  if (rounds > 0 && mixes) {
    const int fc = F - (rounds - 1) * kFc;
    for (int fl = 0; fl < fc; ++fl) mix_step((rounds - 1) & 1, fl);
  }

  // out[g, c0 + row, plane, k0 + bin]: four bins a store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = h * (kCols / 2) + 4 * cg;
    const int gg = col / (2 * kTileBins), p = (col / kTileBins) & 1;
    const int kk = col % kTileBins;
    if (gg >= G || kk >= nk) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + (i >> 2) * (kRows / 2) + 4 * rg + (i & 3);
      if (c >= C_out) continue;
      float* o = out + (((size_t)gg * C_out + c) * 2 + p) * K + k0 + kk;
      const float* a = &acc[i][4 * h];
      if (kAligned) {
        *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (kk + j < nk) o[j] = a[j];
      }
    }
  }
}

template <int G>
size_t mix_group_smem() {
  return MixShape<G>::kSmemFloats * sizeof(float);
}

// bf_mac_mix_group with both operands in bf16 (the note at the top): the
// design above with dense bf16 copies. A 32-bin run is 64 bytes in bf16
// (4 chunks), so a position is kChunks = 16 chunks with both operands in
// bf16 (24 with one in float32: the forms launch_mix_bf16 leaves to the
// float32 kernel). Lane c % kLanes of a warp copies chunk c of a position,
// kPair positions a warp-wide copy (lanes 0-15 and 16-31 two positions
// where a position is 16 chunks, else one on lanes 0-23); lane q copies
// position q's mask value. Each lane keeps its position's ring slot (kPair
// slots back a copy) and computes its source from it, from the bank
// partition, or from xnews in a round's first G - 1 positions. The
// smaller items leave room for 6 positions a stage (the float32 form 4).
// The MAC reads a lane's bin of each run from shared memory, widened,
// with the float32 form's expressions; each warp mixes at stage ((w >> 2)
// + 4 (w & 3)) % stages, so that the warps of one SM sub-partition (w % 4)
// mix at different stages; the rows, columns, mix and stores are the
// float32 form's. So the outputs equal the float32 form's on the widened
// operands, bit for bit.
// On an H100 (700 W) at G = 2 at the scale shape, both in bf16: 0.269
// ms, 34% of its 0.0927 ms bound (the float32 kernel with bf16 runs, which
// it replaces: 0.297, in turns). The mix sets the pace and does not
// overlap the rest: without the mix 0.152, the mix alone (no copies, no
// MAC) 0.158, copies alone 0.136, neither 0.051. With one float32
// operand (24 chunks a position on lanes 0-23) it ran 0.309 against the
// float32 kernel's 0.303, so those forms stay there
// (chip_mac_bf16_designs.py keeps that routing and the forms measured no
// faster: 4 or 8 positions a stage, 2, 4 or 5 stages, each warp mixing
// at stage w % stages, no mix at a round's last stage, the mix spread
// over a round's stages).

template <int G, class X, class H>
struct MixBf16Shape {
  using M = MixShape<G>;
  static constexpr int kRunX = kTileBins * (int)sizeof(X) / 4;   // floats
  static constexpr int kRunH = kTileBins * (int)sizeof(H) / 4;
  static constexpr int kChunks = (2 * kRunX + 2 * kRunH) / 4;
  static constexpr int kLanes = kChunks <= 16 ? 16 : 32;  // lanes a position
  static constexpr int kPair = 32 / kLanes;  // positions a warp-wide copy
  static constexpr int kItem = 2 * kRunX + 2 * kRunH + 4;  // + the mask
  static constexpr int kPos = 6;           // positions a stage
  static constexpr int kStages = 3;
  static constexpr size_t kSmemFloats =
      (size_t)kFc * kStages * kPos * kItem + 2 * kFc * M::kCols +
      2 * kFc * M::kWs + 2 * M::kRows * kFc;
  static_assert(kChunks <= 32 && kPos % kPair == 0 && kPos <= 32, "copies");
  static_assert(kItem % 4 == 0, "16-byte aligned items");
};

template <int G, class X, class H>
__global__ void __launch_bounds__(kMixThreads, 1)
mac_mix_group_bf16_kernel(const X* __restrict__ ring,
                          const X* __restrict__ xnews,
                          const H* __restrict__ bank,
                          const int* __restrict__ coeff_idx,
                          const float* __restrict__ mask,
                          const int* __restrict__ t_ptr,
                          const int* __restrict__ delay,
                          const float* __restrict__ w,
                          float* __restrict__ out, int F, int B, int K,
                          int E, int C_out, int has_bin0) {
  using S = MixShape<G>;
  using Q = MixBf16Shape<G, X, H>;
  constexpr int kRows = S::kRows, kCols = S::kCols, kWs = S::kWs;
  constexpr int kPos = Q::kPos, kItem = Q::kItem, kStg = Q::kStages;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * kTileBins;
  const int nk = min(kTileBins, K - k0);
  const int c0 = blockIdx.y * kRows;
  const size_t part = 2 * (size_t)K;
  const int NP = B + G - 1;                  // window positions a round
  const int nst = (NP + kPos - 1) / kPos;    // stages a round
  const int rounds = (F + kFc - 1) / kFc;
  const int total = rounds * nst;            // stages of a warp's ring
  int t = *t_ptr % B;
  t += t < 0 ? B : 0;

  float* st = sm + warp * (kStg * kPos * kItem);          // this warp's ring
  float* ys = sm + kFc * (kStg * kPos * kItem);  // [2][kFc][kCols]
  float* ws = ys + 2 * kFc * kCols;                       // [2][kFc][kWs]
  float* wraw = ws + 2 * kFc * kWs;                       // [2][kRows][kFc]

  // the padding's columns (g >= G) of both Y buffers stay zero
  for (int i = tid; i < 2 * kFc * kCols; i += kMixThreads)
    if (i % kCols >= G * 2 * kTileBins) ys[i] = 0.f;

  auto copy_w = [&](int r) {
#pragma unroll
    for (int u = 0; u < S::kWPer; ++u) {
      const int i = tid + u * kMixThreads;
      const int c = c0 + i / kFc, f = r * kFc + i % kFc;
      const bool on = c < C_out && f < F;
      cp_async4(wraw + (r & 1) * kRows * kFc + i,
                on ? w + (size_t)c * F + f : w, on);
    }
  };

  // This lane's chunk: position sub of each kPair, chunk c of its runs V
  // re, V im (X), H re, H im (H); its source at element lane_off of the
  // run's row (plane, bin) and its slot at float doff of the item. The
  // issue side walks (round, stage) ahead of the MAC as in the float32
  // form: the stage gi and its buffer gb, its index in the round ii, the
  // round's filter fi, bank row ei and delay di, the next round's ne, nd;
  // si is the ring slot of this lane's next position. Sources are
  // computed from these and the kernel's parameters at each copy: no row
  // pointers are held (registers go to the mix's accumulators).
  const int sub = lane / Q::kLanes, c = lane % Q::kLanes;
  const int run = c < Q::kRunX / 4 ? 0
                  : c < Q::kRunX / 2 ? 1
                  : c < Q::kRunX / 2 + Q::kRunH / 4 ? 2 : 3;
  const bool is_v = run < 2;
  const int cc = c - (is_v ? run * (Q::kRunX / 4)
                           : Q::kRunX / 2 + (run - 2) * (Q::kRunH / 4));
  const int bin = cc * (is_v ? 16 / (int)sizeof(X) : 16 / (int)sizeof(H));
  const bool lane_on = c < Q::kChunks && bin < nk;
  const int doff = (is_v ? run * Q::kRunX
                         : 2 * Q::kRunX + (run - 2) * Q::kRunH) + 4 * cc;
  const int lane_off = (run & 1) * K + k0 + bin;
  const int top = (t + G - 1) % B;           // slot of V(G-1)
  int gi = 0, gb = 0, ii = 0, si = 0, fi = warp, ei, di, ne, nd;
  auto next_ctrl = [&](int f) {
    ne = f < F ? min(max(coeff_idx[f], 0), E - 1) : 0;
    nd = f < F ? delay[f] : 0;
  };
  auto start_round = [&]() {               // filter fi, from ne and nd
    si = top - sub;
    si += si < 0 ? B : 0;
    si += si < 0 ? B : 0;
    ei = ne;
    di = nd;
    next_ctrl(fi + kFc);
  };
  next_ctrl(fi);
  start_round();
  auto issue = [&]() {
    float* dst = st + gb * (kPos * kItem);
    const bool live = fi < F;
    const int p0 = ii * kPos;
#pragma unroll
    for (int q0 = 0; q0 < kPos; q0 += Q::kPair) {
      const int q = q0 + sub;
      const int pos = p0 + q;
      const int b = pos - (G - 1);           // bank partition, < 0: none
      const int j = min(G - 2 - pos - di, G - 2);     // xnews index
      const bool from_x = pos < G - 1 && j >= 0;
      const void* src;
      if (!is_v)
        src = bank + ((size_t)ei * B + max(b, 0)) * part + lane_off;
      else if (from_x)
        src = xnews + ((size_t)fi * (G - 1) + j) * part + lane_off;
      else
        src = ring + ((size_t)fi * B + si) * part + lane_off;
      cp_async16(dst + q * kItem + doff, src,
                 lane_on && live && pos < NP && (is_v || b >= 0));
      si -= Q::kPair;
      si += si < 0 ? B : 0;
      si += si < 0 ? B : 0;
    }
    {
      const int b = p0 + lane - (G - 1);
      cp_async4_if(dst + lane * kItem + kItem - 4,
                   mask + (size_t)fi * B + max(b, 0),
                   lane < kPos && live && b >= 0 && b < B);
    }
    ++gi;
    gb = gb + 1 == kStg ? 0 : gb + 1;
    if (++ii == nst) {
      ii = 0;
      fi += kFc;
      start_round();
    }
  };
  copy_w(0);
#pragma unroll 1
  for (int p = 0; p < kStg - 1; ++p) {
    if (gi < total) issue();
    cp_async_commit();
  }

  // The mix: the float32 form's thread tiles (rows {h * kRows/2 + 4 rg +
  // i}, columns {h * kCols/2 + 4 cg + j})
  const int cg = (warp % S::kGP) * 8 + (lane & 7);
  const int rg = (warp / S::kGP) * 4 + (lane >> 3);
  const bool mixes = (warp / S::kGP) * 16 < C_out - c0;
  const int mix_at = ((warp >> 2) + 4 * (warp & 3)) % nst;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  auto mix_step = [&](int buf, int fl) {
    const float* wrow = ws + (buf * kFc + fl) * kWs;
    const float* yrow = ys + (buf * kFc + fl) * kCols;
    const float4 a0 = *reinterpret_cast<const float4*>(wrow + 4 * rg);
    const float4 a1 =
        *reinterpret_cast<const float4*>(wrow + kRows / 2 + 4 * rg);
    const float4 b0 = *reinterpret_cast<const float4*>(yrow + 4 * cg);
    const float4 b1 =
        *reinterpret_cast<const float4*>(yrow + kCols / 2 + 4 * cg);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float v[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
  };

  const bool bin0 = has_bin0 && k0 + lane == 0;
  int g = 0;                                 // the stage the MAC reads
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    float vr[G], vi[G], yr[G], yi[G];
#pragma unroll
    for (int p = 0; p < G; ++p) {
      vr[p] = vi[p] = 0.f;
      yr[p] = yi[p] = 0.f;
    }
#pragma unroll 1
    for (int s = 0; s < nst; ++s) {
      cp_async_wait<kStg - 2>();             // this lane's copies of g
      __syncwarp();                          // ... and the warp's
      if (gi < total) issue();               // refill stage g - 1's buffer
      if (s == 0 && r + 1 < rounds) copy_w(r + 1);
      cp_async_commit();
      const float* sg = st + g * (kPos * kItem);
      g = g + 1 == kStg ? 0 : g + 1;
#pragma unroll
      for (int q = 0; q < kPos; ++q) {
        const int pos = s * kPos + q;
        if (pos >= NP) break;
        const float* item = sg + q * kItem;
#pragma unroll
        for (int p = G - 1; p > 0; --p) {
          vr[p] = vr[p - 1];
          vi[p] = vi[p - 1];
        }
        vr[0] = ldv(reinterpret_cast<const X*>(item) + lane);
        vi[0] = ldv(reinterpret_cast<const X*>(item + Q::kRunX) + lane);
        if (pos >= G - 1) {
          // V(g - b) against bank row b; at bin 0 DC and Nyquist are
          // two real products (hx = 0, hy = the Nyquist coefficient)
          const float m = item[kItem - 4];
          const float hr =
              ldv(reinterpret_cast<const H*>(item + 2 * Q::kRunX) + lane) *
              m;
          const float hi =
              ldv(reinterpret_cast<const H*>(item + 2 * Q::kRunX +
                                             Q::kRunH) + lane) * m;
          const float hx = bin0 ? 0.f : hi, hy = bin0 ? hi : hr;
#pragma unroll
          for (int p = 0; p < G; ++p) {
            yr[p] = fmaf(vr[p], hr, yr[p]);
            yr[p] = fmaf(-vi[p], hx, yr[p]);
            yi[p] = fmaf(vr[p], hx, yi[p]);
            yi[p] = fmaf(vi[p], hy, yi[p]);
          }
        }
      }
      // the previous round's mix, at this warp's stage of this round
      if (r > 0 && mixes && s == mix_at) {
        for (int fl = 0; fl < kFc; ++fl) mix_step((r - 1) & 1, fl);
      }
    }
    const int buf = r & 1;
    const bool live = r * kFc + warp < F;
    float* y = ys + (buf * kFc + warp) * kCols;
#pragma unroll
    for (int p = 0; p < G; ++p) {
      y[2 * kTileBins * p + lane] = live ? yr[p] : 0.f;
      y[2 * kTileBins * p + kTileBins + lane] = live ? yi[p] : 0.f;
    }
    // this thread's copied elements of w's chunk, transposed (landed: the
    // waits since their copies were issued a round ago have seen them)
    if (nst < kStg) cp_async_wait<0>();
#pragma unroll
    for (int u = 0; u < S::kWPer; ++u) {
      const int i = tid + u * kMixThreads;
      ws[(buf * kFc + i % kFc) * kWs + i / kFc] =
          wraw[buf * kRows * kFc + i];
    }
    __syncthreads();
  }
  if (rounds > 0 && mixes) {
    const int fc = F - (rounds - 1) * kFc;
    for (int fl = 0; fl < fc; ++fl) mix_step((rounds - 1) & 1, fl);
  }

  // out[g, c0 + row, plane, k0 + bin]: four bins a store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = h * (kCols / 2) + 4 * cg;
    const int gg = col / (2 * kTileBins), p = (col / kTileBins) & 1;
    const int kk = col % kTileBins;
    if (gg >= G || kk >= nk) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + (i >> 2) * (kRows / 2) + 4 * rg + (i & 3);
      if (c >= C_out) continue;
      float* o = out + (((size_t)gg * C_out + c) * 2 + p) * K + k0 + kk;
      const float* a = &acc[i][4 * h];
      *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
    }
  }
}

template <int G, class X, class H>
size_t mix_group_bf16_smem() {
  return MixBf16Shape<G, X, H>::kSmemFloats * sizeof(float);
}

template <int G, class X, class H>
int launch_mix_group_bf16(const X* ring, const X* xnews, const H* bank,
                          const int* coeff_idx, const float* mask,
                          const int* t, const int* delay, const float* w,
                          float* out, int F, int B, int K, int E, int C_out,
                          int has_bin0, cudaStream_t s) {
  const size_t bytes = mix_group_bf16_smem<G, X, H>();
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  // raise the kernel's shared-memory limit once per device
  static bool granted[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!granted[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        mac_mix_group_bf16_kernel<G, X, H>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted[dev] = true;
  }
  constexpr int rows = MixShape<G>::kRows;
  const dim3 grid((K + kTileBins - 1) / kTileBins, (C_out + rows - 1) / rows);
  mac_mix_group_bf16_kernel<G, X, H><<<grid, kMixThreads, bytes, s>>>(
      ring, xnews, bank, coeff_idx, mask, t, delay, w, out, F, B, K, E,
      C_out, has_bin0);
  return static_cast<int>(cudaGetLastError());
}

template <int G, bool kAligned, class X, class H>
int launch_mix_group(const X* ring, const X* xnews,
                     const H* bank, const int* coeff_idx,
                     const float* mask, const int* t, const int* delay,
                     const float* w, float* out, int F, int B, int K, int E,
                     int C_out, int has_bin0, cudaStream_t s) {
  const size_t bytes = mix_group_smem<G>();
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  // raise the kernel's shared-memory limit once per device
  static bool granted[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!granted[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        mac_mix_group_kernel<G, kAligned, X, H>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted[dev] = true;
  }
  constexpr int rows = MixShape<G>::kRows;
  const dim3 grid((K + kTileBins - 1) / kTileBins, (C_out + rows - 1) / rows);
  mac_mix_group_kernel<G, kAligned, X, H><<<grid, kMixThreads, bytes, s>>>(
      ring, xnews, bank, coeff_idx, mask, t, delay, w, out, F, B, K, E,
      C_out, has_bin0);
  return static_cast<int>(cudaGetLastError());
}

bool mix_group_aligned(const void* ring, const void* xnews,
                       const void* bank, const void* out, int K, int per) {
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return K % per == 0 && a16(ring) && a16(xnews) && a16(bank) && a16(out);
}

template <int G>
int launch_mix_group(const float* ring, const float* xnews,
                     const float* bank, const int* coeff_idx,
                     const float* mask, const int* t, const int* delay,
                     const float* w, float* out, int F, int B, int K, int E,
                     int C_out, int has_bin0, cudaStream_t s) {
  if (mix_group_aligned(ring, xnews, bank, out, K, 4))
    return launch_mix_group<G, true>(ring, xnews, bank, coeff_idx, mask, t,
                                     delay, w, out, F, B, K, E, C_out,
                                     has_bin0, s);
  return launch_mix_group<G, false>(ring, xnews, bank, coeff_idx, mask, t,
                                    delay, w, out, F, B, K, E, C_out,
                                    has_bin0, s);
}

// bf_mac_mix_group's bf16 forms at group size G: with both operands in
// bf16 their own kernel; with one in float32 the float32 form's kernel
// staging the bf16 runs in its slots (its dense 24-chunk staging measured
// 2% slower, the note above mac_mix_group_bf16_kernel).
template <int G, class X, class H>
int launch_mix_bf16(const X* ring, const X* xnews, const H* bank,
                    const int* coeff_idx, const float* mask, const int* t,
                    const int* delay, const float* w, float* out, int F,
                    int B, int K, int E, int C_out, int has_bin0,
                    cudaStream_t s) {
  if constexpr (std::is_same_v<X, H>)
    return launch_mix_group_bf16<G>(ring, xnews, bank, coeff_idx, mask, t,
                                    delay, w, out, F, B, K, E, C_out,
                                    has_bin0, s);
  else
    return launch_mix_group<G, true>(ring, xnews, bank, coeff_idx, mask, t,
                                     delay, w, out, F, B, K, E, C_out,
                                     has_bin0, s);
}

// The launches of the bf16 operand forms at group size G (2 .. kMaxGroup;
// else cudaErrorInvalidValue): `mix` the fused MAC + mix, else the
// grouped MAC (both on the aligned path, which the caller checked).
template <class X, class H>
int launch_bf16(bool mix, int G, const void* ring, const void* xnews,
                const void* bank, const int* coeff_idx, const float* mask,
                const int* t, const int* delay, const float* w, float* out,
                int F, int B, int K, int E, int C_out, int has_bin0,
                cudaStream_t s) {
  const X* r = static_cast<const X*>(ring);
  const X* x = static_cast<const X*>(xnews);
  const H* h = static_cast<const H*>(bank);
  switch (G) {
#define BF_CASE(g)                                                         \
  case g:                                                                  \
    return mix ? launch_mix_bf16<g>(r, x, h, coeff_idx, mask, t, delay,   \
                                    w, out, F, B, K, E, C_out, has_bin0,   \
                                    s)                                     \
               : launch_group_bf16<g>(r, x, h, coeff_idx, mask, t, delay,  \
                                      out, F, B, K, E, has_bin0, s);
    BF_CASE(2) BF_CASE(3) BF_CASE(4) BF_CASE(5) BF_CASE(6) BF_CASE(7)
    BF_CASE(8)
#undef BF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_bf16(bool mix, int G, const void* ring, const void* xnews,
                const void* bank, const int* coeff_idx, const float* mask,
                const int* t, const int* delay, const float* w, float* out,
                int F, int B, int K, int E, int C_out, int has_bin0,
                int ring_bf16, int bank_bf16, cudaStream_t s) {
  using bf = __nv_bfloat16;
  if (ring_bf16 && bank_bf16)
    return launch_bf16<bf, bf>(mix, G, ring, xnews, bank, coeff_idx, mask, t,
                               delay, w, out, F, B, K, E, C_out, has_bin0, s);
  if (ring_bf16)
    return launch_bf16<bf, float>(mix, G, ring, xnews, bank, coeff_idx, mask,
                                  t, delay, w, out, F, B, K, E, C_out,
                                  has_bin0, s);
  if (bank_bf16)
    return launch_bf16<float, bf>(mix, G, ring, xnews, bank, coeff_idx, mask,
                                  t, delay, w, out, F, B, K, E, C_out,
                                  has_bin0, s);
  return static_cast<int>(cudaErrorInvalidValue);   // float32: not here
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for a group size outside 2 .. kMaxGroup (and,
// for bf_mac_mix_group, B < 1); a refused shared-memory attribute comes
// back as its own error. `has_bin0`: 1 where local bin 0 is the packed
// DC/Nyquist bin (an unsharded call, the first bin shard of a mesh), else
// 0, and bin 0 is an ordinary complex product. ring_bf16 / bank_bf16: 1
// where that operand is bfloat16 (xnews is of the ring's type), else
// float32; both 0 is the float32 form. A bf16 form of either takes the
// aligned path only: cudaErrorInvalidValue unless K % 8 == 0 and ring,
// xnews, bank and out are 16-byte aligned (and, for bf_mac_group, B >=
// 1); bf_mac_mix_group's launch plan is the float32 form's. The caller
// allocates `out` and checks shapes; nothing here synchronises.
extern "C" int bf_mac_group(const void* ring_, const void* xnews_,
                            const void* bank_, const int* coeff_idx,
                            const float* mask, const int* t,
                            const int* delay, float* out, int F, int B,
                            int K, int E, int G, int has_bin0, int ring_bf16,
                            int bank_bf16, void* stream) {
  if (K <= 0 || F <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ring_bf16 || bank_bf16) {
    if (B <= 0 || !mix_group_aligned(ring_, xnews_, bank_, out, K, 8))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_bf16(false, G, ring_, xnews_, bank_, coeff_idx, mask, t,
                       delay, nullptr, out, F, B, K, E, 0, has_bin0,
                       ring_bf16, bank_bf16, s);
  }
  const float* ring = static_cast<const float*>(ring_);
  const float* xnews = static_cast<const float*>(xnews_);
  const float* bank = static_cast<const float*>(bank_);
  switch (G) {
#define BF_CASE(g)                                                        \
  case g:                                                                 \
    return launch_group<g>(ring, xnews, bank, coeff_idx, mask, t, delay,  \
                           out, F, B, K, E, has_bin0, s);
    BF_CASE(2) BF_CASE(3) BF_CASE(4) BF_CASE(5) BF_CASE(6) BF_CASE(7)
    BF_CASE(8)
#undef BF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int bf_mac_mix_group(const void* ring_, const void* xnews_,
                                const void* bank_, const int* coeff_idx,
                                const float* mask, const int* t,
                                const int* delay, const float* w, float* out,
                                int F, int B, int K, int E, int C_out, int G,
                                int has_bin0, int ring_bf16, int bank_bf16,
                                void* stream) {
  if (K <= 0 || C_out <= 0) return 0;
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ring_bf16 || bank_bf16) {
    if (!mix_group_aligned(ring_, xnews_, bank_, out, K, 8))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_bf16(true, G, ring_, xnews_, bank_, coeff_idx, mask, t,
                       delay, w, out, F, B, K, E, C_out, has_bin0, ring_bf16,
                       bank_bf16, s);
  }
  const float* ring = static_cast<const float*>(ring_);
  const float* xnews = static_cast<const float*>(xnews_);
  const float* bank = static_cast<const float*>(bank_);
  switch (G) {
#define BF_CASE(g)                                                        \
  case g:                                                                 \
    return launch_mix_group<g>(ring, xnews, bank, coeff_idx, mask, t,     \
                               delay, w, out, F, B, K, E, C_out, has_bin0, \
                               s);
    BF_CASE(2) BF_CASE(3) BF_CASE(4) BF_CASE(5) BF_CASE(6) BF_CASE(7)
    BF_CASE(8)
#undef BF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch bf_mac_mix_group makes at group size G and C_out outputs
// for the operand form of ring_bf16 / bank_bf16 (both 0: float32; one of
// them: the float32 form's launch):
// out[0] bins a block, out[1] threads a block, out[2] output rows a block,
// out[3] gridDim.y, out[4] stages of a warp's copy ring, out[5] window
// positions a stage, out[6] dynamic shared memory a block in bytes, out[7]
// the column padding of G, out[8] 16-byte chunks a position. For reports
// and tests; launches nothing. Returns cudaErrorInvalidValue for G outside
// 2 .. kMaxGroup.
template <int G, class X, class H>
void bf16_plan(int* out) {
  using Q = MixBf16Shape<G, X, H>;
  out[4] = Q::kStages;
  out[5] = Q::kPos;
  out[6] = static_cast<int>(mix_group_bf16_smem<G, X, H>());
  out[8] = Q::kChunks;
}

extern "C" int bf_mac_mix_group_plan(int G, int C_out, int ring_bf16,
                                     int bank_bf16, int* out) {
  using bf = __nv_bfloat16;
  switch (G) {
#define BF_CASE(g)                                                        \
  case g:                                                                 \
    out[2] = MixShape<g>::kRows;                                          \
    out[7] = MixShape<g>::kGP;                                            \
    out[4] = kStages;                                                     \
    out[5] = kPos;                                                        \
    out[6] = static_cast<int>(mix_group_smem<g>());                       \
    out[8] = 4 * kTileBins * 4 / 16;     /* four float32 runs */          \
    if (ring_bf16 && bank_bf16) bf16_plan<g, bf, bf>(out);                \
    break;
    BF_CASE(2) BF_CASE(3) BF_CASE(4) BF_CASE(5) BF_CASE(6) BF_CASE(7)
    BF_CASE(8)
#undef BF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = kTileBins;
  out[1] = kMixThreads;
  out[3] = ((C_out > 1 ? C_out : 1) + out[2] - 1) / out[2];
  return 0;
}

static_assert(kMaxGroup == 8, "the launch switches cover G = 2 .. 8");
