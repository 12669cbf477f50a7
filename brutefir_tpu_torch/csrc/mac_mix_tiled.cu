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
// graph): the ring and/or the bank (X, H) bfloat16, each value widened to
// float32 after it reaches shared memory; the mask, w, the sums, the mix
// and the output float32. With both in bf16 a scale-shape call moves
// 285 MB (85 us at 3.35 TB/s) beside the same 2.1 GFLOP mix (32 us).
// Loaded straight from device memory as above, a bf16 warp load is 64
// bytes, so the bytes in flight halve with the operand size and the time
// stays where latency puts it (that form ran at 34% of this bound).
// So they take their own kernel, mac_mix_tiled_bf16_kernel, the design of
// the grouped fused MAC + mix (mac_group.cu, mac_mix_group_kernel) at one
// block a group and 64-bin tiles:
//   - one block of 16 warps per tile of kBfTile = 64 bins and kBfRows =
//     256 output rows (gridDim.y covers the rest; each such block reads
//     the tile's ring and bank runs again); filters in rounds of 16,
//     filter r * 16 + w to warp w;
//   - each warp streams its filter's positions b = 0 .. B-1 (the ring
//     slot (t-b) % B, the bank partition b, the mask value) through its
//     own ring of kBfStages stages of kPos positions in shared memory,
//     16-byte cp.async copies kBfStages - 1 stages ahead, and waits on
//     its own copies only (no block barrier a stage). A 64-bin bf16 run
//     is 128 bytes, 8 chunks: with both operands in bf16 the 32 lanes
//     copy the 32 chunks of a position, one each, densely; with one
//     operand in float32 (256-byte runs) a position is 48 chunks, two
//     a lane on lanes 0-15;
//   - lane l MACs bins 2l and 2l+1 (one 4-byte bf16 pair or one float2 a
//     run from shared memory), b ascending, with the float32 form's
//     expression, bin 0 two real products where has_bin0;
//   - at the end of a round the warps' Y go to shared memory beside w's
//     chunk (copied by cp.async a round ahead, transposed), one block
//     barrier; during the next round each warp runs its share of the
//     mix, out += w[:, f] Y_f, f ascending, FP32 FMA, as an 8 x 8
//     register-tiled outer product (a thread: 8 rows x 4 bins x 2
//     planes, two 16-byte words of w and two of Y for 64 FMAs), at its
//     own stage: ((w >> 2) + 4 (w & 3)) % stages, so that the warps of
//     one SM sub-partition (w % 4) mix at different stages while the
//     others' copies stream. The last round's mix runs after the loop.
// They need K % 8 == 0 and 16-byte aligned ring, bank and out (the
// wrapper's check_staged: ValueError elsewhere; cudaErrorInvalidValue
// here). On an H100 with both in bf16 at the scale shape: 0.137 ms, 62%
// of the bound (the replaced form 0.252); without the mix 0.100, the mix
// alone 0.087 (chip_mac_bf16_designs.py, which also keeps the forms
// measured slower: 2 or 4 stages, 2 or 8 positions a stage, each warp
// mixing at stage w % stages). The float32 form is mac_mix_tiled_kernel
// above.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;                    // bins per block (one warp row)
constexpr int kFc = kThreads / kTile;        // filters per chunk: one a warp
constexpr int kPass = kThreads / kTile;      // output rows per pass

template <int kRows>
__global__ void __launch_bounds__(kThreads)
mac_mix_tiled_kernel(const float* __restrict__ ring,
                     const float* __restrict__ bank,
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
      const float* rf = ring + (size_t)f * row;
      const float* hb = bank + (size_t)e * row;
      const float* mrow = mask + (size_t)f * B;
      for (int b = 0; b < B; ++b) {
        int s = (t - b) % B;
        s += (s < 0) ? B : 0;
        const float m = mrow[b];
        const float* rs = rf + (size_t)s * part;
        const float* hs = hb + (size_t)b * part;
        const float rr = rs[k], ri = rs[plane + k];
        const float hr = hs[k] * m, hi = hs[plane + k] * m;
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

template <int kRows>
int launch(const float* ring, const float* bank, const int* coeff_idx,
           const float* mask, const int* t, const float* w, float* out,
           int F, int B, int K, int E, int C_out, int has_bin0,
           cudaStream_t s) {
  const dim3 grid((K + kTile - 1) / kTile,
                  (C_out + kPass * kRows - 1) / (kPass * kRows));
  mac_mix_tiled_kernel<kRows><<<grid, kThreads, 0, s>>>(
      ring, bank, coeff_idx, mask, t, w, out, F, B, K, E, C_out, has_bin0);
  return static_cast<int>(cudaGetLastError());
}

// ---- the bf16 operand forms (the note at the top) ----

constexpr int kBfThreads = 512;
constexpr int kBfWarps = kBfThreads / 32;    // filters a round: one a warp
constexpr int kBfTile = 64;                  // bins a block: two a lane
constexpr int kBfRows = 256;                 // output rows a block
constexpr int kBfCols = 2 * kBfTile;         // Y columns: (plane, bin)
constexpr int kBfWs = kBfRows + 4;           // a transposed w row, padded
constexpr int kBfWPer = kBfWarps * kBfRows / kBfThreads;  // w a thread
constexpr int kBfStages = 3;                 // a warp's stage ring

// A position of X ring runs and H bank runs, in floats: V re, V im, H re,
// H im (each kBfTile values), the mask value padded to 16 bytes; its
// 16-byte chunks and a lane's share of them; the positions a stage.
template <class X, class H>
struct BfShape {
  static constexpr int kRunX = kBfTile * (int)sizeof(X) / 4;
  static constexpr int kRunH = kBfTile * (int)sizeof(H) / 4;
  static constexpr int kChX = kRunX / 4, kChH = kRunH / 4;
  static constexpr int kChunks = 2 * kChX + 2 * kChH;
  static constexpr int kPer = (kChunks + 31) / 32;
  static constexpr int kItem = 2 * kRunX + 2 * kRunH + 4;
  static constexpr int kPos = sizeof(X) == 2 && sizeof(H) == 2 ? 4 : 3;
  static constexpr size_t kSmemFloats =
      (size_t)kBfWarps * kBfStages * kPos * kItem + 2 * kBfWarps * kBfCols +
      2 * kBfWarps * kBfWs + 2 * kBfRows * kBfWarps;
  static_assert(kSmemFloats * 4 <= kSmemMax, "a block's shared memory");
};

// Values 2 lane and 2 lane + 1 of a staged run of T, as float32.
__device__ __forceinline__ float2 pair_at(const float* run, int lane,
                                          float) {
  return reinterpret_cast<const float2*>(run)[lane];
}
__device__ __forceinline__ float2 pair_at(const float* run, int lane,
                                          __nv_bfloat16) {
  const unsigned u = reinterpret_cast<const unsigned*>(run)[lane];
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

template <class X, class H>
__global__ void __launch_bounds__(kBfThreads, 1)
mac_mix_tiled_bf16_kernel(const X* __restrict__ ring,
                          const H* __restrict__ bank,
                          const int* __restrict__ coeff_idx,
                          const float* __restrict__ mask,
                          const int* __restrict__ t_ptr,
                          const float* __restrict__ w,
                          float* __restrict__ out, int F, int B, int K,
                          int E, int C_out, int has_bin0) {
  using S = BfShape<X, H>;
  constexpr int kPos = S::kPos, kItem = S::kItem;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * kBfTile;
  const int nk = min(kBfTile, K - k0);
  const int c0 = blockIdx.y * kBfRows;
  const size_t part = 2 * (size_t)K;
  const int nst = (B + kPos - 1) / kPos;     // stages a round
  const int rounds = (F + kBfWarps - 1) / kBfWarps;
  const int total = rounds * nst;            // stages of a warp's ring
  int t = *t_ptr % B;
  t += t < 0 ? B : 0;

  float* st = sm + warp * (kBfStages * kPos * kItem);   // this warp's ring
  float* ys = sm + kBfWarps * (kBfStages * kPos * kItem);  // [2][16][cols]
  float* ws = ys + 2 * kBfWarps * kBfCols;                 // [2][16][kBfWs]
  float* wraw = ws + 2 * kBfWarps * kBfWs;                 // [2][rows][16]

  // w[c0 + row, r * 16 + fl] -> wraw[r & 1][row][fl]: element
  // tid + u * kBfThreads, u < kBfWPer, of the chunk is this thread's
  auto copy_w = [&](int r) {
#pragma unroll
    for (int u = 0; u < kBfWPer; ++u) {
      const int i = tid + u * kBfThreads;
      const int c = c0 + i / kBfWarps, f = r * kBfWarps + i % kBfWarps;
      const bool on = c < C_out && f < F;
      cp_async4(wraw + (r & 1) * kBfRows * kBfWarps + i,
                on ? w + (size_t)c * F + f : w, on);
    }
  };

  // The copies: chunk lane + 32 u (u < kPer) of each position is this
  // lane's: of a V run (plane vp, the ring) or an H run (the bank), at
  // byte off[u] of its run in device memory and float doff[u] of the
  // item. Each keeps a running pointer: a V chunk steps back a ring slot
  // a position (slot si, wrapping), an H chunk forward a partition. The
  // issue side walks (round, stage) ahead of the MAC with its own
  // counters: the stage gi and its buffer gb, its index in the round ii,
  // the round's filter fi, the next round's bank row ne.
  bool isv[S::kPer], on[S::kPer];
  int doff[S::kPer];
  size_t lane_off[S::kPer];
  ptrdiff_t step[S::kPer];
  const char* cur[S::kPer];
#pragma unroll
  for (int u = 0; u < S::kPer; ++u) {
    const int c = lane + 32 * u;
    isv[u] = c < 2 * S::kChX;
    const int cc = isv[u] ? c : c - 2 * S::kChX;
    const int per = isv[u] ? S::kChX : S::kChH;
    const int esz = isv[u] ? (int)sizeof(X) : (int)sizeof(H);
    const int pl = cc / per, bin = (cc % per) * (16 / esz);
    on[u] = c < S::kChunks && bin < nk;
    doff[u] = isv[u] ? pl * S::kRunX + (cc % per) * 4
                     : 2 * S::kRunX + pl * S::kRunH + (cc % per) * 4;
    lane_off[u] = ((size_t)pl * K + k0 + bin) * esz;
    step[u] = (ptrdiff_t)part * esz;
  }
  const ptrdiff_t wrapx = (ptrdiff_t)(B - 1) * part * sizeof(X);
  int gi = 0, gb = 0, ii = 0, si = t, fi = warp, ne;
  const float* mcur;
  auto next_ctrl = [&](int f) {
    ne = f < F ? min(max(coeff_idx[f], 0), E - 1) : 0;
  };
  auto start_round = [&]() {                 // filter fi, bank row ne
#pragma unroll
    for (int u = 0; u < S::kPer; ++u)
      cur[u] = (isv[u] ? reinterpret_cast<const char*>(
                             ring + ((size_t)fi * B + t) * part)
                       : reinterpret_cast<const char*>(
                             bank + (size_t)ne * B * part)) +
               lane_off[u];
    mcur = mask + (size_t)fi * B;
    si = t;
    next_ctrl(fi + kBfWarps);
  };
  next_ctrl(fi);
  start_round();
  auto issue = [&]() {
    float* dst = st + gb * (kPos * kItem);
    const bool live = fi < F;
#pragma unroll
    for (int q = 0; q < kPos; ++q) {
      const bool in = live && ii * kPos + q < B;
#pragma unroll
      for (int u = 0; u < S::kPer; ++u) {
        cp_async16(dst + q * kItem + doff[u], cur[u], in && on[u]);
        cur[u] += isv[u] ? (si ? -step[u] : wrapx) : step[u];
      }
      cp_async4_if(dst + q * kItem + kItem - 4, mcur, lane == q && in);
      si = si ? si - 1 : B - 1;
      ++mcur;
    }
    ++gi;
    gb = gb + 1 == kBfStages ? 0 : gb + 1;
    if (++ii == nst) {
      ii = 0;
      fi += kBfWarps;
      start_round();
    }
  };
  copy_w(0);
#pragma unroll 1
  for (int p = 0; p < kBfStages - 1; ++p) {
    if (gi < total) issue();
    cp_async_commit();
  }

  // The mix: thread (rg, cg) owns rows {h * kBfRows/2 + 4 rg + i} and
  // columns {h * kBfCols/2 + 4 cg + j} (plane h, bins 4 cg + j), h in
  // {0, 1}, i, j in 0..3; a warp is 4 rg x 8 cg.
  const int cg = (warp & 1) * 8 + (lane & 7);
  const int rg = (warp >> 1) * 4 + (lane >> 3);
  const bool mixes = (warp >> 1) * 16 < C_out - c0;
  const int mix_at = ((warp >> 2) + 4 * (warp & 3)) % nst;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  auto mix_step = [&](int buf, int fl) {
    const float* wrow = ws + (buf * kBfWarps + fl) * kBfWs;
    const float* yrow = ys + (buf * kBfWarps + fl) * kBfCols;
    const float4 a0 = *reinterpret_cast<const float4*>(wrow + 4 * rg);
    const float4 a1 =
        *reinterpret_cast<const float4*>(wrow + kBfRows / 2 + 4 * rg);
    const float4 b0 = *reinterpret_cast<const float4*>(yrow + 4 * cg);
    const float4 b1 =
        *reinterpret_cast<const float4*>(yrow + kBfCols / 2 + 4 * cg);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float v[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
  };

  const bool bin0 = has_bin0 && k0 == 0 && lane == 0;
  int g = 0;                                 // the stage the MAC reads
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    float yr[2] = {0.f, 0.f}, yi[2] = {0.f, 0.f};
#pragma unroll 1
    for (int s = 0; s < nst; ++s) {
      cp_async_wait<kBfStages - 2>();        // this lane's copies of g
      __syncwarp();                          // ... and the warp's
      if (gi < total) issue();               // refill stage g - 1's buffer
      if (s == 0 && r + 1 < rounds) copy_w(r + 1);
      cp_async_commit();
      const float* sg = st + g * (kPos * kItem);
      g = g + 1 == kBfStages ? 0 : g + 1;
#pragma unroll
      for (int q = 0; q < kPos; ++q) {
        if (s * kPos + q >= B) break;
        const float* item = sg + q * kItem;
        const float m = item[kItem - 4];
        const float2 vr = pair_at(item, lane, X());
        const float2 vi = pair_at(item + S::kRunX, lane, X());
        const float2 hr2 = pair_at(item + 2 * S::kRunX, lane, H());
        const float2 hi2 = pair_at(item + 2 * S::kRunX + S::kRunH, lane, H());
        const float rr[2] = {vr.x, vr.y}, ri[2] = {vi.x, vi.y};
        const float hr[2] = {hr2.x * m, hr2.y * m};
        const float hi[2] = {hi2.x * m, hi2.y * m};
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          if (v == 0 && bin0) {
            // packed bin 0: DC and Nyquist are independent real products
            yr[0] += rr[0] * hr[0];
            yi[0] += ri[0] * hi[0];
          } else {
            yr[v] += rr[v] * hr[v] - ri[v] * hi[v];
            yi[v] += rr[v] * hi[v] + ri[v] * hr[v];
          }
        }
      }
      // the previous round's mix, at this warp's stage of this round
      if (r > 0 && mixes && s == mix_at) {
        for (int fl = 0; fl < kBfWarps; ++fl) mix_step((r - 1) & 1, fl);
      }
    }
    const int buf = r & 1;
    const bool live = r * kBfWarps + warp < F;
    float* y = ys + (buf * kBfWarps + warp) * kBfCols;
    reinterpret_cast<float2*>(y)[lane] =
        live ? make_float2(yr[0], yr[1]) : make_float2(0.f, 0.f);
    reinterpret_cast<float2*>(y + kBfTile)[lane] =
        live ? make_float2(yi[0], yi[1]) : make_float2(0.f, 0.f);
    // this thread's copied elements of w's chunk, transposed; its copies
    // of this chunk were issued a round ago (or before round 0) and the
    // waits since have seen them land
    if (nst < kBfStages) cp_async_wait<0>();
#pragma unroll
    for (int u = 0; u < kBfWPer; ++u) {
      const int i = tid + u * kBfThreads;
      ws[(buf * kBfWarps + i % kBfWarps) * kBfWs + i / kBfWarps] =
          wraw[buf * kBfRows * kBfWarps + i];
    }
    __syncthreads();
  }
  if (rounds > 0 && mixes) {
    const int fc = F - (rounds - 1) * kBfWarps;
    for (int fl = 0; fl < fc; ++fl) mix_step((rounds - 1) & 1, fl);
  }

  // out[c0 + row, plane h, k0 + 4 cg .. + 3]: four bins a store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kk = 4 * cg;
    if (kk >= nk) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + (i >> 2) * (kBfRows / 2) + 4 * rg + (i & 3);
      if (c >= C_out) continue;
      const float* a = &acc[i][4 * h];
      *reinterpret_cast<float4*>(out + ((size_t)c * 2 + h) * K + k0 + kk) =
          make_float4(a[0], a[1], a[2], a[3]);
    }
  }
}

template <class X, class H>
size_t bf16_smem() {
  return BfShape<X, H>::kSmemFloats * sizeof(float);
}

template <class X, class H>
int launch_bf16(const X* ring, const H* bank, const int* coeff_idx,
                const float* mask, const int* t, const float* w, float* out,
                int F, int B, int K, int E, int C_out, int has_bin0,
                cudaStream_t s) {
  const size_t bytes = bf16_smem<X, H>();
  // raise the kernel's shared-memory limit once per device
  static bool granted[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!granted[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        mac_mix_tiled_bf16_kernel<X, H>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted[dev] = true;
  }
  const dim3 grid((K + kBfTile - 1) / kBfTile,
                  (C_out + kBfRows - 1) / kBfRows);
  mac_mix_tiled_bf16_kernel<X, H><<<grid, kBfThreads, bytes, s>>>(
      ring, bank, coeff_idx, mask, t, w, out, F, B, K, E, C_out, has_bin0);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out` and checks shapes; nothing here synchronises.
// `has_bin0` as bf_mac_mix's (csrc/mac_mix.cu). ring_bf16 / bank_bf16: 1
// where that operand is bfloat16, else float32 (both 0: the float32 form).
// A bf16 form needs K % 8 == 0 and 16-byte aligned ring, bank and out
// (else cudaErrorInvalidValue); a refused shared-memory attribute comes
// back as its own error.
extern "C" int bf_mac_mix_tiled(const void* ring, const void* bank,
                                const int* coeff_idx, const float* mask,
                                const int* t, const float* w, float* out,
                                int F, int B, int K, int E, int C_out,
                                int has_bin0, int ring_bf16, int bank_bf16,
                                void* stream) {
  if (K <= 0 || C_out <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (ring_bf16 || bank_bf16) {
    if (K % 8 || !aligned16(ring) || !aligned16(bank) || !aligned16(out))
      return static_cast<int>(cudaErrorInvalidValue);
    if (F <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  }
#define BF_LAUNCH(X, H)                                                    \
  return launch_bf16(static_cast<const X*>(ring),                          \
                     static_cast<const H*>(bank), coeff_idx, mask, t, w,   \
                     out, F, B, K, E, C_out, has_bin0, s)
  if (ring_bf16 && bank_bf16) BF_LAUNCH(bf, bf);
  if (ring_bf16) BF_LAUNCH(bf, float);
  if (bank_bf16) BF_LAUNCH(float, bf);
#undef BF_LAUNCH
  const float* ring32 = static_cast<const float*>(ring);
  const float* bank32 = static_cast<const float*>(bank);
  // 4 rows a thread (32 outputs a block) for small mixes, else 32 (256)
  if (C_out <= kPass * 4)
    return launch<4>(ring32, bank32, coeff_idx, mask, t, w, out, F, B, K, E,
                     C_out, has_bin0, s);
  return launch<32>(ring32, bank32, coeff_idx, mask, t, w, out, F, B, K, E,
                    C_out, has_bin0, s);
}
