// Shared core of the unfused partitioned MAC (csrc/mac.cu, one coefficient
// set) and the crossfade dual MAC (csrc/mac_dual.cu, two sets), CUDA C++
// for sm_90a. Each source is its C entry around `launch<NS>` below.
//
// What it computes, for each stage filter i < Fs, packed bin k (planes
// 0 = re, 1 = im) and set s < NS, with r = rows[i]:
//   Y_s[i,:,k] = sum_{b=0}^{B-1} ring[r, (t-b)%B, :, k] (x) bank[e_s, b, :, k] * m_s[b]
//   uniform = 1: e_s = idx_s[rows[0]], m_s = mask_s[rows[0]];
//   uniform = 0: e_s = idx_s[r],       m_s = mask_s[r].
// (x) is a complex multiply, except at bin 0: there DC (plane 0) and
// Nyquist (plane 1) are two independent real products
// (brutefir_tpu/ops/pallas_mac.py:291-299). Each product is the bank value
// times the mask, then FP32 FMAs over b = 0..B-1 in order (never TF32)
// into four sums a bin: re*re, im*im, re*im, im*re; after the loop
// Y = (re*re - im*im, re*im + im*re), and bin 0 takes (re*re, im*im) by a
// select. So each set of the dual equals what the single MAC computes for
// that set's controls, bit for bit.
//
// Layout: ring [F, B, 2, K], bank [E, B, 2, K], rows [Fs] int32 (read in
// place: the stage's rows are never gathered into a copy), idx_s [F]
// int32 and mask_s [F, B] (every filter's controls, read at rows[i] or
// rows[0]), t a device int32 scalar (read here, so the host never waits
// on it), out_s [Fs, 2, K]; all float32 unless named, contiguous. Rows and
// bank indices are clamped into range, so a bad index cannot read out of
// bounds. Each thread owns its outputs: no atomics, the same result from
// run to run.
//
// What bounds it on an H100: bytes, and how many of them are in flight.
// A call must read Fs ring rows and the bank rows the stage uses
// (B * 2 * K * 4 bytes each) and write NS * Fs * 2 * K * 4 bytes; it does
// 8 FP32 operations a partition, bin, filter and set, far under the FP32
// rate. The earlier kernel (one thread a bin, 4-byte loads, an integer `%`
// for the ring slot, a `k == 0` test and a mask load in every partition)
// spent about 12 instructions on each 16 bytes it loaded.
//
// Design: grid (tiles of kTK bins, Fs), kQuads threads a block, one
// filter a block. A thread owns 4 consecutive bins of its filter and loads
// each re and im run of its ring slot and bank partition as one float4:
// per partition and set 2 + 2 loads of 16 bytes and 16 FMAs. The ring slot
// s = t mod B is taken once; each partition steps its offset down a slot,
// wrapping by a compare. A thread issues the loads of a group of G
// partitions, and their mask values (one address a warp), before their
// FMAs: G = 8 for one set on a grid of at most one block an SM (bench1's
// stages: one round trip to memory instead of two), else 4 (fewer
// registers, more warps an SM). Runs read once a call (the ring; the bank
// rows of per-filter controls) are streaming loads, first out of the
// caches; a shared bank row goes through the read-only cache. No barrier,
// no shared memory. Where K % 4 != 0 or ring, bank or an output is not
// 16-byte aligned the same code runs with scalar loads and stores of the
// same 4 bins (the last quad masked at K): every shape the earlier kernel
// took still runs.
//
// With the uniform controls every filter reads the same bank row; the
// rows after the first come from L2, which holds them (one 1 MB row at
// the massive cascade). Staging that row's tile in shared memory once a
// block, and walking a group of filters a block, measured slower at every
// block shape tried on an H100 (chip_mac_designs.py keeps that form as a
// probe): the copy and its barrier cost a block more than the L2 re-reads,
// and fewer, longer blocks keep fewer loads in flight.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace bf_mac_core {
// internal linkage: each library that includes the core keeps its own
// kernels, even where two builds of it share a process
namespace {

constexpr int kQuads = 64;           // threads a block, 4 bins each
constexpr int kTK = 4 * kQuads;      // bins a block
constexpr int kSms = 132;            // SMs of an H100 SXM

template <int NS>
struct Args {
  const float* ring;
  const float* bank;
  const int* rows;
  const int* t;
  const int* idx[NS];
  const float* mask[NS];
  float* out[NS];
  int F, Fs, B, K, E, uniform;
};

// How a call launches; the only place its sizes are chosen.
struct Plan {
  dim3 grid;
  int group;     // partitions a thread loads before their FMAs
};

inline Plan plan(int NS, int Fs, int K) {
  const int tiles = (K + kTK - 1) / kTK;
  const bool few = NS == 1 && static_cast<long>(tiles) * Fs <= kSms;
  return {dim3(tiles, Fs), few ? 8 : 4};
}

__device__ __forceinline__ int clamp_index(int v, int n) {
  return min(max(v, 0), n - 1);
}

// A load through the read-only cache (data read again: a shared bank row)
// or a streaming one (read once a call, first out of the caches).
template <bool STREAM, class T>
__device__ __forceinline__ T ld(const T* p) {
  return STREAM ? __ldcs(p) : __ldg(p);
}

// The 4 floats at p; with VEC one 16-byte load, else scalar loads of the
// n (>= 1) that lie before K, zeros after.
template <bool VEC, bool STREAM>
__device__ __forceinline__ float4 load4(const float* p, int n) {
  if (VEC) return ld<STREAM>(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  v.x = ld<STREAM>(p);
  if (n > 1) v.y = ld<STREAM>(p + 1);
  if (n > 2) v.z = ld<STREAM>(p + 2);
  if (n > 3) v.w = ld<STREAM>(p + 3);
  return v;
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, float4 v, int n) {
  if (VEC) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  p[0] = v.x;
  if (n > 1) p[1] = v.y;
  if (n > 2) p[2] = v.z;
  if (n > 3) p[3] = v.w;
}

__device__ __forceinline__ float4 scale4(float4 v, float m) {
  return make_float4(v.x * m, v.y * m, v.z * m, v.w * m);
}

// The four sums of 4 bins: re*re, im*im, re*im, im*re.
struct Acc {
  float4 rr, ii, ri, ir;
};

__device__ __forceinline__ void fma4(float4& acc, float4 a, float4 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
  acc.z = fmaf(a.z, b.z, acc.z);
  acc.w = fmaf(a.w, b.w, acc.w);
}

__device__ __forceinline__ void mac4(Acc& a, float4 xr, float4 xi, float4 hr,
                                     float4 hi) {
  fma4(a.rr, xr, hr);
  fma4(a.ii, xi, hi);
  fma4(a.ri, xr, hi);
  fma4(a.ir, xi, hr);
}

// Y of bins k0 .. k0+3 into out (plane 0) and out + K (plane 1); bin 0
// keeps its two real products.
template <bool VEC>
__device__ __forceinline__ void store_y(const Acc& a, float* out, int K,
                                        int k0) {
  float4 re = make_float4(a.rr.x - a.ii.x, a.rr.y - a.ii.y, a.rr.z - a.ii.z,
                          a.rr.w - a.ii.w);
  float4 im = make_float4(a.ri.x + a.ir.x, a.ri.y + a.ir.y, a.ri.z + a.ir.z,
                          a.ri.w + a.ir.w);
  const bool bin0 = k0 == 0;
  re.x = bin0 ? a.rr.x : re.x;
  im.x = bin0 ? a.ii.x : im.x;
  store4<VEC>(out + k0, re, K - k0);
  store4<VEC>(out + K + k0, im, K - k0);
}

// SHARED: the uniform controls (every filter reads rows[0]'s bank row,
// which stays in the caches); else each filter's own controls.
template <int NS, bool VEC, int G, bool SHARED>
__global__ void __launch_bounds__(kQuads) mac_kernel(const Args<NS> a) {
  const int B = a.B, K = a.K;
  const int k0 = kTK * blockIdx.x + 4 * threadIdx.x;
  if (k0 >= K) return;
  const int n = K - k0;                       // bins left from k0
  const int part = 2 * K;                     // one partition
  const int row = B * part;                   // one filter / bank entry
  const int i = blockIdx.y;
  const int r = clamp_index(a.rows[i], a.F);
  const int sel = SHARED ? clamp_index(a.rows[0], a.F) : r;
  const float* x = a.ring + size_t(r) * row + k0;
  const float* h[NS];
  const float* m[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    h[s] = a.bank + size_t(clamp_index(a.idx[s][sel], a.E)) * row + k0;
    m[s] = a.mask[s] + size_t(sel) * B;
  }
  int slot = B > 0 ? *a.t % B : 0;
  slot += slot < 0 ? B : 0;
  int xoff = slot * part;                     // ring slot of partition b
  int hoff = 0;                               // bank partition b
  Acc acc[NS] = {};
  for (int g = 0; g < B; g += G) {
    const int ng = min(G, B - g);
    float4 xr[G], xi[G], hr[NS][G], hi[NS][G];
    float mg[NS][G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < ng) {
        xr[j] = load4<VEC, true>(x + xoff, n);
        xi[j] = load4<VEC, true>(x + xoff + K, n);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          hr[s][j] = load4<VEC, !SHARED>(h[s] + hoff, n);
          hi[s][j] = load4<VEC, !SHARED>(h[s] + hoff + K, n);
          mg[s][j] = __ldg(m[s] + g + j);
        }
        xoff -= part;
        xoff += xoff < 0 ? row : 0;
        hoff += part;
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < ng) {
#pragma unroll
        for (int s = 0; s < NS; ++s)
          mac4(acc[s], xr[j], xi[j], scale4(hr[s][j], mg[s][j]),
               scale4(hi[s][j], mg[s][j]));
      }
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
    store_y<VEC>(acc[s], a.out[s] + size_t(i) * part, K, k0);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int NS>
bool aligned(const Args<NS>& a) {
  bool ok = a.K % 4 == 0 && aligned16(a.ring) && aligned16(a.bank);
  for (int s = 0; s < NS; ++s) ok = ok && aligned16(a.out[s]);
  return ok;
}

template <int NS, int G, bool SHARED>
void launch_form(const Args<NS>& a, dim3 grid, cudaStream_t stream) {
  if (aligned(a))
    mac_kernel<NS, true, G, SHARED><<<grid, kQuads, 0, stream>>>(a);
  else
    mac_kernel<NS, false, G, SHARED><<<grid, kQuads, 0, stream>>>(a);
}

template <int NS, int G>
void launch_group(const Args<NS>& a, dim3 grid, cudaStream_t stream) {
  if (a.uniform)
    launch_form<NS, G, true>(a, grid, stream);
  else
    launch_form<NS, G, false>(a, grid, stream);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Nothing here synchronises.
template <int NS>
int launch(const Args<NS>& a, cudaStream_t stream) {
  if (a.K <= 0 || a.Fs <= 0) return 0;
  const Plan p = plan(NS, a.Fs, a.K);
  if constexpr (NS == 1) {
    if (p.group == 8) {
      launch_group<NS, 8>(a, p.grid, stream);
      return static_cast<int>(cudaGetLastError());
    }
  }
  launch_group<NS, 4>(a, p.grid, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace bf_mac_core
