// Shared core of the unfused partitioned MAC (csrc/mac.cu, one coefficient
// set, float32 and float64) and the crossfade dual MAC (csrc/mac_dual.cu,
// two sets, float32), CUDA C++ for sm_90a. Each source is its C entry
// around `launch<NS, R>` below, R the real type.
//
// What it computes, for each stage filter i < Fs, packed bin k (planes
// 0 = re, 1 = im) and set s < NS, with r = rows[i]:
//   Y_s[i,:,k] = sum_{b=0}^{B-1} ring[r, (t-b)%B, :, k] (x) bank[e_s, b, :, k] * m_s[b]
//   uniform = 1: e_s = idx_s[rows[0]], m_s = mask_s[rows[0]];
//   uniform = 0: e_s = idx_s[r],       m_s = mask_s[r].
// (x) is a complex multiply, except at bin 0: there DC (plane 0) and
// Nyquist (plane 1) are two independent real products
// (brutefir_tpu/ops/pallas_mac.py:291-299). Each product is the bank value
// times the mask, then FMAs of the real type over b = 0..B-1 in order
// (FP32, never TF32; FP64 under float_bits: 64) into four sums a bin:
// re*re, im*im, re*im, im*re; after the loop
// Y = (re*re - im*im, re*im + im*re), and bin 0 takes (re*re, im*im) by a
// select. So each set of the dual equals what the single MAC computes for
// that set's controls, bit for bit. `has_bin0` = 0 makes local bin 0 an
// ordinary complex product: a bin shard other than the first of a mesh
// (brutefir_tpu_torch/ops/mac_shard.py), whose local bin 0 is not the
// packed DC/Nyquist bin.
//
// Layout: ring [F, B, 2, K], bank [E, B, 2, K], rows [Fs] int32 (read in
// place: the stage's rows are never gathered into a copy), idx_s [F]
// int32 and mask_s [F, B] (every filter's controls, read at rows[i] or
// rows[0]), t a device int32 scalar (read here, so the host never waits
// on it), out_s [Fs, 2, K]; all float32 unless named, contiguous. Rows and
// bank indices are clamped into range, so a bad index cannot read out of
// bounds. Each thread owns its outputs: no atomics, the same result from
// run to run. Every real operand is of one real type R: float, or double
// for the float64 graphs (float_bits: 64), whose stage loop runs this MAC
// where the JAX package runs its dense float64 MAC (`mac = "jnp"`).
//
// What bounds it on an H100: bytes, and how many of them are in flight.
// A call must read Fs ring rows and the bank rows the stage uses
// (B * 2 * K * 4 bytes each, 8 in float64) and write NS * Fs * 2 * K * 4
// (8) bytes; it does 8 operations a partition, bin, filter and set, far
// under the FP32 rate and the FP64 rate (half of it) alike. The earlier
// kernel (one thread a bin, 4-byte loads, an integer `%` for the ring
// slot, a `k == 0` test and a mask load in every partition) spent about
// 12 instructions on each 16 bytes it loaded.
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
// registers, more warps an SM). In float64 a thread's 4 bins of a run
// are two 16-byte double2 loads, and a group holds twice the registers:
// G = kF64GroupFew on a grid of at most one block an SM, else kF64Group
// (the choice timed by chip_mac_f64_designs.py). Runs read once a call
// (the ring; the bank rows of per-filter controls) are streaming loads,
// first out of the caches; a shared bank row goes through the read-only
// cache. No barrier, no shared memory. Where K % 4 != 0 or ring, bank or
// an output is not 16-byte aligned the same code runs with scalar loads
// and stores of the same 4 bins (the last quad masked at K): every shape
// the earlier kernel took still runs.
//
// With the uniform controls every filter reads the same bank row; the
// rows after the first come from L2, which holds them (one 1 MB row at
// the massive cascade). Staging that row's tile in shared memory once a
// block, and walking a group of filters a block, measured slower at every
// block shape tried on an H100 (chip_mac_designs.py keeps that form as a
// probe): the copy and its barrier cost a block more than the L2 re-reads,
// and fewer, longer blocks keep fewer loads in flight.
//
// The bf16 operand forms (BRUTEFIR_TPU_RING_DTYPE / BRUTEFIR_TPU_BANK_DTYPE
// = bf16, float32 graphs): the ring (X) and/or the bank (H) are stored as
// bfloat16, every other operand, the FMAs and the outputs stay float32,
// as the JAX kernels upconvert on load (pallas_mac.py `_odt`, :73-76).
// A thread still owns 4 bins: a bf16 run of 4 bins is one 8-byte load
// (a uint2), widened to a float4 by shifting each 16-bit word into the
// top of a float (bf16 -> float32 is exact); the FMAs, their order and
// the group sizes are the float32 form's, so each form equals the
// float32 form on the widened operands, bit for bit. The widening waits
// for the FMAs: a group's raw 8-byte words stay in registers (raw_t)
// until then. The form this replaced widened each load where it landed,
// inside the `if (j < ng)` block that issued it; cuobjdump -sass showed
// its first widening reading a loaded register after one partition's
// loads (4 of a group's 32 8- and 16-byte loads at bench1's stage, 6 of
// 24 in the dual), so each partition of a group waited for the one
// before it: a round trip a partition where float32 pays one a group.
// Raw, all 32 of 32 issue first, as in float32. On an H100 (700 W):
// bench1's stage under the bank knob 0.0103 -> 0.0082 ms (float32
// 0.0083), bench5's dual with both 0.0157 -> 0.0103
// (chip_mac_bf16_designs.py, which keeps both forms and the count).
// Deeper groups where both are bf16 (16 / 8 partitions in the float32
// group's registers) measured no faster: 0.0116 at bench5, 0.0172 at 52
// rows against 0.0160. The vector path needs K % 4 == 0 and a bf16
// operand 8-byte aligned (a float32 one 16); else the scalar path runs,
// as in float32, widening each value as it loads it. The float32 and
// float64 forms are the instantiations with X = H = R (raw_t their quads,
// widen the identity), the same code as before.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bf_mac_core {
// internal linkage: each library that includes the core keeps its own
// kernels, even where two builds of it share a process
namespace {

constexpr int kQuads = 64;           // threads a block, 4 bins each
constexpr int kTK = 4 * kQuads;      // bins a block
constexpr int kSms = 132;            // SMs of an H100 SXM
// the float64 form's partitions a thread loads before their FMAs, on a
// grid of at most one block an SM and otherwise (chip_mac_f64_designs.py)
constexpr int kF64GroupFew = 4;
constexpr int kF64Group = 2;

// R: the real type of the sums, the mask and the outputs; X, H: the
// storage types of the ring and the bank (R, or bf16 beside float).
template <int NS, class R = float, class X = R, class H = R>
struct Args {
  const X* ring;
  const H* bank;
  const int* rows;
  const int* t;
  const int* idx[NS];
  const R* mask[NS];
  R* out[NS];
  int F, Fs, B, K, E, uniform, has_bin0;
};

// Four consecutive bins of the real type: a float4, or four doubles (two
// 16-byte halves).
struct dquad {
  double x, y, z, w;
};
template <class R>
using quad_t = std::conditional_t<std::is_same_v<R, double>, dquad, float4>;

template <class R>
__device__ __forceinline__ quad_t<R> make_quad(R x, R y, R z, R w) {
  if constexpr (std::is_same_v<R, double>)
    return dquad{x, y, z, w};
  else
    return make_float4(x, y, z, w);
}

// How a call launches; the only place its sizes are chosen.
struct Plan {
  dim3 grid;
  int group;     // partitions a thread loads before their FMAs
};

// real_bytes: 4 (float) or 8 (double); uniform: the shared bank row;
// ring_bytes, bank_bytes: the storage sizes of the ring's and the bank's
// values (2 in a bf16 form). One set reading a shared bf16 bank row beside
// a float32 ring takes groups of 8 on every grid: the bank row's loads
// hit the caches, the ring's stream sets the pace, and 8 partitions' loads
// fit fewer registers than the float32 form's group of 8 (the massive
// cascade's 52 rows under the bank knob: 0.0249 ms against 0.0264 in
// groups of 4, float32 0.0251; every other form measured no faster in
// groups of 8, chip_mac_bf16_designs.py).
inline Plan plan(int NS, int Fs, int K, int real_bytes = 4, int uniform = 0,
                 int ring_bytes = 4, int bank_bytes = 4) {
  const int tiles = (K + kTK - 1) / kTK;
  const bool few = NS == 1 && static_cast<long>(tiles) * Fs <= kSms;
  if (real_bytes == 8)
    return {dim3(tiles, Fs), few ? kF64GroupFew : kF64Group};
  if (NS == 1 && uniform && ring_bytes == 4 && bank_bytes == 2)
    return {dim3(tiles, Fs), 8};
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

// The 16-byte vector loads and stores of 4 bins: one float4, or two
// double2 halves.
template <bool STREAM>
__device__ __forceinline__ float4 vload(const float* p) {
  return ld<STREAM>(reinterpret_cast<const float4*>(p));
}

template <bool STREAM>
__device__ __forceinline__ dquad vload(const double* p) {
  const double2* q = reinterpret_cast<const double2*>(p);
  const double2 lo = ld<STREAM>(q), hi = ld<STREAM>(q + 1);
  return dquad{lo.x, lo.y, hi.x, hi.y};
}

// bf16 -> float32, exact: the 16 bits are the top half of the float.
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// 4 bf16 bins as they lie in memory: one 8-byte load, kept raw until
// the FMAs (raw_t, widen below).
template <bool STREAM>
__device__ __forceinline__ uint2 vload(const __nv_bfloat16* p) {
  return ld<STREAM>(reinterpret_cast<const uint2*>(p));
}

// One value of storage type T as the real type R.
template <bool STREAM, class R, class T>
__device__ __forceinline__ R ld1(const T* p) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return bf16_lo(ld<STREAM>(reinterpret_cast<const unsigned short*>(p)));
  else
    return ld<STREAM>(p);
}

__device__ __forceinline__ void vstore(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void vstore(double* p, dquad v) {
  double2* q = reinterpret_cast<double2*>(p);
  q[0] = make_double2(v.x, v.y);
  q[1] = make_double2(v.z, v.w);
}

// What a thread holds of 4 loaded values of storage type T until their
// FMAs: a bf16 vector load's raw 8 bytes (half the registers of the
// widened values), else the values as R (the float32 and float64 forms,
// and the scalar path, which widens each value as it loads it).
template <bool VEC, class R, class T>
using raw_t = std::conditional_t<VEC && std::is_same_v<T, __nv_bfloat16>,
                                 uint2, quad_t<R>>;

__device__ __forceinline__ float4 widen(uint2 u) {
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y),
                     bf16_hi(u.y));
}
__device__ __forceinline__ float4 widen(float4 v) { return v; }
__device__ __forceinline__ dquad widen(dquad v) { return v; }

// The 4 values at p (storage type T) as raw_t; with VEC vector loads,
// else scalar loads of the n (>= 1) that lie before K, zeros after.
template <bool VEC, bool STREAM, class R, class T>
__device__ __forceinline__ raw_t<VEC, R, T> load4(const T* p, int n) {
  if constexpr (VEC) {
    return vload<STREAM>(p);
  } else {
    quad_t<R> v = make_quad<R>(0, 0, 0, 0);
    v.x = ld1<STREAM, R>(p);
    if (n > 1) v.y = ld1<STREAM, R>(p + 1);
    if (n > 2) v.z = ld1<STREAM, R>(p + 2);
    if (n > 3) v.w = ld1<STREAM, R>(p + 3);
    return v;
  }
}

template <bool VEC, class R>
__device__ __forceinline__ void store4(R* p, quad_t<R> v, int n) {
  if constexpr (VEC) {
    vstore(p, v);
  } else {
    p[0] = v.x;
    if (n > 1) p[1] = v.y;
    if (n > 2) p[2] = v.z;
    if (n > 3) p[3] = v.w;
  }
}

__device__ __forceinline__ float4 scale4(float4 v, float m) {
  return make_float4(v.x * m, v.y * m, v.z * m, v.w * m);
}

__device__ __forceinline__ dquad scale4(dquad v, double m) {
  return dquad{v.x * m, v.y * m, v.z * m, v.w * m};
}

// The four sums of 4 bins: re*re, im*im, re*im, im*re.
template <class R>
struct AccOf {
  quad_t<R> rr, ii, ri, ir;
};
using Acc = AccOf<float>;

__device__ __forceinline__ float fmar(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ double fmar(double a, double b, double c) {
  return fma(a, b, c);
}

template <class Q>
__device__ __forceinline__ void fma4(Q& acc, Q a, Q b) {
  acc.x = fmar(a.x, b.x, acc.x);
  acc.y = fmar(a.y, b.y, acc.y);
  acc.z = fmar(a.z, b.z, acc.z);
  acc.w = fmar(a.w, b.w, acc.w);
}

template <class R>
__device__ __forceinline__ void mac4(AccOf<R>& a, quad_t<R> xr, quad_t<R> xi,
                                     quad_t<R> hr, quad_t<R> hi) {
  fma4(a.rr, xr, hr);
  fma4(a.ii, xi, hi);
  fma4(a.ri, xr, hi);
  fma4(a.ir, xi, hr);
}

// Y of bins k0 .. k0+3 into out (plane 0) and out + K (plane 1); bin 0
// keeps its two real products where `has_bin0`.
template <bool VEC, class R>
__device__ __forceinline__ void store_y(const AccOf<R>& a, R* out, int K,
                                        int k0, int has_bin0) {
  quad_t<R> re = make_quad<R>(a.rr.x - a.ii.x, a.rr.y - a.ii.y,
                              a.rr.z - a.ii.z, a.rr.w - a.ii.w);
  quad_t<R> im = make_quad<R>(a.ri.x + a.ir.x, a.ri.y + a.ir.y,
                              a.ri.z + a.ir.z, a.ri.w + a.ir.w);
  const bool bin0 = has_bin0 && k0 == 0;
  re.x = bin0 ? a.rr.x : re.x;
  im.x = bin0 ? a.ii.x : im.x;
  store4<VEC, R>(out + k0, re, K - k0);
  store4<VEC, R>(out + K + k0, im, K - k0);
}

// SHARED: the uniform controls (every filter reads rows[0]'s bank row,
// which stays in the caches); else each filter's own controls.
template <class R, class X, class H, int NS, bool VEC, int G, bool SHARED>
__global__ void __launch_bounds__(kQuads)
    mac_kernel(const Args<NS, R, X, H> a) {
  const int B = a.B, K = a.K;
  const int k0 = kTK * blockIdx.x + 4 * threadIdx.x;
  if (k0 >= K) return;
  const int n = K - k0;                       // bins left from k0
  const int part = 2 * K;                     // one partition
  const int row = B * part;                   // one filter / bank entry
  const int i = blockIdx.y;
  const int r = clamp_index(a.rows[i], a.F);
  const int sel = SHARED ? clamp_index(a.rows[0], a.F) : r;
  const X* x = a.ring + size_t(r) * row + k0;
  const H* h[NS];
  const R* m[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    h[s] = a.bank + size_t(clamp_index(a.idx[s][sel], a.E)) * row + k0;
    m[s] = a.mask[s] + size_t(sel) * B;
  }
  int slot = B > 0 ? *a.t % B : 0;
  slot += slot < 0 ? B : 0;
  int xoff = slot * part;                     // ring slot of partition b
  int hoff = 0;                               // bank partition b
  AccOf<R> acc[NS] = {};
  for (int g = 0; g < B; g += G) {
    const int ng = min(G, B - g);
    raw_t<VEC, R, X> xr[G], xi[G];
    raw_t<VEC, R, H> hr[NS][G], hi[NS][G];
    R mg[NS][G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < ng) {
        xr[j] = load4<VEC, true, R>(x + xoff, n);
        xi[j] = load4<VEC, true, R>(x + xoff + K, n);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          hr[s][j] = load4<VEC, !SHARED, R>(h[s] + hoff, n);
          hi[s][j] = load4<VEC, !SHARED, R>(h[s] + hoff + K, n);
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
          mac4<R>(acc[s], widen(xr[j]), widen(xi[j]),
                  scale4(widen(hr[s][j]), mg[s][j]),
                  scale4(widen(hi[s][j]), mg[s][j]));
      }
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
    store_y<VEC, R>(acc[s], a.out[s] + size_t(i) * part, K, k0,
                    a.has_bin0);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// What a vector load of 4 bins of T needs: 16 bytes (float, double), 8
// (bf16).
template <class T>
inline bool vec_aligned(const T* p) {
  return sizeof(T) >= 4 ? aligned16(p)
                        : reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) ==
                              0;
}

template <int NS, class R, class X, class H>
bool aligned(const Args<NS, R, X, H>& a) {
  bool ok = a.K % 4 == 0 && vec_aligned(a.ring) && vec_aligned(a.bank);
  for (int s = 0; s < NS; ++s) ok = ok && aligned16(a.out[s]);
  return ok;
}

template <class R, class X, class H, int NS, int G, bool SHARED>
void launch_form(const Args<NS, R, X, H>& a, dim3 grid,
                 cudaStream_t stream) {
  if (aligned(a))
    mac_kernel<R, X, H, NS, true, G, SHARED><<<grid, kQuads, 0, stream>>>(a);
  else
    mac_kernel<R, X, H, NS, false, G, SHARED><<<grid, kQuads, 0, stream>>>(
        a);
}

template <class R, class X, class H, int NS, int G>
void launch_group(const Args<NS, R, X, H>& a, dim3 grid,
                  cudaStream_t stream) {
  if (a.uniform)
    launch_form<R, X, H, NS, G, true>(a, grid, stream);
  else
    launch_form<R, X, H, NS, G, false>(a, grid, stream);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Nothing here synchronises.
template <int NS, class R = float, class X = R, class H = R>
int launch(const Args<NS, R, X, H>& a, cudaStream_t stream) {
  if (a.K <= 0 || a.Fs <= 0) return 0;
  const Plan p = plan(NS, a.Fs, a.K, sizeof(R), a.uniform, sizeof(X),
                      sizeof(H));
  if constexpr (std::is_same_v<R, double>) {
    if (p.group == kF64GroupFew)
      launch_group<R, X, H, NS, kF64GroupFew>(a, p.grid, stream);
    else
      launch_group<R, X, H, NS, kF64Group>(a, p.grid, stream);
  } else {
    if constexpr (NS == 1) {
      if (p.group == 8) {
        launch_group<R, X, H, NS, 8>(a, p.grid, stream);
        return static_cast<int>(cudaGetLastError());
      }
    }
    launch_group<R, X, H, NS, 4>(a, p.grid, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int NS, class X, class H>
int launch_as(const Args<NS>& f, const void* ring, const void* bank,
              cudaStream_t stream) {
  Args<NS, float, X, H> a{static_cast<const X*>(ring),
                          static_cast<const H*>(bank), f.rows, f.t};
  for (int s = 0; s < NS; ++s) {
    a.idx[s] = f.idx[s];
    a.mask[s] = f.mask[s];
    a.out[s] = f.out[s];
  }
  a.F = f.F;
  a.Fs = f.Fs;
  a.B = f.B;
  a.K = f.K;
  a.E = f.E;
  a.uniform = f.uniform;
  a.has_bin0 = f.has_bin0;
  return launch<NS, float, X, H>(a, stream);
}

// The launch of one of the four operand forms: `f` holds every operand
// but the ring and the bank (its own ring and bank pointers are not read);
// ring_bf16 and bank_bf16 say which of the two is bfloat16, the other
// float32. Neither: the float32 form.
template <int NS>
int launch_typed(const Args<NS>& f, const void* ring, const void* bank,
                 int ring_bf16, int bank_bf16, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  if (ring_bf16 && bank_bf16) return launch_as<NS, bf, bf>(f, ring, bank,
                                                           stream);
  if (ring_bf16) return launch_as<NS, bf, float>(f, ring, bank, stream);
  if (bank_bf16) return launch_as<NS, float, bf>(f, ring, bank, stream);
  return launch_as<NS, float, float>(f, ring, bank, stream);
}

}  // namespace
}  // namespace bf_mac_core
