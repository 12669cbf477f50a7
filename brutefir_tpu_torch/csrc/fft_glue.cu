// FFT glue: the Hermitian mirror and combine around an M-point complex FFT,
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pair of brutefir_tpu/ops/pallas_glue.py that
// `_glue_call` (:141-160) launches under BRUTEFIR_TPU_FFT_GLUE=pallas:
// `_fwd_kernel` (:89, fft_untangle_fwd) and `_inv_kernel` (:106,
// ifft_combine_inv). The TPU builds the mirror Z[(M-k) % M] from
// butterfly roll/select stages because a lane reversal is expensive there;
// on the card the mirror is only an index.
//
// What it computes, per channel c and bin k < M (packed planes: plane 0 =
// re, plane 1 = im; the combine rows of `ab` as in csrc/fft_common.cuh):
//   bf_glue_fwd: Z complex [C, M] (cuFFT's interleaved output) ->
//     X planes [C, 2, M], X[k] = a[k] Z[k] + b[k] conj(Z[(M-k) % M]),
//     X.im[0] = Re Z0 - Im Z0 (Nyquist);
//   bf_glue_inv: packed planes [C, 2, M] -> V complex [C, M] (the input of
//     the inverse FFT), V[k] = a'[k] K[k] + b'[k] R[k], K[k] = P[k] with
//     Im K[0] = 0, R[k] = conj(P[M-k]), R[0] = Nyquist = P.im[0].
// Everything float32 and contiguous; any leading shape is C channels.
//
// bf_glue_fwd_f64 / bf_glue_inv_f64 are the float64 form (float_bits: 64,
// around cuFFT's Z2Z transforms): the same kernels on complex128 and
// float64 planes, with the combine table kept in float64 ([M, 4] doubles,
// read as two 16-byte halves a row). They are the port's counterpart of
// the JAX package's float64 transforms (`jnp.fft` in `rfft_packed` /
// `irfft_planes_valid`, brutefir_tpu/ops/partconv.py:62, :177), which its
// float64 graphs take because `glue_ok` wants float32. Every byte doubles:
// 6.8 MB a direction at the massive shape, about 2 us at 3.35 TB/s.
//
// bf_glue_fwd_ring / bf_glue_fwd_ring_f64 glue the engine's mixed spectra
// straight into the spectra ring: X of row f lands at ring[rows[f],
// (t + delay[rows[f]]) % B] (float32, float64, or a bfloat16 ring rounded
// to nearest even), or with slot addressing off into a [Fs, 2, M]
// destination with a row stride (the grouped dispatch's later blocks). It
// replaces, beside `_fwd_kernel` (pallas_glue.py:89), the ring write that
// the JAX package leaves to XLA (`write_ring`, brutefir_tpu/graph/
// compile.py:260-274: the cast, a dynamic_update_slice or a scatter).
// The glue moved after the input mix: the glue is linear in Z bin by bin
// and the mix is a real matrix, so in_mix @ glue(Z) = glue(in_mix @ Z);
// the engine mixes cuFFT's M-point output (the same matmul on the
// [C_in, 2M] real view) and this one pass then does the glue, the cast
// and the slot write. The planes route (taps, meshes) instead makes a
// glue pass, reads the planes back in the mix and writes them into the
// ring with four to six small launches. Bound: bytes, 8M read and 8M
// written a row (4M into a bfloat16 ring, 16M and 16M in float64): 3.4
// MB at 26 rows of M = 8192, about 1.0 us at 3.35 TB/s, 10 us at 256
// rows, below the 0.005 ms one timed launch takes at the smaller shapes.
// A row's stores wait on two dependent loads, its row and its delay, so
// a stage of a few rows sits above that floor (0.0070 ms at bench1's 4
// rows, chip_smoke.py phase 6c).
//
// Design: one thread per bin pair (k, M-k), k = 0..M/2. It loads both
// values once and writes both outputs, so each input element crosses device
// memory once: neighbouring threads read neighbouring addresses from both
// ends of the channel, and every access is coalesced. Bin 0 and, for even M,
// bin M/2 are their own mirrors and are handled alone. Grid
// (ceil((M/2 + 1) / kThreads), C). The combine table (16 bytes a bin) is
// shared by every channel and stays in L2.
//
// What bounds it on an H100: bytes. Per channel it reads 8M bytes and writes
// 8M: at the massive shape (C = 26, M = 8192) 3.4 MB and the table, about
// 1.1 us at 3.35 TB/s; at C = 256 33.6 MB, about 10 us. Its arithmetic, 16
// operations a bin, is far below that. Timed cold, it runs within a few
// tenths of a us of a plain copy of its input (chip_smoke.py prints both),
// which is the floor it can reach. A tiled form that stages each tile's
// table once and the channels' runs by 16-byte cp.async, the mirror
// reversed in shared memory, was slower at every tile and channel group
// tried: chip_glue_designs.py holds it and times it against this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace {

constexpr int kThreads = 256;

// The complex type and the combine table of each real type: a float4 row
// (float), or two double2 halves a row (double).
template <class R>
struct Glue;

template <>
struct Glue<float> {
  using C = float2;
  using Row = float4;
  static __device__ __forceinline__ C untangle(const Row* ab, int k, C z,
                                               C zm, bool bin0) {
    return bf_untangle(ab[k], z, zm, bin0);
  }
  static __device__ __forceinline__ C combine(const Row* ab, int k, float kr,
                                              float ki, float rr, float ri) {
    return bf_combine_inv(ab[k], kr, ki, rr, ri);
  }
};

template <>
struct Glue<double> {
  using C = double2;
  using Row = double2;
  static __device__ __forceinline__ C untangle(const Row* ab, int k, C z,
                                               C zm, bool bin0) {
    return bf_untangle(ab[2 * k], ab[2 * k + 1], z, zm, bin0);
  }
  static __device__ __forceinline__ C combine(const Row* ab, int k,
                                              double kr, double ki,
                                              double rr, double ri) {
    return bf_combine_inv(ab[2 * k], ab[2 * k + 1], kr, ki, rr, ri);
  }
};

// Where a glued value lands: its own real type, or a bfloat16 ring
// rounded to nearest even (as torch.Tensor.to(torch.bfloat16)).
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(double* p, double v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The forward glue of bin pair (j, M - j) of one channel: zc its M-point
// spectrum, xr its real plane (the imaginary plane follows at xr + M). The
// one body of the glue's arithmetic: glue_fwd_kernel (into planes) and
// glue_fwd_ring_kernel (into the ring) both call it, so a path that glues
// into planes and copies them gives the bits of one that glues into the
// ring.
template <class R, class Out>
__device__ __forceinline__ void glue_fwd_pair(
    const typename Glue<R>::C* __restrict__ zc,
    const typename Glue<R>::Row* __restrict__ ab, Out* __restrict__ xr,
    int M, int j) {
  Out* xi = xr + M;
  const int jm = j ? M - j : 0;                 // the mirror bin
  const auto a = zc[j], b = zc[jm];
  const auto x = Glue<R>::untangle(ab, j, a, b, j == 0);
  put(xr + j, x.x);
  put(xi + j, x.y);
  if (jm != j) {
    const auto y = Glue<R>::untangle(ab, jm, b, a, false);
    put(xr + jm, y.x);
    put(xi + jm, y.y);
  }
}

template <class R>
__global__ void __launch_bounds__(kThreads)
glue_fwd_kernel(const typename Glue<R>::C* __restrict__ z,
                const typename Glue<R>::Row* __restrict__ ab,
                R* __restrict__ out, int M) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j > M / 2) return;
  const size_t c = blockIdx.y;
  glue_fwd_pair<R>(z + c * M, ab, out + c * 2 * M, M, j);
}

// Row f of the mixed spectra z lands at dst + rows[f] * row_stride (rows
// null: f), and with B > 0 at its delayed ring slot (t[0] + dt +
// delay[rows[f]]) % B of 2M values. Every thread of a block works on one
// row, so the row, the delay and t are the same three words for all of
// them (one broadcast load each).
template <class R, class Out>
__global__ void __launch_bounds__(kThreads)
glue_fwd_ring_kernel(const typename Glue<R>::C* __restrict__ z,
                     const typename Glue<R>::Row* __restrict__ ab,
                     Out* __restrict__ dst, const int* __restrict__ rows,
                     const int* __restrict__ delay,
                     const int* __restrict__ t, int dt, int M, int B,
                     int row_stride) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j > M / 2) return;
  const int f = blockIdx.y;
  const int r = rows ? rows[f] : f;
  size_t off = static_cast<size_t>(r) * row_stride;
  if (B > 0) {
    long long s = (static_cast<long long>(t[0]) + dt + delay[r]) % B;
    if (s < 0) s += B;
    off += static_cast<size_t>(s) * 2 * M;
  }
  glue_fwd_pair<R>(z + static_cast<size_t>(f) * M, ab, dst + off, M, j);
}

template <class R>
__global__ void __launch_bounds__(kThreads)
glue_inv_kernel(const R* __restrict__ p,
                const typename Glue<R>::Row* __restrict__ ab,
                typename Glue<R>::C* __restrict__ v, int M) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j > M / 2) return;
  const size_t c = blockIdx.y;
  const R* pr = p + c * 2 * M;
  const R* pi = pr + M;
  typename Glue<R>::C* vc = v + c * M;
  if (j == 0) {
    vc[0] = Glue<R>::combine(ab, 0, pr[0], R(0), pi[0], R(0));
    return;
  }
  const int jm = M - j;
  const R ar = pr[j], ai = pi[j], br = pr[jm], bi = pi[jm];
  vc[j] = Glue<R>::combine(ab, j, ar, ai, br, -bi);
  if (jm != j) vc[jm] = Glue<R>::combine(ab, jm, br, bi, ar, -ai);
}

dim3 grid_of(int C, int M) { return dim3((M / 2 + kThreads) / kThreads, C); }

template <class R>
int launch_fwd(const typename Glue<R>::C* z, const typename Glue<R>::Row* ab,
               R* out, int C, int M, void* stream) {
  if (C <= 0 || M <= 0) return 0;
  glue_fwd_kernel<R><<<grid_of(C, M), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(z, ab, out, M);
  return static_cast<int>(cudaGetLastError());
}

template <class R>
int launch_inv(const R* p, const typename Glue<R>::Row* ab,
               typename Glue<R>::C* v, int C, int M, void* stream) {
  if (C <= 0 || M <= 0) return 0;
  glue_inv_kernel<R><<<grid_of(C, M), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p, ab, v, M);
  return static_cast<int>(cudaGetLastError());
}

template <class R, class Out>
int launch_fwd_ring(const typename Glue<R>::C* z,
                    const typename Glue<R>::Row* ab, Out* dst,
                    const int* rows, const int* delay, const int* t, int dt,
                    int Fs, int M, int B, int row_stride, void* stream) {
  if (Fs <= 0 || M <= 0) return 0;
  glue_fwd_ring_kernel<R, Out><<<grid_of(Fs, M), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      z, ab, dst, rows, delay, t, dt, M, B, row_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All launch on `stream` and return cudaGetLastError() (0 on success). The
// caller allocates the output and checks shapes; nothing here synchronises.
extern "C" int bf_glue_fwd(const float2* z, const float4* ab, float* out,
                           int C, int M, void* stream) {
  return launch_fwd<float>(z, ab, out, C, M, stream);
}

extern "C" int bf_glue_inv(const float* p, const float4* ab, float2* v, int C,
                           int M, void* stream) {
  return launch_inv<float>(p, ab, v, C, M, stream);
}

extern "C" int bf_glue_fwd_f64(const double2* z, const double2* ab,
                               double* out, int C, int M, void* stream) {
  return launch_fwd<double>(z, ab, out, C, M, stream);
}

extern "C" int bf_glue_inv_f64(const double* p, const double2* ab,
                               double2* v, int C, int M, void* stream) {
  return launch_inv<double>(p, ab, v, C, M, stream);
}

// The forward glue of the mixed spectra z [Fs, M] straight into its
// destination: with B > 0 the ring [F, B, 2, M] (row_stride B * 2M), row
// f at ring[rows[f], (t[0] + dt + delay[rows[f]]) % B]; with B = 0 a
// [Fs, 2, M] destination whose rows lie row_stride values apart (delay
// and t unread). dst is float32, or bfloat16 where dst_bf16 is 1.
extern "C" int bf_glue_fwd_ring(const float2* z, const float4* ab, void* dst,
                                const int* rows, const int* delay,
                                const int* t, int dt, int Fs, int M, int B,
                                int row_stride, int dst_bf16, void* stream) {
  if (dst_bf16)
    return launch_fwd_ring<float>(z, ab, static_cast<__nv_bfloat16*>(dst),
                                  rows, delay, t, dt, Fs, M, B, row_stride,
                                  stream);
  return launch_fwd_ring<float>(z, ab, static_cast<float*>(dst), rows, delay,
                                t, dt, Fs, M, B, row_stride, stream);
}

extern "C" int bf_glue_fwd_ring_f64(const double2* z, const double2* ab,
                                    double* dst, const int* rows,
                                    const int* delay, const int* t, int dt,
                                    int Fs, int M, int B, int row_stride,
                                    void* stream) {
  return launch_fwd_ring<double>(z, ab, dst, rows, delay, t, dt, Fs, M, B,
                                 row_stride, stream);
}
