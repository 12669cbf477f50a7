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
// Everything float32, contiguous; any leading shape is C channels.
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

#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
glue_fwd_kernel(const float2* __restrict__ z, const float4* __restrict__ ab,
                float* __restrict__ out, int M) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j > M / 2) return;
  const size_t c = blockIdx.y;
  const float2* zc = z + c * M;
  float* xr = out + c * 2 * M;
  float* xi = xr + M;
  const int jm = j ? M - j : 0;                 // the mirror bin
  const float2 a = zc[j], b = zc[jm];
  const float2 x = bf_untangle(ab[j], a, b, j == 0);
  xr[j] = x.x;
  xi[j] = x.y;
  if (jm != j) {
    const float2 y = bf_untangle(ab[jm], b, a, false);
    xr[jm] = y.x;
    xi[jm] = y.y;
  }
}

__global__ void __launch_bounds__(kThreads)
glue_inv_kernel(const float* __restrict__ p, const float4* __restrict__ ab,
                float2* __restrict__ v, int M) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j > M / 2) return;
  const size_t c = blockIdx.y;
  const float* pr = p + c * 2 * M;
  const float* pi = pr + M;
  float2* vc = v + c * M;
  if (j == 0) {
    vc[0] = bf_combine_inv(ab[0], pr[0], 0.f, pi[0], 0.f);
    return;
  }
  const int jm = M - j;
  const float ar = pr[j], ai = pi[j], br = pr[jm], bi = pi[jm];
  vc[j] = bf_combine_inv(ab[j], ar, ai, br, -bi);
  if (jm != j) vc[jm] = bf_combine_inv(ab[jm], br, bi, ar, -ai);
}

dim3 grid_of(int C, int M) { return dim3((M / 2 + kThreads) / kThreads, C); }

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 on success). The
// caller allocates the output and checks shapes; nothing here synchronises.
extern "C" int bf_glue_fwd(const float2* z, const float4* ab, float* out,
                           int C, int M, void* stream) {
  if (C <= 0 || M <= 0) return 0;
  glue_fwd_kernel<<<grid_of(C, M), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(z, ab, out, M);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bf_glue_inv(const float* p, const float4* ab, float2* v, int C,
                           int M, void* stream) {
  if (C <= 0 || M <= 0) return 0;
  glue_inv_kernel<<<grid_of(C, M), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(p, ab, v, M);
  return static_cast<int>(cudaGetLastError());
}
