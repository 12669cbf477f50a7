// Fused real FFT: the whole packed real transform of a channel in one kernel,
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pair of brutefir_tpu/ops/pallas_fft.py:
// `_fwd_kernel` (:154, via `rfft_planes_fused` :215-244) and `_inv_kernel`
// (:184, via `_inv_call` :247-273). The TPU runs a 4-step transform as dense
// f32 matmuls on its matrix unit and gets the Hermitian mirror as a second,
// conjugate-input transform, because a lane reversal is expensive there.
// None of that is carried over: on the card the mirror is an index into
// shared memory, and the transform is a radix-4/2 Stockham FFT.
//
// What it computes, per channel c (R = M/128; tile position p = k1*128 + k2
// holds natural bin k = k2*R + k1, the JAX package's `bin_order`):
//   bf_fft_fused_fwd: real x [C, 2M] -> packed planes [C, 2, M] in the
//     permuted order: z[n] = x[2n] + i x[2n+1], Z = DFT_M(z), then the
//     forward glue X[k] = a Z[k] + b conj(Z[(M-k) % M]) with Nyquist in
//     bin 0's imaginary slot (csrc/fft_common.cuh), X[k] written to p;
//   bf_fft_fused_inv: permuted packed planes [C, 2, M] -> real
//     [C, 2 n_out]: the planes gathered into natural order, the inverse
//     glue V[k] = a' K[k] + b' R[k], z = IDFT_M(V) / M, and the first n_out
//     complex outputs written as re/im pairs (n_out = M: the full 2M-sample
//     frame; n_out = M/2: its valid lower half).
// The DFT is the Stockham autosort FFT: stages of radix 4, then 2, then the
// odd factors of R (3, 5, ... as plain r-point DFTs), each stage
//   y[(i - k) r + k + q p] = sum_m x[i + m M/r] e^{-+2 pi i m (k + q p)/(p r)}
// over butterflies i < M/r, k = i mod p, p the product of the earlier
// radices; radix 4 and 2 as the usual twiddle-then-butterfly. The twiddles
// come from one table e^{-2 pi i j/M}, built in float64 and rounded once
// (the inverse reads its conjugate). ops/fft_fused.py's plain version runs
// the same stages in the same order. Every M the wrapper takes (M % 128 ==
// 0, M >= 256) works.
//
// Design: one thread block per channel holds its M complex points, two
// buffers (ping-pong) of 8M bytes each, in dynamic shared memory: 128 KB at
// M = 8192, under the 227 KB a block may have. Past that (M > 14528,
// bf_fft_fused_needs_scratch) the wrapper passes a scratch buffer of
// [C, 2M] complex in device memory and the same code runs there; __syncthreads() orders the stages either way.
// Loads of x and stores of the output are coalesced (float2 pairs, and the
// permuted positions p in order); the scattered accesses are in shared
// memory.
//
// What bounds it on an H100: bytes. Per channel it reads 8M bytes and writes
// 8M (the valid inverse 4M); at C = 26, M = 8192 3.4 MB, about 1.0 us at
// 3.35 TB/s. The FFT's arithmetic, about 5 M log2 M operations a channel
// (0.6 MFLOP at M = 8192), is far below that. With one block per channel
// only C SMs work (26 of 132 at the massive shape), so this first version
// is latency bound by its stages; splitting a channel over a cluster is
// later work.

#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kLanes = 128;
constexpr int kSmemMax = 232448;      // 227 KB: a block's opt-in maximum

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// e^{kSign 2 pi i j / M}: the table holds e^{-2 pi i j / M}
template <int kSign>
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw,
                                          int j) {
  const float2 w = __ldg(tw + j);
  return kSign < 0 ? w : make_float2(w.x, -w.y);
}

// The radix of the next stage: 4 while it divides, then 2, then the odd
// factors in ascending order.
__device__ __forceinline__ int next_radix(int rem) {
  if (rem % 4 == 0) return 4;
  if (rem % 2 == 0) return 2;
  int f = 3;
  while (rem % f) f += 2;
  return f;
}

// The M-point DFT of `src` (kSign = -1) or its unnormalised inverse
// (kSign = +1), by the whole block; `dst` is the other buffer. Returns the
// buffer that holds the result. The caller synchronised after writing src.
template <int kSign>
__device__ float2* stockham(float2* src, float2* dst,
                            const float2* __restrict__ tw, int M) {
  int p = 1;
  for (int rem = M; rem > 1;) {
    const int r = next_radix(rem);
    const int n = M / r;                  // butterflies: input m at i + m n
    const int step = M / (p * r);         // table stride of e^{2 pi i/(p r)}
    if (r == 4) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int k = i & (p - 1);        // p is a power of 4 here
        const float2 x0 = src[i];
        const float2 x1 = cmul(src[i + n], twiddle<kSign>(tw, k * step));
        const float2 x2 = cmul(src[i + 2 * n],
                               twiddle<kSign>(tw, 2 * k * step));
        const float2 x3 = cmul(src[i + 3 * n],
                               twiddle<kSign>(tw, 3 * k * step));
        const float2 a0 = cadd(x0, x2), a1 = csub(x0, x2);
        const float2 b0 = cadd(x1, x3), d = csub(x1, x3);
        // d times -i (forward) or +i (inverse)
        const float2 b1 = kSign < 0 ? make_float2(d.y, -d.x)
                                    : make_float2(-d.y, d.x);
        const int j = (i - k) * 4 + k;
        dst[j] = cadd(a0, b0);
        dst[j + p] = cadd(a1, b1);
        dst[j + 2 * p] = csub(a0, b0);
        dst[j + 3 * p] = csub(a1, b1);
      }
    } else if (r == 2) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int k = i & (p - 1);        // p is a power of 2 here
        const float2 x0 = src[i];
        const float2 x1 = cmul(src[i + n], twiddle<kSign>(tw, k * step));
        const int j = (i - k) * 2 + k;
        dst[j] = cadd(x0, x1);
        dst[j + p] = csub(x0, x1);
      }
    } else {
      const int pr = p * r;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int k = i % p;
        const int j = (i - k) * r + k;
        for (int q = 0; q < r; ++q) {
          const long long e = k + q * p;
          float2 acc = src[i];
          for (int m = 1; m < r; ++m) {
            const int ix = static_cast<int>((m * e) % pr) * step;
            acc = cadd(acc, cmul(src[i + m * n], twiddle<kSign>(tw, ix)));
          }
          dst[j + q * p] = acc;
        }
      }
    }
    __syncthreads();
    float2* t = src;
    src = dst;
    dst = t;
    p *= r;
    rem /= r;
  }
  return src;
}

__global__ void __launch_bounds__(kThreads)
fused_fwd_kernel(const float2* __restrict__ x, const float2* __restrict__ tw,
                 const float4* __restrict__ ab_perm, float* __restrict__ out,
                 float2* scratch, int M) {
  const int R = M / kLanes;
  const size_t c = blockIdx.x;
  extern __shared__ float2 smem[];
  // the channel's two buffers: shared memory, or its slice of `scratch`
  float2* a = scratch ? scratch + c * 2 * M : smem;
  float2* b = a + M;
  const float2* xc = x + c * M;           // (even, odd) sample pairs
  for (int n = threadIdx.x; n < M; n += blockDim.x) a[n] = xc[n];
  __syncthreads();
  const float2* Z = stockham<-1>(a, b, tw, M);
  float* xr = out + c * 2 * M;
  float* xi = xr + M;
  for (int p = threadIdx.x; p < M; p += blockDim.x) {
    const int k = (p % kLanes) * R + p / kLanes;
    const float2 X = bf_untangle(ab_perm[p], Z[k], Z[k ? M - k : 0], k == 0);
    xr[p] = X.x;
    xi[p] = X.y;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_inv_kernel(const float* __restrict__ planes,
                 const float2* __restrict__ tw, const float4* __restrict__ ab,
                 float2* __restrict__ out, float2* scratch, int M,
                 int n_out) {
  const int R = M / kLanes;
  const size_t c = blockIdx.x;
  extern __shared__ float2 smem[];
  float2* a = scratch ? scratch + c * 2 * M : smem;
  float2* b = a + M;
  const float* pr = planes + c * 2 * M;
  const float* pi = pr + M;
  // natural order: the bin at permuted position p is k = (p % 128) R + p/128
  for (int p = threadIdx.x; p < M; p += blockDim.x)
    b[(p % kLanes) * R + p / kLanes] = make_float2(pr[p], pi[p]);
  __syncthreads();
  for (int k = threadIdx.x; k < M; k += blockDim.x) {
    const float2 P = b[k];
    if (k == 0) {
      a[0] = bf_combine_inv(ab[0], P.x, 0.f, P.y, 0.f);
    } else {
      const float2 Q = b[M - k];
      a[k] = bf_combine_inv(ab[k], P.x, P.y, Q.x, -Q.y);
    }
  }
  __syncthreads();
  const float2* z = stockham<1>(a, b, tw, M);
  const float s = 1.0f / static_cast<float>(M);
  float2* o = out + c * n_out;
  for (int n = threadIdx.x; n < n_out; n += blockDim.x)
    o[n] = make_float2(z[n].x * s, z[n].y * s);
}

// Shared memory for M points, or 0 when the channel runs in `scratch`.
int smem_bytes(const float2* scratch, int M) {
  return scratch ? 0 : 2 * M * static_cast<int>(sizeof(float2));
}

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024)
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  return 0;
}

}  // namespace

// 1 when a channel's two buffers (16 M bytes) outgrow a block's shared
// memory, so that the kernels need the scratch buffer; else 0.
extern "C" int bf_fft_fused_needs_scratch(int M) {
  return 2 * M * static_cast<int>(sizeof(float2)) > kSmemMax;
}

// Both launch C blocks on `stream` and return a cudaError (0 on success).
// `scratch` is null (shared memory) or [C, 2M] complex, as
// bf_fft_fused_needs_scratch says. The caller allocates the output and
// checks shapes; nothing here synchronises.
extern "C" int bf_fft_fused_fwd(const float2* x, const float2* tw,
                                const float4* ab_perm, float* out,
                                float2* scratch, int C, int M, void* stream) {
  if (C <= 0) return 0;
  const int smem = smem_bytes(scratch, M);
  const int rc = prepare(fused_fwd_kernel, smem);
  if (rc != 0) return rc;
  fused_fwd_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, tw, ab_perm, out, scratch, M);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bf_fft_fused_inv(const float* planes, const float2* tw,
                                const float4* ab, float2* out,
                                float2* scratch, int C, int M, int n_out,
                                void* stream) {
  if (C <= 0) return 0;
  const int smem = smem_bytes(scratch, M);
  const int rc = prepare(fused_inv_kernel, smem);
  if (rc != 0) return rc;
  fused_inv_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      planes, tw, ab, out, scratch, M, n_out);
  return static_cast<int>(cudaGetLastError());
}
