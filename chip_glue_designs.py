"""Times a shared-memory redesign of the FFT glue against the kept kernel
(``csrc/fft_glue.cu``, one bin pair a thread) at M = 8192 and C = 26 and
256 channels on one CUDA card: the measurement behind keeping the simple
form.

    python3 chip_glue_designs.py

The candidate (``STAGED_SRC`` below, built here and nowhere else) is the
tiled design: a block of T/4 threads owns the bins [j0, j0 + T) and
[M - j0 - T, M - j0) of one tile; it copies the tile's two rows of the
combine table into shared memory once, then walks a group of channels,
bringing each channel's two runs (T + 1 values each, the second one the
mirror of the first) into shared memory by 16-byte ``cp.async`` copies,
three channels in flight; the mirror reversal reads shared memory, and
each thread stores four bins of each run as 16-byte vectors. The grid is
tiles x ceil(C / channels a block), swept over T = 256, 512 and 1 to 8
channels a block. It takes only M a multiple of 2T: this is a probe, not
a kernel of the port.

Needs a card and ``nvcc``; builds the port's kernels as ``chip_smoke.py``
does. Every output is held against the plain version first (1e-5 of its
peak). Each time is the median of 20 calls (``chip_smoke.time_ms``),
cold two ways: the L2 cache flushed by a 128 MB write, and by a 128 MB
read (``chip_smoke.read_flush``, the method of the smoke's kernel table),
which leaves no dirty lines for the timed kernel to write back. A kernel writing 4 bytes and a clone
of the input are timed beside them as yardsticks of each method.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys

import chip_smoke as cs

M = cs.FFT_M
CHANNELS = (cs.F, cs.SCALE_C)
TILES = (256, 512)
PER_BLOCK = (1, 2, 4, 8)

STAGED_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_common.cuh"

namespace {

constexpr int kStages = 3;   // channels in flight a block

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* d, const void* s) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr(d)),
               "l"(s) : "memory");
}
__device__ __forceinline__ void cp8(void* d, const void* s) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(saddr(d)),
               "l"(s) : "memory");
}
__device__ __forceinline__ void cp4(void* d, const void* s) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(saddr(d)),
               "l"(s) : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block (tile, group): low bins [j0, j0 + T), high bins [h0, h0 + T),
// h0 = M - j0 - T; channels blockIdx.y, + gridDim.y, ...
template <int T>
__global__ void __launch_bounds__(T / 4)
staged_fwd(const float2* __restrict__ z, const float4* __restrict__ ab,
           float* __restrict__ out, int C, int M) {
  constexpr int NT = T / 4;
  __shared__ __align__(16) float4 tab[2][T];
  __shared__ __align__(16) float2 run[kStages][2][T + 2];
  const int tid = threadIdx.x, j0 = blockIdx.x * T, h0 = M - j0 - T;
  for (int i = tid; i < T; i += NT) {
    cp16(&tab[0][i], ab + j0 + i);
    cp16(&tab[1][i], ab + h0 + i);
  }
  auto issue = [&](int c, int s) {      // Z[j0 .. j0 + T], Z[h0 .. h0 + T]
    const float2* zc = z + (size_t)c * M;
    for (int i = tid; i < T / 2; i += NT) {
      cp16(&run[s][0][2 * i], zc + j0 + 2 * i);
      cp16(&run[s][1][2 * i], zc + h0 + 2 * i);
    }
    if (tid == 0) {
      cp8(&run[s][0][T], zc + j0 + T);
      cp8(&run[s][1][T], zc + (j0 ? M - j0 : 0));
    }
  };
  const int step = gridDim.y;
  for (int s = 0; s < kStages - 1; ++s) {
    const int c = blockIdx.y + s * step;
    if (c < C) issue(c, s);
    commit();
  }
  const int q = 4 * tid;
  int n = 0;
  for (int c = blockIdx.y; c < C; c += step, ++n) {
    wait_groups<kStages - 2>();
    __syncthreads();
    const int cn = c + (kStages - 1) * step;
    if (cn < C) issue(cn, (n + kStages - 1) % kStages);
    commit();
    const float2* lo = run[n % kStages][0];
    const float2* hi = run[n % kStages][1];
    float* xr = out + (size_t)c * 2 * M;
    float* xi = xr + M;
    float r[4], m[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 v = bf_untangle(tab[0][q + u], lo[q + u], hi[T - q - u],
                                   j0 + q + u == 0);
      r[u] = v.x;
      m[u] = v.y;
    }
    *reinterpret_cast<float4*>(xr + j0 + q) = make_float4(r[0], r[1], r[2], r[3]);
    *reinterpret_cast<float4*>(xi + j0 + q) = make_float4(m[0], m[1], m[2], m[3]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 v = bf_untangle(tab[1][q + u], hi[q + u], lo[T - q - u],
                                   false);
      r[u] = v.x;
      m[u] = v.y;
    }
    *reinterpret_cast<float4*>(xr + h0 + q) = make_float4(r[0], r[1], r[2], r[3]);
    *reinterpret_cast<float4*>(xi + h0 + q) = make_float4(m[0], m[1], m[2], m[3]);
  }
}

template <int T>
__global__ void __launch_bounds__(T / 4)
staged_inv(const float* __restrict__ p, const float4* __restrict__ ab,
           float2* __restrict__ v, int C, int M) {
  constexpr int NT = T / 4;
  __shared__ __align__(16) float4 tab[2][T];
  // re and im of the low run, re and im of the high run
  __shared__ __align__(16) float run[kStages][4][T + 4];
  const int tid = threadIdx.x, j0 = blockIdx.x * T, h0 = M - j0 - T;
  for (int i = tid; i < T; i += NT) {
    cp16(&tab[0][i], ab + j0 + i);
    cp16(&tab[1][i], ab + h0 + i);
  }
  auto issue = [&](int c, int s) {
    const float* pr = p + (size_t)c * 2 * M;
    const float* pi = pr + M;
    for (int i = tid; i < T / 4; i += NT) {
      cp16(&run[s][0][4 * i], pr + j0 + 4 * i);
      cp16(&run[s][1][4 * i], pi + j0 + 4 * i);
      cp16(&run[s][2][4 * i], pr + h0 + 4 * i);
      cp16(&run[s][3][4 * i], pi + h0 + 4 * i);
    }
    if (tid == 0) {
      const int top = j0 ? M - j0 : 0;
      cp4(&run[s][0][T], pr + j0 + T);
      cp4(&run[s][1][T], pi + j0 + T);
      cp4(&run[s][2][T], pr + top);
      cp4(&run[s][3][T], pi + top);
    }
  };
  const int step = gridDim.y;
  for (int s = 0; s < kStages - 1; ++s) {
    const int c = blockIdx.y + s * step;
    if (c < C) issue(c, s);
    commit();
  }
  const int q = 4 * tid;
  int n = 0;
  for (int c = blockIdx.y; c < C; c += step, ++n) {
    wait_groups<kStages - 2>();
    __syncthreads();
    const int cn = c + (kStages - 1) * step;
    if (cn < C) issue(cn, (n + kStages - 1) % kStages);
    commit();
    const float* lr = run[n % kStages][0];
    const float* li = run[n % kStages][1];
    const float* hr = run[n % kStages][2];
    const float* hi = run[n % kStages][3];
    float2* vc = v + (size_t)c * M;
    float2 o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int w = T - q - u;
      o[u] = j0 + q + u == 0
                 ? bf_combine_inv(tab[0][0], lr[0], 0.f, li[0], 0.f)
                 : bf_combine_inv(tab[0][q + u], lr[q + u], li[q + u], hr[w],
                                  -hi[w]);
    }
    reinterpret_cast<float4*>(vc + j0 + q)[0] = make_float4(o[0].x, o[0].y, o[1].x, o[1].y);
    reinterpret_cast<float4*>(vc + j0 + q)[1] = make_float4(o[2].x, o[2].y, o[3].x, o[3].y);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int w = T - q - u;
      o[u] = bf_combine_inv(tab[1][q + u], hr[q + u], hi[q + u], lr[w], -li[w]);
    }
    reinterpret_cast<float4*>(vc + h0 + q)[0] = make_float4(o[0].x, o[0].y, o[1].x, o[1].y);
    reinterpret_cast<float4*>(vc + h0 + q)[1] = make_float4(o[2].x, o[2].y, o[3].x, o[3].y);
  }
}

template <bool kFwd, int T>
int launch(const void* src, const float4* ab, void* dst, int C, int M, int G,
           void* stream) {
  if (C <= 0 || G <= 0 || M <= 0 || M % (2 * T))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(M / (2 * T), G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kFwd)
    staged_fwd<T><<<grid, T / 4, 0, s>>>(static_cast<const float2*>(src), ab,
                                          static_cast<float*>(dst), C, M);
  else
    staged_inv<T><<<grid, T / 4, 0, s>>>(static_cast<const float*>(src), ab,
                                          static_cast<float2*>(dst), C, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// T bins a run (256 or 512), G channel groups; returns a cudaError.
extern "C" int bf_staged(int fwd, const void* src, const float4* ab, void* dst,
                         int C, int M, int T, int G, void* stream) {
  if (T == 256)
    return fwd ? launch<true, 256>(src, ab, dst, C, M, G, stream)
               : launch<false, 256>(src, ab, dst, C, M, G, stream);
  if (T == 512)
    return fwd ? launch<true, 512>(src, ab, dst, C, M, G, stream)
               : launch<false, 512>(src, ab, dst, C, M, G, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
"""


def build_candidate():
    """Compile STAGED_SRC with the port's nvcc flags into build/ and load
    it; prints what ``-Xptxas -v`` said of its kernels."""
    from brutefir_tpu_torch.ops import _build
    out = _build.BUILD_DIR.parent / "chip_glue_designs"
    out.mkdir(parents=True, exist_ok=True)
    h = hashlib.sha256(STAGED_SRC.encode() + (
        _build.CSRC / "fft_common.cuh").read_bytes()).hexdigest()[:16]
    src, so = out / f"staged_{h}.cu", out / f"libstaged_{h}.so"
    if not so.exists():
        src.write_text(STAGED_SRC)
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                            str(_build.CSRC), "-o", str(so), str(src)],
                           capture_output=True, text=True, timeout=600)
        so.with_suffix(".log").write_text(r.stdout + r.stderr)
        if r.returncode != 0:
            cs.fail(f"nvcc failed on the candidate:\n{r.stderr[-4000:]}")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bf_staged.argtypes = [I, P, P, P, I, I, I, I, P]
    lib.bf_staged.restype = I
    return lib


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a card")
    from brutefir_tpu_torch.ops import fft_glue as tg
    print(cs.card_line(), flush=True)
    lib = build_candidate()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wflush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    rflush = cs.read_flush()

    def times(fn) -> str:
        w = cs.time_ms(fn, cs.REPS, wflush.zero_) * 1e3
        r = cs.time_ms(fn, cs.REPS, rflush) * 1e3
        return f"{w:.2f} / {r:.2f} us"

    print(f"times: write-flushed / read-flushed; {sms} SMs", flush=True)
    for C in CHANNELS:
        x, p = cs.fft_inputs(C, cs.SEED + 11 + C)
        Z = torch.fft.fft(torch.view_as_complex(x.reshape(C, M, 2)), dim=-1)
        tiny = torch.zeros(1, device="cuda")
        print(f"C={C}, M={M}: a kernel writing 4 bytes "
              f"{times(lambda: tiny.zero_())}, a clone of Z "
              f"{times(lambda: Z.clone())}", flush=True)
        for fwd, src, kept, plain in (
                (1, Z, lambda: tg.glue_fwd(Z), lambda: tg.glue_fwd_reference(Z)),
                (0, p, lambda: torch.view_as_real(tg.glue_inv(p)),
                 lambda: torch.view_as_real(tg.glue_inv_reference(p)))):
            name = "glue_fwd" if fwd else "glue_inv"
            ref = plain()
            cs.check(name, kept(), ref, f"C={C}")
            ab = tg.ab_table(M, bool(fwd), src.device)
            print(f"  {name}: kept (one pair a thread) {times(kept)}",
                  flush=True)
            for T in TILES:
                for per in PER_BLOCK:
                    G = -(-C // per)

                    def cand(T=T, G=G):
                        out = torch.empty_like(ref)
                        rc = lib.bf_staged(
                            fwd, src.data_ptr(), ab.data_ptr(),
                            out.data_ptr(), C, M, T, G,
                            torch.cuda.current_stream().cuda_stream)
                        if rc != 0:
                            cs.fail(f"staged {name} T={T} G={G}: "
                                    f"cudaError {rc}")
                        return out
                    cs.check(f"staged {name} T={T} G={G}", cand(), ref,
                             f"C={C}")
                    print(f"  {name}: staged, T={T}, {per} channels a "
                          f"block ({M // (2 * T) * G} blocks of {T // 4} "
                          f"threads) {times(cand)}", flush=True)
        del x, p, Z
        torch.cuda.empty_cache()
    return None


if __name__ == "__main__":
    sys.exit(main())
