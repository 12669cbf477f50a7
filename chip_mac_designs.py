#!/usr/bin/env python3
"""Times a shared-memory form of the MAC core's uniform controls against
the kept one (``csrc/mac_core.cuh``, every filter's bank runs streamed
from L2) at the uniform shapes of ``chip_smoke.py``'s phases 4 and 5 on
one CUDA card: the measurement behind keeping the streamed form.

    python3 chip_mac_designs.py

The candidate (``STAGED_SRC`` below, built here and nowhere else) stages
the shared bank row's tile [sets, B, 2, 256 bins] in shared memory once a
block with 16-byte ``cp.async`` copies, each thread scaling the chunks it
copied by the mask; its first group of 8 partitions' ring loads is in
flight while the tile lands, and after one barrier row y of the block's
R rows walks filters y, y + R, ... of the block's group. The group is
picked so that the grid holds about P blocks an SM of an H100 (132 SMs),
at least R filters a block. Swept over (R, P) = (2, 1), (2, 4), (4, 2),
(8, 1). It takes only aligned runs and a tile that fits 227 KB: this is
a probe, not a kernel of the port.

Needs a card and ``nvcc``; builds the port's kernels as ``chip_smoke.py``
does. Every output is held against the plain version first (1e-5 of its
peak). Each time is the median of 20 calls with the L2 cache flushed by
a read before each (``chip_smoke.time_ms``, ``read_flush``), the kept
kernel first and last.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys

import chip_smoke as cs

VARIANTS = ((2, 1), (2, 4), (4, 2), (8, 1))   # (rows a block, blocks an SM)

STAGED_SRC = r"""
#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "mac_core.cuh"

// the core's own namespaces, so the kernels below sit beside its kernel
namespace bf_mac_core {
namespace {

constexpr size_t kSmemMax = 232448;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src) : "memory");
}

template <int G>
__device__ __forceinline__ void load_ring(float4 (&xr)[G], float4 (&xi)[G],
                                          const float* x, int& xoff, int ng,
                                          int part, int row, int K) {
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j < ng) {
      xr[j] = __ldg(reinterpret_cast<const float4*>(x + xoff));
      xi[j] = __ldg(reinterpret_cast<const float4*>(x + xoff + K));
      xoff -= part;
      xoff += xoff < 0 ? row : 0;
    }
  }
}

template <int NS, int R>
__global__ void __launch_bounds__(kQuads * R)
staged_kernel(const Args<NS> a, int fg) {
  constexpr int G = 8;
  extern __shared__ __align__(16) float tile[];   // [NS, B, 2, kTK]
  const int B = a.B, K = a.K;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int k0 = kTK * blockIdx.x + 4 * tx;
  const bool active = k0 < K;
  const int part = 2 * K;
  const int row = B * part;
  const int sel = clamp_index(a.rows[0], a.F);
  float* const mine = tile + 4 * tx;
  if (active) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float* h =
          a.bank + size_t(clamp_index(a.idx[s][sel], a.E)) * row + k0;
      for (int run = ty; run < 2 * B; run += R)
        cp_async16(mine + (s * 2 * B + run) * kTK,
                   h + (run >> 1) * part + (run & 1) * K);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  int slot0 = *a.t % B;
  slot0 += slot0 < 0 ? B : 0;
  const int f1 = min(a.Fs, (int)(blockIdx.y + 1) * fg);
  int i = blockIdx.y * fg + ty;
  float4 xr[G], xi[G];
  const float* x = nullptr;
  int xoff = 0;
  bool loaded = active && i < f1;
  if (loaded) {
    x = a.ring + size_t(clamp_index(a.rows[i], a.F)) * row + k0;
    xoff = slot0 * part;
    load_ring<G>(xr, xi, x, xoff, min(G, B), part, row, K);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (active) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float* m = a.mask[s] + size_t(sel) * B;
      for (int run = ty; run < 2 * B; run += R) {
        float4* c = reinterpret_cast<float4*>(mine + (s * 2 * B + run) * kTK);
        *c = scale4(*c, __ldg(m + (run >> 1)));
      }
    }
  }
  __syncthreads();
  if (!active) return;
  for (; i < f1; i += R) {
    if (!loaded) {
      x = a.ring + size_t(clamp_index(a.rows[i], a.F)) * row + k0;
      xoff = slot0 * part;
    }
    Acc acc[NS] = {};
    for (int g = 0; g < B; g += G) {
      const int ng = min(G, B - g);
      if (!loaded) load_ring<G>(xr, xi, x, xoff, ng, part, row, K);
      loaded = false;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (j < ng) {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const float* hb = mine + (s * 2 * B + 2 * (g + j)) * kTK;
            mac4(acc[s], xr[j], xi[j], *reinterpret_cast<const float4*>(hb),
                 *reinterpret_cast<const float4*>(hb + kTK));
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s)
      store_y<true>(acc[s], a.out[s] + size_t(i) * part, K, k0, 1);
  }
}

template <int NS, int R>
int launch_staged(const Args<NS>& a, int per_sm, cudaStream_t stream) {
  const int tiles = (a.K + kTK - 1) / kTK;
  const size_t bytes = size_t(NS) * a.B * 2 * kTK * sizeof(float);
  if (bytes > kSmemMax || a.K % 4 || a.B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int groups = std::max(1, std::min(a.Fs, per_sm * kSms / tiles));
  const int fg = std::max(R, (a.Fs + groups - 1) / groups);
  groups = (a.Fs + fg - 1) / fg;
  static size_t granted = 0;
  if (bytes > 48 * 1024 && bytes > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        staged_kernel<NS, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = bytes;
  }
  staged_kernel<NS, R><<<dim3(tiles, groups), dim3(kQuads, R), bytes,
                         stream>>>(a, fg);
  return static_cast<int>(cudaGetLastError());
}

template <int NS>
int by_rows(const Args<NS>& a, int rows, int per_sm, cudaStream_t s) {
  switch (rows) {
    case 2: return launch_staged<NS, 2>(a, per_sm, s);
    case 4: return launch_staged<NS, 4>(a, per_sm, s);
    case 8: return launch_staged<NS, 8>(a, per_sm, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace bf_mac_core

// The uniform controls only (rows[0]'s index and mask for every filter).
extern "C" int bf_staged(int sets, int rows, int per_sm, const float* ring,
                         const float* bank, const int* stage, const int* t,
                         const int* idx0, const int* idx1, const float* mask0,
                         const float* mask1, float* out0, float* out1, int F,
                         int Fs, int B, int K, int E, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sets == 1) {
    bf_mac_core::Args<1> a{ring, bank, stage, t, {idx0}, {mask0}, {out0},
                           F, Fs, B, K, E, 1, 1};
    return bf_mac_core::by_rows<1>(a, rows, per_sm, s);
  }
  bf_mac_core::Args<2> a{ring, bank, stage, t, {idx0, idx1},
                         {mask0, mask1}, {out0, out1}, F, Fs, B, K, E, 1,
                         1};
  return bf_mac_core::by_rows<2>(a, rows, per_sm, s);
}
"""


def build_candidate():
    """Compile STAGED_SRC (with csrc/ on the include path) into
    build/chip_mac_designs/, print its ptxas lines, load it."""
    from brutefir_tpu_torch.ops import _build
    out = _build.BUILD_DIR.parent / "chip_mac_designs"
    out.mkdir(parents=True, exist_ok=True)
    core = (_build.CSRC / "mac_core.cuh").read_bytes()
    tag = hashlib.sha256(STAGED_SRC.encode() + core).hexdigest()[:16]
    src = out / f"staged_{tag}.cu"
    so = out / f"libstaged_{tag}.so"
    src.write_text(STAGED_SRC)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        str(_build.CSRC), "-o", str(so), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        cs.fail(f"nvcc failed on the staged candidate:\n{r.stdout}{r.stderr}")
    for line in (r.stdout + r.stderr).splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bf_staged.argtypes = [I] * 3 + [P] * 10 + [I] * 5 + [P]
    lib.bf_staged.restype = I
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a card")
    from brutefir_tpu_torch.ops import mac as tm, mac_dual as td
    print(cs.card_line(), flush=True)
    lib = build_candidate()
    dev = torch.device("cuda")
    flush = cs.read_flush()
    tiny = torch.zeros(1, device=dev)
    print(f"floor (a kernel writing 4 bytes): "
          f"{cs.time_ms(lambda: tiny.zero_(), cs.REPS, flush):.4f} ms",
          flush=True)
    t7 = torch.tensor(7, dtype=torch.int32, device=dev)
    cases = []
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    for name, _, F_, B_, K_, E_, uniform, stage, _ in cs.MAC_SHAPES:
        if uniform:
            ring, bank, idx, _, stage = cs.mac_inputs(g, F_, B_, K_, E_,
                                                      True, stage)
            cases.append((name, 1, ring, bank, stage, idx, idx))
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 6)
    for label, F_, B_, K_, E_, uniform, stage, _, _ in cs.DUAL_SHAPES:
        if uniform:
            ring, bank, idx, _, pidx, _, stage = cs.dual_inputs(
                g, F_, B_, K_, E_, True, stage)
            cases.append((f"mac_dual_uniform ({label})", 2, ring, bank,
                          stage, idx, pidx))
    for name, sets, ring, bank, stage, idx, pidx in cases:
        F_, B_, _, K_ = ring.shape
        ones = torch.ones(F_, B_, device=dev)
        rt = torch.tensor(stage, dtype=torch.int32, device=dev)
        if sets == 1:
            def kept():
                return (tm.mac(ring, bank, rt, idx, ones, t7, True),)
        else:
            def kept():
                return td.mac_dual(ring, bank, rt, idx, ones, pidx, ones, t7,
                                   True)
        ref = kept()

        def staged(rows, per_sm):
            outs = [torch.empty_like(ref[0]) for _ in range(2)]
            rc = lib.bf_staged(
                sets, rows, per_sm, ring.data_ptr(), bank.data_ptr(),
                rt.data_ptr(), t7.data_ptr(), idx.data_ptr(),
                pidx.data_ptr(), ones.data_ptr(), ones.data_ptr(),
                outs[0].data_ptr(), outs[1].data_ptr(), F_, len(stage), B_,
                K_, bank.shape[0], torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                cs.fail(f"staged R={rows} P={per_sm}: cudaError {rc}")
            return outs[:sets]
        times = [f"kept {cs.time_ms(kept, cs.REPS, flush):.4f}"]
        for rows, per_sm in VARIANTS:
            for a, b in zip(staged(rows, per_sm), ref):
                cs.check(f"{name} staged R={rows} P={per_sm}", a, b, 7)
            ms = cs.time_ms(lambda: staged(rows, per_sm), cs.REPS, flush)
            times.append(f"staged R={rows} P={per_sm} {ms:.4f}")
        times.append(f"kept {cs.time_ms(kept, cs.REPS, flush):.4f}")
        print(f"{name} (Fs={len(stage)}, B={B_}, K={K_}): "
              f"{', '.join(times)} ms", flush=True)
        del ring, bank
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
