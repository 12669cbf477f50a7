#!/usr/bin/env python3
"""Times forms of the grouped fused MAC + output mix (``bf_mac_mix_group``
of ``csrc/mac_group.cu``, TPU kernel 5) at G = 2 at the 256-channel
scale shape on one CUDA card: the measurements behind the kept form, and
what each part of it costs.

    python3 chip_mix_group_designs.py

Each form is the kept source with text patches applied here (each patch
must apply; the variants are built into ``build/chip_mix_group_designs/``
with the port's nvcc flags and called through the same C entry):

- ``kept``: the source as it is;
- ``spread``: each warp's share of the mix spread over every stage of the
  next round instead of run at its own stage;
- ``stages2``, ``stages4``: 2 or 4 stages in each warp's copy ring;
- ``mma``: the mix as 3xTF32 ``mma.sync`` (m16n8k8; each operand stored
  as a (hi, lo) pair of TF32 halves, three products), warp tiles of 64
  rows x 32 columns;
- ``tf32x1``: the same with one product (hi x hi), for its error;
- ``copy_warp``: a 17th warp fills the stage ring with ``cp.async.bulk``
  copies (one 128-byte run each) behind mbarriers (``COPY_WARP_SRC``);
- ``specialized``: warpgroups 0-1 copy and MAC rounds of 8 filters,
  warpgroups 2-3 mix them (8 rows x 16 columns a thread), registers moved
  from the first to the second by ``setmaxnreg`` (80 and 176 a thread),
  Ys and Ws handed over through named barriers (``SPECIALIZED_SRC``);
- ablations of the kept form, wrong results by design and only timed:
  ``copies_only`` (no MAC, no mix), ``no_mix``, ``mix_only`` (no copies,
  no MAC), ``skeleton`` (no copies, no MAC, no mix).

Prints each form's ptxas registers and spills, its time (median of 20
calls, the L2 cache flushed by a 128 MB read before each:
``chip_smoke.time_ms``, ``read_flush``) and its error against the plain
version (``mac_mix_group_reference``; 1e-5 of the peak is the port's
bar), beside the byte bound and the timing floor, the kept form first
and last.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import chip_smoke as cs

OUT = os.path.join(cs.REPO, "build", "chip_mix_group_designs")
SRC = os.path.join(cs.REPO, "brutefir_tpu_torch", "csrc", "mac_group.cu")


def sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"chip_mix_group_designs: a patch does not apply: "
                         f"{old[:60]!r}")
    return src.replace(old, new)


STAGGER = """      if (r > 0 && mixes && s == warp % nst) {
        for (int fl = 0; fl < kFc; ++fl) mix_step((r - 1) & 1, fl);
      }"""
SPREAD = """      if (r > 0 && mixes) {
        const int f_hi = (s + 1) * kFc / nst;
        for (int fl = s * kFc / nst; fl < f_hi; ++fl)
          mix_step((r - 1) & 1, fl);
      }"""
DRAIN = """    for (int fl = 0; fl < fc; ++fl) mix_step((rounds - 1) & 1, fl);"""
MAC_IF = """        if (pos >= G - 1) {
          // V(g - b)"""
COPY_RUN = """  auto copy_run = [&](float* d, const char* src, bool on) {"""


def spread(src):
    return sub(src, STAGGER, SPREAD)


def stages(n):
    return lambda src: sub(src, "constexpr int kStages = 3;",
                           f"constexpr int kStages = {n};")


def no_mix(src):
    src = sub(src, STAGGER, "")
    return sub(src, DRAIN, "")


def no_mac(src):
    return sub(src, MAC_IF, MAC_IF.replace("pos >= G - 1", "false"))


def no_copy(src):
    return sub(src, COPY_RUN, COPY_RUN + "\n    on = false;")


MMA_HELPERS = r"""
__device__ __forceinline__ float2 split_tf32(float x) {
  uint32_t hi, lo;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
  return make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kAligned: K % 4 == 0"""

MMA_MIX = r"""  const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;
  const int gid = lane >> 2, tig = lane & 3;
  const bool mixes = wm * 64 < C_out - c0 && wn * 32 < G * 2 * kTileBins;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  auto mix_step = [&](int kk) {   // filters 8 kk .. 8 kk + 7
    const float2* yk = ys + (8 * kk + tig) * S::kYs2 + wn * 32 + gid;
    const float2* wk = ws + (8 * kk + tig) * S::kWs2 + wm * 64 + gid;
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = yk[h * 4 * S::kYs2 + nt * 8];
        bh[nt][h] = __float_as_uint(v.x);
        bl[nt][h] = __float_as_uint(v.y);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 v = wk[(e >> 1) * 4 * S::kWs2 + mt * 16 + (e & 1) * 8];
        ah[e] = __float_as_uint(v.x);
        al[e] = __float_as_uint(v.y);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        LO_PRODUCTS
        mma_tf32(acc[mt][nt], ah, bh[nt][0], bh[nt][1]);
      }
    }
  };

"""

MMA_STORE = r"""#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = wn * 32 + nt * 8 + 2 * tig;
    const int gg = col / (2 * kTileBins), p = (col / kTileBins) & 1;
    const int kk = col % kTileBins;
    if (gg >= G || kk >= nk) continue;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + wm * 64 + mt * 16 + gid + 8 * h;
        if (c >= C_out) continue;
        float* o = out + (((size_t)gg * C_out + c) * 2 + p) * K + k0 + kk;
        const float a0 = acc[mt][nt][2 * h], a1 = acc[mt][nt][2 * h + 1];
        if (kAligned) {
          *reinterpret_cast<float2*>(o) = make_float2(a0, a1);
        } else {
          o[0] = a0;
          if (kk + 1 < nk) o[1] = a1;
        }
      }
    }
  }
}

"""


def mma(products: int):
    """The mix on the tensor cores: Ys and Ws as (hi, lo) TF32 pairs,
    single-buffered behind a second barrier a round."""
    lo = ("mma_tf32(acc[mt][nt], al, bh[nt][0], bh[nt][1]);\n"
          "        mma_tf32(acc[mt][nt], ah, bl[nt][0], bl[nt][1]);"
          if products == 3 else "")

    def patch(src):
        src = sub(src, "// kAligned: K % 4 == 0", MMA_HELPERS)
        src = sub(src, """  static constexpr size_t kSmemFloats =
      (size_t)kMixWarps * kStages * kPos * kItem + 2 * kFc * kCols +
      2 * kFc * kWs + 2 * kRows * kFc;""", """  static constexpr int kYs2 = kCols + 4, kWs2 = kRows + 4;   // pairs
  static constexpr int kWarpsN = kCols / 32;
  static constexpr size_t kSmemFloats =
      (size_t)kMixWarps * kStages * kPos * kItem + 2 * kFc * kYs2 +
      2 * kFc * kWs2 + 2 * kRows * kFc;""")
        a = src.index("  float* ys = sm + kMixWarps")
        b = src.index("  // the padding's columns")
        src = src[:a] + """  float2* ys = reinterpret_cast<float2*>(
      sm + kMixWarps * (kStages * kPos * kItem));     // [kFc][kYs2]
  float2* ws = ys + kFc * S::kYs2;                    // [kFc][kWs2]
  float* wraw = reinterpret_cast<float*>(ws + kFc * S::kWs2);
""" + src[b:]
        src = sub(src, """  for (int i = tid; i < 2 * kFc * kCols; i += kMixThreads)
    if (i % kCols >= G * 2 * kTileBins) ys[i] = 0.f;""", """  for (int i = tid; i < kFc * S::kYs2; i += kMixThreads)
    if (i % S::kYs2 >= G * 2 * kTileBins) ys[i] = make_float2(0.f, 0.f);""")
        a = src.index("  const int cg = (warp % S::kGP) * 8 + (lane & 7);")
        b = src.index("  const bool bin0 = has_bin0 && k0 + lane == 0;")
        src = src[:a] + MMA_MIX.replace("LO_PRODUCTS", lo) + src[b:]
        src = sub(src, STAGGER, """      if (r > 0 && mixes && s == warp % nst) {
        for (int kk = 0; kk < 2; ++kk) mix_step(kk);
      }""")
        a = src.index("    const int buf = r & 1;")
        b = src.index("    __syncthreads();\n  }\n")
        src = src[:a] + """    const int buf = r & 1;
    const bool live = r * kFc + warp < F;
    __syncthreads();                       // the last round's mix is done
    float2* y = ys + warp * S::kYs2;
#pragma unroll
    for (int p = 0; p < G; ++p) {
      y[2 * kTileBins * p + lane] = split_tf32(live ? yr[p] : 0.f);
      y[2 * kTileBins * p + kTileBins + lane] =
          split_tf32(live ? yi[p] : 0.f);
    }
    if (nst < kStages) cp_async_wait<0>();
#pragma unroll
    for (int u = 0; u < S::kWPer; ++u) {
      const int i = tid + u * kMixThreads;
      ws[(i % kFc) * S::kWs2 + i / kFc] =
          split_tf32(wraw[buf * kRows * kFc + i]);
    }
""" + src[b:]
        src = sub(src, DRAIN,
                  "    for (int kk = 0; 8 * kk < fc; ++kk) mix_step(kk);")
        a = src.index("  // out[g, c0 + row, plane, k0 + bin]")
        b = src.index("template <int G>\nsize_t mix_group_smem()")
        return src[:a] + MMA_STORE + src[b:]
    return patch


COPY_WARP_SRC = r"""// the copy-warp form: one warp fills the stages with bulk copies
constexpr int kWarps = 16;                   // compute warps
constexpr int kMixThreads = 32 * kWarps;     // compute threads
constexpr int kThreadsAll = kMixThreads + 32;  // and the copy warp
constexpr int kTileBins = 32;                // bins a block: one a lane
constexpr int kFc = kWarps;                  // filters a round: one a warp
constexpr int kPos = 4;                      // window positions a stage
constexpr int kStages = 4;                   // the stage ring
constexpr int kItem = 4 * kTileBins + 4;     // V re, V im, H re, H im, mask
constexpr int kStageFloats = kFc * kPos * kItem;

template <int G>
struct MixShape {
  static constexpr int kGP = G <= 2 ? 2 : (G <= 4 ? 4 : 8);  // padded G
  static constexpr int kCols = kGP * 2 * kTileBins;  // (g, plane, bin)
  static constexpr int kRows = kMixThreads * 64 / kCols;
  static constexpr int kWs = kRows + 4;      // a Ws row, padded (stores)
  static constexpr int kWPer = kFc * kRows / kMixThreads;  // w a thread
  static constexpr size_t kSmemFloats =
      (size_t)kStages * kStageFloats + 2 * kFc * kCols + 2 * kFc * kWs +
      4 * kStages;                           // 2 kStages mbarriers
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Arrive on `bar`, first raising the bytes it waits for by `tx`.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t tx) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(tx)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from 16-byte aligned src to dst, counted on
// `bar` as they land.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The compute warps' barrier (named barrier 1; the copy warp is not in it).
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kMixThreads) : "memory");
}

// kAligned: K % 4 == 0 and ring, xnews, bank and out 16-byte aligned.
template <int G, bool kAligned, class X = float, class H = float>
__global__ void __launch_bounds__(kThreadsAll, 1)
mac_mix_group_kernel(const float* __restrict__ ring,
                     const float* __restrict__ xnews,
                     const float* __restrict__ bank,
                     const int* __restrict__ coeff_idx,
                     const float* __restrict__ mask,
                     const int* __restrict__ t_ptr,
                     const int* __restrict__ delay,
                     const float* __restrict__ w, float* __restrict__ out,
                     int F, int B, int K, int E, int C_out,
                     int has_bin0) {
  using S = MixShape<G>;
  constexpr int kRows = S::kRows, kCols = S::kCols, kWs = S::kWs;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * kTileBins;
  const int nk = min(kTileBins, K - k0);
  const int c0 = blockIdx.y * kRows;
  const int NP = B + G - 1;                  // window positions a round
  const int nst = (NP + kPos - 1) / kPos;    // stages a round
  const int rounds = (F + kFc - 1) / kFc;
  const int total = rounds * nst;            // stages in all

  float* stages = sm;                                  // [kStages][stage]
  float* ys = stages + kStages * kStageFloats;         // [2][kFc][kCols]
  float* ws = ys + 2 * kFc * kCols;                    // [2][kFc][kWs]
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + 2 * kFc * kWs);
  uint64_t* empty = full + kStages;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 64);               // the copy warp: 2 a lane
      mbar_init(&empty[i], kWarps);          // lane 0 of each compute warp
    }
  }
  // the padding's columns (g >= G) of both Y buffers stay zero
  for (int i = tid; i < 2 * kFc * kCols; i += kThreadsAll)
    if (i % kCols >= G * 2 * kTileBins) ys[i] = 0.f;
  __syncthreads();

  if (warp == kWarps) {
    // The copy warp. Stage gs holds positions ii * kPos + q, q < kPos, of
    // round gs / nst (ii = gs % nst) for its 16 filters: [fw][q][kItem].
    // Lane l copies run l % 4 of position (l / 4) % kPos of filters
    // fw = 2 u + l / 16, u < 8, and the mask values of (fw, q) = (i / 4,
    // i % 4), i = l + 32 v, v < 2.
    int t = *t_ptr % B;
    t += t < 0 ? B : 0;
    const int run = lane & 3, q = (lane >> 2) & (kPos - 1);
    const size_t part = 2 * (size_t)K;
    const size_t run_off = (size_t)(run & 1) * K + k0;
    const uint32_t run_bytes = 4u * nk;
    int ce = 0, cd = 0;                      // lane fw < 16: its filter's
    auto load_ctrl = [&](int r) {
      const int f = r * kFc + (lane & (kFc - 1));
      ce = f < F ? min(max(coeff_idx[f], 0), E - 1) : 0;
      cd = f < F ? delay[f] : 0;
    };
    load_ctrl(0);
    int gs = 0;
    for (int r = 0; r < rounds; ++r) {
      const int e_here = ce, d_here = cd;
      if (r + 1 < rounds) load_ctrl(r + 1);
      for (int ii = 0; ii < nst; ++ii, ++gs) {
        const int slot = gs % kStages;
        if (gs >= kStages) mbar_wait(&empty[slot], ((gs / kStages) - 1) & 1);
        float* stage = stages + slot * kStageFloats;
        const int pos = ii * kPos + q;
        const int b = pos - (G - 1);         // bank partition, < 0: none
        const bool in_round = pos < NP && (run < 2 || b >= 0);
        int sl = (t + G - 1 - pos) % B;      // ring slot of V(G-1-pos)
        sl += sl < 0 ? B : 0;
        // this lane's runs of the stage
        const float* src[8];
        bool on[8];
        uint32_t tx = 0;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int fw = 2 * u + (lane >> 4);
          const int f = r * kFc + fw;
          const int e = __shfl_sync(0xffffffffu, e_here, fw);
          const int dl = __shfl_sync(0xffffffffu, d_here, fw);
          const int j = min(G - 2 - pos - dl, G - 2);      // xnews index
          src[u] = run < 2
              ? (j >= 0 ? xnews + ((size_t)f * (G - 1) + j) * part
                        : ring + ((size_t)f * B + sl) * part)
              : bank + ((size_t)e * B + max(b, 0)) * part;
          src[u] += run_off;
          on[u] = f < F && in_round;
          tx += on[u] ? run_bytes : 0u;
        }
        uint64_t* bar = &full[slot];
        if (kAligned) {
          mbar_arrive_tx(bar, tx);
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int fw = 2 * u + (lane >> 4);
            if (on[u])
              bulk_copy(stage + (fw * kPos + q) * kItem + run * kTileBins,
                        src[u], run_bytes, bar);
          }
        } else {
          mbar_arrive(bar);
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int fw = 2 * u + (lane >> 4);
            float* dst = stage + (fw * kPos + q) * kItem + run * kTileBins;
            if (on[u])
              for (int i = 0; i < nk; ++i) cp_async4(dst + i, src[u] + i);
          }
        }
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int i = lane + 32 * v, fw = i >> 2, qm = i & 3;
          const int f = r * kFc + fw, bm = ii * kPos + qm - (G - 1);
          if (qm < kPos && f < F && bm >= 0 && bm < B)
            cp_async4(stage + (fw * kPos + qm) * kItem + 4 * kTileBins,
                      mask + (size_t)f * B + bm);
        }
        mbar_arrive_cp_async(bar);
      }
    }
    return;
  }

  // The compute warps. Mix: thread (rg, cg) owns rows {h * kRows/2 +
  // 4 rg + i} and columns {h * kCols/2 + 4 cg + j}, h in {0, 1}, i, j in
  // 0..3; a warp is 4 rg x 8 cg, so its w loads are 64 and its Y loads 128
  // contiguous bytes.
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

  // w[c0 + row, f0 + fl] for the round's chunk, transposed into Ws
  float wp[S::kWPer];
  auto load_w = [&](int f0) {
#pragma unroll
    for (int u = 0; u < S::kWPer; ++u) {
      const int i = tid + u * kMixThreads;
      const int fl = i % kFc, c = c0 + i / kFc;
      wp[u] = (c < C_out && f0 + fl < F) ? w[(size_t)c * F + f0 + fl] : 0.f;
    }
  };
  load_w(0);

  const bool bin0 = has_bin0 && k0 + lane == 0;
  int gs = 0;                                // the stage the MAC reads
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    float vr[G], vi[G], yr[G], yi[G];
#pragma unroll
    for (int p = 0; p < G; ++p) {
      vr[p] = vi[p] = 0.f;
      yr[p] = yi[p] = 0.f;
    }
#pragma unroll 1
    for (int s = 0; s < nst; ++s, ++gs) {
      const int slot = gs % kStages;
      mbar_wait(&full[slot], (gs / kStages) & 1);
      const float* sg = stages + slot * kStageFloats + warp * kPos * kItem;
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
        vr[0] = item[lane];
        vi[0] = item[kTileBins + lane];
        if (pos >= G - 1) {
          // V(g - b) against bank row b; at bin 0 DC and Nyquist are
          // two real products (hx = 0, hy = the Nyquist coefficient)
          const float m = item[4 * kTileBins];
          const float hr = item[2 * kTileBins + lane] * m;
          const float hi = item[3 * kTileBins + lane] * m;
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
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);  // the stage is free again
      // the previous round's mix, spread over this round's stages
      if (r > 0 && mixes) {
        const int f_hi = (s + 1) * kFc / nst;
        for (int fl = s * kFc / nst; fl < f_hi; ++fl)
          mix_step((r - 1) & 1, fl);
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
#pragma unroll
    for (int u = 0; u < S::kWPer; ++u) {
      const int i = tid + u * kMixThreads;
      ws[(buf * kFc + i % kFc) * kWs + i / kFc] = wp[u];
    }
    if (r + 1 < rounds) load_w((r + 1) * kFc);
    compute_sync();
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

"""


SPECIALIZED_SRC = r"""constexpr int kMixThreads = 512;
constexpr int kMacWarps = 8;                 // warpgroups 0-1: copies, MAC
constexpr int kMixWarps = 8;                 // warpgroups 2-3: the mix
constexpr int kMacThreads = 32 * kMacWarps;
constexpr int kTileBins = 32;                // bins a block: one a lane
constexpr int kFc = kMacWarps;               // filters a round: one a warp
constexpr int kPos = 4;                      // window positions a stage
constexpr int kStages = 4;                   // a MAC warp's stage ring
constexpr int kItem = 4 * kTileBins + 4;     // V re, V im, H re, H im, mask
constexpr int kMacRegs = 80, kMixRegs = 176;  // setmaxnreg: 80 + 176 = 256
// named barriers: Ys/Ws buffer b full (the MAC warps arrive, the mix warps
// wait) and empty (the other way round)
constexpr int kBarFull = 1, kBarEmpty = 3;

template <int G>
struct MixShape {
  static constexpr int kGP = G <= 2 ? 2 : (G <= 4 ? 4 : 8);  // padded G
  static constexpr int kCols = kGP * 2 * kTileBins;  // (g, plane, bin)
  static constexpr int kRows = 32 * kMixWarps * 128 / kCols;
  static constexpr int kWs = kRows + 4;      // a Ws row, padded (stores)
  static constexpr int kWPer = kFc * kRows / kMacThreads;  // w a thread
  static constexpr int kWarpsN = kCols / 128;  // mix warps along columns
  static constexpr size_t kSmemFloats =
      (size_t)kMacWarps * kStages * kPos * kItem + 2 * kFc * kCols +
      2 * kFc * kWs + 2 * kRows * kFc;
};

// Named barrier `id` over all kMixThreads threads: wait, or arrive only.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kMixThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kMixThreads)
               : "memory");
}

// kAligned: K % 4 == 0 and ring, xnews, bank and out 16-byte aligned.
template <int G, bool kAligned, class X = float, class H = float>
__global__ void __launch_bounds__(kMixThreads, 1)
mac_mix_group_kernel(const float* __restrict__ ring,
                     const float* __restrict__ xnews,
                     const float* __restrict__ bank,
                     const int* __restrict__ coeff_idx,
                     const float* __restrict__ mask,
                     const int* __restrict__ t_ptr,
                     const int* __restrict__ delay,
                     const float* __restrict__ w, float* __restrict__ out,
                     int F, int B, int K, int E, int C_out,
                     int has_bin0) {
  using S = MixShape<G>;
  constexpr int kRows = S::kRows, kCols = S::kCols, kWs = S::kWs;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * kTileBins;
  const int nk = min(kTileBins, K - k0);
  const int c0 = blockIdx.y * kRows;
  const int rounds = (F + kFc - 1) / kFc;

  float* ys = sm + kMacWarps * (kStages * kPos * kItem);  // [2][kFc][kCols]
  float* ws = ys + 2 * kFc * kCols;                       // [2][kFc][kWs]
  float* wraw = ws + 2 * kFc * kWs;                       // [2][kRows][kFc]

  // the padding's columns (g >= G) of both Y buffers stay zero
  for (int i = tid; i < 2 * kFc * kCols; i += kMixThreads)
    if (i % kCols >= G * 2 * kTileBins) ys[i] = 0.f;
  __syncthreads();

  if (warp >= kMacWarps) {
    // The mix warps: thread (rg, cg) owns rows {h * kRows/2 + 4 rg + i}
    // and columns {q * kCols/4 + 4 cg + j}, h < 2, q < 4, i, j < 4; a warp
    // is 4 rg x 8 cg, so its w loads are 64 and its Y loads 128
    // contiguous bytes: two 16-byte words of w and four of Y for 128 FMAs.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kMixRegs));
    const int mw = warp - kMacWarps;
    const int cg = (mw % S::kWarpsN) * 8 + (lane & 7);
    const int rg = (mw / S::kWarpsN) * 4 + (lane >> 3);
    const bool mixes = (mw / S::kWarpsN) * 16 < C_out - c0;
    float acc[8][16];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
#pragma unroll 1
    for (int r = 0; r < rounds; ++r) {
      const int buf = r & 1;
      bar_sync(kBarFull + buf);
      const int fc = min(kFc, F - r * kFc);
      if (mixes) {
#pragma unroll 2
        for (int fl = 0; fl < fc; ++fl) {
          const float* wrow = ws + (buf * kFc + fl) * kWs;
          const float* yrow = ys + (buf * kFc + fl) * kCols;
          float a[8], v[16];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 x =
                *reinterpret_cast<const float4*>(wrow + h * (kRows / 2) + 4 * rg);
            a[4 * h] = x.x, a[4 * h + 1] = x.y, a[4 * h + 2] = x.z,
            a[4 * h + 3] = x.w;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 x =
                *reinterpret_cast<const float4*>(yrow + q * (kCols / 4) + 4 * cg);
            v[4 * q] = x.x, v[4 * q + 1] = x.y, v[4 * q + 2] = x.z,
            v[4 * q + 3] = x.w;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
        }
      }
      if (r + 2 < rounds) bar_arrive(kBarEmpty + buf);
    }
    // out[g, c0 + row, plane, k0 + bin]: four bins a store
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = q * (kCols / 4) + 4 * cg;
      const int gg = col / (2 * kTileBins), p = (col / kTileBins) & 1;
      const int kk = col % kTileBins;
      if (gg >= G || kk >= nk) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = c0 + (i >> 2) * (kRows / 2) + 4 * rg + (i & 3);
        if (c >= C_out) continue;
        float* o = out + (((size_t)gg * C_out + c) * 2 + p) * K + k0 + kk;
        const float* a = &acc[i][4 * q];
        if (kAligned) {
          *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (kk + j < nk) o[j] = a[j];
        }
      }
    }
    return;
  }

  // The MAC warps.
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kMacRegs));
  const size_t part = 2 * (size_t)K;
  const int NP = B + G - 1;                  // window positions a round
  const int nst = (NP + kPos - 1) / kPos;    // stages a round
  const int total = rounds * nst;            // stages of a warp's ring
  int t = *t_ptr % B;
  t += t < 0 ? B : 0;
  float* st = sm + warp * (kStages * kPos * kItem);  // this warp's ring

  // w[c0 + row, r * kFc + fl] -> wraw[r & 1][row][fl]: element
  // tid + u * kMacThreads, u < kWPer, of the chunk is this thread's
  auto copy_w = [&](int r) {
#pragma unroll
    for (int u = 0; u < S::kWPer; ++u) {
      const int i = tid + u * kMacThreads;
      const int c = c0 + i / kFc, f = r * kFc + i % kFc;
      const bool on = c < C_out && f < F;
      cp_async4(wraw + (r & 1) * kRows * kFc + i,
                on ? w + (size_t)c * F + f : w, on);
    }
  };

  const int run = lane >> 3, off = 4 * (lane & 7);
  const bool is_v = run < 2;
  const int nfl = max(0, nk - off);          // this lane's bins in range
  const int top = (t + G - 1) % B;           // slot of V(G-1)
  const ptrdiff_t step = (ptrdiff_t)part, wrap = (ptrdiff_t)(B - 1) * part;
  int gi = 0, gb = 0, ii = 0, si = top, fi = warp, di, ne, nd;
  const float *cur, *xb, *mcur;
  auto next_ctrl = [&](int f) {
    ne = f < F ? min(max(coeff_idx[f], 0), E - 1) : 0;
    nd = f < F ? delay[f] : 0;
  };
  auto start_round = [&]() {               // filter fi, from ne and nd
    const size_t lane_off = (size_t)(run & 1) * K + k0 + off;
    cur = (is_v ? ring + ((size_t)fi * B + top) * part
                : bank + (size_t)ne * B * part) + lane_off;
    xb = xnews + (size_t)fi * (G - 1) * part + lane_off;
    mcur = mask + (size_t)fi * B;
    si = top;
    di = nd;
    next_ctrl(fi + kFc);
  };
  next_ctrl(fi);
  start_round();
  auto copy_run = [&](float* d, const float* src, bool on) {
    if (kAligned) {
      cp_async16(d, src, on && nfl >= 4);
    } else if (on) {
      for (int i = 0; i < nfl && i < 4; ++i) cp_async4(d + i, src + i);
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
        copy_run(dst + q * kItem + run * kTileBins + off,
                 use_x ? xb + (size_t)max(j, 0) * part : cur,
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
        copy_run(dst + q * kItem + run * kTileBins + off, cur, in);
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
        vr[0] = item[lane];
        vi[0] = item[kTileBins + lane];
        if (pos >= G - 1) {
          // V(g - b) against bank row b; at bin 0 DC and Nyquist are
          // two real products (hx = 0, hy = the Nyquist coefficient)
          const float m = item[4 * kTileBins];
          const float hr = item[2 * kTileBins + lane] * m;
          const float hi = item[3 * kTileBins + lane] * m;
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
    }
    const int buf = r & 1;
    const bool live = r * kFc + warp < F;
    if (r >= 2) bar_sync(kBarEmpty + buf);   // the mix of round r - 2 is done
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
      const int i = tid + u * kMacThreads;
      ws[(buf * kFc + i % kFc) * kWs + i / kFc] =
          wraw[buf * kRows * kFc + i];
    }
    bar_arrive(kBarFull + buf);
  }
}

"""


def specialized(src):
    a = src.index("constexpr int kMixThreads = 512;")
    b = src.index("template <int G>\nsize_t mix_group_smem()")
    return src[:a] + SPECIALIZED_SRC + src[b:]


def copy_warp(src):
    a = src.index("// bf_mac_mix_group. What limits")
    b = src.index("template <int G>\nsize_t mix_group_smem()")
    src = src[:a] + COPY_WARP_SRC + src[b:]
    src = sub(src,
              "mac_mix_group_kernel<G, kAligned, X, H><<<grid, kMixThreads,",
              "mac_mix_group_kernel<G, kAligned, X, H><<<grid, kThreadsAll,")
    return src


VARIANTS = (
    ("kept", ()),
    ("spread", (spread,)),
    ("stages2", (stages(2),)),
    ("stages4", (stages(4),)),
    ("mma", (mma(3),)),
    ("tf32x1", (mma(1),)),
    ("copy_warp", (copy_warp,)),
    ("specialized", (specialized,)),
    ("copies_only", (no_mix, no_mac)),
    ("no_mix", (no_mix,)),
    ("mix_only", (no_copy, no_mac)),
    ("skeleton", (no_copy, no_mac, no_mix)),
)


BF16_DISPATCH = """                int ring_bf16, int bank_bf16, cudaStream_t s) {
  using bf = __nv_bfloat16;"""


def float32_only(src):
    """The entries' bf16 operand forms refused (cudaErrorInvalidValue) and
    never instantiated: the variants are float32 kernels, and the forms
    compared here are the float32 ones."""
    a = src.index(BF16_DISPATCH)
    b = src.index("\n}\n", a)
    return (src[:a] + BF16_DISPATCH.split("\n")[0]
            + "\n  return static_cast<int>(cudaErrorInvalidValue);" + src[b:])


def build() -> dict:
    """Every variant built at once; name -> (C entry, ptxas line)."""
    from brutefir_tpu_torch.ops import _build
    os.makedirs(OUT, exist_ok=True)
    kept = open(SRC).read()
    jobs = []
    for name, patches in VARIANTS:
        src = float32_only(kept)
        for patch in patches:
            src = patch(src)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(src)
        so = os.path.join(OUT, f"lib{name}.so")
        jobs.append((name, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o",
             so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    built = {}
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"nvcc failed on the {name} form:\n{log[-3000:]}")
        lines = log.splitlines()
        usage = ""
        for i, line in enumerate(lines):
            if "mac_mix_group_kernelILi2ELb1" in line and "Compiling" in line:
                usage = " ".join(x.split(":", 1)[-1].strip()
                                 for x in lines[i + 1:i + 4]
                                 if "Used" in x or "spill" in x)
        fn = ctypes.CDLL(so).bf_mac_mix_group
        fn.argtypes = _build.SIGNATURES["mac_group"]["bf_mac_mix_group"]
        fn.restype = ctypes.c_int
        built[name] = (fn, usage)
    return built


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a card")
    from brutefir_tpu_torch.ops import mac_group as mg
    print(cs.card_line(), flush=True)
    built = build()
    dev = torch.device("cuda")
    flush = cs.read_flush()
    tiny = torch.zeros(1, device=dev)
    cs.FLOOR_MS = cs.time_ms(lambda: tiny.zero_(), cs.REPS, flush)
    G = 2
    Fs = Cs = Es = cs.SCALE_C
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    ring = torch.randn(Fs, cs.B, 2, cs.K, generator=g, device=dev)
    bank = torch.randn(Es, cs.B, 2, cs.K, generator=g, device=dev)
    w = torch.randn(Cs, Fs, generator=g, device=dev) / 16.0
    idx = torch.randperm(Fs, generator=g, device=dev).to(torch.int32)
    xnews = torch.randn(Fs, G - 1, 2, cs.K, generator=g, device=dev)
    delay = torch.arange(Fs, device=dev, dtype=torch.int32) % (G + 2)
    mask = cs.cblocks_mask(delay, cs.B)
    t7 = torch.tensor(7, dtype=torch.int32, device=dev)
    ref = mg.mac_mix_group_reference(ring, xnews, bank, idx, mask, t7, w,
                                     delay)
    out = torch.empty((G, Cs, 2, cs.K), device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn):
        rc = fn(ring.data_ptr(), xnews.data_ptr(), bank.data_ptr(),
                idx.data_ptr(), mask.data_ptr(), t7.data_ptr(),
                delay.data_ptr(), w.data_ptr(), out.data_ptr(), Fs, cs.B,
                cs.K, Es, Cs, G, 1, 0, 0, stream)
        if rc != 0:
            cs.fail(f"a form failed to launch (cudaError {rc})")
    nb, nf = cs.mac_bytes_flops(Fs, cs.B, cs.K, Cs, Es, G)
    print(f"G={G}, F = C_out = E = {Fs}, B={cs.B}, K={cs.K}: bound "
          f"{cs.bound(nb, nf)[0]:.4f} ms, floor {cs.FLOOR_MS:.4f} ms; "
          f"median of {cs.REPS}, L2 flushed by a read before each",
          flush=True)
    for name, _ in VARIANTS + VARIANTS[:1]:
        fn, usage = built[name]
        call(fn)
        torch.cuda.synchronize()
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        ms = cs.time_ms(lambda: call(fn), cs.REPS, flush)
        print(f"{name}: {ms:.4f} ms; max rel err {rel:.3e}; ptxas {usage}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
