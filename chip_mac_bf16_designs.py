#!/usr/bin/env python3
"""Times forms of the bf16 operand forms of the bin-tiled fused MAC + mix
(``bf_mac_mix_tiled``, ``csrc/mac_mix_tiled.cu``, TPU kernel 3) and of the
grouped MAC (``bf_mac_group`` at G = 4, ``csrc/mac_group.cu``, TPU kernel
4) at the 256-channel scale shape on one CUDA card: the measurements
behind the kept forms, and what each part of the tiled one costs.

    python3 chip_mac_bf16_designs.py

Each form is the kept source with text patches applied here (each patch
must apply: change it with the kernel), built into
``build/chip_mac_bf16_designs/`` with the port's nvcc flags and called
through the same C entry as the wrapper:

- ``kept``: the source as it is (the forms these replace are timed in
  turns by ``chip_mac_ab.py`` against a tree that has them);
- row 3: ``stages2``, ``stages4`` (a warp's stage ring), ``pos2`` and
  ``stages2_pos8`` (positions a stage), ``mix_warp_mod`` (each warp mixes
  at stage w % stages, row 5's rule, which puts the warps of one SM
  sub-partition at one stage when the stages are 4); ablations, wrong
  results by design and only timed: ``no_mix``, ``mix_only`` (no copies,
  no MAC), ``copies_only`` (no MAC, no mix), ``skeleton`` (none of the
  three);
- row 4: ``vec2``, ``vec8`` (bins a thread: 4-, 16-byte bf16 loads),
  ``depth1``, ``depth3``, ``depth4`` (partitions' loads in flight),
  ``vec8_depth1``, ``threads256`` (threads a block); with both operands
  in bf16 also ``kept``, ``vec8`` and ``vec8_depth1`` at G = 2, 3 and 8
  (``OTHER_G``).

Row 3's variants other than ``kept`` build the form with both operands
in bf16 only. Prints each form's ptxas registers and
spills, its time (median of 20 calls, the L2 cache flushed by a 128 MB
read before each: ``chip_smoke.time_ms``, ``read_flush``) and its error
against the plain version (1e-5 of the peak is the port's bar), beside
the byte bound and the timing floor, ``kept`` first and last.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import chip_smoke as cs

OUT = os.path.join(cs.REPO, "build", "chip_mac_bf16_designs")
CSRC = os.path.join(cs.REPO, "brutefir_tpu_torch", "csrc")


def sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"chip_mac_bf16_designs: a patch does not apply: "
                         f"{old[:60]!r}")
    return src.replace(old, new)


def const(old: str, new: str):
    return lambda src: sub(src, old, new)


# --- row 3: csrc/mac_mix_tiled.cu ---------------------------------------

MIXED = """  if (ring_bf16) BF_LAUNCH(bf, float);
  if (bank_bf16) BF_LAUNCH(float, bf);
"""
STAGGER = """      if (r > 0 && mixes && s == mix_at) {
        for (int fl = 0; fl < kBfWarps; ++fl) mix_step((r - 1) & 1, fl);
      }"""
DRAIN = """    for (int fl = 0; fl < fc; ++fl) mix_step((rounds - 1) & 1, fl);"""
COPY = """        cp_async16(dst + q * kItem + doff[u], cur[u], in && on[u]);"""
MAC = """        if (s * kPos + q >= B) break;"""


def both_only(src):
    """The forms with one operand in float32 refused: a variant's shared
    memory may fit only the form with both in bf16."""
    return sub(src, MIXED, "  if (ring_bf16 != bank_bf16) return "
                           "static_cast<int>(cudaErrorInvalidValue);\n")


def no_mix(src):
    return sub(sub(src, STAGGER, ""), DRAIN, "")


def no_copy(src):
    return sub(src, COPY, COPY.replace("in && on[u]", "false"))


def no_mac(src):
    return sub(src, MAC, MAC.replace("s * kPos + q >= B", "true"))


STAGES = "constexpr int kBfStages = 3;"
POS = "static constexpr int kPos = sizeof(X) == 2 && sizeof(H) == 2 ? 4 : 3;"

TILED_VARIANTS = (
    ("kept", ()),
    ("stages2", (both_only, const(STAGES, "constexpr int kBfStages = 2;"))),
    ("stages4", (both_only, const(STAGES, "constexpr int kBfStages = 4;"))),
    ("pos2", (both_only, const(POS, POS.replace("? 4 : 3", "? 2 : 3")))),
    ("stages2_pos8", (both_only,
                      const(STAGES, "constexpr int kBfStages = 2;"),
                      const(POS, POS.replace("? 4 : 3", "? 8 : 3")))),
    ("mix_warp_mod", (both_only, const(
        "const int mix_at = ((warp >> 2) + 4 * (warp & 3)) % nst;",
        "const int mix_at = warp % nst;"))),
    ("no_mix", (both_only, no_mix)),
    ("mix_only", (both_only, no_copy, no_mac)),
    ("copies_only", (both_only, no_mix, no_mac)),
    ("skeleton", (both_only, no_copy, no_mac, no_mix)),
)

# --- row 4: csrc/mac_group.cu -------------------------------------------

VEC = "constexpr int kGVec = 4;"
DEPTH = "constexpr int kGDepth = 2;"
GTHREADS = "constexpr int kGThreads = 128;"

GROUP_VARIANTS = (
    ("kept", ()),
    ("vec2", (const(VEC, "constexpr int kGVec = 2;"),)),
    ("vec8", (const(VEC, "constexpr int kGVec = 8;"),)),
    ("vec8_depth1", (const(VEC, "constexpr int kGVec = 8;"),
                     const(DEPTH, "constexpr int kGDepth = 1;"))),
    ("depth1", (const(DEPTH, "constexpr int kGDepth = 1;"),)),
    ("depth3", (const(DEPTH, "constexpr int kGDepth = 3;"),)),
    ("depth4", (const(DEPTH, "constexpr int kGDepth = 4;"),)),
    ("threads256", (const(GTHREADS, "constexpr int kGThreads = 256;"),)),
)
ABLATIONS = ("no_mix", "mix_only", "copies_only", "skeleton")
OTHER_G = (2, 3, 8)
OTHER_G_FORMS = ("kept", "vec8", "vec8_depth1")


def ptxas(log: str, kernel: str, want: str) -> str:
    """The registers and spills ptxas printed for the instantiations of
    ``kernel`` whose mangled name holds ``want``."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if kernel in line and want in line and "Compiling" in line:
            out.append(" ".join(x.split(":", 1)[-1].strip()
                                for x in lines[i + 1:i + 4]
                                if "Used" in x or "spill" in x))
    return " | ".join(out)


def build() -> dict:
    """Every variant of both sources built at once: (stem, name) -> (C
    entry, ptxas usage)."""
    from brutefir_tpu_torch.ops import _build
    os.makedirs(OUT, exist_ok=True)
    jobs = []
    for stem, variants in (("mac_mix_tiled", TILED_VARIANTS),
                           ("mac_group", GROUP_VARIANTS)):
        kept = open(os.path.join(CSRC, f"{stem}.cu")).read()
        for name, patches in variants:
            src = kept
            for patch in patches:
                src = patch(src)
            cu = os.path.join(OUT, f"{stem}_{name}.cu")
            with open(cu, "w") as fh:
                fh.write(src)
            so = os.path.join(OUT, f"lib{stem}_{name}.so")
            jobs.append((stem, name, so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                 "-o", so, cu], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    built = {}
    for stem, name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"nvcc failed on {stem}'s {name} form:\n{log[-3000:]}")
        entry = "bf_mac_mix_tiled" if stem == "mac_mix_tiled" else \
            "bf_mac_group"
        fn = getattr(ctypes.CDLL(so), entry)
        fn.argtypes = _build.SIGNATURES[stem][entry]
        fn.restype = ctypes.c_int
        usage = (ptxas(log, "mac_mix_tiled_bf16_kernel", "")
                 if stem == "mac_mix_tiled" else
                 ptxas(log, "group_bf16_kernel", "ILi4E13__nv_bfloat16S")
                 + " | G=8: " +
                 ptxas(log, "group_bf16_kernel", "ILi8E13__nv_bfloat16S"))
        built[stem, name] = (fn, usage)
    return built


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a card")
    from brutefir_tpu_torch.ops import mac_group as mg, mac_mix as mm
    print(cs.card_line(), flush=True)
    built = build()
    dev = torch.device("cuda")
    flush = cs.read_flush()
    tiny = torch.zeros(1, device=dev)
    cs.FLOOR_MS = cs.time_ms(lambda: tiny.zero_(), cs.REPS, flush)
    Fs = Cs = Es = cs.SCALE_C
    B_, K_ = cs.B, cs.K
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 18)
    ring = torch.randn(Fs, B_, 2, K_, generator=g, device=dev)
    bank = torch.randn(Es, B_, 2, K_, generator=g, device=dev)
    w = torch.randn(Cs, Fs, generator=g, device=dev) / 16.0
    idx = torch.randperm(Fs, generator=g, device=dev).to(torch.int32)
    G = 4
    xnews8 = torch.randn(Fs, max(OTHER_G) - 1, 2, K_, generator=g,
                         device=dev)
    xnews = xnews8[:, :G - 1].contiguous()
    delay = (torch.arange(Fs, device=dev) % (G + 2)).to(torch.int32)
    t7 = torch.tensor(7, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"F = C_out = E = {Fs}, B={B_}, K={K_}; median of {cs.REPS}, L2 "
          f"flushed by a read before each; floor {cs.FLOOR_MS:.4f} ms",
          flush=True)

    for combo in cs.BF16_COMBOS:
        r, h, x = cs.bf16_operands(combo, ring, bank, xnews)
        rb, hb = (2 if combo[0] else 4), (2 if combo[1] else 4)
        label = cs.BF16_NAMES[combo]
        both = combo == (1, 1)
        # row 3
        mask = cs.cblocks_mask(torch.arange(Fs, device=dev) % 4, B_)
        ones = torch.ones(Fs, B_, device=dev)
        ref = mm.mac_mix_reference(r, h, idx, mask, t7, w, False)
        out = torch.empty((Cs, 2, K_), device=dev)

        def tiled(fn, m):
            rc = fn(r.data_ptr(), h.data_ptr(), idx.data_ptr(), m.data_ptr(),
                    t7.data_ptr(), w.data_ptr(), out.data_ptr(), Fs, B_, K_,
                    Es, Cs, 1, combo[0], combo[1], stream)
            if rc != 0:
                cs.fail(f"a row 3 form failed to launch (cudaError {rc})")
        nb, nf = cs.mac_bytes_flops(Fs, B_, K_, Cs, Es, ring_bytes=rb,
                                    bank_bytes=hb)
        print(f"row 3, bf_mac_mix_tiled, bf16 {label}: bound "
              f"{cs.bound(nb, nf)[0]:.4f} ms", flush=True)
        names = [n for n, _ in TILED_VARIANTS
                 if both or n == "kept"]
        for name in names + ["kept"]:
            fn, usage = built["mac_mix_tiled", name]
            tiled(fn, mask)
            torch.cuda.synchronize()
            rel = ((out - ref).abs().max() / ref.abs().max()).item()
            ms = cs.time_ms(lambda: tiled(fn, ones), cs.REPS, flush)
            err = ("(ablation)" if name in ABLATIONS
                   else f"max rel err {rel:.3e}")
            print(f"  {name}: {ms:.4f} ms; {err}; ptxas {usage}", flush=True)
        del ref, out
        # row 4
        mask = cs.cblocks_mask(delay, B_)
        zeros = torch.zeros(Fs, dtype=torch.int32, device=dev)
        ref = mg.mac_group_reference(r, x, h, idx, mask, t7, delay)
        out = torch.empty((G, Fs, 2, K_), device=dev)

        def group(fn, m, d):
            rc = fn(r.data_ptr(), x.data_ptr(), h.data_ptr(), idx.data_ptr(),
                    m.data_ptr(), t7.data_ptr(), d.data_ptr(),
                    out.data_ptr(), Fs, B_, K_, Es, G, 1, combo[0], combo[1],
                    stream)
            if rc != 0:
                cs.fail(f"a row 4 form failed to launch (cudaError {rc})")
        nb, nf = cs.mac_bytes_flops(Fs, B_, K_, 0, Es, G, out_rows=Fs,
                                    ring_bytes=rb, bank_bytes=hb)
        print(f"row 4, bf_mac_group G={G}, bf16 {label}: bound "
              f"{cs.bound(nb, nf)[0]:.4f} ms", flush=True)
        names = [n for n, _ in GROUP_VARIANTS
                 if both or n == "kept"]
        for name in names + ["kept"]:
            fn, usage = built["mac_group", name]
            group(fn, mask, delay)
            torch.cuda.synchronize()
            rel = ((out - ref).abs().max() / ref.abs().max()).item()
            ms = cs.time_ms(lambda: group(fn, ones, zeros), cs.REPS, flush)
            print(f"  {name}: {ms:.4f} ms; max rel err {rel:.3e}; ptxas "
                  f"{usage}", flush=True)
        del ref, out, x
        if not both:
            continue
        for G in OTHER_G:
            x = xnews8[:, :G - 1].to(torch.bfloat16).contiguous()
            ref = mg.mac_group_reference(r, x, h, idx, mask, t7, delay)
            out = torch.empty((G, Fs, 2, K_), device=dev)
            nb, nf = cs.mac_bytes_flops(Fs, B_, K_, 0, Es, G, out_rows=Fs,
                                        ring_bytes=2, bank_bytes=2)
            print(f"row 4, bf_mac_group G={G}, bf16 {label}: bound "
                  f"{cs.bound(nb, nf)[0]:.4f} ms", flush=True)
            for name in OTHER_G_FORMS:
                fn, _ = built["mac_group", name]
                group(fn, mask, delay)
                torch.cuda.synchronize()
                rel = ((out - ref).abs().max() / ref.abs().max()).item()
                ms = cs.time_ms(lambda: group(fn, ones, zeros), cs.REPS,
                                flush)
                print(f"  {name}: {ms:.4f} ms; max rel err {rel:.3e}",
                      flush=True)
            del ref, out, x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
