#!/usr/bin/env python3
"""Times forms of the bf16 operand forms of the MAC kernels on one CUDA
card: the bin-tiled fused MAC + mix (``bf_mac_mix_tiled``,
``csrc/mac_mix_tiled.cu``, TPU kernel 3), the grouped MAC
(``bf_mac_group`` at G = 4, ``csrc/mac_group.cu``, kernel 4) and the
grouped fused MAC + mix (``bf_mac_mix_group`` at G = 2, the same file,
kernel 5) at the 256-channel scale shape, and the unfused and dual MAC
core (``bf_mac``, ``bf_mac_dual`` on ``csrc/mac_core.cuh``, kernels 6-10)
at the shapes of their paths: the measurements behind the kept forms,
and what each part of the fused ones costs.

    python3 chip_mac_bf16_designs.py [3] [4] [5] [core]

(no argument: all four parts). Each form is the kept source with text
patches applied here (each patch must apply: change it with the kernel),
built into ``build/chip_mac_bf16_designs/`` with the port's nvcc flags
and called through the same C entry as the wrapper:

- ``kept``: the source as it is (the forms these replace are timed in
  turns by ``chip_mac_ab.py`` against a tree that has them);
- row 3: ``stages2``, ``stages4`` (a warp's stage ring), ``pos2`` and
  ``stages2_pos8`` (positions a stage), ``mix_warp_mod`` (each warp mixes
  at stage w % stages, row 5's float32 rule, which puts the warps of one
  SM sub-partition at one stage when the stages are 4); ablations, wrong
  results by design and only timed: ``no_mix``, ``mix_only`` (no copies,
  no MAC), ``copies_only`` (no MAC, no mix), ``skeleton`` (none of the
  three);
- row 4: ``vec2``, ``vec8`` (bins a thread: 4-, 16-byte bf16 loads),
  ``depth1``, ``depth3``, ``depth4`` (partitions' loads in flight),
  ``vec8_depth1``, ``threads256`` (threads a block); with both operands
  in bf16 also ``kept``, ``vec8`` and ``vec8_depth1`` at G = 2, 3 and 8
  (``OTHER_G``);
- row 5 (``mac_mix_group_bf16_kernel``, the form with both operands in
  bf16): ``pos4``, ``pos8`` (positions a stage), ``stages2``,
  ``stages4``, ``stages5``; the forms with one float32 operand through
  it (24 chunks a position on lanes 0-23) in place of the float32
  kernel, ``mixed_dense24``, with 4 positions a stage
  ``mixed_dense24_pos4``, with 8 and 2 stages
  ``mixed_dense24_pos8_stages2`` (timed under the ring and the bank knob
  only); ``mix_warp_mod`` (each warp mixing
  at stage w % stages), ``mix_early`` (no warp mixing at a round's last
  stage), ``mix_spread`` (each warp's mix spread over the round's
  stages), and the ablations of row 3; the float32 kernel's ptxas usage
  beside them;
- the core (rows 6-10, ``csrc/mac_core.cuh``): ``group4`` (the float32
  form's groups in every form: no groups of 8 for a shared bf16 bank row
  beside a float32 ring), ``deep_groups`` (a bf16 form's load group the
  largest power of two, up to 16, whose raw loads fit the registers of
  the float32 form's group: 16 / 8 with both in bf16 and one set, 8 for
  the dual), ``mixed_group8`` (groups of 8 on every grid where one
  operand is float32), ``bank_stream`` (a shared bf16 bank row read by
  streaming loads, not through the read-only cache), ``widen_at_load``
  (each bf16 load widened to a float4 as it lands, the float32 groups:
  the form the kept one replaces); each with the count of 8- and 16-byte
  loads ``cuobjdump -sass`` shows issued before the first instruction
  that reads a loaded value, in each vector instance of the kernel.

The variants of rows 3 and 5 other than ``kept``, and ``stages4`` of row
5, build or run the form with both operands in bf16 only. Prints each
form's ptxas registers and spills, its time (median of 20 calls, the L2
cache flushed by a 128 MB read before each: ``chip_smoke.time_ms``,
``read_flush``) and its error against the plain version (1e-5 of the
peak is the port's bar), beside the byte bound and the timing floor,
``kept`` first and last.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
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
# --- row 5: mac_mix_group_bf16_kernel in csrc/mac_group.cu --------------

BF16_KERNEL = "mac_mix_group_bf16_kernel(const X* __restrict__ ring,"


def in_bf16(old: str, new: str):
    """A patch of row 5's bf16 kernel only (the float32 kernel before it
    shares some lines)."""
    def patch(src):
        at = src.index(BF16_KERNEL)
        return src[:at] + sub(src[at:], old, new)
    return patch


POS5 = "static constexpr int kPos = 6;"
STAGES5 = "  static constexpr int kStages = 3;"
STAGGER5 = """      if (r > 0 && mixes && s == mix_at) {
        for (int fl = 0; fl < kFc; ++fl) mix_step((r - 1) & 1, fl);
      }"""
MIX_AT5 = "const int mix_at = ((warp >> 2) + 4 * (warp & 3)) % nst;"
DRAIN5 = "for (int fl = 0; fl < fc; ++fl) mix_step((rounds - 1) & 1, fl);"
COPY5 = "lane_on && live && pos < NP && (is_v || b >= 0));"
MAC5 = "        if (pos >= NP) break;"
# positions a stage and stages by a position's chunks: 16 (both in bf16)
# or 24 (one float32 operand)
def pos_by(both: int, mixed: int):
    return const(POS5, f"static constexpr int kPos = kChunks == 16 ? {both} "
                       f": {mixed};")


def stages_by(both: int, mixed: int):
    return const(STAGES5, f"  static constexpr int kStages = kChunks == 16 "
                          f"? {both} : {mixed};")


# the forms with one float32 operand through the bf16 kernel (24 chunks a
# position on lanes 0-23) in place of the float32 kernel
DENSE24 = const("  if constexpr (std::is_same_v<X, H>)\n"
                "    return launch_mix_group_bf16<G>(",
                "  if constexpr (true)\n    return launch_mix_group_bf16<G>(")
MIX_GROUP_VARIANTS = (
    ("kept", ()),
    ("pos4", (pos_by(4, 4),)),
    ("pos8", (pos_by(8, 6),)),
    ("stages2", (stages_by(2, 3),)),
    ("stages4", (stages_by(4, 3),)),
    ("stages5", (stages_by(5, 3),)),
    ("mixed_dense24", (DENSE24,)),
    ("mixed_dense24_pos4", (DENSE24, pos_by(6, 4))),
    ("mixed_dense24_pos8_stages2", (DENSE24, pos_by(6, 8),
                                    stages_by(3, 2))),
    ("mix_warp_mod", (const(MIX_AT5, "const int mix_at = warp % nst;"),)),
    # no warp mixes at a round's last stage, ahead of its block barrier
    ("mix_early", (const(MIX_AT5, MIX_AT5.replace(
        "% nst;", "% max(nst - 1, 1);")),)),
    # each warp's mix spread over the round's stages, f ascending
    ("mix_spread", (const(STAGGER5, """      if (r > 0 && mixes) {
        for (int fl = s * kFc / nst; fl < (s + 1) * kFc / nst; ++fl)
          mix_step((r - 1) & 1, fl);
      }"""),)),
    ("no_mix", (in_bf16(STAGGER5, ""), in_bf16(DRAIN5, ""))),
    ("mix_only", (in_bf16(COPY5, "false);"),
                  in_bf16(MAC5, "        if (true) break;"))),
    ("copies_only", (in_bf16(STAGGER5, ""), in_bf16(DRAIN5, ""),
                     in_bf16(MAC5, "        if (true) break;"))),
    ("skeleton", (in_bf16(STAGGER5, ""), in_bf16(DRAIN5, ""),
                  in_bf16(COPY5, "false);"),
                  in_bf16(MAC5, "        if (true) break;"))),
)

# --- the core: csrc/mac_core.cuh (built into mac.cu and mac_dual.cu) -----

PLAN = """  if (NS == 1 && uniform && ring_bytes == 4 && bank_bytes == 2)
    return {dim3(tiles, Fs), 8};
  return {dim3(tiles, Fs), few ? 8 : 4};
}"""
# the float32 form's groups in every form
GROUP4_PLAN = """  return {dim3(tiles, Fs), few ? 8 : 4};
}"""
# a bf16 form's group the largest power of two (up to 16) whose raw loads
# fit the 32-bit words of the float32 form's group: 16 / 8 with both
# operands in bf16 and one set, 8 for the dual
DEEP_PLAN = """  const int f32 = few ? 8 : 4;
  if (ring_bytes == 4 && bank_bytes == 4) return {dim3(tiles, Fs), f32};
  const int words = 2 * ring_bytes + 2 * NS * bank_bytes;
  const int budget = f32 * (2 * 4 + 2 * NS * 4);
  int group = 4;
  while (group < 16 && 2 * group * words <= budget) group *= 2;
  return {dim3(tiles, Fs), group};
}"""
# groups of 8 on every grid where one operand is float32
MIXED8_PLAN = """  if (ring_bytes != bank_bytes) return {dim3(tiles, Fs), 8};
  return {dim3(tiles, Fs), few ? 8 : 4};
}"""
LAUNCH = """    if constexpr (NS == 1) {
      if (p.group == 8) {"""
DEEP_LAUNCH = """    constexpr bool bf16 = sizeof(X) == 2 || sizeof(H) == 2;
    if constexpr (bf16 && NS == 1) {
      if (p.group == 16) {
        launch_group<R, X, H, NS, 16>(a, p.grid, stream);
        return static_cast<int>(cudaGetLastError());
      }
    }
    if constexpr (NS == 1 || bf16) {
      if (p.group == 8) {"""
RAW = "using raw_t = std::conditional_t<VEC && std::is_same_v<T, __nv_bfloat16>,"
LOAD = "    return vload<STREAM>(p);"
WIDEN_AT_LOAD = (const(RAW, RAW.replace("VEC &&", "false &&")),
                 const(LOAD, "    return widen(vload<STREAM>(p));"))
BANK = "load4<VEC, !SHARED, R>(h[s] + hoff"
CORE_VARIANTS = (
    ("kept", ()),
    ("group4", (const(PLAN, GROUP4_PLAN),)),
    ("deep_groups", (const(PLAN, DEEP_PLAN), const(LAUNCH, DEEP_LAUNCH))),
    ("mixed_group8", (const(PLAN, MIXED8_PLAN),
                      const(LAUNCH, DEEP_LAUNCH))),
    # a shared bf16 bank row read by streaming loads, not the read-only
    # cache
    ("bank_stream", (lambda src: src.replace(
        BANK, "load4<VEC, !SHARED || sizeof(H) == 2, R>(h[s] + hoff"),)),
    ("widen_at_load", WIDEN_AT_LOAD + (const(PLAN, GROUP4_PLAN),)),
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


def ptxas_by_kernel(log: str) -> dict:
    """Mangled kernel name -> its ``-Xptxas -v`` registers and spills."""
    usage, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("Used" in line or "spill" in line):
            usage[name] = (usage.get(name, "") + " " + line.split(
                ":", 1)[-1].strip()).strip()
    return usage


def sass_functions(so: str) -> dict:
    """Mangled kernel name -> its SASS instructions (``cuobjdump
    -sass``), in the order of the listing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True, timeout=600).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append(m.group(1))
    return funcs


def loads_before_use(instrs) -> tuple:
    """(8- and 16-byte global loads issued before the first instruction
    that reads a register one of them loaded, such loads in all)."""
    pending, first, total = set(), None, 0
    for ins in instrs:
        ins = re.sub(r"^@!?U?P[T0-9]+\s+", "", ins)
        op, _, rest = ins.partition(" ")
        ops = [o.strip() for o in rest.split(",")]
        if op.startswith("LDG") and (".64" in op or ".128" in op):
            total += 1
            m = re.match(r"R(\d+)", ops[0])
            if first is None and m:
                r0 = int(m.group(1))
                pending.update(range(r0, r0 + (4 if ".128" in op else 2)))
            continue
        if first is None and pending:
            srcs = rest if op.startswith(("ST", "RED", "ATOM")) else \
                ",".join(ops[1:])
            if {int(x) for x in re.findall(r"\bR(\d+)\b", srcs)} & pending:
                first = total
    return (total if first is None else first), total


CORE_KERNEL = re.compile(r"mac_kernelI(\w+?)Li(\d)ELb([01])ELi(\d+)ELb([01])E")


def core_instances(so: str, log: str) -> list:
    """Each vector instance of csrc/mac_core.cuh's kernel in a library:
    (label, registers and spills, loads before the first use, loads)."""
    usage = ptxas_by_kernel(log)
    out = []
    for name, instrs in sorted(sass_functions(so).items()):
        m = CORE_KERNEL.search(name)
        if not m or m.group(3) != "1":
            continue
        types = re.sub(r"S\d*_", "b",
                       m.group(1).replace("13__nv_bfloat16", "b"))
        label = (f"R/X/H {'/'.join(types)}, sets {m.group(2)}, group "
                 f"{m.group(4)}, {'shared' if m.group(5) == '1' else 'rows'}")
        out.append((label, usage.get(name, "?"), *loads_before_use(instrs)))
    return out


def build(parts) -> dict:
    """Every variant of the parts asked for, built at once: (part, name)
    -> ({C entry: function}, ptxas usage or core instances). A variant
    that does not build is reported and left out."""
    from brutefir_tpu_torch.ops import _build
    os.makedirs(OUT, exist_ok=True)
    jobs = []
    specs = [("3", "mac_mix_tiled", TILED_VARIANTS),
             ("4", "mac_group", GROUP_VARIANTS),
             ("5", "mac_group", MIX_GROUP_VARIANTS),
             ("core", "mac_core", CORE_VARIANTS)]
    for part, stem, variants in specs:
        if part not in parts:
            continue
        ext = ".cuh" if part == "core" else ".cu"
        kept = open(os.path.join(CSRC, stem + ext)).read()
        for name, patches in variants:
            src = kept
            for patch in patches:
                src = patch(src)
            where = os.path.join(OUT, f"{part}_{name}")
            os.makedirs(where, exist_ok=True)
            with open(os.path.join(where, stem + ext), "w") as fh:
                fh.write(src)
            stems = ("mac", "mac_dual") if part == "core" else (stem,)
            for one in stems:
                cu = os.path.join(where, one + ".cu")
                if part == "core":
                    shutil.copy(os.path.join(CSRC, one + ".cu"), cu)
                so = os.path.join(where, f"lib{one}.so")
                jobs.append((part, name, one, so, subprocess.Popen(
                    [_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                     str(_build.CSRC), "-o", so, cu],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
    built = {}
    for part, name, stem, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"part {part}, {name}: nvcc failed on {stem}:\n"
                  f"{log[-2000:]}", flush=True)
            built[part, name] = None
            continue
        if (part, name) in built and built[part, name] is None:
            continue
        fns, usage = built.setdefault((part, name), ({}, []))
        lib = ctypes.CDLL(so)
        for entry, argtypes in _build.SIGNATURES[stem].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[entry] = fn
        if part == "3":
            usage.append(ptxas(log, "mac_mix_tiled_bf16_kernel", ""))
        elif part == "4":
            usage.append(ptxas(log, "mac_group_bf16_kernel",
                               "ILi4E13__nv_bfloat16S") + " | G=8: " +
                         ptxas(log, "mac_group_bf16_kernel",
                               "ILi8E13__nv_bfloat16S"))
        elif part == "5":
            usage.append(ptxas(log, "mac_mix_group_bf16_kernel", "ILi2E"))
            usage.append(ptxas(log, "mac_mix_group_kernel", "ILi2ELb1E"))
        else:
            usage.extend((stem, *x) for x in core_instances(so, log))
    return built


def timed(label, fn, ref_fn, got_fn, flush, b_ms, ablation=False):
    """Run, check against ``ref_fn()`` and time ``fn``; print one line."""
    import torch
    got = got_fn()
    torch.cuda.synchronize()
    ref = ref_fn()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    ms = cs.time_ms(fn, cs.REPS, flush)
    err = "(ablation)" if ablation else f"max rel err {rel:.3e}"
    print(f"  {label}: {ms:.4f} ms ({b_ms / ms:.0%} of the bound); {err}",
          flush=True)
    return got


def part_tiled_group(built, flush, parts):
    """Rows 3 and 4 at the scale shape under each combination."""
    import torch
    from brutefir_tpu_torch.ops import mac_group as mg, mac_mix as mm
    dev = torch.device("cuda")
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
    for combo in cs.BF16_COMBOS:
        r, h, x = cs.bf16_operands(combo, ring, bank, xnews)
        rb, hb = (2 if combo[0] else 4), (2 if combo[1] else 4)
        label = cs.BF16_NAMES[combo]
        both = combo == (1, 1)
        if "3" in parts:
            mask = cs.cblocks_mask(torch.arange(Fs, device=dev) % 4, B_)
            ones = torch.ones(Fs, B_, device=dev)
            ref = mm.mac_mix_reference(r, h, idx, mask, t7, w, False)
            out = torch.empty((Cs, 2, K_), device=dev)

            def tiled(fn, m):
                rc = fn(r.data_ptr(), h.data_ptr(), idx.data_ptr(),
                        m.data_ptr(), t7.data_ptr(), w.data_ptr(),
                        out.data_ptr(), Fs, B_, K_, Es, Cs, 1, combo[0],
                        combo[1], stream)
                if rc != 0:
                    cs.fail(f"a row 3 form failed to launch (cudaError {rc})")
            nb, nf = cs.mac_bytes_flops(Fs, B_, K_, Cs, Es, ring_bytes=rb,
                                        bank_bytes=hb)
            print(f"row 3, bf_mac_mix_tiled, bf16 {label}: bound "
                  f"{cs.bound(nb, nf)[0]:.4f} ms", flush=True)
            names = [n for n, _ in TILED_VARIANTS if both or n == "kept"]
            for name in names + ["kept"]:
                fns, usage = built["3", name]
                fn = fns["bf_mac_mix_tiled"]
                tiled(fn, mask)
                torch.cuda.synchronize()
                rel = ((out - ref).abs().max() / ref.abs().max()).item()
                ms = cs.time_ms(lambda: tiled(fn, ones), cs.REPS, flush)
                err = ("(ablation)" if name in ABLATIONS
                       else f"max rel err {rel:.3e}")
                print(f"  {name}: {ms:.4f} ms; {err}; ptxas {usage[0]}",
                      flush=True)
            del ref, out
        if "4" not in parts:
            del r, h, x
            continue
        mask = cs.cblocks_mask(delay, B_)
        ones = torch.ones(Fs, B_, device=dev)
        zeros = torch.zeros(Fs, dtype=torch.int32, device=dev)
        ref = mg.mac_group_reference(r, x, h, idx, mask, t7, delay)
        out = torch.empty((G, Fs, 2, K_), device=dev)

        def group(fn, m, d, x=x):
            rc = fn(r.data_ptr(), x.data_ptr(), h.data_ptr(), idx.data_ptr(),
                    m.data_ptr(), t7.data_ptr(), d.data_ptr(),
                    out.data_ptr(), Fs, B_, K_, Es, x.shape[1] + 1, 1,
                    combo[0], combo[1], stream)
            if rc != 0:
                cs.fail(f"a row 4 form failed to launch (cudaError {rc})")
        nb, nf = cs.mac_bytes_flops(Fs, B_, K_, 0, Es, G, out_rows=Fs,
                                    ring_bytes=rb, bank_bytes=hb)
        print(f"row 4, bf_mac_group G={G}, bf16 {label}: bound "
              f"{cs.bound(nb, nf)[0]:.4f} ms", flush=True)
        names = [n for n, _ in GROUP_VARIANTS if both or n == "kept"]
        for name in names + ["kept"]:
            fns, usage = built["4", name]
            fn = fns["bf_mac_group"]
            group(fn, mask, delay)
            torch.cuda.synchronize()
            rel = ((out - ref).abs().max() / ref.abs().max()).item()
            ms = cs.time_ms(lambda: group(fn, ones, zeros), cs.REPS, flush)
            print(f"  {name}: {ms:.4f} ms; max rel err {rel:.3e}; ptxas "
                  f"{usage[0]}", flush=True)
        del ref, out, x
        if not both:
            continue
        for G2 in OTHER_G:
            x = xnews8[:, :G2 - 1].to(torch.bfloat16).contiguous()
            ref = mg.mac_group_reference(r, x, h, idx, mask, t7, delay)
            out = torch.empty((G2, Fs, 2, K_), device=dev)
            nb, nf = cs.mac_bytes_flops(Fs, B_, K_, 0, Es, G2, out_rows=Fs,
                                        ring_bytes=2, bank_bytes=2)
            print(f"row 4, bf_mac_group G={G2}, bf16 {label}: bound "
                  f"{cs.bound(nb, nf)[0]:.4f} ms", flush=True)
            for name in OTHER_G_FORMS:
                fn = built["4", name][0]["bf_mac_group"]
                group(fn, mask, delay, x)
                torch.cuda.synchronize()
                rel = ((out - ref).abs().max() / ref.abs().max()).item()
                ms = cs.time_ms(lambda: group(fn, ones, zeros, x), cs.REPS,
                                flush)
                print(f"  {name}: {ms:.4f} ms; max rel err {rel:.3e}",
                      flush=True)
            del ref, out, x
        torch.cuda.empty_cache()


def part_mix_group(built, flush):
    """Row 5 at G = 2 at the scale shape under each combination: the
    variants (with both operands in bf16) and the ablations."""
    import torch
    from brutefir_tpu_torch.ops import mac_group as mg
    dev = torch.device("cuda")
    Fs = Cs = Es = cs.SCALE_C
    B_, K_, G = cs.B, cs.K, 2
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 19)
    ring = torch.randn(Fs, B_, 2, K_, generator=g, device=dev)
    bank = torch.randn(Es, B_, 2, K_, generator=g, device=dev)
    xnews = torch.randn(Fs, G - 1, 2, K_, generator=g, device=dev)
    w = torch.randn(Cs, Fs, generator=g, device=dev) / 16.0
    idx = torch.randperm(Fs, generator=g, device=dev).to(torch.int32)
    delay = (torch.arange(Fs, device=dev) % (G + 2)).to(torch.int32)
    mask = cs.cblocks_mask(delay, B_)
    ones = torch.ones(Fs, B_, device=dev)
    zeros = torch.zeros(Fs, dtype=torch.int32, device=dev)
    t7 = torch.tensor(7, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((G, Cs, 2, K_), device=dev)
    for combo in cs.BF16_COMBOS:
        r, h, x = cs.bf16_operands(combo, ring, bank, xnews)
        rb, hb = (2 if combo[0] else 4), (2 if combo[1] else 4)

        def call(fn, m, d):
            rc = fn(r.data_ptr(), x.data_ptr(), h.data_ptr(), idx.data_ptr(),
                    m.data_ptr(), t7.data_ptr(), d.data_ptr(), w.data_ptr(),
                    out.data_ptr(), Fs, B_, K_, Es, Cs, G, 1, combo[0],
                    combo[1], stream)
            if rc != 0:
                cs.fail(f"a row 5 form failed to launch (cudaError {rc})")
            return out
        b_ms = cs.bound(*cs.mac_bytes_flops(Fs, B_, K_, Cs, Es, G,
                                            ring_bytes=rb,
                                            bank_bytes=hb))[0]
        print(f"row 5, bf_mac_mix_group G={G}, bf16 "
              f"{cs.BF16_NAMES[combo]}: bound {b_ms:.4f} ms; the float32 "
              f"kernel's ptxas {built['5', 'kept'][1][1]}", flush=True)
        ref = mg.mac_mix_group_reference(r, x, h, idx, mask, t7, w, delay)
        names = [n for n, _ in MIX_GROUP_VARIANTS
                 if (combo == (1, 1)) != n.startswith("mixed")
                 or n == "kept"]
        for name in names + ["kept"]:
            if built.get(("5", name)) is None:
                print(f"  {name}: not built", flush=True)
                continue
            fns, usage = built["5", name]
            fn = fns["bf_mac_mix_group"]
            timed(f"{name} (ptxas {usage[0]})", lambda: call(fn, ones, zeros),
                  lambda: ref, lambda: call(fn, mask, delay), flush, b_ms,
                  name in ABLATIONS)
        del r, h, x, ref
        torch.cuda.empty_cache()


def part_core(built, flush):
    """Rows 6-10 at the shapes of their paths, float32 and under each
    combination, every variant; each variant's output bit-equal to the
    kept form's or the run fails; then every vector instance's ptxas
    usage and loads issued before the first use of a loaded value."""
    import torch
    from brutefir_tpu_torch.ops import mac as tm, mac_dual as td
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 20)
    t7 = torch.tensor(7, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    F2 = 2 * cs.F
    shapes = (
        (6, "bench1 stage, Fs=4 of 6, 8192 x 8", 6, 8, cs.K, 7, False,
         [2, 3, 4, 5], False),
        (7, f"{F2} rows, 8192 x 16, shared", F2, cs.B, cs.K, 1, True,
         list(range(F2)), False),
        (8, "bench5, 26 x 8192 x 8, shared (dual)", cs.BENCH5_C,
         cs.BENCH5_B, cs.BENCH5_N, 2, True, None, True),
        (9, "256 distinct rows, 8192 x 16", cs.SCALE_C, cs.B, cs.K,
         cs.SCALE_C, False, None, False),
        (10, "4 rows, 65536 x 8", 4, 8, 65536, 4, False, [0, 1, 2, 3],
         False),
    )
    names = [n for n, _ in CORE_VARIANTS if built.get(("core", n))]
    for row, label, F_, B_, K_, E_, uniform, stage, dual in shapes:
        if dual:
            ring, bank, idx, mask, pidx, pmask, stage = cs.dual_inputs(
                g, F_, B_, K_, E_, uniform, stage)
        else:
            ring, bank, idx, mask, stage = cs.mac_inputs(
                g, F_, B_, K_, E_, uniform, stage)
        rt = torch.tensor(stage, dtype=torch.int32, device=dev)
        Fs = len(stage)
        ones = torch.ones(F_, B_, device=dev)
        outs = [torch.empty((Fs, 2, K_), device=dev) for _ in range(2)]
        used = (len(set(idx[rt.long()].tolist())) if not uniform
                else 2 if dual else 1)
        for combo in ((0, 0),) + cs.BF16_COMBOS:
            r, h, _ = cs.bf16_operands(combo, ring, bank)
            rb, hb = (2 if combo[0] else 4), (2 if combo[1] else 4)

            def call(fns, m, pm):
                if dual:
                    rc = fns["bf_mac_dual"](
                        r.data_ptr(), h.data_ptr(), rt.data_ptr(),
                        idx.data_ptr(), m.data_ptr(), pidx.data_ptr(),
                        pm.data_ptr(), t7.data_ptr(), outs[0].data_ptr(),
                        outs[1].data_ptr(), F_, Fs, B_, K_, E_, int(uniform),
                        1, combo[0], combo[1], stream)
                else:
                    rc = fns["bf_mac"](
                        r.data_ptr(), h.data_ptr(), rt.data_ptr(),
                        idx.data_ptr(), m.data_ptr(), t7.data_ptr(),
                        outs[0].data_ptr(), F_, Fs, B_, K_, E_,
                        int(uniform), 1, combo[0], combo[1], stream)
                if rc != 0:
                    cs.fail(f"a row {row} form failed (cudaError {rc})")

            def result(fns, m, pm):
                call(fns, m, pm)
                return torch.cat(outs) if dual else outs[0].clone()
            if dual:
                nb, nf = cs.dual_bytes_flops(Fs, B_, K_, used, rb, hb)
                ref = torch.cat(td.mac_dual_reference(
                    r, h, rt, idx, mask, pidx, pmask, t7, uniform))
            else:
                nb, nf = cs.mac_bytes_flops(Fs, B_, K_, 0, used,
                                            out_rows=Fs, ring_bytes=rb,
                                            bank_bytes=hb)
                nb += Fs * 4
                ref = tm.mac_reference(r, h, rt, idx, mask, t7, uniform)
            b_ms = cs.bound(nb, nf)[0]
            what = ("float32" if combo == (0, 0)
                    else "bf16 " + cs.BF16_NAMES[combo])
            print(f"row {row}, {label}, {what}: bound {b_ms:.4f} ms",
                  flush=True)
            kept = None
            for name in (names if combo != (0, 0) else ["kept"]):
                fns = built["core", name][0]
                got = timed(name, lambda: call(fns, ones, ones),
                            lambda: ref,
                            lambda: result(fns, mask,
                                           pmask if dual else mask),
                            flush, b_ms)
                if kept is None:
                    kept = got
                elif not torch.equal(got, kept):
                    cs.fail(f"row {row} {what}: {name} is not bit-equal to "
                            f"the kept form")
            del r, h, ref, kept
        del ring, bank, outs
        torch.cuda.empty_cache()
    for name in names:
        print(f"core {name}: vector instances (library, types, sets, group, "
              f"controls: ptxas; 8- and 16-byte loads before the first use "
              f"of a loaded value, of all such loads)", flush=True)
        for stem, label, usage, before, total in built["core", name][1]:
            print(f"  {stem} {label}: {usage}; {before} of {total}",
                  flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a card")
    parts = set(sys.argv[1:]) or {"3", "4", "5", "core"}
    if not parts <= {"3", "4", "5", "core"}:
        cs.fail("usage: python3 chip_mac_bf16_designs.py [3] [4] [5] [core]")
    print(cs.card_line(), flush=True)
    built = build(parts)
    dev = torch.device("cuda")
    flush = cs.read_flush()
    tiny = torch.zeros(1, device=dev)
    cs.FLOOR_MS = cs.time_ms(lambda: tiny.zero_(), cs.REPS, flush)
    print(f"median of {cs.REPS}, L2 flushed by a read before each; floor "
          f"{cs.FLOOR_MS:.4f} ms", flush=True)
    if parts & {"3", "4"}:
        part_tiled_group(built, flush, parts)
    if "5" in parts:
        part_mix_group(built, flush)
    if "core" in parts:
        part_core(built, flush)
    return 0


if __name__ == "__main__":
    sys.exit(main())
