#!/usr/bin/env python3
"""Times the unfused MAC (``csrc/mac.cu``), the crossfade dual MAC
(``csrc/mac_dual.cu``), the grouped MACs (``csrc/mac_group.cu``) and the
fused MAC + mix (``csrc/mac_mix.cu``, ``csrc/mac_mix_tiled.cu``) of this
tree beside the same sources of another tree of the repository, on one
CUDA card: the first two at the shapes of ``chip_smoke.py``'s phases 4
and 5 (``MAC_SHAPES``, ``DUAL_SHAPES``), the grouped ones at the
256-channel scale shape (``bf_mac_mix_group`` at G = 2, ``bf_mac_group``
at G = 4 and 3), the fused MAC + mix at the massive shape (both forms)
and the tiled one at the scale shape:

    python3 chip_mac_ab.py OTHER_TREE

``OTHER_TREE`` holds the other tree, for example an earlier commit
unpacked with ``git archive`` into a git-ignored directory. Its sources
are built here with the port's nvcc flags into ``build/chip_mac_ab/``
and called through the same C entries (``bf_mac``, ``bf_mac_dual``,
``bf_mac_group``, ``bf_mac_mix_group``) on the same tensors as this
tree's wrappers, each with the other tree's own argument list (its
``_build.SIGNATURES``: a tree whose entries take ``has_bin0`` gets 1,
the unsharded value). Both outputs are held against the plain version
first (1e-5 of its peak), and against each other: bit-equal, or the
run fails. Each time is the median of 20 calls with the L2
cache flushed by a read before each (``chip_smoke.time_ms``,
``read_flush``), taken in turns: other, this, this, other; each pair of
means is marked within 2% of each other or not, and the last line lists
those that are not (printed, not failed: a timing). The floor of the
method (a kernel that writes 4 bytes) and each shape's bound are printed
beside them. The forms compared are the float32 ones (this tree's
wrappers pass its entries ``ring_bf16`` = ``bank_bf16`` = 0) and, where
the other tree's entries take those flags (its ``SIGNATURES`` end in
``ring_bf16, bank_bf16``), the bf16 operand forms of
``bf_mac_mix_tiled``, ``bf_mac_group`` at G = 4 and ``bf_mac_mix_group``
at G = 2 at the scale shape and of ``bf_mac`` / ``bf_mac_dual`` at the
shapes of rows 6, 7, 8 and 10, under a bf16 ring, bank and both: each
tree's output held against the plain version (1e-5 of its peak), their
max difference printed ("bit-equal" where 0: a redesigned bf16 form
need not round as the other tree's does), then timed in turns; rows 6-10
also in turns against this tree's float32 form of the row. The last line
lists the bf16 forms slower than the other tree's and those of rows 6-10
slower than their float32 form.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import chip_smoke as cs

OUT = os.path.join(cs.REPO, "build", "chip_mac_ab")
# source stem -> the C entries compared
ENTRIES = {"mac": ("bf_mac",), "mac_dual": ("bf_mac_dual",),
           "mac_group": ("bf_mac_group", "bf_mac_mix_group"),
           "mac_mix": ("bf_mac_mix",), "mac_mix_tiled": ("bf_mac_mix_tiled",)}
# C entry -> how many of the trailing ints has_bin0, ring_bf16, bank_bf16
# the other tree's entry takes (0, 1 or all 3)
TRAILING = {}


def trailing(name: str, flags=(0, 0)) -> tuple:
    """The other tree's trailing arguments before the stream: has_bin0 =
    1 (unsharded) and the bf16 flags, as many as it takes."""
    return (1, *flags)[:TRAILING[name]]


def other_signatures(tree: str) -> dict:
    """The other tree's ``_build.SIGNATURES``, read from its file."""
    import importlib.util
    path = os.path.join(tree, "brutefir_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location("other_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SIGNATURES


def build_other(tree: str) -> dict:
    """The other tree's sources, built and loaded: C entry -> function."""
    from brutefir_tpu_torch.ops import _build
    sigs = other_signatures(tree)
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for stem in ENTRIES:
        src = os.path.join(tree, "brutefir_tpu_torch", "csrc", f"{stem}.cu")
        so = os.path.join(OUT, f"lib{stem}_other.so")
        jobs[stem] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for stem, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"nvcc failed on the other tree's {stem}.cu:\n{log[-3000:]}")
        lib = ctypes.CDLL(so)
        for name in ENTRIES[stem]:
            fn = getattr(lib, name)
            fn.argtypes = sigs[stem][name]
            fn.restype = ctypes.c_int
            libs[name] = fn
            # this tree's entries end in has_bin0, ring_bf16, bank_bf16
            extra = len(sigs[stem][name]) - len(_build.SIGNATURES[stem][name])
            TRAILING[name] = 3 + extra
    return libs


def same(label: str, other, this) -> None:
    """Fail unless the two trees' outputs are bit-equal."""
    import torch
    for a, b in zip(other if isinstance(other, tuple) else (other,),
                    this if isinstance(this, tuple) else (this,)):
        if not torch.equal(a, b):
            cs.fail(f"{label}: this tree's output is not bit-equal to the "
                    f"other tree's")
    print(f"{label}: bit-equal to the other tree", flush=True)


def stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def other_mac(fn, ring, bank, rows, idx, mask, t, uniform, flags=(0, 0)):
    import torch
    F, B, _, K = ring.shape
    out = torch.empty((rows.numel(), 2, K), device=ring.device)
    rc = fn(ring.data_ptr(), bank.data_ptr(), rows.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), t.data_ptr(), out.data_ptr(),
            F, rows.numel(), B, K, bank.shape[0], int(uniform),
            *trailing("bf_mac", flags), stream())
    if rc != 0:
        cs.fail(f"the other tree's bf_mac failed (cudaError {rc})")
    return out


def other_dual(fn, ring, bank, rows, idx, mask, pidx, pmask, t, uniform,
               flags=(0, 0)):
    import torch
    F, B, _, K = ring.shape
    y_new = torch.empty((rows.numel(), 2, K), device=ring.device)
    y_old = torch.empty_like(y_new)
    rc = fn(ring.data_ptr(), bank.data_ptr(), rows.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), pidx.data_ptr(),
            pmask.data_ptr(), t.data_ptr(), y_new.data_ptr(),
            y_old.data_ptr(), F, rows.numel(), B, K, bank.shape[0],
            int(uniform), *trailing("bf_mac_dual", flags), stream())
    if rc != 0:
        cs.fail(f"the other tree's bf_mac_dual failed (cudaError {rc})")
    return y_new, y_old


def other_group(fn, ring, xnews, bank, idx, mask, t, delay, w=None,
                flags=(0, 0)):
    """The other tree's bf_mac_group, or bf_mac_mix_group with ``w``;
    ``flags``: its operands' (ring_bf16, bank_bf16)."""
    import torch
    F, B, _, K = ring.shape
    G = xnews.shape[1] + 1
    rows = F if w is None else w.shape[0]
    out = torch.empty((G, rows, 2, K), device=ring.device)
    ptrs = [ring, xnews, bank, idx, mask, t, delay] + (
        [] if w is None else [w])
    dims = (F, B, K, bank.shape[0]) + (() if w is None else (rows,))
    name = "bf_mac_group" if w is None else "bf_mac_mix_group"
    rc = fn(*(x.data_ptr() for x in ptrs), out.data_ptr(), *dims, G,
            *trailing(name, flags), stream())
    if rc != 0:
        cs.fail(f"the other tree's group kernel failed (cudaError {rc})")
    return out


def other_mix(libs, ring, bank, idx, mask, t, w, uniform, flags=(0, 0)):
    """The other tree's bf_mac_mix (or bf_mac_mix_tiled where this tree's
    wrapper takes it) with this tree's launch plan; ``flags``: the
    operands' (ring_bf16, bank_bf16), the tiled entry only."""
    import torch
    from brutefir_tpu_torch.ops import mac_mix as mm
    F, B, _, K = ring.shape
    C = w.shape[0]
    out = torch.empty((C, 2, K), device=ring.device)
    args = (ring.data_ptr(), bank.data_ptr(), idx.data_ptr(),
            mask.data_ptr(), t.data_ptr(), w.data_ptr(), out.data_ptr(),
            F, B, K, bank.shape[0], C)
    if mm.tiled_route(C, B, K):
        rc = libs["bf_mac_mix_tiled"](
            *args, *trailing("bf_mac_mix_tiled", flags), stream())
    else:
        p = mm.plan(F, B, K, C, uniform)
        rc = libs["bf_mac_mix"](*args, int(uniform), p["nw"], p["FC"],
                                int(p["bank_smem"]),
                                *trailing("bf_mac_mix"), stream())
    if rc != 0:
        cs.fail(f"the other tree's fused MAC + mix failed (cudaError {rc})")
    return out


def compare_mix(libs, flush) -> None:
    """The fused MAC + mix of both trees: both forms of mac_mix.cu at the
    massive shape, the tiled kernel at the scale shape (256 outputs)."""
    import torch
    from brutefir_tpu_torch.ops import mac_mix as mm
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 52)
    t7 = torch.tensor(7, dtype=torch.int32, device=dev)
    for label, F_, C, E_, uniform in (
            ("mac_mix_uniform (massive)", cs.F, cs.C_OUT, cs.E, True),
            ("mac_mix_rows (massive)", cs.F, cs.C_OUT, cs.E, False),
            ("mac_mix tiled (scale)", cs.SCALE_C, cs.SCALE_C, cs.SCALE_C,
             False)):
        ring = torch.randn(F_, cs.B, 2, cs.K, generator=g, device=dev)
        bank = torch.randn(E_, cs.B, 2, cs.K, generator=g, device=dev)
        w = torch.randn(C, F_, generator=g, device=dev) / 16.0
        idx = (torch.full((F_,), E_ - 1, dtype=torch.int32, device=dev)
               if uniform else
               torch.randperm(F_, generator=g, device=dev).to(torch.int32)
               % E_)
        mask = torch.ones(F_, cs.B, device=dev)
        mask[:, -2:] = 0.0
        ref = mm.mac_mix_reference(ring, bank, idx, mask, t7, w, uniform)
        got_o = other_mix(libs, ring, bank, idx, mask, t7, w, uniform)
        got_t = mm.mac_mix(ring, bank, idx, mask, t7, w, uniform)
        cs.check(f"{label} (other tree)", got_o, ref, 7)
        cs.check(label, got_t, ref, 7)
        same(label, got_o, got_t)
        ones = torch.ones(F_, cs.B, device=dev)
        nb, nf = cs.mac_bytes_flops(F_, cs.B, cs.K, C, 1 if uniform else E_)
        in_turns(label,
                 lambda: other_mix(libs, ring, bank, idx, ones, t7, w,
                                   uniform),
                 lambda: mm.mac_mix(ring, bank, idx, ones, t7, w, uniform),
                 flush, cs.bound(nb, nf)[0])
        del ring, bank, ref, got_o, got_t
        torch.cuda.empty_cache()


def compare_group(libs, flush) -> None:
    """bf_mac_mix_group at G = 2 and bf_mac_group at G = 4 and 3 at the
    scale shape (chip_smoke.kernels_scale's inputs), each tree's output
    held against the plain version first."""
    import torch
    from brutefir_tpu_torch.ops import mac_group as mg
    dev = torch.device("cuda")
    Fs = Cs = Es = cs.SCALE_C
    B_, K_ = cs.B, cs.K
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    ring = torch.randn(Fs, B_, 2, K_, generator=g, device=dev)
    bank = torch.randn(Es, B_, 2, K_, generator=g, device=dev)
    w = torch.randn(Cs, Fs, generator=g, device=dev) / 16.0
    idx = torch.randperm(Fs, generator=g, device=dev).to(torch.int32)
    ones = torch.ones(Fs, B_, device=dev)
    zeros = torch.zeros(Fs, dtype=torch.int32, device=dev)
    t7 = torch.tensor(7, dtype=torch.int32, device=dev)
    for G, fused in ((2, True), (4, False), (3, False)):
        xnews = torch.randn(Fs, G - 1, 2, K_, generator=g, device=dev)
        delay = (torch.arange(Fs, device=dev, dtype=torch.int32)
                 % (G + 2)).to(torch.int32)
        mask = cs.cblocks_mask(delay, B_)
        if fused:
            fn = libs["bf_mac_mix_group"]
            ref = mg.mac_mix_group_reference(ring, xnews, bank, idx, mask,
                                             t7, w, delay)
            got_o = other_group(fn, ring, xnews, bank, idx, mask, t7, delay,
                                w)
            got_t = mg.mac_mix_group(ring, xnews, bank, idx, mask, t7, w,
                                     delay)
            nb, nf = cs.mac_bytes_flops(Fs, B_, K_, Cs, Es, G)
            other = lambda: other_group(fn, ring, xnews, bank, idx, ones,
                                        t7, zeros, w)
            this = lambda: mg.mac_mix_group(ring, xnews, bank, idx, ones,
                                            t7, w, zeros)
        else:
            fn = libs["bf_mac_group"]
            ref = mg.mac_group_reference(ring, xnews, bank, idx, mask, t7,
                                         delay)
            got_o = other_group(fn, ring, xnews, bank, idx, mask, t7, delay)
            got_t = mg.mac_group(ring, xnews, bank, idx, mask, t7, delay)
            nb, nf = cs.mac_bytes_flops(Fs, B_, K_, 0, Es, G, out_rows=Fs)
            other = lambda: other_group(fn, ring, xnews, bank, idx, ones,
                                        t7, zeros)
            this = lambda: mg.mac_group(ring, xnews, bank, idx, ones, t7,
                                        zeros)
        name = "bf_mac_mix_group" if fused else "bf_mac_group"
        cs.check(f"{name} G={G} (other tree)", got_o, ref, 7)
        cs.check(f"{name} G={G}", got_t, ref, 7)
        same(f"{name} G={G}", got_o, got_t)
        del got_o, got_t, ref
        in_turns(f"{name} (scale shape, G={G})", other, this, flush,
                 cs.bound(nb, nf)[0])
        del xnews
        torch.cuda.empty_cache()


def compare_bf16(libs, flush) -> None:
    """The bf16 operand forms of bf_mac_mix_tiled (row 3), bf_mac_group
    at G = 4 (row 4) and bf_mac_mix_group at G = 2 (row 5) at the scale
    shape, and of bf_mac and bf_mac_dual at the shapes of rows 6, 7, 8
    and 10 (``CORE_BF16``), under a bf16 ring, bank and both, where the
    other tree's entries take the flags: each tree's output against the
    plain version, their max difference ("bit-equal" where 0), the times
    in turns; then each of rows 6-10's bf16 forms in turns against this
    tree's float32 form of the row (``compare_core_f32``)."""
    import torch
    from brutefir_tpu_torch.ops import mac_group as mg, mac_mix as mm
    if (TRAILING["bf_mac_mix_tiled"] < 3
            or TRAILING["bf_mac_group"] < 3):
        print("bf16 forms: the other tree's entries take no bf16 flags; "
              "not compared", flush=True)
        return
    dev = torch.device("cuda")
    Fs = Cs = Es = cs.SCALE_C
    B_, K_, G = cs.B, cs.K, 4
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 53)
    ring = torch.randn(Fs, B_, 2, K_, generator=g, device=dev)
    bank = torch.randn(Es, B_, 2, K_, generator=g, device=dev)
    xnews = torch.randn(Fs, G - 1, 2, K_, generator=g, device=dev)
    w = torch.randn(Cs, Fs, generator=g, device=dev) / 16.0
    idx = torch.randperm(Fs, generator=g, device=dev).to(torch.int32)
    delay = (torch.arange(Fs, device=dev) % (G + 2)).to(torch.int32)
    mask = cs.cblocks_mask(delay, B_)
    x2news = xnews[:, :1].contiguous()        # row 5 at G = 2
    ones = torch.ones(Fs, B_, device=dev)
    zeros = torch.zeros(Fs, dtype=torch.int32, device=dev)
    t7 = torch.tensor(7, dtype=torch.int32, device=dev)
    for combo in cs.BF16_COMBOS:
        r, h, x = cs.bf16_operands(combo, ring, bank, xnews)
        x2 = x2news.to(r.dtype)
        rb, hb = (2 if combo[0] else 4), (2 if combo[1] else 4)
        what = f"bf16 {cs.BF16_NAMES[combo]}"
        for name, other, this, plain, nbf in (
                (f"bf_mac_mix_tiled {what} (scale)",
                 lambda m: other_mix(libs, r, h, idx, m, t7, w, False,
                                     combo),
                 lambda m: mm.mac_mix(r, h, idx, m, t7, w, False),
                 lambda: mm.mac_mix_reference(r, h, idx, mask, t7, w,
                                              False),
                 cs.mac_bytes_flops(Fs, B_, K_, Cs, Es, ring_bytes=rb,
                                    bank_bytes=hb)),
                (f"bf_mac_group G={G} {what} (scale)",
                 lambda m, d=delay: other_group(
                     libs["bf_mac_group"], r, x, h, idx, m, t7, d,
                     flags=combo),
                 lambda m, d=delay: mg.mac_group(r, x, h, idx, m, t7, d),
                 lambda: mg.mac_group_reference(r, x, h, idx, mask, t7,
                                                delay),
                 cs.mac_bytes_flops(Fs, B_, K_, 0, Es, G, out_rows=Fs,
                                    ring_bytes=rb, bank_bytes=hb)),
                (f"bf_mac_mix_group G=2 {what} (scale)",
                 lambda m, d=delay: other_group(
                     libs["bf_mac_mix_group"], r, x2, h, idx, m, t7, d, w,
                     flags=combo),
                 lambda m, d=delay: mg.mac_mix_group(r, x2, h, idx, m, t7,
                                                     w, d),
                 lambda: mg.mac_mix_group_reference(r, x2, h, idx, mask, t7,
                                                    w, delay),
                 cs.mac_bytes_flops(Fs, B_, K_, Cs, Es, 2, ring_bytes=rb,
                                    bank_bytes=hb))):
            ref = plain()
            got_o, got_t = other(mask), this(mask)
            cs.check(f"{name} (other tree)", got_o, ref, 7)
            cs.check(name, got_t, ref, 7)
            diff = (got_o - got_t).abs().max().item()
            print(f"{name}: max |this - other| {diff:.3e} "
                  f"({diff / ref.abs().max().item():.3e} of the peak; "
                  f"{'bit-equal' if diff == 0 else 'not bit-equal'})",
                  flush=True)
            del ref, got_o, got_t
            if "group" in name:
                o, t = (lambda: other(ones, zeros)), (lambda: this(ones,
                                                                   zeros))
            else:
                o, t = (lambda: other(ones)), (lambda: this(ones))
            in_turns(name, o, t, flush, cs.bound(*nbf)[0], bf16=True)
        del r, h, x, x2
        torch.cuda.empty_cache()
    del ring, bank, xnews, x2news
    torch.cuda.empty_cache()
    compare_core_bf16(libs, flush)


# rows 6-10's bf16 forms at the shapes of their paths: (row, label, F, B,
# K, E, uniform, stage rows, dual)
CORE_BF16 = (
    (6, "bench1 stage, Fs=4 of 6, 8192 x 8", 6, 8, cs.K, 7, False,
     [2, 3, 4, 5], False),
    (7, f"{2 * cs.F} rows, 8192 x 16, shared", 2 * cs.F, cs.B, cs.K, 1,
     True, list(range(2 * cs.F)), False),
    (8, "bench5, 26 x 8192 x 8, shared (dual)", cs.BENCH5_C, cs.BENCH5_B,
     cs.BENCH5_N, 2, True, None, True),
    (10, "4 rows, 65536 x 8", 4, 8, 65536, 4, False, [0, 1, 2, 3], False),
)


def compare_core_bf16(libs, flush) -> None:
    """Rows 6, 7, 8 and 10's bf16 forms (``CORE_BF16``) under each
    combination: both trees' outputs against the plain version, their max
    difference, the times in turns against the other tree's; then in
    turns against this tree's float32 form of the row at the same shape
    (``SLOWER_THAN_F32`` lists those slower)."""
    import torch
    from brutefir_tpu_torch.ops import mac as tm, mac_dual as td
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 54)
    t7 = torch.tensor(7, dtype=torch.int32, device=dev)
    for row, label, F_, B_, K_, E_, uniform, stage, dual in CORE_BF16:
        if dual:
            ring, bank, idx, mask, pidx, pmask, stage = cs.dual_inputs(
                g, F_, B_, K_, E_, uniform, stage)
        else:
            ring, bank, idx, mask, stage = cs.mac_inputs(
                g, F_, B_, K_, E_, uniform, stage)
        rt = torch.tensor(stage, dtype=torch.int32, device=dev)
        ones = torch.ones(F_, B_, device=dev)
        Fs = len(stage)
        used = (len(set(idx[rt.long()].tolist())) if not uniform
                else 2 if dual else 1)

        def this_f(r, h, m):
            if dual:
                return torch.cat(td.mac_dual(r, h, rt, idx, m, pidx,
                                             pmask if m is mask else m, t7,
                                             uniform))
            return tm.mac(r, h, rt, idx, m, t7, uniform)

        def other_f(r, h, m, combo):
            if dual:
                return torch.cat(other_dual(
                    libs["bf_mac_dual"], r, h, rt, idx, m, pidx,
                    pmask if m is mask else m, t7, uniform, combo))
            return other_mac(libs["bf_mac"], r, h, rt, idx, m, t7, uniform,
                             combo)

        for combo in cs.BF16_COMBOS:
            r, h, _ = cs.bf16_operands(combo, ring, bank)
            rb, hb = (2 if combo[0] else 4), (2 if combo[1] else 4)
            name = f"row {row} {label}, bf16 {cs.BF16_NAMES[combo]}"
            if dual:
                ref = torch.cat(td.mac_dual_reference(
                    r, h, rt, idx, mask, pidx, pmask, t7, uniform))
                nb, nf = cs.dual_bytes_flops(Fs, B_, K_, used, rb, hb)
                nb32, nf32 = cs.dual_bytes_flops(Fs, B_, K_, used)
                o_call = lambda: other_dual(libs["bf_mac_dual"], r, h, rt,
                                            idx, ones, pidx, ones, t7,
                                            uniform, combo)
                t_call = lambda: td.mac_dual(r, h, rt, idx, ones, pidx, ones,
                                             t7, uniform)
                f_call = lambda: td.mac_dual(ring, bank, rt, idx, ones, pidx,
                                             ones, t7, uniform)
            else:
                ref = tm.mac_reference(r, h, rt, idx, mask, t7, uniform)
                nb, nf = cs.mac_bytes_flops(Fs, B_, K_, 0, used,
                                            out_rows=Fs, ring_bytes=rb,
                                            bank_bytes=hb)
                nb32, nf32 = cs.mac_bytes_flops(Fs, B_, K_, 0, used,
                                                out_rows=Fs)
                nb, nb32 = nb + Fs * 4, nb32 + Fs * 4
                o_call = lambda: other_mac(libs["bf_mac"], r, h, rt, idx,
                                           ones, t7, uniform, combo)
                t_call = lambda: tm.mac(r, h, rt, idx, ones, t7, uniform)
                f_call = lambda: tm.mac(ring, bank, rt, idx, ones, t7,
                                        uniform)
            got_o, got_t = other_f(r, h, mask, combo), this_f(r, h, mask)
            cs.check(f"{name} (other tree)", got_o, ref, 7)
            cs.check(name, got_t, ref, 7)
            diff = (got_o - got_t).abs().max().item()
            print(f"{name}: max |this - other| {diff:.3e} "
                  f"({diff / ref.abs().max().item():.3e} of the peak; "
                  f"{'bit-equal' if diff == 0 else 'not bit-equal'})",
                  flush=True)
            del ref, got_o, got_t
            in_turns(name, o_call, t_call, flush, cs.bound(nb, nf)[0],
                     bf16=True)
            vs_f32(name, f_call, t_call, flush, cs.bound(nb32, nf32)[0])
            del r, h
        del ring, bank
        torch.cuda.empty_cache()


SLOWER_THAN_F32 = []


def vs_f32(label: str, f32, bf16, flush, b32_ms: float) -> None:
    """This tree's float32 form and bf16 form of one row at one shape, in
    turns: float32, bf16, bf16, float32."""
    f1 = cs.time_ms(f32, cs.REPS, flush)
    b1 = cs.time_ms(bf16, cs.REPS, flush)
    b2 = cs.time_ms(bf16, cs.REPS, flush)
    f2 = cs.time_ms(f32, cs.REPS, flush)
    f, b = (f1 + f2) / 2, (b1 + b2) / 2
    if b > f:
        SLOWER_THAN_F32.append(label)
    print(f"{label}: this tree's float32 form {f1:.4f} / {f2:.4f} ms, bf16 "
          f"{b1:.4f} / {b2:.4f} ms; means {f:.4f} -> {b:.4f} "
          f"({100.0 * (b / f - 1.0):+.2f}%); float32 bound {b32_ms:.4f} ms",
          flush=True)


# labels whose mean time in this tree is more than 2% off the other's; bf16
# forms whose mean time in this tree is above the other's
OFF_2PCT = []
SLOWER_BF16 = []


def in_turns(label: str, other, this, flush, b_ms: float,
             bf16: bool = False) -> None:
    """Time other, this, this, other; print the pairs' means and whether
    this tree's is within 2% of the other's (``bf16``: a redesigned form,
    noted where this tree's is slower)."""
    o1 = cs.time_ms(other, cs.REPS, flush)
    t1 = cs.time_ms(this, cs.REPS, flush)
    t2 = cs.time_ms(this, cs.REPS, flush)
    o2 = cs.time_ms(other, cs.REPS, flush)
    o, t = (o1 + o2) / 2, (t1 + t2) / 2
    within = abs(t / o - 1.0) <= 0.02
    if bf16:
        if t > o:
            SLOWER_BF16.append(label)
    elif not within:
        OFF_2PCT.append(label)
    print(f"{label}: other tree {o1:.4f} / {o2:.4f} ms, this tree "
          f"{t1:.4f} / {t2:.4f} ms; means {o:.4f} -> {t:.4f} ({o / t:.2f}x, "
          f"{100.0 * (t / o - 1.0):+.2f}%: "
          f"{'within' if within else 'NOT within'} 2%); bound {b_ms:.4f} "
          f"ms, floor {cs.FLOOR_MS:.4f} ms", flush=True)


def main() -> int:
    if len(sys.argv) != 2 or not os.path.isdir(sys.argv[1]):
        cs.fail("usage: python3 chip_mac_ab.py OTHER_TREE")
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a card")
    from brutefir_tpu_torch.ops import _build, mac as tm, mac_dual as td
    print(cs.card_line(), flush=True)
    for stem in ENTRIES:
        _build.load(stem)
    libs = build_other(sys.argv[1])
    dev = torch.device("cuda")
    flush = cs.read_flush()
    tiny = torch.zeros(1, device=dev)
    cs.FLOOR_MS = cs.time_ms(lambda: tiny.zero_(), cs.REPS, flush)
    print(f"floor (a kernel writing 4 bytes): {cs.FLOOR_MS:.4f} ms",
          flush=True)
    compare_mix(libs, flush)
    compare_group(libs, flush)
    compare_bf16(libs, flush)
    t7 = torch.tensor(7, dtype=torch.int32, device=dev)

    g = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    for name, _, F_, B_, K_, E_, uniform, stage, _ in cs.MAC_SHAPES:
        ring, bank, idx, mask, stage = cs.mac_inputs(g, F_, B_, K_, E_,
                                                     uniform, stage)
        rt = torch.tensor(stage, dtype=torch.int32, device=dev)
        ref = tm.mac_reference(ring, bank, rt, idx, mask, t7, uniform)
        got_o = other_mac(libs["bf_mac"], ring, bank, rt, idx, mask, t7,
                          uniform)
        got_t = tm.mac(ring, bank, rt, idx, mask, t7, uniform)
        cs.check(f"{name} (other tree)", got_o, ref, 7)
        cs.check(name, got_t, ref, 7)
        same(name, got_o, got_t)
        ones = torch.ones(F_, B_, device=dev)
        used = 1 if uniform else len(set(idx[rt.long()].tolist()))
        nb, nf = cs.mac_bytes_flops(len(stage), B_, K_, 0, used,
                                    out_rows=len(stage))
        in_turns(f"{name} (F={F_}, Fs={len(stage)}, B={B_}, K={K_})",
                 lambda: other_mac(libs["bf_mac"], ring, bank, rt, idx, ones,
                                   t7, uniform),
                 lambda: tm.mac(ring, bank, rt, idx, ones, t7, uniform),
                 flush, cs.bound(nb + len(stage) * 4, nf)[0])
        del ring, bank, ref
        torch.cuda.empty_cache()

    g = torch.Generator(device=dev).manual_seed(cs.SEED + 6)
    for label, F_, B_, K_, E_, uniform, stage, _, _ in cs.DUAL_SHAPES:
        ring, bank, idx, mask, pidx, pmask, stage = cs.dual_inputs(
            g, F_, B_, K_, E_, uniform, stage)
        rt = torch.tensor(stage, dtype=torch.int32, device=dev)
        refs = td.mac_dual_reference(ring, bank, rt, idx, mask, pidx, pmask,
                                     t7, uniform)
        outs = {}
        for who, got in (
                ("other tree", other_dual(libs["bf_mac_dual"], ring, bank, rt,
                                          idx, mask, pidx, pmask, t7,
                                          uniform)),
                ("this tree", td.mac_dual(ring, bank, rt, idx, mask, pidx,
                                          pmask, t7, uniform))):
            for a, b in zip(got, refs):
                cs.check(f"mac_dual {label} ({who})", a, b, 7)
            outs[who] = got
        same(f"mac_dual {label}", outs["other tree"], outs["this tree"])
        ones = torch.ones(F_, B_, device=dev)
        sel = rt.long()[:1] if uniform else rt.long()
        used = len(set(idx[sel].tolist()) | set(pidx[sel].tolist()))
        nb, nf = cs.dual_bytes_flops(len(stage), B_, K_, used)
        name = "mac_dual_uniform" if uniform else "mac_dual_rows"
        in_turns(f"{name} ({label}: F={F_}, Fs={len(stage)}, B={B_}, "
                 f"K={K_})",
                 lambda: other_dual(libs["bf_mac_dual"], ring, bank, rt, idx,
                                    ones, pidx, ones, t7, uniform),
                 lambda: td.mac_dual(ring, bank, rt, idx, ones, pidx, ones,
                                     t7, uniform),
                 flush, cs.bound(nb, nf)[0])
        del ring, bank, refs
        torch.cuda.empty_cache()
    print(f"every float32 form bit-equal to the other tree's; means within "
          f"2%: {'all' if not OFF_2PCT else 'all but ' + ', '.join(OFF_2PCT)}"
          f"; bf16 forms slower than the other tree's: "
          f"{', '.join(SLOWER_BF16) or 'none'}; rows 6-10's bf16 forms "
          f"slower than their float32 form: "
          f"{', '.join(SLOWER_THAN_F32) or 'none'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
