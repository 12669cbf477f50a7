#!/usr/bin/env python3
"""Times the unfused MAC (``csrc/mac.cu``) and the crossfade dual MAC
(``csrc/mac_dual.cu``) of this tree beside the same two sources of
another tree of the repository, at the shapes of ``chip_smoke.py``'s
phases 4 and 5 (``MAC_SHAPES``, ``DUAL_SHAPES``), on one CUDA card:

    python3 chip_mac_ab.py OTHER_TREE

``OTHER_TREE`` holds the other tree, for example an earlier commit
unpacked with ``git archive`` into a git-ignored directory. Its two
sources are built here with the port's nvcc flags into
``build/chip_mac_ab/`` and called through the same C entries
(``bf_mac``, ``bf_mac_dual``) on the same tensors as this tree's
wrappers. Both outputs are held against the plain version first (1e-5 of
its peak). Each time is the median of 20 calls with the L2 cache flushed
by a read before each (``chip_smoke.time_ms``, ``read_flush``), taken in
turns: other, this, this, other. The floor of the method (a kernel that
writes 4 bytes) and each shape's bound are printed beside them.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import chip_smoke as cs

OUT = os.path.join(cs.REPO, "build", "chip_mac_ab")


def build_other(tree: str) -> dict:
    """The other tree's mac.cu and mac_dual.cu, built and loaded."""
    from brutefir_tpu_torch.ops import _build
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for stem in ("mac", "mac_dual"):
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
        fn = getattr(lib, f"bf_{stem}")
        fn.argtypes = _build.SIGNATURES[stem][f"bf_{stem}"]
        fn.restype = ctypes.c_int
        libs[stem] = fn
    return libs


def stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def other_mac(fn, ring, bank, rows, idx, mask, t, uniform):
    import torch
    F, B, _, K = ring.shape
    out = torch.empty((rows.numel(), 2, K), device=ring.device)
    rc = fn(ring.data_ptr(), bank.data_ptr(), rows.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), t.data_ptr(), out.data_ptr(),
            F, rows.numel(), B, K, bank.shape[0], int(uniform), stream())
    if rc != 0:
        cs.fail(f"the other tree's bf_mac failed (cudaError {rc})")
    return out


def other_dual(fn, ring, bank, rows, idx, mask, pidx, pmask, t, uniform):
    import torch
    F, B, _, K = ring.shape
    y_new = torch.empty((rows.numel(), 2, K), device=ring.device)
    y_old = torch.empty_like(y_new)
    rc = fn(ring.data_ptr(), bank.data_ptr(), rows.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), pidx.data_ptr(),
            pmask.data_ptr(), t.data_ptr(), y_new.data_ptr(),
            y_old.data_ptr(), F, rows.numel(), B, K, bank.shape[0],
            int(uniform), stream())
    if rc != 0:
        cs.fail(f"the other tree's bf_mac_dual failed (cudaError {rc})")
    return y_new, y_old


def in_turns(label: str, other, this, flush, b_ms: float) -> None:
    """Time other, this, this, other; print the pairs' means."""
    o1 = cs.time_ms(other, cs.REPS, flush)
    t1 = cs.time_ms(this, cs.REPS, flush)
    t2 = cs.time_ms(this, cs.REPS, flush)
    o2 = cs.time_ms(other, cs.REPS, flush)
    o, t = (o1 + o2) / 2, (t1 + t2) / 2
    print(f"{label}: other tree {o1:.4f} / {o2:.4f} ms, this tree "
          f"{t1:.4f} / {t2:.4f} ms; means {o:.4f} -> {t:.4f} ({o / t:.2f}x); "
          f"bound {b_ms:.4f} ms, floor {cs.FLOOR_MS:.4f} ms", flush=True)


def main() -> int:
    if len(sys.argv) != 2 or not os.path.isdir(sys.argv[1]):
        cs.fail("usage: python3 chip_mac_ab.py OTHER_TREE")
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a card")
    from brutefir_tpu_torch.ops import _build, mac as tm, mac_dual as td
    print(cs.card_line(), flush=True)
    _build.load("mac")
    _build.load("mac_dual")
    libs = build_other(sys.argv[1])
    dev = torch.device("cuda")
    flush = cs.read_flush()
    tiny = torch.zeros(1, device=dev)
    cs.FLOOR_MS = cs.time_ms(lambda: tiny.zero_(), cs.REPS, flush)
    t7 = torch.tensor(7, dtype=torch.int32, device=dev)

    g = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    for name, _, F_, B_, K_, E_, uniform, stage, _ in cs.MAC_SHAPES:
        ring, bank, idx, mask, stage = cs.mac_inputs(g, F_, B_, K_, E_,
                                                     uniform, stage)
        rt = torch.tensor(stage, dtype=torch.int32, device=dev)
        ref = tm.mac_reference(ring, bank, rt, idx, mask, t7, uniform)
        cs.check(f"{name} (other tree)", other_mac(
            libs["mac"], ring, bank, rt, idx, mask, t7, uniform), ref, 7)
        cs.check(name, tm.mac(ring, bank, rt, idx, mask, t7, uniform), ref,
                 7)
        ones = torch.ones(F_, B_, device=dev)
        used = 1 if uniform else len(set(idx[rt.long()].tolist()))
        nb, nf = cs.mac_bytes_flops(len(stage), B_, K_, 0, used,
                                    out_rows=len(stage))
        in_turns(f"{name} (F={F_}, Fs={len(stage)}, B={B_}, K={K_})",
                 lambda: other_mac(libs["mac"], ring, bank, rt, idx, ones,
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
        for who, got in (
                ("other tree", other_dual(libs["mac_dual"], ring, bank, rt,
                                          idx, mask, pidx, pmask, t7,
                                          uniform)),
                ("this tree", td.mac_dual(ring, bank, rt, idx, mask, pidx,
                                          pmask, t7, uniform))):
            for a, b in zip(got, refs):
                cs.check(f"mac_dual {label} ({who})", a, b, 7)
        ones = torch.ones(F_, B_, device=dev)
        sel = rt.long()[:1] if uniform else rt.long()
        used = len(set(idx[sel].tolist()) | set(pidx[sel].tolist()))
        nb, nf = cs.dual_bytes_flops(len(stage), B_, K_, used)
        name = "mac_dual_uniform" if uniform else "mac_dual_rows"
        in_turns(f"{name} ({label}: F={F_}, Fs={len(stage)}, B={B_}, "
                 f"K={K_})",
                 lambda: other_dual(libs["mac_dual"], ring, bank, rt, idx,
                                    ones, pidx, ones, t7, uniform),
                 lambda: td.mac_dual(ring, bank, rt, idx, ones, pidx, ones,
                                     t7, uniform),
                 flush, cs.bound(nb, nf)[0])
        del ring, bank, refs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
