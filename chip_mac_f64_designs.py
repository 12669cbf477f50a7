#!/usr/bin/env python3
"""Times the float64 form of the unfused MAC (``bf_mac_f64`` of
``csrc/mac.cu`` on ``csrc/mac_core.cuh``) at several load groups, the
partitions a thread loads before their FMAs, on one CUDA card: the
measurement behind the core's float64 group sizes (``kF64GroupFew`` on a
grid of at most one block an SM, ``kF64Group`` otherwise).

    python3 chip_mac_f64_designs.py

Each variant is ``csrc/mac.cu`` with a copy of ``csrc/mac_core.cuh`` whose
two float64 group constants are both set to G, written to and built with
the port's nvcc flags in ``build/chip_mac_f64_designs/g<G>/``, G in
``GROUPS`` (each replaced line must be found: change the probe with the
core); a double group holds twice a float one's registers, so G = 8, the
float32 form's choice for few blocks, may spill. Prints each variant's
registers and spills (``-Xptxas -v``), then times it at the shapes of
``chip_smoke.py``'s phase 3 (``MAC_SHAPES``) in float64, after holding its
output against the plain float64 version (1e-12 of its peak). Each time
is the median of 20 calls with the L2 cache flushed by a read before each
(``chip_smoke.time_ms``, ``read_flush``), the variants in turns: all of
them, then all again in reverse order. The float64 bound of each shape
(8-byte bytes over 3.35 TB/s) and the method's floor are printed beside.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import chip_smoke as cs

OUT = os.path.join(cs.REPO, "build", "chip_mac_f64_designs")
GROUPS = (1, 2, 4, 8)
# the core's float64 group constants, as csrc/mac_core.cuh states them
CONSTANTS = ("constexpr int kF64GroupFew = 4;", "constexpr int kF64Group = 2;")


def build_variants() -> dict:
    """G -> the loaded ``bf_mac_f64`` of csrc/mac.cu built at group G,
    all variants compiled at once; prints what ptxas said of each."""
    from brutefir_tpu_torch.ops import _build
    core = (_build.CSRC / "mac_core.cuh").read_text()
    jobs = {}
    for g in GROUPS:
        folder = os.path.join(OUT, f"g{g}")
        os.makedirs(folder, exist_ok=True)
        text = core
        for line in CONSTANTS:
            if text.count(line) != 1:
                cs.fail(f"csrc/mac_core.cuh no longer states {line!r}")
            text = text.replace(line, line.rsplit("=", 1)[0] + f"= {g};")
        with open(os.path.join(folder, "mac_core.cuh"), "w") as fh:
            fh.write(text)
        shutil.copy(_build.CSRC / "mac.cu", folder)
        so = os.path.join(folder, "libmac.so")
        jobs[g] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
             os.path.join(folder, "mac.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for g, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"nvcc failed on mac.cu at G = {g}:\n{log[-3000:]}")
        name = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif (name and "mac_kernel" in name and "Id" in name
                  and ("registers" in line or "spill" in line)):
                print(f"  G = {g}: {name[:60]}: {line.strip()}", flush=True)
        fn = ctypes.CDLL(so).bf_mac_f64
        fn.argtypes = _build.SIGNATURES["mac"]["bf_mac_f64"]
        fn.restype = ctypes.c_int
        fns[g] = fn
    return fns


def main():
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this probe needs a card")
    from brutefir_tpu_torch.ops import mac as tm
    print(f"card: {cs.card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    fns = build_variants()
    dev = torch.device("cuda")
    flush = cs.read_flush()
    tiny = torch.zeros(1, device=dev)
    cs.FLOOR_MS = cs.time_ms(lambda: tiny.zero_(), cs.REPS, flush)
    print(f"timing floor (a kernel writing 4 bytes): {cs.FLOOR_MS:.4f} ms",
          flush=True)
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 40)
    for name, _, F_, B_, K_, E_, uniform, stage, _ in cs.MAC_SHAPES:
        ring, bank, idx, _, stage = cs.mac_inputs(g, F_, B_, K_, E_,
                                                  uniform, stage)
        ring, bank = ring.double(), bank.double()
        ones = torch.ones(F_, B_, dtype=torch.float64, device=dev)
        rt = torch.tensor(stage, dtype=torch.int32, device=dev)
        t = torch.tensor(7, dtype=torch.int32, device=dev)
        Fs = len(stage)
        ref = tm.mac_reference(ring, bank, rt, idx, ones, t, uniform)
        outs = {G: torch.empty_like(ref) for G in GROUPS}

        def call(G):
            rc = fns[G](ring.data_ptr(), bank.data_ptr(), rt.data_ptr(),
                        idx.data_ptr(), ones.data_ptr(), t.data_ptr(),
                        outs[G].data_ptr(), F_, Fs, B_, K_, E_,
                        int(uniform), 1,
                        torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                cs.fail(f"bf_mac_f64 at G = {G} refused (cudaError {rc})")

        for G in GROUPS:
            call(G)
            torch.cuda.synchronize()
            rel = ((outs[G] - ref).abs().max() / ref.abs().max()).item()
            if not rel <= 1e-12:
                cs.fail(f"{name} at G = {G}: {rel:.3e} off the plain "
                        f"version")
        times = {G: [] for G in GROUPS}
        for order in (GROUPS, GROUPS[::-1]):
            for G in order:
                times[G].append(cs.time_ms(lambda: call(G), cs.REPS, flush))
        used = 1 if uniform else len(set(idx[rt.long()].tolist()))
        nb, nf = cs.mac_bytes_flops(Fs, B_, K_, 0, used, out_rows=Fs,
                                    real_bytes=8)
        b_ms, by = cs.bound(nb + Fs * 4, nf, cs.FP64_FLOP_PER_S)
        plan = tm.launch_plan(1, Fs, K_, torch.float64)
        print(f"{name}_f64 (F={F_}, Fs={Fs}, B={B_}, K={K_}; the core's "
              f"plan {plan}): " + ", ".join(
                  f"G = {G} {times[G][0]:.4f} / {times[G][1]:.4f} ms"
                  for G in GROUPS)
              + f"; bound {b_ms:.4f} ms ({by}), floor {cs.FLOOR_MS:.4f} ms",
              flush=True)
        del ring, bank, ref, outs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
