#!/usr/bin/env python3
"""Smoke run of brutefir_tpu_torch on one NVIDIA GPU.

Usage (from the repository root, one CUDA card, no arguments):

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. card: prints the card's name and power limit, and requires CUDA;
2. build: compiles every CUDA kernel of the main path with nvcc;
3. kernel vs plain: each kernel form at the flagship shape (26 filters,
   16 partitions, 8192 bins, 26 outputs) against its plain torch version
   on the same CUDA tensors, relative error <= 1e-5 of the output's
   magnitude, and both timed with CUDA events;
4. main path: ``python -m brutefir_tpu_torch``'s ``main()`` on the exact
   examples/multichannel_massive.conf shape (26 x 26, 131072 taps in
   8192 x 16 partitions, S24_4LE), seeded random coefficients and input,
   43.5 blocks; then again with two coefficients (filters 0-12 and
   13-25). Each run must exit 0, write as many frames as it read, stay
   within 16 LSB of a float64 convolution oracle on every channel, and
   launch its kernel form (launch counts are reset just before).

The last lines are the kernel summary JSON, the card line, and
``{"ok": true, "device": {...}}``. The script imports no jax.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
REL_TOL = 1e-5          # kernel vs plain, of the output's max magnitude
LSB_TOL = 16            # main path vs the float64 oracle, S24 LSB
F, B, K, C_OUT, E = 26, 16, 8192, 26, 2   # multichannel_massive.conf
BLOCKS = 43.5           # 5 batches of 8, a 3-block remainder, a half block
REPO = os.path.dirname(os.path.abspath(__file__))
EXAMPLE = os.path.join(REPO, "examples", "multichannel_massive.conf")
WORK = os.path.join(REPO, "build", "chip_smoke")


def fail(msg: str):
    sys.stderr.write(f"chip_smoke: FAIL: {msg}\n")
    sys.exit(1)


def phase(name: str):
    print(f"== {name}", flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, flush) -> float:
    """Median device time of one call, CUDA events around each call, the
    L2 cache flushed before each (a cold caller), after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def kernel_vs_plain(mm):
    """Both forms of the fused MAC + mix at the flagship shape."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED)
    ring = torch.randn(F, B, 2, K, generator=g).to(dev)
    bank = torch.randn(E, B, 2, K, generator=g).to(dev)
    w = torch.randn(C_OUT, F, generator=g).to(dev)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for uniform, name, line in ((True, "mac_mix_uniform", 615),
                                (False, "mac_mix_rows", 582)):
        if uniform:
            idx = torch.full((F,), E - 1, dtype=torch.int32)
            mask = (torch.rand(B, generator=g) > 0.25).float().expand(F, B)
        else:
            idx = (torch.arange(F) % E).to(torch.int32)
            mask = (torch.rand(F, B, generator=g) > 0.25).float()
        mask = mask.contiguous()
        mask[:, -2:] = 0.0                       # cblocks-style zeros
        idx, mask = idx.to(dev), mask.to(dev)
        worst = 0.0
        max_abs = 0.0
        for tv in (0, 5, 15, 16, 37):            # 16 and 37 wrap the ring
            t = torch.tensor(tv, dtype=torch.int32, device=dev)
            got = mm.mac_mix(ring, bank, idx, mask, t, w, uniform)
            ref = mm.mac_mix_reference(ring, bank, idx, mask, t, w, uniform)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"{name}: non-finite kernel output at t={tv}")
            err = (got - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            max_abs = max(max_abs, err)
            worst = max(worst, rel)
        print(f"{name}: max rel err {worst:.3e} (tol {REL_TOL:g}), "
              f"max abs err {max_abs:.3e}", flush=True)
        if not worst <= REL_TOL:
            fail(f"{name}: kernel disagrees with the plain version "
                 f"({worst:.3e} > {REL_TOL:g})")
        t = torch.tensor(7, dtype=torch.int32, device=dev)
        k_ms = time_ms(lambda: mm.mac_mix(ring, bank, idx, mask, t, w,
                                          uniform), 30, flush)
        p_ms = time_ms(lambda: mm.mac_mix_reference(ring, bank, idx, mask,
                                                    t, w, uniform), 30,
                       flush)
        print(f"{name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              "(median of 30, L2 flushed before each)", flush=True)
        rows.append({"name": name, "route": "cuda",
                     "source": "brutefir_tpu_torch/csrc/mac_mix.cu",
                     "replaces": f"brutefir_tpu/ops/pallas_mac.py:{line}",
                     "form": "uniform" if uniform else "rows",
                     "max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms})
    del flush
    return rows


def write_inputs(rng, frames: int):
    """Seeded 131072-tap coefficients (||taps||_2 = 0.5) as TEXT files,
    and an S24_4LE input with std 2^20 (no clipping)."""
    n_taps = K * B
    taps = []
    for k in range(2):
        h = rng.standard_normal(n_taps) * np.exp(-np.arange(n_taps) / 20000.0)
        h = (0.5 * h / np.linalg.norm(h)).astype(np.float32)
        path = os.path.join(WORK, f"taps{k}.txt")
        with open(path, "w") as fh:
            fh.write("\n".join(repr(float(v)) for v in h))
            fh.write("\n")
        taps.append(h.astype(np.float64))
    x = np.clip(np.round(rng.standard_normal((frames, F)) * 2.0 ** 20),
                -(2 ** 23), 2 ** 23 - 1).astype("<i4")
    x.tofile(os.path.join(WORK, "input.raw"))
    return taps, x


def massive_config(name: str, two_coeffs: bool) -> str:
    """examples/multichannel_massive.conf with its paths pointed at the
    generated files; with ``two_coeffs`` filters 13-25 take a second
    coefficient."""
    with open(EXAMPLE) as fh:
        text = fh.read()
    text = text.replace('"correction.txt"',
                        f'"{os.path.join(WORK, "taps0.txt")}"')
    text = text.replace('"input.raw"', f'"{os.path.join(WORK, "input.raw")}"')
    text = text.replace('"output.raw"',
                        f'"{os.path.join(WORK, "output.raw")}"')
    if two_coeffs:
        second = ('coeff "second" {\n    filename: "'
                  + os.path.join(WORK, "taps1.txt")
                  + '";\n    format: "TEXT";\n};\n\ninput ')
        text = text.replace("\ninput ", "\n" + second, 1)
        for f in range(13, 26):
            old = f'to_outputs: {f}; coeff: "correction"; }};'
            if old not in text:
                fail(f"could not retarget filter {f} in the example config")
            text = text.replace(old, old.replace('"correction"', '"second"'))
    path = os.path.join(WORK, name)
    with open(path, "w") as fh:
        fh.write(text)
    return path


def main_path(main, x, taps, two_coeffs: bool):
    """One run of the port's __main__.main on the massive shape (its
    writer thread has fetched every output when main() returns)."""
    from scipy.signal import fftconvolve
    frames = x.shape[0]
    cfg = massive_config("run2.conf" if two_coeffs else "run1.conf",
                         two_coeffs)
    out = os.path.join(WORK, "output.raw")
    if os.path.exists(out):
        os.remove(out)
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = main(["-nodefault", cfg])
    wall = time.perf_counter() - t0
    sys.stderr.write(err.getvalue())
    if rc != 0:
        fail(f"main() exited {rc}")
    y = np.fromfile(out, dtype="<i4")
    if y.size != frames * F:
        fail(f"output has {y.size // F} frames, input {frames}")
    y = y.reshape(frames, F)
    lsb = []
    for c in range(F):
        h = taps[1] if (two_coeffs and c >= 13) else taps[0]
        ref = np.round(fftconvolve(x[:, c].astype(np.float64), h)[:frames])
        lsb.append(int(np.abs(y[:, c].astype(np.int64) - ref).max()))
    audio_s = frames / 44100.0
    label = "two coefficients" if two_coeffs else "shared coefficient"
    engine_line = (err.getvalue().strip().splitlines() or ["-"])[-1]
    print(f"main path ({label}): rc 0, {frames} frames in and out, max "
          f"|y - oracle| {max(lsb)} LSB (tol {LSB_TOL}), end to end "
          f"{wall:.3f} s for {audio_s:.3f} s of audio = "
          f"{audio_s / wall:.2f}x realtime (incl. config parse and bank "
          f"build); engine: {engine_line}", flush=True)
    if max(lsb) > LSB_TOL:
        fail(f"output off the float64 oracle by {max(lsb)} LSB")


def run():
    phase("card")
    # one card: the first visible one, so device_count() below is 1
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is None or "," in visible:
        os.environ["CUDA_VISIBLE_DEVICES"] = (visible or "0").split(",")[0]
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a card")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    phase("build")
    from brutefir_tpu_torch.ops import _build, mac_mix as mm
    from brutefir_tpu_torch.__main__ import main
    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    print(f"built {so.name} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    log = so.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip(), flush=True)

    phase("kernel vs plain")
    rows = kernel_vs_plain(mm)

    phase("main path")
    os.makedirs(WORK, exist_ok=True)
    rng = np.random.default_rng(SEED)
    frames = int(BLOCKS * K)
    taps, x = write_inputs(rng, frames)
    counts = {}
    for two in (False, True):
        form = "rows" if two else "uniform"
        mm.reset_launches()
        main_path(main, x, taps, two)
        counts[form] = mm.launches[form]
        print(f"kernel launches in this run: {form} {counts[form]}",
              flush=True)
        if counts[form] <= 0:
            fail(f"the main path never launched the {form} kernel form")
    shutil.rmtree(WORK, ignore_errors=True)
    if "jax" in sys.modules:
        fail("jax was imported")

    for r in rows:
        r["launches"] = counts[r.pop("form")]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    run()
