#!/usr/bin/env python3
"""Smoke run of brutefir_tpu_torch on one NVIDIA GPU.

Usage (from the repository root, one CUDA card, no arguments):

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. card: prints the card's name and power limit, and requires CUDA;
2. build: compiles every CUDA source with nvcc, one process per source,
   all at once;
3. kernel vs plain: each kernel at the shape its main path gives it
   against its plain torch version on the same CUDA tensors, relative
   error <= 1e-5 of the output's magnitude, at several t (ring wraps
   included), per-filter delays 0 .. G-1 and >= G, and the mask zeros of
   the host's cblocks clamp; then both timed with CUDA events (the L2
   cache flushed before each call by reading a 128 MB buffer, so no
   dirty line is written back inside the timed window; all-ones mask and
   zero delays as the main path has them) beside the byte/operation
   bound and the method's floor, the time of a kernel that writes 4
   bytes, taken once a run the same way:
   - the fused MAC + mix, both forms, at the massive_config shape
     (26 filters, 16 partitions, 8192 bins, 26 outputs);
   - at the 256-channel scale shape (256 x 256, 16 partitions, 8192
     bins, 256 distinct coefficient sets): the bin-tiled fused MAC + mix,
     the grouped MAC at G = 4 and G = 3, the grouped fused MAC + mix at
     G = 2, timed beside two routes to the same result (two launches of
     the tiled kernel; the grouped MAC at G = 2 with the mix outside),
     with its launch plan and ptxas usage; then checked, not timed, at
     G = 3 .. 8 on a reduced shape (256 x 256 at 1024 bins);
4. kernel vs plain, the unfused MAC of the stage loop (``csrc/mac.cu``),
   at the shapes where the JAX package takes each of its four TPU
   variants: bench1's first stage (rows 2-5 of 6 filters, 8192 x 8, per
   filter: "row"), the massive cascade (52 filters, 8192 x 16, one shared
   coefficient: "uniform"), the massive shape's single stage (26 filters,
   the uniform form phase 24 runs), 256 filters of 8192 x 16 with 256 distinct
   rows ("chunked") and 4 filters of 65536 x 8 ("tile"); distinct and
   repeated rows, the same t and mask zeros as phase 3; checked, not
   timed, also where the core (``csrc/mac_core.cuh``) takes its scalar
   path: K % 4 != 0 and a ring view that is not 16-byte aligned; prints
   the kernel's registers and spills a form and each shape's launch plan;
5. kernel vs plain, the crossfade dual MAC (``csrc/mac_dual.cu``), at
   bench5's shape (26 filters of 8192 x 8, one shared row per set), the
   massive shape, 256 filters of 8192 x 16 with 256 new and 256 old
   distinct rows, a stage subset (rows 2-5 of 6, 8192 x 8) and the shape
   where the JAX package falls back to two plain passes (4 filters of
   65536 x 8); both products within 1e-5 relative of the plain version
   over the same t, cblocks mask zeros with the previous mask differing,
   distinct and repeated rows; timed beside two ``mac`` calls, with the
   wrapper's host time a call beside the spin that hides it; checked, not
   timed, at phase 4's K % 4 != 0 and unaligned shapes;
6. kernel vs plain, the FFT glue (``csrc/fft_glue.cu``, TPU kernel 11):
   both directions at C = 26 and 256 channels, M = 8192 packed bins,
   within 1e-5 relative of the plain version, timed beside yardsticks
   of the timing method (a kernel writing 4 bytes, a clone of the input,
   cuFFT's fft alone and followed by a 4-byte kernel); then the routes
   they serve (the port's only transforms: cuFFT's M-point complex FFT
   around the glue) within 1e-5 of the library call for the same
   transform (``torch.fft.rfft``, ``torch.fft.irfft``) and timed beside it;
6b. the float64 forms (``float_bits: 64``): the unfused MAC's
   (``bf_mac_f64``) at phase 4's shapes and, checked not timed, its
   scalar-path shapes; the glue's (``bf_glue_fwd_f64`` /
   ``bf_glue_inv_f64``) at C = 26 and 256, M = 8192; each within 1e-12
   relative of its plain float64 version on the same CUDA tensors, timed
   as above beside its float64 bound (8-byte bytes over 3.35 TB/s, FP64
   operations over 34 TFLOP/s), the float64 routes beside
   ``torch.fft.rfft`` / ``irfft`` on float64;
7. the fused real FFT's probe path (``csrc/fft_fused.cu``, TPU kernel 12;
   tools/fused_fft_probe.py's comparison): frame -> digit-permuted planes
   and permuted planes -> valid half at C = 26 and 256, M = 8192, one
   launch each a shape; each within 1e-5 relative of its plain version
   (the same four-step stages in torch) and of the port's transforms after
   ``bin_order``, timed beside them and the library call; each kernel's
   cluster size, registers and shared memory a block printed;
8. main path, massive: ``python -m brutefir_tpu_torch``'s ``main()`` on
   the exact examples/multichannel_massive.conf shape (26 x 26, 131072
   taps in 8192 x 16 partitions, S24_4LE), seeded random coefficients and
   input, 19.5 blocks; then with two coefficients (filters 0-12 and
   13-25);
9. main path, scale: ``main()`` on the 256 x 256 x 131072-tap shape of
   tools/mac_step_compare.py (alldistinct, 256 channels) with 256 seeded
   coefficient sets as RAW float32 files and 19.5 blocks of S24_4LE
   input (2 batches of 8, a 3-block tail, a half block): with the
   default BRUTEFIR_TPU_PAIR (the batches in groups of 4 through the
   grouped MAC, the tail through the tiled kernel), then with
   BRUTEFIR_TPU_PAIR=2 (groups of 2 through the grouped
   fused MAC + mix);
10. main path, bench1 cascade: ``main()`` on the reference's bench1_config
   graph (2 inputs -> 4 filters -> 2 filters -> 2 outputs, 8192 x 8
   partitions) with six seeded 65536-tap coefficient sets as RAW float32
   files and 19.5 blocks of S24_4LE input, held to 2e-5 of the output's
   peak + 4 LSB of the float64 oracle ``conv(conv(x0, h2) + conv(x1, h5),
   h0)``, ``conv(conv(x0, h3) + conv(x1, h4), h1)``; two unfused MAC
   launches a block;
11. main path, massive cascade: the massive shape with a second stage (26
   filters from the inputs, each feeding one of 26 filters to the
   outputs, all on the one shared coefficient), within 16 LSB of
   ``conv(conv(x, h), h)``; two launches a block of the uniform form;
12. main path, bench5: ``main()`` on the reference's bench5_config graph
   (26 crossfading filters, 8192 x 8 partitions) with two seeded
   65536-tap sets as RAW float32 files and a CLI script that flips every
   filter's coefficient every block, 19.5 blocks through the per-block
   ``run()`` (``run_offline``'s fallback for logic modules), within
   8e-6 of the output's peak + 4 LSB of the float64 linear-ramp oracle on
   channels 0, 5, ..., 25; one dual MAC launch a block after block 0;
13. main path, massive with a swap every 64 blocks: the massive shape,
   every filter crossfading between two sets under the script
   ``cfc .. 1; sleep b63`` / ``cfc .. 0; sleep b63``, 130.5 blocks,
   within 16 LSB of the piecewise-ramped float64 oracle on seven
   channels; three dual MAC launches, the fused MAC + mix elsewhere;
14. offline split: the massive shape with crossfading filters and no
   logic module, through ``Engine`` directly: ``run_offline(max_blocks=
   16)``, a swap on every filter, ``run_offline()`` for the remaining
   11.5 blocks (a batch split at the crossfade block, then the EOF tail);
   exactly one dual MAC launch, block 16 ramped, within 16 LSB;
15. main path, bench1 cascade with a crossfading first stage: phase 10's
   graph and inputs with filters 2-5 ``crossfade: true`` and a CLI script
   that swaps their sets on every third block (all four on block 0, then
   filters 2 and 3), 19.5 blocks through ``run()``, within 2e-5 of the
   output's peak + 4 LSB of the float64 oracle whose first-stage outputs
   ramp over each swap block; the per-filter dual MAC on the 7 swap
   blocks' first stage, the unfused MAC on every other stage;
16. main path, the massive shape time-aligned and dithered: phase 8's
   shared-coefficient config with dithered S24_LE (3-byte) outputs,
   output channel c delayed 37 c samples (maxdelay 2048), sdf_length 32
   and output subdelays spread over -99 .. 99 on channels 0-12 (13-25
   undefined: the sdf_length latency), 19.5 blocks through ``main()``,
   within 16 LSB of the float64 oracle (convolution, subdelay FIR,
   integer shift) with the error's RMS in 0.5 .. 2 LSB (dithered; plain
   rounding gives 0.29); the fused MAC + mix once a block; the dither
   table's host time (under 2 s); the dither on the card bit-equal to
   the CPU's on the same inputs; the device time of the output half
   with and without subdelay, delay and dither, and of each step;
17. main path, examples/crossover_2way.conf (two coefficient sets,
   4096 x 4, delays 0, 0, 90, 90, dithered S24_LE) with ``maxdelay:
   512`` and a CLI script that raises output 2's delay to 300 at block 8
   and lowers output 3's to 20 at block 12, seeded taps and FLOAT_LE
   input, 19.5 blocks through ``run()``, within 16 LSB of the oracle
   whose delay lines follow the same changes; the per-filter fused MAC
   + mix once a block;
18. main path, examples/xtc_lowlatency.conf as shipped (64 x 64, four
   filters in a 2 x 2 lattice, dithered S24_LE), two seconds of seeded
   FLOAT_LE input, within 16 LSB of the oracle; the unfused MAC of the
   stage loop once a block; first the MAC's plan and kernel and the glue
   kernels at K = M = 64 against their plain versions;
19. main path, the massive shape under ``benchmark: true;``: 40.5 blocks
   through ``main()``, which takes the per-block ``run()``, within 16 LSB
   of the oracle; the stage table printed once every 10 periods (4
   lines); then the same run under BRUTEFIR_TPU_STAGE_BREAKDOWN=1, bit-
   equal, with the stage probe's calibration line naming its five stages
   and its launches of the unfused MAC and the glue counted exactly
   (``runtime/stageprobe.py``: 1 + CALLS x REPS each); then ``debug:
   true;`` on the first 19.5 blocks of the input: bit-equal to the
   benchmark run over its full blocks (its half block within 1 LSB),
   its timeline one call/ret pair a period for input, filter and output;
20. main path, examples/room_correction_eq.conf as shipped (2 channels,
   8192 x 8, FLOAT_LE, 48 kHz, a CLI on a Unix socket and the EQ on
   sets 0 and 1), its socket under build/chip_smoke: ``lmc eq 0 info``
   and ``lmc eq 0 mag 63/3,1000/0,8000/-2`` over the socket, the host ms
   of three EQ commands (render, preprocess, bank update), then 19.5
   blocks of seeded input through ``Engine.run``; then a variant with a
   CLI script changing the EQ at block 8 through ``main()``; each within
   2e-5 of the output's peak of the float64 oracle (the port's rendered
   impulses, switching at block 8); the fused MAC + mix's uniform form
   once a block; last, the host ms of three EQ commands at the scale
   shape's bank (257 sets of 8192 x 16, 269 MB);
21. main path, the host codec: phase 8's shared-coefficient massive
   config with S24_BE (3-byte big-endian) input and output, 19.5 blocks
   through ``main()`` (``run_offline`` falls back to ``run()`` on the
   host path), within 16 LSB of the float64 oracle; the fused MAC + mix
   once a block, the native C++ codec (``core/native``) built and called
   once a block each way (its call counts reset and read); then the same
   samples as S24_LE through the device-IO path block by block
   (``Engine.run``): within 1 LSB of the host path's output, the share
   of equal words printed;
22. main path, the host codec time-aligned and dithered: phase 16's
   config and input with S24_BE outputs (the host delay lines, subsample
   delays and the native dither, 26 calls a block), within 5 LSB of
   phase 16's oracle with the error's RMS in the dither band; the share
   of words equal to phase 16's output printed (the host and device
   subdelays round differently) and the host ms a block of
   ``write_block``;
23. main path, 8-byte floats: examples/crossover_2way.conf with a
   FLOAT_BE input and FLOAT64_LE outputs through ``main()``, within 2e-5
   of the output's peak of the float64 oracle; the per-filter fused MAC
   + mix once a block;
24. main path, a spectral logic module: phase 8's shared-coefficient
   massive config with ``modules_path`` and the external module
   ``bflogic_spectap.py`` (written to build/chip_smoke/mods), whose six
   hooks each scale their buffer by a seeded gain (0.5 .. 1.5) of its
   channel or filter, 40.5 blocks of input at std 2^18 through
   ``main()``: within 16 LSB of the float64 oracle scaled by each path's
   product of gains; ``Engine.dio`` None (the host codec path); the
   unfused MAC's uniform form (``mac_uniform``) and each glue kernel
   once a block, the fused MAC + mix never; every hook 26 times a block;
   ``input_freqd``'s copy of channel 0 at block 3 within 1e-5 of the
   peak of ``np.fft.rfft`` of the float64 frame [prev, x] with
   ``input_timed``'s gain; the host ms a block of the taps' transfers
   (``engine._spectra_to_host`` / ``_spectra_to_device``) and of the
   hook calls beside the wall; then the same graph and input without
   the module through ``main()`` (``run_offline``), for comparison;
25. main path, crossfade under hooks: bench5 (phase 11) with a second
   module ``bflogic_xfgain.py`` whose ``post_convolve`` scales each
   filter by a seeded gain: the stage loop's dual MAC on every block
   after the first, ``crossfade_spectra``'s extra forward and two
   inverse glue launches on each crossfade block, the fused time-domain
   crossfade never; within 8e-6 of the peak + 4 LSB of the ramp oracle
   scaled by the gains;
26-28. main path, clocked devices, in a child process of their own
   (``chip_smoke.py --clocked-child``: a clocked engine asks for
   SCHED_FIFO and mlockall, which must not reach the other phases; its
   last line is one JSON object of results and launch counts, which the
   parent adds to the rows' launches). Each runs ``Engine`` through its
   parts (``attach_logic``, ``setup()`` with the warm-up, ``run(setup=
   False)``, ``teardown()``), so the warm-up's launches and the blocks'
   are counted apart, and prints the block wall (p50, p95; the input's
   wait included, as the rti reads it), the processing time (the wall
   less the input read), ``rti_max`` and what the realtime request got
   (``Engine.realtime_state``). The paced device is the module
   ``bfio_paced.py`` (``PACED_MODULE``, written to build/chip_smoke/mods):
   an input hands out fragment k at t0 + (k + 1) N / fs, an output
   records each write's lateness against the time a card starts playing
   it, the two silent fragments of the iodelay fill counted.
   26: examples/multichannel_massive.conf with both devices on the paced
   device, 32 blocks (5.9 s of audio): the first 2N frames silent, the
   rest within 16 LSB of the float64 oracle, no missed deadline, the
   uniform fused MAC + mix and the glue once a block (the warm-up runs
   both forms); 27: examples/xtc_lowlatency.conf with both devices on
   ``alsa`` over tests/fake_asound.c (compiled with gcc into
   build/chip_smoke), 400 blocks, its capture pattern read as S16_LE (the
   byte (f + c) & 0xFF in the low byte: finite words), the example's
   dithered S24_LE output dumped by the fake: 2N silent frames, then
   within 16 LSB of the pattern's float64 oracle, ``mac_rows`` and the
   glue once a block; 28: the xtc example on the paced device, 2000
   blocks (2.9 s): the same gates as 27, the deadline misses printed and
   not gated (the step's eager dispatch outlasts the 1.451 ms period);
29. main path, ``float_bits: 64``: phase 8's shared-coefficient massive
   config and input in float64 through ``main()``: the stage loop's
   float64 MAC (``mac_uniform_f64``) and one float64 glue each way a
   block, no float32 kernel; every S24 word the rounding of the float64
   oracle (within 0.5 + 1e-6 LSB of it), phase 8's float32 error printed
   beside;
30. main path, phase 15's crossfading bench1 cascade in float64 with
   FLOAT64_LE files (the host codec path): ``mac_rows_f64`` twice a
   block and once more on each swap block's first stage (its old set),
   the float64 glue as phase 15 counts the float32 one; within 1e-10 of
   the peak of the float64 crossfade oracle, phase 15's error beside;
31. main path, bench5 (phase 12) in float64 through ``run()``: the
   stage loop's float64 MAC on block 0, then on every crossfade block
   the fused time-domain crossfade with two ``mac_uniform_f64``
   launches, the dual MAC never; every word on channels 0, 5, ..., 25 the
   ramp oracle's rounding, phase 12's error beside.

Each main-path run must exit 0, write as many frames as it read, stay
within its bound of a float64 convolution oracle on every channel, and
launch its kernels the expected number of times (launch counts are set
to 0 just before each run). Every run launches the glue kernels: a
single stage one forward and one inverse a block, a two-stage cascade
two of each (the input, ``convolve_eval`` both ways, the output), and
``crossfade_spectra`` one forward and two full inverses more on each
crossfade block of a cascade. No module of jax or of the JAX package
may be loaded at the end.

The last lines are the kernel summary JSON, the card line, and
``{"ok": true, "device": {...}}``. The script imports no jax and nothing
of the JAX package.
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
REL_TOL_F64 = 1e-12     # a float64 form vs its plain float64 version
WORD_GATE = 0.5 + 1e-6  # float64 S24 words: |word - oracle|, its rounding
FLOAT64_TOL = 1e-10     # float64 FLOAT64_LE outputs, of the oracle's peak
LSB_TOL = 16            # main path vs the float64 oracle, S24 LSB
F, B, K, C_OUT, E = 26, 16, 8192, 26, 2   # multichannel_massive.conf
SCALE_C = 256           # the scale shape: 256 x 256, one set per filter
BENCH5_N, BENCH5_B, BENCH5_C = 8192, 8, 26     # the reference's bench5
BLOCKS = 19.5           # 2 batches of 8, a 3-block tail, a half block
REPS = 20               # timed calls per kernel and plain version
SPIN_CYCLES = 2_000_000  # about 1 ms of the card's clock before each call
# one H100 SXM (NVIDIA's data sheet): device memory rate and the FP32
# and FP64 rates outside the tensor cores, for the bound of each kernel
MEM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 34e12
REPO = os.path.dirname(os.path.abspath(__file__))
EXAMPLE = os.path.join(REPO, "examples", "multichannel_massive.conf")
WORK = os.path.join(REPO, "build", "chip_smoke")
PALLAS = "brutefir_tpu/ops/pallas_mac.py"
GLUE_SRC = "brutefir_tpu/ops/pallas_glue.py"
FUSED_SRC = "brutefir_tpu/ops/pallas_fft.py"


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


def read_flush():
    """A callable that empties the 50 MB L2 cache by reading a 128 MB
    buffer (a sum into one float): the dirty lines of earlier calls are
    written back during the read, so none is left for a timed kernel to
    write back."""
    import torch
    buf = torch.ones(32 << 20, dtype=torch.float32, device="cuda")
    return buf.sum


def time_ms(fn, reps: int, flush, spin: int = SPIN_CYCLES) -> float:
    """Median device time of one call, CUDA events around each call, the
    L2 cache flushed before each (a cold caller) by the callable
    ``flush`` (``read_flush()``), after a warm-up. A spin kernel of
    ``spin`` clock cycles queued after the flush keeps the card busy
    while the host enqueues the first event and the call, so the
    wrapper's host overhead (tens of us, more when the host is busy) is
    not timed as device time of a short kernel; a call of many launches
    needs a longer spin."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(spin)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def bound(n_bytes: float, n_flop: float, flop_rate: float = FP32_FLOP_PER_S):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their rate (``flop_rate``: FP32 by default,
    FP64_FLOP_PER_S for a float64 form)."""
    b = n_bytes / MEM_BYTES_PER_S * 1e3
    o = n_flop / flop_rate * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def cblocks_mask(delay, B_):
    """[F, B] mask as the host's cblocks clamp makes it: partitions
    >= B - delay[f] are zero."""
    import torch
    return (torch.arange(B_, device=delay.device)[None, :]
            < (B_ - delay)[:, None]).float().contiguous()


def check(name, got, ref, t, tol: float = REL_TOL):
    """Max relative error of ``got`` against ``ref`` (of ref's max
    magnitude) and max abs error; fails past ``tol``, and where the
    kernel's dtype is not the plain version's."""
    import torch
    torch.cuda.synchronize()
    if got.dtype != ref.dtype:
        fail(f"{name}: kernel gave {got.dtype}, the plain version "
             f"{ref.dtype}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output at t={t}")
    err = (got - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    if not rel <= tol:
        fail(f"{name}: kernel disagrees with the plain version at t={t} "
             f"({rel:.3e} > {tol:g})")
    return rel, err


# the timing method's floor: a kernel that writes 4 bytes, timed by
# time_ms once a run (set in run())
FLOOR_MS = None


def report(rows, name, source, line, worst, max_abs, k_ms, p_ms, n_bytes,
           n_flop, launches_key, note="", pallas=PALLAS, lib_ms=None,
           f64=False):
    """Print one kernel's figures beside its bound and the method's floor;
    with a ``launches_key``, add its row to the kernels summary
    (``lib_ms``: one PyTorch call computing the same function, or None;
    ``f64``: a float64 form, held to REL_TOL_F64, its operations bound by
    the FP64 rate)."""
    b_ms, by = bound(n_bytes, n_flop,
                     FP64_FLOP_PER_S if f64 else FP32_FLOP_PER_S)
    tol = REL_TOL_F64 if f64 else REL_TOL
    lib = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
    print(f"{name}{note}: max rel err {worst:.3e} (tol {tol:g}), max "
          f"abs err {max_abs:.3e}; kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms{lib}, bound {b_ms:.4f} ms ({by}: "
          f"{n_bytes / 1e6:.1f} MB, {n_flop / 1e9:.4f} GFLOP), floor "
          f"{FLOOR_MS:.4f} ms; median of {REPS}, L2 flushed by a read "
          f"before each", flush=True)
    if launches_key is not None:
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": f"{pallas}:{line}",
                     "launches_key": launches_key, "max_abs_err": max_abs,
                     "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": by, "library_ms": lib_ms,
                     "floor_ms": FLOOR_MS})


def mac_bytes_flops(F_, B_, K_, C, rows_used, G=1, out_rows=None,
                    real_bytes=4):
    """Bytes a MAC kernel must move (each input once, each output once)
    and its operations: ring, the bank rows it uses, G-1 xnews blocks,
    the small controls, and G outputs of ``out_rows`` rows; a complex
    multiply-add (8 operations) per filter, partition, bin and block, and
    a real mix (4 a bin: two planes, multiply and add) per output, filter
    and block when C > 0. ``real_bytes``: 4 (float32), 8 (float64)."""
    plane = 2 * K_ * real_bytes
    n_bytes = (F_ * B_ * plane + rows_used * B_ * plane
               + (G - 1) * F_ * plane
               + F_ * 4 + F_ * B_ * real_bytes + 4 + F_ * 4 * (G > 1)
               + C * F_ * real_bytes
               + G * (out_rows if out_rows is not None else C) * plane)
    n_flop = G * (F_ * B_ * K_ * 8 + C * F_ * K_ * 4)
    return n_bytes, n_flop


def kernels_massive(mm, rows, flush):
    """Both forms of the fused MAC + mix at the massive_config shape."""
    import torch
    dev = torch.device("cuda")
    print_ptxas("mac_mix", ("mac_mix_kernel",),
                "one instance a bank placement and alignment")
    for uniform in (True, False):
        print(f"  plan, {'uniform' if uniform else 'per-filter'} form: "
              f"{mm.plan(F, B, K, C_OUT, uniform)}", flush=True)
    g = torch.Generator().manual_seed(SEED)
    ring = torch.randn(F, B, 2, K, generator=g).to(dev)
    bank = torch.randn(E, B, 2, K, generator=g).to(dev)
    w = torch.randn(C_OUT, F, generator=g).to(dev)
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
        worst = max_abs = 0.0
        for tv in (0, 5, 15, 16, 37):            # 16 and 37 wrap the ring
            t = torch.tensor(tv, dtype=torch.int32, device=dev)
            rel, err = check(name, mm.mac_mix(ring, bank, idx, mask, t, w,
                                              uniform),
                             mm.mac_mix_reference(ring, bank, idx, mask, t,
                                                  w, uniform), tv)
            worst, max_abs = max(worst, rel), max(max_abs, err)
        ones = torch.ones(F, B, device=dev)
        t = torch.tensor(7, dtype=torch.int32, device=dev)
        k_ms = time_ms(lambda: mm.mac_mix(ring, bank, idx, ones, t, w,
                                          uniform), REPS, flush)
        p_ms = time_ms(lambda: mm.mac_mix_reference(ring, bank, idx, ones,
                                                    t, w, uniform), REPS,
                       flush)
        nb, nf = mac_bytes_flops(F, B, K, C_OUT, 1 if uniform else E)
        report(rows, name, "brutefir_tpu_torch/csrc/mac_mix.cu", line,
               worst, max_abs, k_ms, p_ms, nb, nf,
               ("mac_mix", "uniform" if uniform else "rows"))


def kernels_scale(mm, mg, rows, flush):
    """The bin-tiled fused MAC + mix and the grouped MACs at the scale
    shape, with 256 distinct bank rows."""
    import torch
    dev = torch.device("cuda")
    Fs = Cs = Es = SCALE_C
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    ring = torch.randn(Fs, B, 2, K, generator=g, device=dev)
    bank = torch.randn(Es, B, 2, K, generator=g, device=dev)
    w = torch.randn(Cs, Fs, generator=g, device=dev) / 16.0
    idx = torch.randperm(Fs, generator=g, device=dev).to(torch.int32)
    ones = torch.ones(Fs, B, device=dev)
    zeros = torch.zeros(Fs, dtype=torch.int32, device=dev)
    t7 = torch.tensor(7, dtype=torch.int32, device=dev)
    ts = (0, 5, B - 1, B, 37)                    # B - 1: groups wrap

    if not mm.tiled_route(Cs, B, K):
        fail("the scale shape does not take the tiled route")
    worst = max_abs = 0.0
    delay = torch.arange(Fs, device=dev, dtype=torch.int32) % 6
    mask = cblocks_mask(delay, B)
    for tv in ts:
        t = torch.tensor(tv, dtype=torch.int32, device=dev)
        rel, err = check("mac_mix_tiled",
                         mm.mac_mix(ring, bank, idx, mask, t, w, False),
                         mm.mac_mix_reference(ring, bank, idx, mask, t, w,
                                              False), tv)
        worst, max_abs = max(worst, rel), max(max_abs, err)
    k_ms = time_ms(lambda: mm.mac_mix(ring, bank, idx, ones, t7, w, False),
                   REPS, flush)
    p_ms = time_ms(lambda: mm.mac_mix_reference(ring, bank, idx, ones, t7,
                                                w, False), REPS, flush)
    nb, nf = mac_bytes_flops(Fs, B, K, Cs, Es)
    report(rows, "mac_mix_tiled", "brutefir_tpu_torch/csrc/mac_mix_tiled.cu",
           665, worst, max_abs, k_ms, p_ms, nb, nf, ("mac_mix", "tiled"))

    for G, fused in ((4, False), (3, False), (2, True)):
        name = "mac_mix_group" if fused else "mac_group"
        xnews = torch.randn(Fs, G - 1, 2, K, generator=g, device=dev)
        # delays 0 .. G+1: in-group, at G-1 and past the group
        delay = (torch.arange(Fs, device=dev, dtype=torch.int32)
                 % (G + 2)).to(torch.int32)
        mask = cblocks_mask(delay, B)
        worst = max_abs = 0.0
        for tv in ts:
            t = torch.tensor(tv, dtype=torch.int32, device=dev)
            if fused:
                got = mg.mac_mix_group(ring, xnews, bank, idx, mask, t, w,
                                       delay)
                ref = mg.mac_mix_group_reference(ring, xnews, bank, idx,
                                                 mask, t, w, delay)
            else:
                got = mg.mac_group(ring, xnews, bank, idx, mask, t, delay)
                ref = mg.mac_group_reference(ring, xnews, bank, idx, mask,
                                             t, delay)
            rel, err = check(f"{name} G={G}", got, ref, tv)
            worst, max_abs = max(worst, rel), max(max_abs, err)
            del got, ref
        if fused:
            k_ms = time_ms(lambda: mg.mac_mix_group(
                ring, xnews, bank, idx, ones, t7, w, zeros), REPS, flush)
            p_ms = time_ms(lambda: mg.mac_mix_group_reference(
                ring, xnews, bank, idx, ones, t7, w, zeros), REPS, flush)
            nb, nf = mac_bytes_flops(Fs, B, K, Cs, Es, G)
        else:
            k_ms = time_ms(lambda: mg.mac_group(
                ring, xnews, bank, idx, ones, t7, zeros), REPS, flush)
            p_ms = time_ms(lambda: mg.mac_group_reference(
                ring, xnews, bank, idx, ones, t7, zeros), REPS, flush)
            nb, nf = mac_bytes_flops(Fs, B, K, 0, Es, G, out_rows=Fs)
        # kernel 4 enters the summary at G = 4, the main path's group
        key = (("mac_group", "mix_group") if fused else
               ("mac_group", "group") if G == 4 else None)
        report(rows, name, "brutefir_tpu_torch/csrc/mac_group.cu",
               768 if fused else 956, worst, max_abs, k_ms, p_ms, nb, nf,
               key, note=f" G={G}")
        if fused:
            mix_group_yardsticks(mm, mg, ring, xnews, bank, idx, ones, w,
                                 zeros, flush)
        del xnews
        torch.cuda.empty_cache()
    mix_group_wider(mg, g)


def mix_group_yardsticks(mm, mg, ring, xnews, bank, idx, ones, w, zeros,
                         flush):
    """Two routes beside bf_mac_mix_group at G = 2 (no single PyTorch call
    computes its function): two launches of the per-block tiled kernel
    (row 3, reading ring and bank twice), and the unfused route of
    BRUTEFIR_TPU_GROUP_FORM=unfused (bf_mac_group at G = 2, then the
    FP32 output mix per block, ``partconv.complex_mix``); the latter held
    against the plain version first. Prints the kernel's launch plan and
    ptxas usage."""
    import torch
    from brutefir_tpu_torch.ops.partconv import complex_mix
    dev = torch.device("cuda")
    G = xnews.shape[1] + 1
    t7 = torch.tensor(7, dtype=torch.int32, device=dev)
    t8 = torch.tensor(8, dtype=torch.int32, device=dev)

    def unfused():
        ys = mg.mac_group(ring, xnews, bank, idx, ones, t7, zeros)
        return torch.stack([complex_mix(w, y) for y in ys])
    rel, _ = check(f"the unfused route G={G}", unfused(),
                   mg.mac_mix_group_reference(ring, xnews, bank, idx, ones,
                                              t7, w, zeros), 7)
    two = time_ms(lambda: (mm.mac_mix(ring, bank, idx, ones, t7, w, False),
                           mm.mac_mix(ring, bank, idx, ones, t8, w, False)),
                  REPS, flush)
    unf = time_ms(unfused, REPS, flush)
    print(f"  yardsticks at G={G}: two launches of mac_mix_tiled {two:.4f} "
          f"ms; the unfused route (mac_group G={G} + {G} complex_mix) "
          f"{unf:.4f} ms (max rel err {rel:.3e}); median of {REPS}, L2 "
          f"flushed by a read before each", flush=True)
    print_ptxas("mac_group", ("mac_mix_group_kernel",),
                "one instance a G and alignment")
    print(f"  launch plan at C_out={w.shape[0]}: "
          f"{mg.mix_group_plan(G, w.shape[0])}", flush=True)


def mix_group_wider(mg, g):
    """bf_mac_mix_group at G = 3 .. 8 against its plain version on a
    reduced scale shape (C_out = F = E = 256, B = 16, K = 1024): the same
    t values, delays 0 .. G+1 and cblocks mask as at G = 2."""
    import torch
    dev = torch.device("cuda")
    Fs = Cs = Es = SCALE_C
    Kr = 1024
    ring = torch.randn(Fs, B, 2, Kr, generator=g, device=dev)
    bank = torch.randn(Es, B, 2, Kr, generator=g, device=dev)
    w = torch.randn(Cs, Fs, generator=g, device=dev) / 16.0
    idx = torch.randperm(Fs, generator=g, device=dev).to(torch.int32)
    for G in range(3, mg.MAX_GROUP + 1):
        xnews = torch.randn(Fs, G - 1, 2, Kr, generator=g, device=dev)
        delay = (torch.arange(Fs, device=dev, dtype=torch.int32)
                 % (G + 2)).to(torch.int32)
        mask = cblocks_mask(delay, B)
        worst = 0.0
        for tv in (0, 5, B - 1, B, 37):
            t = torch.tensor(tv, dtype=torch.int32, device=dev)
            rel, _ = check(f"mac_mix_group G={G} (K={Kr})",
                           mg.mac_mix_group(ring, xnews, bank, idx, mask, t,
                                            w, delay),
                           mg.mac_mix_group_reference(ring, xnews, bank, idx,
                                                      mask, t, w, delay), tv)
            worst = max(worst, rel)
        print(f"mac_mix_group G={G} (C_out = F = E = {Fs}, B={B}, K={Kr}): "
              f"max rel err {worst:.3e} (tol {REL_TOL:g}) over 5 t; plan "
              f"{mg.mix_group_plan(G, Cs)}", flush=True)


# the unfused MAC at the shape of each TPU variant it replaces: (name, TPU
# kernel line, F, B, K, E, uniform, stage rows or None for all F rows
# permuted, repeated rows)
MAC_SHAPES = (
    ("mac_rows", 102, 6, 8, K, 7, False, [2, 3, 4, 5], [5, 2, 2, 3]),
    ("mac_uniform", 149, 2 * F, B, K, 1, True, list(range(2 * F)),
     list(range(F, 2 * F)) + [0, 0]),
    ("mac_uniform_single_stage", 149, F, B, K, 1, True, list(range(F)),
     list(range(13, F)) + [0, 0]),
    ("mac_rows_chunked_shape", 318, SCALE_C, B, K, SCALE_C, False, None,
     [7] * 8),
    ("mac_rows_tile_shape", 79, 4, 8, 65536, 4, False, [0, 1, 2, 3],
     [3, 3, 0]),
)
# where csrc/mac_core.cuh takes its scalar path, checked in both forms:
# (label, F, B, K, E, stage rows, ring offset in floats)
MAC_EDGES = (
    ("K % 4 != 0", 6, 8, K + 2, 7, [2, 3, 4, 5], 0),
    ("a ring view not 16-byte aligned", 2 * F, B, K, 2,
     list(range(2 * F)), 1),
)


def mac_inputs(g, F_, B_, K_, E_, uniform, stage):
    """Seeded ring, bank, coefficient indices and cblocks mask of a MAC
    shape on the card, and the stage rows (all F rows permuted for
    None)."""
    import torch
    dev = torch.device("cuda")
    ring = torch.randn(F_, B_, 2, K_, generator=g, device=dev)
    bank = torch.randn(E_, B_, 2, K_, generator=g, device=dev)
    if uniform:
        idx = torch.full((F_,), E_ - 1, dtype=torch.int32, device=dev)
        delay = torch.full((F_,), 2, dtype=torch.int32, device=dev)
    else:
        idx = torch.randperm(F_, generator=g, device=dev).remainder(
            E_).to(torch.int32)
        delay = torch.arange(F_, device=dev, dtype=torch.int32) % 3
    if stage is None:
        stage = torch.randperm(F_, generator=g, device=dev).tolist()
    return ring, bank, idx, cblocks_mask(delay, B_), stage


def at_offset(x, offset: int):
    """``x`` as a contiguous tensor ``offset`` floats into a larger buffer
    (offset 1: its runs are not 16-byte aligned)."""
    import torch
    buf = torch.zeros(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


def print_mac_core(tm) -> None:
    """Registers and spills of every instance of csrc/mac.cu's and
    csrc/mac_dual.cu's kernel (``-Xptxas -v``), and the launch plan of
    each shape phases 4 and 5 time (csrc/mac_core.cuh's ``plan``)."""
    for stem in ("mac", "mac_dual"):
        print_ptxas(stem, ("mac_kernel",), "one instance a load group and "
                    "with and without 16-byte loads; no shared memory")
    for sets, shapes in ((1, MAC_SHAPES), (2, DUAL_SHAPES)):
        for shape in shapes:
            name, F_, K_, stage = ((shape[0], shape[2], shape[4], shape[7])
                                   if sets == 1 else
                                   (shape[0], shape[1], shape[3], shape[6]))
            Fs = F_ if stage is None else len(stage)
            print(f"  plan, {'mac' if sets == 1 else 'mac_dual'} {name} "
                  f"(Fs={Fs}, K={K_}): {tm.launch_plan(sets, Fs, K_)}",
                  flush=True)


def kernels_mac(tm, rows, flush):
    """The unfused MAC (csrc/mac.cu) at the shape of each TPU variant it
    replaces (MAC_SHAPES), then checked at MAC_EDGES."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    print_mac_core(tm)
    for name, line, F_, B_, K_, E_, uniform, stage, repeated in MAC_SHAPES:
        ring, bank, idx, mask, stage = mac_inputs(g, F_, B_, K_, E_, uniform,
                                                  stage)
        worst = max_abs = 0.0
        for r in (stage, repeated):
            rt = torch.tensor(r, dtype=torch.int32, device=dev)
            for tv in (0, 5, B_ - 1, B_, 2 * B_ + 5):
                t = torch.tensor(tv, dtype=torch.int32, device=dev)
                rel, err = check(name, tm.mac(ring, bank, rt, idx, mask, t,
                                              uniform),
                                 tm.mac_reference(ring, bank, rt, idx, mask,
                                                  t, uniform), tv)
                worst, max_abs = max(worst, rel), max(max_abs, err)
        rt = torch.tensor(stage, dtype=torch.int32, device=dev)
        ones = torch.ones(F_, B_, device=dev)
        t7 = torch.tensor(7, dtype=torch.int32, device=dev)
        k_ms = time_ms(lambda: tm.mac(ring, bank, rt, idx, ones, t7,
                                      uniform), REPS, flush)
        p_ms = time_ms(lambda: tm.mac_reference(ring, bank, rt, idx, ones,
                                                t7, uniform), REPS, flush)
        Fs = len(stage)
        used = 1 if uniform else len(set(idx[rt.long()].tolist()))
        nb, nf = mac_bytes_flops(Fs, B_, K_, 0, used, out_rows=Fs)
        report(rows, name, "brutefir_tpu_torch/csrc/mac.cu", line, worst,
               max_abs, k_ms, p_ms, nb + Fs * 4, nf,
               ("mac", "mac_uniform" if uniform else "mac_rows"),
               note=f" (F={F_}, Fs={Fs}, B={B_}, K={K_})")
        del ring, bank
        torch.cuda.empty_cache()
    for label, F_, B_, K_, E_, stage, offset in MAC_EDGES:
        for uniform in (True, False):
            name = "mac_uniform" if uniform else "mac_rows"
            ring, bank, idx, mask, _ = mac_inputs(g, F_, B_, K_, E_, uniform,
                                                  stage)
            ring = at_offset(ring, offset)
            rt = torch.tensor(stage, dtype=torch.int32, device=dev)
            worst = 0.0
            for tv in (0, 5, B_ - 1, B_, 2 * B_ + 5):
                t = torch.tensor(tv, dtype=torch.int32, device=dev)
                rel, _ = check(f"{name} ({label})",
                               tm.mac(ring, bank, rt, idx, mask, t, uniform),
                               tm.mac_reference(ring, bank, rt, idx, mask, t,
                                                uniform), tv)
                worst = max(worst, rel)
            print(f"{name} ({label}: F={F_}, Fs={len(stage)}, B={B_}, "
                  f"K={K_}): max rel err {worst:.3e} (tol {REL_TOL:g}); "
                  f"checked, not timed", flush=True)
            del ring, bank
        torch.cuda.empty_cache()


def dual_bytes_flops(Fs, B_, K_, rows_used):
    """Bytes the dual MAC must move (each input once, each output once:
    Fs ring rows, the bank rows both sets use, both sets' controls, two
    outputs) and its FP32 operations (two complex multiply-adds, 16
    operations, per filter, partition and bin)."""
    plane = 2 * K_ * 4
    n_bytes = (Fs * B_ * plane + rows_used * B_ * plane + 2 * Fs * plane
               + Fs * 4 + 2 * (Fs * 4 + Fs * B_ * 4) + 4)
    return n_bytes, Fs * B_ * K_ * 16


# the dual MAC at the five shapes of its paths: (label, F, B, K, E,
# uniform, stage rows or None for all F rows permuted, repeated rows, in
# the summary). The per-filter shapes take distinct new and previous rows
# (E = 2F): at the scale shape 256 new and 256 old distinct rows.
DUAL_SHAPES = (
    ("bench5", BENCH5_C, BENCH5_B, BENCH5_N, 2, True, None,
     list(range(13, 26)) + [0, 0], True),
    ("massive", F, B, K, 2, True, None, [25, 0, 0, 7], False),
    ("scale", SCALE_C, B, K, 2 * SCALE_C, False, None, [7] * 8, False),
    ("stage subset", 6, 8, K, 12, False, [2, 3, 4, 5], [5, 2, 2, 3], True),
    ("two-pass shape", 4, 8, 65536, 8, False, [0, 1, 2, 3], [3, 3, 0],
     False),
)


def dual_inputs(g, F_, B_, K_, E_, uniform, stage):
    """Seeded ring, bank, both sets' indices and cblocks masks (the
    previous mask one partition shorter) of a dual MAC shape on the card,
    and the stage rows (all F rows permuted for None)."""
    import torch
    dev = torch.device("cuda")
    ring = torch.randn(F_, B_, 2, K_, generator=g, device=dev)
    bank = torch.randn(E_, B_, 2, K_, generator=g, device=dev)
    if uniform:
        idx = torch.zeros(F_, dtype=torch.int32, device=dev)
        pidx = torch.ones(F_, dtype=torch.int32, device=dev)
        delay = torch.full((F_,), 2, dtype=torch.int32, device=dev)
    else:
        perm = torch.randperm(F_, generator=g, device=dev)
        idx = perm.to(torch.int32)
        pidx = (perm + F_).to(torch.int32)
        delay = torch.arange(F_, device=dev, dtype=torch.int32) % 3
    mask = cblocks_mask(delay, B_)
    pmask = cblocks_mask((delay + 1).clamp(max=B_ - 1), B_)
    if stage is None:
        stage = torch.randperm(F_, generator=g, device=dev).tolist()
    return ring, bank, idx, mask, pidx, pmask, stage


def kernels_dual(td, tm, rows, flush):
    """The crossfade dual MAC (csrc/mac_dual.cu) at DUAL_SHAPES, then
    checked at MAC_EDGES (distinct new and previous rows, E = 2F)."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    torch.cuda._sleep(SPIN_CYCLES)
    e1.record()
    e1.synchronize()
    spin_ms = e0.elapsed_time(e1)
    for label, F_, B_, K_, E_, uniform, stage, repeated, summary in \
            DUAL_SHAPES:
        ring, bank, idx, mask, pidx, pmask, stage = dual_inputs(
            g, F_, B_, K_, E_, uniform, stage)
        name = "mac_dual_uniform" if uniform else "mac_dual_rows"
        worst = max_abs = 0.0
        for r in (stage, repeated):
            rt = torch.tensor(r, dtype=torch.int32, device=dev)
            for tv in (0, 5, B_ - 1, B_, 2 * B_ + 5):
                t = torch.tensor(tv, dtype=torch.int32, device=dev)
                got = td.mac_dual(ring, bank, rt, idx, mask, pidx, pmask, t,
                                  uniform)
                ref = td.mac_dual_reference(ring, bank, rt, idx, mask, pidx,
                                            pmask, t, uniform)
                for a, b in zip(got, ref):
                    rel, err = check(name, a, b, tv)
                    worst, max_abs = max(worst, rel), max(max_abs, err)
                del got, ref
        rt = torch.tensor(stage, dtype=torch.int32, device=dev)
        ones = torch.ones(F_, B_, device=dev)
        t7 = torch.tensor(7, dtype=torch.int32, device=dev)
        k_ms = time_ms(lambda: td.mac_dual(ring, bank, rt, idx, ones, pidx,
                                           ones, t7, uniform), REPS, flush)
        p_ms = time_ms(lambda: td.mac_dual_reference(
            ring, bank, rt, idx, ones, pidx, ones, t7, uniform), REPS, flush)
        two_ms = time_ms(lambda: (
            tm.mac(ring, bank, rt, idx, ones, t7, uniform),
            tm.mac(ring, bank, rt, pidx, ones, t7, uniform)), REPS, flush)
        sel = rt.long()[:1] if uniform else rt.long()
        used = len(set(idx[sel].tolist()) | set(pidx[sel].tolist()))
        nb, nf = dual_bytes_flops(len(stage), B_, K_, used)
        report(rows, name, "brutefir_tpu_torch/csrc/mac_dual.cu",
               404 if uniform else 371, worst, max_abs, k_ms, p_ms, nb, nf,
               ("mac_dual", name) if summary else None,
               note=f" ({label}: F={F_}, Fs={len(stage)}, B={B_}, K={K_})")
        print(f"  {name} ({label}): two mac calls {two_ms:.4f} ms = "
              f"{two_ms / k_ms:.2f}x the dual kernel", flush=True)
        host = []
        for _ in range(REPS):
            h0 = time.perf_counter()
            td.mac_dual(ring, bank, rt, idx, ones, pidx, ones, t7, uniform)
            host.append((time.perf_counter() - h0) * 1e3)
        torch.cuda.synchronize()
        print(f"  {name} ({label}): wrapper host time a call, {REPS} calls "
              f"back to back: median {np.median(host):.4f} ms, max "
              f"{max(host):.4f} ms (the spin before each timed call: "
              f"{spin_ms:.4f} ms)", flush=True)
        del ring, bank
        torch.cuda.empty_cache()
    for label, F_, B_, K_, _, stage, offset in MAC_EDGES:
        for uniform in (True, False):
            name = "mac_dual_uniform" if uniform else "mac_dual_rows"
            ring, bank, idx, mask, pidx, pmask, _ = dual_inputs(
                g, F_, B_, K_, 2 * F_, uniform, stage)
            ring = at_offset(ring, offset)
            rt = torch.tensor(stage, dtype=torch.int32, device=dev)
            worst = 0.0
            for tv in (0, 5, B_ - 1, B_, 2 * B_ + 5):
                t = torch.tensor(tv, dtype=torch.int32, device=dev)
                got = td.mac_dual(ring, bank, rt, idx, mask, pidx, pmask, t,
                                  uniform)
                ref = td.mac_dual_reference(ring, bank, rt, idx, mask, pidx,
                                            pmask, t, uniform)
                for a, b in zip(got, ref):
                    worst = max(worst, check(f"{name} ({label})", a, b,
                                             tv)[0])
                del got, ref
            print(f"{name} ({label}: F={F_}, Fs={len(stage)}, B={B_}, "
                  f"K={K_}): max rel err {worst:.3e} (tol {REL_TOL:g}); "
                  f"checked, not timed", flush=True)
            del ring, bank
        torch.cuda.empty_cache()


FFT_M = 8192            # packed bins of the massive and scale shapes


def fft_inputs(C: int, seed: int):
    """Seeded frames [C, 2M] and packed planes [C, 2, M] on the card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(C, 2 * FFT_M, generator=g, device="cuda")
    p = torch.randn(C, 2, FFT_M, generator=g, device="cuda")
    return x, p


def unpacked(p):
    """Packed planes [C, 2, M] -> the M + 1 complex rfft bins that
    ``torch.fft.irfft`` takes (DC and Nyquist real)."""
    import torch
    zero = torch.zeros_like(p[:, 1, :1])
    return torch.complex(torch.cat([p[:, 0], p[:, 1, :1]], dim=-1),
                         torch.cat([zero, p[:, 1, 1:], zero], dim=-1))


def fft_bytes_flops(C: int, M: int, table_bytes: int, out_floats: int,
                    fft: bool, real_bytes: int = 4):
    """Bytes a transform must move (its input once, the constant tables
    once, its output once) and its operations: 14 a bin for a Hermitian
    combine, plus 5 M log2 M a channel for an M-point complex FFT.
    ``real_bytes``: 4 (float32), 8 (float64)."""
    n_bytes = (C * 2 * M * real_bytes + table_bytes
               + C * out_floats * real_bytes)
    n_flop = C * (14 * M + (5 * M * np.log2(M) if fft else 0))
    return n_bytes, n_flop


def packed(X):
    """The M + 1 complex rfft bins [C, M + 1] -> packed planes [C, 2, M]
    (Nyquist in bin 0's imaginary slot)."""
    import torch
    return torch.stack([X.real[:, :-1], torch.cat(
        [X.real[:, -1:], X.imag[:, 1:-1]], dim=-1)], dim=-2)


def kernels_glue(tg, rows, flush):
    """The glue kernels (csrc/fft_glue.cu) at the massive (C = 26) and
    scale (C = 256) shapes, M = 8192, against their plain versions; then
    the routes they serve, the port's transforms, against the one library
    call for the same transform and timed beside it."""
    import torch
    M = FFT_M
    print_ptxas("fft_glue", ("glue_fwd_kernel", "glue_inv_kernel"),
                "one pair of bins a thread")
    for C in (F, SCALE_C):
        x, p = fft_inputs(C, SEED + 11 + C)
        Z = torch.fft.fft(torch.view_as_complex(x.reshape(C, M, 2)), dim=-1)
        cases = (
            ("glue_fwd", 89, lambda: tg.glue_fwd(Z),
             lambda: tg.glue_fwd_reference(Z), 2 * M),
            ("glue_inv", 106, lambda: torch.view_as_real(tg.glue_inv(p)),
             lambda: torch.view_as_real(tg.glue_inv_reference(p)), 2 * M))
        for name, line, kern, plain, out_floats in cases:
            rel, err = check(name, kern(), plain(), f"C={C}")
            k_ms = time_ms(kern, REPS, flush)
            p_ms = time_ms(plain, REPS, flush)
            nb, nf = fft_bytes_flops(C, M, M * 16, out_floats, False)
            report(rows, name, "brutefir_tpu_torch/csrc/fft_glue.cu", line,
                   rel, err, k_ms, p_ms, nb, nf,
                   ("fft_glue", name) if C == F else None,
                   note=f" (C={C}, M={M})", pallas=GLUE_SRC)
        tiny = torch.zeros(1, device="cuda")
        zc = torch.view_as_complex(x.reshape(C, M, 2))
        floors = (("a kernel writing 4 bytes", lambda: tiny.zero_()),
                  ("torch clone of Z", lambda: Z.clone()),
                  ("cuFFT fft alone", lambda: torch.fft.fft(zc, dim=-1)),
                  ("cuFFT fft, then a kernel writing 4 bytes",
                   lambda: (torch.fft.fft(zc, dim=-1), tiny.zero_())))
        print(f"  yardsticks at C={C}, M={M}: " + ", ".join(
            f"{what} {time_ms(fn, REPS, flush):.4f} ms"
            for what, fn in floors), flush=True)
        Xfull = unpacked(p)
        for label, fns, lib_ref in (
                ("forward, frame -> packed planes",
                 (("glue route (cuFFT fft + glue_fwd)",
                   lambda: tg.rfft_planes_glue(x)),
                  ("library torch.fft.rfft", lambda: torch.fft.rfft(x))),
                 lambda: packed(torch.fft.rfft(x))),
                ("inverse, packed planes -> valid half",
                 (("glue route (glue_inv + cuFFT ifft + slice)",
                   lambda: tg.irfft_planes_valid_glue(p)),
                  ("library torch.fft.irfft (full frame)",
                   lambda: torch.fft.irfft(Xfull, n=2 * M))),
                 lambda: torch.fft.irfft(Xfull, n=2 * M)[:, :M])):
            glue, ref = fns[0][1](), lib_ref()
            rel = ((glue - ref).abs().max() / ref.abs().max()).item()
            if not rel <= REL_TOL:
                fail(f"glue route off the library call ({label}, C={C}): "
                     f"{rel:.3e}")
            times = ", ".join(f"{what} {time_ms(fn, REPS, flush):.4f} ms"
                              for what, fn in fns)
            print(f"  routes at C={C}, M={M}, {label}: {times}; glue route "
                  f"vs library max rel err {rel:.3e}", flush=True)
        del x, p, Z, Xfull
        torch.cuda.empty_cache()


def kernels_f64(tm, tg, rows, flush):
    """The float64 forms (``float_bits: 64``): the unfused MAC
    (``bf_mac_f64`` of csrc/mac.cu) at MAC_SHAPES, then checked at
    MAC_EDGES, and the glue kernels (``bf_glue_fwd_f64`` /
    ``bf_glue_inv_f64`` of csrc/fft_glue.cu) at C = 26 and 256, M = 8192,
    each within REL_TOL_F64 of its plain float64 version and timed beside
    the float64 bound (8-byte bytes, FP64 operations at 34 TFLOP/s); then
    the float64 glue routes beside ``torch.fft.rfft`` / ``irfft`` on
    float64."""
    import torch
    dev = torch.device("cuda")
    f64 = torch.float64
    g = torch.Generator(device=dev).manual_seed(SEED + 33)
    for name, line, F_, B_, K_, E_, uniform, stage, repeated in MAC_SHAPES:
        ring, bank, idx, mask, stage = mac_inputs(g, F_, B_, K_, E_, uniform,
                                                  stage)
        ring, bank, mask = ring.double(), bank.double(), mask.double()
        worst = max_abs = 0.0
        for r in (stage, repeated):
            rt = torch.tensor(r, dtype=torch.int32, device=dev)
            for tv in (0, 5, B_ - 1, B_, 2 * B_ + 5):
                t = torch.tensor(tv, dtype=torch.int32, device=dev)
                rel, err = check(f"{name}_f64",
                                 tm.mac(ring, bank, rt, idx, mask, t,
                                        uniform),
                                 tm.mac_reference(ring, bank, rt, idx, mask,
                                                  t, uniform), tv,
                                 REL_TOL_F64)
                worst, max_abs = max(worst, rel), max(max_abs, err)
        rt = torch.tensor(stage, dtype=torch.int32, device=dev)
        ones = torch.ones(F_, B_, dtype=f64, device=dev)
        t7 = torch.tensor(7, dtype=torch.int32, device=dev)
        k_ms = time_ms(lambda: tm.mac(ring, bank, rt, idx, ones, t7,
                                      uniform), REPS, flush)
        p_ms = time_ms(lambda: tm.mac_reference(ring, bank, rt, idx, ones,
                                                t7, uniform), REPS, flush)
        Fs = len(stage)
        used = 1 if uniform else len(set(idx[rt.long()].tolist()))
        nb, nf = mac_bytes_flops(Fs, B_, K_, 0, used, out_rows=Fs,
                                 real_bytes=8)
        form = ("mac_uniform" if uniform else "mac_rows") + "_f64"
        report(rows, f"{name}_f64", "brutefir_tpu_torch/csrc/mac.cu", line,
               worst, max_abs, k_ms, p_ms, nb + Fs * 4, nf, ("mac", form),
               note=f" (F={F_}, Fs={Fs}, B={B_}, K={K_}; plan "
                    f"{tm.launch_plan(1, Fs, K_, f64)})", f64=True)
        del ring, bank
        torch.cuda.empty_cache()
    for label, F_, B_, K_, E_, stage, offset in MAC_EDGES:
        for uniform in (True, False):
            name = ("mac_uniform" if uniform else "mac_rows") + "_f64"
            ring, bank, idx, mask, _ = mac_inputs(g, F_, B_, K_, E_, uniform,
                                                  stage)
            ring = at_offset(ring.double(), offset)
            bank, mask = bank.double(), mask.double()
            rt = torch.tensor(stage, dtype=torch.int32, device=dev)
            worst = 0.0
            for tv in (0, 5, B_ - 1, B_, 2 * B_ + 5):
                t = torch.tensor(tv, dtype=torch.int32, device=dev)
                rel, _ = check(f"{name} ({label})",
                               tm.mac(ring, bank, rt, idx, mask, t, uniform),
                               tm.mac_reference(ring, bank, rt, idx, mask, t,
                                                uniform), tv, REL_TOL_F64)
                worst = max(worst, rel)
            print(f"{name} ({label}: F={F_}, Fs={len(stage)}, B={B_}, "
                  f"K={K_}): max rel err {worst:.3e} (tol {REL_TOL_F64:g}); "
                  f"checked, not timed", flush=True)
            del ring, bank
        torch.cuda.empty_cache()
    M = FFT_M
    for C in (F, SCALE_C):
        x, p = (a.double() for a in fft_inputs(C, SEED + 34 + C))
        Z = torch.fft.fft(torch.view_as_complex(x.reshape(C, M, 2)), dim=-1)
        cases = (
            ("glue_fwd_f64", 89, lambda: tg.glue_fwd(Z),
             lambda: tg.glue_fwd_reference(Z)),
            ("glue_inv_f64", 106, lambda: torch.view_as_real(tg.glue_inv(p)),
             lambda: torch.view_as_real(tg.glue_inv_reference(p))))
        for name, line, kern, plain in cases:
            rel, err = check(name, kern(), plain(), f"C={C}", REL_TOL_F64)
            k_ms = time_ms(kern, REPS, flush)
            p_ms = time_ms(plain, REPS, flush)
            nb, nf = fft_bytes_flops(C, M, M * 32, 2 * M, False, 8)
            report(rows, name, "brutefir_tpu_torch/csrc/fft_glue.cu", line,
                   rel, err, k_ms, p_ms, nb, nf,
                   ("fft_glue", name) if C == F else None,
                   note=f" (C={C}, M={M})", pallas=GLUE_SRC, f64=True)
        Xfull = unpacked(p)
        for label, fns, lib_ref in (
                ("forward, frame -> packed planes",
                 (("float64 glue route (cuFFT Z2Z fft + glue_fwd_f64)",
                   lambda: tg.rfft_planes_glue(x)),
                  ("library torch.fft.rfft, float64",
                   lambda: torch.fft.rfft(x))),
                 lambda: packed(torch.fft.rfft(x))),
                ("inverse, packed planes -> valid half",
                 (("float64 glue route (glue_inv_f64 + cuFFT Z2Z ifft + "
                   "slice)", lambda: tg.irfft_planes_valid_glue(p)),
                  ("library torch.fft.irfft (full frame), float64",
                   lambda: torch.fft.irfft(Xfull, n=2 * M))),
                 lambda: torch.fft.irfft(Xfull, n=2 * M)[:, :M])):
            glue, ref = fns[0][1](), lib_ref()
            rel = ((glue - ref).abs().max() / ref.abs().max()).item()
            if glue.dtype != f64 or not rel <= REL_TOL_F64:
                fail(f"float64 glue route off the library call ({label}, "
                     f"C={C}): {glue.dtype}, {rel:.3e}")
            times = ", ".join(f"{what} {time_ms(fn, REPS, flush):.4f} ms"
                              for what, fn in fns)
            print(f"  float64 routes at C={C}, M={M}, {label}: {times}; "
                  f"glue route vs library max rel err {rel:.3e}",
                  flush=True)
        del x, p, Z, Xfull
        torch.cuda.empty_cache()


def ptxas_usage(stem: str) -> dict:
    """Kernel (mangled name) -> what ``-Xptxas -v`` said of it in the
    build log of csrc/<stem>.cu: registers, constant memory, spills."""
    from brutefir_tpu_torch.ops import _build
    log = _build.library_path(_build.CSRC / f"{stem}.cu").with_suffix(".log")
    usage, name = {}, None
    for line in log.read_text().splitlines() if log.exists() else []:
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("Used" in line or "spill" in line):
            usage[name] = (usage.get(name, "") + " " + line.split(
                ":", 1)[-1].strip()).strip()
    return usage


def print_ptxas(stem: str, kernels, what: str) -> None:
    """Print what ``-Xptxas -v`` said of each kernel of csrc/<stem>.cu
    (registers, spills); fails where the log has no line for one."""
    usage = ptxas_usage(stem)
    for kernel in kernels:
        said = sorted(u for n, u in usage.items() if kernel in n)
        if not said:
            fail(f"no -Xptxas -v line for {kernel} in the build log")
        print(f"  {kernel} ({what}): ptxas: {'; '.join(said)}", flush=True)


def probe_fused(tf, pc, rows, flush, launched: dict):
    """The fused real FFT (csrc/fft_fused.cu) on its probe path, in place
    of tools/fused_fft_probe.py: frame -> permuted packed planes and
    permuted packed planes -> valid half at C = 26 and 256, M = 8192. One
    probe call of each direction a shape, with the counts set to 0 just
    before (2 + 2 launches: the rows' launches); then each against its
    plain version (the same four-step stages in torch) and against the
    port's transforms (the glue route) after ``bin_order``, and timed
    beside them and torch.fft.rfft / irfft of the same frames."""
    import torch
    M = FFT_M
    order = torch.as_tensor(tf.bin_order(M), device="cuda")
    print_ptxas("fft_fused", ("fused_fwd_kernel", "fused_inv_kernel"),
                "one instance a cluster size")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for C in (F, SCALE_C):
        S = tf.cluster_size(M, C, sms)
        print(f"  C={C}, M={M}: clusters of {S} blocks a channel ({C * S} "
              f"blocks on {sms} SMs), {tf.smem_bytes(M, S)} bytes of "
              f"dynamic shared memory a block", flush=True)
        x, p = fft_inputs(C, SEED + 12 + C)
        pp = p[..., order].contiguous()
        tf.reset_launches()
        fwd = tf.rfft_planes_fused(x)
        inv = tf.irfft_planes_valid_fused(pp)
        expect_launches(tf.launches, {"fft_fused_fwd": 1, "fft_fused_inv": 1},
                        f"fused FFT probe, C={C}")
        for k, n in tf.launches.items():
            launched[("fft_fused", k)] = launched.get(("fft_fused", k), 0) + n
        Xfull = unpacked(p)
        cases = (
            ("fft_fused_fwd", 154, fwd, lambda: tf.rfft_planes_fused(x),
             lambda: tf.rfft_planes_fused_reference(x),
             lambda: pc.rfft_planes(x)[..., order],
             lambda: pc.rfft_planes(x), lambda: torch.fft.rfft(x), 2 * M),
            ("fft_fused_inv", 184, inv,
             lambda: tf.irfft_planes_valid_fused(pp),
             lambda: tf.irfft_planes_fused_reference(pp, M // 2),
             lambda: pc.irfft_planes_valid(p),
             lambda: pc.irfft_planes_valid(p),
             lambda: torch.fft.irfft(Xfull, n=2 * M), M))
        for (name, line, got, kern, plain, route_ref, route, lib,
             out_floats) in cases:
            rel, err = check(name, got, plain(), f"C={C}")
            rel_route, _ = check(f"{name} against the port's route", got,
                                 route_ref(), f"C={C}")
            k_ms = time_ms(kern, REPS, flush)
            p_ms = time_ms(plain, REPS, flush)
            r_ms = time_ms(route, REPS, flush)
            l_ms = time_ms(lib, REPS, flush)
            nb, nf = fft_bytes_flops(C, M, M * 24 + (M // 128 + 128) * 8,
                                     out_floats, True)
            report(rows, name, "brutefir_tpu_torch/csrc/fft_fused.cu", line,
                   rel, err, k_ms, p_ms, nb, nf,
                   ("fft_fused", name) if C == F else None,
                   note=f" (C={C}, M={M})", pallas=FUSED_SRC, lib_ms=l_ms)
            print(f"  {name} (C={C}): the port's route (glue) {r_ms:.4f} "
                  f"ms; max rel err against it {rel_route:.3e}",
                  flush=True)
        del x, p, pp, fwd, inv, Xfull
        torch.cuda.empty_cache()


def write_massive_inputs(rng, frames: int, level: float = 2.0 ** 20):
    """Seeded 131072-tap coefficients (||taps||_2 = 0.5) as TEXT files,
    and an S24_4LE input with std ``level`` (2^20: no clipping)."""
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
    x = np.clip(np.round(rng.standard_normal((frames, F)) * level),
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


def scale_config(work: str) -> str:
    """The 256-channel scale shape: tools/mac_step_compare.py's config
    with MODE=alldistinct and BENCH_C=256 (8192 x 16 partitions, S24_4LE,
    filter i from input i to output i with coefficient set i), its
    coefficients RAW float32 files ``h<i>.raw`` in ``work`` and its
    devices the files ``input.raw`` and ``output.raw`` there."""
    C = SCALE_C
    chans = ", ".join(str(i) for i in range(C))
    coeffs = "\n".join(
        f'coeff {i} {{ filename: "{os.path.join(work, f"h{i}.raw")}"; '
        f'format: "FLOAT_LE"; }};' for i in range(C))
    filters = "\n".join(
        f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; coeff: {i}; }};"
        for i in range(C))
    return f"""
sampling_rate: 44100;
filter_length: {K},{B};
{coeffs}
input {chans} {{
    device: "file" {{ path: "{os.path.join(work, 'input.raw')}"; }};
    sample: "S24_4LE";
    channels: {C};
}};
output {chans} {{
    device: "file" {{ path: "{os.path.join(work, 'output.raw')}"; }};
    sample: "S24_4LE";
    channels: {C};
    dither: false;
}};
{filters}
"""


def read_s24_3(path: str, big: bool = False) -> np.ndarray:
    """An S24_LE file (3 little-endian bytes a sample; with ``big``, an
    S24_BE file) as int32 words."""
    b = np.fromfile(path, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
    if big:
        b = b[:, ::-1]
    w = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    return w - ((w & 0x800000) << 1)


def run_main(main, cfg: str, frames: int, channels: int, label: str,
             out: str = "output.raw", width: int = 4, dtype: str = "<i4",
             with_err: bool = False, rate: int = 44100):
    """One run of the port's __main__.main (its writer thread has
    fetched every output when main() returns); the output words of the
    file ``out`` in WORK, 4-byte words of ``dtype`` or (``width`` 3)
    3-byte words in ``dtype``'s byte order; with ``with_err``, also what
    main() wrote to stderr."""
    out = os.path.join(WORK, out)
    if os.path.exists(out):
        os.remove(out)
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = main(["-nodefault", cfg])
    wall = time.perf_counter() - t0
    sys.stderr.write(err.getvalue())
    if rc != 0:
        fail(f"main() exited {rc} ({label})")
    y = (np.fromfile(out, dtype=dtype) if width == 4
         else read_s24_3(out, big=dtype.startswith(">")))
    if y.size != frames * channels:
        fail(f"output has {y.size // channels} frames, input {frames} "
             f"({label})")
    audio_s = frames / rate
    engine_line = (err.getvalue().strip().splitlines() or ["-"])[-1]
    print(f"main path ({label}): rc 0, {frames} frames in and out, end to "
          f"end {wall:.3f} s for {audio_s:.3f} s of audio = "
          f"{audio_s / wall:.2f}x realtime (incl. config parse and bank "
          f"build); engine: {engine_line}", flush=True)
    if with_err:
        return y.reshape(frames, channels), err.getvalue()
    return y.reshape(frames, channels)


def oracle_lsb(y, x, taps_of):
    """Max |y - round(x (*) h)| in LSB over all channels, the convolution
    in float64."""
    return oracle_lsbs([y], x, taps_of)[0]


def oracle_lsbs(ys, x, taps_of):
    """:func:`oracle_lsb` of several outputs of one input, the oracle
    computed once."""
    from scipy.signal import fftconvolve
    frames, C = ys[0].shape
    worst = [0] * len(ys)
    for c0 in range(0, C, 16):
        c1 = min(C, c0 + 16)
        ref = np.round(fftconvolve(
            x[:, c0:c1].T.astype(np.float64),
            np.stack([taps_of(c) for c in range(c0, c1)]), axes=1)
            [:, :frames])
        for i, y in enumerate(ys):
            worst[i] = max(worst[i], int(np.abs(
                y[:, c0:c1].T.astype(np.int64) - ref).max()))
    return worst


def oracle_gap(y, x, taps_of) -> float:
    """Max |y - x (*) h| over all channels, the convolution in float64
    and not rounded: a float64 run's words are its rounding, within
    WORD_GATE."""
    from scipy.signal import fftconvolve
    frames, C = y.shape
    worst = 0.0
    for c0 in range(0, C, 16):
        c1 = min(C, c0 + 16)
        ref = fftconvolve(x[:, c0:c1].T.astype(np.float64),
                          np.stack([taps_of(c) for c in range(c0, c1)]),
                          axes=1)[:, :frames]
        worst = max(worst, float(np.abs(y[:, c0:c1].T - ref).max()))
    return worst


def add_counts(launched: dict, counts: dict, *keys):
    """Add a run's launches of ``keys`` (module, form) to the rows'."""
    for key in keys:
        launched[key] = launched.get(key, 0) + counts[key]


# each float32 phase's error, printed beside its float64 phase (29-31)
F32_ERR = {}


def expect_launches(counts: dict, want: dict, label: str):
    print(f"kernel launches in this run ({label}): {counts}", flush=True)
    for key, n in want.items():
        if counts.get(key, 0) != n:
            fail(f"{label}: {key} launched {counts.get(key, 0)} times, "
                 f"expected {n}")


def expect_only(counts: dict, want: dict, label: str):
    """``counts`` by (module, form): every form as in ``want``, every
    form it does not name 0."""
    full = {k[1]: 0 for k in counts}
    full.update(want)
    expect_launches({k[1]: v for k, v in counts.items()}, full, label)


@contextlib.contextmanager
def knob(name: str, value):
    """Set (or, with None, unset) an environment knob for the block."""
    old = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if old is not None:
            os.environ[name] = old


def add_glue(launched: dict, counts: dict):
    """Add a run's glue launches (``counts`` by (module, form)) to the
    glue rows' launches."""
    for key in (("fft_glue", "glue_fwd"), ("fft_glue", "glue_inv")):
        launched[key] = launched.get(key, 0) + counts[key]


def glue_want(n_fwd: int, n_inv: int) -> dict:
    return {"glue_fwd": n_fwd, "glue_inv": n_inv}


def main_massive(main, mods: dict, launched: dict):
    rng = np.random.default_rng(SEED)
    frames = int(BLOCKS * K)
    blocks = int(np.ceil(BLOCKS))
    taps, x = write_massive_inputs(rng, frames)
    for two in (False, True):
        label = "massive, two coefficients" if two else \
            "massive, shared coefficient"
        form = "rows" if two else "uniform"
        cfg = massive_config("run2.conf" if two else "run1.conf", two)
        for m in mods.values():
            m.reset_launches()
        y = run_main(main, cfg, frames, F, label)
        counts = all_counts(mods)
        lsb = oracle_lsb(y, x, lambda c: taps[1] if (two and c >= 13)
                         else taps[0])
        print(f"main path ({label}): max |y - oracle| {lsb} LSB (tol "
              f"{LSB_TOL}) on all {F} channels", flush=True)
        if lsb > LSB_TOL:
            fail(f"output off the float64 oracle by {lsb} LSB ({label})")
        if not two:
            F32_ERR["massive"] = oracle_gap(y, x, lambda c: taps[0])
        if counts[("mac_mix", form)] <= 0:
            fail(f"the main path never launched the {form} kernel form")
        # one forward and one inverse glue a block
        expect_launches({k[1]: v for k, v in counts.items()},
                        {"tiled": 0, **glue_want(blocks, blocks)}, label)
        launched[("mac_mix", form)] = counts[("mac_mix", form)]
        add_glue(launched, counts)


def write_scale_inputs(work: str, frames: int, seed: int = SEED + 2):
    """The scale shape's seeded inputs in ``work``: 256 exponentially
    decaying 131072-tap coefficient sets (||h||_2 = 0.5) as RAW float32
    files, an S24_4LE input of ``frames`` frames with std 2^20, and the
    config. Returns (taps [256, 131072] float32, x [frames, 256], config
    path)."""
    C = SCALE_C
    rng = np.random.default_rng(seed)
    n_taps = K * B
    decay = np.exp(-np.arange(n_taps) / 20000.0)
    taps = np.empty((C, n_taps), np.float32)
    for c in range(C):
        h = rng.standard_normal(n_taps) * decay
        taps[c] = 0.5 * h / np.linalg.norm(h)
        taps[c].astype("<f4").tofile(os.path.join(work, f"h{c}.raw"))
    x = np.clip(np.round(rng.standard_normal((frames, C)) * 2.0 ** 20),
                -(2 ** 23), 2 ** 23 - 1).astype("<i4")
    x.tofile(os.path.join(work, "input.raw"))
    cfg = os.path.join(work, "scale.conf")
    with open(cfg, "w") as fh:
        fh.write(scale_config(work))
    return taps, x, cfg


def main_scale(main, mods: dict, launched: dict):
    C = SCALE_C
    frames = int(BLOCKS * K)
    blocks = int(np.ceil(BLOCKS))
    taps, x, cfg = write_scale_inputs(WORK, frames)
    # every block one forward and one inverse glue at C = 256, the groups'
    # blocks included
    runs = (("scale, groups of 4", None,
             {"group": 4, "tiled": 4, "mix_group": 0},
             (("mac_group", "group"), ("mac_mix", "tiled"))),
            ("scale, BRUTEFIR_TPU_PAIR=2", "2",
             {"mix_group": 8, "tiled": 4, "group": 0},
             (("mac_group", "mix_group"),)))
    ys = []
    for label, pair, want, keys in runs:
        with knob("BRUTEFIR_TPU_PAIR", pair):
            for m in mods.values():
                m.reset_launches()
            ys.append(run_main(main, cfg, frames, C, label))
            counts = all_counts(mods)
        expect_launches({k[1]: v for k, v in counts.items()},
                        {**want, **glue_want(blocks, blocks)}, label)
        for key in keys:
            launched[key] = counts[key]
        add_glue(launched, counts)
    for lsb, (label, *_) in zip(
            oracle_lsbs(ys, x, lambda c: taps[c].astype(np.float64)), runs):
        print(f"main path ({label}): max |y - oracle| {lsb} LSB (tol "
              f"{LSB_TOL}) on all {C} channels", flush=True)
        if lsb > LSB_TOL:
            fail(f"output off the float64 oracle by {lsb} LSB ({label})")


BENCH1_N, BENCH1_B = 8192, 8       # the reference's bench1_config


def bench1_config(work: str) -> str:
    """The reference's bench1_config graph at its shipped 8192 x 8: in 0
    -> filters 2, 3; in 1 -> filters 4, 5; filters 2, 5 -> filter 0 ->
    out 0; filters 3, 4 -> filter 1 -> out 1; coefficient i the RAW
    float32 file ``h<i>.raw`` in ``work`` (the reference's are diracs)."""
    coeffs = "\n".join(
        f'coeff {i} {{ filename: "{os.path.join(work, f"h{i}.raw")}"; '
        f'format: "FLOAT_LE"; }};' for i in range(6))
    return f"""
float_bits: 32;
sampling_rate: 44100;
filter_length: {BENCH1_N},{BENCH1_B};
{coeffs}
input 0, 1 {{
    device: "file" {{ path: "{os.path.join(work, 'input.raw')}"; }};
    sample: "S24_4LE";
    channels: 2;
}};
output 0, 1 {{
    device: "file" {{ path: "{os.path.join(work, 'output.raw')}"; }};
    sample: "S24_4LE";
    channels: 2;
    dither: false;
}};
filter 0 {{ from_filters: 2, 5; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_filters: 3, 4; to_outputs: 1; coeff: 1; }};
filter 2 {{ from_inputs: 0; to_filters: 0; coeff: 2; }};
filter 3 {{ from_inputs: 0; to_filters: 1; coeff: 3; }};
filter 4 {{ from_inputs: 1; to_filters: 1; coeff: 4; }};
filter 5 {{ from_inputs: 1; to_filters: 0; coeff: 5; }};
"""


def write_bench1_inputs(work: str, frames: int, seed: int = SEED + 4):
    """Six seeded 65536-tap coefficient sets (uniform in +-0.003, as
    tests/test_fullshape_parity.py makes them) as RAW float32 files, a
    2-channel S24_4LE input uniform in +-2^20, and the config. Returns
    (taps [6, 65536] float32, x [frames, 2], config path)."""
    rng = np.random.default_rng(seed)
    taps = (rng.uniform(-1.0, 1.0, (6, BENCH1_N * BENCH1_B))
            * 0.003).astype(np.float32)
    for i in range(6):
        taps[i].astype("<f4").tofile(os.path.join(work, f"h{i}.raw"))
    x = rng.integers(-(1 << 20), 1 << 20, (frames, 2)).astype("<i4")
    x.tofile(os.path.join(work, "input.raw"))
    cfg = os.path.join(work, "bench1.conf")
    with open(cfg, "w") as fh:
        fh.write(bench1_config(work))
    return taps, x, cfg


def bench1_oracle(taps, x):
    """The float64 oracle of the bench1 graph: [frames, 2]."""
    from scipy.signal import fftconvolve
    n = x.shape[0]

    def conv(a, h):
        return fftconvolve(a, h.astype(np.float64))[:n]

    x0, x1 = x[:, 0].astype(np.float64), x[:, 1].astype(np.float64)
    return np.stack([conv(conv(x0, taps[2]) + conv(x1, taps[5]), taps[0]),
                     conv(conv(x0, taps[3]) + conv(x1, taps[4]), taps[1])],
                    axis=1)


def all_counts(mods: dict) -> dict:
    """Every launch count of the kernel modules, by (module, form)."""
    return {(name, k): v for name, m in mods.items()
            for k, v in m.launches.items()}


def run_cascade(main, mods, cfg, frames, channels, label, form):
    """One cascade run of ``main()`` with every count set to 0 just
    before it; the unfused MAC's ``form`` and each glue kernel must launch
    two times a block (two stages) and no other kernel at all. Returns
    (y, counts)."""
    for m in mods.values():
        m.reset_launches()
    y = run_main(main, cfg, frames, channels, label)
    counts = all_counts(mods)
    n = 2 * int(np.ceil(BLOCKS))
    expect_only(counts, {form: n, **glue_want(n, n)}, label)
    return y, counts


def main_bench1(main, mods: dict, launched: dict):
    frames = int(BLOCKS * BENCH1_N)
    taps, x, cfg = write_bench1_inputs(WORK, frames)
    label = "bench1 cascade"
    y, counts = run_cascade(main, mods, cfg, frames, 2, label, "mac_rows")
    ref = bench1_oracle(taps, x)
    for c in range(2):
        peak = np.abs(ref[:, c]).max()
        err = np.abs(y[:, c] - ref[:, c]).max()
        lsb = int(np.abs(y[:, c].astype(np.int64)
                         - np.round(ref[:, c])).max())
        tol = 2e-5 * peak + 4.0
        print(f"main path ({label}): channel {c}: max |y - oracle| "
              f"{err:.3f} (tol 2e-5 * {peak:.0f} + 4 = {tol:.3f}); "
              f"{lsb} LSB from the rounded oracle", flush=True)
        if not err <= tol:
            fail(f"{label} off the float64 oracle on channel {c}")
    launched[("mac", "mac_rows")] = counts[("mac", "mac_rows")]
    add_glue(launched, counts)


def massive_cascade_config(work: str) -> str:
    """examples/multichannel_massive.conf with a second stage: filter i
    from input i to filter 26 + i, filter 26 + i from filter i to output
    i, all on the one shared coefficient (``taps0.txt`` in ``work``)."""
    with open(massive_config("run1.conf", False)) as fh:
        text = fh.read()
    text = text[:text.index("\nfilter ")]
    text += "\n" + "".join(
        f'filter {i} {{ from_inputs: {i}; to_filters: {F + i}; '
        f'coeff: "correction"; }};\n' for i in range(F))
    text += "".join(
        f'filter {F + i} {{ from_filters: {i}; to_outputs: {i}; '
        f'coeff: "correction"; }};\n' for i in range(F))
    path = os.path.join(work, "cascade.conf")
    with open(path, "w") as fh:
        fh.write(text)
    return path


def main_massive_cascade(main, mods: dict, launched: dict):
    frames = int(BLOCKS * K)
    taps, x = write_massive_inputs(np.random.default_rng(SEED + 5), frames)
    cfg = massive_cascade_config(WORK)
    hh = np.convolve(taps[0], taps[0])           # h (*) h in float64
    y, counts = run_cascade(main, mods, cfg, frames, F, "massive cascade",
                            "mac_uniform")
    lsb = oracle_lsb(y, x, lambda c: hh)
    print(f"main path (massive cascade): max |y - oracle| {lsb} LSB (tol "
          f"{LSB_TOL}) on all {F} channels", flush=True)
    if lsb > LSB_TOL:
        fail(f"output off the float64 oracle by {lsb} LSB (massive "
             f"cascade)")
    launched[("mac", "mac_uniform")] = counts[("mac", "mac_uniform")]
    add_glue(launched, counts)




def xfade_config(work: str, name: str, N_: int, B_: int, C: int,
                 coeffs, script=None) -> str:
    """C crossfading filters, input i -> filter i -> output i on
    coefficient 0, S24_4LE files ``input.raw`` / ``output.raw`` in
    ``work``; ``coeffs``: (path, format) of each set; ``script``: a CLI
    script, one line a block (a real newline between lines). Returns the
    config's path."""
    chans = ", ".join(str(i) for i in range(C))
    sets = "\n".join(f'coeff {k} {{ filename: "{path}"; format: "{fmt}"; }};'
                     for k, (path, fmt) in enumerate(coeffs))
    logic = (f'logic: "cli" {{ script: "{script}"; echo: false; }};'
             if script is not None else "")
    filters = "\n".join(
        f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; coeff: 0; "
        f"crossfade: true; }};" for i in range(C))
    text = f"""
sampling_rate: 44100;
filter_length: {N_},{B_};
show_progress: false;
{logic}
{sets}
input {chans} {{
    device: "file" {{ path: "{os.path.join(work, 'input.raw')}"; }};
    sample: "S24_4LE";
    channels: {C};
}};
output {chans} {{
    device: "file" {{ path: "{os.path.join(work, 'output.raw')}"; }};
    sample: "S24_4LE";
    channels: {C};
    dither: false;
}};
{filters}
"""
    path = os.path.join(work, name)
    with open(path, "w") as fh:
        fh.write(text)
    return path


def flip_script(C: int, first: int, second: int, sleep: str = "") -> str:
    """Two script lines: every filter to set ``first``, then every filter
    to set ``second``, each followed by ``sleep`` (a command or "")."""
    return "\n".join(" ".join(f"cfc {i} {k};" for i in range(C)) + sleep
                     for k in (first, second))


def ramped_oracle(ya, yb, N_, n, segments):
    """The piecewise output of a crossfading filter: ``segments`` maps
    each block index to "a", "b", "ab" (ramp a -> b) or "ba"; ramp
    arange(N) / (N - 1), the last block cut at n samples."""
    ramp = np.arange(N_, dtype=np.float64) / (N_ - 1)
    out = np.empty(n)
    for k in range(-(-n // N_)):
        seg = slice(k * N_, min(n, (k + 1) * N_))
        r = ramp[: seg.stop - seg.start]
        kind = segments(k)
        a, b = (ya, yb) if kind in ("a", "ab") else (yb, ya)
        out[seg] = a[seg] if len(kind) == 1 else a[seg] * (1 - r) + b[seg] * r
    return out


def xfade_lsb(y, x, taps, N_, segments, channels, gains=None):
    """Max |y - oracle| (float64, not rounded) over ``channels``, and the
    largest oracle peak among the two sets; ``gains``: a factor of each
    channel's oracle."""
    from scipy.signal import fftconvolve
    n = y.shape[0]
    worst = peak = 0.0
    for c in channels:
        g = 1.0 if gains is None else float(gains[c])
        ya, yb = (g * fftconvolve(x[:, c].astype(np.float64),
                                  h.astype(np.float64))[:n] for h in taps)
        ref = ramped_oracle(ya, yb, N_, n, segments)
        worst = max(worst, float(np.abs(y[:, c] - ref).max()))
        peak = max(peak, float(np.abs(ya).max()), float(np.abs(yb).max()))
    return worst, peak


def write_bench5_inputs(work: str, frames: int, seed: int = SEED + 7):
    """The reference's bench5_config at its shipped 8192 x 8 with two
    seeded 65536-tap sets (uniform in +-0.003, as
    tests/test_fullshape_parity.py makes them) as RAW float32 files in
    place of its coefficient and dirac, a 26-channel S24_4LE input
    uniform in +-2^20, and its script: every filter to set 0, then every
    filter to set 1, one line a block. Returns (taps, x, config path)."""
    N_, B_, C = BENCH5_N, BENCH5_B, BENCH5_C
    rng = np.random.default_rng(seed)
    taps = [(rng.uniform(-1.0, 1.0, N_ * B_) * 0.003).astype(np.float32)
            for _ in range(2)]
    for k, h in enumerate(taps):
        h.astype("<f4").tofile(os.path.join(work, f"x{k}.raw"))
    x = rng.integers(-(1 << 20), 1 << 20, (frames, C)).astype("<i4")
    x.tofile(os.path.join(work, "input.raw"))
    cfg = xfade_config(work, "bench5.conf", N_, B_, C,
                       [(os.path.join(work, f"x{k}.raw"), "FLOAT_LE")
                        for k in range(2)], flip_script(C, 0, 1))
    return taps, x, cfg


def main_bench5(main, mods: dict, launched: dict):
    N_, C = BENCH5_N, BENCH5_C
    frames = int(BLOCKS * N_)
    taps, x, cfg = write_bench5_inputs(WORK, frames)
    for m in mods.values():
        m.reset_launches()
    y = run_main(main, cfg, frames, C, "bench5")
    counts = all_counts(mods)
    blocks = int(np.ceil(BLOCKS))
    expect_only(counts, {"mac_dual_uniform": blocks - 1, "uniform": 1,
                         **glue_want(blocks, blocks)}, "bench5")
    worst, peak = xfade_lsb(
        y.astype(np.float64), x, taps, N_,
        lambda k: "a" if k == 0 else ("ab" if k % 2 else "ba"),
        range(0, C, 5))
    tol = 8e-6 * peak + 4.0
    F32_ERR["bench5"] = worst
    print(f"main path (bench5): max |y - ramp oracle| {worst:.3f} LSB (tol "
          f"8e-6 * {peak:.0f} + 4 = {tol:.3f}) on channels 0, 5, ..., 25",
          flush=True)
    if not worst <= tol:
        fail("bench5 off the float64 linear-ramp oracle")
    launched[("mac_dual", "mac_dual_uniform")] = counts[
        ("mac_dual", "mac_dual_uniform")]
    add_glue(launched, counts)


SWAP_BLOCKS = 130.5      # crossfades at blocks 0, 64 and 128


def main_massive_swap(main, mods: dict, launched: dict):
    frames = int(SWAP_BLOCKS * K)
    taps, x = write_massive_inputs(np.random.default_rng(SEED + 8), frames)
    cfg = xfade_config(WORK, "swap.conf", K, B, F,
                       [(os.path.join(WORK, f"taps{k}.txt"), "TEXT")
                        for k in range(2)],
                       flip_script(F, 1, 0, " sleep b63"))
    for m in mods.values():
        m.reset_launches()
    y = run_main(main, cfg, frames, F, "massive, swap every 64 blocks")
    blocks = int(np.ceil(SWAP_BLOCKS))
    counts = all_counts(mods)
    expect_only(counts, {"mac_dual_uniform": 3, "uniform": blocks - 3,
                         **glue_want(blocks, blocks)},
                "massive, swap every 64 blocks")
    add_glue(launched, counts)
    segments = {0: "ab", 64: "ba", 128: "ab"}

    def seg(k):
        return segments.get(k, "b" if (k // 64) % 2 == 0 else "a")

    worst, _ = xfade_lsb(y.astype(np.float64), x, taps, K, seg,
                         range(0, F, 4))
    print(f"main path (massive, swap every 64 blocks): max |y - oracle| "
          f"{worst:.3f} LSB (tol {LSB_TOL}) on channels 0, 4, ..., 24",
          flush=True)
    if not worst <= LSB_TOL:
        fail("the massive swap path is off the float64 oracle")


SPLIT_BLOCKS = 27.5      # 2 batches, the swap batch, the EOF tail


def offline_split(mods: dict, launched: dict):
    from brutefir_tpu_torch.config import parse_config
    from brutefir_tpu_torch.runtime.engine import Engine
    frames = int(SPLIT_BLOCKS * K)
    taps, x = write_massive_inputs(np.random.default_rng(SEED + 9), frames)
    cfg = xfade_config(WORK, "split.conf", K, B, F,
                       [(os.path.join(WORK, f"taps{k}.txt"), "TEXT")
                        for k in range(2)])
    with open(cfg) as fh:
        eng = Engine(parse_config(fh.read()))
    out = os.path.join(WORK, "output.raw")
    for m in mods.values():
        m.reset_launches()
    eng.setup()
    try:
        eng.run_offline(max_blocks=16, setup=False)
        for i in range(F):
            eng.control.change_coeff(i, 1)
        eng.run_offline(setup=False)
    finally:
        eng.teardown()
    blocks = int(np.ceil(SPLIT_BLOCKS))
    counts = all_counts(mods)
    expect_only(counts, {"mac_dual_uniform": 1, "uniform": blocks - 1,
                         **glue_want(blocks, blocks)}, "offline split")
    add_glue(launched, counts)
    y = np.fromfile(out, dtype="<i4")
    if y.size != frames * F:
        fail(f"offline split wrote {y.size // F} frames, read {frames}")
    worst, _ = xfade_lsb(
        y.reshape(frames, F).astype(np.float64), x, taps, K,
        lambda k: "a" if k < 16 else ("ab" if k == 16 else "b"),
        range(0, F, 4))
    print(f"offline split: {blocks} blocks, swap before block 16: max |y - "
          f"oracle| {worst:.3f} LSB (tol {LSB_TOL}) on channels 0, 4, ..., "
          f"24", flush=True)
    if not worst <= LSB_TOL:
        fail("the offline split is off the float64 oracle")


# block 0 swaps every first-stage filter's set, block 3 swaps filters 2
# and 3 back, and so on every third block
CASCADE_SCRIPT = ("cfc 2 3; cfc 3 2; cfc 4 5; cfc 5 4; sleep b2\n"
                  "cfc 2 2; cfc 3 3; sleep b2")


def cascade_sets(k):
    """The coefficient sets of filters 2-5 on block k (k = -1: the
    config's) under CASCADE_SCRIPT."""
    if k < 0:
        return [2, 3, 4, 5]
    return [3, 2, 5, 4] if (k // 3) % 2 == 0 else [2, 3, 5, 4]


def cascade_xfade_oracle(taps, x):
    """The float64 output of the crossfading bench1 cascade [frames, 2]:
    each first-stage filter's output ramps linearly (arange(N) / (N - 1))
    from its old set to its new one over a block where its set changes."""
    from scipy.signal import fftconvolve
    n, N_ = x.shape[0], BENCH1_N

    def conv(a, h):
        return fftconvolve(a, h.astype(np.float64))[:n]

    ramp = np.arange(N_, dtype=np.float64) / (N_ - 1)
    z = {}
    for j, (f, c) in enumerate(((2, 0), (3, 0), (4, 1), (5, 1))):
        ys = {h: conv(x[:, c].astype(np.float64), taps[h])
              for h in range(2, 6)}
        out = np.empty(n)
        for k in range(-(-n // N_)):
            seg = slice(k * N_, min(n, (k + 1) * N_))
            old, new = cascade_sets(k - 1)[j], cascade_sets(k)[j]
            r = ramp[: seg.stop - seg.start]
            out[seg] = (ys[new][seg] if old == new
                        else ys[old][seg] * (1 - r) + ys[new][seg] * r)
        z[f] = out
    return np.stack([conv(z[2] + z[5], taps[0]), conv(z[3] + z[4], taps[1])],
                    axis=1)


def write_bench1_xfade_inputs(work: str, frames: int, seed: int = SEED + 10):
    """bench1's inputs (:func:`write_bench1_inputs`) and its graph with
    filters 2-5 ``crossfade: true`` under CASCADE_SCRIPT. Returns (taps,
    x, config path)."""
    taps, x, _ = write_bench1_inputs(work, frames, seed)
    text = bench1_config(work).replace(
        "sampling_rate: 44100;",
        f'sampling_rate: 44100;\nlogic: "cli" {{ script: "{CASCADE_SCRIPT}"; '
        f'echo: false; }};')
    for i in range(2, 6):
        old = f"coeff: {i}; }};"
        if old not in text:
            fail(f"could not make filter {i} crossfade in the bench1 config")
        text = text.replace(old, f"coeff: {i}; crossfade: true; }};")
    cfg = os.path.join(work, "bench1_xfade.conf")
    with open(cfg, "w") as fh:
        fh.write(text)
    return taps, x, cfg


def main_bench1_xfade(main, mods: dict, launched: dict):
    frames = int(BLOCKS * BENCH1_N)
    taps, x, cfg = write_bench1_xfade_inputs(WORK, frames)
    label = "bench1 cascade, crossfading first stage"
    for m in mods.values():
        m.reset_launches()
    y = run_main(main, cfg, frames, 2, label)
    counts = all_counts(mods)
    blocks = int(np.ceil(BLOCKS))
    swaps = len(range(0, blocks, 3))
    # bench1's two glue launches each way a block, and on each swap block
    # crossfade_spectra's two full inverses and one forward
    expect_only(counts, {"mac_dual_rows": swaps,
                         "mac_rows": 2 * blocks - swaps,
                         **glue_want(2 * blocks + swaps,
                                     2 * blocks + 2 * swaps)}, label)
    ref = cascade_xfade_oracle(taps, x)
    for c in range(2):
        peak = np.abs(ref[:, c]).max()
        err = np.abs(y[:, c] - ref[:, c]).max()
        tol = 2e-5 * peak + 4.0
        F32_ERR["bench1_xfade"] = max(F32_ERR.get("bench1_xfade", 0.0),
                                      err / peak)
        print(f"main path ({label}): channel {c}: max |y - oracle| "
              f"{err:.3f} (tol 2e-5 * {peak:.0f} + 4 = {tol:.3f})",
              flush=True)
        if not err <= tol:
            fail(f"{label} off the float64 oracle on channel {c}")
    launched[("mac_dual", "mac_dual_rows")] = counts[
        ("mac_dual", "mac_dual_rows")]
    add_glue(launched, counts)


# ---- phases 16-18: channel delays, subsample delays and dither ------------

SDF_LENGTH = 32          # phase 16: subdelay FIRs of 65 taps in chunks of 128
ALIGN_STEP = 37          # phase 16: output channel c delayed 37 c samples
ALIGN_MAXDELAY = 2048
# phase 16's output subdelays: channels 0-12 spread over -99 .. 99 (in
# 1/100 of a sample), 13-25 undefined (the dirac row: sdf_length latency)
ALIGN_SUBDELAYS = ([int(v) for v in np.round(np.linspace(-99, 99, 13))]
                   + [-100] * 13)
DITHER_RMS = (0.5, 2.0)  # LSB of the error's RMS: plain rounding gives 0.29
S24_MIN, S24_MAX = -(1 << 23), (1 << 23) - 1


def aligned_config(name: str) -> str:
    """Phase 16's config: examples/multichannel_massive.conf (the shared
    coefficient ``taps0.txt``) with dithered S24_LE (3-byte) outputs,
    output channel c delayed 37 c samples under maxdelay 2048,
    sdf_length 32 and ALIGN_SUBDELAYS on the outputs."""
    with open(massive_config(name, False)) as fh:
        text = fh.read()
    head, out = text.split("\noutput ", 1)
    fields = (f"dither: true;\n    delay: "
              + ", ".join(str(ALIGN_STEP * c) for c in range(F))
              + f";\n    maxdelay: {ALIGN_MAXDELAY};\n    subdelay: "
              + ", ".join(str(v) for v in ALIGN_SUBDELAYS) + ";")
    for old, new in (('sample: "S24_4LE";', 'sample: "S24_LE";'),
                     ("dither: false;", fields)):
        if old not in out:
            fail(f"could not set {old!r} in the example's output block")
        out = out.replace(old, new, 1)
    head = head.replace("sampling_rate: 44100;",
                        f"sampling_rate: 44100;\nsdf_length: {SDF_LENGTH};", 1)
    path = os.path.join(WORK, name)
    with open(path, "w") as fh:
        fh.write(head + "\noutput " + out)
    return path


def subdelay_taps(sd: int) -> np.ndarray:
    """The FIR of subdelay ``sd`` (1/100 sample) in float64, as the bank
    of runtime/subdelay.py builds it: the Kaiser-windowed sinc (beta 9)
    of 2 sdf_length + 1 float32 taps, or a dirac at sdf_length for 0 and
    for an undefined subdelay."""
    from brutefir_tpu_torch.core.firwindow import sample_sinc
    if sd == 0 or sd <= -100:
        h = np.zeros(2 * SDF_LENGTH + 1)
        h[SDF_LENGTH] = 1.0
        return h
    return sample_sinc(SDF_LENGTH, sd / 100.0, 9.0,
                       np.float32).astype(np.float64)


def aligned_oracle(x, h):
    """Phase 16's float64 output [frames, F]: each channel's convolution
    with ``h``, then its subdelay FIR, then its integer delay."""
    from scipy.signal import fftconvolve
    frames = x.shape[0]
    ref = np.zeros((frames, F))
    for c0 in range(0, F, 13):
        z = fftconvolve(x[:, c0:c0 + 13].T.astype(np.float64), h[None, :],
                        axes=1)[:, :frames]
        for i, c in enumerate(range(c0, min(F, c0 + 13))):
            zc = np.convolve(z[i], subdelay_taps(ALIGN_SUBDELAYS[c]))[:frames]
            d = ALIGN_STEP * c
            ref[d:, c] = zc[:frames - d]
    return ref


def dither_card_vs_cpu(dio):
    """The massive shape's dither window and dithered quantize on the card
    and on CPU copies of the same inputs: bit-equal, at a normal level, at
    a clipping level, and across the table's wrap."""
    import torch
    from brutefir_tpu_torch.ops.device_dither import (dither_quantize,
                                                      dither_window)
    tab, randmap, size = dio._dither
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(SEED + 13)
    ptr, last = dio.dstate["ptr"].clone(), dio.dstate["last"].clone()
    ptr[::5] = size - K // 2                      # these wrap in this block
    n_diff = 0
    for amp in (2.0 ** 20, 1.2 * 2.0 ** 23):
        y = torch.randn(F, K, generator=g) * amp
        sf = torch.rand(F, 2, generator=g) - 0.5
        card = dither_window(tab, randmap, ptr, last, K, size)
        host = dither_window(tab.to(cpu), randmap.to(cpu), ptr.to(cpu),
                             last.to(cpu), K, size)
        card += dither_quantize(y.cuda(), card[0], sf.cuda(), S24_MIN,
                                S24_MAX)
        host += dither_quantize(y, host[0], sf, S24_MIN, S24_MAX)
        for a, b in zip(card, host):
            n_diff += int((a.cpu() != b).sum())
        ptr, last = card[1], card[2]
    print(f"dither on the card vs the CPU at {F} x {K} (S24, normal and "
          f"clipping levels, {F // 5 + 1} channels wrapping): dither "
          f"floats, pointers, words, feedback and meters differ in "
          f"{n_diff} elements (must be 0)", flush=True)
    if n_diff:
        fail("the dither on the card is not bit-equal to the CPU's")


def time_io_halves(eng_aligned, eng_plain, flush):
    """Device time of the output half a block at the massive shape: with
    subdelay, delay and dither (phase 16's config) against the plain
    encode path, and each step alone."""
    import torch
    from brutefir_tpu_torch.config.model import OUT
    from brutefir_tpu_torch.ops.device_codec import encode_words
    from brutefir_tpu_torch.ops.device_dither import (dither_quantize,
                                                      dither_window)
    from brutefir_tpu_torch.runtime.device_io import (apply_delay,
                                                      apply_subdelay)
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    y = torch.randn(F, K, generator=g, device="cuda") * 2.0 ** 20
    ones = torch.ones(F, device="cuda")
    dio = eng_aligned.dio
    sd, dl, ds = dio._sd[OUT], dio._dly[OUT], dio.dstate
    tab, randmap, size = dio._dither
    sel, _, open_ch, fmt = eng_plain.dio._out_devs[0]

    def dither():
        d, _, _ = dither_window(tab, randmap, ds["ptr"], ds["last"], K, size)
        return dither_quantize(y, d, ds["sf"], S24_MIN, S24_MAX)

    parts = (
        ("output_half, subdelay + delay + dither (phase 16's config)",
         lambda: dio.output_half(y, ones)),
        ("output_half, plain encode (the massive config)",
         lambda: eng_plain.dio.output_half(y, ones)),
        ("  the subdelay FFTs (apply_subdelay)",
         lambda: apply_subdelay(y, ds["sdr_out"], sd["hrows"], sd["byp"],
                                sd["B"])),
        ("  the delay gather (apply_delay)",
         lambda: apply_delay(y, ds["dlw_out"], dl["arr"], dl["W"])),
        ("  the dither (dither_window + dither_quantize)", dither),
        ("  the plain quantize (encode_words)",
         lambda: encode_words(y, fmt, sel, open_ch, torch.int32)))
    for label, fn in parts:
        # a spin of about 20 ms: the host enqueues every launch of the
        # call before the card reaches the first event
        print(f"device time a block at {F} x {K}: {label} "
              f"{time_ms(fn, REPS, flush, 20 * SPIN_CYCLES):.4f} ms "
              f"(median of {REPS}, CUDA events, L2 flushed by a read "
              f"before each)", flush=True)


def main_aligned(main, mods: dict, launched: dict):
    import torch
    from brutefir_tpu_torch.config import parse_config
    from brutefir_tpu_torch.core.dither import DitherTable
    from brutefir_tpu_torch.runtime.engine import Engine
    label = "massive, time-aligned and dithered"
    frames = int(BLOCKS * K)
    blocks = int(np.ceil(BLOCKS))
    taps, x = write_massive_inputs(np.random.default_rng(SEED + 12), frames)
    t0 = time.perf_counter()
    table = DitherTable(F, 44100, 0, K)
    gen_s = time.perf_counter() - t0
    print(f"dither table for {F} channels at 44.1 kHz: {table.size} bytes "
          f"in {gen_s:.3f} s on the host (must be under 2 s)", flush=True)
    if gen_s >= 2.0:
        fail(f"the dither table took {gen_s:.3f} s")
    cfg = aligned_config("aligned.conf")
    for m in mods.values():
        m.reset_launches()
    y = run_main(main, cfg, frames, F, label, width=3)
    counts = all_counts(mods)
    expect_only(counts, {"uniform": blocks, **glue_want(blocks, blocks)},
                label)
    err = y - aligned_oracle(x, taps[0])
    worst = np.abs(err).max(axis=0)
    rms = np.sqrt(np.mean(err ** 2, axis=0))
    print(f"main path ({label}): max |y - oracle| {worst.max():.3f} LSB "
          f"(tol {LSB_TOL}) on all {F} channels; error RMS "
          f"{rms.min():.3f} .. {rms.max():.3f} LSB (band "
          f"{DITHER_RMS[0]} .. {DITHER_RMS[1]}: dithered)", flush=True)
    if worst.max() > LSB_TOL:
        fail(f"{label} off the float64 oracle by {worst.max():.3f} LSB")
    if not (DITHER_RMS[0] <= rms.min() and rms.max() <= DITHER_RMS[1]):
        fail(f"{label}: error RMS outside the dither band")
    key = ("mac_mix", "uniform")
    launched[key] = launched.get(key, 0) + counts[key]
    add_glue(launched, counts)
    with open(cfg) as fh:
        eng = Engine(parse_config(fh.read()))
    dither_card_vs_cpu(eng.dio)
    with open(massive_config("run1.conf", False)) as fh:
        plain = Engine(parse_config(fh.read()))
    flush = read_flush()
    time_io_halves(eng, plain, flush)
    del eng, plain, flush
    torch.cuda.empty_cache()
    return y


def config_oracle(cfg: str, taps: dict, x) -> np.ndarray:
    """The float64 output [frames, C_out] at integer output scale of a
    single-stage config read by the port's parser: per filter the
    convolution of its scaled input mix with ``taps[coeff index]``, summed
    into its outputs with their scales (runtime/control.py's mixes)."""
    from scipy.signal import fftconvolve
    from brutefir_tpu_torch.config import parse_config
    from brutefir_tpu_torch.config.model import IN, OUT
    with open(cfg) as fh:
        conf = parse_config(fh.read())

    def scale(io, ch):
        return conf.physical_format(io, conf.virt2phys[io][ch]).scale

    frames = x.shape[0]
    y = np.zeros((frames, conf.n_channels[OUT]))
    for f in conf.filters:
        xin = sum(s * scale(IN, ch) * x[:, ch].astype(np.float64)
                  for ch, s in f.in_channels)
        z = fftconvolve(xin, taps[f.coeff])[:frames]
        for ch, s in f.out_channels:
            y[:, ch] += s / scale(OUT, ch) * z
    return y


def write_float_example(work: str, example: str, frames: int, n_taps: int,
                        coeff_files, seed: int, script: str = ""):
    """An example config with FLOAT_LE input ``input.f32`` (2 channels,
    std 0.1), S24_LE output ``output.s24`` and seeded ``n_taps``-tap TEXT
    coefficients (||h||_2 = 0.5) for ``coeff_files``, all in ``work``;
    with ``script``, a CLI logic module running it. Returns (taps by
    coefficient index, x, config path)."""
    rng = np.random.default_rng(seed)
    with open(os.path.join(REPO, "examples", example)) as fh:
        text = fh.read()
    x = (rng.standard_normal((frames, 2)) * 0.1).astype("<f4")
    x.tofile(os.path.join(work, "input.f32"))
    text = text.replace('"input.f32"', f'"{os.path.join(work, "input.f32")}"')
    text = text.replace('"output.s24"',
                        f'"{os.path.join(work, "output.s24")}"')
    taps = {}
    for i, name in enumerate(coeff_files):
        h = rng.standard_normal(n_taps) * np.exp(-np.arange(n_taps)
                                                 / (n_taps / 8))
        h = (0.5 * h / np.linalg.norm(h)).astype(np.float32)
        with open(os.path.join(work, name), "w") as fh:
            fh.write("\n".join(repr(float(v)) for v in h) + "\n")
        text = text.replace(f'"{name}"', f'"{os.path.join(work, name)}"')
        taps[i] = h.astype(np.float64)
    if script:
        text = text.replace(
            "sampling_rate: 44100;",
            f'sampling_rate: 44100;\nlogic: "cli" {{ script: "{script}"; '
            f'echo: false; }};', 1)
    path = os.path.join(work, example)
    with open(path, "w") as fh:
        fh.write(text)
    return taps, x, path


def delayed(z, d0: int, changes=()):
    """``z`` through a delay line of delay ``d0`` changed at runtime by
    ``changes`` [(first sample, new delay)]: an increase to ``new``
    silences the first ``new`` samples from its change on, then reads z
    ``new`` samples back; a decrease reads the true samples ``new`` back
    (update_delays' rule)."""
    out = np.zeros_like(z)
    n = np.arange(z.shape[0])
    bounds = [(0, d0, False)] + [(n0, d, d > prev) for (n0, d), prev in
                                 zip(changes, [d0] + [c[1] for c in
                                                      changes[:-1]])]
    for k, (n0, d, silence) in enumerate(bounds):
        n1 = bounds[k + 1][0] if k + 1 < len(bounds) else z.shape[0]
        seg = (n >= n0) & (n < n1) & (n >= d)
        if silence:
            seg &= n >= n0 + d
        out[seg] = z[n[seg] - d]
    return out


XO_BLOCKS = 19.5
XO_N = 4096
# block 8 raises output 2's delay from 90 to 300, block 12 lowers output
# 3's from 90 to 20 (one script line a block; ``sleep bN`` skips N)
XO_SCRIPT = "sleep b7\ncod 2 300; sleep b3\ncod 3 20; sleep b99999"


def main_crossover(main, mods: dict, launched: dict):
    label = "crossover_2way.conf, cod at blocks 8 and 12"
    frames = int(XO_BLOCKS * XO_N)
    blocks = int(np.ceil(XO_BLOCKS))
    taps, x, cfg = write_float_example(WORK, "crossover_2way.conf", frames,
                                       4 * XO_N, ("lp.txt", "hp.txt"),
                                       SEED + 15, XO_SCRIPT)
    with open(cfg) as fh:
        text = fh.read()
    old = "delay: 0, 0, 90, 90;"
    if old not in text:
        fail("could not add maxdelay to the crossover example")
    with open(cfg, "w") as fh:
        fh.write(text.replace(old, old + " maxdelay: 512;", 1))
    for m in mods.values():
        m.reset_launches()
    y = run_main(main, cfg, frames, 4, label, out="output.s24", width=3)
    counts = all_counts(mods)
    expect_only(counts, {"rows": blocks, **glue_want(blocks, blocks)}, label)
    z = config_oracle(cfg, taps, x)
    ref = np.stack([z[:, 0], z[:, 1],
                    delayed(z[:, 2], 90, [(8 * XO_N, 300)]),
                    delayed(z[:, 3], 90, [(12 * XO_N, 20)])], axis=1)
    worst = np.abs(y - ref).max(axis=0)
    quiet = np.abs(y[8 * XO_N:8 * XO_N + 300, 2]).max()
    print(f"main path ({label}): max |y - oracle| per channel "
          f"{', '.join(f'{w:.3f}' for w in worst)} LSB (tol {LSB_TOL}); "
          f"channel 2 on the 300 silenced samples from {8 * XO_N}: max |y| "
          f"{quiet} LSB (dither only)", flush=True)
    if worst.max() > LSB_TOL:
        fail(f"{label} off the float64 oracle")
    key = ("mac_mix", "rows")
    launched[key] = launched.get(key, 0) + counts[key]
    add_glue(launched, counts)


XTC_FRAMES = 2 * 44100
XTC_N, XTC_B = 64, 64


def check_small_partitions(tm, tg):
    """The unfused MAC's launch plan and kernel, and the glue kernels, at
    the XTC example's K = M = 64 (4 filters), against their plain
    versions; then their float64 forms."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    print(f"mac plan at Fs = 4, K = {XTC_N}: {tm.launch_plan(1, 4, XTC_N)}",
          flush=True)
    ring, bank, idx, mask, stage = mac_inputs(g, 4, XTC_B, XTC_N, 2, False,
                                              [0, 1, 2, 3])
    rt = torch.tensor(stage, dtype=torch.int32, device=dev)
    worst = 0.0
    for tv in (0, 5, XTC_B - 1, XTC_B, 2 * XTC_B + 5):
        t = torch.tensor(tv, dtype=torch.int32, device=dev)
        rel, _ = check("mac_rows (K = 64)",
                       tm.mac(ring, bank, rt, idx, mask, t, False),
                       tm.mac_reference(ring, bank, rt, idx, mask, t, False),
                       tv)
        worst = max(worst, rel)
    x = torch.randn(2, 2 * XTC_N, generator=g, device=dev)
    Z = torch.fft.fft(torch.view_as_complex(x.reshape(2, XTC_N, 2)), dim=-1)
    p = torch.randn(4, 2, XTC_N, generator=g, device=dev)
    for name, kern, plain in (
            ("glue_fwd", lambda: tg.glue_fwd(Z),
             lambda: tg.glue_fwd_reference(Z)),
            ("glue_inv", lambda: torch.view_as_real(tg.glue_inv(p)),
             lambda: torch.view_as_real(tg.glue_inv_reference(p)))):
        rel, _ = check(f"{name} (M = 64)", kern(), plain(), "-")
        worst = max(worst, rel)
    print(f"mac_rows and the glue at K = M = {XTC_N}: max rel err "
          f"{worst:.3e} (tol {REL_TOL:g}); checked, not timed", flush=True)
    # the float64 forms at the same shapes
    worst = 0.0
    print(f"mac plan at Fs = 4, K = {XTC_N}, float64: "
          f"{tm.launch_plan(1, 4, XTC_N, torch.float64)}", flush=True)
    ring, bank, mask = ring.double(), bank.double(), mask.double()
    for tv in (0, 5, XTC_B - 1, XTC_B, 2 * XTC_B + 5):
        t = torch.tensor(tv, dtype=torch.int32, device=dev)
        rel, _ = check("mac_rows_f64 (K = 64)",
                       tm.mac(ring, bank, rt, idx, mask, t, False),
                       tm.mac_reference(ring, bank, rt, idx, mask, t, False),
                       tv, REL_TOL_F64)
        worst = max(worst, rel)
    Z, p = Z.to(torch.complex128), p.double()
    for name, kern, plain in (
            ("glue_fwd_f64", lambda: tg.glue_fwd(Z),
             lambda: tg.glue_fwd_reference(Z)),
            ("glue_inv_f64", lambda: torch.view_as_real(tg.glue_inv(p)),
             lambda: torch.view_as_real(tg.glue_inv_reference(p)))):
        rel, _ = check(f"{name} (M = 64)", kern(), plain(), "-", REL_TOL_F64)
        worst = max(worst, rel)
    print(f"mac_rows_f64 and the float64 glue at K = M = {XTC_N}: max rel "
          f"err {worst:.3e} (tol {REL_TOL_F64:g}); checked, not timed",
          flush=True)


def main_xtc(main, tm, tg, mods: dict, launched: dict):
    check_small_partitions(tm, tg)
    label = "xtc_lowlatency.conf"
    frames = XTC_FRAMES
    blocks = -(-frames // XTC_N)
    taps, x, cfg = write_float_example(WORK, "xtc_lowlatency.conf", frames,
                                       XTC_N * XTC_B,
                                       ("direct.txt", "cross.txt"),
                                       SEED + 17)
    for m in mods.values():
        m.reset_launches()
    y = run_main(main, cfg, frames, 2, label, out="output.s24", width=3)
    counts = all_counts(mods)
    expect_only(counts, {"mac_rows": blocks, **glue_want(blocks, blocks)},
                label)
    worst = np.abs(y - config_oracle(cfg, taps, x)).max(axis=0)
    print(f"main path ({label}): {blocks} blocks of {XTC_N}; max |y - "
          f"oracle| per channel {', '.join(f'{w:.3f}' for w in worst)} LSB "
          f"(tol {LSB_TOL})", flush=True)
    if worst.max() > LSB_TOL:
        fail(f"{label} off the float64 oracle")
    key = ("mac", "mac_rows")
    launched[key] = launched.get(key, 0) + counts[key]
    add_glue(launched, counts)


BENCH_BLOCKS = 40.5      # phase 19: 41 periods, 4 stage-table lines
DEBUG_BLOCKS = 19.5      # phase 19's debug run
TABLE_PREFIXES = ("decode/ms", "decode ")


def mode_config(name: str, mode: str, inp: str = "input.raw") -> str:
    """massive_config's shared-coefficient config with ``mode`` (such as
    ``benchmark: true;``) and its input file ``inp`` in WORK."""
    path = massive_config(name, False)
    with open(path) as fh:
        text = fh.read()
    old = "show_progress: false;"
    if old not in text:
        fail("could not add a mode to the massive example config")
    text = text.replace(old, f"{old}\n{mode}", 1)
    text = text.replace(os.path.join(WORK, "input.raw"),
                        os.path.join(WORK, inp))
    with open(path, "w") as fh:
        fh.write(text)
    return path


def debug_events(err: str):
    """The dumped debug timeline as {stage: [(event, period)]}."""
    if "debug timeline (" not in err:
        fail("debug: true dumped no timeline")
    ev, stage, blk = {}, None, None
    for ln in err[err.index("debug timeline ("):].splitlines()[1:]:
        if ln.endswith("_process:"):
            stage = ln[:-len("_process:")]
            ev[stage] = []
        elif ln.startswith("  period "):
            blk = int(ln[len("  period "):-1])
        elif ln.startswith("    ") and "\t" in ln:
            ev[stage].append((ln.split("\t", 1)[1], blk))
    return ev


def main_benchmark(main, mods: dict, launched: dict):
    """Phase 19: the massive shape under benchmark: true (run(), the stage
    table), then with the stage probe's calibration, then debug: true."""
    from brutefir_tpu_torch.runtime import stageprobe
    rng = np.random.default_rng(SEED + 19)
    frames = int(BENCH_BLOCKS * K)
    blocks = int(np.ceil(BENCH_BLOCKS))
    taps, x = write_massive_inputs(rng, frames)
    cfg = mode_config("bench.conf", "benchmark: true;")
    ys = []
    n_probe = 1 + stageprobe.CALLS * stageprobe.REPS
    for breakdown in (None, "1"):
        label = ("massive, benchmark: true"
                 + (", BRUTEFIR_TPU_STAGE_BREAKDOWN=1" if breakdown else ""))
        for m in mods.values():
            m.reset_launches()
        with knob("BRUTEFIR_TPU_STAGE_BREAKDOWN", breakdown):
            y, err = run_main(main, cfg, frames, F, label, with_err=True)
        counts = all_counts(mods)
        probe = n_probe if breakdown else 0
        expect_only(counts, {"uniform": blocks, "mac_rows": probe,
                             **glue_want(blocks + probe, blocks + probe)},
                    label)
        table = [ln for ln in err.splitlines()
                 if ln.startswith(TABLE_PREFIXES)]
        calib = [ln for ln in err.splitlines()
                 if ln.startswith("device stage calibration")]
        for ln in calib + table:
            print(f"  {ln}", flush=True)
        if len(table) != blocks // 10:
            fail(f"{label}: {len(table)} stage-table lines, expected "
                 f"{blocks // 10}")
        if breakdown and (len(calib) != 1 or not all(
                f" {k} " in calib[0] for k in stageprobe.STAGES)):
            fail(f"{label}: no calibration line naming every stage")
        launched[("mac_mix", "uniform")] += counts[("mac_mix", "uniform")]
        launched[("mac", "mac_rows")] += counts[("mac", "mac_rows")]
        add_glue(launched, counts)
        ys.append(y)
    if not np.array_equal(ys[0], ys[1]):
        fail("the calibrated benchmark run's output differs from the first")
    lsb = oracle_lsb(ys[0], x, lambda c: taps[0])
    print(f"main path (massive, benchmark: true): max |y - oracle| {lsb} "
          f"LSB (tol {LSB_TOL}) on all {F} channels; the calibrated run "
          f"bit-equal", flush=True)
    if lsb > LSB_TOL:
        fail(f"benchmark run off the float64 oracle by {lsb} LSB")

    label = "massive, debug: true"
    dframes = int(DEBUG_BLOCKS * K)
    dblocks = int(np.ceil(DEBUG_BLOCKS))
    x[:dframes].tofile(os.path.join(WORK, "input_debug.raw"))
    cfg = mode_config("debug.conf", "debug: true;", "input_debug.raw")
    for m in mods.values():
        m.reset_launches()
    y, err = run_main(main, cfg, dframes, F, label, with_err=True)
    counts = all_counts(mods)
    expect_only(counts, {"uniform": dblocks,
                         **glue_want(dblocks, dblocks)}, label)
    # the debug run's last block is half input, half zero padding: its
    # transforms round differently, so it is held to 1 LSB, the rest to
    # the bit
    full = int(DEBUG_BLOCKS) * K
    tail = int(np.abs(y[full:].astype(np.int64)
                      - ys[0][full:dframes]).max())
    if not np.array_equal(y[:full], ys[0][:full]) or tail > 1:
        fail("the debug run's output differs from the benchmark run's")
    ev = debug_events(err)
    for stage, call in (("input", "call read"), ("filter", "call dispatch"),
                        ("output", "call write")):
        got = ev.get(stage, [])
        want = [e for b in range(dblocks) for e in ((call, b), ("ret", b))]
        if [(e if e == call else e.split()[0], b) for e, b in got] != want:
            fail(f"debug timeline: the {stage} section is not one call/ret "
                 f"pair a period over {dblocks} periods")
    print(f"main path ({label}): output bit-equal to the benchmark run's "
          f"first {full} frames, its last half block within {tail} LSB; "
          f"timeline: one call/ret pair a period for input, filter and "
          f"output over {dblocks} periods", flush=True)
    launched[("mac_mix", "uniform")] += counts[("mac_mix", "uniform")]
    add_glue(launched, counts)


EQ_EXAMPLE = os.path.join(REPO, "examples", "room_correction_eq.conf")
EQ_N, EQ_B, EQ_RATE = 8192, 8, 48000
EQ_BLOCKS = 19.5
EQ_MAG = "63/3,1000/0,8000/-2"
EQ_SCRIPT = f"sleep b7\nlmc eq 0 mag {EQ_MAG}\nsleep b99999"
EQ_TOL = 2e-5            # of the output's peak, FLOAT_LE


def eq_config(work: str, name: str, sock: str = "", script: str = "") -> str:
    """examples/room_correction_eq.conf as shipped, its files in ``work``
    and its CLI socket at ``sock``, or (``script``) a CLI script in place
    of the socket."""
    with open(EQ_EXAMPLE) as fh:
        text = fh.read()
    old = '"cli" { port: "/tmp/brutefir.sock"; }'
    if old not in text:
        fail("could not find the EQ example's CLI socket")
    new = (f'"cli" {{ script: "{script}"; echo: false; }}' if script
           else f'"cli" {{ port: "{sock}"; }}')
    text = text.replace(old, new)
    text = text.replace('"input.f32"', f'"{os.path.join(work, "input.f32")}"')
    text = text.replace('"output.f32"',
                        f'"{os.path.join(work, "output.f32")}"')
    path = os.path.join(work, name)
    with open(path, "w") as fh:
        fh.write(text)
    return path


def socket_talk(path: str, lines) -> str:
    """Send ``lines`` and ``quit`` to a CLI on a Unix socket; its
    replies."""
    import socket
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(60)
    s.connect(path)
    s.sendall(("".join(ln + "\n" for ln in lines) + "quit\n").encode())
    got = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break
        got += chunk
    s.close()
    return got.decode()


def eq_oracle(x, impulses, switch: int):
    """The float64 output: ``x`` convolved with impulses[0] before sample
    ``switch`` and with impulses[1] from it on."""
    from scipy.signal import fftconvolve
    n = x.shape[0]
    ys = [fftconvolve(x.T.astype(np.float64), h[None].astype(np.float64),
                      axes=1)[:, :n].T for h in impulses]
    return np.where(np.arange(n)[:, None] < switch, ys[0], ys[-1])


def time_eq_commands(eq, label: str):
    """Host ms of three EQ commands (render + preprocess + bank update),
    and ms until the card has the new bank; the last leaves the EQ at
    EQ_MAG."""
    import torch
    for val in ("63/0", "63/6", EQ_MAG):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok, msg = eq.command(f"0 mag {val}")
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not ok:
            fail(f"EQ command refused ({label}): {msg.strip()}")
        print(f"EQ command ({label}): 0 mag {val}: host "
              f"{(t1 - t0) * 1e3:.3f} ms (render + preprocess + bank "
              f"update), {(t2 - t0) * 1e3:.3f} ms until the card has the "
              f"bank", flush=True)


def eq_scale_config(work: str) -> str:
    """The 256-channel scale shape (8192 x 16, 256 coefficient sets) with
    the EQ example's equaliser on sets 0 and 1: its bank of 257 sets
    (269 MB) is what one EQ command copies."""
    C = SCALE_C
    coeffs = "\n".join(f'coeff {i} {{ filename: "dirac pulse"; '
                       f'shared_mem: true; }};' for i in range(C))
    chans = ", ".join(str(i) for i in range(C))
    filters = "\n".join(
        f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; coeff: {i}; }};"
        for i in range(C))
    path = os.path.join(work, "eq_scale.conf")
    with open(path, "w") as fh:
        fh.write(f"""
sampling_rate: {EQ_RATE};
filter_length: {K},{B};
logic: "eq" {{ coeff: 0, 1; bands: "ISO 1/3 octave"; }};
{coeffs}
input {chans} {{ device: "file" {{ path: "/dev/zero"; }}; sample: "FLOAT_LE"; channels: {C}; }};
output {chans} {{ device: "file" {{ path: "/dev/null"; }}; sample: "FLOAT_LE"; channels: {C}; }};
{filters}
""")
    return path


def main_eq(main, mods: dict, launched: dict):
    """Phase 20: examples/room_correction_eq.conf over its CLI socket,
    then a script variant changing the EQ at block 8 through main()."""
    import torch
    from brutefir_tpu_torch.config import parse_config
    from brutefir_tpu_torch.runtime.engine import Engine
    frames = int(EQ_BLOCKS * EQ_N)
    blocks = int(np.ceil(EQ_BLOCKS))
    rng = np.random.default_rng(SEED + 20)
    x = (rng.standard_normal((frames, 2)) * 0.1).astype("<f4")
    x.tofile(os.path.join(WORK, "input.f32"))
    sock = os.path.join(WORK, "eq.sock")
    if len(sock) > 100:                   # sun_path holds 108 bytes
        sock = os.path.relpath(sock)
    with open(eq_config(WORK, "eq_socket.conf", sock=sock)) as fh:
        eng = Engine(parse_config(fh.read()))
    eng.attach_logic()
    eng.setup()
    cli, eq = eng.logic
    try:
        h_flat = eq.render_impulse(eq.equalisers[0])
        reply = socket_talk(sock, ["lmc eq 0 info",
                                   f"lmc eq 0 mag {EQ_MAG}"])
        print("CLI socket replies:\n" + "".join(
            f"  {ln}\n" for ln in reply.splitlines()), end="", flush=True)
        if not (reply.startswith("coefficient 0,1:\n band:")
                and reply.endswith("ok\n") and "Command failed" not in reply):
            fail("unexpected EQ replies over the CLI socket")
        h_new = eq.render_impulse(eq.equalisers[0])
        time_eq_commands(eq, "the example's bank, 3 sets of 8 x 8192")
        for m in mods.values():
            m.reset_launches()
        label = "room_correction_eq.conf after the socket commands"
        out = os.path.join(WORK, "output.f32")
        stats = eng.run(setup=False)
        eng.teardown()
    finally:
        cli.close()
    counts = all_counts(mods)
    expect_only(counts, {"uniform": blocks, **glue_want(blocks, blocks)},
                label)
    y = np.fromfile(out, "<f4").reshape(-1, 2)
    ref = eq_oracle(x, [h_new], 0)
    err = np.abs(y - ref).max() / np.abs(ref).max()
    print(f"main path ({label}): {stats['blocks']} blocks, {y.shape[0]} "
          f"frames; max |y - oracle| {err:.3e} of the peak (tol "
          f"{EQ_TOL:g})", flush=True)
    if y.shape != x.shape or not err <= EQ_TOL:
        fail(f"{label} off the float64 oracle")
    key = ("mac_mix", "uniform")
    launched[key] += counts[key]
    add_glue(launched, counts)

    label = "room_correction_eq.conf, lmc eq at block 8 from a script"
    cfg = eq_config(WORK, "eq_script.conf", script=EQ_SCRIPT)
    for m in mods.values():
        m.reset_launches()
    y = run_main(main, cfg, frames, 2, label, out="output.f32",
                 dtype="<f4", rate=EQ_RATE)
    counts = all_counts(mods)
    expect_only(counts, {"uniform": blocks, **glue_want(blocks, blocks)},
                label)
    ref = eq_oracle(x, [h_flat, h_new], 8 * EQ_N)
    err = np.abs(y - ref).max() / np.abs(ref).max()
    moved = np.abs(eq_oracle(x, [h_flat], 0) - ref).max() / np.abs(ref).max()
    print(f"main path ({label}): max |y - oracle| {err:.3e} of the peak "
          f"(tol {EQ_TOL:g}); the flat EQ's output is {moved:.3e} of the "
          f"peak away from it", flush=True)
    if not err <= EQ_TOL or not moved > 100 * EQ_TOL:
        fail(f"{label} off the float64 oracle")
    launched[key] += counts[key]
    add_glue(launched, counts)

    with open(eq_scale_config(WORK)) as fh:
        eng = Engine(parse_config(fh.read()))
    eng.attach_logic()
    print(f"bank at the scale shape: {tuple(eng.bank.shape)}, "
          f"{eng.bank.numel() * 4 / 1e6:.0f} MB", flush=True)
    time_eq_commands(eng.logic[0], "the scale shape's bank")
    del eng
    torch.cuda.empty_cache()


# ---- phases 21-23: the host codec path ------------------------------------

HOST_BLOCKS = 19.5       # phases 21-23: run() block by block, a half block


def s24_bytes(x, big: bool) -> np.ndarray:
    """int32 words -> their 3-byte files' bytes, little- or big-endian."""
    b = x.astype("<i4").view(np.uint8).reshape(x.shape + (4,))[..., :3]
    return np.ascontiguousarray(b[..., ::-1] if big else b)


def retarget(path: str, pairs) -> str:
    """Rewrite a config file with each (old, new, count) replaced
    exactly ``count`` times."""
    with open(path) as fh:
        text = fh.read()
    for old, new, count in pairs:
        if text.count(old) != count:
            fail(f"{os.path.basename(path)}: {old!r} found "
                 f"{text.count(old)} times, expected {count}")
        text = text.replace(old, new)
    with open(path, "w") as fh:
        fh.write(text)
    return path


def hostcodec_config(name: str, fmt: str, ext: str) -> str:
    """The massive shared-coefficient config with ``fmt`` on its input and
    its output device, the files ``input.<ext>`` and ``output.<ext>``."""
    return retarget(massive_config(name, False), (
        ('sample: "S24_4LE";', f'sample: "{fmt}";', 2),
        (os.path.join(WORK, "input.raw"), os.path.join(WORK, f"input.{ext}"),
         1),
        (os.path.join(WORK, "output.raw"),
         os.path.join(WORK, f"output.{ext}"), 1)))


@contextlib.contextmanager
def timed_method(cls, name: str, acc: list):
    """Time every call of ``cls.name`` into ``acc`` (seconds) while the
    block runs."""
    fn = getattr(cls, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc.append(time.perf_counter() - t0)

    setattr(cls, name, timed)
    try:
        yield acc
    finally:
        setattr(cls, name, fn)


def expect_native(calls: dict, want: dict, label: str):
    """The native codec's call counts of a run (``core.native.calls``)
    against ``want``; the library must be built."""
    from brutefir_tpu_torch.core import native
    print(f"native codec calls in this run ({label}): {calls}; library "
          f"{native.library_path().name}", flush=True)
    if not native.library_path().exists():
        fail(f"{label}: the native codec was not built")
    for key, n in want.items():
        if calls[key] != n:
            fail(f"{label}: native {key} called {calls[key]} times, "
                 f"expected {n}")


def main_hostcodec(main, mods: dict, launched: dict):
    """Phase 21: the massive shape with S24_BE devices (the host codec
    path) through main(), then the same samples as S24_LE through the
    device-IO path block by block: within 1 LSB of each other."""
    from brutefir_tpu_torch.config import parse_config
    from brutefir_tpu_torch.core import native
    from brutefir_tpu_torch.runtime.engine import Engine
    label = "massive, S24_BE through the host codec"
    frames = int(HOST_BLOCKS * K)
    blocks = int(np.ceil(HOST_BLOCKS))
    taps, x = write_massive_inputs(np.random.default_rng(SEED + 21), frames)
    s24_bytes(x, True).tofile(os.path.join(WORK, "input.s24be"))
    s24_bytes(x, False).tofile(os.path.join(WORK, "input.s24le"))
    cfg = hostcodec_config("host.conf", "S24_BE", "s24be")
    for m in mods.values():
        m.reset_launches()
    native.reset_calls()
    y = run_main(main, cfg, frames, F, label, out="output.s24be", width=3,
                 dtype=">i4")
    counts, calls = all_counts(mods), dict(native.calls)
    expect_only(counts, {"uniform": blocks, **glue_want(blocks, blocks)},
                label)
    expect_native(calls, {"decode_f32": blocks, "encode_int": blocks,
                          "quantize_rows_no_dither": blocks,
                          "dither_quantize": 0}, label)
    lsb = oracle_lsb(y, x, lambda c: taps[0])
    print(f"main path ({label}): max |y - oracle| {lsb} LSB (tol "
          f"{LSB_TOL}) on all {F} channels", flush=True)
    if lsb > LSB_TOL:
        fail(f"{label} off the float64 oracle by {lsb} LSB")
    key = ("mac_mix", "uniform")
    launched[key] += counts[key]
    add_glue(launched, counts)

    dlabel = "massive, S24_LE through the device-IO path, run()"
    with open(hostcodec_config("dev.conf", "S24_LE", "s24le")) as fh:
        eng = Engine(parse_config(fh.read()))
    if eng.dio is None:
        fail(f"{dlabel}: not on the device-IO path")
    for m in mods.values():
        m.reset_launches()
    t0 = time.perf_counter()
    eng.run()
    wall = time.perf_counter() - t0
    counts = all_counts(mods)
    expect_only(counts, {"uniform": blocks, **glue_want(blocks, blocks)},
                dlabel)
    launched[key] += counts[key]
    add_glue(launched, counts)
    yd = read_s24_3(os.path.join(WORK, "output.s24le")).reshape(frames, F)
    d = np.abs(y.astype(np.int64) - yd)
    print(f"host codec path vs device-IO path on the same samples: "
          f"{np.mean(d == 0) * 100:.4f}% of {d.size} words equal, max "
          f"|diff| {d.max()} LSB (tol 1); device path run() "
          f"{wall / blocks * 1e3:.3f} ms a block", flush=True)
    if d.max() > 1:
        fail("the host codec path is more than 1 LSB off the device path")


def main_hostcodec_aligned(main, mods: dict, launched: dict, y16):
    """Phase 22: phase 16's config and input with S24_BE outputs: the
    host delay lines, subsample delays and native dither."""
    from brutefir_tpu_torch.core import native
    from brutefir_tpu_torch.core.delayline import DelayLine
    from brutefir_tpu_torch.core.dither import DitherState
    from brutefir_tpu_torch.runtime.engine import Engine
    from brutefir_tpu_torch.runtime.subdelay import SubsampleDelay
    label = "massive, time-aligned and dithered, S24_BE (host codec)"
    frames = int(BLOCKS * K)
    blocks = int(np.ceil(BLOCKS))
    taps, x = write_massive_inputs(np.random.default_rng(SEED + 12), frames)
    cfg = retarget(aligned_config("aligned_be.conf"),
                   (('sample: "S24_LE";', 'sample: "S24_BE";', 1),))
    for m in mods.values():
        m.reset_launches()
    native.reset_calls()
    parts = {"SubsampleDelay.process": (SubsampleDelay, "process"),
             "DelayLine.process": (DelayLine, "process"),
             "DitherState.quantize": (DitherState, "quantize")}
    with contextlib.ExitStack() as stack:
        wtimes = stack.enter_context(timed_method(Engine, "write_block", []))
        ptimes = {k: stack.enter_context(timed_method(c, n, []))
                  for k, (c, n) in parts.items()}
        y = run_main(main, cfg, frames, F, label, width=3, dtype=">i4")
    counts, calls = all_counts(mods), dict(native.calls)
    expect_only(counts, {"uniform": blocks, **glue_want(blocks, blocks)},
                label)
    expect_native(calls, {"decode_f32": blocks, "encode_int": blocks,
                          "dither_quantize": F * blocks}, label)
    err = y - aligned_oracle(x, taps[0])
    worst = np.abs(err).max(axis=0)
    rms = np.sqrt(np.mean(err ** 2, axis=0))
    same = np.mean(y == y16) * 100
    print(f"main path ({label}): max |y - oracle| {worst.max():.3f} LSB "
          f"(tol {HOST_DITHER_TOL}) on all {F} channels; error RMS "
          f"{rms.min():.3f} .. {rms.max():.3f} LSB (band {DITHER_RMS[0]} "
          f".. {DITHER_RMS[1]}); {same:.4f}% of the words equal to phase "
          f"16's device-path output (not gated: the host and device "
          f"subdelays round differently); write_block (native dither of "
          f"{F} channels) {np.median(wtimes) * 1e3:.3f} ms a block on the "
          f"host (median of {len(wtimes)})", flush=True)
    print("  of it, host ms a block (all calls, on the writer thread): "
          + ", ".join(f"{k} {sum(v) / blocks * 1e3:.3f} ({len(v)} calls)"
                      for k, v in ptimes.items()), flush=True)
    if worst.max() > HOST_DITHER_TOL:
        fail(f"{label} off the float64 oracle by {worst.max():.3f} LSB")
    if not (DITHER_RMS[0] <= rms.min() and rms.max() <= DITHER_RMS[1]):
        fail(f"{label}: error RMS outside the dither band")
    key = ("mac_mix", "uniform")
    launched[key] += counts[key]
    add_glue(launched, counts)


def main_hostcodec_floats(main, mods: dict, launched: dict):
    """Phase 23: examples/crossover_2way.conf with a FLOAT_BE input and
    FLOAT64_LE outputs through main(): the per-filter fused MAC + mix."""
    from brutefir_tpu_torch.core import native
    label = "crossover_2way.conf, FLOAT_BE in, FLOAT64_LE out"
    frames = int(HOST_BLOCKS * XO_N)
    blocks = int(np.ceil(HOST_BLOCKS))
    taps, x, cfg = write_float_example(WORK, "crossover_2way.conf", frames,
                                       4 * XO_N, ("lp.txt", "hp.txt"),
                                       SEED + 23)
    x.astype(">f4").tofile(os.path.join(WORK, "input.f32be"))
    retarget(cfg, (('sample: "FLOAT_LE";', 'sample: "FLOAT_BE";', 1),
                   ('sample: "S24_LE";', 'sample: "FLOAT64_LE";', 1),
                   (os.path.join(WORK, "input.f32"),
                    os.path.join(WORK, "input.f32be"), 1),
                   (os.path.join(WORK, "output.s24"),
                    os.path.join(WORK, "output.f64"), 1)))
    for m in mods.values():
        m.reset_launches()
    native.reset_calls()
    y = run_main(main, cfg, frames, 4, label, out="output.f64",
                 dtype="<f8")
    counts, calls = all_counts(mods), dict(native.calls)
    expect_only(counts, {"rows": blocks, **glue_want(blocks, blocks)}, label)
    expect_native(calls, {"decode_f32": blocks, "encode_float": blocks},
                  label)
    z = config_oracle(cfg, taps, x)
    ref = np.stack([z[:, 0], z[:, 1], delayed(z[:, 2], 90),
                    delayed(z[:, 3], 90)], axis=1)
    err = np.abs(y - ref).max() / np.abs(ref).max()
    print(f"main path ({label}): max |y - oracle| {err:.3e} of the peak "
          f"(tol {FLOAT_TOL:g})", flush=True)
    if not err <= FLOAT_TOL:
        fail(f"{label} off the float64 oracle")
    key = ("mac_mix", "rows")
    launched[key] += counts[key]
    add_glue(launched, counts)

# ---- phases 24-25: logic-module hooks -------------------------------------

HOOK_BLOCKS = 40.5       # phase 24: 41 blocks through run(), a half block
HOOK_LEVEL = 2.0 ** 18   # phase 24's input std: the six gains' product
                         # reaches 3.2, so outputs stay clear of clipping
HOOK_KINDS = ("input_timed", "input_freqd", "pre_convolve", "post_convolve",
              "output_freqd", "output_timed")
COPY_BLOCK = 3           # phase 24: input_freqd copies channel 0 here
COPY_TOL = 1e-5          # of the copied spectrum's peak

# phase 24's module: all six hooks, each a fixed gain a channel or filter
# (0.5 .. 1.5, from the seed); input_freqd also copies channel 0's
# spectrum at COPY_BLOCK before its own gain; host seconds per kind
SPECTAP_MODULE = """
import time

import numpy as np

from brutefir_tpu_torch.control import register_logic_module

KINDS = {kinds!r}
GAINS = np.random.default_rng({seed}).uniform(0.5, 1.5, (len(KINDS), {c}))


class SpecTap:
    instances = []

    def __init__(self, params, engine):
        self.engine = engine
        self.block = -1
        self.copy = None
        self.calls = dict.fromkeys(KINDS, 0)
        self.seconds = dict.fromkeys(KINDS, 0.0)
        SpecTap.instances.append(self)
        for k, kind in enumerate(KINDS):
            setattr(self, kind, self._hook(kind, GAINS[k]))

    def block_start(self, k):
        self.block = k

    def _hook(self, kind, gains):
        def hook(buf, i):
            t0 = time.perf_counter()
            if (kind == "input_freqd" and i == 0
                    and self.block == {copy_block}):
                self.copy = buf.copy()
            buf *= gains[i]
            self.calls[kind] += 1
            self.seconds[kind] += time.perf_counter() - t0
        return hook


register_logic_module("spectap", SpecTap)
"""

# phase 25's module: post_convolve only, a gain a filter
XFGAIN_MODULE = """
import numpy as np

from brutefir_tpu_torch.control import register_logic_module

GAINS = np.random.default_rng({seed}).uniform(0.5, 1.5, {c})


class XfGain:
    instances = []

    def __init__(self, params, engine):
        self.engine = engine
        self.calls = 0
        XfGain.instances.append(self)

    def post_convolve(self, buf, f):
        buf *= GAINS[f]
        self.calls += 1


register_logic_module("xfgain", XfGain)
"""


def write_module(name: str, text: str, prefix: str = "bflogic") -> str:
    """A module file <prefix>_<name>.py in WORK/mods (a logic module, or
    with ``prefix`` "bfio" a device module); returns the folder (the
    config's modules_path)."""
    mods = os.path.join(WORK, "mods")
    os.makedirs(mods, exist_ok=True)
    with open(os.path.join(mods, f"{prefix}_{name}.py"), "w") as fh:
        fh.write(text)
    return mods


def loaded_module(name: str, prefix: str = "bflogic"):
    """The module object of the external module <prefix>_<name>."""
    mod = sys.modules.get(f"{prefix}_{name}")
    if mod is None:
        fail(f"{prefix}_{name} was not loaded")
    return mod


def with_module(cfg: str, name: str, mods: str, cli: bool = False) -> str:
    """Add ``modules_path`` and the logic module ``name`` to the config
    file ``cfg`` (after its CLI script module with ``cli``)."""
    if cli:
        return retarget(cfg, (("echo: false; };",
                               f'echo: false; }}, "{name}" {{ }};', 1),
                              ("show_progress: false;",
                               f'show_progress: false;\nmodules_path: '
                               f'"{mods}";', 1)))
    return retarget(cfg, (("show_progress: false;",
                           f'show_progress: false;\nmodules_path: '
                           f'"{mods}";\nlogic: "{name}" {{ }};', 1),))


def main_hooks(main, mods: dict, launched: dict):
    """Phase 24: the massive shape through main() with the external
    module bflogic_spectap.py defining all six hooks, then the same graph
    without it."""
    from brutefir_tpu_torch.runtime import engine as eng_mod
    label = "massive with a spectral logic module"
    frames = int(HOOK_BLOCKS * K)
    blocks = int(np.ceil(HOOK_BLOCKS))
    taps, x = write_massive_inputs(np.random.default_rng(SEED + 24), frames,
                                   HOOK_LEVEL)
    seed = SEED + 25
    folder = write_module("spectap", SPECTAP_MODULE.format(
        kinds=HOOK_KINDS, seed=seed, c=F, copy_block=COPY_BLOCK))
    gains = np.random.default_rng(seed).uniform(0.5, 1.5, (len(HOOK_KINDS),
                                                           F))
    cfg = with_module(massive_config("hooks.conf", False), "spectap", folder)
    for m in mods.values():
        m.reset_launches()
    with contextlib.ExitStack() as stack:
        wall = stack.enter_context(timed_method(eng_mod.Engine, "run_offline",
                                                []))
        fetch = stack.enter_context(timed_method(eng_mod, "_spectra_to_host",
                                                 []))
        upload = stack.enter_context(timed_method(
            eng_mod, "_spectra_to_device", []))
        y = run_main(main, cfg, frames, F, label)
    counts = all_counts(mods)
    inst = loaded_module("spectap").SpecTap.instances[-1]
    if inst.engine.dio is not None:
        fail(f"{label}: the engine kept the device-IO path")
    expect_only(counts, {"mac_uniform": blocks, **glue_want(blocks, blocks)},
                label)
    print(f"hook calls in this run ({label}): {inst.calls}", flush=True)
    for kind, n in inst.calls.items():
        if n != F * blocks:
            fail(f"{label}: {kind} called {n} times, expected {F * blocks}")
    # the oracle: each channel's convolution times the product of the
    # six gains along its path (input c -> filter c -> output c)
    lsb = oracle_lsb(y, x * gains.prod(axis=0), lambda c: taps[0])
    print(f"main path ({label}): max |y - oracle| {lsb} LSB (tol "
          f"{LSB_TOL}) on all {F} channels", flush=True)
    if lsb > LSB_TOL:
        fail(f"{label} off the float64 oracle by {lsb} LSB")
    # input_freqd's copy of channel 0 at COPY_BLOCK: the natural [N+1]
    # spectrum of the frame [prev, x] after input_timed's gain
    frame = gains[0, 0] * x[(COPY_BLOCK - 1) * K:(COPY_BLOCK + 1) * K, 0]
    ref = np.fft.rfft(frame.astype(np.float64))
    if inst.copy is None or inst.copy.shape != ref.shape:
        fail(f"{label}: input_freqd's copy is missing or not [N+1]")
    err = np.abs(inst.copy - ref).max() / np.abs(ref).max()
    print(f"input_freqd's copy of channel 0 at block {COPY_BLOCK}: "
          f"{inst.copy.dtype} {inst.copy.shape}, max |copy - rfft(frame)| "
          f"{err:.3e} of the peak (tol {COPY_TOL:g})", flush=True)
    if not err <= COPY_TOL:
        fail(f"{label}: input_freqd's spectrum is off np.fft.rfft")
    ms = {"wall": sum(wall) / blocks * 1e3,
          "fetch": sum(fetch) / blocks * 1e3,
          "upload": sum(upload) / blocks * 1e3,
          "hooks": sum(v for k, v in inst.seconds.items()
                       if k != "output_timed") / blocks * 1e3,
          "output_timed": inst.seconds["output_timed"] / blocks * 1e3}
    rest = ms["wall"] - ms["fetch"] - ms["upload"] - ms["hooks"]
    print(f"main path ({label}): {ms['wall']:.3f} ms a block in run(), "
          f"host: the taps' transfers {ms['fetch'] + ms['upload']:.3f} "
          f"(fetch {ms['fetch']:.3f}, which waits for the step's work "
          f"before each tap; upload {ms['upload']:.3f}; {len(fetch)} taps), "
          f"the hook calls on the main thread {ms['hooks']:.3f}, the rest "
          f"{rest:.3f}; output_timed on the writer thread "
          f"{ms['output_timed']:.3f}", flush=True)
    key = ("mac", "mac_uniform")
    launched[key] = launched.get(key, 0) + counts[key]
    add_glue(launched, counts)

    plain = "massive without the module, the same input"
    for m in mods.values():
        m.reset_launches()
    with timed_method(eng_mod.Engine, "run_offline", []) as wall0:
        y0 = run_main(main, massive_config("plain.conf", False), frames, F,
                      plain)
    counts = all_counts(mods)
    expect_only(counts, {"uniform": blocks, **glue_want(blocks, blocks)},
                plain)
    add_glue(launched, counts)
    launched[("mac_mix", "uniform")] += counts[("mac_mix", "uniform")]
    print(f"main path ({plain}): {sum(wall0) / blocks * 1e3:.3f} ms a "
          f"block in run_offline(), against {ms['wall']:.3f} with the "
          f"module; max |y| {np.abs(y0).max()} LSB", flush=True)


def main_xfade_hooks(main, mods: dict, launched: dict):
    """Phase 25: bench5 with a module whose post_convolve scales each
    filter: the stage loop's dual MAC on every crossfade block."""
    from brutefir_tpu_torch.graph import compile as tcomp
    label = "bench5 with a post_convolve module"
    N_, C = BENCH5_N, BENCH5_C
    frames = int(BLOCKS * N_)
    blocks = int(np.ceil(BLOCKS))
    taps, x, cfg = write_bench5_inputs(WORK, frames, SEED + 26)
    seed = SEED + 27
    folder = write_module("xfgain", XFGAIN_MODULE.format(seed=seed, c=C))
    gains = np.random.default_rng(seed).uniform(0.5, 1.5, C)
    cfg = with_module(cfg, "xfgain", folder, cli=True)
    for m in mods.values():
        m.reset_launches()
    with timed_method(tcomp, "_fused_xfade", []) as fused:
        y = run_main(main, cfg, frames, C, label)
    counts = all_counts(mods)
    inst = loaded_module("xfgain").XfGain.instances[-1]
    if fused or inst.engine.dio is not None:
        fail(f"{label}: the fused time-domain crossfade ran "
             f"{len(fused)} times, or the engine kept the device-IO path")
    # the stage loop: a crossfade block adds crossfade_spectra's forward
    # and two full inverse transforms
    xf = blocks - 1
    expect_only(counts, {"mac_dual_uniform": xf, "mac_uniform": 1,
                         **glue_want(blocks + xf, blocks + 2 * xf)}, label)
    if inst.calls != C * blocks:
        fail(f"{label}: post_convolve called {inst.calls} times")
    worst, peak = xfade_lsb(
        y.astype(np.float64), x, taps, N_,
        lambda k: "a" if k == 0 else ("ab" if k % 2 else "ba"),
        range(0, C, 5), gains)
    tol = 8e-6 * peak + 4.0
    print(f"main path ({label}): max |y - scaled ramp oracle| {worst:.3f} "
          f"LSB (tol 8e-6 * {peak:.0f} + 4 = {tol:.3f}) on channels 0, 5, "
          f"..., 25; the fused time-domain crossfade not taken", flush=True)
    if not worst <= tol:
        fail(f"{label} off the scaled float64 linear-ramp oracle")
    for key in (("mac_dual", "mac_dual_uniform"), ("mac", "mac_uniform")):
        launched[key] = launched.get(key, 0) + counts[key]
    add_glue(launched, counts)


# ---- phases 26-28: clocked devices, in a child process --------------------

CLOCKED_BLOCKS = 32       # phase 26: 5.9 s of audio at the massive shape
ALSA_BLOCKS = 400         # phase 27: the xtc example over the fake libasound
XTC_CLOCKED_BLOCKS = 2000  # phase 28: 2.9 s of audio in 64-sample blocks
FAKE_ASOUND = os.path.join(REPO, "tests", "fake_asound.c")
CHILD_ARG = "--clocked-child"

PACED_MODULE = '''"""bfio_paced: a sound card on the host's clock, for brutefir_tpu_torch.

device: "paced" { path: "<raw file>"; };

An input hands out fragment k (N frames of the file) no earlier than
t0 + (k + 1) N / fs, when a card would have captured it; t0 is the
first synch_start of any paced device. An output writes the file and
records, for each write after t0, its lateness against the time a card
starts playing it: t0 + (frames written before it) / fs, the two silent
fragments of the iodelay fill counted. A write with a positive lateness
missed its deadline.
"""

import time

from brutefir_tpu_torch.config.lexer import T
from brutefir_tpu_torch.io import IoDevice, IoModuleError, register_io_module


class PacedDevice(IoDevice):
    uses_sample_clock = True
    instances = []
    t0 = None

    def __init__(self, params, io, sample_format, sample_rate,
                 open_channels):
        super().__init__(params, io, sample_format, sample_rate,
                         open_channels)
        toks = [t for t in params if t.kind != T.EOF]
        if (len(toks) != 3 or toks[0].kind != T.FIELD
                or toks[0].value != "path" or toks[1].kind != T.STRING
                or toks[2].kind != T.EOS):
            raise IoModuleError('paced I/O: expected path: "<file>";')
        self.path = toks[1].value
        self.fh = None
        self.frames = 0
        self.lateness = []
        PacedDevice.instances.append(self)

    def init(self, period_size):
        self.fb = self.sample_format.bytes * self.open_channels
        self.fh = open(self.path, "rb" if self.io == 0 else "wb")
        PacedDevice.t0 = None

    def synch_start(self):
        if PacedDevice.t0 is None:
            PacedDevice.t0 = time.monotonic()

    def read(self, nbytes):
        self.frames += nbytes // self.fb
        wait = (PacedDevice.t0 + self.frames / self.sample_rate
                - time.monotonic())
        if wait > 0:
            time.sleep(wait)
        return self.fh.read(nbytes)

    def write(self, data):
        if PacedDevice.t0 is not None:
            self.lateness.append(time.monotonic() - PacedDevice.t0
                                 - self.frames / self.sample_rate)
        self.frames += len(data) // self.fb
        self.fh.write(data)
        return len(data)

    def close(self):
        if self.fh is not None:
            self.fh.close()
            self.fh = None


register_io_module("paced", PacedDevice)
'''


def to_paced(cfg: str, inp: str, out: str, mods: str) -> str:
    """The config file ``cfg`` with its file devices ``inp`` and ``out``
    (paths in WORK) on the paced module from ``mods``."""
    pairs = [(f'device: "file" {{ path: "{os.path.join(WORK, name)}"; }};',
              f'device: "paced" {{ path: "{os.path.join(WORK, name)}"; }};',
              1) for name in (inp, out)]
    pairs.append(("sampling_rate: 44100;",
                  f'sampling_rate: 44100;\nmodules_path: "{mods}";', 1))
    return retarget(cfg, pairs)


def split_run(eng, mods: dict, max_blocks=None):
    """``Engine.run`` in its parts: attach the logic modules and
    ``setup()`` (the warm-up), then the blocks, then ``teardown()``; the
    launch counts of the warm-up and of the blocks apart, by (module,
    form). ``stats["proc_ms"]``: each block's wall less its input
    read (on a clocked input the read waits for the card), ms."""
    for m in mods.values():
        m.reset_launches()
    eng.attach_logic()
    eng.setup()
    warm = all_counts(mods)
    for m in mods.values():
        m.reset_launches()
    reads = []
    try:
        with timed_method(eng, "read_block_dio" if eng.dio is not None
                          else "read_block", reads):
            stats = eng.run(max_blocks=max_blocks, setup=False)
    finally:
        eng.teardown()
    periods = np.asarray(eng._periods)
    stats["proc_ms"] = (periods - np.asarray(reads[:periods.size])) * 1e3
    return stats, warm, all_counts(mods)


def deadlines(dev, label: str, period_ms: float) -> dict:
    """Misses and lateness of a paced output's writes after t0."""
    late = np.asarray(dev.lateness) * 1e3
    if not late.size:
        fail(f"{label}: no write after the start")
    misses = int((late > 0).sum())
    print(f"clocked ({label}): {late.size} writes after the start, "
          f"{misses} missed their deadline ({misses / late.size:.1%}); "
          f"lateness p50 {np.median(late):.3f} ms, max {late.max():.3f} ms "
          f"(period {period_ms:.3f} ms)", flush=True)
    return {"writes": int(late.size), "misses": misses,
            "miss_share": misses / late.size,
            "late_p50_ms": float(np.median(late)),
            "late_max_ms": float(late.max())}


def clocked_summary(stats: dict, eng, label: str, period_ms: float) -> dict:
    """The run's block wall (the input's wait included, as the rti
    reads it), its processing time and what the realtime request got."""
    rt = dict(eng.realtime_state)
    proc = stats["proc_ms"]
    res = {"blocks": stats["blocks"], "p50_ms": stats["p50_block_ms"],
           "p95_ms": stats["p95_block_ms"], "rti_max": stats["rti_max"],
           "proc_p50_ms": float(np.median(proc)),
           "proc_p95_ms": float(np.percentile(proc, 95)),
           "proc_max_ms": float(proc.max()), "realtime": rt}
    print(f"clocked ({label}): {res['blocks']} blocks; block wall p50 "
          f"{res['p50_ms']:.3f} ms, p95 {res['p95_ms']:.3f} ms against the "
          f"period's {period_ms:.3f} ms; rti_max {res['rti_max']:.4f}; "
          f"processing (wall less the input read) p50 "
          f"{res['proc_p50_ms']:.3f} ms, p95 {res['proc_p95_ms']:.3f} ms, "
          f"max {res['proc_max_ms']:.3f} ms; realtime {rt}", flush=True)
    return res


def clocked_engine(cfg: str):
    from brutefir_tpu_torch.config import parse_config
    from brutefir_tpu_torch.runtime.engine import Engine
    with open(cfg) as fh:
        return Engine(parse_config(fh.read()))


def silent_fill(y, frames: int, n: int, label: str):
    """The output after the iodelay fill: 2N silent frames, then one
    frame a frame read."""
    if y.shape[0] != frames + 2 * n or y[:2 * n].any():
        fail(f"{label}: {y.shape[0]} frames out for {frames} in, or the "
             f"first 2N frames are not silent")
    return y[2 * n:]


def clocked_massive(mods: dict) -> dict:
    """Phase 26: the massive shape on the paced device, 32 blocks."""
    label = "massive on the paced device"
    frames = CLOCKED_BLOCKS * K
    taps, x = write_massive_inputs(np.random.default_rng(SEED + 28), frames)
    cfg = to_paced(massive_config("clocked.conf", False), "input.raw",
                   "output.raw", write_module("paced", PACED_MODULE, "bfio"))
    eng = clocked_engine(cfg)
    stats, warm, blocks = split_run(eng, mods)
    period = K / 44100 * 1e3
    res = clocked_summary(stats, eng, label, period)
    res.update(deadlines(loaded_module("paced", "bfio").PacedDevice.instances[-1],
                         label, period))
    res["warm"], res["counts"] = launch_keys(warm), launch_keys(blocks)
    y = silent_fill(np.fromfile(os.path.join(WORK, "output.raw"),
                                "<i4").reshape(-1, F), frames, K, label)
    res["lsb"] = oracle_lsb(y, x, lambda c: taps[0])
    print(f"clocked ({label}): the first 2N frames silent; max |y - oracle| "
          f"{res['lsb']} LSB (tol {LSB_TOL}) on all {F} channels",
          flush=True)
    if res["lsb"] > LSB_TOL:
        fail(f"{label}: off the float64 oracle by {res['lsb']} LSB")
    if res["misses"]:
        fail(f"{label}: {res['misses']} writes missed their deadline")
    expect_only(blocks, {"uniform": CLOCKED_BLOCKS,
                         **glue_want(CLOCKED_BLOCKS, CLOCKED_BLOCKS)}, label)
    if not warm[("mac_mix", "uniform")] or not warm[("mac_mix", "rows")]:
        fail(f"{label}: the warm-up did not run both forms: {warm}")
    return res


def launch_keys(counts: dict) -> dict:
    """Nonzero launch counts by (module, form) as "module/form" keys, for
    the child's JSON line."""
    return {f"{m}/{f}": n for (m, f), n in counts.items() if n}


def xtc_config(frames: int, seed: int):
    """The xtc example with seeded coefficients and a FLOAT_LE input of
    ``frames`` frames (``write_float_example``)."""
    return write_float_example(WORK, "xtc_lowlatency.conf", frames,
                               XTC_N * XTC_B, ("direct.txt", "cross.txt"),
                               seed)


def clocked_alsa(mods: dict) -> dict:
    """Phase 27: the xtc example with its devices on ALSA, over the fake
    libasound of tests/fake_asound.c: its capture pattern in S16_LE (the
    byte (f + c) & 0xFF in the low byte, finite words), the example's
    dithered S24_LE output dumped by the fake."""
    import ctypes
    from brutefir_tpu_torch.io.sound_backends import AlsaDevice
    label = "xtc_lowlatency.conf over ALSA (the fake libasound)"
    lib = os.path.join(WORK, "libfakeasound.so")
    r = subprocess.run(["gcc", "-O2", "-shared", "-fPIC", FAKE_ASOUND, "-o",
                        lib], capture_output=True, text=True)
    if r.returncode != 0:
        fail(f"gcc of {FAKE_ASOUND} failed: {r.stderr[-2000:]}")
    dump = os.path.join(WORK, "alsa_dump.raw")
    os.environ["FAKE_ASOUND_LOG"] = os.path.join(WORK, "alsa_calls.log")
    os.environ["FAKE_ASOUND_DUMP"] = dump
    ctypes.CDLL(lib).fake_asound_reset()
    AlsaDevice._lib = AlsaDevice._typed(ctypes.CDLL(lib))
    taps, _, cfg = xtc_config(XTC_N, SEED + 29)
    alsa = 'device: "alsa" { device: "hw:0"; };'
    cfg = retarget(cfg, (
        (f'device: "file" {{ path: "{os.path.join(WORK, "input.f32")}"; }};',
         alsa, 1),
        (f'device: "file" {{ path: "{os.path.join(WORK, "output.s24")}"; '
         '};', alsa, 1),
        ('sample: "FLOAT_LE";', 'sample: "S16_LE";', 1)))
    eng = clocked_engine(cfg)
    stats, warm, blocks = split_run(eng, mods, ALSA_BLOCKS)
    res = clocked_summary(stats, eng, label, XTC_N / 44100 * 1e3)
    res["warm"], res["counts"] = launch_keys(warm), launch_keys(blocks)
    frames = ALSA_BLOCKS * XTC_N
    y = silent_fill(read_s24_3(dump).reshape(-1, 2), frames, XTC_N, label)
    x = ((np.arange(frames)[:, None] + np.arange(2)[None, :])
         & 0xFF).astype(np.int16)
    worst = np.abs(y - config_oracle(cfg, taps, x)).max(axis=0)
    res["lsb"] = float(worst.max())
    print(f"clocked ({label}): the first 2N frames silent; max |y - oracle "
          f"of the fake's pattern| per channel "
          f"{', '.join(f'{w:.3f}' for w in worst)} LSB (tol {LSB_TOL})",
          flush=True)
    if worst.max() > LSB_TOL:
        fail(f"{label}: off the float64 oracle")
    expect_only(blocks, {"mac_rows": ALSA_BLOCKS,
                         **glue_want(ALSA_BLOCKS, ALSA_BLOCKS)}, label)
    return res


def clocked_xtc(mods: dict) -> dict:
    """Phase 28: the xtc example on the paced device, 2000 blocks."""
    label = "xtc_lowlatency.conf on the paced device"
    frames = XTC_CLOCKED_BLOCKS * XTC_N
    taps, x, cfg = xtc_config(frames, SEED + 30)
    cfg = to_paced(cfg, "input.f32", "output.s24",
                   write_module("paced", PACED_MODULE, "bfio"))
    eng = clocked_engine(cfg)
    stats, warm, blocks = split_run(eng, mods)
    period = XTC_N / 44100 * 1e3
    res = clocked_summary(stats, eng, label, period)
    res.update(deadlines(loaded_module("paced", "bfio").PacedDevice.instances[-1],
                         label, period))
    res["warm"], res["counts"] = launch_keys(warm), launch_keys(blocks)
    y = silent_fill(read_s24_3(os.path.join(WORK, "output.s24")).reshape(
        -1, 2), frames, XTC_N, label)
    worst = np.abs(y - config_oracle(cfg, taps, x)).max(axis=0)
    res["lsb"] = float(worst.max())
    print(f"clocked ({label}): the first 2N frames silent; max |y - oracle| "
          f"per channel {', '.join(f'{w:.3f}' for w in worst)} LSB (tol "
          f"{LSB_TOL}); misses are not gated", flush=True)
    if worst.max() > LSB_TOL:
        fail(f"{label}: off the float64 oracle")
    expect_only(blocks, {"mac_rows": XTC_CLOCKED_BLOCKS,
                         **glue_want(XTC_CLOCKED_BLOCKS,
                                     XTC_CLOCKED_BLOCKS)}, label)
    return res


def clocked_child():
    """Phases 26-28 in a process of their own (``chip_smoke.py
    --clocked-child``): a clocked engine asks for SCHED_FIFO and
    mlockall, which must not reach the other phases. The last line of its
    output is one JSON object of the results and launch counts."""
    from brutefir_tpu_torch.ops import fft_glue as tg, mac as tm, mac_mix as mm
    os.makedirs(WORK, exist_ok=True)
    mods = {"mac_mix": mm, "fft_glue": tg, "mac": tm}
    res = {}
    phase("26, clocked: massive on the paced device")
    res["massive"] = clocked_massive(mods)
    phase("27, clocked: xtc_lowlatency.conf over ALSA")
    res["alsa"] = clocked_alsa(mods)
    phase("28, clocked: xtc_lowlatency.conf on the paced device")
    res["xtc"] = clocked_xtc(mods)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] == "brutefir_tpu" or m.startswith("jax"))
    if bad:
        fail(f"modules of jax or of the JAX package were loaded: {bad[:5]}")
    print(json.dumps({"clocked": res}), flush=True)


def main_clocked(launched: dict) -> dict:
    """Phases 26-28 through a child process; its launch counts (warm-up
    and blocks) go into ``launched``."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        CHILD_ARG], capture_output=True, text=True,
                       timeout=900, cwd=REPO)
    lines = r.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"  | {line}", flush=True)
    sys.stderr.write(r.stderr[-20000:])
    if r.returncode != 0 or not lines:
        fail(f"the clocked child exited {r.returncode}")
    res = json.loads(lines[-1])["clocked"]
    print(f"clocked child: rc 0 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for part in res.values():
        for counts in (part["warm"], part["counts"]):
            for key, n in counts.items():
                mod, form = key.split("/")
                launched[(mod, form)] = launched.get((mod, form), 0) + n
    return res



# ---- phases 29-31: float_bits: 64 ------------------------------------------

def as_float64(cfg: str, name: str, pairs=()) -> str:
    """A copy of the config file ``cfg`` as ``name`` in WORK with
    ``float_bits: 64;`` (in place of ``float_bits: 32;`` or added), each
    (old, new, count) of ``pairs`` replaced as :func:`retarget` does."""
    with open(cfg) as fh:
        text = fh.read()
    text = (text.replace("float_bits: 32;", "float_bits: 64;")
            if "float_bits: 32;" in text else "float_bits: 64;\n" + text)
    path = os.path.join(WORK, name)
    with open(path, "w") as fh:
        fh.write(text)
    return retarget(path, pairs)


def f64_want(mac: dict, n_fwd: int, n_inv: int) -> dict:
    """The launches a float64 run must make: ``mac`` (the float64 MAC's
    forms) and the float64 glue; expect_only holds every other form,
    each float32 kernel's among them, to 0."""
    return {**mac, "glue_fwd_f64": n_fwd, "glue_inv_f64": n_inv}


F64_GLUE = (("fft_glue", "glue_fwd_f64"), ("fft_glue", "glue_inv_f64"))


def main_massive_f64(main, mods: dict, launched: dict):
    """Phase 29: phase 8's shared-coefficient massive config and input
    with ``float_bits: 64;`` through ``main()``: the stage loop's float64
    MAC (uniform) and one float64 glue each way a block, no float32
    kernel; every word the float64 oracle's rounding."""
    label = "massive, float_bits: 64"
    frames = int(BLOCKS * K)
    blocks = int(np.ceil(BLOCKS))
    taps, x = write_massive_inputs(np.random.default_rng(SEED), frames)
    cfg = as_float64(massive_config("run1.conf", False), "run64.conf")
    for m in mods.values():
        m.reset_launches()
    y = run_main(main, cfg, frames, F, label)
    counts = all_counts(mods)
    expect_only(counts, f64_want({"mac_uniform_f64": blocks}, blocks,
                                 blocks), label)
    gap = oracle_gap(y, x, lambda c: taps[0])
    print(f"main path ({label}): max |word - float64 oracle| {gap:.6f} LSB "
          f"on all {F} channels (gate {WORD_GATE:g}: every word the "
          f"oracle's rounding); phase 8's float32 run "
          f"{F32_ERR.get('massive', float('nan')):.6f} LSB", flush=True)
    if not gap <= WORD_GATE:
        fail(f"{label}: a word is not the float64 oracle's rounding")
    add_counts(launched, counts, ("mac", "mac_uniform_f64"), *F64_GLUE)


def main_bench1_xfade_f64(main, mods: dict, launched: dict):
    """Phase 30: phase 15's crossfading bench1 cascade with ``float_bits:
    64;`` and FLOAT64_LE files (the host codec path): the float64 MAC on
    every stage, twice on the first stage of each swap block (its old
    set, as the JAX package's float64 step runs ``run_mac`` again), the
    float64 glue as the float32 cascade counts it; within FLOAT64_TOL of
    the peak of the float64 crossfade oracle."""
    label = "bench1 cascade, crossfading first stage, float_bits: 64"
    frames = int(BLOCKS * BENCH1_N)
    taps, x, cfg = write_bench1_xfade_inputs(WORK, frames)
    xf = x.astype(np.float64) / 2.0 ** 23
    xf.astype("<f8").tofile(os.path.join(WORK, "input.f64"))
    cfg = as_float64(cfg, "bench1_xfade64.conf", (
        (os.path.join(WORK, "input.raw"), os.path.join(WORK, "input.f64"),
         1),
        (os.path.join(WORK, "output.raw"), os.path.join(WORK, "output.f64"),
         1),
        ('sample: "S24_4LE";', 'sample: "FLOAT64_LE";', 2)))
    for m in mods.values():
        m.reset_launches()
    y = run_main(main, cfg, frames, 2, label, out="output.f64", dtype="<f8")
    counts = all_counts(mods)
    blocks = int(np.ceil(BLOCKS))
    swaps = len(range(0, blocks, 3))
    expect_only(counts, f64_want({"mac_rows_f64": 2 * blocks + swaps},
                                 2 * blocks + swaps, 2 * blocks + 2 * swaps),
                label)
    ref = cascade_xfade_oracle(taps, xf)
    for c in range(2):
        peak = np.abs(ref[:, c]).max()
        rel = np.abs(y[:, c] - ref[:, c]).max() / peak
        print(f"main path ({label}): channel {c}: max |y - oracle| "
              f"{rel:.3e} of the peak (tol {FLOAT64_TOL:g}); phase 15's "
              f"float32 run {F32_ERR.get('bench1_xfade', float('nan')):.3e}",
              flush=True)
        if not rel <= FLOAT64_TOL:
            fail(f"{label} off the float64 oracle on channel {c}")
    add_counts(launched, counts, ("mac", "mac_rows_f64"), *F64_GLUE)


def main_bench5_f64(main, mods: dict, launched: dict):
    """Phase 31: bench5 (phase 12) with ``float_bits: 64;`` through
    ``run()``: block 0 through the stage loop's float64 MAC, each
    crossfade block through the fused time-domain crossfade with two
    float64 MAC launches (the dual MAC never); every word on channels 0,
    5, ..., 25 the rounding of the float64 ramp oracle."""
    label = "bench5, float_bits: 64"
    N_, C = BENCH5_N, BENCH5_C
    frames = int(BLOCKS * N_)
    taps, x, cfg = write_bench5_inputs(WORK, frames)
    cfg = as_float64(cfg, "bench5_64.conf")
    for m in mods.values():
        m.reset_launches()
    y = run_main(main, cfg, frames, C, label)
    counts = all_counts(mods)
    blocks = int(np.ceil(BLOCKS))
    expect_only(counts, f64_want({"mac_uniform_f64": 1 + 2 * (blocks - 1)},
                                 blocks, blocks), label)
    worst, _ = xfade_lsb(
        y.astype(np.float64), x, taps, N_,
        lambda k: "a" if k == 0 else ("ab" if k % 2 else "ba"),
        range(0, C, 5))
    print(f"main path ({label}): max |word - ramp oracle| {worst:.6f} LSB "
          f"(gate {WORD_GATE:g}) on channels 0, 5, ..., 25; phase 12's "
          f"float32 run {F32_ERR.get('bench5', float('nan')):.3f} LSB",
          flush=True)
    if not worst <= WORD_GATE:
        fail(f"{label}: a word is not the ramp oracle's rounding")
    add_counts(launched, counts, ("mac", "mac_uniform_f64"), *F64_GLUE)


HOST_DITHER_TOL = 5      # phase 22, LSB: the HP-TPDF error reaches 4.5
FLOAT_TOL = 2e-5         # phase 23, of the output's peak


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
    from brutefir_tpu_torch.ops import (_build, fft_fused as tf,
                                        fft_glue as tg, mac as tm,
                                        mac_dual as td, mac_group as mg,
                                        mac_mix as mm, partconv as pc)
    from brutefir_tpu_torch.__main__ import main
    t0 = time.perf_counter()
    libs = _build.build()
    for stem in _build.SIGNATURES:
        _build.load(stem)
    print(f"built {', '.join(p.name for p in libs)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for so in libs:
        log = so.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {so.stem}: {line.strip()}", flush=True)

    phase("kernel vs plain")
    rows = []
    flush = read_flush()
    global FLOOR_MS
    tiny = torch.zeros(1, device="cuda")
    FLOOR_MS = time_ms(lambda: tiny.zero_(), REPS, flush)
    print(f"timing floor (a kernel writing 4 bytes, L2 flushed by a read "
          f"before each): {FLOOR_MS:.4f} ms", flush=True)
    kernels_massive(mm, rows, flush)
    kernels_scale(mm, mg, rows, flush)
    phase("kernel vs plain, the unfused MAC")
    kernels_mac(tm, rows, flush)
    phase("kernel vs plain, the crossfade dual MAC")
    kernels_dual(td, tm, rows, flush)
    launched = {}
    phase("kernel vs plain, the FFT glue, and the FFT routes")
    kernels_glue(tg, rows, flush)
    phase("kernel vs plain, the float64 forms (float_bits: 64)")
    kernels_f64(tm, tg, rows, flush)
    phase("the fused real FFT's probe path")
    probe_fused(tf, pc, rows, flush, launched)
    del flush
    torch.cuda.empty_cache()

    os.makedirs(WORK, exist_ok=True)
    mods = {"mac_mix": mm, "fft_glue": tg}
    phase("main path, massive")
    main_massive(main, mods, launched)
    mods["mac_group"] = mg
    phase("main path, scale")
    main_scale(main, mods, launched)
    mods["mac"] = tm
    phase("main path, bench1 cascade")
    main_bench1(main, mods, launched)
    phase("main path, massive cascade")
    main_massive_cascade(main, mods, launched)
    mods["mac_dual"] = td
    phase("main path, bench5 crossfade every block")
    main_bench5(main, mods, launched)
    phase("main path, massive with a swap every 64 blocks")
    main_massive_swap(main, mods, launched)
    phase("offline split")
    offline_split(mods, launched)
    phase("main path, bench1 cascade with a crossfading first stage")
    main_bench1_xfade(main, mods, launched)
    phase("main path, massive, time-aligned and dithered")
    y16 = main_aligned(main, mods, launched)
    phase("main path, crossover_2way.conf with a CLI script")
    main_crossover(main, mods, launched)
    phase("main path, xtc_lowlatency.conf")
    main_xtc(main, tm, tg, mods, launched)
    phase("main path, massive under benchmark: true and debug: true")
    main_benchmark(main, mods, launched)
    phase("main path, room_correction_eq.conf with its CLI socket")
    main_eq(main, mods, launched)
    phase("main path, massive, S24_BE through the host codec")
    main_hostcodec(main, mods, launched)
    phase("main path, host codec, time-aligned and dithered")
    main_hostcodec_aligned(main, mods, launched, y16)
    del y16
    phase("main path, host codec, 8-byte floats and per-filter sets")
    main_hostcodec_floats(main, mods, launched)
    phase("main path, massive with a spectral logic module")
    main_hooks(main, mods, launched)
    phase("main path, bench5 crossfade under a post_convolve module")
    main_xfade_hooks(main, mods, launched)
    torch.cuda.empty_cache()
    phase("main path, clocked devices (phases 26-28, a child process)")
    main_clocked(launched)
    phase("main path, massive, float_bits: 64")
    main_massive_f64(main, mods, launched)
    phase("main path, bench1 cascade crossfading, float_bits: 64, "
          "FLOAT64_LE")
    main_bench1_xfade_f64(main, mods, launched)
    phase("main path, bench5 crossfade every block, float_bits: 64")
    main_bench5_f64(main, mods, launched)
    shutil.rmtree(WORK, ignore_errors=True)

    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] == "brutefir_tpu" or m.startswith("jax"))
    if bad:
        fail(f"modules of jax or of the JAX package were loaded: {bad[:5]}")

    for r in rows:
        key = r.pop("launches_key")
        r["launches"] = launched[key]
        if r["launches"] <= 0:
            fail(f"{r['name']}: not launched on the main path")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == [CHILD_ARG]:
        clocked_child()
    else:
        run()
