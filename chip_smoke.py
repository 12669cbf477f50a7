#!/usr/bin/env python3
"""Smoke run of brutefir_tpu_torch on one NVIDIA GPU.

Usage (from the repository root, one CUDA card, no arguments):

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. card: prints the host's card count and names (``torch.cuda.
   device_count()`` in a child process, before this process pins the
   first card), the card's name and power limit, and requires CUDA;
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
6c. kernel vs plain, the forward glue into the ring
   (``bf_glue_fwd_ring`` of ``csrc/fft_glue.cu``): its float32, bfloat16
   and float64 forms at the massive shape (one shared delay; per-filter
   delays), bench1's first stage (rows 2-5 of 6, B = 8) and 256 rows,
   M = 8192, each against its plain version on the same CUDA tensors
   (float32 within 1e-5 of the peak, float64 1e-12, the bfloat16 ring
   equal to the plain version's cast, every other slot untouched), timed
   beside its bound, the floor and the plain version; its
   plain-destination form into block 1 of a G = 4 ``xnews`` at 256 rows;
   then the frames-to-ring sequences at C = 26 and 256, in turns: old
   (cuFFT fft, ``glue_fwd``, the mix of planes, ``_write_ring``), new
   (cuFFT fft, the mix on the M-point spectra, ``glue_fwd_ring``) and the
   library sequence (``torch.fft.rfft``, its packing, the mix,
   ``_write_ring``), each ring within 1e-5 of the new one's;
7. the fused real FFT's probe path (``csrc/fft_fused.cu``, TPU kernel 12;
   tools/fused_fft_probe.py's comparison): frame -> digit-permuted planes
   and permuted planes -> valid half at C = 26 and 256, M = 8192, one
   launch each a shape; each within 1e-5 relative of its plain version
   (the same four-step stages in torch) and of the port's transforms after
   ``bin_order``, timed beside them and the library call; each kernel's
   cluster size, registers and shared memory a block printed;
7b. kernel vs plain with ``has_bin0`` = 0 and 1 (the packed DC/Nyquist
   rule on local bin 0, off on a mesh's bin shards other than the first):
   rows 1, 2 (massive's 2 x 2 shard, 13 filters x 4096 bins), 3 (256
   outputs at 8192 bins), 4 (G = 4) and 8 (both forms) at the 2 x 2
   shard, 6 (bench1's stage at 1 x 2) and 9 (256 distinct rows at 2048
   bins), each within 1e-5 relative of its plain version with the same
   flag; with 0 every bin but bin 0 bit-equal to the kernel's output
   with 1, bin 0 not;
7c. the four shard forms (``ops/mac_shard.py``: ``mac_mix_shard``
   uniform and per-filter, ``mac_shard``, ``mac_dual_shard``,
   ``mac_group_shard`` at G = 4) at the massive shape on 2 x 2 and 1 x 4
   meshes whose shards all sit on cuda:0, against the unsharded kernel
   call: bit-equal where the form sums no filters across shards (all but
   the fused MAC + mix at f = 2, held to 1e-5 relative); timed at 2 x 2:
   one shard's kernel at its shard shape beside its bound, the whole
   form and the unsharded call;
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
   (mix2 0.000: the fused route folds the output mix into the MAC) and
   its launches counted exactly (``runtime/stageprobe.py`` times one
   block of the route: the uniform fused MAC + mix, ``glue_fwd_ring`` and
   ``glue_inv`` ``stageprobe.RUNS`` times each beside one a block,
   ``mac_rows`` and ``glue_fwd`` none); then the bench1 cascade under
   ``benchmark: true;`` (20.5 blocks, 2 lines, 2e-5 of the peak + 4 of
   the oracle), without and with the breakdown, bit-equal, the probe's
   stage loop launching ``mac_rows``, ``glue_fwd_ring`` and ``glue_inv``
   2 x RUNS times each beside two a block; both calibration lines
   printed; then ``debug:
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

32-36. main path, sharded, every shard on cuda:0
   (``make_mesh([cuda:0] * n, f, sp)`` passed as ``Engine(conf,
   mesh=...)``), each run beside the same config unsharded (within 1
   LSB; bench1 bit-equal), the counts set to 0 just before the sharded
   run: 32 the massive shape at 2 x 2 through ``run_offline`` (the
   uniform fused MAC + mix, 4 launches a block; 16 LSB of the oracle);
   33 the scale shape at 1 x 4 (the groups of 4 through
   ``mac_group_shard``, 4 launches a group, the tail through the
   per-filter fused MAC + mix at 2048-bin shards); 34 bench5 at 2 x 1
   through ``run()`` (the dual MAC per shard on every crossfade block);
   35 bench1's cascade at 1 x 2 (``mac_shard`` on each stage's rows);
   36 the massive shape with ``process:`` pins on two groups of 14 and
   12 filters at 2 x 1 (28 spec rows with the padding; the placement's
   stderr line; unsharded on one card, the warning that the pins have
   no effect);
37. across cards: when the host has two or more (the card phase's
   count), a child process (``chip_smoke.py --mesh-child``,
   ``CUDA_VISIBLE_DEVICES=0,1``) runs the massive shape at 2 x 1 and
   1 x 2 across cuda:0 and cuda:1 to its oracle; its failure fails the
   smoke. With one card it prints that it did not run, and why.

7d (after 7c). kernel vs plain, the bf16 operand forms
   (``BRUTEFIR_TPU_RING_DTYPE`` / ``BRUTEFIR_TPU_BANK_DTYPE`` = bf16):
   rows 1-10 at their path shapes (``bf16_cases``), and rows 3-4 at a
   2 x 2 shard of the scale shape (128 filters x 4096 bins, has_bin0 =
   0; row 3's route forced), each under a bf16
   ring, a bf16 bank and both: the form against its plain version on the
   same bfloat16 operands (REL_TOL), its launch counted in its module's
   ``launches`` under the form's bf16 name, timed beside the plain version, the bound counting
   bf16 bytes at 2 a value; each combination a main path below launches
   enters the kernels summary (rows 1-2 all three); then the ptxas
   registers and spills of row 5's bf16 kernel and its launch plans
   (``mix_group_plan``) at G = 2 at the scale shape, and row 7's under
   the bank knob (``launch_plan``: groups of 8).
38-42. main paths of the opt-in knobs, the counts set to 0 just before
   each run: 38 the massive shape (shared, then two coefficients), each
   in turns float32, under ``BRUTEFIR_TPU_BANK_DTYPE=bf16``, under
   ``BRUTEFIR_TPU_RING_DTYPE=bf16`` and under both: the bank knob within
   QUANT_TOL LSB of the float64 response of the quantized bank
   (``partconv_q``: the bf16 bank widened, the partitioned overlap-save
   in float64), the ring knob and both within ``RING_BOUND`` of the peak
   + 2 LSB of the float32 run, each run launching its form of the fused
   MAC + mix once a block; 39 the scale shape under both knobs (groups
   of 4 with the tiled tail, then ``BRUTEFIR_TPU_PAIR=2``) within
   ``RING_BOUND`` of the peak + 2 LSB of phase 9's float32 runs; 40 bench5
   under both knobs within that bound of phase 12's run; 41 bench1's and
   the massive cascade under the bank knob within their float32 bounds
   of the cascaded quantized-bank oracle; 42 the massive shape
   through ``Engine.run`` under ``BRUTEFIR_TPU_PROFILE=<dir>``: one
   Chrome trace naming the fused MAC + mix and both glue kernels.

Each main-path run must exit 0, write as many frames as it read, stay
within its bound of a float64 convolution oracle on every channel, and
launch its kernels the expected number of times (launch counts are set
to 0 just before each run). Every run launches the glue kernels: a
single stage one forward glue into the ring (``glue_fwd_ring``, its
``_bf16`` form under the ring knob, its ``_f64`` form in float64) and one
inverse a block, a two-stage cascade two of each (the input, the cascade
input's inverse and its forward into the ring, the output), a group of
G blocks G - 1 more into its ``xnews``, and ``crossfade_spectra`` one
``glue_fwd`` and two full inverses more on each crossfade block of a
cascade; ``glue_fwd`` (the planes) replaces ``glue_fwd_ring`` under
taps (phases 24-25) and on a mesh (32-37), whose ring writes stay
torch's. No module of jax or of the JAX package may be loaded at the
end.

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
                    real_bytes=4, ring_bytes=None, bank_bytes=None):
    """Bytes a MAC kernel must move (each input once, each output once)
    and its operations: ring, the bank rows it uses, G-1 xnews blocks,
    the small controls, and G outputs of ``out_rows`` rows; a complex
    multiply-add (8 operations) per filter, partition, bin and block, and
    a real mix (4 a bin: two planes, multiply and add) per output, filter
    and block when C > 0. ``real_bytes``: 4 (float32), 8 (float64);
    ``ring_bytes`` (the ring and xnews) and ``bank_bytes``: 2 for a
    bfloat16 operand (default ``real_bytes``)."""
    plane = 2 * K_ * real_bytes
    rplane = 2 * K_ * (ring_bytes or real_bytes)
    hplane = 2 * K_ * (bank_bytes or real_bytes)
    n_bytes = (F_ * B_ * rplane + rows_used * B_ * hplane
               + (G - 1) * F_ * rplane
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


def dual_bytes_flops(Fs, B_, K_, rows_used, ring_bytes=4, bank_bytes=4):
    """Bytes the dual MAC must move (each input once, each output once:
    Fs ring rows, the bank rows both sets use, both sets' controls, two
    outputs) and its FP32 operations (two complex multiply-adds, 16
    operations, per filter, partition and bin); ``ring_bytes`` and
    ``bank_bytes`` 2 for a bfloat16 operand."""
    plane = 2 * K_ * 4
    n_bytes = (Fs * B_ * 2 * K_ * ring_bytes
               + rows_used * B_ * 2 * K_ * bank_bytes + 2 * Fs * plane
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


# phase 6c's shapes of the forward glue into the ring, M = 8192: (label,
# F, B, stage rows or None, per-filter delays)
RING_SHAPES = (
    ("massive, one shared delay", F, B, None, [0] * F),
    ("massive, per-filter delays", F, B, None, [f % B for f in range(F)]),
    ("bench1's first stage, rows 2-5 of 6", 6, 8, [2, 3, 4, 5],
     [0, 1, 2, 3, 4, 5]),
    ("scale, 256 rows", SCALE_C, B, None, [0] * SCALE_C))
RING_FORMS = (("glue_fwd_ring", "float32"), ("glue_fwd_ring_bf16",
                                             "bfloat16"),
              ("glue_fwd_ring_f64", "float64"))
SEQ_ROUNDS = 2           # phase 6c: the frames-to-ring sequences in turns


def kernels_glue_ring(tg, pc, rows, flush):
    """Phase 6c: ``bf_glue_fwd_ring`` (csrc/fft_glue.cu) in its three
    forms at RING_SHAPES against its plain version on the same CUDA
    tensors (float32 within REL_TOL of the peak, float64 REL_TOL_F64,
    a bfloat16 ring equal to the plain version's cast; every slot it does
    not write untouched), each timed beside its bound, the floor and the
    plain version; the plain-destination form into the grouped
    dispatch's ``xnews`` at the scale shape, G = 4; then the three
    frames-to-ring sequences at C = 26 and 256 in turns: old (cuFFT fft,
    ``glue_fwd``, the mix of planes, ``_write_ring``), new (cuFFT fft,
    the mix on the M-point spectra, ``glue_fwd_ring``) and the library
    sequence (``torch.fft.rfft``, its packing into planes, the mix,
    ``_write_ring``), each ring within REL_TOL of the others."""
    import torch
    from brutefir_tpu_torch.graph.compile import _write_ring
    M = FFT_M
    print_ptxas("fft_glue", ("glue_fwd_ring_kernel",),
                "one pair of bins a thread, the slot a row")
    g = torch.Generator(device="cuda").manual_seed(SEED + 61)
    t = torch.tensor(5, dtype=torch.int32, device="cuda")
    for label, F_, B_, stage, delays in RING_SHAPES:
        Fs = F_ if stage is None else len(stage)
        r32 = (None if stage is None else
               torch.tensor(stage, dtype=torch.int32, device="cuda"))
        delay = torch.tensor(delays, dtype=torch.int32, device="cuda")
        idx = (torch.arange(Fs, device="cuda") if r32 is None
               else r32.long())
        slots = torch.remainder(t + delay[idx], B_).long()
        written = torch.zeros(F_, B_, dtype=torch.bool, device="cuda")
        written[idx, slots] = True
        for key, what in RING_FORMS:
            f64 = key.endswith("_f64")
            rdt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "float64": torch.float64}[what]
            Zm = torch.randn(Fs, M, generator=g, device="cuda",
                             dtype=torch.complex128 if f64
                             else torch.complex64)
            ring = torch.randn(F_, B_, 2, M, generator=g,
                               device="cuda").to(rdt)
            ref = ring.clone()
            before = tg.launches[key]
            tg.glue_fwd_ring(Zm, ring, r32, delay, t)
            tg.glue_fwd_ring_reference(Zm, ref, r32, delay, t)
            torch.cuda.synchronize()
            if tg.launches[key] != before + 1:
                fail(f"{key} ({label}): not counted under its key")
            if not torch.equal(ring[~written], ref[~written]):
                fail(f"{key} ({label}): a slot it must not write changed")
            got, want = ring[written], ref[written]
            same = float((got == want).float().mean())
            if rdt == torch.bfloat16:
                if not torch.equal(got, want):
                    fail(f"{key} ({label}): the bfloat16 ring is not the "
                         f"plain version's cast")
                rel = err = 0.0
            else:
                rel, err = check(f"{key} ({label})", got, want, 5,
                                 REL_TOL_F64 if f64 else REL_TOL)
            k_ms = time_ms(lambda: tg.glue_fwd_ring(Zm, ring, r32, delay, t),
                           REPS, flush)
            p_ms = time_ms(lambda: tg.glue_fwd_ring_reference(
                Zm, ref, r32, delay, t), REPS, flush)
            rb = {"float32": 4, "bfloat16": 2, "float64": 8}[what]
            cb = 16 if f64 else 8
            nb = (Fs * M * cb + M * (32 if f64 else 16) + Fs * 2 * M * rb
                  + 4 * (Fs + F_ + 1))
            report(rows, key, "brutefir_tpu_torch/csrc/fft_glue.cu", 89,
                   rel, err, k_ms, p_ms, nb, Fs * 14 * M,
                   ("fft_glue", key) if label.startswith("massive, one")
                   else None,
                   note=f" ({label}: Fs={Fs}, F={F_}, B={B_}, M={M}, "
                   f"{what} ring; {same * 100:.2f}% of the written words "
                   f"equal to the plain version's)", pallas=GLUE_SRC,
                   f64=f64)
            del Zm, ring, ref
        torch.cuda.empty_cache()
    # the plain-destination form into xnews [F, G-1, 2, M] at G = 4
    for key, what in RING_FORMS[:2]:
        rdt = torch.float32 if what == "float32" else torch.bfloat16
        Zm = torch.randn(SCALE_C, M, generator=g, device="cuda",
                         dtype=torch.complex64)
        xnews = torch.zeros(SCALE_C, 3, 2, M, dtype=rdt, device="cuda")
        ref = xnews.clone()
        tg.glue_fwd_into(Zm, xnews[:, 1])
        tg.glue_fwd_into_reference(Zm, ref[:, 1])
        torch.cuda.synchronize()
        if rdt == torch.bfloat16:
            if not torch.equal(xnews, ref):
                fail("glue_fwd_into (bfloat16): not the plain version's cast")
            rel = err = 0.0
        else:
            rel, err = check("glue_fwd_into", xnews, ref, 0)
        k_ms = time_ms(lambda: tg.glue_fwd_into(Zm, xnews[:, 1]), REPS, flush)
        p_ms = time_ms(lambda: tg.glue_fwd_into_reference(Zm, ref[:, 1]),
                       REPS, flush)
        rb = 4 if what == "float32" else 2
        report(rows, f"{key} into xnews", "brutefir_tpu_torch/csrc/"
               "fft_glue.cu", 89, rel, err, k_ms, p_ms,
               SCALE_C * M * 8 + M * 16 + SCALE_C * 2 * M * rb,
               SCALE_C * 14 * M, None,
               note=f" (the plain-destination form, block 1 of xnews "
               f"[{SCALE_C}, 3, 2, {M}], {what})", pallas=GLUE_SRC)
        del Zm, xnews, ref
    torch.cuda.empty_cache()
    frames_to_ring(tg, pc, _write_ring, flush)


def frames_to_ring(tg, pc, write_ring, flush):
    """The three frames-to-ring sequences of phase 6c at C = 26 and 256
    (F = C filters, a dense [C, C] input mix, B = 16, one shared delay:
    the massive and scale shapes' step), timed in turns, SEQ_ROUNDS
    rounds of old, new, library; each ring within REL_TOL of the new
    one's."""
    import torch
    M = FFT_M
    for C in (F, SCALE_C):
        x, _ = fft_inputs(C, SEED + 62 + C)
        g = torch.Generator(device="cuda").manual_seed(SEED + 63 + C)
        mix = torch.randn(C, C, generator=g, device="cuda") / C
        delay = torch.zeros(C, dtype=torch.int32, device="cuda")
        t = torch.tensor(3, dtype=torch.int32, device="cuda")
        rings = {k: torch.zeros(C, B, 2, M, device="cuda")
                 for k in ("old", "new", "library")}
        seqs = {
            "old": lambda: write_ring(
                rings["old"], pc.complex_mix(mix, tg.rfft_planes_glue(x)),
                t, delay, True),
            "new": lambda: tg.glue_fwd_ring(
                pc.mix_points(mix, tg.fft_points(x)), rings["new"], None,
                delay, t),
            "library": lambda: write_ring(
                rings["library"],
                pc.complex_mix(mix, packed(torch.fft.rfft(x))), t, delay,
                True)}
        for fn in seqs.values():
            fn()
        torch.cuda.synchronize()
        ref = rings["new"][:, 3]
        peak = ref.abs().max().item()
        for k in ("old", "library"):
            rel = (rings[k][:, 3] - ref).abs().max().item() / peak
            if not rel <= REL_TOL:
                fail(f"frames to ring at C={C}: the {k} sequence is "
                     f"{rel:.3e} of the peak from the new one")
        times = {k: [] for k in seqs}
        for _ in range(SEQ_ROUNDS):
            for k, fn in seqs.items():
                times[k].append(time_ms(fn, REPS, flush))
        print(f"  frames to ring at C={C}, M={M}, B={B}, in turns "
              f"({SEQ_ROUNDS} rounds of old, new, library; median of "
              f"{REPS} each): " + "; ".join(
                  f"{k} " + ", ".join(f"{v:.4f}" for v in ts) + " ms"
                  for k, ts in times.items())
              + f"; floor {FLOOR_MS:.4f} ms", flush=True)
        del x, rings, seqs
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


# each float32 phase's error, printed beside its float64 phase (29-31);
# and outputs, beside the bf16 and mix-precision phases (38-42)
F32_ERR = {}
F32_OUT = {}


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
    """Add a run's launches of the float32 and bfloat16 glue forms
    (``counts`` by (module, form)) to the glue rows' launches."""
    for key in counts:
        if key[0] == "fft_glue" and not key[1].endswith("_f64"):
            launched[key] = launched.get(key, 0) + counts[key]


def glue_want(n_ring: int, n_inv: int, n_fwd: int = 0,
              ring: str = "glue_fwd_ring") -> dict:
    """The glue launches a run must make: ``n_ring`` of the forward glue
    into the ring (``glue_fwd_ring``, or ``ring``: its bfloat16 form
    under the ring knob), one a ring write and one a block of a group's
    ``xnews``; ``n_fwd`` of ``glue_fwd`` (the planes route under taps, a
    mesh's planes, ``crossfade_spectra``'s re-transform, the stage
    probe); ``n_inv`` inverses."""
    return {ring: n_ring, "glue_fwd": n_fwd, "glue_inv": n_inv}


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


# the grouped dispatch's xnews blocks in a 16-block batch run of the
# scale shape, by BRUTEFIR_TPU_PAIR: 4 groups of 4 (3 each), 8 of 2 (1)
GROUP_INTO = {None: 4 * 3, "2": 8 * 1}


def main_scale(main, mods: dict, launched: dict):
    C = SCALE_C
    frames = int(BLOCKS * K)
    blocks = int(np.ceil(BLOCKS))
    taps, x, cfg = write_scale_inputs(WORK, frames)
    # every block one ring write and one inverse glue at C = 256, the
    # groups' blocks included, and each group's later blocks glued into
    # its xnews once more (GROUP_INTO)
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
                        {**want, **glue_want(blocks + GROUP_INTO[pair],
                                             blocks)}, label)
        for key in keys:
            launched[key] = counts[key]
        add_glue(launched, counts)
    F32_OUT["scale"] = ys
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
    F32_OUT["bench5"] = y
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
    # bench1's two ring writes and two inverse glues a block, and on each
    # swap block crossfade_spectra's two full inverses and one forward
    expect_only(counts, {"mac_dual_rows": swaps,
                         "mac_rows": 2 * blocks - swaps,
                         **glue_want(2 * blocks, 2 * blocks + 2 * swaps,
                                     swaps)}, label)
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
BENCH1_BLOCKS = 20.5     # phase 19's bench1 run: 21 periods, 2 lines
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


def calibration(label: str, err: str, fused: bool) -> str:
    """The one calibration line of a run under the stage breakdown, naming
    every stage; mix2 0.000 on the fused route (the output mix is folded
    into the MAC), positive elsewhere."""
    from brutefir_tpu_torch.runtime import stageprobe
    calib = [ln for ln in err.splitlines()
             if ln.startswith("device stage calibration")]
    if len(calib) != 1 or not all(f" {k} " in calib[0]
                                  for k in stageprobe.STAGES):
        fail(f"{label}: no calibration line naming every stage")
    vals = dict(zip(stageprobe.STAGES, calib[0].split(": ", 1)[1].split()[
        1::2]))
    if (vals["mix2"] == "0.000") != fused:
        fail(f"{label}: mix2 reads {vals['mix2']} on the "
             f"{'fused route' if fused else 'stage loop'}")
    return calib[0]


def benchmark_runs(main, mods: dict, cfg: str, frames: int, channels: int,
                   blocks: int, label: str, want) -> list:
    """``cfg`` (under ``benchmark: true;``) through ``main()`` without and
    with BRUTEFIR_TPU_STAGE_BREAKDOWN=1, every count set to 0 just before
    each run: the launches ``want(probe)`` (``probe`` the stage probe's
    RUNS, 0 without the breakdown), one stage-table line every
    10 periods of its ``blocks``, one calibration line with the breakdown,
    the two outputs bit-equal. Returns [(y, counts, err)] of both runs."""
    from brutefir_tpu_torch.runtime import stageprobe
    runs = []
    for breakdown in (None, "1"):
        tag = (label + (", BRUTEFIR_TPU_STAGE_BREAKDOWN=1" if breakdown
                        else ""))
        for m in mods.values():
            m.reset_launches()
        with knob("BRUTEFIR_TPU_STAGE_BREAKDOWN", breakdown):
            y, err = run_main(main, cfg, frames, channels, tag,
                              with_err=True)
        counts = all_counts(mods)
        probe = stageprobe.RUNS if breakdown else 0
        expect_only(counts, want(probe), tag)
        table = [ln for ln in err.splitlines()
                 if ln.startswith(TABLE_PREFIXES)]
        calib = [ln for ln in err.splitlines()
                 if ln.startswith("device stage calibration")]
        for ln in calib + table:
            print(f"  {ln}", flush=True)
        if len(table) != blocks // 10:
            fail(f"{tag}: {len(table)} stage-table lines, expected "
                 f"{blocks // 10}")
        if not breakdown and calib:
            fail(f"{tag}: a calibration line without the breakdown")
        runs.append((y, counts, err))
    if not np.array_equal(runs[0][0], runs[1][0]):
        fail(f"{label}: the calibrated benchmark run's output differs from "
             f"the first")
    return runs


def main_benchmark(main, mods: dict, launched: dict):
    """Phase 19: the massive shape under benchmark: true (run(), the stage
    table), then with the stage probe's calibration (the fused route),
    the bench1 cascade the same way (the stage loop), then debug: true."""
    rng = np.random.default_rng(SEED + 19)
    frames = int(BENCH_BLOCKS * K)
    blocks = int(np.ceil(BENCH_BLOCKS))
    taps, x = write_massive_inputs(rng, frames)
    cfg = mode_config("bench.conf", "benchmark: true;")
    label = "massive, benchmark: true"
    runs = benchmark_runs(
        main, mods, cfg, frames, F, blocks, label,
        lambda p: {"uniform": blocks + p,
                   **glue_want(blocks + p, blocks + p)})
    calib = [calibration(label, runs[1][2], True)]
    for _, counts, _ in runs:
        launched[("mac_mix", "uniform")] += counts[("mac_mix", "uniform")]
        add_glue(launched, counts)
    ys = [runs[0][0]]
    lsb = oracle_lsb(ys[0], x, lambda c: taps[0])
    print(f"main path (massive, benchmark: true): max |y - oracle| {lsb} "
          f"LSB (tol {LSB_TOL}) on all {F} channels; the calibrated run "
          f"bit-equal", flush=True)
    if lsb > LSB_TOL:
        fail(f"benchmark run off the float64 oracle by {lsb} LSB")

    label = "bench1 cascade, benchmark: true"
    bframes = int(BENCH1_BLOCKS * BENCH1_N)
    bblocks = int(np.ceil(BENCH1_BLOCKS))
    btaps, bx, bcfg = write_bench1_inputs(WORK, bframes, SEED + 191)
    with open(bcfg) as fh:
        text = fh.read()
    with open(bcfg, "w") as fh:
        fh.write(text.replace("float_bits: 32;",
                              "float_bits: 32;\nbenchmark: true;", 1))
    runs = benchmark_runs(
        main, mods, bcfg, bframes, 2, bblocks, label,
        lambda p: {"mac_rows": 2 * (bblocks + p),
                   **glue_want(2 * (bblocks + p), 2 * (bblocks + p))})
    calib.append(calibration(label, runs[1][2], False))
    for _, counts, _ in runs:
        launched[("mac", "mac_rows")] += counts[("mac", "mac_rows")]
        add_glue(launched, counts)
    ref = bench1_oracle(btaps, bx)
    worst = 0.0
    for c in range(2):
        err = np.abs(runs[0][0][:, c] - ref[:, c]).max()
        tol = 2e-5 * np.abs(ref[:, c]).max() + 4.0
        worst = max(worst, err / tol)
    print(f"main path ({label}): max |y - oracle| {worst:.3f} of the "
          f"tolerance (2e-5 of the peak + 4) on both channels; the "
          f"calibrated run bit-equal", flush=True)
    if not worst <= 1.0:
        fail(f"{label} off the float64 oracle")
    for ln in calib:
        print(f"stage probe, {ln}", flush=True)

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
    # the planes route: the hooks see packed planes
    expect_only(counts, {"mac_uniform": blocks,
                         **glue_want(0, blocks, blocks)}, label)
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
    # the stage loop on the planes route: a crossfade block adds
    # crossfade_spectra's forward and two full inverse transforms
    xf = blocks - 1
    expect_only(counts, {"mac_dual_uniform": xf, "mac_uniform": 1,
                         **glue_want(0, blocks + 2 * xf, blocks + xf)},
                label)
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


def f64_want(mac: dict, n_ring: int, n_inv: int, n_fwd: int = 0) -> dict:
    """The launches a float64 run must make: ``mac`` (the float64 MAC's
    forms) and the float64 glue, counted as ``glue_want`` counts the
    float32 one; expect_only holds every other form, each float32
    kernel's among them, to 0."""
    return {**mac, "glue_fwd_ring_f64": n_ring, "glue_fwd_f64": n_fwd,
            "glue_inv_f64": n_inv}


F64_GLUE = (("fft_glue", "glue_fwd_f64"), ("fft_glue", "glue_inv_f64"),
            ("fft_glue", "glue_fwd_ring_f64"))


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
                                 2 * blocks, 2 * blocks + 2 * swaps, swaps),
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


# ---- phases 32-37: several shards (parallel/mesh.py, ops/mac_shard.py) ----

MESH_CHILD_ARG = "--mesh-child"
# the card count of the host before the pin (the "card" phase)
HOST_CARDS = {"count": 0, "names": []}


def host_cards() -> dict:
    """torch.cuda.device_count() and every card's name with the
    environment as given, in a child process: this process pins one card
    before CUDA starts, and a count taken here would be the pinned one."""
    code = ("import json, torch\n"
            "n = torch.cuda.device_count()\n"
            "print(json.dumps({'count': n, 'names': "
            "[torch.cuda.get_device_name(k) for k in range(n)]}))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"counting the host's cards failed: {r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def card_mesh(f: int, sp: int, devices=None):
    """An f x sp mesh whose shards all sit on cuda:0 (or on ``devices``,
    f * sp of them)."""
    import torch
    from brutefir_tpu_torch.parallel import make_mesh
    devs = devices or [torch.device("cuda:0")] * (f * sp)
    return make_mesh(devs, f, sp)


def shard_inputs(g, F_, B_, K_, E_, C, G):
    """The shard forms' inputs on the card: ring, bank, per-filter and
    uniform controls, previous controls, w, xnews and zero delays."""
    import torch
    dev = torch.device("cuda")
    ring = torch.randn(F_, B_, 2, K_, generator=g, device=dev)
    bank = torch.randn(E_, B_, 2, K_, generator=g, device=dev)
    idx = (torch.arange(F_, device=dev) % E_).to(torch.int32)
    pidx = ((torch.arange(F_, device=dev) + 1) % E_).to(torch.int32)
    mask = (torch.rand(F_, B_, generator=g, device=dev) > 0.2).float()
    mask[:, -2:] = 0.0
    w = torch.randn(C, F_, generator=g, device=dev)
    xnews = torch.randn(F_, G - 1, 2, K_, generator=g, device=dev)
    delay = torch.zeros(F_, dtype=torch.int32, device=dev)
    return ring, bank, idx, pidx, mask.contiguous(), w, xnews, delay


def kernels_bin0(mm, mg, tm, td):
    """Rows 1-4, 6, 8 and 9 with has_bin0 = 0 and = 1 against their plain
    versions with the same flag (1e-5 relative), at the shard shapes of
    this slice's mesh phases; with 0, bin 0 must change and every other
    bin stay bit for bit."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 50)
    t = torch.tensor(21, dtype=torch.int32, device=dev)

    def case(name, fn, ref):
        outs = {}
        worst = 0.0
        for flag in (False, True):
            got = fn(flag)
            rel, _ = check(f"{name}, has_bin0={int(flag)}", got, ref(flag),
                           21)
            worst = max(worst, rel)
            outs[flag] = got
        a, b = outs[False], outs[True]
        if not torch.equal(a[..., 1:], b[..., 1:]):
            fail(f"{name}: has_bin0 = 0 changed bins other than 0")
        if torch.equal(a[..., 0], b[..., 0]):
            fail(f"{name}: has_bin0 = 0 left bin 0 as it was")
        print(f"{name}: has_bin0 0 and 1 within {worst:.3e} of the plain "
              f"version (tol {REL_TOL:g}); bins 1.. bit-equal between the "
              f"flags, bin 0 not", flush=True)

    Fh, Kh = F // 2, K // 2                      # massive at 2 x 2
    ring, bank, idx, pidx, mask, w, xnews, delay = shard_inputs(
        g, Fh, B, Kh, E, C_OUT, 4)
    uidx = torch.full_like(idx, 1)
    for uni, name, ix in ((True, "mac_mix_uniform (row 1)", uidx),
                          (False, "mac_mix_rows (row 2)", idx)):
        case(name,
             lambda fl: mm.mac_mix(ring, bank, ix, mask, t, w, uni, fl),
             lambda fl: mm.mac_mix_reference(ring, bank, ix, mask, t, w,
                                             uni, fl))
    case("mac_group at G = 4 (row 4)",
         lambda fl: mg.mac_group(ring, xnews, bank, idx, mask, t, delay, fl),
         lambda fl: mg.mac_group_reference(ring, xnews, bank, idx, mask, t,
                                           delay, fl))
    rows = torch.arange(Fh, dtype=torch.int32, device=dev)
    for uni in (True, False):
        ix = uidx if uni else idx
        case(f"mac_dual, {'uniform' if uni else 'per-filter'} (row 8)",
             lambda fl: torch.cat(td.mac_dual(ring, bank, rows, ix, mask,
                                              pidx, mask, t, uni, fl)),
             lambda fl: torch.cat(td.mac_dual_reference(
                 ring, bank, rows, ix, mask, pidx, mask, t, uni, fl)))
    del ring, bank, xnews
    # row 6: bench1's first stage at 1 x 2 (rows 2-5 of 6, 8192 x 8)
    ring, bank, idx, *_ = shard_inputs(g, 6, BENCH1_B, BENCH1_N // 2, 6, 2,
                                       2)
    st = torch.arange(2, 6, dtype=torch.int32, device=dev)
    mask = torch.ones(6, BENCH1_B, device=dev)
    case("mac rows, bench1's stage at 1 x 2 (row 6)",
         lambda fl: tm.mac(ring, bank, st, idx, mask, t, False, fl),
         lambda fl: tm.mac_reference(ring, bank, st, idx, mask, t, False, fl))
    # row 9: 256 distinct rows, the scale shape's 1 x 4 shard
    ring, bank, idx, _, mask, *_ = shard_inputs(g, SCALE_C, B, K // 4,
                                                SCALE_C, 2, 2)
    st = torch.arange(SCALE_C, dtype=torch.int32, device=dev)
    case("mac rows, 256 distinct rows at 2048 bins (row 9)",
         lambda fl: tm.mac(ring, bank, st, idx, mask, t, False, fl),
         lambda fl: tm.mac_reference(ring, bank, st, idx, mask, t, False, fl))
    # row 3: the bin-tiled fused MAC + mix (256 outputs, 8192 bins)
    del ring, bank
    ring, bank, idx, _, mask, w, *_ = shard_inputs(g, 16, B, K, 2, SCALE_C,
                                                   2)
    if not mm.tiled_route(SCALE_C, B, K):
        fail("row 3's check shape does not take the tiled kernel")
    case("mac_mix tiled (row 3)",
         lambda fl: mm.mac_mix(ring, bank, idx, mask, t, w, False, fl),
         lambda fl: mm.mac_mix_reference(ring, bank, idx, mask, t, w, False,
                                         fl))
    torch.cuda.empty_cache()


def kernels_shard(ms, mm, mg, tm, td, flush):
    """The four shard forms on the card, every shard on cuda:0, at the
    massive shape (26 filters, 8192 x 16, 26 outputs): against the
    unsharded kernel call on 2 x 2 and 1 x 4 meshes (bit-equal where the
    form sums no filters across shards: the MAC, the dual MAC and the
    grouped MAC everywhere, the fused MAC + mix at f = 1; else 1e-5
    relative); then timed at 2 x 2: one kernel at its shard shape (13
    filters x 4096 bins) beside its bound, the whole form (4 launches
    and the assembly) and the unsharded call."""
    import torch
    from brutefir_tpu_torch.parallel.mesh import split
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 51)
    ring, bank, idx, pidx, mask, w, xnews, delay = shard_inputs(
        g, F, B, K, E, C_OUT, 4)
    # the uniform forms read the first row's controls for every filter:
    # every row holds them
    uidx = torch.full_like(idx, 1)
    upidx = torch.zeros_like(idx)
    umask = mask[:1].expand_as(mask).contiguous()
    t = torch.tensor(37, dtype=torch.int32, device=dev)
    rows = np.arange(F)
    rows32 = torch.arange(F, dtype=torch.int32, device=dev)
    forms = {
        "mac_mix_shard, uniform": (
            lambda m, S: ms.mac_mix_shard(m, *S["rb"], S["u"], S["um"], t,
                                          S["w"], True),
            lambda: mm.mac_mix(ring, bank, uidx, umask, t, w, True)),
        "mac_mix_shard, per-filter": (
            lambda m, S: ms.mac_mix_shard(m, *S["rb"], S["i"], S["m"], t,
                                          S["w"], False),
            lambda: mm.mac_mix(ring, bank, idx, mask, t, w, False)),
        "mac_shard": (
            lambda m, S: ms.mac_shard(m, *S["rb"], rows, S["i"], S["m"], t),
            lambda: tm.mac(ring, bank, rows32, idx, mask, t, False)),
        "mac_dual_shard": (
            lambda m, S: torch.cat(ms.mac_dual_shard(
                m, *S["rb"], rows, S["u"], S["um"], S["pu"], S["um"], t,
                True)),
            lambda: torch.cat(td.mac_dual(ring, bank, rows32, uidx, umask,
                                          upidx, umask, t, True))),
        "mac_group_shard, G = 4": (
            lambda m, S: ms.mac_group_shard(m, *S["rb"][:1], S["x"],
                                            S["rb"][1], S["i"], S["m"], t,
                                            S["d"]),
            lambda: mg.mac_group(ring, xnews, bank, idx, mask, t, delay)),
    }
    splits = {}
    for shape in ((2, 2), (1, 4)):
        m = card_mesh(*shape)
        splits[shape] = (m, {
            "rb": (split(m, ring, 0, 3), split(m, bank, None, 3)),
            "i": split(m, idx, 0), "u": split(m, uidx, 0),
            "p": split(m, pidx, 0), "m": split(m, mask, 0),
            "pu": split(m, upidx, 0), "um": split(m, umask, 0),
            "w": split(m, w, 1), "x": split(m, xnews, 0, 3),
            "d": split(m, delay, 0)})
    for name, (form, one) in forms.items():
        ref = one()
        for shape, (m, S) in splits.items():
            got = form(m, S)
            torch.cuda.synchronize()
            if name.startswith("mac_mix") and shape[0] > 1:
                rel, _ = check(f"{name} at {shape[0]} x {shape[1]}", got,
                               ref, 37)
                how = f"within {rel:.3e} relative"
            else:
                if not torch.equal(got, ref):
                    fail(f"{name} at {shape[0]} x {shape[1]} is not "
                         f"bit-equal to the unsharded call")
                how = "bit-equal"
            print(f"{name} at {shape[0]} x {shape[1]} on the card: {how} "
                  f"to the unsharded kernel call", flush=True)
    # timed at 2 x 2
    m, S = splits[(2, 2)]
    Fh, Kh = F // 2, K // 2
    R00, B00 = S["rb"][0].parts[0][0], S["rb"][1].parts[0][0]
    i00, u00 = S["i"].parts[0][0], S["u"].parts[0][0]
    m00, um00 = S["m"].parts[0][0], S["um"].parts[0][0]
    pu00 = S["pu"].parts[0][0]
    w00, x00, d00 = S["w"].parts[0][0], S["x"].parts[0][0], S["d"].parts[0][0]
    r00 = torch.arange(Fh, dtype=torch.int32, device=dev)
    one_shard = {
        "mac_mix_shard, uniform": (
            lambda: mm.mac_mix(R00, B00, u00, um00, t, w00, True),
            mac_bytes_flops(Fh, B, Kh, C_OUT, 1)),
        "mac_mix_shard, per-filter": (
            lambda: mm.mac_mix(R00, B00, i00, m00, t, w00, False),
            mac_bytes_flops(Fh, B, Kh, C_OUT, E)),
        "mac_shard": (
            lambda: tm.mac(R00, B00, r00, i00, m00, t, False),
            mac_bytes_flops(Fh, B, Kh, 0, E, out_rows=Fh)),
        "mac_dual_shard": (
            lambda: td.mac_dual(R00, B00, r00, u00, um00, pu00, um00, t,
                                True),
            dual_bytes_flops(Fh, B, Kh, 2)),
        "mac_group_shard, G = 4": (
            lambda: mg.mac_group(R00, x00, B00, i00, m00, t, d00),
            mac_bytes_flops(Fh, B, Kh, 0, E, G=4, out_rows=Fh)),
    }
    for name, (form, one) in forms.items():
        kern, (nb, nf) = one_shard[name]
        k_ms = time_ms(kern, REPS, flush)
        f_ms = time_ms(lambda: form(m, S), REPS, flush)
        u_ms = time_ms(one, REPS, flush)
        b_ms, by = bound(nb, nf)
        print(f"{name}, shard shape {Fh} x {B} x {Kh}: kernel {k_ms:.4f} ms "
              f"at one shard, bound {b_ms:.4f} ms ({by}: {nb / 1e6:.1f} MB), "
              f"floor {FLOOR_MS:.4f} ms; the 2 x 2 form on one card "
              f"{f_ms:.4f} ms (4 launches and the assembly); the unsharded "
              f"call {u_ms:.4f} ms; median of {REPS}, L2 flushed by a read "
              f"before each", flush=True)
    del splits, ring, bank, xnews
    torch.cuda.empty_cache()


def run_engine(cfg: str, frames: int, channels: int, label: str, mesh=None,
               how: str = "run_offline"):
    """One file-to-file run of ``Engine`` on the config file ``cfg``
    (``mesh=``: sharded); returns (y [frames, channels], stderr)."""
    from brutefir_tpu_torch.config import parse_config
    from brutefir_tpu_torch.runtime.engine import Engine
    out = os.path.join(WORK, "output.raw")
    if os.path.exists(out):
        os.remove(out)
    with open(cfg) as fh:
        text = fh.read()
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        eng = Engine(parse_config(text), mesh=mesh)
        stats = getattr(eng, how)()
    wall = time.perf_counter() - t0
    sys.stderr.write(err.getvalue())
    y = np.fromfile(out, dtype="<i4")
    if y.size != frames * channels:
        fail(f"output has {y.size // channels} frames, input {frames} "
             f"({label})")
    shape = ("unsharded" if eng.mesh is None else
             f"mesh {eng.mesh.shape['f']} x {eng.mesh.shape['sp']}")
    print(f"main path ({label}, {shape}, {how}): {stats['blocks']} blocks, "
          f"{frames} frames in and out; run {stats['elapsed_s']:.3f} s "
          f"({stats['elapsed_s'] / stats['blocks'] * 1e3:.3f} ms a block, "
          f"xrt {stats['xrt']:.2f}), with the engine's build "
          f"{wall:.3f} s", flush=True)
    return y.reshape(frames, channels), err.getvalue()


def sharded_pair(mods, cfg, frames, channels, label, mesh, want,
                 launched, how="run_offline"):
    """The config unsharded and on ``mesh``, the counts set to 0 just
    before the sharded run and read just after it (``want`` by form,
    added to the rows' launches); returns (y sharded, y unsharded,
    sharded stderr)."""
    y1, _ = run_engine(cfg, frames, channels, label, None, how)
    for m in mods.values():
        m.reset_launches()
    ys, err = run_engine(cfg, frames, channels, label, mesh, how)
    counts = all_counts(mods)
    expect_only(counts, want, f"{label}, sharded")
    add_counts(launched, counts, *[k for k in counts if counts[k]])
    gap = int(np.abs(ys.astype(np.int64) - y1).max())
    same = float(np.mean(ys == y1))
    print(f"main path ({label}): sharded against unsharded max {gap} LSB "
          f"(tol 1), {same * 100:.2f}% of words equal", flush=True)
    if gap > 1:
        fail(f"{label}: the sharded run is {gap} LSB from the unsharded")
    return ys, y1, err


def main_sharded_massive(mods: dict, launched: dict):
    """Phase 32: the massive shape at 2 x 2 through ``run_offline``: the
    uniform fused MAC + mix per shard, 4 launches a block."""
    frames = int(BLOCKS * K)
    blocks = int(np.ceil(BLOCKS))
    taps, x = write_massive_inputs(np.random.default_rng(SEED), frames)
    cfg = massive_config("mesh1.conf", False)
    ys, y1, _ = sharded_pair(mods, cfg, frames, F, "massive at 2 x 2",
                             card_mesh(2, 2),
                             {"uniform": 4 * blocks,
                              **glue_want(0, blocks, blocks)}, launched)
    lsb = oracle_lsbs([ys, y1], x, lambda c: taps[0])
    print(f"main path (massive at 2 x 2): max |y - oracle| {lsb[0]} LSB "
          f"(tol {LSB_TOL}); unsharded {lsb[1]}", flush=True)
    if lsb[0] > LSB_TOL:
        fail("massive at 2 x 2 off the float64 oracle")
    return ys


def main_sharded_scale(mods: dict, launched: dict):
    """Phase 33: the scale shape at 1 x 4: the batches in groups of 4
    through ``mac_group_shard`` (4 launches a group, the mix outside),
    the 4-block tail through the per-filter fused MAC + mix per shard
    (its 2048-bin shards take the untiled kernel)."""
    frames = int(BLOCKS * K)
    blocks = int(np.ceil(BLOCKS))
    taps, x, cfg = write_scale_inputs(WORK, frames)
    ys, y1, _ = sharded_pair(mods, cfg, frames, SCALE_C, "scale at 1 x 4",
                             card_mesh(1, 4),
                             {"group": 4 * 4, "rows": 4 * 4,
                              **glue_want(0, blocks, blocks)}, launched)
    lsb = oracle_lsbs([ys, y1], x, lambda c: taps[c].astype(np.float64))
    print(f"main path (scale at 1 x 4): max |y - oracle| {lsb[0]} LSB (tol "
          f"{LSB_TOL}); unsharded {lsb[1]}", flush=True)
    if lsb[0] > LSB_TOL:
        fail("scale at 1 x 4 off the float64 oracle")


def main_sharded_bench5(mods: dict, launched: dict):
    """Phase 34: bench5, a crossfade every block, at 2 x 1 through
    ``run()``: the dual MAC per shard (2 launches a crossfade block),
    the fused MAC + mix on block 0."""
    N_, C = BENCH5_N, BENCH5_C
    frames = int(BLOCKS * N_)
    blocks = int(np.ceil(BLOCKS))
    taps, x, cfg = write_bench5_inputs(WORK, frames)
    ys, _, _ = sharded_pair(mods, cfg, frames, C, "bench5 at 2 x 1",
                            card_mesh(2, 1),
                            {"mac_dual_uniform": 2 * (blocks - 1),
                             "uniform": 2, **glue_want(0, blocks, blocks)},
                            launched, how="run")
    worst, peak = xfade_lsb(
        ys.astype(np.float64), x, taps, N_,
        lambda k: "a" if k == 0 else ("ab" if k % 2 else "ba"),
        range(0, C, 5))
    tol = 8e-6 * peak + 4.0
    print(f"main path (bench5 at 2 x 1): max |y - ramp oracle| {worst:.3f} "
          f"LSB (tol {tol:.3f}) on channels 0, 5, ..., 25", flush=True)
    if not worst <= tol:
        fail("bench5 at 2 x 1 off the float64 linear-ramp oracle")


def main_sharded_bench1(mods: dict, launched: dict):
    """Phase 35: bench1's cascade at 1 x 2: each stage's rows through
    ``mac_shard`` (2 launches a stage), bit-equal to the unsharded run."""
    frames = int(BLOCKS * BENCH1_N)
    n = 2 * int(np.ceil(BLOCKS))
    taps, x, cfg = write_bench1_inputs(WORK, frames)
    ys, y1, _ = sharded_pair(mods, cfg, frames, 2, "bench1 at 1 x 2",
                             card_mesh(1, 2),
                             {"mac_rows": 2 * n, **glue_want(0, n, n)},
                             launched)
    if not np.array_equal(ys, y1):
        fail("bench1 at 1 x 2 is not bit-equal to the unsharded run")
    ref = bench1_oracle(taps, x)
    for c in range(2):
        peak = np.abs(ref[:, c]).max()
        err = np.abs(ys[:, c] - ref[:, c]).max()
        tol = 2e-5 * peak + 4.0
        print(f"main path (bench1 at 1 x 2): channel {c}: max |y - oracle| "
              f"{err:.3f} (tol {tol:.3f})", flush=True)
        if not err <= tol:
            fail(f"bench1 at 1 x 2 off the float64 oracle on channel {c}")


def pinned_config(name: str) -> str:
    """examples/multichannel_massive.conf with ``process:`` pins: filters
    0-13 on process 0, 14-25 on process 1 (groups of 14 and 12)."""
    import re
    path = massive_config(name, False)
    with open(path) as fh:
        text = fh.read()

    def pin(m):
        return f"{m.group(1)} process: {0 if int(m.group(2)) < 14 else 1}; }};"

    text, n = re.subn(r'(filter (\d+)\s*\{[^}]*coeff: "correction";)\s*\};',
                      pin, text)
    if n != F:
        fail(f"pinned {n} filters of the example config, not {F}")
    with open(path, "w") as fh:
        fh.write(text)
    return path


def main_sharded_pinned(mods: dict, launched: dict, y_massive):
    """Phase 36: the massive shape with two process groups (14 + 12
    filters) at 2 x 1: the placement pads the second group to 14 rows
    (28 spec rows), one 14-row shard a group; the JAX engine's stderr
    lines; on one card unsharded, its warning that the pins have no
    effect."""
    frames = int(BLOCKS * K)
    blocks = int(np.ceil(BLOCKS))
    taps, x = write_massive_inputs(np.random.default_rng(SEED), frames)
    cfg = pinned_config("pinned.conf")
    ys, y1, err = sharded_pair(mods, cfg, frames, F, "massive pinned at "
                               "2 x 1", card_mesh(2, 1),
                               {"uniform": 2 * blocks,
                                **glue_want(0, blocks, blocks)}, launched)
    line = ("Manual process placement: 2 process group(s) onto the 2-way "
            "'f' mesh axis (28 filter rows incl. padding)")
    if line not in err:
        fail(f"the pinned run did not print {line!r}")
    print(f"main path (massive pinned at 2 x 1): stderr: {line}", flush=True)
    gap = int(np.abs(ys.astype(np.int64) - y_massive).max())
    lsb = oracle_lsb(ys, x, lambda c: taps[0])
    print(f"main path (massive pinned at 2 x 1): max |y - oracle| {lsb} LSB "
          f"(tol {LSB_TOL}); {gap} LSB from the 2 x 2 run", flush=True)
    if lsb > LSB_TOL or gap > 1:
        fail("massive pinned at 2 x 1 off its oracle or the 2 x 2 run")
    _, err1 = run_engine(cfg, frames, F, "massive pinned, one card")
    warn = ("Warning: filter process: settings have no effect (single "
            "device or no 'f' mesh axis to place onto)")
    if warn not in err1:
        fail("the unsharded pinned run did not warn that the pins have no "
             "effect")
    print(f"main path (massive pinned, one card): stderr: {warn}",
          flush=True)


def mesh_child():
    """Phase 37 in a child process that sees two cards
    (CUDA_VISIBLE_DEVICES=0,1): the massive shape at 2 x 1 and 1 x 2
    across cuda:0 and cuda:1, each to its float64 oracle; the last line
    one JSON object of launch counts."""
    import torch
    from brutefir_tpu_torch.ops import (fft_glue as tg, mac_mix as mm)
    if torch.cuda.device_count() < 2:
        fail("the mesh child sees fewer than two cards")
    os.makedirs(WORK, exist_ok=True)
    mods = {"mac_mix": mm, "fft_glue": tg}
    frames = int(BLOCKS * K)
    blocks = int(np.ceil(BLOCKS))
    taps, x = write_massive_inputs(np.random.default_rng(SEED), frames)
    cfg = massive_config("cards.conf", False)
    devs = [torch.device("cuda:0"), torch.device("cuda:1")]
    total = {}
    ys = []
    for f, sp in ((2, 1), (1, 2)):
        for m in mods.values():
            m.reset_launches()
        y, _ = run_engine(cfg, frames, F, f"massive across two cards",
                          card_mesh(f, sp, devs))
        counts = all_counts(mods)
        expect_only(counts, {"uniform": 2 * blocks,
                             **glue_want(0, blocks, blocks)},
                    f"massive across two cards at {f} x {sp}")
        for k, v in counts.items():
            total[f"{k[0]}/{k[1]}"] = total.get(f"{k[0]}/{k[1]}", 0) + v
        ys.append(y)
    lsb = oracle_lsbs(ys, x, lambda c: taps[0])
    print(f"across two cards: max |y - oracle| {lsb[0]} LSB at 2 x 1, "
          f"{lsb[1]} at 1 x 2 (tol {LSB_TOL})", flush=True)
    if max(lsb) > LSB_TOL:
        fail("the massive shape across two cards is off the oracle")
    shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"cards": total}))


def main_cards(launched: dict):
    """Phase 37: across cards, when the host has two or more."""
    if HOST_CARDS["count"] < 2:
        print(f"across cards: not run: the host has "
              f"{HOST_CARDS['count']} card(s) (torch.cuda.device_count() "
              f"before the pin), and this phase needs two", flush=True)
        return
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0,1")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        MESH_CHILD_ARG], capture_output=True, text=True,
                       timeout=600, cwd=REPO, env=env)
    lines = r.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"  | {line}", flush=True)
    sys.stderr.write(r.stderr[-20000:])
    if r.returncode != 0 or not lines:
        fail(f"the across-cards child exited {r.returncode}")
    for key, n in json.loads(lines[-1])["cards"].items():
        mod, form = key.split("/")
        launched[(mod, form)] = launched.get((mod, form), 0) + n


# --- the bf16 operand forms and the opt-in knobs (phases 7d, 38-42) ------

BF16_COMBOS = ((1, 0), (0, 1), (1, 1))     # (ring, bank) in bfloat16
BF16_NAMES = {(1, 0): "ring", (0, 1): "bank", (1, 1): "ring and bank"}
RING_BOUND = 0.005       # of the float32 run's peak, + 2 LSB: the ring knob
QUANT_TOL = LSB_TOL      # the bank knob against the quantized-bank oracle


def bf16_suffix(combo) -> str:
    """The launch-count suffix of a bf16 form (ops/mac_mix.bf16_suffix)."""
    from brutefir_tpu_torch.ops.mac_mix import BF16_SUFFIXES
    return BF16_SUFFIXES[combo[0] + 2 * combo[1] - 1]


def bf16_operands(combo, ring, bank, xnews=None):
    """The ring (and xnews, of the ring's dtype) and the bank of a
    combination: bfloat16 where it says so, else the float32 tensors."""
    import torch
    r16, b16 = combo
    ring = ring.to(torch.bfloat16) if r16 else ring
    bank = bank.to(torch.bfloat16) if b16 else bank
    return ring, bank, None if xnews is None else xnews.to(ring.dtype)


def bf16_cases(mods):
    """Rows 1-10 at the shapes of their paths: (row, name, shape, source,
    TPU line, module, form, the combinations a main path launches, a setup
    returning (ring, bank, xnews, mask, call, plain, bytes_of)), where
    call(ring, bank, xnews, mask, t) launches the kernel, plain(...) runs
    its plain version and bytes_of(ring_bytes, bank_bytes) gives (bytes,
    operations)."""
    import torch
    mm, mg, tm, td = (mods[k] for k in ("mac_mix", "mac_group", "mac",
                                        "mac_dual"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 17)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def i32(x):
        return x.to(torch.int32)

    def tiled_forced(fn):
        # the bin-tiled kernel at a shape below the route's threshold (a
        # shard's); the launch counts under its own key
        def call(*a):
            route = mm.tiled_route
            mm.tiled_route = lambda *_: True
            try:
                return fn(*a)
            finally:
                mm.tiled_route = route
        return call

    def mix_case(uniform, Fc, Cc, Ec, K_=K, bin0=True, forced=False):
        def setup():
            ring, bank = rnd(Fc, B, 2, K_), rnd(Ec, B, 2, K_)
            w = rnd(Cc, Fc) / 16.0
            idx = (torch.full((Fc,), Ec - 1, dtype=torch.int32, device=dev)
                   if uniform else i32(torch.randperm(Fc, generator=g,
                                                      device=dev) % Ec))
            delay = i32(torch.arange(Fc, device=dev) % (1 if uniform else 4))
            call = lambda r, h, x, m, t: mm.mac_mix(r, h, idx, m, t, w,
                                                    uniform, bin0)
            return (ring, bank, None, cblocks_mask(delay, B),
                    tiled_forced(call) if forced else call,
                    lambda r, h, x, m, t: mm.mac_mix_reference(
                        r, h, idx, m, t, w, uniform, bin0),
                    lambda rb, hb: mac_bytes_flops(
                        Fc, B, K_, Cc, 1 if uniform else Ec, ring_bytes=rb,
                        bank_bytes=hb))
        return setup

    def group_case(G, fused, Fs=SCALE_C, K_=K, bin0=True):
        def setup():
            ring, bank = rnd(Fs, B, 2, K_), rnd(Fs, B, 2, K_)
            xnews = rnd(Fs, G - 1, 2, K_)
            w = rnd(Fs, Fs) / 16.0
            idx = i32(torch.randperm(Fs, generator=g, device=dev))
            delay = i32(torch.arange(Fs, device=dev) % (G + 2))
            if fused:
                call = lambda r, h, x, m, t: mg.mac_mix_group(
                    r, x, h, idx, m, t, w, delay, bin0)
                plain = lambda r, h, x, m, t: mg.mac_mix_group_reference(
                    r, x, h, idx, m, t, w, delay, bin0)
            else:
                call = lambda r, h, x, m, t: mg.mac_group(
                    r, x, h, idx, m, t, delay, bin0)
                plain = lambda r, h, x, m, t: mg.mac_group_reference(
                    r, x, h, idx, m, t, delay, bin0)
            return (ring, bank, xnews, cblocks_mask(delay, B), call, plain,
                    lambda rb, hb: mac_bytes_flops(
                        Fs, B, K_, Fs if fused else 0, Fs, G,
                        out_rows=None if fused else Fs, ring_bytes=rb,
                        bank_bytes=hb))
        return setup

    def mac_case(F_, B_, K_, E_, uniform, stage):
        def setup():
            ring, bank, idx, mask, st = mac_inputs(g, F_, B_, K_, E_,
                                                   uniform, stage)
            rt = torch.tensor(st, dtype=torch.int32, device=dev)
            used = 1 if uniform else len(set(idx[rt.long()].tolist()))
            return (ring, bank, None, mask,
                    lambda r, h, x, m, t: tm.mac(r, h, rt, idx, m, t,
                                                 uniform),
                    lambda r, h, x, m, t: tm.mac_reference(r, h, rt, idx, m,
                                                           t, uniform),
                    lambda rb, hb: (lambda nb, nf: (nb + len(st) * 4, nf))(
                        *mac_bytes_flops(len(st), B_, K_, 0, used,
                                         out_rows=len(st), ring_bytes=rb,
                                         bank_bytes=hb)))
        return setup

    def dual_case():
        def setup():
            ring, bank, idx, mask, pidx, pmask, st = dual_inputs(
                g, BENCH5_C, BENCH5_B, BENCH5_N, 2, True, None)
            rt = torch.tensor(st, dtype=torch.int32, device=dev)
            return (ring, bank, None, mask,
                    lambda r, h, x, m, t: td.mac_dual(r, h, rt, idx, m, pidx,
                                                      pmask, t, True),
                    lambda r, h, x, m, t: td.mac_dual_reference(
                        r, h, rt, idx, m, pidx, pmask, t, True),
                    lambda rb, hb: dual_bytes_flops(
                        len(st), BENCH5_B, BENCH5_N, 2, rb, hb))
        return setup

    src = "brutefir_tpu_torch/csrc/"
    bank1, both = ((0, 1),), ((1, 1),)
    massive = f"{F} x {C_OUT}, {K} x {B}"
    scale = f"{SCALE_C} x {SCALE_C}, {K} x {B}"
    return (
        (1, "mac_mix_uniform", massive, src + "mac_mix.cu", 615, "mac_mix",
         "uniform", BF16_COMBOS, mix_case(True, F, C_OUT, E)),
        (2, "mac_mix_rows", massive, src + "mac_mix.cu", 582, "mac_mix",
         "rows", BF16_COMBOS, mix_case(False, F, C_OUT, E)),
        (3, "mac_mix_tiled", scale, src + "mac_mix_tiled.cu", 665,
         "mac_mix", "tiled", both, mix_case(False, SCALE_C, SCALE_C,
                                            SCALE_C)),
        (3, "mac_mix_tiled_shard", f"128 x {SCALE_C}, 4096 x {B}, "
         "has_bin0 = 0 (a 2 x 2 shard of the scale shape; the route forced)",
         src + "mac_mix_tiled.cu", 665, "mac_mix", "tiled", (),
         mix_case(False, 128, SCALE_C, 128, 4096, False, True)),
        (4, "mac_group", "G=4, " + scale, src + "mac_group.cu", 956,
         "mac_group", "group", both, group_case(4, False)),
        (4, "mac_group_shard", f"G=4, 128 filters, 4096 x {B}, has_bin0 = "
         "0 (a 2 x 2 shard of the scale shape)", src + "mac_group.cu", 956,
         "mac_group", "group", (), group_case(4, False, 128, 4096, False)),
        (5, "mac_mix_group", "G=2, " + scale, src + "mac_group.cu", 768,
         "mac_group", "mix_group", both, group_case(2, True)),
        (6, "mac_rows", f"Fs=4 of 6, {K} x 8", src + "mac.cu", 102, "mac",
         "mac_rows", bank1, mac_case(6, 8, K, 7, False, [2, 3, 4, 5])),
        (7, "mac_uniform", f"{2 * F} rows, {K} x {B}", src + "mac.cu", 149,
         "mac", "mac_uniform", bank1,
         mac_case(2 * F, B, K, 1, True, list(range(2 * F)))),
        (8, "mac_dual_uniform", f"{BENCH5_C} rows, {BENCH5_N} x {BENCH5_B}",
         src + "mac_dual.cu", 404, "mac_dual", "mac_dual_uniform", both,
         dual_case()),
        (9, "mac_rows_chunked_shape", f"{SCALE_C} distinct rows, {K} x {B}",
         src + "mac.cu", 318, "mac", "mac_rows", bank1,
         mac_case(SCALE_C, B, K, SCALE_C, False, None)),
        (10, "mac_rows_tile_shape", "4 rows, 65536 x 8", src + "mac.cu", 79,
         "mac", "mac_rows", bank1,
         mac_case(4, 8, 65536, 4, False, [0, 1, 2, 3])),
    )


def kernels_bf16(mods, rows, flush):
    """Phase 7d: each of rows 1-10 at its path's shape, and rows 3-4 at
    a 2 x 2 shard of the scale shape with has_bin0 = 0, under the three
    bf16 combinations (ring, bank, both): the kernel's bf16 form against
    its plain version on the same bfloat16 operands (which it widens:
    REL_TOL), its launch counted in ``launches``, timed beside the
    plain version with bf16 bytes counted at 2 a value in the bound. The
    combinations a main path launches enter the kernels summary."""
    import torch
    dev = torch.device("cuda")
    for (row, name, shape, src, line, mod, form, on_path,
         setup) in bf16_cases(mods):
        ring, bank, xnews, mask, call, plain, bytes_of = setup()
        ones = torch.ones_like(mask)
        t7 = torch.tensor(7, dtype=torch.int32, device=dev)
        B_ = ring.shape[1]
        for combo in BF16_COMBOS:
            r, h, x = bf16_operands(combo, ring, bank, xnews)
            key = form + bf16_suffix(combo)
            worst = max_abs = 0.0
            for tv in (0, 5, B_ - 1, 37):
                t = torch.tensor(tv, dtype=torch.int32, device=dev)
                before = mods[mod].launches[key]
                got, ref = call(r, h, x, mask, t), plain(r, h, x, mask, t)
                if mods[mod].launches[key] != before + 1:
                    fail(f"{name}: the {key} form was not launched")
                for a, b in zip(*((got, ref) if isinstance(got, tuple)
                                  else ((got,), (ref,)))):
                    rel, err = check(f"{name} {BF16_NAMES[combo]} bf16",
                                     a, b, tv)
                    worst, max_abs = max(worst, rel), max(max_abs, err)
                del got, ref
            k_ms = time_ms(lambda: call(r, h, x, ones, t7), REPS, flush)
            p_ms = time_ms(lambda: plain(r, h, x, ones, t7), REPS, flush)
            nb, nf = bytes_of(2 if combo[0] else 4, 2 if combo[1] else 4)
            report(rows, f"{name}{bf16_suffix(combo)}", src, line, worst,
                   max_abs, k_ms, p_ms, nb, nf,
                   (mod, key) if combo in on_path else None,
                   note=f" (row {row}, {shape}, bf16 {BF16_NAMES[combo]})")
            del r, h, x
        del ring, bank, xnews
        torch.cuda.empty_cache()
    print_ptxas("mac_group", ("mac_mix_group_bf16_kernel",),
                "row 5's bf16 forms, one instance a G and operand form")
    for combo in BF16_COMBOS:
        print(f"  row 5's launch plan at G=2, C_out={SCALE_C}, bf16 "
              f"{BF16_NAMES[combo]}: "
              f"{mods['mac_group'].mix_group_plan(2, SCALE_C, *combo)}",
              flush=True)
    print(f"  row 7's launch plan at {2 * F} rows of {K} x {B} under the bank "
          f"knob: {mods['mac'].launch_plan(1, 2 * F, K, torch.float32, True, None, torch.bfloat16)}"
          f" (float32 {mods['mac'].launch_plan(1, 2 * F, K)})", flush=True)


def quantized_spectra(bank_row) -> np.ndarray:
    """A bank row [P, 2, N] (bfloat16 or float32, on any device) as its
    widened, unpacked float64 spectra [P, N + 1]."""
    from brutefir_tpu_torch.ops.partconv import unpack_spectrum
    p = bank_row.double().cpu().numpy()
    return unpack_spectrum(p[:, 0] + 1j * p[:, 1])


def partconv_q(x, H, N_: int, whole: bool = False) -> np.ndarray:
    """The float64 response of the partitioned overlap-save convolution
    with the spectra ``H`` [P, N + 1] (a quantized bank row, widened and
    unpacked): x [n, C] -> y [n, C], frame t = [x_{t-1}, x_t] (zeros past
    n), Y_t = sum_p rfft(frame_{t-p}) H_p, y_t the lower half of
    irfft(Y_t); with ``whole``, every block's N samples (the stream a
    cascade's next stage reads: the effective taps of a quantized
    spectrum reach forward within a block, so the last block's samples
    past n matter). Exact for any spectra, where a linear convolution
    with the effective taps would not be."""
    x = np.asarray(x, np.float64)
    n, C = x.shape
    nb = -(-n // N_)
    xp = np.zeros(((nb + 1) * N_, C))
    xp[N_:N_ + n] = x
    X = np.fft.rfft(np.stack([xp[t * N_:(t + 2) * N_] for t in range(nb)]),
                    axis=1)                          # [nb, N + 1, C]
    y = np.empty((nb * N_, C))
    for t in range(nb):
        Y = sum(X[t - p] * H[p][:, None] for p in range(min(len(H), t + 1)))
        y[t * N_:(t + 1) * N_] = np.fft.irfft(Y, 2 * N_, axis=0)[:N_]
    return y if whole else y[:n]


def engine_bank(cfg: str, N_: int, B_: int, bf16: bool):
    """The bank the engine builds from ``cfg`` ([E, B, 2, N] on the host):
    the port's own config parser and bank build, then the bf16 cast of
    ``BRUTEFIR_TPU_BANK_DTYPE=bf16``."""
    import torch
    from brutefir_tpu_torch.config import parse_config
    from brutefir_tpu_torch.config.coeffs import build_bank
    from brutefir_tpu_torch.ops.partconv import np_c2p
    with open(cfg) as fh:
        conf = parse_config(fh.read())
    bank = torch.as_tensor(np_c2p(build_bank(conf.coeffs, N_, B_,
                                             np.float32)))
    return bank.to(torch.bfloat16) if bf16 else bank


def quant_gap(y, ref) -> float:
    """Max |y - ref| in LSB (ref float64, not rounded)."""
    return float(np.abs(y.astype(np.float64) - ref).max())


def run_counted(main, mods, cfg, frames, channels, label, want, knobs=()):
    """One run of ``main()`` under ``knobs`` ((name, value) pairs), every
    count set to 0 just before it: the forms in ``want`` launched as
    often as it says, every other form never. Returns (y, counts)."""
    with contextlib.ExitStack() as stack:
        for name, value in knobs:
            stack.enter_context(knob(name, value))
        for m in mods.values():
            m.reset_launches()
        y = run_main(main, cfg, frames, channels, label)
        counts = all_counts(mods)
    expect_only(counts, want, label)
    return y, counts


BANK16 = (("BRUTEFIR_TPU_BANK_DTYPE", "bf16"),)
RING16 = (("BRUTEFIR_TPU_RING_DTYPE", "bf16"),)
BOTH16 = BANK16 + RING16
F32 = (("BRUTEFIR_TPU_BANK_DTYPE", None), ("BRUTEFIR_TPU_RING_DTYPE", None))


def main_massive_bf16(main, mods: dict, launched: dict):
    """Phase 38: the massive shape, shared and with two coefficients,
    each in turns float32, under BRUTEFIR_TPU_BANK_DTYPE=bf16, under
    BRUTEFIR_TPU_RING_DTYPE=bf16 and under both: the bank knob within
    QUANT_TOL LSB of the float64 response of the quantized bank (both
    runs' gaps to both oracles printed); the ring knob and both knobs
    within the ring bound of the float32 run (``ring_check``); each run
    launching its form of the fused MAC + mix once a block."""
    frames = int(BLOCKS * K)
    blocks = int(np.ceil(BLOCKS))
    taps, x = write_massive_inputs(np.random.default_rng(SEED), frames)
    glue = glue_want(blocks, blocks)
    glue16 = glue_want(blocks, blocks, ring="glue_fwd_ring_bf16")
    for two in (False, True):
        cfg = massive_config("run2.conf" if two else "run1.conf", two)
        form = "rows" if two else "uniform"
        sets = [0, 1] if two else [0]
        q = {s: quantized_spectra(b) for s, b in
             enumerate(engine_bank(cfg, K, B, True)[sets])}
        ref_q = np.empty((frames, F))
        for s in sets:
            cols = [c for c in range(F) if (two and c >= 13) == bool(s)]
            ref_q[:, cols] = partconv_q(x[:, cols], q[s], K)
        tag = "two coefficients" if two else "shared coefficient"
        y32, _ = run_counted(main, mods, cfg, frames, F,
                             f"massive, {tag}, float32",
                             {form: blocks, **glue}, F32)
        label = f"massive, {tag}, bf16 bank"
        y16, counts = run_counted(main, mods, cfg, frames, F, label, {
            form + "_bf16b": blocks, **glue}, BANK16)
        lsb = oracle_lsb(y16, x, lambda c: taps[1] if (two and c >= 13)
                         else taps[0])
        g16, g32 = quant_gap(y16, ref_q), quant_gap(y32, ref_q)
        print(f"main path ({label}): max |y - quantized-bank oracle| "
              f"{g16:.3f} LSB (tol {QUANT_TOL}); the float32 bank's run "
              f"{g32:.3f} LSB from it; from the float32 oracle: bf16 bank "
              f"{lsb} LSB, float32 bank "
              f"{oracle_lsb(y32, x, lambda c: taps[1] if (two and c >= 13) else taps[0])}"
              f" LSB", flush=True)
        if not g16 <= QUANT_TOL:
            fail(f"{label}: off the quantized-bank oracle by {g16:.3f} LSB")
        add_counts(launched, counts, ("mac_mix", form + "_bf16b"))
        for sfx, knobs, what in (("_bf16r", RING16, "bf16 ring"),
                                 ("_bf16rb", BOTH16, "bf16 bank and ring")):
            label = f"massive, {tag}, {what}"
            y, counts = run_counted(main, mods, cfg, frames, F, label, {
                form + sfx: blocks, **glue16}, F32 + knobs)
            ring_check(label, y, y32)
            add_counts(launched, counts, ("mac_mix", form + sfx),
                       ("fft_glue", "glue_fwd_ring_bf16"))


def main_scale_bf16(main, mods: dict, launched: dict):
    """Phase 39: the scale shape under both knobs, groups of 4 (the tail
    through the tiled kernel) and BRUTEFIR_TPU_PAIR=2, each against phase
    9's float32 run of the same input: within RING_BOUND of its peak + 2
    LSB."""
    frames = int(BLOCKS * K)
    blocks = int(np.ceil(BLOCKS))
    write_scale_inputs(WORK, frames)
    cfg = os.path.join(WORK, "scale.conf")
    runs = (("scale, groups of 4, bf16 bank and ring", None,
             {"group_bf16rb": 4, "tiled_bf16rb": 4},
             (("mac_group", "group_bf16rb"), ("mac_mix", "tiled_bf16rb"))),
            ("scale, BRUTEFIR_TPU_PAIR=2, bf16 bank and ring", "2",
             {"mix_group_bf16rb": 8, "tiled_bf16rb": 4},
             (("mac_group", "mix_group_bf16rb"),)))
    for (label, pair, want, keys), y32 in zip(runs, F32_OUT.pop("scale")):
        y16, counts = run_counted(
            main, mods, cfg, frames, SCALE_C, label,
            {**want, **glue_want(blocks + GROUP_INTO[pair], blocks,
                                 ring="glue_fwd_ring_bf16")},
            BOTH16 + (("BRUTEFIR_TPU_PAIR", pair),))
        ring_check(label, y16, y32)
        add_counts(launched, counts, *keys,
                   ("fft_glue", "glue_fwd_ring_bf16"))


def ring_check(label: str, y16, y32) -> None:
    """The ring knob's bound against the float32 run of the same input
    (tests/test_pallas_mac.py:544-577): max |y - y32| <= RING_BOUND *
    max|y32| + 2 LSB."""
    peak = float(np.abs(y32).max())
    gap = float(np.abs(y16.astype(np.int64) - y32).max())
    tol = RING_BOUND * peak + 2
    print(f"main path ({label}): max |y - float32 run| {gap:.0f} LSB (tol "
          f"{RING_BOUND} * {peak:.0f} + 2 = {tol:.0f}; "
          f"{gap / peak:.2e} of the peak)", flush=True)
    if not gap <= tol:
        fail(f"{label}: {gap:.0f} LSB off the float32 run")


def main_bench5_bf16(main, mods: dict, launched: dict):
    """Phase 40: bench5's crossfade every block under both knobs (the
    dual MAC's bf16 form on every block after the first), beside phase
    12's float32 run: within the ring bound of it; the ramp oracle's
    gap printed beside."""
    N_, C = BENCH5_N, BENCH5_C
    frames = int(BLOCKS * N_)
    blocks = int(np.ceil(BLOCKS))
    taps, x, cfg = write_bench5_inputs(WORK, frames)
    label = "bench5, bf16 ring and bank"
    y16, counts = run_counted(main, mods, cfg, frames, C, label, {
        "mac_dual_uniform_bf16rb": blocks - 1, "uniform_bf16rb": 1,
        **glue_want(blocks, blocks, ring="glue_fwd_ring_bf16")}, BOTH16)
    ring_check(label, y16, F32_OUT.pop("bench5"))
    worst, _ = xfade_lsb(
        y16.astype(np.float64), x, taps, N_,
        lambda k: "a" if k == 0 else ("ab" if k % 2 else "ba"),
        range(0, C, 5))
    print(f"main path ({label}): max |y - ramp oracle| {worst:.3f} LSB "
          f"(the float32 run's {F32_ERR['bench5']:.3f})", flush=True)
    add_counts(launched, counts, ("mac_dual", "mac_dual_uniform_bf16rb"),
               ("fft_glue", "glue_fwd_ring_bf16"))


def main_cascades_bf16(main, mods: dict, launched: dict):
    """Phase 41: bench1's cascade and the massive cascade under
    BRUTEFIR_TPU_BANK_DTYPE=bf16, each beside its float32 run: within
    their float32 bounds of the cascaded quantized-bank oracle (bench1:
    2e-5 of the peak + 4 LSB; massive: QUANT_TOL)."""
    n2 = 2 * int(np.ceil(BLOCKS))
    frames = int(BLOCKS * BENCH1_N)
    _, x, cfg = write_bench1_inputs(WORK, frames)
    q = [quantized_spectra(b) for b in
         engine_bank(cfg, BENCH1_N, BENCH1_B, True)[:6]]

    def pq(sig, s):
        return partconv_q(sig[:, None], q[s], BENCH1_N, whole=True)[:, 0]
    x0, x1 = x[:, 0].astype(np.float64), x[:, 1].astype(np.float64)
    ref = np.stack([pq(pq(x0, 2) + pq(x1, 5), 0),
                    pq(pq(x0, 3) + pq(x1, 4), 1)], axis=1)[:frames]
    want = glue_want(n2, n2)
    y32, _ = run_counted(main, mods, cfg, frames, 2, "bench1, float32",
                         {"mac_rows": n2, **want}, F32)
    label = "bench1 cascade, bf16 bank"
    y16, counts = run_counted(main, mods, cfg, frames, 2, label,
                              {"mac_rows_bf16b": n2, **want}, BANK16)
    for c in range(2):
        peak = np.abs(ref[:, c]).max()
        tol = 2e-5 * peak + 4.0
        g16 = quant_gap(y16[:, c], ref[:, c])
        print(f"main path ({label}): channel {c}: max |y - quantized-bank "
              f"oracle| {g16:.3f} (tol 2e-5 * {peak:.0f} + 4 = {tol:.3f}); "
              f"the float32 bank's run {quant_gap(y32[:, c], ref[:, c]):.3f}",
              flush=True)
        if not g16 <= tol:
            fail(f"{label} off the quantized-bank oracle on channel {c}")
    add_counts(launched, counts, ("mac", "mac_rows_bf16b"))

    frames = int(BLOCKS * K)
    _, x = write_massive_inputs(np.random.default_rng(SEED + 5), frames)
    cfg = massive_cascade_config(WORK)
    h = quantized_spectra(engine_bank(cfg, K, B, True)[0])
    ref = partconv_q(partconv_q(x, h, K, whole=True), h, K)[:frames]
    y32, _ = run_counted(main, mods, cfg, frames, F,
                         "massive cascade, float32",
                         {"mac_uniform": n2, **want}, F32)
    label = "massive cascade, bf16 bank"
    y16, counts = run_counted(main, mods, cfg, frames, F, label,
                              {"mac_uniform_bf16b": n2, **want}, BANK16)
    g16 = quant_gap(y16, ref)
    print(f"main path ({label}): max |y - quantized-bank oracle| "
          f"{g16:.3f} LSB (tol {QUANT_TOL}); the float32 bank's run "
          f"{quant_gap(y32, ref):.3f}", flush=True)
    if not g16 <= QUANT_TOL:
        fail(f"{label}: off the quantized-bank oracle by {g16:.3f} LSB")
    add_counts(launched, counts, ("mac", "mac_uniform_bf16b"))


PROFILE_KERNELS = ("mac_mix_kernel", "glue_fwd_ring_kernel",
                   "glue_inv_kernel")


def main_profile(mods: dict, launched: dict):
    """Phase 42: the massive shape through ``Engine.run`` under
    BRUTEFIR_TPU_PROFILE=<dir>: one Chrome trace in the directory that
    names the fused MAC + mix and both glue kernels; the output within
    LSB_TOL of the oracle."""
    import glob
    from brutefir_tpu_torch.config import parse_config
    from brutefir_tpu_torch.runtime.engine import Engine
    frames = int(BLOCKS * K)
    blocks = int(np.ceil(BLOCKS))
    taps, x = write_massive_inputs(np.random.default_rng(SEED), frames)
    cfg = massive_config("run1.conf", False)
    out = os.path.join(WORK, "profile")
    shutil.rmtree(out, ignore_errors=True)
    with open(cfg) as fh:
        conf = parse_config(fh.read())
    conf.quiet = True
    for m in mods.values():
        m.reset_launches()
    t0 = time.perf_counter()
    with knob("BRUTEFIR_TPU_PROFILE", out):
        Engine(conf).run()
    wall = time.perf_counter() - t0
    counts = all_counts(mods)
    label = "massive under BRUTEFIR_TPU_PROFILE"
    expect_only(counts, {"uniform": blocks, **glue_want(blocks, blocks)},
                label)
    traces = glob.glob(os.path.join(out, "*.json"))
    if len(traces) != 1:
        fail(f"{label}: {len(traces)} trace files in {out}, expected one")
    with open(traces[0]) as fh:
        text = fh.read()
    missing = [k for k in PROFILE_KERNELS if k not in text]
    if missing:
        fail(f"{label}: the trace does not name {missing}")
    events = json.loads(text).get("traceEvents", [])
    kern = sum(1 for e in events if e.get("cat") == "kernel")
    y = np.fromfile(os.path.join(WORK, "output.raw"), "<i4").reshape(
        frames, F)
    lsb = oracle_lsb(y, x, lambda c: taps[0])
    print(f"main path ({label}): run() {wall:.3f} s with the profiler; "
          f"trace {os.path.getsize(traces[0])} bytes, {len(events)} events, "
          f"{kern} kernel events, naming {', '.join(PROFILE_KERNELS)}; max "
          f"|y - oracle| {lsb} LSB (tol {LSB_TOL})", flush=True)
    if lsb > LSB_TOL:
        fail(f"{label}: {lsb} LSB off the float64 oracle")
    add_counts(launched, counts, ("mac_mix", "uniform"))
    add_glue(launched, counts)


HOST_DITHER_TOL = 5      # phase 22, LSB: the HP-TPDF error reaches 4.5
FLOAT_TOL = 2e-5         # phase 23, of the output's peak


def run():
    phase("card")
    # the host's cards, counted before the pin (in a child process)
    HOST_CARDS.update(host_cards())
    print(f"host cards before the pin: {HOST_CARDS['count']}: "
          f"{', '.join(HOST_CARDS['names']) or '-'}", flush=True)
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
    phase("kernel vs plain, the forward glue into the ring, and the "
          "frames-to-ring sequences")
    kernels_glue_ring(tg, pc, rows, flush)
    phase("kernel vs plain, the float64 forms (float_bits: 64)")
    kernels_f64(tm, tg, rows, flush)
    phase("the fused real FFT's probe path")
    probe_fused(tf, pc, rows, flush, launched)
    from brutefir_tpu_torch.ops import mac_shard as ms
    phase("kernel vs plain, has_bin0 = 0 and 1 (rows 1-4, 6, 8, 9)")
    kernels_bin0(mm, mg, tm, td)
    phase("the shard forms on the card (2 x 2 and 1 x 4, every shard on "
          "cuda:0)")
    kernels_shard(ms, mm, mg, tm, td, flush)
    torch.cuda.empty_cache()
    phase("kernel vs plain, the bf16 operand forms (rows 1-10)")
    kernels_bf16({"mac_mix": mm, "mac_group": mg, "mac": tm, "mac_dual": td},
                 rows, flush)
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
    torch.cuda.empty_cache()
    phase("main path, massive at 2 x 2 (every shard on cuda:0)")
    y_massive = main_sharded_massive(mods, launched)
    phase("main path, scale at 1 x 4, grouped")
    main_sharded_scale(mods, launched)
    torch.cuda.empty_cache()
    phase("main path, bench5 crossfade every block at 2 x 1")
    main_sharded_bench5(mods, launched)
    phase("main path, bench1 cascade at 1 x 2")
    main_sharded_bench1(mods, launched)
    phase("main path, massive with process: pins at 2 x 1")
    main_sharded_pinned(mods, launched, y_massive)
    del y_massive
    phase("main path, across cards (a child process, two cards)")
    main_cards(launched)
    torch.cuda.empty_cache()
    phase("main path, massive, bf16 bank, ring and both (beside float32, "
          "in turns)")
    main_massive_bf16(main, mods, launched)
    phase("main path, scale, bf16 bank and ring")
    main_scale_bf16(main, mods, launched)
    torch.cuda.empty_cache()
    phase("main path, bench5 crossfade every block, bf16 ring and bank")
    main_bench5_bf16(main, mods, launched)
    phase("main path, bench1 and massive cascades, bf16 bank")
    main_cascades_bf16(main, mods, launched)
    phase("main path, massive through run() under BRUTEFIR_TPU_PROFILE")
    main_profile(mods, launched)
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
    elif sys.argv[1:] == [MESH_CHILD_ARG]:
        mesh_child()
    else:
        run()
