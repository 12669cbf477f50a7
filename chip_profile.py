#!/usr/bin/env python3
"""Where the time goes in a file-to-file run of the 256-channel scale
shape, of the massive_config shape, of a filter cascade (crossfading or
not) or of bench5's crossfade every block, on one NVIDIA GPU.

Usage (from the repository root, one CUDA card):

    python3 chip_profile.py [--shape scale|massive|bench1|massive_cascade|
                                     bench5|bench1_xfade|aligned|
                                     benchmark|eq|hostcodec|hooks|
                                     clocked|xtc_clocked|f64]
                            [--blocks N]
                            [--pair G] [--mlock]

Writes the shape's seeded inputs for N blocks (default 64) as
``chip_smoke.py`` does: the scale shape (``write_scale_inputs``: 256 x
256 channels, 131072 taps in 8192 x 16 partitions, 256 distinct
coefficient sets, S24_4LE), examples/multichannel_massive.conf (26 x
26, one shared coefficient), the reference's bench1_config cascade
(``write_bench1_inputs``: 2 x 2 through 6 filters in two stages, 65536
taps in 8192 x 8 partitions, six coefficient sets) or the massive shape
with a second stage (``massive_cascade_config``: 26 x 26 through 52
filters, one shared coefficient) or the reference's bench5_config
(``write_bench5_inputs``: 26 crossfading filters of 8192 x 8 whose
coefficient a CLI script flips every block, through the per-block
``run()``) or bench1's cascade with filters 2-5 crossfading under a CLI
script (``write_bench1_xfade_inputs``, also through ``run()``) or the
massive shape time-aligned and dithered (``aligned_config``: dithered
S24_LE outputs, output channel c delayed 37 c samples, subsample delays
on channels 0-12) or the massive shape under ``benchmark: true;``
(``mode_config``: the per-block ``run()``, printing the stage table) or
examples/room_correction_eq.conf with a CLI script changing the EQ at
block 8 (``eq_config``: 2 channels, 8192 x 8, FLOAT_LE, 48 kHz, through
``run()``) or the massive shape with S24_BE devices (``hostcodec_config``,
``chip_smoke.py``'s phase 21: the host codec path, block by block through
``run()``; the host stages are the main thread's ``read_block`` and
``_dispatch_host`` and the writer's ``write_block``) or the massive shape
with ``chip_smoke.py``'s phase 24 module ``bflogic_spectap.py`` (all six
hooks, a gain each; the host codec path through ``run()``, the taps'
transfers and the hook calls timed as well) or, clocked, the massive
shape (``clocked``, ``chip_smoke.py``'s phase 26) or the xtc example
(``xtc_clocked``, phase 28: N blocks of 64 samples) on the paced device
``bfio_paced.py`` (``chip_smoke.PACED_MODULE``: reads wait for each
fragment's due time at 44.1 kHz), through ``run()`` at the fixed 2N
latency, warmed, with SCHED_FIFO and mlockall where the host allows
them (the read time of a block is then mostly the wait for the card;
the deadline misses of the output are printed) or the massive shape
with ``float_bits: 64;`` (``f64``, ``chip_smoke.py``'s phase 29: the
stage loop's float64 MAC and glue), then runs the port's
engine three times on them: once to
warm up (kernel build, cuFFT plans), once timed on the host clock (its
stage-table lines printed), once under ``torch.profiler`` (CPU and CUDA
activities).
Prints the card, the engine's wall time a
block and realtime factor, the host time a block of each pipeline stage
in the timed run (the reads, the main thread's logic hooks, control
snapshots and dispatch, the writer's fetch, meters and writes; the
threads overlap), the device's busy
time a block (the sum of the device time of every kernel and copy in the
profiled run) and its share of the timed run's wall time, and the device
time by name, largest first. ``--pair`` sets BRUTEFIR_TPU_PAIR (default:
the engine's own). ``--mlock`` calls ``mlockall(MCL_CURRENT |
MCL_FUTURE)`` after the warm-up run and prints what it returned, so the
timed and profiled runs allocate under the lock (``mlock_probe``).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import shutil
import time

import numpy as np

import chip_smoke as cs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", choices=("scale", "massive", "bench1",
                                        "massive_cascade", "bench5",
                                        "bench1_xfade", "aligned",
                                        "benchmark", "eq", "hostcodec",
                                        "hooks", "clocked", "xtc_clocked",
                                        "f64"),
                    default="scale")
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--pair", default=None)
    ap.add_argument("--mlock", action="store_true")
    args = ap.parse_args()
    if args.pair is not None:
        os.environ["BRUTEFIR_TPU_PAIR"] = args.pair
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this profile needs a "
                "card")
    from torch.profiler import ProfilerActivity, profile
    from brutefir_tpu_torch.config import parse_config
    from brutefir_tpu_torch.graph.compile import group_size
    from brutefir_tpu_torch.runtime import engine as eng_mod
    from brutefir_tpu_torch.runtime.engine import BATCH_BLOCKS, Engine

    print(f"card: {cs.card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    os.makedirs(cs.WORK, exist_ok=True)
    frames = args.blocks * cs.K
    if args.shape == "scale":
        _, _, cfg = cs.write_scale_inputs(cs.WORK, frames)
    elif args.shape == "bench1":
        _, _, cfg = cs.write_bench1_inputs(cs.WORK, frames)
    elif args.shape == "bench5":
        _, _, cfg = cs.write_bench5_inputs(cs.WORK, frames)
    elif args.shape == "bench1_xfade":
        _, _, cfg = cs.write_bench1_xfade_inputs(cs.WORK, frames)
    elif args.shape == "eq":
        rng = np.random.default_rng(cs.SEED + 20)
        (rng.standard_normal((frames, 2)) * 0.1).astype("<f4").tofile(
            os.path.join(cs.WORK, "input.f32"))
        cfg = cs.eq_config(cs.WORK, "profile.conf", script=cs.EQ_SCRIPT)
    elif args.shape == "hostcodec":
        _, x = cs.write_massive_inputs(np.random.default_rng(cs.SEED + 21),
                                       frames)
        cs.s24_bytes(x, True).tofile(os.path.join(cs.WORK, "input.s24be"))
        cfg = cs.hostcodec_config("profile.conf", "S24_BE", "s24be")
    elif args.shape == "clocked":
        cs.write_massive_inputs(np.random.default_rng(cs.SEED + 28), frames)
        cfg = cs.to_paced(cs.massive_config("profile.conf", False),
                          "input.raw", "output.raw",
                          cs.write_module("paced", cs.PACED_MODULE, "bfio"))
    elif args.shape == "xtc_clocked":
        _, _, cfg = cs.xtc_config(args.blocks * cs.XTC_N, cs.SEED + 30)
        cfg = cs.to_paced(cfg, "input.f32", "output.s24",
                          cs.write_module("paced", cs.PACED_MODULE, "bfio"))
    elif args.shape == "hooks":
        cs.write_massive_inputs(np.random.default_rng(cs.SEED + 24), frames,
                                cs.HOOK_LEVEL)
        folder = cs.write_module("spectap", cs.SPECTAP_MODULE.format(
            kinds=cs.HOOK_KINDS, seed=cs.SEED + 25, c=cs.F,
            copy_block=cs.COPY_BLOCK))
        cfg = cs.with_module(cs.massive_config("profile.conf", False),
                             "spectap", folder)
    else:
        cs.write_massive_inputs(np.random.default_rng(cs.SEED), frames)
        cfg = {"massive": lambda: cs.massive_config("profile.conf", False),
               "aligned": lambda: cs.aligned_config("profile.conf"),
               "massive_cascade": lambda: cs.massive_cascade_config(cs.WORK),
               "benchmark": lambda: cs.mode_config("profile.conf",
                                                   "benchmark: true;"),
               "f64": lambda: cs.as_float64(
                   cs.massive_config("profile.conf", False),
                   "profile64.conf"),
               }[args.shape]()
    with open(cfg) as fh:
        text = fh.read()

    def run(host=None):
        eng = Engine(parse_config(text))
        per_block = eng.conf.benchmark or eng.conf.debug or eng._clocked()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        err = io.StringIO()
        with contextlib.ExitStack() as stack:
            if host is not None:
                # the host time of each stage's calls, seconds in a list;
                # a logic module may drop the device-IO path when run()
                # attaches it, so the host path's stages are always timed
                stages = ((eng, "read_block"), (eng, "_dispatch_host"),
                          (eng, "write_block"), (eng, "_block_start_hooks"),
                          (eng, "_snapshot_epoch"),
                          (eng_mod, "_spectra_to_host"),
                          (eng_mod, "_spectra_to_device"))
                if eng.dio is not None:
                    stages += ((eng, "read_block_dio"), (eng.dio, "step"),
                               (eng.dio, "multi_step"),
                               (eng, "_write_outputs"))
                for obj, name in stages:
                    host[name] = stack.enter_context(
                        cs.timed_method(obj, name, []))
            stack.enter_context(contextlib.redirect_stderr(err))
            stats = eng.run() if per_block else eng.run_offline()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if host is not None:
            for ln in err.getvalue().splitlines():
                if ln.startswith(("decode", "device stage")):
                    print(f"  {ln}", flush=True)
        return eng, stats, wall

    eng, _, _ = run()                                      # warm-up
    if args.mlock:
        mlock_probe()
    G = group_size(eng.spec, BATCH_BLOCKS)
    host = {}
    timed_eng, stats, wall = run(host)
    blocks = stats["blocks"]
    wall_ms = wall / blocks * 1e3
    print(f"{args.shape} shape, {blocks} blocks, BRUTEFIR_TPU_PAIR="
          f"{os.environ.get('BRUTEFIR_TPU_PAIR', 'default')} (groups of "
          f"{G}): wall {wall_ms:.3f} ms a block, engine xrt "
          f"{stats['xrt']:.2f}, p50 batch period {stats['p50_block_ms']:.3f}"
          f" ms a block", flush=True)
    print("host a block: " + ", ".join(
        f"{name} {sum(sec) / blocks * 1e3:.3f} ms"
        for name, sec in sorted(host.items()) if sec), flush=True)
    if args.shape in ("clocked", "xtc_clocked"):
        period = (cs.XTC_N if args.shape == "xtc_clocked" else cs.K) / 44100
        cs.deadlines(timed_eng.devices[1][0], args.shape, period * 1e3)
        print(f"rti_max {stats['rti_max']:.4f}; realtime "
              f"{timed_eng.realtime_state}", flush=True)
    if args.shape == "hooks":
        tap = cs.loaded_module("spectap").SpecTap.instances[-1]
        print("hook calls, host a block: " + ", ".join(
            f"{k} {v / blocks * 1e3:.3f} ms" for k, v in tap.seconds.items())
            + " (output_timed on the writer thread)", flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, pstats, pwall = run()
    # device-side events only (kernels, copies, memsets): the CPU ops that
    # launched them carry the same time again
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / pstats["blocks"]
    if not rows:
        print("device time not traced by torch.profiler: busy share not "
              "measured", flush=True)
    else:
        print(f"device busy {busy_ms:.3f} ms a block = "
              f"{busy_ms / wall_ms * 100:.1f}% of the timed run's wall "
              f"time (profiled run: {pwall / pstats['blocks'] * 1e3:.3f} "
              f"ms a block)", flush=True)
        for dev_us, count, key in rows[:40]:
            print(f"  {dev_us / 1e3 / pstats['blocks']:9.4f} ms a block "
                  f"{count:7d} calls  {key[:90]}", flush=True)
    shutil.rmtree(cs.WORK, ignore_errors=True)


def mlock_probe():
    """``mlockall(MCL_CURRENT | MCL_FUTURE)`` now, as a clocked engine's
    ``_maybe_go_realtime`` calls it once SCHED_FIFO is granted, whether
    or not this host grants it: prints the return code, errno,
    RLIMIT_MEMLOCK and the locked and resident KiB, so the timed and
    profiled runs after it allocate under the lock."""
    import ctypes
    import resource
    from brutefir_tpu_torch.runtime.engine import _locked_kib
    libc = ctypes.CDLL(None, use_errno=True)
    t0 = time.perf_counter()
    rc = libc.mlockall(3)
    err = ctypes.get_errno()
    soft, hard = resource.getrlimit(resource.RLIMIT_MEMLOCK)
    print(f"mlockall(MCL_CURRENT | MCL_FUTURE) = {rc} (errno {err}: "
          f"{os.strerror(err) if rc else 'none'}) in "
          f"{time.perf_counter() - t0:.3f} s; RLIMIT_MEMLOCK soft {soft}, "
          f"hard {hard}; {_locked_kib()}", flush=True)


if __name__ == "__main__":
    main()
