"""The engine: host pipeline around the per-block device step.

Torch twin of :mod:`brutefir_tpu.runtime.engine` for file devices, with
two loops:

- ``run``: the per-block loop (engine.py:1118-1310, 1390-1620). The main
  thread reads a block of raw words, fires the logic modules'
  ``block_start`` hooks (the CLI's script mode runs one script line
  there), takes one control snapshot under ``control_mutex`` and
  dispatches the block through the device-IO program; a writer thread
  fetches, meters and writes the results.
- ``run_offline``: the batched loop. A producer thread reads and uploads
  batches of ``BATCH_BLOCKS`` blocks, the main thread dispatches each
  batch with its controls frozen, and the same writer thread writes. A
  crossfade lands on one block: the batch dispatches its crossfade
  blocks one at a time and the rest under the same snapshot. A config
  with logic modules falls back to ``run``.

Under ``benchmark: true;`` or ``debug: true;`` ``run`` prints the
reference's stage table every 10 periods (bfrun.c:2035-2078): host ms a
block to read, to snapshot and dispatch ("device": the host's enqueue
time, as dispatch is asynchronous), to hand the block to the writer, and
in all; with ``BRUTEFIR_TPU_STAGE_BREAKDOWN=1`` the device column is split
by ``runtime/stageprobe.py``'s per-op device times. ``debug: true;`` also
dumps the input/filter/output event timeline at the end of the run.

The fixed-latency contract holds: output frame m is the convolution of
input frames <= m, and file-to-file output length equals input length
(the EOF tail runs block by block).

Channel delays, subsample delays and dither run on the device
(``runtime/device_io.py``); runtime delay and subdelay changes land on
the block boundary of the control snapshot that carries them.

The EQ logic module hot-swaps coefficient sets through
``update_bank_entry``, which rebinds a new bank tensor: a block takes the
bank of its control snapshot, so blocks already dispatched keep theirs.

Not ported (each a ROADMAP queue 1 item 4 entry, or NotImplementedError
naming its item): clocked devices and the realtime pacing around them,
the host codec, external logic modules, timed and frequency-domain
module hooks, the powersave dispatch skip (the JAX
package makes it byte-identical to always dispatching, so the port always
dispatches), the sink mode with its prefetch pool, the stall watchdog and
the clock-drift monitor; float64 (item 9).
"""

from __future__ import annotations

import collections
import os
import queue
import sys
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config.coeffs import build_bank
from ..config.model import BFConfig, IN, OUT
from ..control import check_logic_module, load_logic_module
from ..core.codecs import Overflow
from ..core.dither import DitherTable
from ..errors import BFError, BF_EXIT_INVALID_INPUT
from ..graph.compile import check_supported, init_state
from ..graph.spec import build_graph_spec
from ..io import get_io_module
from ..ops.partconv import np_c2p
from .control import RuntimeControl
from .device_io import DeviceIO, dithered_phys, eligible
from .subdelay import SubsampleDelay

# blocks per offline dispatch: block latency becomes BATCH_BLOCKS * N
BATCH_BLOCKS = 8


class EngineError(BFError):
    pass


def _expand_p24(raw: np.ndarray) -> np.ndarray:
    """[..., open, 3] le wire bytes -> [..., open] int32 container words
    (sign-extended), the inverse of the device's S24 wire packing."""
    w = (raw[..., 0].astype(np.int32)
         | (raw[..., 1].astype(np.int32) << 8)
         | (raw[..., 2].astype(np.int32) << 16))
    return w - ((w & 0x800000) << 1)


def pin_fp32_matmul() -> None:
    """Full FP32 in every matmul and convolution: TF32 keeps ~10 mantissa
    bits and costs thousands of LSB of S24 in the channel mixes (the
    analog of the JAX package's HIGHEST-precision pin)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Engine:
    """Runs a parsed config on ``device`` (None means ``cuda``; the CPU
    only when passed explicitly)."""

    def __init__(self, conf: BFConfig, device=None):
        for name, _ in conf.logic_modules:
            check_logic_module(name)
        self.device = resolve_device(device)
        pin_fp32_matmul()
        self.conf = conf
        self.N = conf.filter_length
        self.B = conf.n_blocks
        self.rd = np.dtype(np.float32 if conf.realsize == 4 else np.float64)
        if not eligible(conf):
            raise NotImplementedError(
                "this config needs the host codec, not ported yet "
                "(ROADMAP queue 1 item 4c)")

        filter_inputs = [[src for src, _ in f.in_filters]
                         for f in conf.filters]
        self.spec = build_graph_spec(
            self.N, self.B, conf.n_channels[IN], conf.n_channels[OUT],
            filter_inputs, [f.crossfade for f in conf.filters], self.rd,
            powersave=conf.powersave and conf.analog_powersave < 1.0)
        check_supported(self.spec)

        # [E, B, N] complex -> the kernel's [E, B, 2, N] re/im planes
        self.bank = torch.as_tensor(
            np_c2p(build_bank(conf.coeffs, self.N, self.B, self.rd.type)),
            device=self.device)
        self.control = RuntimeControl(conf, self.spec, self.device)

        self.devices: List[list] = [[], []]
        for io in (IN, OUT):
            for dev in conf.iodevs[io]:
                cls = get_io_module(dev.device_name, conf.modules_path)
                inst = cls(dev.device_params, io, dev.sample_format,
                           conf.sampling_rate, dev.open_channels)
                if inst.sample_format is not None:
                    dev.sample_format = inst.sample_format
                if dev.sample_format is None:
                    raise EngineError(
                        f'device "{dev.device_name}" did not resolve AUTO '
                        'format')
                self.devices[io].append(inst)

        self.subdelay = (SubsampleDelay(conf, self.rd)
                         if conf.use_subdelay[IN] or conf.use_subdelay[OUT]
                         else None)
        # one shared random table for the dithered output channels
        # (dither_init, bfconf.c:3174-3238)
        dith = dithered_phys(conf)
        self.dither_table = (DitherTable(len(dith), conf.sampling_rate,
                                         conf.max_dither_table_size, self.N,
                                         dtype=self.rd.type)
                             if dith else None)

        # overflow meters, per virtual output channel; shared per physical
        self.overflow: List[Overflow] = []
        self._phys_overflow = []
        for p in range(conf.n_physical_channels[OUT]):
            fmt = conf.physical_format(OUT, p)
            self._phys_overflow.append(
                Overflow(max=1.0 if fmt.is_float else float(fmt.imax)))
        for ch in range(conf.n_channels[OUT]):
            self.overflow.append(self._phys_overflow[conf.virt2phys[OUT][ch]])

        self.state = init_state(self.spec, self.device)
        self.control_mutex = threading.RLock()
        self.blockcounter = 0
        self.realtime_index = 0.0    # the CLI's rti reads it
        self._rti_max = 0.0
        # full-processing ramp of the rti meter (procblocks,
        # bfrun.c:1436-1445, 1567-1571)
        self._procblocks = 0
        self.logic = []              # logic module instances
        self._peak_hooks = []        # bfevents.peak analogs
        self._last_peak_state = None
        self._stopped = False
        self._stage_t = np.zeros(4)   # read, device, write, total
        self._stage_blocks = 0
        # debug timeline ring (print_debug, bfrun.c:230-434): (wall time,
        # stage, event, block) from the main and writer threads (deque
        # append is thread-safe); 1024 periods of ~8 events, the
        # reference's DEBUG_MAX ring depth
        self._debug_ring = (collections.deque(maxlen=8192) if conf.debug
                            else None)
        self.dio = DeviceIO(self)
        self._gain_version = -1
        self._in_gain = self._out_gain = None
        self._in_framebytes = [
            d.sample_format.bytes * d.open_channels for d in conf.iodevs[IN]]

    def stop(self):
        self._stopped = True

    def update_bank_entry(self, coeff_index: int, H: np.ndarray):
        """Hot-swap one coefficient set's spectral partitions (the EQ
        render), out of place like the JAX package's functional update: a
        new bank tensor is rebound under the control mutex, so a block
        dispatched with the old one (its snapshot's) is unaffected, even
        when the EQ runs on a CLI socket thread."""
        H = torch.as_tensor(np.asarray(H).reshape(self.bank.shape[1:]),
                            dtype=self.bank.dtype, device=self.device)
        idx = torch.tensor([coeff_index], device=self.device)
        bank = self.bank.index_copy(0, idx, H[None])
        with self.control_mutex:
            self.bank = bank

    def _dbg(self, stage: str, event: str, block: int):
        """Append one event to the debug timeline ring (no-op unless
        ``debug: true;``)."""
        if self._debug_ring is not None:
            self._debug_ring.append(
                (time.perf_counter(), stage, event, block))

    # ----- logic modules ---------------------------------------------------
    def attach_logic(self):
        """Load the config's logic modules and wire their hooks
        (engine.py:488-572 without timed and frequency-domain hooks,
        which raise): the coeff_final hooks, the peak push, and each
        module's ``initialised``."""
        for name, params in self.conf.logic_modules:
            self.logic.append(load_logic_module(name, params, self))
        for m in self.logic:
            hooks = [h for h in ("input_timed", "output_timed",
                                 "input_freqd", "pre_convolve",
                                 "post_convolve", "output_freqd")
                     if getattr(m, h, None) is not None]
            if hooks:
                raise NotImplementedError(
                    f"logic module hooks {', '.join(hooks)} are not ported "
                    "yet (ROADMAP queue 1 item 4b)")
        self.control.coeff_final_mod_hooks = [
            m.coeff_final for m in self.logic
            if getattr(m, "coeff_final", None) is not None]
        # peak push (BF_FDEVENT_PEAK / bfevents.peak, bfrun.c:589-618)
        self._peak_hooks = [m.peak for m in self.logic
                            if getattr(m, "peak", None) is not None]
        self._last_peak_state = tuple(
            (o.n_overflows, o.largest, o.intlargest) for o in self.overflow)
        for m in self.logic:
            hook = getattr(m, "initialised", None)
            if hook is not None:
                hook()

    def _peak_push(self):
        """Push a peak event to logic modules when an overflow meter
        changed (check_overflows, bfrun.c:589-618), gated on
        overflow_warnings like the reference."""
        if not self._peak_hooks or not self.conf.overflow_warnings:
            return
        cur = tuple((o.n_overflows, o.largest, o.intlargest)
                    for o in self.overflow)
        if cur != self._last_peak_state:
            self._last_peak_state = cur
            for h in self._peak_hooks:
                h()

    def _block_start_hooks(self):
        for mod in self.logic:
            hook = getattr(mod, "block_start", None)
            if hook is not None:
                hook(self.blockcounter)

    # ----- setup / teardown ----------------------------------------------
    def setup(self):
        for io in (IN, OUT):
            for inst in self.devices[io]:
                inst.init(self.N)
        for io in (IN, OUT):
            for inst in self.devices[io]:
                inst.start()
        for io in (IN, OUT):
            for inst in self.devices[io]:
                inst.synch_start()

    def teardown(self):
        for io in (IN, OUT):
            for inst in self.devices[io]:
                inst.synch_stop()
                inst.stop()
                inst.close()

    def _mute_gains(self):
        ver = self.control.mute_version
        if ver != self._gain_version:
            self._in_gain = torch.tensor(
                [0.0 if m else 1.0 for m in self.control.mute[IN]],
                dtype=torch.float32, device=self.device)
            self._out_gain = torch.tensor(
                [0.0 if m else 1.0 for m in self.control.mute[OUT]],
                dtype=torch.float32, device=self.device)
            self._gain_version = ver
        return self._in_gain, self._out_gain

    def _snapshot_epoch(self):
        """One control epoch for a dispatch: (ctrl, gains, uniform,
        uniform_delay, xfade, bank), taken under the control mutex so that
        a concurrent CLI line is never seen half applied; the device-IO
        delays and subdelays are updated from the same epoch
        (bfrun.c:1574-1601)."""
        with self.control_mutex:
            ctrl = self.control.snapshot()
            gains = self._mute_gains()
            epoch = (ctrl, gains, self.control.snapshot_uniform,
                     self.control.snapshot_uniform_delay,
                     self.control.snapshot_xfade, self.bank)
            delays = [list(d) for d in self.control.delay]
            subdelays = [list(d) for d in self.control.subdelay]
        self.dio.update_delays(*delays)
        self.dio.update_subdelays(*subdelays)
        return epoch

    # ----- device-IO host side ---------------------------------------------
    def read_block_dio(self):
        """Read raw words per input device: ([N, ...] arrays, frames),
        frames < N at EOF (the block is zero padded)."""
        N = self.N
        frames = N
        words = []
        for di, dev in enumerate(self.conf.iodevs[IN]):
            fb = self._in_framebytes[di]
            raw = self.devices[IN][di].read(N * fb)
            got = len(raw) // fb
            if got < N:
                frames = min(frames, got)
            if len(raw) < N * fb:
                raw = raw + b"\0" * (N * fb - len(raw))
            if self.dio.in_wire[di] == "p24":
                # ship only the 3 significant bytes (see device_io.py)
                words.append(np.frombuffer(raw, dtype=np.uint8).reshape(
                    N, dev.open_channels, 4)[:, :, :3])
            elif self.dio.in_wire[di] == "raw3":
                words.append(np.frombuffer(raw, dtype=np.uint8).reshape(
                    N, dev.open_channels, 3))
            else:
                words.append(np.frombuffer(
                    raw, dtype=self.dio.in_wire_dtype[di]).reshape(
                    N, dev.open_channels))
        return words, frames

    def _account_output_meters(self, dev, m: np.ndarray):
        """Fold one device's [used, 4] meter rows into the per-channel
        Overflow stats and enforce safety_limit (real2raw.h:32-42) --
        before anything is written to the device."""
        fmt = dev.sample_format
        limit = self.conf.safety_limit
        for i in range(dev.used_channels):
            ovf = self._phys_overflow[dev.phys_base + i]
            ovf.n_overflows += int(m[i, 0])
            ovf.largest = max(ovf.largest, float(m[i, 1]))
            if not fmt.is_float:
                ovf.intlargest = max(ovf.intlargest, int(m[i, 2]))
            if limit != 0.0 and float(m[i, 3]) > limit * ovf.max:
                raise EngineError(
                    f"safety limit exceeded on output "
                    f"({20 * np.log10(float(m[i, 3]) / ovf.max):.2f} > "
                    f"{20 * np.log10(limit):.2f} dB)")

    def _write_outputs(self, outs, meters, nan_ok, frames):
        """Writer-thread half of a dispatch: fetch, NaN check, meters and
        safety abort, then the device writes (first ``frames`` frames)."""
        if not bool(nan_ok):
            raise EngineError("NaN or Inf values in the system! "
                              "Invalid input?",
                              exit_code=BF_EXIT_INVALID_INPUT)
        for di, dev in enumerate(self.conf.iodevs[OUT]):
            self._account_output_meters(dev, meters[di].cpu().numpy())
            raw = outs[di].cpu().numpy()
            if self.dio.out_wire[di] == "p24":
                raw = _expand_p24(raw)        # 3-byte wire -> 4-byte file
            if self.dio.out_wire[di] == "raw3":
                raw = raw.reshape(-1, dev.open_channels, 3)
            else:
                raw = raw.reshape(-1, dev.open_channels)
            self.devices[OUT][di].write(raw[:frames].tobytes())
        self._peak_push()

    # ----- the writer thread and run statistics -----------------------------
    def _start_writer(self):
        """The output stage on its own thread (the analog of the
        reference's output process, bfrun.c:846-964): it fetches, meters
        and writes block k while the main thread dispatches block k+1.
        Returns (queue, stats, thread); queue depth 2 bounds latency."""
        wq: "queue.Queue" = queue.Queue(maxsize=2)
        wstats = {"frames": 0, "blocks": 0, "err": None}

        def writer():
            while True:
                item = wq.get()
                if item is None:
                    return
                outs, meters, nan_ok, fk = item
                try:
                    wblk = wstats["blocks"]
                    self._dbg("output", "call write", wblk)
                    self._write_outputs(outs, meters, nan_ok, fk)
                    wstats["frames"] += fk
                    wstats["blocks"] += 1
                    self._dbg("output", f"ret {fk} frames", wblk)
                except Exception as e:
                    wstats["err"] = e
                    return

        wth = threading.Thread(target=writer, daemon=True)
        wth.start()
        return wq, wstats, wth

    @staticmethod
    def _stop_writer(wq, wth):
        try:
            wq.put(None, timeout=5.0)
        except queue.Full:
            pass
        wth.join(timeout=600.0)

    def _put(self, wq, wstats, item):
        while wstats["err"] is None:
            try:
                wq.put(item, timeout=1.0)
                return
            except queue.Full:
                continue

    def _stats(self, frames_out: int, elapsed: float) -> dict:
        periods = np.asarray(self._periods)
        return {
            "blocks": self.blockcounter,
            "frames": frames_out,
            "elapsed_s": elapsed,
            "xrt": (frames_out / self.conf.sampling_rate) / elapsed
            if elapsed > 0 else 0.0,
            "p50_block_ms": float(np.median(periods) * 1e3)
            if periods.size else 0.0,
            "p95_block_ms": float(np.percentile(periods, 95) * 1e3)
            if periods.size else 0.0,
            "rti_max": self._rti_max,
            "realtime_index": self.realtime_index,
            "overflows": [o.n_overflows for o in self.overflow],
            "peak_db": [o.peak_db() for o in self.overflow],
        }

    def _teardown_quietly(self):
        try:
            self.teardown()
        except Exception:
            pass

    # ----- per-block run ---------------------------------------------------
    def run(self, max_blocks: Optional[int] = None, setup: bool = True):
        """Process block by block until input EOF (or until the engine
        has run ``max_blocks`` blocks since its first). Returns run
        statistics. ``setup=False`` neither attaches the logic modules
        nor opens or closes the devices: the caller runs ``setup()``,
        one or more runs, then ``teardown()``."""
        if setup:
            self.attach_logic()
            self.setup()
        budget = self.N / self.conf.sampling_rate    # seconds per block
        t_run0 = time.perf_counter()
        # bounded: p50/p95 over the most recent ~131k blocks
        self._periods = collections.deque(maxlen=1 << 17)
        wq, wstats, wth = self._start_writer()
        try:
            try:
                self._run_blocks(max_blocks, wq, wstats, budget)
            finally:
                self._stop_writer(wq, wth)
            if wstats["err"] is not None:
                raise wstats["err"]
        except BaseException:
            # release the devices: a caller that catches the error and
            # builds a new Engine must not inherit still-open devices
            if setup:
                self._teardown_quietly()
            raise
        stats = self._stats(wstats["frames"], time.perf_counter() - t_run0)
        if self._debug_ring is not None:
            self._dump_debug_timeline()
        if setup:
            self.teardown()
        return stats

    def _input_silent_words(self, xw) -> bool:
        """Powersave silence on raw input words: exact zero only (the
        analog threshold would need a decode), as the JAX package's
        device-IO path decides it; it only gates the rti meter here."""
        if not self.conf.powersave:
            return False
        return all(not np.asarray(w).any() for w in xw)

    def _update_full_proc(self, silent: bool) -> bool:
        """Advance the full-processing ramp (procblocks,
        bfrun.c:1567-1571): rti counts only after B+1 live blocks; a
        silent block resets it (bfrun.c:1721-1722)."""
        self._procblocks = 0 if silent else min(self._procblocks + 1,
                                                self.B + 1)
        return self._procblocks > self.B

    def _run_blocks(self, max_blocks, wq, wstats, budget):
        N = self.N
        show = self.conf.benchmark or self.conf.debug
        eof = False
        while not self._stopped and not eof:
            if max_blocks is not None and self.blockcounter >= max_blocks:
                break
            if wstats["err"] is not None:
                break
            t0 = time.perf_counter()
            self._dbg("input", "call read", self.blockcounter)
            self._block_start_hooks()
            xw, frames = self.read_block_dio()
            self._dbg("input", f"ret {frames} frames", self.blockcounter)
            if frames < N:
                eof = True
            t1 = time.perf_counter()
            item = None
            if frames > 0:
                self._dbg("filter", "call dispatch", self.blockcounter)
                ctrl, gains, uni, udl, xf, bank = self._snapshot_epoch()
                # np.array: a writable copy of the (read-only) file words
                words = [torch.as_tensor(np.array(w), device=self.device)
                         for w in xw]
                self.state, outs, meters, nan_ok = self.dio.step(
                    self.state, ctrl, gains[0], gains[1], bank, words,
                    uniform=uni, udelay=udl, xfade=xf)
                item = (outs, meters, nan_ok, frames)
                self._dbg("filter", "ret", self.blockcounter)
                self.blockcounter += 1
            t2 = time.perf_counter()
            if item is not None:
                self._put(wq, wstats, item)
            t3 = time.perf_counter()
            period = t3 - t0
            self._periods.append(period)
            if self._update_full_proc(self._input_silent_words(xw)):
                self.realtime_index = period / budget
                self._rti_max = max(self._rti_max, self.realtime_index)
            self._stage_t += (t1 - t0, t2 - t1, t3 - t2, period)
            self._stage_blocks += 1
            if show and self._stage_blocks % 10 == 0:
                self._print_stage_table()

    def _print_stage_table(self):
        """The reference's benchmark table (bfrun.c:2035-2078), the JAX
        package's text: host ms a block averaged over the periods since
        the last print. With ``BRUTEFIR_TPU_STAGE_BREAKDOWN`` set, the
        device column is apportioned by per-op device times taken once,
        at the first print, at this engine's shapes
        (``stageprobe.device_stage_slopes``)."""
        t = self._stage_t / max(self._stage_blocks, 1) * 1e3
        if os.environ.get("BRUTEFIR_TPU_STAGE_BREAKDOWN"):
            from .stageprobe import STAGES, device_stage_slopes
            if not hasattr(self, "_stage_slopes"):
                self._stage_slopes = device_stage_slopes(
                    self.spec, self.bank, self.device)
                tot = sum(self._stage_slopes.values())
                sys.stderr.write(
                    "device stage calibration (ms/block): "
                    + " ".join(f"{k} {self._stage_slopes[k] * 1e3:.3f}"
                               for k in STAGES)
                    + f"  (sum {tot * 1e3:.3f})\n")
            sl = self._stage_slopes
            tot = sum(sl.values()) or 1.0
            parts = {k: t[1] * sl[k] / tot for k in STAGES}
            sys.stderr.write(
                f"decode {t[0]:7.3f} | "
                + " | ".join(f"{k} {parts[k]:7.3f}" for k in STAGES)
                + f" | encode {t[2]:7.3f} | total {t[3]:7.3f} | "
                f"rti {self.realtime_index:6.3f}  "
                "(ms; device split calibrated)\n")
        else:
            sys.stderr.write(
                f"decode/ms {t[0]:9.3f} | device/ms {t[1]:9.3f} | "
                f"encode/ms {t[2]:9.3f} | total/ms {t[3]:9.3f} | "
                f"rti {self.realtime_index:6.3f}\n")
        self._stage_t[:] = 0
        self._stage_blocks = 0

    def _dump_debug_timeline(self):
        """Full-ring timeline dump (print_debug, bfrun.c:230-434), the
        JAX package's text: one section per pipeline stage (input, filter,
        output), each listing every retained period's call/ret events in
        microseconds from the first retained event."""
        events = list(self._debug_ring)
        if not events:
            sys.stderr.write("debug timeline: no events recorded\n")
            return
        t0 = min(e[0] for e in events)
        sys.stderr.write(
            f"\ndebug timeline ({len(events)} events; timestamps in "
            "microseconds from first retained event):\n\n")
        for stage in ("input", "filter", "output"):
            sec = [e for e in events if e[1] == stage]
            if not sec:
                continue
            sys.stderr.write(f"{stage}_process:\n")
            last_blk = None
            for ts, _, ev, blk in sec:
                if blk != last_blk:
                    sys.stderr.write(f"  period {blk}:\n")
                    last_blk = blk
                sys.stderr.write(
                    f"    {int((ts - t0) * 1e6)}\t{ev}\n")
            sys.stderr.write("\n")

    # ----- offline run -----------------------------------------------------
    def run_offline(self, max_blocks: Optional[int] = None,
                    batch_blocks: int = BATCH_BLOCKS, setup: bool = True):
        """File-to-file throughput mode: batched device dispatch.

        Freezes controls across each batch of ``batch_blocks`` blocks and
        dispatches them back to back with no host synchronisation; a
        producer thread reads and uploads batch k+1 while batch k runs,
        and a writer thread fetches and writes results. Offline only:
        block latency becomes batch_blocks * N samples. Falls back to
        ``run()`` for logic modules (script lines pace per block) and for
        ``batch_blocks <= 1``. ``max_blocks`` and ``setup`` as in
        ``run()``."""
        if self.conf.logic_modules or batch_blocks <= 1:
            return self.run(max_blocks, setup=setup)
        if setup:
            self.setup()
        conf = self.conf
        N = self.N
        M = batch_blocks
        t_run0 = time.perf_counter()
        self._periods = collections.deque(maxlen=1 << 17)
        wq, wstats, wth = self._start_writer()

        # batch producer: reads, packs and uploads batch k+1 while the
        # main thread dispatches batch k
        pq: "queue.Queue" = queue.Queue(maxsize=2)
        pstate = {"stop": False, "err": None}

        def producer():
            try:
                # never read past max_blocks: over-read input would be
                # dropped, skipping samples for a later run on this engine
                left = (None if max_blocks is None
                        else max(0, max_blocks - self.blockcounter))
                while not pstate["stop"]:
                    take = M if left is None else min(M, left)
                    if take == 0:
                        return
                    stacks = [np.zeros((M, N) + self.dio.in_wire_shape[di],
                                       self.dio.in_wire_dtype[di])
                              for di in range(len(conf.iodevs[IN]))]
                    got = 0
                    frames = take * N
                    hit_eof = False
                    for b in range(take):
                        words, f = self.read_block_dio()
                        for di in range(len(stacks)):
                            stacks[di][b] = words[di]
                        got += 1
                        if f < N:
                            frames = b * N + f
                            hit_eof = True
                            break
                    if left is not None:
                        left -= got
                    item = ([torch.from_numpy(st).to(self.device)
                             for st in stacks], frames, got, hit_eof)
                    while not pstate["stop"]:
                        try:
                            pq.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if hit_eof:
                        return
            except Exception as e:
                pstate["err"] = e
                try:
                    pq.put_nowait(([], 0, 0, True))
                except queue.Full:
                    pass

        pth = threading.Thread(target=producer, daemon=True)
        pth.start()

        try:
            try:
                self._run_offline_batches(max_blocks, M, wq, wstats, pq,
                                          pstate, N / conf.sampling_rate)
            finally:
                # always stop both pipeline threads
                pstate["stop"] = True
                try:
                    while True:
                        pq.get_nowait()
                except queue.Empty:
                    pass
                pth.join(timeout=10.0)
                self._stop_writer(wq, wth)
            if wstats["err"] is not None:
                raise wstats["err"]
        except BaseException:
            if setup:
                self._teardown_quietly()
            raise
        stats = self._stats(wstats["frames"], time.perf_counter() - t_run0)
        if setup:
            self.teardown()
        return stats

    def _step_one(self, wq, wstats, epoch, words, frames: int,
                  xfade: bool):
        """Dispatch one block of a batch under ``epoch`` (a
        ``_snapshot_epoch``) and queue its ``frames`` frames."""
        ctrl, gains, uni, udl, _, bank = epoch
        self.state, outs, meters, nan_ok = self.dio.step(
            self.state, ctrl, gains[0], gains[1], bank, words,
            uniform=uni, udelay=udl, xfade=xfade)
        self.blockcounter += 1
        self._put(wq, wstats, (outs, meters, nan_ok, frames))

    def _run_offline_batches(self, max_blocks, M, wq, wstats, pq, pstate,
                             budget):
        N = self.N
        eof = False
        while not self._stopped and not eof and wstats["err"] is None:
            rem = (None if max_blocks is None
                   else max_blocks - self.blockcounter)
            if rem is not None and rem <= 0:
                break
            t0 = time.perf_counter()
            dstacks, frames, got_blocks, eof = pq.get()
            if pstate["err"] is not None:
                raise pstate["err"]
            if rem is not None and rem < got_blocks:
                got_blocks = rem
                frames = min(frames, rem * N)
            if eof or got_blocks < M or frames < M * N:
                # EOF or a max_blocks tail inside the batch: finish the
                # blocks read one at a time so no samples are dropped, a
                # snapshot per block (a pending swap crossfades only its
                # first block, as in run())
                left = frames if frames < M * N else got_blocks * N
                for b in range(got_blocks):
                    f = min(N, left - b * N)
                    if f <= 0:
                        break
                    epoch = self._snapshot_epoch()
                    self._step_one(wq, wstats, epoch,
                                   [st[b] for st in dstacks], f, epoch[4])
                break
            epoch = self._snapshot_epoch()
            start = 0
            while epoch[4] and start < M:
                # a coefficient swap landed before this batch: each
                # crossfade applies to ONE block per snapshot (the
                # reference crossfades where prevcoeff != coeff, and the
                # next snapshot clears it, bfrun.c:1695-1777). Dispatch
                # crossfade blocks one at a time until a snapshot comes
                # back without one, then run the rest under that snapshot
                self._step_one(wq, wstats, epoch,
                               [st[start] for st in dstacks], N, True)
                start += 1
                if start == M:
                    # the batch ended on a crossfade block: no further
                    # snapshot here, since snapshot() advances prev_coeff
                    # and a swap pending now would lose its crossfade;
                    # the next batch's snapshot picks it up
                    break
                epoch = self._snapshot_epoch()
            if start == 0:
                ctrl, gains, uni, udl, _, bank = epoch
                self.state, outs, meters, nan_ok = self.dio.multi_step(
                    self.state, ctrl, gains[0], gains[1], bank,
                    dstacks, uniform=uni, udelay=udl)
                self.blockcounter += M
                self._put(wq, wstats, (outs, meters, nan_ok, M * N))
            else:
                # the rest of a split batch, block by block under the
                # same snapshot
                for b in range(start, M):
                    self._step_one(wq, wstats, epoch,
                                   [st[b] for st in dstacks], N, False)
            per = (time.perf_counter() - t0) / M
            self._periods.append(per)
            # full batches only (the offline analog of full_proc rti
            # gating, bfrun.c:1436-1445)
            self.realtime_index = per / budget
            self._rti_max = max(self._rti_max, self.realtime_index)
