"""The engine: host pipeline around the per-block device step.

Torch twin of the offline slice of :mod:`brutefir_tpu.runtime.engine`:
``run_offline`` reads raw words on a producer thread and uploads each
batch, the main thread dispatches batches of ``BATCH_BLOCKS`` blocks
through the device-IO program (controls frozen per batch), and a writer
thread fetches, meters and writes the results. The fixed-latency
contract holds: output frame m is the convolution of input frames <= m,
and file-to-file output length equals input length (the EOF tail runs
block by block).

Graphs of any number of stages run, filter cascades included. Not in
this slice (each raises NotImplementedError naming its ROADMAP item): the
per-block realtime ``run()`` with the host codec, logic modules,
crossfade, channel delays, subdelay, dither, float64.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import List

import numpy as np
import torch

from .. import resolve_device
from ..config.coeffs import build_bank
from ..config.model import BFConfig, IN, OUT
from ..core.codecs import Overflow
from ..errors import BFError, BF_EXIT_INVALID_INPUT
from ..graph.compile import check_supported, init_state
from ..graph.spec import build_graph_spec
from ..io import get_io_module
from ..ops.partconv import np_c2p
from .control import RuntimeControl
from .device_io import DeviceIO, eligible

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
        self.device = resolve_device(device)
        pin_fp32_matmul()
        self.conf = conf
        self.N = conf.filter_length
        self.B = conf.n_blocks
        self.rd = np.dtype(np.float32 if conf.realsize == 4 else np.float64)
        if conf.logic_modules:
            raise NotImplementedError(
                "logic modules need the per-block run(), not ported yet "
                "(ROADMAP queue 1 item 4)")
        if not eligible(conf):
            raise NotImplementedError(
                "this config needs the host codec, not ported yet "
                "(ROADMAP queue 1 item 4)")

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
        self._rti_max = 0.0
        self._stopped = False
        self.dio = DeviceIO(self)
        self._gain_version = -1
        self._in_gain = self._out_gain = None
        self._in_framebytes = [
            d.sample_format.bytes * d.open_channels for d in conf.iodevs[IN]]

    def stop(self):
        self._stopped = True

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
        uniform_delay), taken under the control mutex."""
        with self.control_mutex:
            ctrl = self.control.snapshot()
            gains = self._mute_gains()
            return (ctrl, gains, self.control.snapshot_uniform,
                    self.control.snapshot_uniform_delay)

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

    # ----- offline run -----------------------------------------------------
    def run_offline(self):
        """File-to-file throughput mode: batched device dispatch.

        Freezes controls across each batch of ``BATCH_BLOCKS`` blocks and
        dispatches them back to back with no host synchronisation; a
        producer thread reads and uploads batch k+1 while batch k runs,
        and a writer thread fetches and writes results. Offline only:
        block latency becomes BATCH_BLOCKS * N samples."""
        self.setup()
        conf = self.conf
        N = self.N
        M = BATCH_BLOCKS
        t_run0 = time.perf_counter()
        self._periods = collections.deque(maxlen=1 << 17)

        wq: "queue.Queue" = queue.Queue(maxsize=2)
        wstats = {"frames": 0, "err": None}

        def writer():
            while True:
                item = wq.get()
                if item is None:
                    return
                outs, meters, nan_ok, fk = item
                try:
                    self._write_outputs(outs, meters, nan_ok, fk)
                    wstats["frames"] += fk
                except Exception as e:
                    wstats["err"] = e
                    return

        wth = threading.Thread(target=writer, daemon=True)
        wth.start()

        # batch producer: reads, packs and uploads batch k+1 while the
        # main thread dispatches batch k
        pq: "queue.Queue" = queue.Queue(maxsize=2)
        pstate = {"stop": False, "err": None}

        def producer():
            try:
                while not pstate["stop"]:
                    stacks = [np.zeros((M, N) + self.dio.in_wire_shape[di],
                                       self.dio.in_wire_dtype[di])
                              for di in range(len(conf.iodevs[IN]))]
                    got = 0
                    frames = M * N
                    hit_eof = False
                    for b in range(M):
                        words, f = self.read_block_dio()
                        for di in range(len(stacks)):
                            stacks[di][b] = words[di]
                        got += 1
                        if f < N:
                            frames = b * N + f
                            hit_eof = True
                            break
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
                self._run_offline_batches(M, N, wq, wstats, pq, pstate,
                                          N / conf.sampling_rate)
            finally:
                # always stop both pipeline threads
                pstate["stop"] = True
                try:
                    while True:
                        pq.get_nowait()
                except queue.Empty:
                    pass
                pth.join(timeout=10.0)
                try:
                    wq.put(None, timeout=5.0)
                except queue.Full:
                    pass
                wth.join(timeout=600.0)
        except BaseException:
            try:
                self.teardown()
            except Exception:
                pass
            raise

        if wstats["err"] is not None:
            try:
                self.teardown()
            except Exception:
                pass
            raise wstats["err"]
        frames_out = wstats["frames"]
        elapsed = time.perf_counter() - t_run0
        periods = np.asarray(self._periods)
        stats = {
            "blocks": self.blockcounter,
            "frames": frames_out,
            "elapsed_s": elapsed,
            "xrt": (frames_out / conf.sampling_rate) / elapsed
            if elapsed > 0 else 0.0,
            "p50_block_ms": float(np.median(periods) * 1e3)
            if periods.size else 0.0,
            "p95_block_ms": float(np.percentile(periods, 95) * 1e3)
            if periods.size else 0.0,
            "rti_max": self._rti_max,
            "overflows": [o.n_overflows for o in self.overflow],
            "peak_db": [o.peak_db() for o in self.overflow],
        }
        self.teardown()
        return stats

    def _put(self, wq, wstats, item):
        while wstats["err"] is None:
            try:
                wq.put(item, timeout=1.0)
                return
            except queue.Full:
                continue

    def _run_offline_batches(self, M, N, wq, wstats, pq, pstate, budget):
        eof = False
        while not self._stopped and not eof and wstats["err"] is None:
            t0 = time.perf_counter()
            dstacks, frames, got_blocks, eof = pq.get()
            if pstate["err"] is not None:
                raise pstate["err"]
            if eof:
                # EOF inside the batch: finish the already-read blocks
                # one at a time so no samples are dropped, with a
                # control snapshot per block
                for b in range(got_blocks):
                    f = min(N, frames - b * N)
                    if f <= 0:
                        break
                    ctrl, gains, uni, udl = self._snapshot_epoch()
                    self.state, outs1, meters1, nan1 = self.dio.step(
                        self.state, ctrl, gains[0], gains[1], self.bank,
                        [st[b] for st in dstacks], uniform=uni, udelay=udl)
                    self.blockcounter += 1
                    self._put(wq, wstats, (outs1, meters1, nan1, f))
                break
            ctrl, gains, uni, udl = self._snapshot_epoch()
            self.state, outs, meters, nan_ok = self.dio.multi_step(
                self.state, ctrl, gains[0], gains[1], self.bank, dstacks,
                uniform=uni, udelay=udl)
            self.blockcounter += M
            self._put(wq, wstats, (outs, meters, nan_ok, M * N))
            per = (time.perf_counter() - t0) / M
            self._periods.append(per)
            # full batches only (the offline analog of full_proc rti
            # gating, bfrun.c:1436-1445)
            self._rti_max = max(self._rti_max, per / budget)
