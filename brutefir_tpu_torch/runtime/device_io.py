"""Device-side I/O path: the whole block program including sample codecs.

Torch twin of :mod:`brutefir_tpu.runtime.device_io`. One step takes the
raw input words of every input device and returns the raw output words
of every output device plus per-channel meters:

    input_half:  p24/raw3 sign-extend -> decode -> mute gain
    step_impl:   rfft -> mix -> ring -> fused MAC + mix -> irfft, the
                 fused time-domain crossfade, or the stage loop (per
                 stage: mix, cascade input, ring, MAC or dual MAC)
    output_half: NaN gate -> gains -> per-device output mix ->
                 no-dither quantize -> p24/raw3 pack -> meters

Host work per block is file reads and writes; transfers are the wire
format's width. Integer delay windows, subsample delays and device
dither are not in this slice of the port: a config that needs them
raises NotImplementedError (ROADMAP queue 1 item 5).

``multi_step`` runs m blocks as a Python loop (the ``lax.scan`` analog)
with controls frozen across the batch; nothing in the loop synchronises
with the host. At big single-stage shapes it steps G blocks at a time
(``graph.compile.group_size`` / ``group_step_impl``), reading the ring
and the bank once per group.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config.model import BFConfig, IN, OUT
from ..graph.compile import group_size, group_step_impl, step_impl
from ..ops.device_codec import (device_format_word, decode_words,
                                encode_words, torch_dtype)


def _wire3(fmt) -> bool:
    """3-byte packed S24: the file bytes are the wire format verbatim
    (sign-extended on device)."""
    return (not fmt.is_float and fmt.bytes == 3 and fmt.sbytes == 3
            and fmt.little_endian and np.little_endian)


def _p24(fmt) -> bool:
    """S24 in a 4-byte container: only the 3 significant bytes travel
    (25% less host->device traffic), sign-extended on device."""
    return (not fmt.is_float and fmt.bytes == 4 and fmt.sbytes == 3
            and fmt.little_endian and np.little_endian)


def eligible(conf: BFConfig) -> bool:
    for io in (IN, OUT):
        for dev in conf.iodevs[io]:
            if (device_format_word(dev.sample_format) is None
                    and not _wire3(dev.sample_format)):
                return False
    return True


def _check_slice(conf: BFConfig) -> None:
    """Raise for device-IO features outside this slice of the port."""
    for io in (IN, OUT):
        for ch in range(conf.n_channels[io]):
            if conf.delay[io][ch] > 0 or conf.maxdelay[io][ch] > 0:
                raise NotImplementedError(
                    "channel delays on the device are not ported yet "
                    "(ROADMAP queue 1 item 5)")
        if conf.use_subdelay[io]:
            raise NotImplementedError(
                "subsample delays are not ported yet (ROADMAP queue 1 "
                "item 5)")
    for dev in conf.iodevs[OUT]:
        fmt = dev.sample_format
        if dev.apply_dither and not fmt.is_float and fmt.sbytes < 4:
            raise NotImplementedError(
                "dither on the device is not ported yet (ROADMAP queue 1 "
                "item 5)")


def sext24(w: torch.Tensor) -> torch.Tensor:
    """[.., 3] little-endian bytes -> sign-extended int32 words."""
    w = w.to(torch.int32)
    w = w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16)
    return w - ((w & 0x800000) << 1)


def pack24(words: torch.Tensor) -> torch.Tensor:
    """[N, open] int32 words -> [N, open, 3] little-endian wire bytes."""
    w32 = words.to(torch.int32)
    return torch.stack([(w32 >> s) & 0xFF for s in (0, 8, 16)],
                       dim=-1).to(torch.uint8)


def aggregate_meters(meters: list) -> torch.Tensor:
    """Per-block meter rows [ch, 4] of a batch -> one row set: clip
    counts sum, peaks max."""
    st = torch.stack(meters)                        # [m, ch, 4]
    return torch.cat([torch.sum(st[:, :, :1], dim=0),
                      torch.amax(st[:, :, 1:], dim=0)], dim=1)


class DeviceIO:
    def __init__(self, engine):
        conf = engine.conf
        _check_slice(conf)
        self.conf = conf
        self.spec = engine.spec
        self.device = engine.device
        dev_ = self.device

        def on_dev(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev_)

        # per input device: wire format, host-side wire dtype and per-frame
        # shape (what read_block_dio hands over), decode wiring
        self.in_wire = []       # "word" | "p24" | "raw3"
        self.in_wire_dtype = []
        self.in_wire_shape = []
        self._in_devs = []
        for dev in conf.iodevs[IN]:
            fmt = dev.sample_format
            if _wire3(fmt) or _p24(fmt):
                self.in_wire.append("raw3" if _wire3(fmt) else "p24")
                self.in_wire_dtype.append(np.dtype(np.uint8))
                self.in_wire_shape.append((dev.open_channels, 3))
            else:
                self.in_wire.append("word")
                self.in_wire_dtype.append(device_format_word(fmt))
                self.in_wire_shape.append((dev.open_channels,))
            self._in_devs.append((on_dev(dev.channel_selection),
                                  on_dev(dev.virt2phys_local)))

        # per output device: wire format, encode word type, and the
        # virtual -> physical mix: a row gather when every physical row is
        # exactly one virtual channel ("perm"), else a 0/1 matrix
        self.out_wire = []
        self.out_words = []
        self._out_devs = []
        for dev in conf.iodevs[OUT]:
            fmt = dev.sample_format
            if _wire3(fmt):
                self.out_wire.append("raw3")
                self.out_words.append(torch.int32)
            else:
                self.out_wire.append("p24" if _p24(fmt) else "word")
                self.out_words.append(torch_dtype(device_format_word(fmt)))
            rows = [np.asarray(conf.phys2virt[OUT][dev.phys_base + i],
                               np.int64)
                    for i in range(dev.used_channels)]
            if all(len(v) == 1 for v in rows):
                mix = ("perm", on_dev([v[0] for v in rows]))
            else:
                m = np.zeros((dev.used_channels, conf.n_channels[OUT]),
                             np.float32)
                for i, virts in enumerate(rows):
                    m[i, virts] = 1.0
                mix = ("matrix", torch.as_tensor(m, device=dev_))
            self._out_devs.append((on_dev(dev.channel_selection), mix,
                                   dev.open_channels, fmt))

    def input_half(self, in_words, in_gain):
        """Per-device words -> [C_in, N] float: sign-extend packed S24,
        decode, mute gain."""
        xs = []
        for di, (sel, vmap) in enumerate(self._in_devs):
            w = in_words[di]
            if self.in_wire[di] != "word":
                w = sext24(w)
            xs.append(decode_words(w, sel, vmap, torch.float32))
        return torch.cat(xs, dim=0) * in_gain[:, None]

    def output_half(self, y, out_gain):
        """y [C_out, N] -> (per-device wire words, per-device meters
        [used, 4], nan_ok scalar bool tensor)."""
        # NaN gate on the first sample of each channel (bfrun.c:1900-1911)
        nan_ok = (torch.all(torch.isfinite(y[:, 0])) if y.shape[0]
                  else torch.ones((), dtype=torch.bool, device=y.device))
        y = y * out_gain[:, None]
        outs, meters = [], []
        for di, (sel, (kind, mix), open_ch, fmt) in enumerate(self._out_devs):
            phys = y[mix] if kind == "perm" else torch.matmul(mix, y)
            peak = torch.amax(torch.abs(phys), dim=1)
            words, m = encode_words(phys, fmt, sel, open_ch,
                                    self.out_words[di])
            if self.out_wire[di] != "word":
                words = pack24(words)
            outs.append(words)
            meters.append(torch.cat([m, peak[:, None]], dim=1))
        return outs, meters, nan_ok

    def step(self, state, ctrl, in_gain, out_gain, bank, in_words,
             uniform=False, udelay=False, xfade=False):
        """One block: per-device words [N, ...] -> (state', outs, meters,
        nan_ok). ``xfade``: the snapshot carries a crossfade on this block
        (``step_impl``'s ``xfade_now``)."""
        x = self.input_half(in_words, in_gain)
        state, y = step_impl(self.spec, state, ctrl, bank, x,
                             uniform=uniform, uniform_delay=udelay,
                             xfade_now=xfade)
        outs, meters, nan_ok = self.output_half(y, out_gain)
        return state, outs, meters, nan_ok

    def multi_step(self, state, ctrl, in_gain, out_gain, bank, in_words,
                   uniform=False, udelay=False):
        """m blocks with frozen controls and no crossfade (the engine
        dispatches crossfade blocks one at a time, as the JAX package
        groups only then, device_io.py:587-613): per-device stacked words
        [m, N, ...] -> (state', per-device stacked outs [m, N, ...],
        per-device aggregated meters, nan_ok over all blocks)."""
        m = in_words[0].shape[0]
        outs_b, meters_b, nans = [], [], []
        G = group_size(self.spec, m)
        for b0 in range(0, m, G):
            if G >= 2:
                # grouped dispatch (device_io.py:587-613, 727-782): the
                # IO halves per block, in order; the graph step G blocks
                # at a time
                xs = [self.input_half([w[b] for w in in_words], in_gain)
                      for b in range(b0, b0 + G)]
                state, ys = group_step_impl(self.spec, state, ctrl, bank,
                                            xs, uniform_delay=udelay)
                blocks = [self.output_half(y, out_gain) for y in ys]
            else:
                state, *one = self.step(
                    state, ctrl, in_gain, out_gain, bank,
                    [w[b0] for w in in_words], uniform=uniform,
                    udelay=udelay)
                blocks = [one]
            for outs, meters, nan_ok in blocks:
                outs_b.append(outs)
                meters_b.append(meters)
                nans.append(nan_ok)
        outs = [torch.stack(per_dev) for per_dev in zip(*outs_b)]
        meters = [aggregate_meters(list(per_dev))
                  for per_dev in zip(*meters_b)]
        return state, outs, meters, torch.all(torch.stack(nans))
