"""Device-side I/O path: the whole block program including sample codecs.

Torch twin of :mod:`brutefir_tpu.runtime.device_io`. One step takes the
raw input words of every input device and returns the raw output words
of every output device plus per-channel meters:

    input_half:  p24/raw3 sign-extend -> decode -> mute gain ->
                 input delay -> input subdelay
    step_impl:   rfft -> mix -> ring -> fused MAC + mix -> irfft, the
                 fused time-domain crossfade, or the stage loop (per
                 stage: mix, cascade input, ring, MAC or dual MAC)
    output_half: NaN gate -> output subdelay -> output delay -> gains ->
                 per-device output mix -> dithered quantize
                 (ops/device_dither.py) or encode -> p24/raw3 pack ->
                 meters

Host work per block is file reads and writes; transfers are the wire
format's width. The IO halves carry state from block to block in
``dstate`` (the JAX package's keys): the dither pointers, last bytes and
error feedback (``ptr``, ``last``, ``sf``), the integer delay windows
(``dlw_in``, ``dlw_out``) and the subdelay rests (``sdr_in``,
``sdr_out``). They are plain torch, as the JAX package computes them in
``jnp`` outside its Pallas kernels, in the graph's real type (float64
under ``float_bits: 64``: decode, the delay windows, the subdelay FFTs,
the dither's error feedback and the quantizer). Runtime delay and
subdelay changes reach them through ``update_delays`` and
``update_subdelays``, which the engine calls with each control snapshot.

``step_eager`` runs one block op by op; ``multi_step_eager`` runs m
blocks as a Python loop (the ``lax.scan`` analog) with controls frozen
across the batch, nothing in the loop synchronising with the host, and
at big single-stage shapes steps G blocks at a time
(``graph.compile.group_size`` / ``group_step_impl``), reading the ring
and the bank once per group. ``step`` and ``multi_step`` run them as the
programs of ``runtime/program.py``: one per key, the JAX package's keys
(``(uniform, udelay, xfade)`` and ``(m, uniform, udelay)``), eager at a
key's first call and a replayed CUDA graph after, over static copies of
the state, ``dstate``, the controls, the gains and the bank. The delay
vectors and the subdelay rows are refreshed in place by
``update_delays`` / ``update_subdelays``, so every program reads them at
one address.

Under the engine's mesh (``parallel/mesh.py``) the IO halves run on the
mesh's first device and the graph step over the mesh: ``step_impl`` and
``group_step_impl`` with ``mesh=`` (the grouped dispatch through
``mac_group_shard``, the mix outside), as the JAX package's program
pins its IO state replicated (device_io.py:437-444). The programs
capture such a step as they capture an unsharded one, the cells' streams
taken into the capture (``runtime/program.py``), the twin of the JAX
package's ``_program`` with in and out shardings (device_io.py:437-466).

S24 in a 4-byte container crosses the wire as its 3 significant bytes
unless ``BRUTEFIR_TPU_WIRE_PACK24=0`` (read when a DeviceIO is made, as
the JAX package reads it, device_io.py:80-92): exact for in-spec words,
while a word whose padding byte is not the sign extension of bit 23
decodes as its 24-bit value; with the switch off the whole int32 word
travels and decodes as the reference reads it (raw2real.h:143-153,
docs/PARITY.md).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..config.model import BFConfig, BF_UNDEFINED_SUBDELAY, IN, OUT
from ..graph.compile import (group_size, group_step_impl, real_dtype,
                             step_impl)
from ..ops.device_codec import (device_format_word, decode_words,
                                encode_words, scatter_words, torch_dtype)
from ..ops.device_dither import dither_quantize, dither_window
from .program import Program, Statics, capturable
from .tracing import RECORDER as REC


def _wire3(fmt) -> bool:
    """3-byte packed S24: the file bytes are the wire format verbatim
    (sign-extended on device)."""
    return (not fmt.is_float and fmt.bytes == 3 and fmt.sbytes == 3
            and fmt.little_endian and np.little_endian)


def _p24(fmt, pack24: bool = True) -> bool:
    """S24 in a 4-byte container: only the 3 significant bytes travel
    (25% less host->device traffic), sign-extended on device; never with
    ``pack24`` False (``BRUTEFIR_TPU_WIRE_PACK24=0``)."""
    return (pack24 and not fmt.is_float and fmt.bytes == 4
            and fmt.sbytes == 3 and fmt.little_endian and np.little_endian)


def eligible(conf: BFConfig) -> bool:
    for io in (IN, OUT):
        for dev in conf.iodevs[io]:
            if (device_format_word(dev.sample_format) is None
                    and not _wire3(dev.sample_format)):
                return False
    return True


def dithered_phys(conf: BFConfig) -> list:
    """The dithered physical output channels, sorted: int formats with
    sbytes < 4 on ``dither: true`` devices (bfconf.c:3174-3238). Channel
    j of this list reads the shared table from j * spacing + 1."""
    phys = []
    for dev in conf.iodevs[OUT]:
        fmt = dev.sample_format
        if dev.apply_dither and not fmt.is_float and fmt.sbytes < 4:
            phys.extend(dev.phys_base + i for i in range(dev.used_channels))
    return sorted(phys)


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


def apply_delay(x: torch.Tensor, win: torch.Tensor, dvec: torch.Tensor,
                W: int):
    """Integer delay lines: out[c, n] = (win | x)[c, W + n - dvec[c]];
    returns (out, the new window of the last W samples)."""
    joined = torch.cat([win, x], dim=1)
    idx = (W + torch.arange(x.shape[1], device=x.device)[None, :]
           - dvec[:, None])
    return torch.gather(joined, 1, idx), joined[:, -W:]


def apply_subdelay(x: torch.Tensor, rest: torch.Tensor, hrows: torch.Tensor,
                   byp: torch.Tensor, B: int):
    """The subdelay FIRs as overlap-save in chunks of B: within a block
    the chunk's rest is the chunk before it, so every chunk goes through
    one batched rfft ([C, N/B, 2B]). ``hrows`` [C, B+1] are the channels'
    bank rows; ``byp`` channels pass x through. Returns (out, the new
    rest: the last B samples)."""
    C, N = x.shape
    n = N // B
    frames = torch.cat([rest, x], dim=1)                      # [C, N+B]
    lo = frames[:, :N].reshape(C, n, B)
    hi = frames[:, B:].reshape(C, n, B)
    w = torch.cat([lo, hi], dim=2)                            # [C, n, 2B]
    Y = torch.fft.rfft(w, dim=2) * hrows[:, None, :]
    y = torch.fft.irfft(Y, n=2 * B, dim=2)[:, :, :B].reshape(C, N)
    return torch.where(byp[:, None], x, y), frames[:, N:]


def _refresh(d: dict, key: str, value: torch.Tensor) -> None:
    """``d[key] = value``, written into the tensor already there: the
    step programs read it at one address."""
    if key in d:
        d[key].copy_(value)
    else:
        d[key] = value


def aggregate_meters(meters: list) -> torch.Tensor:
    """Per-block meter rows [ch, 4] of a batch -> one row set: clip
    counts sum, peaks max."""
    st = torch.stack(meters)                        # [m, ch, 4]
    return torch.cat([torch.sum(st[:, :, :1], dim=0),
                      torch.amax(st[:, :, 1:], dim=0)], dim=1)


class DeviceIO:
    def __init__(self, engine):
        conf = engine.conf
        self.conf = conf
        self.spec = engine.spec
        self.device = engine.device
        self.mesh = engine.mesh
        self.rd = rd = real_dtype(self.spec)
        dev_ = self.device
        # the wire compaction's kill switch (device_io.py:80-92)
        pack24 = os.environ.get("BRUTEFIR_TPU_WIRE_PACK24", "1") != "0"

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
            if _wire3(fmt) or _p24(fmt, pack24):
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
                self.out_wire.append("p24" if _p24(fmt, pack24)
                                     else "word")
                self.out_words.append(torch_dtype(device_format_word(fmt)))
            rows = [np.asarray(conf.phys2virt[OUT][dev.phys_base + i],
                               np.int64)
                    for i in range(dev.used_channels)]
            if all(len(v) == 1 for v in rows):
                mix = ("perm", on_dev([v[0] for v in rows]))
            else:
                m = np.zeros((dev.used_channels, conf.n_channels[OUT]),
                             engine.rd)
                for i, virts in enumerate(rows):
                    m[i, virts] = 1.0
                mix = ("matrix", torch.as_tensor(m, device=dev_))
            self._out_devs.append((on_dev(dev.channel_selection), mix,
                                   dev.open_channels, fmt))
        self.dstate = {}
        # the step programs by key, and the static tensors they share
        self._programs = {}
        self._statics = None

        # integer delay lines: per virtual channel a window of the last W
        # pre-delay samples, out[n] = window[W + n - delay]. The capacity
        # is maxdelay where the delay can change at runtime, else the
        # fixed delay; ``cur`` clamps the initial delay to it
        # (delay.c:351-362)
        self._dly = [None, None]
        for io, key in ((IN, "dlw_in"), (OUT, "dlw_out")):
            C = conf.n_channels[io]
            caps = [md if md >= 0 else d0 for md, d0 in
                    zip(conf.maxdelay[io], conf.delay[io])]
            W = max(caps, default=0)
            if W > 0:
                cur = [min(conf.delay[io][ch], caps[ch]) for ch in range(C)]
                self._dly[io] = {"W": W, "cur": cur,
                                 "max": list(conf.maxdelay[io]),
                                 "arr": on_dev(cur)}
                self.dstate[key] = torch.zeros((C, W), dtype=rd,
                                               device=dev_)

        # subsample delays (runtime/subdelay.py's bank, on the device): on
        # a side that uses them, channels without a subdelay run the
        # centred dirac row, the same sdf_length latency as the reference's
        # compensating integer delay (bfrun.c:1512-1516)
        self._sd = [None, None]
        if engine.subdelay is not None:
            sdh = engine.subdelay
            for io, key in ((IN, "sdr_in"), (OUT, "sdr_out")):
                if not conf.use_subdelay[io]:
                    continue
                C = conf.n_channels[io]
                defined = [conf.subdelay[io][ch] != BF_UNDEFINED_SUBDELAY
                           for ch in range(C)]
                self._sd[io] = {
                    "B": sdh.blocklen, "steps": sdh.steps,
                    "H": torch.as_tensor(sdh.H, device=dev_),
                    "defined": defined,
                    "cur": [conf.subdelay[io][ch] if defined[ch] else 0
                            for ch in range(C)],
                }
                self._sd_refresh(io)
                self.dstate[key] = torch.zeros((C, sdh.blocklen),
                                               dtype=rd, device=dev_)

        # dither: one shared Tausworthe table (the engine's), channel j of
        # dithered_phys reading from j * spacing + 1; per output device the
        # rows of its used channels in that order
        self._dither = None
        self._dith_rows = [None] * len(self._out_devs)
        dith = dithered_phys(conf)
        if dith:
            table = engine.dither_table
            order = {p: j for j, p in enumerate(dith)}
            for di, dev in enumerate(conf.iodevs[OUT]):
                phys = [dev.phys_base + i for i in range(dev.used_channels)]
                if phys and phys[0] in order:    # a dithered device
                    self._dith_rows[di] = on_dev([order[p] for p in phys])
            self._dither = (torch.as_tensor(table.tab, device=dev_),
                            torch.as_tensor(table.randmap, device=dev_),
                            table.size)
            ptr0 = np.asarray([j * table.spacing + 1
                               for j in range(len(dith))], np.int32)
            self.dstate.update(
                ptr=torch.as_tensor(ptr0, device=dev_),
                last=torch.as_tensor(table.tab[ptr0 - 1].astype(np.int32),
                                     device=dev_),
                sf=torch.zeros((len(dith), 2), dtype=rd, device=dev_))

    # ----- runtime delay and subdelay changes --------------------------------
    def _sd_refresh(self, io):
        """The bank row and bypass flag of each channel from ``cur``:
        undefined channels take the centred dirac row; out-of-range
        values bypass the filter (delay_subsample_update, delay.c:424)."""
        d = self._sd[io]
        steps = d["steps"]
        rows, byp = [], []
        for ch, v in enumerate(d["cur"]):
            if d["defined"][ch] and -steps < v < steps:
                rows.append(v + steps - 1)
                byp.append(False)
            else:
                rows.append(steps - 1)               # centred dirac row
                byp.append(d["defined"][ch])
        _refresh(d, "hrows",
                 d["H"][torch.as_tensor(rows, device=self.device)])
        _refresh(d, "byp", torch.as_tensor(byp, device=self.device))

    def update_subdelays(self, in_vals, out_vals):
        for io, vals in ((IN, in_vals), (OUT, out_vals)):
            d = self._sd[io]
            if d is not None and list(vals) != d["cur"]:
                d["cur"] = list(vals)
                self._sd_refresh(io)

    def update_delays(self, in_delays, out_delays):
        """Runtime delay changes with the reference's change_delay
        semantics (delay.c:283-317): channels beyond their maxdelay or
        fixed (maxdelay < 0) are silently refused; an increase to ``new``
        zeroes the channel's last ``new`` window samples, so the next
        ``new`` output samples are silence; a decrease keeps the true last
        samples (the JAX package's rule, docs/PARITY.md)."""
        for io, vals, key in ((IN, in_delays, "dlw_in"),
                              (OUT, out_delays, "dlw_out")):
            d = self._dly[io]
            if d is None:
                continue
            changed = False
            for ch, new in enumerate(vals):
                old, md = d["cur"][ch], d["max"][ch]
                if new == old or md < 0 or new > md:
                    continue
                if new > old:
                    self.dstate[key][ch, d["W"] - new:] = 0.0
                d["cur"][ch] = new
                changed = True
            if changed:
                _refresh(d, "arr", torch.as_tensor(
                    np.asarray(d["cur"], np.int64), device=self.device))

    # ----- the IO halves ----------------------------------------------------
    def input_half(self, in_words, in_gain):
        """Per-device words -> [C_in, N] float: sign-extend packed S24,
        decode, mute gain, then the input delay and subdelay. The mute
        comes first, so the delay state advances on zeros while muted."""
        xs = []
        for di, (sel, vmap) in enumerate(self._in_devs):
            w = in_words[di]
            if self.in_wire[di] != "word":
                w = sext24(w)
            xs.append(decode_words(w, sel, vmap, self.rd))
        x = torch.cat(xs, dim=0) * in_gain[:, None]
        ds, dly, sd = self.dstate, self._dly[IN], self._sd[IN]
        if dly is not None:
            x, ds["dlw_in"] = apply_delay(x, ds["dlw_in"], dly["arr"],
                                          dly["W"])
        if sd is not None:
            x, ds["sdr_in"] = apply_subdelay(x, ds["sdr_in"], sd["hrows"],
                                             sd["byp"], sd["B"])
        return x

    def output_half(self, y, out_gain):
        """y [C_out, N] -> (per-device wire words, per-device meters
        [used, 4], nan_ok scalar bool tensor): the output subdelay and
        delay, gains, then per device the mix and the dithered quantize
        (one shared dither window a block) or encode."""
        # NaN gate on the first sample of each channel (bfrun.c:1900-1911)
        nan_ok = (torch.all(torch.isfinite(y[:, 0])) if y.shape[0]
                  else torch.ones((), dtype=torch.bool, device=y.device))
        ds, dly, sd = self.dstate, self._dly[OUT], self._sd[OUT]
        if sd is not None:
            y, ds["sdr_out"] = apply_subdelay(y, ds["sdr_out"], sd["hrows"],
                                              sd["byp"], sd["B"])
        if dly is not None:
            y, ds["dlw_out"] = apply_delay(y, ds["dlw_out"], dly["arr"],
                                           dly["W"])
        y = y * out_gain[:, None]
        if self._dither is not None:
            # one shared window a block advances every dithered channel's
            # pointer by N
            tab, randmap, size = self._dither
            d_all, ptr, last = dither_window(tab, randmap, ds["ptr"],
                                             ds["last"], y.shape[1], size)
            sf_all = ds["sf"].clone()
        outs, meters = [], []
        for di, (sel, (kind, mix), open_ch, fmt) in enumerate(self._out_devs):
            phys = y[mix] if kind == "perm" else torch.matmul(mix, y)
            peak = torch.amax(torch.abs(phys), dim=1)
            rows = self._dith_rows[di]
            if rows is not None:
                q, sf_new, m = dither_quantize(
                    phys, d_all[rows], sf_all[rows], fmt.imin, fmt.imax)
                sf_all[rows] = sf_new
                words = scatter_words(q, sel, open_ch, self.out_words[di])
            else:
                words, m = encode_words(phys, fmt, sel, open_ch,
                                        self.out_words[di])
            if self.out_wire[di] != "word":
                words = pack24(words)
            outs.append(words)
            meters.append(torch.cat([m, peak[:, None]], dim=1))
        if self._dither is not None:
            ds.update(ptr=ptr, last=last, sf=sf_all)
        return outs, meters, nan_ok

    # ----- the step programs -------------------------------------------------
    def step(self, state, ctrl, in_gain, out_gain, bank, in_words,
             uniform=False, udelay=False, xfade=False):
        """One block: per-device words [N, ...] -> (state', outs, meters,
        nan_ok), as ``step_eager``, through the program of the key
        ``(uniform, udelay, xfade)``. ``state'`` is the programs' static
        state, which the next call reads in place."""
        return self._call(("step", uniform, udelay, xfade), state, ctrl,
                          in_gain, out_gain, bank, in_words,
                          lambda: functools.partial(
                              self.step_eager, uniform=uniform,
                              udelay=udelay, xfade=xfade))

    def multi_step(self, state, ctrl, in_gain, out_gain, bank, in_words,
                   uniform=False, udelay=False):
        """m blocks, as ``multi_step_eager``, through the program of the key
        ``(m, uniform, udelay)``; its group size is chosen at the key's
        first call, as the JAX package chooses it when it builds the
        key's program."""
        m = in_words[0].shape[0]
        return self._call(("multi", m, uniform, udelay), state, ctrl,
                          in_gain, out_gain, bank, in_words,
                          lambda: functools.partial(
                              self.multi_step_eager, uniform=uniform,
                              udelay=udelay,
                              G=group_size(self.spec, m, self.mesh)))

    def _call(self, key, state, ctrl, in_gain, out_gain, bank, in_words,
              make):
        """Bind the arguments to the static tensors, then run the key's
        program (made from ``make()``, the eager form, on first use).
        ``dstate`` is the static one from here on: a replay runs no
        Python, so nothing else would rebind it."""
        sp = REC.on and REC.begin("bind")
        args = (state, (ctrl, in_gain, out_gain, bank), self.dstate)
        if self._statics is None:
            self._statics = Statics(*args)
        else:
            self._statics.bind(*args)
        self.dstate = self._statics.dstate.tree
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = Program(
                self._body(make()), self.device, self.captures, self.mesh,
                key)
        return (self._statics.state.tree,) + prog(in_words, sp)

    def _body(self, fn):
        """``fn`` (an eager form) over the static tensors: words ->
        (outs, meters, nan_ok), the new state and ``dstate`` copied into
        the static ones at the end."""
        S = self._statics

        def body(words):
            self.dstate = dict(S.dstate.tree)
            try:
                st, outs, meters, nan_ok = fn(S.state.tree, *S.args.tree,
                                              words)
                S.state.store(st)
                S.dstate.store(self.dstate)
            finally:
                self.dstate = S.dstate.tree
            return outs, meters, nan_ok

        return body

    @property
    def captures(self) -> bool:
        """Whether the programs are captured as CUDA graphs (a key's
        second call captures; on the card, under a mesh on one card or
        across several too), or run eagerly at every call (the CPU)."""
        return capturable(self.device, self.mesh)

    def programs(self) -> dict:
        """The step programs made so far, by key."""
        return dict(self._programs)

    # ----- the eager forms ---------------------------------------------------
    def step_eager(self, state, ctrl, in_gain, out_gain, bank, in_words,
                   uniform=False, udelay=False, xfade=False):
        """One block op by op: per-device words [N, ...] -> (state', outs,
        meters, nan_ok). ``xfade``: the snapshot carries a crossfade on
        this block (``step_impl``'s ``xfade_now``)."""
        x = self.input_half(in_words, in_gain)
        state, y = step_impl(self.spec, state, ctrl, bank, x,
                             uniform=uniform, uniform_delay=udelay,
                             xfade_now=xfade, mesh=self.mesh)
        outs, meters, nan_ok = self.output_half(y, out_gain)
        return state, outs, meters, nan_ok

    def multi_step_eager(self, state, ctrl, in_gain, out_gain, bank,
                         in_words, uniform=False, udelay=False, G=None):
        """m blocks with frozen controls and no crossfade (the engine
        dispatches crossfade blocks one at a time, as the JAX package
        groups only then, device_io.py:587-613): per-device stacked words
        [m, N, ...] -> (state', per-device stacked outs [m, N, ...],
        per-device aggregated meters, nan_ok over all blocks). ``dstate``
        chains block by block in order, as m calls of ``step_eager`` chain
        it. ``G``: blocks a group (default ``group_size``)."""
        m = in_words[0].shape[0]
        outs_b, meters_b, nans = [], [], []
        if G is None:
            G = group_size(self.spec, m, self.mesh)
        for b0 in range(0, m, G):
            if G >= 2:
                # grouped dispatch (device_io.py:587-613, 727-782): the
                # IO halves per block, in order; the graph step G blocks
                # at a time
                xs = [self.input_half([w[b] for w in in_words], in_gain)
                      for b in range(b0, b0 + G)]
                state, ys = group_step_impl(self.spec, state, ctrl, bank,
                                            xs, uniform_delay=udelay,
                                            mesh=self.mesh)
                blocks = [self.output_half(y, out_gain) for y in ys]
            else:
                state, *one = self.step_eager(
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
