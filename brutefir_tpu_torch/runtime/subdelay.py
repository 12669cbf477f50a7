"""Subsample (fractional) delay filtering.

A copy of :mod:`brutefir_tpu.runtime.subdelay`. On the device-IO path
the engine runs the filter on the device (``runtime/device_io.py``, the
bank ``H`` below); on the host codec path ``Engine.read_block`` and
``write_block`` run ``process``.

Reimplements the reference subsample-delay subsystem (`delay.c:409-506`,
`convolver_td_*` fftw_convolver.c:682-783): a bank of 2*BF_SAMPLE_SLOTS-1
windowed-sinc fractional-delay FIRs of length 2*sdf_length+1, applied
blockwise with a small overlap-save convolver whose chunk size is the
next power of two above the filter length. Channels with a *defined*
subdelay run through the filter (adding sdf_length samples latency);
channels left undefined get a compensating integer delay instead
(bfrun.c:1512-1516).

Faithfulness note: the reference hardcodes Kaiser beta 9 in the sinc
sampler (`delay.c:73`) even though a configured ``sdf_beta`` is threaded
through to it -- we reproduce that (the configured beta is accepted and
ignored, as upstream).
"""

from __future__ import annotations

import numpy as np

from ..config.model import BFConfig, IN, OUT, BF_SAMPLE_SLOTS, BF_UNDEFINED_SUBDELAY
from ..core.firwindow import sample_sinc


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class SubsampleDelay:
    def __init__(self, conf: BFConfig, rd: np.dtype):
        if conf.sdf_length <= 0:
            raise ValueError("subdelay in use but sdf_length not set")
        self.conf = conf
        self.rd = rd
        self.half = conf.sdf_length
        L = 2 * self.half + 1
        self.blocklen = _next_pow2(L)
        if conf.filter_length % self.blocklen != 0:
            raise ValueError(
                f"incompatible fragment/filter sizes: filter_length "
                f"{conf.filter_length} must divide by the subdelay "
                f"chunk {self.blocklen} (next pow2 of {L})")
        steps = BF_SAMPLE_SLOTS
        n_fft = 2 * self.blocklen
        # spectral bank indexed by subdelay in [-(steps-1) .. steps-1]
        self.H = np.zeros((2 * steps - 1, self.blocklen + 1),
                          dtype=np.complex64 if rd == np.float32 else np.complex128)
        for sd in range(-(steps - 1), steps):
            if sd == 0:
                taps = np.zeros(L, dtype=rd.type)
                taps[L >> 1] = 1.0
            else:
                # beta hardcoded to 9 as in delay.c:73
                taps = sample_sinc(self.half, float(sd) / steps, 9.0, rd.type)
            buf = np.zeros(n_fft, dtype=rd.type)
            buf[self.blocklen: self.blocklen + L] = taps
            self.H[sd + steps - 1] = (np.fft.rfft(buf) / 1.0).astype(self.H.dtype)
        self.steps = steps
        # per-channel overlap "rest" buffers: only sides where subdelay is
        # in use get filtering at all (bfrun allocates sd_rest per side
        # under bfconf->use_subdelay), and within such a side only channels
        # with a defined subdelay are filtered -- undefined ones get the
        # compensating integer delay instead.
        self.rest = [{}, {}]
        for io in (IN, OUT):
            if not conf.use_subdelay[io]:
                continue
            for ch in range(conf.n_channels[io]):
                if conf.subdelay[io][ch] != BF_UNDEFINED_SUBDELAY:
                    self.rest[io][ch] = np.zeros(self.blocklen, dtype=rd.type)

    def extra_delay(self, io: int, ch: int) -> int:
        """Compensating integer delay for channels without a subdelay filter
        on a side where subdelay is active (bfrun.c:1512-1516)."""
        if (self.conf.use_subdelay[io]
                and self.conf.subdelay[io][ch] == BF_UNDEFINED_SUBDELAY):
            return self.half
        return 0

    def process(self, io: int, ch: int, x: np.ndarray, subdelay: int) -> np.ndarray:
        rest = self.rest[io].get(ch)
        if rest is None:
            return x
        if subdelay <= -self.steps or subdelay >= self.steps:
            return x  # out of range: no-op (delay_subsample_update delay.c:424)
        H = self.H[subdelay + self.steps - 1]
        B = self.blocklen
        out = np.empty_like(x)
        for i in range(0, x.shape[0], B):
            chunk = x[i: i + B]
            frame = np.concatenate([rest, chunk])
            y = np.fft.irfft(np.fft.rfft(frame) * H).astype(self.rd)
            rest[:] = chunk
            out[i: i + B] = y[:B]
        return out
