"""Runtime control plane -- the `intercomm_area`/`bfaccess` equivalent.

Twin of the part of :mod:`brutefir_tpu.runtime.control` that the
step reads. The config's per-filter coefficient selection, edge gains
(input, filter -> filter and output) and pre-delays are snapshotted into
a :class:`StepCtrl` of tensors on the engine's device; mutes ride
``mute_version`` into the engine's gain vectors.

Not in this slice: the mutation API the CLI and logic modules drive
(coefficient, delay and subdelay changes, the coeff_final hooks) and the
crossfade state, which come with the per-block ``run()`` and logic
modules (ROADMAP queue 1 item 4) and crossfade (item 7).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config.model import BFConfig, IN, OUT
from ..graph.compile import StepCtrl, make_ctrl
from ..graph.spec import GraphSpec


class RuntimeControl:
    def __init__(self, conf: BFConfig, spec: GraphSpec, device):
        self.conf = conf
        self.spec = spec
        self.device = device
        self.mute = [list(conf.mute[IN]), list(conf.mute[OUT])]
        self.mute_version = 0

        # virtual-channel format scales (bfrun.c:1371)
        self.virtscale = [np.ones(conf.n_channels[io]) for io in (IN, OUT)]
        for io in (IN, OUT):
            for ch in range(conf.n_channels[io]):
                fmt = conf.physical_format(io, conf.virt2phys[io][ch])
                self.virtscale[io][ch] = fmt.scale

        self._coeff_nblocks = [c.n_blocks for c in conf.coeffs]
        self._cached: Optional[StepCtrl] = None
        # True when every filter shares one coeff row + mask row: the step
        # then runs the shared-bank-row form of the MAC kernel
        self.snapshot_uniform = False
        # True when every filter shares one pre-delay: the ring write is
        # one slice at a scalar slot
        self.snapshot_uniform_delay = False

    def _cblocks(self, coeff: int, delay: int) -> int:
        B = self.spec.n_blocks
        d = min(max(delay, 0), B - 1)
        if coeff < 0 or self._coeff_nblocks[coeff] > B - d:
            return B - d
        return self._coeff_nblocks[coeff]

    def _bank_index(self, coeff: int) -> int:
        return coeff if coeff >= 0 else len(self.conf.coeffs)

    def snapshot(self) -> StepCtrl:
        """The StepCtrl for the next block (bfrun.c:1573-1601). Nothing in
        this slice changes the controls, so it is built, and its tensors
        uploaded, once."""
        if self._cached is not None:
            return self._cached
        spec, conf = self.spec, self.conf
        F, B = spec.n_filters, spec.n_blocks
        rd = spec.real_dtype

        in_mix = np.zeros((F, spec.n_inputs), rd)
        fmix = np.zeros((F, F), rd)
        out_mix = np.zeros((spec.n_outputs, F), rd)
        delay = np.zeros(F, np.int32)
        coeff_idx = np.zeros(F, np.int32)
        mask = np.zeros((F, B), rd)
        for n, f in enumerate(conf.filters):
            for ch, scale in f.in_channels:
                in_mix[n, ch] = scale * self.virtscale[IN][ch]
            for src, scale in f.in_filters:
                fmix[n, src] = scale
            for ch, scale in f.out_channels:
                out_mix[ch, n] = scale / self.virtscale[OUT][ch]
            d = min(max(f.delayblocks, 0), B - 1)
            delay[n] = d
            coeff_idx[n] = self._bank_index(f.coeff)
            mask[n, : self._cblocks(f.coeff, d)] = 1.0

        ps_thresh = None
        if spec.powersave:
            # scale * max|x| < analog  <=>  max|x| < analog / scale
            ps_thresh = (conf.analog_powersave
                         / np.maximum(self.virtscale[IN], 1e-30)).astype(rd)
        self._cached = make_ctrl(spec, in_mix, out_mix, delay, coeff_idx,
                                 mask, ps_thresh, device=self.device,
                                 fmix=fmix)
        self.snapshot_uniform = bool(
            F > 0
            and np.all(coeff_idx == coeff_idx[0])
            and np.all(mask == mask[0:1]))
        self.snapshot_uniform_delay = bool(F > 0 and np.all(delay == delay[0]))
        return self._cached
