"""Runtime control plane -- the `intercomm_area`/`bfaccess` equivalent.

Twin of :mod:`brutefir_tpu.runtime.control`. All runtime-mutable engine
state (per-filter coefficient selection, edge gains, pre-delays;
per-channel delays, subdelays, mutes) lives here, mutated by logic modules
(the CLI) between blocks and snapshotted into a :class:`StepCtrl` of
tensors on the engine's device at each block boundary, so changes land on
exact block edges like the reference's icomm snapshot
(`bfrun.c:1460-1484`). Mutes ride ``mute_version`` into the engine's gain
vectors. Channel delays and subdelays are kept and validated here, but a
config that needs them on the device still raises in ``DeviceIO`` (ROADMAP
queue 1 item 5).

The JAX package's manual ``process:`` placement permutation
(``spec_rows``/``f2row``) comes with multi-device sharding (ROADMAP queue 1
item 11): here spec rows are config order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config.model import BFConfig, IN, OUT, BF_SAMPLE_SLOTS
from ..graph.compile import StepCtrl, make_ctrl
from ..graph.spec import GraphSpec


class FilterControl:
    """Per-filter mutable control (`struct bffilter_control`)."""

    __slots__ = ("coeff", "delayblocks", "in_scales", "out_scales", "fscales")

    def __init__(self, coeff, delayblocks, in_scales, out_scales, fscales):
        self.coeff = coeff
        self.delayblocks = delayblocks
        self.in_scales = list(in_scales)
        self.out_scales = list(out_scales)
        self.fscales = list(fscales)


class RuntimeControl:
    def __init__(self, conf: BFConfig, spec: GraphSpec, device):
        self.conf = conf
        self.spec = spec
        self.device = device
        self.fctrl = [
            FilterControl(
                f.coeff, f.delayblocks,
                [s for _, s in f.in_channels],
                [s for _, s in f.out_channels],
                [s for _, s in f.in_filters],
            )
            for f in conf.filters
        ]
        self.prev_coeff = [fc.coeff for fc in self.fctrl]
        self.mute = [list(conf.mute[IN]), list(conf.mute[OUT])]
        self.delay = [list(conf.delay[IN]), list(conf.delay[OUT])]
        self.subdelay = [list(conf.subdelay[IN]), list(conf.subdelay[OUT])]
        # coeff_final hook (the EQ's double-buffer redirect,
        # bfrun.c:1574-1578)
        self.coeff_final_hook = None
        # logic modules' coeff_final hooks (return int or None); replaced
        # wholesale by Engine.attach_logic
        self.coeff_final_mod_hooks = []

        # virtual-channel format scales (bfrun.c:1371)
        self.virtscale = [np.ones(conf.n_channels[io]) for io in (IN, OUT)]
        for io in (IN, OUT):
            for ch in range(conf.n_channels[io]):
                fmt = conf.physical_format(io, conf.virt2phys[io][ch])
                self.virtscale[io][ch] = fmt.scale

        self._coeff_nblocks = [c.n_blocks for c in conf.coeffs]
        self._dirty = True
        self.mute_version = 0
        self._cached: Optional[StepCtrl] = None
        self._cached_has_xfade = False
        # True when every filter shares one coeff row + mask row, and one
        # previous row + mask: the step then runs the shared-bank-row
        # form of the MAC kernels
        self.snapshot_uniform = False
        # True when every filter shares one pre-delay: the ring write is
        # one slice at a scalar slot
        self.snapshot_uniform_delay = False
        # True when the latest snapshot carries a crossfade this block:
        # the engine passes xfade_now to the step
        self.snapshot_xfade = False

    # --- mutation API (used by the CLI) -----------------------------------
    def mark_dirty(self):
        self._dirty = True

    def change_coeff(self, filter_idx: int, coeff: int):
        # any negative id means "no coeff" (the reference applies
        # `coeff < 0` uniformly, bfrun.c:1585)
        if coeff < -1:
            coeff = -1
        if coeff < len(self.conf.coeffs):
            self.fctrl[filter_idx].coeff = coeff
            self._dirty = True

    def change_filter_delay(self, filter_idx: int, blocks: int):
        self.fctrl[filter_idx].delayblocks = blocks
        self._dirty = True

    def set_mute(self, io: int, ch: int, mute: bool):
        if 0 <= ch < self.conf.n_channels[io]:
            self.mute[io][ch] = mute
            # mutes ride mute_version -> Engine._mute_gains, not the
            # StepCtrl snapshot
            self.mute_version += 1

    def set_delay(self, io: int, ch: int, delay: int) -> bool:
        if not (0 <= ch < self.conf.n_channels[io]):
            return False
        md = self.conf.maxdelay[io][ch]
        # reject: negative, beyond maxdelay, or not runtime-changeable
        # (maxdelay unset) -- delay.c:283-317
        if delay < 0 or md < 0 or delay > md:
            return False
        self.delay[io][ch] = delay
        self._dirty = True
        return True

    def set_subdelay(self, io: int, ch: int, subdelay: int) -> bool:
        if not (0 <= ch < self.conf.n_channels[io]):
            return False
        if not (-BF_SAMPLE_SLOTS < subdelay < BF_SAMPLE_SLOTS):
            return False
        if self.conf.subdelay[io][ch] == -BF_SAMPLE_SLOTS:
            return False  # channel has no subdelay filter allocated
        self.subdelay[io][ch] = subdelay
        self._dirty = True
        return True

    # --- snapshot ---------------------------------------------------------
    def _cblocks(self, coeff: int, delay: int) -> int:
        B = self.spec.n_blocks
        d = min(max(delay, 0), B - 1)
        if coeff < 0 or self._coeff_nblocks[coeff] > B - d:
            return B - d
        return self._coeff_nblocks[coeff]

    def _bank_index(self, coeff: int) -> int:
        return coeff if coeff >= 0 else len(self.conf.coeffs)

    def snapshot(self) -> StepCtrl:
        """Build (or reuse) the StepCtrl for the next block
        (bfrun.c:1573-1601, 1691-1838): applies the coeff_final hooks,
        marks a crossfade on each crossfade filter whose final coefficient
        changed, and advances ``prev_coeff``. A crossfade block forces a
        rebuild on the next call, which clears the crossfade."""
        spec, conf = self.spec, self.conf
        F, B = spec.n_filters, spec.n_blocks
        rd = spec.real_dtype

        # resolve the final coeff choice (hooks may redirect)
        final_coeff = []
        for n, fc in enumerate(self.fctrl):
            c = fc.coeff
            if self.coeff_final_hook is not None:
                c = self.coeff_final_hook(n, c)
            for h in self.coeff_final_mod_hooks:
                r = h(n, c)
                if r is not None:
                    c = r
            final_coeff.append(c)

        xfade_now = [
            conf.filters[n].crossfade and final_coeff[n] != self.prev_coeff[n]
            for n in range(len(conf.filters))
        ]
        changed = (self._dirty or any(xfade_now)
                   or final_coeff != self.prev_coeff
                   or self._cached_has_xfade)
        if not changed and self._cached is not None:
            return self._cached

        in_mix = np.zeros((F, spec.n_inputs), rd)
        fmix = np.zeros((F, F), rd)
        out_mix = np.zeros((spec.n_outputs, F), rd)
        delay = np.zeros(F, np.int32)
        coeff_idx = np.zeros(F, np.int32)
        mask = np.zeros((F, B), rd)
        prev_idx = np.zeros(F, np.int32)
        prev_mask = np.zeros((F, B), rd)
        xfade = np.zeros(F, rd)
        for n, f in enumerate(conf.filters):
            fc = self.fctrl[n]
            for j, (ch, _) in enumerate(f.in_channels):
                in_mix[n, ch] = fc.in_scales[j] * self.virtscale[IN][ch]
            for j, (src, _) in enumerate(f.in_filters):
                fmix[n, src] = fc.fscales[j]
            for j, (ch, _) in enumerate(f.out_channels):
                out_mix[ch, n] = fc.out_scales[j] / self.virtscale[OUT][ch]
            d = min(max(fc.delayblocks, 0), B - 1)
            delay[n] = d
            c = final_coeff[n]
            coeff_idx[n] = self._bank_index(c)
            mask[n, : self._cblocks(c, d)] = 1.0
            pc = self.prev_coeff[n]
            prev_idx[n] = self._bank_index(pc)
            prev_mask[n, : self._cblocks(pc, d)] = 1.0
            if xfade_now[n]:
                xfade[n] = 1.0

        ps_thresh = None
        if spec.powersave:
            # scale * max|x| < analog  <=>  max|x| < analog / scale
            ps_thresh = (conf.analog_powersave
                         / np.maximum(self.virtscale[IN], 1e-30)).astype(rd)
        self.prev_coeff = final_coeff
        self._dirty = False
        self._cached = make_ctrl(spec, in_mix, out_mix, delay, coeff_idx,
                                 mask, ps_thresh, device=self.device,
                                 fmix=fmix, prev_idx=prev_idx,
                                 prev_mask=prev_mask, xfade=xfade)
        self._cached_has_xfade = any(xfade_now)
        self.snapshot_xfade = self._cached_has_xfade
        self.snapshot_uniform = bool(
            F > 0
            and np.all(coeff_idx == coeff_idx[0])
            and np.all(mask == mask[0:1])
            and np.all(prev_idx == prev_idx[0])
            and np.all(prev_mask == prev_mask[0:1]))
        self.snapshot_uniform_delay = bool(F > 0 and np.all(delay == delay[0]))
        return self._cached
