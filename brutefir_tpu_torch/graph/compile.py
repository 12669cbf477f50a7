"""The per-block device step: ``step_impl(spec, state, ctrl, bank, x)``.

Torch twin of the fused-mix branch of ``_step_impl`` in
:mod:`brutefir_tpu.graph.compile` (compile.py:241-275, 309-351): for a
single-stage graph with no cascades, no crossfade and no spectral taps,
one block is

    frame = [prev_in, x] -> (powersave gate) -> rfft -> input mix
    -> ring write at (t + delay[f]) % B -> fused MAC + output mix (CUDA)
    -> valid-half irfft -> y [C_out, N]

``state`` holds the overlap-save tails, the [F, B, 2, N] spectra ring and
the block counter; ``ctrl`` is the block-boundary snapshot of every
runtime control, so control changes never rebuild anything. PyTorch runs
eagerly, so there is no compiled program cache: the ``uniform`` and
``uniform_delay`` variants are plain arguments chosen by the host.

The ring is written **in place**: the analog of the JAX step donating its
state buffers. The returned state shares the ring tensor with the input.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import partconv
from ..ops.mac_mix import mac_mix
from .spec import GraphSpec


class StepState(NamedTuple):
    prev_in: torch.Tensor    # [C_in, N] previous input block (overlap-save tails)
    ring: torch.Tensor       # [F, B, 2, N] packed spectra ring (re/im planes)
    t: torch.Tensor          # scalar int32 block counter


class StepCtrl(NamedTuple):
    """The controls the fused-mix step reads. The JAX StepCtrl's filter
    mix and crossfade fields come with the ROADMAP items that port
    cascades (queue 1 item 8) and crossfade (item 7)."""
    in_mix: torch.Tensor     # [F, C_in] input mix gains (incl. format scale)
    out_mix: torch.Tensor    # [C_out, F] output mix gains (incl. 1/format scale)
    delay: torch.Tensor      # [F] int32 pre-delay in blocks (clamped 0..B-1)
    coeff_idx: torch.Tensor  # [F] int32 index into the bank (dirac = last entry)
    mask: torch.Tensor       # [F, B] partition validity (cblocks clamp)
    ps_thresh: torch.Tensor  # [C_in] analog-powersave gate threshold (0 = off)


def check_supported(spec: GraphSpec) -> None:
    """Raise NotImplementedError for a graph the fused-mix step does not
    cover, naming the ROADMAP item that will port it."""
    if spec.real_dtype != np.float32:
        raise NotImplementedError(
            "float_bits: 64 is not ported yet (ROADMAP queue 1 item 9)")
    if spec.any_crossfade:
        raise NotImplementedError(
            "crossfade filters are not ported yet (ROADMAP queue 1 item 7)")
    if len(spec.stages) != 1 or spec.n_casc:
        raise NotImplementedError(
            "filter cascades and graphs other than one stage of filters "
            "are not ported yet (ROADMAP queue 1 item 8)")


def init_state(spec: GraphSpec, device) -> StepState:
    rd = torch.float32
    return StepState(
        prev_in=torch.zeros((spec.n_inputs, spec.block_length), dtype=rd,
                            device=device),
        ring=torch.zeros(spec.ring_shape(), dtype=rd, device=device),
        t=torch.zeros((), dtype=torch.int32, device=device),
    )


def make_ctrl(spec: GraphSpec, in_mix, out_mix, delay, coeff_idx, mask,
              ps_thresh=None, device=None) -> StepCtrl:
    """Assemble a StepCtrl on ``device`` from host arrays (default:
    powersave gate off)."""
    rd = spec.real_dtype
    if ps_thresh is None:
        ps_thresh = np.zeros(spec.n_inputs, rd)

    def real(a):
        return torch.as_tensor(np.asarray(a, rd), device=device)

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return StepCtrl(
        in_mix=real(in_mix), out_mix=real(out_mix), delay=idx(delay),
        coeff_idx=idx(coeff_idx), mask=real(mask), ps_thresh=real(ps_thresh),
    )


def step_impl(spec: GraphSpec, state: StepState, ctrl: StepCtrl,
              bank: torch.Tensor, x: torch.Tensor, uniform: bool = False,
              uniform_delay: bool = False):
    """One block: x [C_in, N] -> (state', y [C_out, N]).

    ``uniform``: the host asserts every filter shares one coefficient row
    and mask row (RuntimeControl.snapshot_uniform), so the kernel reads one
    shared bank row. ``uniform_delay``: every filter shares one pre-delay,
    so the ring write is one slice at a scalar slot instead of a
    per-filter scatter. Both give the same values as the general form.

    The ring is updated in place (see the module docstring); nothing here
    synchronises with the host."""
    check_supported(spec)
    B = spec.n_blocks
    F = spec.n_filters
    frame = torch.cat([state.prev_in, x], dim=-1)
    if spec.powersave:
        # analog powersave gate (test_silent, bfrun.c:722-772): the whole
        # 2N frame must be quiet; it is then truly zero for this transform
        thr = ctrl.ps_thresh[:, None]
        peak = torch.amax(torch.abs(frame), dim=1, keepdim=True)
        frame = torch.where((thr > 0) & (peak < thr),
                            torch.zeros_like(frame), frame)
    X = partconv.rfft_planes(frame)                         # [C_in, 2, N]
    mixed = partconv.complex_mix(ctrl.in_mix, X)            # [F, 2, N]

    # the block lands at each filter's delayed slot (the cbuf
    # curblock + delay of bfrun.c:1688-1690) BEFORE the MAC reads the ring
    ring = state.ring
    t = state.t
    if uniform_delay:
        wpos0 = torch.remainder(t + ctrl.delay[0], B).reshape(1).long()
        ring.index_copy_(1, wpos0, mixed[:, None])
    else:
        wpos = torch.remainder(t + ctrl.delay, B).long()
        ring.index_put_(
            (torch.arange(F, device=ring.device), wpos), mixed)

    out_spec = mac_mix(ring, bank, ctrl.coeff_idx, ctrl.mask, t,
                       ctrl.out_mix, uniform)               # [C_out, 2, N]
    y = partconv.irfft_planes_valid(out_spec)               # [C_out, N]
    return StepState(prev_in=x, ring=ring, t=t + 1), y
