"""The per-block device step: ``step_impl(spec, state, ctrl, bank, x)``.

Torch twin of ``_step_impl`` in :mod:`brutefir_tpu.graph.compile`
(compile.py:241-533). One block is

    frame = [prev_in, x] -> (powersave gate) -> rfft -> per stage:
    input mix (+ cascade input) -> ring write at (t + delay[f]) % B -> MAC
    -> output mix -> valid-half irfft -> y [C_out, N]

``taps`` (from ``Engine.attach_logic``) maps the frequency-domain module
hooks to functions ``tap(planes, idx) -> planes``, called as the JAX
step's ordered host callbacks are (compile.py:165-178): ``input_freqd``
on the input spectra after the rfft, ``pre_convolve`` on each stage's
mixed spectra before the ring write (so a mutation stays in the ring's
history), ``post_convolve`` on each stage's filter spectra after the
crossfade selection, ``output_freqd`` on the output spectra before the
inverse transform. Taps take the stage loop: the fused routes have no
tap sites.

Three routes, chosen as the JAX package chooses them: a single stage of
every filter takes the fused MAC + output mix kernel (``mac_mix``,
``fused_mix_route``), unless a crossfade lands on the block; a crossfade
block of such a graph takes the **fused time-domain crossfade** (the dual
MAC ``mac_dual``, three mixed spectra, one inverse transform, the ramp in
time); every other graph runs the **stage loop**, one topological stage
of the filter DAG after the other, through the unfused MAC kernel
(``mac``), or on a crossfade block through ``mac_dual`` and
``partconv.crossfade_spectra``. A stage's filters that take other
filters' outputs (``from_filters``) get them as ``convolve_eval`` of the
mixed upstream spectra, overlap-save framed against the cascade tails
``eval_prev``.

A float64 graph (``float_bits: 64``) takes the JAX package's float64
routes: there its Pallas kernels want float32, so it runs the dense MAC
(``mac = "jnp"``), which never takes the fused MAC + mix, the grouped
dispatch or the dual MAC. Here every block without a crossfade runs the
stage loop through ``mac``'s float64 form, and a crossfade block runs
``mac`` twice, for the new set and the old (the JAX ``run_mac`` twice), in
the fused time-domain crossfade or the stage loop alike.

The batched offline dispatch may instead run G blocks at a time through
``group_step_impl`` (compile.py:615-752), whose grouped MAC kernels read
the ring and the bank once per group; ``group_size`` decides. It only
ever runs blocks without a crossfade.

``state`` holds the overlap-save tails, the [F, B, 2, N] spectra ring, the
cascade tails and the block counter; ``ctrl`` is the block-boundary
snapshot of every runtime control, so control changes never rebuild
anything. PyTorch runs eagerly, so there is no compiled program cache: the
``uniform``, ``uniform_delay`` and ``xfade_now`` variants are plain
arguments chosen by the host (the JAX package's in-graph ``lax.cond`` on
``any_xfade`` has no counterpart: the host always knows).

The ring and the cascade tails are written **in place**: the analog of
the JAX step donating its state buffers. The returned state shares them
with the input.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from ..ops import partconv
from ..ops.mac import mac
from ..ops.mac_dual import mac_dual
from ..ops.mac_group import mac_group, mac_mix_group
from ..ops.mac_mix import mac_mix, tiled_route
from .spec import GraphSpec


class StepState(NamedTuple):
    prev_in: torch.Tensor    # [C_in, N] previous input block (overlap-save tails)
    ring: torch.Tensor       # [F, B, 2, N] packed spectra ring (re/im planes)
    eval_prev: torch.Tensor  # [n_casc, N] cascade valid-output tails
    t: torch.Tensor          # scalar int32 block counter


class StepCtrl(NamedTuple):
    """The controls the step reads: the JAX StepCtrl without
    ``any_xfade`` (the host passes ``xfade_now`` instead)."""
    in_mix: torch.Tensor     # [F, C_in] input mix gains (incl. format scale)
    fmix: torch.Tensor       # [F, F] filter -> filter mix gains
    out_mix: torch.Tensor    # [C_out, F] output mix gains (incl. 1/format scale)
    delay: torch.Tensor      # [F] int32 pre-delay in blocks (clamped 0..B-1)
    coeff_idx: torch.Tensor  # [F] int32 index into the bank (dirac = last entry)
    mask: torch.Tensor       # [F, B] partition validity (cblocks clamp)
    prev_idx: torch.Tensor   # [F] int32 previous coefficient (crossfade source)
    prev_mask: torch.Tensor  # [F, B]
    xfade: torch.Tensor      # [F] 1.0 where a crossfade happens this block
    ps_thresh: torch.Tensor  # [C_in] analog-powersave gate threshold (0 = off)


def check_supported(spec: GraphSpec) -> None:
    """Raise NotImplementedError for a graph the step does not cover: a
    real type other than float32 and float64 (``float_bits`` 32 and 64,
    the only two the config language has)."""
    if spec.real_dtype not in (np.float32, np.float64):
        raise NotImplementedError(
            f"real type {spec.real_dtype}: the step runs float32 and "
            f"float64 graphs")


def real_dtype(spec: GraphSpec) -> torch.dtype:
    """The torch dtype of the graph's real type."""
    return torch.float64 if spec.real_dtype == np.float64 else torch.float32


def init_state(spec: GraphSpec, device) -> StepState:
    rd = real_dtype(spec)
    N = spec.block_length
    return StepState(
        prev_in=torch.zeros((spec.n_inputs, N), dtype=rd, device=device),
        ring=torch.zeros(spec.ring_shape(), dtype=rd, device=device),
        eval_prev=torch.zeros((spec.n_casc, N), dtype=rd, device=device),
        t=torch.zeros((), dtype=torch.int32, device=device),
    )


def make_ctrl(spec: GraphSpec, in_mix, out_mix, delay, coeff_idx, mask,
              ps_thresh=None, device=None, fmix=None, prev_idx=None,
              prev_mask=None, xfade=None) -> StepCtrl:
    """Assemble a StepCtrl on ``device`` from host arrays (default:
    powersave gate off, no filter -> filter edges, no crossfade: the
    previous coefficient is the current one)."""
    rd = spec.real_dtype
    if ps_thresh is None:
        ps_thresh = np.zeros(spec.n_inputs, rd)
    if fmix is None:
        fmix = np.zeros((spec.n_filters, spec.n_filters), rd)
    if prev_idx is None:
        prev_idx = coeff_idx
    if prev_mask is None:
        prev_mask = mask
    if xfade is None:
        xfade = np.zeros(spec.n_filters, rd)

    def real(a):
        return torch.as_tensor(np.asarray(a, rd), device=device)

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return StepCtrl(
        in_mix=real(in_mix), fmix=real(fmix), out_mix=real(out_mix),
        delay=idx(delay), coeff_idx=idx(coeff_idx), mask=real(mask),
        prev_idx=idx(prev_idx), prev_mask=real(prev_mask),
        xfade=real(xfade), ps_thresh=real(ps_thresh),
    )


_VMEM_BUDGET = 12 * 2**20


def mix_fusable(F: int, B: int, K: int, C_out: int) -> bool:
    """The JAX package's test for its fused MAC + mix kernels
    (pallas_mac.py:645-662), as plain arithmetic: the [C_out, 2, K] output
    and four ring and bank rows fit the TPU's 12 MiB VMEM budget (the
    untiled kernel), or the bin-tiled form's 16-row bin chunks do."""
    if not tiled_route(C_out, B, K):
        return True
    if (K // 128) % 16 != 0:
        return False
    Fc = 128 if F % 128 == 0 else F
    return (C_out + Fc + 4 * B) * 2 * 16 * 128 * 4 <= _VMEM_BUDGET


def fused_mix_route(spec: GraphSpec, xfade_now: bool = False,
                    taps=None) -> bool:
    """Whether a block takes the fused MAC + output mix (``mac_mix``)
    rather than the stage loop or the fused time-domain crossfade: the JAX
    package's ``fused_mix`` predicate (compile.py:323-330) without the
    mesh. No frequency-domain taps, a single stage of every filter in
    order, not crossfading this block, at a shape where the JAX package
    runs its Pallas kernels (``pallas_available``: K a multiple of 128,
    K >= 256; elsewhere it runs the dense stage loop) and its fused
    kernel fits
    (``mix_fusable``), unless ``BRUTEFIR_TPU_FUSED_MIX=0``; and a float32
    graph (``pallas_available`` wants float32: a float64 graph runs the
    JAX package's dense MAC in the stage loop). The card needs none of
    these limits; they are kept so that a config takes the same route,
    and so the same summation order, in both packages."""
    K = spec.n_bins
    return (not taps and spec.single_full_stage and K % 128 == 0
            and spec.real_dtype == np.float32
            and K >= 256
            and not (spec.stages[0].any_crossfade and xfade_now)
            and mix_fusable(spec.n_filters, spec.n_blocks, K,
                            spec.n_outputs)
            and os.environ.get("BRUTEFIR_TPU_FUSED_MIX", "1") != "0")


def fused_xfade_route(spec: GraphSpec, xfade_now: bool,
                      taps=None) -> bool:
    """Whether a crossfade block takes the fused time-domain crossfade:
    the JAX package's ``fused_xf`` predicate (compile.py:369-373) at its
    default. No frequency-domain taps, and a single stage of every
    filter in order holding a crossfading filter."""
    return (xfade_now and not taps and spec.single_full_stage
            and spec.stages[0].any_crossfade)


@functools.lru_cache(maxsize=256)
def _index(values: tuple, device: torch.device,
           dtype: torch.dtype = torch.long) -> torch.Tensor:
    """A static index vector (a stage's filters, slots, an inverse
    permutation) on ``device``, built once: a tensor made from host data
    inside the per-block loop is a synchronous host -> device copy."""
    return torch.tensor(values, dtype=dtype, device=device)


def _gate(spec: GraphSpec, ctrl: StepCtrl, frame: torch.Tensor):
    """The analog powersave gate (test_silent, bfrun.c:722-772) on one
    [C_in, 2N] frame: a channel whose whole frame is quiet is truly zero
    for this transform."""
    if not spec.powersave:
        return frame
    thr = ctrl.ps_thresh[:, None]
    peak = torch.amax(torch.abs(frame), dim=1, keepdim=True)
    return torch.where((thr > 0) & (peak < thr), torch.zeros_like(frame),
                       frame)


def _tap(taps, name: str, planes: torch.Tensor, idx) -> torch.Tensor:
    """The frequency-domain hooks of kind ``name`` on ``planes`` [C, 2, N]
    with their ids ``idx`` (a numpy vector): the tapped planes, or
    ``planes`` when no module hooks that kind."""
    fn = taps.get(name) if taps else None
    return planes if fn is None else fn(planes, idx)


def _write_ring(ring, blk, t, delay, uniform_delay: bool, rows=None) -> None:
    """Write spectra [Fs, 2, N] in place at each filter's delayed slot
    (t + delay[f]) % B (the cbuf curblock + delay of bfrun.c:1688-1690).
    ``rows``: the filters of ``blk`` (a long index), or None for every
    filter in order; then one slice at a scalar slot when every filter
    shares one delay, else a per-filter scatter (compile.py:260-274)."""
    B = ring.shape[1]
    if rows is None and uniform_delay:
        wpos0 = torch.remainder(t + delay[0], B).reshape(1).long()
        ring.index_copy_(1, wpos0, blk[:, None])
        return
    if rows is None:
        rows = _index(tuple(range(ring.shape[0])), ring.device)
    wpos = torch.remainder(t + delay[rows], B).long()
    ring.index_put_((rows, wpos), blk)


def _stage_loop(spec: GraphSpec, state: StepState, ctrl: StepCtrl,
                bank: torch.Tensor, X: torch.Tensor, uniform: bool,
                uniform_delay: bool, xfade_now: bool,
                taps=None) -> torch.Tensor:
    """The stage loop of compile.py:418-533: per stage, the input mix of
    its filters, the cascade input of those with filter inputs, the
    ``pre_convolve`` tap, the ring write and the unfused MAC of its
    filters (read in place in the ring), the ``post_convolve`` tap; then
    every filter's spectra [F, 2, N] in filter order. On a crossfade
    block a stage holding a crossfading filter runs the dual MAC and
    ``crossfade_spectra`` instead, and keeps the ramped spectra of the
    filters whose ``xfade`` is set (compile.py:456-505 without the
    cond). Updates the ring and ``state.eval_prev`` in place."""
    ring, t, eval_prev = state.ring, state.t, state.eval_prev
    dev = ring.device
    F, N = spec.n_filters, spec.block_length
    ys, done = [], []
    for stage in spec.stages:
        idx = tuple(stage.idx.tolist())
        rows = _index(idx, dev)
        mixed = partconv.complex_mix(ctrl.in_mix[rows], X)    # [Fs, 2, N]
        if stage.casc_local.size:
            # the mixed spectra of the earlier stages' filters that feed
            # this one, contracted stage by stage in stage order
            cidx = _index(tuple(stage.idx[stage.casc_local].tolist()), dev)
            z = None
            for prows, py in zip(done, ys):
                zc = partconv.complex_mix(
                    ctrl.fmix[cidx[:, None], prows[None, :]], py)
                z = zc if z is None else z + zc
            slots = _index(tuple(stage.casc_slots.tolist()), dev)
            e, tails = partconv.convolve_eval(z, eval_prev[slots])
            eval_prev.index_copy_(0, slots, tails)
            mixed.index_add_(0, _index(tuple(stage.casc_local.tolist()), dev),
                             e)
        # the ring takes the tapped spectra: a mutation persists in its
        # history, as the reference's in-place cbuf[n][curblock]
        # (bfrun.c:1688-1690)
        mixed = _tap(taps, "pre_convolve", mixed, stage.idx)
        full = idx == tuple(range(F))
        _write_ring(ring, mixed, t, ctrl.delay, uniform_delay,
                    None if full else rows)
        rows32 = _index(idx, dev, torch.int32)
        if stage.any_crossfade and xfade_now:
            y_new, y_old = _xfade_macs(ring, bank, rows32, ctrl, t, uniform)
            y_xf = partconv.crossfade_spectra(y_old, y_new, N)
            y = torch.where(ctrl.xfade[rows][:, None, None] > 0, y_xf, y_new)
        else:
            y = mac(ring, bank, rows32, ctrl.coeff_idx, ctrl.mask, t,
                    uniform)                                # [Fs, 2, N]
        # the filter's result, as the JAX package hands it (the reference
        # hands the ring block, docs/PARITY.md); later stages mix the
        # tapped spectra
        y = _tap(taps, "post_convolve", y, stage.idx)
        ys.append(y)
        done.append(rows)
    y_all = ys[0] if len(ys) == 1 else torch.cat(ys, dim=0)
    order = np.concatenate([s.idx for s in spec.stages])
    if not np.array_equal(order, np.arange(F)):
        y_all = y_all[_index(tuple(np.argsort(order).tolist()), dev)]
    return y_all


def _xfade_macs(ring, bank, rows32, ctrl: StepCtrl, t, uniform: bool):
    """A crossfade block's two MACs of the filters ``rows32``: ``(y_new,
    y_old)`` against the current and the previous controls. Float32 runs
    the dual MAC, one pass over the ring; float64 runs ``mac`` twice,
    the new set first, as the JAX package's float64 step runs its dense
    ``run_mac`` twice (the core makes each set of the dual equal to the
    single MAC, so no result depends on the choice)."""
    if ring.dtype == torch.float64:
        return (mac(ring, bank, rows32, ctrl.coeff_idx, ctrl.mask, t,
                    uniform),
                mac(ring, bank, rows32, ctrl.prev_idx, ctrl.prev_mask, t,
                    uniform))
    return mac_dual(ring, bank, rows32, ctrl.coeff_idx, ctrl.mask,
                    ctrl.prev_idx, ctrl.prev_mask, t, uniform)


def _fused_xfade(spec: GraphSpec, ctrl: StepCtrl, bank: torch.Tensor,
                 ring: torch.Tensor, t: torch.Tensor,
                 uniform: bool) -> torch.Tensor:
    """The fused time-domain crossfade of compile.py:353-416 for a single
    full stage (the ring already holds the block): the two MACs
    (``_xfade_macs``), then the three mixed spectra -- old and new
    products of the crossfading filters, new products of the others -- in
    two matmuls of the real type, one batched valid-half inverse
    transform, and the linear ramp in time,
    ``y = a (1 - r) + b r + c``. The output mix commutes with the
    transforms, so this equals ``crossfade_spectra`` followed by the mix
    up to the removed transform round trip's rounding."""
    N, C_out = spec.block_length, spec.n_outputs
    rows32 = _index(tuple(range(spec.n_filters)), ring.device, torch.int32)
    y_new, y_old = _xfade_macs(ring, bank, rows32, ctrl, t, uniform)
    sel = (ctrl.xfade > 0).to(y_new.dtype)                  # [F]
    w_sel = ctrl.out_mix * sel[None, :]
    w_rest = ctrl.out_mix - w_sel
    o_old = partconv.complex_mix(w_sel, y_old)              # [C_out, 2, N]
    o_new = partconv.complex_mix(torch.cat([w_sel, w_rest], dim=0), y_new)
    tv = partconv.irfft_planes_valid(torch.cat([o_old, o_new], dim=0))
    a, b, c = tv[:C_out], tv[C_out:2 * C_out], tv[2 * C_out:]
    r = partconv.xfade_ramp(N, tv.dtype, tv.device)
    return a * (1.0 - r) + b * r + c


def step_impl(spec: GraphSpec, state: StepState, ctrl: StepCtrl,
              bank: torch.Tensor, x: torch.Tensor, uniform: bool = False,
              uniform_delay: bool = False, xfade_now: bool = False,
              taps=None):
    """One block: x [C_in, N] -> (state', y [C_out, N]).

    ``uniform``: the host asserts every filter shares one coefficient row
    and mask row, and one previous row and mask
    (RuntimeControl.snapshot_uniform), so the kernels read one shared bank
    row per set. ``uniform_delay``: every filter shares one pre-delay, so
    a ring write that covers every filter is one slice at a scalar slot
    instead of a per-filter scatter. Both give the same values as the
    general form. ``xfade_now``: the host asserts that ``ctrl.xfade``
    marks a crossfade on this block (RuntimeControl.snapshot_xfade);
    False asserts it is all zero. ``taps``: the frequency-domain hooks
    (see the module docstring), or None.

    The ring and the cascade tails are updated in place (see the module
    docstring); nothing here synchronises with the host but the taps."""
    check_supported(spec)
    frame = _gate(spec, ctrl, torch.cat([state.prev_in, x], dim=-1))
    X = partconv.rfft_planes(frame)                         # [C_in, 2, N]
    X = _tap(taps, "input_freqd", X, np.arange(spec.n_inputs))
    ring, t = state.ring, state.t
    new_state = StepState(prev_in=x, ring=ring, eval_prev=state.eval_prev,
                          t=t + 1)
    td_xfade = fused_xfade_route(spec, xfade_now, taps)
    if td_xfade or fused_mix_route(spec, xfade_now, taps):
        mixed = partconv.complex_mix(ctrl.in_mix, X)        # [F, 2, N]
        # the block lands at each filter's delayed slot BEFORE the MAC
        # reads the ring
        _write_ring(ring, mixed, t, ctrl.delay, uniform_delay)
        if td_xfade:
            return new_state, _fused_xfade(spec, ctrl, bank, ring, t,
                                           uniform)
        # at big shapes mac_mix launches the bin-tiled kernel (tiled_route)
        out_spec = mac_mix(ring, bank, ctrl.coeff_idx, ctrl.mask, t,
                           ctrl.out_mix, uniform)           # [C_out, 2, N]
    else:
        y_all = _stage_loop(spec, state, ctrl, bank, X, uniform,
                            uniform_delay, xfade_now, taps)  # [F, 2, N]
        out_spec = _tap(taps, "output_freqd",
                        partconv.complex_mix(ctrl.out_mix, y_all),
                        np.arange(spec.n_outputs))
    return new_state, partconv.irfft_planes_valid(out_spec)  # [C_out, N]


# --- the grouped offline dispatch ------------------------------------------
#
# The VMEM arithmetic below is copied from brutefir_tpu/ops/pallas_mac.py
# (_group_vmem_units :858, _group_tiles :869, group_mix_fusable :896,
# _group_unfused_vmem :1011, group_unfused_fusable :1018) as plain
# arithmetic with the default tiles (the TPU's tile knobs are not read).
# These are the budgets of the TPU's 16 MiB of scoped VMEM; the card has no
# such limit. They are kept so that one config takes the same group size
# and the same form in both packages: the form fixes the summation order of
# the output mix (in the fused kernel, or as a matmul outside), so the two
# packages stay comparable block for block. Retuning them for the card is
# later work.


def _group_vmem_units(G: int, B: int, Rc: int, Fc: int, C_out: int) -> int:
    return (2 * G * C_out + G * Fc + 4 * B + 4 * (G - 1)) * 2 * Rc * 128 * 4


def _group_tiles(G: int, F: int, B: int, R: int, C_out: int):
    for rc in (8, R):
        for fc in (128, 64, 32, 16, 8):
            if (R % rc == 0 and (rc % 8 == 0 or rc == R) and F % fc == 0
                    and _group_vmem_units(G, B, rc, fc, C_out)
                    <= _VMEM_BUDGET):
                return rc, fc
    return R, F


def group_mix_fusable(G: int, F: int, B: int, K: int, C_out: int) -> bool:
    """The JAX package's test for its fused G-block MAC + mix kernel."""
    if K % 128 != 0 or G < 2:
        return False
    Rc, Fc = _group_tiles(G, F, B, K // 128, C_out)
    return _group_vmem_units(G, B, Rc, Fc, C_out) <= _VMEM_BUDGET


def group_unfused_fusable(G: int, B: int, K: int) -> bool:
    """The JAX package's test for its unfused G-block MAC kernel."""
    if K % 128 != 0 or G < 2:
        return False
    return (4 * B + 2 * (G - 1) + 2 * G) * 2 * K * 4 <= _VMEM_BUDGET


def _group_fused(spec: GraphSpec, G: int) -> bool:
    """The form a group of G takes: the fused MAC + mix kernel, or the
    unfused grouped MAC with the output mix outside
    (BRUTEFIR_TPU_GROUP_FORM=unfused forces the latter)."""
    return (os.environ.get("BRUTEFIR_TPU_GROUP_FORM", "") != "unfused"
            and group_mix_fusable(G, spec.n_filters, spec.n_blocks,
                                  spec.n_bins, spec.n_outputs))


def group_size(spec: GraphSpec, m: int) -> int:
    """Blocks per group for a batch of m blocks with frozen controls:
    the twin of ``group_size`` in brutefir_tpu/graph/compile.py:536-607
    with the JAX package's kernel MAC, no spectral taps and no mesh.
    Returns 1 when the batch runs block by block.

    ``BRUTEFIR_TPU_PAIR`` sets the group size (default 4; 0 or 1 turn
    grouping off; ``force[:G]`` groups at any shape, default G = 2).
    Without force only big shapes group:
    ``(C_out + 4 B) * 2 * K * 4 > 12 MiB``. G falls until it divides m
    and a form fits: the fused form at any G, the unfused form at G > 2
    or under ``BRUTEFIR_TPU_GROUP_FORM=unfused``. A float64 graph never
    groups (``force`` included): the JAX package's grouped dispatch wants
    its Pallas MAC, which wants float32."""
    if spec.real_dtype != np.float32:
        return 1
    env = os.environ.get("BRUTEFIR_TPU_PAIR", "4")
    force = env.startswith("force")
    try:
        G = int(env.split(":", 1)[1]) if force and ":" in env else (
            2 if force else int(env))
    except ValueError:
        G = 2
    if G in (0, 1):
        return 1
    if os.environ.get("BRUTEFIR_TPU_FUSED_MIX", "1") == "0":
        # the block-by-block step leaves the fused kernel too
        # (fused_mix_route), and so does the grouped dispatch
        return 1
    if not (spec.tileable and spec.single_full_stage):
        return 1
    B, K = spec.n_blocks, spec.n_bins
    if not force and (spec.n_outputs + 4 * B) * 2 * K * 4 <= _VMEM_BUDGET:
        return 1
    unfused_only = os.environ.get("BRUTEFIR_TPU_GROUP_FORM", "") == "unfused"
    while G >= 2:
        if m % G == 0 and (
                _group_fused(spec, G)
                or ((G > 2 or unfused_only)
                    and group_unfused_fusable(G, B, K))):
            return G
        G -= 1
    return 1


def group_step_impl(spec: GraphSpec, state: StepState, ctrl: StepCtrl,
                    bank: torch.Tensor, xs, uniform_delay: bool = False):
    """G = len(xs) consecutive blocks with one pass over the ring and the
    bank: the twin of ``_group_step_impl`` (brutefir_tpu/graph/
    compile.py:615-752). Only reachable through ``group_size``.

    Per block, the rfft and input mix (with the powersave gate); block
    t's ring write; then ONE kernel launch for the group, which reads the
    ring holding block t's write and no later one, plus the later blocks'
    spectra as ``xnews``; then the ring writes of blocks t+1 .. t+G-1, in
    order. The launch and the later writes run in that order on one
    stream; writing first would let the kernel read a later block where
    an earlier one belongs, in partitions the mask does not zero. The
    group kernels read ``coeff_idx`` per filter even for a shared
    coefficient, as the JAX group path does.

    The fused form mixes in the kernel; the unfused form mixes outside
    with ``partconv.complex_mix`` (an FP32 matmul, where the JAX package
    also leaves it to XLA). Returns (state', [y_0 .. y_{G-1}])."""
    check_supported(spec)
    G = len(xs)
    frames = [torch.cat([p, x], dim=-1)
              for p, x in zip([state.prev_in] + list(xs[:-1]), xs)]
    blks = [partconv.complex_mix(ctrl.in_mix,
                                 partconv.rfft_planes(_gate(spec, ctrl, f)))
            for f in frames]                                # G x [F, 2, N]
    ring, t = state.ring, state.t
    _write_ring(ring, blks[0], t, ctrl.delay, uniform_delay)
    xnews = torch.stack(blks[1:], dim=1)                    # [F, G-1, 2, N]
    if _group_fused(spec, G):
        outs = mac_mix_group(ring, xnews, bank, ctrl.coeff_idx, ctrl.mask,
                             t, ctrl.out_mix, ctrl.delay)
    else:
        ys = mac_group(ring, xnews, bank, ctrl.coeff_idx, ctrl.mask, t,
                       ctrl.delay)
        outs = [partconv.complex_mix(ctrl.out_mix, y) for y in ys]
    for g in range(1, G):
        _write_ring(ring, blks[g], t + g, ctrl.delay, uniform_delay)
    ys = [partconv.irfft_planes_valid(o) for o in outs]     # G x [C_out, N]
    return StepState(prev_in=xs[-1], ring=ring, eval_prev=state.eval_prev,
                     t=t + G), ys
