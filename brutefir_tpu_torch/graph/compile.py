"""The per-block device step: ``step_impl(spec, state, ctrl, bank, x)``.

Torch twin of ``_step_impl`` in :mod:`brutefir_tpu.graph.compile`
(compile.py:241-533). One block is

    frame = [prev_in, x] -> (powersave gate) -> M-point FFT -> per
    stage: input mix (+ cascade input) -> forward glue + ring write at
    (t + delay[f]) % B -> MAC -> output mix -> valid-half irfft
    -> y [C_out, N]

The forward transform is split around the input mix (the **points
route**): cuFFT's M-point transform of the frame (``fft_glue.
fft_points``), the mix on those complex spectra (``partconv.
mix_points``; the glue is linear bin by bin and the mix real, so they
commute), and one kernel, ``fft_glue.glue_fwd_ring``, that glues the
mixed spectra, casts them to the ring's dtype and writes each filter's
row at its slot. The JAX package rfft's, mixes the packed planes and
writes the ring with XLA's ops; the port's words differ from it by the
rounding of the moved glue. Under a mesh the mixed spectra are glued into
planes on the first device and split into the shards' rings (a bin shard
lacks the mirror bins the glue reads); under taps the **planes route**
keeps the JAX package's order, as the hooks see packed planes.

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

Under ``BRUTEFIR_TPU_RING_DTYPE=bf16`` (a float32 graph; read once, by
:func:`read_ring_dtype`, when the engine is built) the ring is stored as
bfloat16 (``init_state(..., ring_dtype)``): every ring write casts its
spectra to the ring's dtype (round to nearest even, as the JAX package's
``astype``), the grouped dispatch casts its ``xnews`` so, and the MAC
kernels widen the ring back to float32 on load. Everything else stays in
the graph's real type.

Under a mesh (``mesh=``, ``parallel/mesh.py``) the ring and the bank are
:class:`~brutefir_tpu_torch.parallel.mesh.Sharded` over the ('f', 'sp')
shards and ``ctrl`` is a :class:`MeshCtrl` (``place_ctrl``); the step
follows the JAX package's mesh branches (compile.py:179-235, 318-330,
388-392, 473-478, 570-605, 708-717). The transforms, the input mix, the
cascade input and the output mix of the stage loop run on the mesh's
first device; the mixed spectra are split into each shard's ring, and
the MACs run per shard through ``ops/mac_shard.py``: the fused MAC + mix
where ``shardable`` holds (the shard sizes ``F/f`` and ``K/sp`` decide
``mix_fusable``), the per-filter MAC of each stage's rows otherwise (the
JAX package's dense MAC, which XLA shards), the dual MAC on a crossfade
block, the grouped MAC with the mix outside. Each shard's ring write,
its part of the grouped dispatch's ``xnews`` (``split``) and its MAC run
in the shard's cell context (``Mesh.cell``: on the card a stream of its
own), each per-cell loop ending with the join.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..ops import fft_glue, partconv
from ..ops.partconv import static_index as _index
from ..ops.mac import mac
from ..ops.mac_dual import mac_dual
from ..ops.mac_group import mac_group, mac_mix_group
from ..ops.mac_mix import mac_mix, tiled_route
from ..ops.mac_shard import (mac_dual_shard, mac_group_shard, mac_mix_shard,
                             mac_shard)
from ..parallel.mesh import available, shardable, split, to_device
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


class MeshCtrl(NamedTuple):
    """A StepCtrl on a mesh: ``full``, every control on the mesh's first
    device (the input mix, the filter mix, the output mix, the crossfade
    selection, the powersave gate run there), and ``shards``, a StepCtrl
    of :class:`~brutefir_tpu_torch.parallel.mesh.Sharded`: the per-filter
    controls split by rows over 'f' (``delay``, ``coeff_idx``, ``mask``,
    ``prev_idx``, ``prev_mask``, ``xfade``) and ``out_mix`` by its filter
    columns, the rest None (the JAX package's ``step_shardings``)."""
    full: StepCtrl
    shards: StepCtrl


def place_ctrl(mesh, ctrl: StepCtrl) -> MeshCtrl:
    """``ctrl`` on ``mesh``: its tensors on the first device and each
    shard's rows on the shard's device."""
    full = StepCtrl(*(to_device(v, mesh.first) for v in ctrl))
    rows = {k: split(mesh, getattr(full, k), 0)
            for k in ("delay", "coeff_idx", "mask", "prev_idx", "prev_mask",
                      "xfade")}
    return MeshCtrl(full, StepCtrl(
        in_mix=None, fmix=None, out_mix=split(mesh, full.out_mix, 1),
        ps_thresh=None, **rows))


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


def read_ring_dtype(spec: GraphSpec) -> torch.dtype:
    """The ring's dtype: ``torch.bfloat16`` under
    ``BRUTEFIR_TPU_RING_DTYPE=bf16`` (or ``bfloat16``) on a float32 graph,
    as the JAX package's ``CompiledGraph`` reads it (compile.py:84-95);
    else the graph's real type (a float64 graph ignores the knob)."""
    env = os.environ.get("BRUTEFIR_TPU_RING_DTYPE", "")
    if env in ("bf16", "bfloat16") and spec.real_dtype == np.float32:
        return torch.bfloat16
    return real_dtype(spec)


def init_state(spec: GraphSpec, device,
               ring_dtype: torch.dtype = None) -> StepState:
    """Zero state; the ring of ``ring_dtype`` (default: the graph's real
    type; the engine passes its :func:`read_ring_dtype`)."""
    rd = real_dtype(spec)
    N = spec.block_length
    return StepState(
        prev_in=torch.zeros((spec.n_inputs, N), dtype=rd, device=device),
        ring=torch.zeros(spec.ring_shape(), dtype=ring_dtype or rd,
                         device=device),
        eval_prev=torch.zeros((spec.n_casc, N), dtype=rd, device=device),
        t=torch.zeros((), dtype=torch.int32, device=device),
    )


def make_ctrl(spec: GraphSpec, in_mix, out_mix, delay, coeff_idx, mask,
              ps_thresh=None, device=None, fmix=None, prev_idx=None,
              prev_mask=None, xfade=None, mesh=None):
    """Assemble a StepCtrl on ``device`` from host arrays (default:
    powersave gate off, no filter -> filter edges, no crossfade: the
    previous coefficient is the current one); under ``mesh`` a
    :class:`MeshCtrl`, each shard's rows on its device."""
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

    if mesh is not None:
        device = mesh.first
    ctrl = StepCtrl(
        in_mix=real(in_mix), fmix=real(fmix), out_mix=real(out_mix),
        delay=idx(delay), coeff_idx=idx(coeff_idx), mask=real(mask),
        prev_idx=idx(prev_idx), prev_mask=real(prev_mask),
        xfade=real(xfade), ps_thresh=real(ps_thresh),
    )
    return ctrl if mesh is None else place_ctrl(mesh, ctrl)


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
                    taps=None, mesh=None) -> bool:
    """Whether a block takes the fused MAC + output mix (``mac_mix``, or
    ``mac_mix_shard`` under ``mesh``) rather than the stage loop or the
    fused time-domain crossfade: the JAX package's ``fused_mix``
    predicate (compile.py:318-330). No frequency-domain taps, a single
    stage of every filter in order, not crossfading this block, at a
    shape where the JAX package runs its Pallas kernels
    (``pallas_available``: K a multiple of 128, K >= 256; under a mesh
    ``shardable``, the same per bin shard; elsewhere it runs the dense
    stage loop) and its fused kernel fits the shard (``mix_fusable`` at
    F/f filters, K/sp bins), unless ``BRUTEFIR_TPU_FUSED_MIX=0``; and a
    float32 graph (``pallas_available`` wants float32: a float64 graph
    runs the JAX package's dense MAC in the stage loop). The card needs
    none of these limits; they are kept so that a config takes the same
    route, and so the same summation order, in both packages."""
    K, F = spec.n_bins, spec.n_filters
    f = sp = 1
    if mesh is not None:
        if not shardable(mesh, F, K, spec.real_dtype):
            return False
        f, sp = mesh.shape["f"], mesh.shape["sp"]
    return (not taps and spec.single_full_stage
            and available(K, spec.real_dtype)
            and not (spec.stages[0].any_crossfade and xfade_now)
            and mix_fusable(F // f, spec.n_blocks, K // sp,
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


def _write_ring(ring, blk, t, delay, uniform_delay: bool, rows=None,
                mesh=None) -> None:
    """Write spectra [Fs, 2, N] in place at each filter's delayed slot
    (t + delay[f]) % B (the cbuf curblock + delay of bfrun.c:1688-1690).
    ``rows``: the filters of ``blk`` (a long index), or None for every
    filter in order; then one slice at a scalar slot when every filter
    shares one delay, else a per-filter scatter (compile.py:260-274).
    Under ``mesh``: ``ring`` and ``delay`` Sharded, ``blk`` on the first
    device, ``rows`` the stage's filters as a numpy vector; each shard
    takes its rows and bins of ``blk``. ``blk`` is cast to the ring's
    dtype (a bfloat16 ring, compile.py:267)."""
    if mesh is not None:
        _write_ring_mesh(mesh, ring, blk, t, delay, uniform_delay, rows)
        return
    blk = blk.to(ring.dtype)
    B = ring.shape[1]
    if rows is None and uniform_delay:
        wpos0 = torch.remainder(t + delay[0], B).reshape(1).long()
        ring.index_copy_(1, wpos0, blk[:, None])
        return
    if rows is None:
        rows = _index(tuple(range(ring.shape[0])), ring.device)
    wpos = torch.remainder(t + delay[rows], B).long()
    ring.index_put_((rows, wpos), blk)


def _write_ring_mesh(mesh, ring, blk, t, delay, uniform_delay: bool,
                     rows=None) -> None:
    """``_write_ring`` on each shard, in the cell's context (the
    ``Mesh.cell`` of ``parallel/mesh.py``): its rows of ``blk`` (those of
    the stage ``rows`` it holds), its bins, its delays, at its device;
    then the cells are joined."""
    K = ring.shape[3]
    for i, (r0, r1) in enumerate(mesh.rows(ring.shape[0])):
        if rows is None:
            pos = local = None
            if r1 <= r0:
                continue
        else:
            sel = np.flatnonzero((rows >= r0) & (rows < r1))
            if sel.size == 0:
                continue
            pos = _index(tuple(sel.tolist()), blk.device)
        for j, (k0, k1) in enumerate(mesh.bins(K)):
            if k1 <= k0:
                continue
            with mesh.cell(i, j):
                dev = mesh.devices[i, j]
                sub = (blk[r0:r1, :, k0:k1] if pos is None
                       else blk[pos, :, k0:k1])
                if pos is not None:
                    local = _index(tuple((rows[sel] - r0).tolist()), dev)
                _write_ring(ring.parts[i][j], to_device(sub, dev),
                            to_device(t, dev), delay.parts[i][j],
                            uniform_delay, local)
    mesh.join()


def _mix(mix: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """The input mix of the spectra ``S``: M-point spectra (complex
    ``[C, M]``, the points route) or packed planes (``[C, 2, N]``, the
    planes route under taps)."""
    return (partconv.mix_points(mix, S) if S.is_complex()
            else partconv.complex_mix(mix, S))


def _land(ring, S, t, delay, uniform_delay: bool, rows=None, mesh=None,
          taps=None, tap_idx=None) -> None:
    """Land a stage's mixed spectra ``S`` in the ring at each filter's
    delayed slot; ``rows`` the stage's filters as a numpy vector, or None
    for every filter in order. M-point spectra on one device take
    ``fft_glue.glue_fwd_ring``, the glue, the cast and the slot write in
    one launch; under ``mesh`` they are glued into planes on the first
    device (a bin shard lacks the mirror bins the glue reads) and split by
    ``_write_ring``. Packed planes (the planes route) go through the
    ``pre_convolve`` tap (with ids ``tap_idx``), then ``_write_ring``: the
    ring takes the tapped spectra, so a mutation persists in its history,
    as the reference's in-place cbuf[n][curblock] (bfrun.c:1688-1690)."""
    if S.is_complex() and mesh is None:
        r32 = None if rows is None else _index(tuple(rows.tolist()),
                                               ring.device, torch.int32)
        fft_glue.glue_fwd_ring(S, ring, r32, delay, t)
        return
    if S.is_complex():
        S = fft_glue.glue_fwd(S)
    else:
        S = _tap(taps, "pre_convolve", S, tap_idx)
    if rows is not None and mesh is None:
        rows = _index(tuple(rows.tolist()), ring.device)
    _write_ring(ring, S, t, delay, uniform_delay, rows, mesh)


def _mac(ring, bank, idx: np.ndarray, coeff_idx, mask, t, uniform: bool,
         mesh=None) -> torch.Tensor:
    """The unfused MAC of the stage filters ``idx``: ``mac`` on the ring
    in place, or under ``mesh`` ``mac_shard`` (per-filter controls, as the
    JAX shard wrapper and dense MAC have no uniform form)."""
    if mesh is not None:
        return mac_shard(mesh, ring, bank, idx, coeff_idx, mask, t)
    rows32 = _index(tuple(idx.tolist()), ring.device, torch.int32)
    return mac(ring, bank, rows32, coeff_idx, mask, t, uniform)


def _stage_loop(spec: GraphSpec, state: StepState, ctrl: StepCtrl,
                bank: torch.Tensor, X: torch.Tensor, uniform: bool,
                uniform_delay: bool, xfade_now: bool,
                taps=None, mesh=None) -> torch.Tensor:
    """The stage loop of compile.py:418-533: per stage, the input mix of
    its filters, the cascade input of those with filter inputs, the
    ``pre_convolve`` tap, the ring write and the unfused MAC of its
    filters (read in place in the ring), the ``post_convolve`` tap; then
    every filter's spectra [F, 2, N] in filter order. ``X``: the input's
    M-point spectra (the points route: the mixes and the cascade input
    stay M-point spectra up to the ring write, ``_land``) or its packed
    planes (the planes route, under taps). On a crossfade
    block a stage holding a crossfading filter runs the dual MAC and
    ``crossfade_spectra`` instead, and keeps the ramped spectra of the
    filters whose ``xfade`` is set (compile.py:456-505 without the
    cond). Updates the ring and ``state.eval_prev`` in place. Under
    ``mesh`` (``ctrl`` a MeshCtrl) the mixes, the cascade input and the
    crossfade ramp run on the first device, the ring writes and the MACs
    per shard, and every stage's spectra come back to the first device."""
    ring, t, eval_prev = state.ring, state.t, state.eval_prev
    full = ctrl.full if mesh is not None else ctrl
    rctrl = ctrl.shards if mesh is not None else ctrl
    dev = eval_prev.device
    F, N = spec.n_filters, spec.block_length
    ys, done = [], []
    for stage in spec.stages:
        idx = tuple(stage.idx.tolist())
        rows = _index(idx, dev)
        mixed = _mix(full.in_mix[rows], X)          # [Fs, M] or [Fs, 2, N]
        if stage.casc_local.size:
            _cascade_input(stage, full.fmix, done, ys, eval_prev, mixed)
        _land(ring, mixed, t, rctrl.delay, uniform_delay,
              None if idx == tuple(range(F)) else stage.idx, mesh, taps,
              stage.idx)
        if stage.any_crossfade and xfade_now:
            y_new, y_old = _xfade_macs(ring, bank, stage.idx, ctrl, t,
                                       uniform, mesh)
            y_xf = partconv.crossfade_spectra(y_old, y_new, N)
            y = torch.where(full.xfade[rows][:, None, None] > 0, y_xf, y_new)
        else:
            y = _mac(ring, bank, stage.idx, rctrl.coeff_idx, rctrl.mask, t,
                     uniform, mesh)                         # [Fs, 2, N]
        # the filter's result, as the JAX package hands it (the reference
        # hands the ring block, docs/PARITY.md); later stages mix the
        # tapped spectra
        y = _tap(taps, "post_convolve", y, stage.idx)
        ys.append(y)
        done.append(rows)
    return _in_filter_order(spec, ys, dev)


def _cascade_input(stage, fmix, done, ys, eval_prev, mixed) -> None:
    """Add the cascade input of ``stage``'s filters that take other
    filters' outputs to their rows of ``mixed`` in place: the spectra
    ``ys`` of the earlier stages (their filters ``done``) mixed by
    ``fmix`` stage by stage in stage order, then ``convolve_eval`` of the
    sum against the cascade tails ``eval_prev`` (updated in place), in
    the domain of ``mixed`` (M-point spectra or packed planes)."""
    dev = eval_prev.device
    cidx = _index(tuple(stage.idx[stage.casc_local].tolist()), dev)
    z = None
    for prows, py in zip(done, ys):
        zc = partconv.complex_mix(fmix[cidx[:, None], prows[None, :]], py)
        z = zc if z is None else z + zc
    slots = _index(tuple(stage.casc_slots.tolist()), dev)
    ev = (partconv.convolve_eval_points if mixed.is_complex()
          else partconv.convolve_eval)
    e, tails = ev(z, eval_prev[slots])
    eval_prev.index_copy_(0, slots, tails)
    local = _index(tuple(stage.casc_local.tolist()), dev)
    if mixed.is_complex():
        torch.view_as_real(mixed).index_add_(0, local, torch.view_as_real(e))
    else:
        mixed.index_add_(0, local, e)


def _in_filter_order(spec: GraphSpec, ys, dev) -> torch.Tensor:
    """The stages' spectra ``ys`` as one [F, 2, N] tensor in filter
    order."""
    y_all = ys[0] if len(ys) == 1 else torch.cat(ys, dim=0)
    order = np.concatenate([s.idx for s in spec.stages])
    if not np.array_equal(order, np.arange(spec.n_filters)):
        y_all = y_all[_index(tuple(np.argsort(order).tolist()), dev)]
    return y_all


def _xfade_macs(ring, bank, idx: np.ndarray, ctrl, t, uniform: bool,
                mesh=None):
    """A crossfade block's two MACs of the filters ``idx``: ``(y_new,
    y_old)`` against the current and the previous controls. Float32 runs
    the dual MAC, one pass over the ring; float64 runs ``mac`` twice,
    the new set first, as the JAX package's float64 step runs its dense
    ``run_mac`` twice (the core makes each set of the dual equal to the
    single MAC, so no result depends on the choice). Under ``mesh`` the
    shard forms (``ctrl`` a MeshCtrl)."""
    c = ctrl.shards if mesh is not None else ctrl
    if ring.dtype == torch.float64:
        return (_mac(ring, bank, idx, c.coeff_idx, c.mask, t, uniform,
                     mesh),
                _mac(ring, bank, idx, c.prev_idx, c.prev_mask, t, uniform,
                     mesh))
    if mesh is not None:
        return mac_dual_shard(mesh, ring, bank, idx, c.coeff_idx, c.mask,
                              c.prev_idx, c.prev_mask, t, uniform)
    rows32 = _index(tuple(idx.tolist()), ring.device, torch.int32)
    return mac_dual(ring, bank, rows32, c.coeff_idx, c.mask, c.prev_idx,
                    c.prev_mask, t, uniform)


def _fused_xfade(spec: GraphSpec, ctrl, bank: torch.Tensor,
                 ring: torch.Tensor, t: torch.Tensor,
                 uniform: bool, mesh=None) -> torch.Tensor:
    """The fused time-domain crossfade of compile.py:353-416 for a single
    full stage (the ring already holds the block): the two MACs
    (``_xfade_macs``), then the three mixed spectra -- old and new
    products of the crossfading filters, new products of the others -- in
    two matmuls of the real type, one batched valid-half inverse
    transform, and the linear ramp in time,
    ``y = a (1 - r) + b r + c``. The output mix commutes with the
    transforms, so this equals ``crossfade_spectra`` followed by the mix
    up to the removed transform round trip's rounding. Under ``mesh`` the
    MACs run per shard and the rest on the first device."""
    N, C_out = spec.block_length, spec.n_outputs
    y_new, y_old = _xfade_macs(ring, bank, np.arange(spec.n_filters), ctrl,
                               t, uniform, mesh)
    full = ctrl.full if mesh is not None else ctrl
    sel = (full.xfade > 0).to(y_new.dtype)                  # [F]
    w_sel = full.out_mix * sel[None, :]
    w_rest = full.out_mix - w_sel
    o_old = partconv.complex_mix(w_sel, y_old)              # [C_out, 2, N]
    o_new = partconv.complex_mix(torch.cat([w_sel, w_rest], dim=0), y_new)
    tv = partconv.irfft_planes_valid(torch.cat([o_old, o_new], dim=0))
    a, b, c = tv[:C_out], tv[C_out:2 * C_out], tv[2 * C_out:]
    r = partconv.xfade_ramp(N, tv.dtype, tv.device)
    return a * (1.0 - r) + b * r + c


def step_impl(spec: GraphSpec, state: StepState, ctrl: StepCtrl,
              bank: torch.Tensor, x: torch.Tensor, uniform: bool = False,
              uniform_delay: bool = False, xfade_now: bool = False,
              taps=None, mesh=None):
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
    (see the module docstring), or None. ``mesh``: the step over a mesh
    (see the module docstring): ``state`` from
    ``ShardedGraph.init_state``, ``ctrl`` a MeshCtrl, ``bank`` Sharded
    over 'sp'; ``x`` and the returned y on the mesh's first device.

    The ring and the cascade tails are updated in place (see the module
    docstring); nothing here synchronises with the host but the taps."""
    check_supported(spec)
    full = ctrl.full if mesh is not None else ctrl
    frame = _gate(spec, full, torch.cat([state.prev_in, x], dim=-1))
    if taps:
        # the planes route: the hooks see packed planes
        X = _tap(taps, "input_freqd", partconv.rfft_planes(frame),
                 np.arange(spec.n_inputs))                  # [C_in, 2, N]
    else:
        X = fft_glue.fft_points(frame)                      # [C_in, M]
    ring, t = state.ring, state.t
    new_state = StepState(prev_in=x, ring=ring, eval_prev=state.eval_prev,
                          t=t + 1)
    td_xfade = fused_xfade_route(spec, xfade_now, taps)
    if td_xfade or fused_mix_route(spec, xfade_now, taps, mesh):
        # the block lands at each filter's delayed slot BEFORE the MAC
        # reads the ring
        rc = ctrl.shards if mesh is not None else ctrl
        _land(ring, _mix(full.in_mix, X), t, rc.delay, uniform_delay,
              mesh=mesh)
        if td_xfade:
            return new_state, _fused_xfade(spec, ctrl, bank, ring, t,
                                           uniform, mesh)
        # at big shapes mac_mix launches the bin-tiled kernel (tiled_route)
        if mesh is not None:
            out_spec = mac_mix_shard(mesh, ring, bank, rc.coeff_idx,
                                     rc.mask, t, rc.out_mix, uniform)
        else:
            out_spec = mac_mix(ring, bank, ctrl.coeff_idx, ctrl.mask, t,
                               ctrl.out_mix, uniform)       # [C_out, 2, N]
    else:
        y_all = _stage_loop(spec, state, ctrl, bank, X, uniform,
                            uniform_delay, xfade_now, taps,
                            mesh)                            # [F, 2, N]
        out_spec = _tap(taps, "output_freqd",
                        partconv.complex_mix(full.out_mix, y_all),
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


def group_size(spec: GraphSpec, m: int, mesh=None) -> int:
    """Blocks per group for a batch of m blocks with frozen controls:
    the twin of ``group_size`` in brutefir_tpu/graph/compile.py:536-607
    with the JAX package's kernel MAC and no spectral taps. Returns 1
    when the batch runs block by block.

    ``BRUTEFIR_TPU_PAIR`` sets the group size (default 4; 0 or 1 turn
    grouping off; ``force[:G]`` groups at any shape, default G = 2).
    Without force only big shapes group:
    ``(C_out + 4 B) * 2 * K * 4 > 12 MiB``. G falls until it divides m
    and a form fits: the fused form at any G, the unfused form at G > 2
    or under ``BRUTEFIR_TPU_GROUP_FORM=unfused``. A float64 graph never
    groups (``force`` included): the JAX package's grouped dispatch wants
    its Pallas MAC, which wants float32. Under ``mesh`` (compile.py:
    570-605) the shape must be ``shardable``, and only the unfused form
    groups, sized at the bin shard's K/sp: the fused form would bury the
    sum over 'f' in the kernel."""
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
    sp = 1
    if mesh is not None:
        if not shardable(mesh, spec.n_filters, K, spec.real_dtype):
            return 1
        sp = mesh.shape["sp"]
    if not force and (spec.n_outputs + 4 * B) * 2 * K * 4 <= _VMEM_BUDGET:
        return 1
    unfused_only = os.environ.get("BRUTEFIR_TPU_GROUP_FORM", "") == "unfused"
    while G >= 2:
        if m % G == 0 and (
                (mesh is None and _group_fused(spec, G))
                or ((G > 2 or unfused_only or mesh is not None)
                    and group_unfused_fusable(G, B, K // sp))):
            return G
        G -= 1
    return 1


class GroupRoute(NamedTuple):
    """The route of a batch: ``G`` blocks a group and the group's
    ``form``: "fused" (``mac_mix_group``), "unfused" (``mac_group``, the
    mix outside) or "none" (G = 1, block by block)."""
    G: int
    form: str

    def __str__(self) -> str:
        return f"G={self.G} {self.form}"


NO_GROUP = GroupRoute(1, "none")


def group_route(spec: GraphSpec, m: int, mesh=None) -> GroupRoute:
    """The route ``group_step_impl`` takes for a batch of m blocks:
    ``group_size``'s G, and the form ``_group_fused`` picks (under a mesh
    always the unfused form)."""
    G = group_size(spec, m, mesh)
    if G < 2:
        return NO_GROUP
    fused = mesh is None and _group_fused(spec, G)
    return GroupRoute(G, "fused" if fused else "unfused")


def group_step_impl(spec: GraphSpec, state: StepState, ctrl: StepCtrl,
                    bank: torch.Tensor, xs, uniform_delay: bool = False,
                    mesh=None):
    """G = len(xs) consecutive blocks with one pass over the ring and the
    bank: the twin of ``_group_step_impl`` (brutefir_tpu/graph/
    compile.py:615-752). Only reachable through ``group_size``.

    Per block, the M-point FFT and the input mix (with the powersave
    gate); block t's ring write (``glue_fwd_ring``); the later blocks'
    spectra glued into ``xnews`` in the ring's dtype (``glue_fwd_into``);
    then ONE kernel launch for the group, which reads the ring holding
    block t's write and no later one, plus ``xnews``; then the ring writes
    of blocks t+1 .. t+G-1, in order, glued again from their spectra (the
    same bits as ``xnews``; under a mesh the planes, split as
    ``_write_ring`` splits them). The launch and the later writes run in
    that order on one stream; writing first would let the kernel read a
    later block where an earlier one belongs, in partitions the mask does
    not zero. The group kernels read ``coeff_idx`` per filter even for a
    shared coefficient, as the JAX group path does.

    The fused form mixes in the kernel; the unfused form mixes outside
    with ``partconv.complex_mix`` (an FP32 matmul, where the JAX package
    also leaves it to XLA). Under ``mesh`` the unfused grouped MAC runs per
    shard (``mac_group_shard``) and the mix on the first device
    (compile.py:708-717). Returns (state', [y_0 .. y_{G-1}])."""
    check_supported(spec)
    G = len(xs)
    full = ctrl.full if mesh is not None else ctrl
    rc = ctrl.shards if mesh is not None else ctrl
    frames = [torch.cat([p, x], dim=-1)
              for p, x in zip([state.prev_in] + list(xs[:-1]), xs)]
    zs = [partconv.mix_points(full.in_mix,
                              fft_glue.fft_points(_gate(spec, full, f)))
          for f in frames]                                  # G x [F, M]
    ring, t = state.ring, state.t
    # the later blocks read the spectra the ring will hold: glued and
    # cast as the ring writes glue and cast them (compile.py:700-702)
    if mesh is not None:
        blks = [fft_glue.glue_fwd(z) for z in zs]           # G x [F, 2, N]
        _write_ring(ring, blks[0], t, rc.delay, uniform_delay, mesh=mesh)
        xnews = torch.stack(blks[1:], dim=1).to(ring.dtype)
    else:
        fft_glue.glue_fwd_ring(zs[0], ring, None, rc.delay, t)
        F, N = spec.n_filters, spec.block_length
        xnews = torch.empty((F, G - 1, 2, N), dtype=ring.dtype,
                            device=ring.device)             # [F, G-1, 2, N]
        for g in range(1, G):
            fft_glue.glue_fwd_into(zs[g], xnews[:, g - 1])
    if mesh is not None:
        ys = mac_group_shard(mesh, ring, split(mesh, xnews, 0, 3), bank,
                             rc.coeff_idx, rc.mask, t, rc.delay)
        outs = [partconv.complex_mix(full.out_mix, y) for y in ys]
    elif _group_fused(spec, G):
        outs = mac_mix_group(ring, xnews, bank, ctrl.coeff_idx, ctrl.mask,
                             t, ctrl.out_mix, ctrl.delay)
    else:
        ys = mac_group(ring, xnews, bank, ctrl.coeff_idx, ctrl.mask, t,
                       ctrl.delay)
        outs = [partconv.complex_mix(ctrl.out_mix, y) for y in ys]
    for g in range(1, G):
        if mesh is not None:
            _write_ring(ring, blks[g], t + g, rc.delay, uniform_delay,
                        mesh=mesh)
        else:
            fft_glue.glue_fwd_ring(zs[g], ring, None, rc.delay, t, dt=g)
    ys = [partconv.irfft_planes_valid(o) for o in outs]     # G x [C_out, N]
    return StepState(prev_in=xs[-1], ring=ring, eval_prev=state.eval_prev,
                     t=t + G), ys
