"""Carry the JAX package's weights, state and controls over to the port.

The "weights" of this system are the coefficient bank and its state is
the spectra ring plus the overlap tails, the device-IO state (dither
pointers and feedback, delay windows, subdelay rests) and, on the host
codec path, the host IO state (delay lines, dither states, overflow
meters, subdelay rests). The JAX
package keeps ring and bank in the lane-tiled ``[.., 2, N/128, 128]``
layout when its Pallas MAC runs, or flat ``[.., 2, N]`` otherwise; the
port always keeps them flat.
Every function takes numpy arrays (``np.asarray`` of the JAX values) and
a target device, so both packages can start from one mid-stream state.
The results are copies: the port writes its ring in place, and a view of
a JAX buffer must never be written. Real arrays keep their dtype:
float32 from a float32 engine, float64 from a ``float_bits: 64`` one
(unrounded).
"""

from __future__ import annotations

import numpy as np
import torch

from .graph.compile import StepCtrl, StepState


def _real(a) -> np.ndarray:
    """A contiguous copy of a real array, float64 kept, anything else
    float32."""
    a = np.asarray(a)
    dt = np.float64 if a.dtype == np.float64 else np.float32
    return np.array(a, dt, order="C", copy=True)


def _flat(a: np.ndarray) -> np.ndarray:
    """[X, B, 2, N] or tiled [X, B, 2, R, 128] -> contiguous [X, B, 2, N]."""
    a = np.asarray(a)
    if a.ndim == 5:
        a = a.reshape(a.shape[:3] + (a.shape[3] * a.shape[4],))
    if a.ndim != 4 or a.shape[2] != 2:
        raise ValueError(f"expected [X, B, 2, N] or [X, B, 2, R, 128] "
                         f"spectra, got shape {a.shape}")
    return _real(a)


def bank_from_jax(np_bank, device) -> torch.Tensor:
    """Coefficient bank: flat or tiled float planes -> flat [E, B, 2, N]."""
    return torch.as_tensor(_flat(np_bank), device=device)


def state_from_jax(prev_in, ring, eval_prev, t, device) -> StepState:
    """StepState fields (numpy) -> the port's StepState on ``device``.
    ``eval_prev`` holds the cascade tails, one [N] row per filter with
    filter inputs (none for a graph without cascades)."""
    prev_in = _real(prev_in)
    eval_prev = _real(eval_prev)
    if eval_prev.ndim != 2 or eval_prev.shape[1] != prev_in.shape[-1]:
        raise ValueError(f"eval_prev must be [n_casc, {prev_in.shape[-1]}], "
                         f"got shape {eval_prev.shape}")
    return StepState(
        prev_in=torch.as_tensor(prev_in, device=device),
        ring=torch.as_tensor(_flat(ring), device=device),
        eval_prev=torch.as_tensor(eval_prev, device=device),
        t=torch.tensor(int(np.asarray(t)), dtype=torch.int32, device=device),
    )


def ctrl_from_jax(ctrl, device) -> StepCtrl:
    """A StepCtrl-shaped tuple of numpy-convertible arrays -> the port's
    StepCtrl on ``device``: every field the port's step reads, the
    crossfade fields (``prev_idx``, ``prev_mask``, ``xfade``) included,
    same dtypes (float64 fields of a float64 engine stay float64). The
    JAX ``any_xfade`` scalar is left behind: the port's host passes
    ``xfade_now`` to the step instead."""
    out = {}
    for name in StepCtrl._fields:
        a = np.asarray(getattr(ctrl, name))
        out[name] = torch.as_tensor(np.array(a, order="C", copy=True),
                                    device=device)
    return StepCtrl(**out)


# DeviceIO.dstate keys: the dither pointers and last bytes (int32), its
# error feedback, the integer delay windows, the subdelay rests (real)
_DSTATE_INT = {"ptr", "last"}
_DSTATE_REAL = {"sf", "dlw_in", "dlw_out", "sdr_in", "sdr_out"}


def dstate_from_jax(dstate, device) -> dict:
    """The JAX package's ``DeviceIO.dstate`` (a dict of arrays) -> the
    port's, on ``device``: a stream the JAX engine started continues in
    the port from the same dither, delay and subdelay state. Raises on a
    key the port does not know, so no state is dropped."""
    unknown = sorted(set(dstate) - _DSTATE_INT - _DSTATE_REAL)
    if unknown:
        raise ValueError(f"unknown device-IO state keys {unknown}")
    return {k: torch.as_tensor(np.array(v, np.int32, copy=True)
                               if k in _DSTATE_INT else _real(v),
                               device=device)
            for k, v in dstate.items()}


# DelayLine's machine state (core/delayline.py): scalars, then buffers
_DL_SCALARS = ("maxdelay", "delay", "_cap", "_frag", "_n_rest", "_n_fbufs",
               "_curbuf")


def _copy_buf(v):
    if v is None:
        return None
    if isinstance(v, list):
        return [np.array(b, copy=True) for b in v]
    return np.array(v, copy=True)


def host_io_state_from_jax(jax_engine, port_engine) -> None:
    """Copy the JAX engine's host IO state into the port engine of the
    same config, so that a run the JAX engine began on its host codec
    path goes on in the port: every ``DelayLine``'s machine (cursor,
    rest and buffers), every ``DitherState``'s table pointer and error
    feedback (``sf``) with the shared table's first byte (a wrap rewrites
    it), the ``Overflow`` meters and the ``SubsampleDelay`` rests. Copies,
    never views."""
    for io in (0, 1):
        jl, tl = jax_engine.dlines[io], port_engine.dlines[io]
        if len(jl) != len(tl):
            raise ValueError(f"delay lines differ in number on side {io}")
        for a, b in zip(jl, tl):
            for name in _DL_SCALARS:
                setattr(b, name, getattr(a, name))
            for name in ("_fbufs", "_rbuf", "_shortbuf"):
                setattr(b, name, _copy_buf(getattr(a, name)))
    if len(jax_engine.dither_state) != len(port_engine.dither_state):
        raise ValueError("dither states differ in number")
    for a, b in zip(jax_engine.dither_state, port_engine.dither_state):
        if (a is None) != (b is None):
            raise ValueError("dithered channels differ")
        if a is not None:
            b.randtab_ptr = a.randtab_ptr
            b.sf[:] = a.sf
            b.table.tab[0] = a.table.tab[0]
    for a, b in zip(jax_engine._phys_overflow, port_engine._phys_overflow):
        b.n_overflows, b.intlargest, b.largest = (
            a.n_overflows, a.intlargest, a.largest)
    js, ts = jax_engine.subdelay, port_engine.subdelay
    if (js is None) != (ts is None):
        raise ValueError("subsample delays differ")
    if js is not None:
        for io in (0, 1):
            if set(js.rest[io]) != set(ts.rest[io]):
                raise ValueError(f"subdelay channels differ on side {io}")
            for ch, rest in js.rest[io].items():
                ts.rest[io][ch] = np.array(rest, copy=True)
