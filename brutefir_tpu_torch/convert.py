"""Carry the JAX package's weights, state and controls over to the port.

The "weights" of this system are the coefficient bank and its state is
the spectra ring plus the overlap tails. The JAX package keeps ring and
bank in the lane-tiled ``[.., 2, N/128, 128]`` layout when its Pallas MAC
runs, or flat ``[.., 2, N]`` otherwise; the port always keeps them flat.
Every function takes numpy arrays (``np.asarray`` of the JAX values) and
a target device, so both packages can start from one mid-stream state.
The results are copies: the port writes its ring in place, and a view of
a JAX buffer must never be written.
"""

from __future__ import annotations

import numpy as np
import torch

from .graph.compile import StepCtrl, StepState


def _flat(a: np.ndarray) -> np.ndarray:
    """[X, B, 2, N] or tiled [X, B, 2, R, 128] -> contiguous [X, B, 2, N]."""
    a = np.asarray(a)
    if a.ndim == 5:
        a = a.reshape(a.shape[:3] + (a.shape[3] * a.shape[4],))
    if a.ndim != 4 or a.shape[2] != 2:
        raise ValueError(f"expected [X, B, 2, N] or [X, B, 2, R, 128] "
                         f"spectra, got shape {a.shape}")
    return np.array(a, np.float32, order="C", copy=True)


def bank_from_jax(np_bank, device) -> torch.Tensor:
    """Coefficient bank: flat or tiled float planes -> flat [E, B, 2, N]."""
    return torch.as_tensor(_flat(np_bank), device=device)


def state_from_jax(prev_in, ring, eval_prev, t, device) -> StepState:
    """StepState fields (numpy) -> the port's StepState on ``device``.
    ``eval_prev`` holds the cascade tails, one [N] row per filter with
    filter inputs (none for a graph without cascades)."""
    prev_in = np.array(prev_in, np.float32, copy=True)
    eval_prev = np.array(eval_prev, np.float32, copy=True)
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
    same dtypes. The JAX ``any_xfade`` scalar is left behind: the port's
    host passes ``xfade_now`` to the step instead."""
    out = {}
    for name in StepCtrl._fields:
        a = np.asarray(getattr(ctrl, name))
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        out[name] = torch.as_tensor(np.array(a, order="C", copy=True),
                                    device=device)
    return StepCtrl(**out)
