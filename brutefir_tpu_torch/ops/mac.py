"""Partitioned spectral MAC without the output mix: wrapper, plain
version, launch counts.

``mac`` computes, for the stage filters ``rows``,
``Y[i] = sum_b ring[rows[i], (t-b)%B] (*) (bank[e_i, b] * mask_i[b])``,
the port of ``pallas_spectral_mac`` and ``pallas_spectral_mac_uniform``
(brutefir_tpu/ops/pallas_mac.py): the MAC of the stage loop, whose
per-filter spectra feed filter cascades and the output mix. The ring is
read in place at ``rows``: the stage's rows are never gathered into a
copy. ``coeff_idx`` and ``mask`` are every filter's controls, read at
``rows[i]``; ``uniform`` reads the first stage filter's for all of them.
``has_bin0`` False makes bin 0 an ordinary complex product: the call of a
mesh's bin shard other than the first (``ops/mac_shard.py``).

On a CUDA tensor it launches the hand-written kernel ``csrc/mac.cu``, the
one-set entry of the core it shares with the crossfade dual MAC
(``csrc/mac_core.cuh``): ``bf_mac`` on float32 operands, ``bf_mac_f64``
on float64 ones (``float_bits: 64``, whose step runs this MAC where the
JAX package runs its dense float64 MAC), ``bf_mac_bf16`` on a bfloat16
ring and/or bank (the bf16 operand forms, ``ops/mac_mix.py``); on a CPU
tensor it runs :func:`mac_reference`, the plain torch version.
There is no fallback from the kernel to the plain version on a CUDA
tensor: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .mac_mix import bf16_flags, bf16_suffix, check_operands, with_bf16
from .partconv import spectral_mac_rollh, spectral_mac_uniform

# kernel launches per form, counted where the kernel is launched and
# nowhere else (the smoke run reads them to prove the main path used it)
launches = {**with_bf16("mac_uniform", "mac_rows"), "mac_uniform_f64": 0,
            "mac_rows_f64": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def launch_plan(sets: int, Fs: int, K: int,
                dtype: torch.dtype = torch.float32, uniform: bool = False,
                ring_dtype: torch.dtype = None,
                bank_dtype: torch.dtype = None) -> dict:
    """The launch ``csrc/mac_core.cuh``'s ``plan`` makes for ``mac``
    (``sets`` = 1, float32 or float64 ``dtype``) or ``mac_dual`` (2) at a
    stage of ``Fs`` filters and ``K`` bins, with the ``uniform`` controls
    or not and the ring and the bank of ``ring_dtype`` / ``bank_dtype``
    (bfloat16 in a bf16 form; None: ``dtype``): ``grid``, ``threads`` a
    block and ``group``, the partitions a thread loads before their FMAs.
    Asks the built library (the card's machine only); the kernels choose
    their launch there, not here."""
    o = (ctypes.c_int * 4)()
    _build.load("mac").bf_mac_plan(
        sets, Fs, K, dtype.itemsize, int(uniform),
        (ring_dtype or dtype).itemsize, (bank_dtype or dtype).itemsize, o)
    return {"grid": (o[0], o[1]), "threads": o[2], "group": o[3]}


def mac_reference(ring, bank, rows, coeff_idx, mask, t, uniform: bool,
                  has_bin0: bool = True):
    """Plain torch version: the dense MAC over the gathered stage rows."""
    r = rows.long()
    fn = spectral_mac_uniform if uniform else spectral_mac_rollh
    return fn(ring[r], bank, coeff_idx[r], mask[r], t, has_bin0)


def mac(ring: torch.Tensor, bank: torch.Tensor, rows: torch.Tensor,
        coeff_idx: torch.Tensor, mask: torch.Tensor, t: torch.Tensor,
        uniform: bool, has_bin0: bool = True) -> torch.Tensor:
    """Unfused MAC of the stage filters ``rows`` -> ``[Fs, 2, K]`` of the
    graph's real dtype (float32, or float64 under ``float_bits: 64``).

    ring [F, B, 2, K] (current block already written), bank [E, B, 2, K],
    rows [Fs] int32 (indices into the ring's filters), coeff_idx [F]
    int32, mask [F, B], t scalar int32 tensor; the real operands of one
    dtype, but the ring and the bank each float32 or bfloat16 beside a
    float32 mask; all on one device, contiguous. ``uniform``: every stage
    filter uses coeff_idx[rows[0]] and mask[rows[0]].
    """
    f64 = ring.dtype == torch.float64
    check_operands("mac", ring, bank, coeff_idx, mask, t, rows=rows,
                   dtype=ring.dtype if f64 else torch.float32)
    if ring.device.type == "cpu":
        return mac_reference(ring, bank, rows, coeff_idx, mask, t, uniform,
                             has_bin0)
    if ring.device.type != "cuda":
        raise ValueError(f"mac: unsupported device {ring.device}")
    F, B, _, K = ring.shape
    Fs = rows.shape[0]
    out = torch.empty((Fs, 2, K), dtype=mask.dtype, device=ring.device)
    lib = _build.load("mac")
    args = (ring.data_ptr(), bank.data_ptr(), rows.data_ptr(),
            coeff_idx.data_ptr(), mask.data_ptr(), t.data_ptr(),
            out.data_ptr(), F, Fs, B, K, bank.shape[0], int(uniform),
            int(has_bin0))
    with torch.cuda.device(ring.device):
        stream = torch.cuda.current_stream().cuda_stream
        if f64:
            rc = lib.bf_mac_f64(*args, stream)
        else:
            rc = lib.bf_mac(*args, *bf16_flags(ring, bank), stream)
    form = ("mac_uniform" if uniform else "mac_rows") + (
        "_f64" if f64 else bf16_suffix(ring, bank))
    if rc != 0:
        raise RuntimeError(f"mac: {form} kernel launch failed (cudaError {rc})")
    launches[form] += 1
    return out
