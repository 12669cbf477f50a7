"""Crossfade dual MAC: wrapper, plain version, launch counts.

``mac_dual`` computes, for the stage filters ``rows``, the partitioned
MAC against two coefficient sets in one pass over the ring:
``Y_new[i] = sum_b ring[rows[i], (t-b)%B] (*) (bank[e_i, b] * mask_i[b])``
and ``Y_old[i]`` the same with ``prev_idx``/``prev_mask`` -- the port of
``pallas_spectral_mac_dual`` (brutefir_tpu/ops/pallas_mac.py), whose two
results a crossfade block ramps between. The ring is read in place at
``rows``. The controls are every filter's, read at ``rows[i]``;
``uniform`` reads the first stage filter's for all of them; ``has_bin0``
as ``mac``'s.

On a CUDA tensor it launches the hand-written kernel ``csrc/mac_dual.cu``,
the two-set entry of the core it shares with the unfused MAC
(``csrc/mac_core.cuh``), its ``bf_mac_dual_bf16`` entry on a bfloat16
ring and/or bank (the bf16 operand forms, ``ops/mac_mix.py``); on a CPU
tensor it runs :func:`mac_dual_reference`, the plain torch version (two
plain MACs). There is no fallback from the kernel to the
plain version on a CUDA tensor: a failed build or launch raises.
"""

from __future__ import annotations

import torch

from . import _build
from .mac_mix import bf16_flags, bf16_suffix, check_operands, with_bf16
from .partconv import spectral_mac_dual as mac_dual_reference

# kernel launches per form, counted where the kernel is launched and
# nowhere else (the smoke run reads them to prove the main path used it)
launches = with_bf16("mac_dual_uniform", "mac_dual_rows")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def mac_dual(ring: torch.Tensor, bank: torch.Tensor, rows: torch.Tensor,
             coeff_idx: torch.Tensor, mask: torch.Tensor,
             prev_idx: torch.Tensor, prev_mask: torch.Tensor,
             t: torch.Tensor, uniform: bool, has_bin0: bool = True):
    """Dual MAC of the stage filters ``rows`` -> ``(Y_new, Y_old)``, two
    ``[Fs, 2, K]`` float32.

    ring [F, B, 2, K] f32 or bf16 (current block already written), bank
    [E, B, 2, K] f32 or bf16, rows [Fs] int32, coeff_idx / prev_idx [F] int32,
    mask / prev_mask [F, B] f32, t scalar int32 tensor; all on one
    device, contiguous.
    """
    check_operands("mac_dual", ring, bank, coeff_idx, mask, t, rows=rows,
                   prev_idx=prev_idx, prev_mask=prev_mask)
    if ring.device.type == "cpu":
        return mac_dual_reference(ring, bank, rows, coeff_idx, mask,
                                  prev_idx, prev_mask, t, uniform, has_bin0)
    if ring.device.type != "cuda":
        raise ValueError(f"mac_dual: unsupported device {ring.device}")
    F, B, _, K = ring.shape
    Fs = rows.shape[0]
    y_new = torch.empty((Fs, 2, K), dtype=torch.float32, device=ring.device)
    y_old = torch.empty_like(y_new)
    with torch.cuda.device(ring.device):
        rc = _build.load("mac_dual").bf_mac_dual(
            ring.data_ptr(), bank.data_ptr(), rows.data_ptr(),
            coeff_idx.data_ptr(), mask.data_ptr(), prev_idx.data_ptr(),
            prev_mask.data_ptr(), t.data_ptr(), y_new.data_ptr(),
            y_old.data_ptr(), F, Fs, B, K, bank.shape[0], int(uniform),
            int(has_bin0), *bf16_flags(ring, bank),
            torch.cuda.current_stream().cuda_stream)
    form = (("mac_dual_uniform" if uniform else "mac_dual_rows")
            + bf16_suffix(ring, bank))
    if rc != 0:
        raise RuntimeError(
            f"mac_dual: {form} kernel launch failed (cudaError {rc})")
    launches[form] += 1
    return y_new, y_old
