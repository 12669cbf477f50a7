"""Fused partitioned spectral MAC + output mix: wrapper, plain version,
launch counts.

``mac_mix`` computes ``out[c] = sum_f w[c, f] * Y_f`` with
``Y_f = sum_b ring[f, (t-b)%B] (*) (bank[idx_f, b] * mask[f, b])`` -- the
port of ``pallas_spectral_mac_mix`` (brutefir_tpu/ops/pallas_mac.py).
On a CUDA tensor it launches the hand-written kernel of
``csrc/mac_mix.cu``; on a CPU tensor it runs :func:`mac_mix_reference`,
the plain torch version. There is no fallback from the kernel to the
plain version on a CUDA tensor: a failed build or launch raises.
"""

from __future__ import annotations

import torch

from . import _build
from .partconv import complex_mix, spectral_mac_rollh, spectral_mac_uniform

# kernel launches per form, counted where the kernel is launched and
# nowhere else (the smoke run reads them to prove the main path used it)
launches = {"uniform": 0, "rows": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def mac_mix_reference(ring, bank, coeff_idx, mask, t, w, uniform: bool):
    """Plain torch version: the dense MAC, then the FP32 output mix."""
    mac = spectral_mac_uniform if uniform else spectral_mac_rollh
    return complex_mix(w, mac(ring, bank, coeff_idx, mask, t))


def _check(ring, bank, coeff_idx, mask, t, w):
    dev = ring.device
    for name, x, dt in (("ring", ring, torch.float32),
                        ("bank", bank, torch.float32),
                        ("coeff_idx", coeff_idx, torch.int32),
                        ("mask", mask, torch.float32),
                        ("t", t, torch.int32),
                        ("w", w, torch.float32)):
        if x.device != dev:
            raise ValueError(f"mac_mix: {name} is on {x.device}, ring on {dev}")
        if x.dtype != dt:
            raise TypeError(f"mac_mix: {name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"mac_mix: {name} must be contiguous")
    if ring.dim() != 4 or ring.shape[2] != 2:
        raise ValueError(f"mac_mix: ring must be [F, B, 2, K], got "
                         f"{tuple(ring.shape)}")
    F, B, _, K = ring.shape
    if bank.dim() != 4 or tuple(bank.shape[1:]) != (B, 2, K):
        raise ValueError(f"mac_mix: bank must be [E, {B}, 2, {K}], got "
                         f"{tuple(bank.shape)}")
    if bank.shape[0] < 1:
        raise ValueError("mac_mix: empty bank")
    if tuple(coeff_idx.shape) != (F,) or tuple(mask.shape) != (F, B):
        raise ValueError("mac_mix: coeff_idx must be [F] and mask [F, B]")
    if t.numel() != 1:
        raise ValueError("mac_mix: t must be a scalar")
    if w.dim() != 2 or w.shape[1] != F:
        raise ValueError(f"mac_mix: w must be [C_out, {F}], got "
                         f"{tuple(w.shape)}")


def mac_mix(ring: torch.Tensor, bank: torch.Tensor, coeff_idx: torch.Tensor,
            mask: torch.Tensor, t: torch.Tensor, w: torch.Tensor,
            uniform: bool) -> torch.Tensor:
    """Fused MAC + output mix -> ``[C_out, 2, K]`` float32.

    ring [F, B, 2, K] f32 (current block already written), bank
    [E, B, 2, K] f32, coeff_idx [F] int32, mask [F, B] f32, t scalar
    int32 tensor, w [C_out, F] f32; all on one device, contiguous.
    ``uniform``: every filter uses coeff_idx[0] and mask[0].
    """
    _check(ring, bank, coeff_idx, mask, t, w)
    if ring.device.type == "cpu":
        return mac_mix_reference(ring, bank, coeff_idx, mask, t, w, uniform)
    if ring.device.type != "cuda":
        raise ValueError(f"mac_mix: unsupported device {ring.device}")
    F, B, _, K = ring.shape
    C_out = w.shape[0]
    out = torch.empty((C_out, 2, K), dtype=torch.float32, device=ring.device)
    lib = _build.load()
    with torch.cuda.device(ring.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bf_mac_mix(ring.data_ptr(), bank.data_ptr(),
                            coeff_idx.data_ptr(), mask.data_ptr(),
                            t.data_ptr(), w.data_ptr(), out.data_ptr(),
                            F, B, K, bank.shape[0], C_out, int(uniform),
                            stream)
    if rc != 0:
        raise RuntimeError(f"mac_mix: kernel launch failed (cudaError {rc})")
    launches["uniform" if uniform else "rows"] += 1
    return out
