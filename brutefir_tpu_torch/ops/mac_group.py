"""Grouped partitioned spectral MACs for the batched offline dispatch:
wrappers, plain versions, launch counts.

G consecutive blocks t .. t+G-1 share one pass over the spectra ring and
the coefficient bank (controls are frozen across the group). ``ring``
holds block t's write and no later one; ``xnews`` [F, G-1, 2, K] holds
blocks t+1 .. t+G-1's in-mixed spectra, written into the ring by the
caller only after the call. Block t+g reads at partition b the ring slot
``(t+g-b) % B``, or ``xnews[f, g-b-1-delay[f]]`` where that index is
>= 0 (see ``group_rows``).

- ``mac_group`` -> ``[G, F, 2, K]`` per-filter spectra, the port of
  ``pallas_spectral_mac_group`` (the output mix runs outside, as
  ``partconv.complex_mix``);
- ``mac_mix_group`` -> ``[G, C_out, 2, K]`` mixed spectra, the port of
  ``pallas_spectral_mac_mix_group``.

On a CUDA tensor each launches its kernel of ``csrc/mac_group.cu``; on a
CPU tensor it runs its plain torch version. There is no fallback from a
kernel to the plain version on a CUDA tensor: a failed build or launch
raises.
"""

from __future__ import annotations

import torch

from . import _build
from .mac_mix import check_operands
from .partconv import complex_mix, mac_terms

# the kernels are instantiated for G = 2 .. MAX_GROUP
MAX_GROUP = 8

# kernel launches per kernel, counted where it is launched and nowhere else
launches = {"group": 0, "mix_group": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def group_rows(ring, xnews, t, delay, g: int) -> torch.Tensor:
    """[F, B, 2, K]: what block t+g reads at each partition b. The ring
    slot ``(t+g-b) % B``, except where ``j = g-b-1-delay[f] >= 0``: there
    the group's own spectra ``xnews[f, j]``, not yet in the ring (the
    select chain of pallas_mac.py:803-815, and `_group_bin0_rot` for bin
    0: no bin is treated apart)."""
    F, B = ring.shape[:2]
    barange = torch.arange(B, device=ring.device)
    slots = torch.remainder(t.to(torch.int64) + g - barange, B)
    rows = ring[:, slots]                                   # a copy
    if g:
        j = (g - 1 - barange[None, :g]
             - delay.to(torch.int64)[:, None])              # [F, min(g, B)]
        fsel = torch.arange(F, device=ring.device)[:, None]
        xsel = xnews[fsel, j.clamp(0, xnews.shape[1] - 1)]  # [F, g, 2, K]
        rows[:, :g] = torch.where((j >= 0)[:, :, None, None], xsel,
                                  rows[:, :g])
    return rows


def mac_group_reference(ring, xnews, bank, coeff_idx, mask, t, delay):
    """Plain torch version of ``mac_group``: per block, the rows it reads
    against the unrotated coefficient partitions, with the bin-0 rule."""
    G = xnews.shape[1] + 1
    H = bank[coeff_idx.long()] * mask[:, :, None, None]     # [F, B, 2, K]
    return torch.stack([mac_terms(group_rows(ring, xnews, t, delay, g), H)
                        for g in range(G)])


def mac_mix_group_reference(ring, xnews, bank, coeff_idx, mask, t, w,
                            delay):
    """Plain torch version of ``mac_mix_group``: ``mac_group``'s spectra
    through the FP32 output mix."""
    ys = mac_group_reference(ring, xnews, bank, coeff_idx, mask, t, delay)
    return torch.stack([complex_mix(w, y) for y in ys])


def _launch(fn: str, kernel: str, ring, xnews, out, ptrs, dims):
    G = xnews.shape[1] + 1
    if G > MAX_GROUP:
        raise ValueError(f"{fn}: the kernel takes G <= {MAX_GROUP}, got {G}")
    with torch.cuda.device(ring.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_build.load("mac_group"), kernel)(
            *(x.data_ptr() for x in ptrs), out.data_ptr(), *dims, G, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed (cudaError {rc})")


def mac_group(ring: torch.Tensor, xnews: torch.Tensor, bank: torch.Tensor,
              coeff_idx: torch.Tensor, mask: torch.Tensor, t: torch.Tensor,
              delay: torch.Tensor) -> torch.Tensor:
    """Grouped MAC -> ``[G, F, 2, K]`` float32.

    ring [F, B, 2, K] f32 (block t written, no later block), xnews
    [F, G-1, 2, K] f32, bank [E, B, 2, K] f32, coeff_idx [F] int32, mask
    [F, B] f32, t scalar int32 tensor, delay [F] int32; all on one
    device, contiguous."""
    check_operands("mac_group", ring, bank, coeff_idx, mask, t,
                   xnews=xnews, delay=delay)
    if ring.device.type == "cpu":
        return mac_group_reference(ring, xnews, bank, coeff_idx, mask, t,
                                   delay)
    if ring.device.type != "cuda":
        raise ValueError(f"mac_group: unsupported device {ring.device}")
    F, B, _, K = ring.shape
    G = xnews.shape[1] + 1
    out = torch.empty((G, F, 2, K), dtype=torch.float32, device=ring.device)
    _launch("mac_group", "bf_mac_group", ring, xnews, out,
            (ring, xnews, bank, coeff_idx, mask, t, delay),
            (F, B, K, bank.shape[0]))
    launches["group"] += 1
    return out


def mac_mix_group(ring: torch.Tensor, xnews: torch.Tensor,
                  bank: torch.Tensor, coeff_idx: torch.Tensor,
                  mask: torch.Tensor, t: torch.Tensor, w: torch.Tensor,
                  delay: torch.Tensor) -> torch.Tensor:
    """Grouped fused MAC + output mix -> ``[G, C_out, 2, K]`` float32.
    Operands as ``mac_group``, plus w [C_out, F] f32."""
    check_operands("mac_mix_group", ring, bank, coeff_idx, mask, t, w=w,
                   xnews=xnews, delay=delay)
    if ring.device.type == "cpu":
        return mac_mix_group_reference(ring, xnews, bank, coeff_idx, mask,
                                       t, w, delay)
    if ring.device.type != "cuda":
        raise ValueError(f"mac_mix_group: unsupported device {ring.device}")
    F, B, _, K = ring.shape
    G = xnews.shape[1] + 1
    C_out = w.shape[0]
    out = torch.empty((G, C_out, 2, K), dtype=torch.float32,
                      device=ring.device)
    _launch("mac_mix_group", "bf_mac_mix_group", ring, xnews, out,
            (ring, xnews, bank, coeff_idx, mask, t, delay, w),
            (F, B, K, bank.shape[0], C_out))
    launches["mix_group"] += 1
    return out
