"""Fused partitioned spectral MAC + output mix: wrapper, plain version,
launch counts.

``mac_mix`` computes ``out[c] = sum_f w[c, f] * Y_f`` with
``Y_f = sum_b ring[f, (t-b)%B] (*) (bank[idx_f, b] * mask[f, b])`` -- the
port of ``pallas_spectral_mac_mix`` (brutefir_tpu/ops/pallas_mac.py).
On a CUDA tensor it launches a hand-written kernel: ``csrc/mac_mix.cu``
(the ``uniform`` and ``rows`` forms), or ``csrc/mac_mix_tiled.cu`` at the
shapes where the JAX package takes its bin-tiled kernel (``tiled_route``).
On a CPU tensor it runs :func:`mac_mix_reference`, the plain torch
version. There is no fallback from a kernel to the plain version on a
CUDA tensor: a failed build or launch raises. ``has_bin0`` False makes
bin 0 an ordinary complex product: the call of a mesh's bin shard other
than the first (``ops/mac_shard.py``).
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .partconv import complex_mix, spectral_mac_rollh, spectral_mac_uniform

# kernel launches per form, counted where the kernel is launched and
# nowhere else (the smoke run reads them to prove the main path used it)
launches = {"uniform": 0, "rows": 0, "tiled": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def tiled_route(C_out: int, B: int, K: int) -> bool:
    """Whether ``pallas_spectral_mac_mix`` takes its bin-tiled kernel
    (pallas_mac.py:1304-1306): the [C_out, 2, K] output plus four ring and
    bank rows exceed the TPU kernel's 12 MiB VMEM budget. The card has no
    such budget; the rule is kept so that a shape takes the same kernel,
    and so the same summation order, in both packages. It is also where
    the tiled kernel's on-chip mix pays on the card: at 256 outputs."""
    return (C_out + 4 * B) * 2 * K * 4 > 12 * 2**20


# csrc/mac_mix.cu's constants: warps a block at most, bins a block, stage
# buffers, the dynamic shared memory a block may have (227 KB)
MIX_MAX_WARPS = 16
MIX_TK = 32
MIX_STAGES = 8
SMEM_MAX = 232448


def smem_bytes(nw: int, FC: int, F: int, B: int, C_out: int,
               bank_smem: bool) -> int:
    """Shared memory a block of csrc/mac_mix.cu takes (its ``smem_bytes``):
    the uniform bank tile [B, 2, MIX_TK] if staged; MIX_STAGES stages of nw
    items (the ring's runs, the bank's runs when streamed, the mask value;
    a run of MIX_TK floats takes MIX_TK + 4); the F bank indices; the
    chunk's Y tiles and w columns; the out tile when the filters take more
    than one chunk."""
    run = MIX_TK + 4
    item = (2 if bank_smem else 4) * run + 4
    chunks = -(-F // FC) if F > FC else 1
    floats = ((B * 2 * run if bank_smem else 0) + MIX_STAGES * nw * item
              + -(-F // 4) * 4 + FC * 2 * MIX_TK + -(-FC * C_out // 4) * 4
              + (C_out * 2 * MIX_TK if chunks > 1 else 0))
    return 4 * floats


def warps_for(F: int) -> int:
    """Warps a block, one filter each a round: the fewest rounds of at
    most MIX_MAX_WARPS, then as few warps as give that (26 filters: two
    rounds of 13), at least 4."""
    rounds = max(1, -(-F // MIX_MAX_WARPS))
    return max(4, -(-F // rounds))


@functools.lru_cache(maxsize=256)
def plan(F: int, B: int, K: int, C_out: int, uniform: bool = False) -> dict:
    """The launch of csrc/mac_mix.cu, the only place its sizes are chosen:
    ``nw`` warps a block (:func:`warps_for`), ``TK`` bins a block (MIX_TK:
    64-bin tiles measured slower on the H100, csrc/mac_mix.cu's note),
    ``FC`` filters a chunk (a multiple of nw: the largest that fits half of
    SMEM_MAX, so two blocks share an SM, else the largest that fits it),
    ``bank_smem`` (the uniform form's bank tile staged in shared memory,
    where it fits beside the rest), ``smem`` bytes and ``tiles`` (blocks).
    Raises ValueError where nothing fits."""
    nw = warps_for(F)
    top = max(nw, -(-F // nw) * nw)
    for budget in (SMEM_MAX // 2, SMEM_MAX):
        for FC in range(top, 0, -nw):
            if smem_bytes(nw, FC, F, B, C_out, False) > budget:
                continue
            bank = uniform and smem_bytes(nw, FC, F, B, C_out,
                                          True) <= budget
            return {"nw": nw, "TK": MIX_TK, "FC": FC, "bank_smem": bank,
                    "smem": smem_bytes(nw, FC, F, B, C_out, bank),
                    "tiles": -(-K // MIX_TK)}
    raise ValueError(f"mac_mix: no launch fits {SMEM_MAX} bytes of shared "
                     f"memory (F={F}, B={B}, K={K}, C_out={C_out})")


def mac_mix_reference(ring, bank, coeff_idx, mask, t, w, uniform: bool,
                      has_bin0: bool = True):
    """Plain torch version of every form: the dense MAC, then the FP32
    output mix. The tiled kernel reads per-filter rows, so its plain
    version is the ``uniform=False`` one."""
    mac = spectral_mac_uniform if uniform else spectral_mac_rollh
    return complex_mix(w, mac(ring, bank, coeff_idx, mask, t, has_bin0))


def check_operands(fn: str, ring, bank, coeff_idx, mask, t, w=None,
                   xnews=None, delay=None, rows=None, prev_idx=None,
                   prev_mask=None, dtype=torch.float32) -> None:
    """Raise on what the MAC kernels do not take: every operand on the
    ring's device, contiguous, of its dtype and shape; the real operands
    of ``dtype``. ``w``, ``xnews``, ``delay``, ``rows``, ``prev_idx`` and
    ``prev_mask`` are checked when given.

    Only ``mac`` has a float64 form: the float64 ring and bank of a
    float64 graph given to a float32-only kernel (``mac_mix``,
    ``mac_group``, ``mac_dual``) raise ValueError, as the JAX package
    never reaches their counterparts under ``float_bits: 64``; one
    operand of another dtype than the rest raises TypeError."""
    if (ring.dtype == bank.dtype == torch.float64
            and dtype != torch.float64):
        raise ValueError(f"{fn}: float32 only (a float64 graph runs the "
                         f"unfused mac, the JAX package's float64 route)")
    ops = [("ring", ring, dtype), ("bank", bank, dtype),
           ("coeff_idx", coeff_idx, torch.int32),
           ("mask", mask, dtype), ("t", t, torch.int32)]
    ops += [(name, x, dt) for name, x, dt in
            (("w", w, dtype), ("xnews", xnews, dtype),
             ("delay", delay, torch.int32), ("rows", rows, torch.int32),
             ("prev_idx", prev_idx, torch.int32),
             ("prev_mask", prev_mask, dtype))
            if x is not None]
    dev = ring.device
    for name, x, dt in ops:
        if x.device != dev:
            raise ValueError(f"{fn}: {name} is on {x.device}, ring on {dev}")
        if x.dtype != dt:
            raise TypeError(f"{fn}: {name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if ring.dim() != 4 or ring.shape[2] != 2:
        raise ValueError(f"{fn}: ring must be [F, B, 2, K], got "
                         f"{tuple(ring.shape)}")
    F, B, _, K = ring.shape
    if bank.dim() != 4 or tuple(bank.shape[1:]) != (B, 2, K):
        raise ValueError(f"{fn}: bank must be [E, {B}, 2, {K}], got "
                         f"{tuple(bank.shape)}")
    if bank.shape[0] < 1:
        raise ValueError(f"{fn}: empty bank")
    if tuple(coeff_idx.shape) != (F,) or tuple(mask.shape) != (F, B):
        raise ValueError(f"{fn}: coeff_idx must be [F] and mask [F, B]")
    if (prev_idx is not None and tuple(prev_idx.shape) != (F,)) or (
            prev_mask is not None and tuple(prev_mask.shape) != (F, B)):
        raise ValueError(f"{fn}: prev_idx must be [F] and prev_mask [F, B]")
    if t.numel() != 1:
        raise ValueError(f"{fn}: t must be a scalar")
    if w is not None and (w.dim() != 2 or w.shape[1] != F):
        raise ValueError(f"{fn}: w must be [C_out, {F}], got "
                         f"{tuple(w.shape)}")
    if xnews is not None and (xnews.dim() != 4 or xnews.shape[0] != F
                              or xnews.shape[1] < 1
                              or tuple(xnews.shape[2:]) != (2, K)):
        raise ValueError(f"{fn}: xnews must be [{F}, G-1, 2, {K}] with "
                         f"G >= 2, got {tuple(xnews.shape)}")
    if delay is not None and tuple(delay.shape) != (F,):
        raise ValueError(f"{fn}: delay must be [{F}]")
    if rows is not None and (rows.dim() != 1 or rows.shape[0] < 1):
        raise ValueError(f"{fn}: rows must be [Fs] with Fs >= 1, got "
                         f"{tuple(rows.shape)}")


def mac_mix(ring: torch.Tensor, bank: torch.Tensor, coeff_idx: torch.Tensor,
            mask: torch.Tensor, t: torch.Tensor, w: torch.Tensor,
            uniform: bool, has_bin0: bool = True) -> torch.Tensor:
    """Fused MAC + output mix -> ``[C_out, 2, K]`` float32.

    ring [F, B, 2, K] f32 (current block already written), bank
    [E, B, 2, K] f32, coeff_idx [F] int32, mask [F, B] f32, t scalar
    int32 tensor, w [C_out, F] f32; all on one device, contiguous.
    ``uniform``: every filter uses coeff_idx[0] and mask[0] (the tiled
    kernel reads per-filter rows, which then hold the same values).
    """
    check_operands("mac_mix", ring, bank, coeff_idx, mask, t, w)
    if ring.device.type == "cpu":
        return mac_mix_reference(ring, bank, coeff_idx, mask, t, w, uniform,
                                 has_bin0)
    if ring.device.type != "cuda":
        raise ValueError(f"mac_mix: unsupported device {ring.device}")
    F, B, _, K = ring.shape
    C_out = w.shape[0]
    E = bank.shape[0]
    tiled = tiled_route(C_out, B, K)
    if not tiled:
        p = plan(F, B, K, C_out, uniform)
    out = torch.empty((C_out, 2, K), dtype=torch.float32, device=ring.device)
    args = (ring.data_ptr(), bank.data_ptr(), coeff_idx.data_ptr(),
            mask.data_ptr(), t.data_ptr(), w.data_ptr(), out.data_ptr(),
            F, B, K, E, C_out)
    with torch.cuda.device(ring.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tiled:
            form = "tiled"
            rc = _build.load("mac_mix_tiled").bf_mac_mix_tiled(
                *args, int(has_bin0), stream)
        else:
            form = "uniform" if uniform else "rows"
            rc = _build.load("mac_mix").bf_mac_mix(
                *args, int(uniform), p["nw"], p["FC"], int(p["bank_smem"]),
                int(has_bin0), stream)
    if rc != 0:
        raise RuntimeError(
            f"mac_mix: {form} kernel launch failed (cudaError {rc})")
    launches[form] += 1
    return out
