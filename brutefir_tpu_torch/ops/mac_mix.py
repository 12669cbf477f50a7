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

The bf16 operand forms: under ``BRUTEFIR_TPU_RING_DTYPE`` /
``BRUTEFIR_TPU_BANK_DTYPE`` = bf16 the ring and/or the bank are
``torch.bfloat16`` (float32 graphs only); every MAC wrapper passes its
kernel's entry the flags ``ring_bf16`` / ``bank_bf16``
(:func:`bf16_flags`; both 0 for float32), and the kernel widens them to
float32 on load and returns float32. A launch counts in the module's
``launches`` under the form's name with :func:`bf16_suffix`.
The plain versions widen them on entry (``partconv.widen``).
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .partconv import complex_mix, spectral_mac_rollh, spectral_mac_uniform

# the bf16 forms' suffixes (:func:`bf16_suffix`): the ring, the bank, both
BF16_SUFFIXES = ("_bf16r", "_bf16b", "_bf16rb")


def with_bf16(*names) -> dict:
    """Launch counts of the forms ``names`` and of their bf16 forms, all
    0."""
    return {n + sfx: 0 for n in names for sfx in ("",) + BF16_SUFFIXES}


# kernel launches per form, counted where the kernel is launched and
# nowhere else (the smoke run reads them to prove the main path used it)
launches = with_bf16("uniform", "rows", "tiled")


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


def run_floats(size: int) -> int:
    """The slot of a run of MIX_TK values of ``size`` bytes: float32
    MIX_TK + 4 (its skew), bf16 densely (64 bytes)."""
    return MIX_TK + 4 if size == 4 else MIX_TK * size // 4


def parts_a_stage(ring_size: int = 4, bank_size: int = 4) -> int:
    """Partitions a stage: 1 in float32, 2 in a bf16 form (half the
    stages: csrc/mac_mix.cu's note)."""
    return 1 if ring_size == bank_size == 4 else 2


def part_floats(bank_smem: bool, ring_size: int = 4,
                bank_size: int = 4) -> int:
    """One partition of a warp's item: the ring's two runs, the bank's
    two when streamed, the mask value (padded to 16 bytes)."""
    return (2 * run_floats(ring_size)
            + (0 if bank_smem else 2 * run_floats(bank_size)) + 4)


def smem_bytes(nw: int, FC: int, F: int, B: int, C_out: int,
               bank_smem: bool, ring_size: int = 4,
               bank_size: int = 4) -> int:
    """Shared memory a block of csrc/mac_mix.cu takes (its ``smem_bytes``)
    for ring and bank values of ``ring_size`` / ``bank_size`` bytes: the
    uniform bank tile [B, 2, MIX_TK] if staged (:func:`run_floats` a
    run); MIX_STAGES stages of nw items (:func:`parts_a_stage` partitions
    of :func:`part_floats`); the F bank indices; the chunk's Y tiles and w
    columns; the out tile when the filters take more than one chunk."""
    item = (parts_a_stage(ring_size, bank_size)
            * part_floats(bank_smem, ring_size, bank_size))
    chunks = -(-F // FC) if F > FC else 1
    floats = ((B * 2 * run_floats(bank_size) if bank_smem else 0)
              + MIX_STAGES * nw * item
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
def plan(F: int, B: int, K: int, C_out: int, uniform: bool = False,
         ring_size: int = 4, bank_size: int = 4) -> dict:
    """The launch of csrc/mac_mix.cu, the only place its sizes are chosen,
    for ring and bank values of ``ring_size`` / ``bank_size`` bytes: ``nw``
    warps a block (:func:`warps_for`), ``TK`` bins a block (MIX_TK: 64-bin
    tiles measured slower on the H100, csrc/mac_mix.cu's note), ``FC``
    filters a chunk (a multiple of nw: the largest that fits half of
    SMEM_MAX, so two blocks share an SM, else the largest that fits it),
    ``bank_smem`` (the uniform form's bank tile staged in shared memory,
    where it fits beside the rest), ``parts`` partitions a stage, ``smem``
    bytes and ``tiles`` (blocks). Raises ValueError where nothing fits."""
    nw = warps_for(F)
    top = max(nw, -(-F // nw) * nw)
    sizes = (ring_size, bank_size)
    for budget in (SMEM_MAX // 2, SMEM_MAX):
        for FC in range(top, 0, -nw):
            if smem_bytes(nw, FC, F, B, C_out, False, *sizes) > budget:
                continue
            bank = uniform and smem_bytes(nw, FC, F, B, C_out, True,
                                          *sizes) <= budget
            return {"nw": nw, "TK": MIX_TK, "FC": FC, "bank_smem": bank,
                    "parts": parts_a_stage(*sizes),
                    "smem": smem_bytes(nw, FC, F, B, C_out, bank, *sizes),
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


def bf16_flags(ring, bank) -> tuple:
    """``(ring_bf16, bank_bf16)``: 1 where that operand is bfloat16."""
    return (int(ring.dtype == torch.bfloat16),
            int(bank.dtype == torch.bfloat16))


def bf16_suffix(ring, bank) -> str:
    """The launch-count suffix of a call's form: '' for float32 (or
    float64) operands, else one of BF16_SUFFIXES (a bfloat16 ring, bank,
    or both)."""
    r, b = bf16_flags(ring, bank)
    return "" if not (r or b) else BF16_SUFFIXES[r + 2 * b - 1]


def check_staged(fn: str, ring, bank, xnews=None) -> None:
    """The alignment the bf16 forms of the fused MAC + mix and the
    grouped MACs take (``csrc/mac_mix.cu``, ``csrc/mac_mix_tiled.cu``,
    ``csrc/mac_group.cu``: 16-byte copies or 8- and 16-byte loads of
    whole runs): with a bfloat16 ring or bank, K % 8 == 0 and ring, bank
    and ``xnews`` 16-byte aligned; ValueError elsewhere, never a read out
    of bounds. Every engine path meets it: its fused and grouped routes
    need K % 128 == 0 (on a mesh, at each bin shard)."""
    if ring.dtype != torch.bfloat16 and bank.dtype != torch.bfloat16:
        return
    K = ring.shape[-1]
    if K % 8 or any(x.data_ptr() % 16 for x in (ring, bank, xnews)
                    if x is not None):
        raise ValueError(f"{fn}: the bf16 forms need K % 8 == 0 and "
                         f"16-byte aligned ring, bank and xnews (K = {K})")


def check_operands(fn: str, ring, bank, coeff_idx, mask, t, w=None,
                   xnews=None, delay=None, rows=None, prev_idx=None,
                   prev_mask=None, dtype=torch.float32) -> None:
    """Raise on what the MAC kernels do not take: every operand on the
    ring's device, contiguous, of its dtype and shape; the real operands
    of ``dtype``, but for ``dtype`` float32 the ring and the bank each
    float32 or bfloat16 (the bf16 operand forms), ``xnews`` of the ring's
    dtype. ``w``, ``xnews``, ``delay``, ``rows``, ``prev_idx`` and
    ``prev_mask`` are checked when given.

    Only ``mac`` has a float64 form: the float64 ring and bank of a
    float64 graph given to a float32-only kernel (``mac_mix``,
    ``mac_group``, ``mac_dual``) raise ValueError, as the JAX package
    never reaches their counterparts under ``float_bits: 64``; one
    operand of another dtype than the rest (a bfloat16 one beside
    float64 included) raises TypeError."""
    if (ring.dtype == bank.dtype == torch.float64
            and dtype != torch.float64):
        raise ValueError(f"{fn}: float32 only (a float64 graph runs the "
                         f"unfused mac, the JAX package's float64 route)")
    stored = ((dtype, torch.bfloat16) if dtype == torch.float32
              else (dtype,))
    ops = [("ring", ring, stored), ("bank", bank, stored),
           ("coeff_idx", coeff_idx, (torch.int32,)),
           ("mask", mask, (dtype,)), ("t", t, (torch.int32,))]
    ops += [(name, x, dt) for name, x, dt in
            (("w", w, (dtype,)), ("xnews", xnews, (ring.dtype,)),
             ("delay", delay, (torch.int32,)),
             ("rows", rows, (torch.int32,)),
             ("prev_idx", prev_idx, (torch.int32,)),
             ("prev_mask", prev_mask, (dtype,)))
            if x is not None]
    dev = ring.device
    for name, x, dts in ops:
        if x.device != dev:
            raise ValueError(f"{fn}: {name} is on {x.device}, ring on {dev}")
        if x.dtype not in dts:
            raise TypeError(f"{fn}: {name} must be "
                            f"{' or '.join(map(str, dts))}, got {x.dtype}")
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

    ring [F, B, 2, K] f32 or bf16 (current block already written), bank
    [E, B, 2, K] f32 or bf16, coeff_idx [F] int32, mask [F, B] f32, t
    scalar int32 tensor, w [C_out, F] f32; all on one device, contiguous.
    ``uniform``: every filter uses coeff_idx[0] and mask[0] (the tiled
    kernel reads per-filter rows, which then hold the same values).
    """
    check_operands("mac_mix", ring, bank, coeff_idx, mask, t, w)
    check_staged("mac_mix", ring, bank)
    F, B, _, K = ring.shape
    C_out = w.shape[0]
    tiled = tiled_route(C_out, B, K)
    if ring.device.type == "cpu":
        return mac_mix_reference(ring, bank, coeff_idx, mask, t, w, uniform,
                                 has_bin0)
    if ring.device.type != "cuda":
        raise ValueError(f"mac_mix: unsupported device {ring.device}")
    E = bank.shape[0]
    if not tiled:
        p = plan(F, B, K, C_out, uniform, ring.element_size(),
                 bank.element_size())
    out = torch.empty((C_out, 2, K), dtype=torch.float32, device=ring.device)
    args = (ring.data_ptr(), bank.data_ptr(), coeff_idx.data_ptr(),
            mask.data_ptr(), t.data_ptr(), w.data_ptr(), out.data_ptr(),
            F, B, K, E, C_out)
    with torch.cuda.device(ring.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tiled:
            form = "tiled"
            rc = _build.load("mac_mix_tiled").bf_mac_mix_tiled(
                *args, int(has_bin0), *bf16_flags(ring, bank), stream)
        else:
            form = "uniform" if uniform else "rows"
            rc = _build.load("mac_mix").bf_mac_mix(
                *args, int(uniform), p["nw"], p["FC"], int(p["bank_smem"]),
                int(has_bin0), *bf16_flags(ring, bank), stream)
    form += bf16_suffix(ring, bank)
    if rc != 0:
        raise RuntimeError(
            f"mac_mix: {form} kernel launch failed (cudaError {rc})")
    launches[form] += 1
    return out
