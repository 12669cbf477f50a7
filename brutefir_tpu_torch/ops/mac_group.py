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

On a CUDA tensor each launches its kernel of ``csrc/mac_group.cu`` (its
bf16 operand form on a bfloat16 ring and/or bank, ``ops/mac_mix.py``'s
flags; ``xnews`` then of the ring's dtype); on a CPU
tensor it runs its plain torch version. ``has_bin0`` False makes bin 0
an ordinary complex product: the call of a mesh's bin shard other than
the first (``ops/mac_shard.py``). There is no fallback from a
kernel to the plain version on a CUDA tensor: a failed build or launch
raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .mac_mix import (SMEM_MAX, bf16_flags, bf16_suffix, check_operands,
                      check_staged, with_bf16)
from .partconv import complex_mix, mac_terms, widen

# the kernels are instantiated for G = 2 .. MAX_GROUP
MAX_GROUP = 8

# kernel launches per kernel, counted where it is launched and nowhere
# else
launches = with_bf16("group", "mix_group")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# csrc/mac_group.cu's constants for mac_mix_group: bins and threads a
# block, accumulators a thread, stages of a warp's copy ring, positions a
# stage (float32, both operands in bf16)
MIX_TILE = 32
MIX_THREADS = 512
MIX_ACC = 64
MIX_STAGES = 3
MIX_POS, MIX_POS_BF16 = 4, 6


def mix_group_layout(G: int, C_out: int, ring_size: int = 4,
                     bank_size: int = 4) -> dict:
    """``csrc/mac_group.cu``'s launch of ``mac_mix_group`` (``MixShape``,
    ``MixBf16Shape``) at group size ``G`` and ``C_out`` outputs for ring
    and bank values of ``ring_size`` / ``bank_size`` bytes, as
    ``mix_group_plan`` reads it from the library: a position's 16-byte
    ``chunks`` (its four 32-bin runs: 32 in float32, 16 with both operands
    in bf16, two positions a warp-wide copy), positions a stage (4 in
    float32, 6 with both in bf16), its rows (all 64 accumulators of a
    thread over G's padded columns) and shared memory. With one bf16
    operand the launch is the float32 form's (each bf16 run in the first
    4 chunks of its slot). The kernel chooses its launch in the library;
    this mirror is for tests and reports."""
    if not 2 <= G <= MAX_GROUP:
        raise ValueError(f"mix_group_layout: no plan for G = {G}")
    gp = 2 if G <= 2 else 4 if G <= 4 else 8
    cols = gp * 2 * MIX_TILE
    rows = MIX_THREADS * MIX_ACC // cols
    warps = MIX_THREADS // 32
    both = ring_size == bank_size == 2     # else the float32 form's launch
    run = MIX_TILE // 2 if both else MIX_TILE       # floats a run
    chunks, item = run, 4 * run + 4
    pos = MIX_POS_BF16 if both else MIX_POS
    floats = (warps * MIX_STAGES * pos * item + 2 * warps * cols
              + 2 * warps * (rows + 4) + 2 * rows * warps)
    return {"bins": MIX_TILE, "threads": MIX_THREADS, "rows": rows,
            "grid_y": -(-max(C_out, 1) // rows), "stages": MIX_STAGES,
            "positions": pos, "smem": 4 * floats, "padded_g": gp,
            "chunks": chunks}


def mix_group_plan(G: int, C_out: int, ring_bf16: int = 0,
                   bank_bf16: int = 0) -> dict:
    """The launch ``csrc/mac_group.cu`` makes for ``mac_mix_group`` at
    group size ``G`` and ``C_out`` outputs, for the operand form of
    ``ring_bf16`` / ``bank_bf16`` (both 0: float32): ``bins`` and
    ``rows`` a block (``grid_y`` blocks over C_out), ``threads``, the
    ``stages`` of a warp's copy ring and the window ``positions`` a
    stage, dynamic ``smem`` bytes a block, G's column padding
    ``padded_g`` and a position's 16-byte ``chunks``. Asks the built
    library (the card's machine only); the kernel chooses its launch
    there, not here (``mix_group_layout`` mirrors it)."""
    o = (ctypes.c_int * 9)()
    rc = _build.load("mac_group").bf_mac_mix_group_plan(
        G, C_out, ring_bf16, bank_bf16, o)
    if rc != 0:
        raise ValueError(f"mix_group_plan: no plan for G = {G}")
    keys = ("bins", "threads", "rows", "grid_y", "stages", "positions",
            "smem", "padded_g", "chunks")
    return dict(zip(keys, o))


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


def mac_group_reference(ring, xnews, bank, coeff_idx, mask, t, delay,
                        has_bin0: bool = True):
    """Plain torch version of ``mac_group``: per block, the rows it reads
    against the unrotated coefficient partitions, with the bin-0 rule
    where ``has_bin0``."""
    G = xnews.shape[1] + 1
    ring, xnews = widen(ring), widen(xnews)
    H = widen(bank[coeff_idx.long()]) * mask[:, :, None, None]  # [F, B, 2, K]
    return torch.stack([mac_terms(group_rows(ring, xnews, t, delay, g), H,
                                  has_bin0) for g in range(G)])


def mac_mix_group_reference(ring, xnews, bank, coeff_idx, mask, t, w,
                            delay, has_bin0: bool = True):
    """Plain torch version of ``mac_mix_group``: ``mac_group``'s spectra
    through the FP32 output mix."""
    ys = mac_group_reference(ring, xnews, bank, coeff_idx, mask, t, delay,
                             has_bin0)
    return torch.stack([complex_mix(w, y) for y in ys])


def _launch(fn: str, kernel: str, ring, xnews, bank, out, ptrs, dims,
            has_bin0: bool) -> str:
    """Launch ``kernel`` with the operands' bf16 flags and return the
    form's launch-count suffix."""
    G = xnews.shape[1] + 1
    if G > MAX_GROUP:
        raise ValueError(f"{fn}: the kernel takes G <= {MAX_GROUP}, got {G}")
    with torch.cuda.device(ring.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_build.load("mac_group"), kernel)(
            *(x.data_ptr() for x in ptrs), out.data_ptr(), *dims, G,
            int(has_bin0), *bf16_flags(ring, bank), stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed (cudaError {rc})")
    return bf16_suffix(ring, bank)


def mac_group(ring: torch.Tensor, xnews: torch.Tensor, bank: torch.Tensor,
              coeff_idx: torch.Tensor, mask: torch.Tensor, t: torch.Tensor,
              delay: torch.Tensor, has_bin0: bool = True) -> torch.Tensor:
    """Grouped MAC -> ``[G, F, 2, K]`` float32.

    ring [F, B, 2, K] f32 or bf16 (block t written, no later block),
    xnews [F, G-1, 2, K] of the ring's dtype, bank [E, B, 2, K] f32 or
    bf16, coeff_idx [F] int32, mask [F, B] f32, t scalar int32 tensor,
    delay [F] int32; all on one device, contiguous; the bf16 forms need
    ``check_staged``'s alignment."""
    check_operands("mac_group", ring, bank, coeff_idx, mask, t,
                   xnews=xnews, delay=delay)
    check_staged("mac_group", ring, bank, xnews)
    if ring.device.type == "cpu":
        return mac_group_reference(ring, xnews, bank, coeff_idx, mask, t,
                                   delay, has_bin0)
    if ring.device.type != "cuda":
        raise ValueError(f"mac_group: unsupported device {ring.device}")
    F, B, _, K = ring.shape
    G = xnews.shape[1] + 1
    out = torch.empty((G, F, 2, K), dtype=torch.float32, device=ring.device)
    sfx = _launch("mac_group", "bf_mac_group", ring, xnews, bank, out,
                  (ring, xnews, bank, coeff_idx, mask, t, delay),
                  (F, B, K, bank.shape[0]), has_bin0)
    launches["group" + sfx] += 1
    return out


def mac_mix_group(ring: torch.Tensor, xnews: torch.Tensor,
                  bank: torch.Tensor, coeff_idx: torch.Tensor,
                  mask: torch.Tensor, t: torch.Tensor, w: torch.Tensor,
                  delay: torch.Tensor, has_bin0: bool = True) -> torch.Tensor:
    """Grouped fused MAC + output mix -> ``[G, C_out, 2, K]`` float32.
    Operands as ``mac_group``, plus w [C_out, F] f32; the bf16 forms need
    ``check_staged``'s alignment."""
    check_operands("mac_mix_group", ring, bank, coeff_idx, mask, t, w=w,
                   xnews=xnews, delay=delay)
    check_staged("mac_mix_group", ring, bank, xnews)
    if ring.device.type == "cpu":
        return mac_mix_group_reference(ring, xnews, bank, coeff_idx, mask,
                                       t, w, delay, has_bin0)
    if ring.device.type != "cuda":
        raise ValueError(f"mac_mix_group: unsupported device {ring.device}")
    F, B, _, K = ring.shape
    G = xnews.shape[1] + 1
    C_out = w.shape[0]
    out = torch.empty((G, C_out, 2, K), dtype=torch.float32,
                      device=ring.device)
    sfx = _launch("mac_mix_group", "bf_mac_mix_group", ring, xnews, bank,
                  out, (ring, xnews, bank, coeff_idx, mask, t, delay, w),
                  (F, B, K, bank.shape[0], C_out), has_bin0)
    launches["mix_group" + sfx] += 1
    return out
