"""The shard forms of the MAC kernels: each kernel per shard of a mesh.

Counterparts of the JAX package's ``shard_map`` wrappers
(brutefir_tpu/ops/pallas_mac.py): the kernel runs on each shard's
``[F/f, B, 2, K/sp]`` ring against the bank's bin shard, on the shard's
device, and the results are assembled on the mesh's first device as the
JAX wrapper's ``out_specs`` say. The packed DC/Nyquist rule belongs to
global bin 0, so only the shards of the first bin range (``j = 0``) call
their kernel with ``has_bin0``.

- ``mac_mix_shard`` <- ``pallas_spectral_mac_mix_shmap`` :1374: the fused
  MAC + mix (``mac_mix``, rows 1-3) per shard, a partial ``[C_out, 2,
  K/sp]`` each; the partials summed over 'f' in the order of ``i`` (the
  psum) and concatenated over 'sp' -> ``[C_out, 2, K]``.
- ``mac_shard`` <- ``pallas_spectral_mac_shmap`` :1417: the unfused MAC
  (``mac``, rows 6, 9, 10 and the float64 form) of a stage's filters,
  each shard on the stage rows it holds, per-filter controls (the JAX
  wrapper has no uniform form) -> ``[Fs, 2, K]`` in stage order. A stage
  subset (a cascade) runs so too, where the JAX package runs its dense MAC.
- ``mac_dual_shard`` <- ``pallas_spectral_mac_dual_shmap`` :542: the dual
  MAC (``mac_dual``, row 8) likewise -> two ``[Fs, 2, K]``.
- ``mac_group_shard`` <- ``pallas_spectral_mac_group_shmap`` :1123: the
  grouped MAC (``mac_group``, row 4) per shard -> ``[G, F, 2, K]``; the
  output mix, and with it the sum over 'f', stays outside, as in the JAX
  package. The fused grouped MAC + mix (row 5) has no shard form there
  either.

Operands split over the mesh are :class:`~brutefir_tpu_torch.parallel.
mesh.Sharded`: the ring (rows and bins), the bank (bins), the per-filter
controls (rows), the mix ``w`` (its filter columns), ``xnews`` (rows and
bins). ``t`` is the block counter on the first device, copied to each
other device. A shard's launch counts in its kernel's ``launches`` like
any other: on the card a shard form launches f x sp kernels.

Each cell's body (the copies of ``t`` and of its index onto its device,
the kernel launch, and the partial it hands back to the first device)
runs in the cell's context (``Mesh.cell``: on the card the cell's own
stream); the form joins the cells (``Mesh.join``) before the first
device assembles the partials, in the order of ``i`` and ``j`` as
before, so every output word is what the cells' sequential run gives.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import to_device
from .mac import mac
from .mac_dual import mac_dual
from .mac_group import mac_group
from .mac_mix import mac_mix
from .partconv import static_index


def _stage_cells(mesh, ring, rows: np.ndarray):
    """Per 'f' shard i holding some of the stage ``rows``: (i, where they
    sit in ``rows``: ("run", (lo, hi)) or ("idx", positions), their local
    rows in the shard)."""
    out = []
    for i, (lo, hi) in enumerate(mesh.rows(ring.shape[0])):
        pos = np.flatnonzero((rows >= lo) & (rows < hi))
        if pos.size == 0:
            continue
        sel = (("run", (int(pos[0]), int(pos[-1]) + 1))
               if pos[-1] - pos[0] + 1 == pos.size
               else ("idx", tuple(pos.tolist())))
        out.append((i, sel, tuple((rows[pos] - lo).tolist())))
    return out


def _assemble(out: torch.Tensor, sel, k0: int, k1: int,
              part: torch.Tensor) -> None:
    """Write a shard's ``part`` [n, 2, k1 - k0], on the first device,
    into ``out`` [Fs, 2, K] at the stage positions ``sel`` and bins
    k0:k1."""
    kind, pos = sel
    if kind == "run":
        out[pos[0]:pos[1], :, k0:k1] = part
    else:
        out[static_index(pos, out.device), :, k0:k1] = part


def _per_cell(mesh, ring, rows: np.ndarray, body) -> list:
    """``body(i, j, local, dev, has_bin0)`` in the context of each cell
    holding some of the stage ``rows``, then the join: [(sel, k0, k1,
    what body handed back)] in the cells' order."""
    K = ring.shape[3]
    out = []
    for i, sel, local in _stage_cells(mesh, ring, rows):
        for j, (k0, k1) in enumerate(mesh.bins(K)):
            if k1 <= k0:
                continue
            with mesh.cell(i, j):
                dev = mesh.devices[i, j]
                out.append((sel, k0, k1, body(
                    i, j, static_index(local, dev, torch.int32), dev,
                    k0 == 0)))
    mesh.join()
    return out


def mac_shard(mesh, ring, bank, rows, coeff_idx, mask,
              t: torch.Tensor) -> torch.Tensor:
    """The unfused MAC of the stage filters ``rows`` (global indices, a
    numpy vector) over the mesh -> ``[Fs, 2, K]`` of the mask's dtype
    (the graph's: float32 beside a bfloat16 ring or bank) on the first
    device, in the order of ``rows``. ``ring`` [F, B, 2, K]
    Sharded (0, 3), ``bank`` [E, B, 2, K] Sharded (None, 3),
    ``coeff_idx`` [F] and ``mask`` [F, B] Sharded (0, None)."""
    rows = np.asarray(rows)
    K = ring.shape[3]

    def body(i, j, local, dev, has_bin0):
        return to_device(mac(ring.parts[i][j], bank.parts[i][j], local,
                             coeff_idx.parts[i][j], mask.parts[i][j],
                             to_device(t, dev), False, has_bin0=has_bin0),
                         mesh.first)

    out = torch.empty((rows.size, 2, K), dtype=mask.dtype,
                      device=mesh.first)
    for sel, k0, k1, y in _per_cell(mesh, ring, rows, body):
        _assemble(out, sel, k0, k1, y)
    return out


def mac_dual_shard(mesh, ring, bank, rows, coeff_idx, mask, prev_idx,
                   prev_mask, t: torch.Tensor, uniform: bool = False):
    """The dual MAC of the stage filters ``rows`` over the mesh ->
    ``(Y_new, Y_old)``, two ``[Fs, 2, K]`` float32 on the first device.
    Operands as ``mac_shard``'s, plus ``prev_idx`` and ``prev_mask``
    Sharded (0, None); ``uniform``: every stage filter reads the first's
    controls (each shard's first local row: the same under uniform
    controls)."""
    rows = np.asarray(rows)
    K = ring.shape[3]

    def body(i, j, local, dev, has_bin0):
        ys = mac_dual(ring.parts[i][j], bank.parts[i][j], local,
                      coeff_idx.parts[i][j], mask.parts[i][j],
                      prev_idx.parts[i][j], prev_mask.parts[i][j],
                      to_device(t, dev), uniform, has_bin0=has_bin0)
        return [to_device(y, mesh.first) for y in ys]

    y_new = torch.empty((rows.size, 2, K), dtype=torch.float32,
                        device=mesh.first)
    y_old = torch.empty_like(y_new)
    for sel, k0, k1, (yn, yo) in _per_cell(mesh, ring, rows, body):
        _assemble(y_new, sel, k0, k1, yn)
        _assemble(y_old, sel, k0, k1, yo)
    return y_new, y_old


def mac_mix_shard(mesh, ring, bank, coeff_idx, mask, t: torch.Tensor, w,
                  uniform: bool = False) -> torch.Tensor:
    """The fused MAC + output mix over the mesh -> ``[C_out, 2, K]``
    float32 on the first device: per shard a partial ``[C_out, 2, K/sp]``
    against the shard's columns of ``w`` ([C_out, F] Sharded (1, None)),
    summed over 'f' in the order of ``i``, concatenated over 'sp'.
    ``uniform``: every filter reads coeff_idx[0] and mask[0] (each
    shard's first row: the same under uniform controls)."""
    K = ring.shape[3]
    parts = []                      # per bin shard j, the partials by i
    for j, (k0, k1) in enumerate(mesh.bins(K)):
        if k1 <= k0:
            continue
        parts.append([])
        for i, (r0, r1) in enumerate(mesh.rows(ring.shape[0])):
            if r1 <= r0:
                continue
            with mesh.cell(i, j):
                dev = mesh.devices[i, j]
                parts[-1].append(to_device(
                    mac_mix(ring.parts[i][j], bank.parts[i][j],
                            coeff_idx.parts[i][j], mask.parts[i][j],
                            to_device(t, dev), w.parts[i][j], uniform,
                            has_bin0=(k0 == 0)), mesh.first))
    mesh.join()
    cols = []
    for col in parts:
        acc = None
        for part in col:
            acc = part if acc is None else acc + part
        cols.append(acc)
    return cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)


def mac_group_shard(mesh, ring, xnews, bank, coeff_idx, mask,
                    t: torch.Tensor, delay) -> torch.Tensor:
    """The grouped MAC of G blocks over the mesh -> ``[G, F, 2, K]``
    float32 on the first device (the output mix runs outside). ``xnews``
    [F, G-1, 2, K] Sharded (0, 3), ``delay`` [F] Sharded (0, None); the
    rest as ``mac_shard``'s."""
    F, B, _, K = ring.shape
    G = xnews.shape[1] + 1
    parts = []
    for i, (r0, r1) in enumerate(mesh.rows(F)):
        if r1 <= r0:
            continue
        for j, (k0, k1) in enumerate(mesh.bins(K)):
            if k1 <= k0:
                continue
            with mesh.cell(i, j):
                dev = mesh.devices[i, j]
                parts.append((r0, r1, k0, k1, to_device(
                    mac_group(ring.parts[i][j], xnews.parts[i][j],
                              bank.parts[i][j], coeff_idx.parts[i][j],
                              mask.parts[i][j], to_device(t, dev),
                              delay.parts[i][j], has_bin0=(k0 == 0)),
                    mesh.first)))
    mesh.join()
    out = torch.empty((G, F, 2, K), dtype=torch.float32, device=mesh.first)
    for r0, r1, k0, k1, y in parts:
        out[:, r0:r1, :, k0:k1] = y
    return out
