"""The fused real FFT: the whole packed real transform of a channel in one
hand-written kernel, output in a digit-permuted bin order.

The port of ``brutefir_tpu/ops/pallas_fft.py``. Like there, it is not
wired into the engine: its path is the A/B probe (``chip_smoke.py``'s
fused-FFT phase, in place of ``tools/fused_fft_probe.py``) and the tests.
Using it in the engine would mean carrying the bank and the ring in the
permuted order, which the JAX package does not do either.

Tile position ``p = k1 * 128 + k2`` holds natural bin ``k = k2 * R + k1``
(``R = M / 128``): ``X_perm = X_nat[..., bin_order(M)]``. That is the
natural output order of a four-step transform ``M = R x 128``: R-point
DFTs down the 128 columns ``n2`` of ``z[n1 * 128 + n2]``, the twiddle
``W_M^{n2 k1}``, then 128-point DFTs along the R rows ``k1``.

On a CUDA tensor the three transforms launch ``csrc/fft_fused.cu`` (the
four-step transform of one channel split over a thread-block cluster of
:func:`cluster_size` blocks, with the Hermitian glue of
:mod:`brutefir_tpu_torch.ops.fft_glue` in the same kernel); on a CPU
tensor they run the plain torch versions below, which take the same
stages in the same order (:func:`stockham` down the columns,
:func:`row_dft` along the rows). There is no fallback from the kernel to
the plain version on a CUDA tensor: a failed build or launch raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .fft_glue import (ab_table, check_tensor, glue_fwd_reference,
                       glue_inv_reference)

_LANES = 128
SMEM_MAX = 232448       # bytes of shared memory a block may have (227 KB)
BLOCKS_PER_SM = 6       # the kernels' resident blocks on one SM (kMinBlocks)

# kernel launches per direction, counted where the kernel is launched and
# nowhere else (the smoke run reads them to prove the probe path used it)
launches = {"fft_fused_fwd": 0, "fft_fused_inv": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def fused_ok(M: int, dtype) -> bool:
    """The JAX package's eligibility (pallas_fft.py:73-74)."""
    return dtype == torch.float32 and M % _LANES == 0 and M >= 2 * _LANES


def bin_order(M: int) -> np.ndarray:
    """Gather indices turning a natural-order packed spectrum into the
    digit-permuted order: ``X_perm = X_nat[..., bin_order(M)]``."""
    R = M // _LANES
    p = np.arange(M)
    return (p % _LANES) * R + (p // _LANES)


def bin_order_inv(M: int) -> np.ndarray:
    """Inverse gather: ``X_nat = X_perm[..., bin_order_inv(M)]``."""
    return np.argsort(bin_order(M))


def cluster_size(M: int, C: int = 1, sms: int = 132) -> int:
    """Blocks of the cluster that splits one channel (S divides 128: each
    block owns 128/S columns). 8, the portable maximum, from R = M/128 = 8
    rows up, else 4 or 2 (at most R). Where C clusters of 8 would not all
    be resident at once on ``sms`` SMs (C x 8 > sms x BLOCKS_PER_SM) and a
    block's share at 4 still fits its shared memory, 4: fewer, larger
    blocks then take fewer waves (``chip_fft_clusters.py`` times both)."""
    R = M // _LANES
    S = 8 if R >= 8 else 4 if R >= 4 else 2
    if S == 8 and C * 8 > sms * BLOCKS_PER_SM and not needs_scratch(M, 4):
        S = 4
    return S


def smem_bytes(M: int, S: int) -> int:
    """Shared memory a block of a cluster of S needs: two buffers
    (ping-pong of the column DFTs) of R x 128/S complex points, and the
    tables W_R and W_128."""
    R = M // _LANES
    return 8 * (2 * M // S + R + _LANES)


def needs_scratch(M: int, S: int) -> bool:
    """True where that outgrows a block's shared memory (M past 112128 at
    S = 8): the kernels then keep the two buffers in a device-memory
    scratch buffer and the row phase reads the peers' share there."""
    return smem_bytes(M, S) > SMEM_MAX


def cluster_rows(M: int, S: int) -> list:
    """The rows k1 each block of a cluster of S transforms (index: the
    block's rank), as the kernel assigns them: row unit u holds row u and
    its Hermitian mirror row R - u (one row where u = 0 or u = R - u), and
    block ``u % S`` takes unit u. Each block's set is closed under
    k1 -> (R - k1) % R, so both rows of a mirror pair meet in one warp."""
    R = M // _LANES
    rows = [[] for _ in range(S)]
    for u in range(R // 2 + 1):
        rows[u % S] += [u] if u in (0, R - u) else [u, R - u]
    return rows


@functools.lru_cache(maxsize=16)
def _order(M: int, inverse: bool, device) -> torch.Tensor:
    return torch.as_tensor(bin_order_inv(M) if inverse
                           else bin_order(M)).to(device)


@functools.lru_cache(maxsize=16)
def twiddles(M: int, device) -> torch.Tensor:
    """``e^{-2 pi i j / M}`` for j < M as complex64, built in float64 and
    rounded once; cached per (M, device)."""
    return torch.as_tensor(
        np.exp(-2j * np.pi * np.arange(M) / M).astype(np.complex64)).to(device)


@functools.lru_cache(maxsize=16)
def _ab_rows(M: int, forward: bool, device) -> torch.Tensor:
    """A combine table ([M, 4]) for the kernel's row phase: the bins of
    permuted row k1 (position p = k1 * 128 + 4 q + r holds bin
    ``bin_order(M)[p]``) stored at k1 * 128 + 32 r + q, so that the lanes
    of a warp (q = brev5(lane)) read 512 contiguous bytes for each r."""
    ab = ab_table(M, forward, device)[_order(M, False, device)]
    return ab.reshape(M // _LANES, 32, 4, 4).transpose(1, 2).reshape(
        M, 4).contiguous()


@functools.lru_cache(maxsize=16)
def _stage_twiddles(M: int, device) -> torch.Tensor:
    """W_R^j (j < R) then W_128^j (j < 128): every 128th and every R-th
    entry of :func:`twiddles`, the tables of the column and row stages,
    contiguous so that a block copies them into shared memory in order."""
    tw = twiddles(M, device)
    return torch.cat([tw[::_LANES], tw[::M // _LANES]]).contiguous()


@functools.lru_cache(maxsize=16)
def _row_twiddles(M: int, device) -> torch.Tensor:
    """[R, 128] four-step twiddles ``W_M^{n2 k1}``: entry n2 * k1 (below
    M) of :func:`twiddles`, gathered into rows so that a warp reads row
    k1 contiguously."""
    R = M // _LANES
    idx = (torch.arange(R, device=device)[:, None]
           * torch.arange(_LANES, device=device)[None, :])
    return twiddles(M, device)[idx].contiguous()


def radices(M: int) -> list:
    """The Stockham stages' radices: 4 while it divides, then 2, then the
    odd factors in ascending order (csrc/fft_fused.cu ``next_radix``)."""
    out, rem = [], M
    while rem > 1:
        if rem % 4 == 0:
            r = 4
        elif rem % 2 == 0:
            r = 2
        else:
            r = 3
            while rem % r:
                r += 2
        out.append(r)
        rem //= r
    return out


def stockham(z: torch.Tensor, sign: int,
             tw: torch.Tensor | None = None) -> torch.Tensor:
    """The N-point DFT of complex ``z [..., N]`` (``sign = -1``) or its
    unnormalised inverse (``sign = +1``) as the kernel's column phase
    computes it: Stockham autosort stages, stage by stage in the kernel's
    order, each ``y[(i-k) r + k + q p] = sum_m x[i + m N/r]
    e^{sign 2 pi i m (k+qp)/(pr)}`` with k = i mod p, radix 4 and 2 as
    twiddle-then-butterfly. ``tw`` is the table ``e^{-2 pi i j / N}``
    (default :func:`twiddles` of N; the kernel's columns read every
    128th entry of the M-point table)."""
    N = z.shape[-1]
    if tw is None:
        tw = twiddles(N, z.device)
    if sign > 0:
        tw = tw.conj().resolve_conj()
    p = 1
    for r in radices(N):
        n, step = N // r, N // (p * r)
        i = torch.arange(n, device=z.device)
        k = i % p
        j = (i - k) * r + k
        xs = [z[..., m * n:(m + 1) * n] for m in range(r)]
        y = torch.empty_like(z)
        if r == 4:
            x1, x2, x3 = (xs[m] * tw[m * k * step] for m in (1, 2, 3))
            a0, a1 = xs[0] + x2, xs[0] - x2
            b0, d = x1 + x3, x1 - x3
            b1 = (torch.complex(d.imag, -d.real) if sign < 0
                  else torch.complex(-d.imag, d.real))
            y[..., j], y[..., j + p] = a0 + b0, a1 + b1
            y[..., j + 2 * p], y[..., j + 3 * p] = a0 - b0, a1 - b1
        elif r == 2:
            x1 = xs[1] * tw[k * step]
            y[..., j], y[..., j + p] = xs[0] + x1, xs[0] - x1
        else:
            for q in range(r):
                e = k + q * p
                acc = xs[0]
                for m in range(1, r):
                    acc = acc + xs[m] * tw[((m * e) % (p * r)) * step]
                y[..., j + q * p] = acc
        z, p = y, p * r
    return z


def _dft4(v: torch.Tensor, sign: int) -> torch.Tensor:
    """The 4-point DFT (or unnormalised inverse) over dim -2 of size 4,
    as one radix-4 butterfly."""
    a0, a1 = v[..., 0, :] + v[..., 2, :], v[..., 0, :] - v[..., 2, :]
    b0, d = v[..., 1, :] + v[..., 3, :], v[..., 1, :] - v[..., 3, :]
    b1 = (torch.complex(d.imag, -d.real) if sign < 0
          else torch.complex(-d.imag, d.real))
    return torch.stack([a0 + b0, a1 + b1, a0 - b0, a1 - b1], dim=-2)


def row_dft(y: torch.Tensor, sign: int, tw: torch.Tensor) -> torch.Tensor:
    """The 128-point DFT (``sign = -1``) or its unnormalised inverse
    (``+1``) of each row of ``y [..., 128]``, natural order in and out,
    as a warp of the kernel computes it (32 lanes l, 4 points a lane).
    Forward: the 4-point DFT over j of ``y[l + 32 j]``, the twiddle
    ``W_128^{l r}``, then five radix-2 decimation-in-frequency stages over
    l (partner lane l ^ h, h = 16 ... 1), after which lane l, register r
    holds bin ``r + 4 brev5(l)``. The inverse runs the mirror image:
    decimation-in-time stages (h = 1 ... 16) from that layout, the
    conjugate twiddle, the 4-point inverse into ``y[l + 32 j]``. ``tw``
    is the M-point table: ``W_128`` is every R-th entry."""
    R = tw.shape[-1] // _LANES
    if sign > 0:
        tw = tw.conj().resolve_conj()
    dev = y.device
    lane = torch.arange(32, device=dev)
    r = torch.arange(4, device=dev)[:, None]
    brev = torch.as_tensor([int(f"{i:05b}"[::-1], 2) for i in range(32)],
                           device=dev)
    if sign < 0:
        v = _dft4(y.reshape(y.shape[:-1] + (4, 32)), sign)   # [r, l]
        v = v * tw[lane * r * R]
        for h in (16, 8, 4, 2, 1):
            hi = (lane & h) != 0
            o = v[..., lane ^ h]
            v = torch.where(hi, (o - v) * tw[(lane & (h - 1)) * (64 // h) * R],
                            v + o)
        # v[r, l] = X[r + 4 brev(l)]: X as [q, r] is v[r, brev(q)]
        return v[..., brev].transpose(-1, -2).reshape(y.shape)
    v = y.reshape(y.shape[:-1] + (32, 4)).transpose(-1, -2)[..., brev]
    for h in (1, 2, 4, 8, 16):
        hi = (lane & h) != 0
        t = torch.where(hi, v * tw[(lane & (h - 1)) * (64 // h) * R], v)
        o = t[..., lane ^ h]
        v = torch.where(hi, o - t, v + o)
    v = _dft4(v * tw[lane * r * R], sign)                   # [j, l]
    return v.reshape(y.shape)


def rfft_planes_fused_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`rfft_planes_fused`, the kernel's
    stages in its order: column DFTs (``z`` as [n1, n2], R-point Stockham
    down each column n2), the twiddle ``W_M^{n2 k1}``, the row DFTs, the
    forward glue."""
    M = x.shape[-1] // 2
    R, dev = M // _LANES, x.device
    lead = x.shape[:-1]
    tw = twiddles(M, dev)
    z = torch.view_as_complex(x.reshape(lead + (M, 2)))
    cols = z.reshape(lead + (R, _LANES)).transpose(-1, -2)    # [n2, n1]
    y = stockham(cols, -1, tw[::_LANES]).transpose(-1, -2)    # [k1, n2]
    Z = row_dft(y * _row_twiddles(M, dev), -1, tw).reshape(lead + (M,))
    # Z is in the permuted order; the glue reads each bin and its mirror
    return glue_fwd_reference(Z[..., _order(M, True, dev)])[
        ..., _order(M, False, dev)]


def irfft_planes_fused_reference(p: torch.Tensor,
                                 n_out: int | None = None) -> torch.Tensor:
    """Plain torch version of the inverse: the first ``n_out`` complex
    outputs (default M: the whole frame; M/2: the valid half) as
    ``[..., 2 n_out]`` real samples. The kernel's stages in its order:
    the inverse glue, the row inverse DFTs, the twiddle ``W_M^{-n2 k1}``,
    the column inverse DFTs (Stockham over k1), the scale 1/M."""
    M = p.shape[-1]
    R, dev = M // _LANES, p.device
    n_out = M if n_out is None else n_out
    lead = p.shape[:-2]
    tw = twiddles(M, dev)
    V = glue_inv_reference(p[..., _order(M, True, dev)])[
        ..., _order(M, False, dev)]
    y = row_dft(V.reshape(lead + (R, _LANES)), 1, tw)       # [k1, n2]
    y = y * _row_twiddles(M, dev).conj()
    z = stockham(y.transpose(-1, -2), 1, tw[::_LANES])       # [n2, n1]
    z = z.transpose(-1, -2).reshape(lead + (M,))[..., :n_out]
    return torch.view_as_real(z).reshape(lead + (2 * n_out,)) * (1.0 / M)


@functools.lru_cache(maxsize=8)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(fn: str, t: torch.Tensor, M: int) -> None:
    if not fused_ok(M, t.dtype):
        raise ValueError(f"{fn}: needs float32 and M % 128 == 0, M >= 256 "
                         f"(got M = {M}, {t.dtype})")
    check_tensor(fn, t, torch.float32)
    if t.data_ptr() % 16:
        raise ValueError(f"{fn}: input must be 16-byte aligned")


def _launch(name: str, src: torch.Tensor, table: torch.Tensor,
            out: torch.Tensor, C: int, M: int, *extra) -> None:
    """Launch ``bf_<name>`` of csrc/fft_fused.cu over C channels, one
    cluster of :func:`cluster_size` blocks a channel, with a scratch
    buffer in device memory where :func:`needs_scratch` says so."""
    dev = src.device
    S = cluster_size(M, C, _sm_count(dev))
    scratch = (torch.empty((C, 2 * M), dtype=torch.complex64, device=dev)
               if needs_scratch(M, S) else None)
    with torch.cuda.device(dev):
        rc = getattr(_build.load("fft_fused"), f"bf_{name}")(
            src.data_ptr(), _stage_twiddles(M, dev).data_ptr(),
            _row_twiddles(M, dev).data_ptr(), table.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            C, M, *extra, S, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    launches[name] += 1


def rfft_planes_fused(x: torch.Tensor) -> torch.Tensor:
    """Real ``x [..., 2M]`` -> packed planes ``[..., 2, M]`` in the
    digit-permuted order."""
    M = x.shape[-1] // 2
    _check("rfft_planes_fused", x, M)
    if x.device.type == "cpu":
        return rfft_planes_fused_reference(x)
    out = torch.empty(x.shape[:-1] + (2, M), dtype=torch.float32,
                      device=x.device)
    _launch("fft_fused_fwd", x, _ab_rows(M, True, x.device), out,
            x.numel() // (2 * M), M)
    return out


def _inv(p: torch.Tensor, n_out: int, fn: str) -> torch.Tensor:
    M = p.shape[-1]
    _check(fn, p, M)
    if p.dim() < 2 or p.shape[-2] != 2:
        raise ValueError(f"{fn}: planes must be [..., 2, M], got "
                         f"{tuple(p.shape)}")
    if p.device.type == "cpu":
        return irfft_planes_fused_reference(p, n_out)
    out = torch.empty(p.shape[:-2] + (2 * n_out,), dtype=torch.float32,
                      device=p.device)
    _launch("fft_fused_inv", p, _ab_rows(M, False, p.device), out,
            p.numel() // (2 * M), M, n_out)
    return out


def irfft_planes_fused(p: torch.Tensor) -> torch.Tensor:
    """Digit-permuted packed planes ``[..., 2, M]`` -> real ``[..., 2M]``."""
    return _inv(p, p.shape[-1], "irfft_planes_fused")


def irfft_planes_valid_fused(p: torch.Tensor) -> torch.Tensor:
    """Valid (lower) half of the inverse -> real ``[..., M]``: the kernel
    writes the first M/2 complex outputs at any M (the JAX package runs
    the full inverse and slices where M/128 is odd, pallas_fft.py:286-287,
    because of how its TPU kernel is tiled)."""
    return _inv(p, p.shape[-1] // 2, "irfft_planes_valid_fused")
