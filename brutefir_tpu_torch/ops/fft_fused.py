"""The fused real FFT: the whole packed real transform of a channel in one
hand-written kernel, output in a digit-permuted bin order.

The port of ``brutefir_tpu/ops/pallas_fft.py``. Like there, it is not
wired into the engine: its path is the A/B probe (``chip_smoke.py``'s
fused-FFT phase, in place of ``tools/fused_fft_probe.py``) and the tests.
Using it in the engine would mean carrying the bank and the ring in the
permuted order, which the JAX package does not do either.

Tile position ``p = k1 * 128 + k2`` holds natural bin ``k = k2 * R + k1``
(``R = M / 128``): ``X_perm = X_nat[..., bin_order(M)]``.

On a CUDA tensor the three transforms launch ``csrc/fft_fused.cu`` (a
Stockham FFT in shared memory with the Hermitian glue of
:mod:`brutefir_tpu_torch.ops.fft_glue` in the same kernel); on a CPU
tensor they run the plain torch versions below, which take the same
stages in the same order (:func:`stockham`). There is no fallback from
the kernel to the plain version on a CUDA tensor: a failed build or
launch raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .fft_glue import (ab_table, check_tensor, glue_fwd_reference,
                       glue_inv_reference)

_LANES = 128

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
def _ab_perm(M: int, device) -> torch.Tensor:
    """The forward combine table in the permuted order (row p holds bin
    ``bin_order(M)[p]``), so that the kernel reads it in order."""
    return ab_table(M, True, device)[_order(M, False, device)].contiguous()


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


def stockham(z: torch.Tensor, sign: int) -> torch.Tensor:
    """The M-point DFT of complex ``z [..., M]`` (``sign = -1``) or its
    unnormalised inverse (``sign = +1``) as the kernel computes it:
    Stockham autosort stages, stage by stage in the kernel's order, each
    ``y[(i-k) r + k + q p] = sum_m x[i + m M/r] e^{sign 2 pi i m (k+qp)/(pr)}``
    with k = i mod p, radix 4 and 2 as twiddle-then-butterfly."""
    M = z.shape[-1]
    tw = twiddles(M, z.device)
    if sign > 0:
        tw = tw.conj().resolve_conj()
    p = 1
    for r in radices(M):
        n, step = M // r, M // (p * r)
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


def rfft_planes_fused_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`rfft_planes_fused`."""
    M = x.shape[-1] // 2
    z = torch.view_as_complex(x.reshape(x.shape[:-1] + (M, 2)))
    X = glue_fwd_reference(stockham(z, -1))
    return X[..., _order(M, False, x.device)]


def irfft_planes_fused_reference(p: torch.Tensor,
                                 n_out: int | None = None) -> torch.Tensor:
    """Plain torch version of the inverse: the first ``n_out`` complex
    outputs (default M: the whole frame; M/2: the valid half) as
    ``[..., 2 n_out]`` real samples."""
    M = p.shape[-1]
    n_out = M if n_out is None else n_out
    v = glue_inv_reference(p[..., _order(M, True, p.device)])
    z = stockham(v, 1)[..., :n_out]
    return torch.view_as_real(z).reshape(z.shape[:-1] + (2 * n_out,)) * (
        1.0 / M)


def _check(fn: str, t: torch.Tensor, M: int) -> None:
    if not fused_ok(M, t.dtype):
        raise ValueError(f"{fn}: needs float32 and M % 128 == 0, M >= 256 "
                         f"(got M = {M}, {t.dtype})")
    check_tensor(fn, t, torch.float32)
    if t.data_ptr() % 8:
        raise ValueError(f"{fn}: input must be 8-byte aligned")


def _launch(name: str, src: torch.Tensor, table: torch.Tensor,
            out: torch.Tensor, C: int, M: int, *extra) -> None:
    """Launch ``bf_<name>`` of csrc/fft_fused.cu over C channels, with a
    scratch buffer in device memory where the kernel says that a
    channel's two buffers outgrow a block's shared memory."""
    dev = src.device
    lib = _build.load("fft_fused")
    scratch = (torch.empty((C, 2 * M), dtype=torch.complex64, device=dev)
               if lib.bf_fft_fused_needs_scratch(M) else None)
    with torch.cuda.device(dev):
        rc = getattr(lib, f"bf_{name}")(
            src.data_ptr(), twiddles(M, dev).data_ptr(), table.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            C, M, *extra, torch.cuda.current_stream().cuda_stream)
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
    _launch("fft_fused_fwd", x, _ab_perm(M, x.device), out,
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
    _launch("fft_fused_inv", p, ab_table(M, False, p.device), out,
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
