"""The FFT glue route: the real <-> complex transforms as an M-point
complex FFT (cuFFT) plus one hand-written pass for the Hermitian glue.

The port of ``brutefir_tpu/ops/pallas_glue.py``, which the JAX package
takes under ``BRUTEFIR_TPU_FFT_GLUE=pallas`` where its ``glue_ok`` holds;
the port takes it for every transform, at any M (``partconv.rfft_planes``,
``irfft_planes``, ``irfft_planes_valid``). The 2M-point real
frame's even/odd samples are the real/imaginary parts of M complex points
``z``; with ``Z = fft(z)`` the packed spectrum is
``X[k] = a[k] Z[k] + b[k] conj(Z[(M-k) % M])``, ``a = (1 - iw)/2``,
``b = (1 + iw)/2``, ``w = e^{-i pi k/M}``, and packed bin 0 carries DC in
its real slot and Nyquist (``Re Z0 - Im Z0``) in its imaginary slot. The
inverse builds ``V[k] = a'[k] K[k] + b'[k] R[k]`` from the packed planes
(``K`` the bin, ``R`` the conjugated mirror bin, with DC and Nyquist
unpacked from bin 0; ``a' = (1 + iW)/2``, ``b' = (1 - iW)/2``,
``W = e^{i pi k/M}``), and ``ifft(V)`` (1/M, as ``jnp.fft.ifft``) holds
the time samples as re/im pairs.

``glue_fwd`` (Z -> packed planes) and ``glue_inv`` (packed planes -> V)
launch ``csrc/fft_glue.cu`` on a CUDA tensor and run their plain torch
versions on a CPU tensor; there is no fallback from the kernel to the
plain version on a CUDA tensor: a failed build or launch raises. The
complex FFTs around them are ``torch.fft`` (cuFFT), as the JAX package
leaves them to XLA. Each takes one of two type pairs: complex64 with
float32 planes, or complex128 with float64 planes (``float_bits: 64``:
cuFFT's Z2Z transforms and the kernels' ``_f64`` entries, the table kept
in float64), the port's route where the JAX package's float64 graphs
take ``jnp.fft``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build

# kernel launches per direction, counted where the kernel is launched and
# nowhere else (the smoke run reads them to prove the main path used it)
launches = {"glue_fwd": 0, "glue_inv": 0, "glue_fwd_f64": 0,
            "glue_inv_f64": 0}

# complex dtype -> the real dtype of its planes, and back
_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}
_COMPLEX = {r: c for c, r in _REAL.items()}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=32)
def ab_table(M: int, forward: bool, device,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[M, 4] rows (a.re, a.im, b.re, b.im) of the combine, built in
    float64; for float32 rounded once (as ``pallas_glue._ab_consts``), for
    float64 kept (a float32 table would put a 1e-7 error into every
    float64 spectrum). Cached per (M, direction, device, dtype): building
    it is a host -> device copy."""
    k = np.arange(M)
    if forward:
        w = np.exp(-1j * np.pi * k / M)
        a, b = (1.0 - 1j * w) * 0.5, (1.0 + 1j * w) * 0.5
    else:
        w = np.exp(1j * np.pi * k / M)
        a, b = (1.0 + 1j * w) * 0.5, (1.0 - 1j * w) * 0.5
    tab = np.stack([a.real, a.imag, b.real, b.imag], axis=1)
    real = np.float64 if dtype == torch.float64 else np.float32
    return torch.as_tensor(tab.astype(real)).to(device)


@functools.lru_cache(maxsize=32)
def _mirror(M: int, device) -> torch.Tensor:
    """(M - k) % M for k = 0..M-1: the Hermitian mirror bin."""
    return torch.remainder(M - torch.arange(M, device=device), M)


def glue_fwd_reference(Z: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the forward glue: complex ``Z [..., M]`` ->
    packed planes ``[..., 2, M]`` (pallas_glue.py ``_fwd_kernel`` :89)."""
    M = Z.shape[-1]
    ar, ai, br, bi = ab_table(M, True, Z.device, _REAL[Z.dtype]).unbind(1)
    zr, zi = Z.real, Z.imag
    m = _mirror(M, Z.device)
    mr, mi = zr[..., m], -zi[..., m]                 # conj(Z[(M-k) % M])
    xr = ar * zr - ai * zi + br * mr - bi * mi
    xi = ar * zi + ai * zr + br * mi + bi * mr
    xi[..., 0] = zr[..., 0] - zi[..., 0]             # Nyquist in bin 0
    return torch.stack([xr, xi], dim=-2)


def glue_inv_reference(p: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the inverse glue: packed planes
    ``[..., 2, M]`` -> complex ``V [..., M]``, the input of the M-point
    inverse FFT (pallas_glue.py ``_inv_kernel`` :106)."""
    M = p.shape[-1]
    ar, ai, br, bi = ab_table(M, False, p.device, p.dtype).unbind(1)
    pr, pi = p[..., 0, :], p[..., 1, :]
    m = _mirror(M, p.device)
    ki = pi.clone()
    ki[..., 0] = 0.0                                 # DC is real
    rr, ri = pr[..., m], -pi[..., m]                 # conj(X[M-k])
    rr[..., 0] = pi[..., 0]                          # bin 0's mirror: Nyquist
    ri[..., 0] = 0.0
    vr = ar * pr - ai * ki + br * rr - bi * ri
    vi = ar * ki + ai * pr + br * ri + bi * rr
    return torch.complex(vr, vi)


def check_tensor(fn: str, t: torch.Tensor, dtype) -> None:
    """Raise on what the FFT kernels do not take: another dtype, a
    non-contiguous tensor, a device other than the CPU or a CUDA card."""
    if t.dtype != dtype:
        raise TypeError(f"{fn}: input must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: input must be contiguous (got strides "
                         f"{tuple(t.stride())} for shape {tuple(t.shape)})")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {t.device}")


def _launch(direction: str, src: torch.Tensor, dst: torch.Tensor, C: int,
            M: int, real: torch.dtype) -> None:
    """Launch ``bf_<direction>`` of csrc/fft_glue.cu over C channels, its
    ``_f64`` entry for float64 planes (``real``)."""
    if real == torch.float64:
        direction += "_f64"
    ab = ab_table(M, direction.startswith("glue_fwd"), src.device, real)
    with torch.cuda.device(src.device):
        rc = getattr(_build.load("fft_glue"), f"bf_{direction}")(
            src.data_ptr(), ab.data_ptr(), dst.data_ptr(), C, M,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{direction}: kernel launch failed (cudaError {rc})")
    launches[direction] += 1


def glue_fwd(Z: torch.Tensor) -> torch.Tensor:
    """Forward glue: complex64 (complex128) ``Z [..., M]`` (contiguous)
    -> packed float32 (float64) planes ``[..., 2, M]``."""
    check_tensor("glue_fwd", Z, Z.dtype if Z.dtype in _REAL
                 else torch.complex64)
    if Z.device.type == "cpu":
        return glue_fwd_reference(Z)
    M = Z.shape[-1]
    real = _REAL[Z.dtype]
    out = torch.empty(Z.shape[:-1] + (2, M), dtype=real, device=Z.device)
    _launch("glue_fwd", Z, out, Z.numel() // max(M, 1), M, real)
    return out


def glue_inv(p: torch.Tensor) -> torch.Tensor:
    """Inverse glue: packed float32 (float64) planes ``[..., 2, M]``
    (contiguous) -> complex64 (complex128) ``V [..., M]``."""
    check_tensor("glue_inv", p, p.dtype if p.dtype in _COMPLEX
                 else torch.float32)
    if p.dim() < 2 or p.shape[-2] != 2:
        raise ValueError(f"glue_inv: planes must be [..., 2, M], got "
                         f"{tuple(p.shape)}")
    if p.device.type == "cpu":
        return glue_inv_reference(p)
    M = p.shape[-1]
    v = torch.empty(p.shape[:-2] + (M,), dtype=_COMPLEX[p.dtype],
                    device=p.device)
    _launch("glue_inv", p, v, p.numel() // max(2 * M, 1), M, p.dtype)
    return v


def rfft_planes_glue(x: torch.Tensor) -> torch.Tensor:
    """rfft of real ``x [..., 2M]`` -> packed planes ``[..., 2, M]``: the
    even/odd pairs viewed as M complex points (no copy), cuFFT's M-point
    transform, then the forward glue, which writes the planes directly."""
    M = x.shape[-1] // 2
    z = torch.view_as_complex(x.reshape(x.shape[:-1] + (M, 2)))
    return glue_fwd(torch.fft.fft(z, dim=-1))


def irfft_planes_glue(p: torch.Tensor) -> torch.Tensor:
    """Full inverse: packed planes ``[..., 2, M]`` -> real ``[..., 2M]``."""
    z = torch.fft.ifft(glue_inv(p), dim=-1)
    return torch.view_as_real(z).reshape(z.shape[:-1] + (2 * z.shape[-1],))


def irfft_planes_valid_glue(p: torch.Tensor) -> torch.Tensor:
    """Valid (lower) half of the inverse: packed planes ``[..., 2, M]`` ->
    real ``[..., M]``, the first M/2 complex outputs interleaved."""
    M = p.shape[-1]
    z = torch.fft.ifft(glue_inv(p), dim=-1)[..., : M // 2]
    return torch.view_as_real(z).reshape(z.shape[:-1] + (M,))
