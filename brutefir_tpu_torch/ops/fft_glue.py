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
plain version on a CUDA tensor: a failed build or launch raises.
``glue_fwd_ring`` and ``glue_fwd_into`` are the engine's forward route:
the input mix runs on cuFFT's M-point output ``fft_points(x)`` (the glue
is linear bin by bin and the mix real, so the two commute), and one
launch glues the mixed spectra straight into the spectra ring at each
filter's delayed slot, cast to the ring's dtype (``glue_fwd_ring``), or
into a strided destination (``glue_fwd_into``). The
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
            "glue_inv_f64": 0, "glue_fwd_ring": 0, "glue_fwd_ring_bf16": 0,
            "glue_fwd_ring_f64": 0}

# complex dtype -> the real dtype of its planes, and back
_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}
_COMPLEX = {r: c for c, r in _REAL.items()}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def ab_table(M: int, forward: bool, device,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[M, 4] rows (a.re, a.im, b.re, b.im) of the combine, built in
    float64; for float32 rounded once (as ``pallas_glue._ab_consts``), for
    float64 kept (a float32 table would put a 1e-7 error into every
    float64 spectrum). Cached per (M, direction, device, dtype): building
    it is a host -> device copy. Never evicted: a captured step program
    (``runtime/program.py``) reads it at its address."""
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


def fft_points(x: torch.Tensor) -> torch.Tensor:
    """The route's first half: real ``x [..., 2M]`` -> complex ``Z [...,
    M]``, the even/odd pairs viewed as M complex points (no copy) and
    cuFFT's M-point transform."""
    M = x.shape[-1] // 2
    z = torch.view_as_complex(x.reshape(x.shape[:-1] + (M, 2)))
    return torch.fft.fft(z, dim=-1)


def rfft_planes_glue(x: torch.Tensor) -> torch.Tensor:
    """rfft of real ``x [..., 2M]`` -> packed planes ``[..., 2, M]``:
    ``fft_points``, then the forward glue, which writes the planes
    directly."""
    return glue_fwd(fft_points(x))


def glue_fwd_ring_reference(Zm: torch.Tensor, ring: torch.Tensor, rows,
                            delay: torch.Tensor, t: torch.Tensor,
                            dt: int = 0) -> None:
    """Plain torch version of ``glue_fwd_ring``: ``glue_fwd_reference``,
    the cast to the ring's dtype, and the ring write's index arithmetic
    (row f at ``ring[rows[f], (t + dt + delay[rows[f]]) % B]``)."""
    blk = glue_fwd_reference(Zm).to(ring.dtype)
    r = (torch.arange(Zm.shape[0], device=Zm.device) if rows is None
         else rows.long())
    tt = t if dt == 0 else t + dt
    wpos = torch.remainder(tt + delay[r], ring.shape[1]).long()
    ring.index_put_((r, wpos), blk)


def glue_fwd_into_reference(Zm: torch.Tensor, dst: torch.Tensor) -> None:
    """Plain torch version of ``glue_fwd_into``."""
    dst.copy_(glue_fwd_reference(Zm))


def _check_points(fn: str, Zm: torch.Tensor, dst: torch.Tensor) -> None:
    """Raise on what ``bf_glue_fwd_ring`` does not take: ``Zm`` complex64
    (complex128) ``[Fs, M]`` contiguous, ``dst`` float32 or bfloat16
    (float64) on Zm's device."""
    check_tensor(fn, Zm, Zm.dtype if Zm.dtype in _REAL else torch.complex64)
    if Zm.dim() != 2:
        raise ValueError(f"{fn}: spectra must be [Fs, M], got "
                         f"{tuple(Zm.shape)}")
    ok = ((torch.float32, torch.bfloat16) if Zm.dtype == torch.complex64
          else (torch.float64,))
    if dst.dtype not in ok:
        raise TypeError(f"{fn}: {Zm.dtype} spectra cannot land in a "
                        f"{dst.dtype} destination")
    if dst.device != Zm.device:
        raise ValueError(f"{fn}: spectra on {Zm.device}, destination on "
                         f"{dst.device}")


def _launch_ring(Zm, dst, rows, delay, t, dt: int, B: int,
                 row_stride: int) -> None:
    """Launch ``bf_glue_fwd_ring`` (``_f64``) over Zm's rows into
    ``dst``; count it under ``glue_fwd_ring`` and the destination's
    dtype."""
    Fs, M = Zm.shape
    f64 = Zm.dtype == torch.complex128
    ab = ab_table(M, True, Zm.device, _REAL[Zm.dtype])
    ptr = [Zm.data_ptr(), ab.data_ptr(), dst.data_ptr(),
           0 if rows is None else rows.data_ptr(),
           0 if delay is None else delay.data_ptr(),
           0 if t is None else t.data_ptr(), dt, Fs, M, B, row_stride]
    bf16 = dst.dtype == torch.bfloat16
    with torch.cuda.device(Zm.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = _build.load("fft_glue")
        rc = (lib.bf_glue_fwd_ring_f64(*ptr, stream) if f64
              else lib.bf_glue_fwd_ring(*ptr, int(bf16), stream))
    if rc != 0:
        raise RuntimeError(f"glue_fwd_ring: kernel launch failed (cudaError "
                           f"{rc})")
    launches["glue_fwd_ring" + ("_f64" if f64 else "_bf16" if bf16
                                else "")] += 1


def glue_fwd_ring(Zm: torch.Tensor, ring: torch.Tensor, rows,
                  delay: torch.Tensor, t: torch.Tensor, dt: int = 0) -> None:
    """The forward glue of the mixed M-point spectra ``Zm [Fs, M]``
    (complex64, or complex128 for a float64 ring), written in place into
    the ring ``[F, B, 2, M]`` (float32, bfloat16 rounded to nearest even,
    or float64): row f at ``ring[rows[f], (t + dt + delay[rows[f]]) %
    B]``. ``rows``: an int32 ``[Fs]`` index of the ring's rows, or None
    for rows 0..Fs-1; ``delay`` int32 ``[F]`` and ``t`` an int32 scalar,
    read by the kernel from device memory (no host sync); ``dt`` a host
    offset of ``t``. Everything contiguous, on one device."""
    _check_points("glue_fwd_ring", Zm, ring)
    Fs, M = Zm.shape
    if ring.dim() != 4 or ring.shape[2:] != (2, M) or not \
            ring.is_contiguous():
        raise ValueError(f"glue_fwd_ring: ring must be a contiguous "
                         f"[F, B, 2, {M}], got {tuple(ring.shape)}")
    F, B = ring.shape[:2]
    if rows is None and Fs > F:
        raise ValueError(f"glue_fwd_ring: {Fs} rows into a ring of {F}")
    for name, v, n in (("rows", rows, Fs), ("delay", delay, F), ("t", t, 1)):
        if v is not None and (v.dtype != torch.int32 or v.numel() != n
                              or not v.is_contiguous()
                              or v.device != Zm.device):
            raise ValueError(f"glue_fwd_ring: {name} must be a contiguous "
                             f"int32 tensor of {n} on {Zm.device}")
    if Zm.device.type == "cpu":
        glue_fwd_ring_reference(Zm, ring, rows, delay, t, dt)
        return
    _launch_ring(Zm, ring, rows, delay, t, dt, B, B * 2 * M)


def glue_fwd_into(Zm: torch.Tensor, dst: torch.Tensor) -> None:
    """The forward glue of ``Zm [Fs, M]`` written into ``dst [Fs, 2, M]``
    (float32, bfloat16 or float64 as for ``glue_fwd_ring``), whose rows
    may lie any stride apart (a block of the grouped dispatch's ``xnews
    [F, G-1, 2, M]``) but whose planes are contiguous: the same kernel
    with slot addressing off, counted with ``glue_fwd_ring``."""
    _check_points("glue_fwd_into", Zm, dst)
    Fs, M = Zm.shape
    if (dst.shape != (Fs, 2, M) or dst.stride(2) != 1
            or dst.stride(1) != M):
        raise ValueError(f"glue_fwd_into: destination must be [{Fs}, 2, "
                         f"{M}] with contiguous planes, got shape "
                         f"{tuple(dst.shape)} strides {tuple(dst.stride())}")
    if Zm.device.type == "cpu":
        glue_fwd_into_reference(Zm, dst)
        return
    _launch_ring(Zm, dst, None, None, None, 0, 0, dst.stride(0))


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
