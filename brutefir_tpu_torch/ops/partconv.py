"""Partitioned overlap-save convolution primitives (torch).

Twin of :mod:`brutefir_tpu.ops.partconv`; see its docstring for the
reference conventions (upper-half coefficient placement, valid lower half
of the inverse transform, ``Y[t] = sum_i X[(t-i) mod B] * H[i]``).

**Packed spectra.** Spectra use a packed N-bin layout: the real Nyquist
bin rides in the imaginary slot of the real DC bin
(``Xp[0] = X[0].re + 1j X[N].re``). Bin 0 of a packed spectral product
multiplies real and imaginary parts *separately* (two independent real
spectra), the d1s/d2s special case of the reference kernels.

On the device spectra are separate real/imag float planes ``[..., 2, N]``
(plane axis second-to-last), the layout the MAC kernel reads.

The FFTs are cuFFT (``torch.fft``) and the channel mixes ``torch.matmul``
in full FP32, as the JAX package left them to XLA. The plain MACs below
are the correctness baseline for the CUDA kernels in
:mod:`brutefir_tpu_torch.ops.mac_mix`, ``mac_group``, ``mac`` and
``mac_dual``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


# --- numpy helpers (host-side coefficient preprocessing) --------------------

def pack_spectrum(H: np.ndarray) -> np.ndarray:
    """[..., N+1] rfft spectrum -> packed [..., N]."""
    dc = H[..., :1].real + 1j * H[..., -1:].real
    return np.concatenate([dc.astype(H.dtype), H[..., 1:-1]], axis=-1)


def np_c2p(z: np.ndarray) -> np.ndarray:
    """complex [..., N] -> float planes [..., 2, N] (numpy)."""
    return np.ascontiguousarray(np.stack([z.real, z.imag], axis=-2))


def np_p2c(p: np.ndarray) -> np.ndarray:
    """float planes [..., 2, N] -> packed complex [..., N] (numpy)."""
    return p[..., 0, :] + 1j * p[..., 1, :]


def make_bank(entries) -> np.ndarray:
    """Stack per-coeff packed complex entries [B, N] into the device bank
    layout [n_entries, B, 2, N] float planes."""
    return np_c2p(np.stack(entries))


def preprocess_coeffs(taps: np.ndarray, block_length: int, n_blocks: int,
                      scale: float = 1.0, dtype=np.float32) -> np.ndarray:
    """Host-side coefficient preprocessing.

    Splits ``taps`` (1-D) into ``n_blocks`` partitions of ``block_length``,
    zero-padding the tail, and returns the *packed* spectral coefficient
    bank ``H [n_blocks, block_length] complex`` (upper-half placement
    absorbed as the (-1)^k factor; Nyquist packed into bin 0). ``scale``
    is the linear attenuation applied to the taps. Raises ValueError on
    NaN/Inf taps.
    """
    N = block_length
    taps = (np.asarray(taps, dtype=dtype) * dtype(scale) if scale != 1.0
            else np.asarray(taps, dtype=dtype))
    if not np.all(np.isfinite(taps)):
        raise ValueError("NaN or Inf value among coefficients")
    total = N * n_blocks
    padded = np.zeros(total, dtype=dtype)
    padded[: min(len(taps), total)] = taps[:total]
    parts = padded.reshape(n_blocks, N)
    # taps at offset N in a 2N buffer == (-1)^k * rfft(taps at offset 0)
    buf = np.zeros((n_blocks, 2 * N), dtype=dtype)
    buf[:, N:] = parts
    ctype = np.complex64 if dtype == np.float32 else np.complex128
    return pack_spectrum(np.fft.rfft(buf, axis=1).astype(ctype))


def dirac_bank_entry(block_length: int, n_blocks: int,
                     dtype=np.complex64) -> np.ndarray:
    """Packed bank entry for the pass-through ("dirac pulse") coefficient."""
    N = block_length
    H = np.zeros((n_blocks, N + 1), dtype=dtype)
    H[0] = np.where(np.arange(N + 1) % 2 == 0, 1.0, -1.0)
    return pack_spectrum(H)


# --- torch transforms --------------------------------------------------------

def rfft_planes(x: torch.Tensor) -> torch.Tensor:
    """rfft of real ``x [..., 2M]`` -> packed spectrum planes ``[..., 2, M]``."""
    X = torch.fft.rfft(x, dim=-1)                       # [..., M+1]
    re = X.real[..., :-1]
    im = torch.cat([X.real[..., -1:], X.imag[..., 1:-1]], dim=-1)
    return torch.stack([re, im], dim=-2)


@functools.lru_cache(maxsize=16)
def _untangle_consts(M: int, dtype, device):
    """``a = (1 + iW)/2``, ``b = (1 - iW)/2`` with ``W[k] = e^{i pi k/M}``,
    computed in float64 and rounded once to the working type. Cached per
    (M, dtype, device): building them is a host->device copy, which would
    stall the host on every block."""
    W = np.exp(1j * np.pi * np.arange(M) / M)
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    a = torch.as_tensor((1.0 + 1j * W) * 0.5).to(device=device, dtype=cdt)
    b = torch.as_tensor((1.0 - 1j * W) * 0.5).to(device=device, dtype=cdt)
    return a, b


def irfft_planes_valid(p: torch.Tensor) -> torch.Tensor:
    """Valid (lower) half of the inverse transform: packed planes
    ``[..., 2, M]`` -> real ``[..., M]`` (samples 0..M-1 of the 2M frame).

    The half-size form of the JAX package: an M-point complex inverse FFT
    of ``V[k] = a[k] X[k] + b[k] conj(X[M-k])``, of which only the first
    M/2 outputs are interleaved (the overlap-save step keeps the lower
    half only)."""
    M = p.shape[-1]
    re, im = p[..., 0, :], p[..., 1, :]
    zero = torch.zeros_like(re[..., :1])
    # X[k] for k = 0..M-1, with bin 0 = DC (real)
    Xk = torch.complex(re, torch.cat([zero, im[..., 1:]], dim=-1))
    # X[M-k]: the Nyquist bin at k = 0, conj-mirrored bins after
    Xr = torch.complex(
        torch.cat([im[..., :1], torch.flip(re[..., 1:], dims=(-1,))], dim=-1),
        torch.cat([zero, -torch.flip(im[..., 1:], dims=(-1,))], dim=-1))
    a, b = _untangle_consts(M, p.dtype, p.device)
    z = torch.fft.ifft(a * Xk + b * Xr, dim=-1)
    zv = z[..., : M // 2]
    return torch.stack([zv.real, zv.imag], dim=-1).reshape(
        *z.shape[:-1], M)


def irfft_planes(p: torch.Tensor) -> torch.Tensor:
    """Full inverse of :func:`rfft_planes`: packed planes ``[..., 2, M]``
    -> real ``[..., 2M]`` (cuFFT's irfft of the unpacked M+1 bins)."""
    M = p.shape[-1]
    re, im = p[..., 0, :], p[..., 1, :]
    zero = torch.zeros_like(re[..., :1])
    X = torch.complex(torch.cat([re, im[..., :1]], dim=-1),
                      torch.cat([zero, im[..., 1:], zero], dim=-1))
    return torch.fft.irfft(X, n=2 * M, dim=-1)


@functools.lru_cache(maxsize=16)
def xfade_ramp(n: int, dtype, device) -> torch.Tensor:
    """The crossfade's linear ramp ``arange(n) / (n - 1)``, built once per
    (n, dtype, device) rather than on every crossfade block."""
    return torch.arange(n, dtype=dtype, device=device) / (n - 1)


def crossfade_spectra(y_old: torch.Tensor, y_new: torch.Tensor,
                      n_fft2: int) -> torch.Tensor:
    """Seamless coefficient-change crossfade
    (``convolver_crossfade_inplace``, fftw_convolver.c:330-368), twin of
    the JAX package's ``partconv.crossfade_spectra``: inverse-transform
    both spectra, ramp old -> new linearly across the valid (lower) half,
    keep the new upper half, re-transform."""
    t_old = irfft_planes(y_old)
    t_new = irfft_planes(y_new)
    f = xfade_ramp(n_fft2, t_new.dtype, t_new.device)
    ramped = t_old[..., :n_fft2] * (1.0 - f) + t_new[..., :n_fft2] * f
    return rfft_planes(torch.cat([ramped, t_new[..., n_fft2:]], dim=-1))


def convolve_eval(z: torch.Tensor, eval_prev: torch.Tensor):
    """Filter-cascade re-framing (``convolver_convolve_eval``,
    fftw_convolver.c:411-433), twin of the JAX package's
    ``partconv.convolve_eval``: the mixed upstream spectra ``z [Fc, 2, N]``
    -> their valid time-domain output, overlap-save framed with the
    previous block's valid output ``eval_prev [Fc, N]``, re-transformed.
    Returns ``(E [Fc, 2, N], new eval_prev [Fc, N])``."""
    valid = irfft_planes_valid(z)
    return rfft_planes(torch.cat([eval_prev, valid], dim=-1)), valid


def complex_mix(mix: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Real mixing matrix applied to dual-plane spectra.

    [A, F] @ [F, 2, N] -> [A, 2, N]: one FP32 matmul over both planes.
    Full FP32 needs ``torch.backends.cuda.matmul.allow_tf32 = False``,
    which the engine sets: a TF32 mix costs thousands of LSB of S24."""
    F = x.shape[0]
    return torch.matmul(mix, x.reshape(F, -1)).reshape(
        (mix.shape[0],) + x.shape[1:])


# --- plain MACs (the kernel's reference) ------------------------------------

def _hpos(t: torch.Tensor, B: int) -> torch.Tensor:
    """(t - b) mod B for b = 0..B-1, on t's device (no host sync)."""
    b = torch.arange(B, dtype=torch.int64, device=t.device)
    return torch.remainder(t.to(torch.int64) - b, B)


def mac_terms(ring, H):
    """Sum over partitions of ring (*) H, with the bin-0 rule.
    ring [F, B, 2, N], H [F|1, B, 2, N] -> [F, 2, N]."""
    rr, ri = ring[:, :, 0], ring[:, :, 1]          # [F, B, N]
    hr, hi = H[:, :, 0], H[:, :, 1]
    yr = torch.sum(rr * hr - ri * hi, dim=1)       # [F, N]
    yi = torch.sum(rr * hi + ri * hr, dim=1)
    # bin 0: DC and Nyquist are independent real products
    yr0 = torch.sum(rr[..., 0] * hr[..., 0], dim=-1)
    yi0 = torch.sum(ri[..., 0] * hi[..., 0], dim=-1)
    yr = torch.cat([yr0[:, None], yr[:, 1:]], dim=1)
    yi = torch.cat([yi0[:, None], yi[:, 1:]], dim=1)
    return torch.stack([yr, yi], dim=1)            # [F, 2, N]


def spectral_mac_rollh(ring: torch.Tensor, bank: torch.Tensor,
                       coeff_idx: torch.Tensor, mask: torch.Tensor,
                       t: torch.Tensor) -> torch.Tensor:
    """``Y = sum_b ring[:, (t-b)%B] (*) (bank[idx, b] * mask[:, b])``,
    rewritten as ``sum_j ring[:, j] (*) H[:, (t-j)%B]``: the rotation
    rides the coefficient gather and the ring is read unrotated.

    ring [F, B, 2, N], bank [E, B, 2, N], coeff_idx [F] int, mask [F, B]
    (follows the coefficient partition index), t scalar int tensor.
    Returns [F, 2, N]."""
    B = ring.shape[1]
    hpos = _hpos(t, B)
    mg = mask[:, hpos].to(ring.dtype)
    H = bank[coeff_idx.long()[:, None], hpos[None, :]] * mg[:, :, None, None]
    return mac_terms(ring, H)


def spectral_mac_uniform(ring: torch.Tensor, bank: torch.Tensor,
                         coeff_idx: torch.Tensor, mask: torch.Tensor,
                         t: torch.Tensor) -> torch.Tensor:
    """spectral_mac_rollh when every filter uses the SAME coefficient row
    and mask row (``coeff_idx[0]``, ``mask[0]``): one [B, 2, N] row is
    gathered and broadcast across the filter axis."""
    B = ring.shape[1]
    hpos = _hpos(t, B)
    mrow = mask[0, hpos].to(ring.dtype)
    H = bank[coeff_idx.long()[0], hpos] * mrow[:, None, None]   # [B, 2, N]
    return mac_terms(ring, H[None])


def spectral_mac_dual(ring, bank, rows, coeff_idx, mask, prev_idx,
                      prev_mask, t, uniform: bool):
    """The crossfade's two MACs of the stage filters ``rows`` (int tensor)
    as two plain MACs over the gathered rows: ``(Y_new, Y_old)`` against
    (``coeff_idx``, ``mask``) and (``prev_idx``, ``prev_mask``), every
    filter's controls read at ``rows``; ``uniform`` reads the first stage
    filter's for all of them. Returns two [Fs, 2, N]."""
    r = rows.long()
    fn = spectral_mac_uniform if uniform else spectral_mac_rollh
    rs = ring[r]
    return (fn(rs, bank, coeff_idx[r], mask[r], t),
            fn(rs, bank, prev_idx[r], prev_mask[r], t))
