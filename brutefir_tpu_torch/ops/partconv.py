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

The real transforms are the glue route of
:mod:`brutefir_tpu_torch.ops.fft_glue` (an M-point complex cuFFT plus the
hand-written glue kernel, the JAX package's ``BRUTEFIR_TPU_FFT_GLUE=pallas``
route, taken here at every shape) and the channel mixes ``torch.matmul``
in full FP32, as the JAX package left them to XLA. Every function here
works in its input's real type: float64 spectra (``float_bits: 64``)
take the float64 glue and float64 matmuls. The plain MACs
below are the correctness baseline for the CUDA kernels in
:mod:`brutefir_tpu_torch.ops.mac_mix`, ``mac_group``, ``mac`` and
``mac_dual``. A bfloat16 ring or bank (``BRUTEFIR_TPU_RING_DTYPE`` /
``BRUTEFIR_TPU_BANK_DTYPE`` = bf16) is widened to float32 on entry
(:func:`widen`, exact), so they compute in float32 what they compute for
float32 operands, as the JAX kernels upconvert on load.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import fft_glue


# --- numpy helpers (host-side coefficient preprocessing) --------------------

def pack_spectrum(H: np.ndarray) -> np.ndarray:
    """[..., N+1] rfft spectrum -> packed [..., N]."""
    dc = H[..., :1].real + 1j * H[..., -1:].real
    return np.concatenate([dc.astype(H.dtype), H[..., 1:-1]], axis=-1)


def unpack_spectrum(Hp: np.ndarray) -> np.ndarray:
    """packed [..., N] -> [..., N+1] rfft spectrum, the inverse of
    :func:`pack_spectrum` (the DC and Nyquist bins come back real)."""
    dc = Hp[..., :1].real.astype(Hp.dtype)
    nyq = Hp[..., :1].imag.astype(Hp.dtype)
    return np.concatenate([dc, Hp[..., 1:], nyq], axis=-1)


def np_c2p(z: np.ndarray, out: np.ndarray = None) -> np.ndarray:
    """complex [..., N] -> float planes [..., 2, N] (numpy), into ``out``
    if given (the same values, written in place)."""
    if out is not None:
        return np.stack([z.real, z.imag], axis=-2, out=out)
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

# The three transforms are the glue route of :mod:`.fft_glue`: cuFFT's
# M-point complex FFT of the even/odd sample pairs around the hand-written
# Hermitian glue kernel (on a CPU tensor, its plain torch version).
rfft_planes = fft_glue.rfft_planes_glue            # [..., 2M] -> [..., 2, M]
irfft_planes = fft_glue.irfft_planes_glue          # [..., 2, M] -> [..., 2M]
irfft_planes_valid = fft_glue.irfft_planes_valid_glue  # -> [..., M], lower half


@functools.lru_cache(maxsize=None)
def static_index(values: tuple, device: torch.device,
                 dtype: torch.dtype = torch.long) -> torch.Tensor:
    """A static index vector (a stage's filters, slots, an inverse
    permutation, a shard's rows) on ``device``, built once per (values,
    device, dtype) and kept: a tensor made from host data inside the
    per-block loop is a synchronous host -> device copy, which no CUDA
    graph capture allows, and a captured step program
    (``runtime/program.py``) reads the cached tensor at its address, so
    the cache never evicts. A key's first, eager call fills it."""
    return torch.tensor(values, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def xfade_ramp(n: int, dtype, device) -> torch.Tensor:
    """The crossfade's linear ramp ``arange(n) / (n - 1)``, built once per
    (n, dtype, device) rather than on every crossfade block, and never
    evicted (a captured step program reads it at its address)."""
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
    e, valid = convolve_eval_points(z, eval_prev)
    return fft_glue.glue_fwd(e), valid


def convolve_eval_points(z: torch.Tensor, eval_prev: torch.Tensor):
    """``convolve_eval`` before its forward glue: ``(E [Fc, M] complex,
    the M-point spectra of the re-framed output (``fft_glue.fft_points``),
    new eval_prev [Fc, N])``. The stage loop adds E to the stage's mixed
    spectra and glues the sum once, into the ring."""
    valid = irfft_planes_valid(z)
    return fft_glue.fft_points(torch.cat([eval_prev, valid], dim=-1)), valid


def complex_mix(mix: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Real mixing matrix applied to dual-plane spectra.

    [A, F] @ [F, 2, N] -> [A, 2, N]: one matmul over both planes, in the
    spectra's real type. Full FP32 needs
    ``torch.backends.cuda.matmul.allow_tf32 = False``, which the engine
    sets: a TF32 mix costs thousands of LSB of S24 (a float64 matmul has
    no TF32 mode)."""
    F = x.shape[0]
    return torch.matmul(mix, x.reshape(F, -1)).reshape(
        (mix.shape[0],) + x.shape[1:])


def mix_points(mix: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Real mixing matrix applied to M-point spectra (``fft_glue.
    fft_points``): [A, C] @ complex [C, M] -> complex [A, M], one matmul
    of the real type on the [C, 2M] real view, as ``complex_mix`` on
    planes. The forward glue is linear bin by bin, so mixing before it
    equals mixing its planes up to rounding."""
    C, M = Z.shape
    y = torch.matmul(mix, torch.view_as_real(Z).reshape(C, 2 * M))
    return torch.view_as_complex(y.reshape(mix.shape[0], M, 2))


def widen(x: torch.Tensor) -> torch.Tensor:
    """A bfloat16 operand (the opt-in ring or bank) as float32, exactly;
    any other tensor as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


# --- plain MACs (the kernel's reference) ------------------------------------

def _hpos(t: torch.Tensor, B: int) -> torch.Tensor:
    """(t - b) mod B for b = 0..B-1, on t's device (no host sync)."""
    b = torch.arange(B, dtype=torch.int64, device=t.device)
    return torch.remainder(t.to(torch.int64) - b, B)


def mac_terms(ring, H, has_bin0: bool = True):
    """Sum over partitions of ring (*) H, with the bin-0 rule where
    ``has_bin0`` (else bin 0 is an ordinary complex product: a bin shard
    other than a mesh's first). ring [F, B, 2, N], H [F|1, B, 2, N] ->
    [F, 2, N]; bfloat16 operands widened to float32."""
    ring, H = widen(ring), widen(H)
    rr, ri = ring[:, :, 0], ring[:, :, 1]          # [F, B, N]
    hr, hi = H[:, :, 0], H[:, :, 1]
    yr = torch.sum(rr * hr - ri * hi, dim=1)       # [F, N]
    yi = torch.sum(rr * hi + ri * hr, dim=1)
    if not has_bin0:
        return torch.stack([yr, yi], dim=1)
    # bin 0: DC and Nyquist are independent real products
    yr0 = torch.sum(rr[..., 0] * hr[..., 0], dim=-1)
    yi0 = torch.sum(ri[..., 0] * hi[..., 0], dim=-1)
    yr = torch.cat([yr0[:, None], yr[:, 1:]], dim=1)
    yi = torch.cat([yi0[:, None], yi[:, 1:]], dim=1)
    return torch.stack([yr, yi], dim=1)            # [F, 2, N]


def spectral_mac_rollh(ring: torch.Tensor, bank: torch.Tensor,
                       coeff_idx: torch.Tensor, mask: torch.Tensor,
                       t: torch.Tensor, has_bin0: bool = True) -> torch.Tensor:
    """``Y = sum_b ring[:, (t-b)%B] (*) (bank[idx, b] * mask[:, b])``,
    rewritten as ``sum_j ring[:, j] (*) H[:, (t-j)%B]``: the rotation
    rides the coefficient gather and the ring is read unrotated.

    ring [F, B, 2, N], bank [E, B, 2, N], coeff_idx [F] int, mask [F, B]
    (follows the coefficient partition index), t scalar int tensor;
    ``has_bin0`` as ``mac_terms``; a bfloat16 ring or bank is widened to
    float32 (the gathered rows of the bank). Returns [F, 2, N]."""
    B = ring.shape[1]
    ring = widen(ring)
    hpos = _hpos(t, B)
    mg = mask[:, hpos].to(ring.dtype)
    H = (widen(bank[coeff_idx.long()[:, None], hpos[None, :]])
         * mg[:, :, None, None])
    return mac_terms(ring, H, has_bin0)


def spectral_mac_uniform(ring: torch.Tensor, bank: torch.Tensor,
                         coeff_idx: torch.Tensor, mask: torch.Tensor,
                         t: torch.Tensor,
                         has_bin0: bool = True) -> torch.Tensor:
    """spectral_mac_rollh when every filter uses the SAME coefficient row
    and mask row (``coeff_idx[0]``, ``mask[0]``): one [B, 2, N] row is
    gathered and broadcast across the filter axis."""
    B = ring.shape[1]
    ring = widen(ring)
    hpos = _hpos(t, B)
    mrow = mask[0, hpos].to(ring.dtype)
    H = widen(bank[coeff_idx.long()[0], hpos]) * mrow[:, None, None]
    return mac_terms(ring, H[None], has_bin0)


def spectral_mac_dual(ring, bank, rows, coeff_idx, mask, prev_idx,
                      prev_mask, t, uniform: bool, has_bin0: bool = True):
    """The crossfade's two MACs of the stage filters ``rows`` (int tensor)
    as two plain MACs over the gathered rows: ``(Y_new, Y_old)`` against
    (``coeff_idx``, ``mask``) and (``prev_idx``, ``prev_mask``), every
    filter's controls read at ``rows``; ``uniform`` reads the first stage
    filter's for all of them; ``has_bin0`` as ``mac_terms``. Returns two
    [Fs, 2, N]."""
    r = rows.long()
    fn = spectral_mac_uniform if uniform else spectral_mac_rollh
    rs = ring[r]
    return (fn(rs, bank, coeff_idx[r], mask[r], t, has_bin0),
            fn(rs, bank, prev_idx[r], prev_mask[r], t, has_bin0))
