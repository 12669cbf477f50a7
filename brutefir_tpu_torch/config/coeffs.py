"""Coefficient bank loading: TEXT, RAW and PROCESSED files, the dirac
pulse and shared-memory parts.

Numpy twin of :mod:`brutefir_tpu.config.coeffs` (the port imports nothing
of the JAX package). The loaders mirror `load_coeff` (bfconf.c:1867-2030):
TEXT reads the leading float of each line (`real_read`), RAW reads the
declared sample format times its scale (`raw_read`), ``skip`` seeks, taps
beyond ``n_blocks * filter_length`` are truncated and shorter files zero
padded.

PROCESSED is the reference's on-disk *internal* coefficient dump: per
partition, ``2N`` float32 values in the SIMD-interleaved halfcomplex layout
of `fftw_convfuns.h` (groups of 8: four bin reals then four bin imags, with
the Nyquist real packed into the bin-0 imaginary slot) carrying a built-in
1/n_fft factor. ``processed_to_spectral``/``spectral_to_processed`` convert
between that layout and the plain rfft convention, so PROCESSED files and
shm coefficient segments stay interchangeable with the reference. As in
the JAX package, a PROCESSED file must hold n_blocks * 2N floats (the
reference's file path checks bytes against items, bfconf.c:1945-1951).
"""

from __future__ import annotations

import re

import numpy as np

from ..core.codecs import raw_to_float
from ..ops.partconv import dirac_bank_entry, pack_spectrum, preprocess_coeffs

_FLOAT_PREFIX = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")


def processed_to_spectral(cbuf: np.ndarray, dtype=np.complex64) -> np.ndarray:
    """One partition: internal layout [2N] float -> spectral [N+1] complex.

    Inverts the MIXMODE_INPUT reorder (fftw_convfuns.h:22-43) and removes
    the folded 1/n_fft factor (convolver_coeffs2cbuf fftw_convolver.c:562).
    """
    squeeze = cbuf.ndim == 1
    cbuf = np.atleast_2d(cbuf)
    n_fft = cbuf.shape[-1]
    N = n_fft // 2
    g = cbuf.reshape(cbuf.shape[0], N // 4, 8)
    reals = g[:, :, 0:4].reshape(cbuf.shape[0], N)
    imags = g[:, :, 4:8].reshape(cbuf.shape[0], N).copy()
    nyq = imags[:, 0].copy()
    imags[:, 0] = 0.0
    H = np.zeros((cbuf.shape[0], N + 1), dtype=dtype)
    H[:, :N] = reals + 1j * imags
    H[:, N] = nyq
    H *= n_fft
    return H[0] if squeeze else H


def spectral_to_processed(H: np.ndarray, real_dtype=np.float32) -> np.ndarray:
    """One partition: spectral [N+1] complex -> internal layout [2N] float."""
    squeeze = H.ndim == 1
    H = np.atleast_2d(H)
    rows = H.shape[0]
    N = H.shape[-1] - 1
    n_fft = 2 * N
    Hs = H / n_fft
    reals = Hs[:, :N].real.astype(real_dtype)
    imags = Hs[:, :N].imag.astype(real_dtype).copy()
    imags[:, 0] = Hs[:, N].real.astype(real_dtype)
    g = np.empty((rows, N // 4, 8), dtype=real_dtype)
    g[:, :, 0:4] = reals.reshape(rows, N // 4, 4)
    g[:, :, 4:8] = imags.reshape(rows, N // 4, 4)
    out = g.reshape(rows, n_fft)
    return out[0] if squeeze else out


def read_shm_processed(shmid: int, offset: int, blocks: int,
                       block_length: int) -> np.ndarray:
    """Attach a SysV shared-memory segment and read PROCESSED partitions.

    The reference accepts ``filename: shmid/offset/blocks`` triples so
    external tools can hand over preprocessed coefficients
    (bfconf.c:795-818, get_sharedmem 1824-1865).
    """
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    libc.shmat.restype = ctypes.c_void_p
    SHM_RDONLY = 0o10000
    ptr = libc.shmat(shmid, None, SHM_RDONLY)
    if ptr is None or ptr == ctypes.c_void_p(-1).value:
        raise OSError(
            f"failed to attach to shared memory with id {shmid}")
    try:
        nbytes = blocks * 2 * block_length * 4  # float32 internal layout
        buf = ctypes.string_at(ptr + offset, nbytes)
        return np.frombuffer(buf, dtype=np.float32).copy()
    finally:
        libc.shmdt(ctypes.c_void_p(ptr))


def _read_text_taps(path: str, skip: int, max_items: int, dtype) -> np.ndarray:
    vals = []
    with open(path, "rt") as fh:
        if skip > 0:
            fh.seek(skip)
        for line in fh:
            s = line.strip()
            if not s:
                continue
            # strtod semantics: the leading float of the line, trailing
            # junk ignored; a line with no parseable prefix is an error
            tok = s.split()[0]
            try:
                vals.append(float(tok))
            except ValueError:
                m = _FLOAT_PREFIX.match(tok)
                if not m:
                    raise ValueError(
                        f'invalid floating point number in file "{path}"')
                vals.append(float(m.group(0)))
            if 0 < max_items <= len(vals):
                break
    return np.asarray(vals, dtype=dtype)


def _read_raw_taps(path: str, skip: int, max_items: int, rawformat,
                   dtype) -> np.ndarray:
    with open(path, "rb") as fh:
        if skip > 0:
            fh.seek(skip)
        raw = fh.read()
    n_items = len(raw) // rawformat.bytes
    if 0 < max_items < n_items:
        n_items = max_items
    buf = np.frombuffer(raw, dtype=np.uint8)
    x = raw_to_float(buf, rawformat, n_items, 1, [0], dtype=dtype)[0]
    return x * dtype(rawformat.scale) if rawformat.scale != 1.0 else x


def load_coeff_bank_entry(coeff, block_length: int, total_blocks: int,
                          real_dtype=np.float32) -> np.ndarray:
    """Load one coeff set and return its [total_blocks, N] packed bank row.
    Partitions beyond ``coeff.n_blocks`` are zero (the MAC mask also skips
    them, matching the reference's cblocks clamp)."""
    N = block_length
    cdtype = np.complex64 if real_dtype == np.float32 else np.complex128
    out = np.zeros((total_blocks, N), dtype=cdtype)
    if coeff.filename == "dirac pulse":
        # attenuation applies to the dirac too (coeffs2cbuf scale)
        d = dirac_bank_entry(N, coeff.n_blocks, cdtype) * real_dtype(coeff.scale)
        out[: coeff.n_blocks] = d
        return out
    max_items = coeff.n_blocks * N
    if coeff.format == "TEXT":
        taps = _read_text_taps(coeff.filename, coeff.skip, max_items,
                               real_dtype)
    elif coeff.format == "RAW":
        taps = _read_raw_taps(coeff.filename, coeff.skip, max_items,
                              coeff.rawformat, real_dtype)
    elif coeff.format == "PROCESSED":
        if coeff.shm_parts:
            total = sum(b for _, _, b in coeff.shm_parts)
            if total != coeff.n_blocks:
                raise ValueError(
                    f"shared memory block count mismatch in coeff "
                    f"{coeff.intname}")
            segs = [read_shm_processed(shmid, off, blocks, N)
                    for shmid, off, blocks in coeff.shm_parts]
            raw = np.concatenate(segs).reshape(-1)
        else:
            raw = np.fromfile(coeff.filename, dtype=np.float32,
                              offset=max(coeff.skip, 0))
        expect = coeff.n_blocks * 2 * N
        if raw.size != expect:
            raise ValueError(
                f'length mismatch of file "{coeff.filename}", expected '
                f"{expect} float32 values, got {raw.size}")
        if not np.all(np.isfinite(raw)):
            raise ValueError(f"coeff {coeff.intname} is invalid (NaN/Inf)")
        cbufs = raw.reshape(coeff.n_blocks, 2 * N)
        out[: coeff.n_blocks] = pack_spectrum(processed_to_spectral(cbufs, cdtype))
        return out
    else:
        raise ValueError(f"invalid coeff format {coeff.format}")
    out[: coeff.n_blocks] = preprocess_coeffs(
        taps, N, coeff.n_blocks, coeff.scale, real_dtype)
    return out


def build_bank(coeffs, block_length: int, n_blocks: int,
               real_dtype=np.float32) -> np.ndarray:
    """[n_coeffs + 1, B, N] packed spectral bank; the last entry is the
    dirac passthrough used for ``coeff: -1`` (bfrun.c:1779-1837)."""
    cdtype = np.complex64 if real_dtype == np.float32 else np.complex128
    bank = np.zeros((len(coeffs) + 1, n_blocks, block_length), dtype=cdtype)
    for i, c in enumerate(coeffs):
        bank[i] = load_coeff_bank_entry(c, block_length, n_blocks, real_dtype)
    bank[len(coeffs)] = dirac_bank_entry(block_length, n_blocks, cdtype)
    return bank
