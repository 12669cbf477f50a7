"""Coefficient bank loading: TEXT and RAW tap files and the dirac pulse.

Numpy twin of ``build_bank`` in :mod:`brutefir_tpu.config.coeffs` (the
port imports nothing of the JAX package). The loaders mirror `load_coeff`
(bfconf.c:1867-2030): TEXT reads the leading float of each line
(`real_read`), RAW reads the declared sample format times its scale
(`raw_read`), ``skip`` seeks, taps beyond ``n_blocks * filter_length`` are
truncated and shorter files zero padded. PROCESSED coefficients are not
in this slice of the port (ROADMAP queue 1).
"""

from __future__ import annotations

import re

import numpy as np

from ..core.codecs import raw_to_float
from ..ops.partconv import dirac_bank_entry, preprocess_coeffs

_FLOAT_PREFIX = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")


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
        raise NotImplementedError(
            "PROCESSED coefficients are not ported yet (ROADMAP queue 1 "
            "item 4)")
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
