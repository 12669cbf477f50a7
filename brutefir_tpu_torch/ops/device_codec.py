"""On-device sample codec: raw PCM words <-> engine float, inside the step.

Torch twin of :mod:`brutefir_tpu.ops.device_codec`, bit-exact with it.
The host hands the device the raw *words* it read and receives raw words
back, so per-block host work is file I/O and the transfers are the wire
format's width.

Quantization replicates dither_funs.h:70-114 bit for bit: the reference
promotes its float path through the DOUBLE quantizer
(fftw_convolver.c:447-473), so v = (double)x + 0.5, truncate toward zero,
decrement negatives in the integer domain, clip to float-rounded
[imin, imax] bounds. ``quantize_nd_exact`` reproduces those f64 semantics
exactly with f32/int32 ops, op for op like the JAX version.

Every op follows the engine's real type (``y.dtype``) as the JAX module
does: under ``float_bits: 64`` decode, quantize and encode run in
float64, with the same float32-derived clip thresholds cast up. That
mirrors the JAX package where its device codec's bounds differ from its
host codec's exact float64 bounds (core/codecs.py): S32 at full scale.
"""

from __future__ import annotations

import numpy as np
import torch

_TORCH_WORD = {
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float32): torch.float32,
}


def torch_dtype(word: np.dtype) -> torch.dtype:
    return _TORCH_WORD[np.dtype(word)]


def device_format_word(fmt) -> np.dtype | None:
    """The numpy word dtype for a device-codec-eligible format, else None."""
    if fmt.bytes == 3:
        return None
    if fmt.bytes > 1 and fmt.little_endian != np.little_endian:
        return None
    if fmt.is_float:
        return np.dtype(np.float32) if fmt.bytes == 4 else None
    return np.dtype({1: np.int8, 2: np.int16, 4: np.int32}[fmt.bytes])


def _nd_clip_thresholds(imin: int, imax: int) -> tuple:
    """Exact float32 decision thresholds for the reference's double-
    precision clip tests: under <=> y < under_t and over <=> y >= over_t
    as pure f32 comparisons (see the JAX module for the derivation)."""
    def next_above(x64):
        # smallest float32 strictly greater than the real number x64
        c = np.float32(x64)
        if np.float64(c) > x64:
            return c
        return np.nextafter(c, np.float32(np.inf))

    under_t = next_above(np.float64(np.float32(imin)) - 0.5)
    over_t = next_above(np.float64(np.float32(imax)) - 0.5)
    return float(under_t), float(over_t)


def quantize_nd_exact(y: torch.Tensor, imin: int, imax: int):
    """Mid-tread no-dither quantizer, bit-equal to the host/reference
    double-precision path, in f32/int32 ops.

    A plain f32 ``y + 0.5`` loses the half above 2^23 and f32(imax)
    rounds UP for 32-bit formats. Instead: split y into exact integer +
    fraction, decide the half-step and the v<0 branch with exact
    comparisons, and clip against thresholds precomputed in f64. In y's
    dtype (float32, or float64 with the same thresholds).

    Returns (q int32, under bool, over bool).
    """
    under_t, over_t = _nd_clip_thresholds(imin, imax)
    under = y < under_t
    over = y >= over_t
    clip = under | over
    yc = torch.where(clip, torch.zeros_like(y), y)  # keep trunc in int32 range
    t = yc.to(torch.int32)                           # trunc toward zero, exact
    f = yc - t.to(y.dtype)                           # exact: |f| < 1
    one = torch.ones_like(t)
    zero = torch.zeros_like(t)
    # v = y + 0.5 in f64 equals t + (f + 0.5) exactly; every branch
    # decision reduces to an exact f32 comparison on f
    s_pos = t + (f >= 0.5).to(torch.int32)
    v_neg = (t < 0) | ((t == 0) & (f < -0.5))
    s_neg = torch.where(v_neg, t - one + (f > -0.5).to(torch.int32), zero)
    q = torch.where(yc >= 0, s_pos, s_neg)
    q = torch.where(under, torch.full_like(q, imin), q)
    q = torch.where(over, torch.full_like(q, imax), q)
    return q, under, over


def _index(idx, device) -> torch.Tensor:
    """An index array as a long tensor on ``device``; a tensor already
    there is returned as is (the device-IO program builds them once)."""
    return torch.as_tensor(idx, dtype=torch.long, device=device)


def scatter_words(cols: torch.Tensor, selection,
                  open_channels: int, word_dtype: torch.dtype) -> torch.Tensor:
    """[P_used, N] per-channel samples -> [N, open_ch] wire words."""
    words = torch.zeros((cols.shape[1], open_channels), dtype=word_dtype,
                        device=cols.device)
    words[:, _index(selection, cols.device)] = cols.to(word_dtype).T
    return words


def decode_words(words: torch.Tensor, selection, virt_map, rd: torch.dtype) -> torch.Tensor:
    """[N, open_ch] raw words -> [C_virtual, N] float at integer scale.

    ``selection`` picks used physical columns; ``virt_map`` maps virtual
    channels to used-channel rows (the config's ``mapping:``)."""
    cols = words[:, _index(selection, words.device)]
    x = cols.to(rd).T
    return x[_index(virt_map, words.device)]


def encode_words(y: torch.Tensor, fmt, selection,
                 open_channels: int, word_dtype: torch.dtype) -> tuple:
    """[P_used, N] float -> ([N, open_ch] raw words, [P_used, 3] meters).

    Integer formats quantize mid-tread with reference clip semantics;
    float formats pass through. Meters: [n_overflows, peak, int_peak], in
    y's dtype; the counts and the int peak are taken in float32 and cast
    up, as the JAX stack promotes them."""
    P, rd = y.shape[0], y.dtype
    f32 = torch.float32
    if fmt.is_float:
        mag = torch.abs(y)
        meters = torch.stack([
            torch.sum((mag > 1.0).to(f32), dim=1).to(rd),
            torch.amax(mag, dim=1),
            torch.zeros(P, dtype=rd, device=y.device),
        ], dim=1)
        out_cols = y.to(word_dtype)
    else:
        q, under, over = quantize_nd_exact(y, fmt.imin, fmt.imax)
        clip = under | over
        # meters only: the float-rounded |y + 0.5| is a reported peak,
        # not part of the sample bit contract
        mag = torch.abs(y + 0.5)
        meters = torch.stack([
            torch.sum(clip.to(f32), dim=1).to(rd),
            torch.amax(torch.where(clip, mag, torch.zeros_like(mag)), dim=1),
            torch.amax(torch.where(clip, torch.zeros_like(q), torch.abs(q)),
                       dim=1).to(f32).to(rd),
        ], dim=1)
        out_cols = q.to(word_dtype)
    return scatter_words(out_cols, selection, open_channels, word_dtype), \
        meters
