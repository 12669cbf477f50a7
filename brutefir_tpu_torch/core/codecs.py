"""Vectorized raw <-> float sample codecs (host side, numpy and native C++).

A copy of :mod:`brutefir_tpu.core.codecs`, equal to it apart from this
docstring and the import lines. The engine's host codec path
(``Engine.read_block`` / ``write_block``, taken when a device's format
has no device codec: big-endian words, 3-byte big-endian S24, 8-byte
floats) decodes and encodes every device with it; the coefficient reader
decodes RAW files with ``raw_to_float``. Each function runs the native C++ codec
(:mod:`brutefir_tpu_torch.core.native`) on float32 rows when it is
available, else numpy, byte-identical; the semantics are the reference's
(`raw2real.h:7-160`, `real2raw.h:61-255`):

* integer PCM converts to float at *integer scale* (S16 sample 1000 becomes
  1000.0, not 1000/32768) -- normalization happens in the engine's mixing
  matrices via ``SampleFormat.scale``;
* S24 3-byte packed assembles (b0 | b1<<8 | b2<<16) << 8 >> 8 (sign extend);
* S24_4 converts the full int32 word (low-24 semantics come from the
  quantizer clamping to 24 significant bits on output);
* quantization is mid-tread: trunc(x + 0.5), minus one when (x + 0.5) < 0,
  clamping to [imin, imax] with overflow counting (`dither_funs.h:70-114`);
* overflow statistics match `struct bfoverflow` (`bfmod.h:99-104`).

Dithered quantization lives in :mod:`brutefir_tpu_torch.core.dither` (it
carries sequential error-feedback state).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .sampleformat import SampleFormat


def _native():
    try:
        from . import native
        if native.available():
            return native
    except Exception:
        pass
    return None


@dataclass
class Overflow:
    """Per-output-channel clip/peak statistics (reference `bfmod.h:99-104`)."""

    n_overflows: int = 0
    intlargest: int = 0
    largest: float = 0.0
    max: float = 1.0

    def reset(self) -> None:
        self.n_overflows = 0
        self.intlargest = 0
        self.largest = 0.0

    def peak_db(self) -> float:
        peak = max(self.largest, float(self.intlargest))
        if peak <= 0.0:
            return float("-inf")
        return 20.0 * np.log10(peak / self.max)


def raw_to_float(
    raw: np.ndarray,
    fmt: SampleFormat,
    n_frames: int,
    open_channels: int,
    channel_selection,
    dtype=np.float32,
) -> np.ndarray:
    """Decode an interleaved raw device buffer into float channel rows.

    ``raw`` is a uint8 array of at least n_frames*open_channels*fmt.bytes
    bytes. Returns [len(channel_selection), n_frames] float at integer scale.
    Matches `raw2real.h` instantiated per format.
    """
    nat = _native()
    if nat is not None and dtype == np.float32:
        return nat.decode_f32(raw, fmt, n_frames, open_channels,
                              channel_selection)
    sel = np.asarray(channel_selection, dtype=np.int64)
    nbytes = n_frames * open_channels * fmt.bytes
    buf = raw[:nbytes]

    if fmt.is_float:
        base = np.dtype(np.float32 if fmt.bytes == 4 else np.float64)
        a = buf.view(base.newbyteorder("<" if fmt.little_endian else ">"))
        a = a.reshape(n_frames, open_channels)[:, sel]
        return np.ascontiguousarray(a.T.astype(dtype))

    if fmt.bytes == 1:
        a = buf.view(np.int8).reshape(n_frames, open_channels)[:, sel]
        return np.ascontiguousarray(a.T.astype(dtype))

    if fmt.bytes == 2:
        a = buf.view(np.dtype(np.int16).newbyteorder("<" if fmt.little_endian else ">"))
        a = a.reshape(n_frames, open_channels)[:, sel]
        return np.ascontiguousarray(a.T.astype(dtype))

    if fmt.bytes == 3:
        b = buf.reshape(n_frames, open_channels, 3)[:, sel, :].astype(np.uint32)
        if fmt.little_endian:
            v = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
        else:
            v = b[..., 2] | (b[..., 1] << 8) | (b[..., 0] << 16)
        v = (v << 8).astype(np.int32) >> 8  # sign extend 24 -> 32
        return np.ascontiguousarray(v.T.astype(dtype))

    if fmt.bytes == 4:
        a = buf.view(np.dtype(np.int32).newbyteorder("<" if fmt.little_endian else ">"))
        a = a.reshape(n_frames, open_channels)[:, sel]
        # S24_4: reference converts the stored int32 directly (raw2real.h:143-153)
        return np.ascontiguousarray(a.T.astype(dtype))

    raise ValueError(f"unsupported sample byte size {fmt.bytes}")


def quantize_no_dither(x: np.ndarray, fmt: SampleFormat, overflow: Overflow) -> np.ndarray:
    """Mid-tread requantization without dither (`dither_funs.h:70-114`).

    Returns int32 samples clipped to the format's range; updates ``overflow``.
    """
    nat = _native()
    if nat is not None and x.dtype == np.float32:
        return nat.quantize_no_dither(x, fmt, overflow)
    # the reference's no-dither quantizer always runs in DOUBLE (both
    # real2rawf_no_dither and real2rawd_no_dither call the ditherd_
    # variant, fftw_convolver.c:447-450/470-473); on the float32 path the
    # rmin/rmax bounds are float-rounded before promotion (golden-verified)
    shifted = x.astype(np.float64) + 0.5
    if x.dtype == np.float32:
        rmin = np.float64(np.float32(fmt.imin))
        rmax = np.float64(np.float32(fmt.imax))
    else:
        rmin = np.float64(fmt.imin)
        rmax = np.float64(fmt.imax)

    # NaN saturates to imin and counts, like the native path (codec.cpp)
    # -- it fails both range tests, and an invalid float->int cast would
    # otherwise emit a silent 0 with no accounting
    nan = np.isnan(shifted)
    under = (shifted <= rmin) | nan
    over = shifted > rmax
    clipped = under | over
    # trunc then decrement negatives in the *integer* domain (the reference
    # casts to int32 before sample--, dither_funs.h:93-94; a float-domain
    # decrement loses the -1 above 2^24)
    qi = np.trunc(np.where(clipped, 0.0, shifted)).astype(np.int64)
    qi = np.where(shifted < 0, qi - 1, qi).astype(np.int32)
    qi = np.where(under, np.int32(fmt.imin), qi)
    qi = np.where(over, np.int32(fmt.imax), qi)

    n_ovf = int(np.count_nonzero(under) + np.count_nonzero(over))
    overflow.n_overflows += n_ovf
    if n_ovf:
        mag = np.abs(shifted[clipped & ~nan])
        if mag.size:
            overflow.largest = max(overflow.largest, float(mag.max()))
    ok = ~clipped
    if np.any(ok):
        overflow.intlargest = max(overflow.intlargest, int(np.abs(qi[ok]).max()))
    return qi


def check_float_overflow(x: np.ndarray, overflow: Overflow) -> None:
    """Overflow accounting for float output formats (`real2raw.h:44-59`)."""
    mag = np.abs(x)
    overflow.n_overflows += int(np.count_nonzero(mag > overflow.max))
    if mag.size:
        overflow.largest = max(overflow.largest, float(mag.max()))


def _pack_int(qi: np.ndarray, fmt: SampleFormat, out: np.ndarray, open_channels: int, channel_selection) -> None:
    """Scatter int32 samples [C, n_frames] into the interleaved raw buffer."""
    sel = np.asarray(channel_selection, dtype=np.int64)
    n_frames = qi.shape[1]

    if fmt.bytes == 1:
        view = out[: n_frames * open_channels].view(np.int8).reshape(n_frames, open_channels)
        view[:, sel] = qi.T.astype(np.int8)
        return
    if fmt.bytes == 2:
        dt = np.dtype(np.int16).newbyteorder("<" if fmt.little_endian else ">")
        view = out[: n_frames * open_channels * 2].view(dt).reshape(n_frames, open_channels)
        view[:, sel] = qi.T.astype(np.int16)
        return
    if fmt.bytes == 3:
        v = qi.T.astype(np.uint32)
        view = out[: n_frames * open_channels * 3].reshape(n_frames, open_channels, 3)
        if fmt.little_endian:
            view[:, sel, 0] = (v & 0xFF).astype(np.uint8)
            view[:, sel, 1] = ((v >> 8) & 0xFF).astype(np.uint8)
            view[:, sel, 2] = ((v >> 16) & 0xFF).astype(np.uint8)
        else:
            view[:, sel, 2] = (v & 0xFF).astype(np.uint8)
            view[:, sel, 1] = ((v >> 8) & 0xFF).astype(np.uint8)
            view[:, sel, 0] = ((v >> 16) & 0xFF).astype(np.uint8)
        return
    if fmt.bytes == 4:
        dt = np.dtype(np.int32).newbyteorder("<" if fmt.little_endian else ">")
        view = out[: n_frames * open_channels * 4].view(dt).reshape(n_frames, open_channels)
        view[:, sel] = qi.T
        return
    raise ValueError(f"unsupported sample byte size {fmt.bytes}")


def float_to_raw(
    x: np.ndarray,
    fmt: SampleFormat,
    open_channels: int,
    channel_selection,
    out: np.ndarray,
    overflows,
    dither_state=None,
) -> None:
    """Encode float channel rows [C, n_frames] into an interleaved raw buffer.

    ``overflows`` is a sequence of Overflow, one per row of ``x``.
    ``dither_state`` (per-channel list or None) selects the HP-TPDF dithered
    quantizer for integer formats (`real2raw.h` hp_tpdf instantiation).
    Float formats are written as-is with overflow accounting only.
    """
    n_frames = x.shape[1]
    nat = _native() if x.dtype == np.float32 else None
    if fmt.is_float:
        if nat is not None:
            nat.encode_float(x, fmt, open_channels, channel_selection, out,
                             overflows)
            return
        for c in range(x.shape[0]):
            check_float_overflow(x[c], overflows[c])
        dt_base = np.float32 if fmt.bytes == 4 else np.float64
        dt = np.dtype(dt_base).newbyteorder("<" if fmt.little_endian else ">")
        sel = np.asarray(channel_selection, dtype=np.int64)
        view = out[: n_frames * open_channels * fmt.bytes].view(dt).reshape(n_frames, open_channels)
        view[:, sel] = x.T.astype(dt_base)
        return

    no_dither = dither_state is None or all(d is None for d in dither_state)
    if nat is not None and no_dither:
        qrows = nat.quantize_rows_no_dither(x, fmt, overflows)
        nat.encode_int(qrows, fmt, open_channels, channel_selection, out)
        return
    qrows = np.empty((x.shape[0], n_frames), dtype=np.int32)
    for c in range(x.shape[0]):
        if dither_state is not None and dither_state[c] is not None:
            qrows[c] = dither_state[c].quantize(x[c], fmt, overflows[c])
        else:
            qrows[c] = quantize_no_dither(x[c], fmt, overflows[c])
    if nat is not None:
        nat.encode_int(qrows, fmt, open_channels, channel_selection, out)
        return
    _pack_int(qrows, fmt, out, open_channels, channel_selection)
