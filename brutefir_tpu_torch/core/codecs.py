"""Host-side sample codec pieces of the port (numpy).

A copy of the part of :mod:`brutefir_tpu.core.codecs` that the port uses:
the overflow statistics (``Overflow``) and the raw -> float decoder that
reads RAW coefficient files (``raw_to_float``), numpy paths only.
Integer PCM converts to float at *integer scale* (S16 sample 1000 becomes
1000.0, not 1000/32768); normalization happens in the mixing matrices via
``SampleFormat.scale``. S24 3-byte packed assembles
(b0 | b1<<8 | b2<<16) << 8 >> 8 (sign extend); S24_4 converts the full
int32 word (`raw2real.h:7-160`).

The output quantizer runs on the device (``ops/device_codec.py``); the
host quantizer and the native C++ codec come with the host codec path
(ROADMAP queue 1 item 4c).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .sampleformat import SampleFormat


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
