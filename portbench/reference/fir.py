"""The plain reference of configurations of kind ``fir``: each output
channel the linear convolution of its input channel with its
coefficient set, in float64, requantized as BruteFIR's undithered output
stage does.

Plain numpy and ``torch.fft``; it imports nothing of the program and
takes nothing the program made: it reads the raw coefficient and input
files that the program read too, and works the spectra out itself.

Units: an S24 word w stands for w / 2^23, and the output word is the
output value times 2^23, so the reference convolves the input words
themselves and rounds the result to the nearest integer, halves up
(``floor(y + 0.5)``, the program's no-dither quantizer), clipped to the
format's range.

``precision="tf32"`` is the control: the same convolution with the
transforms in float32 and both operands of every spectral product
rounded to TF32 (10 stored mantissa bits, nearest even), the products
and sums in float32: the step below the configuration's float32 with
TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch


def sign_extend24(w: np.ndarray) -> np.ndarray:
    """The low 24 bits of int32 words, sign-extended."""
    w = w.astype(np.int32)
    return (w << 8) >> 8


def read_words(path: str, channels: int) -> np.ndarray:
    """An S24_4LE file -> int32 [frames, channels]."""
    w = np.fromfile(path, dtype="<i4")
    return sign_extend24(w.reshape(-1, channels))


def decode_written(data: bytes, channels: int) -> np.ndarray:
    """Bytes written to an S24_4LE output -> int32 [frames, channels]."""
    return sign_extend24(np.frombuffer(data, dtype="<i4").reshape(
        -1, channels))


def encode_words(words: np.ndarray) -> bytes:
    """int [frames, channels] words -> the bytes an S24_4LE output
    device is handed (the inverse of ``decode_written``)."""
    return np.ascontiguousarray(words, dtype="<i4").tobytes()


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 (or complex64) values rounded to TF32's 10 mantissa bits,
    to nearest, ties to even."""
    if t.is_complex():
        return torch.view_as_complex(round_tf32(torch.view_as_real(t)))
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


class Reference:
    """Output words of the ``diagonal`` routing: output c convolves input
    c with coefficient set ``c % coeff_sets``. The input stream is the
    input file looped from its first frame, silence before it; the
    output stream starts with the first block. ``files``: the run's
    ``inputs.Inputs`` (the raw files and their sizes); ``device``: where
    the transforms run (the card once the program is freed, or the
    CPU)."""

    def __init__(self, files, device="cpu", bits: int = 24,
                 chunk: int = 16):
        self.device = torch.device(device)
        taps = np.fromfile(files.taps_path, dtype="<f4")
        self.taps = torch.as_tensor(
            taps.reshape(files.coeff_sets, files.taps).astype(np.float64),
            device=self.device)
        self.sets = files.coeff_sets
        self.L = files.taps
        self.C = files.channels
        self.x = torch.as_tensor(read_words(files.input_path, self.C),
                                 device=self.device)      # [F, C] int32
        self.F = self.x.shape[0]
        self.lo = -(1 << (bits - 1))
        self.hi = (1 << (bits - 1)) - 1
        self.chunk = chunk
        self._spectra = {}

    def decode(self, data: bytes) -> torch.Tensor:
        """Bytes written to the output device -> int64 [frames, C]."""
        return torch.as_tensor(decode_written(data, self.C).astype(np.int64),
                               device=self.device)

    def encode(self, words: torch.Tensor) -> bytes:
        """int64 [frames, C] output words -> bytes as written."""
        return encode_words(words.cpu().numpy())

    def _segment(self, pos: int, n: int) -> torch.Tensor:
        """Input words of stream frames [pos - L + 1, pos + n) as float64
        [C, L - 1 + n], zeros before the stream starts."""
        idx = torch.arange(pos - self.L + 1, pos + n, device=self.device)
        seg = self.x[idx.clamp(min=0) % self.F].to(torch.float64)
        seg[idx < 0] = 0.0
        return seg.T.contiguous()

    def _taps_spectrum(self, rows: torch.Tensor, nfft: int, precision: str):
        key = (nfft, precision, tuple(rows.tolist()))
        H = self._spectra.get(key)
        if H is None:
            h = self.taps[rows]
            if precision == "tf32":
                H = round_tf32(torch.fft.rfft(h.float(), nfft))
            else:
                H = torch.fft.rfft(h, nfft)
            if len(self._spectra) > 8:
                self._spectra.clear()
            self._spectra[key] = H
        return H

    def values(self, pos: int, n: int, precision: str = "float64"):
        """The convolution at output frames [pos, pos + n) before
        rounding, float64 [n, C] (in output words)."""
        seg = self._segment(pos, n)
        nfft = _next_pow2(seg.shape[1])
        out = torch.empty((n, self.C), dtype=torch.float64,
                          device=self.device)
        for c0 in range(0, self.C, self.chunk):
            c1 = min(self.C, c0 + self.chunk)
            rows = torch.arange(c0, c1, device=self.device) % self.sets
            H = self._taps_spectrum(rows, nfft, precision)
            if precision == "tf32":
                X = round_tf32(torch.fft.rfft(seg[c0:c1].float(), nfft))
            elif precision == "float64":
                X = torch.fft.rfft(seg[c0:c1], nfft)
            else:
                raise ValueError(f"no precision {precision!r}")
            y = torch.fft.irfft(X * H, nfft)[:, self.L - 1:self.L - 1 + n]
            out[:, c0:c1] = y.T.to(torch.float64)
        return out

    def words(self, pos: int, n: int, precision: str = "float64"):
        """The output words at frames [pos, pos + n): int64 [n, C]."""
        y = torch.floor(self.values(pos, n, precision) + 0.5)
        return y.clamp(self.lo, self.hi).to(torch.int64)
