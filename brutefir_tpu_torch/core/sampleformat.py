"""Sample-format registry.

Mirrors the sample-format vocabulary of the reference engine
(`bfmod.h:33-62`, parser at `bfconf.c:359-535`): signed integer PCM at
8/16/24/32 bits (24-bit both 3-byte packed and low-24-of-32), IEEE float32/64,
each in little/big/native endianness, plus AUTO for device-negotiated formats.

``scale`` is the factor that maps the integer domain to the normalized
+-1.0 float domain (1 / 2^(significant_bits-1); 1.0 for float formats) --
the engine's internal convolution domain is normalized float and every
input edge multiplies by ``scale`` while every output edge divides by it
(reference: `bfrun.c:1371,1642,1850`).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

_LITTLE = sys.byteorder == "little"


@dataclass(frozen=True)
class SampleFormat:
    name: str          # canonical name, e.g. "S24_4LE"
    bytes: int         # bytes occupied in the stream per sample
    sbytes: int        # significant bytes (3 for S24_4LE even though bytes=4)
    is_float: bool
    little_endian: bool

    @property
    def scale(self) -> float:
        if self.is_float:
            return 1.0
        return 1.0 / float(1 << (self.sbytes * 8 - 1))

    @property
    def bits(self) -> int:
        return self.sbytes * 8

    @property
    def imin(self) -> int:
        return -(1 << (self.bits - 1))

    @property
    def imax(self) -> int:
        return (1 << (self.bits - 1)) - 1


def _mk(name, bytes_, sbytes, is_float, little):
    return SampleFormat(name, bytes_, sbytes, is_float, little)


_FORMATS = {}


def _register(fmt: SampleFormat, *aliases: str) -> None:
    _FORMATS[fmt.name.upper()] = fmt
    for a in aliases:
        _FORMATS[a.upper()] = fmt


_register(_mk("S8", 1, 1, False, True))          # endianness irrelevant
_register(_mk("S16_LE", 2, 2, False, True))
_register(_mk("S16_BE", 2, 2, False, False))
_register(_mk("S24_LE", 3, 3, False, True), "S24_3LE")
_register(_mk("S24_BE", 3, 3, False, False), "S24_3BE")
_register(_mk("S24_4LE", 4, 3, False, True))
_register(_mk("S24_4BE", 4, 3, False, False))
_register(_mk("S32_LE", 4, 4, False, True))
_register(_mk("S32_BE", 4, 4, False, False))
_register(_mk("FLOAT_LE", 4, 4, True, True))
_register(_mk("FLOAT_BE", 4, 4, True, False))
_register(_mk("FLOAT64_LE", 8, 8, True, True))
_register(_mk("FLOAT64_BE", 8, 8, True, False))

# native-endian aliases resolve at registry build time, matching the
# reference's _NE handling (bfconf.c:480-533)
_NE = {
    "S16_NE": "S16_LE" if _LITTLE else "S16_BE",
    "S24_NE": "S24_LE" if _LITTLE else "S24_BE",
    "S24_3NE": "S24_LE" if _LITTLE else "S24_BE",
    "S24_4NE": "S24_4LE" if _LITTLE else "S24_4BE",
    "S32_NE": "S32_LE" if _LITTLE else "S32_BE",
    "FLOAT_NE": "FLOAT_LE" if _LITTLE else "FLOAT_BE",
    "FLOAT64_NE": "FLOAT64_LE" if _LITTLE else "FLOAT64_BE",
}
for alias, target in _NE.items():
    _FORMATS[alias] = _FORMATS[target]


class UnknownSampleFormat(ValueError):
    pass


def parse_sample_format(name: str, allow_auto: bool = False):
    """Resolve a sample format name. Returns None for AUTO (if allowed)."""
    key = name.upper()
    if key == "AUTO":
        if allow_auto:
            return None
        raise UnknownSampleFormat('cannot have "AUTO" sample format here')
    try:
        return _FORMATS[key]
    except KeyError:
        raise UnknownSampleFormat(f"unknown sample format: {name}") from None


def all_format_names():
    return sorted(set(f.name for f in _FORMATS.values()))
