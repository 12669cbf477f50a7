"""Sample formats and the host codec: copies of the JAX package's
framework-free ``core`` modules (sample formats, codecs with the native
C++ codec, dither, delay lines, FIR windows)."""

from .sampleformat import SampleFormat, parse_sample_format, UnknownSampleFormat
from .codecs import Overflow, raw_to_float
