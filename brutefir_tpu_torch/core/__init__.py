"""Sample formats and the host codec pieces the port uses (copies of
brutefir_tpu.core.sampleformat and of part of brutefir_tpu.core.codecs)."""

from .sampleformat import SampleFormat, parse_sample_format, UnknownSampleFormat
from .codecs import Overflow, raw_to_float
