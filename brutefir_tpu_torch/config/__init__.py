"""Configuration language (a copy of brutefir_tpu.config: lexer, model,
parser, defaults) and the coefficient bank loader (numpy twin of
brutefir_tpu.config.coeffs). The port keeps its own copies, so it imports
nothing of the JAX package; ``parse_config`` accepts exactly what the JAX
package's does (tests/test_torch_import.py holds the two against each
other)."""

from .lexer import tokenize, Token, T, ConfigParseError
from .model import BFConfig, CoeffDef, IODevDef, FilterDef, IN, OUT
from .parser import parse_config, parse_config_file, from_db
from .defaults import DEFAULT_CONFIG_TEXT, ensure_defaults_file
