"""Tokenizer for the BruteFIR configuration language.

Token-for-token compatible with the reference flex scanner
(`bfconf_lexical.lex:28-108`): braces, comma, slash, semicolon, ``#``
line comments, double-quoted strings with ``\\n``/``\\t``/pass-through
escapes, ``name:`` fields, numbers (optional sign, optional decimal part,
optional two-digit signed exponent), booleans, and the four structure
keywords (``route`` aliases ``filter``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from enum import Enum, auto


class T(Enum):
    LBRACE = auto()
    RBRACE = auto()
    COMMA = auto()
    SLASH = auto()
    EOS = auto()
    COEFF = auto()
    INPUT = auto()
    OUTPUT = auto()
    FILTER = auto()
    BOOLEAN = auto()
    STRING = auto()
    FIELD = auto()
    REAL = auto()
    EOF = auto()


@dataclass(frozen=True)
class Token:
    kind: T
    value: object
    line: int

    def __repr__(self):
        return f"{self.kind.name}({self.value!r})@{self.line}"


class ConfigParseError(Exception):
    def __init__(self, message: str, line: int = -1, filename: str = ""):
        loc = f"{filename or '<config>'}:{line}" if line >= 0 else (filename or "<config>")
        super().__init__(f"parse error on line {line} ({loc}): {message}")
        self.line = line
        self.filename = filename


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>[ \t\r]+)
  | (?P<nl>\n)
  | (?P<comment>\#[^\n]*)
  | (?P<lbrace>\{) | (?P<rbrace>\}) | (?P<comma>,) | (?P<slash>/) | (?P<eos>;)
  | (?P<string>"(\\.|[^"\\])*")
  | (?P<field>[A-Za-z_0-9]+:)
  | (?P<real>[+-]?[0-9]*\.?[0-9]+(e[+-][0-9]{2})?)
  | (?P<word>[A-Za-z_][A-Za-z_0-9]*)
    """,
    re.VERBOSE,
)

_KEYWORDS = {
    "coeff": T.COEFF,
    "input": T.INPUT,
    "output": T.OUTPUT,
    "filter": T.FILTER,
    "route": T.FILTER,  # backwards compatibility
}


def _unescape(s: str, line: int) -> tuple[str, int]:
    """String body unescaping per the flex rule; counts embedded newlines."""
    out = []
    i = 0
    nls = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            if nxt == "n":
                out.append("\n")
            elif nxt == "t":
                out.append("\t")
            else:
                out.append(nxt)
            i += 2
        else:
            if c == "\n":
                nls += 1
            out.append(c)
            i += 1
    return "".join(out), nls


def tokenize(text: str, filename: str = "<config>"):
    """Yield Tokens; terminates with a single EOF token."""
    pos = 0
    line = 1
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ConfigParseError("unrecognised token", line, filename)
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        if kind == "nl":
            line += 1
            continue
        if kind == "lbrace":
            yield Token(T.LBRACE, "{", line)
        elif kind == "rbrace":
            yield Token(T.RBRACE, "}", line)
        elif kind == "comma":
            yield Token(T.COMMA, ",", line)
        elif kind == "slash":
            yield Token(T.SLASH, "/", line)
        elif kind == "eos":
            yield Token(T.EOS, ";", line)
        elif kind == "string":
            body, nls = _unescape(m.group("string")[1:-1], line)
            yield Token(T.STRING, body, line)
            line += nls
        elif kind == "field":
            yield Token(T.FIELD, m.group("field")[:-1], line)
        elif kind == "real":
            yield Token(T.REAL, float(m.group("real")), line)
        elif kind == "word":
            w = m.group("word")
            if w == "true":
                yield Token(T.BOOLEAN, True, line)
            elif w == "false":
                yield Token(T.BOOLEAN, False, line)
            elif w in _KEYWORDS:
                yield Token(_KEYWORDS[w], w, line)
            else:
                raise ConfigParseError(f"unrecognised token: {w}", line, filename)
    yield Token(T.EOF, None, line)
