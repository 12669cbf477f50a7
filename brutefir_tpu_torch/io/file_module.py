"""File I/O module -- the deterministic/offline path.

Reimplements `bfio_file.c`: ``path``, ``skip`` (seek bytes before reading),
``append`` (output open mode), ``loop`` (seamless seek-back to skip offset at
EOF), ``text`` (whitespace-separated ASCII floats; forces FLOAT64_NE; output
writes one line per frame, tab-separated ``%+.16e`` values).

This module is the reference's benchmark rig (/dev/zero -> /dev/null) and its
de-facto regression oracle, so EOF/short-read semantics are preserved: binary
reads return short counts at EOF, loop mode seeks back and keeps reading.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.sampleformat import parse_sample_format
from . import IoDevice, IoModuleError, register_io_module, IN, OUT
from ..config.lexer import T

OUTTEXT_FORMAT = "%+.16e"
_OUTTEXT_LEN = len(OUTTEXT_FORMAT % 1.0)


def parse_params(params):
    """Parse the captured ``device: "file" {...}`` token list."""
    settings = {"path": None, "skip": 0, "append": False, "loop": False,
                "text": False}
    i = 0
    n = len(params)

    def need(kind):
        nonlocal i
        if i >= n or params[i].kind != kind:
            raise IoModuleError(f"File I/O: parse error: expected {kind.name}")
        t = params[i]
        i += 1
        return t

    while i < n:
        f = need(T.FIELD).value
        if f == "path":
            if settings["path"] is not None:
                raise IoModuleError("File I/O: parse error: path already set")
            settings["path"] = need(T.STRING).value
        elif f == "skip":
            settings["skip"] = int(need(T.REAL).value)
        elif f == "append":
            settings["append"] = need(T.BOOLEAN).value
        elif f == "loop":
            settings["loop"] = need(T.BOOLEAN).value
        elif f == "text":
            settings["text"] = need(T.BOOLEAN).value
        else:
            raise IoModuleError(f"File I/O: parse error: unknown field {f}")
        need(T.EOS)
    if settings["path"] is None:
        raise IoModuleError("File I/O: parse error: path not set")
    return settings


class FileDevice(IoDevice):
    uses_sample_clock = False  # bfio_file.c:192: files are clockless

    def __init__(self, params, io, sample_format, sample_rate, open_channels):
        super().__init__(params, io, sample_format, sample_rate, open_channels)
        s = parse_params(params)
        self.path = s["path"]
        self.skipbytes = s["skip"]
        self.append = s["append"]
        self.loop = s["loop"]
        self.text = s["text"]
        self.fh = None
        self.filesize = 0
        self.curpos = 0
        self._text_tail = b""
        if self.text:
            # text mode requires native-endian float64 (bfio_file.c:165-186)
            ne = parse_sample_format("FLOAT64_NE")
            if sample_format is None:
                self.sample_format = ne
            elif sample_format.name != ne.name:
                raise IoModuleError(
                    "File I/O: no support for text conversion of given "
                    "sample format")
        elif sample_format is None:
            raise IoModuleError("File I/O: no support for AUTO sample format")

    @property
    def batch_safe(self) -> bool:
        """Scan-batched dispatch is safe when the path is storage (a
        regular file) or a null-like device -- NOT a pipe/FIFO/socket/tty
        with a live peer, where batching would add batch_blocks*N of
        latency and bursty output (e.g. `path: "/dev/stdin"` pipelines,
        the classic reference usage)."""
        import stat as _stat
        try:
            st = os.stat(self.path)
        except OSError:
            # output file that does not exist yet: created as a regular
            # file by init()
            return self.io == OUT
        if _stat.S_ISREG(st.st_mode):
            return True
        return self.path in ("/dev/zero", "/dev/null", "/dev/full")

    def init(self, period_size):
        if self.io == IN:
            self.fh = open(self.path, "rb", buffering=0)
            if self.loop:
                self.filesize = os.fstat(self.fh.fileno()).st_size
                if self.filesize == 0:
                    raise IoModuleError(
                        f'File I/O: cannot loop empty file "{self.path}"')
            if self.skipbytes > 0:
                self.fh.seek(self.skipbytes)
                self.curpos = self.skipbytes
        else:
            mode = "ab" if self.append else "wb"
            self.fh = open(self.path, mode, buffering=0)

    # --- binary path ----------------------------------------------------
    def _read_binary(self, nbytes: int) -> bytes:
        buf = bytearray(nbytes)
        got = self._readinto_binary(memoryview(buf))
        del buf[got:]
        return bytes(buf)

    def _readinto_binary(self, view) -> int:
        got = 0
        while got < len(view):
            n = self.fh.readinto(view[got:]) or 0
            self.curpos += n
            got += n
            if self.loop and self.curpos == self.filesize:
                self.fh.seek(self.skipbytes)
                self.curpos = self.skipbytes
                continue
            if n == 0:
                break
        return got

    # --- text path --------------------------------------------------------
    def _read_text(self, nbytes: int) -> bytes:
        count = nbytes >> 3
        vals = np.empty(count, dtype=np.float64)
        got = 0
        while got < count:
            raw = self.fh.read(65536)
            n_raw = len(raw) if raw else 0
            self.curpos += n_raw
            if self.loop and self.curpos == self.filesize:
                self.fh.seek(self.skipbytes)
                self.curpos = self.skipbytes
                # token boundary at the seam: without it a file whose last
                # token has no trailing whitespace would merge with the
                # first token of the next pass
                raw = (raw or b"") + b"\n"
                n_raw = len(raw)
            data = self._text_tail + (raw or b"")
            if n_raw == 0:
                # EOF: parse what remains, keeping any unconsumed tokens
                # for the next call (a large pushed-back tail can hold
                # more than one period's worth of samples)
                toks = data.split()
                for ti, t in enumerate(toks):
                    if got == count:
                        self._text_tail = b" ".join(toks[ti:])
                        break
                    try:
                        vals[got] = float(t)
                    except ValueError:
                        # same clean error as the mid-file branch
                        # (bfio_file.c:397-402)
                        raise IoModuleError(
                            "File I/O: Read failed: bad text format."
                        ) from None
                    got += 1
                else:
                    self._text_tail = b""
                break
            # keep a possibly-split trailing token for the next round
            cut = max(data.rfind(b"\n"), data.rfind(b" "), data.rfind(b"\t"))
            if cut < 0:
                self._text_tail = data
                continue
            parse, self._text_tail = data[: cut + 1], data[cut + 1:]
            toks = parse.split()
            for ti, t in enumerate(toks):
                if got == count:
                    # push back unconsumed values as text for the next call
                    self._text_tail = b" ".join(toks[ti:]) + b" " + self._text_tail
                    break
                try:
                    vals[got] = float(t)
                except ValueError:
                    # clean device error, like the reference's strtod
                    # check ("bad text format", bfio_file.c:397-402) --
                    # not an uncaught traceback
                    raise IoModuleError(
                        "File I/O: Read failed: bad text format.") from None
                got += 1
        return vals[:got].tobytes()

    def read(self, nbytes: int) -> bytes:
        if self.io != IN:
            raise IoModuleError("not an input device")
        if self.text:
            return self._read_text(nbytes)
        return self._read_binary(nbytes)

    def readinto(self, view) -> int:
        """``read`` into ``view`` in place: the binary path reads straight
        into it, with no intermediate bytes."""
        if self.io != IN:
            raise IoModuleError("not an input device")
        if self.text:
            return super().readinto(view)
        return self._readinto_binary(view)

    def write(self, data) -> int:
        if self.io != OUT:
            raise IoModuleError("not an output device")
        if self.text:
            a = np.frombuffer(bytes(data), dtype=np.float64)
            frames = a.reshape(-1, self.open_channels)
            lines = []
            for row in frames:
                lines.append("\t".join(OUTTEXT_FORMAT % v for v in row))
            body = ("\n".join(lines) + "\n").encode()
            self.fh.write(body)
            return len(data)
        # the caller's buffer itself, uncopied
        self.fh.write(memoryview(data))
        return len(data)

    def close(self):
        if self.fh is not None:
            self.fh.close()
            self.fh = None


register_io_module("file", FileDevice)
