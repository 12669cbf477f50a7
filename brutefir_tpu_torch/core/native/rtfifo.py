"""ctypes loader of the native realtime FIFO (rtfifo.cpp), which it
compiles.

A copy of the JAX package's loader with the codec loader's build
(``core/native/__init__.py``): the library lands in the repository's
git-ignored ``build/brutefir_tpu_torch/``, named by a hash of the source
and the compiler flags; each process compiles to a temporary name of its
own (``<lib>.<pid>.tmp``) and moves it into place with ``os.replace``, so
concurrent builds never share a file. Nothing builds at import: the first
``lib()`` or ``NativeRing`` builds and loads. ``available()`` is False
only when no library is built and no C++ compiler is on PATH (the JACK
module then takes the Python FIFO bridge of ``io/callback.py``); with a
compiler present a failed build raises :class:`NativeBuildError` carrying
the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from . import NativeBuildError
from ...ops._build import BUILD_DIR

_SRC = Path(__file__).resolve().with_name("rtfifo.cpp")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    """The library of ``rtfifo.cpp``, named by a hash of the flags and the
    source."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"librtfifo_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    """Compile ``rtfifo.cpp`` into ``so`` under a temporary name of this
    process's own; raises NativeBuildError with the compiler's output."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{' '.join(cmd)} failed ({r.returncode}):\n"
                               + (r.stdout + r.stderr)[-4000:])
    os.replace(tmp, so)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        c = ctypes
        lib.bf_ring_create.restype = c.c_void_p
        lib.bf_ring_create.argtypes = [c.c_size_t]
        lib.bf_ring_destroy.argtypes = [c.c_void_p]
        lib.bf_ring_used.restype = c.c_uint64
        lib.bf_ring_used.argtypes = [c.c_void_p]
        lib.bf_ring_write.restype = c.c_uint64
        lib.bf_ring_write.argtypes = [c.c_void_p, c.c_void_p, c.c_uint64]
        lib.bf_ring_read.restype = c.c_uint64
        lib.bf_ring_read.argtypes = [c.c_void_p, c.c_void_p, c.c_uint64]
        lib.bf_jack_ctx_create.restype = c.c_void_p
        lib.bf_jack_ctx_create.argtypes = [c.c_void_p, c.c_int, c.c_int,
                                           c.POINTER(c.c_void_p),
                                           c.c_void_p]
        lib.bf_jack_ctx_destroy.argtypes = [c.c_void_p]
        lib.bf_jack_ctx_stop.argtypes = [c.c_void_p]
        lib.bf_jack_ctx_xruns.restype = c.c_uint64
        lib.bf_jack_ctx_xruns.argtypes = [c.c_void_p]
        # bf_jack_process stays untyped: its address is handed to JACK
        _lib = lib
        return lib


def available() -> bool:
    """True when the FIFO can run here: loaded, built, or a C++ compiler
    on PATH to build it at the first call."""
    return (_lib is not None or library_path().exists()
            or shutil.which("g++") is not None)


def lib():
    return _load()


class NativeRing:
    """Engine-side (non-realtime) view of one SPSC ring.

    The realtime end runs in C (bf_jack_process); this end polls with
    short sleeps — the engine threads are allowed to block.
    """

    def __init__(self, capacity: int):
        l = _load()
        self._lib = l
        self._ring = l.bf_ring_create(capacity)
        if not self._ring:
            raise MemoryError("rtfifo ring allocation failed")
        self.capacity = capacity
        self._closed = False

    @property
    def handle(self) -> int:
        return self._ring

    def used(self) -> int:
        return int(self._lib.bf_ring_used(self._ring))

    def close(self) -> None:
        self._closed = True

    def destroy(self) -> None:
        """Free the C ring. Only safe when no other thread can still be
        inside read_blocking/write_blocking or the C callback — device
        close() paths therefore only ``close()`` and leave the free to
        the GC finalizer (refcount 0 implies no such thread exists)."""
        self._closed = True
        ring, self._ring = self._ring, None
        if ring:
            self._lib.bf_ring_destroy(ring)

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.destroy()
        except Exception:
            pass

    def read_blocking(self, nbytes: int, poll_s: float = 0.0005) -> bytes:
        """Block until nbytes are available (or closed -> short read)."""
        out = bytearray(nbytes)
        view = (ctypes.c_char * nbytes).from_buffer(out)
        got = 0
        while got < nbytes:
            ring = self._ring
            if ring is None:
                return bytes(out[:got])
            n = int(self._lib.bf_ring_read(
                ring, ctypes.byref(view, got), nbytes - got))
            got += n
            if got < nbytes:
                if self._closed:
                    return bytes(out[:got])
                time.sleep(poll_s)
        return bytes(out)

    def write_blocking(self, data: bytes, poll_s: float = 0.0005) -> int:
        data = bytes(data)
        buf = (ctypes.c_char * len(data)).from_buffer_copy(data)
        sent = 0
        while sent < len(data):
            ring = self._ring
            if ring is None:
                return sent
            n = int(self._lib.bf_ring_write(
                ring, ctypes.byref(buf, sent), len(data) - sent))
            sent += n
            if sent < len(data):
                if self._closed:
                    return sent
                time.sleep(poll_s)
        return sent
