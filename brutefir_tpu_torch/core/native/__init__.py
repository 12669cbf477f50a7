"""ctypes loader of the native codec (codec.cpp), which it compiles.

A copy of the JAX package's loader with one change, to where and how it
builds. The library lands in the repository's git-ignored
``build/brutefir_tpu_torch/``, named by a hash of the source and the
compiler flags (as ``ops/_build.py`` names the CUDA libraries), so an
edited source rebuilds and an unchanged one is reused. Each process
compiles to a temporary name of its own (``<lib>.<pid>.tmp``) and moves
it into place with ``os.replace``: concurrent builds never share a file.

Nothing builds at import. ``available()`` is False when no library is
built and no C++ compiler is on PATH; the pure-numpy paths then take over,
byte-identical. Otherwise the first codec call builds and loads; with a
compiler present, a failed build raises :class:`NativeBuildError` carrying
the compiler's output, and nothing falls back.

``calls`` counts the codec's C calls by function (``reset_calls``
zeroes it), so a run can show that it went through the native codec.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

from ...ops._build import BUILD_DIR

_SRC = Path(__file__).resolve().with_name("codec.cpp")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]

_lib = None
_lock = threading.Lock()
_count_lock = threading.Lock()

calls = {"decode_f32": 0, "quantize_no_dither": 0, "dither_quantize": 0,
         "quantize_rows_no_dither": 0, "encode_int": 0, "encode_float": 0}


def reset_calls() -> None:
    with _count_lock:
        for k in calls:
            calls[k] = 0


def _count(name: str) -> None:
    # the writer thread and the encode pool call the codec concurrently
    with _count_lock:
        calls[name] += 1


class NativeBuildError(RuntimeError):
    pass


class OvfStatsC(ctypes.Structure):
    _fields_ = [("n_overflows", ctypes.c_uint32),
                ("intlargest", ctypes.c_int32),
                ("largest", ctypes.c_double)]


def library_path() -> Path:
    """The library of ``codec.cpp``, named by a hash of the flags and the
    source."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libcodec_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    """Compile ``codec.cpp`` into ``so`` under a temporary name of this
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
        u8p, f32p, i32p, f64p = (
            np.ctypeslib.ndpointer(dtype=d, flags="C_CONTIGUOUS")
            for d in (np.uint8, np.float32, np.int32, np.float64))
        lib.bf_decode_f32.argtypes = [u8p, f32p, c.c_int64, c.c_int32, i32p,
                                      c.c_int32, c.c_int32, c.c_int32,
                                      c.c_int32]
        lib.bf_quantize_nd.argtypes = [f32p, c.c_int64, c.c_int32, i32p,
                                       c.POINTER(OvfStatsC)]
        lib.bf_quantize_dither.argtypes = [f32p, f32p, c.c_int64, c.c_int32,
                                           f32p, i32p, c.POINTER(OvfStatsC)]
        lib.bf_quantize_nd_rows.argtypes = [f32p, c.c_int32, c.c_int64,
                                            c.c_int32, i32p,
                                            c.POINTER(OvfStatsC)]
        lib.bf_encode_int.argtypes = [i32p, u8p, c.c_int64, c.c_int32, i32p,
                                      c.c_int32, c.c_int32, c.c_int32]
        lib.bf_encode_float.argtypes = [f32p, u8p, c.c_int64, c.c_int32,
                                        i32p, c.c_int32, c.c_int32,
                                        c.c_int32, f64p,
                                        c.POINTER(OvfStatsC)]
        for fn in (lib.bf_decode_f32, lib.bf_quantize_nd,
                   lib.bf_quantize_dither, lib.bf_quantize_nd_rows,
                   lib.bf_encode_int, lib.bf_encode_float):
            fn.restype = None
        _lib = lib
        return lib


def available() -> bool:
    """True when the codec can run here: loaded, built, or a C++ compiler
    on PATH to build it at the first call."""
    return (_lib is not None or library_path().exists()
            or shutil.which("g++") is not None)


def _swap_flag(fmt) -> int:
    return int(fmt.little_endian != (sys.byteorder == "little"))


def decode_f32(raw: np.ndarray, fmt, n_frames: int, open_channels: int,
               channel_selection) -> np.ndarray:
    lib = _load()
    sel = np.ascontiguousarray(channel_selection, dtype=np.int32)
    out = np.empty((len(sel), n_frames), dtype=np.float32)
    need = n_frames * open_channels * fmt.bytes
    buf = np.ascontiguousarray(raw[:need])
    # the C walks need bytes unconditionally and loads word-sized --
    # validate what the numpy fallback's reshape would have caught, and
    # realign odd-offset views (fresh numpy allocations are aligned)
    if buf.nbytes < need:
        raise ValueError(
            f"decode_f32: raw buffer holds {buf.nbytes} of {need} bytes")
    if fmt.bytes in (2, 4, 8) and buf.ctypes.data % fmt.bytes:
        buf = buf.copy()
    lib.bf_decode_f32(buf, out, n_frames, open_channels, sel, len(sel),
                      fmt.bytes, int(fmt.is_float), _swap_flag(fmt))
    _count("decode_f32")
    return out


def _sync_stats(cst: OvfStatsC, overflow) -> None:
    overflow.n_overflows = int(cst.n_overflows)
    overflow.intlargest = int(cst.intlargest)
    overflow.largest = float(cst.largest)


def _make_stats(overflow) -> OvfStatsC:
    return OvfStatsC(overflow.n_overflows, overflow.intlargest, overflow.largest)


def quantize_no_dither(x: np.ndarray, fmt, overflow) -> np.ndarray:
    lib = _load()
    q = np.empty(x.shape[-1] if x.ndim == 1 else x.shape, dtype=np.int32)
    cst = _make_stats(overflow)
    lib.bf_quantize_nd(np.ascontiguousarray(x, np.float32), x.size,
                       fmt.bits, q.reshape(-1), ctypes.byref(cst))
    _sync_stats(cst, overflow)
    _count("quantize_no_dither")
    return q


def dither_quantize(x: np.ndarray, dith: np.ndarray, sf: np.ndarray, fmt,
                    overflow) -> np.ndarray:
    lib = _load()
    q = np.empty(x.shape[0], dtype=np.int32)
    cst = _make_stats(overflow)
    lib.bf_quantize_dither(np.ascontiguousarray(x, np.float32),
                           np.ascontiguousarray(dith, np.float32),
                           x.shape[0], fmt.bits, sf, q, ctypes.byref(cst))
    _sync_stats(cst, overflow)
    _count("dither_quantize")
    return q


def quantize_rows_no_dither(x: np.ndarray, fmt, overflows) -> np.ndarray:
    """Quantize [n_rows, n] in one call; overflows is one Overflow per row."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    q = np.empty(x.shape, dtype=np.int32)
    stats = (OvfStatsC * len(overflows))(*[_make_stats(o) for o in overflows])
    lib.bf_quantize_nd_rows(x, x.shape[0], x.shape[1], fmt.bits,
                            q, ctypes.cast(stats, ctypes.POINTER(OvfStatsC)))
    for i, o in enumerate(overflows):
        _sync_stats(stats[i], o)
    _count("quantize_rows_no_dither")
    return q


def _check_out(out: np.ndarray, n_frames: int, open_channels: int,
               fmt) -> None:
    need = n_frames * open_channels * fmt.bytes
    if out.nbytes < need:
        raise ValueError(
            f"encode: out buffer holds {out.nbytes} of {need} bytes")
    if fmt.bytes in (2, 4, 8) and out.ctypes.data % fmt.bytes:
        raise ValueError("encode: out buffer is not word-aligned")


def encode_int(rows_q: np.ndarray, fmt, open_channels: int, channel_selection,
               out: np.ndarray) -> None:
    lib = _load()
    sel = np.ascontiguousarray(channel_selection, dtype=np.int32)
    _check_out(out, rows_q.shape[1], open_channels, fmt)
    lib.bf_encode_int(np.ascontiguousarray(rows_q, np.int32), out,
                      rows_q.shape[1], open_channels, sel, len(sel),
                      fmt.bytes, _swap_flag(fmt))
    _count("encode_int")


def encode_float(rows: np.ndarray, fmt, open_channels: int, channel_selection,
                 out: np.ndarray, overflows) -> None:
    lib = _load()
    sel = np.ascontiguousarray(channel_selection, dtype=np.int32)
    maxes = np.array([o.max for o in overflows], dtype=np.float64)
    stats = (OvfStatsC * len(overflows))(
        *[_make_stats(o) for o in overflows])
    _check_out(out, rows.shape[1], open_channels, fmt)
    lib.bf_encode_float(np.ascontiguousarray(rows, np.float32), out,
                        rows.shape[1], open_channels, sel, len(sel),
                        fmt.bytes, _swap_flag(fmt), maxes,
                        ctypes.cast(stats, ctypes.POINTER(OvfStatsC)))
    for i, o in enumerate(overflows):
        _sync_stats(stats[i], o)
    _count("encode_float")
