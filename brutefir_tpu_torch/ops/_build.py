"""Build and load the CUDA kernels of ``brutefir_tpu_torch/csrc``.

On first use the sources are compiled with plain ``nvcc`` into one shared
library with a C interface, which is loaded with ``ctypes``. The library
lands in ``build/brutefir_tpu_torch/`` at the repository root, named by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. ``torch.utils.cpp_extension.load`` is not used:
a source that includes PyTorch's headers takes minutes to compile, a plain
C interface seconds.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "brutefir_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        cand = os.path.join(root, "bin", "nvcc") if root else ""
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda)")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbf_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for their hash exists. The
    compiler's output (``-Xptxas -v``: registers, spills) is kept beside
    the library as ``.log``. Returns the library path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def load():
    """The loaded kernel library, built on first use (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.bf_mac_mix.argtypes = [p, p, p, p, p, p, p,
                                       i, i, i, i, i, i, p]
            lib.bf_mac_mix.restype = i
            _lib = lib
        return _lib
