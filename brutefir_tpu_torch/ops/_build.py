"""Build and load the CUDA kernels of ``brutefir_tpu_torch/csrc``.

On first use each source is compiled with plain ``nvcc`` into a shared
library of its own with a C interface, loaded with ``ctypes``. The
compilers run side by side, one process per source, all started
together. The libraries land in ``build/brutefir_tpu_torch/`` at the
repository root, named by a hash of the source, the shared headers
(``csrc/*.cuh``: ``fft_common.cuh`` of the FFT sources, ``mac_core.cuh``
of ``mac.cu`` and ``mac_dual.cu``, ``cp_async.cuh`` of ``mac_group.cu``
and ``mac_mix_tiled.cu``) and the flags, so an edited source or header
rebuilds and an unchanged one is reused.
``torch.utils.cpp_extension.load`` is not used: a source that includes
PyTorch's headers takes minutes to compile, a plain C interface seconds.

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

_P, _I = ctypes.c_void_p, ctypes.c_int
# source stem -> {C function: argtypes}; every launch returns a cudaError.
# Each MAC entry's last ints are ``has_bin0`` (the packed DC/Nyquist rule
# on local bin 0: 1 unsharded and on a mesh's first bin shard, else 0)
# and, but for ``bf_mac_f64``, ``ring_bf16`` and ``bank_bf16`` (1 where
# that operand is bfloat16: the bf16 operand forms)
SIGNATURES = {
    "mac": {"bf_mac": [_P] * 7 + [_I] * 9 + [_P],
            "bf_mac_f64": [_P] * 7 + [_I] * 7 + [_P],
            "bf_mac_plan": [_I] * 7 + [_P]},
    "mac_dual": {"bf_mac_dual": [_P] * 10 + [_I] * 9 + [_P]},
    "mac_mix": {"bf_mac_mix": [_P] * 7 + [_I] * 12 + [_P]},
    "mac_mix_tiled": {"bf_mac_mix_tiled": [_P] * 7 + [_I] * 8 + [_P]},
    "mac_group": {"bf_mac_group": [_P] * 8 + [_I] * 8 + [_P],
                  "bf_mac_mix_group": [_P] * 9 + [_I] * 9 + [_P],
                  "bf_mac_mix_group_plan": [_I] * 4 + [_P]},
    "fft_glue": {"bf_glue_fwd": [_P] * 3 + [_I] * 2 + [_P],
                 "bf_glue_inv": [_P] * 3 + [_I] * 2 + [_P],
                 "bf_glue_fwd_f64": [_P] * 3 + [_I] * 2 + [_P],
                 "bf_glue_inv_f64": [_P] * 3 + [_I] * 2 + [_P],
                 "bf_glue_fwd_ring": [_P] * 6 + [_I] * 6 + [_P],
                 "bf_glue_fwd_ring_f64": [_P] * 6 + [_I] * 5 + [_P]},
    "fft_fused": {"bf_fft_fused_fwd": [_P] * 6 + [_I] * 3 + [_P],
                  "bf_fft_fused_inv": [_P] * 6 + [_I] * 4 + [_P]},
}

_lock = threading.Lock()
_libs: dict = {}


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


def library_path(src: Path) -> Path:
    """The library of ``src``, named by a hash of the flags, the source
    and the shared headers (``csrc/*.cuh``) it may include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.name.encode())
    for part in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(part.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build() -> list:
    """Compile every source that has no library for its hash yet, one
    ``nvcc`` per source, all at once. The compiler's output (``-Xptxas
    -v``: registers, spills) is kept beside each library as ``.log``.
    Returns the library paths, one per source."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources():
        so = library_path(src)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        log = open(so.with_suffix(".log"), "w")
        log.write(" ".join(cmd) + "\n")
        log.flush()
        jobs.append((so, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for so, tmp, log, proc in jobs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({rc}) on {so.stem}:\n"
                          + so.with_suffix(".log").read_text()[-4000:])
        else:
            os.replace(tmp, so)
    if failed:
        raise KernelBuildError("\n".join(failed))
    return [library_path(src) for src in sources()]


def load(stem: str):
    """The loaded library of ``csrc/<stem>.cu`` with its functions'
    argtypes set; the first call builds every source (thread-safe)."""
    with _lock:
        if stem not in _libs:
            build()
            lib = ctypes.CDLL(str(library_path(CSRC / f"{stem}.cu")))
            for name, argtypes in SIGNATURES[stem].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _I
            _libs[stem] = lib
        return _libs[stem]
