"""brutefir_tpu_torch -- the BruteFIR rebuild on PyTorch and CUDA.

The port of :mod:`brutefir_tpu` to an NVIDIA GPU. It keeps the JAX
package's layout (``config/``, ``graph/``, ``ops/``, ``runtime/``) and
module names, and keeps its own copies of the framework-free layers
(config parsing, sample formats, the file I/O module, errors): it imports
nothing of :mod:`brutefir_tpu`.
The per-block device program runs as plain torch ops around hand-written
CUDA kernels (``csrc/``), built with ``nvcc`` on first use.

This package never imports ``jax``.

Public entry points:
    brutefir_tpu_torch.runtime.engine.Engine  -- run a parsed config
    python -m brutefir_tpu_torch -nodefault <config>
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The engine's device. ``None`` means ``cuda``; when CUDA is absent
    that raises instead of quietly running on the CPU. The CPU is taken
    only when asked for explicitly (the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "brutefir_tpu_torch: no CUDA device is available; pass "
                "device=torch.device('cpu') explicitly to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
