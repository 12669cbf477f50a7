"""I/O module system -- the bfio plugin contract, pythonic.

A copy of :mod:`brutefir_tpu.io`: the file module, the sound-server
modules (``sound_backends.py``: alsa, oss, jack, pulse, a copy of the JAX
file with two ALSA fixes), the callback bridge (``callback.py``) and the
loader of external ``bfio_<name>.py`` modules.

The reference loads `.bfio` shared objects exposing the symbol set of
`bfmod.h:217-275` (preinit/init/read/write/start/stop/synch/command). Here a
module is a registered class per device type; each config ``device:`` block
instantiates one. The engine drives blocking-style devices synchronously per
block (it owns the pipeline), so the reference's select()/errno machinery
reduces to plain read/write with short-read EOF semantics, which the engine's
drain logic relies on (dai.c:1312-1332, 1423-1439).
"""

from __future__ import annotations

from typing import Dict, Optional, Type

from ..core.sampleformat import SampleFormat
from ..errors import BFError

IN, OUT = 0, 1


class IoModuleError(BFError):
    pass


class IoDevice:
    """One configured device (the analog of a bfio subdevice).

    Subclasses parse their own ``device: "name" { ... }`` parameter token
    list in __init__, mirroring the reference's module-parsed params
    (`bfconf.c:556-610`). ``sample_format`` may be None (AUTO); the device
    must then resolve it and set ``self.sample_format``.
    """

    uses_sample_clock = True
    is_callback = False
    # True when scan-batched (multi-block) dispatch cannot harm a live
    # peer: the endpoint is storage, not a pipe/FIFO/tty another process
    # is waiting on. Batching adds batch_blocks*N of buffering, so only
    # batch-safe endpoints opt in (FileDevice overrides per path).
    batch_safe = False
    # True when the hardware cannot signal readiness at period boundaries
    # (fragment misalignment, dai.c:905-931): with allow_poll_mode the
    # engine then paces reads with short sleeps (poll mode) instead of
    # blocking on read(). Poll-mode devices implement read_nonblock.
    bad_alignment = False

    def __init__(self, params, io: int, sample_format: Optional[SampleFormat],
                 sample_rate: int, open_channels: int):
        self.io = io
        self.sample_format = sample_format
        self.sample_rate = sample_rate
        self.open_channels = open_channels

    def init(self, period_size: int) -> None:
        """Open the device. period_size is frames per block."""

    def read(self, nbytes: int) -> bytes:
        """Read up to nbytes. Short result means EOF is imminent (input)."""
        raise IoModuleError("not an input device")

    def readinto(self, view) -> int:
        """Read up to ``len(view)`` bytes into ``view`` (a writable
        byte-format memoryview) in place; returns the count, short as
        ``read``'s. This default copies what ``read`` returns."""
        data = self.read(len(view))
        view[:len(data)] = data
        return len(data)

    def read_nonblock(self, nbytes: int):
        """Poll-mode read: return whatever is available now.

        ``None`` means no data yet (the EAGAIN analog), a short bytes
        result is partial data, ``b""`` is EOF. Only consulted when the
        device declares ``bad_alignment`` and the engine runs in poll
        mode (dai.c:1198-1230)."""
        raise IoModuleError("device does not support poll mode")

    def write(self, data) -> int:
        """Write bytes; returns bytes written."""
        raise IoModuleError("not an output device")

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def synch_start(self) -> None:
        pass

    def synch_stop(self) -> None:
        pass

    def command(self, params: str) -> str:
        """Module command (CLI imc/omc); returns a message string."""
        return ""

    def close(self) -> None:
        pass


_REGISTRY: Dict[str, Type[IoDevice]] = {}


def register_io_module(name: str, cls: Type[IoDevice]) -> None:
    _REGISTRY[name] = cls


def get_io_module(name: str, modules_path: str = "") -> Type[IoDevice]:
    """The device class for ``device: "name"``: the file module, a
    sound-server module (alsa, oss, jack, pulse; each needs its library
    only when a device opens), or an external ``bfio_<name>.py`` on
    ``modules_path``."""
    if name not in _REGISTRY:
        # lazily import built-ins so optional backends do not break import
        if name == "file":
            from . import file_module  # noqa: F401
        elif name in ("alsa", "oss", "jack", "pulse"):
            from . import sound_backends  # noqa: F401
        else:
            _load_external(name, modules_path)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise IoModuleError(f"unknown I/O module: {name}") from None


def _load_external(name: str, modules_path: str) -> None:
    """Search modules_path for bfio_<name>.py -- the analog of the
    reference's dlopen module search (bfconf.c:2069-2170). The module file
    must call register_io_module(name, cls), importing both from
    ``brutefir_tpu_torch.io``."""
    import importlib.util
    import os
    for d in filter(None, (modules_path or "").split(":")):
        path = os.path.join(os.path.expanduser(d), f"bfio_{name}.py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(f"bfio_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            import sys
            sys.modules[spec.name] = mod  # importable/introspectable after
            spec.loader.exec_module(mod)
            return
