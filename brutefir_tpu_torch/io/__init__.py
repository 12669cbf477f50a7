"""I/O module system -- the bfio plugin contract, pythonic.

A copy of :mod:`brutefir_tpu.io` with the file module only.

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
    """The device class for ``device: "name"``. Only the file module is in
    the port so far: the sound-server backends (alsa, oss, jack, pulse)
    and external ``bfio_<name>.py`` modules come with the clocked
    ``run()`` (ROADMAP queue 1 item 4d)."""
    if name not in _REGISTRY:
        if name != "file":
            raise NotImplementedError(
                f'I/O module "{name}" is not ported yet: only "file" is '
                "(ROADMAP queue 1 item 4d)")
        from . import file_module  # noqa: F401
    return _REGISTRY[name]
