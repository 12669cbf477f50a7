"""Callback-driven I/O bridge -- the reference's callback module path.

The reference supports two I/O styles (bfmod.h:217-275): blocking
read/write (file, alsa, oss) and callback (jack), where the *module* owns
the clock and calls back into the engine per period
(`dai.c:process_callback` path, SURVEY 3.3). The engine here drives a
blocking pipeline, so callback devices adapt through a bounded byte FIFO
per direction:

* the callback thread delivers captured bytes with ``deliver_input`` and
  fetches playback bytes with ``fetch_output``;
* the engine side sees the ordinary blocking ``read``/``write`` contract;
* an output underrun (engine late for the hardware clock) yields zeros to
  the callback, like the reference's synchronization-failure silence, and
  is counted in ``underruns``; an input overrun drops the oldest bytes and
  counts in ``overruns`` (the reference's xrun path, dai.c:1336-1369
  reports these through the rate monitor);
* ``stop_stream`` wakes blocked engine calls and makes further reads
  return EOF, which ends the run through the normal drain logic.

External callback modules (``bfio_<name>.py`` on ``modules_path``)
subclass :class:`CallbackDevice` and call the deliver/fetch pair from
their own realtime thread.
"""

from __future__ import annotations

import threading

from . import IoDevice

IN, OUT = 0, 1


class _ByteFifo:
    """Bounded blocking byte FIFO (one producer, one consumer)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._buf = bytearray()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._closed = False

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def push(self, data: bytes, drop_oldest: bool = False) -> int:
        """Append data. drop_oldest=True never blocks (realtime side):
        overflow discards the oldest bytes and returns how many were
        dropped. Otherwise blocks until there is room (engine side)."""
        with self._cv:
            if drop_oldest:
                self._buf += data
                dropped = len(self._buf) - self.capacity
                if dropped > 0:
                    del self._buf[:dropped]
                else:
                    dropped = 0
                self._cv.notify_all()
                return dropped
            data = memoryview(bytes(data))
            while len(data):
                while (not self._closed
                       and len(self._buf) >= self.capacity):
                    self._cv.wait(timeout=0.5)
                if self._closed:
                    return 0
                room = self.capacity - len(self._buf)
                take = min(room, len(data))
                self._buf += data[:take]
                data = data[take:]
                self._cv.notify_all()
            return 0

    def pop(self, nbytes: int, pad_zeros: bool = False) -> tuple:
        """Remove up to nbytes. pad_zeros=True never blocks (realtime
        side): a shortfall is zero-filled and its size returned. Otherwise
        blocks until nbytes are available or the FIFO closes (EOF)."""
        with self._cv:
            if pad_zeros:
                got = min(nbytes, len(self._buf))
                out = bytes(self._buf[:got])
                del self._buf[:got]
                self._cv.notify_all()
                return out + b"\0" * (nbytes - got), nbytes - got
            while not self._closed and len(self._buf) < nbytes:
                self._cv.wait(timeout=0.5)
            got = min(nbytes, len(self._buf))
            out = bytes(self._buf[:got])
            del self._buf[:got]
            self._cv.notify_all()
            return out, 0


class CallbackDevice(IoDevice):
    """Base for callback-clocked devices (the bfio callback contract).

    Subclasses open their client in ``init``/``start`` and, from the
    callback thread, call ``deliver_input(bytes)`` (capture) and/or
    ``fetch_output(nbytes)`` (playback). ``periods`` sets the FIFO depth
    in blocks (the reference uses 2-period double buffering; more rides
    out scheduling jitter at the cost of latency).
    """

    is_callback = True
    uses_sample_clock = True

    def __init__(self, params, io, sample_format, sample_rate,
                 open_channels, periods: int = 4):
        super().__init__(params, io, sample_format, sample_rate,
                         open_channels)
        self._fifo = None
        self._periods = periods
        self._framebytes = None
        self.underruns = 0
        self.overruns = 0

    def init(self, period_size: int) -> None:
        self._framebytes = self.sample_format.bytes * self.open_channels
        self._fifo = _ByteFifo(max(1, self._periods)
                               * period_size * self._framebytes)

    # engine (blocking) side ------------------------------------------
    def read(self, nbytes: int) -> bytes:
        data, _ = self._fifo.pop(nbytes)
        return data

    def write(self, data) -> int:
        self._fifo.push(bytes(data))
        return len(data)

    def stop_stream(self) -> None:
        """Terminate: wake any blocked engine call; reads turn into EOF."""
        if self._fifo is not None:
            self._fifo.close()

    def close(self) -> None:
        self.stop_stream()

    # callback (realtime) side ----------------------------------------
    def deliver_input(self, data: bytes) -> None:
        dropped = self._fifo.push(data, drop_oldest=True)
        if dropped:
            self.overruns += 1

    def fetch_output(self, nbytes: int) -> bytes:
        data, short = self._fifo.pop(nbytes, pad_zeros=True)
        if short:
            self.underruns += 1
        return data
