"""Per-channel integer-sample delay lines (host side).

Bit-exact mirror of the reference delay buffers (`delay.c:228-407`,
`delay_allocate_buffer` / `change_delay` / `delay_update`), validated
against reference-compiled golden vectors (tests/golden/delay_*.bin,
tools/golden/harness.c). Steady-state output is exactly ``x[n - delay]``
with zero initial fill. Runtime changes keep the reference's exact (and
quirky) transition semantics:

* an **increase** zeroes the entire history -- the next ``newdelay``
  output samples are silence, not just the grown difference
  (`change_delay` memsets the short buffers / all full buffers);
* a **decrease** does NOT zero: the machine resets its buffer cursor
  (``curbuf = 0``) and replays whatever the retained buffers hold until
  the pipeline refills -- a deterministic stale-sample transient.

The machine is fragment-based: buffers are sized against the engine's
block length, which every ``process()`` call must match (the reference
calls ``delay_update`` once per fragment).
"""

from __future__ import annotations

import numpy as np


class DelayLine:
    def __init__(self, delay: int, maxdelay: int, dtype=np.float32,
                 frag: int | None = None):
        # maxdelay < 0 means the delay is fixed at its initial value;
        # an initial delay above maxdelay is clamped at allocation
        # (delay_allocate_buffer, delay.c:351-362)
        cap = delay if maxdelay <= 0 else maxdelay
        if maxdelay >= 0 and delay > maxdelay:
            delay = maxdelay
        self.maxdelay = maxdelay
        self.delay = delay          # curdelay
        self.dtype = np.dtype(dtype)
        self._cap = cap
        self._frag = None
        # machine state (allocated on the first fragment, when the
        # fragment size is known; every pre-audio buffer is zero, so a
        # set_delay before allocation is indistinguishable from the
        # reference's allocate-then-change)
        self._n_rest = 0
        self._n_fbufs = 0
        self._curbuf = 0
        self._fbufs = None
        self._rbuf = None
        self._shortbuf = None
        if frag is not None:
            self._allocate(frag)

    # -- delay_allocate_buffer (delay.c:340-407) --
    def _allocate(self, frag: int) -> None:
        self._frag = frag
        cap, init = self._cap, self.delay
        if cap == 0:
            return
        if cap <= frag:
            # short-delay machine only
            self._n_rest = init
            self._shortbuf = [np.zeros(cap, self.dtype),
                              np.zeros(cap, self.dtype)]
            return
        if self.maxdelay > 0:
            # full-length short buffers kept so a runtime decrease can
            # drop back to the short machine
            self._shortbuf = [np.zeros(frag, self.dtype),
                              np.zeros(frag, self.dtype)]
        self._n_rest = init % frag
        self._n_fbufs = init // frag + 1
        if self._n_fbufs == 1:
            self._n_fbufs = 0
        n_cap = cap // frag + 1
        self._fbufs = [np.zeros(frag, self.dtype) for _ in range(n_cap)]
        if self.maxdelay > 0:
            self._rbuf = np.zeros(frag, self.dtype)
        elif self._n_rest != 0:
            self._rbuf = np.zeros(self._n_rest, self.dtype)

    # -- change_delay (delay.c:283-317) --
    def set_delay(self, newdelay: int) -> None:
        if newdelay == self.delay:
            return
        if newdelay > self.maxdelay:
            # silently refused; also covers maxdelay < 0 (fixed)
            return
        if self._frag is None:
            # pre-audio: buffers are all zero either way
            self.delay = newdelay
            self._cap = max(self._cap, 0)
            return
        frag = self._frag
        if newdelay <= frag:
            self._n_rest = newdelay
            if self.delay > frag or self.delay < newdelay:
                self._shortbuf[0][:newdelay] = 0
                self._shortbuf[1][:newdelay] = 0
            self._n_fbufs = 0
            self._curbuf = 0
            self.delay = newdelay
            return
        self._n_rest = newdelay % frag
        self._n_fbufs = newdelay // frag + 1
        if self.delay < newdelay:
            for i in range(self._n_fbufs):
                self._fbufs[i][:] = 0
            if self._n_rest != 0:
                self._rbuf[: self._n_rest] = 0
        self._curbuf = 0
        self.delay = newdelay

    # -- update_delay_buffer (delay.c:228-261) --
    def _update_long(self, x: np.ndarray) -> np.ndarray:
        frag, nr = self._frag, self._n_rest
        last = (self._fbufs[0] if self._curbuf == self._n_fbufs - 1
                else self._fbufs[self._curbuf + 1])
        self._fbufs[self._curbuf][:] = x
        out = np.empty(frag, self.dtype)
        if nr != 0:
            out[:nr] = self._rbuf[:nr]
            self._rbuf[:nr] = last[frag - nr:]
        out[nr:] = last[: frag - nr]
        self._curbuf += 1
        if self._curbuf == self._n_fbufs:
            self._curbuf = 0
        return out

    # -- update_delay_short_buffer (delay.c:263-281) --
    def _update_short(self, x: np.ndarray) -> np.ndarray:
        frag, nr = self._frag, self._n_rest
        self._shortbuf[self._curbuf][:nr] = x[frag - nr:]
        out = np.empty(frag, self.dtype)
        out[nr:] = x[: frag - nr]
        self._curbuf = 1 - self._curbuf
        out[:nr] = self._shortbuf[self._curbuf][:nr]
        return out

    # -- delay_update (delay.c:319-338) --
    def process(self, x: np.ndarray) -> np.ndarray:
        """Delay one fragment of the stream; returns the delayed fragment.

        Every call must use the same fragment length (the engine's block
        size) -- the reference machine is fragment-based.
        """
        if self._frag is None:
            self._allocate(x.shape[0])
        if self._n_fbufs > 0:
            return self._update_long(x)
        if self._n_rest > 0:
            return self._update_short(x)
        return x
