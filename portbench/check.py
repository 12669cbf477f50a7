"""What decides ``correct``: the output words as they reach the output
device, sampled across the window, against the plain reference.

``Recorder`` wraps the output device's ``write``: it counts every frame
written (the stream's position) and keeps, by reservoir sampling from
the seed, ``keep`` of the window's writes besides its first and its
last. Keeping costs no copy: the
device is handed a new ``bytes`` object every write, and the recorder
holds on to it.

``compare`` works out the same frames with the reference once the
window has closed and the program is freed, and returns the numbers
compared, each beside its limit.
"""

from __future__ import annotations


class Recorder:
    """Wraps ``device.write`` of one output device with ``frame_bytes``
    bytes a frame."""

    def __init__(self, device, frame_bytes: int, keep: int, rng):
        self.device = device
        self.frame_bytes = frame_bytes
        self.keep = keep
        self.rng = rng
        self.frames = 0              # stream frames written so far
        self.active = False
        self.window_frames = 0
        self.window_writes = 0
        self.first = self.last = None
        self.reservoir = []
        self._write = device.write
        device.write = self.write

    def write(self, data):
        n = len(data) // self.frame_bytes
        pos = self.frames
        r = self._write(data)
        self.frames += n
        if self.active:
            item = (pos, data)
            i = self.window_writes
            self.window_writes += 1
            self.window_frames += n
            if self.first is None:
                self.first = item
            self.last = item
            if i < self.keep:
                self.reservoir.append(item)
            else:
                j = int(self.rng.integers(0, i + 1))
                if j < self.keep:
                    self.reservoir[j] = item
        return r

    def kept(self) -> list:
        """The kept writes (stream position, bytes) in stream order."""
        items = {pos: data for pos, data in self.reservoir}
        for it in (self.first, self.last):
            if it is not None:
                items[it[0]] = it[1]
        return sorted(items.items())

    def release(self) -> None:
        self.device.write = self._write
        self.reservoir = []
        self.first = self.last = None


def compare(kept, reference, limits: dict) -> dict:
    """The numbers compared: ``max_gap_lsb``, the largest distance in
    output words between a kept word and the reference's, and
    ``frames_checked``, how many frames were compared (at least one
    write has to be). Returns {name: (value, op, limit, ok)} and the frames
    of the kept writes whose gap is over the limit."""
    worst = 0
    frames = 0
    over = 0
    lim = limits["max_gap_lsb"]
    for pos, data in kept:
        got = reference.decode(data)
        want = reference.words(pos, got.shape[0])
        gap = int((got - want).abs().max())
        worst = max(worst, gap)
        frames += got.shape[0]
        if gap > lim:
            over += got.shape[0]
    return {
        "max_gap_lsb": (worst, "<=", lim, worst <= lim),
        "frames_checked": (frames, ">=", 1, frames >= 1),
    }, over


def control_writes(kept, reference, precision: str) -> list:
    """The control put in the program's place: at each kept write's
    frames, the reference computed in ``precision``, as the bytes the
    output device would have been handed. ``compare`` judges them as it
    judges the program's writes."""
    out = []
    for pos, data in kept:
        n = len(data) // (4 * reference.C)
        out.append((pos, reference.encode(reference.words(pos, n,
                                                          precision))))
    return out
