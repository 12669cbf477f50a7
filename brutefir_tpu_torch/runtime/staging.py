"""The offline pipeline's host buffers, kept and reused from batch to
batch instead of fresh pageable arrays each time (``Engine.run_offline``'s
producer and the writer's ``Engine._write_outputs``).

- The producer's stacks (``stacks``, ``upload``): [M, N, *wire] words a
  batch, one stack an input device. On a card two sets of them live in
  pinned memory and are used in turn: the producer reads each block
  straight into its row and uploads the set by one asynchronous copy on
  a stream of its own, and refills a set only once the copy that last
  read it has completed. The consumer's stream waits on that copy's
  event (``consume``). Elsewhere the stacks are fresh zeros every batch,
  since the CPU's upload aliases them.
- The writer's fetch (``fetch``): a device tensor on the host, on a card
  through a pinned buffer kept for its shape and dtype, copied on a
  stream of the writer's own after the dispatch's event (``mark``), so
  it never queues behind a later dispatch's work.
- The writer's pool (``encode``): per output device, the 1-D uint8
  arrays the writer copies the bytes to write into and hands to the
  device, reused only once nothing but the pool holds one, so a device
  that keeps a written buffer never sees it change.

``Staging.counts`` says how often each engaged, for an entry's stats:
``pinned_batches`` (batches read in place into a pinned stack),
``fresh_batches`` (batches read into fresh stacks), ``pool_reused`` and
``pool_new`` (the writer's arrays reused and newly allocated).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

COUNTS = ("pinned_batches", "fresh_batches", "pool_reused", "pool_new")
POOL_KEEP = 4      # free arrays the pool keeps an output device
# arrays the pool follows an output device, free or held: a device that
# keeps more of its writes than this keeps the oldest out of the pool
POOL_FOLLOW = 64


def _refs(arrays: list, i: int) -> int:
    return sys.getrefcount(arrays[i])


# the count of an array that only its list holds, read as _free reads it
_FREE_REFS = _refs([np.empty(0)], 0)


def _free(arrays: list, i: int) -> bool:
    """Whether nothing but ``arrays`` holds ``arrays[i]``: a view of it
    holds it too, through its ``.base``."""
    return _refs(arrays, i) == _FREE_REFS


class _PinnedSet:
    """One set of pinned stacks, its numpy views, and the event of the
    upload that last read it (None: never uploaded)."""

    def __init__(self, layout):
        self.tensors = [
            torch.empty(shape, pin_memory=True,
                        dtype=torch.from_numpy(np.empty(0, dtype)).dtype)
            for shape, dtype in layout]
        self.arrays = [t.numpy() for t in self.tensors]
        self.done = None


class Staging:
    """An engine's reused host buffers, pinned where ``device`` is a
    CUDA card. The producer thread calls ``stacks`` and ``upload``, the
    main thread ``consume`` and ``mark``, the writer thread ``fetch`` and
    ``encode``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self.counts = dict.fromkeys(COUNTS, 0)
        self._sets = {}        # stack layout -> its two _PinnedSets
        self._stream = None    # the uploads' stream
        self._bufs = {}        # (shape, dtype) -> pinned fetch buffer
        self._fetch_stream = None
        self._fetched = None   # the event of the last fetch
        self._pool = {}        # output device -> the arrays it follows

    def reset(self) -> None:
        """Start the counts of a new entry."""
        self.counts = dict.fromkeys(COUNTS, 0)

    # ----- the producer ------------------------------------------------------
    def stacks(self, layout):
        """Host stacks for one batch, ``layout`` a (shape, dtype) an input
        device: (the stacks as numpy arrays, their pinned set or None).
        A pinned set is handed out once the upload that last read it has
        completed; its rows hold the last batch's words."""
        if not self.pinned:
            self.counts["fresh_batches"] += 1
            return [np.zeros(shape, dtype) for shape, dtype in layout], None
        sets = self._sets.get(layout)
        if sets is None:
            sets = self._sets[layout] = [_PinnedSet(layout),
                                         _PinnedSet(layout)]
        pset = sets.pop(0)
        sets.append(pset)
        if pset.done is not None:
            pset.done.synchronize()
        self.counts["pinned_batches"] += 1
        return pset.arrays, pset

    def upload(self, arrays, pset):
        """The stacks on the device: (tensors, the event the consumer's
        stream waits on before it reads them, None where the upload is
        synchronous). A pinned set goes by one asynchronous copy a stack
        on the uploads' stream."""
        if pset is None:
            return [torch.from_numpy(a).to(self.device) for a in arrays], None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            out = [t.to(self.device, non_blocking=True)
                   for t in pset.tensors]
        pset.done = torch.cuda.Event()
        pset.done.record(self._stream)
        return out, pset.done

    def consume(self, tensors, ready) -> None:
        """Order the current stream after the upload of ``tensors``
        (``ready``, ``upload``'s event) and mark them used there, so the
        allocator hands their memory to no later upload before this
        stream has read them."""
        if ready is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(ready)
        for t in tensors:
            t.record_stream(cur)

    def mark(self):
        """An event on the current stream, where a dispatch has just
        queued its work, for the writer's fetches of its results (None
        off the card)."""
        if not self.pinned:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    # ----- the writer --------------------------------------------------------
    def fetch(self, t: torch.Tensor, after) -> np.ndarray:
        """``t`` on the host. On a card: copied, once ``after`` (``mark``'s
        event of the dispatch that made ``t``) has passed, on the
        writer's stream into the pinned buffer kept for its shape and
        dtype, and waited for, so the array holds it until the next fetch
        of that shape; elsewhere ``t``'s own memory."""
        if not self.pinned:
            return t.cpu().numpy()
        if self._fetch_stream is None:
            self._fetch_stream = torch.cuda.Stream(self.device)
            self._fetched = torch.cuda.Event()
        key = (tuple(t.shape), t.dtype)
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = torch.empty(t.shape, dtype=t.dtype,
                                                pin_memory=True)
        stream = self._fetch_stream
        stream.wait_event(after)
        with torch.cuda.stream(stream):
            buf.copy_(t, non_blocking=True)
        self._fetched.record(stream)
        self._fetched.synchronize()
        return buf.numpy()

    def encode(self, dev: int, src: np.ndarray) -> np.ndarray:
        """A 1-D uint8 copy of ``src``'s bytes (C-contiguous), its length
        the byte count, in an array of output device ``dev``'s pool: a
        free one (nothing but the pool holds it) large enough, or a new
        one. Of the free arrays the pool keeps ``POOL_KEEP``."""
        n = src.nbytes
        arrays = self._pool.setdefault(dev, [])
        free = [i for i in range(len(arrays)) if _free(arrays, i)]
        for i in reversed(free[POOL_KEEP:]):
            del arrays[i]
        fit = [i for i in free[:POOL_KEEP] if arrays[i].size >= n]
        if fit:
            self.counts["pool_reused"] += 1
            out = arrays[fit[0]][:n]
        else:
            self.counts["pool_new"] += 1
            out = np.empty(n, np.uint8)
            arrays.append(out)
            if len(arrays) > POOL_FOLLOW:
                del arrays[0]
        # copyto releases the interpreter lock for the copy
        np.copyto(out, src.reshape(-1).view(np.uint8))
        return out
