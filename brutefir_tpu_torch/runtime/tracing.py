"""The engine's host spans: one in-memory recorder for the block pipeline.

A span is one stage of one thread's work: its name, its start and end
(ns on ``time.time_ns``'s clock, the clock of ``torch.profiler``'s
events, so spans and the card's kernels share one timeline), its
thread, the span that encloses it on the same thread, and the block id
of the work: the first block index and the block count. The spans of one batch share
the id across threads: the producer's reads of blocks k..k+7, the main
thread's dispatch of them and the writer's write of them all carry
``block=k, blocks=8``; a child that gives no id takes its parent's.
``frames`` is what a read or a write moved (-1 elsewhere). A span reads
no thread CPU clock: on a sandboxed card host that clock's system call
took 3.6 µs alone and, under the pipeline's three threads, cost the main
thread's dispatch 0.1 ms a block.

The sites, by thread (``runtime/engine.py`` unless named):

- ``run_offline``'s producer: ``read`` (the batch's blocks read and
  copied into the batch stacks, one block after the other),
  ``upload`` (the stacks' copy to the device), ``produce.wait`` (a full
  queue);
- the main thread: ``dispatch.wait_producer`` (the producer's queue),
  ``snapshot`` (``_snapshot_epoch``), ``dispatch`` (``DeviceIO.multi_step``
  or ``.step``; on the per-block path the whole dispatch stage, from the
  block's read to its queueing, with ``snapshot`` and ``upload`` inside),
  ``dispatch.wait_writer`` (a full writer queue); inside a dispatch
  ``bind`` (``DeviceIO._call``'s statics and ``program.Program``'s word
  slots), ``eager`` or ``replay`` and ``clone``;
- the per-block path's main thread: ``read`` (the read stage: the
  block-start hooks and the read; ``dispatch.wait_producer`` where a
  producer reads);
- the writer: ``write.wait`` (its empty queue), ``write`` (one item),
  inside it ``write.sync`` (the NaN flag's fetch, which waits for the
  item's device work), ``write.meters``, ``write.fetch`` (the words'
  copy off the card), ``write.encode``, ``write.file``, ``write.peak``;
- a capture: ``program.capture <key> <route>`` (``program._capturing``;
  the route as ``G=4 unfused``, ``G=1 none``: ``graph.compile.
  GroupRoute``), where one happens while the recorder is on. A grouped
  batch runs inside one replay, so no span sees into it: its kernels
  are counted by ``Program.delta`` (launches a call) and read from the
  device trace.

While the recorder is off, each site costs one attribute test and reads
no clock. It is switched on by ``enable()`` (until ``disable()``), and
for one run entry (``Engine.run``, ``Engine.run_offline``) by a
``torch.profiler`` that records when the entry starts
(``BRUTEFIR_TPU_PROFILE``'s, an operator's, a benchmark's traced
window) and, for ``Engine.run``, by ``debug: true;``, which keeps a
small ring of the timeline's three span names alone: see ``follow``. Storage is a preallocated list of ``CAPACITY`` slots (a
51 s window of the massive shape offline takes about 43000); spans past
it are counted in ``dropped`` and not kept. ``take(lo_ns, hi_ns)``
returns the kept spans that started in the window.

Sites hold a span open with ``sp = REC.on and REC.begin(name)``, hand
its end to the next stage with ``sp = sp and REC.next(sp, name)`` (one
reading for both), and close it with ``REC.end(sp)``.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

import torch

# spans kept per recording: about six 51 s windows of the massive shape
# offline (18 spans a batch of 8 blocks of 2.7 ms)
CAPACITY = 1 << 18


class Span(NamedTuple):
    name: str
    start_ns: int        # time.time_ns's clock
    end_ns: int
    thread: str          # the thread's name
    tid: int             # its native id (the profiler's track)
    id: int
    parent: int          # the enclosing span's id on the thread, or -1
    block: int           # the first block of the work, or -1
    blocks: int          # its block count
    frames: int          # frames a read or write moved, or -1


class Recorder:
    """Spans in a preallocated list of ``capacity`` slots (or a ring, see
    ``enable``). An open span is a list ``[name, id, parent, block,
    blocks, t0, generation]`` on its thread's stack; its row is
    written when it ends."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.on = False
        self.dropped = 0
        self._size = capacity
        self._ring = False
        self._names = None
        self._rows = []
        self._ids = itertools.count()
        self._gen = 0
        self._anchor = 0
        self._threads = []
        self._local = threading.local()
        self._lock = threading.Lock()

    def enable(self, ring: int = 0, names=None) -> None:
        """Start a new recording: the kept spans and ``dropped`` are
        cleared. ``ring``: keep the newest ``ring`` spans, none dropped
        (0: the first ``capacity``). ``names``: record only spans so
        named."""
        with self._lock:
            self._size = ring or self.capacity
            self._ring = bool(ring)
            self._names = None if names is None else frozenset(names)
            self._rows = [None] * self._size
            self._ids = itertools.count()
            self._gen += 1
            self._threads = []
            self.dropped = 0
            # perf_counter_ns -> time_ns, read once a recording
            self._anchor = time.time_ns() - time.perf_counter_ns()
            self.on = True

    def disable(self) -> None:
        """Stop recording; the kept spans stay for ``take``."""
        self.on = False

    def _stack(self) -> list:
        loc = self._local
        if getattr(loc, "gen", None) != self._gen:
            with self._lock:
                loc.thread = len(self._threads)
                self._threads.append((threading.current_thread().name,
                                      threading.get_native_id()))
            loc.stack = []
            loc.gen = self._gen
        return loc.stack

    def begin(self, name: str, block: int = -1, blocks: int = 0,
              t: float | None = None):
        """Open a span on this thread (False: a name not recorded);
        ``t``: its start, a ``time.perf_counter()`` reading the caller
        already took."""
        if self._names is not None and name not in self._names:
            return False
        t = time.perf_counter_ns() if t is None else int(t * 1e9)
        return self._begin(name, block, blocks, t)

    def _begin(self, name, block, blocks, t) -> list:
        stack = self._stack()
        parent = stack[-1] if stack else None
        if block < 0 and parent is not None:
            block, blocks = parent[3], parent[4]
        sp = [name, next(self._ids), parent[1] if parent else -1, block,
              blocks, t, self._gen]
        stack.append(sp)
        return sp

    def end(self, sp: list, frames: int = -1, t: float | None = None,
            block: tuple | None = None) -> None:
        """Close ``sp`` (and any span left open inside it); ``t``: its
        end, a ``time.perf_counter()`` reading the caller already took;
        ``block``: (block, blocks), where known only now."""
        t = time.perf_counter_ns() if t is None else int(t * 1e9)
        if block is not None:
            sp[3], sp[4] = block
        self._end(sp, frames, t)

    def _end(self, sp, frames, t) -> None:
        if sp[6] != self._gen:
            return            # begun before the recording restarted
        loc = self._local
        stack = loc.stack
        while stack and stack.pop() is not sp:
            pass
        i = sp[1]
        if i >= self._size:
            if not self._ring:
                with self._lock:
                    self.dropped += 1
                return
            i %= self._size
        self._rows[i] = (sp[0], sp[5], t, loc.thread, sp[1], sp[2], sp[3],
                         sp[4], frames)

    def next(self, sp: list, name: str, frames: int = -1,
             t: float | None = None):
        """End ``sp`` and begin its sibling ``name`` (False: a name not
        recorded) at the same instant, one clock reading; the sibling
        takes ``sp``'s block id."""
        t = time.perf_counter_ns() if t is None else int(t * 1e9)
        self._end(sp, frames, t)
        if self._names is not None and name not in self._names:
            return False
        return self._begin(name, sp[3], sp[4], t)

    def take(self, lo_ns: int | None = None,
             hi_ns: int | None = None) -> list:
        """The kept spans of the last recording that started in
        [lo_ns, hi_ns) (time_ns's clock; None: unbounded), by id."""
        with self._lock:
            rows = [r for r in self._rows if r is not None]
            threads = list(self._threads)
            anchor = self._anchor
        lo = -1 << 63 if lo_ns is None else lo_ns - anchor
        hi = 1 << 63 if hi_ns is None else hi_ns - anchor
        out = [Span(name, t0 + anchor, t1 + anchor, *threads[th], sid,
                    parent, block, blocks, frames)
               for name, t0, t1, th, sid, parent, block, blocks, frames
               in rows if lo <= t0 < hi]
        out.sort(key=lambda s: s.id)
        return out


RECORDER = Recorder()
enable = RECORDER.enable
disable = RECORDER.disable
take = RECORDER.take


def follow(ring: int = 0, names=None) -> bool:
    """Switch the recorder on for one run entry when it is off and a
    ``torch.profiler`` records (every span), or else when ``ring`` is
    given (``debug: true;``: as ``enable(ring, names)``); returns whether
    it did, so the entry switches it off at its end."""
    if RECORDER.on:
        return False
    if profiling():
        RECORDER.enable()
        return True
    if ring:
        RECORDER.enable(ring, names)
        return True
    return False


def profiling() -> bool:
    """Whether a ``torch.profiler`` records: the flag its start sets for
    the process, or the calling thread's profiler state."""
    return (getattr(torch.autograd.profiler, "_is_profiler_enabled", False)
            or torch.autograd._profiler_enabled())


def chrome_events(spans, base_ns: int, pid: int, named=()) -> list:
    """``spans`` as Chrome trace events of a ``torch.profiler`` trace
    whose ``baseTimeNanoseconds`` is ``base_ns``: complete events in µs
    on each thread's own track (``pid``, the native thread id), with the
    thread's name where the trace has none (``named``: the ids it
    names)."""
    out, named = [], set(named)
    for s in spans:
        if s.tid not in named:
            named.add(s.tid)
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": s.tid, "args": {"name": s.thread}})
        out.append({"ph": "X", "cat": "program_span", "name": s.name,
                    "pid": pid, "tid": s.tid,
                    "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": {"block": s.block, "blocks": s.blocks,
                             "frames": s.frames,
                             "id": s.id, "parent": s.parent}})
    return out
