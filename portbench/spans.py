"""Host spans from the benchmark's own wrappers around the program's
methods: while ``Spans.wrapping`` is open, every call of a wrapped
method records its thread, its start on the wall clock (ns, the clock of
the profiler's trace) and its duration (ns, on the monotonic clock).

Rewritten from the method timer of the repository's chip smoke
(``timed_method``): the class attribute is replaced by a timing wrapper
and put back on exit.
"""

from __future__ import annotations

import contextlib
import importlib
import threading
import time
from collections import defaultdict


def resolve(spec: str):
    """``"runtime.device_io.DeviceIO.multi_step"`` -> (class, method name)
    in the program's package."""
    path, cls_name, meth = spec.rsplit(".", 2)
    mod = importlib.import_module(f"brutefir_tpu_torch.{path}")
    return getattr(mod, cls_name), meth


class Spans:
    """``by_name[spec]``: a list of (thread name, start ns, duration ns)."""

    def __init__(self):
        self.by_name = defaultdict(list)
        self._lock = threading.Lock()

    def total_s(self, *specs) -> float:
        return sum(d for s in specs for _, _, d in self.by_name.get(s, ())
                   ) / 1e9

    @contextlib.contextmanager
    def wrapping(self, specs):
        """Wrap each method named in ``specs`` for the block's duration."""
        saved = []
        try:
            for spec in sorted(set(specs)):
                cls, name = resolve(spec)
                fn = getattr(cls, name)
                saved.append((cls, name, fn))
                setattr(cls, name, self._timed(spec, fn))
            yield self
        finally:
            for cls, name, fn in reversed(saved):
                setattr(cls, name, fn)

    def _timed(self, spec, fn):
        acc = self.by_name[spec]
        lock = self._lock

        def timed(*args, **kwargs):
            t0 = time.time_ns()
            p0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                d = time.perf_counter_ns() - p0
                with lock:
                    acc.append((threading.current_thread().name, t0, d))

        return timed
