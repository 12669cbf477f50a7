"""Device time of named kernels in a traced run's window, for the metrics
that read one layer's kernels: a kernel event counts where its function's
name, as the profiler demangles it (``void (anonymous namespace)::
mac_group_kernel<4>(float const*, ...)``), is one of the names given.
The names themselves are kept in each metric's file."""

from __future__ import annotations

import re

# the function's own name: the first identifier followed directly by its
# template arguments or its parameter list
_FUNC = re.compile(r"(?:^|::|\s)([A-Za-z_]\w*)(?=[<(])")


def function_name(event_name: str) -> str:
    """``void ns::name<T>(args)`` -> ``name``; a name the pattern does not
    fit comes back whole."""
    m = _FUNC.search(event_name)
    return m.group(1) if m else event_name


def ms_per_block(run, names) -> float | None:
    """Device ms a block of the window's kernels named in ``names``: their
    summed durations over ``run.blocks``. None without a device trace, a
    window block, or one such kernel."""
    if run.events is None or not run.cards or not run.blocks:
        return None
    ns = [t1 - t0 for _, _, name, t0, t1 in run.window_events(("kernel",))
          if function_name(name) in names]
    if not ns:
        return None
    return sum(ns) / 1e6 / run.blocks
