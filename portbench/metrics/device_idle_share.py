"""Per cent of the traced window in which no kernel, copy or memset ran
on a card: 1 - the union of their intervals over the window, averaged
over the cards the run uses (the union, so that kernels overlapping on
several streams count once). None without a device trace."""

from portbench import trace


def read(run):
    if run.events is None or not run.cards:
        return None
    busy = trace.busy_s(run.window_events(), run.cards, run.lo, run.hi)
    return 100.0 * (1.0 - busy / ((run.hi - run.lo) / 1e9))
