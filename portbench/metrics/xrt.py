"""Seconds of audio written to the output device in the window, over the
window's wall seconds: every frame of every write, all the time from
the entry's call to its return (the last dispatch finished and
written)."""


def read(run):
    return run.frames / run.rate / run.window_s
