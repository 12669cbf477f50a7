"""Seconds from the harness's first line (before torch is imported) to
the window's start: the seeded files, the import of the program, the
config's parse, the engine (bank, uploads), ``setup()`` and the warm-up
through the cell's own entry (each program key's eager call and
capture). A checkout's first run also builds the kernels."""


def read(run):
    return run.setup_s
