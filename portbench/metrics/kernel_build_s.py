"""Host seconds in the program's kernel build (``ops/_build.build()``,
called before the engine is built): a checkout's first run compiles
every CUDA source with nvcc, every later run only finds the built
libraries. Part of ``setup_s``; none on a run without a card."""


def read(run):
    return run.kernel_build_s
