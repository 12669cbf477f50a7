"""Host ms the warm-up spent capturing the step programs as CUDA graphs:
the sum of ``capture_s`` over ``DeviceIO.programs()``. None where
nothing was captured (the CPU)."""


def read(run):
    captured = [p["capture_s"] for p in run.programs if p["graph"]]
    return 1e3 * sum(captured) if captured else None
