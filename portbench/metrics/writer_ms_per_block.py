"""Host ms a block the writer thread spends in ``Engine._write_outputs``
(the NaN flag's fetch, the meters, the outputs' fetch and expansion,
the device write), over the window's blocks."""

SPANS = ("runtime.engine.Engine._write_outputs",)


def read(run):
    if not run.blocks:
        return None
    return 1e3 * run.spans.total_s(*SPANS) / run.blocks
