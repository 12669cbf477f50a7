"""Host ms a block the main thread spends in ``DeviceIO.multi_step`` and
``DeviceIO.step`` (binding the statics, copying the words in, replaying
the key's graph, cloning the outputs), over the window's blocks."""

SPANS = ("runtime.device_io.DeviceIO.multi_step",
         "runtime.device_io.DeviceIO.step")


def read(run):
    if not run.blocks:
        return None
    return 1e3 * run.spans.total_s(*SPANS) / run.blocks
