"""Host ms a block in ``Engine.read_block_dio`` (the file read and the
words packed), over the window's blocks: the producer thread's in
``run_offline``, the main thread's in ``run``. The upload that follows
it is inline in the program's loops, where no wrapper reaches."""

SPANS = ("runtime.engine.Engine.read_block_dio",)


def read(run):
    if not run.blocks:
        return None
    return 1e3 * run.spans.total_s(*SPANS) / run.blocks
