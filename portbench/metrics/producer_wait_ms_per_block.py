"""Host ms a block the main thread waits on the producer's queue
(``dispatch.wait_producer`` spans) over the window's blocks: the
program's own spans."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_block(run, "dispatch.wait_producer")
