"""Host ms a block in the writer's ``write.sync`` spans (the NaN flag's
fetch, which waits for the batch's work on the card) over the window's
blocks: the program's own spans."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_block(run, "write.sync")
