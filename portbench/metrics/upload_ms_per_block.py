"""Host ms a block in the producer's ``upload`` spans (the batch's stacks
copied to the card) over the window's blocks: the program's own spans."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_block(run, "upload")
