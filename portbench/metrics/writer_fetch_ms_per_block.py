"""Host ms a block in the writer's ``write.meters`` and ``write.fetch``
spans (the meters' fetch and accounting, the words' copy off the card)
over the window's blocks: the program's own spans."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_block(run, "write.meters", "write.fetch")
