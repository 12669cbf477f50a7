"""Host ms a block in the writer's ``write.encode``, ``write.file`` and
``write.peak`` spans (the 3-byte words expanded and made bytes, the
device write, the peak push) over the window's blocks: the program's
own spans."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_block(run, "write.encode", "write.file",
                                      "write.peak")
