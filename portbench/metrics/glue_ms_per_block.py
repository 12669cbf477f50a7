"""Device ms a block in the FFT glue kernels (``csrc/fft_glue.cu``: the
forward glue into planes, into the ring or a strided destination such as
the grouped dispatch's ``xnews``, and the inverse glue): their summed
durations in the traced window over the window's blocks. None without a
device trace, or where no glue kernel ran."""

from portbench import kernel_time

KERNELS = ("glue_fwd_kernel", "glue_fwd_ring_kernel", "glue_inv_kernel")


def read(run):
    return kernel_time.ms_per_block(run, KERNELS)
