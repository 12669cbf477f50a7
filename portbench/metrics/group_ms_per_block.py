"""Device ms a block in the grouped dispatch's MAC kernels (the unfused
``mac_group`` and the fused ``mac_mix_group``, each in its float32 and
bf16 operand forms; ``csrc/mac_group.cu``): their summed durations in the
traced window over the window's blocks. None without a device trace, or
where no grouped kernel ran (a route that does not group)."""

from portbench import kernel_time

KERNELS = ("mac_group_kernel", "mac_group_bf16_kernel",
           "mac_mix_group_kernel", "mac_mix_group_bf16_kernel")


def read(run):
    return kernel_time.ms_per_block(run, KERNELS)
