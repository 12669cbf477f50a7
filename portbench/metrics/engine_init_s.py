"""Host seconds in the config's parse and ``Engine(...)`` (the bank
built and uploaded, the devices opened, the state allocated)."""


def read(run):
    return run.engine_init_s
