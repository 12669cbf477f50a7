"""Auto-generated defaults file, compatible with `~/.brutefir_defaults`.

Content mirrors the reference's `create_default_config` (bfconf.c:183-259)
so existing defaults files parse unchanged and freshly created ones are
interchangeable with the reference engine's.
"""

from __future__ import annotations

import os

from .model import BF_SAMPLE_SLOTS

DEFAULT_BFCONF_NAME = "~/.brutefir_defaults"

DEFAULT_CONFIG_TEXT = """## DEFAULT GENERAL SETTINGS ##

float_bits: 32;             # internal floating point precision
sampling_rate: 44100;       # sampling rate in Hz of audio interfaces
filter_length: 65536;       # length of filters
config_file: "~/.brutefir_config"; # standard location of main config file
overflow_warnings: true;    # echo warnings to stderr if overflow occurs
show_progress: true;        # echo filtering progress to stderr
max_dither_table_size: 0;   # maximum size in bytes of precalculated dither
allow_poll_mode: false;     # allow use of input poll mode
modules_path: ".";          # extra path where to find BruteFIR modules
monitor_rate: false;        # monitor sample rate
powersave: false;           # pause filtering when input is zero
lock_memory: true;          # try to lock memory if realtime prio is set
sdf_length: -1;             # subsample filter half length in samples
safety_limit: 20;           # if non-zero max dB in output before aborting
convolver_config: "~/.brutefir_convolver"; # location of convolver config file

## COEFF DEFAULTS ##

coeff {
\tformat: "TEXT";     # file format
\tattenuation: 0.0;   # attenuation in dB
\tblocks: -1;         # how long in blocks
\tskip: 0;            # how many bytes to skip
\tshared_mem: false;  # allocate in shared memory
};

## INPUT DEFAULTS ##

input {
\tdevice: "file" {};  # module and parameters to get audio
\tsample: "S16_LE";   # sample format
\tchannels: 2/0,1;    # number of open channels / which to use
\tdelay: 0,0;         # delay in samples for each channel
\tmaxdelay: -1;       # max delay for variable delays
\tsubdelay: 0,0;      # subsample delay in 1/SLOTSth sample for each channel
\tmute: false,false;  # mute active on startup for each channel
};

## OUTPUT DEFAULTS ##

output {
\tdevice: "file" {};  # module and parameters to put audio
\tsample: "S16_LE";   # sample format
\tchannels: 2/0,1;    # number of open channels / which to use
\tdelay: 0,0;         # delay in samples for each channel
\tmaxdelay: -1;       # max delay for variable delays
\tsubdelay: 0,0;      # subsample delay in 1/SLOTSth sample for each channel
\tmute: false,false;  # mute active on startup for each channel
\tdither: false;      # apply dither
};

## FILTER DEFAULTS ##

filter {
\tprocess: -1;        # process index to run in (-1 means auto)
\tdelay: 0;           # predelay, in blocks
\tcrossfade: false;   # crossfade when coefficient is changed
};
""".replace("SLOTS", str(BF_SAMPLE_SLOTS))


def defaults_path() -> str:
    return os.path.expanduser(DEFAULT_BFCONF_NAME)


def ensure_defaults_file(path: str = None) -> str:
    """Create the defaults file if absent; return its path."""
    path = path or defaults_path()
    if not os.path.exists(path):
        with open(path, "wt") as fh:
            fh.write(DEFAULT_CONFIG_TEXT)
    return path
