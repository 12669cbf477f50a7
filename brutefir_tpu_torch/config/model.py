"""Parsed-configuration data model (the analog of `struct bfconf`)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..core.sampleformat import SampleFormat

IN, OUT = 0, 1

MINFILTERLEN = 4
MAXFILTERLEN = 1 << 30
BF_MAXCHANNELS = 256
BF_MAXFILTERS = 256
BF_MAXPROCESSES = 64
BF_MAXCOEFFPARTS = 128
BF_SAMPLE_SLOTS = 100
BF_UNDEFINED_SUBDELAY = -BF_SAMPLE_SLOTS
BF_MAXOBJECTNAME = 128


@dataclass
class CoeffDef:
    name: str = ""
    intname: int = 0
    format: str = "TEXT"              # TEXT | RAW | PROCESSED
    rawformat: Optional[SampleFormat] = None
    scale: float = 1.0                # linear, from attenuation dB
    filename: str = ""
    shm_parts: List[Tuple[int, int, int]] = field(default_factory=list)
    n_blocks: int = -1
    skip: int = 0
    is_shared: bool = False


@dataclass
class IODevDef:
    io: int = IN
    device_name: str = ""
    device_params: list = field(default_factory=list)   # replayed token list
    sample_format: Optional[SampleFormat] = None        # None == AUTO
    open_channels: int = 2
    used_channels: int = 2
    channel_selection: List[int] = field(default_factory=lambda: [0, 1])
    virtual_channels: int = 0
    channel_intnames: List[int] = field(default_factory=list)
    channel_names: List[str] = field(default_factory=list)
    virt2phys_local: List[int] = field(default_factory=list)
    apply_dither: bool = False
    phys_base: int = 0                                  # global physical index of channel 0


@dataclass
class FilterDef:
    name: str = ""
    intname: int = 0
    coeff: int = -1                 # resolved index; -1 == dirac passthrough
    coeff_name: str = ""
    process: int = -1
    delayblocks: int = 0
    crossfade: bool = False
    # per-edge (target, scale); scale folds attenuation dB and multiplier
    in_channels: List[Tuple[int, float]] = field(default_factory=list)
    out_channels: List[Tuple[int, float]] = field(default_factory=list)
    in_filters: List[Tuple[int, float]] = field(default_factory=list)
    out_filters: List[int] = field(default_factory=list)
    # unresolved name forms kept until link time
    in_channel_names: list = field(default_factory=list)
    out_channel_names: list = field(default_factory=list)
    in_filter_names: list = field(default_factory=list)
    out_filter_names: list = field(default_factory=list)


@dataclass
class BFConfig:
    sampling_rate: int = 0
    filter_length: int = 0            # N
    n_blocks: int = 1                 # B
    realsize: int = 4
    overflow_warnings: bool = True
    show_progress: bool = True
    max_dither_table_size: int = 0
    allow_poll_mode: bool = False
    modules_path: str = "."
    monitor_rate: bool = False
    debug: bool = False
    powersave: bool = False
    analog_powersave: float = 1.0
    lock_memory: bool = True
    sdf_length: int = -1
    sdf_beta: float = 9.0
    safety_limit: float = 0.0         # linear (parsed from dB)
    benchmark: bool = False
    convolver_config: str = ""
    config_file: str = ""
    logic_modules: List[Tuple[str, list]] = field(default_factory=list)

    coeffs: List[CoeffDef] = field(default_factory=list)
    iodevs: Tuple[List[IODevDef], List[IODevDef]] = field(
        default_factory=lambda: ([], []))
    filters: List[FilterDef] = field(default_factory=list)

    # resolved channel maps, one pair per io side
    n_channels: List[int] = field(default_factory=lambda: [0, 0])
    n_physical_channels: List[int] = field(default_factory=lambda: [0, 0])
    channel_names: Tuple[list, list] = field(default_factory=lambda: ([], []))
    virt2phys: Tuple[list, list] = field(default_factory=lambda: ([], []))
    phys2virt: Tuple[list, list] = field(default_factory=lambda: ([], []))
    n_virtperphys: Tuple[list, list] = field(default_factory=lambda: ([], []))

    # per-virtual-channel arrays, one list per io side
    delay: Tuple[list, list] = field(default_factory=lambda: ([], []))
    maxdelay: Tuple[list, list] = field(default_factory=lambda: ([], []))
    subdelay: Tuple[list, list] = field(default_factory=lambda: ([], []))
    mute: Tuple[list, list] = field(default_factory=lambda: ([], []))
    use_subdelay: List[bool] = field(default_factory=lambda: [False, False])

    @property
    def total_taps(self) -> int:
        return self.filter_length * self.n_blocks

    def physical_format(self, io: int, physch: int) -> SampleFormat:
        for dev in self.iodevs[io]:
            if dev.phys_base <= physch < dev.phys_base + dev.used_channels:
                return dev.sample_format
        raise IndexError(physch)

    def dev_of_virtual(self, io: int, virtch: int) -> IODevDef:
        for dev in self.iodevs[io]:
            if virtch in dev.channel_intnames:
                return dev
        raise IndexError(virtch)
