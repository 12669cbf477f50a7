"""Seeded inputs of one cell: the coefficient file, the input file and the
BruteFIR configuration text that names them.

One general generator for every configuration of kind ``fir`` and every
traffic mix: the sizes come from the configuration's JSON (channels,
partitions, coefficient sets, sample format) and the traffic's (input
length and level), the samples from ``--seed``. Every seed gives the
same sizes; only the values differ.

Rewritten from the seeded writers of the repository's chip scripts
(``write_scale_inputs``): the same shapes (Gaussian taps under an
exponential decay, scaled to an L2 norm; Gaussian S24 input), written in
a few large calls.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

# the sample formats this generator writes: name -> (bytes a sample,
# significant bits); the input and output words are little-endian
FORMATS = {"S24_4LE": (4, 24)}


@dataclass
class Inputs:
    """Where one run's inputs are, and what the reference needs to read
    them back: ``taps_path`` holds ``coeff_sets`` rows of ``taps`` float32
    samples, ``input_path`` ``frames`` frames of ``channels`` words."""
    taps_path: str
    input_path: str
    conf_path: str
    coeff_sets: int
    taps: int
    channels: int
    frames: int


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The seed's generator for one use (0 taps, 1 input, 2 the output
    sample): any whole number, however large, gives its own streams."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), stream])


def input_frames(config: dict, traffic: dict) -> int:
    return int(round(traffic["input_seconds"] * config["sampling_rate"]))


def write_taps(path: str, config: dict, seed: int) -> None:
    """``coeff_sets`` rows of ``filter_length * partitions`` float32 taps,
    each Gaussian under ``exp(-n / decay_samples)``, scaled to the L2 norm
    ``l2_norm``, in one RAW little-endian float32 file, row after row."""
    n = config["filter_length"] * config["partitions"]
    t = config["taps"]
    rng = rng_for(seed, 0)
    h = rng.standard_normal((config["coeff_sets"], n), dtype=np.float32)
    h *= np.exp(-np.arange(n, dtype=np.float64)
                / t["decay_samples"]).astype(np.float32)
    h *= (t["l2_norm"] / np.linalg.norm(h.astype(np.float64), axis=1)
          ).astype(np.float32)[:, None]
    h.astype("<f4").tofile(path)


def write_input(path: str, config: dict, traffic: dict, seed: int) -> None:
    """``input_frames`` frames of ``channels`` Gaussian samples of standard
    deviation ``input_std_lsb``, clipped to the format's range, as
    interleaved little-endian words."""
    nbytes, bits = FORMATS[config["sample_format"]]
    if nbytes != 4:
        raise ValueError(f"no writer for {config['sample_format']}")
    rng = rng_for(seed, 1)
    shape = (input_frames(config, traffic), config["channels"])
    x = rng.standard_normal(shape, dtype=np.float32) * np.float32(
        traffic["input_std_lsb"])
    lim = 1 << (bits - 1)
    np.clip(np.rint(x), -lim, lim - 1, out=x)
    x.astype("<i4").tofile(path)


def conf_text(config: dict, taps_path: str, input_path: str,
              output_path: str) -> str:
    """The BruteFIR configuration of kind ``fir`` with ``routing``
    ``diagonal``: filter c from input c to output c through coefficient
    set ``c % coeff_sets``, one file device in (looped) and one out."""
    if config["routing"] != "diagonal" or config["dither"]:
        raise ValueError("kind fir has a reference for the undithered "
                         "diagonal routing only")
    C = config["channels"]
    sets = config["coeff_sets"]
    n = config["filter_length"] * config["partitions"]
    chans = ", ".join(str(c) for c in range(C))
    fmt = config["sample_format"]
    lines = [
        f"sampling_rate: {config['sampling_rate']};",
        f"filter_length: {config['filter_length']}, "
        f"{config['partitions']};",
        f"float_bits: {config['float_bits']};",
        "show_progress: false;",
        "overflow_warnings: false;",
    ]
    for s in range(sets):
        lines.append(
            f'coeff {s} {{ filename: "{taps_path}"; '
            f'format: "{config["taps"]["format"]}"; skip: {s * n * 4}; }};')
    lines.append(
        f'input {chans} {{ device: "file" {{ path: "{input_path}"; '
        f'loop: true; }}; sample: "{fmt}"; channels: {C}; }};')
    lines.append(
        f'output {chans} {{ device: "file" {{ path: "{output_path}"; }}; '
        f'sample: "{fmt}"; channels: {C}; dither: false; }};')
    for c in range(C):
        lines.append(f"filter {c} {{ from_inputs: {c}; to_outputs: {c}; "
                     f"coeff: {c % sets}; }};")
    return "\n".join(lines) + "\n"


def write_all(workdir: str, config: dict, traffic: dict, seed: int,
              output_path: str = "/dev/null") -> Inputs:
    """Write the taps, the input and the configuration into ``workdir``."""
    taps = os.path.join(workdir, "taps.raw")
    inp = os.path.join(workdir, "input.raw")
    conf = os.path.join(workdir, "brutefir.conf")
    write_taps(taps, config, seed)
    write_input(inp, config, traffic, seed)
    with open(conf, "w") as fh:
        fh.write(conf_text(config, taps, inp, output_path))
    return Inputs(taps, inp, conf, config["coeff_sets"],
                  config["filter_length"] * config["partitions"],
                  config["channels"], input_frames(config, traffic))
