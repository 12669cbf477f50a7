#!/usr/bin/env python3
"""The stage probe's calibration at the massive shape and at the bench1
cascade, on one NVIDIA GPU.

Usage (from the root of a tree, one CUDA card):

    python3 chip_stage_probe.py [--runs R] [--blocks X]

Writes ``chip_smoke.py``'s seeded inputs for X blocks (default 20.5) of
the massive shape (examples/multichannel_massive.conf: 26 x 26, one
shared coefficient of 8192 x 16, S24_4LE; the fused route) and of the
reference's bench1 cascade (2 x 2 through 6 filters in two stages, six
coefficient sets of 8192 x 8; the stage loop), adds ``benchmark: true;``
to each config, and runs each config R times (default 3) through the
tree's ``__main__.main`` under BRUTEFIR_TPU_STAGE_BREAKDOWN=1. Every run
builds an engine, which runs ``runtime/stageprobe.py`` once, at its first
table print. Prints the card's name and power limit, then, for each run,
its calibration line (``device stage calibration (ms/block): ...``) and
its stage-table lines; the first run also builds the kernels and plans.

The script needs only what every tree since the stage probe has:
``__main__.main`` and the helpers of the tree's ``chip_smoke.py``
(``write_massive_inputs``, ``mode_config``, ``write_bench1_inputs``).
To compare an older tree's probe with this one's, unpack it with ``git
archive`` into a git-ignored directory (``build/parent``), copy this
script there, and run both in turns in one chip call:

    (cd build/parent && python3 chip_stage_probe.py); \\
        python3 chip_stage_probe.py; python3 chip_stage_probe.py; \\
        (cd build/parent && python3 chip_stage_probe.py)
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--blocks", type=float, default=20.5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_stage_probe: torch.cuda.is_available() is False")
    import chip_smoke as cs
    from brutefir_tpu_torch.__main__ import main as bf_main
    tree = os.path.dirname(os.path.abspath(cs.__file__))
    print(f"card: {cs.card_line()}; tree {tree}", flush=True)
    os.makedirs(cs.WORK, exist_ok=True)
    frames = int(args.blocks * cs.K)

    def massive():
        cs.write_massive_inputs(np.random.default_rng(cs.SEED + 19), frames)
        return cs.mode_config("probe_massive.conf", "benchmark: true;")

    def bench1():
        # bench1 writes its own input.raw: set up after the massive runs
        _, _, cfg = cs.write_bench1_inputs(cs.WORK, frames, cs.SEED + 191)
        with open(cfg) as fh:
            text = fh.read()
        with open(cfg, "w") as fh:
            fh.write(text.replace("float_bits: 32;",
                                  "float_bits: 32;\nbenchmark: true;", 1))
        return cfg

    os.environ["BRUTEFIR_TPU_STAGE_BREAKDOWN"] = "1"
    for name, setup in (("massive", massive), ("bench1", bench1)):
        cfg = setup()
        for r in range(args.runs):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = bf_main(["-nodefault", cfg])
            if rc != 0:
                sys.stderr.write(err.getvalue())
                sys.exit(f"chip_stage_probe: main() exited {rc} ({name})")
            for ln in err.getvalue().splitlines():
                if ln.startswith("device stage calibration"):
                    print(f"{name} run {r + 1}: {ln}", flush=True)
                elif ln.startswith("decode"):
                    print(f"{name} run {r + 1}:   {ln}", flush=True)


if __name__ == "__main__":
    main()
