"""The end-of-run overflow summary of ``Engine.run`` against the JAX
engine's, on the CPU.

``run()`` ends, when ``overflow_warnings`` is on and ``quiet`` off, by
writing ``Overflow warnings: n/count/+x.xx ...`` to stderr: each output
channel that clipped, its clip count and its peak in dB of full scale
(print_overflows, bfrun.c:555-587). The inputs are FLOAT_LE samples at
+-0.25 or +-2 of full scale through a dirac filter, so every clip count is
exact in both packages whatever their float rounding; the peaks agree
within 0.01 dB. S24_4LE outputs take the device-IO path, S24_BE the host
codec path.
"""

import re

import numpy as np
import pytest
import torch

from brutefir_tpu.config import parse_config as jax_parse_config
from brutefir_tpu_torch.config import parse_config

CPU = torch.device("cpu")
N, B, C = 128, 2, 3
FRAMES = N * 9 + 37
# clipped samples a channel: channel 1 never clips
CLIPS = (17, 0, 5)
LINE = re.compile(r"^Overflow warnings: (.*)$", re.M)


def _input(d):
    rng = np.random.default_rng(11)
    x = 0.25 * rng.choice([-1.0, 1.0], size=(FRAMES, C))
    for c, n in enumerate(CLIPS):
        at = rng.choice(FRAMES, size=n, replace=False)
        x[at, c] = 2.0 * rng.choice([-1.0, 1.0], size=n)
    x.astype("<f4").tofile(d / "in.raw")


def _config(d, out, fmt, extra):
    chans = ",".join(str(c) for c in range(C))
    filters = "".join(
        f"filter {c} {{ from_inputs: {c}; to_outputs: {c}; coeff: 0; }};\n"
        for c in range(C))
    return f"""
sampling_rate: 44100;
filter_length: {N},{B};
{extra}
coeff 0 {{ filename: "dirac pulse"; }};
input {chans} {{ device: "file" {{ path: "{d / 'in.raw'}"; }}; sample: "FLOAT_LE"; channels: {C}; }};
output {chans} {{ device: "file" {{ path: "{d / out}"; }}; sample: "{fmt}"; channels: {C}; dither: false; }};
{filters}"""


def _run_both(d, capsys, fmt, extra="", quiet=False):
    """stderr of the JAX engine's and the port's ``run()`` on one
    config."""
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    _input(d)
    errs = []
    for who, parse, make in (
            ("jax", jax_parse_config, lambda conf: JaxEngine(conf)),
            ("torch", parse_config, lambda conf: Engine(conf, device=CPU))):
        conf = parse(_config(d, f"out_{who}.raw", fmt, extra))
        conf.quiet = quiet
        capsys.readouterr()
        make(conf).run()
        errs.append(capsys.readouterr().err)
    return errs


def _summary(err):
    """{channel: (count, peak dB)} of the one summary line."""
    lines = LINE.findall(err)
    assert len(lines) == 1, err
    out = {}
    for item in lines[0].split():
        ch, count, peak = item.split("/")
        out[int(ch)] = (int(count), float(peak))
    return out


@pytest.mark.parametrize("fmt", ["S24_4LE", "S24_BE"])
def test_run_prints_the_jax_overflow_summary(tmp_path, capsys, fmt):
    """The port's ``run()`` prints the JAX engine's line: the same
    channels and counts, the peaks within 0.01 dB (+6.02: samples at
    twice full scale)."""
    err_jax, err_torch = _run_both(tmp_path, capsys, fmt)
    want, got = _summary(err_jax), _summary(err_torch)
    assert sorted(want) == sorted(got) == [c for c, n in enumerate(CLIPS)
                                           if n]
    for c in want:
        assert got[c][0] == want[c][0] == CLIPS[c]
        assert abs(got[c][1] - want[c][1]) <= 0.01
        assert abs(got[c][1] - 20 * np.log10(2.0)) <= 0.01


@pytest.mark.parametrize("how", ["overflow_warnings_false", "quiet"])
def test_run_prints_no_overflow_summary_when_off(tmp_path, capsys, how):
    """``overflow_warnings: false;`` or ``quiet``: neither package prints
    the line, though the same samples clip."""
    off = how == "overflow_warnings_false"
    errs = _run_both(tmp_path, capsys, "S24_4LE",
                     "overflow_warnings: false;" if off else "",
                     quiet=not off)
    for err in errs:
        assert "Overflow warnings" not in err, err


def test_run_offline_prints_no_overflow_summary(tmp_path, capsys):
    """``run_offline`` prints nothing of it, as in the JAX package; its
    meters count the same clips."""
    from brutefir_tpu_torch.runtime.engine import Engine
    _input(tmp_path)
    eng = Engine(parse_config(_config(tmp_path, "out.raw", "S24_4LE", "")),
                 device=CPU)
    capsys.readouterr()
    stats = eng.run_offline()
    assert "Overflow warnings" not in capsys.readouterr().err
    assert list(stats["overflows"]) == list(CLIPS)
