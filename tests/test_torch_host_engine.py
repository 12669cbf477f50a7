"""The port's host codec path against the JAX package's, engines on the
CPU file to file at 256 x 4 partitions with 2-3 channels.

A config whose devices include a format without a device codec
(big-endian words, 3-byte big-endian S24, 8-byte floats) runs every
device through ``Engine.read_block`` / ``write_block`` in both packages,
and ``run_offline`` falls back to ``run``. Bounds: integer words within
+-1 LSB of the JAX engine's (docs/PARITY.md's "Float-tolerance"), with
more than 90% of them equal (32-bit words in LSB of 24 bits, the float32
significand); float outputs within 1e-6 of the peak;
dithered words within 2 LSB (the error feedback walks apart on float
rounding upstream, tests/test_torch_device_delay.py), with more than 80%
equal. The host path against the port's device-IO path on the same
samples is bit-equal without dither. The JAX engine runs its default CPU
step, as the JAX package's own engine tests do.
"""

import os
import re

import numpy as np
import pytest
import torch

import brutefir_tpu.core.dither as jdither
from brutefir_tpu.config import parse_config as jax_parse_config
from brutefir_tpu.core.codecs import Overflow as JaxOverflow
from brutefir_tpu.core.codecs import float_to_raw as jax_float_to_raw
from brutefir_tpu.core.codecs import raw_to_float as jax_raw_to_float
from brutefir_tpu.core.sampleformat import parse_sample_format
from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.core import dither as tdither

CPU = torch.device("cpu")
N, B = 256, 4
HOST_FORMATS = ["S16_BE", "S24_BE", "S32_BE", "S24_4BE", "FLOAT_BE",
                "FLOAT64_LE", "FLOAT64_BE"]
EQUAL_SHARE = 0.9          # integer words equal to the JAX engine's
DITHER_SHARE = 0.8         # dithered words equal to the JAX engine's


@pytest.fixture
def fast_jax_table(monkeypatch):
    """The JAX DitherTable with the port's vectorised generator
    (byte-equal to its one-byte loop, tests/test_torch_device_dither.py)."""
    monkeypatch.setattr(jdither, "tausrand_table", tdither.tausrand_table)


def _write(path, fmt_name, x):
    """x [frames, C] at the format's integer scale (or floats) -> the
    file's bytes, through the JAX package's codec."""
    fmt = parse_sample_format(fmt_name)
    rows = np.ascontiguousarray(x.T, np.float32)
    raw = np.zeros(x.size * fmt.bytes, np.uint8)
    jax_float_to_raw(rows, fmt, x.shape[1], list(range(x.shape[1])), raw,
                     [JaxOverflow(max=1e30) for _ in range(x.shape[1])])
    raw.tofile(path)


def _signal(fmt_name, frames, C, seed, level=2.0 ** -5):
    """Seeded samples of std ``level`` of full scale, integer-valued for
    integer formats."""
    fmt = parse_sample_format(fmt_name)
    x = np.random.default_rng(seed).standard_normal((frames, C)) * level
    if fmt.is_float:
        return x
    return np.clip(np.round(x * 2.0 ** (fmt.bits - 1)), fmt.imin, fmt.imax)


def _read(path, fmt_name, C):
    """A file's samples [frames, C] as float64 (integer scale for integer
    formats)."""
    fmt = parse_sample_format(fmt_name)
    raw = np.fromfile(path, np.uint8)
    frames = raw.size // (fmt.bytes * C)
    return jax_raw_to_float(raw, fmt, frames, C, list(range(C)),
                            np.float64).T


def _taps(tmp_path, seed, n=N * B, name=None):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal(n) * np.exp(-np.arange(n) / (n / 6))
    h = (0.5 * h / np.linalg.norm(h)).astype(np.float32)
    path = tmp_path / (name or f"h{seed}.txt")
    path.write_text("\n".join(repr(float(v)) for v in h) + "\n")
    return path


def _config(tmp_path, out_name, in_fmt, out_fmt, C=3, coeffs=(0, 1, 0),
            in_fields="", out_fields="dither: false;", head="",
            filters=None, inputs=None, outputs=None):
    files = {k: _taps(tmp_path, 40 + k) for k in sorted(set(coeffs))}
    chans = ",".join(str(c) for c in range(C))
    text = f"sampling_rate: 8000;\nfilter_length: {N},{B};\n{head}\n"
    text += "".join(f'coeff {k} {{ filename: "{p}"; format: "TEXT"; }};\n'
                    for k, p in files.items())
    text += inputs or (
        f'input {chans} {{ device: "file" {{ path: "{tmp_path / "in.raw"}"; '
        f'}}; sample: "{in_fmt}"; channels: {C}; {in_fields} }};\n')
    text += outputs or (
        f'output {chans} {{ device: "file" {{ path: '
        f'"{tmp_path / out_name}"; }}; sample: "{out_fmt}"; channels: {C}; '
        f'{out_fields} }};\n')
    text += filters or "".join(
        f"filter {f} {{ from_inputs: {f}; to_outputs: {f}; coeff: {c}; }};\n"
        for f, c in enumerate(coeffs))
    return text


def _engines(make_text):
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    jeng = JaxEngine(jax_parse_config(make_text("out_jax.raw")))
    teng = Engine(parse_config(make_text("out_port.raw")), device=CPU)
    return jeng, teng


def _run_both(make_text, offline=True):
    """Both engines file to file; the port's must be on the host path."""
    jeng, teng = _engines(make_text)
    assert jeng.dio is None and teng.dio is None
    js = jeng.run_offline() if offline else jeng.run()
    ts = teng.run_offline() if offline else teng.run()
    assert ts["frames"] == js["frames"] and ts["blocks"] == js["blocks"]
    return jeng, teng, ts


def _compare(tmp_path, out_fmt, C, share=EQUAL_SHARE, tol=1):
    yj = _read(tmp_path / "out_jax.raw", out_fmt, C)
    yt = _read(tmp_path / "out_port.raw", out_fmt, C)
    assert yt.shape == yj.shape and yj.size
    peak = np.abs(yj).max()
    assert peak > 0
    if parse_sample_format(out_fmt).is_float:
        assert np.abs(yt - yj).max() <= 1e-6 * peak
        return yj, yt
    # 32-bit words hold more bits than the float32 path carries: they
    # compare in LSB of 24 bits (float32's 24-bit significand)
    d = np.abs(yt - yj) / 2.0 ** max(0, parse_sample_format(out_fmt).bits
                                     - 24)
    assert d.max() <= tol
    assert np.mean(d < 1) > share, np.mean(d < 1)
    return yj, yt


FORMAT_CASES = ([("input", f) for f in HOST_FORMATS]
                + [("output", f) for f in HOST_FORMATS])


@pytest.mark.parametrize("side,fmt", FORMAT_CASES,
                         ids=[f"{s}-{f}" for s, f in FORMAT_CASES])
def test_format_matches_jax(tmp_path, side, fmt):
    """One host-path format on one side (S24_4LE, which has a device
    codec, on the other), 11.4 blocks through run_offline -> run: the
    port's output within the bounds of the JAX engine's, and the same
    overflow meters."""
    in_fmt, out_fmt = (fmt, "S24_4LE") if side == "input" else ("S24_4LE",
                                                               fmt)
    frames = N * 11 + 101
    _write(tmp_path / "in.raw", in_fmt, _signal(in_fmt, frames, 3, 1))
    jeng, teng, ts = _run_both(lambda n: _config(tmp_path, n, in_fmt,
                                                 out_fmt))
    assert ts["frames"] == frames
    _compare(tmp_path, out_fmt, 3)
    lsb = 2 ** max(0, parse_sample_format(out_fmt).bits - 24)
    for ot, oj in zip(teng.overflow, jeng.overflow):
        assert ot.n_overflows == oj.n_overflows
        assert abs(ot.intlargest - oj.intlargest) <= lsb
        assert ot.largest == pytest.approx(oj.largest, rel=1e-6)


def test_dithered_s16_be_matches_jax(tmp_path, fast_jax_table):
    """Dithered S16_BE outputs: the host DitherState per channel from the
    engine's shared table, at the JAX engine's table offsets."""
    frames = N * 12 + 7
    _write(tmp_path / "in.raw", "S32_BE",
           _signal("S32_BE", frames, 3, 2, level=0.1))
    jeng, teng, _ = _run_both(lambda n: _config(
        tmp_path, n, "S32_BE", "S16_BE", out_fields="dither: true;"))
    assert teng.dither_table is not None
    assert [s.table for s in teng.dither_state] == [teng.dither_table] * 3
    assert ([s.randtab_ptr for s in teng.dither_state]
            == [s.randtab_ptr for s in jeng.dither_state])
    _compare(tmp_path, "S16_BE", 3, share=DITHER_SHARE, tol=2)


def test_cli_delay_and_mute_changes_match_jax(tmp_path):
    """A CLI script through run(): output 0's delay raised 0 -> 300 at
    block 2 (the DelayLine zeroes its whole history), output 1 lowered
    9 -> 3 at block 4 (stale buffers replay), output 2 muted at block 3
    and unmuted at block 6, input 1 muted at block 5. Both engines keep
    the reference's delay machine, so the port follows the JAX host path
    within 1 LSB."""
    frames = N * 10 + 55
    _write(tmp_path / "in.raw", "S24_BE",
           _signal("S24_BE", frames, 3, 3, level=0.1))
    script = ("sleep b1\\ncod 0 300\\ntmo 2\\ncod 1 3\\ntmi 1\\ntmo 2; "
              "sleep b999")
    jeng, teng, ts = _run_both(lambda n: _config(
        tmp_path, n, "S24_BE", "S24_BE",
        head=f'logic: "cli" {{ script: "{script}"; echo: false; }};',
        out_fields="dither: false; delay: 0, 9, 0; maxdelay: 600;"),
        offline=False)
    assert ts["blocks"] == 11
    assert teng.control.delay[1] == [300, 3, 0]
    yj, yt = _compare(tmp_path, "S24_BE", 3, share=0.95)
    assert not yt[2 * N:2 * N + 300, 0].any()         # history zeroed
    assert not yt[3 * N:6 * N, 2].any() and yt[6 * N:, 2].any()


def test_subdelays_match_jax(tmp_path):
    """sdf_length 15: input subdelays on channels 0 and 2, output
    subdelays on 1 (the others take the compensating integer delay), an
    input delay, through the host SubsampleDelay and DelayLines."""
    frames = N * 9 + 40
    _write(tmp_path / "in.raw", "S32_BE",
           _signal("S32_BE", frames, 3, 4, level=0.1))
    _run_both(lambda n: _config(
        tmp_path, n, "S32_BE", "S24_BE", head="sdf_length: 15;",
        in_fields="delay: 0, 17, 3; subdelay: 30, -100, -55;",
        out_fields="dither: false; subdelay: -100, 70, -100;"))
    _compare(tmp_path, "S24_BE", 3)


def test_crossfading_filters_match_jax(tmp_path):
    """crossfade: true filters whose set a CLI script swaps every other
    block (the dual MAC, TPU kernel 8, on the crossfade blocks)."""
    frames = N * 9 + 11
    _write(tmp_path / "in.raw", "FLOAT64_LE",
           _signal("FLOAT64_LE", frames, 2, 5, level=0.1))
    filters = ("filter 0 { from_inputs: 0; to_outputs: 0; coeff: 0; "
               "crossfade: true; };\n"
               "filter 1 { from_inputs: 1; to_outputs: 1; coeff: 1; "
               "crossfade: true; };\n")
    script = "cfc 0 1; cfc 1 0\\nsleep b0\\ncfc 0 0; cfc 1 1\\nsleep b999"
    _run_both(lambda n: _config(
        tmp_path, n, "FLOAT64_LE", "FLOAT_BE", C=2, coeffs=(0, 1),
        head=f'logic: "cli" {{ script: "{script}"; echo: false; }};',
        filters=filters), offline=False)
    _compare(tmp_path, "FLOAT_BE", 2)


def test_two_stage_cascade_matches_jax(tmp_path):
    """Two inputs -> two filters -> one filter each -> two outputs (the
    stage loop's unfused MAC, TPU kernels 6-10)."""
    frames = N * 9 + 200
    _write(tmp_path / "in.raw", "S16_BE",
           _signal("S16_BE", frames, 2, 6, level=0.1))
    filters = (
        'filter "a" { from_inputs: 0; to_filters: "c"; coeff: 0; };\n'
        'filter "b" { from_inputs: 1; to_filters: "d"; coeff: 1; };\n'
        'filter "c" { from_filters: "a"; to_outputs: 0; coeff: 1; };\n'
        'filter "d" { from_filters: "b"; to_outputs: 1; coeff: 0; };\n')
    _run_both(lambda n: _config(tmp_path, n, "S16_BE", "S32_BE", C=2,
                                coeffs=(0, 1), filters=filters))
    _compare(tmp_path, "S32_BE", 2)


def test_mixed_devices_take_the_host_path(tmp_path):
    """An S24_4LE input beside an S16_BE one, an S24_4LE output beside a
    FLOAT64_LE one: one device without a device codec sends the whole
    engine to the host path, in both packages; two output devices encode
    in parallel."""
    frames = N * 8 + 30
    _write(tmp_path / "a.raw", "S24_4LE",
           _signal("S24_4LE", frames, 2, 7, level=0.1))
    _write(tmp_path / "b.raw", "S16_BE",
           _signal("S16_BE", frames, 1, 8, level=0.1))
    inputs = (
        f'input 0,1 {{ device: "file" {{ path: "{tmp_path / "a.raw"}"; }}; '
        f'sample: "S24_4LE"; channels: 2; }};\n'
        f'input 2 {{ device: "file" {{ path: "{tmp_path / "b.raw"}"; }}; '
        f'sample: "S16_BE"; channels: 1; }};\n')

    def outputs(name):
        return (f'output 0 {{ device: "file" {{ path: '
                f'"{tmp_path / ("a_" + name)}"; }}; sample: "S24_4LE"; '
                f'channels: 1; dither: false; }};\n'
                f'output 1,2 {{ device: "file" {{ path: '
                f'"{tmp_path / ("b_" + name)}"; }}; sample: "FLOAT64_LE"; '
                f'channels: 2; }};\n')

    _, teng, _ = _run_both(lambda n: _config(
        tmp_path, n, None, None, inputs=inputs, outputs=outputs(n)))
    assert teng._encode_pool is None                 # shut down at teardown
    for pre, fmt, C in (("a_", "S24_4LE", 1), ("b_", "FLOAT64_LE", 2)):
        os.replace(tmp_path / f"{pre}out_jax.raw", tmp_path / "out_jax.raw")
        os.replace(tmp_path / f"{pre}out_port.raw",
                   tmp_path / "out_port.raw")
        _compare(tmp_path, fmt, C)


def test_run_offline_falls_back_to_run(tmp_path, monkeypatch):
    """On the host path run_offline is run() (engine.py:1633)."""
    from brutefir_tpu_torch.runtime.engine import Engine
    _write(tmp_path / "in.raw", "S24_BE", _signal("S24_BE", N * 3, 3, 9))
    text = _config(tmp_path, "out_port.raw", "S24_BE", "S24_BE")
    eng = Engine(parse_config(text), device=CPU)
    seen = []
    real_run = eng.run
    monkeypatch.setattr(eng, "run", lambda *a, **k: seen.append(k)
                        or real_run(*a, **k))
    stats = eng.run_offline(max_blocks=2)
    assert seen == [{"setup": True}] and stats["blocks"] == 2
    assert os.path.getsize(tmp_path / "out_port.raw") == 2 * N * 3 * 3


def test_host_io_state_from_jax_continues_a_jax_run(tmp_path,
                                                    fast_jax_table):
    """The JAX engine runs 5 blocks of a config with input and output
    delays, subdelays and dithered S16_BE outputs; its step state and
    host IO state go over to the port, which runs the remaining 5.5
    blocks from the rest of the input beside the JAX engine running on.
    The outputs agree within the dithered bound, the delayed samples of
    the first part come out of the port's delay lines, and the dither
    pointers, delay-line cursors and meters end equal."""
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.convert import (host_io_state_from_jax,
                                            state_from_jax)
    from brutefir_tpu_torch.runtime.engine import Engine
    k, frames = 5, N * 10 + N // 2
    x = _signal("S32_BE", frames, 3, 10, level=0.1)
    _write(tmp_path / "in.raw", "S32_BE", x)
    _write(tmp_path / "rest.raw", "S32_BE", x[k * N:])
    fields = dict(
        head="sdf_length: 15;", in_fields="delay: 5, 0, 40; maxdelay: 300;",
        out_fields="dither: true; delay: 200, 0, 7; subdelay: 40, -100, "
                   "-100;")
    jeng = JaxEngine(jax_parse_config(_config(
        tmp_path, "out_jax.raw", "S32_BE", "S16_BE", **fields)))
    jeng.setup()
    jeng.run(max_blocks=k, setup=False)
    text = _config(tmp_path, "out_port.raw", "S32_BE", "S16_BE", **fields)
    text = text.replace(str(tmp_path / "in.raw"), str(tmp_path / "rest.raw"))
    teng = Engine(parse_config(text), device=CPU)
    js = jeng.state
    teng.state = state_from_jax(np.asarray(js.prev_in), np.asarray(js.ring),
                                np.asarray(js.eval_prev), js.t, CPU)
    host_io_state_from_jax(jeng, teng)
    jeng.run(setup=False)
    jeng.teardown()
    teng.run()
    yj = _read(tmp_path / "out_jax.raw", "S16_BE", 3)[k * N:]
    yt = _read(tmp_path / "out_port.raw", "S16_BE", 3)
    assert yt.shape == yj.shape == (frames - k * N, 3)
    d = np.abs(yt - yj)
    assert d.max() <= 2 and np.mean(d == 0) > DITHER_SHARE
    assert np.abs(yt[:150, 0]).max() > 100        # delayed first-part audio
    for a, b in zip(jeng.dither_state, teng.dither_state):
        assert a.randtab_ptr == b.randtab_ptr
    for io in (0, 1):
        for a, b in zip(jeng.dlines[io], teng.dlines[io]):
            assert (a.delay, a._curbuf, a._n_rest) == (b.delay, b._curbuf,
                                                       b._n_rest)
    for a, b in zip(jeng._phys_overflow, teng._phys_overflow):
        assert abs(a.intlargest - b.intlargest) <= 2


def test_host_path_matches_device_path(tmp_path):
    """The same samples as S32_BE in / S24_BE out (the host path) and as
    S32_LE in / S24_LE out (the device-IO path), with output delays:
    bit-equal after the byte swap."""
    from brutefir_tpu_torch.runtime.engine import Engine
    frames = N * 10 + 77
    x = _signal("S32_LE", frames, 3, 11, level=0.1)
    outs = {}
    for in_fmt, out_fmt in (("S32_BE", "S24_BE"), ("S32_LE", "S24_LE")):
        _write(tmp_path / "in.raw", in_fmt, x)
        eng = Engine(parse_config(_config(
            tmp_path, "out.raw", in_fmt, out_fmt,
            out_fields="dither: false; delay: 0, 13, 300;")), device=CPU)
        assert (eng.dio is None) == (in_fmt == "S32_BE")
        eng.run_offline()
        outs[in_fmt] = _read(tmp_path / "out.raw", out_fmt, 3)
    assert np.abs(outs["S32_LE"]).max() > 2.0 ** 18
    np.testing.assert_array_equal(outs["S32_BE"], outs["S32_LE"])


_TABLE = re.compile(r"^decode/ms +\d+\.\d{3} \| device/ms +\d+\.\d{3} \| "
                    r"encode/ms +\d+\.\d{3} \| total/ms +\d+\.\d{3} \| "
                    r"rti +-?\d+\.\d{3}$")
_EVENT = re.compile(r"^    \d+\t(.+)$")


def _timeline(err):
    """The dumped debug timeline as [(stage, event, block)]."""
    out, stage, blk = [], None, None
    for ln in err[err.index("debug timeline ("):].splitlines()[1:]:
        if ln.endswith("_process:"):
            stage = ln[:-len("_process:")]
        elif ln.startswith("  period "):
            blk = int(ln[len("  period "):-1])
        elif _EVENT.match(ln):
            out.append((stage, _EVENT.match(ln).group(1), blk))
    return out


@pytest.mark.parametrize("mode", ["benchmark: true;", "debug: true;"])
def test_stage_table_and_timeline_on_the_host_path(tmp_path, capsys, mode):
    """``benchmark: true;`` and ``debug: true;`` on the host path: the
    stage table every 10 periods and the debug timeline's events, as the
    JAX engine prints them on its host path."""
    frames = N * 21 + 50
    _write(tmp_path / "in.raw", "S24_BE", _signal("S24_BE", frames, 3, 12))
    jeng, teng = _engines(lambda n: _config(tmp_path, n, "S24_BE", "S24_BE",
                                            head=mode))
    assert jeng.dio is None and teng.dio is None
    capsys.readouterr()
    jeng.run()
    jerr = capsys.readouterr().err
    teng.run()
    terr = capsys.readouterr().err
    _compare(tmp_path, "S24_BE", 3)
    tables = [[ln for ln in e.splitlines() if _TABLE.match(ln)]
              for e in (jerr, terr)]
    assert len(tables[1]) == len(tables[0]) == 2
    if mode == "debug: true;":
        ours = _timeline(terr)
        assert ours == _timeline(jerr)
        assert ("output", "call write", 21) in ours
