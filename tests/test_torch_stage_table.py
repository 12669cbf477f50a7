"""The benchmark and debug modes of brutefir_tpu_torch against the JAX
package's, on the CPU.

``benchmark: true;`` and ``debug: true;`` run through the per-block
``Engine.run`` (never ``run_offline``), print the JAX package's stage
table every 10 periods and, under ``debug``, dump its event timeline.
Output words agree with the JAX engine's within +-1 LSB of S24 at levels
near 2^19 (docs/PARITY.md "Float-tolerance"; the JAX side runs its Pallas
MAC and glue, interpreted, the port's route) and are bit-equal to the
port's own offline run. ``runtime/stageprobe.py`` times its five ops at
the engine's shapes.
"""

import re

import numpy as np
import pytest
import torch

from brutefir_tpu.config import parse_config as jax_parse_config
from brutefir_tpu_torch.config import parse_config

CPU = torch.device("cpu")
N = 128

TABLE = re.compile(r"^decode/ms +\d+\.\d{3} \| device/ms +\d+\.\d{3} \| "
                   r"encode/ms +\d+\.\d{3} \| total/ms +\d+\.\d{3} \| "
                   r"rti +-?\d+\.\d{3}$")
SPLIT = re.compile(r"^decode +\d+\.\d{3} \| t2f +\d+\.\d{3} \| mix1 +\d+\.\d{3}"
                   r" \| conv +\d+\.\d{3} \| mix2 +\d+\.\d{3} \| f2t +\d+\.\d{3}"
                   r" \| encode +\d+\.\d{3} \| total +\d+\.\d{3} \| rti +-?\d+"
                   r"\.\d{3}  \(ms; device split calibrated\)$")
CALIB = re.compile(r"^device stage calibration \(ms/block\): t2f (\S+) mix1 "
                   r"(\S+) conv (\S+) mix2 (\S+) f2t (\S+)  \(sum (\S+)\)$")


def _input(d, frames, channels=2, seed=7):
    x = np.clip(np.round(np.random.default_rng(seed).standard_normal(
        (frames, channels)) * 2.0 ** 19), -(2 ** 23), 2 ** 23 - 1)
    x.astype("<i4").tofile(d / "in.raw")
    return x


def _config(d, out, mode="benchmark: true;", B=3):
    taps = (np.random.default_rng(9).standard_normal(N * B)
            * 0.1).astype(np.float32)
    (d / "c0.txt").write_text("\n".join(repr(float(v)) for v in taps))
    return f"""
sampling_rate: 44100;
filter_length: {N},{B};
{mode}
coeff 0 {{ filename: "{d / 'c0.txt'}"; format: "TEXT"; }};
input 0,1 {{ device: "file" {{ path: "{d / 'in.raw'}"; }}; sample: "S24_4LE"; channels: 2; }};
output 0,1 {{ device: "file" {{ path: "{d / out}"; }}; sample: "S24_4LE"; channels: 2; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_inputs: 1/-2; to_outputs: 1; coeff: 0; }};
"""


def _jax_run(d, monkeypatch, mode, out="out_jax.raw"):
    from brutefir_tpu.runtime import Engine as JaxEngine
    monkeypatch.setenv("BRUTEFIR_TPU_MAC", "pallas")
    monkeypatch.setenv("BRUTEFIR_TPU_FFT_GLUE", "pallas")
    stats = JaxEngine(jax_parse_config(_config(d, out, mode))).run()
    monkeypatch.delenv("BRUTEFIR_TPU_MAC")
    monkeypatch.delenv("BRUTEFIR_TPU_FFT_GLUE")
    return stats


def _main(d, out, mode):
    from brutefir_tpu_torch.__main__ import main
    cfg = d / f"{out}.conf"
    cfg.write_text(_config(d, out, mode))
    return main(["-quiet", "-nodefault", str(cfg)], device=CPU)


def _spy_runs(monkeypatch):
    from brutefir_tpu_torch.runtime.engine import Engine
    calls = []
    for name in ("run", "run_offline"):
        orig = getattr(Engine, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(Engine, name, spy)
    return calls


def _words(path):
    return np.fromfile(path, "<i4").astype(np.int64)


@pytest.mark.parametrize("mode", ["benchmark: true;", "debug: true;"])
def test_modes_run_per_block_and_match_jax(tmp_path, monkeypatch, capsys,
                                           mode):
    """``python -m brutefir_tpu_torch`` on a benchmark or debug config
    takes ``run()`` (exit 0) and writes the JAX engine's words within
    +-1 LSB, bit-equal to the port's own offline run of the config
    without the mode."""
    frames = N * 23 + 41
    x = _input(tmp_path, frames)
    calls = _spy_runs(monkeypatch)
    assert _main(tmp_path, "out_torch.raw", mode) == 0
    assert calls == ["run"]
    assert _main(tmp_path, "out_plain.raw", "") == 0
    assert calls == ["run", "run_offline"]
    _jax_run(tmp_path, monkeypatch, mode)
    yt = _words(tmp_path / "out_torch.raw")
    yj = _words(tmp_path / "out_jax.raw")
    assert yt.size == yj.size == x.size
    np.testing.assert_array_equal(yt, _words(tmp_path / "out_plain.raw"))
    assert np.abs(yt - yj).max() <= 1
    assert np.abs(yt).max() > 2 ** 18


@pytest.mark.parametrize("frames", [N * 36 + 5, N * 20, N * 9])
def test_stage_table_every_ten_periods_as_jax(tmp_path, monkeypatch, capsys,
                                              frames):
    """The table prints once every 10 periods (the EOF period counts), in
    the JAX engine's column text, as many times as the JAX engine prints
    it on the same run."""
    from brutefir_tpu_torch.runtime.engine import Engine
    _input(tmp_path, frames)
    capsys.readouterr()
    stats = Engine(parse_config(_config(tmp_path, "out_torch.raw")),
                   device=CPU).run()
    lines = capsys.readouterr().err.splitlines()
    _jax_run(tmp_path, monkeypatch, "benchmark: true;")
    jlines = [ln for ln in capsys.readouterr().err.splitlines()
              if ln.startswith("decode/ms")]
    periods = frames // N + 1
    assert stats["blocks"] == -(-frames // N)
    assert len(lines) == periods // 10 == len(jlines)
    for ln in lines + jlines:
        assert TABLE.match(ln), ln
    strip = re.compile(r" *-?\d+\.\d{3}")
    assert [strip.sub("#", ln) for ln in lines] == \
        [strip.sub("#", ln) for ln in jlines]


def test_dev_zero_benchmark_blocks():
    """tests/test_engine_e2e.py's /dev/zero -> /dev/null benchmark run:
    ``run(max_blocks=25)`` counts 25 blocks."""
    from brutefir_tpu_torch.runtime.engine import Engine
    conf = parse_config("""
sampling_rate: 44100;
filter_length: 128,2;
benchmark: true;
coeff 0 { filename: "dirac pulse"; };
input 0 { device: "file" { path: "/dev/zero"; }; sample: "S24_4LE"; channels: 1; };
output 0 { device: "file" { path: "/dev/null"; }; sample: "S24_4LE"; channels: 1; dither: false; };
filter 0 { from_inputs: 0; to_outputs: 0; coeff: 0; };
""")
    stats = Engine(conf, device=CPU).run(max_blocks=25)
    assert stats["blocks"] == 25
    assert stats["frames"] == 25 * 128


def test_stage_breakdown_calibrates_every_stage_once(tmp_path, monkeypatch,
                                                     capsys):
    """Under BRUTEFIR_TPU_STAGE_BREAKDOWN=1 the first table print
    calibrates once: the line names all five stages, each > 0, and every
    table line splits the device column into them."""
    from brutefir_tpu_torch.runtime.engine import Engine
    _input(tmp_path, N * 25)
    monkeypatch.setenv("BRUTEFIR_TPU_STAGE_BREAKDOWN", "1")
    capsys.readouterr()
    Engine(parse_config(_config(tmp_path, "out.raw")), device=CPU).run()
    lines = capsys.readouterr().err.splitlines()
    calib = [CALIB.match(ln) for ln in lines if ln.startswith("device stage")]
    assert len(calib) == 1 and calib[0] is not None, lines
    vals = [float(v) for v in calib[0].groups()]
    assert all(v > 0 for v in vals[:5])
    assert abs(sum(vals[:5]) - vals[5]) <= 0.006
    rows = [ln for ln in lines if ln.startswith("decode")]
    assert len(rows) == 2 and all(SPLIT.match(ln) for ln in rows), rows


def test_stageprobe_times_each_op_at_the_engine_shapes(monkeypatch):
    """``device_stage_slopes`` runs each of its five ops 1 + CALLS * REPS
    times at the engine's shapes: the forward transform of the input
    frames, both mixes, the unfused MAC over the init_state ring with
    ``arange(F) % E`` and an all-ones mask, the inverse transform."""
    from brutefir_tpu_torch.graph.spec import build_graph_spec
    from brutefir_tpu_torch.ops import partconv
    from brutefir_tpu_torch.runtime import stageprobe as sp
    C_in, C_out, F, B, E = 3, 2, 5, 4, 2
    spec = build_graph_spec(N, B, C_in, C_out, [[]] * F, [False] * F,
                            np.dtype(np.float32))
    bank = torch.randn(E, B, 2, N)
    seen = {k: [] for k in sp.STAGES}

    def spy(stage, fn):
        def wrapped(*a):
            seen[stage].append(a)
            return fn(*a)
        return wrapped

    monkeypatch.setattr(partconv, "rfft_planes",
                        spy("t2f", partconv.rfft_planes))
    monkeypatch.setattr(partconv, "irfft_planes",
                        spy("f2t", partconv.irfft_planes))
    mix = partconv.complex_mix
    monkeypatch.setattr(partconv, "complex_mix", lambda m, x: spy(
        "mix1" if m.shape == (F, C_in) else "mix2", mix)(m, x))
    monkeypatch.setattr(sp, "mac", spy("conv", sp.mac))
    got = sp.device_stage_slopes(spec, bank, "cpu")
    assert list(got) == list(sp.STAGES) and all(v > 0 for v in got.values())
    n = 1 + sp.CALLS * sp.REPS
    assert {k: len(v) for k, v in seen.items()} == dict.fromkeys(sp.STAGES, n)
    assert seen["t2f"][0][0].shape == (C_in, 2 * N)
    assert seen["mix1"][0][1].shape == (C_in, 2, N)
    assert seen["mix2"][0][0].shape == (C_out, F)
    assert seen["f2t"][0][0].shape == (C_out, 2, N)
    ring, bk, rows, idx, mask, t, uniform = seen["conv"][0]
    assert ring.shape == (F, B, 2, N) and bk is bank and not uniform
    assert rows.tolist() == list(range(F))
    assert idx.tolist() == [f % E for f in range(F)]
    assert bool((mask == 1).all()) and mask.shape == (F, B)
    assert int(t) == 1


_EVENT = re.compile(r"^    (\d+)\t(.+)$")


def _timeline(err: str):
    """The dumped timeline as [(stage, event, block)], times dropped."""
    out, stage, blk = [], None, None
    text = err[err.index("debug timeline ("):]
    for ln in text.splitlines()[1:]:
        if ln.endswith("_process:"):
            stage = ln[:-len("_process:")]
        elif ln.startswith("  period "):
            blk = int(ln[len("  period "):-1])
        elif _EVENT.match(ln):
            out.append((stage, _EVENT.match(ln).group(2), blk))
    return out


@pytest.mark.parametrize("frames", [N * 12 + 50, N * 7])
def test_debug_timeline_matches_jax(tmp_path, monkeypatch, capsys, frames):
    """``debug: true;`` dumps the input, filter and output sections at the
    end of ``run()``, one call/ret pair a period each, and the
    (stage, event, block) sequence equals the JAX engine's."""
    _input(tmp_path, frames)
    capsys.readouterr()
    assert _main(tmp_path, "out_torch.raw", "debug: true;") == 0
    ours = _timeline(capsys.readouterr().err)
    _jax_run(tmp_path, monkeypatch, "debug: true;")
    theirs = _timeline(capsys.readouterr().err)
    assert ours == theirs
    blocks = -(-frames // N)
    for stage, call, ret in (("input", "call read", "ret"),
                             ("filter", "call dispatch", "ret"),
                             ("output", "call write", "ret")):
        ev = [(e, b) for s, e, b in ours if s == stage]
        assert [e for e, _ in ev[0::2]] == [call] * (len(ev) // 2)
        assert all(e.startswith(ret) for e, _ in ev[1::2])
        assert len(ev) == 2 * (blocks + (stage == "input"
                                        and frames % N == 0))
    assert ("output", f"ret {frames - (blocks - 1) * N} frames",
            blocks - 1) in ours
