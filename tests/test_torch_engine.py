"""File to file: the JAX Engine (Pallas fused MAC in interpret mode)
against the port's Engine on the CPU, run_offline() (batches of 8 blocks
on both sides).

S24 words agree within +-1 LSB (docs/PARITY.md "Float-tolerance": the
two packages round float32 sums in different orders); frame counts and
overflow meters agree. A logic module that no ``bflogic_<name>.py``
registers raises at ``run()``, as in the JAX package; float64 configs run
(tests/test_torch_float64.py)."""

import os

import numpy as np
import pytest
import torch

from brutefir_tpu.config import parse_config as jax_parse_config
from brutefir_tpu_torch.config import parse_config

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
CPU = torch.device("cpu")


def _s24_input(path, frames, channels, seed, std=2.0 ** 18):
    x = np.clip(np.round(np.random.default_rng(seed).standard_normal(
        (frames, channels)) * std), -(2 ** 23), 2 ** 23 - 1)
    x.astype("<i4").tofile(path)
    return x


def _taps_file(path, n, seed, scale=0.1):
    taps = (np.random.default_rng(seed).standard_normal(n)
            * scale).astype(np.float32)
    path.write_text("\n".join(repr(float(v)) for v in taps) + "\n")
    return taps


def _config(tmp_path, name, coeff_of, N=256, B=4):
    """An S24_4LE config with len(coeff_of) channels; filter f uses coeff
    coeff_of[f]."""
    C = len(coeff_of)
    chans = ",".join(str(c) for c in range(C))
    coeffs = "".join(
        f'coeff {k} {{ filename: "{tmp_path / f"c{k}.txt"}"; format: "TEXT"; }};\n'
        for k in sorted(set(coeff_of)))
    filters = "".join(
        f"filter {f} {{ from_inputs: {f}; to_outputs: {f}; coeff: {c}; }};\n"
        for f, c in enumerate(coeff_of))
    return f"""
sampling_rate: 44100;
filter_length: {N},{B};
{coeffs}
input {chans} {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: {C}; }};
output {chans} {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "S24_4LE"; channels: {C}; dither: false; }};
{filters}"""


def _massive_small(tmp_path, name):
    """examples/multichannel_massive.conf at test scale: same 26x26 graph
    with one shared coefficient, partitions shrunk to 256 x 4."""
    text = open(os.path.join(EXAMPLES, "multichannel_massive.conf")).read()
    text = text.replace("filter_length: 8192, 16;", "filter_length: 256, 4;")
    text = text.replace('"input.raw"', f'"{tmp_path / "in.raw"}"')
    text = text.replace('"output.raw"', f'"{tmp_path / name}"')
    text = text.replace('"correction.txt"', f'"{tmp_path / "c0.txt"}"')
    assert "filter_length: 256, 4;" in text
    return text


def _run_both(tmp_path, monkeypatch, make_text, frames, channels):
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    _s24_input(tmp_path / "in.raw", frames, channels, seed=11)
    # the JAX side runs its fused Pallas kernel, interpreted on the CPU
    monkeypatch.setenv("BRUTEFIR_TPU_MAC", "pallas")
    jeng = JaxEngine(jax_parse_config(make_text("out_jax.raw")))
    assert jeng.cg.mac == "pallas-interpret"
    jstats = jeng.run_offline(batch_blocks=8)
    teng = Engine(parse_config(make_text("out_torch.raw")), device=CPU)
    tstats = teng.run_offline()
    yj = np.fromfile(tmp_path / "out_jax.raw", "<i4").astype(np.int64)
    yt = np.fromfile(tmp_path / "out_torch.raw", "<i4").astype(np.int64)
    return jeng, teng, jstats, tstats, yj, yt


@pytest.mark.parametrize("kind", ["shared", "distinct", "massive_small"])
def test_engine_file_to_file_matches_jax(tmp_path, monkeypatch, kind):
    N = 256
    frames = N * 11 + 101          # > one batch, not a multiple of N
    if kind == "massive_small":
        C = 26
        _taps_file(tmp_path / "c0.txt", N * 4, seed=1)

        def make_text(name):
            return _massive_small(tmp_path, name)
    else:
        C = 3
        coeff_of = [0, 0, 0] if kind == "shared" else [0, 1, 0]
        _taps_file(tmp_path / "c0.txt", N * 4, seed=1)
        _taps_file(tmp_path / "c1.txt", N * 2 + 17, seed=2)

        def make_text(name):
            return _config(tmp_path, name, coeff_of)

    jeng, teng, js, ts, yj, yt = _run_both(tmp_path, monkeypatch,
                                           make_text, frames, C)
    assert ts["frames"] == js["frames"] == frames
    assert ts["blocks"] == js["blocks"] == 12
    assert yt.size == yj.size == frames * C
    assert np.abs(yt - yj).max() <= 1
    assert np.abs(yj).max() > 2 ** 18          # a real signal went through
    assert teng.control.snapshot_uniform == (kind != "distinct")
    assert ts["overflows"] == js["overflows"] == [0] * C
    for ot, oj in zip(teng.overflow, jeng.overflow):
        assert ot.n_overflows == oj.n_overflows
        assert abs(ot.intlargest - oj.intlargest) <= 1


def test_engine_clipping_meters_match_jax(tmp_path, monkeypatch):
    """A loud input clips: overflow counts and peaks agree."""
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    N = 256
    (tmp_path / "c0.txt").write_text("3.0\n")      # +9.5 dB
    # two regimes, so that no sample sits within float rounding of the
    # clip level: |x| <= 2^20 passes (|3x| < 2^22), |x| >= 2^22 clips
    rng = np.random.default_rng(5)
    x = np.round(rng.uniform(-1, 1, (N * 9 + 5, 2)) * 2 ** 20)
    loud = rng.uniform(size=x.shape) < 0.1
    x[loud] = np.sign(x[loud] + 0.5) * (2 ** 22 + np.abs(x[loud]))
    x.astype("<i4").tofile(tmp_path / "in.raw")

    def make_text(name):
        return _config(tmp_path, name, [0, 0])

    monkeypatch.setenv("BRUTEFIR_TPU_MAC", "pallas")
    # the JAX engine's twin of the port's FFT route (the glue route)
    monkeypatch.setenv("BRUTEFIR_TPU_FFT_GLUE", "pallas")
    jeng = JaxEngine(jax_parse_config(make_text("out_jax.raw")))
    js = jeng.run_offline(batch_blocks=8)
    teng = Engine(parse_config(make_text("out_torch.raw")), device=CPU)
    ts = teng.run_offline()
    assert ts["overflows"] == js["overflows"]
    assert min(ts["overflows"]) > 0
    for ot, oj in zip(teng.overflow, jeng.overflow):
        assert abs(ot.intlargest - oj.intlargest) <= 1
        np.testing.assert_allclose(ot.largest, oj.largest, rtol=1e-6)
    yj = np.fromfile(tmp_path / "out_jax.raw", "<i4").astype(np.int64)
    yt = np.fromfile(tmp_path / "out_torch.raw", "<i4").astype(np.int64)
    # frames carrying ~2^24-level content round at that level's float32
    # ulp (2 LSB) in both packages: up to 4 LSB apart here (ROADMAP
    # queue 3), where the quieter tests above stay within 1
    assert np.abs(yt - yj).max() <= 4
    # and each package sits as close to the float64 oracle as the other
    ref = np.clip(np.round(3.0 * x.reshape(-1)), -(2 ** 23), 2 ** 23 - 1)
    assert np.abs(yt - ref).max() <= 4 and np.abs(yj - ref).max() <= 4


# name: (sample format, numpy word dtype, input std, extra config lines,
#        channel/mapping fields per device, filter lines); 2 channels,
# 256 x 2 partitions, one coefficient
VARIANTS = {
    "s16_word": ("S16_LE", "<i2", 2.0 ** 12, "", "", ""),
    "s32_word": ("S32_LE", "<i4", 2.0 ** 26, "", "", ""),
    "float_word": ("FLOAT_LE", "<f4", 0.05, "", "", ""),
    "s24_packed3": ("S24_LE", None, 2.0 ** 18, "", "", ""),
    "out_fanin_matrix_mix": (
        "S24_4LE", "<i4", 2.0 ** 18, "", "mapping: 0,0;", ""),
    "filter_predelay": (
        "S24_4LE", "<i4", 2.0 ** 18, "", "",
        "filter 0 { from_inputs: 0; to_outputs: 0; coeff: 0; delay: 1; };\n"
        "filter 1 { from_inputs: 1/-3, 0; to_outputs: 1; coeff: 0; };\n"),
    "mute": ("S24_4LE", "<i4", 2.0 ** 18, "", "mute: false, true;", ""),
    "analog_powersave": ("S24_4LE", "<i4", 2.0 ** 18, "powersave: -70.0;",
                         "", ""),
}


@pytest.mark.parametrize("kind", sorted(VARIANTS))
def test_engine_variants_match_jax(tmp_path, monkeypatch, kind):
    """Wire formats (word, packed S24), the matrix output mix (two
    virtual outputs onto one physical channel), per-filter pre-delays
    and input mixes, mutes and the analog powersave gate, file to file
    against the JAX engine."""
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    fmt, dt, std, extra, devfield, filters = VARIANTS[kind]
    N, frames = 256, 256 * 10 + 33
    _taps_file(tmp_path / "c0.txt", N * 2, seed=3)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((frames, 2)) * std
    if kind == "analog_powersave":
        x[N * 3:N * 7] *= 1e-5           # a quiet stretch below -70 dB
    if dt is None:                        # 3-byte packed S24
        w = np.clip(np.round(x), -(2 ** 23), 2 ** 23 - 1).astype("<i4")
        (tmp_path / "in.raw").write_bytes(
            w.view(np.uint8).reshape(-1, 4)[:, :3].tobytes())
    elif dt == "<f4":
        x.astype(dt).tofile(tmp_path / "in.raw")
    else:
        info = np.iinfo(dt)
        np.clip(np.round(x), info.min, info.max).astype(dt).tofile(
            tmp_path / "in.raw")
    filters = filters or (
        "filter 0 { from_inputs: 0; to_outputs: 0; coeff: 0; };\n"
        "filter 1 { from_inputs: 1; to_outputs: 1; coeff: 0; };\n")
    out_field = devfield if kind != "mute" else ""
    in_field = devfield if kind == "mute" else ""

    def make_text(name):
        out_ch = "channels: 1;" if kind == "out_fanin_matrix_mix" else \
            "channels: 2;"
        return f"""
sampling_rate: 44100;
filter_length: {N},2;
{extra}
coeff 0 {{ filename: "{tmp_path / 'c0.txt'}"; format: "TEXT"; }};
input 0,1 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "{fmt}"; channels: 2; {in_field} }};
output 0,1 {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "{fmt}"; {out_ch} dither: false; {out_field} }};
{filters}"""

    monkeypatch.setenv("BRUTEFIR_TPU_MAC", "pallas")
    jeng = JaxEngine(jax_parse_config(make_text("out_jax.raw")))
    assert jeng.dio is not None and jeng.cg.mac == "pallas-interpret"
    js = jeng.run_offline(batch_blocks=8)
    teng = Engine(parse_config(make_text("out_torch.raw")), device=CPU)
    ts = teng.run_offline()
    assert ts["frames"] == js["frames"] == frames
    assert ts["overflows"] == js["overflows"]
    raw_j = (tmp_path / "out_jax.raw").read_bytes()
    raw_t = (tmp_path / "out_torch.raw").read_bytes()
    assert len(raw_t) == len(raw_j) > 0
    if dt is None:
        def words(b):
            a = np.frombuffer(b, np.uint8).reshape(-1, 3).astype(np.int32)
            v = a[:, 0] | (a[:, 1] << 8) | (a[:, 2] << 16)
            return (v - ((v & 0x800000) << 1)).astype(np.int64)
        yj, yt = words(raw_j), words(raw_t)
    else:
        yj = np.frombuffer(raw_j, dt).astype(np.float64)
        yt = np.frombuffer(raw_t, dt).astype(np.float64)
    # S16/S24: +-1 LSB; float and S32 outputs carry more bits than the
    # float32 engine resolves, so a float32 bound relative to the peak
    tol = 1e-6 * np.abs(yj).max() if dt in ("<f4", "<i4") and \
        fmt != "S24_4LE" else 1
    assert np.abs(yt - yj).max() <= tol
    assert np.abs(yj).max() > 0
    if kind == "mute":
        assert teng.dio is not None
        assert np.all(yt.reshape(-1, 2)[:, 1] == 0)


_FILTER0 = 'filter 0 { from_inputs: 0; to_outputs: 0; coeff: 0; };'
OUTSIDE = {
    # a logic module no bflogic_<name>.py on modules_path registers
    "logic_mymod": 'logic: "mymod" { a: 1; };\n' + _FILTER0,
}


@pytest.mark.parametrize("kind", sorted(OUTSIDE))
def test_config_outside_the_slice_raises(tmp_path, kind):
    from brutefir_tpu_torch.runtime.engine import Engine
    (tmp_path / "in.raw").write_bytes(b"")
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: 128,2;
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{tmp_path / 'out.raw'}"; }}; sample: "S24_4LE"; channels: 1; dither: false; }};
{OUTSIDE[kind]}
""")
    # the engine builds; attaching the module (the first thing run()
    # does) raises, as in the JAX package
    eng = Engine(conf, device=CPU)
    with pytest.raises(RuntimeError, match="unknown logic module: mymod"):
        eng.run()


def test_main_runs_on_cpu_and_matches_engine(tmp_path):
    """The port's __main__ entry, device given as a function argument."""
    from brutefir_tpu_torch.__main__ import main
    from brutefir_tpu_torch.runtime.engine import Engine
    N = 256
    _taps_file(tmp_path / "c0.txt", N * 3, seed=4)
    _s24_input(tmp_path / "in.raw", N * 10 + 7, 2, seed=6)
    cfg = tmp_path / "c.conf"
    cfg.write_text(_config(tmp_path, "out_main.raw", [0, 0]))
    assert main(["-quiet", "-nodefault", str(cfg)], device=CPU) == 0
    Engine(parse_config(_config(tmp_path, "out_eng.raw", [0, 0])),
           device=CPU).run_offline()
    a = np.fromfile(tmp_path / "out_main.raw", "<i4")
    b = np.fromfile(tmp_path / "out_eng.raw", "<i4")
    assert a.size == (N * 10 + 7) * 2
    np.testing.assert_array_equal(a, b)


def test_main_rejects_bad_flags_and_missing_config(tmp_path):
    from brutefir_tpu_torch.__main__ import main
    assert main(["-bogus"], device=CPU) == 2
    assert main(["-nodefault"], device=CPU) == 2
    assert main(["-nodefault", str(tmp_path / "none.conf")],
                device=CPU) in (1, 2)


def test_run_offline_max_blocks_tail(tmp_path):
    """An input of whole blocks that is no multiple of the batch: the
    blocks after the last full batch finish block by block."""
    from brutefir_tpu_torch.runtime.engine import BATCH_BLOCKS, Engine
    N = 256
    blocks = BATCH_BLOCKS + 3
    _taps_file(tmp_path / "c0.txt", N, seed=7)
    _s24_input(tmp_path / "in.raw", N * blocks, 1, seed=8)
    eng = Engine(parse_config(_config(tmp_path, "o.raw", [0])), device=CPU)
    stats = eng.run_offline()
    assert stats["blocks"] == blocks
    assert stats["frames"] == blocks * N
    assert os.path.getsize(tmp_path / "o.raw") == blocks * N * 4


def test_offline_output_matches_convolution_oracle(tmp_path):
    """Port alone against a float64 convolution oracle, within 2 LSB."""
    import scipy.signal
    from brutefir_tpu_torch.runtime.engine import Engine
    N = 256
    taps = _taps_file(tmp_path / "c0.txt", N * 4, seed=9)
    frames = N * 9 + 200
    x = _s24_input(tmp_path / "in.raw", frames, 2, seed=10)
    Engine(parse_config(_config(tmp_path, "o.raw", [0, 0])),
           device=CPU).run_offline()
    y = np.fromfile(tmp_path / "o.raw", "<i4").reshape(-1, 2)
    for c in range(2):
        ref = np.round(scipy.signal.fftconvolve(
            x[:, c], taps.astype(np.float64))[:frames])
        assert np.abs(y[:, c] - ref).max() <= 2


def test_main_runs_a_pipe_block_by_block(tmp_path, monkeypatch):
    """A file device on a live endpoint (a FIFO) is not batch safe: the
    port's __main__ runs it through the per-block run(), and the output
    equals the batched run of the same samples from a regular file."""
    import threading
    from brutefir_tpu_torch.__main__ import main
    from brutefir_tpu_torch.runtime.engine import Engine
    N = 256
    _taps_file(tmp_path / "c0.txt", N * 2, seed=13)
    _s24_input(tmp_path / "in.raw", N * 5 + 30, 2, seed=14)
    Engine(parse_config(_config(tmp_path, "o_file.raw", [0, 0])),
           device=CPU).run_offline()
    fifo = tmp_path / "pipe"
    os.mkfifo(fifo)
    cfg = tmp_path / "p.conf"
    cfg.write_text(_config(tmp_path, "o_pipe.raw", [0, 0]).replace(
        str(tmp_path / "in.raw"), str(fifo)))
    used = []
    for name in ("run", "run_offline"):
        orig = getattr(Engine, name)
        monkeypatch.setattr(Engine, name, lambda self, *a, _o=orig,
                            _n=name, **k: (used.append(_n),
                                           _o(self, *a, **k))[1])
    data = (tmp_path / "in.raw").read_bytes()

    def feed():
        with open(fifo, "wb") as fh:
            fh.write(data)

    th = threading.Thread(target=feed, daemon=True)
    th.start()
    assert main(["-quiet", "-nodefault", str(cfg)], device=CPU) == 0
    th.join(timeout=10)
    assert used == ["run"]
    assert ((tmp_path / "o_pipe.raw").read_bytes()
            == (tmp_path / "o_file.raw").read_bytes())
