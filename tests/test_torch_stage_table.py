"""The benchmark and debug modes of brutefir_tpu_torch against the JAX
package's, on the CPU.

``benchmark: true;`` and ``debug: true;`` run through the per-block
``Engine.run`` (never ``run_offline``), print the JAX package's stage
table every 10 periods and, under ``debug``, dump its event timeline.
Output words agree with the JAX engine's within +-1 LSB of S24 at levels
near 2^19 (docs/PARITY.md "Float-tolerance"; the JAX side runs its Pallas
MAC and glue, interpreted, the port's route) and are bit-equal to the
port's own offline run. ``runtime/stageprobe.py`` times the calls of one
block of the route the engine runs (fused, stage loop, float64, taps, a
2 x 2 CPU mesh): one probe block makes one ``step_impl`` block's
kernel-wrapper calls, by function and argument shapes, each column holds
the calls its docstring names, and a run with the breakdown writes the
bytes of one without it.
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
    """``device_stage_slopes`` without a control snapshot, on the stage
    loop (K = 128 is below the fused kernel's shapes), runs each call of
    one block RUNS = 1 + CALLS * (REPS + 1) times at the engine's shapes: the M-point
    FFT of the input frames and the ring write of the mixed spectra
    (t2f), the input mix on M-point spectra (mix1), the unfused MAC over
    the probe's ``init_state`` ring with ``arange(F) % E`` and an all-ones
    mask (conv), the output mix (mix2), the valid-half inverse transform
    (f2t)."""
    from brutefir_tpu_torch.graph import compile as gc
    from brutefir_tpu_torch.graph.spec import build_graph_spec
    from brutefir_tpu_torch.ops import fft_glue, partconv
    from brutefir_tpu_torch.runtime import stageprobe as sp
    C_in, C_out, F, B, E = 3, 2, 5, 4, 2
    spec = build_graph_spec(N, B, C_in, C_out, [[]] * F, [False] * F,
                            np.dtype(np.float32))
    bank = torch.randn(E, B, 2, N)
    ops = {"fft_points": (fft_glue, "t2f"),
           "glue_fwd_ring": (fft_glue, "t2f"),
           "mix_points": (partconv, "mix1"), "mac": (gc, "conv"),
           "complex_mix": (partconv, "mix2"),
           "irfft_planes_valid": (partconv, "f2t")}
    seen = {k: [] for k in ops}

    def spy(name, fn):
        def wrapped(*a):
            seen[name].append(a)
            return fn(*a)
        return wrapped

    for name, (mod, _) in ops.items():
        monkeypatch.setattr(mod, name, spy(name, getattr(mod, name)))
    got = sp.device_stage_slopes(spec, bank, "cpu")
    assert list(got) == list(sp.STAGES) and all(v > 0 for v in got.values())
    n = sp.RUNS
    assert {k: len(v) for k, v in seen.items()} == dict.fromkeys(ops, n)
    assert sorted({stage for _, stage in ops.values()}) == sorted(sp.STAGES)
    assert seen["fft_points"][0][0].shape == (C_in, 2 * N)
    mix, X = seen["mix_points"][0]
    assert mix.shape == (F, C_in) and X.shape == (C_in, N) and X.is_complex()
    Zm, ring, rows, delay, t = seen["glue_fwd_ring"][0]
    assert Zm.shape == (F, N) and ring.shape == (F, B, 2, N) and rows is None
    assert delay.tolist() == [0] * F and int(t) == 0
    assert seen["complex_mix"][0][0].shape == (C_out, F)
    assert seen["complex_mix"][0][1].shape == (F, 2, N)
    assert seen["irfft_planes_valid"][0][0].shape == (C_out, 2, N)
    mring, bk, rows, idx, mask, t, uniform = seen["mac"][0]
    assert mring is ring and bk is bank and not uniform
    assert rows.tolist() == list(range(F))
    assert idx.tolist() == [f % E for f in range(F)]
    assert bool((mask == 1).all()) and mask.shape == (F, B)


# --- the probe times the route each block runs ------------------------------

class _PreConvolve:
    """A ``pre_convolve`` hook scaling filter f's spectra by 0.5 + f / 4:
    a frequency-domain tap, which keeps the step on the planes route."""

    def pre_convolve(self, buf, f):
        buf *= 0.5 + 0.25 * f


# route -> (block length, two-stage cascade, float_bits, tap, mesh, fused)
ROUTES = {
    "fused_uniform": (256, False, 32, False, False, True),
    "fused_per_filter": (256, False, 32, False, False, True),
    "cascade": (256, True, 32, False, False, False),
    "float64": (256, False, 64, False, False, False),
    "taps": (256, False, 32, True, False, False),
    "mesh_fused": (512, False, 32, False, True, True),
    "mesh_cascade": (256, True, 32, False, True, False),
}


def _route_config(d, route, out, mode="benchmark: true;", B=3):
    """A 2 x 2 config taking ``route``: one shared coefficient (two for
    ``fused_per_filter``; every filter its own on a cascade), a single
    stage of two filters, or two stages of two (inputs -> filters 2, 3 ->
    filters 0, 1 -> outputs)."""
    n, casc, bits = ROUTES[route][:3]
    rng = np.random.default_rng(11)
    for i in range(4):
        (d / f"c{i}.txt").write_text("\n".join(
            repr(float(v)) for v in rng.standard_normal(n * B) * 0.1))
    coeffs = "".join(f'coeff {i} {{ filename: "{d / f"c{i}.txt"}"; '
                     f'format: "TEXT"; }};\n' for i in range(4))
    if casc:
        filters = """
filter 0 { from_filters: 2/-2, 3; to_outputs: 0; coeff: 0; };
filter 1 { from_filters: 2; to_outputs: 1; coeff: 1; };
filter 2 { from_inputs: 0; to_filters: 0, 1; coeff: 2; };
filter 3 { from_inputs: 1/-3; to_filters: 0; coeff: 3; };
"""
    else:
        c1 = 1 if route == "fused_per_filter" else 0
        filters = f"""
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_inputs: 0/-6, 1/-2; to_outputs: 1; coeff: {c1}; }};
"""
    return f"""
float_bits: {bits};
sampling_rate: 44100;
filter_length: {n},{B};
{mode}
{coeffs}
input 0,1 {{ device: "file" {{ path: "{d / 'in.raw'}"; }}; sample: "S24_4LE"; channels: 2; }};
output 0,1 {{ device: "file" {{ path: "{d / out}"; }}; sample: "S24_4LE"; channels: 2; dither: false; }};
{filters}"""


def _route_engine(d, route, out="out.raw", mode="benchmark: true;"):
    from brutefir_tpu_torch.parallel import mesh as tmesh
    from brutefir_tpu_torch.runtime.engine import Engine
    tap, mesh = ROUTES[route][3:5]
    eng = Engine(parse_config(_route_config(d, route, out, mode)),
                 device=CPU, mesh=(tmesh.make_mesh([CPU] * 4, 2, 2)
                                   if mesh else None))
    if tap:
        eng.logic.append(_PreConvolve())
    return eng


def _sig(a):
    """What a call's argument is, for comparing calls: a tensor's shape
    and dtype, a Sharded's, an array's shape, a scalar itself."""
    from brutefir_tpu_torch.parallel.mesh import Mesh, Sharded
    if isinstance(a, torch.Tensor):
        return ("tensor", tuple(a.shape), str(a.dtype))
    if isinstance(a, Sharded):
        return ("sharded", a.shape, str(a.dtype))
    if isinstance(a, np.ndarray):
        return ("array", a.shape)
    if isinstance(a, Mesh):
        return ("mesh", tuple(a.devices.shape))
    return a


# the kernel wrappers of the step's routes, and the ring write under taps
# and meshes: compile's names are those step_impl calls
WRAPPERS = {
    "fft_glue": ("fft_points", "glue_fwd", "glue_fwd_ring", "glue_fwd_into",
                 "glue_inv"),
    "partconv": ("rfft_planes", "irfft_planes", "irfft_planes_valid",
                 "complex_mix", "mix_points", "convolve_eval",
                 "convolve_eval_points"),
    "compile": ("mac", "mac_mix", "mac_shard", "mac_mix_shard", "mac_dual",
                "mac_dual_shard", "_write_ring"),
}


def _spy_wrappers(monkeypatch):
    """Record every call of WRAPPERS as (name, argument signatures)."""
    from brutefir_tpu_torch.graph import compile as gc
    from brutefir_tpu_torch.ops import fft_glue, partconv
    mods = {"fft_glue": fft_glue, "partconv": partconv, "compile": gc}
    calls = []
    for mod, names in WRAPPERS.items():
        for name in names:
            fn = getattr(mods[mod], name)

            def spy(*a, _fn=fn, _name=name, **k):
                calls.append((_name, tuple(_sig(v) for v in a),
                              tuple(sorted((kk, _sig(v))
                                           for kk, v in k.items()))))
                return _fn(*a, **k)

            monkeypatch.setattr(mods[mod], name, spy)
    return calls


@pytest.mark.parametrize("route", list(ROUTES))
def test_probe_block_makes_one_step_blocks_calls(tmp_path, monkeypatch,
                                                 route):
    """On each route, one probe block makes the kernel-wrapper calls of
    one ``step_impl`` block, by function and argument shapes, under the
    engine's snapshot, bank, taps and mesh: the probe's calls are
    RUNS times one step block's. The fused routes time no
    output mix (mix2 0, folded into the MAC); every other column runs."""
    from collections import Counter
    from brutefir_tpu_torch.graph import compile as gc
    from brutefir_tpu_torch.runtime import stageprobe as sp
    monkeypatch.setattr(sp, "CALLS", 2)
    monkeypatch.setattr(sp, "REPS", 1)
    eng = _route_engine(tmp_path, route)
    eng.attach_logic()
    ctrl, _, uni, udl, _, bank, _ = eng._snapshot_epoch()
    assert uni == (not ROUTES[route][1] and route != "fused_per_filter")
    assert bool(eng.taps) == ROUTES[route][3]
    assert (eng.mesh is not None) == ROUTES[route][4]
    assert gc.fused_mix_route(eng.spec, False, eng.taps, eng.mesh) == \
        ROUTES[route][5]
    state = (eng._sharded.init_state(eng.ring_dtype) if eng.mesh is not None
             else gc.init_state(eng.spec, CPU, eng.ring_dtype))
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (eng.spec.n_inputs, eng.N)), dtype=gc.real_dtype(eng.spec))
    calls = _spy_wrappers(monkeypatch)
    gc.step_impl(eng.spec, state, ctrl, bank, x, uniform=uni,
                 uniform_delay=udl, taps=eng.taps, mesh=eng.mesh)
    step = Counter(calls)
    calls.clear()
    got = sp.device_stage_slopes(eng.spec, bank, eng.device, eng.ring_dtype,
                                 ctrl, uni, udl, eng.taps, eng.mesh)
    n = 1 + sp.CALLS * (sp.REPS + 1)
    assert step and Counter(calls) == Counter(
        {k: v * n for k, v in step.items()})
    names = {c[0] for c in step}
    assert ("mac_mix" in names or "mac_mix_shard" in names) == \
        ROUTES[route][5]
    assert (got["mix2"] == 0.0) == ROUTES[route][5]
    assert all(got[k] > 0 for k in sp.STAGES if k != "mix2")


_FUSED_F2T = {"irfft_planes_valid": 1, "glue_inv": 1}
_CASCADE_IN = {"complex_mix": 1, "convolve_eval_points": 1,
               "irfft_planes_valid": 1, "glue_inv": 1, "fft_points": 1}
# route -> column -> the wrappers its calls reach, as runtime/stageprobe.py
# documents them (the output inverse also reaches glue_inv; a mesh's ring
# write, _write_ring once and once a shard cell holding the stage's rows)
COLUMNS = {
    "fused_uniform": {"t2f": {"fft_points": 1, "glue_fwd_ring": 1},
                      "mix1": {"mix_points": 1}, "conv": {"mac_mix": 1},
                      "mix2": {}, "f2t": _FUSED_F2T},
    "cascade": {"t2f": {"fft_points": 1, "glue_fwd_ring": 2},
                "mix1": {"mix_points": 2}, "conv": {"mac": 2, **_CASCADE_IN},
                "mix2": {"complex_mix": 1}, "f2t": _FUSED_F2T},
    "float64": {"t2f": {"fft_points": 1, "glue_fwd_ring": 1},
                "mix1": {"mix_points": 1}, "conv": {"mac": 1},
                "mix2": {"complex_mix": 1}, "f2t": _FUSED_F2T},
    "taps": {"t2f": {"rfft_planes": 1, "fft_points": 1, "glue_fwd": 1,
                     "_write_ring": 1},
             "mix1": {"complex_mix": 1}, "conv": {"mac": 1},
             "mix2": {"complex_mix": 1}, "f2t": _FUSED_F2T},
    "mesh_fused": {"t2f": {"fft_points": 1, "glue_fwd": 1,
                           "_write_ring": 1 + 4},
                   "mix1": {"mix_points": 1}, "conv": {"mac_mix_shard": 1},
                   "mix2": {}, "f2t": _FUSED_F2T},
    "mesh_cascade": {"t2f": {"fft_points": 1, "glue_fwd": 2,
                             "_write_ring": 2 + 2 + 2},
                     "mix1": {"mix_points": 2},
                     "conv": {"mac_shard": 2, **_CASCADE_IN},
                     "mix2": {"complex_mix": 1}, "f2t": _FUSED_F2T},
}
COLUMNS["fused_per_filter"] = COLUMNS["fused_uniform"]


@pytest.mark.parametrize("route", list(ROUTES))
def test_probe_columns_hold_the_documented_calls(tmp_path, monkeypatch,
                                                 route):
    """``stageprobe.record_block`` puts each call of the block in the
    column the module docstring names for its route: one pass over a
    column's calls reaches exactly COLUMNS' wrappers."""
    from collections import Counter
    from brutefir_tpu_torch.graph import compile as gc
    from brutefir_tpu_torch.runtime import stageprobe as sp
    eng = _route_engine(tmp_path, route)
    eng.attach_logic()
    ctrl, _, uni, udl, _, bank, _ = eng._snapshot_epoch()
    state = (eng._sharded.init_state(eng.ring_dtype) if eng.mesh is not None
             else gc.init_state(eng.spec, CPU, eng.ring_dtype))
    x = torch.ones((eng.spec.n_inputs, eng.N), dtype=gc.real_dtype(eng.spec))
    calls = _spy_wrappers(monkeypatch)
    cols = sp.record_block(eng.spec, state, ctrl, bank, x, uni, udl,
                           eng.taps, eng.mesh)
    got = {}
    for k in sp.STAGES:
        calls.clear()
        for fn, args in cols[k]:
            fn(*args)
        got[k] = dict(Counter(c[0] for c in calls))
    assert got == COLUMNS[route]


@pytest.mark.parametrize("route", list(ROUTES))
def test_breakdown_leaves_the_output_bytes(tmp_path, monkeypatch, capsys,
                                           route):
    """A benchmark run under BRUTEFIR_TPU_STAGE_BREAKDOWN=1 writes the same
    bytes as one without it on each route (the probe owns its state), and
    prints one calibration line in the JAX package's text, with mix2
    0.000 on the fused routes."""
    frames = ROUTES[route][0] * 12 + 37
    _input(tmp_path, frames)
    outs = []
    for breakdown in (None, "1"):
        if breakdown:
            monkeypatch.setenv("BRUTEFIR_TPU_STAGE_BREAKDOWN", breakdown)
        out = f"out_{breakdown}.raw"
        capsys.readouterr()
        _route_engine(tmp_path, route, out).run()
        lines = capsys.readouterr().err.splitlines()
        outs.append((tmp_path / out).read_bytes())
        calib = [CALIB.match(ln) for ln in lines
                 if ln.startswith("device stage")]
        rows = [ln for ln in lines if ln.startswith("decode")]
        assert rows and all((SPLIT if breakdown else TABLE).match(ln)
                            for ln in rows), rows
    assert len(calib) == 1 and calib[0] is not None, lines
    assert (calib[0].group(4) == "0.000") == ROUTES[route][5]
    assert len(outs[0]) == frames * 2 * 4 and outs[0] == outs[1]


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
