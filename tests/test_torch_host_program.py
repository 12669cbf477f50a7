"""The host codec path's step programs (``runtime/program.HostStep``,
``Engine._dispatch_host``) on the CPU: engines on that path step through
one program a key ``(uniform, udelay, xfade)`` over static copies of the
state, ``ctrl`` and the bank, and a static input block the engine fills.

Each case runs one config file to file through three engines: the port
through the programs with an emulated capture and replay (``_Emulated``
of tests/test_torch_program.py: a key's second call captures, the later
ones replay), the port through the eager dispatch
(``Engine._dispatch_eager``, ``step_impl`` op by op, where
``chip_smoke.eager_forms`` routes it), byte-equal with equal launch
counts; and the JAX engine, within tests/test_torch_host_engine.py's
bounds (integer words within 1 LSB with more than 90% of them equal,
dithered words within 2 LSB with more than 80% equal, float32 outputs
within 1e-6 of the peak) or, for a float64 graph,
tests/test_torch_float64.py's (1e-11 of the peak). The CPU itself does
not capture: there the programs run their body eagerly at every call
through the same plumbing.
"""

import contextlib

import numpy as np
import pytest
import torch

from brutefir_tpu.config import parse_config as jax_parse_config
from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.graph import compile as tcomp
from brutefir_tpu_torch.ops import fft_glue, partconv
from brutefir_tpu_torch.runtime import program
from test_torch_float64 import REL_FLOAT, x64
from test_torch_host_engine import (DITHER_SHARE, EQUAL_SHARE, N, _compare,
                                    _config, _read, _signal, _write,
                                    fast_jax_table)  # noqa: F401
from test_torch_program import _Emulated, emulated  # noqa: F401

CPU = torch.device("cpu")


class _HostView:
    """An engine's HostStep as ``_Emulated`` reads a DeviceIO: its
    statics (no ``dstate``) and its programs."""
    dstate = None

    def __init__(self, eng):
        self.eng = eng

    @property
    def _statics(self):
        return self.eng.host_step._statics

    def programs(self):
        return self.eng.host_step.programs()


# the step's kernel wrappers and transforms, counted on the CPU
SPIED = ((tcomp, "mac_mix"), (tcomp, "mac"), (tcomp, "mac_dual"),
         (tcomp, "mac_mix_shard"), (tcomp, "mac_shard"),
         (tcomp, "mac_dual_shard"), (fft_glue, "fft_points"),
         (fft_glue, "glue_fwd_ring"), (fft_glue, "glue_fwd"),
         (partconv, "irfft_planes_valid"))


@pytest.fixture
def host_emulated(emulated, monkeypatch):
    """The capture path on the CPU for the host path's programs. The
    wrappers count launches only on the card, so here every call of the
    step's wrappers and transforms counts in ``fft_glue.launches`` under
    ``spy:<name>``, a counter the programs keep as they keep the launch
    counts (a replay adds its capture's calls)."""
    monkeypatch.setattr(program, "capturable", lambda *a: True)
    for mod, name in SPIED:
        key = f"spy:{name}"
        monkeypatch.setitem(fft_glue.launches, key, 0)

        def spy(*a, _fn=getattr(mod, name), _key=key, **k):
            fft_glue.launches[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    return emulated


def _counts() -> list:
    return [dict(c) for c in program.COUNTERS]


def _launched(before) -> dict:
    """Every launch counter's change since ``before``, by (counter, key)."""
    return {(i, k): n - before[i].get(k, 0)
            for i, c in enumerate(program.COUNTERS) for k, n in c.items()
            if n != before[i].get(k, 0)}


def _engine(text, route, mesh=None, hooks=()):
    from brutefir_tpu_torch.runtime.engine import Engine
    conf = parse_config(text)
    conf.quiet = True
    eng = Engine(conf, device=CPU, mesh=mesh)
    eng.logic.extend(hooks)
    if route == "eager":
        eng._dispatch_host = eng._dispatch_eager
    return eng


def _run(eng, between=None):
    """``run()`` to EOF; with ``between`` (block, fn): the blocks before
    ``block``, then ``fn(eng)``, then the rest."""
    if between is None:
        return eng.run()
    block, fn = between
    eng.attach_logic()
    eng.setup()
    eng.run(max_blocks=block, setup=False)
    fn(eng)
    stats = eng.run(setup=False)
    eng.teardown()
    return stats


def _check_programs(eng, xfade=None):
    """Every key called twice or more captured, at least one; the keys'
    ``xfade`` flags ``xfade`` when given."""
    progs = eng.host_step.programs()
    assert progs and all(p.graph is not None for p in progs.values()
                         if p.calls >= 2)
    assert any(p.graph is not None for p in progs.values())
    if xfade is not None:
        assert {k[2] for k in progs} == xfade
    return progs


def _graphs_and_eager(tmp_path, host_emulated, make_text, mesh=None,
                      hooks=(), between=None):
    """The programs (emulated capture) and the eager dispatch on one
    config: the outputs byte-equal, the launch counts equal. Returns the
    programs' engine (its output is ``out_port.raw``) and its counts."""
    runs = {}
    for route, name in (("graphs", "out_port.raw"),
                        ("eager", "out_eager.raw")):
        eng = _engine(make_text(name), route, mesh, hooks)
        assert eng.dio is None or hooks
        if route == "graphs":
            host_emulated.dio = _HostView(eng)
        before = _counts()
        stats = _run(eng, between)
        runs[route] = (eng, _launched(before), stats)
    (eng, counts, stats), (eager, ecounts, estats) = (runs["graphs"],
                                                      runs["eager"])
    assert stats["frames"] == estats["frames"] > 0
    a = (tmp_path / "out_port.raw").read_bytes()
    assert a and a == (tmp_path / "out_eager.raw").read_bytes()
    assert counts == ecounts and counts
    assert not eager.host_step.programs()
    return eng, counts


def _jax_run(make_text, between=None, float64=False):
    from brutefir_tpu.runtime import Engine as JaxEngine
    with x64() if float64 else contextlib.nullcontext():
        jeng = JaxEngine(jax_parse_config(make_text("out_jax.raw")))
        assert jeng.dio is None
        _run(jeng, between)
    return jeng


def _compare_f64(tmp_path, C):
    yj, yt = (np.fromfile(tmp_path / n, "<f8").reshape(-1, C)
              for n in ("out_jax.raw", "out_port.raw"))
    assert yt.shape == yj.shape and np.abs(yj).max() > 0
    assert np.abs(yt - yj).max() <= REL_FLOAT * np.abs(yj).max()


XFADE_FILTERS = ("filter 0 { from_inputs: 0; to_outputs: 0; coeff: 0; "
                 "crossfade: true; };\n"
                 "filter 1 { from_inputs: 1; to_outputs: 1; coeff: 1; "
                 "crossfade: true; };\n")
CASCADE_FILTERS = (
    'filter "a" { from_inputs: 0; to_filters: "c"; coeff: 0; };\n'
    'filter "b" { from_inputs: 1; to_filters: "d"; coeff: 1; };\n'
    'filter "c" { from_filters: "a"; to_outputs: 0; coeff: 1; };\n'
    'filter "d" { from_filters: "b"; to_outputs: 1; coeff: 0; };\n')
CLI_SCRIPT = ("sleep b1\\ncod 0 300\\ntmo 2\\ncod 1 3\\ntmi 1\\ntmo 2; "
              "sleep b999")
XFADE_SCRIPT = "cfc 0 1; cfc 1 0\\nsleep b0\\ncfc 0 0; cfc 1 1\\nsleep b999"


def _cli(script):
    return f'logic: "cli" {{ script: "{script}"; echo: false; }};'


# case: (input format, output format, channels, _config fields, the
# bound against the JAX engine, the xfade flags of the keys)
CASES = {
    "s24_be": ("S24_BE", "S24_BE", 3, {}, "words", {False}),
    "s16_be_dithered": ("S32_BE", "S16_BE", 3,
                        {"out_fields": "dither: true;"}, "dither", {False}),
    "float64_le_f64": ("FLOAT64_LE", "FLOAT64_LE", 3,
                       {"head": "float_bits: 64;"}, "f64", {False}),
    "crossfade": ("FLOAT64_LE", "FLOAT_BE", 2,
                  {"coeffs": (0, 1), "head": _cli(XFADE_SCRIPT),
                   "filters": XFADE_FILTERS}, "words", {False, True}),
    "cascade": ("S16_BE", "S32_BE", 2,
                {"coeffs": (0, 1), "filters": CASCADE_FILTERS}, "words",
                {False}),
    "cli_delay_mute": ("S24_BE", "S24_BE", 3,
                       {"head": _cli(CLI_SCRIPT),
                        "out_fields": "dither: false; delay: 0, 9, 0; "
                                      "maxdelay: 600;"}, "cli", {False}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_programs_match_eager_and_jax(tmp_path, host_emulated,
                                      fast_jax_table, case):
    """The programs (emulated capture and replay) against the eager
    dispatch, byte-equal with equal launch counts, and against the JAX
    engine within its bounds. ``crossfade`` makes the ``xfade`` key (the
    dual MAC's block); ``cli_delay_mute`` copies a new ``ctrl`` in at
    each CLI line (a delay raised and lowered, mutes on both sides)."""
    fin, fout, C, fields, bound, xfade = CASES[case]
    frames = N * 10 + 55
    level = 2.0 ** -5 if case == "s24_be" else 0.1
    _write(tmp_path / "in.raw", fin, _signal(fin, frames, C, 30, level))

    def make_text(name):
        return _config(tmp_path, name, fin, fout, C=C, **fields)

    eng, _ = _graphs_and_eager(tmp_path, host_emulated, make_text)
    progs = _check_programs(eng, xfade)
    assert sum(p.calls for p in progs.values()) == 11
    _jax_run(make_text, float64=bound == "f64")
    if bound == "f64":
        _compare_f64(tmp_path, C)
    elif bound == "dither":
        _compare(tmp_path, fout, C, share=DITHER_SHARE, tol=2)
    else:
        _compare(tmp_path, fout, C,
                 share=0.95 if bound == "cli" else EQUAL_SHARE)
    if case == "cli_delay_mute":
        assert eng.control.delay[1] == [300, 3, 0]
        y = _read(tmp_path / "out_port.raw", fout, C)
        assert not y[3 * N:6 * N, 2].any() and y[6 * N:, 2].any()


def test_bank_rebound_mid_run(tmp_path, host_emulated):
    """``update_bank_entry`` between two runs rebinds the bank: the
    programs copy the new bank into their static one once, and the
    blocks after it take it, as the eager dispatch and the JAX engine."""
    frames = N * 10 + 9
    _write(tmp_path / "in.raw", "S24_BE",
           _signal("S24_BE", frames, 3, 31, 0.1))

    def make_text(name):
        return _config(tmp_path, name, "S24_BE", "S24_BE")

    H = {}

    def swap(eng):
        if "H" not in H:
            bank = eng.bank
            H["H"] = 0.5 * np.asarray(bank[1].cpu() if isinstance(
                bank, torch.Tensor) else bank[1])
        eng.update_bank_entry(0, H["H"])

    seen = []
    real_fill = program.Slot.fill

    def fill(slot, tree):
        if not slot.owned:
            seen.append([id(t) for t in program.leaves(tree)])
        return real_fill(slot, tree)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(program.Slot, "fill", fill)
        eng, _ = _graphs_and_eager(tmp_path, host_emulated, make_text,
                                between=(4, swap))
    # the bank is the args' last leaf: one new object over the run
    assert len({ids[-1] for ids in seen}) == 2
    _check_programs(eng, {False})
    _jax_run(make_text, between=(4, swap))
    _compare(tmp_path, "S24_BE", 3)
    y = _read(tmp_path / "out_port.raw", "S24_BE", 3)
    assert np.abs(y[6 * N:, 0]).max() > 0


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_float64_host_path_on_a_cpu_mesh(tmp_path, host_emulated, shape):
    """``float_bits: 64`` with FLOAT64_LE devices on a mesh of CPU shards
    (the Sharded state, ``MeshCtrl`` and bank in the statics): the
    programs byte-equal to the eager dispatch on the same mesh, and
    within 1e-11 of the peak of the JAX float64 engine."""
    from brutefir_tpu_torch.parallel import mesh as tmesh
    C, frames = 4, N * 8 + 21
    _write(tmp_path / "in.raw", "FLOAT64_LE",
           _signal("FLOAT64_LE", frames, C, 32, 0.3))

    def make_text(name):
        return _config(tmp_path, name, "FLOAT64_LE", "FLOAT64_LE", C=C,
                       coeffs=(0, 1, 0, 1), head="float_bits: 64;")

    mesh = tmesh.make_mesh([CPU] * 2, *shape)
    eng, _ = _graphs_and_eager(tmp_path, host_emulated, make_text, mesh=mesh)
    assert eng.mesh is mesh and eng.host_step.mesh is mesh
    assert isinstance(eng.state.ring, tmesh.Sharded)
    _check_programs(eng)
    _jax_run(make_text, float64=True)
    _compare_f64(tmp_path, C)


class _Tap:
    """A post_convolve hook that scales every filter's spectrum."""

    def post_convolve(self, buf, f):
        buf *= 0.5 + 0.25 * f


class _Timed:
    """input_timed / output_timed hooks scaling each channel's block."""

    def input_timed(self, buf, c):
        buf *= 1.0 + 0.125 * c

    def output_timed(self, buf, c):
        buf *= 0.75


def test_tapped_engine_makes_the_segmented_program(tmp_path, monkeypatch):
    """A frequency-domain hook makes a tap of the step: ``attach_logic``
    replaces the HostStep by a TapStep, whose program for the key has
    S + 1 segments for the S tap sites (here one, the single stage's
    ``post_convolve``); the engine never dispatches eagerly."""
    from brutefir_tpu_torch.runtime.engine import Engine
    _write(tmp_path / "in.raw", "S24_BE",
           _signal("S24_BE", N * 4 + 3, 3, 33, 0.1))
    eng = _engine(_config(tmp_path, "o.raw", "S24_BE", "S24_BE"),
                  "graphs", hooks=[_Tap()])
    assert type(eng.host_step) is program.HostStep   # before attach_logic
    calls = []
    real = Engine._dispatch_eager
    monkeypatch.setattr(Engine, "_dispatch_eager",
                        lambda self, *a: calls.append(1) or real(self, *a))
    eng.run()
    hs = eng.host_step
    assert eng.taps and isinstance(hs, program.TapStep) and not calls
    assert [s.kind for s in hs.sites] == ["post_convolve"]
    progs = hs.programs()
    assert [(p.calls, p.segments) for p in progs.values()] == [(5, 2)]


def test_timed_hook_engine_makes_programs(tmp_path, host_emulated):
    """Timed hooks alone put a device-codec config on the host path
    (``attach_logic``); they run in ``read_block`` / ``write_block``,
    outside the step, so the step runs through the programs, byte-equal
    to the eager dispatch with the same hooks."""
    _write(tmp_path / "in.raw", "S24_4LE",
           _signal("S24_4LE", N * 7 + 40, 3, 34, 0.1))

    def make_text(name):
        return _config(tmp_path, name, "S24_4LE", "S24_4LE")

    eng, _ = _graphs_and_eager(tmp_path, host_emulated, make_text,
                            hooks=[_Timed()])
    assert eng.dio is None and not eng.taps
    _check_programs(eng, {False})


def test_launch_counts_are_the_eager_runs(tmp_path, host_emulated):
    """Replays add their capture's launches: the counts of a run through
    the programs are the eager run's, one forward transform, one forward
    glue into the ring, one fused MAC + mix and one inverse a block."""
    _write(tmp_path / "in.raw", "S24_BE",
           _signal("S24_BE", N * 6, 3, 35, 0.1))
    eng, counts = _graphs_and_eager(
        tmp_path, host_emulated,
        lambda name: _config(tmp_path, name, "S24_BE", "S24_BE"))
    progs = _check_programs(eng)
    assert [p.calls for p in progs.values()] == [6]
    assert {k: n for (_, k), n in counts.items()} == {
        f"spy:{k}": 6 for k in ("fft_points", "glue_fwd_ring", "mac_mix",
                                "irfft_planes_valid")}
    assert sorted(k for _, k, _ in next(iter(progs.values())).delta) == \
        sorted(f"spy:{k}" for k in ("fft_points", "glue_fwd_ring",
                                    "mac_mix", "irfft_planes_valid"))


def test_warm_up_leaves_no_trace(tmp_path, host_emulated, fast_jax_table):
    """``_warm_programs`` on the host path (forced on, as for a clocked
    device) calls each key twice, capturing it, on a clone of the state,
    which it hands back: the run after it is byte-equal to a run without
    it, dithered outputs and delay lines included."""
    frames = N * 7 + 13
    _write(tmp_path / "in.raw", "S32_BE",
           _signal("S32_BE", frames, 3, 36, 0.1))

    def make_text(name):
        return _config(tmp_path, name, "S32_BE", "S16_BE",
                       out_fields="dither: true; delay: 0, 17, 3;",
                       filters="".join(
                           f"filter {f} {{ from_inputs: {f}; to_outputs: "
                           f"{f}; coeff: 0; crossfade: true; }};\n"
                           for f in range(3)))

    out = {}
    for warm in (True, False):
        eng = _engine(make_text(f"o{warm}.raw"), "graphs")
        host_emulated.dio = _HostView(eng)
        if warm:
            state = program.tree_map(torch.clone, eng.state)
            eng._clocked = lambda: True
            eng._warm_programs()
            del eng._clocked
            progs = eng.host_step.programs()
            assert set(progs) == {(u, True, x) for u in (False, True)
                                  for x in (False, True)}
            assert all(p.calls == 2 and p.graph is not None
                       for p in progs.values())
            for a, b in zip(program.leaves(eng.state),
                            program.leaves(state)):
                assert torch.equal(a, b)
        eng.run()
        out[warm] = (tmp_path / f"o{warm}.raw").read_bytes()
    assert out[True] and out[True] == out[False]


def test_state_handed_in_is_copied_in(tmp_path, host_emulated,
                                      fast_jax_table):
    """A JAX engine's step state (``convert.state_from_jax``) and host IO
    state (``host_io_state_from_jax``) handed to an engine whose programs
    exist already (captured by the warm-up) are copied into the static
    state: the rest of the run is byte-equal to the eager dispatch given
    the same, within the dithered bound of the JAX engine running on."""
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.convert import (host_io_state_from_jax,
                                            state_from_jax)
    k, frames = 4, N * 9 + N // 2
    x = _signal("S32_BE", frames, 3, 37, level=0.1)
    _write(tmp_path / "in.raw", "S32_BE", x)
    _write(tmp_path / "rest.raw", "S32_BE", x[k * N:])
    fields = dict(in_fields="delay: 5, 0, 40; maxdelay: 300;",
                  out_fields="dither: true; delay: 200, 0, 7;")
    jeng = JaxEngine(jax_parse_config(_config(
        tmp_path, "out_jax.raw", "S32_BE", "S16_BE", **fields)))
    jeng.setup()
    jeng.run(max_blocks=k, setup=False)
    outs = {}
    for route in ("graphs", "eager"):
        text = _config(tmp_path, f"o_{route}.raw", "S32_BE", "S16_BE",
                       **fields).replace(str(tmp_path / "in.raw"),
                                         str(tmp_path / "rest.raw"))
        eng = _engine(text, route)
        if route == "graphs":
            host_emulated.dio = _HostView(eng)
            eng._clocked = lambda: True
            eng._warm_programs()
            del eng._clocked
            assert eng.host_step.programs()
        js = jeng.state
        eng.state = state_from_jax(np.asarray(js.prev_in),
                                   np.asarray(js.ring),
                                   np.asarray(js.eval_prev), js.t, CPU)
        handed = eng.state
        host_io_state_from_jax(jeng, eng)
        eng.run()
        outs[route] = _read(tmp_path / f"o_{route}.raw", "S16_BE", 3)
        if route == "graphs":
            static = eng.host_step._statics.state.tree
            assert eng.state is static
            assert all(a is not b for a, b in zip(
                program.leaves(static), program.leaves(handed)))
    jeng.run(setup=False)
    jeng.teardown()
    assert np.array_equal(outs["graphs"], outs["eager"])
    yj = _read(tmp_path / "out_jax.raw", "S16_BE", 3)[k * N:]
    d = np.abs(outs["graphs"] - yj)
    assert yj.shape == outs["graphs"].shape
    assert d.max() <= 2 and np.mean(d == 0) > DITHER_SHARE


def test_cpu_programs_run_eagerly_at_fixed_addresses(tmp_path):
    """Without the emulation the CPU does not capture: every key's
    program runs its body at every call through the statics, the input
    block lands in ``HostStep.x`` at one address, and the engine's state
    is the static state."""
    _write(tmp_path / "in.raw", "S24_BE",
           _signal("S24_BE", N * 5, 3, 38, 0.1))
    eng = _engine(_config(tmp_path, "o.raw", "S24_BE", "S24_BE"), "graphs")
    hs = eng.host_step
    ptr = hs.x.data_ptr()
    eng.run()
    assert not hs.captures and eng.host_step is hs
    progs = hs.programs()
    assert [(p.calls, p.graph) for p in progs.values()] == [(5, None)]
    assert hs.x.data_ptr() == ptr
    assert eng.state is hs._statics.state.tree


def test_failed_capture_raises(tmp_path, host_emulated, monkeypatch):
    """No fallback: a capture that fails raises out of the run."""

    @contextlib.contextmanager
    def broken(graph, **kwargs):
        raise RuntimeError("capture failed")
        yield

    monkeypatch.setattr(torch.cuda, "graph", broken)
    _write(tmp_path / "in.raw", "S24_BE",
           _signal("S24_BE", N * 4, 3, 39, 0.1))
    eng = _engine(_config(tmp_path, "o.raw", "S24_BE", "S24_BE"), "graphs")
    host_emulated.dio = _HostView(eng)
    with pytest.raises(RuntimeError, match="capture failed"):
        eng.run()
