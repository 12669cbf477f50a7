"""The tapped host step's programs (``runtime/program.TapStep``,
``Segmented``) on the CPU: an engine with frequency-domain taps steps
through one program a key ``(uniform, udelay, xfade)``, cut at its S tap
sites into S + 1 segments, the hooks run on the host between them.

Each case runs one config file to file through three engines: the port
through the segmented programs under an emulated capture and replay
(``_SegGraph``: a key's second call captures, the later ones replay),
the port through the eager dispatch (``Engine._dispatch_eager``,
``step_impl`` op by op, where ``chip_smoke.eager_forms`` routes it),
byte-equal with equal launch counts (the ``spy:`` counts of
tests/test_torch_host_program.py) and an equal hook call list (kind, id,
the bytes of the row each hook is handed); and the JAX engine, within
tests/test_torch_hooks.py's bounds (float outputs within 1e-6 of the
peak, S24 words within 1 LSB). The CPU itself does not capture: there
the programs run every segment eagerly at every call through the same
static buffers.

The emulated replay of segment k does that segment's device work and no
other: the first replay of a block starts the program's ``segments``
(the code the capture ran) in a thread of its own, which stops at each
tap site, and the replay of segment k + 1 lets it run on to the next.
So a segment's ops run once a block, on the static tensors, in order,
as a captured graph's do (the cascade tails ``eval_prev`` are updated in
place: an op run twice would show), and nothing but the ops runs: the
launch counters are put back after each replay. An emulated capture
runs the Python (its launches count) and puts the static tensors back.
"""

import contextlib
import queue
import threading

import numpy as np
import pytest
import torch

from brutefir_tpu.config import parse_config as jax_parse_config
from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.ops import fft_glue
from brutefir_tpu_torch.runtime import program
from brutefir_tpu_torch.runtime.engine import Engine
from test_torch_float64 import x64
from test_torch_hooks import (FREQD, KINDS, N, Hooks, _coeffs,
                              _input, cascade_config, compare_outputs,
                              single_config)
from test_torch_host_program import SPIED, _counts, _launched

CPU = torch.device("cpu")
PAUSE_S = 60          # the longest a replay waits for its segment


class _Abort(Exception):
    """Ends a segment thread whose block was abandoned (a hook raised)."""


class _Block:
    """One block of a program's segments run in a thread that stops at
    each tap site: ``step()`` runs the next segment and returns
    ("site", site), ("done", y) or ("error", exception)."""

    def __init__(self, prog):
        self.to_main = queue.Queue()
        self.to_seg = queue.Queue()
        self.thread = threading.Thread(target=self._run, args=(prog,),
                                       daemon=True)

    def _run(self, prog):
        try:
            y = prog.owner.segments(prog.key, self._pause)
        except _Abort:
            return
        except BaseException as e:      # handed to the replaying thread
            self.to_main.put(("error", e))
            return
        self.to_main.put(("done", y))

    def _pause(self, site):
        self.to_main.put(("site", site))
        if self.to_seg.get(timeout=PAUSE_S) is _Abort:
            raise _Abort

    def step(self):
        if self.thread.ident is None:
            self.thread.start()
        else:
            self.to_seg.put(None)
        return self.to_main.get(timeout=PAUSE_S)

    def abort(self):
        if self.thread.is_alive():
            self.to_seg.put(_Abort)
            self.thread.join(PAUSE_S)
            assert not self.thread.is_alive()


class _SegGraph:
    """``torch.cuda.CUDAGraph`` on the CPU for the segmented programs
    (see the module docstring). ``steps``: every TapStep the test made;
    ``blocks``: each program's block in flight."""
    steps = []
    blocks = {}

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.saved = [(b, b.clone()) for b in _static_tensors()]

    def capture_end(self):
        for b, v in self.saved:
            b.copy_(v)

    def replay(self):
        prog, k = _owner(self)
        if k == 0:
            old = _SegGraph.blocks.pop(id(prog), None)
            if old is not None:
                old.abort()
            _SegGraph.blocks[id(prog)] = _Block(prog)
        held = [dict(c) for c in program.COUNTERS]
        msg = _SegGraph.blocks[id(prog)].step()
        for c, h in zip(program.COUNTERS, held):
            c.clear()
            c.update(h)
        if msg[0] == "error":
            raise msg[1]
        sites = prog.owner.sites
        if k < len(sites):
            assert msg == ("site", sites[k]), (k, msg)
            return
        assert msg[0] == "done"
        del _SegGraph.blocks[id(prog)]
        for o, n in zip(program.leaves(prog.out), program.leaves(msg[1])):
            o.copy_(n)


def _static_tensors() -> list:
    """The tensors a capture's device work would write: every TapStep's
    static state and its sites' buffers."""
    out = []
    for hs in _SegGraph.steps:
        if hs._statics is not None:
            out += hs._statics.state.bufs
        out += [t for s in hs.sites for t in (s.buf, s.inp)]
    return out


def _owner(graph):
    """The program whose segments hold ``graph``, and its index."""
    for hs in _SegGraph.steps:
        for p in hs.programs().values():
            if p.graph is not None and graph in p.graph:
                return p, p.graph.index(graph)
    raise AssertionError("replay of a graph no program captured")


@pytest.fixture
def tap_emulated(monkeypatch):
    """The capture path on the CPU for the tapped programs
    (``_SegGraph``), and the step's wrappers counted under ``spy:<name>``
    (tests/test_torch_host_program.py's ``host_emulated``)."""
    made = []
    real_init = program.TapStep.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        made.append(self)

    monkeypatch.setattr(program.TapStep, "__init__", init)
    monkeypatch.setattr(_SegGraph, "steps", made)
    monkeypatch.setattr(_SegGraph, "blocks", {})
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _SegGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: object())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    monkeypatch.setattr(program, "capturable", lambda *a: True)
    for mod, name in SPIED:
        key = f"spy:{name}"
        monkeypatch.setitem(fft_glue.launches, key, 0)

        def spy(*a, _fn=getattr(mod, name), _key=key, **k):
            fft_glue.launches[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    yield _SegGraph
    for b in list(_SegGraph.blocks.values()):
        b.abort()


class _Recording(Hooks):
    """:class:`Hooks` that also record (kind, id, the row's bytes as the
    hook is handed it) in ``rows``."""

    def __init__(self, *a, **k):
        self.rows = []
        super().__init__(*a, **k)

    def _hook(self, kind):
        inner = super()._hook(kind)

        def hook(buf, i):
            self.rows.append((kind, i, buf.dtype.name, buf.tobytes()))
            inner(buf, i)
        return hook


class _Raising:
    """A post_convolve hook that raises at its ``at``-th call."""

    def __init__(self, at):
        self.at = at
        self.n = 0

    def post_convolve(self, buf, f):
        self.n += 1
        if self.n == self.at:
            raise RuntimeError("hook failed")


def _port(text, route, hooks):
    conf = parse_config(text)
    conf.quiet = True
    eng = Engine(conf, device=CPU)
    eng.logic.append(hooks)
    if route == "eager":
        eng._dispatch_host = eng._dispatch_eager
    return eng


def _per_block(eng, blocks):
    """``blocks`` one-block runs, so that every hook of a block has run
    before the next block starts (the JAX engine's taps run on a thread
    of its runtime)."""
    eng.attach_logic()
    eng.setup()
    try:
        for b in range(blocks):
            eng.run(max_blocks=b + 1, setup=False)
    finally:
        eng.teardown()


def _check_segments(eng, xfade=None):
    """Every key called twice or more captured into S + 1 graphs for the
    S tap sites, in the order ``input_freqd``, each stage's
    ``pre_convolve`` and ``post_convolve``, ``output_freqd`` (the kinds
    hooked); the keys' ``xfade`` flags ``xfade`` when given. Returns the
    programs."""
    hs = eng.host_step
    assert isinstance(hs, program.TapStep) and hs.taps is eng.taps
    kinds = [s.kind for s in hs.sites]
    stages = len(eng.spec.stages)
    want = ((["input_freqd"] if "input_freqd" in eng.taps else [])
            + [k for _ in range(stages) for k in ("pre_convolve",
                                                  "post_convolve")
               if k in eng.taps]
            + (["output_freqd"] if "output_freqd" in eng.taps else []))
    assert kinds == want and kinds
    progs = hs.programs()
    assert progs and all(isinstance(p, program.Segmented)
                         for p in progs.values())
    assert all(p.graph is not None and len(p.graph) == len(kinds) + 1
               and len(p.delta) == len(kinds) + 1
               for p in progs.values() if p.calls >= 2)
    assert any(p.graph is not None and p.calls >= 3 for p in progs.values())
    assert all(p.segments == len(kinds) + 1 for p in progs.values())
    if xfade is not None:
        assert {k[2] for k in progs} == xfade
    return progs


def _in_order(calls) -> tuple:
    """A hook call list as two lists in call order: the main thread's
    and ``output_timed``'s (the writer thread's, which interleaves with
    the next blocks')."""
    return ([c for c in calls if "output_timed" not in c[:2]],
            [c for c in calls if "output_timed" in c[:2]])


def _three(tmp_path, make_text, make_hooks, per_block=0, float64=False,
           env=None):
    """The segmented programs (emulated capture), the eager dispatch and
    the JAX engine on ``make_text(tag)`` (outputs ``<tag>_f.raw`` and
    ``<tag>_i.raw``), each with its own ``make_hooks()``: the two port
    routes' output bytes, launch counts and hook call lists equal.
    Returns ((engine, hooks) of the programs, of the JAX engine)."""
    from brutefir_tpu.runtime import Engine as JaxEngine
    runs = {}
    for route in ("port", "eager"):
        hooks = make_hooks()
        eng = _port(make_text(route), route, hooks)
        before = _counts()
        if per_block:
            _per_block(eng, per_block)
        else:
            eng.run()
        runs[route] = (eng, hooks, _launched(before))
    (eng, hooks, counts), (eager, ehooks, ecounts) = (runs["port"],
                                                      runs["eager"])
    for suffix in ("_f.raw", "_i.raw"):
        a, b = (tmp_path / f"port{suffix}", tmp_path / f"eager{suffix}")
        if a.exists():
            assert a.read_bytes() and a.read_bytes() == b.read_bytes()
    assert counts == ecounts and counts
    assert _in_order(hooks.rows) == _in_order(ehooks.rows) and hooks.rows
    assert (_in_order([c[1:] for c in hooks.calls])
            == _in_order([c[1:] for c in ehooks.calls]))
    assert not eager.host_step.programs()
    jhooks = make_hooks()
    with x64() if float64 else contextlib.nullcontext():
        jeng = JaxEngine(jax_parse_config(make_text("jax")))
        jeng.logic.append(jhooks)
        if per_block:
            _per_block(jeng, per_block)
        else:
            jeng.run()
    assert hooks.by_kind() == jhooks.by_kind()
    return (eng, hooks), (jeng, jhooks)


@pytest.fixture
def writable_jax_output_timed(monkeypatch):
    """The JAX engine's write_block with a writable copy of y, as in
    tests/test_torch_hooks.py."""
    from brutefir_tpu.runtime.engine import Engine as JaxEngine
    real = JaxEngine.write_block
    monkeypatch.setattr(JaxEngine, "write_block",
                        lambda self, y, *a, **k: real(self, np.array(y),
                                                      *a, **k))


@pytest.mark.parametrize("kind", FREQD)
def test_each_kind_alone(tmp_path, tap_emulated, kind):
    """One frequency-domain kind scaling each row by its id's gain: two
    segments (one tap site a block, the single stage's), the programs
    byte-equal to the eager dispatch and within the bounds of the JAX
    engine."""
    frames = N * 6 + 37
    _input(tmp_path, frames, 3)
    (eng, hooks), _ = _three(
        tmp_path, lambda t: single_config(tmp_path, t),
        lambda: _Recording((kind,), "scale"))
    progs = _check_segments(eng, {False})
    assert [p.segments for p in progs.values()] == [2]
    assert hooks.by_kind()[kind] == [0, 1, 2] * 7
    assert {r[2] for r in hooks.rows} == {"complex64"}
    compare_outputs(tmp_path, frames, 2, with_int=True)


def test_all_six_hooks(tmp_path, tap_emulated, writable_jax_output_timed):
    """Every kind scaling at once (the timed hooks outside the step): four
    tap sites, five segments; the gains multiply along each path as in
    the JAX engine."""
    frames = N * 5 + 3
    _input(tmp_path, frames, 3, level=0.02)
    (eng, hooks), _ = _three(
        tmp_path, lambda t: single_config(tmp_path, t),
        lambda: _Recording(KINDS, "scale"))
    progs = _check_segments(eng, {False})
    assert [p.segments for p in progs.values()] == [5]
    assert len(hooks.by_kind()) == 6 and sorted(eng.taps) == sorted(FREQD)
    compare_outputs(tmp_path, frames, 2, with_int=True)


def test_pre_convolve_mutation_persists_in_ring(tmp_path, tap_emulated):
    """Only block 0 carries signal; pre_convolve zeroes filter 1's
    spectra: segment 1 writes the tapped planes into the ring, so filter
    1's output stays 0 in every block (its echoes in the later
    partitions included) while filter 0's echoes go on."""
    frames = N * 7
    x = np.zeros((frames, 3), "<f4")
    x[:N] = np.random.default_rng(5).standard_normal((N, 3)) * 0.3
    x.tofile(tmp_path / "in.raw")
    (eng, _), _ = _three(
        tmp_path, lambda t: single_config(tmp_path, t),
        lambda: _Recording(("pre_convolve",), "zero_all", {1}))
    _check_segments(eng, {False})
    y = np.fromfile(tmp_path / "port_f.raw", "<f4").reshape(frames, 2)
    assert not y[:, 1].any() and np.abs(y[N * 4:, 0]).max() > 0
    compare_outputs(tmp_path, frames, 2, with_int=True)


def test_cascade_post_convolve(tmp_path, tap_emulated):
    """A two-stage cascade (stage 0 filters [1, 2], stage 1 [0]) with
    post_convolve on filter 2: two tap sites, three segments; the cascade
    tails, updated in place in segment 1, once a block; the ids run 1,
    2, 0 a block, and filter 0 mixes filter 2's tapped spectra."""
    frames = N * 6 + 9
    _input(tmp_path, frames, 2)
    (eng, hooks), _ = _three(
        tmp_path, lambda t: cascade_config(tmp_path, t),
        lambda: _Recording(("post_convolve",), "zero_all", {2}))
    progs = _check_segments(eng, {False})
    assert [p.segments for p in progs.values()] == [3]
    assert hooks.by_kind()["post_convolve"] == [1, 2, 0] * 7
    y = np.fromfile(tmp_path / "port_f.raw", "<f4").reshape(frames, 2)
    assert not y[:, 1].any() and np.abs(y[:, 0]).max() > 0
    compare_outputs(tmp_path, frames, 2)


XFADE_SCRIPT = ("cfc 0 1; cfc 1 1\\nsleep b2\\ncfc 0 0; cfc 1 0\\n"
                "sleep b2")


def _xfade_text(tmp_path, tag):
    """Two crossfading filters whose sets a CLI script flips every third
    block, FLOAT_LE outputs."""
    return (f"sampling_rate: 44100;\nfilter_length: {N},4;\n"
            f'logic: "cli" {{ script: "{XFADE_SCRIPT}"; echo: false; }};\n'
            + _coeffs(tmp_path, 2)
            + f'input 0,1 {{ device: "file" {{ path: '
              f'"{tmp_path / "in.raw"}"; }}; sample: "FLOAT_LE"; '
              f'channels: 2; }};\n'
            + f'output 0,1 {{ device: "file" {{ path: '
              f'"{tmp_path / f"{tag}_f.raw"}"; }}; sample: "FLOAT_LE"; '
              f'channels: 2; }};\n'
            + "".join(f"filter {f} {{ from_inputs: {f}; to_outputs: {f}; "
                      f"coeff: 0; crossfade: true; }};\n" for f in range(2)))


def test_crossfade_interleaved_with_plain_blocks(tmp_path, tap_emulated,
                                                 monkeypatch):
    """Crossfade blocks between plain ones under a post_convolve gain:
    the ``xfade`` key's program (the dual MAC and ``crossfade_spectra``
    before the tap) and the plain key's replayed in turns, each on its
    own pool, both byte-equal to the eager dispatch; never the fused
    time-domain crossfade."""
    from brutefir_tpu_torch.graph import compile as tcomp

    def refuse(*a, **k):
        raise AssertionError("fused time-domain crossfade under taps")

    monkeypatch.setattr(tcomp, "_fused_xfade", refuse)
    frames = N * 14 + 77
    _input(tmp_path, frames, 2)
    (eng, _), _ = _three(tmp_path, lambda t: _xfade_text(tmp_path, t),
                         lambda: _Recording(("post_convolve",), "scale"))
    progs = _check_segments(eng, {False, True})
    order = [k[2] for k in progs]
    assert all(p.calls >= 3 for p in progs.values()), order
    assert sum(p.calls for p in progs.values()) == 15
    compare_outputs(tmp_path, frames, 2)


def _placed_text(tmp_path, tag):
    """3 filters on processes {0, 0, 1}: on an automatic 'f' axis of two
    groups, padded to 2 + 2 spec rows."""
    return (f"sampling_rate: 44100;\nfilter_length: {N},4;\n"
            + _coeffs(tmp_path, 2)
            + f'input 0,1,2 {{ device: "file" {{ path: '
              f'"{tmp_path / "in.raw"}"; }}; sample: "FLOAT_LE"; '
              f'channels: 3; }};\n'
            + f'output 0,1 {{ device: "file" {{ path: '
              f'"{tmp_path / f"{tag}_f.raw"}"; }}; sample: "FLOAT_LE"; '
              f'channels: 2; }};\n'
            + f'output 2 {{ device: "file" {{ path: '
              f'"{tmp_path / f"{tag}_i.raw"}"; }}; sample: "S24_4LE"; '
              f'channels: 1; dither: false; }};\n'
            + "".join(f"filter {f} {{ from_inputs: {f}; to_outputs: {f}; "
                      f"coeff: {c}; process: {p}; }};\n"
                      for f, c, p in ((0, 0, 0), (1, 1, 0), (2, 0, 1))))


def test_process_placement_row2conf(tmp_path, tap_emulated, monkeypatch):
    """``process:`` pins on an automatic mesh that the taps drop: the
    spec keeps its padded rows, the hooks see config filter ids
    (``row2conf``, the padding row skipped), as in the JAX engine."""
    from brutefir_tpu_torch.parallel import mesh as tmesh
    monkeypatch.setattr(tmesh, "default_devices", lambda *a: [CPU] * 8)
    monkeypatch.setenv("BRUTEFIR_TPU_MESH", "auto")
    frames = N * 5 + 11
    _input(tmp_path, frames, 3)
    (eng, hooks), _ = _three(
        tmp_path, lambda t: _placed_text(tmp_path, t),
        lambda: _Recording(("pre_convolve", "post_convolve"), "scale"))
    assert eng.mesh is None and -1 in eng.spec_rows
    _check_segments(eng, {False})
    assert sorted(set(hooks.by_kind()["post_convolve"])) == [0, 1, 2]
    assert len(hooks.by_kind()["post_convolve"]) == 3 * 6
    compare_outputs(tmp_path, frames, 2, with_int=True)


def test_float64_complex128_rows(tmp_path, tap_emulated):
    """``float_bits: 64``: the taps' planes are float64, the hooks get
    complex128 rows; the float64 stage loop through the segments,
    byte-equal to the eager dispatch, within the bounds of the JAX
    float64 engine."""
    frames = N * 5 + 21
    _input(tmp_path, frames, 3)
    (eng, hooks), _ = _three(
        tmp_path, lambda t: single_config(tmp_path, t, "float_bits: 64;"),
        lambda: _Recording(("input_freqd", "output_freqd"), "scale"),
        float64=True)
    _check_segments(eng, {False})
    assert {r[2] for r in hooks.rows} == {"complex128"}
    assert all(s.buf.dtype == torch.float64 for s in eng.host_step.sites)
    compare_outputs(tmp_path, frames, 2, with_int=True)


def test_hook_call_list_per_block(tmp_path, tap_emulated,
                                  writable_jax_output_timed):
    """All six hooks recording on the cascade, one block a run: the call
    list (kind, id, row bytes) of the programs is the eager dispatch's,
    and (kind, id, shape, dtype, writable, contiguous) the JAX engine's,
    block_start included."""
    frames = N * 4
    _input(tmp_path, frames, 2)
    (eng, hooks), (_, jhooks) = _three(
        tmp_path, lambda t: cascade_config(tmp_path, t),
        lambda: _Recording(KINDS), per_block=4)
    _check_segments(eng, {False})
    assert [c[1:] for c in hooks.calls] == [c[1:] for c in jhooks.calls]
    kinds = [c[1] for c in hooks.calls]
    assert kinds.count("block_start") == 4
    assert kinds.count("post_convolve") == 4 * eng.spec.n_filters
    compare_outputs(tmp_path, frames, 2)


def test_warm_up_on_a_paced_device(tmp_path, tap_emulated):
    """A clocked engine on the paced device (``chip_smoke.PACED_MODULE``)
    warms and captures each key on a clone of the state with the hooks
    silenced: no hook sees the warm-up, every captured key has its
    segments, and the output after the 2N silent frames is byte-equal
    to the eager dispatch's (which warms eagerly) and to a file run's."""
    from test_torch_clocked import PACED
    mods = tmp_path / "mods"
    mods.mkdir()
    (mods / "bfio_paced.py").write_text(PACED)
    frames = N * 6 + 19
    _input(tmp_path, frames, 3)

    def make_text(tag):
        text = single_config(tmp_path, tag, f'modules_path: "{mods}";')
        if tag == "file":
            return text
        return text.replace('device: "file"', 'device: "paced"')

    outs, calls = {}, {}
    for route in ("port", "eager", "file"):
        hooks = _Recording(("pre_convolve", "output_freqd"), "scale")
        eng = _port(make_text(route), "eager" if route == "eager"
                    else "port", hooks)
        assert eng._clocked() == (route != "file")
        eng.run()
        outs[route] = np.fromfile(tmp_path / f"{route}_f.raw", "<f4")
        calls[route] = hooks.rows
        if route == "port":
            progs = _check_segments(eng, {False})
            assert set(progs) == {(u, True, False) for u in (False, True)}
    lead = 2 * N * 2
    assert np.array_equal(outs["port"], outs["eager"])
    assert not outs["port"][:lead].any()
    assert np.array_equal(outs["port"][lead:], outs["file"])
    assert calls["port"] == calls["eager"] == calls["file"]
    assert len(calls["port"]) == 2 * 3 * 7


def test_failed_capture_raises(tmp_path, tap_emulated, monkeypatch):
    """No fallback: a segment's capture that fails raises out of the run,
    and the open capture is ended."""
    ended = []

    def broken(self, pool=None, capture_error_mode="global"):
        if len(ended) == 1:
            raise RuntimeError("capture failed")
        self.saved = []

    def end(self):
        ended.append(self)

    monkeypatch.setattr(_SegGraph, "capture_begin", broken)
    monkeypatch.setattr(_SegGraph, "capture_end", end)
    _input(tmp_path, N * 4, 3)
    eng = _port(single_config(tmp_path, "port"), "port",
                _Recording(("post_convolve",), "scale"))
    with pytest.raises(RuntimeError, match="capture failed"):
        eng.run()
    assert len(ended) == 2


def test_raising_hook_propagates(tmp_path, tap_emulated):
    """A hook that raises on a replayed block (the fifth: its second row)
    propagates out of run(), as it does from the eager dispatch; nothing
    falls back."""
    _input(tmp_path, N * 6, 3)
    eng = _port(single_config(tmp_path, "port"), "port", _Raising(3 * 4 + 2))
    with pytest.raises(RuntimeError, match="hook failed"):
        eng.run()
    progs = eng.host_step.programs()
    assert [p.calls for p in progs.values()] == [4]
    assert all(p.graph is not None for p in progs.values())


def test_cpu_runs_segments_eagerly_at_fixed_addresses(tmp_path):
    """Without the emulation the CPU does not capture: each key's program
    runs every segment at every call through the static tensors, the
    sites' buffers and the input block at one address, the engine's
    state the static state; byte-equal to the eager dispatch."""
    frames = N * 5
    _input(tmp_path, frames, 3)
    out, ptrs = {}, {}
    for route in ("port", "eager"):
        eng = _port(single_config(tmp_path, route), route,
                    _Recording(("input_freqd", "post_convolve"), "scale"))
        eng.attach_logic()
        hs = eng.host_step
        if route == "port":
            ptrs["x"] = hs.x.data_ptr()
            seen = []
            real = hs.tap

            def tap(site, _real=real):
                seen.append((site.buf.data_ptr(), site.inp.data_ptr()))
                return _real(site)

            hs.tap = tap
        eng.setup()
        eng.run(setup=False)
        eng.teardown()
        out[route] = (tmp_path / f"{route}_f.raw").read_bytes()
        if route == "port":
            assert not hs.captures and eng.host_step is hs
            progs = hs.programs()
            assert [(p.calls, p.graph) for p in progs.values()] == [(5, None)]
            assert hs.x.data_ptr() == ptrs["x"]
            assert eng.state is hs._statics.state.tree
            assert len(seen) == 2 * 5 and len(set(seen)) == 2
    assert out["port"] and out["port"] == out["eager"]
