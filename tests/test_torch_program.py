"""DeviceIO's step programs (``brutefir_tpu_torch/runtime/program.py``)
on the CPU: ``DeviceIO.step`` / ``multi_step`` run their eager forms
through the programs' plumbing (static state, ``dstate``, controls,
gains and bank; words copied in; outputs handed out), as on the card
between captures.

Each case drives three engines built from one config with the same
words (numpy seed) and the same control changes: the port through the
programs, the port through the eager forms (``step_eager`` /
``multi_step_eager``), byte-equal; and the JAX package's
``DeviceIO.multi_step`` / ``step`` (its Pallas kernels interpreted,
``BRUTEFIR_TPU_MAC=pallas``), S24 words within 1 LSB, the bound
tests/test_torch_engine.py holds the two packages to. Changes between
calls: a coefficient change and a mute (new control snapshot and
gains), an input delay change (``update_delays`` in place) and a bank
entry swap (``update_bank_entry``).

The capture path itself runs on the card (tests/test_torch_cuda.py); here
an emulated graph (``_Emulated``: a capture runs the body's Python and
undoes its device work, a replay the reverse) exercises its counters (a
replay adds one capture's launches), its outputs (each call's clones
survive the next replay) and DeviceIO's plumbing around it, byte-equal
to the eager forms.
"""

import contextlib

import numpy as np
import pytest
import torch

from brutefir_tpu.config import parse_config as jax_parse_config
from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.config.model import IN, OUT
from brutefir_tpu_torch.ops import fft_glue, mac
from brutefir_tpu_torch.ops.partconv import static_index
from brutefir_tpu_torch.runtime import program
from brutefir_tpu_torch.runtime.program import Program, leaves

CPU = torch.device("cpu")
N, B, C = 256, 4, 3


def _coeffs(tmp_path, n: int):
    """``n`` TEXT coefficients of unit gain or so (the level of
    tests/test_torch_cascade.py's taps, whose cascade the 1 LSB bound
    holds)."""
    rng = np.random.default_rng(5)
    for k in range(n):
        (tmp_path / f"c{k}.txt").write_text("\n".join(
            repr(float(v)) for v in rng.standard_normal(N * B - 50 * k)
            * 0.03) + "\n")
    return "".join(f'coeff {k} {{ filename: "{tmp_path / f"c{k}.txt"}"; '
                   f'format: "TEXT"; }};\n' for k in range(n))


def _config(tmp_path, topology: str) -> str:
    """S24_4LE in and out, input delays (changeable up to maxdelay) and
    output delays. ``shared``: C filters of one coefficient (uniform
    controls, one pre-delay); ``per``: two coefficients and per-filter
    pre-delays; ``cascade``: two stages; ``xfade``: ``shared`` with
    crossfading filters."""
    chans = ",".join(str(c) for c in range(C))
    if topology == "cascade":
        filters = (
            "filter 0 { from_inputs: 0; to_filters: 2; coeff: 0; };\n"
            "filter 1 { from_inputs: 1, 2; to_filters: 2; coeff: 1; };\n"
            "filter 2 { from_filters: 0, 1; to_outputs: 0, 1, 2; "
            "coeff: 0; };\n")
    else:
        filters = "".join(
            f"filter {f} {{ from_inputs: {f}; to_outputs: {f}; "
            f"coeff: {f % 2 if topology == 'per' else 0}; "
            f"{'delay: ' + str(f) + '; ' if topology == 'per' else ''}"
            f"{'crossfade: true; ' if topology == 'xfade' else ''}}};\n"
            for f in range(C))
    return f"""
sampling_rate: 44100;
filter_length: {N},{B};
{_coeffs(tmp_path, 2)}
input {chans} {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: {C}; delay: 3, 0, 7; maxdelay: 20; }};
output {chans} {{ device: "file" {{ path: "{tmp_path / 'out.raw'}"; }}; sample: "S24_4LE"; channels: {C}; dither: false; delay: 0, 5, 2; }};
{filters}"""


class _Port:
    """The port's engine, stepped through the programs or the eager
    forms."""

    def __init__(self, text, eager: bool):
        from brutefir_tpu_torch.runtime.engine import Engine
        self.eng = Engine(parse_config(text), device=CPU)
        self.eager = eager

    def multi(self, words):
        e = self.eng
        ctrl, gains, uni, udl, _, bank, _ = e._snapshot_epoch()
        fn = e.dio.multi_step_eager if self.eager else e.dio.multi_step
        e.state, outs, meters, nan_ok = fn(
            e.state, ctrl, gains[0], gains[1], bank,
            [torch.as_tensor(w) for w in words], uniform=uni, udelay=udl)
        return outs, meters, nan_ok

    def step(self, words):
        e = self.eng
        ctrl, gains, uni, udl, xf, bank, _ = e._snapshot_epoch()
        fn = e.dio.step_eager if self.eager else e.dio.step
        e.state, outs, meters, nan_ok = fn(
            e.state, ctrl, gains[0], gains[1], bank,
            [torch.as_tensor(w) for w in words], uniform=uni, udelay=udl,
            xfade=xf)
        return outs, meters, nan_ok


class _Jax:
    """The JAX package's engine, stepped through its DeviceIO."""

    def __init__(self, text):
        from brutefir_tpu.runtime import Engine as JaxEngine
        self.eng = JaxEngine(jax_parse_config(text))
        assert self.eng.cg.mac == "pallas-interpret"

    def multi(self, words):
        import jax.numpy as jnp
        e = self.eng
        ctrl, gains, uni, udl, _ = e._snapshot_epoch()
        fn = e.dio.multi_step(words[0].shape[0], uniform=uni, udelay=udl,
                              xfade=False)
        e.state, outs, meters, nan_ok = fn(
            e.state, ctrl, gains[0], gains[1], e.bank,
            [jnp.asarray(w) for w in words])
        return outs, meters, nan_ok

    def step(self, words):
        import jax.numpy as jnp
        e = self.eng
        ctrl, gains, uni, _, xf = e._snapshot_epoch()
        e.state, outs, meters, nan_ok = e.dio.step(
            e.state, ctrl, gains[0], gains[1], e.bank,
            [jnp.asarray(w) for w in words], uniform=uni, xfade=xf)
        return outs, meters, nan_ok


def _wire(x: np.ndarray) -> np.ndarray:
    """S24 samples [..., C] -> the JAX package's p24 wire: 3 little-endian
    bytes."""
    return np.ascontiguousarray(
        x.astype("<i4").view(np.uint8).reshape(x.shape + (4,))[..., :3])


def _words(x: np.ndarray) -> np.ndarray:
    """S24 samples [..., C] -> the port's wire: the S24_4LE file's int32
    container words, sign-extended."""
    return np.ascontiguousarray(x.astype("<i4"))


def _s24(words) -> np.ndarray:
    """The JAX package's p24 wire bytes -> sign-extended samples."""
    w = np.asarray(words).astype(np.int32)
    v = w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16)
    return v - ((v & 0x800000) << 1)


def _host(out) -> list:
    """(outs, meters, nan_ok) -> numpy arrays, one list."""
    outs, meters, nan_ok = out
    return [np.asarray(o) for o in outs] + [np.asarray(m) for m in meters] \
        + [np.asarray(nan_ok)]


def _swap_entry(eng):
    """Half of bank entry 1: [B, 2, N]."""
    return 0.5 * eng.bank[1].numpy()


def _changes(i: int, engines, entry):
    """The control change landing before call ``i`` on every engine."""
    for e in engines:
        if i == 1:
            e.control.change_coeff(0, 1)        # a new snapshot
            e.control.set_mute(OUT, 2, True)    # new gains
        elif i == 2:
            e.control.set_delay(IN, 1, 9)       # update_delays, in place
            e.update_bank_entry(0, entry)       # a bank swap
        elif i == 3:
            e.control.change_coeff(0, 0)        # a second crossfade
            e.control.set_mute(OUT, 2, False)


def _drive(tmp_path, monkeypatch, topology: str, op: str, calls: int,
           m: int = 0):
    monkeypatch.setenv("BRUTEFIR_TPU_MAC", "pallas")
    text = _config(tmp_path, topology)
    prog, eager, jx = _Port(text, False), _Port(text, True), _Jax(text)
    entry = _swap_entry(prog.eng)
    rng = np.random.default_rng(23)
    shape = (m, N, C) if op == "multi" else (N, C)
    results = {"prog": [], "eager": [], "jax": []}
    kept = []
    for i in range(calls):
        _changes(i, (prog.eng, eager.eng, jx.eng), entry)
        x = np.round(rng.standard_normal(shape) * 2.0 ** 18)
        for name, side, words in (("prog", prog, [_words(x)]),
                                  ("eager", eager, [_words(x)]),
                                  ("jax", jx, [_wire(x)])):
            out = getattr(side, op)(words)
            results[name].append(_host(out))
            if name == "prog":
                kept.append((out, _host(out)))
    # the outputs of a call survive the later calls
    for out, first in kept:
        for a, b in zip(_host(out), first):
            assert np.array_equal(a, b)
    for p, e in zip(results["prog"], results["eager"]):
        for a, b in zip(p, e):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for p, j in zip(results["prog"], results["jax"]):
        assert p[0].dtype == np.int32
        assert np.abs(p[0] - _s24(j[0])).max() <= 1
    return prog, results


@pytest.mark.parametrize("topology,pair,form,m", [
    ("shared", None, None, 8),            # per block, uniform, one delay
    ("per", None, None, 8),               # per block, per-filter controls
    ("cascade", None, None, 4),           # the stage loop, two stages
    ("shared", "force:2", None, 8),       # G = 2, fused MAC + mix
    ("shared", "force:2", "unfused", 8),  # G = 2, unfused MAC
    ("per", "force:4", None, 8),          # G = 4, fused
    ("per", "force:4", "unfused", 8),     # G = 4, unfused
])
def test_multi_step_program_matches_eager_and_jax(tmp_path, monkeypatch,
                                                  topology, pair, form, m):
    if pair:
        monkeypatch.setenv("BRUTEFIR_TPU_PAIR", pair)
    if form:
        monkeypatch.setenv("BRUTEFIR_TPU_GROUP_FORM", form)
    prog, _ = _drive(tmp_path, monkeypatch, topology, "multi", 4, m)
    from brutefir_tpu_torch.graph.compile import group_size
    dio = prog.eng.dio
    # one program a key (m, uniform, udelay): the coefficient change
    # before call 1 ends the shared config's uniform controls
    keys = set(dio.programs())
    assert all(k[:2] == ("multi", m) for k in keys)
    assert {k[2] for k in keys} == ({True, False} if topology == "shared"
                                    else {False})
    assert not dio.captures
    assert group_size(prog.eng.spec, m) == {None: 1, "force:2": 2,
                                            "force:4": 4}[pair]


@pytest.mark.parametrize("topology", ["xfade", "per"])
def test_step_program_matches_eager_and_jax(tmp_path, monkeypatch,
                                            topology):
    """Block by block: the coefficient change before call 1 makes it a
    crossfade block on the ``xfade`` config (the ``xfade`` key)."""
    prog, _ = _drive(tmp_path, monkeypatch, topology, "step", 5)
    keys = set(prog.eng.dio.programs())
    xf = {k[3] for k in keys}
    assert xf == ({False, True} if topology == "xfade" else {False})


def test_state_handed_in_is_copied_in(tmp_path):
    """A state that is not the programs' (a fresh ``init_state``) is
    copied into their static tensors; the static state comes back."""
    from brutefir_tpu_torch.graph.compile import init_state
    a = _Port(_config(tmp_path, "shared"), False)
    b = _Port(_config(tmp_path, "shared"), True)
    rng = np.random.default_rng(3)
    for i in range(3):
        words = [_words(np.round(rng.standard_normal((N, C)) * 2.0 ** 20))]
        if i == 2:
            for p in (a, b):
                p.eng.state = init_state(p.eng.spec, CPU)
        oa, ob = a.step(words), b.step(words)
        for x, y in zip(_host(oa), _host(ob)):
            assert np.array_equal(x, y)
    st = a.eng.dio._statics.state.tree
    assert a.eng.state is st
    for x, y in zip(leaves(a.eng.state), leaves(b.eng.state)):
        assert torch.equal(x, y)


def test_static_index_builds_each_index_once():
    first = static_index((0, 2, 1), CPU)
    assert static_index((0, 2, 1), CPU) is first
    assert static_index((0, 2, 1), CPU, torch.int32) is not first
    for k in range(600):            # more keys than the old bound held
        static_index((k, k + 1), CPU)
    assert static_index((0, 2, 1), CPU) is first
    assert first.tolist() == [0, 2, 1] and first.dtype == torch.long


class _Emulated:
    """``torch.cuda.CUDAGraph`` on the CPU, what a capture and a replay
    do emulated: capturing (``_capturing``) runs the body's Python, so its
    launches count and its Python effects happen, but puts the static
    tensors' contents back (no device work); ``replay`` does the device
    work and no Python: it runs the body with the counters held and
    ``DeviceIO.dstate`` put back, and writes the captured outputs in
    place."""
    dio = None          # the DeviceIO under test, or None
    programs = []       # the programs of a test without a DeviceIO

    def replay(self):
        dio = _Emulated.dio
        progs = (list(dio.programs().values()) if dio is not None
                 else _Emulated.programs)
        p = next(p for p in progs if p.graph is self)
        held = [dict(c) for c in program.COUNTERS]
        dstate = dio.dstate if dio is not None else None
        new = p.body(p.words.tree)
        if dio is not None:
            dio.dstate = dstate
        for c, h in zip(program.COUNTERS, held):
            c.update(h)
        for o, n in zip(leaves(p.out), leaves(new)):
            o.copy_(n)


@contextlib.contextmanager
def _capturing(graph, **kwargs):
    dio = _Emulated.dio
    bufs = ([] if dio is None else
            dio._statics.state.bufs + dio._statics.dstate.bufs)
    saved = [b.clone() for b in bufs]
    yield
    for b, v in zip(bufs, saved):
        b.copy_(v)


@pytest.fixture
def emulated(monkeypatch):
    """The capture path on the CPU (``_Emulated``): DeviceIO captures."""
    from brutefir_tpu_torch.runtime import device_io
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Emulated)
    monkeypatch.setattr(torch.cuda, "graph", _capturing)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    monkeypatch.setattr(device_io, "capturable", lambda *a: True)
    yield _Emulated
    _Emulated.dio = None
    _Emulated.programs = []


def test_program_capture_counts_and_outputs(emulated):
    """The capture path: the launch counters after n calls are n times
    one call's, and the outputs of call k are unchanged after call k + 1
    (clones, not the graph's outputs)."""
    mac.reset_launches()
    fft_glue.reset_launches()

    def body(words):
        mac.launches["mac_rows"] += 2
        fft_glue.launches["glue_fwd_ring"] += 1
        return [words[0] * 2 + 1], [words[0].sum(dim=0)]

    p = Program(body, CPU, capture=True)
    emulated.programs = [p]
    outs = []
    for k in range(5):
        out = p([torch.full((4, 3), float(k))])
        outs.append(out)
        assert mac.launches["mac_rows"] == 2 * (k + 1)
        assert fft_glue.launches["glue_fwd_ring"] == k + 1
    assert p.graph is not None and p.calls == 5
    assert p.delta and sum(n for _, _, n in p.delta) == 3
    for k, (y, s) in enumerate(outs):
        assert torch.equal(y[0], torch.full((4, 3), 2.0 * k + 1))
        assert torch.equal(s[0], torch.full((3,), 4.0 * k))


@pytest.mark.parametrize("topology,op,pair", [
    ("shared", "multi", None), ("cascade", "multi", None),
    ("per", "multi", "force:4"), ("xfade", "step", None)])
def test_emulated_capture_matches_eager(tmp_path, monkeypatch, emulated,
                                        topology, op, pair):
    """DeviceIO capturing (emulated) against the eager forms, byte-equal,
    through the control changes and a state and ``dstate`` handed back
    between replays (what ``Engine._warm_programs`` does): the handed
    state is copied in once, and the replays after it chain from the
    static state."""
    if pair:
        monkeypatch.setenv("BRUTEFIR_TPU_PAIR", pair)
    text = _config(tmp_path, topology)
    prog, eager = _Port(text, False), _Port(text, True)
    emulated.dio = prog.eng.dio
    entry = _swap_entry(prog.eng)
    rng = np.random.default_rng(29)
    shape = (8, N, C) if op == "multi" else (N, C)
    for i in range(7):
        _changes(i, (prog.eng, eager.eng), entry)
        if i == 4:
            for e in (prog.eng, eager.eng):
                e.state = program.tree_map(torch.clone, e.state)
                e.dio.dstate = program.tree_map(torch.clone, e.dio.dstate)
        words = [_words(np.round(rng.standard_normal(shape) * 2.0 ** 18))]
        a, b = _host(getattr(prog, op)(words)), _host(getattr(eager, op)(
            words))
        for x, y in zip(a, b):
            assert np.array_equal(x, y), i
    progs = prog.eng.dio.programs()
    assert any(p.graph is not None and p.calls >= 3 for p in progs.values())
    assert prog.eng.dio.dstate is prog.eng.dio._statics.dstate.tree


def test_program_refuses_another_shape():
    p = Program(lambda w: ([w[0]], [w[0]]), CPU, capture=False)
    p([torch.zeros(4, 3)])
    with pytest.raises(ValueError):
        p([torch.zeros(5, 3)])


@pytest.mark.parametrize("pair,form,route", [
    (None, "", (1, "none")),              # massive-like: block by block
    ("force:4", "unfused", (4, "unfused")),
    ("force:4", "", (4, "fused")),
    ("force:2", "unfused", (2, "unfused")),
])
def test_program_keeps_its_route(tmp_path, monkeypatch, emulated, pair,
                                 form, route):
    """Each program records at its key's first call the route
    ``group_route`` chose (G blocks a group and the form), which
    ``DeviceIO.programs()`` exposes, and its capture's span carries it in
    its name; a per-block key records G = 1, "none"."""
    from brutefir_tpu_torch.graph.compile import GroupRoute, group_route
    from brutefir_tpu_torch.runtime import tracing
    if pair:
        monkeypatch.setenv("BRUTEFIR_TPU_PAIR", pair)
    monkeypatch.setenv("BRUTEFIR_TPU_GROUP_FORM", form)
    port = _Port(_config(tmp_path, "shared"), False)
    emulated.dio = port.eng.dio
    rng = np.random.default_rng(31)
    tracing.enable()
    try:
        for _ in range(3):                 # eager, capture, replay
            port.multi([_words(np.round(rng.standard_normal((8, N, C))
                                        * 2.0 ** 18))])
        port.step([_words(np.round(rng.standard_normal((N, C))
                                   * 2.0 ** 18))])
        port.step([_words(np.round(rng.standard_normal((N, C))
                                   * 2.0 ** 18))])
    finally:
        tracing.disable()
    progs = port.eng.dio.programs()
    multi = [p for k, p in progs.items() if k[0] == "multi"]
    step = [p for k, p in progs.items() if k[0] == "step"]
    assert len(multi) == len(step) == 1
    assert multi[0].route == route == group_route(port.eng.spec, 8)
    assert isinstance(multi[0].route, GroupRoute)
    assert step[0].route == (1, "none")
    names = [s.name for s in tracing.take()
             if s.name.startswith("program.capture")]
    assert names == [f"program.capture {multi[0].key} G={route[0]} "
                     f"{route[1]}",
                     f"program.capture {step[0].key} G=1 none"]
