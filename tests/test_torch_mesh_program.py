"""The step programs (``runtime/program.py``) on a mesh, on the CPU: a
mesh's cells on streams of their own (``parallel/mesh.CellStreams``),
captured and replayed as on the card, one card or several.

Each case is a mesh case of tests/test_torch_mesh.py (or, for the host
codec path, of tests/test_torch_host_program.py) run file to file by
three engines: the port through its programs, with an emulated capture
and replay (``_Emulated`` of tests/test_torch_program.py) and the cell
streams, events and pools replaced by stand-ins that record what was
called; the port through its eager forms on the same mesh, byte-equal
with equal calls of every kernel wrapper; and the JAX engine on the
virtual 8-CPU mesh of tests/conftest.py (its Pallas kernels interpreted,
``BRUTEFIR_TPU_MAC=pallas``), within 1 LSB, the bound of the mesh tests.
Each case runs with the mesh's cells on one card and, by its card
grouping (``Mesh.cards``), across two.

The stand-ins check what the card needs: every cell's kernel and ring
write are issued with its cell's stream current; every shard form, ring
write and split returns with its cells joined, and the first device
assembles partials only then; every cell stream that joins a capture
(waits on the capture stream) is waited on by it before the capture
ends; each card other than the first gets one private pool, in use for
the whole capture and kept by the program; and across cards every
replay runs between the waits that order it with the other cards'
current streams.
"""

import contextlib

import numpy as np
import pytest
import torch

from brutefir_tpu.config import parse_config as jax_parse_config
from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.graph import compile as tcomp
from brutefir_tpu_torch.ops import fft_glue, mac_shard as ms, partconv
from brutefir_tpu_torch.parallel import mesh as tmesh
from brutefir_tpu_torch.runtime import program
from test_torch_host_engine import EQUAL_SHARE, N as HOST_N
from test_torch_host_engine import _config as host_config
from test_torch_host_engine import _read, _signal, _write
from test_torch_mesh import _config, _flip_script, _s24_input, _taps
from test_torch_mesh import bench1_text
from test_torch_program import _Emulated, _capturing, emulated  # noqa: F401

CPU = torch.device("cpu")
OTHER = torch.device("cpu", 1)     # the second card of a two-card grouping


# --- stand-ins for the card's streams, events and pools ----------------------

class _Stream:
    """A stream: its device and the waits it was given."""

    def __init__(self, device=None, name="cell"):
        self.device = torch.device(device if device is not None else CPU)
        self.name = name

    def wait_stream(self, other):
        _Card.log.append(("wait", self, other))


class _Card:
    """The stand-in's state: the current stream of each device, the log
    of waits, pools and captures."""
    log = []
    current = {}

    @staticmethod
    def key(dev) -> str:
        return str(torch.device(dev if dev is not None else CPU))

    @classmethod
    def current_stream(cls, dev=None):
        k = cls.key(dev)
        if k not in cls.current:
            cls.current[k] = _Stream(dev, "default")
        return cls.current[k]

    @classmethod
    def set_stream(cls, s):
        cls.current[cls.key(s.device)] = s

    @classmethod
    @contextlib.contextmanager
    def stream(cls, s):
        k = cls.key(s.device)
        prev = cls.current_stream(s.device)
        cls.current[k] = s
        try:
            yield
        finally:
            cls.current[k] = prev


class _Pool:
    def __init__(self):
        _Card.log.append(("pool", self))


@contextlib.contextmanager
def _use_pool(pool, device=None):
    _Card.log.append(("pool_in", pool, torch.device(device)))
    yield
    _Card.log.append(("pool_out", pool, torch.device(device)))


@contextlib.contextmanager
def _graph(graph, **kwargs):
    """A capture (``_capturing`` of tests/test_torch_program.py) on a
    capture stream of its own, the first device's current stream while
    it runs; at its end every stream that joined it must have been joined
    back."""
    cap = _Stream(CPU, "capture")
    prev = _Card.current_stream(CPU)
    _Card.current[_Card.key(CPU)] = cap
    _Card.log.append(("capture_in", cap))
    with _capturing(graph, **kwargs):
        yield
    _Card.current[_Card.key(CPU)] = prev
    _Card.log.append(("capture_out", cap))
    _check_joined(cap)


def _check_joined(cap) -> None:
    """Every stream that waited on ``cap`` (its fork into the capture) is
    waited on by ``cap`` after its last fork."""
    start = next(k for k, e in enumerate(_Card.log)
                 if e[0] == "capture_in" and e[1] is cap)
    forked = {}
    for k, e in enumerate(_Card.log[start:]):
        if e[0] == "wait" and e[2] is cap:
            forked[id(e[1])] = (k, e[1])
    assert forked
    for k, s in forked.values():
        assert any(e[0] == "wait" and e[1] is cap and e[2] is s
                   for e in _Card.log[start + k:]), s.name


class _Graph(_Emulated):
    """``_Emulated``, its replays checked: across cards each runs inside
    ``CellStreams.replaying``."""
    replaying = 0
    spans = False
    replays = 0

    def replay(self):
        assert _Graph.replaying == 1 or not _Graph.spans
        _Graph.replays += 1
        super().replay()


class _Checks:
    """The stand-in's checks on one engine pair: the ring parts of each
    engine's mesh by cell, and the calls of the kernel wrappers."""

    def __init__(self):
        self.engines = []

    def cell_of(self, part):
        for eng in self.engines:
            ring = eng.state.ring
            for i, j, _ in eng.mesh.cells():
                if ring.parts[i][j] is part:
                    return eng.mesh, (i, j)
        raise AssertionError("not a ring part of a mesh under test")

    def in_cell(self, part) -> None:
        """The current stream of ``part``'s device is its cell's stream,
        forked since the last join."""
        mesh, cell = self.cell_of(part)
        s = mesh.streams.streams[cell]
        assert _Card.current_stream(part.device) is s
        assert cell in mesh.streams.forked

    def joined(self) -> None:
        for eng in self.engines:
            assert not eng.mesh.streams.forked


@pytest.fixture
def cells(emulated, monkeypatch):
    """The stand-ins, the spies on every kernel wrapper a mesh step calls
    (counted in ``fft_glue.launches`` under ``spy:<name>``, which the
    programs keep as launch counts: the wrappers count no launch on the
    CPU) and the checks around them."""
    checks = _Checks()
    _Card.log = []
    _Card.current = {}
    _Graph.replaying = 0
    _Graph.spans = False
    _Graph.replays = 0
    for name in ("Stream", "current_stream", "set_stream", "stream"):
        monkeypatch.setattr(torch.cuda, name,
                            getattr(_Card, name) if name != "Stream"
                            else _Stream)
    monkeypatch.setattr(torch.cuda, "MemPool", _Pool)
    monkeypatch.setattr(torch.cuda, "use_mem_pool", _use_pool)
    monkeypatch.setattr(torch.cuda, "graph", _graph)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(program, "capturable", lambda *a: True)

    def spy(mod, name, before=None, after=None):
        key = f"spy:{name}"
        monkeypatch.setitem(fft_glue.launches, key, 0)
        fn = getattr(mod, name)

        def call(*a, **k):
            fft_glue.launches[key] += 1
            if before is not None:
                before(*a)
            out = fn(*a, **k)
            if after is not None:
                after()
            return out

        monkeypatch.setattr(mod, name, call)

    # each cell's kernel with its cell's stream current
    for name in ("mac", "mac_dual", "mac_mix", "mac_group"):
        spy(ms, name, before=lambda ring, *a: checks.in_cell(ring))
    # each shard form, ring write and split returns joined
    for name in ("mac_shard", "mac_dual_shard", "mac_mix_shard",
                 "mac_group_shard", "_write_ring_mesh", "split"):
        spy(tcomp, name, after=checks.joined)
    spy(ms, "_assemble", before=lambda *a: checks.joined())

    def ring_write(ring, *a):
        if isinstance(ring, torch.Tensor):
            checks.in_cell(ring)

    spy(tcomp, "_write_ring", before=ring_write)
    for mod, name in ((fft_glue, "fft_points"), (fft_glue, "glue_fwd"),
                      (partconv, "irfft_planes_valid")):
        spy(mod, name)
    real = tmesh.CellStreams.replaying

    @contextlib.contextmanager
    def replaying(self):
        _Graph.replaying += 1
        with real(self):
            yield
        _Graph.replaying -= 1

    monkeypatch.setattr(tmesh.CellStreams, "replaying", replaying)
    yield checks
    _Card.log = []
    _Card.current = {}


# --- the cases ------------------------------------------------------------------

def _words(path):
    return np.fromfile(path, "<i4").astype(np.int64)


def _host_words(path):
    return _read(path, "S24_BE", 4)


MESH_N, MESH_B = 512, 2


def _mesh_case(C, sets, filters=None, extra="", frames=None, seed=4,
               N=MESH_N, B=MESH_B, taps=2, level=2.0 ** 18):
    def prepare(tmp_path):
        _taps(tmp_path, taps, N * B, seed - 1)
        _s24_input(tmp_path, frames or N * 11 + 37, C, seed, level)
        return lambda name: _config(tmp_path, name, C, N, B, sets=sets,
                                    filters=filters, extra=extra)
    return prepare


def _bench1_case(tmp_path):
    N, B = 256, 2
    _taps(tmp_path, 6, N * B, 5)
    _s24_input(tmp_path, N * 9 + 11, 2, 6, level=2.0 ** 17)
    return lambda name: bench1_text(tmp_path, name, N, B)


XF_FILTERS = "\n".join(
    f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; coeff: 0; "
    f"crossfade: true; }};" for i in range(4))
XF_EXTRA = f'logic: "cli" {{ script: "{_flip_script(4)}"; echo: false; }};'


def _host_case(tmp_path):
    frames = HOST_N * 10 + 55
    _write(tmp_path / "in.raw", "S24_BE",
           _signal("S24_BE", frames, 4, 30, 2.0 ** -5))
    return lambda name: host_config(tmp_path, name, "S24_BE", "S24_BE",
                                    C=4, coeffs=(0, 1, 0, 1))


# name: (prepare(tmp_path) -> text_of(name), f, sp, how, batch blocks,
# BRUTEFIR_TPU_PAIR, read(path) -> words, what the mesh's step takes)
CASES = {
    "massive_like_uniform_2x2": (_mesh_case(4, [0, 0, 0, 0]), 2, 2,
                                 "run_offline", 2, None, _words, "mix"),
    "per_filter_sets_2x1": (_mesh_case(4, [0, 1, 1, 0]), 2, 1,
                            "run_offline", 2, None, _words, "mix"),
    "per_filter_sets_1x2": (_mesh_case(4, [0, 1, 1, 0]), 1, 2,
                            "run_offline", 2, None, _words, "mix"),
    "bench1_cascade_1x2": (_bench1_case, 1, 2, "run_offline", 2, None,
                           _words, "loop"),
    "bench1_cascade_2x2": (_bench1_case, 2, 2, "run_offline", 2, None,
                           _words, "loop"),
    "crossfade_script_2x1": (_mesh_case(4, [0, 1], XF_FILTERS, XF_EXTRA,
                                        MESH_N * 10 + 5, 8),
                             2, 1, "run", 0, None, _words, "mix"),
    "grouped_dispatch_1x2": (_mesh_case(4, [0, 1, 0, 1],
                                        frames=MESH_N * 16 + 30, seed=10),
                             1, 2, "run_offline", 4, "force:4", _words,
                             "mix"),
    "s24_be_host_path_2x2": (_host_case, 2, 2, "run", 0, None, _host_words,
                             "host"),
}


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX engine's output of each case, run once a case."""
    return {}


def _jax_output(tmp_path, monkeypatch, case, text_of, f, sp, how, read):
    from brutefir_tpu.runtime import Engine as JaxEngine
    with monkeypatch.context() as mp:
        mp.setenv("BRUTEFIR_TPU_MESH", f"{f}x{sp}")
        jc = jax_parse_config(text_of("out_jax.raw"))
        jc.quiet = True
        je = JaxEngine(jc)
        assert je.mesh is not None and je.mesh.shape == {"f": f, "sp": sp}
        getattr(je, how)()
    return read(tmp_path / "out_jax.raw")


def _port_run(text_of, name, mesh, how, batch, eager, checks):
    """One port engine on ``mesh`` to EOF through its programs or
    (``eager``) its eager forms: (engine, its output file, the kernel
    wrappers' calls)."""
    from brutefir_tpu_torch.runtime.engine import Engine
    conf = parse_config(text_of(name))
    conf.quiet = True
    eng = Engine(conf, device=CPU, mesh=mesh)
    assert eng.mesh is mesh
    checks.engines.append(eng)
    if eager:
        if eng.dio is not None:
            eng.dio.step = eng.dio.step_eager
            eng.dio.multi_step = eng.dio.multi_step_eager
        eng._dispatch_host = eng._dispatch_eager
    elif eng.dio is not None:
        _Emulated.dio = eng.dio
    else:
        from test_torch_host_program import _HostView
        _Emulated.dio = _HostView(eng)
    before = {k: v for k, v in fft_glue.launches.items()
              if k.startswith("spy:")}
    if how == "run_offline":
        eng.run_offline(batch_blocks=batch)
    else:
        eng.run()
    calls = {k: v - before[k] for k, v in fft_glue.launches.items()
             if k.startswith("spy:") and v != before[k]}
    return eng, calls


def _programs(eng):
    return (eng.dio if eng.dio is not None else eng.host_step).programs()


@pytest.mark.parametrize("cards", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_mesh_programs_match_eager_and_jax(tmp_path, monkeypatch, cells,
                                           jax_outputs, case, cards):
    prepare, f, sp, how, batch, pair, read, route = CASES[case]
    monkeypatch.setenv("BRUTEFIR_TPU_MAC", "pallas")
    if pair:
        monkeypatch.setenv("BRUTEFIR_TPU_PAIR", pair)
    text_of = prepare(tmp_path)
    meshes = {}
    for route_name in ("graphs", "eager"):
        mesh = tmesh.make_mesh([CPU] * (f * sp), f, sp)
        mesh.streams = tmesh.CellStreams(mesh)
        if cards == 2:
            # the cells' card grouping: the second half on a second card
            mesh.cards = lambda: [CPU, OTHER]
        meshes[route_name] = mesh
    _Graph.spans = cards == 2
    eng, calls = _port_run(text_of, "out_port.raw", meshes["graphs"], how,
                           batch, False, cells)
    eager, ecalls = _port_run(text_of, "out_eager.raw", meshes["eager"], how,
                              batch, True, cells)
    # byte-equal to the eager mesh, the same kernel wrapper calls
    a = (tmp_path / "out_port.raw").read_bytes()
    assert a and a == (tmp_path / "out_eager.raw").read_bytes()
    assert calls == ecalls and calls
    shard_calls = ("spy:mac_mix", "spy:mac", "spy:mac_dual", "spy:mac_group")
    assert any(calls.get(k) for k in shard_calls)
    if route == "mix":
        assert eng._sharded.kernel
    if pair:
        assert calls.get("spy:mac_group")
    # every key called twice was captured, some key was, and replayed
    progs = _programs(eng)
    assert progs and all(p.graph is not None for p in progs.values()
                         if p.calls >= 2)
    assert any(p.graph is not None for p in progs.values())
    assert _Graph.replays > 0 and not _programs(eager)
    # one private pool a card other than the first, in use for the whole
    # capture, kept by the program
    caps = [e for e in _Card.log if e[0] == "capture_in"]
    assert len(caps) == sum(p.graph is not None for p in progs.values())
    for p in progs.values():
        if p.graph is None:
            continue
        assert len(p.pools) == cards - 1
        for pool in p.pools:
            k_in = _Card.log.index(("pool_in", pool, OTHER))
            k_out = _Card.log.index(("pool_out", pool, OTHER))
            inside = [e for e in _Card.log[k_in:k_out]
                      if e[0] in ("capture_in", "capture_out")]
            assert [e[0] for e in inside] == ["capture_in", "capture_out"]
    assert sum(e[0] == "pool" for e in _Card.log) == (cards - 1) * len(caps)
    # the cells ran on streams of their own, one each
    assert len(meshes["graphs"].streams.streams) == f * sp
    assert len({id(s) for s in meshes["graphs"].streams.streams.values()}) \
        == f * sp
    # within 1 LSB of the JAX engine on its virtual mesh
    if case not in jax_outputs:
        jax_outputs[case] = _jax_output(tmp_path, monkeypatch, case,
                                        text_of, f, sp, how, read)
    yj, yt = jax_outputs[case], read(tmp_path / "out_port.raw")
    assert yt.shape == yj.shape and np.abs(yj).max() > 2 ** 12
    d = np.abs(yt - yj)
    assert d.max() <= 1
    if route == "host":
        assert np.mean(d == 0) >= EQUAL_SHARE


# --- the mesh's cells and cards ---------------------------------------------------

def test_cpu_mesh_cells_and_joins_do_nothing():
    mesh = tmesh.make_mesh([CPU] * 4, 2, 2)
    assert mesh.streams is None and mesh.cards() == [CPU]
    with mesh.cell(1, 0):
        pass
    mesh.join()


@pytest.mark.parametrize("devices,f,cards", [
    (["cuda:0"] * 4, 2, ["cuda:0"]),
    (["cuda:0", "cuda:1"], 2, ["cuda:0", "cuda:1"]),
    (["cuda:1", "cuda:0", "cuda:1", "cuda:0"], 1, ["cuda:1", "cuda:0"]),
])
def test_cuda_mesh_is_captured_on_its_cards(devices, f, cards):
    """A mesh on the card has cell streams (made at a cell's first use,
    so none here), and its programs are captured on one card or across
    several; the cards are the distinct devices, the first device's
    first."""
    mesh = tmesh.make_mesh([torch.device(d) for d in devices], f)
    assert isinstance(mesh.streams, tmesh.CellStreams)
    assert not mesh.streams.streams
    assert mesh.cards() == [torch.device(d) for d in cards]
    assert program.capturable(mesh.first, mesh)
    assert program._spans(mesh) == (len(cards) > 1)
    assert not program.capturable(CPU, tmesh.make_mesh([CPU] * 2, 2))


def test_cell_streams_fork_and_join(cells):
    """A cell forks from the first device's current stream (and, on
    another card, from that card's), runs with its stream current, and
    the join makes the first device's current stream (and the other
    card's) wait on it; only cells forked since the last join."""
    mesh = tmesh.Mesh(np.array([[CPU, OTHER]], dtype=object))
    mesh.streams = tmesh.CellStreams(mesh)
    first, other = _Card.current_stream(CPU), _Card.current_stream(OTHER)
    with mesh.cell(0, 1):
        s = mesh.streams.streams[(0, 1)]
        assert _Card.current_stream(OTHER) is s
        assert _Card.current_stream(CPU) is first
    assert _Card.current_stream(OTHER) is other
    assert _Card.log == [("wait", s, first), ("wait", s, other)]
    mesh.join()
    assert _Card.log[2:] == [("wait", first, s), ("wait", other, s)]
    mesh.join()
    assert len(_Card.log) == 4 and not mesh.streams.forked
    with mesh.cell(0, 0):
        assert _Card.current_stream(CPU) is mesh.streams.streams[(0, 0)]
    assert mesh.streams.streams[(0, 1)] is s
    assert _Card.log[4:] == [("wait", mesh.streams.streams[(0, 0)], first)]
