"""Logic-module hooks and external modules in the port against the JAX
package: the six bfevents hooks (``input_timed``, ``input_freqd``,
``pre_convolve``, ``post_convolve``, ``output_freqd``, ``output_timed``,
bfmod.h:192-215), external ``bflogic_<name>.py`` and ``bfio_<name>.py``
modules from ``modules_path``.

Engines run on the CPU at 256 x 4 partitions with 1-3 channels. The same
seeded numpy input and the same hook objects (plain numpy classes
appended to ``engine.logic``, as tests/test_logic_hooks.py does) go
through the JAX engine and the port's engine. Bounds, against the JAX
engine's output on the same input: float outputs within 1e-6 of the
peak, S24 words within +-1 LSB; a hook that zeroes everything gives
exact zeros in both. The call lists, the ids, and the shape and dtype of
every buffer a hook sees are equal: ``[N+1]`` complex64 spectra and
``[N]`` float32 blocks. The taps' spectra round trip (numpy only) is
bit-equal to the JAX package's.

The JAX engine hands ``output_timed`` a read-only view of its device
array; the port hands a writable row, as the reference does. So that
both packages run the same mutation there, the JAX engine's
``write_block`` is given a writable copy here (a test harness for the
JAX side; nothing of the JAX package changes).
"""

import os
import re
import threading
import types

import numpy as np
import pytest
import torch

from brutefir_tpu.config import parse_config as jax_parse_config
from brutefir_tpu_torch.config import parse_config

CPU = torch.device("cpu")
N, B = 256, 4
KINDS = ("input_timed", "input_freqd", "pre_convolve", "post_convolve",
         "output_freqd", "output_timed")
FREQD = KINDS[1:5]
MODES = ("read", "scale", "zero_bin", "zero_all")
GAINS = np.random.default_rng(71).uniform(0.5, 1.5, 16)
REL_TOL = 1e-6          # float outputs, of the peak
LSB_TOL = 1             # S24 words


class Hooks:
    """Hooks of the ``kinds`` named, applying ``mode`` to every buffer:
    ``read`` leaves it, ``scale`` multiplies by GAINS[id], ``zero_bin``
    zeroes entry 5, ``zero_all`` zeroes it. Each call is recorded as
    (thread, kind, id, shape, dtype, writable, contiguous); block_start
    as (thread, "block_start", k)."""

    def __init__(self, kinds=KINDS, mode="read", only=None):
        self.calls = []
        self.mode = mode
        self.only = only        # ids the mode applies to (None: all)
        for kind in kinds:
            setattr(self, kind, self._hook(kind))

    def block_start(self, k):
        self.calls.append((threading.current_thread().name, "block_start",
                           k))

    def _hook(self, kind):
        def hook(buf, i):
            self.calls.append((threading.current_thread().name, kind, i,
                               buf.shape, buf.dtype.name,
                               buf.flags.writeable, buf.flags.c_contiguous))
            if self.only is not None and i not in self.only:
                return
            if self.mode == "scale":
                buf *= GAINS[i]
            elif self.mode == "zero_bin":
                buf[5] = 0
            elif self.mode == "zero_all":
                buf[:] = 0
        return hook

    def by_kind(self):
        """{kind: [id, ...]} in call order."""
        out = {}
        for c in self.calls:
            if c[1] != "block_start":
                out.setdefault(c[1], []).append(c[2])
        return out


# --- configs and runs ---------------------------------------------------------

def _taps(tmp_path, k, n=N * B):
    rng = np.random.default_rng(50 + k)
    h = rng.standard_normal(n) * np.exp(-np.arange(n) / (n / 5))
    (0.5 * h / np.linalg.norm(h)).astype("<f4").tofile(tmp_path / f"h{k}.raw")


def _input(tmp_path, frames, C, seed=3, level=0.1):
    x = (np.random.default_rng(seed).standard_normal((frames, C))
         * level).astype("<f4")
    x.tofile(tmp_path / "in.raw")
    return x


def _coeffs(tmp_path, n_sets):
    for k in range(n_sets):
        _taps(tmp_path, k)
    return "".join(f'coeff {k} {{ filename: "{tmp_path / f"h{k}.raw"}"; '
                   f'format: "FLOAT_LE"; }};\n' for k in range(n_sets))


def single_config(tmp_path, tag, head=""):
    """3 inputs -> 3 filters (sets 0, 1, 0) -> outputs 0-1 FLOAT_LE on one
    device and output 2 S24_4LE on another."""
    return (f"sampling_rate: 44100;\nfilter_length: {N},{B};\n{head}\n"
            + _coeffs(tmp_path, 2)
            + f'input 0,1,2 {{ device: "file" {{ path: "{tmp_path / "in.raw"}"; '
              f'}}; sample: "FLOAT_LE"; channels: 3; }};\n'
            + f'output 0,1 {{ device: "file" {{ path: '
              f'"{tmp_path / f"{tag}_f.raw"}"; }}; sample: "FLOAT_LE"; '
              f'channels: 2; }};\n'
            + f'output 2 {{ device: "file" {{ path: '
              f'"{tmp_path / f"{tag}_i.raw"}"; }}; sample: "S24_4LE"; '
              f'channels: 1; dither: false; }};\n'
            + "".join(f"filter {f} {{ from_inputs: {f}; to_outputs: {f}; "
                      f"coeff: {c}; }};\n" for f, c in enumerate((0, 1, 0))))


def cascade_config(tmp_path, tag, head=""):
    """Two stages: filters 1 and 2 (inputs 0 and 1) feed filter 0, which
    drives output 0; filter 2 also drives output 1. Stage 0 is [1, 2],
    stage 1 is [0]."""
    return (f"sampling_rate: 44100;\nfilter_length: {N},{B};\n{head}\n"
            + _coeffs(tmp_path, 3)
            + f'input 0,1 {{ device: "file" {{ path: "{tmp_path / "in.raw"}"; '
              f'}}; sample: "FLOAT_LE"; channels: 2; }};\n'
            + f'output 0,1 {{ device: "file" {{ path: '
              f'"{tmp_path / f"{tag}_f.raw"}"; }}; sample: "FLOAT_LE"; '
              f'channels: 2; }};\n'
            + "filter 0 { from_filters: 1, 2/-6; to_outputs: 0; coeff: 0; };\n"
              "filter 1 { from_inputs: 0; to_filters: 0; coeff: 1; };\n"
              "filter 2 { from_inputs: 1; to_filters: 0; to_outputs: 1; "
              "coeff: 2; };\n")


def xfade_config(tmp_path, tag, head=""):
    """Two crossfading filters whose sets a CLI script flips every block,
    outputs FLOAT_LE."""
    script = "cfc 0 1; cfc 1 1\\ncfc 0 0; cfc 1 0"
    return (f"sampling_rate: 44100;\nfilter_length: {N},{B};\n{head}\n"
            f'logic: "cli" {{ script: "{script}"; echo: false; }};\n'
            + _coeffs(tmp_path, 2)
            + f'input 0,1 {{ device: "file" {{ path: "{tmp_path / "in.raw"}"; '
              f'}}; sample: "FLOAT_LE"; channels: 2; }};\n'
            + f'output 0,1 {{ device: "file" {{ path: '
              f'"{tmp_path / f"{tag}_f.raw"}"; }}; sample: "FLOAT_LE"; '
              f'channels: 2; }};\n'
            + "".join(f"filter {f} {{ from_inputs: {f}; to_outputs: {f}; "
                      f"coeff: 0; crossfade: true; }};\n" for f in range(2)))


TOPOLOGIES = {"single": (single_config, 3), "cascade": (cascade_config, 2),
              "crossfade": (xfade_config, 2)}


@pytest.fixture
def writable_jax_output_timed(monkeypatch):
    """The JAX engine's write_block with a writable copy of y (see the
    module docstring)."""
    from brutefir_tpu.runtime.engine import Engine as JaxEngine
    real = JaxEngine.write_block
    monkeypatch.setattr(JaxEngine, "write_block",
                        lambda self, y, *a, **k: real(self, np.array(y),
                                                      *a, **k))


def _engines(text_of):
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    return (JaxEngine(jax_parse_config(text_of("jax"))),
            Engine(parse_config(text_of("port")), device=CPU))


def run_pair(text_of, make_hooks, per_block=0):
    """Both engines with a fresh ``make_hooks()`` each, through run() (or
    ``per_block`` one-block runs, so that every hook of a block has run
    before the next block starts). Returns ((jax engine, hooks), (port
    engine, hooks))."""
    out = []
    for eng in _engines(text_of):
        hooks = make_hooks()
        eng.logic.append(hooks)
        if per_block:
            eng.attach_logic()
            eng.setup()
            try:
                for b in range(per_block):
                    eng.run(max_blocks=b + 1, setup=False)
            finally:
                eng.teardown()
        else:
            eng.run()
        out.append((eng, hooks))
    return out


def compare_outputs(tmp_path, frames, channels_f, with_int=False,
                    zero=False):
    """The port's output files against the JAX engine's within the
    bounds; returns the float outputs' peak."""
    yj = np.fromfile(tmp_path / "jax_f.raw", "<f4").astype(np.float64)
    yt = np.fromfile(tmp_path / "port_f.raw", "<f4").astype(np.float64)
    assert yj.size == yt.size == frames * channels_f
    peak = np.abs(yj).max()
    if zero:
        assert peak == 0 and not yt.any()
    else:
        assert peak > 0
        assert np.abs(yt - yj).max() <= REL_TOL * peak
    if with_int:
        ij = np.fromfile(tmp_path / "jax_i.raw", "<i4").astype(np.int64)
        it = np.fromfile(tmp_path / "port_i.raw", "<i4").astype(np.int64)
        assert ij.size == it.size == frames
        assert (not ij.any() and not it.any()) if zero else (
            np.abs(ij).max() > 2 ** 16 and np.abs(it - ij).max() <= LSB_TOL)
    return peak


# --- the taps' spectra round trip ---------------------------------------------

@pytest.mark.parametrize("shape", [(8,), (3, 16), (2, 3, 32), (5, 256)])
def test_unpack_spectrum_matches_jax(shape):
    """The port's numpy ``unpack_spectrum`` is the JAX one's numpy branch,
    bit for bit, and ``pack_spectrum`` inverts it."""
    from brutefir_tpu.ops.partconv import unpack_spectrum as jax_unpack
    from brutefir_tpu_torch.ops.partconv import (pack_spectrum,
                                                 unpack_spectrum)
    rng = np.random.default_rng(len(shape))
    hp = (rng.standard_normal(shape)
          + 1j * rng.standard_normal(shape)).astype(np.complex64)
    z = unpack_spectrum(hp)
    ref = jax_unpack(hp)
    assert z.shape == shape[:-1] + (shape[-1] + 1,) and z.dtype == np.complex64
    assert z.dtype == ref.dtype and np.array_equal(z, ref)
    assert not z[..., 0].imag.any() and not z[..., -1].imag.any()
    assert np.array_equal(pack_spectrum(z), hp)


@pytest.mark.parametrize("row2conf", [None, (2, -1, 0, 1)],
                         ids=["config-order", "permuted"])
@pytest.mark.parametrize("mode", MODES + ("dc_nyquist_imag",))
def test_freqd_tap_matches_jax(mode, row2conf):
    """One tap function on the same planes [4, 2, 64] and the same hooks:
    the port's (a tensor in, a tensor out) gives the JAX one's planes bit
    for bit, with the same calls; ``row2conf`` skips rows mapped to -1.
    Imaginary parts written into the DC and Nyquist bins are dropped in
    both."""
    from brutefir_tpu.runtime.engine import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    planes = np.random.default_rng(9).standard_normal(
        (4, 2, 64)).astype(np.float32)
    idx = np.array([3, 1, 0, 2])

    def make():
        if mode != "dc_nyquist_imag":
            return Hooks(("pre_convolve",), mode)
        h = Hooks(("pre_convolve",))

        def hook(buf, i):
            h.calls.append(("", "pre_convolve", i))
            buf[0] += 1j
            buf[-1] -= 2j
            buf[1] += 0.25j
        h.pre_convolve = hook
        return h

    hj, ht = make(), make()
    jfn = JaxEngine._make_freqd_tap(types.SimpleNamespace(_warming=False),
                                    [hj.pre_convolve], row2conf)
    tfn = Engine._make_freqd_tap([ht.pre_convolve], row2conf)
    ref = jfn(planes.copy(), idx)
    got = tfn(torch.from_numpy(planes.copy()), idx)
    assert got.dtype == torch.float32 and got.shape == planes.shape
    assert np.array_equal(got.numpy(), ref)
    assert ht.calls == hj.calls and ht.calls
    if mode == "read":
        assert np.array_equal(got.numpy(), planes)
    if mode == "dc_nyquist_imag":
        # only bin 1's change survives the packed layout
        moved = got.numpy() != planes
        assert moved.any() and not moved[:, :, 2:].any()
        assert not moved[:, 0, :].any()


# --- engines: the hooks' calls and buffers -------------------------------------

@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_hook_call_order_matches_jax(tmp_path, writable_jax_output_timed,
                                     topology):
    """All six hooks recording, 3 blocks run one at a time: the ordered
    list of (kind, id, shape, dtype, writable, contiguous) calls is the
    JAX engine's, block_start included, and the outputs agree. The port
    calls every hook but ``output_timed`` on the main thread, and that
    one on the writer thread (the JAX engine runs its taps on a thread
    of its runtime)."""
    make_text, C = TOPOLOGIES[topology]
    frames = N * 3
    _input(tmp_path, frames, C)
    (_, hj), (teng, ht) = run_pair(lambda t: make_text(tmp_path, t), Hooks,
                                   per_block=3)
    assert teng.dio is None
    assert [c[1:] for c in ht.calls] == [c[1:] for c in hj.calls]
    main = threading.main_thread().name
    assert all((c[0] == main) == (c[1] != "output_timed") for c in ht.calls)
    kinds = [c[1] for c in ht.calls]
    assert kinds.count("block_start") == 3
    assert kinds.count("post_convolve") == 3 * teng.spec.n_filters
    compare_outputs(tmp_path, frames, 2, with_int=(C == 3))


@pytest.mark.parametrize("kind", KINDS)
def test_hook_buffers_match_jax(tmp_path, writable_jax_output_timed,
                                kind):
    """One hook kind alone: it sees the JAX engine's buffers (``[N+1]``
    complex64 spectra, ``[N]`` float32 blocks, writable, C-contiguous)
    with the same ids, and one hook of any kind puts the port's engine on
    the host codec path, as the JAX engine."""
    frames = N * 2 + 37
    _input(tmp_path, frames, 3)
    (jeng, hj), (teng, ht) = run_pair(
        lambda t: single_config(tmp_path, t), lambda: Hooks((kind,)))
    assert jeng.dio is None and teng.dio is None
    assert (kind in FREQD) == bool(teng.taps) and teng._has_timed_hooks == (
        kind not in FREQD)
    seen = {c[3:] for c in ht.calls if c[1] == kind}
    assert seen == {c[3:] for c in hj.calls if c[1] == kind}
    assert seen == {((N + 1,) if kind in FREQD else (N,),
                     "complex64" if kind in FREQD else "float32",
                     True, True)}
    assert ht.by_kind() == hj.by_kind()
    assert ht.by_kind()[kind] == [0, 1, 2] * 3
    compare_outputs(tmp_path, frames, 2, with_int=True)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_hook_mutation_matches_jax(tmp_path, writable_jax_output_timed,
                                   kind, mode):
    """Each kind read-only and mutating (scale by a per-id gain, zero
    entry 5, zero everything) through run(): the port's outputs within
    the bounds of the JAX engine's, and the same ids in the same order
    for each kind."""
    frames = N * 4 + 101
    _input(tmp_path, frames, 3)
    (_, hj), (_, ht) = run_pair(lambda t: single_config(tmp_path, t),
                                lambda: Hooks((kind,), mode))
    assert ht.by_kind() == hj.by_kind()
    compare_outputs(tmp_path, frames, 2, with_int=True,
                    zero=(mode == "zero_all"))


def test_all_hooks_mutating_match_jax(tmp_path, monkeypatch,
                                      writable_jax_output_timed):
    """Every kind scaling at once, through run(): the gains multiply along
    each path in both packages, and the port never reaches the fused MAC
    + mix (it would raise here). The six gains multiply the level by up
    to 11, so the input is 0.02 of full scale: S24 peaks near 2^20, where
    float32 resolves the +-1 LSB bound (ROADMAP queue 3: content near
    full scale rounds at float32's ulp, 2 LSB, in both packages)."""
    from brutefir_tpu_torch.graph import compile as tcomp

    def refuse(*a, **k):
        raise AssertionError("fused MAC + mix under taps")

    monkeypatch.setattr(tcomp, "mac_mix", refuse)
    frames = N * 5 + 3
    _input(tmp_path, frames, 3, level=0.02)
    (_, hj), (teng, ht) = run_pair(lambda t: single_config(tmp_path, t),
                                   lambda: Hooks(KINDS, "scale"))
    assert ht.by_kind() == hj.by_kind() and len(ht.by_kind()) == 6
    assert sorted(teng.taps) == sorted(FREQD)
    compare_outputs(tmp_path, frames, 2, with_int=True)


@pytest.mark.parametrize("only", [None, {1}], ids=["all", "filter1"])
def test_pre_convolve_mutation_persists_in_ring(tmp_path, only):
    """Only block 0 carries signal: zeroing its pre_convolve spectra
    silences the block and its echoes in the later partitions, so the
    silenced filters' outputs stay 0 for every block (the tapped block is
    what the ring holds), the others as the JAX engine's."""
    frames = N * 7
    x = np.zeros((frames, 3), "<f4")
    x[:N] = np.random.default_rng(5).standard_normal((N, 3)) * 0.3
    x.tofile(tmp_path / "in.raw")
    (_, hj), (_, ht) = run_pair(lambda t: single_config(tmp_path, t),
                                lambda: Hooks(("pre_convolve",), "zero_all",
                                              only))
    yt = np.fromfile(tmp_path / "port_f.raw", "<f4").reshape(frames, 2)
    assert not yt[:, 1].any()
    if only is None:
        compare_outputs(tmp_path, frames, 2, with_int=True, zero=True)
    else:
        assert np.abs(yt[N * B:, 0]).max() > 0      # filter 0's echoes
        compare_outputs(tmp_path, frames, 2, with_int=True)


@pytest.mark.parametrize("mode", ["scale", "zero_all"])
def test_post_convolve_in_cascade_matches_jax(tmp_path, mode):
    """A two-stage cascade (stage 0 filters [1, 2], stage 1 [0]) with a
    post_convolve hook on filter 2 only: the ids run 1, 2, 0 a block in
    both packages, and the mutation reaches both filter 2's output and
    filter 0, which mixes filter 2's tapped spectra."""
    frames = N * 4 + 9
    _input(tmp_path, frames, 2)
    (_, hj), (_, ht) = run_pair(lambda t: cascade_config(tmp_path, t),
                                lambda: Hooks(("post_convolve",), mode, {2}))
    assert ht.by_kind() == hj.by_kind()
    assert ht.by_kind()["post_convolve"] == [1, 2, 0] * 5
    compare_outputs(tmp_path, frames, 2)
    if mode == "zero_all":
        y = np.fromfile(tmp_path / "port_f.raw", "<f4").reshape(frames, 2)
        assert not y[:, 1].any() and np.abs(y[:, 0]).max() > 0


@pytest.mark.parametrize("kind", ["pre_convolve", "post_convolve"])
def test_crossfade_under_hooks_matches_jax(tmp_path, monkeypatch, kind):
    """Two crossfading filters flipped every block by a CLI script with a
    per-filter gain hook: the port leaves the fused time-domain
    crossfade (it would raise here) for the stage loop's dual MAC and
    ``crossfade_spectra``, within the bounds of the JAX engine."""
    from brutefir_tpu_torch.graph import compile as tcomp

    def refuse(*a, **k):
        raise AssertionError("fused time-domain crossfade under taps")

    monkeypatch.setattr(tcomp, "_fused_xfade", refuse)
    frames = N * 5 + 77
    _input(tmp_path, frames, 2)
    (_, hj), (teng, ht) = run_pair(lambda t: xfade_config(tmp_path, t),
                                   lambda: Hooks((kind,), "scale"))
    assert ht.by_kind() == hj.by_kind()
    assert tcomp.fused_xfade_route(teng.spec, True)
    assert not tcomp.fused_xfade_route(teng.spec, True, teng.taps)
    compare_outputs(tmp_path, frames, 2)


@pytest.mark.parametrize("kind", KINDS)
def test_hooks_leave_the_device_path(tmp_path, kind):
    """Attaching one hook of any kind drops the device-IO path in both
    packages; a tap also turns the fused MAC + mix route off, which the
    same graph takes without it."""
    from brutefir_tpu_torch.graph import compile as tcomp
    _input(tmp_path, N, 3)
    engines = _engines(lambda t: single_config(tmp_path, t))
    for eng in engines:
        assert eng.dio is not None
        eng.logic.append(Hooks((kind,)))
        eng.attach_logic()
        assert eng.dio is None
    teng = engines[1]
    assert tcomp.fused_mix_route(teng.spec)
    assert tcomp.fused_mix_route(teng.spec, False, teng.taps) == (
        kind not in FREQD)


# --- external modules ---------------------------------------------------------

_LOGIC_MODULE = '''
import numpy as np
from {package}.control import register_logic_module

GAINS = np.array({gains})


class Spectral:
    instances = []

    def __init__(self, params, engine):
        self.engine = engine
        self.commands = []
        self.ids = []
        Spectral.instances.append(self)

    def post_convolve(self, buf, f):
        self.ids.append(f)
        buf *= GAINS[f]

    def command(self, params):
        self.commands.append(params)
        return True, f"spectral {{params}}\\n"


register_logic_module("{name}", Spectral)
'''


def _write_logic_module(directory, package, name):
    directory.mkdir(exist_ok=True)
    (directory / f"bflogic_{name}.py").write_text(_LOGIC_MODULE.format(
        package=package, name=name, gains=list(GAINS)))


@pytest.mark.parametrize("script", [False, True],
                         ids=["module-alone", "lmc-from-cli"])
def test_external_logic_module_matches_jax(tmp_path, capfd, script):
    """A ``bflogic_<name>.py`` on ``modules_path`` that differs from the
    JAX package's by its import line loads in both, scales each filter in
    ``post_convolve``, and (with a CLI script) gets ``lmc`` commands: the
    same ids, commands and outputs."""
    import sys
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    name = "spectral_" + re.sub(r"\W", "_", tmp_path.name)
    logic = f'logic: "{name}" {{ }};'
    if script:
        logic = (f'logic: "cli" {{ script: "lmc {name} hello\\nlmc 1 '
                 f'world"; echo: false; }}, "{name}" {{ }};')
    frames = N * 3 + 11
    _input(tmp_path, frames, 3)
    got = []
    for tag, pkg, E, parse, kw in (
            ("jax", "brutefir_tpu", JaxEngine, jax_parse_config, {}),
            ("port", "brutefir_tpu_torch", Engine, parse_config,
             {"device": CPU})):
        mods = tmp_path / f"mods_{tag}"
        _write_logic_module(mods, pkg, name)
        head = f'modules_path: "{mods}";\n{logic}'
        eng = E(parse(single_config(tmp_path, tag, head)), **kw)
        eng.run()
        inst = sys.modules[f"bflogic_{name}"].Spectral.instances[-1]
        assert inst.engine is eng and eng.dio is None
        got.append((inst.ids, inst.commands))
        del sys.modules[f"bflogic_{name}"]
    assert got[1] == got[0]
    assert got[1][0] == [0, 1, 2] * 4
    # the script's two lines repeat over the 4 blocks
    assert got[1][1] == (["hello", "world"] * 2 if script else [])
    if script:
        assert capfd.readouterr().err.count("spectral hello") == 4
    compare_outputs(tmp_path, frames, 2, with_int=True)


@pytest.mark.parametrize("modules_path", ["", "missing", "empty"])
def test_unknown_logic_module_raises_like_jax(tmp_path, modules_path):
    """A logic module no file on ``modules_path`` registers: the engine
    builds, and attaching (the first thing run() does) raises the JAX
    package's error."""
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    (tmp_path / "empty").mkdir()
    path = str(tmp_path / modules_path) if modules_path else ""
    _input(tmp_path, N, 3)
    head = f'modules_path: "{path}";\nlogic: "nosuch_module" {{ }};'
    errs = []
    for tag, E, parse, kw in (("jax", JaxEngine, jax_parse_config, {}),
                              ("port", Engine, parse_config,
                               {"device": CPU})):
        eng = E(parse(single_config(tmp_path, tag, head)), **kw)
        with pytest.raises(RuntimeError) as ei:
            eng.run()
        errs.append(str(ei.value))
    assert errs[1] == errs[0] == "unknown logic module: nosuch_module"


_IO_MODULE = '''
from brutefir_tpu_torch.io import IN, IoDevice, register_io_module
from brutefir_tpu_torch.io.file_module import parse_params


class Tee(IoDevice):
    uses_sample_clock = {clocked}
    opened = 0

    def __init__(self, params, io, sample_format, sample_rate,
                 open_channels):
        super().__init__(params, io, sample_format, sample_rate,
                         open_channels)
        self.path = parse_params(params)["path"]
        self.fh = None

    def init(self, period_size):
        Tee.opened += 1
        self.fh = open(self.path, "rb" if self.io == IN else "wb")

    def read(self, nbytes):
        return self.fh.read(nbytes)

    def write(self, data):
        return self.fh.write(data)

    def close(self):
        if self.fh is not None:
            self.fh.close()


register_io_module("{name}", Tee)
'''


def _io_config(tmp_path, in_dev, out_dev, out_name):
    return f"""
sampling_rate: 44100;
filter_length: {N},{B};
modules_path: "{tmp_path / 'mods'}";
coeff 0 {{ filename: "{tmp_path / 'h0.raw'}"; format: "FLOAT_LE"; }};
input 0 {{ device: "{in_dev}" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: 1; }};
output 0 {{ device: "{out_dev}" {{ path: "{tmp_path / out_name}"; }}; sample: "S24_4LE"; channels: 1; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
"""


@pytest.mark.parametrize("side", ["input", "output"])
def test_external_io_module_runs_through_main(tmp_path, capfd,
                                              monkeypatch, side):
    """A clockless ``bfio_<name>.py`` device on ``modules_path`` (plain
    file reads and writes, not batch safe) runs file to file through
    ``main()`` and ``run()``, word for word as the built-in file module;
    a clocked one runs through ``run()`` too (warmed, realtime refused
    here), word for word after a clocked output's 2 silent fragments."""
    import sys
    from brutefir_tpu_torch.__main__ import main
    from brutefir_tpu_torch.runtime.engine import Engine
    runs = []
    real_run = Engine.run
    monkeypatch.setattr(Engine, "run", lambda self, *a, **k: (
        runs.append(self.devices), real_run(self, *a, **k))[1])
    mods = tmp_path / "mods"
    mods.mkdir()
    name = "tee_" + re.sub(r"\W", "_", tmp_path.name)
    for suffix, clocked in (("", False), ("_clk", True)):
        (mods / f"bfio_{name}{suffix}.py").write_text(_IO_MODULE.format(
            name=name + suffix, clocked=clocked))
    _taps(tmp_path, 0)
    frames = N * 5 + 13
    np.round(np.random.default_rng(8).standard_normal(frames)
             * 2 ** 19).astype("<i4").tofile(tmp_path / "in.raw")
    devs = {"input": (name, "file"), "output": ("file", name)}[side]
    cfgs = {}
    for tag, (i, o) in (("ext", devs), ("file", ("file", "file")),
                        ("clk", (name + "_clk", "file"))):
        cfgs[tag] = tmp_path / f"{tag}.conf"
        cfgs[tag].write_text(_io_config(tmp_path, i, o, f"out_{tag}.raw"))
    assert main(["-quiet", "-nodefault", str(cfgs["ext"])], device=CPU) == 0
    assert sys.modules[f"bfio_{name}"].Tee.opened == 1 and len(runs) == 1
    assert main(["-quiet", "-nodefault", str(cfgs["file"])],
                device=CPU) == 0
    ext = np.fromfile(tmp_path / "out_ext.raw", "<i4")
    assert ext.size == frames and np.abs(ext).max() > 2 ** 16
    assert np.array_equal(ext, np.fromfile(tmp_path / "out_file.raw",
                                           "<i4"))
    capfd.readouterr()
    monkeypatch.setattr(os, "sched_setscheduler", _refuse, raising=False)
    assert main(["-quiet", "-nodefault", str(cfgs["clk"])],
                device=CPU) == 0
    assert len(runs) == 2
    assert np.array_equal(np.fromfile(tmp_path / "out_clk.raw", "<i4"),
                          ext)


def _refuse(*a, **k):
    raise PermissionError


def test_unknown_io_module_raises_like_jax(tmp_path):
    """An I/O module no ``bfio_<name>.py`` registers raises the JAX
    package's IoModuleError with its message."""
    from brutefir_tpu.io import IoModuleError as JaxIoModuleError
    from brutefir_tpu.io import get_io_module as jax_get
    from brutefir_tpu_torch.io import IoModuleError, get_io_module
    with pytest.raises(JaxIoModuleError) as ej:
        jax_get("nosuch_io", str(tmp_path))
    with pytest.raises(IoModuleError) as et:
        get_io_module("nosuch_io", str(tmp_path))
    assert str(et.value) == str(ej.value) == "unknown I/O module: nosuch_io"
    assert not os.listdir(tmp_path)
