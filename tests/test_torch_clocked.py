"""The clocked ``run()`` of the port on the CPU: a paced ``bfio_`` device
(``chip_smoke.PACED_MODULE``, ``uses_sample_clock = True``: reads wait
for each fragment's due time at fs, writes record their lateness), poll
mode, the realtime request, the iodelay fill, the warm-up, the rti echo,
the drift abort, the stall watchdog, sink mode and ``main()``.

Engines run at N = 64 x 2 partitions with 2 channels. Against the JAX
engine on the same paced device and input: byte-equal with ``dither:
false``, within 2 LSB with dither on (ROADMAP queue 3). Against the same
config's file run: the paced output after its 2N silent frames is
byte-equal, dither on, so the warm-up moved no persistent state.

No test runs realtime: ``os.sched_setscheduler`` raises PermissionError
in every test here (autouse fixture), so ``mlockall`` never runs; the
tests of the realtime request replace ``ctypes.CDLL(None)``'s
``mlockall`` by a recorder.
"""

import importlib.util
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from brutefir_tpu.config import parse_config as jax_parse_config
from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.io import IoDevice, register_io_module
from brutefir_tpu_torch.runtime import engine as engine_mod
from brutefir_tpu_torch.runtime import program as program_mod
from brutefir_tpu_torch.runtime.engine import Engine, EngineError

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B, C = 64, 2, 2
BLOCKS = 9


def _raise_perm(*a, **k):
    raise PermissionError


@pytest.fixture(autouse=True)
def no_realtime(monkeypatch):
    monkeypatch.setattr(os, "sched_setscheduler", _raise_perm,
                        raising=False)


def _paced_text():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs.PACED_MODULE


PACED = _paced_text()


def _modules(tmp_path):
    """bfio_paced.py for the port in mods/, the JAX package's version
    (its imports swapped) in jmods/."""
    paths = {}
    for name, text in (("mods", PACED),
                       ("jmods", PACED.replace("brutefir_tpu_torch.",
                                               "brutefir_tpu."))):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        (d / "bfio_paced.py").write_text(text)
        paths[name] = d
    return paths


def _setup(tmp_path, frames=BLOCKS * N + 17, seed=5, level=2.0 ** 20):
    """Seeded taps (FLOAT_LE) and an S24_4LE input of ``frames`` frames
    with std ``level``."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal(N * B) * np.exp(-np.arange(N * B) / 40.0)
    (0.5 * h / np.linalg.norm(h)).astype("<f4").tofile(tmp_path / "h.raw")
    x = np.round(rng.standard_normal((frames, C)) * level).astype("<i4")
    x.tofile(tmp_path / "in.raw")
    return x


def _config(tmp_path, mods, dev_in="paced", dev_out="paced",
            out_fmt="S24_4LE", dither="false", out="out.raw", extra="",
            in_fmt="S24_4LE", crossfade="false", dirac=False,
            scale="0.5"):
    coeff = ('"dirac pulse";' if dirac
             else f'"{tmp_path / "h.raw"}"; format: "FLOAT_LE";')
    return f"""
sampling_rate: 44100;
filter_length: {N},{B};
modules_path: "{mods}";
{extra}
coeff 0 {{ filename: {coeff} }};
input 0, 1 {{ device: "{dev_in}" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "{in_fmt}"; channels: {C}; }};
output 0, 1 {{ device: "{dev_out}" {{ path: "{tmp_path / out}"; }}; sample: "{out_fmt}"; channels: {C}; dither: {dither}; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; crossfade: {crossfade}; }};
filter 1 {{ from_inputs: 1/{scale}; to_outputs: 1; coeff: 0; }};
"""


def _engine(text, quiet=True):
    conf = parse_config(text)
    conf.quiet = quiet
    return Engine(conf, device=CPU)


def _words(path, fmt):
    if fmt == "S24_BE":
        b = np.fromfile(path, np.uint8).reshape(-1, 3).astype(np.int64)
        w = (b[:, 0] << 16) | (b[:, 1] << 8) | b[:, 2]
        return w - ((w & 0x800000) << 1)
    return np.fromfile(path, "<i4").astype(np.int64)


# --- the iodelay fill, the setup, main() --------------------------------------

@pytest.mark.parametrize("quiet", [False, True])
def test_iodelay_fill_and_its_message(tmp_path, capfd, quiet):
    """Two silent fragments precede the audio on a clocked output, and
    the "Fixed I/O-delay" message names 2N samples unless quiet
    (engine.py:864-888); every input frame comes out after them."""
    mods = _modules(tmp_path)["mods"]
    x = _setup(tmp_path)
    eng = _engine(_config(tmp_path, mods), quiet=quiet)
    stats = eng.run()
    err = capfd.readouterr().err
    msg = f"Fixed I/O-delay is {2 * N} samples\nAudio processing starts now"
    assert (msg in err) != quiet
    y = _words(tmp_path / "out.raw", "S24_4LE").reshape(-1, C)
    assert y.shape[0] == x.shape[0] + 2 * N and not y[:2 * N].any()
    assert np.abs(y[2 * N:]).max() > 2 ** 16
    assert stats["frames"] == x.shape[0]
    assert stats["blocks"] == BLOCKS + 1


def test_main_runs_a_clocked_config(tmp_path, capfd):
    """main() runs a config with clocked devices through run() and exits
    0: the paced output is the file run's output after 2N silent frames."""
    from brutefir_tpu_torch.__main__ import main
    mods = _modules(tmp_path)["mods"]
    _setup(tmp_path)
    paced, plain = tmp_path / "paced.conf", tmp_path / "file.conf"
    paced.write_text(_config(tmp_path, mods))
    plain.write_text(_config(tmp_path, mods, "file", "file",
                             out="out_file.raw"))
    assert main(["-nodefault", str(paced)], device=CPU) == 0
    err = capfd.readouterr().err
    assert "Fixed I/O-delay is 128 samples" in err and "Finished:" in err
    assert main(["-quiet", "-nodefault", str(plain)], device=CPU) == 0
    y = _words(tmp_path / "out.raw", "S24_4LE")
    assert np.array_equal(y[2 * N * C:],
                          _words(tmp_path / "out_file.raw", "S24_4LE"))


@pytest.mark.parametrize("dither, dirac, tol", [("false", True, 0),
                                                ("true", True, 2),
                                                ("false", False, 1)])
def test_clocked_engine_matches_jax(tmp_path, dither, dirac, tol):
    """The same paced config through the JAX engine and the port's:
    through a dirac byte-equal without dither and within 2 LSB with it
    (ROADMAP queue 3), at an input level whose float32 round trip is
    exact (std 2^12, unit gains, as the fakes' patterns); through seeded
    taps at std 2^20 within the float rounding's 1 LSB."""
    from brutefir_tpu.runtime import Engine as JaxEngine
    mods = _modules(tmp_path)
    x = _setup(tmp_path, level=2.0 ** 12 if dirac else 2.0 ** 20)
    outs = []
    for eng, name in (
            (lambda t: JaxEngine(jax_parse_config(t)), "jmods"),
            (lambda t: Engine(parse_config(t), device=CPU), "mods")):
        e = eng(_config(tmp_path, mods[name], dither=dither,
                        out=f"out_{name}.raw", dirac=dirac,
                        scale="0" if dirac else "0.5"))
        e.conf.quiet = True
        e.run()
        outs.append(_words(tmp_path / f"out_{name}.raw", "S24_4LE"))
    assert outs[0].size == outs[1].size == (x.shape[0] + 2 * N) * C
    assert np.abs(outs[1] - outs[0]).max() <= tol
    assert np.abs(outs[1]).max() > 2 ** 12


@pytest.mark.parametrize("out_fmt", ["S24_4LE", "S24_BE"])
def test_warmup_leaves_no_trace(tmp_path, out_fmt):
    """Dithered outputs, a crossfading filter (four warm-up variants):
    after its 2N silent frames the paced run is byte-equal to the same
    config's file run, which has no warm-up, on the device-IO path
    (``dstate`` restored) and on the host path (S24_BE: the graph only,
    through the step programs' ``step_impl``, no read_block /
    write_block)."""
    mods = _modules(tmp_path)["mods"]
    _setup(tmp_path)
    steps = []
    real = program_mod.step_impl
    outs = {}
    for dev in ("paced", "file"):
        eng = _engine(_config(tmp_path, mods, dev, dev, out_fmt=out_fmt,
                              dither="true", out=f"out_{dev}.raw",
                              crossfade="true"))
        assert (eng.dio is None) == (out_fmt == "S24_BE")
        if eng.dio is not None:
            real_dio = eng.dio.step
            eng.dio.step = (lambda *a, _r=real_dio, **k:
                            (steps.append(dev), _r(*a, **k))[1])
        else:
            program_mod.step_impl = (lambda *a, **k:
                                     (steps.append(dev), real(*a, **k))[1])
        try:
            eng.run()
        finally:
            program_mod.step_impl = real
        outs[dev] = _words(tmp_path / f"out_{dev}.raw", out_fmt)
    assert steps.count("paced") == steps.count("file") + 4
    assert not outs["paced"][:2 * N * C].any()
    assert np.array_equal(outs["paced"][2 * N * C:], outs["file"])


class _Spectra:
    def __init__(self, params, engine):
        self.calls = []
        self.blocks = []

    def input_freqd(self, buf, ch):
        self.calls.append(("input_freqd", ch))

    def output_freqd(self, buf, ch):
        self.calls.append(("output_freqd", ch))

    def block_start(self, k):
        self.blocks.append(k)


def test_freqd_hooks_never_see_the_warmup(tmp_path):
    """Frequency-domain hooks on a clocked engine, a crossfading filter:
    the warm-up's four steps run the taps silenced (``_warming``), so each
    hook is called once a channel a real block, and block_start once a
    block."""
    mods = _modules(tmp_path)["mods"]
    x = _setup(tmp_path)
    eng = _engine(_config(tmp_path, mods, crossfade="true"))
    mod = _Spectra([], eng)
    eng.logic.append(mod)
    taps = []
    real = Engine._make_freqd_tap

    def counted(hooks, row2conf=None, warming=None):
        fn = real(hooks, row2conf, warming)
        return lambda planes, idx, *host: (taps.append(warming()),
                                           fn(planes, idx, *host))[1]

    eng._make_freqd_tap = counted
    stats = eng.run()
    blocks = -(-x.shape[0] // N)
    assert stats["blocks"] == blocks
    assert mod.calls.count(("input_freqd", 0)) == blocks
    assert len(mod.calls) == 2 * C * blocks
    assert mod.blocks == list(range(blocks))
    assert taps.count(True) == 2 * 4 and taps.count(False) == 2 * blocks


# --- the realtime request ----------------------------------------------------------

class _FakeLibc:
    calls = []

    def mlockall(self, flags):
        _FakeLibc.calls.append(flags)
        return 0


@pytest.mark.parametrize("lock_memory", ["true", "false"])
def test_realtime_request(tmp_path, monkeypatch, capfd, lock_memory):
    """SCHED_FIFO at priority 4, then mlockall(MCL_CURRENT | MCL_FUTURE)
    under lock_memory (engine.py:890-913), after the warm-up; a refused
    priority warns and locks nothing. ``realtime_state`` records it."""
    import ctypes
    mods = _modules(tmp_path)["mods"]
    _setup(tmp_path)
    text = _config(tmp_path, mods, extra=f"lock_memory: {lock_memory};")
    eng = _engine(text)
    eng.setup()
    eng.teardown()
    assert "failed to set realtime priority" in capfd.readouterr().err
    assert eng.realtime_state == {"sched_fifo": False}

    asked = []
    monkeypatch.setattr(os, "sched_setscheduler",
                        lambda pid, pol, prm: asked.append(
                            (pid, pol, prm.sched_priority)))
    real_cdll = ctypes.CDLL
    monkeypatch.setattr(ctypes, "CDLL", lambda name, *a, **k: (
        _FakeLibc() if name is None else real_cdll(name, *a, **k)))
    _FakeLibc.calls = []
    eng = _engine(text)
    eng.setup()
    eng.teardown()
    assert asked == [(0, os.SCHED_FIFO, 4)]
    if lock_memory == "true":
        assert _FakeLibc.calls == [3]
        assert eng.realtime_state["mlockall"] == 0
        assert eng.realtime_state["vmrss_kib"] > 0
    else:
        assert _FakeLibc.calls == []
        assert eng.realtime_state == {"sched_fifo": True}


def test_clockless_config_neither_warms_nor_goes_realtime(tmp_path):
    mods = _modules(tmp_path)["mods"]
    _setup(tmp_path)
    eng = _engine(_config(tmp_path, mods, "file", "file"))
    steps = []
    real = eng.dio.step
    eng.dio.step = lambda *a, **k: (steps.append(1), real(*a, **k))[1]
    eng.setup()
    eng.teardown()
    assert steps == [] and eng.realtime_state == {}


# --- poll mode -------------------------------------------------------------------

class _PollIn(IoDevice):
    """A clocked input that cannot signal period boundaries: it hands out
    at most 50 frames' bytes a call, and nothing on every third call."""
    uses_sample_clock = True
    bad_alignment = True
    data = b""

    def init(self, period_size):
        self.pos = 0
        self.calls = 0

    def read(self, nbytes):
        raise AssertionError("poll mode reads with read_nonblock")

    def read_nonblock(self, nbytes):
        self.calls += 1
        if self.calls % 3 == 1:
            return None
        chunk = _PollIn.data[self.pos:self.pos + min(nbytes, 50 * 8)]
        self.pos += len(chunk)
        return chunk


register_io_module("t_pollin", _PollIn)


@pytest.mark.parametrize("allow", [False, True])
def test_poll_mode(tmp_path, capfd, allow):
    """Every clocked input misaligned: refused without allow_poll_mode
    (the JAX text), else "Input poll mode activated" and reads paced by
    the sleep tiers, the input intact through the graph."""
    mods = _modules(tmp_path)["mods"]
    x = _setup(tmp_path)
    _PollIn.data = x.tobytes()
    text = _config(tmp_path, mods, "t_pollin", "file",
                   extra=f"allow_poll_mode: {str(allow).lower()};",
                   out="out_poll.raw")
    if not allow:
        with pytest.raises(EngineError) as ei:
            _engine(text, quiet=False)
        assert str(ei.value) == (
            "sound input hardware requires poll mode to be activated but "
            "current configuration does not allow it (allow_poll_mode: "
            "false;)")
        return
    eng = _engine(text, quiet=False)
    assert "Input poll mode activated" in capfd.readouterr().err
    eng.run()
    assert eng.devices[0][0].calls > 2 * BLOCKS
    _engine(_config(tmp_path, mods, "file", "file")).run()
    assert np.array_equal(_words(tmp_path / "out_poll.raw", "S24_4LE"),
                          _words(tmp_path / "out.raw", "S24_4LE"))


# --- the rti echo, the drift abort ------------------------------------------------

class _FakeClock:
    """The engine's ``time``: perf_counter advances ``step`` seconds a
    call; monotonic and sleep are the real ones."""

    def __init__(self, step):
        self.t = 0.0
        self.step = step
        self.monotonic = time.monotonic
        self.sleep = time.sleep

    def perf_counter(self):
        self.t += self.step
        return self.t


def test_rti_echo(tmp_path, monkeypatch, capfd):
    """show_progress: an rti line on stderr after each second of wall
    time (engine.py:1599-1607); before full processing (B + 1 live
    blocks) the no-update line."""
    mods = _modules(tmp_path)["mods"]
    _setup(tmp_path, frames=6 * N)
    monkeypatch.setattr(engine_mod, "time", _FakeClock(0.3))
    _engine(_config(tmp_path, mods, "file", "file"), quiet=False).run()
    lines = [ln for ln in capfd.readouterr().err.splitlines()
             if ln.startswith("rti:")]
    # 7 periods of 1.2 s of the engine's clock: 6 blocks and the EOF read
    rti = 3 * 0.3 / (N / 44100)
    assert lines[:B] == ["rti: not full processing - no rti update"] * B
    assert lines[B:] == [f"rti: {rti:.3f}"] * (7 - B)


def test_rti_echo_silent_when_quiet(tmp_path, monkeypatch, capfd):
    mods = _modules(tmp_path)["mods"]
    _setup(tmp_path, frames=4 * N)
    monkeypatch.setattr(engine_mod, "time", _FakeClock(0.3))
    _engine(_config(tmp_path, mods, "file", "file"), quiet=True).run()
    assert "rti:" not in capfd.readouterr().err


@pytest.mark.parametrize("clocked", [True, False])
def test_rate_drift_abort(tmp_path, monkeypatch, clocked):
    """monitor_rate on a clocked input: blocks that take 1.2 s of the
    engine's clock each are a rate far below 44.1 kHz, and the run aborts
    after 4 s with the JAX text (engine.py:1608-1620); a clockless input
    is never monitored."""
    mods = _modules(tmp_path)["mods"]
    _setup(tmp_path)
    dev = "paced" if clocked else "file"
    eng = _engine(_config(tmp_path, mods, dev, "file",
                          extra="monitor_rate: true;"))
    monkeypatch.setattr(engine_mod, "time", _FakeClock(0.3))
    if not clocked:
        assert eng.run()["blocks"] == BLOCKS + 1
        return
    with pytest.raises(EngineError, match=r"^sample rate drift detected: "
                       r"measured \d+ Hz, configured 44100 Hz$"):
        eng.run()
    assert eng.blockcounter == 4       # 4.8 s of the engine's clock


# --- the watchdog, the xrun report --------------------------------------------------

_STALL = """
import sys, time, torch
from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.io import IoDevice, register_io_module
from brutefir_tpu_torch.runtime.engine import Engine


class Stall(IoDevice):
    uses_sample_clock = False
    reads = 0

    def read(self, nbytes):
        Stall.reads += 1
        if Stall.reads > 2:
            time.sleep(120)
        return bytes(nbytes)

    def write(self, data):
        return len(data)


register_io_module("stall", Stall)
conf = parse_config(sys.argv[1])
conf.quiet = True
Engine(conf, device=torch.device("cpu")).run()
print("returned")
"""


def test_watchdog_ends_a_stalled_run(tmp_path):
    """BRUTEFIR_TPU_WATCHDOG=1: the input stalls after two blocks, and
    the process exits 1 with the JAX message (engine.py:1234-1257)."""
    text = f"""
sampling_rate: 44100;
filter_length: {N},{B};
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "stall" {{ }}; sample: "S16_LE"; channels: 1; }};
output 0 {{ device: "stall" {{ }}; sample: "S16_LE"; channels: 1; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
"""
    env = dict(os.environ, PYTHONPATH=REPO, BRUTEFIR_TPU_WATCHDOG="1")
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-c", _STALL, text],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=100)
    assert r.returncode == 1, r.stderr
    assert ("no block completed for 1 s (stalled device or transport); "
            "aborting.") in r.stderr
    assert "returned" not in r.stdout and time.monotonic() - t0 < 90


def test_teardown_reports_xruns(tmp_path, capfd):
    """A callback device's underruns are reported at teardown
    (engine.py:915-931), unless quiet."""
    from brutefir_tpu_torch.io.callback import CallbackDevice

    class XrunOut(CallbackDevice):
        uses_sample_clock = False

        def write(self, data):
            self.underruns += 1
            return len(data)

    register_io_module("t_xrunout", XrunOut)
    mods = _modules(tmp_path)["mods"]
    _setup(tmp_path, frames=3 * N)
    text = _config(tmp_path, mods, "file", "t_xrunout", out_fmt="FLOAT_LE")
    for quiet in (False, True):
        _engine(text, quiet=quiet).run()
        err = capfd.readouterr().err
        assert ('Warning: 3 xrun(s) on output device "XrunOut"' in err) \
            != quiet


# --- sink mode ---------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["S32_LE", "S32_BE"])
def test_sink_mode_stats_and_prefetch(tmp_path, fmt):
    """Sink mode (no sample leaves the device): the block and frame
    counts and the EOF tail of a normal run; with max_blocks the
    producer stops there (it reads 3 blocks, not 4). S32_LE runs the
    device-IO path with the prefetch pool, S32_BE the host path's
    zero-staging encode."""
    rng = np.random.default_rng(7)
    frames = 8 * 256 + 100
    np.round(rng.standard_normal((frames, 2)) * 1e6).astype(
        "<i4").tofile(tmp_path / "in.raw")
    text = f"""
sampling_rate: 44100;
filter_length: 256,4;
coeff 0 {{ filename: "dirac pulse"; }};
input 0,1 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "{fmt}"; channels: 2; }};
output 0,1 {{ device: "file" {{ path: "/dev/null"; }}; sample: "{fmt}"; channels: 2; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_inputs: 1; to_outputs: 1; coeff: 0; }};
"""
    eng = _engine(text)
    assert (eng.dio is None) == (fmt == "S32_BE")
    stats = eng.run(sink_output=True)
    assert stats["blocks"] == 9 and stats["frames"] == frames
    eng2 = _engine(text)
    reads = []
    dev = eng2.devices[0][0]
    real = dev.read
    dev.read = lambda n: (reads.append(n), real(n))[1]
    stats2 = eng2.run(max_blocks=3, sink_output=True)
    assert stats2["blocks"] == 3 and stats2["frames"] == 3 * 256
    assert len(reads) == 3


def test_sink_mode_drains_every_n_blocks(tmp_path, monkeypatch):
    """BRUTEFIR_TPU_DRAIN_EVERY=2: the writer waits for the newest result
    every second block and once at the end, never fetching it."""
    waits = []
    monkeypatch.setattr(engine_mod, "_wait_for", waits.append)
    monkeypatch.setenv("BRUTEFIR_TPU_DRAIN_EVERY", "2")
    mods = _modules(tmp_path)["mods"]
    _setup(tmp_path, frames=5 * N)
    eng = _engine(_config(tmp_path, mods, "file", "file"))
    eng._write_outputs = None          # a fetch would fail
    stats = eng.run(sink_output=True)
    assert stats["blocks"] == 5 and len(waits) == 3
    assert all(isinstance(w, list) for w in waits)
