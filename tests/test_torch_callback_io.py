"""The port's callback bridge (``io/callback.py``) and native realtime FIFO
(``core/native/rtfifo.py`` / ``rtfifo.cpp``), twins of
tests/test_callback_io.py and tests/test_native_rtfifo.py run against the
port, plus the FIFO's build: four processes building it into one fresh
directory at once, a failed build, and no compiler.

Engines run on the CPU. Clocked devices here keep the test process off
SCHED_FIFO (``os.sched_setscheduler`` raises PermissionError, autouse),
so ``mlockall`` never runs.
"""

import ctypes
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.core.native import rtfifo
from brutefir_tpu_torch.core.sampleformat import parse_sample_format
from brutefir_tpu_torch.io import IoDevice, register_io_module
from brutefir_tpu_torch.io.callback import CallbackDevice, _ByteFifo
from brutefir_tpu_torch.runtime.engine import Engine

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 256
K = 8
VALUE = 0.25


def _raise_perm(*a, **k):
    raise PermissionError


@pytest.fixture(autouse=True)
def no_realtime(monkeypatch):
    monkeypatch.setattr(os, "sched_setscheduler", _raise_perm,
                        raising=False)


# --- the callback bridge -------------------------------------------------------

class _CallbackIn(CallbackDevice):
    """A card's period thread delivering K blocks of VALUE, then the
    stream's end."""
    uses_sample_clock = False

    def __init__(self, params, io, sample_format, sample_rate, open_channels):
        super().__init__(params, io, parse_sample_format("FLOAT_NE"),
                         sample_rate, open_channels, periods=K + 2)

    def start(self):
        def feeder():
            block = np.full((N, self.open_channels), VALUE, np.float32)
            for _ in range(K):
                self.deliver_input(block.tobytes())
            self.stop_stream()

        threading.Thread(target=feeder, daemon=True).start()


class _CallbackOut(CallbackDevice):
    uses_sample_clock = False
    collected = b""
    done = False

    def __init__(self, params, io, sample_format, sample_rate, open_channels):
        super().__init__(params, io, parse_sample_format("FLOAT_NE"),
                         sample_rate, open_channels)
        _CallbackOut.collected = b""
        _CallbackOut.done = False

    def start(self):
        def puller():
            chunk = N * self.open_channels * 4
            while not _CallbackOut.done:
                _CallbackOut.collected += self.fetch_output(chunk)
                time.sleep(0.001)

        self._pth = threading.Thread(target=puller, daemon=True)
        self._pth.start()

    def stop(self):
        time.sleep(0.05)
        _CallbackOut.done = True
        self._pth.join(timeout=5.0)
        _CallbackOut.collected += self.fetch_output(self._fifo.capacity)
        super().stop_stream()


def test_callback_bridge_engine_run():
    register_io_module("t_testcb_in", _CallbackIn)
    register_io_module("t_testcb_out", _CallbackOut)
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},2;
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "t_testcb_in" {{ }}; sample: "FLOAT_NE"; channels: 1; }};
output 0 {{ device: "t_testcb_out" {{ }}; sample: "FLOAT_NE"; channels: 1; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    stats = Engine(conf, device=CPU).run()
    assert stats["frames"] == K * N
    out = np.frombuffer(_CallbackOut.collected, np.float32)
    vals = out[out != 0.0]
    assert len(vals) == K * N
    np.testing.assert_allclose(vals, VALUE, rtol=0, atol=1e-6)


def test_byte_fifo_overrun_drop_and_eof():
    f = _ByteFifo(8)
    assert f.push(b"abcdef", drop_oldest=True) == 0
    assert f.push(b"ghij", drop_oldest=True) == 2
    assert f.pop(8, pad_zeros=True) == (b"cdefghij", 0)
    assert f.pop(4, pad_zeros=True) == (b"\0\0\0\0", 4)
    f.push(b"xy", drop_oldest=True)
    f.close()
    assert f.pop(5)[0] == b"xy"


def test_setup_fires_synch_start_after_start(tmp_path):
    """setup(): init, the warm-up, start, the 2 silent fragments of the
    iodelay fill to the clocked output, then synch_start on every device
    (engine.py:781-797); teardown fires synch_stop."""
    calls = []

    class Synthetic(IoDevice):
        def init(self, period_size):
            calls.append(("init", self.io))

        def start(self):
            calls.append(("start", self.io))

        def synch_start(self):
            calls.append(("synch_start", self.io))

        def synch_stop(self):
            calls.append(("synch_stop", self.io))

        def read(self, nbytes):
            return b""

        def write(self, data):
            calls.append(("write", len(data)))
            return len(data)

    register_io_module("t_synthsync", Synthetic)
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: 128,2;
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "t_synthsync" {{}}; sample: "S16_LE"; channels: 1; }};
output 0 {{ device: "t_synthsync" {{}}; sample: "S16_LE"; channels: 1; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    conf.quiet = True
    eng = Engine(conf, device=CPU)
    steps = []
    real = eng.dio.step
    eng.dio.step = lambda *a, **k: (steps.append(len(calls)),
                                    real(*a, **k))[1]
    eng.setup()
    assert calls == [("init", 0), ("init", 1), ("start", 0), ("start", 1),
                     ("write", 256), ("write", 256), ("synch_start", 0),
                     ("synch_start", 1)]
    assert steps == [2, 2]        # the warm-up: after init, before start
    eng.teardown()
    assert ("synch_stop", 0) in calls and ("synch_stop", 1) in calls


def test_bridge_drain_underrun_stress():
    """A fast callback clock against a slow, bursty writer: no deadlock,
    every underrun counted, zeros only in between, every byte in order."""
    dev = CallbackDevice([], 1, None, 44100, 1, periods=2)
    dev.sample_format = parse_sample_format("S16_LE")
    dev.init(64)
    pulled = bytearray()
    stop = threading.Event()

    def clock():
        while not stop.is_set():
            pulled.extend(dev.fetch_output(64 * 2))
            time.sleep(0.0005)

    th = threading.Thread(target=clock, daemon=True)
    th.start()
    payload = bytes(range(1, 256)) * 64
    expected = bytearray()
    for i in range(40):
        chunk = payload[(i * 37) % 200: (i * 37) % 200 + 130]
        dev.write(chunk)
        expected += chunk
        if i % 7 == 0:
            time.sleep(0.004)
    time.sleep(0.03)
    stop.set()
    th.join(timeout=5.0)
    pulled.extend(dev.fetch_output(dev._fifo.capacity))
    assert bytes(b for b in pulled if b != 0) == bytes(expected)
    assert dev.underruns > 0
    dev.close()


def test_bridge_stop_stream_wakes_blocked_writer():
    dev = CallbackDevice([], 1, None, 44100, 1, periods=1)
    dev.sample_format = parse_sample_format("S16_LE")
    dev.init(32)
    dev.write(b"\1" * 64)
    done = threading.Event()

    def writer():
        dev.write(b"\2" * 64)
        done.set()

    th = threading.Thread(target=writer, daemon=True)
    th.start()
    time.sleep(0.1)
    assert not done.is_set()
    dev.stop_stream()
    assert done.wait(timeout=2.0)
    th.join(timeout=2.0)
    assert len(dev.read(128)) <= 64


# --- the native FIFO ----------------------------------------------------------

needs_gxx = pytest.mark.skipif(not rtfifo.available(),
                               reason="no C++ compiler here")


@needs_gxx
def test_ring_wraparound_and_partials():
    r = rtfifo.NativeRing(16)
    lib = rtfifo.lib()
    h = ctypes.c_void_p(r.handle)
    assert r.used() == 0
    assert lib.bf_ring_write(h, b"abcdefghij", 10) == 10 and r.used() == 10
    buf = ctypes.create_string_buffer(6)
    assert lib.bf_ring_read(h, buf, 6) == 6 and buf.raw == b"abcdef"
    assert lib.bf_ring_write(h, b"0123456789XY", 12) == 12
    assert r.used() == 16
    assert lib.bf_ring_write(h, b"zz", 2) == 0
    buf = ctypes.create_string_buffer(16)
    assert lib.bf_ring_read(h, buf, 16) == 16
    assert buf.raw == b"ghij0123456789XY"
    r.destroy()


GET_BUF = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32)


class FakeJack:
    """Owns planar port buffers and calls bf_jack_process as JACK's
    realtime thread would."""

    def __init__(self, n_ports, nframes):
        self.bufs = [np.zeros(nframes, np.float32) for _ in range(n_ports)]
        self.nframes = nframes
        self._cb = GET_BUF(lambda port, _n: self.bufs[int(port) - 1]
                           .ctypes.data)
        self.ports = (ctypes.c_void_p * n_ports)(
            *[ctypes.c_void_p(i + 1) for i in range(n_ports)])

    def ctx(self, io, ring):
        return rtfifo.lib().bf_jack_ctx_create(
            ctypes.cast(self._cb, ctypes.c_void_p), io, len(self.ports),
            self.ports, ctypes.c_void_p(ring.handle))

    def process(self, ctx):
        rtfifo.lib().bf_jack_process(ctypes.c_uint32(self.nframes),
                                     ctypes.c_void_p(ctx))


@needs_gxx
def test_capture_interleaves_and_counts_overruns():
    P, n = 2, 64
    fj = FakeJack(P, n)
    ring = rtfifo.NativeRing(2 * n * P * 4)
    ctx = fj.ctx(0, ring)
    fj.bufs[0][:] = np.arange(n, dtype=np.float32)
    fj.bufs[1][:] = -np.arange(n, dtype=np.float32)
    fj.process(ctx)
    frames = np.frombuffer(ring.read_blocking(n * P * 4),
                           np.float32).reshape(n, P)
    np.testing.assert_array_equal(frames[:, 0], fj.bufs[0])
    np.testing.assert_array_equal(frames[:, 1], fj.bufs[1])
    lib = rtfifo.lib()
    assert lib.bf_jack_ctx_xruns(ctypes.c_void_p(ctx)) == 0
    for _ in range(3):
        fj.process(ctx)
    assert lib.bf_jack_ctx_xruns(ctypes.c_void_p(ctx)) >= 1
    assert ring.used() % (P * 4) == 0
    lib.bf_jack_ctx_destroy(ctypes.c_void_p(ctx))
    ring.destroy()


@needs_gxx
def test_playback_deinterleaves_and_zero_fills():
    P, n = 3, 32
    fj = FakeJack(P, n)
    ring = rtfifo.NativeRing(4 * n * P * 4)
    ctx = fj.ctx(1, ring)
    frames = np.arange(n * P, dtype=np.float32).reshape(n, P)
    ring.write_blocking(frames.tobytes())
    fj.process(ctx)
    for c in range(P):
        np.testing.assert_array_equal(fj.bufs[c], frames[:, c])
    fj.process(ctx)
    lib = rtfifo.lib()
    assert lib.bf_jack_ctx_xruns(ctypes.c_void_p(ctx)) == 1
    for c in range(P):
        np.testing.assert_array_equal(fj.bufs[c], 0.0)
    lib.bf_jack_ctx_destroy(ctypes.c_void_p(ctx))
    ring.destroy()


@needs_gxx
def test_ring_threaded_stream_integrity():
    total = 1 << 20
    ring = rtfifo.NativeRing(4096)
    src = np.random.RandomState(0).bytes(total)
    t = threading.Thread(target=lambda: ring.write_blocking(src))
    t.start()
    out = ring.read_blocking(total)
    t.join()
    assert out == src
    ring.destroy()


_BUILD = """
import sys
from pathlib import Path
from brutefir_tpu_torch.core.native import rtfifo
rtfifo.BUILD_DIR = Path(sys.argv[1])
r = rtfifo.NativeRing(64)
assert r.used() == 0
r.destroy()
print(rtfifo.library_path())
"""


@needs_gxx
def test_concurrent_builds_all_load(tmp_path):
    """Four processes build the FIFO into one fresh directory at once:
    each compiles to a temporary name of its own and all four load the
    one library; no temporary file is left."""
    env = dict(os.environ, PYTHONPATH=REPO)
    d = tmp_path / "fresh"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(d)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=REPO)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    libs = {out.strip() for out, _ in outs}
    assert len(libs) == 1
    lib = libs.pop()
    assert os.path.dirname(lib) == str(d)
    assert os.listdir(d) == [os.path.basename(lib)]


@needs_gxx
def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    from brutefir_tpu_torch.core.native import NativeBuildError
    monkeypatch.setattr(rtfifo, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(rtfifo, "CXX_FLAGS",
                        rtfifo.CXX_FLAGS + ["-fno-such-flag-here"])
    monkeypatch.setattr(rtfifo, "_lib", None)
    assert rtfifo.available()
    with pytest.raises(NativeBuildError, match="no-such-flag"):
        rtfifo.NativeRing(64)
    assert os.listdir(tmp_path) == []


def test_no_compiler_means_not_available(tmp_path, monkeypatch):
    """No built library and no compiler on PATH: available() is False, so
    the JACK module takes the Python FIFO bridge; nothing was built at
    import."""
    monkeypatch.setattr(rtfifo, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(rtfifo, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not rtfifo.available()
    assert os.listdir(tmp_path) == []
