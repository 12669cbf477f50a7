"""The port's sound-server modules (``io/sound_backends.py``) against the
fakes of the JAX package's tests, and engines over them against the JAX
engine.

ALSA runs against tests/fake_asound.c and PulseAudio against
tests/fake_pulse.c (compiled here with gcc, used as they are): real
ctypes dispatch, the fakes' error semantics and byte dumps of playback.
OSS runs on regular files with a recording stand-in for ``fcntl.ioctl``;
JACK's parameter parser and auto-connect run against a stand-in library.
Each test is the twin of one in tests/test_fake_alsa.py,
test_fake_pulse.py, test_fake_oss.py, test_backend_review_fixes.py or
test_review5_fixes.py. Engine runs go through the JAX engine and the
port's CPU engine on the same fake: the dumps are byte-equal with
``dither: false`` and within 2 LSB with dither on (ROADMAP queue 3: the
error feedback walks apart on float rounding). Two tests hold the port's
ALSA fixes: the noninterleaved read keeps each channel's own samples
through short reads, and the read/write calls return ``c_long``.

No test runs realtime: ``os.sched_setscheduler`` raises PermissionError
in every test here (autouse fixture), so ``mlockall`` never runs.
"""

import ctypes
import os
import struct
import subprocess

import numpy as np
import pytest
import torch

from brutefir_tpu.config import parse_config as jax_parse_config
from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.config.lexer import T, tokenize
from brutefir_tpu_torch.core.sampleformat import parse_sample_format
from brutefir_tpu_torch.errors import BF_EXIT_BUFFER_UNDERFLOW
from brutefir_tpu_torch.io import IoModuleError
from brutefir_tpu_torch.io import sound_backends as sb
from brutefir_tpu_torch.io.sound_backends import (AlsaDevice, JackDevice,
                                                  OssDevice, PulseDevice)
from brutefir_tpu_torch.runtime.engine import Engine

CPU = torch.device("cpu")
HERE = os.path.dirname(os.path.abspath(__file__))


def _raise_perm(*a, **k):
    raise PermissionError


@pytest.fixture(autouse=True)
def no_realtime(monkeypatch):
    """Keep the test process off SCHED_FIFO (and so off mlockall)."""
    monkeypatch.setattr(os, "sched_setscheduler", _raise_perm,
                        raising=False)


def _params(text):
    return [t for t in tokenize(text) if t.kind != T.EOF]


def _gcc(tmp_path_factory, src, name):
    out = tmp_path_factory.mktemp(name) / f"lib{name}.so"
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC",
                    os.path.join(HERE, src), "-o", str(out)], check=True)
    return str(out)


def _run_pair(conf_text, dump, reset, nblocks, capture=None):
    """The config through the JAX engine, then the port's CPU engine,
    each on a freshly reset fake; returns (JAX dump, port dump)."""
    from brutefir_tpu.runtime import Engine as JaxEngine
    dumps = []
    for make in (lambda: JaxEngine(_quiet(jax_parse_config(conf_text))),
                 lambda: Engine(_quiet(parse_config(conf_text)),
                                device=CPU)):
        reset()
        make().run(max_blocks=nblocks)
        dumps.append(dump.read_bytes() if capture is None else capture())
    return dumps


def _quiet(conf):
    conf.quiet = True
    return conf


# --- ALSA ------------------------------------------------------------------

@pytest.fixture(scope="module")
def fake_asound(tmp_path_factory):
    return _gcc(tmp_path_factory, "fake_asound.c", "fakeasound")


def _point_alsa(monkeypatch, cls, path, typed):
    """Point an AlsaDevice class at the fake (the port's through its
    ``_typed`` restypes) with clean process-global link state."""
    def load(c):
        lib = ctypes.CDLL(path)
        c._lib = AlsaDevice._typed(lib) if typed else lib
        return c._lib
    monkeypatch.setattr(cls, "_lib", None)
    monkeypatch.setattr(cls, "_asound",
                        classmethod(lambda c: c._lib or load(c)))
    monkeypatch.setattr(cls, "_base", None)
    monkeypatch.setattr(cls, "_link_setting", None)
    monkeypatch.setattr(cls, "_n_open", 0)


@pytest.fixture
def fake_alsa(fake_asound, tmp_path, monkeypatch):
    """Both packages' AlsaDevice on the fake; returns (log, dump, reset)
    where reset re-reads the environment (fresh log and dump)."""
    from brutefir_tpu.io.sound_backends import AlsaDevice as JaxAlsa
    log = tmp_path / "calls.log"
    dump = tmp_path / "dump.raw"
    monkeypatch.setenv("FAKE_ASOUND_LOG", str(log))
    monkeypatch.setenv("FAKE_ASOUND_DUMP", str(dump))
    monkeypatch.delenv("FAKE_ASOUND_XRUN", raising=False)
    _point_alsa(monkeypatch, AlsaDevice, fake_asound, True)
    _point_alsa(monkeypatch, JaxAlsa, fake_asound, False)

    def reset():
        ctypes.CDLL(fake_asound).fake_asound_reset()
    reset()
    return log, dump, reset


def _alsa(fmt="S16_LE", io=0, channels=2, ignore_xrun=False, link=None):
    text = f'device: "hw:0"; ignore_xrun: {str(ignore_xrun).lower()};'
    if link is not None:
        text += f" link: {str(link).lower()};"
    return AlsaDevice(_params(text), io, parse_sample_format(fmt), 44100,
                      channels)


def test_alsa_param_negotiation_sequence(fake_alsa):
    """hw/sw params in the reference's order (bfio_alsa.c:141-283)."""
    log, _, _ = fake_alsa
    dev = _alsa(fmt="S24_4LE", io=0, channels=3)
    dev.init(256)
    dev.synch_start()
    dev.close()
    lines = log.read_text().splitlines()
    assert lines[0].startswith("open name=hw:0 stream=1")
    assert lines[1:7] == ["hw_params_any", "set_access access=3",
                          "set_rate_near want=44100 got=44100",
                          "set_format format=6", "set_channels channels=3",
                          "set_period_size_near frames=256"]
    assert lines[7].startswith(
        "hw_params access=3 format=6 channels=3 rate=44100 period=256")
    assert lines[8] == "sw_params start=4294967295 stop=1024 avail_min=1"
    assert lines[9:] == ["prepare", "start", "close"]


def test_alsa_rate_near_tolerance(fake_alsa, monkeypatch):
    """Within 1% is accepted, beyond aborts (bfio_alsa.c:174-181)."""
    monkeypatch.setenv("FAKE_ASOUND_RATE", "44099")
    dev = _alsa(io=0)
    dev.init(64)
    dev.close()
    AlsaDevice._lib.fake_asound_reset()
    monkeypatch.setenv("FAKE_ASOUND_RATE", "48000")
    dev = _alsa(io=0)
    with pytest.raises(IoModuleError, match="suggested 48000"):
        dev.init(64)


def test_alsa_noninterleaved_fallback_roundtrip(fake_alsa, monkeypatch):
    """RW_INTERLEAVED refused: noninterleaved access through readn /
    writen, the same wire bytes as the interleaved mode."""
    log, dump, _ = fake_alsa
    monkeypatch.setenv("FAKE_ASOUND_ACCESS", "noninterleaved")
    din = _alsa(fmt="S24_LE", io=0, channels=3)
    din.init(64)
    raw = din.read(64 * 9)
    a = np.frombuffer(raw, np.uint8).reshape(64, 3, 3)
    assert a[0, 0, 0] == 0 and a[0, 1, 0] == 1 and a[0, 2, 0] == 2
    assert a[5, 0, 0] == 5 and not a[:, :, 1:].any()
    dout = _alsa(fmt="S24_LE", io=1, channels=3)
    dout.init(64)
    dout.write(raw)
    txt = log.read_text()
    assert "set_access access=3 -> -EINVAL" in txt
    assert "set_access access=4" in txt
    assert "readn frames=64" in txt and "writen frames=64" in txt
    assert dump.read_bytes() == raw
    din.close()
    dout.close()


def test_alsa_noninterleaved_write_xrun_restart(fake_alsa, monkeypatch):
    """writen xrun with ignore_xrun: prepare, then a restart after the
    next successful write (bfio_alsa.c:619-627)."""
    log, _, _ = fake_alsa
    monkeypatch.setenv("FAKE_ASOUND_ACCESS", "noninterleaved")
    monkeypatch.setenv("FAKE_ASOUND_XRUN", "w:2")
    dev = _alsa(io=1, ignore_xrun=True)
    dev.init(64)
    dev.synch_start()
    dev.write(b"\0" * 64 * 4)
    dev.write(b"\0" * 64 * 4)
    lines = log.read_text().splitlines()
    i = lines.index("writen frames=64 -> -EPIPE")
    assert lines[i + 1:i + 4] == ["prepare", "writen frames=64", "start"]
    assert AlsaDevice._lib.snd_pcm_state(dev.pcm) == 3
    dev.close()


def test_alsa_capture_pattern_roundtrip(fake_alsa):
    dev = _alsa(fmt="S16_LE", io=0, channels=2)
    dev.init(64)
    a = np.frombuffer(dev.read(64 * 4), "<i2").reshape(64, 2)
    assert a[0, 0] == 0 and a[0, 1] == 1 and a[5, 0] == 5 and a[5, 1] == 6
    b = np.frombuffer(dev.read(64 * 4), "<i2").reshape(64, 2)
    assert b[0, 0] == 64
    dev.close()


def test_alsa_xrun_recovery_with_ignore(fake_alsa, monkeypatch):
    """EPIPE on read with ignore_xrun: prepare + retry
    (bfio_alsa.c:555-586)."""
    log, _, _ = fake_alsa
    monkeypatch.setenv("FAKE_ASOUND_XRUN", "r:2")
    dev = _alsa(io=0, ignore_xrun=True)
    dev.init(64)
    dev.read(64 * 4)
    assert len(dev.read(64 * 4)) == 64 * 4
    txt = log.read_text()
    assert "-EPIPE" in txt and "prepare" in txt
    dev.close()


def test_alsa_xrun_abort_without_ignore(fake_alsa, monkeypatch):
    """EPIPE without ignore_xrun: the underflow exit code
    (dai.c:1292-1303)."""
    monkeypatch.setenv("FAKE_ASOUND_XRUN", "w:1")
    dev = _alsa(io=1, ignore_xrun=False)
    dev.init(64)
    with pytest.raises(IoModuleError) as ei:
        dev.write(b"\0" * 64 * 4)
    assert ei.value.exit_code == BF_EXIT_BUFFER_UNDERFLOW
    dev.close()


def test_alsa_linked_synchronous_start(fake_alsa):
    """Default link: the second handle joins the first's group and one
    start runs both (bfio_alsa.c:419-428, 469-486)."""
    log, _, _ = fake_alsa
    din, dout = _alsa(io=0), _alsa(io=1)
    din.init(64)
    dout.init(64)
    din.synch_start()
    dout.synch_start()
    lines = log.read_text().splitlines()
    assert sum(ln.startswith("link ") for ln in lines) == 1
    assert sum(ln == "start" for ln in lines) == 1
    assert AlsaDevice._lib.snd_pcm_state(din.pcm) == 3
    assert AlsaDevice._lib.snd_pcm_state(dout.pcm) == 3
    din.close()
    dout.close()


def test_alsa_link_false_starts_each_handle(fake_alsa):
    log, _, _ = fake_alsa
    din, dout = _alsa(io=0, link=False), _alsa(io=1, link=False)
    din.init(64)
    dout.init(64)
    din.synch_start()
    dout.synch_start()
    lines = log.read_text().splitlines()
    assert not any(ln.startswith("link ") for ln in lines)
    assert sum(ln == "start" for ln in lines) == 2
    din.close()
    dout.close()


def test_alsa_link_global_conflict_rejected(fake_alsa):
    _alsa(io=0, link=True)
    with pytest.raises(IoModuleError, match="global setting"):
        _alsa(io=1, link=False)


def test_alsa_failed_config_leaves_no_link_state(fake_alsa):
    """A config whose devices disagree on ``link:`` fails while its
    devices are built, before any handle opens, leaving the global link
    setting behind; the next engine clears it (``reset_module_state``,
    as the JAX engine calls it) and builds."""
    devs = ('input 0 {{ device: "alsa" {{ device: "hw:0"; link: {}; }}; '
            'sample: "S16_LE"; channels: 1; }};\n'
            'output 0 {{ device: "alsa" {{ device: "hw:0"; link: {}; }}; '
            'sample: "S16_LE"; channels: 1; dither: false; }};\n')
    text = ('sampling_rate: 44100;\nfilter_length: 128,2;\n'
            'coeff 0 { filename: "dirac pulse"; };\n{devs}'
            'filter 0 { from_inputs: 0; to_outputs: 0; coeff: 0; };\n')
    with pytest.raises(IoModuleError, match="global setting"):
        Engine(parse_config(text.replace(
            "{devs}", devs.format("true", "false"))), device=CPU)
    assert AlsaDevice._link_setting is True and AlsaDevice._n_open == 0
    eng = Engine(parse_config(text.replace(
        "{devs}", devs.format("false", "false"))), device=CPU)
    assert AlsaDevice._link_setting is False and len(eng.devices[1]) == 1


def _alsa_config(N, out_fmt, dither):
    return f"""
sampling_rate: 44100;
filter_length: {N},2;
coeff 0 {{ filename: "dirac pulse"; }};
input 0, 1 {{ device: "alsa" {{ device: "hw:0"; }}; sample: "S16_LE"; channels: 2; }};
output 0, 1 {{ device: "alsa" {{ device: "hw:0"; }}; sample: "{out_fmt}"; channels: 2; dither: {dither}; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_inputs: 1; to_outputs: 1; coeff: 0; }};
"""


def test_alsa_engine_end_to_end_matches_jax(fake_alsa):
    """alsa capture -> dirac -> alsa playback through both engines: the
    dumps byte-equal, 2 silent fragments of the iodelay fill, then the
    capture pattern (dai.c:1451-1457)."""
    log, dump, reset = fake_alsa
    N, nblocks = 128, 6
    jax_dump, dump_t = _run_pair(_alsa_config(N, "S16_LE", "false"), dump,
                                 reset, nblocks)
    assert dump_t == jax_dump
    out = np.frombuffer(dump_t, "<i2").reshape(-1, 2)
    assert out.shape[0] == (2 + nblocks) * N and not out[:2 * N].any()
    f = np.arange(nblocks * N)
    np.testing.assert_array_equal(out[2 * N:, 0], f & 0xFF)
    np.testing.assert_array_equal(out[2 * N:, 1], (f + 1) & 0xFF)
    assert "start" in log.read_text()


def test_alsa_dithered_engine_within_2_lsb_of_jax(fake_alsa):
    """S16 capture to dithered S24_4LE playback (the device-IO path's
    dither) through both engines: within 2 LSB, the dither noise on."""
    _, dump, reset = fake_alsa
    N, nblocks = 128, 6
    jd, td = _run_pair(_alsa_config(N, "S24_4LE", "true"), dump, reset,
                       nblocks)
    j = np.frombuffer(jd, "<i4").astype(np.int64)
    t = np.frombuffer(td, "<i4").astype(np.int64)
    assert j.size == t.size == (2 + nblocks) * N * 2
    assert np.abs(t - j).max() <= 2
    # against the dirac's output, the dither's band: its HP-TPDF noise
    # reaches 4.5 LSB (chip_smoke.HOST_DITHER_TOL)
    ref = (np.arange(nblocks * N)[:, None] + np.arange(2)) & 0xFF
    assert np.abs(t[4 * N:].reshape(-1, 2) - ref * 256).max() <= 5
    assert (t[4 * N:].reshape(-1, 2) != ref * 256).any()     # dithered


def test_alsa_underflow_exits_with_the_reference_code(fake_alsa,
                                                      monkeypatch, tmp_path):
    """A playback xrun without ignore_xrun ends main() with
    BF_EXIT_BUFFER_UNDERFLOW, as in the JAX package."""
    from brutefir_tpu_torch.__main__ import main
    monkeypatch.setenv("FAKE_ASOUND_XRUN", "w:4")
    cfg = tmp_path / "alsa.conf"
    cfg.write_text(_alsa_config(128, "S16_LE", "false"))
    assert main(["-quiet", "-nodefault", str(cfg)],
                device=CPU) == BF_EXIT_BUFFER_UNDERFLOW


class _ShortReads:
    """The fake library with readn/readi capped at ``cap`` frames a call,
    as a driver returns fewer frames than asked."""

    def __init__(self, lib, cap):
        self._lib, self._cap = lib, cap

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def snd_pcm_readn(self, pcm, bufs, frames):
        return self._lib.snd_pcm_readn(pcm, bufs, min(frames, self._cap))

    def snd_pcm_readi(self, pcm, buf, frames):
        return self._lib.snd_pcm_readi(pcm, buf, min(frames, self._cap))


@pytest.mark.parametrize("access", ["noninterleaved", "interleaved"])
def test_alsa_short_reads_keep_each_channel(fake_alsa, monkeypatch, access):
    """A driver returning 10 frames a call: the reads continue into each
    channel's plane (planes lie ``frames`` apart) and the port returns
    every channel's own samples, interleaved, in both access modes."""
    log, _, _ = fake_alsa
    if access == "noninterleaved":
        monkeypatch.setenv("FAKE_ASOUND_ACCESS", "noninterleaved")
    dev = _alsa(fmt="S16_LE", io=0, channels=3)
    dev.init(64)
    monkeypatch.setattr(AlsaDevice, "_lib", _ShortReads(AlsaDevice._lib, 10))
    for k in range(2):
        a = np.frombuffer(dev.read(64 * 6), "<i2").reshape(64, 3)
        f = np.arange(64 * k, 64 * (k + 1))[:, None] + np.arange(3)
        np.testing.assert_array_equal(a, f & 0xFF)
    calls = [ln for ln in log.read_text().splitlines()
             if ln.startswith(("readn", "readi"))]
    assert calls[:7] == [f"read{'n' if access[0] == 'n' else 'i'} "
                         f"frames={n}" for n in (10,) * 6 + (4,)]
    dev.close()


def test_alsa_frame_calls_return_long(fake_alsa):
    """snd_pcm_readi / readn / writei / writen return snd_pcm_sframes_t:
    the port's library has c_long restypes, the int getters keep int."""
    lib = AlsaDevice._asound()
    for fn in ("snd_pcm_readi", "snd_pcm_readn", "snd_pcm_writei",
               "snd_pcm_writen"):
        assert getattr(lib, fn).restype is ctypes.c_long
    assert lib.snd_pcm_hw_params_get_periods.restype is ctypes.c_int


def test_alsa_failed_getter_raises(fake_alsa, monkeypatch):
    """A hw-params getter that fails aborts the setup with IoModuleError,
    as a failed setter does (the JAX module ignores the getters' codes)."""
    class FailingGetter(_ShortReads):
        def snd_pcm_hw_params_get_buffer_size(self, hwp, frames):
            return -22
    dev = _alsa(io=1)
    monkeypatch.setattr(AlsaDevice, "_lib",
                        FailingGetter(AlsaDevice._asound(), 1 << 30))
    with pytest.raises(IoModuleError, match="buffer size.*error -22"):
        dev.init(64)
    assert dev.pcm is None


# --- PulseAudio --------------------------------------------------------------

@pytest.fixture(scope="module")
def fake_pulse_lib(tmp_path_factory):
    return _gcc(tmp_path_factory, "fake_pulse.c", "fakepulse")


def _point_pulse(monkeypatch, cls, path):
    def load(c):
        lib = ctypes.CDLL(path)
        lib.pa_simple_new.restype = ctypes.c_void_p
        c._lib = lib
        return lib
    monkeypatch.setattr(cls, "_lib", None)
    monkeypatch.setattr(cls, "_pulse", classmethod(lambda c: c._lib
                                                   or load(c)))


@pytest.fixture
def fake_pulse(fake_pulse_lib, tmp_path, monkeypatch):
    from brutefir_tpu.io.sound_backends import PulseDevice as JaxPulse
    log = tmp_path / "calls.log"
    dump = tmp_path / "dump.raw"
    monkeypatch.setenv("FAKE_PULSE_LOG", str(log))
    monkeypatch.setenv("FAKE_PULSE_DUMP", str(dump))
    monkeypatch.delenv("FAKE_PULSE_FAIL_NEW", raising=False)
    _point_pulse(monkeypatch, PulseDevice, fake_pulse_lib)
    _point_pulse(monkeypatch, JaxPulse, fake_pulse_lib)

    def reset():
        ctypes.CDLL(fake_pulse_lib).fake_pulse_reset()
    reset()
    return log, dump, reset


def _pulse(io=0, fmt="S16_LE", channels=2):
    return PulseDevice(_params('device: "mysink"; app_name: "bf-test";'),
                       io, parse_sample_format(fmt), 44100, channels)


def test_pulse_connection_parameters(fake_pulse):
    log, _, _ = fake_pulse
    dev = _pulse(io=0, fmt="S24_4LE", channels=3)
    dev.init(256)
    dev.close()
    lines = log.read_text().splitlines()
    assert lines[0] == ("new server=(default) name=bf-test dir=2 dev=mysink "
                        "stream=brutefir format=11 rate=44100 channels=3")
    assert lines[1] == "free"


def test_pulse_connection_refused(fake_pulse, monkeypatch):
    monkeypatch.setenv("FAKE_PULSE_FAIL_NEW", "1")
    with pytest.raises(IoModuleError,
                       match=r"pa_simple_new failed \(error 6\)"):
        _pulse(io=0).init(256)


def test_pulse_capture_pattern(fake_pulse):
    dev = _pulse(io=0, channels=2)
    dev.init(64)
    a = np.frombuffer(dev.read(64 * 4), "<i2").reshape(64, 2)
    assert a[0, 0] == 0 and a[7, 1] == 8
    b = np.frombuffer(dev.read(64 * 4), "<i2").reshape(64, 2)
    assert b[0, 0] == 64
    dev.close()


def test_pulse_engine_end_to_end_matches_jax(fake_pulse):
    """pulse in -> dirac -> pulse out through both engines: byte-equal
    dumps, the iodelay fill, and drain before free at teardown."""
    log, dump, reset = fake_pulse
    N, nblocks = 128, 5
    conf = f"""
sampling_rate: 44100;
filter_length: {N},2;
coeff 0 {{ filename: "dirac pulse"; }};
input 0, 1 {{ device: "pulse" {{ device: "mysource"; }}; sample: "S16_LE"; channels: 2; }};
output 0, 1 {{ device: "pulse" {{ device: "mysink"; }}; sample: "S16_LE"; channels: 2; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_inputs: 1; to_outputs: 1; coeff: 0; }};
"""
    jd, td = _run_pair(conf, dump, reset, nblocks)
    assert td == jd
    out = np.frombuffer(td, "<i2").reshape(-1, 2)
    assert out.shape[0] == (2 + nblocks) * N and not out[:2 * N].any()
    np.testing.assert_array_equal(out[2 * N:, 0],
                                  np.arange(nblocks * N) & 0xFF)
    txt = log.read_text().splitlines()
    assert txt.index("drain") < len(txt) - 1 - txt[::-1].index("free")


# --- OSS -------------------------------------------------------------------

class FakeIoctl:
    def __init__(self, refuse=None):
        self.calls = []
        self.refuse = refuse or {}

    def __call__(self, fd, request, arg=0, mutate_flag=True):
        val = struct.unpack("i", arg)[0]
        self.calls.append((fd, request, val))
        return struct.pack("i", self.refuse.get(request, val))


def _oss(path, fmt="S16_LE", io=0, channels=2):
    return OssDevice(_params(f'device: "{path}";'), io,
                     parse_sample_format(fmt), 44100, channels)


def test_oss_ioctl_negotiation(tmp_path, monkeypatch):
    import fcntl
    fake = FakeIoctl()
    monkeypatch.setattr(fcntl, "ioctl", fake)
    (tmp_path / "dsp").write_bytes(b"")
    dev = _oss(tmp_path / "dsp", fmt="S32_LE", io=0, channels=4)
    dev.init(128)
    assert [(r, v) for _, r, v in fake.calls] == [
        (OssDevice.SNDCTL_DSP_SETFMT, OssDevice.AFMT["S32_LE"]),
        (OssDevice.SNDCTL_DSP_CHANNELS, 4),
        (OssDevice.SNDCTL_DSP_SPEED, 44100)]
    dev.close()


def test_oss_refused_setting_aborts(tmp_path, monkeypatch):
    import fcntl
    monkeypatch.setattr(fcntl, "ioctl",
                        FakeIoctl(refuse={OssDevice.SNDCTL_DSP_SPEED: 48000}))
    (tmp_path / "dsp").write_bytes(b"")
    dev = _oss(tmp_path / "dsp", io=0)
    with pytest.raises(IoModuleError, match="refused"):
        dev.init(128)
    dev.close()


def test_oss_engine_end_to_end_matches_jax(tmp_path, monkeypatch):
    """oss in + oss out on files through both engines: byte-equal, the
    iodelay fill, then the input through a dirac bit-cleanly."""
    import fcntl
    monkeypatch.setattr(fcntl, "ioctl", FakeIoctl())
    N, C, nblocks = 128, 2, 5
    x = ((np.arange(N * nblocks * C) * 37) % 32749 - 16374).astype("<i2")
    inp, outp = tmp_path / "dsp_in", tmp_path / "dsp_out"
    x.tofile(inp)
    conf = f"""
sampling_rate: 44100;
filter_length: {N},2;
coeff 0 {{ filename: "dirac pulse"; }};
input 0, 1 {{ device: "oss" {{ device: "{inp}"; }}; sample: "S16_LE"; channels: {C}; }};
output 0, 1 {{ device: "oss" {{ device: "{outp}"; }}; sample: "S16_LE"; channels: {C}; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_inputs: 1; to_outputs: 1; coeff: 0; }};
"""
    jd, td = _run_pair(conf, outp, lambda: outp.write_bytes(b""),
                       nblocks + 2)
    assert td == jd
    out = np.frombuffer(td, "<i2")
    assert not out[:2 * N * C].any()
    np.testing.assert_array_equal(out[2 * N * C:], x)


# --- JACK (parameters and connections; no server here) ------------------------

def test_jack_ports_reference_syntax_parses():
    """ports: '"dest"/"local", ...' (bfio_jack.c:330-353)."""
    dev = JackDevice(_params('clientname: "bf"; ports: "system:playback_1"'
                             '/"left", "system:playback_2"/"right";'),
                     1, parse_sample_format("FLOAT_NE"), 44100, 2)
    assert dev._clientname == "bf"
    assert dev._connect == ["system:playback_1", "system:playback_2"]
    assert dev._portnames == ["left", "right"]


def test_jack_ports_without_local_names():
    dev = JackDevice(_params('ports: "a", "";'), 0,
                     parse_sample_format("FLOAT_NE"), 44100, 2)
    assert dev._connect == ["a", None]
    assert dev._portnames == [None, None]


class _FakeJackLib:
    def __init__(self, fail_on=None):
        self.connects = []
        self.fail_on = fail_on or set()

    def jack_activate(self, client):
        return 0

    def jack_port_name(self, port):
        return b"bf:port"

    def jack_connect(self, client, a, b):
        self.connects.append((a, b))
        return 1 if (a in self.fail_on or b in self.fail_on) else 0


def _jack_for_start(connect):
    dev = JackDevice.__new__(JackDevice)
    dev.io = 1
    dev._client = 1
    dev._ports = [1] * len(connect)
    dev._connect = connect
    return dev


def test_jack_unconnected_port_skips_not_breaks(monkeypatch):
    """An empty dest leaves that port unconnected; later ports connect
    (bfio_jack.c:534-536)."""
    fake = _FakeJackLib()
    monkeypatch.setattr(sb.JackDevice, "_jack", classmethod(lambda c: fake))
    _jack_for_start([None, "system:playback_1"]).start()
    assert fake.connects == [(b"bf:port", b"system:playback_1")]


def test_jack_failed_connect_is_fatal(monkeypatch):
    """A failed auto-connect aborts the start (bfio_jack.c:538-546)."""
    fake = _FakeJackLib(fail_on={b"nosuch:port"})
    monkeypatch.setattr(sb.JackDevice, "_jack", classmethod(lambda c: fake))
    with pytest.raises(IoModuleError, match="Could not connect"):
        _jack_for_start(["nosuch:port"]).start()
