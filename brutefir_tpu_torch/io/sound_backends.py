"""Realtime sound-server I/O modules: alsa, oss, jack, pulse.

Host-side backends mirroring the reference's dlopen'd modules
(`bfio_alsa.c`, `bfio_oss.c`, `bfio_jack.c`, `bfio_pulse.c`). The engine's
compute path is identical for all backends; these differ only in device
setup and the blocking read/write calls.

* ``alsa``: ctypes bindings to libasound (snd_pcm blocking API). Parameters
  ``device:``, ``ignore_xrun:``, ``link:`` (snd_pcm_link'd handles with a
  single sample-synchronous base start, bfio_alsa.c:419-428,469-486;
  default true like the reference). Recovers from xruns with
  prepare+restart when ``ignore_xrun`` is set, matching
  bfio_alsa.c:555-586. Full hw-params negotiation with an
  interleaved -> noninterleaved access fallback (bfio_alsa.c:149-166);
  noninterleaved devices are driven with snd_pcm_readn/writen over
  per-channel planes (bfio_alsa.c:541-553,606-618).
* ``oss``: /dev/dsp ioctl setup (SNDCTL_DSP_*) with plain read/write.
* ``jack``: a real ctypes libjack client over the callback FIFO bridge
  (io/callback.py) -- JACK owns the clock, the engine's blocking pipeline
  rides the bridge. Gated on libjack's presence with a clear error.
* ``pulse``: blocking libpulse-simple client; gated on the library's
  presence with a clear error, like the others.

All four register so configs referencing them parse and fail with a clear
message only when the host lacks the library.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import sys

from ..config.lexer import T
from ..errors import BF_EXIT_BUFFER_UNDERFLOW, BF_EXIT_INVALID_INPUT
from . import IoDevice, IoModuleError, register_io_module, IN
from .callback import CallbackDevice


def _parse_fields(params, spec):
    """Generic module-parameter parser: spec maps field -> token kind."""
    out = {}
    i = 0

    def need(kind):
        nonlocal i
        if i >= len(params) or params[i].kind != kind:
            raise IoModuleError("parse error in module parameters")
        t = params[i]
        i += 1
        return t

    while i < len(params):
        f = need(T.FIELD).value
        if f not in spec:
            raise IoModuleError(f"unknown field {f}")
        out[f] = need(spec[f]).value
        need(T.EOS)
    return out


class AlsaDevice(IoDevice):
    """Blocking ALSA PCM device through libasound (bfio_alsa.c analog).

    ``link:`` is a process-global setting (default true, like the
    reference's ``link_handles``, bfio_alsa.c:59,330-350): the first
    opened handle becomes the base, later handles are snd_pcm_link'd to
    it (bfio_alsa.c:419-428), and synch_start starts only the base --
    the linked handles start in sample sync (bfio_alsa.c:469-486).

    Hardware parameters are negotiated with the full hw_params API in
    the reference's order (bfio_alsa.c:141-283): access (interleaved,
    falling back to noninterleaved), rate (set_rate_near with the
    reference's 1% tolerance window), format, channels, >=2 periods
    with the halve-until-two-periods loop, then sw params pinning an
    explicit-start threshold and a full-buffer stop threshold. A
    noninterleaved device is read/written through snd_pcm_readn/writen
    with per-channel plane pointers and re-/de-interleaved host-side so
    the engine always sees the interleaved wire layout.
    """

    _lib = None
    # process-global link state (the reference's link_handles/base_handle)
    _base = None          # the base AlsaDevice instance
    _link_setting = None  # None until any device block sets `link:`
    _n_open = 0

    @classmethod
    def reset_module_state(cls):
        """Clear stale link state left by a FAILED config build (an
        __init__ parse error raises before any handle opens, so close()
        never runs the all-closed reset). Called by the engine before
        constructing a config's devices; a live engine's link group
        (open handles) is never touched."""
        if cls._n_open == 0:
            cls._base = None
            cls._link_setting = None

    @classmethod
    def _asound(cls):
        if cls._lib is None:
            name = ctypes.util.find_library("asound")
            if name is None:
                raise IoModuleError(
                    "ALSA I/O: libasound not found on this host")
            cls._lib = cls._typed(ctypes.CDLL(name))
        return cls._lib

    @staticmethod
    def _typed(lib):
        """Give the read and write calls their snd_pcm_sframes_t (long)
        return type: ctypes' default int would cut it to 32 bits."""
        for fn in ("snd_pcm_readi", "snd_pcm_readn", "snd_pcm_writei",
                   "snd_pcm_writen"):
            getattr(lib, fn).restype = ctypes.c_long
        return lib

    # snd_pcm_format_t values (asoundlib.h)
    _FMT = {"S8": 0, "S16_LE": 2, "S16_BE": 3, "S24_LE": 32, "S24_BE": 33,
            "S24_4LE": 6, "S24_4BE": 7, "S32_LE": 10, "S32_BE": 11,
            "FLOAT_LE": 14, "FLOAT_BE": 15, "FLOAT64_LE": 16, "FLOAT64_BE": 17}

    def __init__(self, params, io, sample_format, sample_rate, open_channels):
        super().__init__(params, io, sample_format, sample_rate, open_channels)
        opts = _parse_fields(params, {"device": T.STRING,
                                      "ignore_xrun": T.BOOLEAN,
                                      "link": T.BOOLEAN})
        self.device = opts.get("device", "default")
        self.ignore_xrun = opts.get("ignore_xrun", False)
        if "link" in opts:
            want = bool(opts["link"])
            if (AlsaDevice._link_setting is not None
                    and AlsaDevice._link_setting != want):
                raise IoModuleError(
                    'ALSA I/O: "link" is a global setting, if set on '
                    "more than one device, the value must be the same")
            AlsaDevice._link_setting = want
        self.pcm = None
        self._frame_bytes = None
        self._is_base = False
        self._linked = False
        self._interleaved = True
        self._restart = False
        if sample_format is None:
            raise IoModuleError(
                "ALSA I/O: AUTO sample format negotiation requires opening "
                "the device; set an explicit format")

    def _set_hw_sw_params(self, lib, pcm, period_size):
        """Full hw/sw-params negotiation, bfio_alsa.c set_params
        (bfio_alsa.c:141-283) in the same order: access with the
        noninterleaved fallback, rate_near + 1% window, format,
        channels, >=2 periods (halving the period size until the
        device gives at least two), explicit-start / full-buffer-stop
        sw thresholds, prepare."""

        def chk(rc, what):
            if rc < 0:
                raise IoModuleError(
                    f'ALSA I/O: could not set audio parameters for '
                    f'"{self.device}": {what} (error {rc})')

        hwp = ctypes.c_void_p()
        chk(lib.snd_pcm_hw_params_malloc(ctypes.byref(hwp)), "alloc")
        try:
            chk(lib.snd_pcm_hw_params_any(pcm, hwp),
                "no hardware configuration available")
            # SND_PCM_ACCESS_RW_INTERLEAVED=3, RW_NONINTERLEAVED=4
            if lib.snd_pcm_hw_params_set_access(pcm, hwp, 3) < 0:
                chk(lib.snd_pcm_hw_params_set_access(pcm, hwp, 4),
                    "failed to set interleaved and non-interleaved "
                    "access mode")
                self._interleaved = False
            else:
                self._interleaved = True
            # set_rate_near, accepting a minor variation
            # (bfio_alsa.c:167-181: ens1371-style near rates within 1%)
            un = ctypes.c_uint(self.sample_rate)
            chk(lib.snd_pcm_hw_params_set_rate_near(
                pcm, hwp, ctypes.byref(un), None),
                f"failed to set sample rate to {self.sample_rate} Hz")
            got = un.value
            if got != self.sample_rate and not (
                    int(self.sample_rate * 0.99) < got
                    < int(self.sample_rate / 0.99)):
                raise IoModuleError(
                    f"ALSA I/O: failed to set sample rate to "
                    f"{self.sample_rate} Hz, device suggested {got} Hz "
                    f"instead")
            fmt = self._FMT[self.sample_format.name]
            chk(lib.snd_pcm_hw_params_set_format(pcm, hwp, fmt),
                f"failed to set sample format to {self.sample_format.name}")
            chk(lib.snd_pcm_hw_params_set_channels(
                pcm, hwp, self.open_channels),
                f"failed to set channel count to {self.open_channels}")
            chk(lib.snd_pcm_hw_params_get_periods_max(
                hwp, ctypes.byref(un), None),
                "failed to get the maximum number of periods")
            if un.value < 2:
                raise IoModuleError(
                    f"ALSA I/O: hardware does not support enough periods "
                    f"(at least 2 required, device supports {un.value})")
            # period size near the software fragment; halve until the
            # device yields >= 2 periods (bfio_alsa.c:203-225)
            ps = ctypes.c_ulong(period_size)
            lib.snd_pcm_hw_params_set_period_size_near(
                pcm, hwp, ctypes.byref(ps), None)
            chk(lib.snd_pcm_hw_params_get_periods(
                hwp, ctypes.byref(un), None),
                "failed to get the number of periods")
            try_ps = ps.value
            while un.value == 1 and try_ps != 0:
                try_ps //= 2
                ps.value = try_ps
                lib.snd_pcm_hw_params_set_period_size_near(
                    pcm, hwp, ctypes.byref(ps), None)
                chk(lib.snd_pcm_hw_params_get_periods(
                    hwp, ctypes.byref(un), None),
                    "failed to get the number of periods")
            if ps.value == 0:
                raise IoModuleError("ALSA I/O: could not set period size")
            chk(lib.snd_pcm_hw_params(pcm, hwp),
                "unable to install hw params")
            bufsz = ctypes.c_ulong(0)
            chk(lib.snd_pcm_hw_params_get_buffer_size(
                hwp, ctypes.byref(bufsz)), "failed to get the buffer size")
        finally:
            lib.snd_pcm_hw_params_free(hwp)

        swp = ctypes.c_void_p()
        chk(lib.snd_pcm_sw_params_malloc(ctypes.byref(swp)), "alloc")
        try:
            chk(lib.snd_pcm_sw_params_current(pcm, swp), "sw params")
            # start only when explicitly told so (bfio_alsa.c:229-236);
            # stop when the buffer underflows (bfio_alsa.c:238-246)
            chk(lib.snd_pcm_sw_params_set_start_threshold(
                pcm, swp, ctypes.c_ulong(0xFFFFFFFF)),
                "failed to set start threshold")
            chk(lib.snd_pcm_sw_params_set_stop_threshold(pcm, swp, bufsz),
                "failed to set stop threshold")
            chk(lib.snd_pcm_sw_params_set_avail_min(
                pcm, swp, ctypes.c_ulong(1)),
                "failed to set min avail")
            chk(lib.snd_pcm_sw_params(pcm, swp),
                "unable to install sw params")
        finally:
            lib.snd_pcm_sw_params_free(swp)
        chk(lib.snd_pcm_prepare(pcm), "unable to prepare audio")

    def init(self, period_size):
        lib = self._asound()
        pcm = ctypes.c_void_p()
        stream = 1 if self.io == IN else 0  # SND_PCM_STREAM_CAPTURE=1
        rc = lib.snd_pcm_open(ctypes.byref(pcm), self.device.encode(),
                              stream, 0)
        if rc < 0:
            raise IoModuleError(
                f'ALSA I/O: could not open "{self.device}" (error {rc})')
        self.pcm = pcm
        if self.sample_format.name not in self._FMT:
            raise IoModuleError(
                f"ALSA I/O: unsupported format {self.sample_format.name}")
        try:
            self._set_hw_sw_params(lib, pcm, period_size)
        except IoModuleError:
            lib.snd_pcm_close(pcm)
            self.pcm = None
            raise
        self._frame_bytes = self.sample_format.bytes * self.open_channels
        if AlsaDevice._link_setting in (None, True):
            # linked synchronous start (bfio_alsa.c:419-428): the first
            # handle is the base, later handles join its link group
            if AlsaDevice._base is None:
                AlsaDevice._base = self
                self._is_base = True
            else:
                rc = lib.snd_pcm_link(AlsaDevice._base.pcm, pcm)
                if rc < 0:
                    lib.snd_pcm_close(pcm)
                    self.pcm = None
                    raise IoModuleError(
                        f"ALSA I/O: could not link alsa devices "
                        f"(error {rc})")
                self._linked = True
        AlsaDevice._n_open += 1

    def _plane_ptrs(self, base, frames, done):
        """Per-channel plane pointer array for readn/writen: plane c is
        ``frames`` samples at base + c*plane_bytes, advanced ``done``
        samples into each plane (bfio_alsa.c:541-547 pointer setup)."""
        sb = self.sample_format.bytes
        plane = frames * sb
        addr = ctypes.addressof(base)
        return (ctypes.c_void_p * self.open_channels)(
            *[addr + c * plane + done * sb
              for c in range(self.open_channels)])

    def read(self, nbytes):
        lib = self._asound()
        frames = nbytes // self._frame_bytes
        buf = ctypes.create_string_buffer(nbytes)
        got = 0
        while got < frames:
            if self._interleaved:
                rc = lib.snd_pcm_readi(
                    self.pcm, ctypes.byref(buf, got * self._frame_bytes),
                    frames - got)
            else:
                rc = lib.snd_pcm_readn(
                    self.pcm, self._plane_ptrs(buf, frames, got),
                    frames - got)
            if rc < 0:
                if self.ignore_xrun and rc == -32:  # EPIPE: xrun
                    lib.snd_pcm_prepare(self.pcm)
                    # capture: PREPARED does not auto-start below the
                    # explicit start threshold, so the next read would
                    # block forever -- restart (bfio_alsa.c:555-586)
                    lib.snd_pcm_start(self.pcm)
                    continue
                # errno contract of dai.c:1279-1310: EPIPE = overflow/
                # underflow abort, EIO = invalid signal on the input
                raise IoModuleError(
                    f"ALSA I/O: read failed (error {rc})",
                    exit_code=(BF_EXIT_BUFFER_UNDERFLOW if rc == -32
                               else BF_EXIT_INVALID_INPUT if rc == -5
                               else None))
            got += rc
        if self._interleaved or got == 0:
            return buf.raw[: got * self._frame_bytes]
        # planes -> interleaved wire layout (the engine's contract); the
        # planes lie ``frames`` samples apart (_plane_ptrs), so a short
        # read keeps the first ``got`` samples of each
        import numpy as np
        sb = self.sample_format.bytes
        planes = np.frombuffer(buf.raw[: frames * self._frame_bytes],
                               np.uint8).reshape(
            self.open_channels, frames, sb)[:, :got]
        return planes.transpose(1, 0, 2).tobytes()

    def write(self, data):
        lib = self._asound()
        frames = len(data) // self._frame_bytes
        buf = bytes(data)
        if not self._interleaved:
            # interleaved engine layout -> per-channel planes
            import numpy as np
            sb = self.sample_format.bytes
            planar = np.frombuffer(buf, np.uint8).reshape(
                frames, self.open_channels, sb).transpose(1, 0, 2)
            nbuf = ctypes.create_string_buffer(planar.tobytes(), len(buf))
        done = 0
        while done < frames:
            if self._interleaved:
                rc = lib.snd_pcm_writei(
                    self.pcm, buf[done * self._frame_bytes:], frames - done)
            else:
                rc = lib.snd_pcm_writen(
                    self.pcm, self._plane_ptrs(nbuf, frames, done),
                    frames - done)
            if rc < 0:
                if self.ignore_xrun and rc == -32:
                    lib.snd_pcm_prepare(self.pcm)
                    # playback: with the explicit start threshold the
                    # prepared stream never auto-restarts; arm a restart
                    # after the next successful write, like the
                    # reference's bfio_write hack (bfio_alsa.c:619-627)
                    self._restart = True
                    continue
                raise IoModuleError(
                    f"ALSA I/O: write failed (error {rc}), buffer underflow",
                    exit_code=(BF_EXIT_BUFFER_UNDERFLOW if rc == -32
                               else None))
            done += rc
            if self._restart:
                self._restart = False
                lib.snd_pcm_start(self.pcm)
        return len(data)

    def synch_start(self):
        if self.pcm is None:
            return
        if self._linked:
            # rides the base handle's linked start (bfio_alsa.c:469-486)
            return
        lib = self._asound()
        if lib.snd_pcm_state(self.pcm) == 3:  # SND_PCM_STATE_RUNNING
            return  # already auto-started (bfio_alsa.c:457-467)
        lib.snd_pcm_start(self.pcm)

    def close(self):
        if self.pcm is not None:
            self._asound().snd_pcm_close(self.pcm)
            self.pcm = None
            AlsaDevice._n_open = max(0, AlsaDevice._n_open - 1)
            if self._is_base:
                AlsaDevice._base = None
            if AlsaDevice._n_open == 0:
                # all handles released: forget the process-global link
                # state so a fresh engine in the same process (tests)
                # starts clean -- the reference never closes, so this
                # has no reference analog
                AlsaDevice._base = None
                AlsaDevice._link_setting = None


class OssDevice(IoDevice):
    """OSS /dev/dsp device (bfio_oss.c analog): ioctl setup, plain rw."""

    # soundcard.h ioctls (x86-64)
    SNDCTL_DSP_SETFMT = 0xC0045005
    SNDCTL_DSP_CHANNELS = 0xC0045006
    SNDCTL_DSP_SPEED = 0xC0045002
    AFMT = {"S8": 0x00000040, "S16_LE": 0x00000010, "S16_BE": 0x00000020,
            "S32_LE": 0x00001000, "S32_BE": 0x00002000}

    def __init__(self, params, io, sample_format, sample_rate, open_channels):
        super().__init__(params, io, sample_format, sample_rate, open_channels)
        opts = _parse_fields(params, {"device": T.STRING})
        self.device = opts.get("device", "/dev/dsp")
        self.fd = None
        if sample_format is None:
            raise IoModuleError("OSS I/O: no support for AUTO sample format")
        if sample_format.name not in self.AFMT:
            raise IoModuleError(
                f"OSS I/O: unsupported format {sample_format.name}")

    def init(self, period_size):
        import fcntl
        import struct
        flags = os.O_RDONLY if self.io == IN else os.O_WRONLY
        # wrap raw OS errors into the module's typed error so the CLI
        # exit-code contract holds (a missing /dev/dsp must print a
        # clean message, not a traceback -- bfio_oss.c error paths)
        try:
            self.fd = os.open(self.device, flags)
        except OSError as e:
            raise IoModuleError(
                f"OSS I/O: could not open {self.device}: {e.strerror}"
            ) from None
        for req, val in ((self.SNDCTL_DSP_SETFMT,
                          self.AFMT[self.sample_format.name]),
                         (self.SNDCTL_DSP_CHANNELS, self.open_channels),
                         (self.SNDCTL_DSP_SPEED, self.sample_rate)):
            buf = struct.pack("i", val)
            try:
                res = fcntl.ioctl(self.fd, req, buf)
            except OSError as e:
                raise IoModuleError(
                    f"OSS I/O: ioctl {req:#x} failed: {e.strerror}"
                ) from None
            got = struct.unpack("i", res)[0]
            if got != val:
                raise IoModuleError(
                    f"OSS I/O: device refused setting {req:#x} "
                    f"(wanted {val}, got {got})")

    def read(self, nbytes):
        out = bytearray()
        while len(out) < nbytes:
            try:
                chunk = os.read(self.fd, nbytes - len(out))
            except OSError as e:
                raise IoModuleError(
                    f"OSS I/O: read failed: {e.strerror}") from None
            if not chunk:
                break
            out += chunk
        return bytes(out)

    def write(self, data):
        # OSS drivers may accept a partial buffer; a dropped tail would
        # shear the channel interleave for the rest of the stream --
        # loop until everything is written (like AlsaDevice.write)
        buf = bytes(data)
        done = 0
        while done < len(buf):
            try:
                n = os.write(self.fd, buf[done:])
            except OSError as e:
                raise IoModuleError(
                    f"OSS I/O: write failed: {e.strerror}") from None
            if n == 0:
                # some OSS emulation layers return 0 on a full buffer
                # instead of blocking; retrying would busy-spin forever
                raise IoModuleError(
                    "OSS I/O: write returned 0 bytes (device stalled)")
            done += n
        return done

    def close(self):
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None


class JackDevice(CallbackDevice):
    """JACK client through ctypes libjack (bfio_jack.c analog).

    JACK owns the clock: its process callback moves planar float32 port
    buffers through the CallbackDevice FIFO bridge, and the engine's
    blocking pipeline runs against that (SURVEY 3.3). Parameters:
    ``clientname:`` (default "brutefir"), ``ports:`` accepted like the
    reference (connection targets are applied after activate, best
    effort). The sample format is JACK's: FLOAT_NE, one port per open
    channel. A sample-rate mismatch with the config aborts, as upstream.
    """

    _lib = None
    _SHUTDOWN_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
    _PROC_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_uint32,
                                ctypes.c_void_p)

    @classmethod
    def _jack(cls):
        if cls._lib is None:
            name = ctypes.util.find_library("jack")
            if name is None:
                raise IoModuleError(
                    "JACK I/O: libjack is not available on this host; "
                    "use the file, alsa or oss modules")
            lib = ctypes.CDLL(name)
            lib.jack_client_open.restype = ctypes.c_void_p
            lib.jack_port_register.restype = ctypes.c_void_p
            lib.jack_port_get_buffer.restype = ctypes.c_void_p
            lib.jack_get_sample_rate.restype = ctypes.c_uint32
            lib.jack_port_name.restype = ctypes.c_char_p
            cls._lib = lib
        return cls._lib

    def __init__(self, params, io, sample_format, sample_rate,
                 open_channels):
        from ..core.sampleformat import parse_sample_format
        fmt = parse_sample_format("FLOAT_NE")
        if sample_format is not None and sample_format.name != fmt.name:
            raise IoModuleError(
                "JACK I/O: sample format must be FLOAT_NE (JACK is "
                "32-bit float)")
        super().__init__(params, io, fmt, sample_rate, open_channels)
        # ports: one entry per open channel, '"dest"[/"local_name"]'
        # comma-separated (bfio_jack.c:330-353) -- the generic
        # field parser cannot express the SLASH pairs
        self._clientname = "brutefir"
        self._connect = []     # per-channel connection target (or None)
        self._portnames = []   # per-channel local port name (or None)
        i = 0

        def tk(kind):
            nonlocal i
            if i >= len(params) or params[i].kind != kind:
                raise IoModuleError(
                    "JACK I/O: parse error in module parameters")
            t = params[i]
            i += 1
            return t

        while i < len(params) and params[i].kind != T.EOF:
            f = tk(T.FIELD).value
            if f == "clientname":
                self._clientname = tk(T.STRING).value
                tk(T.EOS)
            elif f == "ports":
                for n in range(open_channels):
                    self._connect.append(tk(T.STRING).value or None)
                    local = None
                    if i < len(params) and params[i].kind == T.SLASH:
                        i += 1
                        local = tk(T.STRING).value or None
                    self._portnames.append(local)
                    tk(T.COMMA if n < open_channels - 1 else T.EOS)
            else:
                raise IoModuleError(f"unknown field {f}")
        self._client = None
        self._ports = []
        self._cb_ref = None
        self._nring = None
        self._nctx = None

    def init(self, period_size: int) -> None:
        super().init(period_size)
        import numpy as np
        lib = self._jack()
        status = ctypes.c_int(0)
        self._client = lib.jack_client_open(
            self._clientname.encode(), 0, ctypes.byref(status))
        if not self._client:
            raise IoModuleError("JACK I/O: could not connect to a JACK "
                                "server (is jackd running?)")
        srate = lib.jack_get_sample_rate(ctypes.c_void_p(self._client))
        if int(srate) != self.sample_rate:
            raise IoModuleError(
                f"JACK I/O: server rate {int(srate)} != configured "
                f"{self.sample_rate}")
        # engine input captures FROM jack => JackPortIsInput on our side
        flags = 1 if self.io == IN else 2
        audio_type = b"32 bit float mono audio"
        for ch in range(self.open_channels):
            name = (self._portnames[ch] if ch < len(self._portnames)
                    and self._portnames[ch] else
                    f"{'in' if self.io == IN else 'out'}_{ch}")
            port = lib.jack_port_register(
                ctypes.c_void_p(self._client), name.encode(),
                audio_type, ctypes.c_ulong(flags), ctypes.c_ulong(0))
            if not port:
                raise IoModuleError("JACK I/O: port registration failed")
            self._ports.append(port)

        # server-death handling (the reference registers a shutdown
        # callback, bfio_jack.c): close the rings so blocking engine
        # reads/writes end instead of hanging forever on a dead server
        def on_shutdown(_arg):
            sys.stderr.write("JACK I/O: server shut down\n")
            try:
                self.stop_stream()
            except Exception:
                pass

        self._shutdown_ref = self._SHUTDOWN_CB(on_shutdown)
        lib.jack_on_shutdown(ctypes.c_void_p(self._client),
                             self._shutdown_ref, None)

        # Realtime path: prefer the native C process callback + SPSC ring
        # (core/native/rtfifo.cpp) -- no Python (and no GIL) in JACK's
        # realtime thread, like the reference's bfio_jack.c. Fallback:
        # the ctypes->Python callback over the byte-FIFO bridge.
        from ..core.native import rtfifo as _rt
        self._nring = None
        self._nctx = None
        if _rt.available():
            rtlib = _rt.lib()
            framebytes = 4 * self.open_channels
            self._nring = _rt.NativeRing(
                max(1, self._periods) * period_size * framebytes)
            ports_arr = (ctypes.c_void_p * len(self._ports))(
                *[ctypes.c_void_p(p) for p in self._ports])
            get_buf = ctypes.cast(lib.jack_port_get_buffer,
                                  ctypes.c_void_p)
            self._nctx = rtlib.bf_jack_ctx_create(
                get_buf, 0 if self.io == IN else 1, len(self._ports),
                ports_arr, ctypes.c_void_p(self._nring.handle))
            if self._nctx:
                cb = ctypes.cast(rtlib.bf_jack_process, ctypes.c_void_p)
                lib.jack_set_process_callback(
                    ctypes.c_void_p(self._client), cb,
                    ctypes.c_void_p(self._nctx))
            else:
                # ctx refused (e.g. > MAX_PORTS): the Python fallback
                # callback feeds the byte-FIFO, so the engine must NOT
                # keep polling the orphaned native ring
                self._nring = None
        if not self._nctx:
            dev = self
            np_ = np

            def process(nframes, _arg):
                n = int(nframes)
                bufs = [lib.jack_port_get_buffer(ctypes.c_void_p(p),
                                                 ctypes.c_uint32(n))
                        for p in dev._ports]
                planes = [np_.ctypeslib.as_array(
                    ctypes.cast(b, ctypes.POINTER(ctypes.c_float)), (n,))
                    for b in bufs]
                if dev.io == IN:
                    frame = np_.stack(planes, axis=1)  # [n, ch] interleaved
                    dev.deliver_input(frame.tobytes())
                else:
                    raw = dev.fetch_output(n * dev.open_channels * 4)
                    frame = np_.frombuffer(raw, np_.float32).reshape(
                        n, dev.open_channels)
                    for c, pl_ in enumerate(planes):
                        pl_[:] = frame[:, c]
                return 0

            self._cb_ref = self._PROC_CB(process)
            lib.jack_set_process_callback(ctypes.c_void_p(self._client),
                                          self._cb_ref, None)

    def start(self) -> None:
        lib = self._jack()
        if lib.jack_activate(ctypes.c_void_p(self._client)) != 0:
            raise IoModuleError("JACK I/O: activate failed")
        for i, target in enumerate(self._connect):
            if i >= len(self._ports):
                break
            if not target:
                # unconnected port (empty/omitted dest) -- skip, keep
                # connecting the rest (bfio_jack.c:534-536 continue)
                continue
            mine = lib.jack_port_name(ctypes.c_void_p(self._ports[i]))
            pair = ((mine, target.encode()) if self.io != IN
                    else (target.encode(), mine))
            if lib.jack_connect(ctypes.c_void_p(self._client),
                                pair[0], pair[1]) != 0:
                # a failed auto-connect is fatal (bfio_jack.c:538-546)
                raise IoModuleError(
                    f'JACK I/O: Could not connect local port to '
                    f'"{target}".')

    # engine-side I/O rides the native ring when the C callback is in
    # charge; otherwise the inherited Python FIFO bridge
    def read(self, nbytes: int) -> bytes:
        if self._nring is not None:
            return self._nring.read_blocking(nbytes)
        return super().read(nbytes)

    def write(self, data) -> int:
        if self._nring is not None:
            return self._nring.write_blocking(bytes(data))
        return super().write(data)

    def stop_stream(self) -> None:
        if self._nctx:
            from ..core.native import rtfifo as _rt
            _rt.lib().bf_jack_ctx_stop(ctypes.c_void_p(self._nctx))
        if self._nring is not None:
            self._nring.close()
        super().stop_stream()

    @property
    def native_xruns(self) -> int:
        if self._nctx:
            from ..core.native import rtfifo as _rt
            return int(_rt.lib().bf_jack_ctx_xruns(
                ctypes.c_void_p(self._nctx)))
        return self.underruns + self.overruns

    def stop(self) -> None:
        if self._client:
            self._jack().jack_deactivate(ctypes.c_void_p(self._client))
        self.stop_stream()

    def close(self) -> None:
        if self._client:
            self._jack().jack_client_close(ctypes.c_void_p(self._client))
            self._client = None
        if self._nctx:
            from ..core.native import rtfifo as _rt
            _rt.lib().bf_jack_ctx_destroy(ctypes.c_void_p(self._nctx))
            self._nctx = None
        if self._nring is not None:
            # only close(); the GC finalizer frees the C ring once no
            # thread can still be blocked inside it (rtfifo.NativeRing)
            self._nring.close()
            self._nring = None
        super().close()


class PulseDevice(IoDevice):
    """PulseAudio through libpulse-simple (bfio_pulse.c analog).

    The simple API is blocking, which matches the engine's pipeline
    directly (pa_simple_read/pa_simple_write). Parameters: ``server:``,
    ``device:`` (sink/source name), ``app_name:``, ``stream_name:``.
    """

    _lib = None

    # pa_sample_format_t (pulse/sample.h)
    _FMT = {"S16_LE": 3, "S16_BE": 4, "FLOAT_LE": 5, "FLOAT_BE": 6,
            "S32_LE": 7, "S32_BE": 8, "S24_LE": 9, "S24_BE": 10,
            "S24_4LE": 11, "S24_4BE": 12}

    @classmethod
    def _pulse(cls):
        if cls._lib is None:
            name = ctypes.util.find_library("pulse-simple")
            if name is None:
                raise IoModuleError(
                    "Pulse I/O: libpulse-simple is not available on this "
                    "host; use the file, alsa or oss modules")
            lib = ctypes.CDLL(name)
            lib.pa_simple_new.restype = ctypes.c_void_p
            cls._lib = lib
        return cls._lib

    class _SampleSpec(ctypes.Structure):
        _fields_ = [("format", ctypes.c_int), ("rate", ctypes.c_uint32),
                    ("channels", ctypes.c_uint8)]

    class _BufferAttr(ctypes.Structure):
        # pa_buffer_attr (pulse/def.h); (uint32)-1 = server default
        _fields_ = [("maxlength", ctypes.c_uint32),
                    ("tlength", ctypes.c_uint32),
                    ("prebuf", ctypes.c_uint32),
                    ("minreq", ctypes.c_uint32),
                    ("fragsize", ctypes.c_uint32)]

    def __init__(self, params, io, sample_format, sample_rate, open_channels):
        super().__init__(params, io, sample_format, sample_rate, open_channels)
        opts = _parse_fields(params, {"server": T.STRING, "device": T.STRING,
                                      "app_name": T.STRING,
                                      "stream_name": T.STRING})
        self._opts = opts
        self._s = None
        if sample_format is None:
            raise IoModuleError(
                "Pulse I/O: no support for AUTO sample format")
        if sample_format.name not in self._FMT:
            raise IoModuleError(
                f"Pulse I/O: unsupported format {sample_format.name}")

    def init(self, period_size):
        lib = self._pulse()
        ss = self._SampleSpec(self._FMT[self.sample_format.name],
                              self.sample_rate, self.open_channels)
        err = ctypes.c_int(0)
        opts = self._opts
        direction = 2 if self.io == IN else 1   # PA_STREAM_RECORD=2
        # bound the server-side buffering to the engine's period: the
        # Pulse defaults (hundreds of ms of tlength / large fragsize)
        # would silently replace the advertised fixed 2N I/O delay
        fb = self.sample_format.bytes * self.open_channels
        period_bytes = max(1, int(period_size)) * fb
        default = 0xFFFFFFFF
        attr = self._BufferAttr(default, default, default, default, default)
        if self.io == IN:
            attr.fragsize = period_bytes
        else:
            attr.tlength = 2 * period_bytes
            attr.maxlength = 4 * period_bytes
        self._s = lib.pa_simple_new(
            opts.get("server", "").encode() or None,
            opts.get("app_name", "brutefir").encode(),
            direction,
            opts.get("device", "").encode() or None,
            opts.get("stream_name", "brutefir").encode(),
            ctypes.byref(ss), None, ctypes.byref(attr), ctypes.byref(err))
        if not self._s:
            raise IoModuleError(
                f"Pulse I/O: pa_simple_new failed (error {err.value})")
        self._framebytes = self.sample_format.bytes * self.open_channels

    def read(self, nbytes):
        lib = self._pulse()
        buf = ctypes.create_string_buffer(nbytes)
        err = ctypes.c_int(0)
        if lib.pa_simple_read(ctypes.c_void_p(self._s), buf, nbytes,
                              ctypes.byref(err)) < 0:
            raise IoModuleError(f"Pulse I/O: read failed ({err.value})")
        return buf.raw

    def write(self, data):
        lib = self._pulse()
        data = bytes(data)
        err = ctypes.c_int(0)
        if lib.pa_simple_write(ctypes.c_void_p(self._s), data, len(data),
                               ctypes.byref(err)) < 0:
            raise IoModuleError(f"Pulse I/O: write failed ({err.value})")
        return len(data)

    def stop(self):
        if self._s and self.io != IN:
            err = ctypes.c_int(0)
            self._pulse().pa_simple_drain(ctypes.c_void_p(self._s),
                                          ctypes.byref(err))

    def close(self):
        if self._s:
            self._pulse().pa_simple_free(ctypes.c_void_p(self._s))
            self._s = None


register_io_module("alsa", AlsaDevice)
register_io_module("oss", OssDevice)
register_io_module("jack", JackDevice)
register_io_module("pulse", PulseDevice)
