"""brutefir_tpu_torch imports neither jax nor anything of the JAX package
brutefir_tpu (it keeps its own copies of the framework-free layers), its
config parser accepts exactly what the JAX one does, its CLI logic
module is the JAX one's (same file, same answers), and it pins full FP32
matmuls."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import torch

from brutefir_tpu_torch.config import parse_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# run in the subprocess after the imports: no jax* module and no module
# of the JAX package (brutefir_tpu, brutefir_tpu.*) may be loaded
_NOTHING_OF_JAX = (
    "bad = sorted(m for m in sys.modules if m.split('.')[0] == "
    "'brutefir_tpu' or m.startswith('jax'))\n"
    "assert not bad, bad\n")


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import brutefir_tpu_torch\n"
        "import brutefir_tpu_torch.runtime.engine\n"
        "import brutefir_tpu_torch.__main__\n"
        "import brutefir_tpu_torch.ops.mac_mix\n"
        "import brutefir_tpu_torch.convert\n"
        "import brutefir_tpu_torch.ops.mac_group\n"
        "import brutefir_tpu_torch.ops.mac_dual\n"
        "import brutefir_tpu_torch.ops.fft_glue\n"
        "import brutefir_tpu_torch.ops.fft_fused\n"
        "import brutefir_tpu_torch.control.cli\n"
        "import brutefir_tpu_torch.control.eq\n"
        "import brutefir_tpu_torch.runtime.stageprobe\n"
        "import brutefir_tpu_torch.config.coeffs\n"
        "import brutefir_tpu_torch.core.dither\n"
        "import brutefir_tpu_torch.core.firwindow\n"
        "import brutefir_tpu_torch.ops.device_dither\n"
        "import brutefir_tpu_torch.runtime.subdelay\n"
        "import brutefir_tpu_torch.core.codecs\n"
        "import brutefir_tpu_torch.core.native\n"
        "import brutefir_tpu_torch.core.delayline\n"
        "import brutefir_tpu_torch.io.sound_backends\n"
        "import brutefir_tpu_torch.io.callback\n"
        "import brutefir_tpu_torch.core.native.rtfifo\n"
        "import brutefir_tpu_torch.parallel\n"
        "import brutefir_tpu_torch.parallel.mesh\n"
        "import brutefir_tpu_torch.ops.mac_shard\n"
        + _NOTHING_OF_JAX +
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_port_has_every_package_of_the_jax_package():
    """Every subpackage of brutefir_tpu has its twin in the port, since
    ``brutefir_tpu_torch.parallel`` (multi-device sharding) joined."""
    import brutefir_tpu_torch.parallel as par

    def packages(name):
        root = os.path.join(REPO, name)
        return sorted(d for d in os.listdir(root)
                      if os.path.isfile(os.path.join(root, d,
                                                     "__init__.py")))

    assert "parallel" in packages("brutefir_tpu_torch")
    assert packages("brutefir_tpu_torch") == packages("brutefir_tpu")
    for name in ("make_mesh", "auto_mesh", "ShardedGraph"):
        assert callable(getattr(par, name))


def test_port_main_path_imports_no_jax(tmp_path):
    """Running a file-to-file config through the port's __main__ (on the
    CPU) pulls in no jax either."""
    x = (np.random.default_rng(3).standard_normal((300, 1)) * 2 ** 18)
    x.astype("<i4").tofile(tmp_path / "in.raw")
    cfg = tmp_path / "c.conf"
    cfg.write_text(f"""
sampling_rate: 44100;
filter_length: 128,2;
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S32_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{tmp_path / 'out.raw'}"; }}; sample: "S32_LE"; channels: 1; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    code = (
        "import sys, torch\n"
        "from brutefir_tpu_torch.__main__ import main\n"
        f"rc = main(['-quiet', '-nodefault', {str(cfg)!r}],\n"
        "          device=torch.device('cpu'))\n"
        "assert rc == 0, rc\n"
        + _NOTHING_OF_JAX +
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
    assert os.path.getsize(tmp_path / "out.raw") == 300 * 4


def test_engine_pins_fp32_matmul(tmp_path, monkeypatch):
    from brutefir_tpu_torch.runtime.engine import Engine
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    (tmp_path / "in.raw").write_bytes(b"")
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: 128,2;
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S32_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{tmp_path / 'out.raw'}"; }}; sample: "S32_LE"; channels: 1; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    Engine(conf, device=torch.device("cpu"))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_resolve_device_never_falls_back_to_cpu(monkeypatch):
    import pytest
    from brutefir_tpu_torch import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device(torch.device("cpu")).type == "cpu"


def _plain(obj):
    """A parsed config as nested plain values: dataclasses by class name
    and fields, enums by name (the two packages' classes differ)."""
    import dataclasses
    import enum
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                tuple((f.name, _plain(getattr(obj, f.name)))
                      for f in dataclasses.fields(obj)))
    if isinstance(obj, enum.Enum):
        return obj.name
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


def _scale_config_text():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs.scale_config("/data/scale")


_IO = ('input 0,1 {{ device: "file" {{ path: "/in.raw"; }}; '
       'sample: "{fmt}"; channels: 2; {inf} }};\n'
       'output 0,1 {{ device: "file" {{ path: "/out.raw"; }}; '
       'sample: "{fmt}"; channels: {och}; dither: {dither}; {outf} }};\n')
PARSE_TEXTS = {
    "s24_text_coeffs": (
        'sampling_rate: 44100;\nfilter_length: 256,4;\n'
        'coeff 0 { filename: "/c0.txt"; format: "TEXT"; };\n'
        'coeff 1 { filename: "/c1.txt"; format: "TEXT"; };\n'
        + _IO.format(fmt="S24_4LE", inf="", och=2, dither="false", outf="")
        + 'filter 0 { from_inputs: 0; to_outputs: 0; coeff: 0; };\n'
          'filter 1 { from_inputs: 1; to_outputs: 1; coeff: 1; };\n'),
    "raw_coeffs_mapping_mute_delay": (
        'sampling_rate: 48000;\nfilter_length: 128,4;\npowersave: -70.0;\n'
        'coeff 0 { filename: "/a.txt"; format: "TEXT"; attenuation: 3.0; };\n'
        'coeff 1 { filename: "/b.raw"; format: "S32_LE"; skip: 8; '
        'blocks: 3; };\n'
        'coeff 2 { filename: "dirac pulse"; format: "TEXT"; '
        'attenuation: 6.0; };\n'
        + _IO.format(fmt="S16_LE", inf="mute: false, true;", och=1,
                     dither="true", outf="mapping: 0,0;")
        + 'filter 0 { from_inputs: 0; to_outputs: 0; coeff: 1; '
          'delay: 1; };\n'
          'filter 1 { from_inputs: 1/-3, 0; to_outputs: 1/2.5; '
          'coeff: 2; };\n'),
    "float_cascade_crossfade": (
        'sampling_rate: 44100;\nfilter_length: 64,2;\nfloat_bits: 64;\n'
        'coeff "c" { filename: "/c.raw"; format: "FLOAT_LE"; };\n'
        + _IO.format(fmt="FLOAT_LE", inf="", och=2, dither="false",
                     outf="")
        + 'filter "a" { from_inputs: 0; to_filters: "b"; coeff: "c"; '
          'crossfade: true; };\n'
          'filter "b" { from_filters: "a"; to_outputs: 0, 1; coeff: -1; };\n'),
}


def _parity_cases():
    cases = dict(PARSE_TEXTS)
    for name in sorted(os.listdir(os.path.join(REPO, "examples"))):
        if name.endswith(".conf"):
            with open(os.path.join(REPO, "examples", name)) as fh:
                cases[name] = fh.read()
    return cases


def test_parse_config_matches_jax_on_every_config():
    """The port's copy of the config language gives the same BFConfig as
    the JAX package's on the configs the port's tests use, the examples,
    the 256-channel scale config of chip_smoke.py, and under the defaults
    file."""
    from brutefir_tpu.config import parse_config as jax_parse_config
    from brutefir_tpu.config.defaults import (
        DEFAULT_CONFIG_TEXT as JAX_DEFAULTS)
    from brutefir_tpu_torch.config import DEFAULT_CONFIG_TEXT
    assert DEFAULT_CONFIG_TEXT == JAX_DEFAULTS
    cases = _parity_cases()
    cases["scale_256"] = _scale_config_text()
    for name, text in cases.items():
        got = _plain(parse_config(text))
        assert got == _plain(jax_parse_config(text)), name
        assert got == _plain(parse_config(text)), name      # deterministic
    text = cases["s24_text_coeffs"]
    assert (_plain(parse_config(text, defaults_text=DEFAULT_CONFIG_TEXT))
            == _plain(jax_parse_config(text, defaults_text=JAX_DEFAULTS)))


def test_parse_config_rejects_what_jax_rejects():
    """Both parsers refuse the same broken configs, with the same message."""
    from brutefir_tpu.config import parse_config as jax_parse_config
    good = PARSE_TEXTS["s24_text_coeffs"]
    for bad in (good.replace("filter_length: 256,4;", "filter_length: 3,4;"),
                good.replace("coeff: 1; };", "coeff: 7; };"),
                good.replace("channels: 2;", "channels: 300;", 1),
                good + "filter 0 { from_inputs: 0; to_outputs: 1; };\n",
                good.replace(";", "", 1)):
        errs = []
        for parse in (parse_config, jax_parse_config):
            try:
                parse(bad)
                errs.append(None)
            except Exception as e:              # noqa: BLE001
                errs.append(str(e))
        assert errs[0] is not None and errs[0] == errs[1], errs


def test_io_modules_other_than_file_are_not_ported_yet():
    """The port carries the file module, the four sound-server modules
    (io/sound_backends.py, each needing its library only when a device
    opens) and loads external bfio_<name>.py modules; a name no module
    registers raises the JAX package's IoModuleError."""
    import pytest
    from brutefir_tpu_torch.io import IoModuleError, get_io_module
    assert get_io_module("file").__name__ == "FileDevice"
    for name, cls in (("alsa", "AlsaDevice"), ("oss", "OssDevice"),
                      ("jack", "JackDevice"), ("pulse", "PulseDevice")):
        got = get_io_module(name, ".")
        assert got.__name__ == cls
        assert got.__module__ == "brutefir_tpu_torch.io.sound_backends"
        assert got.uses_sample_clock
    assert get_io_module("jack").is_callback
    with pytest.raises(IoModuleError, match="unknown I/O module: mymodule"):
        get_io_module("mymodule", ".")


# the two ALSA fixes of io/sound_backends.py (ROADMAP queue 3), as text
# replacements of the JAX file: restypes for the frame calls, checked
# hw-params getters, the noninterleaved read's plane stride
ALSA_FIXES = (
    ("""            cls._lib = ctypes.CDLL(name)
        return cls._lib
""", """            cls._lib = cls._typed(ctypes.CDLL(name))
        return cls._lib

    @staticmethod
    def _typed(lib):
        \"\"\"Give the read and write calls their snd_pcm_sframes_t (long)
        return type: ctypes' default int would cut it to 32 bits.\"\"\"
        for fn in ("snd_pcm_readi", "snd_pcm_readn", "snd_pcm_writei",
                   "snd_pcm_writen"):
            getattr(lib, fn).restype = ctypes.c_long
        return lib
"""),
    ("""            lib.snd_pcm_hw_params_get_periods_max(
                hwp, ctypes.byref(un), None)
""", """            chk(lib.snd_pcm_hw_params_get_periods_max(
                hwp, ctypes.byref(un), None),
                "failed to get the maximum number of periods")
"""),
    ("""            lib.snd_pcm_hw_params_get_periods(hwp, ctypes.byref(un), None)
""", """            chk(lib.snd_pcm_hw_params_get_periods(
                hwp, ctypes.byref(un), None),
                "failed to get the number of periods")
"""),
    ("""                lib.snd_pcm_hw_params_get_periods(
                    hwp, ctypes.byref(un), None)
""", """                chk(lib.snd_pcm_hw_params_get_periods(
                    hwp, ctypes.byref(un), None),
                    "failed to get the number of periods")
"""),
    ("""            lib.snd_pcm_hw_params_get_buffer_size(hwp, ctypes.byref(bufsz))
""", """            chk(lib.snd_pcm_hw_params_get_buffer_size(
                hwp, ctypes.byref(bufsz)), "failed to get the buffer size")
"""),
    ("""        raw = buf.raw[: got * self._frame_bytes]
        if self._interleaved or got == 0:
            return raw
        # planes -> interleaved wire layout (the engine's contract)
        import numpy as np
        sb = self.sample_format.bytes
        planes = np.frombuffer(raw, np.uint8).reshape(
            self.open_channels, got, sb)
""", """        if self._interleaved or got == 0:
            return buf.raw[: got * self._frame_bytes]
        # planes -> interleaved wire layout (the engine's contract); the
        # planes lie ``frames`` samples apart (_plane_ptrs), so a short
        # read keeps the first ``got`` samples of each
        import numpy as np
        sb = self.sample_format.bytes
        planes = np.frombuffer(buf.raw[: frames * self._frame_bytes],
                               np.uint8).reshape(
            self.open_channels, frames, sb)[:, :got]
"""),
)


def _read(*parts):
    with open(os.path.join(REPO, *parts)) as fh:
        return fh.read()


def test_io_copies_are_the_jax_files():
    """io/callback.py is the JAX file apart from import lines, and
    core/native/rtfifo.cpp its byte copy."""
    assert (_code_lines(os.path.join(REPO, "brutefir_tpu_torch", "io",
                                     "callback.py"))
            == _code_lines(os.path.join(REPO, "brutefir_tpu", "io",
                                        "callback.py")))
    with open(os.path.join(REPO, "brutefir_tpu_torch", "core", "native",
                           "rtfifo.cpp"), "rb") as a, \
            open(os.path.join(REPO, "brutefir_tpu", "core", "native",
                              "rtfifo.cpp"), "rb") as b:
        assert a.read() == b.read()


def test_sound_backends_is_the_jax_file_with_the_alsa_fixes():
    """io/sound_backends.py is the JAX file with exactly the two ALSA
    fixes applied, apart from import lines."""
    theirs = _read("brutefir_tpu", "io", "sound_backends.py")
    for old, new in ALSA_FIXES:
        assert theirs.count(old) == 1, old
        theirs = theirs.replace(old, new)
    ours = _read("brutefir_tpu_torch", "io", "sound_backends.py")

    def code(text):
        return [ln for ln in text.splitlines()
                if not ln.strip().startswith(("import ", "from "))]
    assert code(ours) == code(theirs)


def test_port_clocked_run_imports_no_jax(tmp_path):
    """A config with a clocked input (chip_smoke's paced module, written
    for the port) runs through the port's __main__ on the CPU, warmed and
    with its iodelay fill, realtime refused, and pulls in no jax."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    (tmp_path / "bfio_paced.py").write_text(cs.PACED_MODULE)
    x = np.round(np.random.default_rng(9).standard_normal((300, 1))
                 * 2 ** 18).astype("<i4")
    x.tofile(tmp_path / "in.raw")
    cfg = tmp_path / "c.conf"
    cfg.write_text(f"""
sampling_rate: 44100;
filter_length: 64,2;
modules_path: "{tmp_path}";
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "paced" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S32_LE"; channels: 1; }};
output 0 {{ device: "paced" {{ path: "{tmp_path / 'out.raw'}"; }}; sample: "S32_LE"; channels: 1; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    code = (
        "import os, sys, torch\n"
        "def refuse(*a):\n"
        "    raise PermissionError\n"
        "os.sched_setscheduler = refuse\n"
        "from brutefir_tpu_torch.__main__ import main\n"
        f"rc = main(['-quiet', '-nodefault', {str(cfg)!r}],\n"
        "          device=torch.device('cpu'))\n"
        "assert rc == 0, rc\n"
        "assert 'brutefir_tpu_torch.io.sound_backends' not in sys.modules\n"
        + _NOTHING_OF_JAX +
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
    y = np.fromfile(tmp_path / "out.raw", "<i4")
    assert y.size == 300 + 2 * 64 and not y[:128].any()
    assert np.array_equal(y[128:], x[:, 0])


def _code_lines(path):
    """The lines of a source file other than its import lines."""
    with open(path) as fh:
        return [ln for ln in fh.read().splitlines()
                if not ln.strip().startswith(("import ", "from "))]


def test_cli_module_is_a_copy_of_the_jax_one():
    """control/cli.py is framework-free: the port's is the JAX package's,
    line for line apart from import lines."""
    ours = _code_lines(os.path.join(REPO, "brutefir_tpu_torch", "control",
                                    "cli.py"))
    theirs = _code_lines(os.path.join(REPO, "brutefir_tpu", "control",
                                      "cli.py"))
    assert ours == theirs


_CLI_CONFIG = """
sampling_rate: 44100;
filter_length: 128,2;
logic: "cli" {{ script: "lf"; echo: false; }};
coeff "a" {{ filename: "dirac pulse"; }};
coeff "b" {{ filename: "dirac pulse"; }};
input "l", "r" {{ device: "file" {{ path: "{d}/in.raw"; }}; sample: "S24_4LE"; channels: 2; }};
output "l", "r" {{ device: "file" {{ path: "{d}/out.raw"; }}; sample: "S24_4LE"; channels: 2; dither: false; }};
filter "f0" {{ from_inputs: "l"; to_outputs: "l"; to_filters: "f2"; coeff: "a"; crossfade: true; }};
filter "f1" {{ from_inputs: "r"/-3; to_outputs: "r"; coeff: "a"; }};
filter "f2" {{ from_inputs: "l"; from_filters: "f0"/2; to_outputs: "r"/6; coeff: "b"; }};
"""
_CLI_SCRIPT = [
    "lf; lc; li; lo; lm; ppk; help; rti",
    'cfc 0 1; cfoa 0 0 6; cfia 1 "r" M0.5; cffa 2 0 3.5; tmo 1; cfc "f1" "b"',
    "lf; lo; cfc 9 0; cfoa 0 1 3; cfia 0 0 x; tmo 7; cfd 1 5; bogus",
    "cfd 1 1; cffa 2 0 M-2; cfc 2 -1; lf; li",
]


def test_cli_commands_match_jax(tmp_path):
    """The same script through both packages' CLI modules, on CPU engines
    of one config: the same text, and the same control state after each
    line (every snapshot field equal)."""
    import io
    from brutefir_tpu.config import parse_config as jax_parse_config
    from brutefir_tpu.control.cli import CliModule as JaxCli
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.control.cli import CliModule, _SleepTask
    from brutefir_tpu_torch.convert import ctrl_from_jax
    from brutefir_tpu_torch.runtime.engine import Engine
    text = _CLI_CONFIG.format(d=tmp_path)
    jconf, tconf = jax_parse_config(text), parse_config(text)
    jeng = JaxEngine(jconf)
    teng = Engine(tconf, device=torch.device("cpu"))
    jcli = JaxCli(jconf.logic_modules[0][1], jeng)
    tcli = CliModule(tconf.logic_modules[0][1], teng)
    cpu = torch.device("cpu")
    texts = []
    for line in _CLI_SCRIPT:
        outs = []
        for cli in (jcli, tcli):
            buf = io.StringIO()
            assert cli.run_line(buf, line, _SleepTask())
            outs.append(buf.getvalue())
        assert outs[0] == outs[1], line
        texts.append(outs[1])
        jc, tc = jeng.control, teng.control
        for a, b in zip(jc.fctrl, tc.fctrl):
            assert ((a.coeff, a.delayblocks, a.in_scales, a.out_scales,
                     a.fscales) == (b.coeff, b.delayblocks, b.in_scales,
                                    b.out_scales, b.fscales)), line
        assert jc.mute == tc.mute
        conv = ctrl_from_jax(jc.snapshot(), cpu)
        tctrl = tc.snapshot()
        for name in tctrl._fields:
            assert torch.equal(getattr(tctrl, name), getattr(conv, name)), \
                (line, name)
        assert tc.snapshot_xfade == jc.snapshot_xfade
    assert teng.control.fctrl[0].coeff == 1 and teng.control.mute[1][1]
    # listings, help and error messages were printed; line 2 is silent
    assert all(texts[i] for i in (0, 2, 3)) and texts[1] == ""
    assert "Unknown command" in texts[2] and "Commands:" in texts[0]


def test_port_cli_script_run_imports_no_jax(tmp_path):
    """A crossfade config driven by a CLI script through the port's
    __main__ (run_offline falls back to the per-block run()) on the CPU
    pulls in no jax either, and writes every frame."""
    x = (np.random.default_rng(4).standard_normal((700, 1)) * 2 ** 18)
    x.astype("<i4").tofile(tmp_path / "in.raw")
    cfg = tmp_path / "c.conf"
    cfg.write_text(f"""
sampling_rate: 44100;
filter_length: 128,2;
logic: "cli" {{ script: "cfc 0 1\ncfc 0 0"; echo: false; }};
coeff 0 {{ filename: "dirac pulse"; }};
coeff 1 {{ filename: "dirac pulse"; format: "TEXT"; attenuation: 6.0; }};
input 0 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S32_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{tmp_path / 'out.raw'}"; }}; sample: "S32_LE"; channels: 1; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; crossfade: true; }};
""")
    code = (
        "import sys, torch\n"
        "from brutefir_tpu_torch.__main__ import main\n"
        f"rc = main(['-quiet', '-nodefault', {str(cfg)!r}],\n"
        "          device=torch.device('cpu'))\n"
        "assert rc == 0, rc\n"
        + _NOTHING_OF_JAX +
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
    assert os.path.getsize(tmp_path / "out.raw") == 700 * 4


def test_port_host_codec_run_imports_no_jax(tmp_path):
    """A config with big-endian and 8-byte float devices and a dithered
    output takes the host codec path through the port's __main__ on the
    CPU (native codec, delay lines, host dither), pulls in no jax, and
    writes every frame of both outputs."""
    frames = 600
    x = np.round(np.random.default_rng(5).standard_normal((frames, 2))
                 * 2 ** 20).astype(">i4")
    x.tofile(tmp_path / "in.raw")
    cfg = tmp_path / "c.conf"
    cfg.write_text(f"""
sampling_rate: 8000;
filter_length: 128,2;
coeff 0 {{ filename: "dirac pulse"; }};
input 0,1 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S32_BE"; channels: 2; }};
output 0 {{ device: "file" {{ path: "{tmp_path / 'a.raw'}"; }}; sample: "S24_BE"; channels: 1; dither: true; delay: 7; }};
output 1 {{ device: "file" {{ path: "{tmp_path / 'b.raw'}"; }}; sample: "FLOAT64_BE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_inputs: 1; to_outputs: 1; coeff: 0; }};
""")
    code = (
        "import sys, torch\n"
        "from brutefir_tpu_torch.__main__ import main\n"
        "from brutefir_tpu_torch.runtime import engine\n"
        "seen = []\n"
        "real = engine.Engine.read_block\n"
        "engine.Engine.read_block = lambda self: seen.append(1) or real(self)\n"
        f"rc = main(['-quiet', '-nodefault', {str(cfg)!r}],\n"
        "          device=torch.device('cpu'))\n"
        "assert rc == 0 and seen, (rc, seen)\n"
        + _NOTHING_OF_JAX +
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
    assert os.path.getsize(tmp_path / "a.raw") == frames * 3
    assert os.path.getsize(tmp_path / "b.raw") == frames * 8


def test_port_external_modules_import_no_jax(tmp_path):
    """A config with an external bflogic_<name>.py (a spectral hook) and
    an external bfio_<name>.py input device, written for the port, runs
    through the port's __main__ on the CPU and pulls in no jax."""
    mods = tmp_path / "mods"
    mods.mkdir()
    (mods / "bflogic_halver.py").write_text(
        "from brutefir_tpu_torch.control import register_logic_module\n"
        "class Halver:\n"
        "    def __init__(self, params, engine):\n"
        "        pass\n"
        "    def output_freqd(self, buf, ch):\n"
        "        buf *= 0.5\n"
        "register_logic_module('halver', Halver)\n")
    (mods / "bfio_rawfile.py").write_text(
        "from brutefir_tpu_torch.io import register_io_module\n"
        "from brutefir_tpu_torch.io.file_module import FileDevice\n"
        "register_io_module('rawfile', FileDevice)\n")
    x = np.round(np.random.default_rng(6).standard_normal(500) * 2 ** 18)
    x.astype("<i4").tofile(tmp_path / "in.raw")
    cfg = tmp_path / "c.conf"
    cfg.write_text(f"""
sampling_rate: 44100;
filter_length: 128,2;
modules_path: "{mods}";
logic: "halver" {{ }};
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "rawfile" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S32_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{tmp_path / 'out.raw'}"; }}; sample: "S32_LE"; channels: 1; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    code = (
        "import sys, torch\n"
        "from brutefir_tpu_torch.__main__ import main\n"
        f"rc = main(['-quiet', '-nodefault', {str(cfg)!r}],\n"
        "          device=torch.device('cpu'))\n"
        "assert rc == 0, rc\n"
        "assert 'bflogic_halver' in sys.modules\n"
        "assert 'bfio_rawfile' in sys.modules\n"
        + _NOTHING_OF_JAX +
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
    y = np.fromfile(tmp_path / "out.raw", "<i4")
    assert y.size == 500 and np.abs(y - x / 2).max() <= 1
