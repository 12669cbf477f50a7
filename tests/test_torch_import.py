"""brutefir_tpu_torch imports neither jax nor anything of the JAX package
brutefir_tpu (it keeps its own copies of the framework-free layers), its
config parser accepts exactly what the JAX one does, its CLI logic
module is the JAX one's (same file, same answers), and it pins full FP32
matmuls."""

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
        + _NOTHING_OF_JAX +
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


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
    """The port carries the file module only; sound-server backends and
    external bfio_<name>.py modules raise, naming their ROADMAP item."""
    import pytest
    from brutefir_tpu_torch.io import get_io_module
    assert get_io_module("file").__name__ == "FileDevice"
    for name in ("alsa", "oss", "jack", "pulse", "mymodule"):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue 1 item 4"):
            get_io_module(name, ".")


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
