"""brutefir_tpu_torch never imports jax, and pins full FP32 matmuls."""

import os
import subprocess
import sys

import numpy as np
import torch

from brutefir_tpu.config import parse_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import brutefir_tpu_torch\n"
        "import brutefir_tpu_torch.runtime.engine\n"
        "import brutefir_tpu_torch.__main__\n"
        "import brutefir_tpu_torch.ops.mac_mix\n"
        "import brutefir_tpu_torch.convert\n"
        "assert 'jax' not in sys.modules, sorted(\n"
        "    m for m in sys.modules if m.startswith('jax'))\n"
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
        "assert 'jax' not in sys.modules\n"
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
