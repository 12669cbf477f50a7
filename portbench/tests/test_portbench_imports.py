"""No module the benchmark loads is JAX's or the JAX package's, and the
reference loads nothing of the program. Top-level names are compared
whole (the part before the first dot): ``brutefir_tpu_torch`` begins
with ``brutefir_tpu`` and is not it."""

import ast
import subprocess
import sys

from conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "brutefir_tpu"}
# the repository's old benchmark and chip scripts: the harness copies
# what it needs from them and imports none
OLD = {"bench", "tools", "chip_smoke", "chip_profile", "chip_stage_probe",
       "chip_mac_ab", "chip_mac_designs", "chip_glue_designs",
       "chip_fft_clusters", "chip_mac_bf16_designs", "chip_mac_f64_designs",
       "chip_mix_group_designs", "__graft_entry__"}

RUN = """
import sys, time, torch
sys.path.insert(0, {tests!r})
sys.path.insert(0, {repo!r})
from pathlib import Path
from conftest import make_root
from portbench import harness
root = make_root(Path({tmp!r}))
r = harness.run_cell("tiny.offline", 5, 0.4, True, time.perf_counter(),
                     device=torch.device("cpu"), root=root)
assert r["correct"]
print(" ".join(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

REF = """
import sys
sys.path.insert(0, {repo!r})
from pathlib import Path
from portbench import inputs
from portbench.reference import fir
cfg = dict(channels=2, filter_length=64, partitions=2, coeff_sets=2,
           sampling_rate=44100, routing="diagonal", sample_format="S24_4LE",
           float_bits=32, dither=False,
           taps=dict(format="FLOAT_LE", decay_samples=50, l2_norm=0.5))
files = inputs.write_all({tmp!r}, cfg, dict(input_seconds=0.01,
                         input_std_lsb=1000), 3)
fir.Reference(files).words(0, 64, "tf32")
print(" ".join(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _top_levels(script, tmp_path):
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split())


def test_a_run_loads_no_jax(tmp_path):
    mods = _top_levels(RUN.format(tests=str(ROOT / "portbench" / "tests"),
                                  repo=str(ROOT), tmp=str(tmp_path)),
                       tmp_path)
    assert "brutefir_tpu_torch" in mods and "portbench" in mods
    assert not mods & BANNED
    assert not mods & OLD


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    mods = _top_levels(REF.format(repo=str(ROOT), tmp=str(tmp_path)),
                       tmp_path)
    assert "torch" in mods
    assert not mods & (BANNED | OLD | {"brutefir_tpu_torch"})


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_no_source_of_the_benchmark_imports_them():
    for path in (ROOT / "portbench").rglob("*.py"):
        names = _imports(path)
        assert not names & (BANNED | OLD), path
        if "reference" in path.parts:
            assert "brutefir_tpu_torch" not in names, path
