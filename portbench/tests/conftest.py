"""The benchmark's own tests: ``python -m pytest portbench/tests`` from
the root of the repository. They run on the CPU at tiny shapes, but for
the test marked ``cuda``, which skips where there is no card."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TRAFFIC = ("offline",)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")


def tiny_config(name="tiny", **over) -> dict:
    """massive's configuration at a shape the CPU runs in seconds: 3
    channels, 256 x 4 partitions, a coefficient set each."""
    with open(ROOT / "portbench" / "configs" / "massive.json") as fh:
        c = json.load(fh)
    c.update(name=name, channels=3, filter_length=256, partitions=4,
             coeff_sets=3)
    c["taps"] = dict(c["taps"], decay_samples=300)
    c.update(over)
    return c


def make_root(path: Path, copy_code: bool = False) -> Path:
    """A checkout-like root under ``path``: BENCHMARK.json with the cells
    ``tiny.<traffic>`` added to the real ones, the real traffic files and
    the tiny configuration (with ``copy_code``, the whole benchmark
    folder)."""
    bench = path / "portbench"
    if copy_code:
        shutil.copytree(ROOT / "portbench", bench,
                        ignore=shutil.ignore_patterns("__pycache__"))
    else:
        shutil.copytree(ROOT / "portbench" / "traffic", bench / "traffic")
        (bench / "configs").mkdir(parents=True)
    with open(bench / "configs" / "tiny.json", "w") as fh:
        json.dump(tiny_config(), fh)
    with open(ROOT / "BENCHMARK.json") as fh:
        b = json.load(fh)
    tiny = [f"tiny.{t}" for t in TRAFFIC]
    b["workloads"] += [{"name": n, "config": "tiny", "traffic": n[5:],
                        "chips": 1, "why": "a test shape"} for n in tiny]
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + tiny
    with open(path / "BENCHMARK.json", "w") as fh:
        json.dump(b, fh, indent=1)
    return path


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
