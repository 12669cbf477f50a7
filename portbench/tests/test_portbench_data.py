"""A configuration, a traffic mix and a per-layer metric added as new
files and entries in BENCHMARK.json alone: the harness lists the new
cell, parses its files, runs it and reports the new metric, in a copy
of the benchmark where no existing file was edited."""

import filecmp
import json
import subprocess
import sys

from conftest import ROOT, make_root

NEW_METRIC = '''"""Frames a block of the window (a test metric)."""


def read(run):
    return run.frames / max(run.blocks, 1)
'''

SCRIPT = """
import json, sys, time, torch
sys.path.insert(0, {root!r})
sys.path.insert(1, {repo!r})
from portbench import harness
c = harness.cell("wide.burst")
assert c.config["channels"] == 5 and c.traffic["input_seconds"] == 0.25
assert [m["name"] for m in c.per_layer][-1] == "frames_per_block"
r = harness.run_cell("wide.burst", 77, 0.5, True, time.perf_counter(),
                     device=torch.device("cpu"))
print(json.dumps({{k: r[k] for k in ("correct", "metrics")}}))
"""


def test_cell_added_as_files_only(tmp_path):
    root = make_root(tmp_path, copy_code=True)
    bench = root / "portbench"
    before = {p.relative_to(bench): p.read_bytes()
              for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "tiny.json").read_text())
    cfg.update(name="wide", channels=5, coeff_sets=1)
    (bench / "configs" / "wide.json").write_text(json.dumps(cfg))
    trf = json.loads((bench / "traffic" / "offline.json").read_text())
    trf.update(name="burst", input_seconds=0.25, check_writes=4)
    (bench / "traffic" / "burst.json").write_text(json.dumps(trf))
    (bench / "metrics" / "frames_per_block.py").write_text(NEW_METRIC)
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "wide", "source": "a test",
                         "file": "portbench/configs/wide.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "wide.burst", "config": "wide",
                           "traffic": "burst", "chips": 1, "why": "a test"})
    for m in b["per_layer"]:
        m["workloads"].append("wide.burst")
    b["per_layer"].append({"name": "frames_per_block", "unit": "frames",
                           "better": "higher", "source": "host_clock",
                           "layer": "host I/O", "moves": "xrt",
                           "workloads": ["wide.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=str(root),
                                             repo=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"]
    assert r["metrics"]["frames_per_block"]["value"] == 256
    # nothing that was there was edited
    for rel, data in before.items():
        assert (bench / rel).read_bytes() == data, rel
    assert filecmp.cmp(ROOT / "portbench" / "harness.py",
                       bench / "harness.py", shallow=False)
