"""bench3_config (BruteFIR's unpartitioned benchmark: 26 channels through
one 65536-tap filter each, filter_length 65536 in one partition) on the
port's normal path, ``Engine.run_offline``: the grouped offline dispatch
at one partition, each batch of 8 in groups of G = 4 (the unfused form:
``mac_group``, the output mix outside), against the benchmark's plain
reference (``portbench/reference/fir.py``: float64 FFT convolution of
the raw files).

On the CPU: the route at the published shape (arithmetic on the graph
spec, nothing allocated), and a tiny bench3 (N = 256, B = 1, 3 channels,
one set) file to file under ``BRUTEFIR_TPU_PAIR=force:4``. On the card
(marked ``cuda``; skipped here): the published widths against the
reference, and the grouped kernels in a traced window against the
programs' launch counts.

This file imports no jax, so it also runs on a machine without it:

    python -m pytest tests/test_torch_bench3.py --noconftest -m cuda

Tolerances: the CPU engine within 1 LSB of S24 of the float64 reference
(float32 FFTs and sums in another order; outputs near 2^20, where a
float32 ulp is an eighth of an LSB); on the card the benchmark cell's
own limit, ``check.max_gap_lsb`` of ``portbench/configs/bench3.json``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from brutefir_tpu_torch.config import parse_config_file
from brutefir_tpu_torch.graph.compile import (_group_fused, group_route,
                                              group_size)
from brutefir_tpu_torch.graph.spec import build_graph_spec

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "portbench" / "configs"
CPU = torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bench_config(name: str, **over) -> dict:
    with open(CONFIGS / f"{name}.json") as fh:
        c = json.load(fh)
    c.update(over)
    return c


def _spec(c: dict):
    C = c["channels"]
    return build_graph_spec(c["filter_length"], c["partitions"], C, C,
                            [[] for _ in range(C)], [False] * C)


@pytest.mark.parametrize("name,route", [("bench3", (4, "unfused")),
                                        ("massive", (1, "none"))])
def test_route_at_the_published_shape(monkeypatch, name, route):
    """bench3's (26 + 4 B) 2 K 4 bytes (15.7 MB) pass the 12 MiB line, so
    a batch of 8 groups; the fused form does not fit at G = 4 and the
    unfused one does. massive's (5.9 MB) never groups."""
    for var in ("BRUTEFIR_TPU_PAIR", "BRUTEFIR_TPU_GROUP_FORM",
                "BRUTEFIR_TPU_FUSED_MIX"):
        monkeypatch.delenv(var, raising=False)
    spec = _spec(_bench_config(name))
    assert group_size(spec, 8) == route[0]
    assert group_route(spec, 8) == route
    if route[0] > 1:
        assert not _group_fused(spec, route[0])


def _inputs(workdir, config, seconds, seed):
    """The benchmark's seeded files for ``config`` and its configuration
    text, the output going to ``out.raw`` in ``workdir``."""
    from portbench import inputs
    with open(ROOT / "portbench" / "traffic" / "offline.json") as fh:
        traffic = json.load(fh)
    traffic["input_seconds"] = seconds
    out = str(Path(workdir) / "out.raw")
    return inputs.write_all(str(workdir), config, traffic, seed, out), out


def _run(files, out, device, blocks, batch=8):
    """``run_offline`` of ``blocks`` blocks in batches of ``batch``: the
    engine's batch program and the output words [frames, C]."""
    from brutefir_tpu_torch.runtime.engine import Engine
    conf = parse_config_file(files.conf_path)
    conf.quiet = True
    eng = Engine(conf, device=device)
    eng.setup()
    eng.run_offline(max_blocks=blocks, batch_blocks=batch, setup=False)
    prog = eng.dio.programs()[("multi", batch, True, True)]
    eng.teardown()
    words = np.fromfile(out, "<i4").reshape(-1, files.channels)
    return prog, ((words << 8) >> 8).astype(np.int64)


@pytest.mark.parametrize("form,route", [("unfused", (4, "unfused")),
                                        ("", (4, "fused"))])
def test_tiny_bench3_file_to_file_matches_reference(tmp_path, monkeypatch,
                                                    form, route):
    """bench3's routing and formats at N = 256, B = 1, 3 channels, one
    set: three batches of 8 through ``run_offline`` grouped by 4 (force),
    in each form, within 1 LSB of the reference at every frame."""
    from portbench.reference.fir import Reference
    monkeypatch.setenv("BRUTEFIR_TPU_PAIR", "force:4")
    monkeypatch.setenv("BRUTEFIR_TPU_GROUP_FORM", form)
    c = _bench_config("bench3", channels=3, filter_length=256)
    c["taps"] = dict(c["taps"], decay_samples=100)
    files, out = _inputs(tmp_path, c, 0.1, 2 ** 40 + 7)
    prog, got = _run(files, out, CPU, 24)
    assert prog.route == route
    assert prog.calls == 3
    assert got.shape == (24 * 256, 3)
    want = Reference(files).words(0, got.shape[0]).numpy()
    assert np.abs(want).max() > 2 ** 18
    assert np.abs(got - want).max() <= 1


@pytest.mark.cuda
def test_bench3_on_card_matches_reference(cuda, tmp_path, monkeypatch):
    """The published widths on the card: 48 blocks of 65536 frames (six
    batches, two groups of 4 each, unfused) against the reference within
    the cell's limit; the program's route and its launch counts."""
    from brutefir_tpu_torch.ops import fft_glue, mac_group
    from portbench.reference.fir import Reference
    for var in ("BRUTEFIR_TPU_PAIR", "BRUTEFIR_TPU_GROUP_FORM"):
        monkeypatch.delenv(var, raising=False)
    c = _bench_config("bench3")
    files, out = _inputs(tmp_path, c, 1.5, 2 ** 33 + 5)
    g0, r0 = mac_group.launches["group"], fft_glue.launches["glue_fwd_ring"]
    prog, got = _run(files, out, cuda, 48)
    assert prog.route == (4, "unfused") and prog.graph is not None
    assert mac_group.launches["group"] - g0 == 2 * 6
    # a group of 4: 4 ring writes and 3 blocks glued into xnews
    assert fft_glue.launches["glue_fwd_ring"] - r0 == 14 * 6
    ref = Reference(files, device=cuda)
    worst = 0
    for pos in range(0, got.shape[0], 8 * 65536):
        want = ref.words(pos, 8 * 65536).cpu().numpy()
        worst = max(worst, int(np.abs(got[pos:pos + 8 * 65536] - want)
                               .max()))
    print(f"bench3 on the card: max gap {worst} LSB")
    assert worst <= c["check"]["max_gap_lsb"]


@pytest.mark.cuda
def test_grouped_kernel_events_match_launch_counts(cuda, tmp_path,
                                                   monkeypatch):
    """In a traced window of replays only, the device's events of
    ``mac_group_kernel``, ``glue_fwd_ring_kernel`` (ring writes and
    ``xnews``) and ``glue_inv_kernel`` equal the batch program's launch
    counts a call (``Program.delta``, taken at its capture) times its
    replays in the window."""
    from brutefir_tpu_torch.runtime.engine import Engine
    from portbench import kernel_time, trace
    for var in ("BRUTEFIR_TPU_PAIR", "BRUTEFIR_TPU_GROUP_FORM"):
        monkeypatch.delenv(var, raising=False)
    files, _ = _inputs(tmp_path, _bench_config("bench3"), 1.5, 2 ** 35 + 3)
    conf = parse_config_file(files.conf_path)
    conf.quiet = True
    eng = Engine(conf, device=cuda)
    eng.setup()
    eng.run_offline(max_blocks=16, setup=False)      # eager, capture
    prog = eng.dio.programs()[("multi", 8, True, True)]
    assert prog.graph is not None and prog.route == (4, "unfused")
    calls = prog.calls
    torch.cuda.synchronize()
    prof = trace.start()
    eng.run_offline(max_blocks=16 + 32, setup=False)
    torch.cuda.synchronize()
    prof.stop()
    replays = prog.calls - calls
    eng.teardown()
    assert replays == 4
    delta = {k: n for _, k, n in prog.delta}
    assert (delta["group"], delta["glue_fwd_ring"], delta["glue_inv"]) == (
        2, 14, 8)
    seen = {}
    for _, kind, name, _, _ in trace.device_events(prof):
        if kind == "kernel":
            f = kernel_time.function_name(name)
            seen[f] = seen.get(f, 0) + 1
    assert seen.get("mac_group_kernel") == delta["group"] * replays
    assert seen.get("glue_fwd_ring_kernel") == (delta["glue_fwd_ring"]
                                                * replays)
    assert seen.get("glue_inv_kernel") == delta["glue_inv"] * replays
    assert "mac_mix_group_kernel" not in seen
