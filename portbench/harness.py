"""One run of one cell: inputs from the seed, the engine built and set
up, a warm-up through the cell's own entry, the timed window, then the
reading of the trace, the check against the reference, and the metrics.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in ``BENCHMARK.json``:
``portbench/configs/<config>.json``, ``portbench/traffic/<traffic>.json``
and ``portbench/metrics/<metric>.py``, whose ``read(run)`` returns the
metric's value or None (nothing to read: the metric is left out) and
whose optional ``SPANS`` names the program's methods it times.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from . import check, inputs, trace
from .spans import Spans

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "brutefir_tpu")
# the program's knobs that change the precision the configuration states:
# cleared for every run, set only by the readings of a control
PRECISION_KNOBS = ("BRUTEFIR_TPU_BANK_DTYPE", "BRUTEFIR_TPU_RING_DTYPE")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic
    and metrics (the entries of ``BENCHMARK.json`` that name it or have
    no ``workloads`` key)."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    w = {x["name"]: x for x in bench["workloads"]}.get(name)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def mine(kind):
        return [m for m in bench[kind]
                if name in m.get("workloads", [name])]

    here = root / HERE.name
    return Cell(name, int(w["chips"]),
                load_json(here / "configs" / f"{w['config']}.json"),
                load_json(here / "traffic" / f"{w['traffic']}.json"),
                mine("end_to_end"), mine("per_layer"))


def metric_module(name: str):
    return importlib.import_module(f"portbench.metrics.{name}")


@dataclass
class Run:
    """What a metric's reader reads. Host times in seconds; ``events`` and
    the trace window ``lo``, ``hi`` in the wall clock's ns."""
    config: dict
    traffic: dict
    rate: int
    block_frames: int
    setup_s: float = 0.0
    kernel_build_s: Optional[float] = None
    engine_init_s: float = 0.0
    window_s: float = 0.0
    frames: int = 0
    blocks: int = 0
    programs: list = field(default_factory=list)
    cards: list = field(default_factory=list)
    spans: Optional[Spans] = None
    events: Optional[list] = None
    lo: int = 0
    hi: int = 0

    def window_events(self, kinds=trace.DEVICE_KINDS) -> list:
        """The traced device events that started in the window."""
        return [e for e in (self.events or ())
                if e[1] in kinds and self.lo <= e[3] < self.hi]


def banned_modules() -> list:
    """Loaded modules whose top-level name is banned, compared whole."""
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(BANNED))


def _entry(eng, traffic: dict):
    kind = traffic["entry"]
    if kind == "run_offline":
        return lambda max_blocks=None: eng.run_offline(
            max_blocks=max_blocks, batch_blocks=traffic["batch_blocks"],
            setup=False)
    raise ValueError(f"no entry {kind!r}")


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             t_start: float, device=None, root: Path = ROOT,
             keep_reference: bool = False, knobs=None) -> dict:
    """Run cell ``name`` once and return its result (the JSON line's
    object; ``checks`` last). ``device``: None for the first card, or a
    torch device (the CPU tests pass the CPU). ``keep_reference``: the
    result's ``_reference`` holds the reference and the kept writes, for
    the readings of the controls; ``knobs``: environment settings of the
    program for this run (a control's lower precision)."""
    c = cell(name, root)
    os.environ["BRUTEFIR_TPU_MESH"] = c.traffic["mesh"]
    for k in PRECISION_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(knobs or {})
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        return _run(c, seed, seconds, traced, t_start, device, workdir,
                    keep_reference)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(c: Cell, seed, seconds, traced, t_start, device, workdir,
         keep_reference) -> dict:
    import torch
    from brutefir_tpu_torch.config import OUT, parse_config_file
    from brutefir_tpu_torch.runtime.engine import Engine

    cfg, trf = c.config, c.traffic
    files = inputs.write_all(workdir, cfg, trf, seed)
    device = torch.device("cuda:0" if device is None else device)

    build_s = None
    if device.type == "cuda":
        # the program builds its kernels on first use; built here, the
        # build (a checkout's first run) or the finding of the built
        # libraries (every later run) is timed apart
        from brutefir_tpu_torch.ops import _build
        tb = time.perf_counter()
        _build.build()
        build_s = time.perf_counter() - tb

    t0 = time.perf_counter()
    conf = parse_config_file(files.conf_path)
    conf.quiet = True
    eng = Engine(conf, device=device)
    run = Run(cfg, trf, cfg["sampling_rate"], eng.N,
              kernel_build_s=build_s,
              engine_init_s=time.perf_counter() - t0)
    run.cards = ([eng.device.index or 0] if eng.device.type == "cuda"
                 else [])
    go = _entry(eng, trf)
    nbytes = inputs.FORMATS[cfg["sample_format"]][0]
    rec = check.Recorder(eng.devices[OUT][0], cfg["channels"] * nbytes,
                         trf["check_writes"], inputs.rng_for(seed, 2))
    eng.setup()
    go(max_blocks=trf["warm_blocks"])
    if rec.frames != trf["warm_blocks"] * eng.N:
        raise RuntimeError(f"the warm-up wrote {rec.frames} frames, not "
                           f"{trf['warm_blocks'] * eng.N}")

    spans = Spans() if traced else None
    specs = [s for m in c.per_layer
             for s in getattr(metric_module(m["name"]), "SPANS", ())]
    prof = None
    with (spans.wrapping(specs) if traced else contextlib.nullcontext()):
        if traced and run.cards:
            prof = trace.start()
        rec.active = True
        timer = threading.Timer(seconds, eng.stop)
        run.lo = time.time_ns()
        w0 = time.perf_counter()
        run.setup_s = w0 - t_start
        timer.start()
        try:
            go()
        finally:
            timer.cancel()
            timer.join()
        run.window_s = time.perf_counter() - w0
        run.hi = time.time_ns()
        rec.active = False
        if prof is not None:
            prof.stop()
    run.spans = spans
    run.frames = rec.window_frames
    sys.stderr.write(f"setup: setup_s {run.setup_s:.3f}, of which the "
                     f"kernel build {build_s} s\n")
    run.blocks = rec.window_frames // eng.N
    if prof is not None:
        run.events = trace.device_events(prof)
        del prof

    dev = {"platform": "gpu" if run.cards else device.type,
           "kind": (torch.cuda.get_device_name(run.cards[0]) if run.cards
                    else "not measured"),
           "count": max(len(run.cards), 1),
           "memory_peak_bytes": (max(torch.cuda.max_memory_allocated(k)
                                     for k in run.cards)
                                 if run.cards else "not measured")}
    if traced and run.cards:
        dev["busy_s"] = trace.busy_s(run.window_events(), run.cards,
                                     run.lo, run.hi)
        dev["window_s"] = (run.hi - run.lo) / 1e9
    if eng.dio is not None:
        run.programs = [{"capture_s": p.capture_s,
                         "graph": p.graph is not None}
                        for p in eng.dio.programs().values()]
    eng.teardown()
    kept = rec.kept()
    rec.release()
    ref_device = eng.device
    del eng, go, rec
    gc.collect()
    if run.cards:
        torch.cuda.empty_cache()

    ref_mod = importlib.import_module(f"portbench.reference.{cfg['kind']}")
    reference = ref_mod.Reference(files, device=ref_device)
    numbers, over_frames = check.compare(kept, reference, cfg["check"])
    correct = all(ok for *_, ok in numbers.values())

    metrics = {}
    for m in (c.per_layer if traced else c.end_to_end):
        value = metric_module(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": run.blocks,
              "failed": over_frames // run.block_frames, "metrics": metrics,
              "device": dev}
    if traced and run.events is not None:
        ev = run.window_events()
        result["breakdown"] = {
            "device_ops": trace.top_ops(ev),
            "idle_gaps": trace.idle_by_host(ev, run.cards[0], spans,
                                            run.lo, run.hi)}
    if keep_reference:
        result["_reference"] = (reference, kept)
    result["checks"] = {k: {"value": v, "op": op, "limit": lim}
                        for k, (v, op, lim, _) in numbers.items()}
    return result
