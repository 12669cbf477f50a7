"""The engine's span recorder (``brutefir_tpu_torch/runtime/tracing.py``)
on the CPU: off, it records nothing and reads no clock; on, every batch of
``run_offline`` and every block of ``run()`` has its stages' spans on the
threads that ran them, tied by one block id; children nest inside their
parents on their own thread; the recorder reads the wall clock alone;
spans past the capacity are counted; a run entry under a
``torch.profiler`` records, and ``run()`` under ``debug: true;`` keeps a
ring of the debug timeline's spans alone; and the output bytes do not
change."""

import threading
import time
from collections import defaultdict

import numpy as np
import pytest
import torch

from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.runtime import tracing
from brutefir_tpu_torch.runtime import engine as engine_mod
from brutefir_tpu_torch.runtime.engine import Engine

CPU = torch.device("cpu")
N, B = 128, 3
BLOCKS = 21                # 21 blocks and 50 frames: a partial last block
FRAMES = N * BLOCKS + 50
WORK = ("write.sync", "write.meters", "write.fetch", "write.encode",
        "write.file", "write.peak")


@pytest.fixture(autouse=True)
def _recorder_off():
    tracing.disable()
    yield
    tracing.disable()


def _files(d):
    rng = np.random.default_rng(5)
    np.clip(np.round(rng.standard_normal((FRAMES, 2)) * 2.0 ** 19),
            -(2 ** 23), 2 ** 23 - 1).astype("<i4").tofile(d / "in.raw")
    (rng.standard_normal(N * B) * 0.1).astype("<f4").tofile(d / "h.raw")


def _engine(d, out, debug=False):
    conf = parse_config(f"""
sampling_rate: 44100;{" debug: true;" if debug else ""}
filter_length: {N},{B};
coeff 0 {{ filename: "{d / 'h.raw'}"; format: "FLOAT_LE"; }};
input 0,1 {{ device: "file" {{ path: "{d / 'in.raw'}"; }}; sample: "S24_4LE"; channels: 2; }};
output 0,1 {{ device: "file" {{ path: "{d / out}"; }}; sample: "S24_4LE"; channels: 2; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_inputs: 1; to_outputs: 1; coeff: 0; }};
""")
    conf.quiet = True
    return Engine(conf, device=CPU)


def _run(d, out, entry, debug=False):
    eng = _engine(d, out, debug)
    if entry == "run_offline":
        eng.run_offline(batch_blocks=4)
    else:
        eng.run()
    return (d / out).read_bytes()


class _Clock:
    """``tracing``'s ``time``, counting its clock reads."""

    def __init__(self):
        self.reads = 0

    def __getattr__(self, name):
        fn = getattr(time, name)

        def read(*a):
            self.reads += 1
            return fn(*a)

        return read


@pytest.mark.parametrize("entry", ["run_offline", "run"])
def test_off_records_nothing_and_reads_no_clock(tmp_path, monkeypatch,
                                                entry):
    _files(tmp_path)
    tracing.enable()
    tracing.disable()
    clock = _Clock()
    monkeypatch.setattr(tracing, "time", clock)
    _run(tmp_path, "off.raw", entry)
    assert clock.reads == 0
    assert tracing.take() == [] and not tracing.RECORDER.on


def _by_thread(spans):
    out = defaultdict(list)
    for s in spans:
        out[s.thread].append(s)
    return out


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def _check_nesting(spans):
    """Every parent exists, on the same thread, around its child."""
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.start_ns <= s.end_ns, s
        if s.parent >= 0:
            p = by_id[s.parent]
            assert p.thread == s.thread and p.tid == s.tid
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (p, s)


def test_offline_batches_have_their_spans(tmp_path):
    """``run_offline`` in batches of 4: the producer reads (and copies
    into the stacks) and uploads each batch, the main thread dispatches it (``bind`` and
    ``eager`` inside) and the writer writes it (its six parts inside),
    all under the batch's block id; the tail past the last full batch
    runs block by block."""
    _files(tmp_path)
    tracing.enable()
    _run(tmp_path, "on.raw", "run_offline")
    tracing.disable()
    spans = tracing.take()
    assert tracing.RECORDER.dropped == 0
    _check_nesting(spans)
    th = _by_thread(spans)
    assert set(th) == {"MainThread", "bf-producer", "bf-writer"}
    prod, main, wr = th["bf-producer"], th["MainThread"], th["bf-writer"]
    ids = {(s.block, s.blocks) for s in prod if s.name == "upload"}
    assert ids == {(k, 4) for k in range(0, BLOCKS + 1, 4)}
    for k, m in sorted(ids):
        for name in ("read", "upload", "produce.wait"):
            assert [s.block for s in prod if s.name == name].count(k) == 1
    assert [s.frames for s in prod if s.name == "read"] == [4 * N] * 5 + [
        N + 50]
    full = {(k, 4) for k in range(0, BLOCKS - 3, 4)}
    disp = [s for s in main if s.name == "dispatch"]
    assert {(s.block, s.blocks) for s in disp if s.blocks == 4} == full
    tail = sorted(s.block for s in disp if s.blocks == 1)
    assert tail == list(range(20, BLOCKS + 1))
    for s in disp:
        kids = [c.name for c in _children(main, s)]
        assert kids[0] == "bind" and "eager" in kids, kids
    for name in ("dispatch.wait_producer", "snapshot",
                 "dispatch.wait_writer"):
        assert any(s.name == name for s in main)
    writes = [s for s in wr if s.name == "write"]
    assert ({(s.block, s.blocks) for s in writes}
            == {(s.block, s.blocks) for s in disp})
    assert sum(s.frames for s in writes) == FRAMES
    for s in writes:
        assert [c.name for c in _children(wr, s)] == list(WORK)
        assert all((c.block, c.blocks) == (s.block, s.blocks)
                   for c in _children(wr, s))
    waits = {s.block for s in wr if s.name == "write.wait"}
    assert {s.block for s in writes} <= waits


def test_run_blocks_have_their_spans(tmp_path):
    """``run()``: a ``read``, a ``dispatch`` (with ``snapshot``,
    ``upload``, ``bind``, ``eager``) and a ``write`` for each block, tied
    by the block's index; the read past the end reads 0 frames and
    dispatches nothing."""
    _files(tmp_path)
    tracing.enable()
    _run(tmp_path, "on.raw", "run")
    tracing.disable()
    spans = tracing.take()
    _check_nesting(spans)
    th = _by_thread(spans)
    assert set(th) == {"MainThread", "bf-writer"}
    main, wr = th["MainThread"], th["bf-writer"]
    reads = [s for s in main if s.name == "read"]
    assert [(s.block, s.blocks) for s in reads] == [
        (k, 1) for k in range(BLOCKS + 1)]
    assert [s.frames for s in reads][-2:] == [N, 50]
    disp = [s for s in main if s.name == "dispatch"]
    assert [s.block for s in disp] == list(range(BLOCKS + 1))
    for s in disp:
        kids = [c.name for c in _children(main, s)]
        assert kids == ["snapshot", "upload", "bind", "eager"], kids
    writes = [s for s in wr if s.name == "write"]
    assert [s.block for s in writes] == list(range(BLOCKS + 1))
    assert [(s.block, s.frames) for s in writes][-1] == (BLOCKS, 50)
    # each stage starts where the last one ended: one clock reading a
    # boundary
    for r, d in zip(reads, disp):
        assert r.end_ns == d.start_ns


@pytest.mark.parametrize("entry", ["run_offline", "run"])
def test_recorder_leaves_the_output_bytes(tmp_path, entry):
    _files(tmp_path)
    off = _run(tmp_path, "off.raw", entry)
    tracing.enable()
    on = _run(tmp_path, "on.raw", entry)
    assert tracing.take()
    assert len(off) == FRAMES * 2 * 4 and on == off


def test_dropped_spans_are_counted_and_a_ring_keeps_the_newest():
    rec = tracing.Recorder(capacity=8)
    for ring, kept in ((0, range(8)), (4, range(16, 20))):
        rec.enable(ring=ring)
        for k in range(20):
            sp = rec.begin("s", k, 1)
            rec.end(sp)
        assert rec.dropped == (0 if ring else 12)
        assert [s.block for s in rec.take()] == list(kept)


def test_spans_from_threads_nest_and_take_a_window():
    """Threads keep their own parents; a child with no block id takes its
    parent's; ``next`` ends one span where the next begins; ``take`` keeps
    the spans that started in the window."""
    rec = tracing.Recorder()
    rec.enable()

    def work(k):
        outer = rec.begin("outer", k, 2)
        sp = rec.begin("a")
        sp = rec.next(sp, "b")
        rec.end(sp)
        rec.end(outer)

    threads = [threading.Thread(target=work, args=(k,), name=f"t{k}")
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    spans = rec.take()
    assert len(spans) == 12
    _check_nesting(spans)
    for outer in (s for s in spans if s.name == "outer"):
        a, b = _children(spans, outer)
        assert (a.name, b.name) == ("a", "b") and a.end_ns == b.start_ns
        assert a.block == b.block == outer.block and b.blocks == 2
    mid = sorted(s.start_ns for s in spans)[6]
    assert all(s.start_ns >= mid for s in rec.take(mid, None))
    assert len(rec.take(mid, None)) + len(rec.take(None, mid)) == 12


def test_an_entry_records_under_a_profiler(tmp_path):
    """A run entry called while a ``torch.profiler`` records switches the
    recorder on for itself and off at its end; one called while
    ``enable()`` holds leaves it on."""
    _files(tmp_path)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _run(tmp_path, "a.raw", "run_offline")
        assert not tracing.RECORDER.on
    assert {"read", "dispatch", "write"} <= {s.name for s in tracing.take()}
    tracing.enable()
    _run(tmp_path, "b.raw", "run_offline")
    assert tracing.RECORDER.on


def test_named_recording_keeps_those_names():
    """``enable(names=...)``: a name not listed opens no span (``begin``
    and ``next`` give False) and is not counted."""
    rec = tracing.Recorder()
    rec.enable(names={"a", "c"})
    sp = rec.begin("a", 0, 1)
    sp = rec.next(sp, "b")
    assert sp is False and rec.begin("b") is False
    sp = rec.begin("c", 1, 1)
    rec.end(sp)
    spans = rec.take()
    assert [(s.name, s.block) for s in spans] == [("a", 0), ("c", 1)]
    assert rec.dropped == 0


class _WallClock:
    """``tracing``'s ``time`` with the wall clocks alone."""
    perf_counter_ns = staticmethod(time.perf_counter_ns)
    time_ns = staticmethod(time.time_ns)


@pytest.mark.parametrize("entry", ["run_offline", "run"])
def test_on_reads_the_wall_clock_alone(tmp_path, monkeypatch, entry):
    """On, a run reads no thread CPU clock (its system call is what a
    span would cost most on a sandboxed host), only the wall clock."""
    _files(tmp_path)
    monkeypatch.setattr(tracing, "time", _WallClock)
    tracing.enable()
    _run(tmp_path, "on.raw", entry)
    assert {"read", "dispatch", "write"} <= {s.name for s in tracing.take()}


@pytest.mark.parametrize("entry", ["run_offline", "run"])
def test_debug_keeps_a_ring_of_the_timelines_spans(tmp_path, monkeypatch,
                                                    entry):
    """``debug: true;`` switches the recorder on for ``run()`` alone, as
    a ring of ``DEBUG_SPANS`` slots that keeps only the timeline's
    ``read``, ``dispatch`` and ``write`` spans;
    ``run_offline`` prints no timeline and records nothing."""
    _files(tmp_path)
    calls = []
    enable = tracing.Recorder.enable

    def spy(self, ring=0, names=None):
        calls.append((ring, names))
        enable(self, ring, names)

    monkeypatch.setattr(tracing.Recorder, "enable", spy)
    _run(tmp_path, "d.raw", entry, debug=True)
    assert not tracing.RECORDER.on
    if entry == "run_offline":
        assert calls == []
        return
    assert calls == [(engine_mod.DEBUG_SPANS, engine_mod.DEBUG_EVENTS)]
    spans = tracing.take()
    assert {s.name for s in spans} == {"read", "dispatch", "write"}
    assert [s.block for s in spans if s.name == "write"] == list(
        range(BLOCKS + 1))
