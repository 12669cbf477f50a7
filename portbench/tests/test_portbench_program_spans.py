"""The metrics that read the program's own spans
(``portbench/program_spans.py``): a traced rehearsal under a profiler, as
the card's traced window runs, reads all six; a run without one never
switches the program's recorder on; the arithmetic on made-up spans."""

import time

import pytest
import torch

from portbench import harness, program_spans
from brutefir_tpu_torch.runtime import tracing
from brutefir_tpu_torch.runtime.tracing import Span

CPU = torch.device("cpu")
SIX = {"upload_ms_per_block", "writer_sync_ms_per_block",
       "writer_fetch_ms_per_block", "writer_encode_ms_per_block",
       "producer_wait_ms_per_block", "writer_backpressure_ms_per_block"}


@pytest.fixture(autouse=True)
def _recorder_off():
    tracing.disable()
    yield
    tracing.disable()


def _run(root, traced):
    return harness.run_cell("tiny.offline", 2 ** 31 + 7, 0.6, traced,
                            time.perf_counter(), device=CPU, root=root)


def test_traced_rehearsal_reads_the_program_spans(tiny_root):
    """Under a profiler, as the card's traced window runs the entry, the
    six metrics are read beside the wrapped ones, and ``correct``
    holds."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        r = _run(tiny_root, True)
    assert r["correct"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert SIX <= set(got)
    assert all(v >= 0 for v in got.values())
    assert not tracing.RECORDER.on


@pytest.mark.parametrize("traced", [False, True])
def test_runs_without_a_profiler_leave_the_recorder_off(tiny_root,
                                                        monkeypatch, traced):
    """An untraced run (and on the CPU a traced one, which takes no
    profile) never switches the recorder on, and leaves the six
    metrics out."""
    calls = []
    monkeypatch.setattr(tracing.Recorder, "enable",
                        lambda self, ring=0, names=None: calls.append(ring))
    r = _run(tiny_root, traced)
    assert calls == [] and r["correct"]
    assert not SIX & set(r["metrics"])


def _span(name, t0, t1, sid, parent=-1, thread="MainThread"):
    return Span(name, t0, t1, thread, 1, sid, parent, 0, 8, -1)


def test_idle_by_the_main_threads_span_and_the_coverage():
    spans = [_span("dispatch", 0, 100, 0),
             _span("replay", 10, 90, 1, parent=0),
             _span("dispatch.wait_writer", 100, 300, 2),
             _span("write.fetch", 50, 150, 3, thread="bf-writer")]
    events = [(0, "kernel", "k", 0, 40), (0, "kernel", "k", 120, 140)]
    idle = dict(program_spans.idle_by_span(events, 0, spans, 0, 400))
    assert idle == {"dispatch": 80e-9, "dispatch.wait_writer": 260e-9}
    assert program_spans.report(events, 0, spans, 2)["main_stages_cover"] \
        == 1.0
