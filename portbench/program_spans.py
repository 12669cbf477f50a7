"""The program's own spans (``brutefir_tpu_torch/runtime/tracing.py``)
in a traced run's window, for the metrics that read them, and the card's
idle time by the main thread's span at each gap.

The program records its spans through each run entry that starts while
a ``torch.profiler`` records, as the traced window's does; a program
without the recorder, or a run with no profiler (the CPU's), gives none,
and the metrics that read them are left out.

    python3 portbench/program_spans.py --workload <cell> --seed <n>
                                       --seconds <s>

runs one traced run of the cell on the first card and prints one JSON
line: the cell's metrics, each span name's wall ms a block and count by
thread, the card's idle seconds by the main thread's span at each gap's
middle (as ``trace.idle_by_host`` labels them by the wrapped methods),
and the coverage of the writer's parts and of the main thread's spans.
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]

WRITE_PARTS = ("write.sync", "write.meters", "write.fetch", "write.encode",
               "write.file", "write.peak")
MAIN_STAGES = ("dispatch.wait_producer", "snapshot", "dispatch",
               "dispatch.wait_writer")


def window(run):
    """The spans that started in the run's window, or None."""
    try:
        from brutefir_tpu_torch.runtime import tracing
    except ImportError:
        return None
    return tracing.take(run.lo, run.hi) or None


def wall_ns(spans, names) -> int:
    return sum(s.end_ns - s.start_ns for s in spans if s.name in names)


def ms_per_block(run, *names):
    """Host ms a block in the spans named ``names`` over the window's
    blocks; None where no such span was recorded."""
    spans = window(run)
    if not spans or not run.blocks:
        return None
    if not any(s.name in names for s in spans):
        return None
    return wall_ns(spans, names) / 1e6 / run.blocks


def idle_by_span(events, card, spans, lo: int, hi: int,
                 thread: str = "MainThread"):
    """Idle seconds of ``card`` in [lo, hi] by ``thread``'s outermost span
    running at each gap's middle, or 'other': the labelling of
    ``trace.idle_by_host`` with the program's own spans."""
    from portbench import trace
    g = trace.gaps(trace.by_card(events).get(card, []), lo, hi)
    tot = defaultdict(int)
    top = [s for s in spans if s.thread == thread and s.parent < 0]
    if g.size == 0:
        return []
    a = np.array([(s.start_ns, s.end_ns) for s in top] or [(0, 0)],
                 dtype=np.int64)
    order = np.argsort(a[:, 0], kind="stable")
    a = a[order]
    names = [top[i].name for i in order] if top else ["other"]
    mid = (g[:, 0] + g[:, 1]) // 2
    i = np.searchsorted(a[:, 0], mid, side="right") - 1
    for (x, y), k, m in zip(g, i, mid):
        on = k >= 0 and a[k, 1] > m
        tot[names[k] if on else "other"] += int(y - x)
    return sorted(([n, ns / 1e9] for n, ns in tot.items()),
                  key=lambda kv: -kv[1])


def report(events, card, spans, blocks: int) -> dict:
    """Each span name's wall ms a block and count by thread, the card's idle
    seconds by the main thread's span, and the coverage checks."""
    lo = min(s.start_ns for s in spans)
    hi = max(s.end_ns for s in spans)
    table = defaultdict(lambda: [0, 0])
    for s in spans:
        t = table[f"{s.thread}:{s.name}"]
        t[0] += s.end_ns - s.start_ns
        t[1] += 1
    writes = [s for s in spans if s.name == "write"]
    parts = wall_ns([s for s in spans if s.name in WRITE_PARTS],
                    WRITE_PARTS)
    main = [s for s in spans if s.thread == "MainThread" and s.parent < 0]
    return {
        "blocks": blocks, "window_s": (hi - lo) / 1e9,
        "ms_per_block": {k: [w / 1e6 / blocks, n]
                         for k, (w, n) in sorted(table.items())},
        "idle_by_main_span": (idle_by_span(events, card, spans, lo, hi)
                              if events is not None else None),
        "write_parts_cover": parts / max(wall_ns(writes, ("write",)), 1),
        "main_stages_cover": wall_ns(main, MAIN_STAGES) / (hi - lo),
    }


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness, trace
    from brutefir_tpu_torch.runtime import tracing

    kept = {}
    device_events = trace.device_events

    def keep(prof):
        kept["events"] = device_events(prof)
        return kept["events"]

    trace.device_events = keep
    result = harness.run_cell(args.workload, args.seed, args.seconds, True,
                              T_START)
    spans = tracing.take()
    out = {"correct": result["correct"], "metrics": result["metrics"],
           "dropped": tracing.RECORDER.dropped,
           **report(kept.get("events"), 0, spans, result["attempted"])}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
