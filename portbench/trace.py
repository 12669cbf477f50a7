"""The device's side of a traced window: ``torch.profiler`` over the
window (CUDA activity), reduced to the intervals in which a kernel, a
copy or a memset ran on each card, and arithmetic on them: the union of
the intervals (overlapping kernels on several streams count once), the
idle gaps between them, and the device time by name.

Rewritten from the device-time sums of the repository's chip profile,
which summed the profiler's device times (and so counted overlapping
kernels twice).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def start():
    """A started profiler of the card's activity."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def kind_of(name: str) -> str:
    """A device event's kind by its name, as the profiler names copies
    ("Memcpy HtoD (Pageable -> Device)") and memsets; the rest are
    kernels."""
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def device_events(prof) -> list:
    """(card, kind, name, start ns, end ns) of every kernel, copy and
    memset the stopped profiler recorded, in the wall clock's ns."""
    from torch._C._autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        kind = kind_of(e.name())
        t0 = e.start_ns()
        out.append((e.device_index(), kind, e.name(), t0,
                    t0 + e.duration_ns()))
    return out


def merged(intervals, lo: int, hi: int) -> np.ndarray:
    """The union of (start, end) ns intervals clipped to [lo, hi], as
    disjoint sorted [k, 2] rows."""
    a = np.asarray(intervals, dtype=np.int64).reshape(-1, 2)
    a = np.clip(a, lo, hi)
    a = a[a[:, 1] > a[:, 0]]
    if a.size == 0:
        return a
    a = a[np.argsort(a[:, 0], kind="stable")]
    ends = np.maximum.accumulate(a[:, 1])
    new = np.ones(len(a), bool)
    new[1:] = a[1:, 0] > ends[:-1]
    starts = a[new, 0]
    idx = np.flatnonzero(new)
    stops = ends[np.r_[idx[1:] - 1, len(a) - 1]]
    return np.stack([starts, stops], axis=1)


def union_ns(intervals, lo: int, hi: int) -> int:
    m = merged(intervals, lo, hi)
    return int((m[:, 1] - m[:, 0]).sum()) if m.size else 0


def gaps(intervals, lo: int, hi: int) -> np.ndarray:
    """The idle [start, end) ns gaps of [lo, hi] outside the union."""
    m = merged(intervals, lo, hi)
    if m.size == 0:
        return np.array([[lo, hi]], dtype=np.int64)
    starts = np.r_[lo, m[:, 1]]
    stops = np.r_[m[:, 0], hi]
    g = np.stack([starts, stops], axis=1)
    return g[g[:, 1] > g[:, 0]]


def by_card(events) -> dict:
    """card -> [(start, end)] of the events."""
    cards = defaultdict(list)
    for card, _, _, t0, t1 in events:
        cards[card].append((t0, t1))
    return cards


def busy_s(events, cards, lo: int, hi: int) -> float:
    """The seconds in [lo, hi] in which something ran on a card, averaged
    over ``cards`` (a card with no event counts 0)."""
    per = by_card(events)
    return sum(union_ns(per.get(c, []), lo, hi) for c in cards) / (
        1e9 * max(len(cards), 1))


def top_ops(events, k: int = 10) -> list:
    """The ``k`` device operations with the most summed seconds."""
    tot = defaultdict(int)
    for _, _, name, t0, t1 in events:
        tot[name] += t1 - t0
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
    return [[name[:200], ns / 1e9] for name, ns in best]


def idle_by_host(events, card, spans, lo: int, hi: int, k: int = 10):
    """Idle seconds of ``card`` in [lo, hi], by what the host was doing at
    each gap's middle: the wrapped methods running then (``spans``: a
    ``Spans``), joined by '+', or 'other'. The ``k`` largest sums."""
    g = gaps(by_card(events).get(card, []), lo, hi)
    if g.size == 0:
        return []
    mid = (g[:, 0] + g[:, 1]) // 2
    labels = np.full(len(g), "", dtype=object)
    for spec, rows in sorted(spans.by_name.items()):
        if not rows:
            continue
        a = np.array([(t0, t0 + d) for _, t0, d in rows], dtype=np.int64)
        a = a[np.argsort(a[:, 0], kind="stable")]
        run_end = np.maximum.accumulate(a[:, 1])
        i = np.searchsorted(a[:, 0], mid, side="right") - 1
        on = (i >= 0) & (run_end[np.maximum(i, 0)] > mid)
        short = spec.rsplit(".", 2)
        name = f"{short[-2]}.{short[-1]}"
        labels[on] = [f"{s}+{name}" if s else name for s in labels[on]]
    tot = defaultdict(int)
    for lab, (a, b) in zip(labels, g):
        tot[lab or "other"] += int(b - a)
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
    return [[lab, ns / 1e9] for lab, ns in best]

