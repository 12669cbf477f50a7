"""The harness's plumbing at a tiny shape on the CPU (the look for a card
skipped): every traffic mix runs its entry, is checked against the
reference and reports its metrics, the device's as not measured. Then
the same runs with the timed path broken underneath, once for each
fault the cells can have, and ``correct`` comes out false."""

import time

import pytest
import torch

from portbench import check, harness
from brutefir_tpu_torch.runtime.device_io import DeviceIO
from brutefir_tpu_torch.runtime.program import tree_map

CPU = torch.device("cpu")
HOST = {"engine_init_s", "dispatch_ms_per_block", "read_ms_per_block",
        "writer_ms_per_block"}


def _run(root, name, traced=False, seed=2 ** 31 + 99, **kw):
    return harness.run_cell(name, seed, 0.6, traced, time.perf_counter(),
                            device=CPU, root=root, **kw)


@pytest.mark.parametrize("traffic", ["offline"])
@pytest.mark.parametrize("traced", [False, True])
def test_rehearsal(tiny_root, traffic, traced):
    r = _run(tiny_root, f"tiny.{traffic}", traced)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert r["checks"]["max_gap_lsb"]["value"] <= 1
    assert r["device"] == {"platform": "cpu", "kind": "not measured",
                           "count": 1, "memory_peak_bytes": "not measured"}
    if traced:
        # host spans are read; device metrics have no trace to read
        assert set(r["metrics"]) == HOST
        assert "breakdown" not in r
    else:
        assert set(r["metrics"]) == {"xrt", "setup_s"}
        assert r["metrics"]["xrt"]["value"] > 0


def _state_unchanged(monkeypatch):
    """Every step hands back the state it was given."""
    for name in ("step_eager", "multi_step_eager"):
        orig = getattr(DeviceIO, name)

        def broken(self, state, *a, _orig=orig, **k):
            before = tree_map(torch.clone, state)
            _, *rest = _orig(self, state, *a, **k)
            return (before, *rest)

        monkeypatch.setattr(DeviceIO, name, broken)


def _half_batch(monkeypatch):
    """A batch runs its first half of blocks only and writes their
    outputs twice."""
    orig = DeviceIO.multi_step_eager

    def broken(self, state, ctrl, in_gain, out_gain, bank, in_words, **k):
        h = in_words[0].shape[0] // 2
        st, outs, meters, nan_ok = orig(self, state, ctrl, in_gain,
                                        out_gain, bank,
                                        [w[:h] for w in in_words], **k)
        return st, [torch.cat([o, o]) for o in outs], meters, nan_ok

    monkeypatch.setattr(DeviceIO, "multi_step_eager", broken)


def _answer_altered(monkeypatch):
    """One output sample a block, its sign flipped, where the output is
    encoded."""
    orig = DeviceIO.output_half

    def broken(self, y, out_gain):
        y = y.clone()
        y[0, 5] = -y[0, 5]
        return orig(self, y, out_gain)

    monkeypatch.setattr(DeviceIO, "output_half", broken)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}
# the faults the cell can have (no exchange between cards: one card)
CASES = [("offline", f) for f in FAULTS]


@pytest.mark.parametrize("traffic,fault", CASES)
def test_fault_is_not_correct(tiny_root, monkeypatch, traffic, fault):
    FAULTS[fault](monkeypatch)
    r = _run(tiny_root, f"tiny.{traffic}")
    assert not r["correct"]
    assert r["checks"]["max_gap_lsb"]["value"] > r["checks"][
        "max_gap_lsb"]["limit"]
    assert r["failed"] > 0


def test_program_in_bf16_is_not_correct(tiny_root):
    """The control the program has a path for: its bf16 bank and ring."""
    r = harness.run_cell("tiny.offline", 41, 0.6, False, time.perf_counter(),
                         device=CPU, root=tiny_root,
                         knobs={k: "bf16" for k in harness.PRECISION_KNOBS})
    assert not r["correct"]
    assert r["checks"]["max_gap_lsb"]["value"] > 3 * r["checks"][
        "max_gap_lsb"]["limit"]


def test_tf32_control_is_not_correct(tiny_root):
    """The control, the reference in TF32 put in the program's place at
    the same written frames, judged by the comparison that decides
    ``correct``."""
    r = _run(tiny_root, "tiny.offline", seed=2 ** 32 + 41,
             keep_reference=True)
    assert r["correct"]
    reference, kept = r.pop("_reference")
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    numbers, over = check.compare(
        check.control_writes(kept, reference, "tf32"), reference, limits)
    assert not all(ok for *_, ok in numbers.values())
    assert numbers["max_gap_lsb"][0] > 3 * limits["max_gap_lsb"]
    assert over > 0
    # the program's own writes, put back through the same path, pass
    same = [(pos, reference.encode(reference.decode(data)))
            for pos, data in kept]
    assert all(ok for *_, ok in check.compare(same, reference,
                                              limits)[0].values())
