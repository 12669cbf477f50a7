"""The harness on a card at the tiny shape: its traced run reads the
device (busy time, idle share, the breakdown) and its check holds.
Marked ``cuda``; skips where there is no card, decided in the test."""

import time

import pytest
import torch

from portbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", ["offline"])
def test_traced_run_on_the_card(tiny_root, traffic):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = harness.run_cell(f"tiny.{traffic}", 2 ** 33 + 5, 1.0, True,
                         time.perf_counter(), root=tiny_root)
    assert r["correct"]
    dev = r["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert 0 <= r["metrics"]["device_idle_share"]["value"] < 100
    assert r["breakdown"]["device_ops"]
