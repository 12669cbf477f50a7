"""The arithmetic of the metrics: xrt, the union and idle gaps of device
intervals, the set-up's parts."""

import pytest

from portbench import harness, trace
from portbench.metrics import (device_idle_share, kernel_build_s, setup_s,
                               xrt)
from portbench.spans import Spans

from conftest import tiny_config


def _run(**kw):
    r = harness.Run(config=tiny_config(), traffic={"batch_blocks": 8},
                    rate=44100, block_frames=256)
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_xrt_counts_all_frames_over_all_the_time():
    r = _run(frames=44100 * 30, window_s=2.0)
    assert xrt.read(r) == pytest.approx(15.0)


def test_union_counts_overlap_once_and_clips_to_the_window():
    iv = [(0, 10), (5, 20), (30, 40), (35, 38), (95, 130)]
    assert trace.union_ns(iv, 0, 100) == 20 + 10 + 5
    assert trace.gaps(iv, 0, 100).tolist() == [[20, 30], [40, 95]]
    assert trace.union_ns([], 0, 100) == 0
    assert trace.gaps([], 0, 100).tolist() == [[0, 100]]


def test_idle_share_averages_the_cards():
    ev = [(0, "kernel", "k", 0, 50), (0, "gpu_memcpy", "Memcpy HtoD", 25,
                                      75), (1, "kernel", "k", 0, 25)]
    r = _run(events=ev, cards=[0, 1], lo=0, hi=100)
    # card 0 busy 75 of 100, card 1 25: busy 0.5 on average
    assert device_idle_share.read(r) == pytest.approx(50.0)
    assert trace.busy_s(ev, [0, 1], 0, 100) == pytest.approx(50e-9)


def test_idle_gaps_by_what_the_host_was_doing():
    sp = Spans()
    sp.by_name["runtime.engine.Engine._write_outputs"] = [("w", 0, 60)]
    sp.by_name["runtime.device_io.DeviceIO.multi_step"] = [("m", 50, 30)]
    ev = [(0, "kernel", "k", 10, 20), (0, "kernel", "k", 40, 45)]
    out = dict(trace.idle_by_host(ev, 0, sp, 0, 100))
    # gaps [0,10) mid 5, [20,40) mid 30: writer; [45,100) mid 72: dispatch
    assert out == {"Engine._write_outputs": 30e-9,
                   "DeviceIO.multi_step": 55e-9}


def test_event_kinds_by_name():
    assert trace.kind_of("Memcpy HtoD (Pageable -> Device)") == "gpu_memcpy"
    assert trace.kind_of("Memset (Device)") == "gpu_memset"
    assert trace.kind_of("void mac_group_kernel<4>(...)") == "kernel"


def test_kernel_build_is_read_apart_from_the_set_up():
    r = _run(setup_s=31.5, kernel_build_s=24.0)
    assert setup_s.read(r) == 31.5 and kernel_build_s.read(r) == 24.0
    # a run on the CPU builds nothing: the metric is left out
    assert kernel_build_s.read(_run()) is None
