"""The kernel metrics of one layer, on a synthetic run: each sums the
device time of its own named kernels in the window, over the window's
blocks, and finds nothing to read without a trace."""

import pytest

from portbench import harness, kernel_time
from portbench.metrics import glue_ms_per_block, group_ms_per_block

from conftest import tiny_config

NS = 1_000_000          # a millisecond


def _run(events=None, blocks=8, cards=(0,)):
    r = harness.Run(config=tiny_config(), traffic={"batch_blocks": 8},
                    rate=44100, block_frames=256)
    r.events, r.blocks, r.cards = events, blocks, list(cards)
    r.lo, r.hi = 0, 100 * NS
    return r


def _kernel(name, t0_ms, ms, kind="kernel"):
    return (0, kind, name, t0_ms * NS, int((t0_ms + ms) * NS))


EVENTS = [
    _kernel("void (anonymous namespace)::mac_group_kernel<4>(float const*,"
            " float const*)", 1, 0.5),
    _kernel("void (anonymous namespace)::mac_group_kernel<4>(float const*,"
            " float const*)", 11, 0.5),
    _kernel("void (anonymous namespace)::mac_mix_group_bf16_kernel<"
            "__nv_bfloat16, 2>(...)", 21, 0.25),
    _kernel("void (anonymous namespace)::glue_fwd_ring_kernel<float, "
            "float>(float2 const*, float4 const*)", 2, 0.1),
    _kernel("void (anonymous namespace)::glue_fwd_ring_kernel<float, "
            "float>(float2 const*, float4 const*)", 3, 0.1),
    _kernel("void (anonymous namespace)::glue_inv_kernel<float>(float "
            "const*)", 4, 0.2),
    _kernel("void (anonymous namespace)::glue_fwd_kernel<float>(float2 "
            "const*)", 5, 0.2),
    # not theirs: another kernel, a copy, a kernel outside the window
    _kernel("void (anonymous namespace)::mac_mix_kernel<float, float, true"
            ">(...)", 6, 3.0),
    _kernel("Memcpy HtoD (Pageable -> Device)", 7, 3.0, "gpu_memcpy"),
    _kernel("void (anonymous namespace)::mac_group_kernel<4>(float const*,"
            " float const*)", 150, 9.0),
    _kernel("void vector_fft<65536u, 16u, 1u>(...)", 8, 3.0),
]


@pytest.mark.parametrize("metric,want_ms", [
    (group_ms_per_block, 0.5 + 0.5 + 0.25),
    (glue_ms_per_block, 0.1 + 0.1 + 0.2 + 0.2)])
def test_sums_only_its_named_kernels_over_the_blocks(metric, want_ms):
    for blocks in (8, 4):
        assert metric.read(_run(EVENTS, blocks)) == pytest.approx(
            want_ms / blocks)


@pytest.mark.parametrize("metric", [group_ms_per_block, glue_ms_per_block])
@pytest.mark.parametrize("case", ["no trace", "no card", "no block",
                                  "none of its kernels"])
def test_reads_nothing_without_its_kernels(metric, case):
    run = {"no trace": _run(None),
           "no card": _run(EVENTS, cards=()),
           "no block": _run(EVENTS, blocks=0),
           "none of its kernels": _run(EVENTS[7:])}[case]
    assert metric.read(run) is None


def test_kernel_names_are_the_functions_of_the_sources():
    from pathlib import Path
    csrc = Path(harness.ROOT) / "brutefir_tpu_torch" / "csrc"
    text = ((csrc / "mac_group.cu").read_text()
            + (csrc / "fft_glue.cu").read_text())
    for name in group_ms_per_block.KERNELS + glue_ms_per_block.KERNELS:
        assert f"\n{name}(" in text, name


@pytest.mark.parametrize("event,name", [
    ("void (anonymous namespace)::glue_inv_kernel<double>(double const*)",
     "glue_inv_kernel"),
    ("void mac_group_kernel<3>(float const*)", "mac_group_kernel"),
    ("glue_fwd_kernel<float>(float2 const*)", "glue_fwd_kernel"),
    ("Memcpy DtoH (Device -> Pageable)", "Memcpy DtoH (Device -> Pageable)"),
])
def test_function_name_of_an_event(event, name):
    assert kernel_time.function_name(event) == name
