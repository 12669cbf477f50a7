"""brutefir_tpu_torch on a CUDA card: each kernel against its plain torch
version on the same CUDA tensors, and the engine on the card against the
engine on the CPU. Every test here is marked ``cuda`` and skips where
there is no card (a CUDA kernel has no CPU mode).

This file imports no jax, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

Tolerances: the kernel within 1e-5 of the output's max magnitude (float32
sums in another order, FMA contraction); the engine on the card within
2 LSB of S24 of the CPU engine and of a float64 oracle (cuFFT and the
CPU FFT round differently; outputs here peak near 2^22, where a float32
ulp is half an LSB).
"""

import json
import time

import numpy as np
import pytest
import torch

from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.ops import (fft_fused as tf, fft_glue as tg,
                                    mac as tm, mac_dual as td,
                                    mac_group as mg, mac_mix as mm)
from brutefir_tpu_torch.ops.mac_mix import with_bf16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _mac_inputs(seed, F, B, K, E, C, uniform, dev):
    rng = np.random.default_rng(seed)
    ring = rng.standard_normal((F, B, 2, K)).astype(np.float32)
    bank = rng.standard_normal((E, B, 2, K)).astype(np.float32)
    if uniform:
        idx = np.full(F, E - 1, np.int32)
        mask = np.tile((rng.uniform(size=B) > 0.3).astype(np.float32), (F, 1))
    else:
        idx = (np.arange(F) % E).astype(np.int32)
        mask = (rng.uniform(size=(F, B)) > 0.3).astype(np.float32)
    mask[:, -1] = 0.0
    w = rng.standard_normal((C, F)).astype(np.float32)
    return [torch.as_tensor(a, device=dev)
            for a in (ring, bank, idx, mask, w)]


@pytest.mark.cuda
@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("F,B,K,E,C", [
    (5, 6, 512, 3, 7),
    (5, 6, 384, 3, 40),
    (5, 6, 8192, 3, 26),
    (26, 16, 8192, 2, 26),     # the massive shape
    (1, 6, 1000, 3, 1),        # K not a multiple of the 32-bin tile
    (17, 6, 33, 3, 33),        # two rounds of 9 warps, one idle in the last
    (13, 6, 200, 3, 128),
    (255, 4, 100, 3, 256),     # F past one chunk: the shared out tile
    (3, 2, 65536, 2, 1),       # 2048 tiles
    (4, 3, 1001, 2, 5),        # K % 4 != 0: runs copied with their skews
    (2, 3000, 128, 2, 1),      # a bank tile too big to stage: streamed
])
def test_kernel_matches_plain_version(cuda, uniform, F, B, K, E, C):
    """csrc/mac_mix.cu at the edges of its plan (mac_mix.plan): ragged
    bin tiles, filters that do not fill the warps or one chunk, 1 to 256
    outputs at small K (the shapes the first form accumulated in device
    memory), runs with and without 16-byte alignment, the uniform bank
    tile staged or streamed; t over ring wraps."""
    assert not mm.tiled_route(C, B, K)
    ring, bank, idx, mask, w = _mac_inputs(K + C + F, F, B, K, E, C,
                                           uniform, cuda)
    form = "uniform" if uniform else "rows"
    for tv in (0, 4, B - 1, B, 2 * B + 5):
        t = torch.tensor(tv, dtype=torch.int32, device=cuda)
        before = mm.launches[form]
        got = mm.mac_mix(ring, bank, idx, mask, t, w, uniform)
        ref = mm.mac_mix_reference(ring, bank, idx, mask, t, w, uniform)
        torch.cuda.synchronize()
        assert mm.launches[form] == before + 1
        assert got.shape == (C, 2, K)
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        assert err <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("F,B,K,E,C", [
    (5, 3, 1000, 3, 37),       # K not a multiple of the 32-bin tile
    (13, 4, 8200, 5, 300),     # C past one block's 256 rows, F % 8 != 0
    (9, 2, 24, 4, 3),          # small mix: the 4-row form
])
def test_tiled_kernel_matches_plain_version(cuda, monkeypatch, F, B, K, E,
                                            C):
    """The bin-tiled kernel at odd sizes (E < F), forced by the route."""
    monkeypatch.setattr(mm, "tiled_route", lambda *a: True)
    ring, bank, idx, mask, w = _mac_inputs(F * K + C, F, B, K, E, C, False,
                                           cuda)
    for tv in (0, B - 1, B, 3 * B + 2):
        t = torch.tensor(tv, dtype=torch.int32, device=cuda)
        before = mm.launches["tiled"]
        got = mm.mac_mix(ring, bank, idx, mask, t, w, False)
        ref = mm.mac_mix_reference(ring, bank, idx, mask, t, w, False)
        torch.cuda.synchronize()
        assert mm.launches["tiled"] == before + 1
        assert got.shape == (C, 2, K)
        assert (got - ref).abs().max().item() / ref.abs().max().item() <= 1e-5


def _at_offset(x, offset):
    """``x`` as a contiguous tensor ``offset`` floats into a larger buffer
    on its device (offset 1: its runs are not 16-byte aligned)."""
    buf = torch.zeros(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


# (F, B, K, E, stage rows, ring offset in floats): the shapes of the MAC
# core's paths (csrc/mac_core.cuh)
MAC_CORE_SHAPES = [
    (6, 8, 8192, 7, [2, 3, 4, 5], 0),    # bench1's first stage
    (5, 6, 1000, 3, [4, 1, 1], 0),       # K not a multiple of the tile
    (3, 2, 64, 2, [0, 1, 2], 0),         # an xtc-like short partition
    (4, 64, 64, 2, [0, 1, 2, 3], 0),     # xtc_lowlatency.conf: 64 x 64
    (5, 6, 1001, 3, [4, 1, 1], 0),       # K % 4 != 0: the scalar path
    (6, 8, 8192, 7, [2, 3, 4, 5], 1),    # a ring view not 16-byte aligned
    (4, 8, 8192, 3, [2], 0),             # one stage filter
    (3, 1, 512, 2, [0, 2], 0),           # one partition
    (3, 24, 1024, 2, [2, 0, 1], 0),      # several load groups
    (3, 4, 100, 2, [1, 2], 0),           # K under one block's bins
    (40, 4, 8192, 2, list(range(40)) + [3, 3], 0),  # more blocks than SMs
]


@pytest.mark.cuda
@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("F,B,K,E,rows,offset", MAC_CORE_SHAPES)
def test_unfused_mac_kernel_matches_plain_version(cuda, uniform, F, B, K, E,
                                                  rows, offset):
    """csrc/mac.cu: the stage's rows read in place, t over ring wraps."""
    ring, bank, idx, mask, _ = _mac_inputs(F * K, F, B, K, E, 1, uniform,
                                           cuda)
    mask[:, 0] = 1.0                 # no all-zero mask row at small B
    ring = _at_offset(ring, offset)
    r = torch.tensor(rows, dtype=torch.int32, device=cuda)
    form = "mac_uniform" if uniform else "mac_rows"
    for tv in (0, 3, B - 1, B, 2 * B + 5):
        t = torch.tensor(tv, dtype=torch.int32, device=cuda)
        before = tm.launches[form]
        got = tm.mac(ring, bank, r, idx, mask, t, uniform)
        ref = tm.mac_reference(ring, bank, r, idx, mask, t, uniform)
        torch.cuda.synchronize()
        assert tm.launches[form] == before + 1
        assert got.shape == (len(rows), 2, K)
        assert (got - ref).abs().max().item() / ref.abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("F,B,K,E,rows,offset", [
    (26, 8, 8192, 2, list(range(26)), 0),   # bench5's shape
] + MAC_CORE_SHAPES)
def test_dual_mac_kernel_matches_plain_version(cuda, uniform, F, B, K, E,
                                               rows, offset):
    """csrc/mac_dual.cu: both products against two plain MACs, the
    stage's rows read in place, prev_mask != mask, t over ring wraps;
    the new-set product equal to csrc/mac.cu's, bit for bit (one core)."""
    ring, bank, idx, mask, _ = _mac_inputs(F * K + 1, F, B, K, E, 1,
                                           uniform, cuda)
    mask[:, 0] = 1.0
    ring = _at_offset(ring, offset)
    pidx = (idx + 1) % E
    pmask = mask.clone()
    pmask[:, max(1, B // 2):] = 0.0      # B = 1: keep the one partition
    r = torch.tensor(rows, dtype=torch.int32, device=cuda)
    form = "mac_dual_uniform" if uniform else "mac_dual_rows"
    for tv in (0, 5, B - 1, B, 2 * B + 5):
        t = torch.tensor(tv, dtype=torch.int32, device=cuda)
        before = td.launches[form]
        got = td.mac_dual(ring, bank, r, idx, mask, pidx, pmask, t, uniform)
        ref = td.mac_dual_reference(ring, bank, r, idx, mask, pidx, pmask,
                                    t, uniform)
        torch.cuda.synchronize()
        assert td.launches[form] == before + 1
        for a, b in zip(got, ref):
            assert a.shape == (len(rows), 2, K)
            assert (a - b).abs().max().item() / b.abs().max().item() <= 1e-5
        assert torch.equal(got[0], tm.mac(ring, bank, r, idx, mask, t,
                                          uniform))


@pytest.mark.cuda
@pytest.mark.parametrize("sets", [1, 2])
@pytest.mark.parametrize("Fs,K", [
    (4, 8192), (52, 8192), (26, 8192), (256, 8192), (4, 65536), (1, 100),
    (40, 1024), (33, 1024), (132, 256), (133, 256), (4, 64)])
def test_mac_core_plan_covers(cuda, sets, Fs, K):
    """csrc/mac_core.cuh's plan at the engine's and the smoke's shapes: the
    grid covers every (filter, bin) once as the kernel reads it (a block a
    filter and 256 bins, 4 a thread), and one set loads 8 partitions a
    group on a grid of at most one block an SM (132), else 4; the bf16
    forms the same, but one set reading a shared bf16 bank row beside a
    float32 ring, which takes groups of 8 on every grid."""
    p = tm.launch_plan(sets, Fs, K)
    tiles, gy = p["grid"]
    assert p["threads"] == 64 and gy == Fs
    assert (tiles - 1) * 256 < K <= tiles * 256
    assert p["group"] == (8 if sets == 1 and tiles * Fs <= 132 else 4)
    bf = torch.bfloat16
    for uniform in (False, True):
        for ring_dtype, bank_dtype in ((None, None), (bf, None), (None, bf),
                                       (bf, bf)):
            q = tm.launch_plan(sets, Fs, K, torch.float32, uniform,
                               ring_dtype, bank_dtype)
            shared_bank = sets == 1 and uniform and bank_dtype and \
                not ring_dtype
            assert q == ({**p, "group": 8} if shared_bank else p)


@pytest.mark.cuda
@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("F,B,K,E,rows,offset", MAC_CORE_SHAPES)
def test_unfused_mac_f64_kernel_matches_plain_version(cuda, uniform, F, B,
                                                      K, E, rows, offset):
    """csrc/mac.cu's float64 form (``bf_mac_f64``) at the MAC core's
    shapes: within 1e-12 of the plain float64 version (FP64 FMAs against
    separate products and sums), its own launch count, the float32
    counts untouched."""
    ring, bank, idx, mask, _ = _mac_inputs(F * K + 2, F, B, K, E, 1,
                                           uniform, cuda)
    ring, bank, mask = ring.double(), bank.double(), mask.double()
    mask[:, 0] = 1.0
    ring = _at_offset(ring, offset)
    r = torch.tensor(rows, dtype=torch.int32, device=cuda)
    form = "mac_uniform_f64" if uniform else "mac_rows_f64"
    for tv in (0, 3, B - 1, B, 2 * B + 5):
        t = torch.tensor(tv, dtype=torch.int32, device=cuda)
        before = dict(tm.launches)
        got = tm.mac(ring, bank, r, idx, mask, t, uniform)
        ref = tm.mac_reference(ring, bank, r, idx, mask, t, uniform)
        torch.cuda.synchronize()
        assert tm.launches == {**before, form: before[form] + 1}
        assert got.dtype == torch.float64 and got.shape == (len(rows), 2, K)
        assert (got - ref).abs().max().item() / ref.abs().max().item() <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("Fs,K", [(4, 8192), (26, 8192), (52, 8192),
                                  (256, 8192), (4, 65536), (4, 64)])
def test_mac_core_plan_f64(cuda, Fs, K):
    """The float64 form's plan: the float32 grid, and its own group of
    partitions (fewer: each holds twice the registers)."""
    p = tm.launch_plan(1, Fs, K, torch.float64)
    q = tm.launch_plan(1, Fs, K)
    assert p["grid"] == q["grid"] and p["threads"] == q["threads"]
    tiles = p["grid"][0]
    assert p["group"] == (4 if tiles * Fs <= 132 else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,M,C", [
    (k, M, C) for k in ("glue_fwd", "glue_inv")
    for M in (1, 3, 64, 255, 256, 4097, 8192) for C in (1, 3, 256)])
def test_fft_glue_f64_kernels_match_plain_versions(cuda, kernel, M, C):
    """csrc/fft_glue.cu's float64 form on complex128 / float64 planes
    with the float64 table: within 1e-12 of the plain float64 version."""
    g = torch.Generator(device="cpu").manual_seed(M * C)
    before = dict(tg.launches)
    if kernel == "glue_fwd":
        z = torch.randn(C, M, dtype=torch.complex128, generator=g).to(cuda)
        got, ref = tg.glue_fwd(z), tg.glue_fwd_reference(z)
    else:
        p = torch.randn(C, 2, M, dtype=torch.float64, generator=g).to(cuda)
        got = torch.view_as_real(tg.glue_inv(p))
        ref = torch.view_as_real(tg.glue_inv_reference(p))
    torch.cuda.synchronize()
    key = kernel + "_f64"
    assert tg.launches == {**before, key: before[key] + 1}
    assert got.dtype == torch.float64 and got.shape == ref.shape
    assert (got - ref).abs().max().item() / ref.abs().max().item() <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["S24_4LE", "FLOAT64_LE"])
def test_float64_engine_on_card_matches_cpu(cuda, tmp_path, fmt):
    """A ``float_bits: 64`` config on the card and on the CPU (S24_4LE:
    the device codec path; FLOAT64_LE: the host path), filters 0 and 2
    crossfading under a CLI script: the float64 MAC and glue kernels
    only (two MACs a crossfade block, no float32 kernel), S24 words
    within 1 LSB of the CPU's, FLOAT64 within 1e-12 of the peak."""
    from brutefir_tpu_torch.runtime.engine import Engine
    N, B, C = 256, 4, 3
    rng = np.random.default_rng(17)
    for k, n in ((0, N * B), (1, N * 2 + 9)):
        (tmp_path / f"c{k}.txt").write_text("\n".join(
            repr(float(v)) for v in rng.standard_normal(n) * 0.1) + "\n")
    frames = N * 11 + 77
    x = rng.standard_normal((frames, C))
    if fmt == "S24_4LE":
        np.clip(np.round(x * 2 ** 19), -(2 ** 23), 2 ** 23 - 1).astype(
            "<i4").tofile(tmp_path / "in.raw")
    else:
        (x * 0.3).astype("<f8").tofile(tmp_path / "in.raw")
    script = "sleep b3\\ncfc 0 1; cfc 2 1\\nsleep b4\\ncfc 0 0\\nsleep b99"

    def conf(name):
        return parse_config(f"""
sampling_rate: 44100;
float_bits: 64;
filter_length: {N},{B};
coeff 0 {{ filename: "{tmp_path / 'c0.txt'}"; format: "TEXT"; }};
coeff 1 {{ filename: "{tmp_path / 'c1.txt'}"; format: "TEXT"; }};
input 0,1,2 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "{fmt}"; channels: {C}; }};
output 0,1,2 {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "{fmt}"; channels: {C}; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; crossfade: true; }};
filter 1 {{ from_inputs: 1; to_outputs: 1; coeff: 1; }};
filter 2 {{ from_inputs: 2; to_outputs: 2; coeff: 0; crossfade: true; }};
logic: "cli" {{ script: "{script}"; echo: false; }};
""")

    for m in (tm, td, mm, mg, tg):
        m.reset_launches()
    eg = Engine(conf("gpu.raw"), device=cuda)
    assert (eg.dio is None) == (fmt == "FLOAT64_LE")
    sg = eg.run()
    blocks = sg["blocks"]
    assert blocks == 12
    # one MAC a block, one more on the two crossfade blocks; uniform
    # while every filter runs set 1
    assert tm.launches["mac_uniform"] == tm.launches["mac_rows"] == 0
    assert (tm.launches["mac_uniform_f64"] + tm.launches["mac_rows_f64"]
            == blocks + 2)
    assert tm.launches["mac_uniform_f64"] > 0
    assert tg.launches == {**dict.fromkeys(tg.launches, 0),
                           "glue_fwd_ring_f64": blocks,
                           "glue_inv_f64": blocks}
    assert not any(td.launches.values()) and not any(mm.launches.values())
    assert not any(mg.launches.values())
    Engine(conf("cpu.raw"), device=torch.device("cpu")).run()
    dt = "<i4" if fmt == "S24_4LE" else "<f8"
    yg, yc = (np.fromfile(tmp_path / f"{t}.raw", dt).astype(np.float64)
              for t in ("gpu", "cpu"))
    assert yg.size == frames * C
    if fmt == "S24_4LE":
        assert np.abs(yc).max() > 2 ** 20 and np.abs(yg - yc).max() <= 1
    else:
        assert np.abs(yg - yc).max() <= 1e-12 * np.abs(yc).max()


@pytest.mark.cuda
def test_failed_dual_launch_raises(cuda, monkeypatch):
    class Refused:
        def __getattr__(self, name):
            return lambda *a: 9          # cudaErrorInvalidConfiguration
    monkeypatch.setattr(td._build, "load", lambda stem: Refused())
    ring, bank, idx, mask, _ = _mac_inputs(2, 3, 2, 128, 2, 1, False, cuda)
    t = torch.tensor(0, dtype=torch.int32, device=cuda)
    before = dict(td.launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        td.mac_dual(ring, bank, idx[:2], idx, mask, idx, mask, t, False)
    assert td.launches == before


def _group_inputs(seed, F, B, K, E, G, C, dev):
    rng = np.random.default_rng(seed)
    ring = rng.standard_normal((F, B, 2, K)).astype(np.float32)
    xnews = rng.standard_normal((F, G - 1, 2, K)).astype(np.float32)
    bank = rng.standard_normal((E, B, 2, K)).astype(np.float32)
    idx = rng.integers(0, E, F).astype(np.int32)
    delay = (np.arange(F) % (G + 2)).clip(0, B - 1).astype(np.int32)
    mask = (np.arange(B)[None, :] < (B - delay)[:, None]).astype(np.float32)
    w = rng.standard_normal((C, F)).astype(np.float32)
    return [torch.as_tensor(a, device=dev)
            for a in (ring, xnews, bank, idx, mask, delay, w)]


@pytest.mark.cuda
@pytest.mark.parametrize("G", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("F,B,K,E,C", [
    (7, 6, 1000, 3, 9),        # K not a multiple of any tile
    (19, 9, 300, 5, 70),       # F % 16 != 0, C past one block at G >= 5
    (256, 16, 1024, 256, 256),  # the full-width rows, 16 rounds of 16
    (20, 5, 1000, 4, 300),     # C past one block's rows at every G
    (40, 3, 96, 3, 33),        # E < F: every bank row used many times
])
def test_group_kernels_match_plain_versions(cuda, G, F, B, K, E, C):
    """Both grouped kernels: delays 0 .. G+1 (clamped to B-1), the
    cblocks mask, start times that wrap the ring inside the group; for
    bf_mac_mix_group the full-width accumulator layout (C = F = E = 256),
    outputs past one block's rows (gridDim.y), a ragged last bin tile
    and repeated bank rows."""
    ring, xnews, bank, idx, mask, delay, w = _group_inputs(
        G * 100 + K, F, B, K, E, G, C, cuda)
    for tv in (0, B - 1, 2 * B + 1):
        t = torch.tensor(tv, dtype=torch.int32, device=cuda)
        before = dict(mg.launches)
        got = mg.mac_group(ring, xnews, bank, idx, mask, t, delay)
        ref = mg.mac_group_reference(ring, xnews, bank, idx, mask, t, delay)
        gotm = mg.mac_mix_group(ring, xnews, bank, idx, mask, t, w, delay)
        refm = mg.mac_mix_group_reference(ring, xnews, bank, idx, mask, t,
                                          w, delay)
        torch.cuda.synchronize()
        assert mg.launches == {**before, "group": before["group"] + 1,
                               "mix_group": before["mix_group"] + 1}
        assert got.shape == (G, F, 2, K) and gotm.shape == (G, C, 2, K)
        for a, b in ((got, ref), (gotm, refm)):
            assert (a - b).abs().max().item() / b.abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("G", [2, 3, 5, 8])
@pytest.mark.parametrize("K", [1000, 1003])
def test_mix_group_unaligned_operands(cuda, G, K):
    """bf_mac_mix_group where its runs cannot be copied 16 bytes at a
    time: ring and xnews views one float into their buffers (K = 1000),
    and K % 4 != 0 (every run unaligned)."""
    F, B, E, C = 18, 5, 4, 40
    ring, xnews, bank, idx, mask, delay, w = _group_inputs(
        G + K, F, B, K, E, G, C, cuda)

    def at_offset(x):
        buf = torch.zeros(x.numel() + 1, device=cuda)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        return view
    ring, xnews = at_offset(ring), at_offset(xnews)
    for tv in (0, B - 1, 2 * B + 1):
        t = torch.tensor(tv, dtype=torch.int32, device=cuda)
        got = mg.mac_mix_group(ring, xnews, bank, idx, mask, t, w, delay)
        ref = mg.mac_mix_group_reference(ring, xnews, bank, idx, mask, t,
                                         w, delay)
        torch.cuda.synchronize()
        assert (got - ref).abs().max().item() / ref.abs().max().item() \
            <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [(0, 0), (1, 0), (0, 1), (1, 1)])
@pytest.mark.parametrize("G", range(2, mg.MAX_GROUP + 1))
@pytest.mark.parametrize("C_out", [1, 9, 70, 256, 300])
def test_mix_group_plan_fits_the_card(cuda, flags, G, C_out):
    """The launch bf_mac_mix_group makes, in float32 and in each bf16
    form (``flags``: ring_bf16, bank_bf16): 32-bin tiles, its rows over
    gridDim.y cover C_out, its shared memory fits a block (232,448 bytes)
    and the device's limit, its threads the block limit; 64 accumulators
    a thread (rows x padded G x 64 = threads x 64); the library's plan
    is ``mix_group_layout``'s (its Python mirror)."""
    p = mg.mix_group_plan(G, C_out, *flags)
    assert p == mg.mix_group_layout(G, C_out, *(2 if f else 4
                                                for f in flags))
    props = torch.cuda.get_device_properties(cuda)
    assert p["bins"] == 32 and p["padded_g"] >= G
    assert p["grid_y"] * p["rows"] >= C_out > (p["grid_y"] - 1) * p["rows"]
    assert p["smem"] <= 232448
    assert p["smem"] <= getattr(props, "shared_memory_per_block_optin",
                                232448)
    assert p["threads"] <= 1024 and p["threads"] % 32 == 0
    assert p["rows"] * p["padded_g"] == p["threads"]
    assert p["stages"] >= 2 and p["positions"] >= 1


@pytest.mark.cuda
def test_failed_group_launch_raises(cuda):
    """A launch the card refuses (grid.y past 65535 filters) raises; it
    counts no launch."""
    F, B, K, G = 70000, 1, 1, 2
    z = torch.zeros
    args = (z(F, B, 2, K, device=cuda), z(F, G - 1, 2, K, device=cuda),
            z(1, B, 2, K, device=cuda),
            z(F, dtype=torch.int32, device=cuda), z(F, B, device=cuda),
            torch.tensor(0, dtype=torch.int32, device=cuda),
            z(F, dtype=torch.int32, device=cuda))
    before = mg.launches["group"]
    with pytest.raises(RuntimeError, match="launch failed"):
        mg.mac_group(*args)
    assert mg.launches["group"] == before


@pytest.mark.cuda
def test_failed_launches_raise(cuda, monkeypatch):
    """Every wrapper raises when its C entry reports a CUDA error."""
    class Refused:
        def __getattr__(self, name):
            return lambda *a: 9          # cudaErrorInvalidConfiguration
    monkeypatch.setattr(mm._build, "load", lambda stem: Refused())
    ring, xnews, bank, idx, mask, delay, w = _group_inputs(
        1, 3, 2, 128, 2, 2, 300, cuda)
    t = torch.tensor(0, dtype=torch.int32, device=cuda)
    before = dict(mm.launches)
    for tiled in (True, False):
        monkeypatch.setattr(mm, "tiled_route", lambda *a, _t=tiled: _t)
        for uniform in (True, False):
            with pytest.raises(RuntimeError, match="launch failed"):
                mm.mac_mix(ring, bank, idx, mask, t, w, uniform)
    assert mm.launches == before
    with pytest.raises(RuntimeError, match="launch failed"):
        tm.mac(ring, bank, idx[:2], idx, mask, t, False)
    with pytest.raises(RuntimeError, match="launch failed"):
        mg.mac_group(ring, xnews, bank, idx, mask, t, delay)
    with pytest.raises(RuntimeError, match="launch failed"):
        mg.mac_mix_group(ring, xnews, bank, idx, mask, t, w, delay)


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices(cuda):
    ring, bank, idx, mask, w = _mac_inputs(1, 2, 2, 128, 1, 2, False, cuda)
    t = torch.tensor(0, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        mm.mac_mix(ring, bank, idx, mask, t, w.cpu(), False)


def _card_and_cpu(cuda, tmp_path, coeff_of, delays=(0, 0, 0)):
    """The same S24 file through the engine on the card and on the CPU;
    checks both against each other and the card against a float64
    oracle, within 2 LSB."""
    from brutefir_tpu_torch.runtime.engine import Engine
    N, B, C = 256, 4, 3
    rng = np.random.default_rng(7)
    taps = []
    for k, n in ((0, N * B), (1, N * 2 + 9)):
        taps.append((rng.standard_normal(n) * 0.1).astype(np.float32))
        (tmp_path / f"c{k}.txt").write_text(
            "\n".join(repr(float(v)) for v in taps[k]) + "\n")
    frames = N * 11 + 77
    x = np.clip(np.round(rng.standard_normal((frames, C)) * 2 ** 19),
                -(2 ** 23), 2 ** 23 - 1).astype("<i4")
    x.tofile(tmp_path / "in.raw")

    def conf(name):
        coeffs = "".join(
            f'coeff {k} {{ filename: "{tmp_path / f"c{k}.txt"}"; '
            f'format: "TEXT"; }};\n' for k in sorted(set(coeff_of)))
        filters = "".join(
            f"filter {f} {{ from_inputs: {f}; to_outputs: {f}; "
            f"coeff: {c}; delay: {d}; }};\n"
            for f, (c, d) in enumerate(zip(coeff_of, delays)))
        return parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
{coeffs}
input 0,1,2 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: {C}; }};
output 0,1,2 {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "S24_4LE"; channels: {C}; dither: false; }};
{filters}""")

    sg = Engine(conf("gpu.raw"), device=cuda).run_offline()
    sc = Engine(conf("cpu.raw"),
                device=torch.device("cpu")).run_offline()
    assert sg["frames"] == sc["frames"] == frames
    yg = np.fromfile(tmp_path / "gpu.raw", "<i4").astype(np.int64)
    yc = np.fromfile(tmp_path / "cpu.raw", "<i4").astype(np.int64)
    assert yg.size == frames * C
    assert np.abs(yg - yc).max() <= 2
    yg = yg.reshape(frames, C)
    for c in range(C):
        # a filter delayed d blocks keeps B - d partitions of its taps
        h = taps[coeff_of[c]][:(B - delays[c]) * N].astype(np.float64)
        ref = np.convolve(x[:, c].astype(np.float64), h)[:frames]
        ref = np.concatenate([np.zeros(delays[c] * N), ref])[:frames]
        assert np.abs(yg[:, c] - np.round(ref)).max() <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("coeff_of", [[0, 0, 0], [0, 1, 0]])
def test_engine_on_card_matches_cpu(cuda, tmp_path, coeff_of):
    form = "uniform" if len(set(coeff_of)) == 1 else "rows"
    before = mm.launches[form]
    _card_and_cpu(cuda, tmp_path, coeff_of)
    assert mm.launches[form] - before == 12


@pytest.mark.cuda
@pytest.mark.parametrize("form,kernel", [("", "mix_group"),
                                         ("unfused", "group")])
def test_grouped_engine_on_card_matches_cpu(cuda, tmp_path, monkeypatch,
                                            form, kernel):
    """The batch of 8 in groups of 4 (BRUTEFIR_TPU_PAIR=force:4), with
    per-filter delays that select the group's own spectra."""
    monkeypatch.setenv("BRUTEFIR_TPU_PAIR", "force:4")
    monkeypatch.setenv("BRUTEFIR_TPU_GROUP_FORM", form)
    before = mg.launches[kernel]
    _card_and_cpu(cuda, tmp_path, [0, 1, 0], delays=(0, 1, 2))
    assert mg.launches[kernel] - before == 2


@pytest.mark.cuda
def test_cascade_engine_on_card_matches_cpu(cuda, tmp_path):
    """bench1's cascade at 256 x 4 partitions, file to file on the card
    and on the CPU: two unfused MAC launches a block, within 2 LSB."""
    from brutefir_tpu_torch.runtime.engine import Engine
    N, B = 256, 4
    rng = np.random.default_rng(9)
    for i in range(6):
        (rng.uniform(-1, 1, N * B) * 0.03).astype("<f4").tofile(
            tmp_path / f"h{i}.raw")
    frames = N * 13 + 77
    rng.integers(-(1 << 20), 1 << 20, (frames, 2)).astype("<i4").tofile(
        tmp_path / "in.raw")

    def conf(name):
        coeffs = "".join(
            f'coeff {i} {{ filename: "{tmp_path / f"h{i}.raw"}"; '
            f'format: "FLOAT_LE"; }};\n' for i in range(6))
        return parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
{coeffs}
input 0, 1 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: 2; }};
output 0, 1 {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "S24_4LE"; channels: 2; dither: false; }};
filter 0 {{ from_filters: 2, 5; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_filters: 3, 4; to_outputs: 1; coeff: 1; }};
filter 2 {{ from_inputs: 0; to_filters: 0; coeff: 2; }};
filter 3 {{ from_inputs: 0; to_filters: 1; coeff: 3; }};
filter 4 {{ from_inputs: 1; to_filters: 1; coeff: 4; }};
filter 5 {{ from_inputs: 1; to_filters: 0; coeff: 5; }};
""")

    before = dict(tm.launches)
    sg = Engine(conf("gpu.raw"), device=cuda).run_offline()
    assert tm.launches["mac_rows"] - before["mac_rows"] == 2 * sg["blocks"]
    sc = Engine(conf("cpu.raw"), device=torch.device("cpu")).run_offline()
    assert sg["frames"] == sc["frames"] == frames
    yg = np.fromfile(tmp_path / "gpu.raw", "<i4").astype(np.int64)
    yc = np.fromfile(tmp_path / "cpu.raw", "<i4").astype(np.int64)
    assert yg.size == frames * 2 and np.abs(yg).max() > 2 ** 16
    assert np.abs(yg - yc).max() <= 2


@pytest.mark.cuda
def test_crossfade_engine_on_card_matches_cpu(cuda, tmp_path):
    """A bench5-topology CLI script (every filter's coefficient flipped
    every block) at 256 x 4 partitions, file to file on the card and on
    the CPU: one dual MAC launch a block after the first, within 2 LSB."""
    from brutefir_tpu_torch.runtime.engine import Engine
    N, B, C = 256, 4, 3
    rng = np.random.default_rng(11)
    for k in range(2):
        (rng.uniform(-1, 1, N * B) * 0.03).astype("<f4").tofile(
            tmp_path / f"h{k}.raw")
    frames = N * 9 + 100
    rng.integers(-(1 << 20), 1 << 20, (frames, C)).astype("<i4").tofile(
        tmp_path / "in.raw")
    line0 = " ".join(f"cfc {i} 0;" for i in range(C))
    line1 = " ".join(f"cfc {i} 1;" for i in range(C))

    def conf(name):
        filters = "".join(
            f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; coeff: 0; "
            f"crossfade: true; }};\n" for i in range(C))
        return parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
logic: "cli" {{ script: "{line0}\n{line1}"; echo: false; }};
coeff 0 {{ filename: "{tmp_path / 'h0.raw'}"; format: "FLOAT_LE"; }};
coeff 1 {{ filename: "{tmp_path / 'h1.raw'}"; format: "FLOAT_LE"; }};
input 0,1,2 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: {C}; }};
output 0,1,2 {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "S24_4LE"; channels: {C}; dither: false; }};
{filters}""")

    before = dict(td.launches)
    sg = Engine(conf("gpu.raw"), device=cuda).run_offline()
    assert (td.launches["mac_dual_uniform"]
            - before["mac_dual_uniform"]) == sg["blocks"] - 1
    sc = Engine(conf("cpu.raw"), device=torch.device("cpu")).run_offline()
    assert sg["frames"] == sc["frames"] == frames
    yg = np.fromfile(tmp_path / "gpu.raw", "<i4").astype(np.int64)
    yc = np.fromfile(tmp_path / "cpu.raw", "<i4").astype(np.int64)
    assert yg.size == frames * C and np.abs(yg).max() > 2 ** 16
    assert np.abs(yg - yc).max() <= 2


# --- the FFT glue route and the fused real FFT -------------------------------

def _fft_pairs(kernel, M, dev, C=3):
    """(kernel output, plain version) pairs of one FFT kernel on seeded
    inputs of C channels."""
    rng = np.random.default_rng(M + C)
    x = torch.as_tensor(rng.standard_normal((C, 2 * M)).astype(np.float32),
                        device=dev)
    p = torch.as_tensor(rng.standard_normal((C, 2, M)).astype(np.float32),
                        device=dev)
    if kernel == "glue_fwd":
        Z = torch.fft.fft(torch.view_as_complex(x.reshape(C, M, 2)), dim=-1)
        return [(tg.glue_fwd(Z), tg.glue_fwd_reference(Z))]
    if kernel == "glue_inv":
        return [(torch.view_as_real(tg.glue_inv(p)),
                 torch.view_as_real(tg.glue_inv_reference(p)))]
    if kernel == "fft_fused_fwd":
        return [(tf.rfft_planes_fused(x), tf.rfft_planes_fused_reference(x))]
    return [(tf.irfft_planes_fused(p), tf.irfft_planes_fused_reference(p)),
            (tf.irfft_planes_valid_fused(p),
             tf.irfft_planes_fused_reference(p, M // 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,M,C", [
    (k, M, 3) for k in ("glue_fwd", "glue_inv", "fft_fused_fwd",
                        "fft_fused_inv")
    for M in (256, 1024, 8192, 65536)] + [
    (k, M, 3) for k in ("fft_fused_fwd", "fft_fused_inv")
    for M in (384, 1408)] + [
    (k, M, C) for k in ("glue_fwd", "glue_inv") for M in (1, 3, 64, 255, 4097)
    for C in (1, 256)])
def test_fft_kernels_match_plain_versions(cuda, kernel, M, C):
    """csrc/fft_glue.cu and csrc/fft_fused.cu against their plain torch
    versions: the glue's mirror pairs, bins 0 and M/2, M below one tile
    and odd (1, 3, 255, 4097: a ragged last tile, bin M/2 or none), one
    channel and 256, and M = 64 (xtc_lowlatency.conf); the fused FFT's
    clusters of 2 (M = 256, 384) and 8 blocks (1024 up), its column
    stages of radix 4/2 and of radix 3 and 11 (384, 1408), and 65536
    (R = 512, 128 KB of shared memory a block)."""
    _check_fft_pairs(kernel, M, cuda, C)


def _check_fft_pairs(kernel, M, dev, C):
    counts = tg.launches if kernel.startswith("glue") else tf.launches
    before = counts[kernel]
    pairs = _fft_pairs(kernel, M, dev, C)
    torch.cuda.synchronize()
    assert counts[kernel] == before + len(pairs)
    for got, ref in pairs:
        assert got.shape == ref.shape and torch.isfinite(got).all()
        assert (got - ref).abs().max().item() / ref.abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fft_fused_fwd", "fft_fused_inv"])
@pytest.mark.parametrize("C,M", [(1, 8192), (5, 8192), (1, 256), (5, 384),
                                 (5, 640), (200, 8192), (2, 131072)])
def test_fused_fft_cluster_shapes(cuda, kernel, C, M):
    """The fused FFT's cluster split at channel counts that fill no wave
    of the card (C = 1, 5), where R = M/128 is below the portable cluster
    size (M = 256, 384: clusters of 2; 640: of 4, R = 5 odd), on a grid
    too wide for clusters of 8 (C = 200: clusters of 4), and where a
    block's column buffers outgrow shared memory (131072: the
    device-memory scratch path)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    S = tf.cluster_size(M, C, sms)
    assert tf.needs_scratch(M, S) == (M == 131072)
    _check_fft_pairs(kernel, M, cuda, C)


@pytest.mark.cuda
def test_glue_kernels_refuse_noncontiguous_prefix(cuda):
    p = torch.zeros(4, 2, 256, device=cuda)[::2]
    Z = torch.zeros(4, 256, dtype=torch.complex64, device=cuda)[::2]
    before = dict(tg.launches)
    with pytest.raises(ValueError, match="must be contiguous"):
        tg.glue_inv(p)
    with pytest.raises(ValueError, match="must be contiguous"):
        tg.glue_fwd(Z)
    assert tg.launches == before


@pytest.mark.cuda
def test_failed_fft_launches_raise(cuda, monkeypatch):
    class Refused:
        def __getattr__(self, name):
            return lambda *a: 9          # cudaErrorInvalidConfiguration
    monkeypatch.setattr(tg._build, "load", lambda stem: Refused())
    x = torch.zeros(2, 512, device=cuda)
    p = torch.zeros(2, 2, 256, device=cuda)
    before = (dict(tg.launches), dict(tf.launches))
    for fn, arg in ((tg.rfft_planes_glue, x), (tg.irfft_planes_glue, p),
                    (tf.rfft_planes_fused, x), (tf.irfft_planes_fused, p),
                    (tf.irfft_planes_valid_fused, p)):
        with pytest.raises(RuntimeError, match="launch failed"):
            fn(arg)
    assert (tg.launches, tf.launches) == before


# (Fs, F, B, M, rows, delays): the massive shape (26 filters, one shared
# delay), per-filter delays, bench1's second stage (2 of 6 rows), 256
# rows, and lengths with a ragged last tile (1, 3, 255, 4097)
RING_SHAPES = [
    (26, 26, 16, 8192, None, [3] * 26),
    (26, 26, 16, 8192, None, [f % 16 for f in range(26)]),
    (2, 6, 8, 8192, [0, 1], [0, 1, 2, 3, 4, 5]),
    (256, 256, 2, 8192, None, [f % 2 for f in range(256)]),
    (3, 5, 3, 1, [4, 0, 2], [0, 1, 2, 0, 1]),
    (3, 3, 2, 3, None, [1, 0, 1]),
    (4, 4, 3, 255, [3, 2, 1, 0], [2, 1, 0, 2]),
    (2, 2, 2, 4097, None, [0, 1]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("Fs,F,B,M,rows,delays", RING_SHAPES)
def test_glue_fwd_ring_kernel_matches_plain_version(cuda, dtype, Fs, F, B,
                                                    M, rows, delays):
    """``bf_glue_fwd_ring`` (``_f64``) against its plain version on the
    same CUDA tensors: the ring's written rows within 1e-5 of their peak
    (1e-12 in float64), a bfloat16 ring equal to the plain version's
    cast, every other slot untouched; one launch under the form's key."""
    g = torch.Generator(device="cpu").manual_seed(Fs * M + B)
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    Zm = torch.randn(Fs, M, dtype=cdt, generator=g).to(cuda)
    ring = torch.randn(F, B, 2, M, generator=g).to(cuda, dtype)
    ref = ring.clone()
    r32 = (None if rows is None
           else torch.tensor(rows, dtype=torch.int32, device=cuda))
    delay = torch.tensor(delays, dtype=torch.int32, device=cuda)
    t = torch.tensor(5, dtype=torch.int32, device=cuda)
    key = "glue_fwd_ring" + {torch.float32: "", torch.bfloat16: "_bf16",
                             torch.float64: "_f64"}[dtype]
    before = dict(tg.launches)
    tg.glue_fwd_ring(Zm, ring, r32, delay, t, dt=2)
    torch.cuda.synchronize()
    assert tg.launches == {**before, key: before[key] + 1}
    tg.glue_fwd_ring_reference(Zm, ref, r32, delay, t, dt=2)
    idx = torch.arange(Fs, device=cuda) if r32 is None else r32.long()
    slots = torch.remainder(7 + delay[idx], B).long()
    written = torch.zeros(F, B, dtype=torch.bool, device=cuda)
    written[idx, slots] = True
    assert torch.equal(ring[~written], ref[~written])
    got, want = ring[written].double(), ref[written].double()
    if dtype == torch.bfloat16:
        assert torch.equal(ring[written], ref[written])
    else:
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        assert (got - want).abs().max().item() <= \
            tol * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("F,G,M", [(26, 2, 8192), (256, 4, 8192),
                                   (3, 3, 255)])
def test_glue_fwd_into_kernel_matches_plain_version(cuda, dtype, F, G, M):
    """The plain-destination form into block g of ``xnews [F, G-1, 2,
    M]`` (the grouped dispatch's row stride): the block as the plain
    version writes it (bfloat16 equal, float32 within 1e-5 of the peak,
    float64 1e-12), the other blocks untouched."""
    g = torch.Generator(device="cpu").manual_seed(F * G + M)
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    Zm = torch.randn(F, M, dtype=cdt, generator=g).to(cuda)
    xnews = torch.full((F, G - 1, 2, M), 3.0, dtype=dtype, device=cuda)
    ref = xnews.clone()
    tg.glue_fwd_into(Zm, xnews[:, G - 2])
    tg.glue_fwd_into_reference(Zm, ref[:, G - 2])
    torch.cuda.synchronize()
    assert torch.equal(xnews[:, : G - 2], ref[:, : G - 2])
    if dtype == torch.bfloat16:
        assert torch.equal(xnews, ref)
    else:
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        d = (xnews - ref).abs().max().item()
        assert d <= tol * ref.abs().max().item()


@pytest.mark.cuda
def test_glue_fwd_ring_refuses_and_raises(cuda, monkeypatch):
    """Operands on two devices are refused before any launch; a refused
    launch raises and counts nothing."""
    Zm = torch.zeros(2, 256, dtype=torch.complex64, device=cuda)
    ring = torch.zeros(2, 2, 2, 256, device=cuda)
    delay = torch.zeros(2, dtype=torch.int32, device=cuda)
    t = torch.zeros((), dtype=torch.int32, device=cuda)
    before = dict(tg.launches)
    with pytest.raises(ValueError):
        tg.glue_fwd_ring(Zm, ring, None, delay.cpu(), t)
    with pytest.raises(ValueError):
        tg.glue_fwd_ring(Zm, ring.cpu(), None, delay, t)

    class Refused:
        def __getattr__(self, name):
            return lambda *a: 9          # cudaErrorInvalidConfiguration
    monkeypatch.setattr(tg._build, "load", lambda stem: Refused())
    with pytest.raises(RuntimeError, match="launch failed"):
        tg.glue_fwd_ring(Zm, ring, None, delay, t)
    with pytest.raises(RuntimeError, match="launch failed"):
        tg.glue_fwd_into(Zm, ring[:, 0])
    assert tg.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("pair,into", [("0", 0), ("force:4", 6),
                                       ("force", 4)])
def test_ring_route_engine_on_card_matches_cpu(cuda, tmp_path, monkeypatch,
                                               pair, into):
    """The engine on the card block by block and in groups of 4 and 2
    (the batch of 8, then the 4-block tail block by block), per-filter
    delays: every forward transform lands through ``bf_glue_fwd_ring``
    (each block's ring write, and the group's later blocks into
    ``xnews``), no ``glue_fwd``; within 2 LSB of the CPU engine and of
    the float64 oracle."""
    monkeypatch.setenv("BRUTEFIR_TPU_PAIR", pair)
    tg.reset_launches()
    _card_and_cpu(cuda, tmp_path, [0, 1, 0], delays=(0, 1, 2))
    assert tg.launches == {**dict.fromkeys(tg.launches, 0),
                           "glue_fwd_ring": 12 + into,
                           "glue_inv": 12}


@pytest.mark.cuda
def test_glue_route_engine_on_card_matches_cpu(cuda, tmp_path):
    """The glue route, the engine's only FFT route: one forward glue
    into the ring (``glue_fwd_ring``) and one inverse glue kernel a block
    on the card, no ``glue_fwd``, within 2 LSB of the CPU engine and of
    the float64 oracle."""
    before = dict(tg.launches)
    _card_and_cpu(cuda, tmp_path, [0, 1, 0])
    assert tg.launches == {k: v + 12 * (k in ("glue_fwd_ring", "glue_inv"))
                           for k, v in before.items()}


# --- delays, subsample delays and dither on the card -----------------------

@pytest.mark.cuda
@pytest.mark.parametrize("imin,imax", [(-(1 << 15), (1 << 15) - 1),
                                       (-(1 << 23), (1 << 23) - 1)])
@pytest.mark.parametrize("N", [1, 2, 8192])
def test_dither_on_card_matches_cpu(cuda, imin, imax, N):
    """ops/device_dither.py on the card: the window (with a pointer wrap)
    and the quantize (small, 2^22 and clipping levels) bit-equal to the
    same calls on CPU copies of the inputs."""
    from brutefir_tpu_torch.core.dither import DitherTable
    from brutefir_tpu_torch.ops.device_dither import (dither_quantize,
                                                      dither_window)
    cpu = torch.device("cpu")
    table = DitherTable(5, 8000, 0, max(N, 64))
    tab, rm = torch.as_tensor(table.tab), torch.as_tensor(table.randmap)
    ptr = torch.tensor([j * table.spacing + 1 for j in range(5)],
                       dtype=torch.int32)
    ptr[2] = table.size - max(N // 2, 1)          # wraps in this window
    last = torch.as_tensor(table.tab[ptr.numpy() - 1].astype(np.int32))
    g = torch.Generator().manual_seed(N)
    for amp in (3.0, 2.0 ** 22, 1.5 * imax):
        x = torch.randn(5, N, generator=g) * amp
        sf = torch.rand(5, 2, generator=g) - 0.5
        host = dither_window(tab, rm, ptr, last, N, table.size)
        card = dither_window(tab.to(cuda), rm.to(cuda), ptr.to(cuda),
                             last.to(cuda), N, table.size)
        host += dither_quantize(x, host[0], sf, imin, imax)
        card += dither_quantize(x.to(cuda), card[0], sf.to(cuda), imin,
                                imax)
        for a, b in zip(card, host):
            assert a.dtype == b.dtype and torch.equal(a.to(cpu), b)
        ptr, last = host[1], host[2]


@pytest.mark.cuda
def test_delay_and_subdelay_on_card_match_cpu(cuda):
    """device_io.apply_delay (a gather: exact) and apply_subdelay (batched
    rfft/irfft: within 1e-5 of the peak, cuFFT against the CPU's FFT),
    with bypassed channels passing x through exactly."""
    from brutefir_tpu_torch.runtime.device_io import (apply_delay,
                                                      apply_subdelay)
    g = torch.Generator().manual_seed(5)
    C, N, W, Bsd = 4, 1024, 300, 32
    x = torch.randn(C, N, generator=g) * 2.0 ** 20
    win = torch.randn(C, W, generator=g)
    dvec = torch.tensor([0, 7, 299, 300])
    host = apply_delay(x, win, dvec, W)
    card = apply_delay(x.to(cuda), win.to(cuda), dvec.to(cuda), W)
    for a, b in zip(card, host):
        assert torch.equal(a.cpu(), b)
    rest = torch.randn(C, Bsd, generator=g)
    H = torch.randn(C, Bsd + 1, 2, generator=g)
    hrows = torch.complex(H[..., 0], H[..., 1])
    byp = torch.tensor([False, True, False, True])
    host = apply_subdelay(x, rest, hrows, byp, Bsd)
    card = apply_subdelay(x.to(cuda), rest.to(cuda), hrows.to(cuda),
                          byp.to(cuda), Bsd)
    assert torch.equal(card[1].cpu(), host[1])
    assert torch.equal(card[0].cpu()[byp], x[byp])
    peak = host[0].abs().max()
    assert (card[0].cpu() - host[0]).abs().max() <= 1e-5 * peak


@pytest.mark.cuda
def test_aligned_engine_on_card(cuda, tmp_path):
    """Dither, input and output delays and output subdelays through the
    engine on the card: run() and run_offline() byte-equal, and the
    output within 6 LSB of the float64 oracle (dither error up to 4.5 LSB
    plus the float32 engine's) with the error's RMS in the dither band
    0.5 .. 2 LSB (plain rounding gives 0.29)."""
    from brutefir_tpu_torch.core.firwindow import sample_sinc
    from brutefir_tpu_torch.runtime.engine import Engine
    N, B, C, half = 256, 4, 3, 15
    rng = np.random.default_rng(31)
    taps = (rng.standard_normal(N * B) * 0.05).astype(np.float32)
    (tmp_path / "c0.txt").write_text(
        "\n".join(repr(float(v)) for v in taps))
    frames = N * 13 + 77
    x = np.clip(np.round(rng.standard_normal((frames, C)) * 2.0 ** 19),
                -(2 ** 23), 2 ** 23 - 1).astype("<i4")
    x.tofile(tmp_path / "in.raw")
    in_delay, out_delay, subdelay = (5, 0, 300), (0, 9, 1), (37, -100, -60)

    def conf(name):
        return parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
sdf_length: {half};
coeff 0 {{ filename: "{tmp_path / 'c0.txt'}"; format: "TEXT"; }};
input 0,1,2 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: {C}; delay: {", ".join(map(str, in_delay))}; }};
output 0,1,2 {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "S24_LE"; channels: {C}; dither: true; delay: {", ".join(map(str, out_delay))}; subdelay: {", ".join(map(str, subdelay))}; }};
""" + "".join(f"filter {c} {{ from_inputs: {c}; to_outputs: {c}; "
              f"coeff: 0; }};\n" for c in range(C)))

    def read(name):
        b = np.fromfile(tmp_path / name, np.uint8).reshape(-1, 3)
        w = b.astype(np.int64) @ np.array([1, 256, 65536])
        return (w - ((w & 0x800000) << 1)).reshape(frames, C)

    Engine(conf("offline.raw"), device=cuda).run_offline()
    Engine(conf("run.raw"), device=cuda).run()
    y = read("offline.raw")
    assert np.array_equal(y, read("run.raw"))
    for c in range(C):
        z = np.convolve(x[:, c].astype(np.float64), taps)[:frames]
        if subdelay[c] > -100:
            z = np.convolve(z, sample_sinc(half, subdelay[c] / 100, 9.0,
                                           np.float32))[:frames]
        else:
            z = np.concatenate([np.zeros(half), z])[:frames]
        d = in_delay[c] + out_delay[c]
        ref = np.concatenate([np.zeros(d), z])[:frames]
        err = y[:, c] - ref
        assert np.abs(err).max() <= 6
        assert 0.5 <= np.sqrt(np.mean(err ** 2)) <= 2.0


# --- the stage probe and the EQ on the card ---------------------------------

@pytest.mark.cuda
def test_stage_probe_on_card(cuda):
    """``stageprobe.device_stage_slopes`` on the card times the route a
    block runs, each call RUNS times: at a fused shape (one
    stage of 6 filters, 1024 x 4, three coefficient sets) the per-filter
    fused MAC + mix, ``glue_fwd_ring`` and ``glue_inv``, mix2 0 and the
    other columns positive; on a two-stage cascade the stage loop's
    ``mac_rows``, ``glue_fwd_ring`` and ``glue_inv`` (the cascade input's
    and the output's) twice each, every column positive."""
    from brutefir_tpu_torch.graph.spec import build_graph_spec
    from brutefir_tpu_torch.runtime import stageprobe as sp
    N, B, F = 1024, 4, 6
    n = sp.RUNS
    bank = torch.randn(3, B, 2, N, device=cuda)
    for inputs, mac_want, mix_want, k in (
            ([[]] * F, {}, {"rows": n}, 1),
            ([[2], [3], [], [], [], []], {"mac_rows": 2 * n}, {}, 2)):
        spec = build_graph_spec(N, B, 3, 2, inputs, [False] * F,
                                np.dtype(np.float32))
        tm.reset_launches()
        tg.reset_launches()
        mm.reset_launches()
        got = sp.device_stage_slopes(spec, bank, cuda)
        assert list(got) == list(sp.STAGES)
        fused = k == 1
        assert (got["mix2"] == 0.0) == fused, got
        assert all(0 < v < 0.01 for s, v in got.items()
                   if not (fused and s == "mix2")), got
        assert tm.launches == {**dict.fromkeys(tm.launches, 0), **mac_want}
        assert mm.launches == {**dict.fromkeys(mm.launches, 0), **mix_want}
        assert tg.launches == {**dict.fromkeys(tg.launches, 0),
                               "glue_fwd_ring": k * n, "glue_inv": k * n}


def _eq_xfade_conf(tmp_path, name):
    N, B = 256, 4
    cli = ('"cli" { script: "sleep b2\nlmc eq 0 mag 1000/-6\n'
           'lmc eq 0 mag 1000/3,8000/-12\nsleep b999"; echo: false; }')
    return parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
logic: {cli}, "eq" {{ coeff: 0, 1; bands: "ISO octave"; }};
coeff 0 {{ filename: "dirac pulse"; shared_mem: true; }};
coeff 1 {{ filename: "dirac pulse"; shared_mem: true; }};
input 0,1 {{ device: "file" {{ path: "{tmp_path / 'in.f32'}"; }}; sample: "FLOAT_LE"; channels: 2; }};
output 0,1 {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "FLOAT_LE"; channels: 2; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; crossfade: true; }};
filter 1 {{ from_inputs: 1; to_outputs: 1; coeff: 0; crossfade: true; }};
""")


@pytest.mark.cuda
def test_eq_crossfade_on_card_matches_cpu(cuda, tmp_path):
    """Crossfading filters on an EQ pair, with EQ commands from a CLI
    script on blocks 3 and 4 (each block's old set is the one the command
    before rendered), on the card and on the CPU: the dual MAC on blocks
    0, 3 and 4, outputs within 1e-5 of the peak. A bank update leaves the
    bank of a block already dispatched as it was."""
    from brutefir_tpu_torch.runtime.engine import Engine
    frames = 256 * 9 + 50
    x = (np.random.default_rng(12).standard_normal((frames, 2))
         * 0.25).astype("<f4")
    x.tofile(tmp_path / "in.f32")
    td.reset_launches()
    sg = Engine(_eq_xfade_conf(tmp_path, "gpu.f32"), device=cuda).run()
    assert sum(td.launches.values()) == 3
    sc = Engine(_eq_xfade_conf(tmp_path, "cpu.f32"),
                device=torch.device("cpu")).run()
    assert sg["frames"] == sc["frames"] == frames
    yg = np.fromfile(tmp_path / "gpu.f32", "<f4")
    yc = np.fromfile(tmp_path / "cpu.f32", "<f4")
    assert yg.size == frames * 2 and np.abs(yc).max() > 0.1
    assert np.abs(yg - yc).max() <= 1e-5 * np.abs(yc).max()

    eng = Engine(_eq_xfade_conf(tmp_path, "unused.f32"), device=cuda)
    old = eng._snapshot_epoch()[5]
    kept = old.clone()
    eng.update_bank_entry(0, np.ones((4, 2, 256), np.float32))
    torch.cuda.synchronize()
    assert eng.bank is not old and torch.equal(old, kept)
    assert bool((eng.bank[0] == 1).all()) and torch.equal(eng.bank[1],
                                                          kept[1])


@pytest.mark.cuda
def test_host_codec_engine_on_card_matches_cpu(cuda, tmp_path):
    """The host codec path (S32_BE in, S24_BE and FLOAT64_LE out, output
    delays and a subdelay) on the card and on the CPU: the step's fused
    MAC + mix once a block on the card, the native codec called, S24
    within 2 LSB and the float64 device within 2e-6 of the peak."""
    from brutefir_tpu_torch.core import native
    from brutefir_tpu_torch.core.codecs import (Overflow, float_to_raw,
                                                raw_to_float)
    from brutefir_tpu_torch.core.sampleformat import parse_sample_format
    from brutefir_tpu_torch.runtime.engine import Engine
    N, B, C = 256, 4, 3
    rng = np.random.default_rng(13)
    h = (rng.standard_normal(N * B) * 0.1).astype(np.float32)
    (tmp_path / "c0.txt").write_text(
        "\n".join(repr(float(v)) for v in h) + "\n")
    frames = N * 11 + 77
    s32 = parse_sample_format("S32_BE")
    x = np.round(rng.standard_normal((C, frames)) * 2.0 ** 27).astype(
        np.float32)
    raw = np.zeros(frames * C * 4, np.uint8)
    float_to_raw(x, s32, C, [0, 1, 2], raw, [Overflow(max=2.0 ** 31)] * C)
    raw.tofile(tmp_path / "in.raw")

    def conf(tag):
        return parse_config(f"""
sampling_rate: 44100;
sdf_length: 15;
filter_length: {N},{B};
coeff 0 {{ filename: "{tmp_path / 'c0.txt'}"; format: "TEXT"; }};
input 0,1,2 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S32_BE"; channels: {C}; }};
output 0,1 {{ device: "file" {{ path: "{tmp_path / (tag + '.s24')}"; }}; sample: "S24_BE"; channels: 2; dither: false; delay: 0, 31; subdelay: 45, -100; }};
output 2 {{ device: "file" {{ path: "{tmp_path / (tag + '.f64')}"; }}; sample: "FLOAT64_LE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_inputs: 1; to_outputs: 1; coeff: 0; }};
filter 2 {{ from_inputs: 2; to_outputs: 2; coeff: 0; }};
""")

    mm.reset_launches()
    native.reset_calls()
    eg = Engine(conf("gpu"), device=cuda)
    assert eg.dio is None
    sg = eg.run_offline()
    assert mm.launches["uniform"] == 12
    assert native.calls["decode_f32"] == 12 and native.calls["encode_int"]
    sc = Engine(conf("cpu"), device=torch.device("cpu")).run_offline()
    assert sg["frames"] == sc["frames"] == frames
    fmt24, fmt64 = (parse_sample_format(n) for n in ("S24_BE", "FLOAT64_LE"))
    ys = [raw_to_float(np.fromfile(tmp_path / f"{t}.s24", np.uint8), fmt24,
                       frames, 2, [0, 1], np.float64) for t in ("gpu", "cpu")]
    assert np.abs(ys[1]).max() > 2.0 ** 20
    assert np.abs(ys[0] - ys[1]).max() <= 2
    yf = [np.fromfile(tmp_path / f"{t}.f64", "<f8") for t in ("gpu", "cpu")]
    assert yf[0].size == frames
    assert np.abs(yf[0] - yf[1]).max() <= 2e-6 * np.abs(yf[1]).max()


class _ScaleHooks:
    """All six bfevents hooks, each scaling its buffer by a fixed gain of
    its id, counting its calls. The gains are 0.5 .. 1: a gain above 1
    after the point where the card and the CPU round apart would amplify
    their 2 LSB gap (with gains to 1.5 the H100 measured 3 LSB)."""

    GAINS = np.random.default_rng(13).uniform(0.5, 1.0, 8)

    def __init__(self):
        self.calls = dict.fromkeys(
            ("input_timed", "input_freqd", "pre_convolve", "post_convolve",
             "output_freqd", "output_timed"), 0)
        for kind in self.calls:
            setattr(self, kind, self._hook(kind))

    def _hook(self, kind):
        def hook(buf, i):
            self.calls[kind] += 1
            buf *= self.GAINS[i]
        return hook


@pytest.mark.cuda
def test_hooked_engine_on_card_matches_cpu(cuda, tmp_path):
    """A module with all six hooks on a shared-coefficient engine at
    256 x 4 partitions, on the card and on the CPU: the host codec path
    (``dio`` None), the unfused uniform MAC and each glue kernel once a
    block, the fused MAC + mix never, every hook once a channel a block,
    and the card within 2 LSB of the CPU."""
    from brutefir_tpu_torch.runtime.engine import Engine
    N, B, C = 256, 4, 3
    rng = np.random.default_rng(17)
    (tmp_path / "c0.txt").write_text("\n".join(
        repr(float(v)) for v in rng.standard_normal(N * B) * 0.05) + "\n")
    frames = N * 9 + 31
    np.round(rng.standard_normal((frames, C)) * 2 ** 18).astype(
        "<i4").tofile(tmp_path / "in.raw")

    def run(tag, device):
        eng = Engine(parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
coeff 0 {{ filename: "{tmp_path / 'c0.txt'}"; format: "TEXT"; }};
input 0,1,2 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: {C}; }};
output 0,1,2 {{ device: "file" {{ path: "{tmp_path / (tag + '.raw')}"; }}; sample: "S24_4LE"; channels: {C}; dither: false; }};
""" + "".join(f"filter {c} {{ from_inputs: {c}; to_outputs: {c}; "
              f"coeff: 0; }};\n" for c in range(C))), device=device)
        hooks = _ScaleHooks()
        eng.logic.append(hooks)
        stats = eng.run()
        assert eng.dio is None and stats["frames"] == frames
        assert all(n == C * stats["blocks"] for n in hooks.calls.values())
        return np.fromfile(tmp_path / (tag + ".raw"), "<i4").astype(np.int64)

    for m in (tm, mm, tg):
        m.reset_launches()
    yg = run("gpu", cuda)
    blocks = -(-frames // N)
    assert tm.launches == {**with_bf16("mac_uniform", "mac_rows"),
                           "mac_uniform": blocks, "mac_uniform_f64": 0,
                           "mac_rows_f64": 0}
    assert not any(mm.launches.values())
    assert tg.launches["glue_fwd"] == tg.launches["glue_inv"] == blocks
    yc = run("cpu", torch.device("cpu"))
    assert yg.size == frames * C and np.abs(yc).max() > 2 ** 18
    assert np.abs(yg - yc).max() <= 2


@pytest.mark.cuda
def test_clocked_engine_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """The paced device of chip_smoke.py (``bfio_paced.py``, clocked) at
    64 x 4 partitions, two coefficient sets, dithered S24_4LE: on the card
    the warm-up runs both step variants twice before the start, the
    key's warm-up and its capture (two ``mac_rows`` and two
    ``mac_uniform`` launches, two glue launches each way each) and every
    block one ``mac_rows`` and one glue launch each way; the output is 2N
    silent frames, then within 2 LSB of the CPU engine's (ROADMAP queue
    3). Realtime is refused here."""
    import importlib.util
    import os
    from brutefir_tpu_torch.runtime.engine import Engine

    def refuse(*a, **k):
        raise PermissionError
    monkeypatch.setattr(os, "sched_setscheduler", refuse, raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    (tmp_path / "bfio_paced.py").write_text(cs.PACED_MODULE)
    N, B, C = 64, 4, 2
    rng = np.random.default_rng(29)
    for k in range(2):
        h = rng.standard_normal(N * B) * np.exp(-np.arange(N * B) / 60.0)
        (0.5 * h / np.linalg.norm(h)).astype("<f4").tofile(
            tmp_path / f"h{k}.raw")
    frames = N * 40 + 21
    np.round(rng.standard_normal((frames, C)) * 2 ** 20).astype(
        "<i4").tofile(tmp_path / "in.raw")

    def run(tag, device):
        eng = Engine(parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
modules_path: "{tmp_path}";
coeff 0 {{ filename: "{tmp_path / 'h0.raw'}"; format: "FLOAT_LE"; }};
coeff 1 {{ filename: "{tmp_path / 'h1.raw'}"; format: "FLOAT_LE"; }};
input 0,1 {{ device: "paced" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: {C}; }};
output 0,1 {{ device: "paced" {{ path: "{tmp_path / (tag + '.raw')}"; }}; sample: "S24_4LE"; channels: {C}; dither: true; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_inputs: 1; to_outputs: 1; coeff: 1; }};
"""), device=device)
        eng.conf.quiet = True
        stats = eng.run()
        assert stats["frames"] == frames
        return np.fromfile(tmp_path / (tag + ".raw"), "<i4").astype(np.int64)

    for m in (tm, mm, tg):
        m.reset_launches()
    yg = run("gpu", cuda)
    blocks = -(-frames // N)
    assert tm.launches == {**with_bf16("mac_uniform", "mac_rows"),
                           "mac_uniform": 2, "mac_rows": blocks + 2,
                           "mac_uniform_f64": 0, "mac_rows_f64": 0}
    assert not any(mm.launches.values())
    assert tg.launches["glue_fwd_ring"] == tg.launches["glue_inv"] == \
        blocks + 4
    assert tg.launches["glue_fwd"] == 0
    yc = run("cpu", torch.device("cpu"))
    assert yg.size == (frames + 2 * N) * C and not yg[:2 * N * C].any()
    assert np.abs(yc).max() > 2 ** 18
    assert np.abs(yg - yc).max() <= 2


# --- has_bin0 and the shard forms (multi-device sharding) -------------------

BIN0_KERNELS = ("mac_mix_uniform", "mac_mix_rows", "mac_mix_tiled", "mac",
                "mac_scalar_path", "mac_dual", "mac_group", "mac_mix_group")


def _bin0_call(name, flag, dev):
    """(kernel output, plain output) of ``name`` with ``has_bin0 = flag``
    on the same CUDA tensors."""
    K = 1001 if name == "mac_scalar_path" else 512
    C = 4096 if name == "mac_mix_tiled" else 5
    ring, bank, idx, mask, w = _mac_inputs(40, 6, 4, K, 3, C,
                                           name == "mac_mix_uniform", dev)
    t = torch.tensor(9, dtype=torch.int32, device=dev)
    rows = torch.tensor([4, 1, 2], dtype=torch.int32, device=dev)
    xnews = torch.randn(6, 2, 2, K, generator=torch.Generator(
        device=dev).manual_seed(41), device=dev)
    delay = torch.tensor([0, 1, 0, 2, 0, 1], dtype=torch.int32, device=dev)
    if name.startswith("mac_mix") and name != "mac_mix_group":
        if name == "mac_mix_tiled":
            assert mm.tiled_route(C, 4, K)
        uni = name == "mac_mix_uniform"
        return (mm.mac_mix(ring, bank, idx, mask, t, w, uni, flag),
                mm.mac_mix_reference(ring, bank, idx, mask, t, w, uni, flag))
    if name in ("mac", "mac_scalar_path"):
        return (tm.mac(ring, bank, rows, idx, mask, t, False, flag),
                tm.mac_reference(ring, bank, rows, idx, mask, t, False,
                                 flag))
    if name == "mac_dual":
        pidx = idx.flip(0).contiguous()
        return (torch.cat(td.mac_dual(ring, bank, rows, idx, mask, pidx,
                                      mask, t, False, flag)),
                torch.cat(td.mac_dual_reference(ring, bank, rows, idx, mask,
                                                pidx, mask, t, False, flag)))
    if name == "mac_group":
        return (mg.mac_group(ring, xnews, bank, idx, mask, t, delay, flag),
                mg.mac_group_reference(ring, xnews, bank, idx, mask, t,
                                       delay, flag))
    return (mg.mac_mix_group(ring, xnews, bank, idx, mask, t, w, delay,
                             flag),
            mg.mac_mix_group_reference(ring, xnews, bank, idx, mask, t, w,
                                       delay, flag))


@pytest.mark.cuda
@pytest.mark.parametrize("name", BIN0_KERNELS)
def test_kernels_has_bin0_match_plain_versions(cuda, name):
    """Every MAC kernel with has_bin0 = 0 and = 1 against its plain
    version with the same flag; 0 changes bin 0 and no other bin."""
    outs = {}
    for flag in (False, True):
        got, ref = _bin0_call(name, flag, cuda)
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
        outs[flag] = got
    assert torch.equal(outs[False][..., 1:], outs[True][..., 1:])
    assert not torch.equal(outs[False][..., 0], outs[True][..., 0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1), (3, 2)])
def test_shard_forms_on_card_match_unsharded(cuda, shape):
    """The four shard forms with every shard on the card against the
    unsharded kernel call: bit-equal where no filters are summed across
    shards, else 1e-5 relative; (3, 2) splits 8 filters unevenly and
    takes 2 of 3 row shards' stage rows."""
    from brutefir_tpu_torch.ops import mac_shard as ms
    from brutefir_tpu_torch.parallel.mesh import make_mesh, split
    F, B, K, E, C = 8, 4, 1024, 3, 5
    ring, bank, idx, mask, w = _mac_inputs(42, F, B, K, E, C, False, cuda)
    pidx = idx.flip(0).contiguous()
    t = torch.tensor(6, dtype=torch.int32, device=cuda)
    xnews = torch.randn(F, 3, 2, K, device=cuda)
    delay = (torch.arange(F, device=cuda) % 3).to(torch.int32)
    m = make_mesh([cuda] * (shape[0] * shape[1]), *shape)
    R, Bk = split(m, ring, 0, 3), split(m, bank, None, 3)
    I, M, P = split(m, idx, 0), split(m, mask, 0), split(m, pidx, 0)
    rows = np.array([6, 1, 7, 3])
    r32 = torch.as_tensor(rows, dtype=torch.int32, device=cuda)
    assert torch.equal(ms.mac_shard(m, R, Bk, rows, I, M, t),
                       tm.mac(ring, bank, r32, idx, mask, t, False))
    for a, b in zip(ms.mac_dual_shard(m, R, Bk, rows, I, M, P, M, t),
                    td.mac_dual(ring, bank, r32, idx, mask, pidx, mask, t,
                                False)):
        assert torch.equal(a, b)
    assert torch.equal(
        ms.mac_group_shard(m, R, split(m, xnews, 0, 3), Bk, I, M, t,
                           split(m, delay, 0)),
        mg.mac_group(ring, xnews, bank, idx, mask, t, delay))
    got = ms.mac_mix_shard(m, R, Bk, I, M, t, split(m, w, 1))
    ref = mm.mac_mix(ring, bank, idx, mask, t, w, False)
    if shape[0] == 1:
        assert torch.equal(got, ref)
    else:
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
def test_sharded_engine_on_card_matches_unsharded(cuda, tmp_path):
    """A 4-filter config at 2 x 2 on one card (the fused MAC + mix per
    shard) against the unsharded engine on the card: within 1 LSB."""
    from brutefir_tpu_torch.parallel import make_mesh
    from brutefir_tpu_torch.runtime.engine import Engine
    N, B, C = 512, 2, 4
    rng = np.random.default_rng(43)
    for k in range(2):
        (rng.standard_normal(N * B) * 0.05).astype("<f4").tofile(
            tmp_path / f"h{k}.raw")
    frames = N * 11 + 7
    np.round(rng.standard_normal((frames, C)) * 2 ** 19).astype(
        "<i4").tofile(tmp_path / "in.raw")
    ys = []
    for tag, mesh in (("one", None), ("mesh", make_mesh([cuda] * 4, 2, 2))):
        conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
coeff 0 {{ filename: "{tmp_path / 'h0.raw'}"; format: "FLOAT_LE"; }};
coeff 1 {{ filename: "{tmp_path / 'h1.raw'}"; format: "FLOAT_LE"; }};
input 0,1,2,3 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: {C}; }};
output 0,1,2,3 {{ device: "file" {{ path: "{tmp_path / (tag + '.raw')}"; }}; sample: "S24_4LE"; channels: {C}; dither: false; }};
""" + "\n".join(f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; "
                f"coeff: {i % 2}; }};" for i in range(C)))
        conf.quiet = True
        eng = Engine(conf, device=cuda, mesh=mesh)
        assert eng.run_offline()["frames"] == frames
        ys.append(np.fromfile(tmp_path / (tag + ".raw"), "<i4").astype(
            np.int64))
    assert np.abs(ys[0]).max() > 2 ** 18
    assert np.abs(ys[1] - ys[0]).max() <= 1


# --- the bf16 operand forms (BRUTEFIR_TPU_RING_DTYPE / _BANK_DTYPE) ---------
#
# Each form against its plain version on the same bfloat16 operands (the
# plain version widens them, so the products are the same: float32's
# tolerance), its launch counted in ``launches``, and against the
# float32 form run on the widened operands: bit-equal where the kernel
# writes its FMAs out (csrc/mac_core.cuh, the fused grouped MAC + mix),
# within 1e-5 where it leaves `a*b - c*d + y` to the compiler, whose FMA
# contraction may differ between two instantiations of one code
# (csrc/mac_mix.cu, csrc/mac_mix_tiled.cu, bf_mac_group). chip_mac_ab.py
# holds the float32 forms bit-equal to the parent tree's.

BF16_COMBOS = [(1, 0), (0, 1), (1, 1)]     # (ring, bank) in bfloat16


def _bf16(combo, ring, bank, xnews=None):
    r16, b16 = combo
    ring = ring.to(torch.bfloat16) if r16 else ring
    out = [ring, bank.to(torch.bfloat16) if b16 else bank]
    if xnews is not None:
        out.append(xnews.to(ring.dtype))
    return out


def _rel(a, b):
    return (a - b).abs().max().item() / b.abs().max().item()


# the bf16 forms' edges beside the core's shapes: bench5's 26 x 8192 x 8;
# groups of 8 (one set, at most one block an SM) that B does not fill (24
# = 8 + 8 + 8 of 8192 bins at Fs = 4; 20 = 8 + 8 + 4), groups of 4 past
# B = 40
MAC_BF16_SHAPES = MAC_CORE_SHAPES + [
    (26, 8, 8192, 2, list(range(26)), 0),
    (4, 24, 8192, 5, [0, 1, 2, 3], 0),
    (4, 20, 1024, 3, [3, 1, 2, 0], 0),
    (40, 42, 1024, 3, list(range(40)), 0),
    (3, 20, 1001, 2, [0, 1, 2], 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("combo", BF16_COMBOS)
@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("F,B,K,E,rows,offset", MAC_BF16_SHAPES)
def test_unfused_mac_bf16_forms_match_plain_version(cuda, combo, uniform, F,
                                                    B, K, E, rows, offset):
    """The bf16 forms of bf_mac (csrc/mac.cu) on the core's paths (bench1's
    stage, bench5's 26 rows, load groups that B does not fill): an offset
    ring view takes the scalar path, as K % 4 != 0 does."""
    ring, bank, idx, mask, _ = _mac_inputs(F * K + 3, F, B, K, E, 1,
                                           uniform, cuda)
    mask[:, 0] = 1.0
    ring, bank = _bf16(combo, ring, bank)
    ring = _at_offset(ring, offset)
    r = torch.tensor(rows, dtype=torch.int32, device=cuda)
    form = ("mac_uniform" if uniform else "mac_rows") + mm.bf16_suffix(
        ring, bank)
    for tv in (0, 3, B - 1, 2 * B + 5):
        t = torch.tensor(tv, dtype=torch.int32, device=cuda)
        before = tm.launches[form]
        got = tm.mac(ring, bank, r, idx, mask, t, uniform)
        ref = tm.mac_reference(ring, bank, r, idx, mask, t, uniform)
        torch.cuda.synchronize()
        assert tm.launches[form] == before + 1
        assert got.dtype == torch.float32 and got.shape == (len(rows), 2, K)
        assert _rel(got, ref) <= 1e-5
    assert torch.equal(got, tm.mac(ring.float(), bank.float(), r, idx, mask,
                                   t, uniform))


@pytest.mark.cuda
@pytest.mark.parametrize("combo", BF16_COMBOS)
@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("F,B,K,E,rows,offset", [
    (26, 8, 8192, 2, list(range(26)), 0),   # bench5's shape
    (6, 8, 8192, 7, [2, 3, 4, 5], 0),       # bench1's first stage
    (6, 8, 8192, 7, [2, 3, 4, 5], 1),
    (5, 6, 1001, 3, [4, 1, 1], 0),          # K % 4 != 0: the scalar path
    (40, 4, 8192, 2, list(range(40)) + [3, 3], 0),
    (3, 22, 1024, 2, [0, 1, 2], 0),         # groups of 4: 5 and a half
])
def test_dual_mac_bf16_forms_match_plain_version(cuda, combo, uniform, F, B,
                                                 K, E, rows, offset):
    """The bf16 forms of bf_mac_dual (csrc/mac_dual.cu) at bench5's and
    bench1's shapes, on the scalar path and past one group: both
    products, prev_mask != mask; the new set equal to bf_mac's bf16
    form's, bit for bit."""
    ring, bank, idx, mask, _ = _mac_inputs(F * K + 5, F, B, K, E, 1,
                                           uniform, cuda)
    mask[:, 0] = 1.0
    ring, bank = _bf16(combo, ring, bank)
    ring = _at_offset(ring, offset)
    pidx = (idx + 1) % E
    pmask = mask.clone()
    pmask[:, max(1, B // 2):] = 0.0
    r = torch.tensor(rows, dtype=torch.int32, device=cuda)
    form = ("mac_dual_uniform" if uniform else "mac_dual_rows") + \
        mm.bf16_suffix(ring, bank)
    for tv in (0, 5, B - 1, 2 * B + 5):
        t = torch.tensor(tv, dtype=torch.int32, device=cuda)
        before = td.launches[form]
        got = td.mac_dual(ring, bank, r, idx, mask, pidx, pmask, t, uniform)
        ref = td.mac_dual_reference(ring, bank, r, idx, mask, pidx, pmask,
                                    t, uniform)
        torch.cuda.synchronize()
        assert td.launches[form] == before + 1
        for a, b in zip(got, ref):
            assert a.dtype == torch.float32 and _rel(a, b) <= 1e-5
        assert torch.equal(got[0], tm.mac(ring, bank, r, idx, mask, t,
                                          uniform))
    wide = td.mac_dual(ring.float(), bank.float(), r, idx, mask, pidx,
                       pmask, t, uniform)
    assert all(torch.equal(a, b) for a, b in zip(got, wide))


@pytest.mark.cuda
@pytest.mark.parametrize("combo", BF16_COMBOS)
@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("F,B,K,E,C", [
    (5, 6, 512, 3, 7),
    (26, 16, 8192, 2, 26),     # the massive shape
    (13, 6, 200, 3, 128),      # a ragged last 32-bin tile (K % 32 = 8)
    (255, 4, 96, 3, 256),      # F past one chunk: the shared out tile
    (3, 2, 65536, 2, 1),
    (2, 3000, 128, 2, 1),      # a bank tile too big to stage: streamed
    (7, 5, 256, 3, 9),         # odd B: a round's last stage one partition
    (4, 1, 64, 2, 3),          # B = 1
])
def test_mix_bf16_forms_match_plain_version(cuda, combo, uniform, F, B, K,
                                            E, C):
    """The bf16 forms of bf_mac_mix (csrc/mac_mix.cu): bf16 runs staged
    densely, two partitions a stage where they fit (odd B: the last stage
    of a round holds one), the uniform bank tile staged or streamed."""
    assert not mm.tiled_route(C, B, K)
    ring, bank, idx, mask, w = _mac_inputs(K + C + F + 1, F, B, K, E, C,
                                           uniform, cuda)
    mask[:, 0] = 1.0                 # no all-zero mask row at small B
    ring, bank = _bf16(combo, ring, bank)
    form = ("uniform" if uniform else "rows") + mm.bf16_suffix(ring, bank)
    for tv in (0, 4, B - 1, 2 * B + 5):
        t = torch.tensor(tv, dtype=torch.int32, device=cuda)
        before = mm.launches[form]
        got = mm.mac_mix(ring, bank, idx, mask, t, w, uniform)
        ref = mm.mac_mix_reference(ring, bank, idx, mask, t, w, uniform)
        torch.cuda.synchronize()
        assert mm.launches[form] == before + 1
        assert got.dtype == torch.float32 and _rel(got, ref) <= 1e-5
    assert _rel(got, mm.mac_mix(ring.float(), bank.float(), idx, mask, t, w,
                                uniform)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("combo", BF16_COMBOS)
@pytest.mark.parametrize("F,B,K,E,C,has_bin0", [
    (5, 3, 1000, 3, 37, 1),        # K % 64 = 40: a ragged last tile
    (13, 4, 8200, 5, 300, 1),      # C past one block's 256 rows
    (9, 2, 24, 4, 3, 1),           # K under one tile
    (256, 16, 1024, 256, 256, 1),  # the full-width rows, 16 rounds of 16
    (20, 5, 2056, 7, 20, 1),       # C_out 20, K % 64 = 8
    (128, 16, 2048, 128, 256, 0),  # a 2048-bin shard, not the first
    (128, 16, 2048, 128, 256, 1),  # ... the first
    (33, 7, 1096, 9, 300, 0),      # F % 16 != 0, two row blocks
])
def test_tiled_bf16_forms_match_plain_version(cuda, monkeypatch, combo, F, B,
                                              K, E, C, has_bin0):
    """The bf16 forms of bf_mac_mix_tiled (csrc/mac_mix_tiled.cu), forced
    by the route: 64-bin tiles of 256 rows (gridDim.y past that), rounds
    of 16 filters, a ragged last tile, bin 0 with and without the packed
    rule."""
    monkeypatch.setattr(mm, "tiled_route", lambda *a: True)
    ring, bank, idx, mask, w = _mac_inputs(F * K + C + 2, F, B, K, E, C,
                                           False, cuda)
    ring, bank = _bf16(combo, ring, bank)
    form = "tiled" + mm.bf16_suffix(ring, bank)
    for tv in (0, B - 1, 3 * B + 2):
        t = torch.tensor(tv, dtype=torch.int32, device=cuda)
        before = mm.launches[form]
        got = mm.mac_mix(ring, bank, idx, mask, t, w, False, bool(has_bin0))
        ref = mm.mac_mix_reference(ring, bank, idx, mask, t, w, False,
                                   bool(has_bin0))
        torch.cuda.synchronize()
        assert mm.launches[form] == before + 1
        assert got.dtype == torch.float32 and _rel(got, ref) <= 1e-5
    assert _rel(got, mm.mac_mix(ring.float(), bank.float(), idx, mask, t, w,
                                False, bool(has_bin0))) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("combo", BF16_COMBOS)
@pytest.mark.parametrize("G", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("F,B,K,E,C,has_bin0", [
    (7, 6, 1000, 3, 9, 1),         # K % 512 != 0: a ragged last block
    (19, 9, 296, 5, 70, 1),        # K under one block's 512 bins
    (256, 16, 1024, 256, 256, 1),  # the full-width rows
    (40, 3, 96, 3, 33, 1),         # E < F: bank rows used many times
    (20, 5, 1000, 4, 20, 1),       # C_out 20
    (20, 5, 1000, 4, 300, 1),      # C past one block's rows at every G
    (128, 16, 2048, 128, 256, 0),  # a 2048-bin shard, not the first
    (128, 16, 2048, 128, 256, 1),  # ... the first
    (33, 7, 1096, 9, 300, 0),      # F % 16 != 0, C_out past 256, no bin 0
    (20, 5, 1000, 4, 20, 0),       # C_out 20 without the packed bin 0
    (37, 2, 8, 5, 256, 1),         # K = 8: one chunk of a bf16 run
    (5, 1, 64, 2, 7, 1),           # B = 1: ring slots wrap twice a copy
])
def test_group_bf16_forms_match_plain_versions(cuda, combo, G, F, B, K, E,
                                               C, has_bin0):
    """The bf16 forms of bf_mac_group and bf_mac_mix_group
    (csrc/mac_group.cu):
    xnews of the ring's dtype, delays 0 .. G+1, start times that wrap the
    ring inside the group, four bins a thread in blocks of 512 bins (the
    grouped MAC), dense 16- or 24-chunk positions with two positions a
    copy and ragged 32-bin tiles (the fused form), bin 0 with and without
    the packed rule; the fused form equal to its float32 form on the
    widened operands, bit for bit."""
    ring, xnews, bank, idx, mask, delay, w = _group_inputs(
        G * 100 + K + 1, F, B, K, E, G, C, cuda)
    ring, bank, xnews = _bf16(combo, ring, bank, xnews)
    sfx = mm.bf16_suffix(ring, bank)
    b0 = bool(has_bin0)
    for tv in (0, B - 1, 2 * B + 1):
        t = torch.tensor(tv, dtype=torch.int32, device=cuda)
        before = dict(mg.launches)
        got = mg.mac_group(ring, xnews, bank, idx, mask, t, delay, b0)
        ref = mg.mac_group_reference(ring, xnews, bank, idx, mask, t, delay,
                                     b0)
        gotm = mg.mac_mix_group(ring, xnews, bank, idx, mask, t, w, delay, b0)
        refm = mg.mac_mix_group_reference(ring, xnews, bank, idx, mask, t,
                                          w, delay, b0)
        torch.cuda.synchronize()
        assert mg.launches["group" + sfx] == before["group" + sfx] + 1
        assert (mg.launches["mix_group" + sfx]
                == before["mix_group" + sfx] + 1)
        for a, b in ((got, ref), (gotm, refm)):
            assert a.dtype == torch.float32 and _rel(a, b) <= 1e-5
    wide = [x.float() for x in (ring, xnews, bank)]
    assert _rel(got, mg.mac_group(wide[0], wide[1], wide[2], idx, mask, t,
                                  delay, b0)) <= 1e-5
    assert torch.equal(gotm, mg.mac_mix_group(wide[0], wide[1], wide[2], idx,
                                              mask, t, w, delay, b0))


@pytest.mark.cuda
def test_staged_bf16_forms_refuse_unaligned_operands(cuda, monkeypatch):
    """The bf16 forms that move whole 16-byte runs (csrc/mac_mix.cu, the
    tiled kernel, both grouped MACs) raise ValueError at K % 8 != 0 or on
    an unaligned ring, bank or xnews, never read out of bounds; the
    unfused MAC takes such operands (its scalar path)."""
    ring, bank, idx, mask, w = _mac_inputs(3, 4, 3, 1004, 2, 5, False, cuda)
    t = torch.tensor(2, dtype=torch.int32, device=cuda)
    r16 = ring.to(torch.bfloat16)
    for tiled in (False, True):
        monkeypatch.setattr(mm, "tiled_route", lambda *a, _t=tiled: _t)
        with pytest.raises(ValueError):
            mm.mac_mix(r16, bank, idx, mask, t, w, False)
        with pytest.raises(ValueError):
            mm.mac_mix(ring, bank.to(torch.bfloat16), idx, mask, t, w, False)
    monkeypatch.undo()
    ring, bank, idx, mask, w = _mac_inputs(4, 4, 3, 1024, 2, 5, False, cuda)
    r16 = _at_offset(ring.to(torch.bfloat16), 1)
    for tiled in (False, True):
        monkeypatch.setattr(mm, "tiled_route", lambda *a, _t=tiled: _t)
        with pytest.raises(ValueError):
            mm.mac_mix(r16, bank, idx, mask, t, w, False)
        with pytest.raises(ValueError):
            mm.mac_mix(ring, _at_offset(bank.to(torch.bfloat16), 4), idx,
                       mask, t, w, False)
    monkeypatch.undo()
    rows = torch.arange(4, dtype=torch.int32, device=cuda)
    got = tm.mac(r16, bank, rows, idx, mask, t, False)
    assert _rel(got, tm.mac_reference(r16, bank, rows, idx, mask, t,
                                      False)) <= 1e-5
    ring, xnews, bank, idx, mask, delay, w = _group_inputs(
        5, 6, 5, 1004, 3, 2, 7, cuda)
    for fn in (mg.mac_group, mg.mac_mix_group):
        extra = (w,) if fn is mg.mac_mix_group else ()
        with pytest.raises(ValueError):
            fn(ring.to(torch.bfloat16), xnews.to(torch.bfloat16), bank, idx,
               mask, t, *extra, delay)
        with pytest.raises(ValueError):
            fn(ring, xnews, bank.to(torch.bfloat16), idx, mask, t, *extra,
               delay)
    ring, xnews, bank, idx, mask, delay, w = _group_inputs(
        6, 6, 5, 1024, 3, 3, 7, cuda)
    r16 = ring.to(torch.bfloat16)
    for fn in (mg.mac_group, mg.mac_mix_group):
        extra = (w,) if fn is mg.mac_mix_group else ()
        with pytest.raises(ValueError):
            fn(r16, _at_offset(xnews.to(torch.bfloat16), 2), bank, idx,
               mask, t, *extra, delay)
        with pytest.raises(ValueError):
            fn(_at_offset(r16, 4), xnews.to(torch.bfloat16), bank, idx,
               mask, t, *extra, delay)


@pytest.mark.cuda
@pytest.mark.parametrize("fail", [False, True])
def test_profile_traces_run_on_card(cuda, tmp_path, monkeypatch, fail):
    """BRUTEFIR_TPU_PROFILE=<dir>: run() writes one Chrome trace that
    names the MAC kernel and both glue kernels of the route (the forward
    one into the ring); also when run() raises,
    and the profiler is stopped then (a new one starts). run_offline
    writes one too, with the kernels and the engine's spans: the
    producer's upload, the dispatch's replays, the writer's fetch."""
    from brutefir_tpu_torch.runtime.engine import Engine
    N, B, C = 512, 2, 2
    rng = np.random.default_rng(3)
    (rng.standard_normal(N * B) * 0.1).astype("<f4").tofile(tmp_path / "h.raw")
    np.round(rng.standard_normal((N * 4, C)) * 2 ** 19).astype(
        "<i4").tofile(tmp_path / "in.raw")
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
coeff 0 {{ filename: "{tmp_path / 'h.raw'}"; format: "FLOAT_LE"; }};
input 0,1 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: {C}; }};
output 0,1 {{ device: "file" {{ path: "{tmp_path / 'out.raw'}"; }}; sample: "S24_4LE"; channels: {C}; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_inputs: 1; to_outputs: 1; coeff: 0; }};
""")
    conf.quiet = True
    out = tmp_path / "trace"
    monkeypatch.setenv("BRUTEFIR_TPU_PROFILE", str(out))
    eng = Engine(conf, device=cuda)
    if fail:
        def boom(*a, **k):
            raise RuntimeError("stop")
        monkeypatch.setattr(eng, "_run_blocks", boom)
        with pytest.raises(RuntimeError):
            eng.run()
    else:
        eng.run()
    files = list(out.glob("*.json"))
    assert len(files) == 1
    if not fail:
        text = files[0].read_text()
        for name in ("mac_mix_kernel", "glue_fwd_ring_kernel",
                     "glue_inv_kernel"):
            assert name in text, name
        Engine(conf, device=cuda).run_offline(batch_blocks=2)
        new = set(out.glob("*.json")) - set(files)
        assert len(new) == 1
        trace = json.loads(new.pop().read_text())
        names = {e.get("name", "") for e in trace["traceEvents"]}
        assert any("mac_mix_kernel" in n for n in names)
        spans = {e["name"] for e in trace["traceEvents"]
                 if e.get("cat") == "program_span"}
        assert {"upload", "dispatch", "replay", "clone", "write.sync",
                "write.fetch"} <= spans, spans
    with torch.profiler.profile():
        pass


@pytest.mark.cuda
def test_spans_share_the_profilers_clock(cuda):
    """A span around one kernel's launch and ``torch.cuda.synchronize()``
    holds that kernel's interval among ``torch.profiler``'s device events,
    within 50 µs at each end: the recorder's spans and the profiler's
    device events lie on one clock. (The launch itself can take 0.1-0.3
    ms, so a kernel starts well inside its span; a clock off by more than
    the span's slack would put it outside.)"""
    from torch._C._autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from brutefir_tpu_torch.runtime import tracing
    rec = tracing.RECORDER
    x = torch.ones(1 << 26, device=cuda)      # 256 MB: one kernel of ~0.2 ms
    x.mul_(1.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tracing.enable()
        try:
            for _ in range(8):
                sp = rec.begin("kernel")
                x.mul_(1.0)
                torch.cuda.synchronize()
                rec.end(sp)
                time.sleep(0.005)
        finally:
            tracing.disable()
    spans = tracing.take()
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and "elementwise" in e.name()]
    assert len(spans) == 8 and kernels
    for a, b in kernels:
        inside = [s for s in spans
                  if s.start_ns - 50_000 <= a and b <= s.end_ns + 50_000]
        assert len(inside) == 1, (a, b, spans)


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [("bf16", ""), ("", "bf16"),
                                   ("bf16", "bf16")])
def test_bf16_engine_on_card_matches_cpu(cuda, tmp_path, monkeypatch, knobs,
                                        capsys):
    """The engine under the bank and ring knobs on the card against the
    same engine on the CPU: the bank's bits equal; the outputs within 4
    LSB (2 measured on an H100 under each combination: both sides round
    the same spectra to bf16 to nearest even, and the card's and the
    CPU's float32 FFTs differ by an ulp now and then, which may send a
    value to the other bf16 neighbour; a cast that truncated, or a biased
    widening, would be thousands of LSB off)."""
    from brutefir_tpu_torch.runtime.engine import Engine
    bank_dt, ring_dt = knobs
    monkeypatch.setenv("BRUTEFIR_TPU_BANK_DTYPE", bank_dt)
    monkeypatch.setenv("BRUTEFIR_TPU_RING_DTYPE", ring_dt)
    N, B, C = 256, 4, 3
    rng = np.random.default_rng(11)
    for k in range(2):
        (rng.standard_normal(N * B) * 0.1).astype("<f4").tofile(
            tmp_path / f"h{k}.raw")
    frames = N * 9 + 5
    np.round(rng.standard_normal((frames, C)) * 2 ** 19).astype(
        "<i4").tofile(tmp_path / "in.raw")
    ys, banks = [], []
    for tag, dev in (("gpu", cuda), ("cpu", torch.device("cpu"))):
        conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
coeff 0 {{ filename: "{tmp_path / 'h0.raw'}"; format: "FLOAT_LE"; }};
coeff 1 {{ filename: "{tmp_path / 'h1.raw'}"; format: "FLOAT_LE"; }};
input 0,1,2 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: {C}; }};
output 0,1,2 {{ device: "file" {{ path: "{tmp_path / (tag + '.raw')}"; }}; sample: "S24_4LE"; channels: {C}; dither: false; }};
""" + "\n".join(f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; "
                f"coeff: {i % 2}; }};" for i in range(C)))
        conf.quiet = True
        eng = Engine(conf, device=dev)
        assert eng.bank.dtype == (torch.bfloat16 if bank_dt
                                  else torch.float32)
        assert eng.state.ring.dtype == (torch.bfloat16 if ring_dt
                                        else torch.float32)
        banks.append(eng.bank.cpu())
        assert eng.run_offline()["frames"] == frames
        ys.append(np.fromfile(tmp_path / (tag + ".raw"), "<i4").astype(
            np.int64))
    assert torch.equal(banks[0], banks[1])
    peak = np.abs(ys[1]).max()
    gap = np.abs(ys[0] - ys[1]).max()
    with capsys.disabled():
        print(f"\nbf16 engine, bank {bank_dt or 'f32'}, ring "
              f"{ring_dt or 'f32'}: card vs CPU {gap} LSB (peak {peak})")
    assert peak > 2 ** 18
    assert gap <= 4


# --- the step programs: captured graphs against the eager forms -------------

def _program_config(tmp_path, topology: str, N: int = 256, B: int = 4,
                    C: int = 3) -> str:
    """tests/test_torch_program.py's configs: S24_4LE, input delays up to
    a maxdelay, output delays; ``shared`` (one coefficient), ``per`` (two,
    per-filter pre-delays), ``cascade`` (two stages), ``xfade`` (shared,
    crossfading)."""
    rng = np.random.default_rng(5)
    coeffs = ""
    for k in range(2):
        (tmp_path / f"c{k}.txt").write_text("\n".join(
            repr(float(v)) for v in rng.standard_normal(N * B - 50 * k)
            * 0.03) + "\n")
        coeffs += (f'coeff {k} {{ filename: "{tmp_path / f"c{k}.txt"}"; '
                   f'format: "TEXT"; }};\n')
    chans = ",".join(str(c) for c in range(C))
    if topology == "cascade":
        filters = (
            "filter 0 { from_inputs: 0; to_filters: 2; coeff: 0; };\n"
            "filter 1 { from_inputs: 1, 2; to_filters: 2; coeff: 1; };\n"
            "filter 2 { from_filters: 0, 1; to_outputs: 0, 1, 2; "
            "coeff: 0; };\n")
    else:
        filters = "".join(
            f"filter {f} {{ from_inputs: {f}; to_outputs: {f}; "
            f"coeff: {f % 2 if topology == 'per' else 0}; "
            f"{'delay: ' + str(f) + '; ' if topology == 'per' else ''}"
            f"{'crossfade: true; ' if topology == 'xfade' else ''}}};\n"
            for f in range(C))
    return f"""
sampling_rate: 44100;
filter_length: {N},{B};
{coeffs}
input {chans} {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: {C}; delay: 3, 0, 7; maxdelay: 20; }};
output {chans} {{ device: "file" {{ path: "{tmp_path / 'out.raw'}"; }}; sample: "S24_4LE"; channels: {C}; dither: false; delay: 0, 5, 2; }};
{filters}"""


@pytest.mark.cuda
@pytest.mark.parametrize("topology,op,pair,form", [
    ("shared", "multi", None, None),
    ("per", "multi", None, None),
    ("cascade", "multi", None, None),
    ("shared", "multi", "force:2", None),
    ("per", "multi", "force:4", None),
    ("per", "multi", "force:4", "unfused"),
    ("xfade", "step", None, None),
    ("per", "step", None, None)])
def test_program_graphs_match_eager_forms(cuda, tmp_path, monkeypatch,
                                          topology, op, pair, form):
    """DeviceIO through its captured graphs and through its eager forms,
    two engines on the card, the same words and control changes (a
    coefficient change and a mute, an input delay change and a bank
    swap, a state and ``dstate`` handed back): byte-equal outputs,
    meters and NaN flags; the launches a call
    counts equal to the eager call's; the outputs of a call unchanged
    after the later calls; every key called twice captured."""
    from brutefir_tpu_torch.config.model import IN, OUT
    from brutefir_tpu_torch.runtime.engine import Engine
    from brutefir_tpu_torch.runtime.program import COUNTERS, tree_map
    if pair:
        monkeypatch.setenv("BRUTEFIR_TPU_PAIR", pair)
    if form:
        monkeypatch.setenv("BRUTEFIR_TPU_GROUP_FORM", form)
    text = _program_config(tmp_path, topology)
    engines = [Engine(parse_config(text), device=cuda) for _ in range(2)]
    entry = 0.5 * engines[0].bank[1].cpu().numpy()
    rng = np.random.default_rng(23)
    N, C, m = 256, 3, 8

    def counts():
        return [dict(c) for c in COUNTERS]

    def call(eng, eager, words):
        ctrl, gains, uni, udl, xf, bank, _ = eng._snapshot_epoch()
        w = [torch.as_tensor(words, device=cuda)]
        if op == "multi":
            fn = eng.dio.multi_step_eager if eager else eng.dio.multi_step
            r = fn(eng.state, ctrl, gains[0], gains[1], bank, w,
                   uniform=uni, udelay=udl)
        else:
            fn = eng.dio.step_eager if eager else eng.dio.step
            r = fn(eng.state, ctrl, gains[0], gains[1], bank, w,
                   uniform=uni, udelay=udl, xfade=xf)
        eng.state = r[0]
        return r[1:]

    def host(out):
        outs, meters, nan_ok = out
        return [o.cpu().numpy() for o in outs + meters] + [
            nan_ok.cpu().numpy()]

    kept = []
    for i in range(7):
        for e in engines:
            if i == 2:
                e.control.change_coeff(0, 1)
                e.control.set_mute(OUT, 2, True)
            elif i == 4:
                e.control.change_coeff(0, 0)
                e.control.set_delay(IN, 1, 9)
                e.update_bank_entry(0, entry)
            elif i == 5:
                e.control.set_mute(OUT, 2, False)
                # a state and dstate handed back, as the warm-up does
                e.state = tree_map(torch.clone, e.state)
                e.dio.dstate = tree_map(torch.clone, e.dio.dstate)
        x = np.round(rng.standard_normal(
            ((m,) if op == "multi" else ()) + (N, C)) * 2.0 ** 18)
        words = np.ascontiguousarray(x.astype("<i4").view(np.uint8).reshape(
            x.shape + (4,))[..., :3])
        deltas, results = [], []
        for eng, eager in zip(engines, (False, True)):
            before = counts()
            out = call(eng, eager, words)
            torch.cuda.synchronize()
            after = counts()
            deltas.append([{k: a[k] - b[k] for k in a}
                           for a, b in zip(after, before)])
            results.append(host(out))
            if not eager:
                kept.append((out, results[-1]))
        assert deltas[0] == deltas[1], (i, deltas)
        assert sum(n for d in deltas[0] for n in d.values()) > 0
        for j, (a, b) in enumerate(zip(*results)):
            assert a.dtype == b.dtype and np.array_equal(a, b), (
                i, j, np.abs(a.astype(np.float64) - b).max())
    for out, first in kept:
        for a, b in zip(host(out), first):
            assert np.array_equal(a, b)
    progs = engines[0].dio.programs()
    assert engines[0].dio.captures and not engines[1].dio.programs()
    assert all(p.graph is not None for p in progs.values() if p.calls >= 2)
    assert any(p.graph is not None for p in progs.values())
    if topology == "xfade":
        assert any(k[3] for k in progs)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["S24_BE", "FLOAT64_LE"])
def test_host_programs_match_eager_on_card(cuda, tmp_path, fmt):
    """The host codec path on the card through its captured graphs
    (``runtime/program.HostStep``) and through the eager dispatch
    (``Engine._dispatch_eager``), file to file through ``run()``: S24_BE
    devices (crossfading filters swapped and a mute set by a CLI script:
    the ``xfade`` key and new controls copied in) and FLOAT64_LE devices
    under ``float_bits: 64`` (the float64 stage loop and glue). The
    output files byte-equal, every launch count equal, every key called
    twice captured."""
    from brutefir_tpu_torch.runtime.engine import Engine
    from brutefir_tpu_torch.runtime.program import COUNTERS
    N, B, C, frames = 256, 4, 3, 256 * 12 + 77
    rng = np.random.default_rng(41)
    coeffs = ""
    for k in range(2):
        (tmp_path / f"c{k}.txt").write_text("\n".join(
            repr(float(v)) for v in rng.standard_normal(N * B - 60 * k)
            * 0.05) + "\n")
        coeffs += (f'coeff {k} {{ filename: "{tmp_path / f"c{k}.txt"}"; '
                   f'format: "TEXT"; }};\n')
    x = rng.standard_normal((frames, C))
    if fmt == "S24_BE":
        w = np.round(x * 2.0 ** 18).astype("<i4")
        (w.view(np.uint8).reshape(frames, C, 4)[..., 2::-1]
         .tofile(tmp_path / "in.raw"))
        head = ('logic: "cli" { script: "sleep b2\\ncfc 0 1; tmo 2\\n'
                'sleep b3\\ncfc 0 0; tmo 2\\nsleep b999"; echo: false; };')
        xf = "crossfade: true; "
    else:
        (x * 0.3).astype("<f8").tofile(tmp_path / "in.raw")
        head, xf = "float_bits: 64;", ""
    filters = "".join(f"filter {f} {{ from_inputs: {f}; to_outputs: {f}; "
                      f"coeff: {f % 2}; {xf}}};\n" for f in range(C))
    chans = ",".join(str(c) for c in range(C))
    outs, launched, engines = {}, {}, {}
    for route in ("graphs", "eager"):
        conf = parse_config(
            f"sampling_rate: 44100;\nfilter_length: {N},{B};\n{head}\n"
            f"{coeffs}"
            f'input {chans} {{ device: "file" {{ path: '
            f'"{tmp_path / "in.raw"}"; }}; sample: "{fmt}"; channels: {C}; '
            f'}};\noutput {chans} {{ device: "file" {{ path: '
            f'"{tmp_path / (route + ".raw")}"; }}; sample: "{fmt}"; '
            f'channels: {C}; dither: false; }};\n{filters}')
        conf.quiet = True
        eng = Engine(conf, device=cuda)
        assert eng.dio is None and eng.host_step is not None
        if route == "eager":
            eng._dispatch_host = eng._dispatch_eager
        before = [dict(c) for c in COUNTERS]
        eng.run()
        torch.cuda.synchronize()
        launched[route] = [{k: n - b[k] for k, n in c.items()}
                           for c, b in zip(COUNTERS, before)]
        outs[route] = (tmp_path / (route + ".raw")).read_bytes()
        engines[route] = eng
    assert len(outs["graphs"]) == frames * C * (3 if fmt == "S24_BE" else 8)
    assert outs["graphs"] == outs["eager"]
    assert launched["graphs"] == launched["eager"]
    assert sum(n for d in launched["graphs"] for n in d.values()) > 0
    hs = engines["graphs"].host_step
    progs = hs.programs()
    assert hs.captures and not engines["eager"].host_step.programs()
    assert all(p.graph is not None for p in progs.values() if p.calls >= 2)
    assert any(p.graph is not None for p in progs.values())
    if fmt == "S24_BE":
        assert {k[2] for k in progs} == {False, True}


class _GainTaps:
    """Frequency-domain hooks of ``kinds``, each scaling its row by a
    seeded gain of the row's id, each call recorded as (kind, id, the
    bytes of the row it is handed)."""

    def __init__(self, kinds, seed=43):
        self.rows = []
        gains = np.random.default_rng(seed).uniform(0.5, 1.5, (4, 16))
        for k, kind in enumerate(kinds):
            setattr(self, kind, self._hook(kind, gains[k]))

    def _hook(self, kind, gains):
        def hook(buf, i):
            self.rows.append((kind, i, buf.tobytes()))
            buf *= gains[i]
        return hook


@pytest.mark.cuda
@pytest.mark.parametrize("topology", ["single", "crossfade"])
def test_tap_programs_match_eager_on_card(cuda, tmp_path, topology):
    """The tapped host step on the card through its segmented graphs
    (``runtime/program.TapStep``: S + 1 captured graphs a key, the hooks
    on the host between them) and through the eager dispatch
    (``Engine._dispatch_eager``), file to file through ``run()``: a
    single stage under all four frequency-domain hooks (four tap sites,
    five segments), and two crossfading filters a CLI script swaps every
    third block under ``post_convolve`` (the plain and the ``xfade``
    keys replayed in turns, each on its own pool). The output files
    byte-equal, every launch count equal, the hooks handed the same rows,
    every key called twice captured into S + 1 graphs."""
    from brutefir_tpu_torch.runtime.engine import Engine
    from brutefir_tpu_torch.runtime.program import COUNTERS, TapStep
    N, B, C, frames = 256, 4, 3, 256 * 14 + 77
    rng = np.random.default_rng(44)
    coeffs = ""
    for k in range(2):
        (tmp_path / f"c{k}.txt").write_text("\n".join(
            repr(float(v)) for v in rng.standard_normal(N * B - 60 * k)
            * 0.05) + "\n")
        coeffs += (f'coeff {k} {{ filename: "{tmp_path / f"c{k}.txt"}"; '
                   f'format: "TEXT"; }};\n')
    x = rng.standard_normal((frames, C))
    w = np.round(x * 2.0 ** 18).astype("<i4")
    (w.view(np.uint8).reshape(frames, C, 4)[..., 2::-1]
     .tofile(tmp_path / "in.raw"))
    if topology == "single":
        kinds = ("input_freqd", "pre_convolve", "post_convolve",
                 "output_freqd")
        head, xf = "", ""
    else:
        kinds = ("post_convolve",)
        head = ('logic: "cli" { script: "cfc 0 1; cfc 1 0\\nsleep b2\\n'
                'cfc 0 0; cfc 1 1\\nsleep b2"; echo: false; };')
        xf = "crossfade: true; "
    filters = "".join(f"filter {f} {{ from_inputs: {f}; to_outputs: {f}; "
                      f"coeff: {f % 2}; {xf}}};\n" for f in range(C))
    chans = ",".join(str(c) for c in range(C))
    outs, launched, engines, rows = {}, {}, {}, {}
    for route in ("graphs", "eager"):
        conf = parse_config(
            f"sampling_rate: 44100;\nfilter_length: {N},{B};\n{head}\n"
            f"{coeffs}"
            f'input {chans} {{ device: "file" {{ path: '
            f'"{tmp_path / "in.raw"}"; }}; sample: "S24_BE"; channels: {C}; '
            f'}};\noutput {chans} {{ device: "file" {{ path: '
            f'"{tmp_path / (route + ".raw")}"; }}; sample: "S24_BE"; '
            f'channels: {C}; dither: false; }};\n{filters}')
        conf.quiet = True
        eng = Engine(conf, device=cuda)
        hooks = _GainTaps(kinds)
        eng.logic.append(hooks)
        if route == "eager":
            eng._dispatch_host = eng._dispatch_eager
        before = [dict(c) for c in COUNTERS]
        eng.run()
        torch.cuda.synchronize()
        launched[route] = [{k: n - b[k] for k, n in c.items()}
                           for c, b in zip(COUNTERS, before)]
        outs[route] = (tmp_path / (route + ".raw")).read_bytes()
        engines[route] = eng
        rows[route] = hooks.rows
    assert len(outs["graphs"]) == frames * C * 3
    assert outs["graphs"] == outs["eager"]
    assert launched["graphs"] == launched["eager"]
    assert sum(n for d in launched["graphs"] for n in d.values()) > 0
    assert rows["graphs"] == rows["eager"] and rows["graphs"]
    hs = engines["graphs"].host_step
    assert isinstance(hs, TapStep) and hs.captures
    assert not engines["eager"].host_step.programs()
    assert [s.kind for s in hs.sites] == list(kinds)
    progs = hs.programs()
    assert all(p.graph is not None and len(p.graph) == len(kinds) + 1
               for p in progs.values() if p.calls >= 2)
    assert all(p.calls >= 3 for p in progs.values())
    if topology == "crossfade":
        assert {k[2] for k in progs} == {False, True}


# --- the step programs on a mesh: cell streams, captured ---------------------

def _mesh_program_config(tmp_path, shape: str, name: str) -> str:
    """The smoke's main-path shapes at a reduced depth: ``massive`` (26
    filters of one coefficient), ``scale`` (32 filters, a coefficient
    each, the grouped dispatch under ``BRUTEFIR_TPU_PAIR=force:4``),
    ``bench1`` (the reference's two-stage cascade) and ``bench5`` (26
    crossfading filters a CLI script flips every block), S24_4LE."""
    N, B = 1024, 4
    C = {"massive": 26, "scale": 32, "bench1": 2, "bench5": 26}[shape]
    E = {"massive": 1, "scale": 32, "bench1": 6, "bench5": 2}[shape]
    rng = np.random.default_rng(61)
    coeffs = ""
    for k in range(E):
        (rng.standard_normal(N * B) * 0.05 * np.exp(-np.arange(N * B)
                                                    / 1500.0)).astype(
            "<f4").tofile(tmp_path / f"h{k}.raw")
        coeffs += (f'coeff {k} {{ filename: "{tmp_path / f"h{k}.raw"}"; '
                   f'format: "FLOAT_LE"; }};\n')
    head = ""
    if shape == "bench1":
        filters = """
filter 0 { from_filters: 2, 5; to_outputs: 0; coeff: 0; };
filter 1 { from_filters: 3, 4; to_outputs: 1; coeff: 1; };
filter 2 { from_inputs: 0; to_filters: 0; coeff: 2; };
filter 3 { from_inputs: 0; to_filters: 1; coeff: 3; };
filter 4 { from_inputs: 1; to_filters: 1; coeff: 4; };
filter 5 { from_inputs: 1; to_filters: 0; coeff: 5; };
"""
    else:
        xf = "crossfade: true; " if shape == "bench5" else ""
        filters = "".join(
            f"filter {f} {{ from_inputs: {f}; to_outputs: {f}; "
            f"coeff: {f % E}; {xf}}};\n" for f in range(C))
    if shape == "bench5":
        script = "\\n".join(" ".join(f"cfc {i} {s};" for i in range(C))
                            for s in (1, 0))
        head = f'logic: "cli" {{ script: "{script}"; echo: false; }};'
    chans = ",".join(str(c) for c in range(C))
    return (f"sampling_rate: 44100;\nfilter_length: {N},{B};\n{head}\n"
            f"{coeffs}"
            f'input {chans} {{ device: "file" {{ path: '
            f'"{tmp_path / "in.raw"}"; }}; sample: "S24_4LE"; channels: '
            f'{C}; }};\noutput {chans} {{ device: "file" {{ path: '
            f'"{tmp_path / name}"; }}; sample: "S24_4LE"; channels: {C}; '
            f'dither: false; }};\n{filters}')


def _mesh_graphs_vs_eager(tmp_path, monkeypatch, shape, devices, f, sp):
    """One shape on the mesh ``f`` x ``sp`` over ``devices`` through the
    captured graphs and through the eager forms, file to file: the output
    files byte-equal, every launch count equal, every key called twice
    captured, each cell on a stream of its own. Returns the graphs'
    engine."""
    from brutefir_tpu_torch.parallel import make_mesh
    from brutefir_tpu_torch.runtime.engine import Engine
    from brutefir_tpu_torch.runtime.program import COUNTERS
    if shape == "scale":
        monkeypatch.setenv("BRUTEFIR_TPU_PAIR", "force:4")
    N = 1024
    C = {"massive": 26, "scale": 32, "bench1": 2, "bench5": 26}[shape]
    frames = N * 17 + 300
    np.round(np.random.default_rng(62).standard_normal((frames, C))
             * 2 ** 18).astype("<i4").tofile(tmp_path / "in.raw")
    outs, launched, engines = {}, {}, {}
    for route in ("graphs", "eager"):
        conf = parse_config(_mesh_program_config(tmp_path, shape,
                                                 route + ".raw"))
        conf.quiet = True
        eng = Engine(conf, device=devices[0], mesh=make_mesh(devices, f, sp))
        if route == "eager":
            eng.dio.step = eng.dio.step_eager
            eng.dio.multi_step = eng.dio.multi_step_eager
        before = [dict(c) for c in COUNTERS]
        if shape == "bench5":
            eng.run()
        else:
            eng.run_offline(batch_blocks=4 if shape == "scale" else 2)
        for d in set(devices):
            torch.cuda.synchronize(d)
        launched[route] = [{k: n - b.get(k, 0) for k, n in c.items()}
                           for c, b in zip(COUNTERS, before)]
        outs[route] = (tmp_path / (route + ".raw")).read_bytes()
        engines[route] = eng
    assert len(outs["graphs"]) == frames * C * 4
    assert outs["graphs"] == outs["eager"]
    assert launched["graphs"] == launched["eager"]
    assert sum(n for d in launched["graphs"] for n in d.values()) > 0
    if shape == "scale":
        assert launched["graphs"][2].get("group", 0) > 0   # mac_group
    eng = engines["graphs"]
    progs = eng.dio.programs()
    assert eng.dio.captures and not engines["eager"].dio.programs()
    assert all(p.graph is not None for p in progs.values() if p.calls >= 2)
    assert any(p.graph is not None for p in progs.values())
    assert len(eng.mesh.streams.streams) == f * sp
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("f,sp", [(2, 2), (1, 4)])
@pytest.mark.parametrize("shape", ["massive", "scale", "bench1", "bench5"])
def test_mesh_programs_match_eager_on_card(cuda, tmp_path, monkeypatch,
                                           shape, f, sp):
    """A mesh of f x sp cells on cuda:0, each on its own stream, through
    the captured graphs and through the eager forms: byte-equal, equal
    launch counts."""
    dev = torch.device("cuda:0")
    _mesh_graphs_vs_eager(tmp_path, monkeypatch, shape, [dev] * (f * sp),
                          f, sp)


@pytest.mark.cuda
@pytest.mark.parametrize("f,sp", [(2, 1), (1, 2)])
def test_mesh_programs_across_two_cards(cuda, tmp_path, monkeypatch, f, sp):
    """The massive shape across cuda:0 and cuda:1, captured in one graph
    over both cards (the second card's allocations in a private pool of
    its own): byte-equal to the eager forms, equal launch counts."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    devs = [torch.device("cuda:0"), torch.device("cuda:1")]
    eng = _mesh_graphs_vs_eager(tmp_path, monkeypatch, "massive", devs, f,
                                sp)
    for p in eng.dio.programs().values():
        if p.graph is not None:
            assert len(p.pools) == 1 and set(p.card_pool_bytes) == {
                "cuda:0", "cuda:1"}
