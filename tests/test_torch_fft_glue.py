"""brutefir_tpu_torch.ops.fft_glue (the FFT glue route, the port's only
route for its real transforms; the JAX package's BRUTEFIR_TPU_FFT_GLUE=
pallas) against the JAX package's Pallas glue (brutefir_tpu/ops/
pallas_glue.py, run in interpret mode off the TPU) on the same numpy
inputs, at lengths that glue does not take against numpy, the port's
transforms under each value of the JAX package's knob, and engines file
to file with the glue route in both packages.

Tolerances: the transforms within 1e-5 of the output's peak (the same
glue arithmetic in float32 on both sides; each package's own M-point
complex FFT, pocketfft and XLA's, rounds at a few ulp of the peak; numpy's
float64 FFT rounds below that); the
engines within 1 LSB of S24 of each other at normal levels (ROADMAP
queue 3), and the cascades on their float64 oracles within 2e-5 of the
peak + 4 LSB, the bound the JAX package's own cascade tests use."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from brutefir_tpu.config import parse_config as jax_parse_config
from brutefir_tpu.ops import pallas_glue as jpg
from brutefir_tpu.ops import partconv as jpc
from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.ops import fft_glue as tg
from brutefir_tpu_torch.ops import partconv as tpc
from tests.test_torch_cascade import bench1_config
from tests.test_torch_crossfade import (CASCADE_SCRIPT, bench1_xfade_config,
                                        cascade_oracle, cascade_sets)

SHAPES = [(3, 256), (2, 1024), (1, 8192)]
REL = 1e-5
CPU = torch.device("cpu")


def _close(got, ref, rel=REL):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("C,M", SHAPES)
def test_rfft_planes_glue_matches_jax(rng, C, M):
    x = rng.standard_normal((C, 2 * M)).astype(np.float32)
    _close(tg.rfft_planes_glue(torch.as_tensor(x)).numpy(),
           jpg.rfft_planes_pallas(jnp.asarray(x)))


@pytest.mark.parametrize("C,M", SHAPES)
def test_irfft_planes_glue_matches_jax(rng, C, M):
    p = rng.standard_normal((C, 2, M)).astype(np.float32)
    _close(tg.irfft_planes_glue(torch.as_tensor(p)).numpy(),
           jpg.irfft_planes_pallas(jnp.asarray(p)))


@pytest.mark.parametrize("C,M", SHAPES)
def test_irfft_planes_valid_glue_matches_jax(rng, C, M):
    p = rng.standard_normal((C, 2, M)).astype(np.float32)
    _close(tg.irfft_planes_valid_glue(torch.as_tensor(p)).numpy(),
           jpg.irfft_planes_valid_pallas(jnp.asarray(p)))


def test_multidim_prefix(rng):
    """Any leading shape flattens to channels (a crossfade passes
    [F, 2, N]; here a 4-D planes tensor)."""
    p = rng.standard_normal((2, 3, 2, 256)).astype(np.float32)
    x = rng.standard_normal((2, 3, 512)).astype(np.float32)
    _close(tg.irfft_planes_glue(torch.as_tensor(p)).numpy(),
           jpg.irfft_planes_pallas(jnp.asarray(p)))
    _close(tg.irfft_planes_valid_glue(torch.as_tensor(p)).numpy(),
           jpg.irfft_planes_valid_pallas(jnp.asarray(p)))
    _close(tg.rfft_planes_glue(torch.as_tensor(x)).numpy(),
           jpg.rfft_planes_pallas(jnp.asarray(x)))


@pytest.mark.parametrize("M", [8, 64, 128, 192, 384, 1000])
def test_glue_route_any_length(rng, M):
    """The glue route at lengths the JAX package's glue refuses (under
    two lanes, a row count that is not a power of two, M not a multiple
    of 128) against numpy's float64 transforms of the packed spectrum."""
    x = rng.standard_normal((2, 2 * M)).astype(np.float32)
    X = np.fft.rfft(x.astype(np.float64), axis=-1)
    packed = np.stack([X.real[:, :M],
                       np.concatenate([X.real[:, M:], X.imag[:, 1:M]], -1)],
                      axis=-2)
    _close(tpc.rfft_planes(torch.as_tensor(x)).numpy(), packed)
    p = torch.as_tensor(packed.astype(np.float32))
    _close(tpc.irfft_planes(p).numpy(), x)
    _close(tpc.irfft_planes_valid(p).numpy(), x[:, :M])


_GLUE_THREADS = 256      # csrc/fft_glue.cu's kThreads


def _glue_bins(M: int, block: int) -> list:
    """The bins block ``block`` of csrc/fft_glue.cu writes, as its kernels
    map them: thread j = block * kThreads + i, j <= M/2, writes bin j and,
    where it differs, the mirror bin (j ? M - j : 0)."""
    out = []
    for j in range(block * _GLUE_THREADS, (block + 1) * _GLUE_THREADS):
        if j > M // 2:
            break
        jm = M - j if j else 0
        out += [j] if jm == j else [j, jm]
    return out


@pytest.mark.parametrize("M", [1, 2, 3, 255, 256, 8192, 131072])
def test_glue_grid_writes_each_bin_once(M):
    """The glue kernels' grid (``grid_of``: (M/2 + kThreads) / kThreads
    blocks a channel) covers the pairs (j, M - j), j <= M/2; walking the
    block -> bin map, every bin is written exactly once, bins 0 and M/2
    included, and no block is empty."""
    blocks = (M // 2 + _GLUE_THREADS) // _GLUE_THREADS
    bins = [_glue_bins(M, b) for b in range(blocks)]
    assert all(bins)
    flat = [k for b in bins for k in b]
    assert len(flat) == M and sorted(flat) == list(range(M))


def _spy(monkeypatch):
    """Count the glue kernels' wrapper calls (on the CPU they run their
    plain versions)."""
    calls = {"glue_fwd": 0, "glue_inv": 0}
    for name in calls:
        orig = getattr(tg, name)

        def spy(t, _o=orig, _n=name):
            calls[_n] += 1
            return _o(t)
        monkeypatch.setattr(tg, name, spy)
    return calls


@pytest.mark.parametrize("mode", ["pallas", "mxu", None])
def test_partconv_dispatch_matches_jax(rng, monkeypatch, mode):
    """Every transform of the port goes through the glue route whatever
    the JAX package's knob says (the port does not read it), and equals
    the JAX package's under each value: its Pallas glue ("pallas" at
    M = 256 and 512; M = 384's three tile rows fail its glue_ok), its
    MXU glue ("mxu") or XLA's transforms."""
    if mode is None:
        monkeypatch.delenv("BRUTEFIR_TPU_FFT_GLUE", raising=False)
    else:
        monkeypatch.setenv("BRUTEFIR_TPU_FFT_GLUE", mode)
    calls = _spy(monkeypatch)
    for M in (256, 384, 512):
        x = rng.standard_normal((2, 2 * M)).astype(np.float32)
        p = rng.standard_normal((2, 2, M)).astype(np.float32)
        _close(tpc.rfft_planes(torch.as_tensor(x)).numpy(),
               jpc.rfft_planes(jnp.asarray(x)))
        _close(tpc.irfft_planes(torch.as_tensor(p)).numpy(),
               jpc.irfft_planes(jnp.asarray(p)))
        _close(tpc.irfft_planes_valid(torch.as_tensor(p)).numpy(),
               jpc.irfft_planes_valid(jnp.asarray(p)))
    assert calls == {"glue_fwd": 3, "glue_inv": 6}


def test_roundtrip_identity(rng):
    x = rng.standard_normal((4, 512)).astype(np.float32)
    p = tg.rfft_planes_glue(torch.as_tensor(x))
    np.testing.assert_allclose(tg.irfft_planes_glue(p).numpy(), x, rtol=0,
                               atol=1e-5 * np.abs(x).max())
    np.testing.assert_allclose(tg.irfft_planes_valid_glue(p).numpy(),
                               x[:, :256], rtol=0,
                               atol=1e-5 * np.abs(x).max())


# --- engines file to file, both packages on the glue route --------------------

def _engines(tmp_path, monkeypatch, make_text):
    """The JAX engine under BRUTEFIR_TPU_FFT_GLUE=pallas (and its Pallas
    MAC: the kernel forms and the FFT route the port runs) and the port's
    (CPU) on one config; returns the port's stats, both outputs and the
    port's glue calls."""
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    monkeypatch.setenv("BRUTEFIR_TPU_FFT_GLUE", "pallas")
    monkeypatch.setenv("BRUTEFIR_TPU_MAC", "pallas")
    JaxEngine(jax_parse_config(make_text("out_jax.raw"))).run_offline()
    calls = _spy(monkeypatch)
    stats = Engine(parse_config(make_text("out_torch.raw")),
                   device=CPU).run_offline()
    yj = np.fromfile(tmp_path / "out_jax.raw", "<i4").astype(np.int64)
    yt = np.fromfile(tmp_path / "out_torch.raw", "<i4").astype(np.int64)
    return stats, yj, yt, calls


def test_two_channel_engine_matches_jax(tmp_path, monkeypatch, rng):
    """tests/test_fft_glue_pallas.py's engine config (256 x 2, a dirac on
    two channels): one forward and one inverse glue a block."""
    vals = np.clip((rng.standard_normal((256 * 4, 2)) * 2 ** 20).round(),
                   -(2 ** 23), 2 ** 23 - 1).astype("<i4")
    vals.tofile(tmp_path / "in.raw")

    def text(name):
        return f"""
sampling_rate: 44100;
filter_length: 256,2;
coeff 0 {{ filename: "dirac pulse"; }};
input 0,1 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S32_LE"; channels: 2; }};
output 0,1 {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "S32_LE"; channels: 2; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_inputs: 1; to_outputs: 1; coeff: 0; }};
"""
    stats, yj, yt, calls = _engines(tmp_path, monkeypatch, text)
    assert yt.size == yj.size == vals.size
    assert np.abs(yt - yj).max() <= 1
    assert np.abs(yt.reshape(-1, 2) - vals).max() <= 1      # a dirac
    assert calls == {"glue_fwd": stats["blocks"],
                     "glue_inv": stats["blocks"]}


def _cascade_inputs(tmp_path, seed, N_, B_):
    rng = np.random.default_rng(seed)
    taps = [(rng.uniform(-1, 1, N_ * B_) * 0.03).astype(np.float32)
            for _ in range(6)]
    for i, h in enumerate(taps):
        h.astype("<f4").tofile(tmp_path / f"h{i}.raw")
    frames = N_ * 13 + 77                # a batch of 8, then the tail
    x = rng.integers(-(1 << 20), 1 << 20, (frames, 2)).astype("<i4")
    x.tofile(tmp_path / "in.raw")
    return taps, x, frames


def _check_oracle(y, ref):
    for c in range(2):
        assert np.abs(ref[:, c]).max() > 2 ** 16          # a real signal
        tol = 2e-5 * np.abs(ref[:, c]).max() + 4.0
        assert np.abs(y[:, c] - ref[:, c]).max() <= tol


def test_bench1_cascade_engine_matches_jax(tmp_path, monkeypatch):
    """bench1's cascade at 256 x 4: per block the input's forward glue,
    the cascade re-framing's inverse and forward (convolve_eval) and the
    output's inverse."""
    N_, B_ = 256, 4
    taps, x, frames = _cascade_inputs(tmp_path, 21, N_, B_)
    stats, yj, yt, calls = _engines(
        tmp_path, monkeypatch,
        lambda name: bench1_config(tmp_path, name, N_, B_))
    assert stats["blocks"] == 14
    assert calls == {"glue_fwd": 2 * 14, "glue_inv": 2 * 14}
    assert yt.size == yj.size == frames * 2
    assert np.abs(yt - yj).max() <= 1
    ref = cascade_oracle(x, taps, N_, lambda k: [2, 3, 4, 5])
    _check_oracle(yt.reshape(frames, 2), ref)


def test_crossfading_cascade_engine_matches_jax(tmp_path, monkeypatch):
    """bench1's cascade with its first stage crossfading under a CLI
    script: on each of the 5 swap blocks (0, 3, ..., 12) of 14,
    crossfade_spectra adds two full inverses and one forward."""
    N_, B_ = 256, 4
    taps, x, frames = _cascade_inputs(tmp_path, 23, N_, B_)
    stats, yj, yt, calls = _engines(
        tmp_path, monkeypatch,
        lambda name: bench1_xfade_config(tmp_path, name, N_, B_,
                                         CASCADE_SCRIPT))
    assert stats["blocks"] == 14
    assert calls == {"glue_fwd": 2 * 14 + 5, "glue_inv": 2 * 14 + 2 * 5}
    assert yt.size == yj.size == frames * 2
    assert np.abs(yt - yj).max() <= 1
    _check_oracle(yt.reshape(frames, 2),
                  cascade_oracle(x, taps, N_, cascade_sets))
