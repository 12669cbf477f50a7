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

import numpy as np
import pytest
import torch

from brutefir_tpu.config import parse_config
from brutefir_tpu_torch.ops import mac_mix as mm


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
@pytest.mark.parametrize("K,C", [(512, 7), (384, 40), (8192, 26)])
def test_kernel_matches_plain_version(cuda, uniform, K, C):
    """C = 40 takes the kernel's global-memory accumulator path; K = 384
    is not a multiple of the block size."""
    F, B, E = 5, 6, 3
    ring, bank, idx, mask, w = _mac_inputs(K + C, F, B, K, E, C, uniform,
                                           cuda)
    form = "uniform" if uniform else "rows"
    for tv in (0, 4, 6, 17):
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
def test_wrapper_rejects_mixed_devices(cuda):
    ring, bank, idx, mask, w = _mac_inputs(1, 2, 2, 128, 1, 2, False, cuda)
    t = torch.tensor(0, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        mm.mac_mix(ring, bank, idx, mask, t, w.cpu(), False)


@pytest.mark.cuda
@pytest.mark.parametrize("coeff_of", [[0, 0, 0], [0, 1, 0]])
def test_engine_on_card_matches_cpu(cuda, tmp_path, coeff_of):
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
            f"coeff: {c}; }};\n" for f, c in enumerate(coeff_of))
        return parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
{coeffs}
input 0,1,2 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: {C}; }};
output 0,1,2 {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "S24_4LE"; channels: {C}; dither: false; }};
{filters}""")

    form = "uniform" if len(set(coeff_of)) == 1 else "rows"
    before = mm.launches[form]
    sg = Engine(conf("gpu.raw"), device=cuda).run_offline()
    assert mm.launches[form] - before == 12
    sc = Engine(conf("cpu.raw"),
                device=torch.device("cpu")).run_offline()
    assert sg["frames"] == sc["frames"] == frames
    yg = np.fromfile(tmp_path / "gpu.raw", "<i4").astype(np.int64)
    yc = np.fromfile(tmp_path / "cpu.raw", "<i4").astype(np.int64)
    assert yg.size == frames * C
    assert np.abs(yg - yc).max() <= 2
    yg = yg.reshape(frames, C)
    for c in range(C):
        ref = np.convolve(x[:, c].astype(np.float64),
                          taps[coeff_of[c]].astype(np.float64))[:frames]
        assert np.abs(yg[:, c] - np.round(ref)).max() <= 2
