"""The plain reference against an independent direct convolution at a
tiny size, its control in TF32, and its rounding."""

import numpy as np
import torch

from portbench import inputs
from portbench.reference import fir

from conftest import tiny_config


def _files(tmp_path, seed=3, **over):
    cfg = tiny_config(**over)
    trf = {"input_seconds": 0.05, "input_std_lsb": 1 << 20}
    return cfg, inputs.write_all(str(tmp_path), cfg, trf, seed)


def _direct(files, pos, n):
    """Output words of frames [pos, pos + n) by np.convolve over the
    looped input, in float64."""
    x = fir.read_words(files.input_path, files.channels).astype(np.float64)
    h = np.fromfile(files.taps_path, "<f4").reshape(
        files.coeff_sets, files.taps).astype(np.float64)
    idx = np.arange(0, pos + n)
    stream = x[idx % files.frames]
    out = np.empty((n, files.channels))
    for c in range(files.channels):
        y = np.convolve(stream[:, c], h[c % files.coeff_sets])
        out[:, c] = y[pos:pos + n]
    return out


def test_reference_matches_direct_convolution(tmp_path):
    cfg, files = _files(tmp_path)
    ref = fir.Reference(files)
    for pos, n in ((0, 256), (300, 512), (5 * files.frames + 17, 1024)):
        want = _direct(files, pos, n)
        got = ref.values(pos, n).numpy()
        assert np.abs(got - want).max() < 1e-6 * np.abs(want).max()
        words = ref.words(pos, n).numpy()
        assert np.array_equal(words, np.clip(np.floor(want + 0.5),
                                             -(1 << 23), (1 << 23) - 1))


def test_shared_coefficient_set(tmp_path):
    cfg, files = _files(tmp_path, coeff_sets=1)
    ref = fir.Reference(files)
    assert np.abs(ref.values(1000, 256).numpy()
                  - _direct(files, 1000, 256)).max() < 1e-3


def test_tf32_control_is_far_from_the_reference(tmp_path):
    """The control fails the limit at this size too; float32 alone
    does not."""
    cfg, files = _files(tmp_path)
    ref = fir.Reference(files)
    gap = int((ref.words(2048, 2048, "tf32") - ref.words(2048, 2048)
               ).abs().max())
    assert gap > 3 * cfg["check"]["max_gap_lsb"]


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -10, -3.0000001], dtype=torch.float32)
    got = fir.round_tf32(x)
    assert got.tolist() == [1.0, 1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10,
                            -3.0]
    z = torch.complex(x, -x)
    assert torch.equal(torch.view_as_real(fir.round_tf32(z))[:, 0], got)


def test_sign_extension_and_decode():
    w = np.array([0x007FFFFF, 0x00800000, 0xFFFFFFFF, 0x12000001],
                 dtype=np.uint32).view(np.int32)
    assert fir.sign_extend24(w).tolist() == [(1 << 23) - 1, -(1 << 23), -1,
                                             1]
    data = w.astype("<i4").tobytes()
    assert fir.decode_written(data, 2).shape == (2, 2)


def test_inputs_same_sizes_for_every_seed(tmp_path):
    a = tmp_path / "a"
    b = tmp_path / "b"
    a.mkdir()
    b.mkdir()
    cfg, fa = _files(a, seed=1)
    _, fb = _files(b, seed=2 ** 40 + 7)
    import os
    assert os.path.getsize(fa.taps_path) == os.path.getsize(fb.taps_path)
    assert os.path.getsize(fa.input_path) == os.path.getsize(fb.input_path)
    h = np.fromfile(fa.taps_path, "<f4").reshape(3, -1)
    assert np.allclose(np.linalg.norm(h.astype(np.float64), axis=1), 0.5,
                       rtol=1e-5)
    with open(fa.conf_path) as fh:
        text = fh.read()
    assert "loop: true" in text and text.count("filter ") == 3
