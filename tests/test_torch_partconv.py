"""brutefir_tpu_torch.ops.partconv and config.coeffs against the JAX
package on the same numpy inputs.

Float ops are held to atol 1e-5 at O(1) magnitudes (float32 FFTs and sums
in a different order); the numpy coefficient preprocessing is held to
exact equality, since both packages run the same numpy code."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from brutefir_tpu.config import parse_config
from brutefir_tpu_torch.config import parse_config as port_parse_config
from brutefir_tpu.config.coeffs import build_bank as jax_build_bank
from brutefir_tpu.ops import partconv as jpc
from brutefir_tpu_torch.config.coeffs import build_bank
from brutefir_tpu_torch.ops import partconv as tpc

ATOL = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("N", [128, 256, 384])
def test_rfft_planes_matches_jax(rng, N):
    x = (rng.standard_normal((3, 2 * N)) * 0.05).astype(np.float32)
    got = tpc.rfft_planes(_t(x)).numpy()
    ref = np.asarray(jpc.rfft_planes(jnp.asarray(x)))
    assert got.shape == (3, 2, N)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("N", [128, 256, 384])
def test_irfft_planes_valid_matches_jax(rng, N):
    p = rng.standard_normal((4, 2, N)).astype(np.float32)
    got = tpc.irfft_planes_valid(_t(p)).numpy()
    ref = np.asarray(jpc.irfft_planes_valid(jnp.asarray(p)))
    assert got.shape == (4, N)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_rfft_irfft_roundtrip_valid_half(rng):
    """irfft_planes_valid(rfft_planes(x)) returns the lower half of x."""
    x = rng.standard_normal((2, 512)).astype(np.float32)
    y = tpc.irfft_planes_valid(tpc.rfft_planes(_t(x))).numpy()
    np.testing.assert_allclose(y, x[:, :256], rtol=0, atol=ATOL)


@pytest.mark.parametrize("N", [128, 256])
def test_convolve_eval_matches_jax(rng, N):
    """Cascade re-framing: the re-transformed spectra and the new tails."""
    z = rng.standard_normal((3, 2, N)).astype(np.float32)
    prev = rng.standard_normal((3, N)).astype(np.float32)
    e, tails = tpc.convolve_eval(_t(z), _t(prev))
    e_ref, tails_ref = jpc.convolve_eval(jnp.asarray(z), jnp.asarray(prev), N)
    assert e.shape == (3, 2, N) and tails.shape == (3, N)
    np.testing.assert_allclose(tails.numpy(), np.asarray(tails_ref), rtol=0,
                               atol=ATOL)
    # |E| grows with the 2N-point transform: held relative to its peak
    e_ref = np.asarray(e_ref)
    np.testing.assert_allclose(e.numpy(), e_ref, rtol=0,
                               atol=ATOL * np.abs(e_ref).max())


def test_complex_mix_matches_jax(rng):
    w = rng.standard_normal((5, 4)).astype(np.float32)
    x = rng.standard_normal((4, 2, 256)).astype(np.float32)
    got = tpc.complex_mix(_t(w), _t(x)).numpy()
    ref = np.asarray(jpc.complex_mix(jnp.asarray(w), jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("t", [0, 3, 7, 12])
def test_spectral_mac_rollh_matches_jax(rng, t):
    F, B, N, E = 3, 4, 256, 2
    ring = rng.standard_normal((F, B, 2, N)).astype(np.float32)
    bank = rng.standard_normal((E, B, 2, N)).astype(np.float32)
    idx = np.array([0, 1, 0], np.int32)
    mask = (rng.uniform(size=(F, B)) > 0.3).astype(np.float32)
    got = tpc.spectral_mac_rollh(_t(ring), _t(bank), _t(idx), _t(mask),
                                 torch.tensor(t, dtype=torch.int32)).numpy()
    ref = np.asarray(jpc.spectral_mac_rollh(
        jnp.asarray(ring), jnp.asarray(bank), jnp.asarray(idx),
        jnp.asarray(mask), jnp.int32(t)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("t", [0, 4, 9])
def test_spectral_mac_uniform_matches_jax(rng, t):
    F, B, N, E = 4, 6, 256, 3
    ring = rng.standard_normal((F, B, 2, N)).astype(np.float32)
    bank = rng.standard_normal((E, B, 2, N)).astype(np.float32)
    idx = np.full(F, 2, np.int32)
    mask = np.tile((rng.uniform(size=B) > 0.3).astype(np.float32), (F, 1))
    got = tpc.spectral_mac_uniform(_t(ring), _t(bank), _t(idx), _t(mask),
                                   torch.tensor(t, dtype=torch.int32)).numpy()
    ref = np.asarray(jpc.spectral_mac_uniform(
        jnp.asarray(ring), jnp.asarray(bank), jnp.asarray(idx),
        jnp.asarray(mask), jnp.int32(t)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_mac_bin0_rule_is_two_real_products(rng):
    """Bin 0 carries DC and Nyquist: independent real products, no cross
    terms (a kernel that treats it as a complex lane is off here)."""
    F, B, N = 1, 2, 128
    ring = rng.standard_normal((F, B, 2, N)).astype(np.float32)
    bank = rng.standard_normal((1, B, 2, N)).astype(np.float32)
    y = tpc.spectral_mac_rollh(_t(ring), _t(bank), torch.zeros(1, dtype=torch.int32),
                               torch.ones(F, B), torch.tensor(0, dtype=torch.int32))
    hpos = [(0 - j) % B for j in range(B)]    # coefficient slot of ring slot j at t = 0
    dc = sum(ring[0, j, 0, 0] * bank[0, hpos[j], 0, 0] for j in range(B))
    ny = sum(ring[0, j, 1, 0] * bank[0, hpos[j], 1, 0] for j in range(B))
    np.testing.assert_allclose(y[0, :, 0].numpy(), [dc, ny], rtol=1e-6)


@pytest.mark.parametrize("N,B,n_taps,scale",
                         [(128, 4, 500, 1.0), (256, 2, 300, 0.5),
                          (64, 3, 64 * 3 + 50, 0.25)])
def test_preprocess_coeffs_equals_jax(rng, N, B, n_taps, scale):
    taps = rng.standard_normal(n_taps).astype(np.float32)
    got = tpc.preprocess_coeffs(taps, N, B, scale)
    ref = jpc.preprocess_coeffs(taps, N, B, scale)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tpc.dirac_bank_entry(N, B),
                                  jpc.dirac_bank_entry(N, B))
    bank = tpc.make_bank([got])
    np.testing.assert_array_equal(bank, jpc.make_bank([ref]))
    np.testing.assert_array_equal(tpc.np_p2c(bank)[0], got)


def test_build_bank_equals_jax(tmp_path, rng):
    """TEXT, RAW and dirac coefficients (with attenuation, skip and
    partition truncation) give the same packed bank in both packages."""
    N, B = 128, 4
    taps = rng.standard_normal(N * B + 77).astype(np.float32)
    txt = tmp_path / "a.txt"
    txt.write_text("\n".join(repr(float(v)) for v in taps[:300]) + "\n")
    raw = tmp_path / "b.raw"
    (taps * 2 ** 20).astype("<i4").tofile(raw)
    text = f"""
sampling_rate: 44100;
filter_length: {N},{B};
coeff 0 {{ filename: "{txt}"; format: "TEXT"; attenuation: 3.0; }};
coeff 1 {{ filename: "{raw}"; format: "S32_LE"; skip: 8; blocks: 3; }};
coeff 2 {{ filename: "dirac pulse"; format: "TEXT"; attenuation: 6.0; }};
input 0 {{ device: "file" {{ path: "/dev/null"; }}; sample: "S32_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "/dev/null"; }}; sample: "S32_LE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
"""
    conf = parse_config(text)
    got = build_bank(port_parse_config(text).coeffs, N, B)
    ref = jax_build_bank(conf.coeffs, N, B)
    assert got.shape == (4, B, N)
    np.testing.assert_array_equal(got, ref)
