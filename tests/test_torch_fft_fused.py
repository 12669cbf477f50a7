"""brutefir_tpu_torch.ops.fft_fused (the fused real FFT, digit-permuted
bins) against the JAX package's fused Pallas FFT (brutefir_tpu/ops/
pallas_fft.py, run in interpret mode off the TPU) and against the port's
own transforms (the glue route), on the same numpy inputs.

Tolerances: against the JAX fused kernels 2e-4 of the output's peak, the
bound of the JAX package's own tests (tests/test_pallas_fft.py): its
4-step transform sums dense DFTs in float32 and carries O(R) rounding.
Against the port's glue-route transforms, and the Stockham stages
against numpy's float64 FFT, 1e-5 of the peak: a radix-4 FFT rounds at a
few ulp of the peak times log M."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from brutefir_tpu.ops import pallas_fft as jpf
from brutefir_tpu_torch.ops import fft_fused as tf
from brutefir_tpu_torch.ops import partconv as tpc

SHAPES = [(3, 256), (2, 1024), (1, 8192)]
JAX_REL = 2e-4
REL = 1e-5


def _close(got, ref, rel):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("M", [256, 384, 1024, 8192])
def test_bin_order_matches_jax(M):
    np.testing.assert_array_equal(tf.bin_order(M), jpf.bin_order(M))
    np.testing.assert_array_equal(tf.bin_order_inv(M), jpf.bin_order_inv(M))
    assert tf.bin_order(M)[tf.bin_order_inv(M)].tolist() == list(range(M))


@pytest.mark.parametrize("C,M", SHAPES)
def test_rfft_fused_matches_jax(rng, C, M):
    x = rng.standard_normal((C, 2 * M)).astype(np.float32)
    got = tf.rfft_planes_fused(torch.as_tensor(x))
    _close(got.numpy(), jpf.rfft_planes_fused(jnp.asarray(x)), JAX_REL)
    nat = tpc.rfft_planes(torch.as_tensor(x))[..., tf.bin_order(M)]
    _close(got.numpy(), nat.numpy(), REL)


@pytest.mark.parametrize("C,M", SHAPES)
def test_irfft_fused_matches_jax(rng, C, M):
    p = rng.standard_normal((C, 2, M)).astype(np.float32)
    perm = np.ascontiguousarray(p[..., tf.bin_order(M)])
    got = tf.irfft_planes_fused(torch.as_tensor(perm))
    _close(got.numpy(), jpf.irfft_planes_fused(jnp.asarray(perm)), JAX_REL)
    _close(got.numpy(), tpc.irfft_planes(torch.as_tensor(p)).numpy(), REL)


@pytest.mark.parametrize("C,M", SHAPES)
def test_irfft_valid_fused_matches_jax(rng, C, M):
    p = rng.standard_normal((C, 2, M)).astype(np.float32)
    perm = np.ascontiguousarray(p[..., tf.bin_order(M)])
    got = tf.irfft_planes_valid_fused(torch.as_tensor(perm))
    _close(got.numpy(), jpf.irfft_planes_valid_fused(jnp.asarray(perm)),
           JAX_REL)
    _close(got.numpy(), tpc.irfft_planes_valid(torch.as_tensor(p)).numpy(),
           REL)


@pytest.mark.parametrize("M", [384, 640])
def test_odd_row_count(rng, M):
    """M/128 odd (radix 3, 5 in the Stockham stages), where the JAX
    package's valid inverse runs its full inverse and slices; the port
    writes the valid half directly."""
    x = rng.standard_normal((2, 2 * M)).astype(np.float32)
    p = rng.standard_normal((2, 2, M)).astype(np.float32)
    perm = np.ascontiguousarray(p[..., tf.bin_order(M)])
    _close(tf.rfft_planes_fused(torch.as_tensor(x)).numpy(),
           jpf.rfft_planes_fused(jnp.asarray(x)), JAX_REL)
    got = tf.irfft_planes_valid_fused(torch.as_tensor(perm))
    _close(got.numpy(), jpf.irfft_planes_valid_fused(jnp.asarray(perm)),
           JAX_REL)
    _close(got.numpy(), tpc.irfft_planes_valid(torch.as_tensor(p)).numpy(),
           REL)


def test_roundtrip_recovers_frame(rng):
    x = rng.standard_normal((2, 2048)).astype(np.float32)
    spec = tf.rfft_planes_fused(torch.as_tensor(x))
    np.testing.assert_allclose(tf.irfft_planes_fused(spec).numpy(), x,
                               rtol=0, atol=1e-5 * np.abs(x).max())


@pytest.mark.parametrize("M", [1408, 1920, 65536])
def test_stockham_matches_numpy(rng, M):
    """The kernel's stages (ops/fft_fused.stockham, which the CUDA kernel
    follows step for step) against numpy's float64 FFT, both directions:
    radix 4, 2 and 11; 4, 2, 3 and 5; and 65536, eight radix-4 stages at
    a size where the kernel runs in a device-memory scratch buffer."""
    z = (rng.standard_normal((2, M))
         + 1j * rng.standard_normal((2, M))).astype(np.complex64)
    assert tf.radices(M)[-1] == {1408: 11, 1920: 5, 65536: 4}[M]
    for sign, ref in ((-1, np.fft.fft(z.astype(np.complex128))),
                      (1, np.fft.ifft(z.astype(np.complex128)) * M)):
        got = tf.stockham(torch.as_tensor(z), sign).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=REL * np.abs(ref).max())


def test_wrappers_refuse_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="M % 128"):
        tf.rfft_planes_fused(torch.zeros(2, 2 * 192))
    with pytest.raises(ValueError, match="M % 128"):
        tf.irfft_planes_fused(torch.zeros(2, 2, 256, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        tf.irfft_planes_valid_fused(torch.zeros(2, 3, 2, 256)[:, 1])
