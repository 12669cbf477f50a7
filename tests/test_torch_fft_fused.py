"""brutefir_tpu_torch.ops.fft_fused (the fused real FFT, digit-permuted
bins) against the JAX package's fused Pallas FFT (brutefir_tpu/ops/
pallas_fft.py, run in interpret mode off the TPU) and against the port's
own transforms (the glue route), on the same numpy inputs.

Tolerances: against the JAX fused kernels 2e-4 of the output's peak, the
bound of the JAX package's own tests (tests/test_pallas_fft.py): its
4-step transform sums dense DFTs in float32 and carries O(R) rounding.
Against the port's glue-route transforms, and the four-step plain
versions and their stages against numpy's float64 FFT, 1e-5 of the peak:
a radix-4 FFT rounds at a few ulp of the peak times log M."""

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
    """The Stockham stages (ops/fft_fused.stockham, which the CUDA
    kernel's column DFTs follow step for step) against numpy's float64
    FFT, both directions: radix 4, 2 and 11; 4, 2, 3 and 5; and 65536,
    eight radix-4 stages."""
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


FOUR_STEP_M = [256, 384, 1408, 8192, 65536]


def _numpy_planes(x, M):
    """Packed planes [..., 2, M] of numpy's float64 rfft of frames x
    (Nyquist in bin 0's imaginary slot), in the permuted order."""
    X = np.fft.rfft(x.astype(np.float64))
    nat = np.stack([X.real[..., :M], np.concatenate(
        [X.real[..., M:], X.imag[..., 1:M]], axis=-1)], axis=-2)
    return nat[..., tf.bin_order(M)]


def _numpy_frames(perm, M):
    """numpy's float64 irfft of permuted packed planes: the whole frame."""
    p = perm[..., tf.bin_order_inv(M)].astype(np.float64)
    zero = np.zeros(p.shape[:-2] + (1,))
    X = np.concatenate([p[..., 0, :], p[..., 1, :1]], axis=-1) + 1j * (
        np.concatenate([zero, p[..., 1, 1:], zero], axis=-1))
    return np.fft.irfft(X, n=2 * M)


@pytest.mark.parametrize("M", FOUR_STEP_M)
def test_four_step_forward_matches_numpy(rng, M):
    """The plain forward (column Stockham over R, the twiddle, the rows
    as the kernel's warps run them, the glue) against numpy's float64
    rfft: R = 2, 3 (clusters of 2), 11, 64 and 512."""
    x = rng.standard_normal((2, 2 * M)).astype(np.float32)
    _close(tf.rfft_planes_fused_reference(torch.as_tensor(x)).numpy(),
           _numpy_planes(x, M), REL)


@pytest.mark.parametrize("M", FOUR_STEP_M)
@pytest.mark.parametrize("half", [False, True])
def test_four_step_inverse_matches_numpy(rng, M, half):
    """The plain inverse, the whole frame and the valid half (at R = 3
    and 11 that ends in the middle of a column's row), against numpy's
    float64 irfft."""
    perm = rng.standard_normal((2, 2, M)).astype(np.float32)
    ref = _numpy_frames(perm, M)
    got = tf.irfft_planes_fused_reference(torch.as_tensor(perm),
                                          M // 2 if half else None)
    _close(got.numpy(), ref[..., :M] if half else ref, REL)


@pytest.mark.parametrize("sign", [-1, 1])
def test_row_dft_matches_numpy(rng, sign):
    """The warp's 128-point row transform (radix 4 in registers, five
    radix-2 stages across lanes) against numpy, in both directions, with
    the W_128 twiddles read at stride R of an M-point table."""
    M = 1024
    y = (rng.standard_normal((3, 128))
         + 1j * rng.standard_normal((3, 128))).astype(np.complex64)
    ref = (np.fft.fft(y.astype(np.complex128)) if sign < 0
           else np.fft.ifft(y.astype(np.complex128)) * 128)
    got = tf.row_dft(torch.as_tensor(y), sign, tf.twiddles(M, "cpu"))
    _close(got.numpy(), ref, REL)


@pytest.mark.parametrize("M,S", [(256, 2), (384, 2), (512, 4), (640, 4),
                                 (896, 4), (1024, 8), (1408, 8),
                                 (8192, 8), (8192, 4), (65536, 8)])
def test_cluster_rows_partition(M, S):
    """The kernel's row split: every row held by exactly one block of the
    cluster, each block's rows closed under the mirror k1 -> (R - k1) % R
    (rows 0 and R/2 mirror into themselves), and S dividing the 128
    columns. Where R/2 + 1 < S some blocks hold no row: they only run
    columns."""
    R = M // 128
    assert 128 % S == 0 and S <= R
    rows = tf.cluster_rows(M, S)
    assert len(rows) == S
    assert sorted(k for block in rows for k in block) == list(range(R))
    for block in rows:
        assert {(R - k) % R for k in block} == set(block)
    assert 0 in rows[0] and (R % 2 or R // 2 in rows[(R // 2) % S])


@pytest.mark.parametrize("M,C,S", [
    (256, 1, 2), (384, 256, 2), (640, 1, 4), (896, 256, 4), (1024, 1, 8),
    (8192, 26, 8), (8192, 99, 8), (8192, 100, 4), (8192, 256, 4),
    (65536, 256, 8), (131072, 256, 8)])
def test_cluster_size(M, C, S):
    """S from R (2 or 4 where R < 8), and 4 in place of 8 where C
    clusters of 8 outgrow the resident blocks of 132 SMs (C x 8 > 792)
    unless a block's share at 4 would outgrow shared memory (65536)."""
    assert tf.cluster_size(M, C, 132) == S


@pytest.mark.parametrize("M", [256, 8192, 65536, 112128, 112256, 131072])
def test_scratch_only_past_shared_memory(M):
    """A block's two column buffers (16 M / S bytes) and its tables W_R
    and W_128 (8 (R + 128) bytes) stay in shared memory up to 227 KB a
    block (M = 112128 at S = 8)."""
    R, S = M // 128, tf.cluster_size(M)
    assert tf.smem_bytes(M, S) == 16 * M // S + 8 * (R + 128)
    assert tf.needs_scratch(M, S) == (M > 112128)
