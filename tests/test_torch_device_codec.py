"""The port's device codec is bit-equal to brutefir_tpu.ops.device_codec:
quantizer, encode (words and meters), decode and scatter, for S8, S16,
S24_4, S32 and FLOAT, on the adversarial inputs of
tests/test_device_codec_exact.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from brutefir_tpu.core.sampleformat import parse_sample_format
from brutefir_tpu.ops import device_codec as jdc
from brutefir_tpu_torch.ops import device_codec as tdc

INT_FORMATS = ["S8", "S16_NE", "S24_4NE", "S32_NE"]


def _edges(fmt, rng):
    edges = []
    # power-of-two magnitudes with half-step offsets: the f32 rounding
    # trap lives at |y| >= 2^23 where +0.5 is inexact
    for k in range(0, 32):
        for base in (2.0 ** k, -(2.0 ** k)):
            for d in (-1.0, -0.5, -0.25, 0.0, 0.25, 0.5, 1.0):
                edges.append(np.float32(base + d))
    # the clip thresholds themselves, plus their f32 neighbours
    for b in (np.float64(np.float32(fmt.imin)),
              np.float64(np.float32(fmt.imax))):
        for off in (-1.0, -0.5, 0.0, 0.5, 1.0):
            v = np.float32(b + off)
            edges += [v, np.nextafter(v, np.float32(-np.inf)),
                      np.nextafter(v, np.float32(np.inf))]
    x = np.array(edges, np.float32)
    return np.concatenate([
        x,
        (rng.standard_normal(4096) * abs(float(fmt.imax))).astype(np.float32),
        (rng.standard_normal(4096) * 2.0 ** 20).astype(np.float32),
        np.round(rng.standard_normal(1024) * 2.0 ** 24).astype(np.float32),
    ])


@pytest.mark.parametrize("name", INT_FORMATS)
def test_quantizer_bit_equal_to_jax(name, rng):
    fmt = parse_sample_format(name)
    x = _edges(fmt, rng)
    qj, uj, oj = jax.jit(jdc.quantize_nd_exact, static_argnums=(1, 2))(
        x, fmt.imin, fmt.imax)
    qt, ut, ot = tdc.quantize_nd_exact(torch.as_tensor(x), fmt.imin,
                                       fmt.imax)
    assert qt.dtype == torch.int32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


@pytest.mark.parametrize("name", INT_FORMATS + ["FLOAT_NE"])
def test_encode_words_bit_equal_to_jax(name, rng):
    fmt = parse_sample_format(name)
    x = _edges(fmt, rng) if not fmt.is_float else \
        (rng.standard_normal(3000) * 0.7).astype(np.float32)
    P = 3
    n = x.size // P
    y = x[: P * n].reshape(P, n)
    sel = np.array([3, 0, 1], np.int32)           # used -> open columns
    open_ch = 5
    wdt = tdc.device_format_word(fmt)
    assert wdt == jdc.device_format_word(fmt)
    wj, mj = jdc.encode_words(jnp.asarray(y), fmt, sel, open_ch, wdt)
    wt, mt = tdc.encode_words(torch.as_tensor(y), fmt, sel, open_ch,
                              tdc.torch_dtype(wdt))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


@pytest.mark.parametrize("name", INT_FORMATS + ["FLOAT_NE"])
def test_decode_words_bit_equal_to_jax(name, rng):
    fmt = parse_sample_format(name)
    wdt = tdc.device_format_word(fmt)
    N, open_ch = 64, 4
    if fmt.is_float:
        words = rng.standard_normal((N, open_ch)).astype(wdt)
    else:
        info = np.iinfo(wdt)
        words = rng.integers(info.min, info.max, (N, open_ch),
                             endpoint=True).astype(wdt)
        words[0, :] = [info.min, info.max, 0, -1]
    sel = np.array([2, 0, 3], np.int32)
    vmap = np.array([0, 2, 1, 1], np.int32)         # mapping with fan-out
    ref = np.asarray(jdc.decode_words(jnp.asarray(words), sel, vmap,
                                      jnp.float32))
    got = tdc.decode_words(torch.as_tensor(words), sel, vmap, torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_scatter_words_bit_equal_to_jax(rng):
    cols = rng.integers(-2 ** 23, 2 ** 23, (3, 16)).astype(np.int32)
    sel = np.array([4, 1, 2], np.int32)
    ref = np.asarray(jdc.scatter_words(jnp.asarray(cols), sel, 6, np.int32))
    got = tdc.scatter_words(torch.as_tensor(cols), sel, 6, torch.int32)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_format_words_agree_with_jax():
    for name in ["S8", "S16_LE", "S16_BE", "S24_LE", "S24_4LE", "S32_LE",
                 "FLOAT_LE", "FLOAT64_LE"]:
        fmt = parse_sample_format(name)
        assert tdc.device_format_word(fmt) == jdc.device_format_word(fmt)
