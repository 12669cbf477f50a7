"""The port's dither against the JAX package's, on the CPU.

- ``core/dither.py``: the vectorised ``tausrand_table`` makes the JAX
  package's bytes (byte-equal on a 200 k prefix, at lengths whose lanes
  end mid-table, and on the full table of a small config), and
  ``build_randmap``, ``DitherTable`` and the host ``DitherState`` are
  equal to the JAX package's.
- ``ops/device_dither.py``: ``dither_window`` (pointer wrap included) and
  ``dither_quantize`` (words, error feedback and meters, at small, 2^22
  and clipping levels of S16 and S24, N = 1, 2 and whole blocks) are
  bit-equal to the JAX functions on the same inputs. No rounding
  difference was found, so the tolerance is 0.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from brutefir_tpu.core import dither as jdither
from brutefir_tpu.core.codecs import Overflow as JaxOverflow
from brutefir_tpu.core.sampleformat import parse_sample_format as jax_fmt
from brutefir_tpu.ops import device_dither as jdd
from brutefir_tpu_torch.core import dither as tdither
from brutefir_tpu_torch.core.codecs import Overflow
from brutefir_tpu_torch.core.sampleformat import parse_sample_format
from brutefir_tpu_torch.ops import device_dither as tdd

S16 = (-(1 << 15), (1 << 15) - 1)
S24 = (-(1 << 23), (1 << 23) - 1)


# --- the random table ------------------------------------------------------

def test_tausrand_table_prefix_matches_jax():
    n = 200_000
    a, b = tdither.tausrand_table(n), jdither.tausrand_table(n)
    assert a.dtype == b.dtype == np.int8
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 6, 17, 4096, 65537, 150_001])
def test_tausrand_table_lane_boundaries(n):
    """Every length's lanes (``lane_length``) end inside the table or at
    its end; the bytes on both sides of each boundary and the whole table
    equal the JAX package's sequential loop."""
    L = tdither.lane_length(n)
    a, b = tdither.tausrand_table(n), jdither.tausrand_table(n)
    assert a.shape == b.shape == (n,)
    for j in range(L, n, L):
        np.testing.assert_array_equal(a[j - 3:j + 3], b[j - 3:j + 3])
    np.testing.assert_array_equal(a, b)
    if n > 100:
        assert L < n                      # several lanes


def test_tausrand_table_seed():
    np.testing.assert_array_equal(tdither.tausrand_table(5000, seed=7),
                                  jdither.tausrand_table(5000, seed=7))


@pytest.mark.parametrize("n_ch,rate,max_size,block", [
    (2, 8000, 0, 256),
    (3, 8000, 100_000, 256),          # max_dither_table_size binds
    (1, 2000, 0, 4096),               # the block binds the spacing
])
def test_dither_table_matches_jax(n_ch, rate, max_size, block):
    t = tdither.DitherTable(n_ch, rate, max_size, block)
    j = jdither.DitherTable(n_ch, rate, max_size, block)
    assert (t.size, t.spacing) == (j.size, j.spacing)
    np.testing.assert_array_equal(t.tab, j.tab)
    np.testing.assert_array_equal(t.randmap, j.randmap)
    for c in range(n_ch):
        assert t.new_state(c).randtab_ptr == j.new_state(c).randtab_ptr


def test_dither_table_too_small_raises_like_jax():
    with pytest.raises(ValueError, match="too small"):
        jdither.DitherTable(4, 8000, 1000, 256)
    with pytest.raises(ValueError, match="too small"):
        tdither.DitherTable(4, 8000, 1000, 256)


def test_build_randmap_matches_jax():
    np.testing.assert_array_equal(tdither.build_randmap(),
                                  jdither.build_randmap())


@pytest.mark.parametrize("fmt,amp", [("S16_LE", 12.0), ("S16_LE", 3000.0),
                                     ("S24_LE", 2.0 ** 20),
                                     ("S16_LE", 50000.0)])
def test_host_dither_state_matches_jax(fmt, amp):
    """The host reference (``DitherState.quantize``, the sequential
    recurrence) against the JAX package's numpy path, over blocks that
    wrap the table: words, feedback state and overflow meters equal."""
    rng = np.random.default_rng(int(amp))
    t = tdither.DitherTable(1, 2000, 0, 700)
    j = jdither.DitherTable(1, 2000, 0, 700)
    ts, js = t.new_state(0), j.new_state(0)
    to, jo = Overflow(max=32767.0), JaxOverflow(max=32767.0)
    tf, jf = parse_sample_format(fmt), jax_fmt(fmt)
    for _ in range(4):                        # 2800 samples: one wrap
        x = (rng.standard_normal(700) * amp).astype(np.float32)
        d = js._next_window(700)
        np.testing.assert_array_equal(ts._next_window(700), d)
        np.testing.assert_array_equal(ts._quantize_py(x, d, tf, to),
                                      js._quantize_py(x, d, jf, jo))
        np.testing.assert_array_equal(ts.sf, js.sf)
    assert ts.randtab_ptr == js.randtab_ptr
    assert (to.n_overflows, to.largest, to.intlargest) == (
        jo.n_overflows, jo.largest, jo.intlargest)


# --- the device dither -------------------------------------------------------

def _window_state(table, n_ch):
    ptr = np.asarray([j * table.spacing + 1 for j in range(n_ch)], np.int32)
    last = table.tab[ptr - 1].astype(np.int32)
    return ptr, last


@pytest.mark.parametrize("n", [1, 64, 1000])
def test_dither_window_matches_jax_across_wrap(n):
    """Block after block across the table's end (dither.h:28-38: the
    window starts again at 1 and its first difference continues from the
    last consumed byte): floats, pointers and last bytes bit-equal."""
    table = tdither.DitherTable(3, 2000, 0, max(n, 64))
    tab_t, rm_t = torch.as_tensor(table.tab), torch.as_tensor(table.randmap)
    tab_j, rm_j = jnp.asarray(table.tab), jnp.asarray(table.randmap)
    ptr, last = _window_state(table, 3)
    ptr[1] = table.size - 2 * n - 1                # wraps on block 2
    last[1] = table.tab[ptr[1] - 1]
    pt, lt = torch.as_tensor(ptr), torch.as_tensor(last)
    pj, lj = jnp.asarray(ptr), jnp.asarray(last)
    wrapped = False
    for _ in range(5):
        dt, pt, lt = tdd.dither_window(tab_t, rm_t, pt, lt, n, table.size)
        dj, pj, lj = jdd.dither_window(tab_j, rm_j, pj, lj, n, table.size)
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
        assert pt.dtype == lt.dtype == torch.int32
        wrapped |= int(pt[1]) < 3 * n
    assert wrapped


@pytest.mark.parametrize("imin,imax", [S16, S24], ids=["S16", "S24"])
@pytest.mark.parametrize("N", [1, 2, 517, 8192])
@pytest.mark.parametrize("level", ["small", "2^22", "clipping"])
def test_dither_quantize_matches_jax(imin, imax, N, level):
    """The same x, d and feedback state through both packages: int32
    words, the new feedback state and the [count, clip peak, int peak]
    meters bit-equal (tolerance 0)."""
    rng = np.random.default_rng(N)
    C = 3
    amp = {"small": 12.0, "2^22": 2.0 ** 22, "clipping": 1.5 * imax}[level]
    x = (rng.standard_normal((C, N)) * amp).astype(np.float32)
    if level == "clipping":
        x[0, : N // 2 + 1] = imax + 0.25          # just over the top
        x[1, : N // 2 + 1] = imin - 0.25
    table = tdither.DitherTable(C, 2000, 0, max(N, 64))
    ptr, last = _window_state(table, C)
    d, _, _ = tdd.dither_window(torch.as_tensor(table.tab),
                                torch.as_tensor(table.randmap),
                                torch.as_tensor(ptr), torch.as_tensor(last),
                                N, table.size)
    d = d.numpy()
    sf = rng.uniform(-1, 1, (C, 2)).astype(np.float32)
    got = tdd.dither_quantize(torch.as_tensor(x), torch.as_tensor(d),
                              torch.as_tensor(sf), imin, imax)
    ref = jdd.dither_quantize(jnp.asarray(x), jnp.asarray(d),
                              jnp.asarray(sf), imin, imax)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype
        np.testing.assert_array_equal(g.numpy(), r)
    if level == "clipping":
        assert got[2][:, 0].sum() > 0


def test_dither_quantize_matches_host_recurrence_at_small_levels():
    """At small amplitudes the parallel form equals the sequential host
    reference (``DitherState._quantize_py``) word for word."""
    rng = np.random.default_rng(5)
    fmt = parse_sample_format("S16_LE")
    table = tdither.DitherTable(2, 2000, 0, 512)
    states = [table.new_state(c) for c in range(2)]
    x = (rng.standard_normal((2, 512)) * 12.0).astype(np.float32)
    d = np.stack([s._next_window(512) for s in states])
    ovf = Overflow(max=32767.0)
    host = np.stack([states[c]._quantize_py(x[c], d[c], fmt, ovf)
                     for c in range(2)])
    s, sf, _ = tdd.dither_quantize(torch.as_tensor(x), torch.as_tensor(d),
                                   torch.zeros(2, 2), fmt.imin, fmt.imax)
    np.testing.assert_array_equal(s.numpy(), host)
    np.testing.assert_allclose(sf[:, 0].numpy(),
                               [st.sf[0] for st in states], atol=1e-5)


def test_dither_quantize_feedback_carries_across_blocks():
    """Two blocks with the feedback state carried equal one block of
    twice the length."""
    rng = np.random.default_rng(7)
    n = 384
    x = torch.as_tensor((rng.standard_normal((1, 2 * n)) * 3000)
                        .astype(np.float32))
    d = torch.as_tensor(rng.uniform(-0.5, 1.5, (1, 2 * n))
                        .astype(np.float32))
    whole, _, _ = tdd.dither_quantize(x, d, torch.zeros(1, 2), *S16)
    a, sf, _ = tdd.dither_quantize(x[:, :n], d[:, :n], torch.zeros(1, 2),
                                   *S16)
    b, _, _ = tdd.dither_quantize(x[:, n:], d[:, n:], sf, *S16)
    assert torch.equal(torch.cat([a, b], dim=1), whole)


def test_dither_quantize_mod_one_wrap():
    """A tiny negative fractional part floor-mods to 1.0, whose fixed-point
    value 2^24 << 8 = 2^32 is 0 modulo 2^32 (the JAX package's int32
    shift): both packages agree on such an input."""
    tiny = torch.tensor([-1e-9], dtype=torch.float32)
    assert torch.remainder(tiny, 1.0).item() == 1.0
    x = np.zeros((2, 12), np.float32)
    d = np.zeros((2, 12), np.float32)
    sf = np.array([[-1e-9, 0.0], [0.0, 1e-9]], np.float32)   # v[0] = -1e-9
    got = tdd.dither_quantize(torch.as_tensor(x), torch.as_tensor(d),
                              torch.as_tensor(sf), *S16)
    ref = jdd.dither_quantize(jnp.asarray(x), jnp.asarray(d),
                              jnp.asarray(sf), *S16)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
