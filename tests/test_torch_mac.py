"""The unfused partitioned MAC of the stage loop: the port's plain version
against the JAX package's Pallas kernels (interpret mode) -- the "row",
"chunked" and "tile" variants of ``pallas_spectral_mac`` and
``pallas_spectral_mac_uniform`` -- and the wrapper's dispatch and checks.
The CUDA kernel itself is held against the plain version on a card by
tests/test_torch_cuda.py and chip_smoke.py.

The JAX side gets the stage's rows gathered (``ring[rows]``, as its stage
loop does); the port reads them in place through ``rows``.

Tolerance atol 1e-5, as tests/test_pallas_mac.py holds the variants: O(1)
random spectra summed over B partitions in float32, in another order.

The edge shapes of the kernel's paths (``EDGES``: K % 4 != 0, a ring
that is a contiguous view not 16-byte aligned, one stage filter, one
and 24 partitions, K under one block's 256 bins, more stage filters
than ring rows) go through the same comparison; where K is no multiple
of 128, which the Pallas kernels refuse, the JAX side is its dense MAC
(``brutefir_tpu.ops.partconv.spectral_mac_rollh`` / ``_uniform``)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from brutefir_tpu.ops import partconv as jpc
from brutefir_tpu.ops.pallas_mac import (pallas_spectral_mac,
                                         pallas_spectral_mac_uniform)
from brutefir_tpu_torch.ops import mac as tm

ATOL = 1e-5
F, B, K, E = 6, 4, 2048, 3        # K = 16 x 128: "chunked" takes Rc = 16
ROWS = {"stage": [2, 3, 4, 5], "repeated": [4, 1, 1], "all": list(range(F))}


def _inputs(rng, uniform):
    ring = rng.standard_normal((F, B, 2, K)).astype(np.float32)
    bank = rng.standard_normal((E, B, 2, K)).astype(np.float32)
    if uniform:
        idx = np.full(F, E - 1, np.int32)
        mask = np.tile((rng.uniform(size=B) > 0.3).astype(np.float32),
                       (F, 1))
    else:
        idx = (np.arange(F) % E).astype(np.int32)
        mask = (rng.uniform(size=(F, B)) > 0.3).astype(np.float32)
    mask[:, -1] = 0.0          # cblocks-style zeros
    return ring, bank, idx, mask


def _at_offset(a, offset):
    """``a`` as a contiguous tensor ``offset`` floats into a larger
    buffer (offset 1: its runs are not 16-byte aligned)."""
    buf = torch.zeros(a.size + offset, dtype=torch.float32)
    view = buf[offset:].view(a.shape)
    view.copy_(torch.as_tensor(a))
    assert view.is_contiguous()
    return view


# (F, B, K, E, stage rows, ring offset in floats)
EDGES = {
    "k_not_multiple_of_4": (5, 6, 1001, 3, [4, 1, 1], 0),
    "unaligned_ring_view": (4, 4, 256, 2, [3, 0, 2], 1),
    "one_stage_filter": (4, 4, 256, 2, [2], 0),
    "one_partition": (3, 1, 256, 2, [0, 2], 0),
    "24_partitions": (3, 24, 128, 2, [2, 0, 1], 0),
    "k_under_one_tile": (3, 4, 128, 2, [1, 2], 0),
    "many_stage_filters": (12, 2, 256, 2, list(range(12)) + [3, 3], 0),
}


def _edge_inputs(rng, F_, B_, K_, E_, uniform):
    ring = rng.standard_normal((F_, B_, 2, K_)).astype(np.float32)
    bank = rng.standard_normal((E_, B_, 2, K_)).astype(np.float32)
    if uniform:
        idx = np.full(F_, E_ - 1, np.int32)
        mask = np.tile((rng.uniform(size=B_) > 0.3).astype(np.float32),
                       (F_, 1))
    else:
        idx = (np.arange(F_) % E_).astype(np.int32)
        mask = (rng.uniform(size=(F_, B_)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0           # no all-zero mask row at small B
    return ring, bank, idx, mask


def _jax_mac(ring, bank, idx, mask, t, uniform):
    """The JAX package's MAC of gathered rows: its Pallas kernel in
    interpret mode where K is a multiple of 128, else its dense MAC."""
    args = (jnp.asarray(ring), jnp.asarray(bank), jnp.asarray(idx),
            jnp.asarray(mask), jnp.int32(t))
    if ring.shape[-1] % 128 == 0:
        fn = pallas_spectral_mac_uniform if uniform else pallas_spectral_mac
        return np.asarray(fn(*args, interpret=True))
    fn = jpc.spectral_mac_uniform if uniform else jpc.spectral_mac_rollh
    return np.asarray(fn(*args))


@pytest.mark.parametrize("edge", sorted(EDGES))
@pytest.mark.parametrize("uniform", [True, False])
def test_mac_edge_shapes_match_jax(rng, uniform, edge):
    F_, B_, K_, E_, rows, offset = EDGES[edge]
    ring, bank, idx, mask = _edge_inputs(rng, F_, B_, K_, E_, uniform)
    r = np.asarray(rows)
    ring_t = _at_offset(ring, offset)
    for t in (0, B_ - 1, 2 * B_ + 5):     # the last slot; past two wraps
        ref = _jax_mac(ring[r], bank, idx[r], mask[r], t, uniform)
        got = tm.mac(ring_t, torch.as_tensor(bank),
                     torch.as_tensor(r.astype(np.int32)),
                     torch.as_tensor(idx), torch.as_tensor(mask),
                     torch.tensor(t, dtype=torch.int32), uniform).numpy()
        assert got.shape == (r.size, 2, K_)
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def _port(ring, bank, rows, idx, mask, t, uniform):
    return tm.mac(torch.as_tensor(ring), torch.as_tensor(bank),
                  torch.as_tensor(np.asarray(rows, np.int32)),
                  torch.as_tensor(idx), torch.as_tensor(mask),
                  torch.tensor(t, dtype=torch.int32), uniform).numpy()


@pytest.mark.parametrize("rows", sorted(ROWS))
@pytest.mark.parametrize("variant", ["row", "chunked", "tile"])
def test_mac_matches_pallas_variants(rng, monkeypatch, variant, rows):
    monkeypatch.setenv("BRUTEFIR_TPU_PALLAS_VARIANT", variant)
    ring, bank, idx, mask = _inputs(rng, False)
    r = np.asarray(ROWS[rows])
    for t in (0, 3, 4, 9):                   # 4 and 9 wrap the ring
        ref = np.asarray(pallas_spectral_mac(
            jnp.asarray(ring[r]), jnp.asarray(bank), jnp.asarray(idx[r]),
            jnp.asarray(mask[r]), jnp.int32(t), interpret=True))
        got = _port(ring, bank, r, idx, mask, t, False)
        assert got.shape == (r.size, 2, K)
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("rows", sorted(ROWS))
def test_mac_uniform_matches_pallas(rng, rows):
    ring, bank, idx, mask = _inputs(rng, True)
    r = np.asarray(ROWS[rows])
    for t in (0, 2, 5):
        ref = np.asarray(pallas_spectral_mac_uniform(
            jnp.asarray(ring[r]), jnp.asarray(bank), jnp.asarray(idx[r]),
            jnp.asarray(mask[r]), jnp.int32(t), interpret=True))
        got = _port(ring, bank, r, idx, mask, t, True)
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_mac_bin0_is_two_real_products(rng):
    """Bin 0 carries DC and Nyquist: independent real products, no cross
    terms, for a row read in place."""
    ring, bank, idx, mask = _inputs(rng, False)
    mask[:] = 1.0
    y = _port(ring, bank, [5], idx, mask, 0, False)
    e = idx[5]
    hpos = [(0 - j) % B for j in range(B)]   # coefficient slot of ring slot j
    dc = sum(ring[5, j, 0, 0] * bank[e, hpos[j], 0, 0] for j in range(B))
    ny = sum(ring[5, j, 1, 0] * bank[e, hpos[j], 1, 0] for j in range(B))
    np.testing.assert_allclose(y[0, :, 0], [dc, ny], rtol=1e-6)


@pytest.mark.parametrize("uniform", [True, False])
def test_wrapper_on_cpu_runs_plain_version_and_counts_nothing(rng, uniform):
    ring, bank, idx, mask = _inputs(rng, uniform)
    args = (torch.as_tensor(ring), torch.as_tensor(bank),
            torch.tensor([3, 0], dtype=torch.int32), torch.as_tensor(idx),
            torch.as_tensor(mask), torch.tensor(5, dtype=torch.int32))
    tm.reset_launches()
    got = tm.mac(*args, uniform)
    assert tm.launches == {"mac_uniform": 0, "mac_rows": 0,
                           "mac_uniform_f64": 0, "mac_rows_f64": 0}
    torch.testing.assert_close(got, tm.mac_reference(*args, uniform),
                               rtol=0, atol=0)


def _good_args():
    Fg, Bg, Kg, Eg = 3, 4, 128, 2
    return [torch.zeros(Fg, Bg, 2, Kg), torch.zeros(Eg, Bg, 2, Kg),
            torch.tensor([2, 0], dtype=torch.int32),
            torch.zeros(Fg, dtype=torch.int32), torch.ones(Fg, Bg),
            torch.tensor(0, dtype=torch.int32)]


@pytest.mark.parametrize("pos,bad,exc", [
    (0, torch.zeros(3, 4, 2, 128, dtype=torch.float64), TypeError),
    (1, torch.zeros(2, 4, 2, 64), ValueError),
    (2, torch.tensor([2, 0], dtype=torch.int64), TypeError),
    (2, torch.zeros((1, 2), dtype=torch.int32), ValueError),
    (2, torch.zeros(0, dtype=torch.int32), ValueError),
    (2, torch.zeros(4, dtype=torch.int32)[::2], ValueError),
    (3, torch.zeros(2, dtype=torch.int32), ValueError),
    (4, torch.ones(3, 5), ValueError),
    (5, torch.tensor([0, 1], dtype=torch.int32), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(pos, bad, exc):
    args = _good_args()
    args[pos] = bad
    with pytest.raises(exc):
        tm.mac(*args, False)
