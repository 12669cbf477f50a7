"""The crossfade dual MAC: the port's plain version against the JAX
package's ``pallas_spectral_mac_dual`` (its ``_mac_kernel_rowmajor_dual``
and ``_mac_kernel_uniform_dual``, interpret mode), and the wrapper's
dispatch, counts and checks. The CUDA kernel itself is held against the
plain version on a card by tests/test_torch_cuda.py and chip_smoke.py.

The JAX side gets the stage's rows gathered (``ring[rows]``) with the
stage's controls, as its stage loop passes them; the port reads them in
place through ``rows``.

Tolerance atol 1e-5, as tests/test_torch_mac.py holds the single MAC:
O(1) random spectra summed over B partitions in float32, in another
order.

The edge shapes of the kernel's paths (test_torch_mac.py's ``EDGES``)
go through the same comparison; where K is no multiple of 128, which the
Pallas kernels refuse, the JAX side is its dense MAC twice."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from brutefir_tpu.ops import partconv as jpc
from brutefir_tpu.ops.pallas_mac import pallas_spectral_mac_dual
from brutefir_tpu_torch.ops import mac as tm, mac_dual as td
from test_torch_mac import EDGES, _at_offset, _edge_inputs

ATOL = 1e-5
F, B, K, E = 6, 4, 256, 4
ROWS = {"stage": [2, 3, 4, 5], "repeated": [4, 1, 1], "all": list(range(F))}


def _inputs(rng, uniform):
    """Ring, bank and both control sets; the masks hold cblocks-style
    zeros and prev_mask differs from mask."""
    ring = rng.standard_normal((F, B, 2, K)).astype(np.float32)
    bank = rng.standard_normal((E, B, 2, K)).astype(np.float32)
    if uniform:
        idx = np.full(F, E - 1, np.int32)
        pidx = np.full(F, 1, np.int32)
        mask = np.tile(np.array([1, 1, 1, 0], np.float32), (F, 1))
        pmask = np.tile(np.array([1, 1, 0, 0], np.float32), (F, 1))
    else:
        idx = (np.arange(F) % E).astype(np.int32)
        pidx = ((np.arange(F) + 1) % E).astype(np.int32)
        mask = (rng.uniform(size=(F, B)) > 0.3).astype(np.float32)
        pmask = (rng.uniform(size=(F, B)) > 0.3).astype(np.float32)
        mask[:, -1] = 0.0
        pmask[:, -2:] = 0.0
    assert not np.array_equal(mask, pmask)
    return ring, bank, idx, mask, pidx, pmask


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _port(ring, bank, rows, idx, mask, pidx, pmask, t, uniform):
    y_new, y_old = td.mac_dual(
        *_t(ring, bank, np.asarray(rows, np.int32), idx, mask, pidx, pmask),
        torch.tensor(t, dtype=torch.int32), uniform)
    return y_new.numpy(), y_old.numpy()


@pytest.mark.parametrize("rows", sorted(ROWS))
@pytest.mark.parametrize("uniform", [True, False])
def test_mac_dual_matches_pallas(rng, uniform, rows):
    ring, bank, idx, mask, pidx, pmask = _inputs(rng, uniform)
    r = np.asarray(ROWS[rows])
    for t in (0, 3, 4, 9):                   # 4 and 9 wrap the ring
        ref_new, ref_old = pallas_spectral_mac_dual(
            jnp.asarray(ring[r]), jnp.asarray(bank), jnp.asarray(idx[r]),
            jnp.asarray(mask[r]), jnp.asarray(pidx[r]),
            jnp.asarray(pmask[r]), jnp.int32(t), uniform=uniform,
            interpret=True)
        y_new, y_old = _port(ring, bank, r, idx, mask, pidx, pmask, t,
                             uniform)
        assert y_new.shape == y_old.shape == (r.size, 2, K)
        np.testing.assert_allclose(y_new, np.asarray(ref_new), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(y_old, np.asarray(ref_old), rtol=0,
                                   atol=ATOL)
        assert np.abs(y_new - y_old).max() > 1.0   # two distinct products


@pytest.mark.parametrize("edge", sorted(EDGES))
@pytest.mark.parametrize("uniform", [True, False])
def test_mac_dual_edge_shapes_match_jax(rng, uniform, edge):
    F_, B_, K_, E_, rows, offset = EDGES[edge]
    ring, bank, idx, mask = _edge_inputs(rng, F_, B_, K_, E_, uniform)
    pidx = ((idx + 1) % E_).astype(np.int32)
    pmask = mask.copy()
    pmask[:, B_ // 2 + 1:] = 0.0
    r = np.asarray(rows)
    ring_t = _at_offset(ring, offset)
    for t in (0, B_ - 1, 2 * B_ + 5):     # the last slot; past two wraps
        jargs = [jnp.asarray(a) for a in (ring[r], bank, idx[r], mask[r],
                                          pidx[r], pmask[r])]
        if K_ % 128 == 0:
            refs = pallas_spectral_mac_dual(*jargs, jnp.int32(t),
                                            uniform=uniform, interpret=True)
        else:
            fn = jpc.spectral_mac_uniform if uniform else \
                jpc.spectral_mac_rollh
            refs = (fn(*jargs[:4], jnp.int32(t)),
                    fn(jargs[0], jargs[1], jargs[4], jargs[5], jnp.int32(t)))
        got = td.mac_dual(ring_t, *_t(bank, r.astype(np.int32), idx, mask,
                                      pidx, pmask),
                          torch.tensor(t, dtype=torch.int32), uniform)
        for y, ref in zip(got, refs):
            assert y.shape == (r.size, 2, K_)
            np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=0,
                                       atol=ATOL)


@pytest.mark.parametrize("uniform", [True, False])
def test_mac_dual_is_two_single_macs(rng, uniform):
    """Each output equals the single MAC with its control set, bit for
    bit on the CPU (the same plain version)."""
    ring, bank, idx, mask, pidx, pmask = _inputs(rng, uniform)
    rows = torch.tensor([5, 0, 3], dtype=torch.int32)
    t = torch.tensor(6, dtype=torch.int32)
    rg, bk, ix, mk, px, pm = _t(ring, bank, idx, mask, pidx, pmask)
    y_new, y_old = td.mac_dual(rg, bk, rows, ix, mk, px, pm, t, uniform)
    torch.testing.assert_close(y_new, tm.mac(rg, bk, rows, ix, mk, t,
                                             uniform), rtol=0, atol=0)
    torch.testing.assert_close(y_old, tm.mac(rg, bk, rows, px, pm, t,
                                             uniform), rtol=0, atol=0)


def test_wrapper_on_cpu_counts_nothing(rng):
    ring, bank, idx, mask, pidx, pmask = _inputs(rng, False)
    td.reset_launches()
    _port(ring, bank, [1, 2], idx, mask, pidx, pmask, 2, False)
    assert td.launches == {"mac_dual_uniform": 0, "mac_dual_rows": 0}


def _good_args():
    Fg, Bg, Kg, Eg = 3, 4, 128, 2
    return [torch.zeros(Fg, Bg, 2, Kg), torch.zeros(Eg, Bg, 2, Kg),
            torch.tensor([2, 0], dtype=torch.int32),
            torch.zeros(Fg, dtype=torch.int32), torch.ones(Fg, Bg),
            torch.zeros(Fg, dtype=torch.int32), torch.ones(Fg, Bg),
            torch.tensor(0, dtype=torch.int32)]


@pytest.mark.parametrize("pos,bad,exc", [
    (0, torch.zeros(3, 4, 2, 128, dtype=torch.float64), TypeError),
    (2, torch.zeros(0, dtype=torch.int32), ValueError),
    (5, torch.zeros(3, dtype=torch.int64), TypeError),
    (5, torch.zeros(2, dtype=torch.int32), ValueError),
    (6, torch.ones(3, 5), ValueError),
    (6, torch.ones(4, 3).t(), ValueError),
    (7, torch.tensor([0, 1], dtype=torch.int32), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(pos, bad, exc):
    args = _good_args()
    args[pos] = bad
    with pytest.raises(exc):
        td.mac_dual(*args, False)
