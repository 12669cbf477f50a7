"""The grouped MACs of the batched offline dispatch: the port's plain
versions of ``mac_group`` and ``mac_mix_group`` against the JAX package's
``pallas_spectral_mac_group`` / ``pallas_spectral_mac_mix_group`` (Pallas
in interpret mode), against G blocks of the sequential schedule, and the
wrappers' dispatch and checks. The CUDA kernels themselves are held
against the plain versions on a card by tests/test_torch_cuda.py and
chip_smoke.py.

Inputs as tests/test_pair_step.py drives the JAX kernels: random O(1)
spectra, per-filter delays covering 0, 1, G-1 and >= G, and the mask the
host's cblocks clamp gives (partitions >= B - delay are zero), at start
times that wrap the ring inside the group. Tolerance: 1e-5 of the
output's max magnitude -- float32 sums over B partitions (and F filters
in the mix) taken in another order."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from brutefir_tpu.ops.pallas_mac import (pallas_spectral_mac_group,
                                         pallas_spectral_mac_mix_group)
from brutefir_tpu_torch.graph.compile import _write_ring
from brutefir_tpu_torch.ops import mac_group as mg
from brutefir_tpu_torch.ops.partconv import complex_mix, spectral_mac_rollh

REL = 1e-5
F, B, E, C_OUT = 10, 5, 4, 7


def _inputs(G, N, seed):
    rng = np.random.default_rng(seed)
    ring = rng.standard_normal((F, B, 2, N)).astype(np.float32)
    bank = rng.standard_normal((E, B, 2, N)).astype(np.float32)
    xnews = rng.standard_normal((F, G - 1, 2, N)).astype(np.float32)
    w = rng.standard_normal((C_OUT, F)).astype(np.float32)
    idx = rng.integers(0, E, F).astype(np.int32)
    # 0, 1, G-1 and >= G (the delays are clamped to B-1 by the host)
    delay = np.array([0, 1, G - 1, G, min(G + 1, B - 1), 0, 1, G - 1, 0,
                      B - 1], np.int32)
    mask = np.zeros((F, B), np.float32)
    for f in range(F):
        mask[f, :B - delay[f]] = 1.0
    mask[5, 2:] = 0.0                           # a shorter coefficient
    return ring, bank, xnews, w, idx, mask, delay


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("G", [2, 3, 4])
@pytest.mark.parametrize("N", [256, 1024])
def test_group_plain_matches_pallas(G, N):
    ring, bank, xnews, w, idx, mask, delay = _inputs(G, N, seed=G * N)
    jx = jnp.asarray(np.moveaxis(xnews, 1, 0))  # JAX's flat [G-1, F, 2, N]
    for t in (0, B - 2, 2 * B + 3):             # B - 2: the group wraps
        ref = pallas_spectral_mac_group(
            jnp.asarray(ring), jx, jnp.asarray(bank), jnp.asarray(idx),
            jnp.asarray(mask), jnp.int32(t), jnp.asarray(delay),
            interpret=True)
        r, x, h, i, m, d = _torch(ring, xnews, bank, idx, mask, delay)
        got = mg.mac_group_reference(r, x, h, i, m,
                                     torch.tensor(t, dtype=torch.int32), d)
        assert got.shape == (G, F, 2, N)
        for g in range(G):
            assert _rel(got[g], ref[g]) <= REL, (t, g)


@pytest.mark.parametrize("G", [2, 3, 4])
@pytest.mark.parametrize("N", [256, 1024])
def test_mix_group_plain_matches_pallas(G, N):
    ring, bank, xnews, w, idx, mask, delay = _inputs(G, N, seed=G + N)
    jx = jnp.asarray(np.moveaxis(xnews, 1, 0))
    for t in (1, B - 1, 3 * B):
        ref = pallas_spectral_mac_mix_group(
            jnp.asarray(ring), jx, jnp.asarray(bank), jnp.asarray(idx),
            jnp.asarray(mask), jnp.int32(t), jnp.asarray(w),
            jnp.asarray(delay), interpret=True)
        r, x, h, i, m, ww, d = _torch(ring, xnews, bank, idx, mask, w, delay)
        got = mg.mac_mix_group_reference(
            r, x, h, i, m, torch.tensor(t, dtype=torch.int32), ww, d)
        assert got.shape == (G, C_OUT, 2, N)
        for g in range(G):
            assert _rel(got[g], ref[g]) <= REL, (t, g)


@pytest.mark.parametrize("G", [2, 3, 4])
def test_group_plain_matches_sequential_blocks(G):
    """The group's result is what G blocks of the per-block step read:
    ring writes in order, one plain MAC per block. Bin 0 included (the
    taps are random, not a dirac)."""
    N = 256
    ring, bank, xnews, w, idx, mask, delay = _inputs(G, N, seed=7 * G)
    r, x, h, i, m, d = _torch(ring, xnews, bank, idx, mask, delay)
    t0 = 2 * B - 1
    t = torch.tensor(t0, dtype=torch.int32)
    got = mg.mac_group_reference(r, x, h, i, m, t, d)
    seq = r.clone()
    for g in range(G):
        if g:
            _write_ring(seq, x[:, g - 1], t + g, d, False)
        ref = spectral_mac_rollh(seq, h, i, m, t + g)
        assert _rel(got[g], ref) <= REL, g
        assert float(ref[:, :, 0].abs().max()) > 0   # bin 0 carries data


def test_group_rows_substitutes_the_groups_own_spectra():
    """Block t+g, partition b reads xnews[f, g-b-1-delay[f]] where that
    index is >= 0, the ring slot (t+g-b) % B elsewhere."""
    G, N = 4, 4
    ring = torch.arange(F * B, dtype=torch.float32).reshape(F, B, 1, 1)
    ring = ring.expand(F, B, 2, N).contiguous()
    xnews = -1.0 - torch.arange(G - 1, dtype=torch.float32)
    xnews = xnews.reshape(1, G - 1, 1, 1).expand(F, G - 1, 2, N).contiguous()
    delay = torch.tensor([0, 1, 2, 3, 0, 0, 0, 0, 0, 0], dtype=torch.int32)
    t = torch.tensor(6, dtype=torch.int32)
    for g in range(G):
        rows = mg.group_rows(ring, xnews, t, delay, g)
        for f in range(4):
            for b in range(B):
                j = g - b - 1 - int(delay[f])
                want = -1.0 - j if j >= 0 else float(f * B + (6 + g - b) % B)
                assert float(rows[f, b, 0, 0]) == want, (g, f, b)


def test_wrappers_on_cpu_run_plain_versions_and_count_nothing():
    G, N = 3, 256
    ring, bank, xnews, w, idx, mask, delay = _inputs(G, N, seed=3)
    r, x, h, i, m, ww, d = _torch(ring, xnews, bank, idx, mask, w, delay)
    t = torch.tensor(4, dtype=torch.int32)
    mg.reset_launches()
    torch.testing.assert_close(mg.mac_group(r, x, h, i, m, t, d),
                               mg.mac_group_reference(r, x, h, i, m, t, d),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        mg.mac_mix_group(r, x, h, i, m, t, ww, d),
        mg.mac_mix_group_reference(r, x, h, i, m, t, ww, d), rtol=0, atol=0)
    assert mg.launches == {"group": 0, "mix_group": 0}
    mix = mg.mac_mix_group_reference(r, x, h, i, m, t, ww, d)
    ys = mg.mac_group_reference(r, x, h, i, m, t, d)
    torch.testing.assert_close(mix[1], complex_mix(ww, ys[1]))


def _good_args():
    G, K = 3, 128
    return [torch.zeros(F, B, 2, K), torch.zeros(F, G - 1, 2, K),
            torch.zeros(E, B, 2, K), torch.zeros(F, dtype=torch.int32),
            torch.ones(F, B), torch.tensor(0, dtype=torch.int32),
            torch.zeros(F, dtype=torch.int32)]


@pytest.mark.parametrize("pos,bad,exc", [
    (1, torch.zeros(F, 0, 2, 128), ValueError),          # G = 1
    (1, torch.zeros(F, 2, 2, 64), ValueError),
    (1, torch.zeros(F + 1, 2, 2, 128), ValueError),
    (1, torch.zeros(F, 2, 2, 128, dtype=torch.float64), TypeError),
    (6, torch.zeros(F, dtype=torch.int64), TypeError),
    (6, torch.zeros(F - 1, dtype=torch.int32), ValueError),
    (2, torch.zeros(E, B + 1, 2, 128), ValueError),
])
def test_wrappers_reject_what_the_kernels_do_not_take(pos, bad, exc):
    args = _good_args()
    args[pos] = bad
    with pytest.raises(exc):
        mg.mac_group(*args)
    with pytest.raises(exc):
        mg.mac_mix_group(*args[:6], torch.zeros(C_OUT, F), args[6])
