"""The fused MAC + output mix: the port's plain version against the JAX
package's Pallas kernel (interpret mode), and the wrapper's dispatch and
checks. The CUDA kernel itself is held against the plain version on a
card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerance atol 1e-4, as tests/test_pallas_mac.py holds the fused kernel:
O(1) random spectra summed over B partitions and F filters in float32,
in a different order."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from brutefir_tpu.ops.pallas_mac import pallas_spectral_mac_mix
from brutefir_tpu_torch.convert import bank_from_jax, state_from_jax
from brutefir_tpu_torch.ops import mac_mix as mm

ATOL = 1e-4


def _inputs(rng, F, B, N, E, C, uniform):
    R = N // 128
    ring = rng.standard_normal((F, B, 2, R, 128)).astype(np.float32)
    bank = rng.standard_normal((E, B, 2, R, 128)).astype(np.float32)
    if uniform:
        idx = np.full(F, E - 1, np.int32)
        mask = np.tile((rng.uniform(size=B) > 0.3).astype(np.float32),
                       (F, 1))
    else:
        idx = (np.arange(F) % E).astype(np.int32)
        mask = (rng.uniform(size=(F, B)) > 0.3).astype(np.float32)
    mask[:, -1] = 0.0          # always some zeros
    w = rng.standard_normal((C, F)).astype(np.float32)
    return ring, bank, idx, mask, w


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("t", [0, 3, 6, 11])
def test_mac_mix_reference_matches_pallas(rng, uniform, t):
    """Tiled JAX inputs go through convert.py into the port's flat
    layout; the plain version equals the JAX fused kernel."""
    F, B, N, E, C = 4, 4, 256, 2, 3
    ring, bank, idx, mask, w = _inputs(rng, F, B, N, E, C, uniform)
    ref = np.asarray(pallas_spectral_mac_mix(
        jnp.asarray(ring), jnp.asarray(bank), jnp.asarray(idx),
        jnp.asarray(mask), jnp.int32(t), jnp.asarray(w),
        uniform=uniform, interpret=True))
    cpu = torch.device("cpu")
    st = state_from_jax(np.zeros((1, N), np.float32), ring,
                        np.zeros((0, N), np.float32), t, cpu)
    got = mm.mac_mix_reference(
        st.ring, bank_from_jax(bank, cpu), torch.as_tensor(idx),
        torch.as_tensor(mask), st.t, torch.as_tensor(w), uniform)
    assert got.shape == (C, 2, N)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("uniform", [True, False])
def test_wrapper_on_cpu_runs_plain_version_and_counts_nothing(rng, uniform):
    F, B, N, E, C = 3, 4, 256, 2, 5
    ring, bank, idx, mask, w = _inputs(rng, F, B, N, E, C, uniform)
    args = (torch.as_tensor(ring.reshape(F, B, 2, N)),
            torch.as_tensor(bank.reshape(E, B, 2, N)),
            torch.as_tensor(idx), torch.as_tensor(mask),
            torch.tensor(5, dtype=torch.int32), torch.as_tensor(w))
    mm.reset_launches()
    got = mm.mac_mix(*args, uniform)
    assert mm.launches == mm.with_bf16("uniform", "rows", "tiled")
    torch.testing.assert_close(got, mm.mac_mix_reference(*args, uniform),
                               rtol=0, atol=0)


def _good_args():
    F, B, K, E, C = 3, 4, 128, 2, 2
    return [torch.zeros(F, B, 2, K), torch.zeros(E, B, 2, K),
            torch.zeros(F, dtype=torch.int32), torch.ones(F, B),
            torch.tensor(0, dtype=torch.int32), torch.zeros(C, F)]


@pytest.mark.parametrize("pos,bad,exc", [
    (0, torch.zeros(3, 4, 2, 128, dtype=torch.float64), TypeError),
    (0, torch.zeros(3, 4, 3, 128), ValueError),
    (1, torch.zeros(2, 4, 2, 64), ValueError),
    (2, torch.zeros(3, dtype=torch.int64), TypeError),
    (3, torch.ones(3, 5), ValueError),
    (4, torch.tensor([0, 1], dtype=torch.int32), ValueError),
    (5, torch.zeros(2, 4), ValueError),
    (5, torch.zeros(3, 2).T, ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(pos, bad, exc):
    args = _good_args()
    args[pos] = bad
    with pytest.raises(exc):
        mm.mac_mix(*args, False)


# --- the launch plan of csrc/mac_mix.cu ---------------------------------------

_PLAN_SHAPES = [(F, C, B, K) for F in (1, 26, 255, 256)
                for C in (1, 32, 33, 128, 256) for B in (1, 8, 16)
                for K in (1, 64, 256, 1000, 8192, 65536)
                if not mm.tiled_route(C, B, K)]


def _tile_bins(K: int, TK: int, tile: int) -> list:
    """The bins block ``tile`` of csrc/mac_mix.cu owns, as it maps them
    (k0 = blockIdx.x * TK): lane l takes bin tile * TK + l below K."""
    return [k for lane in range(TK) if (k := tile * TK + lane) < K]


def _chunk_filters(F: int, nw: int, FC: int, chunk: int, warp: int) -> list:
    """The filters warp ``warp`` of csrc/mac_mix.cu MACs in chunk
    ``chunk``, in its order: round r (chunk * FC / nw up to the chunk's
    end) gives it filter r * nw + warp, below F."""
    per_chunk = FC // nw
    return [f for r in range(chunk * per_chunk, (chunk + 1) * per_chunk)
            if (f := r * nw + warp) < F]


@pytest.mark.parametrize("F,C_out,B,K", _PLAN_SHAPES)
def test_plan_fits_and_covers_every_bin_once(F, C_out, B, K):
    """Every shape that reaches csrc/mac_mix.cu (F <= 256 filters, C_out
    <= 256 outputs, tiled_route false) gets a plan in both forms that fits
    the 227 KB of dynamic shared memory; its blocks own every bin once and
    its chunks and warps every filter once, in ascending order within a
    warp."""
    for uniform in (True, False):
        p = mm.plan(F, B, K, C_out, uniform)
        nw = p["nw"]
        assert 4 <= nw <= mm.MIX_MAX_WARPS and p["FC"] % nw == 0
        assert p["TK"] == mm.MIX_TK and p["bank_smem"] <= uniform
        assert p["smem"] == mm.smem_bytes(nw, p["FC"], F, B, C_out,
                                          p["bank_smem"]) <= mm.SMEM_MAX
        bins = [k for tile in range(p["tiles"])
                for k in _tile_bins(K, p["TK"], tile)]
        assert len(bins) == K and sorted(bins) == list(range(K))
        chunks = max(1, -(-F // p["FC"]))
        owned = []
        for ch in range(chunks):
            for warp in range(nw):
                fs = _chunk_filters(F, nw, p["FC"], ch, warp)
                assert fs == sorted(fs)
                assert all(ch * p["FC"] <= f < (ch + 1) * p["FC"] for f in fs)
                owned += fs
        assert len(owned) == F and sorted(owned) == list(range(F))


@pytest.mark.parametrize("uniform", [True, False])
def test_plan_at_the_massive_shape(uniform):
    """26 filters of 8192 x 16 to 26 outputs: at least one block a SM of
    the H100's 132, two rounds of 13 warps, one chunk (no out tile), the
    uniform bank tile staged once a block, and two blocks' shared memory
    fitting one SM."""
    p = mm.plan(26, 16, 8192, 26, uniform)
    assert p["tiles"] >= 132 and p["nw"] == 13 and p["FC"] == 26
    assert p["bank_smem"] == uniform
    assert 2 * p["smem"] <= mm.SMEM_MAX


def test_plan_refuses_what_fits_no_block():
    with pytest.raises(ValueError, match="no launch fits"):
        mm.plan(8, 4, 64, 10_000)
