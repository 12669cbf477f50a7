"""The bin-tiled fused MAC + output mix (the big-shape route of the fused
MAC): the port's plain version against the JAX package's
``_tiled_mix_call`` in interpret mode plus its ``_bin0`` patch, the way
tests/test_pallas_mac.py holds the tiled kernel; the routing rule against
the one ``pallas_spectral_mac_mix`` applies; and the wrapper on the CPU
at a routed shape. The CUDA kernel itself is held against the plain
version on a card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerance: 1e-5 of the output's max magnitude -- O(1) random spectra
summed over B partitions and F filters in float32, in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brutefir_tpu.ops.pallas_mac as pm
from brutefir_tpu_torch.ops import mac_mix as mm

REL = 1e-5


@pytest.mark.parametrize("F,B,N,E,C", [
    (8, 3, 1024, 5, 12),       # E < F, C > F
    (16, 5, 2048, 16, 9),      # one bank row per filter, R = 16 (Rc = 16)
    (12, 4, 256, 3, 16),
])
def test_tiled_plain_matches_pallas(rng, F, B, N, E, C):
    ring = rng.standard_normal((F, B, 2, N)).astype(np.float32)
    bank = rng.standard_normal((E, B, 2, N)).astype(np.float32)
    idx = rng.integers(0, E, F).astype(np.int32)
    mask = (rng.uniform(size=(F, B)) > 0.25).astype(np.float32)
    mask[:, -1] = 0.0
    w = rng.standard_normal((C, F)).astype(np.float32)
    R = N // 128
    ring5 = jnp.asarray(ring.reshape(F, B, 2, R, 128))
    bank5 = jnp.asarray(bank.reshape(E, B, 2, R, 128))
    for t in (0, B - 1, B + 2, 3 * B + 1):
        rpos = jnp.mod(jnp.int32(t) - jnp.arange(B, dtype=jnp.int32),
                       B).astype(jnp.int32)
        out = pm._tiled_mix_call(ring5, bank5, jnp.asarray(idx), rpos,
                                 jnp.asarray(mask), jnp.asarray(w),
                                 interpret=True).reshape(C, 2, N)
        y0r, y0i = pm._bin0(jnp.asarray(ring), jnp.asarray(bank),
                            jnp.asarray(idx), jnp.asarray(mask), rpos)
        ref = np.asarray(out.at[:, 0, 0].set(w @ np.asarray(y0r))
                         .at[:, 1, 0].set(w @ np.asarray(y0i)))
        got = mm.mac_mix_reference(
            torch.as_tensor(ring), torch.as_tensor(bank),
            torch.as_tensor(idx), torch.as_tensor(mask),
            torch.tensor(t, dtype=torch.int32), torch.as_tensor(w),
            uniform=False).numpy()
        assert got.shape == (C, 2, N)
        assert np.abs(got - ref).max() / np.abs(ref).max() <= REL, t


@pytest.mark.parametrize("C_out,B,K", [
    (256, 16, 8192),           # the 256-channel scale shape: tiled
    (26, 16, 8192),            # massive_config: resident
    (8, 64, 8192),             # the ring and bank rows alone overflow
    (128, 16, 8192),           # 4 MiB + 8 MiB: at the budget, resident
    (129, 16, 8192),           # one output over it: tiled
    (256, 4, 1024),
])
def test_tiled_route_is_the_jax_rule(monkeypatch, C_out, B, K):
    """``tiled_route`` picks the tiled kernel exactly where
    ``pallas_spectral_mac_mix`` does, read off the JAX function itself
    (traced abstractly, with its tiled call spied)."""
    taken = []

    def spy(*args, **kwargs):
        taken.append(True)
        raise _Routed()

    monkeypatch.setattr(pm, "_tiled_mix_call", spy)
    F, E = 2, 1
    sds = jax.ShapeDtypeStruct
    try:
        jax.eval_shape(
            lambda r, b, i, m, t, w: pm.pallas_spectral_mac_mix(
                r, b, i, m, t, w, interpret=True),
            sds((F, B, 2, K), jnp.float32), sds((E, B, 2, K), jnp.float32),
            sds((F,), jnp.int32), sds((F, B), jnp.float32),
            sds((), jnp.int32), sds((C_out, F), jnp.float32))
    except _Routed:
        pass
    assert mm.tiled_route(C_out, B, K) == bool(taken)


class _Routed(Exception):
    pass


def test_mac_mix_on_cpu_at_a_tiled_shape_runs_plain_version():
    """At a routed shape the wrapper on a CPU tensor still runs the plain
    version and launches nothing."""
    F, B, K, E, C = 3, 1, 8192, 2, 260
    assert mm.tiled_route(C, B, K)
    g = torch.Generator().manual_seed(5)
    ring = torch.randn(F, B, 2, K, generator=g)
    bank = torch.randn(E, B, 2, K, generator=g)
    idx = torch.tensor([1, 0, 1], dtype=torch.int32)
    mask = torch.ones(F, B)
    t = torch.tensor(3, dtype=torch.int32)
    w = torch.randn(C, F, generator=g)
    mm.reset_launches()
    got = mm.mac_mix(ring, bank, idx, mask, t, w, False)
    assert mm.launches == mm.with_bf16("uniform", "rows", "tiled")
    torch.testing.assert_close(
        got, mm.mac_mix_reference(ring, bank, idx, mask, t, w, False),
        rtol=0, atol=0)
