"""Several blocks of the port's step_impl against the JAX package's
fused-mix step (Pallas kernel in interpret mode, lane-tiled state),
starting both from one converted mid-stream state.

atol 1e-5 on y: O(1) signals through float32 FFTs, mixes and partition
sums taken in a different order by the two packages."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from brutefir_tpu.graph import compile as jcomp
from brutefir_tpu.graph.spec import build_graph_spec as jax_spec
from brutefir_tpu.ops.partconv import make_bank, preprocess_coeffs
from brutefir_tpu_torch.convert import (bank_from_jax, ctrl_from_jax,
                                        state_from_jax)
from brutefir_tpu_torch.graph.compile import step_impl
from brutefir_tpu_torch.graph.spec import build_graph_spec

N, B, C = 256, 4, 3
CPU = torch.device("cpu")

CASES = {
    # name: (coeff_idx, delay, uniform, uniform_delay, powersave)
    "predelay": ([0, 1, 0], [0, 1, 3], False, False, False),
    "uniform": ([1, 1, 1], [0, 0, 0], True, True, False),
    "uniform_delay": ([0, 1, 1], [2, 2, 2], False, True, False),
    "shared_coeff_predelay": ([0, 0, 0], [1, 0, 2], True, False, False),
    "powersave": ([1, 1, 1], [0, 0, 0], True, True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_jax(rng, case):
    idx, delay, uniform, udl, powersave = CASES[case]
    idx = np.asarray(idx, np.int32)
    taps_a = (rng.standard_normal(N * B) * 0.05).astype(np.float32)
    taps_b = (rng.standard_normal(N * 2) * 0.05).astype(np.float32)
    bank = make_bank([preprocess_coeffs(taps_a, N, B),
                      preprocess_coeffs(taps_b, N, B)])     # [2, B, 2, N]
    mask = np.ones((C, B), np.float32)
    mask[idx == 1, 2:] = 0.0                  # coeff 1 has 2 partitions
    in_mix = rng.standard_normal((C, C)).astype(np.float32)
    out_mix = rng.standard_normal((C, C)).astype(np.float32)
    ps = np.array([0.0, 0.05, 0.05], np.float32) if powersave else None

    jspec = jax_spec(N, B, C, C, [[] for _ in range(C)], [False] * C,
                     powersave=powersave)
    tspec = build_graph_spec(N, B, C, C, [[] for _ in range(C)],
                             [False] * C, powersave=powersave)
    jctrl = jcomp.make_ctrl(jspec, in_mix, np.zeros((C, C), np.float32),
                            out_mix, np.asarray(delay, np.int32), idx, mask,
                            ps_thresh=ps)
    jstep = jax.jit(functools.partial(
        jcomp._step_impl, jspec, "pallas-interpret", uniform=uniform,
        tiled=True, uniform_delay=udl))
    jbank = jnp.asarray(bank.reshape(2, B, 2, N // 128, 128))
    jstate = jcomp.CompiledGraph(jspec, mac="pallas-interpret").init_state()

    xs = (rng.standard_normal((9, C, N)) * 0.5).astype(np.float32)
    if powersave:
        xs[3:6, 1] *= 1e-3        # channel 1 quiet for a few frames
        xs[2:7, 2] = 0.0          # channel 2 silent
    # JAX alone up to a mid-stream state (ring partly filled, t wrapped)
    for xb in xs[:5]:
        jstate, _ = jstep(jstate, jctrl, jbank, jnp.asarray(xb))
    tstate = state_from_jax(np.asarray(jstate.prev_in),
                            np.asarray(jstate.ring),
                            np.asarray(jstate.eval_prev), jstate.t, CPU)
    tctrl = ctrl_from_jax(jctrl, CPU)
    tbank = bank_from_jax(np.asarray(jbank), CPU)
    assert tstate.ring.shape == (C, B, 2, N)

    for xb in xs[5:]:
        jstate, yj = jstep(jstate, jctrl, jbank, jnp.asarray(xb))
        tstate, yt = step_impl(tspec, tstate, tctrl, tbank,
                               torch.as_tensor(xb), uniform=uniform,
                               uniform_delay=udl)
        assert yt.shape == (C, N)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                                   atol=1e-5)
    assert int(tstate.t) == int(jstate.t) == 9
    # the ring holds unnormalised spectra (|X| up to ~50 here): held to
    # 1e-6 of its peak, the same float32 headroom as y's 1e-5 at O(1)
    ring_j = np.asarray(jstate.ring).reshape(C, B, 2, N)
    np.testing.assert_allclose(tstate.ring.numpy(), ring_j, rtol=0,
                               atol=1e-6 * np.abs(ring_j).max())


def test_step_writes_ring_in_place(rng):
    """The ring is updated in place (the JAX donation analog), at slot
    (t + delay[f]) % B, before the MAC reads it."""
    from brutefir_tpu_torch.graph.compile import init_state, make_ctrl
    spec = build_graph_spec(N, 2, 2, 2, [[], []], [False, False])
    ctrl = make_ctrl(spec, np.eye(2), np.eye(2), np.array([0, 1]),
                     np.array([0, 0]), np.ones((2, 2)), device=CPU)
    bank = torch.as_tensor(make_bank([preprocess_coeffs(
        np.array([1.0], np.float32), N, 2)]))
    st = init_state(spec, CPU)
    ring = st.ring
    x = torch.as_tensor(rng.standard_normal((2, N)).astype(np.float32))
    st2, y = step_impl(spec, st, ctrl, bank, x)
    assert st2.ring is ring
    assert ring[0, 0].abs().sum() > 0 and ring[0, 1].abs().sum() == 0
    assert ring[1, 1].abs().sum() > 0 and ring[1, 0].abs().sum() == 0
    # unit-tap coefficient, no pre-delay on filter 0: y[0] is x[0]
    np.testing.assert_allclose(y[0].numpy(), x[0].numpy(), atol=1e-5)
    assert float(y[1].abs().max()) < 1e-5     # filter 1 one block late


def test_state_from_jax_refuses_cascade_tails():
    """Cascade tails carry over as a copy, none or some; tails of another
    shape than [n_casc, N] are refused."""
    prev_in = np.ones((2, N), np.float32)
    ring = np.zeros((2, B, 2, N // 128, 128), np.float32)
    st = state_from_jax(prev_in, ring, np.zeros((0, N), np.float32), 3, CPU)
    assert st.ring.shape == (2, B, 2, N) and int(st.t) == 3
    assert st.eval_prev.shape == (0, N)
    tails = np.arange(2 * N, dtype=np.float32).reshape(2, N)
    st = state_from_jax(prev_in, ring, tails, 3, CPU)
    np.testing.assert_array_equal(st.eval_prev.numpy(), tails)
    st.eval_prev.zero_()                     # the port writes it in place
    assert tails[1, 1] == N + 1
    for bad in (np.zeros((1, N // 2), np.float32), np.zeros(N, np.float32)):
        with pytest.raises(ValueError, match="eval_prev"):
            state_from_jax(prev_in, ring, bad, 3, CPU)
