"""Filter cascades and the stage loop: the port against the JAX package.

- Step level: the JAX ``CompiledGraph(spec, mac="pallas-interpret")``
  (its stage loop through the Pallas MACs, interpreted, lane-tiled state)
  against the port's ``step_impl`` from one converted mid-stream state, on
  bench1's topology, a three-stage chain, a shared cascade node, a filter
  with input and filter inputs, per-filter pre-delays and a shared
  coefficient; outputs, cascade tails and ring compared every block.
- Route: the port's ``fused_mix_route`` / ``mix_fusable`` take the fused
  MAC + mix exactly where the JAX package's ``fused_mix`` does.
- Engine level, file to file: a bench1-topology config at 256 x 4
  partitions with random FLOAT_LE taps, and single-stage configs that the
  JAX package sends to its stage loop (K = 64, where it has no Pallas
  kernel; ``BRUTEFIR_TPU_FUSED_MIX=0``), against the JAX engine.

Tolerances: y and the cascade tails within 1e-5 of the JAX block's peak
(float32 FFTs, mixes and partition sums in another order, through up to
three convolutions); the ring within 1e-6 of its peak, as
tests/test_torch_step.py holds it; S24 words within 1 LSB of the JAX
engine (docs/PARITY.md "Float-tolerance"), and within 2e-5 of the
output's peak + 4 LSB of a float64 oracle (the bound of
tests/test_fullshape_parity.py::test_bench1_fullshape_cascade_random_taps).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.signal
import torch

from brutefir_tpu.config import parse_config as jax_parse_config
from brutefir_tpu.graph import compile as jcomp
from brutefir_tpu.graph.spec import build_graph_spec as jax_spec
from brutefir_tpu.ops.pallas_mac import mix_fusable as jax_mix_fusable
from brutefir_tpu.ops.partconv import make_bank, preprocess_coeffs
from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.convert import (bank_from_jax, ctrl_from_jax,
                                        state_from_jax)
from brutefir_tpu_torch.graph import compile as tcomp
from brutefir_tpu_torch.graph.spec import build_graph_spec

N, B = 256, 4
CPU = torch.device("cpu")

# name: (C_in, C_out, filter_inputs, input edges (filter, channel), output
#        edges (channel, filter), coefficient per filter, delay per filter)
GRAPHS = {
    # the reference's bench1_config: f2, f5 -> f0 -> out 0; f3, f4 -> f1
    "bench1": (2, 2, [[2, 5], [3, 4], [], [], [], []],
               [(2, 0), (3, 0), (4, 1), (5, 1)], [(0, 0), (1, 1)],
               [0, 1, 2, 0, 1, 2], [0] * 6),
    "bench1_predelay": (2, 2, [[2, 5], [3, 4], [], [], [], []],
                        [(2, 0), (3, 0), (4, 1), (5, 1)], [(0, 0), (1, 1)],
                        [0, 1, 2, 0, 1, 2], [1, 0, 2, 0, 3, 1]),
    # in 0 -> f0 -> f1 -> f2 -> out 0, beside in 1 -> f3 -> out 1
    "chain3": (2, 2, [[], [0], [1], []], [(0, 0), (3, 1)],
               [(0, 2), (1, 3)], [0, 1, 2, 1], [0, 0, 1, 0]),
    # f0 feeds f1 and f2; f1 -> out 0, f2 -> out 1
    "shared_node": (1, 2, [[], [0], [0]], [(0, 0)], [(0, 1), (1, 2)],
                    [2, 0, 1], [0, 0, 0]),
    # f1 takes input 1 and f0's output, and goes out beside f0
    "inputs_and_filters": (2, 2, [[], [0]], [(0, 0), (1, 1)],
                           [(0, 0), (1, 1)], [0, 1], [0, 2]),
    # one shared coefficient and delay over two stages: the uniform forms
    "uniform": (3, 3, [[], [], [], [0], [1], [2]],
                [(0, 0), (1, 1), (2, 2)], [(0, 3), (1, 4), (2, 5)],
                [1] * 6, [2] * 6),
}


def _bank(rng):
    """Three coefficient sets of 4, 3 and 2 partitions, and the dirac."""
    n_blocks = np.array([B, 3, 2, 1])
    entries = [preprocess_coeffs(
        (rng.standard_normal(N * n) * 0.05).astype(np.float32), N, B)
        for n in n_blocks[:3]]
    entries.append(preprocess_coeffs(np.array([1.0], np.float32), N, B))
    return make_bank(entries), n_blocks


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_cascade_step_matches_jax(rng, graph):
    C_in, C_out, fin, in_edges, out_edges, coeff, delay = GRAPHS[graph]
    F = len(fin)
    coeff = np.asarray(coeff, np.int32)
    delay = np.asarray(delay, np.int32)
    bank, n_blocks = _bank(rng)
    mask = np.zeros((F, B), np.float32)
    for f in range(F):                   # the host's cblocks clamp
        mask[f, :min(n_blocks[coeff[f]], B - delay[f])] = 1.0
    uniform = graph == "uniform"
    in_mix = np.zeros((F, C_in), np.float32)
    for f, c in in_edges:
        in_mix[f, c] = rng.uniform(0.5, 1.5)
    fmix = np.zeros((F, F), np.float32)
    for f, srcs in enumerate(fin):
        for s in srcs:
            fmix[f, s] = rng.uniform(0.5, 1.5)
    out_mix = np.zeros((C_out, F), np.float32)
    for c, f in out_edges:
        out_mix[c, f] = rng.uniform(0.5, 1.5)

    jspec = jax_spec(N, B, C_in, C_out, fin, [False] * F)
    tspec = build_graph_spec(N, B, C_in, C_out, fin, [False] * F)
    assert len(tspec.stages) > 1 and not tcomp.fused_mix_route(tspec)
    jctrl = jcomp.make_ctrl(jspec, in_mix, fmix, out_mix, delay, coeff, mask)
    cg = jcomp.CompiledGraph(jspec, mac="pallas-interpret")
    assert cg.mac == "pallas-interpret" and cg.tiled
    jbank = jnp.asarray(bank.reshape(bank.shape[0], B, 2, N // 128, 128))
    jstate = cg.init_state()

    xs = (rng.standard_normal((11, C_in, N)) * 0.5).astype(np.float32)
    # JAX alone up to a mid-stream state (tails filled, t past the ring)
    for xb in xs[:5]:
        jstate, _ = cg.step(jstate, jctrl, jbank, jnp.asarray(xb),
                            uniform=uniform)
    tstate = state_from_jax(np.asarray(jstate.prev_in),
                            np.asarray(jstate.ring),
                            np.asarray(jstate.eval_prev), jstate.t, CPU)
    tctrl = ctrl_from_jax(jctrl, CPU)
    tbank = bank_from_jax(np.asarray(jbank), CPU)
    assert tstate.eval_prev.shape == (tspec.n_casc, N)
    assert float(tstate.eval_prev.abs().max()) > 0

    for xb in xs[5:]:
        jstate, yj = cg.step(jstate, jctrl, jbank, jnp.asarray(xb),
                             uniform=uniform)
        tstate, yt = tcomp.step_impl(tspec, tstate, tctrl, tbank,
                                     torch.as_tensor(xb), uniform=uniform,
                                     uniform_delay=uniform)
        yj = np.asarray(yj)
        assert yt.shape == (C_out, N)
        np.testing.assert_allclose(yt.numpy(), yj, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(yj).max()))
        ej = np.asarray(jstate.eval_prev)
        np.testing.assert_allclose(tstate.eval_prev.numpy(), ej, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ej).max()))
    assert int(tstate.t) == int(jstate.t) == 11
    ring_j = np.asarray(jstate.ring).reshape(F, B, 2, N)
    np.testing.assert_allclose(tstate.ring.numpy(), ring_j, rtol=0,
                               atol=1e-6 * np.abs(ring_j).max())


def test_stage_loop_launches_the_unfused_mac_per_stage(rng, monkeypatch):
    """bench1 takes two MAC calls a block, with the stage's rows (read in
    place) and every filter's controls; the fused kernel is not called."""
    C_in, C_out, fin, in_edges, out_edges, coeff, delay = GRAPHS["bench1"]
    spec = build_graph_spec(N, B, C_in, C_out, fin, [False] * 6)
    ctrl = tcomp.make_ctrl(spec, np.ones((6, 2)), np.ones((2, 6)),
                           np.zeros(6), np.zeros(6), np.ones((6, B)),
                           device=CPU, fmix=np.ones((6, 6)))
    calls = []

    def spy(ring, bank, rows, coeff_idx, mask, t, uniform):
        calls.append((rows.tolist(), ring.shape[0], coeff_idx.shape[0]))
        return torch.zeros(rows.shape[0], 2, N)

    monkeypatch.setattr(tcomp, "mac", spy)
    monkeypatch.setattr(tcomp, "mac_mix", None)
    bank = torch.as_tensor(_bank(rng)[0])
    st = tcomp.init_state(spec, CPU)
    for _ in range(2):
        st, y = tcomp.step_impl(spec, st, ctrl, bank, torch.ones(2, N))
    assert calls == [([2, 3, 4, 5], 6, 6), ([0, 1], 6, 6)] * 2


def test_unsupported_graphs_still_raise():
    """Crossfade graphs (a crossfading cascade among them) and float64
    graphs (``float_bits: 64``) are supported; a real type the config
    language cannot name (float16) raises."""
    spec = build_graph_spec(N, B, 1, 1, [[], [0]], [False, True])
    assert spec.any_crossfade
    tcomp.check_supported(spec)
    spec = build_graph_spec(N, B, 1, 1, [[], [0]], [False, False],
                            real_dtype=np.float64)
    tcomp.check_supported(spec)
    spec = build_graph_spec(N, B, 1, 1, [[], [0]], [False, False],
                            real_dtype=np.float16)
    with pytest.raises(NotImplementedError, match="float32 and float64"):
        tcomp.check_supported(spec)


# (N, B, F, C_out, filter_inputs of filter 1 or None)
ROUTE_SHAPES = [
    (256, 4, 3, 3, None),
    (64, 4, 3, 3, None),          # K % 128 != 0: no Pallas kernel
    (128, 4, 3, 3, None),         # K < 256: no Pallas kernel
    (384, 4, 3, 3, None),
    (256, 4, 3, 3, [0]),          # a cascade
]


@pytest.mark.parametrize("fused_env", [None, "1", "0"])
def test_fused_mix_route_matches_jax(monkeypatch, fused_env):
    """The JAX package's ``_step_impl`` is traced (shapes only) with its
    fused kernel spied; the port's predicate must name the same route."""
    import brutefir_tpu.ops.pallas_mac as jpm
    if fused_env is None:
        monkeypatch.delenv("BRUTEFIR_TPU_FUSED_MIX", raising=False)
    else:
        monkeypatch.setenv("BRUTEFIR_TPU_FUSED_MIX", fused_env)
    taken = []
    orig = jpm.pallas_spectral_mac_mix

    def spy(*a, **k):
        taken.append(True)
        return orig(*a, **k)

    monkeypatch.setattr(jpm, "pallas_spectral_mac_mix", spy)
    seen = set()
    for n, b, f, c, f1 in ROUTE_SHAPES:
        fin = [[] for _ in range(f)]
        if f1 is not None:
            fin[1] = f1
        js = jax_spec(n, b, f, c, fin, [False] * f)
        ts = build_graph_spec(n, b, f, c, fin, [False] * f)
        cg = jcomp.CompiledGraph(js, mac="pallas-interpret")
        st = cg.init_state()
        ctrl = jcomp.make_ctrl(js, np.ones((f, f)), np.zeros((f, f)),
                               np.ones((c, f)), np.zeros(f), np.zeros(f),
                               np.ones((f, b)))
        bank = jnp.zeros((1,) + tuple(st.ring.shape[1:]), jnp.float32)
        taken.clear()
        jax.eval_shape(functools.partial(
            jcomp._step_impl, js, cg.mac, tiled=cg.tiled), st, ctrl, bank,
            jnp.zeros((f, n), jnp.float32))
        assert tcomp.fused_mix_route(ts) == bool(taken), (n, b, f, c, f1)
        seen.add(bool(taken))
    assert seen == ({False} if fused_env == "0" else {True, False})


@pytest.mark.parametrize("F,B_,K,C", [
    (26, 16, 8192, 26), (256, 16, 8192, 256), (100, 16, 8192, 256),
    (256, 16, 8320, 256), (4, 8, 65536, 2), (2, 8, 8192, 2),
    (512, 64, 16384, 512), (3, 4, 256, 3)])
def test_mix_fusable_matches_jax(F, B_, K, C):
    assert tcomp.mix_fusable(F, B_, K, C) == jax_mix_fusable(F, B_, K, C)


# --- engine level -----------------------------------------------------------

def bench1_config(tmp_path, name, N_, B_):
    """bench1_config's graph (the reference's 2 x 2 cascade benchmark) at
    N_ x B_ partitions, coefficient i the RAW float32 file h<i>.raw."""
    coeffs = "".join(
        f'coeff {i} {{ filename: "{tmp_path / f"h{i}.raw"}"; '
        f'format: "FLOAT_LE"; }};\n' for i in range(6))
    return f"""
float_bits: 32;
sampling_rate: 44100;
filter_length: {N_},{B_};
{coeffs}
input 0, 1 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: 2; }};
output 0, 1 {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "S24_4LE"; channels: 2; dither: false; }};
filter 0 {{ from_filters: 2, 5; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_filters: 3, 4; to_outputs: 1; coeff: 1; }};
filter 2 {{ from_inputs: 0; to_filters: 0; coeff: 2; }};
filter 3 {{ from_inputs: 0; to_filters: 1; coeff: 3; }};
filter 4 {{ from_inputs: 1; to_filters: 1; coeff: 4; }};
filter 5 {{ from_inputs: 1; to_filters: 0; coeff: 5; }};
"""


def _run_both(tmp_path, monkeypatch, make_text):
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    monkeypatch.setenv("BRUTEFIR_TPU_MAC", "pallas")
    js = JaxEngine(jax_parse_config(make_text("out_jax.raw"))).run_offline(
        batch_blocks=8)
    ts = Engine(parse_config(make_text("out_torch.raw")),
                device=CPU).run_offline()
    yj = np.fromfile(tmp_path / "out_jax.raw", "<i4").astype(np.int64)
    yt = np.fromfile(tmp_path / "out_torch.raw", "<i4").astype(np.int64)
    return js, ts, yj, yt


def _conv(x, h):
    return scipy.signal.fftconvolve(x, h.astype(np.float64))[:len(x)]


def test_engine_bench1_cascade_matches_jax_and_oracle(tmp_path, monkeypatch,
                                                      rng):
    import brutefir_tpu_torch.graph.compile as tc
    N_, B_ = 256, 4
    taps = [(rng.uniform(-1, 1, N_ * B_) * 0.03).astype(np.float32)
            for _ in range(6)]
    for i, h in enumerate(taps):
        h.astype("<f4").tofile(tmp_path / f"h{i}.raw")
    frames = N_ * 13 + 77            # a batch of 8, then the tail
    x = rng.integers(-(1 << 20), 1 << 20, (frames, 2)).astype("<i4")
    x.tofile(tmp_path / "in.raw")
    stages = []
    orig = tc.mac
    monkeypatch.setattr(tc, "mac", lambda ring, bank, rows, *a: (
        stages.append(rows.tolist()), orig(ring, bank, rows, *a))[1])
    js, ts, yj, yt = _run_both(
        tmp_path, monkeypatch,
        lambda name: bench1_config(tmp_path, name, N_, B_))
    assert ts["frames"] == js["frames"] == frames
    assert ts["blocks"] == js["blocks"] == 14
    assert stages == [[2, 3, 4, 5], [0, 1]] * 14
    assert yt.size == yj.size == frames * 2
    assert np.abs(yt - yj).max() <= 1
    x0, x1 = x[:, 0].astype(np.float64), x[:, 1].astype(np.float64)
    refs = (_conv(_conv(x0, taps[2]) + _conv(x1, taps[5]), taps[0]),
            _conv(_conv(x0, taps[3]) + _conv(x1, taps[4]), taps[1]))
    for y in (yt, yj):
        y = y.reshape(frames, 2)
        for c, ref in enumerate(refs):
            assert np.abs(ref).max() > 2 ** 16       # a real signal
            tol = 2e-5 * np.abs(ref).max() + 4.0
            assert np.abs(y[:, c] - ref).max() <= tol


def _single_stage_config(tmp_path, name, N_):
    return f"""
sampling_rate: 44100;
filter_length: {N_},4;
coeff 0 {{ filename: "{tmp_path / 'h0.raw'}"; format: "FLOAT_LE"; }};
coeff 1 {{ filename: "{tmp_path / 'h1.raw'}"; format: "FLOAT_LE"; }};
input 0, 1, 2 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: 3; }};
output 0, 1 {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "S24_4LE"; channels: 2; dither: false; }};
filter 0 {{ from_inputs: 0, 2/-3; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_inputs: 1; to_outputs: 1, 0/6; coeff: 1; delay: 1; }};
filter 2 {{ from_inputs: 2; to_outputs: 1; coeff: 0; }};
"""


@pytest.mark.parametrize("case,N_,env", [("xtc_like_k64", 64, None),
                                         ("fused_mix_off", 256, "0")])
def test_engine_single_stage_loop_matches_jax(tmp_path, monkeypatch, rng,
                                              case, N_, env):
    """A single stage that the JAX package runs through its stage loop
    (no Pallas kernel at K = 64, an xtc-like short partition; or the
    fused kernel turned off) takes the port's stage loop too."""
    import brutefir_tpu_torch.graph.compile as tc
    if env is not None:
        monkeypatch.setenv("BRUTEFIR_TPU_FUSED_MIX", env)
    for i in range(2):
        (rng.standard_normal(N_ * 4 - 5 * i) * 0.1).astype("<f4").tofile(
            tmp_path / f"h{i}.raw")
    frames = N_ * 21 + 9
    # outputs peak near 2^21, below the level where float32 rounds at
    # the LSB (ROADMAP queue 3)
    np.clip(np.round(rng.standard_normal((frames, 3)) * 2.0 ** 17),
            -(2 ** 23), 2 ** 23 - 1).astype("<i4").tofile(tmp_path / "in.raw")
    calls = {"mac": 0}
    orig = tc.mac

    def spy(*a):
        calls["mac"] += 1
        return orig(*a)

    monkeypatch.setattr(tc, "mac", spy)
    monkeypatch.setattr(tc, "mac_mix", None)
    js, ts, yj, yt = _run_both(
        tmp_path, monkeypatch,
        lambda name: _single_stage_config(tmp_path, name, N_))
    assert ts["frames"] == js["frames"] == frames
    assert calls["mac"] == ts["blocks"] == 22
    assert yt.size == yj.size == frames * 2
    assert np.abs(yj).max() > 2 ** 19
    assert np.abs(yt - yj).max() <= 1
