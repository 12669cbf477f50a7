"""Coefficient crossfade and its control path: the port against the JAX
package.

- Control: the same sequence of ``change_coeff``, ``change_filter_delay``,
  ``set_mute`` and ``coeff_final_mod_hooks`` through the JAX
  ``RuntimeControl`` and the port's; every snapshot equal field for field
  (through ``convert.ctrl_from_jax``), and ``snapshot_xfade``,
  ``snapshot_uniform`` and ``snapshot_uniform_delay`` equal, block by
  block, the block after each swap included.
- Step: the JAX ``CompiledGraph(spec, mac="pallas-interpret")`` stepping
  with ``xfade=True/False`` against the port's ``step_impl(...,
  xfade_now=...)``, 8 blocks at 256 x 4 with swaps: the fused time-domain
  crossfade (uniform and per-filter, and against the JAX package's two
  MAC passes under ``BRUTEFIR_TPU_DUAL_XFADE=0``), the stage loop on a
  single stage (the JAX side under ``BRUTEFIR_TPU_TD_XFADE=0``) and a
  crossfading first stage of bench1's cascade.
- Engine, file to file: a bench5-topology config (a CLI script flipping
  every filter's coefficient every block) through both engines and the
  port's ``__main__``; bench1's cascade with its first stage crossfading
  under a CLI script through both engines (the dual MAC on the swap
  blocks only); the port dispatching ``xfade`` exactly on a script's swap
  blocks; a swap staged between calls, run three ways
  (per-block ``run()``, a split batch, the EOF tail).

Tolerances: step outputs within 1e-5 of the JAX block's peak, the ring
within 1e-6 of its peak (tests/test_torch_cascade.py's bounds: float32
FFTs, mixes and sums in another order); S24 words within 1 LSB of the JAX
engine (docs/PARITY.md "Float-tolerance") and within 8e-6 of the output's
peak + 4 LSB of the float64 linear-ramp oracle (the bound of
tests/test_fullshape_parity.py::test_bench5_fullshape_crossfade_random_taps),
the cascade within 2e-5 of its peak + 4 LSB (tests/test_torch_cascade.py's
bench1 bound).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.signal
import torch

from brutefir_tpu.config import parse_config as jax_parse_config
from brutefir_tpu.graph import compile as jcomp
from brutefir_tpu.graph.spec import build_graph_spec as jax_spec
from brutefir_tpu.ops.partconv import make_bank, preprocess_coeffs
from brutefir_tpu.runtime.control import RuntimeControl as JaxControl
from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.config.model import OUT
from brutefir_tpu_torch.convert import bank_from_jax, ctrl_from_jax
from brutefir_tpu_torch.graph import compile as tcomp
from brutefir_tpu_torch.graph.spec import build_graph_spec
from brutefir_tpu_torch.runtime.control import RuntimeControl

N, B = 256, 4
CPU = torch.device("cpu")


# --- control -----------------------------------------------------------------

def _control_config(tmp_path):
    """Three filters, two crossfading, a cascade edge (fmix) and three
    coefficient sets of 4, 2 and 3 partitions."""
    rng = np.random.default_rng(3)
    for k, nb in enumerate((4, 2, 3)):
        (rng.standard_normal(N * nb) * 0.1).astype("<f4").tofile(
            tmp_path / f"c{k}.raw")
    coeffs = "".join(
        f'coeff {k} {{ filename: "{tmp_path / f"c{k}.raw"}"; '
        f'format: "FLOAT_LE"; }};\n' for k in range(3))
    return f"""
sampling_rate: 44100;
filter_length: {N},{B};
{coeffs}
input 0,1 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: 2; }};
output 0,1 {{ device: "file" {{ path: "{tmp_path / 'out.raw'}"; }}; sample: "S24_4LE"; channels: 2; dither: false; }};
filter 0 {{ from_inputs: 0/-2; to_outputs: 0; to_filters: 2; coeff: 0;
            crossfade: true; }};
filter 1 {{ from_inputs: 1; to_outputs: 1/3; coeff: 0; crossfade: true; }};
filter 2 {{ from_inputs: 0; from_filters: 0/-6; to_outputs: 1; coeff: 0; }};
"""


def _specs(conf_j, conf_t):
    out = []
    for conf, build in ((conf_j, jax_spec), (conf_t, build_graph_spec)):
        out.append(build(
            conf.filter_length, conf.n_blocks, conf.n_channels[0],
            conf.n_channels[1], [[s for s, _ in f.in_filters]
                                 for f in conf.filters],
            [f.crossfade for f in conf.filters]))
    return out


def test_control_snapshots_match_jax(tmp_path):
    text = _control_config(tmp_path)
    conf_j, conf_t = jax_parse_config(text), parse_config(text)
    jspec, tspec = _specs(conf_j, conf_t)
    jc, tc = JaxControl(conf_j, jspec), RuntimeControl(conf_t, tspec, CPU)

    def hook(n, c):                      # pins filter 1 to set 2 once set
        return 2 if n == 1 and c == 1 else None

    steps = [
        [],
        [("change_coeff", 0, 1)],                         # crossfade 0
        [],                                               # ... cleared
        [("change_coeff", 2, 1), ("change_coeff", 1, -1)],  # abrupt, xf 1
        [("change_filter_delay", 0, 1), ("set_mute", OUT, 1, True)],
        [("hooks", [hook]), ("change_coeff", 1, 1)],      # hook -> set 2
        [],
        [("change_coeff", 0, 0), ("change_coeff", 1, 0),
         ("change_coeff", 2, -5)],                        # -5 -> no coeff
        [("hooks", []), ("change_filter_delay", 0, 0)],
        [("set_mute", OUT, 1, False)],
    ]
    seen = set()
    for block, ops in enumerate(steps):
        for op in ops:
            for c in (jc, tc):
                if op[0] == "hooks":
                    c.coeff_final_mod_hooks = list(op[1])
                else:
                    getattr(c, op[0])(*op[1:])
        jctrl, tctrl = jc.snapshot(), tc.snapshot()
        conv = ctrl_from_jax(jctrl, CPU)
        for name in tctrl._fields:
            a, b = getattr(tctrl, name), getattr(conv, name)
            assert a.dtype == b.dtype and torch.equal(a, b), (block, name)
        flags = (tc.snapshot_xfade, tc.snapshot_uniform,
                 tc.snapshot_uniform_delay)
        assert flags == (jc.snapshot_xfade, jc.snapshot_uniform,
                         jc.snapshot_uniform_delay), block
        assert tc.prev_coeff == jc.prev_coeff
        assert tc.mute == jc.mute and tc.mute_version == jc.mute_version
        seen.add(flags)
    # every flag took both values over the sequence
    for i in range(3):
        assert {f[i] for f in seen} == {True, False}


def test_set_delay_and_subdelay_match_jax(tmp_path):
    """The channel delay and subdelay setters accept and refuse alike
    (no maxdelay: every runtime delay change is refused)."""
    text = _control_config(tmp_path)
    conf_j, conf_t = jax_parse_config(text), parse_config(text)
    jspec, tspec = _specs(conf_j, conf_t)
    jc, tc = JaxControl(conf_j, jspec), RuntimeControl(conf_t, tspec, CPU)
    for io in (0, 1):
        for ch in (-1, 0, 1, 2):
            for d in (-1, 0, 3):
                assert (tc.set_delay(io, ch, d)
                        == jc.set_delay(io, ch, d)), (io, ch, d)
            for sd in (-100, -5, 0, 7, 100):
                assert (tc.set_subdelay(io, ch, sd)
                        == jc.set_subdelay(io, ch, sd)), (io, ch, sd)
    assert tc.delay == jc.delay and tc.subdelay == jc.subdelay


# --- step ----------------------------------------------------------------------

def _bank(rng):
    """Three coefficient sets of 4, 3 and 2 partitions, and the dirac."""
    n_blocks = np.array([B, 3, 2, 1])
    entries = [preprocess_coeffs(
        (rng.standard_normal(N * n) * 0.05).astype(np.float32), N, B)
        for n in n_blocks[:3]]
    entries.append(preprocess_coeffs(np.array([1.0], np.float32), N, B))
    return make_bank(entries), n_blocks


# the reference's bench1_config: f2, f5 -> f0 -> out 0; f3, f4 -> f1
BENCH1 = (2, 2, [[2, 5], [3, 4], [], [], [], []],
          [(2, 0), (3, 0), (4, 1), (5, 1)], [(0, 0), (1, 1)])

# name: (topology or None for F = 3 single-stage, crossfade flags,
#        coefficient schedule per filter (A, B), uniform, the JAX side's
#        env, whether the port runs the fused time-domain crossfade)
STEP_CASES = {
    "fused_uniform": (None, [True] * 3, ([1] * 3, [0] * 3), True, {}, True),
    "fused_rows": (None, [True, True, False], ([0, 1, 2], [2, 0, 2]),
                   False, {}, True),
    # the port's stage loop on a single stage, its route predicate forced
    # (only cascades take it in use), against the JAX stage loop
    "stage_loop_single": (None, [True, True, False], ([0, 1, 2], [2, 0, 2]),
                          False, {"BRUTEFIR_TPU_TD_XFADE": "0"}, False),
    # the port's one dual kernel against the JAX package's two MAC passes
    "two_macs_fused": (None, [True, True, False], ([0, 1, 2], [2, 0, 2]),
                       False, {"BRUTEFIR_TPU_DUAL_XFADE": "0"}, True),
    "bench1_first_stage": (BENCH1, [False, False] + [True] * 4,
                           ([0, 1, 2, 0, 1, 2], [0, 1, 0, 1, 1, 2]),
                           False, {}, False),
}
# per block: which schedule entry is current (0 = A, 1 = B); a block whose
# entry differs from the one before crossfades its crossfade filters
SCHEDULE = [0, 0, 1, 1, 1, 0, 1, 1]


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_crossfade_step_matches_jax(rng, monkeypatch, case):
    topo, flags, (ca, cb), uniform, env, fused = STEP_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    F = len(flags)
    if topo is None:
        C_in = C_out = F
        fin = [[] for _ in range(F)]
        in_edges = [(f, f) for f in range(F)]
        out_edges = [(f, f) for f in range(F)] + [(0, 2)]
    else:
        C_in, C_out, fin, in_edges, out_edges = topo
    bank, n_blocks = _bank(rng)
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
    delay = np.zeros(F, np.int32)

    def ctrl_of(cur, prev):
        coeff = np.asarray((ca, cb)[cur], np.int32)
        pcoeff = np.asarray((ca, cb)[prev], np.int32)
        mask = (np.arange(B)[None, :] < n_blocks[coeff][:, None]).astype(
            np.float32)
        pmask = (np.arange(B)[None, :] < n_blocks[pcoeff][:, None]).astype(
            np.float32)
        xf = ((coeff != pcoeff) & np.asarray(flags)).astype(np.float32)
        return jcomp.make_ctrl(jspec, in_mix, fmix, out_mix, delay, coeff,
                               mask, coeff if not xf.any() else pcoeff,
                               mask if not xf.any() else pmask, xf), \
            bool(xf.any())

    jspec = jax_spec(N, B, C_in, C_out, fin, flags)
    tspec = build_graph_spec(N, B, C_in, C_out, fin, flags)
    tcomp.check_supported(tspec)
    assert tcomp.fused_xfade_route(tspec, True) == (topo is None)
    if not fused:
        monkeypatch.setattr(tcomp, "fused_xfade_route", lambda *a: False)
    assert not tcomp.fused_mix_route(tspec, True)
    assert tcomp.fused_mix_route(tspec, False) == (topo is None)
    cg = jcomp.CompiledGraph(jspec, mac="pallas-interpret")
    assert cg.mac == "pallas-interpret" and cg.tiled
    jbank = jnp.asarray(bank.reshape(bank.shape[0], B, 2, N // 128, 128))
    tbank = bank_from_jax(np.asarray(jbank), CPU)
    jstate = cg.init_state()
    tstate = tcomp.init_state(tspec, CPU)
    xs = (rng.standard_normal((len(SCHEDULE), C_in, N)) * 0.5).astype(
        np.float32)
    n_xf = 0
    for k, xb in enumerate(xs):
        jctrl, xf = ctrl_of(SCHEDULE[k], SCHEDULE[k - 1] if k else 0)
        n_xf += xf
        jstate, yj = cg.step(jstate, jctrl, jbank, jnp.asarray(xb),
                             uniform=uniform, xfade=xf)
        tstate, yt = tcomp.step_impl(tspec, tstate,
                                     ctrl_from_jax(jctrl, CPU), tbank,
                                     torch.as_tensor(xb), uniform=uniform,
                                     uniform_delay=True, xfade_now=xf)
        yj = np.asarray(yj)
        assert yt.shape == (C_out, N)
        np.testing.assert_allclose(yt.numpy(), yj, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(yj).max()),
                                   err_msg=f"block {k}")
    assert n_xf == 3
    ring_j = np.asarray(jstate.ring).reshape(F, B, 2, N)
    np.testing.assert_allclose(tstate.ring.numpy(), ring_j, rtol=0,
                               atol=1e-6 * np.abs(ring_j).max())
    if tspec.n_casc:
        ej = np.asarray(jstate.eval_prev)
        np.testing.assert_allclose(tstate.eval_prev.numpy(), ej, rtol=0,
                                   atol=1e-5 * np.abs(ej).max())


def test_crossfade_spectra_matches_jax(rng):
    from brutefir_tpu.ops import partconv as jpc
    from brutefir_tpu_torch.ops import partconv as tpc
    y_old = rng.standard_normal((3, 2, N)).astype(np.float32)
    y_new = rng.standard_normal((3, 2, N)).astype(np.float32)
    ref = np.asarray(jpc.crossfade_spectra(jnp.asarray(y_old),
                                           jnp.asarray(y_new), N))
    got = tpc.crossfade_spectra(torch.as_tensor(y_old),
                                torch.as_tensor(y_new), N).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    full = np.asarray(jpc.irfft_planes(jnp.asarray(y_new)))
    np.testing.assert_allclose(
        tpc.irfft_planes(torch.as_tensor(y_new)).numpy(), full, rtol=0,
        atol=1e-6 * np.abs(full).max())


# --- engine ----------------------------------------------------------------------

def _conv64(x, h):
    return scipy.signal.fftconvolve(x.astype(np.float64),
                                    h.astype(np.float64))[:len(x)]


def bench5_config(tmp_path, name, C, N_, B_):
    """The reference's bench5_config topology: C crossfading filters, in
    i -> filter i -> out i on coefficient 0, and a CLI script that sets
    every filter to set 0 on even blocks and to set 1 on odd ones (one
    script line a block)."""
    line0 = " ".join(f"cfc {i} 0;" for i in range(C))
    line1 = " ".join(f"cfc {i} 1;" for i in range(C))
    chans = ",".join(str(i) for i in range(C))
    filters = "".join(
        f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; coeff: 0; "
        f"crossfade: true; }};\n" for i in range(C))
    return f"""
sampling_rate: 44100;
filter_length: {N_},{B_};
logic: "cli" {{ script: "{line0}\n{line1}"; echo: false; }};
coeff 0 {{ filename: "{tmp_path / 'a.raw'}"; format: "FLOAT_LE"; }};
coeff 1 {{ filename: "{tmp_path / 'b.raw'}"; format: "FLOAT_LE"; }};
input {chans} {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: {C}; }};
output {chans} {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "S24_4LE"; channels: {C}; dither: false; }};
{filters}"""


def ramp_oracle(ya, yb, N_, n):
    """bench5's expected output: block 0 on set a, then odd blocks ramp
    a -> b and even blocks b -> a (test_fullshape_parity.py:296-313),
    the last block cut at n samples."""
    ramp = np.arange(N_, dtype=np.float64) / (N_ - 1)
    out = np.empty(n)
    for k in range(-(-n // N_)):
        seg = slice(k * N_, min(n, (k + 1) * N_))
        r = ramp[: seg.stop - seg.start]
        if k == 0:
            out[seg] = ya[seg]
        elif k % 2 == 1:
            out[seg] = ya[seg] * (1 - r) + yb[seg] * r
        else:
            out[seg] = yb[seg] * (1 - r) + ya[seg] * r
    return out


def test_bench5_engine_matches_jax_and_ramp_oracle(tmp_path, monkeypatch):
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.__main__ import main
    import brutefir_tpu_torch.graph.compile as tc
    C = 4
    rng = np.random.default_rng(21)
    taps = [(rng.uniform(-1, 1, N * B) * 0.02).astype(np.float32)
            for _ in range(2)]
    taps[0].tofile(tmp_path / "a.raw")
    taps[1].tofile(tmp_path / "b.raw")
    n = N * 12 + N // 2                  # the EOF block crossfades too
    x = rng.integers(-(1 << 20), 1 << 20, (n, C)).astype("<i4")
    x.tofile(tmp_path / "in.raw")
    monkeypatch.setenv("BRUTEFIR_TPU_MAC", "pallas")
    JaxEngine(jax_parse_config(bench5_config(
        tmp_path, "out_jax.raw", C, N, B))).run_offline(batch_blocks=8)
    calls = {"dual": 0}
    orig = tc.mac_dual

    def spy(*a):
        calls["dual"] += 1
        return orig(*a)

    monkeypatch.setattr(tc, "mac_dual", spy)
    cfg = tmp_path / "b5.conf"
    cfg.write_text(bench5_config(tmp_path, "out_torch.raw", C, N, B))
    assert main(["-quiet", "-nodefault", str(cfg)], device=CPU) == 0
    assert calls["dual"] == 12           # every block after block 0
    yj = np.fromfile(tmp_path / "out_jax.raw", "<i4").astype(np.int64)
    yt = np.fromfile(tmp_path / "out_torch.raw", "<i4").astype(np.int64)
    assert yt.size == yj.size == n * C
    assert np.abs(yt - yj).max() <= 1
    yt = yt.reshape(n, C)
    for c in range(C):
        ya, yb = _conv64(x[:, c], taps[0]), _conv64(x[:, c], taps[1])
        tol = 8e-6 * max(np.abs(ya).max(), np.abs(yb).max()) + 4.0
        assert np.abs(yt[:, c] - ramp_oracle(ya, yb, N, n)).max() <= tol
        assert np.abs(yt[:, c]).max() > 2 ** 18


def bench1_xfade_config(tmp_path, name, N_, B_, script):
    """bench1_config's cascade (f2, f5 -> f0 -> out 0; f3, f4 -> f1 ->
    out 1) with its first stage crossfading and a CLI script."""
    coeffs = "".join(
        f'coeff {i} {{ filename: "{tmp_path / f"h{i}.raw"}"; '
        f'format: "FLOAT_LE"; }};\n' for i in range(6))
    return f"""
sampling_rate: 44100;
filter_length: {N_},{B_};
logic: "cli" {{ script: "{script}"; echo: false; }};
{coeffs}
input 0, 1 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: 2; }};
output 0, 1 {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "S24_4LE"; channels: 2; dither: false; }};
filter 0 {{ from_filters: 2, 5; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_filters: 3, 4; to_outputs: 1; coeff: 1; }};
filter 2 {{ from_inputs: 0; to_filters: 0; coeff: 2; crossfade: true; }};
filter 3 {{ from_inputs: 0; to_filters: 1; coeff: 3; crossfade: true; }};
filter 4 {{ from_inputs: 1; to_filters: 1; coeff: 4; crossfade: true; }};
filter 5 {{ from_inputs: 1; to_filters: 0; coeff: 5; crossfade: true; }};
"""


# block 0 swaps every first-stage filter's set, block 3 swaps filters 2
# and 3 back, and so on every third block: crossfades on blocks 0, 3, 6,
# ... (all four filters on block 0, filters 2 and 3 after that)
CASCADE_SCRIPT = ("cfc 2 3; cfc 3 2; cfc 4 5; cfc 5 4; sleep b2\n"
                  "cfc 2 2; cfc 3 3; sleep b2")


def cascade_sets(k):
    """The coefficient set of filters 2-5 on block k (k = -1: the
    config's) under CASCADE_SCRIPT."""
    if k < 0:
        return [2, 3, 4, 5]
    return [3, 2, 5, 4] if (k // 3) % 2 == 0 else [2, 3, 5, 4]


def cascade_oracle(x, taps, N_, sets):
    """The float64 output of the crossfading cascade: each first-stage
    filter's output ramps linearly (arange(N) / (N - 1)) from its old set
    to its new one over a block where its set changes; ``sets(k)`` gives
    the sets of filters 2-5 on block k. Returns [frames, 2]."""
    n = x.shape[0]
    ramp = np.arange(N_, dtype=np.float64) / (N_ - 1)
    z = {}
    for j, (f, c) in enumerate(((2, 0), (3, 0), (4, 1), (5, 1))):
        ys = {h: _conv64(x[:, c], taps[h]) for h in range(2, 6)}
        out = np.empty(n)
        for k in range(-(-n // N_)):
            seg = slice(k * N_, min(n, (k + 1) * N_))
            old, new = sets(k - 1)[j], sets(k)[j]
            r = ramp[: seg.stop - seg.start]
            out[seg] = (ys[new][seg] if old == new
                        else ys[old][seg] * (1 - r) + ys[new][seg] * r)
        z[f] = out
    return np.stack([_conv64(z[2] + z[5], taps[0]),
                     _conv64(z[3] + z[4], taps[1])], axis=1)


def test_bench1_cascade_crossfade_engine_matches_jax(tmp_path, monkeypatch):
    """bench1's cascade whose first stage crossfades under a CLI script,
    file to file through the JAX engine and the port's: the port runs
    its stage loop's dual MAC + crossfade_spectra on exactly the swap
    blocks, within 1 LSB of the JAX engine and on the float64 oracle."""
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    import brutefir_tpu_torch.graph.compile as tc
    rng = np.random.default_rng(11)
    taps = [(rng.uniform(-1, 1, N * B) * 0.03).astype(np.float32)
            for _ in range(6)]
    for i, h in enumerate(taps):
        h.astype("<f4").tofile(tmp_path / f"h{i}.raw")
    frames = N * 13 + 77                 # block 12 swaps, 13 is the EOF
    x = rng.integers(-(1 << 20), 1 << 20, (frames, 2)).astype("<i4")
    x.tofile(tmp_path / "in.raw")
    monkeypatch.setenv("BRUTEFIR_TPU_MAC", "pallas")
    JaxEngine(jax_parse_config(bench1_xfade_config(
        tmp_path, "out_jax.raw", N, B, CASCADE_SCRIPT))).run_offline()
    calls = []
    for name in ("mac", "mac_dual"):
        orig = getattr(tc, name)
        monkeypatch.setattr(tc, name, lambda ring, bank, rows, *a, _o=orig,
                            _n=name: (calls.append((_n, rows.tolist())),
                                      _o(ring, bank, rows, *a))[1])
    stats = Engine(parse_config(bench1_xfade_config(
        tmp_path, "out_torch.raw", N, B, CASCADE_SCRIPT)),
        device=CPU).run_offline()
    assert stats["blocks"] == 14
    want = []
    for k in range(14):
        first = "mac_dual" if k % 3 == 0 else "mac"
        want += [(first, [2, 3, 4, 5]), ("mac", [0, 1])]
    assert calls == want
    yj = np.fromfile(tmp_path / "out_jax.raw", "<i4").astype(np.int64)
    yt = np.fromfile(tmp_path / "out_torch.raw", "<i4").astype(np.int64)
    assert yt.size == yj.size == frames * 2
    assert np.abs(yt - yj).max() <= 1
    ref = cascade_oracle(x, taps, N, cascade_sets)
    for c in range(2):
        assert np.abs(ref[:, c]).max() > 2 ** 16          # a real signal
        tol = 2e-5 * np.abs(ref[:, c]).max() + 4.0
        assert np.abs(yt.reshape(frames, 2)[:, c] - ref[:, c]).max() <= tol


def test_engine_dispatches_xfade_only_on_swap_blocks(tmp_path, monkeypatch):
    """The port's twin of tests/test_engine_e2e.py::
    test_engine_dispatches_xfade_program_only_on_swap_blocks: the step
    gets xfade=True exactly on the blocks whose script line swaps a
    coefficient, and a dirac <-> dirac crossfade stays the identity."""
    from brutefir_tpu_torch.runtime.device_io import DeviceIO
    from brutefir_tpu_torch.runtime.engine import Engine
    rng = np.random.default_rng(5)
    x = rng.integers(-(1 << 20), 1 << 20, (N * 8, 1)).astype("<i4")
    x.tofile(tmp_path / "in.raw")
    outp = tmp_path / "out.raw"
    # one newline-separated script line per block; ';' only joins commands
    # within a block: flips at blocks 2 and 5
    script = "ppk\nppk\ncfc 0 1\nppk\nppk\ncfc 0 0\nppk\nppk"
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
logic: "cli" {{ script: "{script}"; echo: false; }};
coeff 0 {{ filename: "dirac pulse"; }};
coeff 1 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S32_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }}; sample: "S32_LE"; channels: 1; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; crossfade: true; }};
""")
    keys = []
    orig = DeviceIO.step

    def spy(self, *a, **k):
        keys.append(k["xfade"])
        return orig(self, *a, **k)

    monkeypatch.setattr(DeviceIO, "step", spy)
    stats = Engine(conf, device=CPU).run_offline()
    assert stats["blocks"] == 8
    assert keys == [False, False, True, False, False, True, False, False]
    y = np.fromfile(outp, dtype="<i4")
    np.testing.assert_allclose(y, x[:, 0], atol=1)


def _swap_config(tmp_path, outp):
    return f"""
sampling_rate: 44100; filter_length: {N},2; show_progress: false;
coeff 0 {{ filename: "{tmp_path / 'c0.raw'}"; format: "FLOAT_LE"; }};
coeff 1 {{ filename: "{tmp_path / 'c1.raw'}"; format: "FLOAT_LE"; }};
input 0 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }};
           sample: "S24_4LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }};
            sample: "S24_4LE"; channels: 1; dither: false; }};
filter 0 {{ crossfade: true; from_inputs: 0; to_outputs: 0; coeff: 0; }};
"""


def _swap_run(eng, mode):
    """Four blocks, a swap to set 1, the rest: per block (``run``), as a
    full batch of 4 (the split dispatch), or as the EOF tail of a batch
    of 8."""
    eng.setup()
    try:
        if mode == "perblock":
            eng.run(max_blocks=4, setup=False)
            eng.control.change_coeff(0, 1)
            eng.run(setup=False)
        else:
            eng.run_offline(max_blocks=4, batch_blocks=4, setup=False)
            eng.control.change_coeff(0, 1)
            eng.run_offline(batch_blocks=4 if mode == "batch" else 8,
                            setup=False)
    finally:
        eng.teardown()


def test_swap_between_calls_crossfades_one_block(tmp_path, monkeypatch):
    """The port's twin of tests/test_composed_mutation.py::
    test_offline_xfade_crossfades_one_block: a swap staged between calls
    crossfades exactly one block whether the rest runs per block, as a
    split batch or as the EOF tail; the three outputs are byte-identical,
    within 1 LSB of the JAX engine's per-block run and on the ramp."""
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    import brutefir_tpu_torch.graph.compile as tc
    rng = np.random.default_rng(7)
    h = [(rng.uniform(-1, 1, N * 2) * 0.05).astype(np.float32)
         for _ in range(2)]
    for k in range(2):
        h[k].tofile(tmp_path / f"c{k}.raw")
    x = rng.integers(-(1 << 20), 1 << 20, 8 * N).astype("<i4")
    x.tofile(tmp_path / "in.raw")
    monkeypatch.setenv("BRUTEFIR_TPU_MAC", "pallas")
    jo = tmp_path / "o_jax.raw"
    _swap_run(JaxEngine(jax_parse_config(_swap_config(tmp_path, jo),
                                         "probe")), "perblock")
    calls = {"dual": 0}
    orig = tc.mac_dual

    def spy(*a):
        calls["dual"] += 1
        return orig(*a)

    monkeypatch.setattr(tc, "mac_dual", spy)
    outs = {}
    for mode in ("perblock", "batch", "tail"):
        outp = tmp_path / f"o_{mode}.raw"
        calls["dual"] = 0
        _swap_run(Engine(parse_config(_swap_config(tmp_path, outp)),
                         device=CPU), mode)
        assert calls["dual"] == 1, mode
        outs[mode] = outp.read_bytes()
    assert len(outs["perblock"]) == 8 * N * 4
    assert outs["batch"] == outs["perblock"] == outs["tail"]
    yt = np.frombuffer(outs["perblock"], "<i4").astype(np.int64)
    yj = np.fromfile(jo, "<i4").astype(np.int64)
    assert np.abs(yt - yj).max() <= 1
    ya, yb = _conv64(x, h[0]), _conv64(x, h[1])
    ramp = np.arange(N) / (N - 1)
    ref = np.concatenate([ya[:4 * N],
                          ya[4 * N:5 * N] * (1 - ramp)
                          + yb[4 * N:5 * N] * ramp, yb[5 * N:]])
    assert np.abs(yt - ref).max() <= 8e-6 * np.abs(ref).max() + 4.0
