"""``float_bits: 64``: the port's float64 path against the JAX package's.

The JAX package runs a float64 graph on its CPU backend with
``jax_enable_x64`` on, through its dense MAC (``mac = "jnp"``: its Pallas
kernels want float32) and ``jnp.fft``. The port runs the same routes with
the float64 forms of its unfused MAC and FFT glue (their plain versions
here, on the CPU):

- ops: the plain float64 ``mac`` (uniform and per-filter) and the glue
  route against ``spectral_mac_uniform`` / ``spectral_mac_rollh`` /
  ``rfft_planes`` / ``irfft_planes_valid`` at float64, 1e-12 relative; the
  glue's float64 table unrounded; the device codec and the dither on
  float64 blocks bit-equal to the JAX functions;
- routes: under float64 ``fused_mix_route`` is False and ``group_size`` 1
  (``BRUTEFIR_TPU_PAIR=force`` too); the float32-only wrappers raise on
  float64 operands; a crossfade block calls ``mac`` twice a crossfading
  stage and never ``mac_dual``;
- step: ``step_impl`` against the JAX ``CompiledGraph(mac="jnp")`` step
  from one mid-stream state (a single stage, a cascade, a crossfade block
  fused and in the stage loop), 1e-11 of the block's peak;
- engine, file to file against the JAX float64 engine: S24_4LE on the
  device codec path (max 1 LSB, >= 99.99% equal words, every word the
  float64 oracle's rounding), FLOAT64_LE on the host path (1e-11 of the
  peak), S32 at full scale on both paths (clips and meters included),
  dither (held to the float64 oracle), a crossfading cascade, and
  ``__main__.main`` on the CPU;
- ``convert``: a mid-stream float64 JAX state, controls and device-IO
  state carried over unrounded.

Every JAX call runs under ``x64()``, which restores ``jax_enable_x64`` as
it found it: the JAX engine turns it on for the whole process, and a
pytest worker runs other files after this one.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from brutefir_tpu.config import parse_config as jax_parse_config
from brutefir_tpu.graph import compile as jcomp
from brutefir_tpu.graph.spec import build_graph_spec as jax_spec
from brutefir_tpu.ops import partconv as jpc
from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.convert import (bank_from_jax, ctrl_from_jax,
                                        dstate_from_jax, state_from_jax)
from brutefir_tpu_torch.graph import compile as tcomp
from brutefir_tpu_torch.graph.spec import build_graph_spec
from brutefir_tpu_torch.ops import fft_glue as tg
from brutefir_tpu_torch.ops import mac as tm
from brutefir_tpu_torch.ops import partconv as tpc

N, B = 256, 4
CPU = torch.device("cpu")
F64 = torch.float64
REL_OPS = 1e-12          # plain float64 ops against the JAX package's
REL_STEP = 1e-11         # several blocks of the step, of the block's peak
REL_FLOAT = 1e-11        # FLOAT64_LE engine outputs, of the peak
WORD_GATE = 0.5 + 1e-6   # |S24 word - float64 oracle|: the oracle's rounding


@contextlib.contextmanager
def x64():
    """``jax_enable_x64`` on for the block, then as it was found."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


# --- ops ---------------------------------------------------------------------

def _mac_inputs(rng, F, E):
    ring = rng.standard_normal((F, B, 2, N))
    bank = rng.standard_normal((E, B, 2, N))
    idx = rng.integers(0, E, F).astype(np.int32)
    mask = np.ones((F, B))
    mask[1, 2:] = 0.0                        # a cblocks clamp
    return ring, bank, idx, mask


@pytest.mark.parametrize("uniform", [True, False])
def test_plain_mac_f64_matches_jax(rng, uniform):
    F, E = 5, 3
    ring, bank, idx, mask = _mac_inputs(rng, F, E)
    rows = np.array([4, 1, 2], np.int32)
    for t in (0, 3, 9):
        got = tm.mac(torch.as_tensor(ring), torch.as_tensor(bank),
                     torch.as_tensor(rows), torch.as_tensor(idx),
                     torch.as_tensor(mask),
                     torch.tensor(t, dtype=torch.int32), uniform)
        assert got.dtype == F64
        fn = jpc.spectral_mac_uniform if uniform else jpc.spectral_mac_rollh
        with x64():
            ref = np.asarray(fn(jnp.asarray(ring[rows]), jnp.asarray(bank),
                                jnp.asarray(idx[rows]),
                                jnp.asarray(mask[rows]), jnp.int32(t)))
        assert ref.dtype == np.float64
        assert _rel(got.numpy(), ref) <= REL_OPS


@pytest.mark.parametrize("route", ["rfft", "irfft_valid", "irfft"])
def test_glue_route_f64_matches_jax(rng, route):
    M = N
    if route == "rfft":
        x = rng.standard_normal((3, 2 * M))
        got = tpc.rfft_planes(torch.as_tensor(x)).numpy()
        with x64():
            ref = np.asarray(jpc.rfft_planes(jnp.asarray(x)))
    else:
        p = rng.standard_normal((3, 2, M))
        fn = {"irfft_valid": (tpc.irfft_planes_valid,
                              jpc.irfft_planes_valid),
              "irfft": (tpc.irfft_planes, jpc.irfft_planes)}[route]
        got = fn[0](torch.as_tensor(p)).numpy()
        with x64():
            ref = np.asarray(fn[1](jnp.asarray(p)))
    assert got.dtype == ref.dtype == np.float64
    assert _rel(got, ref) <= REL_OPS


def test_glue_f64_table_is_not_rounded():
    """The float64 combine table is numpy's float64 one; float32 rounds
    it once; the float64 glue against numpy's rfft is at float64's own
    rounding (a float32 table would leave 1e-7)."""
    M = 64
    for fwd in (True, False):
        t64 = tg.ab_table(M, fwd, CPU, F64)
        t32 = tg.ab_table(M, fwd, CPU)
        assert t64.dtype == F64 and t32.dtype == torch.float32
        assert torch.equal(t64.to(torch.float32), t32)
        assert float((t64 - t32.double()).abs().max()) > 1e-10
    x = np.random.default_rng(3).standard_normal((2, 2 * M))
    X = np.fft.rfft(x)
    ref = np.stack([np.concatenate([X[:, :1].real, X[:, 1:M].real], 1),
                    np.concatenate([X[:, M:].real, X[:, 1:M].imag], 1)], 1)
    got = tpc.rfft_planes(torch.as_tensor(x)).numpy()
    assert _rel(got, ref) <= 1e-14
    assert tg.launches["glue_fwd_f64"] == 0


@pytest.mark.parametrize("imin,imax", [(-(1 << 23), (1 << 23) - 1),
                                       (-(1 << 31), (1 << 31) - 1)])
def test_device_codec_f64_matches_jax(rng, imin, imax):
    """quantize_nd_exact and encode_words on float64 blocks, S32 at full
    scale included: words, clip flags and meters bit-equal to the JAX
    functions under x64 (its float32-derived thresholds cast up)."""
    from brutefir_tpu.ops import device_codec as jdc
    from brutefir_tpu_torch.core.sampleformat import parse_sample_format
    from brutefir_tpu_torch.ops import device_codec as tdc
    y = rng.standard_normal((3, 512)) * imax * 0.7
    edge = np.array([imax - 0.5, imax - 0.25, imax + 0.4, imax + 0.5,
                     imin - 0.5, imin - 0.49, imin + 0.5, 2.5, -2.5, -0.5])
    y[0, :edge.size] = edge
    y[1, :64] = imax * 1.2                    # clipping
    got = tdc.quantize_nd_exact(torch.as_tensor(y), imin, imax)
    with x64():
        ref = jdc.quantize_nd_exact(jnp.asarray(y), imin, imax)
        ref = [np.asarray(r) for r in ref]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)
    fmt = parse_sample_format("S24_4LE" if imax < 1 << 24 else "S32_LE")
    sel = np.array([0, 2, 1])
    words, meters = tdc.encode_words(torch.as_tensor(y), fmt, sel, 4,
                                     torch.int32)
    with x64():
        jw, jm = jdc.encode_words(jnp.asarray(y), fmt, sel, 4, np.int32)
        jw, jm = np.asarray(jw), np.asarray(jm)
    np.testing.assert_array_equal(words.numpy(), jw)
    assert meters.dtype == F64 and jm.dtype == np.float64
    np.testing.assert_array_equal(meters.numpy(), jm)
    assert meters[1, 0] >= 64


def test_dither_f64_matches_jax():
    """dither_quantize on float64 blocks: words, feedback and meters
    bit-equal to the JAX function under x64, as in float32."""
    from brutefir_tpu.ops import device_dither as jdd
    from brutefir_tpu_torch.core import dither as tdither
    from brutefir_tpu_torch.ops import device_dither as tdd
    rng = np.random.default_rng(9)
    C, n = 3, 512
    imin, imax = -(1 << 15), (1 << 15) - 1
    x = rng.standard_normal((C, n)) * 3000.0
    x[0, :40] = imax + 0.25
    table = tdither.DitherTable(C, 2000, 0, n, dtype=np.float64)
    ptr = np.array([j * table.spacing + 1 for j in range(C)], np.int32)
    last = table.tab[ptr - 1].astype(np.int32)
    d, _, _ = tdd.dither_window(torch.as_tensor(table.tab),
                                torch.as_tensor(table.randmap),
                                torch.as_tensor(ptr), torch.as_tensor(last),
                                n, table.size)
    assert d.dtype == F64
    sf = rng.uniform(-1, 1, (C, 2))
    got = tdd.dither_quantize(torch.as_tensor(x), d, torch.as_tensor(sf),
                              imin, imax)
    with x64():
        ref = jdd.dither_quantize(jnp.asarray(x), jnp.asarray(d.numpy()),
                                  jnp.asarray(sf), imin, imax)
        ref = [np.asarray(r) for r in ref]
    for g, r in zip(got, ref):
        assert g.numpy().dtype == r.dtype
        np.testing.assert_array_equal(g.numpy(), r)
    assert got[1].dtype == got[2].dtype == F64


# --- routes ------------------------------------------------------------------

def _spec(fin, xf, C_in=2, C_out=2, rd=np.float64, NN=N):
    return build_graph_spec(NN, B, C_in, C_out, fin, xf, real_dtype=rd)


def test_f64_routes_leave_the_float32_kernels(monkeypatch):
    """A float64 single stage that the float32 graph sends to the fused
    MAC + mix takes the stage loop; the grouped dispatch never groups."""
    f32 = _spec([[], []], [False, False], rd=np.float32, NN=8192)
    f64 = _spec([[], []], [False, False], NN=8192)
    assert tcomp.fused_mix_route(f32) and not tcomp.fused_mix_route(f64)
    assert tcomp.fused_xfade_route(_spec([[], []], [True, False]), True)
    big32 = build_graph_spec(8192, 16, 256, 256, [[]] * 256, [False] * 256)
    big64 = build_graph_spec(8192, 16, 256, 256, [[]] * 256, [False] * 256,
                             real_dtype=np.float64)
    assert tcomp.group_size(big32, 8) == 4
    assert tcomp.group_size(big64, 8) == 1
    for env in ("force", "force:4"):
        monkeypatch.setenv("BRUTEFIR_TPU_PAIR", env)
        assert tcomp.group_size(f32, 8) >= 2
        assert tcomp.group_size(f64, 8) == 1
    monkeypatch.setenv("BRUTEFIR_TPU_PAIR", "2")
    assert tcomp.group_size(big32, 8) == 2
    assert tcomp.group_size(big64, 8) == 1
    assert tcomp.init_state(f64, CPU).ring.dtype == F64


def test_float32_only_kernels_refuse_float64():
    from brutefir_tpu_torch.ops import fft_fused as tf
    from brutefir_tpu_torch.ops import mac_dual as td
    from brutefir_tpu_torch.ops import mac_group as mg
    from brutefir_tpu_torch.ops import mac_mix as mm
    F, E, K = 3, 2, 256
    ring = torch.zeros(F, B, 2, K, dtype=F64)
    bank = torch.zeros(E, B, 2, K, dtype=F64)
    idx = torch.zeros(F, dtype=torch.int32)
    mask = torch.ones(F, B, dtype=F64)
    t = torch.tensor(0, dtype=torch.int32)
    w = torch.zeros(2, F, dtype=F64)
    rows = torch.arange(F, dtype=torch.int32)
    xnews = torch.zeros(F, 1, 2, K, dtype=F64)
    delay = torch.zeros(F, dtype=torch.int32)
    calls = [lambda: mm.mac_mix(ring, bank, idx, mask, t, w, True),
             lambda: mg.mac_group(ring, xnews, bank, idx, mask, t, delay),
             lambda: mg.mac_mix_group(ring, xnews, bank, idx, mask, t, w,
                                      delay),
             lambda: td.mac_dual(ring, bank, rows, idx, mask, idx, mask, t,
                                 False),
             lambda: tf.rfft_planes_fused(torch.zeros(2, 2 * K, dtype=F64))]
    for call in calls:
        with pytest.raises(ValueError):
            call()
    # the unfused MAC takes them, and keeps their dtype
    assert tm.mac(ring, bank, rows, idx, mask, t, True).dtype == F64
    with pytest.raises(TypeError):
        tm.mac(ring, bank.float(), rows, idx, mask, t, True)


class _Spy:
    """Records the step's kernel wrapper calls; ``mac`` runs for real."""

    def __init__(self, monkeypatch):
        self.calls = []

        def mac(ring, bank, rows, idx, mask, t, uniform):
            self.calls.append(("mac", tuple(rows.tolist())))
            return tm.mac(ring, bank, rows, idx, mask, t, uniform)

        def never(name):
            def fn(*a, **k):
                raise AssertionError(f"{name} called under float64")
            return fn

        monkeypatch.setattr(tcomp, "mac", mac)
        for name in ("mac_dual", "mac_mix", "mac_group", "mac_mix_group"):
            monkeypatch.setattr(tcomp, name, never(name))


# --- step --------------------------------------------------------------------

# name: (C_in, C_out, filter_inputs, in edges (f, c), out edges (c, f),
#        crossfade flags, coefficient sets A and B, uniform, fused route)
STEP_CASES = {
    "single": (2, 2, [[], [], []], [(0, 0), (1, 1), (2, 0)],
               [(0, 0), (1, 1), (0, 2)], [False] * 3, ([0, 1, 2], None),
               False, False),
    "single_uniform": (2, 2, [[], []], [(0, 0), (1, 1)], [(0, 0), (1, 1)],
                       [False] * 2, ([1, 1], None), True, False),
    # bench1's topology: two stages
    "cascade": (2, 2, [[2, 5], [3, 4], [], [], [], []],
                [(2, 0), (3, 0), (4, 1), (5, 1)], [(0, 0), (1, 1)],
                [False] * 6, ([0, 1, 2, 0, 1, 2], None), False, False),
    "xfade_fused": (3, 3, [[], [], []], [(0, 0), (1, 1), (2, 2)],
                    [(0, 0), (1, 1), (2, 2), (0, 2)], [True, True, False],
                    ([0, 1, 2], [2, 0, 2]), False, True),
    "xfade_fused_uniform": (2, 2, [[], []], [(0, 0), (1, 1)],
                            [(0, 0), (1, 1)], [True, True],
                            ([0, 0], [1, 1]), True, True),
    "xfade_stage_loop": (2, 2, [[2, 5], [3, 4], [], [], [], []],
                         [(2, 0), (3, 0), (4, 1), (5, 1)], [(0, 0), (1, 1)],
                         [False, False] + [True] * 4,
                         ([0, 1, 2, 0, 1, 2], [0, 1, 0, 1, 1, 2]),
                         False, False),
}
SCHEDULE = [0, 0, 1, 1, 1, 0, 1, 1]


def _bank64(rng):
    """Three float64 coefficient sets of 4, 3 and 2 partitions."""
    n_blocks = np.array([B, 3, 2])
    return jpc.make_bank([jpc.preprocess_coeffs(
        rng.standard_normal(N * n) * 0.05, N, B, dtype=np.float64)
        for n in n_blocks]), n_blocks


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_f64_matches_jax(rng, monkeypatch, case):
    C_in, C_out, fin, in_edges, out_edges, flags, (ca, cb), uniform, \
        fused = STEP_CASES[case]
    F = len(fin)
    bank, n_blocks = _bank64(rng)
    assert bank.dtype == np.float64
    in_mix = np.zeros((F, C_in))
    for f, c in in_edges:
        in_mix[f, c] = rng.uniform(0.5, 1.5)
    fmix = np.zeros((F, F))
    for f, srcs in enumerate(fin):
        for s in srcs:
            fmix[f, s] = rng.uniform(0.5, 1.5)
    out_mix = np.zeros((C_out, F))
    for c, f in out_edges:
        out_mix[c, f] = rng.uniform(0.5, 1.5)
    delay = np.zeros(F, np.int32)
    sets = (ca, cb if cb is not None else ca)
    tspec = build_graph_spec(N, B, C_in, C_out, fin, flags,
                             real_dtype=np.float64)
    assert tcomp.fused_xfade_route(tspec, True) == fused
    assert not tcomp.fused_mix_route(tspec, False)
    spy = _Spy(monkeypatch)

    with x64():
        jspec = jax_spec(N, B, C_in, C_out, fin, flags,
                         real_dtype=np.float64)

        def ctrl_of(cur, prev):
            coeff = np.asarray(sets[cur], np.int32)
            pcoeff = np.asarray(sets[prev], np.int32)
            mask = (np.arange(B)[None] < n_blocks[coeff][:, None]) * 1.0
            pmask = (np.arange(B)[None] < n_blocks[pcoeff][:, None]) * 1.0
            xf = ((coeff != pcoeff) & np.asarray(flags)) * 1.0
            return jcomp.make_ctrl(jspec, in_mix, fmix, out_mix, delay,
                                   coeff, mask,
                                   coeff if not xf.any() else pcoeff,
                                   mask if not xf.any() else pmask,
                                   xf), bool(xf.any())

        cg = jcomp.CompiledGraph(jspec, mac="pallas-interpret")
        assert cg.mac == "jnp" and not cg.tiled
        jbank = jnp.asarray(bank)
        jstate = cg.init_state()
        assert jstate.ring.dtype == jnp.float64
        xs = rng.standard_normal((len(SCHEDULE), C_in, N)) * 0.5
        # JAX alone up to a mid-stream state; the port from its copy
        for k in range(3):
            jctrl, xf = ctrl_of(SCHEDULE[k], SCHEDULE[k - 1] if k else 0)
            jstate, _ = cg.step(jstate, jctrl, jbank, jnp.asarray(xs[k]),
                                uniform=uniform, xfade=xf)
        tstate = state_from_jax(np.asarray(jstate.prev_in),
                                np.asarray(jstate.ring),
                                np.asarray(jstate.eval_prev), jstate.t, CPU)
        tbank = bank_from_jax(np.asarray(jbank), CPU)
        n_xf = 0
        for k in range(3, len(SCHEDULE)):
            jctrl, xf = ctrl_of(SCHEDULE[k], SCHEDULE[k - 1])
            if cb is None:
                assert not xf
            n_xf += xf
            jstate, yj = cg.step(jstate, jctrl, jbank, jnp.asarray(xs[k]),
                                 uniform=uniform, xfade=xf)
            spy.calls.clear()
            tstate, yt = tcomp.step_impl(
                tspec, tstate, ctrl_from_jax(jctrl, CPU), tbank,
                torch.as_tensor(xs[k]), uniform=uniform,
                uniform_delay=True, xfade_now=xf)
            yj = np.asarray(yj)
            assert yt.dtype == F64 and yt.shape == (C_out, N)
            assert _rel(yt.numpy(), yj) <= REL_STEP, k
            # one mac a stage, and one more a crossfading stage on a
            # crossfade block (the old set's)
            want = sum(1 + (xf and st.any_crossfade)
                       for st in tspec.stages)
            assert len(spy.calls) == want, (k, spy.calls)
        ring_j = np.asarray(jstate.ring)
        assert _rel(tstate.ring.numpy(), ring_j) <= REL_STEP
        if tspec.n_casc:
            assert _rel(tstate.eval_prev.numpy(),
                        np.asarray(jstate.eval_prev)) <= REL_STEP
    assert n_xf == (2 if cb is not None else 0)


# --- engine ------------------------------------------------------------------

def _taps_file(path, n, seed, scale=0.1):
    taps = np.random.default_rng(seed).standard_normal(n) * scale
    path.write_text("\n".join(repr(float(v)) for v in taps) + "\n")
    return taps


def _engine_config(tmp_path, name, fin, fout, C=3, coeffs=(0, 1, 0),
                   extra="", float_bits=64, dither=False, delays=None):
    chans = ",".join(str(c) for c in range(C))
    sets = "".join(
        f'coeff {k} {{ filename: "{tmp_path / f"c{k}.txt"}"; '
        f'format: "TEXT"; }};\n' for k in sorted(set(coeffs)))
    filters = "".join(
        f"filter {f} {{ from_inputs: {f}; to_outputs: {f}; coeff: {c}; "
        + (f"delay: {delays[f]}; " if delays else "") + "};\n"
        for f, c in enumerate(coeffs))
    return f"""
sampling_rate: 44100;
float_bits: {float_bits};
filter_length: {N},{B};
{sets}
input {chans} {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "{fin}"; channels: {C}; }};
output {chans} {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "{fout}"; channels: {C}; dither: {str(dither).lower()}; }};
{filters}{extra}"""


# each file format's numpy word
_DT = {"S24_4LE": "<i4", "S32_LE": "<i4", "S32_BE": ">i4",
       "FLOAT64_LE": "<f8", "FLOAT_LE": "<f4", "S16_LE": "<i2"}


def _write_input(path, frames, C, fmt, seed, std=2.0 ** 18):
    """A seeded input file; its samples as float64 [frames, C]."""
    x = np.random.default_rng(seed).standard_normal((frames, C)) * std
    if fmt.startswith("S"):
        top = 2.0 ** (23 if fmt == "S24_4LE" else 31)
        x = np.clip(np.round(x), -top, top - 1)
    x = x.astype(_DT[fmt])
    x.tofile(path)
    return x.astype(np.float64)


def _run_both(tmp_path, make_text, fout, C):
    """The JAX float64 engine and the port's on one config; the outputs
    as float64 [frames, C]."""
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    with x64():
        jeng = JaxEngine(jax_parse_config(make_text("out_jax.raw")))
        assert jeng.rd == np.float64 and jeng.cg.mac == "jnp"
        jeng.run_offline()
    teng = Engine(parse_config(make_text("out_torch.raw")), device=CPU)
    assert teng.state.ring.dtype == F64 and teng.bank.dtype == F64
    teng.run_offline()
    yj, yt = (np.fromfile(tmp_path / n, _DT[fout]).astype(np.float64)
              .reshape(-1, C) for n in ("out_jax.raw", "out_torch.raw"))
    return jeng, teng, yj, yt


def _oracle(x, taps_of, C):
    return np.stack([scipy.signal.fftconvolve(x[:, c], taps_of(c))
                     [:len(x)] for c in range(C)], axis=1)


def test_engine_s24_device_path_matches_jax_and_oracle(tmp_path):
    """S24_4LE on the device codec path: within 1 LSB of the JAX float64
    engine, >= 99.99% of the words equal, and every word the float64
    oracle's rounding (the float32 engine misses that gate). Filter 1 is
    a block late: the JAX package's scanned device-IO step fails under
    x64 when every filter shares one delay (its dynamic_update_slice
    takes int64 and int32 indices, brutefir_tpu/graph/compile.py:271)."""
    C, frames = 3, N * 11 + 101
    taps = [_taps_file(tmp_path / "c0.txt", N * B, 1),
            _taps_file(tmp_path / "c1.txt", N * 2 + 17, 2)]
    x = _write_input(tmp_path / "in.raw", frames, C, "S24_4LE", 11)

    def make_text(name, bits=64):
        return _engine_config(tmp_path, name, "S24_4LE", "S24_4LE",
                              float_bits=bits, delays=(0, 1, 0))

    jeng, teng, yj, yt = _run_both(tmp_path, make_text, "S24_4LE", C)
    assert teng.dio is not None and teng.dio.rd == F64
    assert yt.shape == (frames, C)
    assert np.abs(yt - yj).max() <= 1
    assert np.mean(yt == yj) >= 0.9999
    late = np.concatenate([np.zeros(N), taps[1]])
    ref = _oracle(x, lambda c: (taps[0], late, taps[0])[c], C)
    err64 = np.abs(yt - ref).max()
    assert err64 <= WORD_GATE, err64
    assert np.abs(ref).max() > 2 ** 20
    # the same config in float32: off the oracle's rounding
    from brutefir_tpu_torch.runtime.engine import Engine
    Engine(parse_config(make_text("out32.raw", 32)),
           device=CPU).run_offline()
    y32 = np.fromfile(tmp_path / "out32.raw", "<i4").reshape(-1, C)
    err32 = np.abs(y32 - ref).max()
    print(f"S24 words vs the float64 oracle: float64 {err64:.6f}, "
          f"float32 {err32:.6f} LSB")
    assert err32 > WORD_GATE


def test_engine_float64_host_path_matches_jax(tmp_path):
    """FLOAT64_LE devices have no device codec: the host path, within
    1e-11 of the peak of the JAX float64 engine and of the oracle."""
    C, frames = 3, N * 9 + 57
    taps = [_taps_file(tmp_path / "c0.txt", N * B, 3),
            _taps_file(tmp_path / "c1.txt", N * 3, 4)]
    x = _write_input(tmp_path / "in.raw", frames, C, "FLOAT64_LE", 5, 0.3)

    def make_text(name):
        return _engine_config(tmp_path, name, "FLOAT64_LE", "FLOAT64_LE")

    jeng, teng, yj, yt = _run_both(tmp_path, make_text, "FLOAT64_LE", C)
    assert teng.dio is None
    peak = np.abs(yj).max()
    assert np.abs(yt - yj).max() <= REL_FLOAT * peak
    ref = _oracle(x, lambda c: taps[(0, 1, 0)[c]], C)
    assert np.abs(yt - ref).max() <= REL_FLOAT * np.abs(ref).max()


@pytest.mark.parametrize("fmt", ["S32_LE", "S32_BE"])
def test_engine_s32_full_scale_matches_jax(tmp_path, fmt):
    """S32 at full scale, the device codec path (S32_LE) and the host
    path (S32_BE): words within 1 LSB of the JAX float64 engine, the
    clipped samples and the overflow meters equal."""
    C, frames = 2, N * 7 + 33
    (tmp_path / "c0.txt").write_text("1.3\n")     # a gain past full scale
    _taps_file(tmp_path / "c1.txt", N * 2, 7)
    _write_input(tmp_path / "in.raw", frames, C, fmt, 8, std=2.0 ** 30)

    def make_text(name):
        return _engine_config(tmp_path, name, fmt, fmt, C=C, coeffs=(0, 1))

    jeng, teng, yj, yt = _run_both(tmp_path, make_text, fmt, C)
    assert (teng.dio is None) == (fmt == "S32_BE")
    assert np.abs(yt - yj).max() <= 1
    full = (yj == 2 ** 31 - 1) | (yj == -2 ** 31)
    assert full.sum() > 100 and np.array_equal(full, (
        yt == 2 ** 31 - 1) | (yt == -2 ** 31))
    for ot, oj in zip(teng.overflow, jeng.overflow):
        assert ot.n_overflows == oj.n_overflows > 0


def test_engine_dither_f64_holds_the_oracle(tmp_path):
    """Dithered S16_LE outputs on the device path in float64: within 5
    LSB of the float64 oracle, the error's RMS in the dither band (plain
    rounding gives 0.29)."""
    from brutefir_tpu_torch.runtime.engine import Engine
    C, frames = 2, N * 16
    taps = _taps_file(tmp_path / "c0.txt", N * B, 9)
    x = _write_input(tmp_path / "in.raw", frames, C, "S24_4LE", 10)
    text = _engine_config(tmp_path, "out.raw", "S24_4LE", "S16_LE", C=C,
                          coeffs=(0, 0), dither=True)
    teng = Engine(parse_config(text), device=CPU)
    assert teng.dio is not None and teng.dio.dstate["sf"].dtype == F64
    teng.run_offline()
    y = np.fromfile(tmp_path / "out.raw", "<i2").reshape(-1, C)
    ref = _oracle(x, lambda c: taps, C) / 2 ** 8   # S24 in, S16 out
    err = y - ref
    assert np.abs(ref).max() > 2 ** 12
    assert np.abs(err).max() <= 5
    rms = np.sqrt(np.mean(err ** 2))
    assert 0.5 <= rms <= 2.0, rms


def test_engine_crossfading_cascade_matches_jax(tmp_path):
    """A cascade whose first filter crossfades under a CLI script (the
    shape of test_torch_import's ``float_cascade_crossfade`` text):
    FLOAT_LE outputs equal to the JAX float64 engine's within one float32
    ulp of the peak; the step calls mac twice on the swap blocks' first
    stage."""
    C, frames = 2, N * 10
    _taps_file(tmp_path / "c0.txt", N * 3, 12)
    _taps_file(tmp_path / "c1.txt", N * 2, 13)
    _write_input(tmp_path / "in.raw", frames, C, "FLOAT_LE", 14, 0.3)
    script = "sleep b2\\ncfc a 1; sleep b3\\ncfc a 0\\nsleep b99"

    def make_text(name):
        return f"""
sampling_rate: 44100;
filter_length: {N},{B};
float_bits: 64;
coeff 0 {{ filename: "{tmp_path / 'c0.txt'}"; format: "TEXT"; }};
coeff 1 {{ filename: "{tmp_path / 'c1.txt'}"; format: "TEXT"; }};
input 0,1 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "FLOAT_LE"; channels: 2; }};
output 0,1 {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "FLOAT_LE"; channels: 2; dither: false; }};
filter "a" {{ from_inputs: 0; to_filters: "b"; coeff: 0; crossfade: true; }};
filter "b" {{ from_filters: "a"; to_outputs: 0, 1; coeff: -1; }};
logic: "cli" {{ script: "{script}"; echo: false; }};
"""

    jeng, teng, yj, yt = _run_both(tmp_path, make_text, "FLOAT_LE", C)
    peak = np.abs(yj).max()
    assert peak > 0.1
    assert np.abs(yt - yj).max() <= peak * 2.0 ** -23


def test_engine_crossfade_calls_mac_twice(tmp_path, monkeypatch):
    """bench5's topology in float64 (every filter crossfading, a CLI
    script flipping the sets every block): the fused time-domain
    crossfade with two mac calls a crossfade block, never mac_dual."""
    from brutefir_tpu_torch.runtime.engine import Engine
    C, frames = 3, N * 6
    _taps_file(tmp_path / "c0.txt", N * 3, 15)
    _taps_file(tmp_path / "c1.txt", N * 2, 16)
    _write_input(tmp_path / "in.raw", frames, C, "FLOAT64_LE", 17, 0.3)
    script = "\\n".join("; ".join(f"cfc {f} {(k + 1) % 2}" for f in range(C))
                         for k in range(6))
    extra = (f'logic: "cli" {{ script: "{script}"; echo: false; }};\n')
    text = _engine_config(tmp_path, "out.raw", "FLOAT64_LE", "FLOAT64_LE",
                          C=C, coeffs=(0, 1, 0), extra=extra)
    text = text.replace("coeff: 0; }", "coeff: 0; crossfade: true; }")
    spy = _Spy(monkeypatch)
    fused = []
    real_fused = tcomp._fused_xfade
    monkeypatch.setattr(tcomp, "_fused_xfade",
                        lambda *a: fused.append(1) or real_fused(*a))
    stats = Engine(parse_config(text), device=CPU).run()
    assert stats["blocks"] == 6
    # a crossfade on every block (block 0 moves filters 0 and 2 to set 1)
    assert len(fused) == 6
    assert len(spy.calls) == 2 * 6


def test_main_runs_float64_on_cpu(tmp_path):
    """``__main__.main`` on a float64 config, the CPU asked for: equal to
    the Engine's output byte for byte."""
    from brutefir_tpu_torch.__main__ import main
    from brutefir_tpu_torch.runtime.engine import Engine
    C, frames = 3, N * 5 + 9
    _taps_file(tmp_path / "c0.txt", N * B, 18)
    _taps_file(tmp_path / "c1.txt", N, 19)
    _write_input(tmp_path / "in.raw", frames, C, "S24_4LE", 20)
    cfg = tmp_path / "c.conf"
    cfg.write_text(_engine_config(tmp_path, "out_main.raw", "S24_4LE",
                                  "S24_4LE"))
    assert main(["-quiet", "-nodefault", str(cfg)], device=CPU) == 0
    Engine(parse_config(_engine_config(tmp_path, "out_eng.raw", "S24_4LE",
                                       "S24_4LE")), device=CPU).run_offline()
    a = (tmp_path / "out_main.raw").read_bytes()
    assert len(a) == frames * C * 4
    assert a == (tmp_path / "out_eng.raw").read_bytes()


# --- convert -----------------------------------------------------------------

def test_convert_carries_float64_state_unrounded(tmp_path, rng):
    """A mid-stream float64 JAX state (ring, tails, controls, bank, the
    device-IO state) carries over with its dtype and bit for bit; a
    float32 one stays float32."""
    from brutefir_tpu.runtime import Engine as JaxEngine
    C, frames = 2, N * 6
    _taps_file(tmp_path / "c0.txt", N * B, 21)
    _write_input(tmp_path / "in.raw", frames, C, "S24_4LE", 22)
    text = _engine_config(tmp_path, "out.raw", "S24_4LE", "S16_LE", C=C,
                          coeffs=(0, 0), dither=True)
    text = text.replace(f"filter_length: {N},{B};",
                        f"filter_length: {N},{B};\nsdf_length: 8;")
    text = text.replace("dither: true;", "dither: true; delay: 3, 5; "
                        "maxdelay: 9; subdelay: 17, -4;")
    with x64():
        jeng = JaxEngine(jax_parse_config(text))
        jeng.run_offline(max_blocks=4)
        js = jeng.state
        parts = {"prev_in": np.asarray(js.prev_in),
                 "ring": np.asarray(js.ring),
                 "eval_prev": np.asarray(js.eval_prev)}
        jctrl = jeng.control.snapshot()
        ctrl = {k: np.asarray(getattr(jctrl, k)) for k in jctrl._fields}
        dstate = {k: np.asarray(v) for k, v in jeng.dio.dstate.items()}
        bank = np.asarray(jeng.bank)
    assert parts["ring"].dtype == np.float64
    st = state_from_jax(parts["prev_in"], parts["ring"], parts["eval_prev"],
                        js.t, CPU)
    for name in ("prev_in", "ring", "eval_prev"):
        got = getattr(st, name)
        assert got.dtype == F64
        np.testing.assert_array_equal(got.numpy(), parts[name].reshape(
            got.shape))
    tctrl = ctrl_from_jax(jctrl, CPU)
    for name in tctrl._fields:
        got = getattr(tctrl, name).numpy()
        assert got.dtype == ctrl[name].dtype
        np.testing.assert_array_equal(got, ctrl[name])
    assert tctrl.in_mix.dtype == tctrl.mask.dtype == F64
    ds = dstate_from_jax(dstate, CPU)
    assert {"sf", "dlw_out", "sdr_out", "ptr"} <= set(ds)
    for k, v in ds.items():
        assert v.numpy().dtype == dstate[k].dtype
        np.testing.assert_array_equal(v.numpy(), dstate[k])
    assert ds["sf"].dtype == F64 and float(ds["sf"].abs().max()) > 0
    tb = bank_from_jax(bank, CPU)
    assert tb.dtype == F64
    np.testing.assert_array_equal(tb.numpy(), bank.reshape(tb.shape))
    # a float32 state stays float32
    st32 = state_from_jax(parts["prev_in"].astype(np.float32),
                          parts["ring"].astype(np.float32),
                          parts["eval_prev"].astype(np.float32), 3, CPU)
    assert st32.ring.dtype == torch.float32


def test_x64_restored_after_a_float64_run(tmp_path):
    """A JAX float64 engine turns x64 on for the process; ``x64()``
    leaves it as it found it, so later JAX tests in the worker run as
    before."""
    from brutefir_tpu.runtime import Engine as JaxEngine
    before = jax.config.jax_enable_x64
    _taps_file(tmp_path / "c0.txt", N, 23)
    _write_input(tmp_path / "in.raw", N * 2, 1, "FLOAT64_LE", 24)
    text = _engine_config(tmp_path, "out.raw", "FLOAT64_LE", "FLOAT64_LE",
                          C=1, coeffs=(0,))
    with x64():
        JaxEngine(jax_parse_config(text)).run_offline()
        assert jax.config.jax_enable_x64
    assert jax.config.jax_enable_x64 == before
    assert jnp.zeros(2, float).dtype == (jnp.float64 if before
                                         else jnp.float32)
