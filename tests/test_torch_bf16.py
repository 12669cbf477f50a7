"""The opt-in bfloat16 bank and ring (``BRUTEFIR_TPU_BANK_DTYPE`` /
``BRUTEFIR_TPU_RING_DTYPE`` = bf16) and ``BRUTEFIR_TPU_PROFILE`` in the
port, on the CPU, against the JAX
package on the same numpy inputs made from a seed.

- The plain MAC of every kernel form (rows 1-10, through the wrappers on
  CPU tensors) with a bf16 ring, a bf16 bank and both, against the JAX
  package's Pallas kernels in interpret mode on the same bf16 values
  (both round float32 to bf16 to nearest even: the bits are checked
  equal): ``atol`` 1e-4, 1e-3 for the mixes, as
  tests/test_pallas_mac.py:405-541 holds the JAX kernels to their dense
  path.
- The engine's bf16 bank: its bits equal to the JAX engine's bank on the
  same config (demanded where the two float32 banks are bit-equal; where
  they differ by float32 rounding of the FFTs, one bf16 ulp is allowed).
- Engines end to end: a dirac bank is exact in bf16, so the bank knob's
  output is bit-equal to the float32 bank's (and within the JAX parity
  tolerance of 1 LSB of the JAX engine's); a random bank is held to the
  float64 response of the *quantized* bank (the bf16 bank widened, the
  partitioned overlap-save in float64) within the float32 bound of a few
  LSB; the ring knob within ``0.005 max|y| + 2`` LSB of the float32 run
  (its quantization depends on the signal: tests/test_pallas_mac.py:
  544-577) and within 20 LSB of the JAX engine under the same knob (both
  round the same spectra to nearest even; where their float32 FFTs differ
  by an ulp a value may round to the other bf16 neighbour: 15 LSB
  measured); on a 2 x 2 CPU mesh within ``0.01 max|y|`` of one device
  (tests/test_parallel.py:415-446).
- ``float_bits: 64`` ignores both knobs; ``check_operands`` admits bf16
  only beside float32.
- ``ops/mac_mix.plan`` stages bf16 runs densely, two partitions a
  stage; ``ops/mac_group.mix_group_layout`` (row 5's launch) stages a
  bf16 position in 16 or 24 chunks, more positions a stage, all 256 rows
  a block at G = 2.
- ``BRUTEFIR_TPU_PROFILE=<dir>``: a 4-block ``run()`` writes one Chrome
  trace into the directory it creates, and so does ``run_offline``, each
  with the engine's spans on their threads' tracks; an error inside
  ``run()`` still stops the profiler.

The CUDA forms themselves are held against these plain versions on a
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brutefir_tpu.config import parse_config as jax_parse_config
from brutefir_tpu.ops import pallas_mac as jpm
from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.ops import (mac as tm, mac_dual as td,
                                    mac_group as mg, mac_mix as mm,
                                    partconv as pc)
from brutefir_tpu_torch.ops.mac_mix import check_operands
from brutefir_tpu_torch.runtime import tracing

CPU = torch.device("cpu")
F, B, K, E, C_OUT = 4, 4, 256, 3, 3
COMBOS = {"ring": (1, 0), "bank": (0, 1), "both": (1, 1)}
ATOL, ATOL_MIX = 1e-4, 1e-3


def _pair(x, bf16: bool):
    """(JAX array, torch tensor) of a float32 numpy array, both cast to
    bfloat16 where ``bf16``; their bits checked equal."""
    if not bf16:
        return jnp.asarray(x), torch.as_tensor(x)
    j, t = jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(j.view(jnp.uint16)),
                                  t.view(torch.int16).numpy().view(np.uint16))
    return j, t


def _mac_inputs(seed, uniform):
    rng = np.random.default_rng(seed)
    ring = rng.standard_normal((F, B, 2, K)).astype(np.float32)
    bank = rng.standard_normal((E, B, 2, K)).astype(np.float32)
    if uniform:
        idx = np.full(F, 1, np.int32)
        mask = np.tile((rng.uniform(size=B) > 0.3).astype(np.float32), (F, 1))
    else:
        idx = np.array([0, 2, 1, 0], np.int32)
        mask = (rng.uniform(size=(F, B)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    w = rng.standard_normal((C_OUT, F)).astype(np.float32)
    return ring, bank, idx, mask, w


def _close(got, ref, atol):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=atol)


KERNELS = ["rows", "uniform", "dual_rows", "dual_uniform", "mix_rows",
           "mix_uniform"]


@pytest.mark.parametrize("combo", COMBOS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_mac_bf16_matches_pallas(combo, kernel):
    """Rows 1-2 and 6-10 (the unfused rows/chunked/tile variants share
    ``mac_rows``' plain version, row 3 ``mix_rows``'): the port's
    wrappers on CPU tensors against the JAX kernels in interpret mode."""
    r16, b16 = COMBOS[combo]
    uniform = kernel.endswith("uniform")
    ring, bank, idx, mask, w = _mac_inputs(
        10 * list(COMBOS).index(combo) + KERNELS.index(kernel), uniform)
    jr, tr = _pair(ring, r16)
    jb, tb = _pair(bank, b16)
    ji, ti = jnp.asarray(idx), torch.as_tensor(idx)
    jm, tmk = jnp.asarray(mask), torch.as_tensor(mask)
    rows = torch.arange(F, dtype=torch.int32)
    for tv in (0, 3, 6):
        jt, tt = jnp.int32(tv), torch.tensor(tv, dtype=torch.int32)
        if kernel in ("rows", "uniform"):
            fn = (jpm.pallas_spectral_mac_uniform if uniform
                  else jpm.pallas_spectral_mac)
            ref = fn(jr, jb, ji, jm, jt, interpret=True)
            _close(tm.mac(tr, tb, rows, ti, tmk, tt, uniform), ref, ATOL)
        elif kernel.startswith("dual"):
            pidx = (idx + 1) % E
            pmask = mask.copy()
            pmask[:, 2:] = 0.0
            refs = jpm.pallas_spectral_mac_dual(
                jr, jb, ji, jm, jnp.asarray(pidx), jnp.asarray(pmask), jt,
                uniform=uniform, interpret=True)
            gots = td.mac_dual(tr, tb, rows, ti, tmk, torch.as_tensor(pidx),
                               torch.as_tensor(pmask), tt, uniform)
            for g, r in zip(gots, refs):
                _close(g, r, ATOL)
        else:
            ref = jpm.pallas_spectral_mac_mix(jr, jb, ji, jm, jt,
                                              jnp.asarray(w), uniform=uniform,
                                              interpret=True)
            _close(mm.mac_mix(tr, tb, ti, tmk, tt, torch.as_tensor(w),
                              uniform), ref, ATOL_MIX)


@pytest.mark.parametrize("combo", COMBOS)
@pytest.mark.parametrize("G", [2, 3])
@pytest.mark.parametrize("fused", [False, True])
def test_plain_group_bf16_matches_pallas(combo, G, fused):
    """Rows 4-5: the grouped MACs with xnews of the ring's dtype against
    ``pallas_spectral_mac_group`` / ``_mix_group`` in interpret mode."""
    r16, b16 = COMBOS[combo]
    rng = np.random.default_rng(G * 10 + fused)
    ring = rng.standard_normal((F, B, 2, K)).astype(np.float32)
    bank = rng.standard_normal((E, B, 2, K)).astype(np.float32)
    xnews = rng.standard_normal((F, G - 1, 2, K)).astype(np.float32)
    idx = rng.integers(0, E, F).astype(np.int32)
    delay = np.array([0, 1, G, B - 1], np.int32)
    mask = (np.arange(B)[None, :] < (B - delay)[:, None]).astype(np.float32)
    w = rng.standard_normal((C_OUT, F)).astype(np.float32)
    jr, tr = _pair(ring, r16)
    jb, tb = _pair(bank, b16)
    jx, tx = _pair(np.ascontiguousarray(np.moveaxis(xnews, 1, 0)), r16)
    tx = tx.movedim(0, 1).contiguous()           # the port's [F, G-1, 2, K]
    args_j = (jnp.asarray(idx), jnp.asarray(mask))
    args_t = (torch.as_tensor(idx), torch.as_tensor(mask))
    for tv in (0, B - 2, 2 * B + 1):
        jt, tt = jnp.int32(tv), torch.tensor(tv, dtype=torch.int32)
        if fused:
            ref = jpm.pallas_spectral_mac_mix_group(
                jr, jx, jb, *args_j, jt, jnp.asarray(w), jnp.asarray(delay),
                interpret=True)
            got = mg.mac_mix_group(tr, tx, tb, *args_t, tt,
                                   torch.as_tensor(w), torch.as_tensor(delay))
            atol = ATOL_MIX
        else:
            ref = jpm.pallas_spectral_mac_group(
                jr, jx, jb, *args_j, jt, jnp.asarray(delay), interpret=True)
            got = mg.mac_group(tr, tx, tb, *args_t, tt,
                               torch.as_tensor(delay))
            atol = ATOL
        assert got.shape[0] == G
        for g in range(G):
            _close(got[g], np.asarray(ref[g]), atol)


def test_check_operands_admits_bf16_beside_float32_only():
    ring = torch.zeros(F, B, 2, K, dtype=torch.bfloat16)
    bank = torch.zeros(E, B, 2, K, dtype=torch.bfloat16)
    idx = torch.zeros(F, dtype=torch.int32)
    mask = torch.ones(F, B)
    t = torch.tensor(0, dtype=torch.int32)
    check_operands("mac", ring, bank, idx, mask, t)
    check_operands("mac", ring.float(), bank, idx, mask, t)
    xnews = torch.zeros(F, 1, 2, K, dtype=torch.bfloat16)
    check_operands("mac_group", ring, bank, idx, mask, t, xnews=xnews,
                   delay=idx)
    with pytest.raises(TypeError):          # xnews of another dtype
        check_operands("mac_group", ring, bank, idx, mask, t,
                       xnews=xnews.float(), delay=idx)
    with pytest.raises(TypeError):          # bf16 beside float64
        tm.mac(ring.double(), bank, torch.arange(F, dtype=torch.int32), idx,
               mask.double(), t, False)
    with pytest.raises(TypeError):
        tm.mac(ring, bank.double(), torch.arange(F, dtype=torch.int32), idx,
               mask, t, False)
    with pytest.raises(TypeError):          # the mask stays float32
        check_operands("mac", ring, bank, idx, mask.to(torch.bfloat16), t)


def test_staged_forms_refuse_unaligned_bf16_shapes(monkeypatch):
    """The bf16 forms of the kernels that move whole 16-byte runs (the
    fused MAC + mix, its tiled form, both grouped MACs) take K % 8 == 0
    only (ValueError, on every device: a shape rule); the unfused MAC
    takes any K."""
    ring = torch.ones(F, B, 2, 100, dtype=torch.bfloat16)
    bank = torch.ones(E, B, 2, 100)
    idx = torch.zeros(F, dtype=torch.int32)
    mask = torch.ones(F, B)
    t = torch.tensor(1, dtype=torch.int32)
    w = torch.ones(C_OUT, F)
    xnews = torch.ones(F, 1, 2, 100, dtype=torch.bfloat16)
    for tiled in (False, True):
        monkeypatch.setattr(mm, "tiled_route", lambda *a, _t=tiled: _t)
        with pytest.raises(ValueError):
            mm.mac_mix(ring, bank, idx, mask, t, w, False)
        with pytest.raises(ValueError):
            mm.mac_mix(ring.float(), bank.to(torch.bfloat16), idx, mask, t,
                       w, False)
    monkeypatch.undo()
    with pytest.raises(ValueError):
        mg.mac_mix_group(ring, xnews, bank, idx, mask, t, w, idx)
    with pytest.raises(ValueError):
        mg.mac_group(ring, xnews, bank, idx, mask, t, idx)
    with pytest.raises(ValueError):
        mg.mac_group(ring.float(), xnews.float(), bank.to(torch.bfloat16),
                     idx, mask, t, idx)
    # K % 8 == 0 but xnews 4 bytes off 16-byte alignment
    r8 = torch.ones(F, B, 2, 96, dtype=torch.bfloat16)
    buf = torch.ones(F * 2 * 96 + 2, dtype=torch.bfloat16)
    x8 = buf[2:].view(F, 1, 2, 96)
    assert x8.is_contiguous() and x8.data_ptr() % 16
    with pytest.raises(ValueError):
        mg.mac_group(r8, x8, torch.ones(E, B, 2, 96), idx, mask, t, idx)
    y8 = mg.mac_group(r8, x8.clone(), torch.ones(E, B, 2, 96), idx, mask, t,
                      idx)
    assert y8.shape == (2, F, 2, 96)
    y = tm.mac(ring, bank, torch.arange(F, dtype=torch.int32), idx, mask, t,
               False)
    assert y.dtype == torch.float32 and y.shape == (F, 2, 100)


@pytest.mark.parametrize("combo", COMBOS)
def test_bf16_launches_counted_apart(combo):
    """On a CPU tensor a wrapper runs its plain version and counts
    nothing, float32 or bf16; ``bf16_suffix`` names the forms, each a key
    of its module's ``launches``."""
    r16, b16 = COMBOS[combo]
    ring, bank, idx, mask, w = _mac_inputs(5, False)
    _, tr = _pair(ring, r16)
    _, tb = _pair(bank, b16)
    assert mm.bf16_suffix(tr, tb) == {"ring": "_bf16r", "bank": "_bf16b",
                                      "both": "_bf16rb"}[combo]
    assert mm.bf16_suffix(torch.as_tensor(ring), torch.as_tensor(bank)) == ""
    assert mm.bf16_flags(tr, tb) == (r16, b16)
    for mod in (tm, td, mg, mm):
        mod.reset_launches()
    mm.mac_mix(tr, tb, torch.as_tensor(idx), torch.as_tensor(mask),
               torch.tensor(2, dtype=torch.int32), torch.as_tensor(w), False)
    assert set(mm.launches) == {
        f + s for f in ("uniform", "rows", "tiled")
        for s in ("",) + mm.BF16_SUFFIXES}
    assert set(tm.launches) == {
        f + s for f in ("mac_uniform", "mac_rows")
        for s in ("", "_f64") + mm.BF16_SUFFIXES}
    for mod in (tm, td, mg, mm):
        assert not any(mod.launches.values())


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("F,B,C", [(26, 16, 26), (5, 7, 3), (255, 4, 256),
                                   (2, 3000, 1)])
def test_mac_mix_plan_stages_bf16_densely(uniform, F, B, C):
    """``plan`` for bf16 operands (csrc/mac_mix.cu's dense staging): a
    bf16 run's slot is 64 bytes, a float32 one's MIX_TK + 4 floats; a bf16
    form's stage holds two partitions; the plan's bytes are ``smem_bytes``
    of its operand sizes; at the massive shape every form keeps two blocks
    an SM (half of SMEM_MAX) with all 26 filters in one chunk."""
    assert mm.run_floats(4) == mm.MIX_TK + 4 and mm.run_floats(2) == 16
    assert mm.part_floats(False, 2, 4) == 2 * 16 + 2 * 36 + 4
    assert mm.part_floats(True, 2, 4) == 2 * 16 + 4
    p32 = mm.plan(F, B, 8192, C, uniform)
    assert p32["parts"] == 1
    for sizes in ((2, 4), (4, 2), (2, 2)):
        p = mm.plan(F, B, 8192, C, uniform, *sizes)
        assert p["parts"] == 2 and p["nw"] == p32["nw"]
        assert p["bank_smem"] == p32["bank_smem"] or sizes[1] == 2
        assert p["smem"] == mm.smem_bytes(p["nw"], p["FC"], F, B, C,
                                          p["bank_smem"], *sizes)
        assert p["smem"] <= mm.SMEM_MAX
        if (F, B, C) == (26, 16, 26):
            assert p["smem"] <= mm.SMEM_MAX // 2 and p["FC"] == 26


SIZES = {"float32": (4, 4), "ring": (2, 4), "bank": (4, 2), "both": (2, 2)}


@pytest.mark.parametrize("sizes", list(SIZES))
@pytest.mark.parametrize("G", range(2, mg.MAX_GROUP + 1))
@pytest.mark.parametrize("C_out", [1, 20, 256, 300])
def test_mix_group_layout_stages_bf16_densely(sizes, G, C_out):
    """``mix_group_layout`` (csrc/mac_group.cu's row-5 launch): a
    position's four 32-bin runs are 32 chunks of 16 bytes in float32 and
    16 with both operands in bf16 (two positions a warp-wide copy), so
    that form's stage holds 6 positions (float32 4); with one bf16
    operand the launch is the float32 form's; the shared memory of three
    stages fits SMEM_MAX; a thread's 64 accumulators cover the rows x
    padded G columns, all 256 rows a block at G = 2; gridDim.y covers
    C_out; the rest of the launch is the float32 form's; G outside 2 ..
    8 is refused."""
    rs, hs = SIZES[sizes]
    p = mg.mix_group_layout(G, C_out, rs, hs)
    f32 = mg.mix_group_layout(G, C_out)
    assert p["chunks"] == (16 if sizes == "both" else 32)
    assert p["positions"] == (6 if sizes == "both" else 4)
    assert (p == f32) == (sizes != "both")
    assert p["stages"] == 3 and p["bins"] == 32 and p["threads"] == 512
    assert p["smem"] <= mg.SMEM_MAX
    assert p["rows"] * p["padded_g"] * 2 * 32 == 512 * 64
    assert p["padded_g"] >= G and p["rows"] == (256 if G == 2 else
                                                128 if G <= 4 else 64)
    assert (p["grid_y"] - 1) * p["rows"] < C_out <= p["grid_y"] * p["rows"]
    assert {k: v for k, v in p.items() if k not in (
        "chunks", "positions", "smem")} == {
        k: v for k, v in f32.items() if k not in (
            "chunks", "positions", "smem")}
    for bad in (1, mg.MAX_GROUP + 1):
        with pytest.raises(ValueError):
            mg.mix_group_layout(bad, C_out, rs, hs)


# --- engines ----------------------------------------------------------------

N_E, B_E = 256, 4


def _s32_input(path, frames, channels, seed):
    x = np.clip(np.round(np.random.default_rng(seed).standard_normal(
        (frames, channels)) * 2 ** 20), -(2 ** 23), 2 ** 23 - 1)
    x.astype("<i4").tofile(path)
    return x


def _engine_text(tmp_path, name, coeffs, coeff_of, fmt="S24_4LE",
                 float_bits=32):
    C = len(coeff_of)
    chans = ",".join(str(c) for c in range(C))
    ctext = "".join(
        f'coeff {k} {{ filename: "{v}"; }};\n' if v == "dirac pulse" else
        f'coeff {k} {{ filename: "{v}"; format: "FLOAT_LE"; }};\n'
        for k, v in enumerate(coeffs))
    filters = "".join(
        f"filter {f} {{ from_inputs: {f}; to_outputs: {f}; coeff: {c}; }};\n"
        for f, c in enumerate(coeff_of))
    return f"""
sampling_rate: 44100;
filter_length: {N_E},{B_E};
float_bits: {float_bits};
{ctext}
input {chans} {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "{fmt}"; channels: {C}; }};
output {chans} {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "{fmt}"; channels: {C}; dither: false; }};
{filters}"""


def _taps(tmp_path, k, n, seed):
    """n seeded, decaying taps with ||h||_2 = 0.5 (no clipping at the
    input's std of 2^20) as a FLOAT_LE file."""
    h = (np.random.default_rng(seed).standard_normal(n)
         * np.exp(-np.arange(n) / (n / 3)))
    h = (0.5 * h / np.linalg.norm(h)).astype(np.float32)
    path = tmp_path / f"h{k}.raw"
    h.astype("<f4").tofile(path)
    return str(path), h


def _knobs(monkeypatch, bank="", ring=""):
    monkeypatch.setenv("BRUTEFIR_TPU_BANK_DTYPE", bank)
    monkeypatch.setenv("BRUTEFIR_TPU_RING_DTYPE", ring)


def _port(tmp_path, text_of, name, mesh=None):
    from brutefir_tpu_torch.runtime.engine import Engine
    conf = parse_config(text_of(name))
    conf.quiet = True
    eng = Engine(conf, device=CPU, mesh=mesh)
    eng.run_offline()
    return eng, np.fromfile(tmp_path / name, "<i4").astype(np.int64)


def _jax(tmp_path, monkeypatch, text_of, name):
    from brutefir_tpu.runtime import Engine as JaxEngine
    monkeypatch.setenv("BRUTEFIR_TPU_MAC", "pallas")
    conf = jax_parse_config(text_of(name))
    conf.quiet = True
    eng = JaxEngine(conf)
    eng.run_offline(batch_blocks=8)
    monkeypatch.delenv("BRUTEFIR_TPU_MAC")
    return eng, np.fromfile(tmp_path / name, "<i4").astype(np.int64)


def _jax_bank_bits(eng) -> np.ndarray:
    b = np.asarray(eng.bank.view(jnp.uint16))
    return b.reshape(b.shape[:3] + (-1,))        # tiled -> [E, B, 2, N]


def _port_bank_bits(eng) -> np.ndarray:
    return eng.bank.view(torch.int16).numpy().view(np.uint16)


def test_bank_bits_equal_the_jax_engines(tmp_path, monkeypatch):
    """The bf16 bank of both engines from the same two coefficient sets
    and the dirac: bit-equal where the two float32 banks are (the dirac
    and every value whose float32 FFTs agree), and within one bf16 ulp
    where float32 rounding of the FFTs differs."""
    p0, _ = _taps(tmp_path, 0, N_E * B_E, 1)
    p1, _ = _taps(tmp_path, 1, N_E * 2 + 9, 2)
    _s32_input(tmp_path / "in.raw", N_E * 2, 3, 3)

    def text_of(name):
        return _engine_text(tmp_path, name, [p0, p1, "dirac pulse"],
                            [0, 1, 2])
    banks = {}
    for knob in ("", "bf16"):
        _knobs(monkeypatch, bank=knob)
        teng, _ = _port(tmp_path, text_of, f"t{knob}.raw")
        jeng, _ = _jax(tmp_path, monkeypatch, text_of, f"j{knob}.raw")
        banks[knob] = (teng.bank, jeng.bank)
    tb, jb = banks["bf16"]
    assert tb.dtype == torch.bfloat16 and jb.dtype == jnp.bfloat16
    t32 = banks[""][0].numpy()
    j32 = np.asarray(banks[""][1]).reshape(t32.shape)
    same32 = t32 == j32
    tbits = _port_bank_bits(teng).astype(np.int64)
    jbits = _jax_bank_bits(jeng).astype(np.int64)
    assert tbits.shape == jbits.shape
    assert same32.mean() > 0.5
    np.testing.assert_array_equal(tbits[same32], jbits[same32])
    assert np.abs(tbits - jbits).max() <= 1
    # the float32 bank cast to bf16 here is the engine's bf16 bank
    assert torch.equal(banks[""][0].to(torch.bfloat16), tb)


def test_dirac_bank_knob_is_bit_equal(tmp_path, monkeypatch):
    """A dirac bank is exact in bf16 (+-1 spectra): the bank knob's output
    is bit-equal to the float32 bank's, and within the parity tolerance
    (1 LSB) of the JAX engine under the same knob."""
    frames = N_E * 5 + 37
    _s32_input(tmp_path / "in.raw", frames, 2, 5)

    def text_of(name):
        return _engine_text(tmp_path, name, ["dirac pulse"], [0, 0])
    _knobs(monkeypatch)
    _, y32 = _port(tmp_path, text_of, "t32.raw")
    _knobs(monkeypatch, bank="bf16")
    teng, y16 = _port(tmp_path, text_of, "t16.raw")
    assert teng.bank.dtype == torch.bfloat16
    _, yj = _jax(tmp_path, monkeypatch, text_of, "j16.raw")
    assert np.abs(y32).max() > 2 ** 20
    np.testing.assert_array_equal(y16, y32)
    assert np.abs(y16 - yj).max() <= 1


def partconv_q(x: np.ndarray, H: np.ndarray, N: int) -> np.ndarray:
    """The float64 response of the partitioned overlap-save convolution
    with the spectra ``H`` [P, N + 1] (complex128: the quantized bank
    widened and unpacked): frame t = [x_{t-1}, x_t], Y_t = sum_p
    rfft(frame_{t-p}) H_p, y_t = the lower half of irfft(Y_t). Exact for
    any H, where the effective taps of a quantized spectrum reach into
    the frame's other half and a linear convolution would not be."""
    frames = x.size
    nb = -(-frames // N)
    xp = np.zeros((nb + 1) * N)
    xp[N:N + frames] = x
    X = np.fft.rfft(np.stack([xp[t * N:(t + 2) * N] for t in range(nb)]),
                    axis=1)
    y = np.zeros(nb * N)
    for t in range(nb):
        Y = sum(X[t - p] * H[p] for p in range(min(len(H), t + 1)))
        y[t * N:(t + 1) * N] = np.fft.irfft(Y, 2 * N)[:N]
    return y[:frames]


def quantized_spectra(bank_row: torch.Tensor) -> np.ndarray:
    """A bank row [P, 2, N] (bf16 or float32) as its widened, unpacked
    float64 spectra [P, N + 1]."""
    p = bank_row.double().numpy()
    return pc.unpack_spectrum(p[:, 0] + 1j * p[:, 1])


def test_bank_knob_within_the_quantized_bank_oracle(tmp_path, monkeypatch):
    """A random bank under the bank knob: every S24 word within 2 LSB of
    the float64 response of the quantized bank (the float32 run's gap to
    its own oracle is of that size), while the float32 run is thousands
    of LSB off that oracle (the quantization is real); the JAX engine
    under the knob within 2 LSB of the port."""
    p0, _ = _taps(tmp_path, 0, N_E * B_E, 7)
    p1, _ = _taps(tmp_path, 1, N_E * 3, 8)
    frames = N_E * 7 + 11
    x = _s32_input(tmp_path / "in.raw", frames, 2, 9)

    def text_of(name):
        return _engine_text(tmp_path, name, [p0, p1], [0, 1])
    _knobs(monkeypatch)
    e32, y32 = _port(tmp_path, text_of, "t32.raw")
    _knobs(monkeypatch, bank="bf16")
    e16, y16 = _port(tmp_path, text_of, "t16.raw")
    _, yj = _jax(tmp_path, monkeypatch, text_of, "j16.raw")
    y16, y32 = y16.reshape(frames, 2), y32.reshape(frames, 2)
    gaps16, gaps32, far = [], [], []
    for c in range(2):
        ref16 = partconv_q(x[:, c], quantized_spectra(e16.bank[c]), N_E)
        ref32 = partconv_q(x[:, c], quantized_spectra(e32.bank[c]), N_E)
        gaps16.append(np.abs(y16[:, c] - ref16).max())
        gaps32.append(np.abs(y32[:, c] - ref32).max())
        far.append(np.abs(y32[:, c] - ref16).max())
    assert max(gaps32) <= 2 and max(gaps16) <= 2, (gaps16, gaps32)
    assert min(far) > 100
    assert np.abs(y16.ravel() - yj).max() <= 2


@pytest.mark.parametrize("pair", ["0", "force:4"])
def test_ring_knob_within_the_bound(tmp_path, monkeypatch, pair):
    """The ring knob against the float32 run (the JAX bound) and the JAX
    engine under the same knob (20 LSB: 15 measured, where the two float32
    FFTs round a spectrum value to either side of a bf16 tie; a cast that
    truncated would be thousands off), block by block and in groups of 4
    (the group's xnews cast as the ring writes cast: the grouped run within
    2 LSB of the block by block one)."""
    monkeypatch.setenv("BRUTEFIR_TPU_PAIR", pair)
    p0, _ = _taps(tmp_path, 0, N_E * B_E, 11)
    frames = N_E * 9 + 3
    _s32_input(tmp_path / "in.raw", frames, 3, 12)

    def text_of(name):
        return _engine_text(tmp_path, name, [p0], [0, 0, 0])
    _knobs(monkeypatch)
    _, y32 = _port(tmp_path, text_of, "t32.raw")
    _knobs(monkeypatch, ring="bf16")
    eng, y16 = _port(tmp_path, text_of, "t16.raw")
    assert eng.state.ring.dtype == torch.bfloat16
    assert eng.bank.dtype == torch.float32
    _, yj = _jax(tmp_path, monkeypatch, text_of, "j16.raw")
    peak = np.abs(y32).max()
    assert peak > 2 ** 20
    assert 0 < np.abs(y16 - y32).max() <= 0.005 * peak + 2
    assert np.abs(y16 - yj).max() <= 20
    monkeypatch.setenv("BRUTEFIR_TPU_PAIR", "0")
    _, yb = _port(tmp_path, text_of, "tb.raw")
    assert np.abs(y16 - yb).max() <= 2


def test_mesh_with_both_knobs(tmp_path, monkeypatch):
    """A 2 x 2 CPU mesh under both knobs: every shard of the bank and the
    ring bfloat16; the output within 0.01 max|y| of one device."""
    from brutefir_tpu_torch.parallel import make_mesh
    p0, _ = _taps(tmp_path, 0, N_E * B_E, 13)
    p1, _ = _taps(tmp_path, 1, N_E * B_E, 14)
    frames = N_E * 6 + 5
    _s32_input(tmp_path / "in.raw", frames, 4, 15)

    def text_of(name):
        return _engine_text(tmp_path, name, [p0, p1], [0, 1, 0, 1])
    _knobs(monkeypatch, bank="bf16", ring="bf16")
    _, y1 = _port(tmp_path, text_of, "one.raw")
    eng, ym = _port(tmp_path, text_of, "mesh.raw",
                    mesh=make_mesh([CPU] * 4, 2, 2))
    for sh in (eng.bank, eng.state.ring):
        assert sh.dtype == torch.bfloat16
        assert all(p.dtype == torch.bfloat16 for row in sh.parts
                   for p in row)
    peak = np.abs(y1).max()
    assert peak > 2 ** 20
    assert np.abs(ym - y1).max() <= 0.01 * peak


def test_float64_graph_ignores_the_knobs(tmp_path, monkeypatch):
    p0, _ = _taps(tmp_path, 0, N_E * B_E, 16)
    _s32_input(tmp_path / "in.raw", N_E * 3, 2, 17)
    _knobs(monkeypatch, bank="bf16", ring="bfloat16")
    eng, y = _port(tmp_path, lambda name: _engine_text(
        tmp_path, name, [p0], [0, 0], float_bits=64), "f64.raw")
    assert eng.bank.dtype == torch.float64
    assert eng.state.ring.dtype == torch.float64
    assert np.abs(y).max() > 2 ** 18


def test_eq_render_goes_through_the_bf16_bank(tmp_path, monkeypatch):
    """``update_bank_entry`` (the EQ's render, a coefficient swap) casts
    to the bank's dtype: the new row is the bf16 rounding of the float32
    spectra, the others untouched."""
    p0, _ = _taps(tmp_path, 0, N_E * B_E, 18)
    _s32_input(tmp_path / "in.raw", N_E * 2, 2, 19)
    _knobs(monkeypatch, bank="bf16")
    eng, _ = _port(tmp_path, lambda name: _engine_text(
        tmp_path, name, [p0, p0], [0, 1]), "eq.raw")
    old = eng.bank.clone()
    H = np.random.default_rng(20).standard_normal(
        (B_E, 2, N_E)).astype(np.float32)
    eng.update_bank_entry(1, H)
    assert eng.bank.dtype == torch.bfloat16
    assert torch.equal(eng.bank[1], torch.as_tensor(H).to(torch.bfloat16))
    assert torch.equal(eng.bank[0], old[0])


@pytest.mark.parametrize("fail", [False, True])
def test_profile_writes_a_trace_of_run(tmp_path, monkeypatch, fail):
    """``BRUTEFIR_TPU_PROFILE=<dir>``: a 4-block ``run()`` writes one
    Chrome trace into the directory it makes; an error inside ``run()``
    writes it too and leaves no profiler running, and the recorder off;
    ``run_offline``, the CLI's default for files, writes one too. Each
    trace carries the engine's spans (``runtime/tracing.py``) on the
    tracks of the threads that ran them."""
    from brutefir_tpu_torch.runtime.engine import Engine
    p0, _ = _taps(tmp_path, 0, N_E * B_E, 21)
    _s32_input(tmp_path / "in.raw", N_E * 4, 2, 22)
    out = tmp_path / "prof" / "deep"
    monkeypatch.setenv("BRUTEFIR_TPU_PROFILE", str(out))
    conf = parse_config(_engine_text(tmp_path, "p.raw", [p0], [0, 0]))
    conf.quiet = True
    eng = Engine(conf, device=CPU)
    if fail:
        def boom(*a, **k):
            raise RuntimeError("stop")
        monkeypatch.setattr(eng, "_run_blocks", boom)
        with pytest.raises(RuntimeError, match="stop"):
            eng.run()
    else:
        assert eng.run()["frames"] == N_E * 4
    assert not torch.autograd._profiler_enabled()
    files = list(out.glob("*.json"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    assert trace["traceEvents"]
    assert not tracing.RECORDER.on
    if not fail:
        names = {e.get("name", "") for e in trace["traceEvents"]}
        assert any("matmul" in n or "mm" in n for n in names)
        assert {"read", "dispatch", "write"} <= _span_names(trace)
        conf = parse_config(_engine_text(tmp_path, "q.raw", [p0], [0, 0]))
        conf.quiet = True
        Engine(conf, device=CPU).run_offline(batch_blocks=2)
        assert not tracing.RECORDER.on
        files = set(out.glob("*.json")) - set(files)
        assert len(files) == 1
        trace = json.loads(files.pop().read_text())
        assert {"read", "upload", "dispatch", "write",
                "write.fetch"} <= _span_names(trace)
        tracks = {e["args"]["name"]: e["tid"] for e in trace["traceEvents"]
                  if e.get("name") == "thread_name"}
        tids = {}
        for e in trace["traceEvents"]:
            if e.get("cat") == "program_span":
                tids.setdefault(e["name"].split(".")[0], set()).add(e["tid"])
        assert tids["read"] == tids["upload"] == {tracks["bf-producer"]}
        assert tids["write"] == {tracks["bf-writer"]}
        # the main thread's spans on the track of its own operators
        ops = {e["tid"] for e in trace["traceEvents"]
               if e.get("cat") == "cpu_op"}
        assert tids["dispatch"] == ops and len(ops) == 1
    assert os.path.isdir(out)


def _span_names(trace) -> set:
    return {e["name"] for e in trace["traceEvents"]
            if e.get("cat") == "program_span"}
