"""The forward route into the ring: ``fft_glue.glue_fwd_ring`` /
``glue_fwd_into`` (csrc/fft_glue.cu's ``bf_glue_fwd_ring``; on the CPU
their plain versions) against the JAX package's Pallas forward glue
(brutefir_tpu/ops/pallas_glue.py ``_fwd_kernel``, interpret mode off the
TPU) followed by the JAX step's ring write (the cast, then a
dynamic_update_slice at one slot or a scatter at each filter's, as
``write_ring`` in brutefir_tpu/graph/compile.py:260-274), on the same
seeded numpy inputs; the input mix on M-point spectra (``mix_points``)
and the cascade input before its glue (``convolve_eval_points``) against
the JAX package's mixes and ``convolve_eval`` of packed planes; the
wrappers' checks; and engines file to file against the JAX engine with
the route's calls counted: grouped G = 2 and 4, a 2 x 2 mesh.

Tolerances: float32 spectra within 1e-5 of their peak (the same glue
arithmetic on both sides, each package's FFT and mix rounding at a few
ulp of the peak); a bfloat16 ring within one bfloat16 step of the JAX
ring (a float32 value a few ulp away can round to the neighbouring
bfloat16) and bit-equal to the port's own float32 result cast; float64
within 1e-12 of the peak; engines within 1 LSB of S24 of the JAX engine,
the mesh bit-equal to the port unsharded where no output mix is split."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from brutefir_tpu.ops import pallas_glue as jpg
from brutefir_tpu.ops import partconv as jpc
from brutefir_tpu_torch.ops import fft_glue as tg
from brutefir_tpu_torch.ops import partconv as tpc

CPU = torch.device("cpu")


@pytest.fixture
def x64():
    """``jax_enable_x64`` on for the test, restored after it."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _jax_glue(Zm: np.ndarray) -> jnp.ndarray:
    """The Pallas forward glue (``_fwd_kernel``) of complex ``Zm [Fs, M]``
    -> packed planes [Fs, 2, M], in Zm's real type."""
    real = np.float64 if Zm.dtype == np.complex128 else np.float32
    zp = jnp.asarray(np.stack([Zm.real, Zm.imag], axis=-2).astype(real))
    ab = jnp.asarray(jpg._ab_consts(Zm.shape[-1], True, real))
    return jpg._glue_call(jpg._fwd_kernel, zp, ab, True)


def _jax_write_ring(ring, blk, idx, t, delay, uniform: bool):
    """The JAX step's ``write_ring`` (compile.py:260-274) as it stands
    there: the cast, then one slice at a shared slot or a scatter."""
    B = ring.shape[1]
    blk = blk.astype(ring.dtype)
    if uniform:
        wpos0 = jnp.mod(t + delay[0], B)
        zero = jnp.zeros((), wpos0.dtype)      # one index type under x64
        return jax.lax.dynamic_update_slice(
            ring, blk[:, None], (zero, wpos0) + (zero,) * (blk.ndim - 1))
    wpos = jnp.mod(t + delay[idx], B)
    return ring.at[idx, wpos].set(blk)


def _spectra(rng, Fs, M, real=np.float32):
    """Seeded M-point spectra of real frames: ``fft_points`` of the port
    (so bin 0 and the mirror pairs are what the engine glues)."""
    x = rng.standard_normal((Fs, 2 * M)).astype(real)
    return tg.fft_points(torch.as_tensor(x))


RING_CASES = {
    # name: (F, B, M, rows (None: 0..F-1), delays, t, dt, ring dtype)
    "uniform_delay": (4, 3, 256, None, [2, 2, 2, 2], 5, 0, "f32"),
    "per_filter_delays": (5, 4, 256, None, [0, 3, 1, 2, 3], 6, 0, "f32"),
    "stage_rows": (6, 4, 128, [4, 1, 5], [1, 0, 3, 2, 0, 1], 2, 0, "f32"),
    "dt_offset": (3, 4, 128, None, [0, 1, 2], 1, 3, "f32"),
    "two_of_three_rows": (3, 2, 512, [2, 0], [1, 1, 0], 3, 0, "f32"),
    "bf16_ring": (4, 3, 256, None, [0, 2, 1, 2], 4, 0, "bf16"),
    "bf16_stage_rows": (6, 3, 128, [5, 0, 3], [2, 1, 0, 2, 1, 0], 7, 1,
                        "bf16"),
    "float64": (4, 3, 256, None, [1, 0, 2, 2], 2, 0, "f64"),
    "float64_stage_rows": (5, 2, 128, [3, 4], [0, 1, 0, 1, 1], 9, 0,
                           "f64"),
}
DTYPES = {"f32": (torch.float32, jnp.float32, np.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16, np.float32),
          "f64": (torch.float64, jnp.float64, np.float64)}


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_glue_fwd_ring_matches_jax_glue_and_ring_write(rng, x64, case):
    """Every row of the ring the route writes holds the JAX glue of its
    spectra at the JAX ring write's slot, and every other row and slot is
    untouched."""
    F, B, M, rows, delays, t0, dt, kind = RING_CASES[case]
    tdt, jdt, real = DTYPES[kind]
    Fs = F if rows is None else len(rows)
    Zm = _spectra(rng, Fs, M, real)
    ring0 = rng.standard_normal((F, B, 2, M)).astype(real)
    ring = torch.as_tensor(ring0).to(tdt)
    delay = torch.tensor(delays, dtype=torch.int32)
    t = torch.tensor(t0, dtype=torch.int32)
    r32 = None if rows is None else torch.tensor(rows, dtype=torch.int32)
    n0 = dict(tg.launches)
    tg.glue_fwd_ring(Zm, ring, r32, delay, t, dt=dt)
    assert tg.launches == n0                  # the CPU runs no kernel
    idx = np.arange(F) if rows is None else np.asarray(rows)
    uniform = rows is None and len(set(delays)) == 1
    ref = _jax_write_ring(jnp.asarray(ring0).astype(jdt),
                          _jax_glue(Zm.numpy()), idx, t0 + dt,
                          jnp.asarray(delays, jnp.int32), uniform)
    got = ring.to(torch.float64).numpy()
    ref = np.asarray(ref.astype(jnp.float64))
    slots = (t0 + dt + np.asarray(delays)[idx]) % B
    written = np.zeros((F, B), bool)
    written[idx, slots] = True
    # rows and slots the route does not write keep their bits
    np.testing.assert_array_equal(got[~written], ref[~written])
    peak = np.abs(ref[written]).max()
    if kind == "bf16":
        # one bfloat16 step at the value's own exponent
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref[written]),
                                                   1e-30))) - 7)
        assert np.all(np.abs(got[written] - ref[written]) <= step)
        mine = tg.glue_fwd_reference(Zm).to(torch.bfloat16)
        assert torch.equal(ring[torch.as_tensor(idx),
                                torch.as_tensor(slots)], mine)
    else:
        rel = 1e-12 if kind == "f64" else 1e-5
        np.testing.assert_allclose(got[written], ref[written], rtol=0,
                                   atol=rel * peak)


@pytest.mark.parametrize("kind", ["f32", "bf16", "f64"])
def test_glue_fwd_into_a_strided_destination(rng, x64, kind):
    """The plain-destination form into one block of a grouped
    dispatch's ``xnews [F, G-1, 2, M]``: that block is the JAX glue cast
    to the ring's dtype (as the JAX group step casts its ``xnews``), the
    other blocks are untouched."""
    tdt, jdt, real = DTYPES[kind]
    F, G, M = 3, 4, 128
    Zm = _spectra(rng, F, M, real)
    xnews = torch.full((F, G - 1, 2, M), 7.0, dtype=tdt)
    tg.glue_fwd_into(Zm, xnews[:, 1])
    ref = np.asarray(_jax_glue(Zm.numpy()).astype(jdt).astype(jnp.float64))
    got = xnews.to(torch.float64).numpy()
    assert np.all(got[:, [0, 2]] == 7.0)
    if kind == "bf16":
        assert torch.equal(xnews[:, 1],
                           tg.glue_fwd_reference(Zm).to(torch.bfloat16))
        assert np.abs(got[:, 1] - ref).max() <= 2.0 ** -7 * np.abs(ref).max()
    else:
        rel = 1e-12 if kind == "f64" else 1e-5
        np.testing.assert_allclose(got[:, 1], ref, rtol=0,
                                   atol=rel * np.abs(ref).max())


def test_ring_and_destination_forms_give_the_same_bits(rng):
    """The grouped dispatch's two writes of one block, ``glue_fwd_into``
    into ``xnews`` and ``glue_fwd_ring`` into the ring, and the mesh's
    planes (``glue_fwd``), hold the same words."""
    F, B, M = 4, 3, 256
    Zm = _spectra(rng, F, M)
    for dtype in (torch.float32, torch.bfloat16):
        ring = torch.zeros((F, B, 2, M), dtype=dtype)
        tg.glue_fwd_ring(Zm, ring, None, torch.zeros(F, dtype=torch.int32),
                         torch.tensor(1, dtype=torch.int32))
        dst = torch.empty((F, 2, M), dtype=dtype)
        tg.glue_fwd_into(Zm, dst)
        assert torch.equal(ring[:, 1], dst)
        assert torch.equal(dst, tg.glue_fwd(Zm).to(dtype))


@pytest.mark.parametrize("C_in,F,M", [(2, 3, 256), (3, 5, 128),
                                      (1, 4, 1024)])
def test_mix_on_points_then_glue_matches_jax_mix_of_planes(rng, C_in, F, M):
    """The points route's first half, ``fft_points`` then ``mix_points``
    then the glue, against the JAX package's Pallas rfft of the frames
    and its ``complex_mix`` of the planes: the glue commutes with the
    mix."""
    x = rng.standard_normal((C_in, 2 * M)).astype(np.float32)
    mix = rng.standard_normal((F, C_in)).astype(np.float32)
    got = tg.glue_fwd_reference(tpc.mix_points(
        torch.as_tensor(mix), tg.fft_points(torch.as_tensor(x)))).numpy()
    ref = np.asarray(jpc.complex_mix(jnp.asarray(mix),
                                     jpg.rfft_planes_pallas(jnp.asarray(x))))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("N", [128, 256])
def test_convolve_eval_points_glued_matches_jax(rng, N):
    """The cascade input before its glue, glued, is the JAX package's
    ``convolve_eval`` (its tails too), and the planes form stays the
    glue of the points form bit for bit."""
    z = rng.standard_normal((3, 2, N)).astype(np.float32)
    prev = rng.standard_normal((3, N)).astype(np.float32)
    e, tails = tpc.convolve_eval_points(torch.as_tensor(z),
                                        torch.as_tensor(prev))
    e_ref, tails_ref = jpc.convolve_eval(jnp.asarray(z), jnp.asarray(prev),
                                         N)
    e_ref = np.asarray(e_ref)
    np.testing.assert_allclose(tg.glue_fwd_reference(e).numpy(), e_ref,
                               rtol=0, atol=1e-5 * np.abs(e_ref).max())
    np.testing.assert_allclose(tails.numpy(), np.asarray(tails_ref), rtol=0,
                               atol=1e-5 * np.abs(tails_ref).max())
    planes, _ = tpc.convolve_eval(torch.as_tensor(z), torch.as_tensor(prev))
    assert torch.equal(planes, tg.glue_fwd_reference(e))


def _ring_args():
    Zm = torch.zeros((3, 64), dtype=torch.complex64)
    return {"Zm": Zm, "ring": torch.zeros((4, 2, 2, 64)),
            "rows": torch.tensor([0, 2, 3], dtype=torch.int32),
            "delay": torch.zeros(4, dtype=torch.int32),
            "t": torch.tensor(0, dtype=torch.int32)}


BAD = {
    "real_spectra": ("Zm", torch.zeros((3, 64)), TypeError),
    "planes_not_points": ("Zm", torch.zeros((3, 2, 64),
                                            dtype=torch.complex64),
                          ValueError),
    "f64_ring_for_c64": ("ring", torch.zeros((4, 2, 2, 64),
                                             dtype=torch.float64), TypeError),
    "ring_length": ("ring", torch.zeros((4, 2, 2, 32)), ValueError),
    "ring_strided": ("ring", torch.zeros((4, 2, 2, 128))[..., ::2],
                     ValueError),
    "rows_long": ("rows", torch.tensor([0, 2, 3]), ValueError),
    "rows_count": ("rows", torch.tensor([0, 2], dtype=torch.int32),
                   ValueError),
    "delay_count": ("delay", torch.zeros(3, dtype=torch.int32), ValueError),
    "t_long": ("t", torch.tensor(0), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_glue_fwd_ring_rejects_what_the_kernel_does_not_take(case):
    key, bad, exc = BAD[case]
    args = _ring_args()
    args[key] = bad
    with pytest.raises(exc):
        tg.glue_fwd_ring(args["Zm"], args["ring"], args["rows"],
                         args["delay"], args["t"])


def test_glue_fwd_into_rejects_split_planes():
    """A destination whose planes are not contiguous (plane stride other
    than M) is refused: the kernel writes plane 1 at plane 0 + M."""
    Zm = torch.zeros((2, 64), dtype=torch.complex64)
    with pytest.raises(ValueError):
        tg.glue_fwd_into(Zm, torch.zeros((2, 64, 2)).transpose(1, 2))
    with pytest.raises(ValueError):
        tg.glue_fwd_into(Zm, torch.zeros((3, 2, 64)))


# --- engines file to file: the route's calls -----------------------------

def _route_spy(monkeypatch):
    """Count the forward route's wrapper calls in ``fft_glue``."""
    calls = {"glue_fwd": 0, "glue_fwd_ring": 0, "glue_fwd_into": 0}
    for name in calls:
        def spy(*a, _o=getattr(tg, name), _n=name, **k):
            calls[_n] += 1
            return _o(*a, **k)
        monkeypatch.setattr(tg, name, spy)
    return calls


@pytest.mark.parametrize("pair,G", [("force", 2), ("force:4", 4)])
def test_grouped_engine_lands_every_block_through_the_ring_kernel(
        tmp_path, monkeypatch, pair, G):
    """The batch of 8 in groups of G against the JAX engine (within 1
    LSB): per group, G ring writes by ``glue_fwd_ring`` (block t before
    the group kernel, blocks t+1 .. after it) and G - 1 blocks of
    ``xnews`` by ``glue_fwd_into``; the EOF tail block by block, one ring
    write a block; no ``glue_fwd``."""
    from brutefir_tpu.config import parse_config as jax_parse_config
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.config import parse_config
    from brutefir_tpu_torch.runtime.engine import Engine
    from tests.test_torch_group_step import _config, _taps
    N, delays = 256, [0, 1, 2]
    for i, n in enumerate((N * 4, N * 3 + 17, N * 2)):
        _taps(tmp_path / f"c{i}.txt", n, seed=i + 31)
    frames = N * 11 + 101
    x = np.clip(np.round(np.random.default_rng(33).standard_normal(
        (frames, 3)) * 2.0 ** 18), -(2 ** 23), 2 ** 23 - 1)
    x.astype("<i4").tofile(tmp_path / "in.raw")
    monkeypatch.setenv("BRUTEFIR_TPU_MAC", "pallas")
    monkeypatch.setenv("BRUTEFIR_TPU_PAIR", pair)
    JaxEngine(jax_parse_config(_config(tmp_path, "out_jax.raw", delays))
              ).run_offline(batch_blocks=8)
    calls = _route_spy(monkeypatch)
    stats = Engine(parse_config(_config(tmp_path, "out_torch.raw", delays)),
                   device=CPU).run_offline()
    groups, tail = 8 // G, stats["blocks"] - 8
    assert tail > 0
    assert calls == {"glue_fwd": 0, "glue_fwd_ring": groups * G + tail,
                     "glue_fwd_into": groups * (G - 1)}
    yj = np.fromfile(tmp_path / "out_jax.raw", "<i4").astype(np.int64)
    yt = np.fromfile(tmp_path / "out_torch.raw", "<i4").astype(np.int64)
    assert yt.size == yj.size == frames * 3
    assert np.abs(yj).max() > 2 ** 18
    assert np.abs(yt - yj).max() <= 1


@pytest.mark.parametrize("pair,into", [("0", 0), ("force:4", 6)])
def test_mesh_engine_glues_planes_and_equals_the_ring_kernel_route(
        tmp_path, monkeypatch, pair, into):
    """A 2 x 2 mesh on the CPU against the JAX engine on its mesh (1 LSB)
    and the port unsharded, block by block and with the batch of 8 in two
    groups of 4 (the unfused grouped MAC per shard): the mesh glues each
    block's mixed spectra into planes once (``glue_fwd``, one a block, a
    group's blocks included) and splits them; the port unsharded writes
    each block through ``glue_fwd_ring`` and a group's 3 later blocks
    into its ``xnews`` (``glue_fwd_into``) too; the 4-block tail runs
    block by block."""
    from tests.test_torch_mesh import _config, _run_pair, _s24_input, _taps
    C, N, B = 4, 512, 2
    _taps(tmp_path, 2, N * B, 41)
    frames = N * 11 + 19
    _s24_input(tmp_path, frames, C, 42)
    monkeypatch.setenv("BRUTEFIR_TPU_PAIR", pair)
    calls = _route_spy(monkeypatch)
    (yj, yt, y1), te, _ = _run_pair(
        tmp_path, monkeypatch,
        lambda name: _config(tmp_path, name, C, N, B, sets=[0, 1, 1, 0]),
        "2x2")
    assert te.mesh.shape == {"f": 2, "sp": 2}
    assert calls["glue_fwd_into"] == into
    assert calls["glue_fwd"] == calls["glue_fwd_ring"] >= frames // N
    assert yt.size == yj.size == y1.size == frames * C
    assert np.abs(yj).max() > 2 ** 18
    assert np.abs(yt - yj).max() <= 1
    assert np.abs(yt - y1).max() <= 1
