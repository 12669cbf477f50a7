"""The grouped offline dispatch: the port's ``group_step_impl`` against
the JAX package's ``_group_step_impl`` (Pallas in interpret mode, lane-
tiled state) from one converted mid-stream state; the port's
``group_size`` against the JAX one over a table of shapes, batch sizes
and ``BRUTEFIR_TPU_PAIR`` / ``BRUTEFIR_TPU_GROUP_FORM`` settings; and the
engine file to file under ``BRUTEFIR_TPU_PAIR=force:4`` against the JAX
engine.

Tolerances: y within atol 1e-5 at O(1) signals (float32 FFTs, mixes and
partition sums in another order), the ring within 1e-6 of its peak, S24
words within 1 LSB at normal levels (docs/PARITY.md "Float-tolerance")."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from brutefir_tpu.config import parse_config as jax_parse_config
from brutefir_tpu.graph import compile as jcomp
from brutefir_tpu.graph.spec import build_graph_spec as jax_spec
from brutefir_tpu.ops.pallas_mac import (
    group_mix_fusable as jax_group_mix_fusable)
from brutefir_tpu.ops.partconv import make_bank, preprocess_coeffs
from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.convert import (bank_from_jax, ctrl_from_jax,
                                        state_from_jax)
from brutefir_tpu_torch.graph import compile as tcomp
from brutefir_tpu_torch.graph.spec import build_graph_spec

N, B, C = 256, 5, 4
CPU = torch.device("cpu")

CASES = {
    # name: (G, BRUTEFIR_TPU_GROUP_FORM, coeff_idx, delay, uniform_delay,
    #        powersave, the port's kernel)
    "fused_g2": (2, "", [0, 1, 2, 0], [0, 1, 3, 2], False, False,
                 "mac_mix_group"),
    "fused_g4": (4, "", [0, 1, 2, 0], [0, 1, 3, 4], False, False,
                 "mac_mix_group"),
    "unfused_g4": (4, "unfused", [2, 1, 0, 1], [0, 1, 3, 4], False, False,
                   "mac_group"),
    "unfused_g3": (3, "unfused", [0, 1, 2, 0], [2, 0, 1, 3], False, False,
                   "mac_group"),
    "uniform_delay_g3": (3, "", [1, 1, 1, 1], [2, 2, 2, 2], True, False,
                         "mac_mix_group"),
    "powersave_g4": (4, "", [0, 1, 2, 0], [0, 1, 0, 2], False, True,
                     "mac_mix_group"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_group_step_matches_jax(rng, monkeypatch, case):
    G, form, idx, delay, udl, powersave, kernel = CASES[case]
    monkeypatch.setenv("BRUTEFIR_TPU_GROUP_FORM", form)
    idx = np.asarray(idx, np.int32)
    delay = np.asarray(delay, np.int32)
    entries = [preprocess_coeffs(
        (rng.standard_normal(N * n) * 0.05).astype(np.float32), N, B)
        for n in (B, 3, 2)]
    bank = make_bank(entries)                               # [3, B, 2, N]
    n_blocks = np.array([B, 3, 2])
    mask = np.zeros((C, B), np.float32)
    for f in range(C):                   # the host's cblocks clamp
        mask[f, :min(n_blocks[idx[f]], B - delay[f])] = 1.0
    in_mix = rng.standard_normal((C, C)).astype(np.float32)
    out_mix = rng.standard_normal((C, C)).astype(np.float32)
    ps = np.array([0.0, 0.05, 0.05, 0.0], np.float32) if powersave else None

    jspec = jax_spec(N, B, C, C, [[] for _ in range(C)], [False] * C,
                     powersave=powersave)
    tspec = build_graph_spec(N, B, C, C, [[] for _ in range(C)],
                             [False] * C, powersave=powersave)
    jctrl = jcomp.make_ctrl(jspec, in_mix, np.zeros((C, C), np.float32),
                            out_mix, delay, idx, mask, ps_thresh=ps)
    jstep = jax.jit(functools.partial(
        jcomp._step_impl, jspec, "pallas-interpret", tiled=True,
        uniform_delay=udl))
    jgroup = jax.jit(functools.partial(
        jcomp._group_step_impl, jspec, "pallas-interpret",
        uniform_delay=udl))
    jbank = jnp.asarray(bank.reshape(3, B, 2, N // 128, 128))
    jstate = jcomp.CompiledGraph(jspec, mac="pallas-interpret").init_state()

    xs = (rng.standard_normal((7 + 2 * G, C, N)) * 0.5).astype(np.float32)
    if powersave:
        xs[8:, 1] *= 1e-3          # channel 1 falls quiet mid-group
        xs[6:, 2] = 0.0            # channel 2 silent
    # JAX alone, block by block, to a mid-stream state (t wraps the ring)
    for xb in xs[:7]:
        jstate, _ = jstep(jstate, jctrl, jbank, jnp.asarray(xb))
    tstate = state_from_jax(np.asarray(jstate.prev_in),
                            np.asarray(jstate.ring),
                            np.asarray(jstate.eval_prev), jstate.t, CPU)
    tctrl = ctrl_from_jax(jctrl, CPU)
    tbank = bank_from_jax(np.asarray(jbank), CPU)

    taken = []

    def spy(name, orig, *args):
        taken.append(name)
        return orig(*args)

    for name in ("mac_group", "mac_mix_group"):
        monkeypatch.setattr(tcomp, name, functools.partial(
            spy, name, getattr(tcomp, name)))
    for g0 in (7, 7 + G):
        xg = xs[g0:g0 + G]
        jstate, yj = jgroup(jstate, jctrl, jbank,
                            [jnp.asarray(x) for x in xg])
        tstate, yt = tcomp.group_step_impl(
            tspec, tstate, tctrl, tbank, [torch.as_tensor(x) for x in xg],
            uniform_delay=udl)
        assert len(yt) == len(yj) == G
        for a, b in zip(yt, yj):
            assert a.shape == (C, N)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5)
    assert taken == [kernel, kernel]
    assert int(tstate.t) == int(jstate.t) == 7 + 2 * G
    ring_j = np.asarray(jstate.ring).reshape(C, B, 2, N)
    np.testing.assert_allclose(tstate.ring.numpy(), ring_j, rtol=0,
                               atol=1e-6 * np.abs(ring_j).max())


SHAPES = [
    # (N, B, channels, cascade)
    (8192, 16, 256, False),    # the 256-channel scale shape
    (8192, 16, 26, False),     # massive_config: not big
    (8192, 32, 128, False),
    (16384, 16, 256, False),
    (65536, 4, 2, False),
    (256, 4, 3, False),
    (192, 4, 3, False),        # not tileable
    (256, 4, 3, True),         # a cascade
]


@pytest.mark.parametrize("form", ["", "unfused"])
@pytest.mark.parametrize("pair", [None, "2", "4", "8", "0", "1", "force",
                                  "force:4", "force:3", "bogus"])
def test_group_size_matches_jax(monkeypatch, pair, form):
    if pair is None:
        monkeypatch.delenv("BRUTEFIR_TPU_PAIR", raising=False)
    else:
        monkeypatch.setenv("BRUTEFIR_TPU_PAIR", pair)
    monkeypatch.setenv("BRUTEFIR_TPU_GROUP_FORM", form)
    seen = set()
    for n, b, c, casc in SHAPES:
        fin = [[] for _ in range(c)]
        if casc:
            fin[1] = [0]
        js = jax_spec(n, b, c, c, fin, [False] * c)
        ts = build_graph_spec(n, b, c, c, fin, [False] * c)
        for m in (8, 6, 5, 4):
            want = jcomp.group_size(js, "pallas-interpret", None, None, m)
            got = tcomp.group_size(ts, m)
            assert got == want, (n, b, c, casc, m)
            if want >= 2:
                # the form _group_step_impl takes (compile.py:718-719)
                fused = (form != "unfused"
                         and jax_group_mix_fusable(want, c, b, n, c))
                assert tcomp._group_fused(ts, want) == fused
                seen.add((want, fused))
    if pair in (None, "4", "8") and form == "":
        assert (4, False) in seen          # the scale shape: G=4 unfused
    if pair == "2" and form == "":
        assert (2, True) in seen           # ... and G=2 fused


@pytest.mark.parametrize("pair", [None, "4", "force:4"])
def test_group_size_stands_down_without_fused_mix(monkeypatch, pair):
    """BRUTEFIR_TPU_FUSED_MIX=0 turns the grouped dispatch off in both
    packages, at every shape of the table."""
    if pair is None:
        monkeypatch.delenv("BRUTEFIR_TPU_PAIR", raising=False)
    else:
        monkeypatch.setenv("BRUTEFIR_TPU_PAIR", pair)
    monkeypatch.setenv("BRUTEFIR_TPU_FUSED_MIX", "0")
    for n, b, c, casc in SHAPES:
        fin = [[] for _ in range(c)]
        js = jax_spec(n, b, c, c, fin, [False] * c)
        ts = build_graph_spec(n, b, c, c, fin, [False] * c)
        assert jcomp.group_size(js, "pallas-interpret", None, None, 8) == 1
        assert tcomp.group_size(ts, 8) == 1
    # and the same table groups somewhere with the switch back on
    monkeypatch.setenv("BRUTEFIR_TPU_FUSED_MIX", "1")
    assert max(tcomp.group_size(build_graph_spec(
        n, b, c, c, [[] for _ in range(c)], [False] * c), 8)
        for n, b, c, _ in SHAPES) >= 2


def _taps(path, n, seed):
    t = (np.random.default_rng(seed).standard_normal(n) * 0.05)
    path.write_text("\n".join(repr(float(v)) for v in t) + "\n")


def _config(tmp_path, name, delays, n_coeff=3, N=256, B=4):
    C = len(delays)
    chans = ",".join(str(i) for i in range(C))
    coeffs = "".join(
        f'coeff {i} {{ filename: "{tmp_path / f"c{i}.txt"}"; '
        f'format: "TEXT"; }};\n' for i in range(n_coeff))
    filters = "".join(
        f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; "
        f"coeff: {i % n_coeff}; delay: {d}; }};\n"
        for i, d in enumerate(delays))
    return f"""
sampling_rate: 44100;
filter_length: {N},{B};
{coeffs}
input {chans} {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: {C}; }};
output {chans} {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "S24_4LE"; channels: {C}; dither: false; }};
{filters}"""


@pytest.mark.parametrize("pair,form,G", [("force:4", "", 4),
                                         ("force:4", "unfused", 4),
                                         ("force", "", 2)])
def test_engine_grouped_matches_jax(tmp_path, monkeypatch, pair, form, G):
    """File to file with the batch of 8 blocks grouped (then the EOF tail
    block by block): the port's S24 words against the JAX engine's. Both
    engines are spied to prove they took the grouped dispatch."""
    import brutefir_tpu.graph.compile as jc
    import brutefir_tpu_torch.runtime.device_io as tdio
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    N, delays = 256, [0, 1, 2]
    for i, n in enumerate((N * 4, N * 3 + 17, N * 2)):
        _taps(tmp_path / f"c{i}.txt", n, seed=i + 1)
    frames = N * 11 + 101
    x = np.clip(np.round(np.random.default_rng(21).standard_normal(
        (frames, 3)) * 2.0 ** 18), -(2 ** 23), 2 ** 23 - 1)
    x.astype("<i4").tofile(tmp_path / "in.raw")
    monkeypatch.setenv("BRUTEFIR_TPU_MAC", "pallas")
    monkeypatch.setenv("BRUTEFIR_TPU_PAIR", pair)
    monkeypatch.setenv("BRUTEFIR_TPU_GROUP_FORM", form)

    taken_j, taken_t = [], []

    def spy(taken, orig, *args, **kwargs):
        taken.append(len(args[-1]))             # the group's blocks, xs
        return orig(*args, **kwargs)

    monkeypatch.setattr(jc, "_group_step_impl", functools.partial(
        spy, taken_j, jc._group_step_impl))
    monkeypatch.setattr(tdio, "group_step_impl", functools.partial(
        spy, taken_t, tdio.group_step_impl))

    jeng = JaxEngine(jax_parse_config(_config(tmp_path, "out_jax.raw",
                                              delays)))
    assert jeng.cg.mac == "pallas-interpret"
    js = jeng.run_offline(batch_blocks=8)
    ts = Engine(parse_config(_config(tmp_path, "out_torch.raw", delays)),
                device=CPU).run_offline()
    assert taken_j and set(taken_j) == {G}
    assert taken_t == [G] * (8 // G)
    assert ts["frames"] == js["frames"] == frames
    assert ts["overflows"] == js["overflows"] == [0] * 3
    yj = np.fromfile(tmp_path / "out_jax.raw", "<i4").astype(np.int64)
    yt = np.fromfile(tmp_path / "out_torch.raw", "<i4").astype(np.int64)
    assert yt.size == yj.size == frames * 3
    assert np.abs(yj).max() > 2 ** 18
    assert np.abs(yt - yj).max() <= 1
