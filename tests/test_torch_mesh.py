"""Multi-device sharding: the port's mesh (``brutefir_tpu_torch/parallel``)
and shard forms (``ops/mac_shard.py``) against the JAX package's, and the
sharded engine against the unsharded one and against the JAX engine.

The port's shards run on ``torch.device("cpu")``, several a mesh; the JAX
side on the 8 virtual CPU devices of tests/conftest.py, its Pallas
kernels interpreted (``interpret=True``, ``BRUTEFIR_TPU_MAC=pallas``), as
tests/test_parallel.py runs them.

- The kernels' ``has_bin0`` flag, on their plain versions: False makes
  bin 0 an ordinary complex product, True is today's function bit for
  bit.
- The four shard forms on 2 x 2 and 1 x 4 meshes against the JAX
  ``*_shmap`` wrappers (atol 1e-4 of unit-scale input) and against the
  port's unsharded call (bit-equal where f = 1: each bin's arithmetic is
  the same; 1e-5 of the peak where f > 1, the sum over 'f' in another
  order).
- ``auto_mesh`` makes the JAX package's choice over 1-8 devices, a grid
  of filters and bins, with and without ``f_pref``; malformed
  ``BRUTEFIR_TPU_MESH`` values are the same typed config error.
- Engines file to file under the same ``BRUTEFIR_TPU_MESH``: S24 words
  within 1 LSB of the JAX engine and of the port unsharded, FLOAT_LE
  within 2e-4 (tests/test_parallel.py's tolerance); a float64 graph on
  1 x 2 and 2 x 1 within 1e-12 of the peak of the port unsharded.
- ``run_offline`` batched under a mesh equals ``run()`` under it; the
  ``BRUTEFIR_TPU_BATCH`` knob; ``BRUTEFIR_TPU_WIRE_PACK24=0``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from brutefir_tpu.config import parse_config as jax_parse_config
from brutefir_tpu.errors import BFError as JaxBFError
from brutefir_tpu.ops import pallas_mac as jpm
from brutefir_tpu.parallel import mesh as jmesh
from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.errors import BFError, BF_EXIT_INVALID_CONFIG
from brutefir_tpu_torch.ops import mac_shard as ms
from brutefir_tpu_torch.ops import (mac as tm, mac_dual as td,
                                    mac_group as tg, mac_mix as tmm)
from brutefir_tpu_torch.parallel import mesh as tmesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

CPU = torch.device("cpu")


def _f32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _meshes(f, sp):
    return (jmesh.make_mesh(jax.devices()[:f * sp], f_axis=f, sp_axis=sp),
            tmesh.make_mesh([CPU] * (f * sp), f_axis=f, sp_axis=sp))


# --- the kernels' has_bin0 flag, on the plain versions ------------------------

def _mac_inputs(rng, F=4, B=3, K=256, E=2):
    ring = _f32(rng.standard_normal((F, B, 2, K)))
    bank = _f32(rng.standard_normal((E, B, 2, K)))
    idx = torch.as_tensor(np.arange(F) % E, dtype=torch.int32)
    mask = _f32(rng.uniform(size=(F, B)) > 0.2)
    return ring, bank, idx, mask


def _complex_bin0(ring, bank, idx, mask, t, rows=None):
    """Bin 0 as an ordinary complex product, in float64: the oracle of
    ``has_bin0=False``."""
    B = ring.shape[1]
    r = np.arange(ring.shape[0]) if rows is None else np.asarray(rows)
    z = (ring[r, :, 0, 0].double() + 1j * ring[r, :, 1, 0].double()).numpy()
    hb = bank[idx.long()[r]][:, :, :, 0].double()
    h = (hb[:, :, 0] + 1j * hb[:, :, 1]).numpy() * mask[r].double().numpy()
    slots = (int(t) - np.arange(B)) % B
    return (z[:, slots] * h).sum(axis=1)


PLAIN = ("mac", "mac_uniform", "mac_dual", "mac_mix", "mac_group",
         "mac_mix_group")


def _plain_call(name, rng, has_bin0):
    ring, bank, idx, mask = _mac_inputs(rng)
    t = torch.tensor(4, dtype=torch.int32)
    rows = torch.tensor([3, 0, 2], dtype=torch.int32)
    kw = {} if has_bin0 is None else {"has_bin0": has_bin0}
    w = _f32(rng.standard_normal((2, 4)))
    if name in ("mac", "mac_uniform"):
        return tm.mac_reference(ring, bank, rows, idx, mask, t,
                                name == "mac_uniform", **kw)
    if name == "mac_dual":
        return torch.cat(td.mac_dual_reference(
            ring, bank, rows, idx, mask, idx.flip(0).contiguous(), mask, t,
            False, **kw))
    if name == "mac_mix":
        return tmm.mac_mix_reference(ring, bank, idx, mask, t, w, False, **kw)
    xnews = _f32(rng.standard_normal((4, 2, 2, 256)))
    delay = torch.tensor([0, 1, 0, 2], dtype=torch.int32)
    if name == "mac_group":
        return tg.mac_group_reference(ring, xnews, bank, idx, mask, t, delay,
                                      **kw)
    return tg.mac_mix_group_reference(ring, xnews, bank, idx, mask, t, w,
                                      delay, **kw)


@pytest.mark.parametrize("name", PLAIN)
def test_plain_has_bin0_true_is_todays_function(name):
    a = _plain_call(name, np.random.default_rng(5), None)
    b = _plain_call(name, np.random.default_rng(5), True)
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", PLAIN)
def test_plain_has_bin0_false_makes_bin0_a_complex_product(name):
    a = _plain_call(name, np.random.default_rng(6), True)
    b = _plain_call(name, np.random.default_rng(6), False)
    # every other bin is untouched, bit for bit
    assert torch.equal(a[..., 1:], b[..., 1:])
    assert not torch.equal(a[..., 0], b[..., 0])
    if name in ("mac", "mac_uniform"):
        ring, bank, idx, mask = _mac_inputs(np.random.default_rng(6))
        if name == "mac_uniform":
            idx = torch.full_like(idx, int(idx[3]))
            mask = mask[3:4].expand_as(mask).contiguous()
        want = _complex_bin0(ring, bank, idx, mask, 4, [3, 0, 2])
        got = b[:, 0, 0].double().numpy() + 1j * b[:, 1, 0].double().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# --- the shard forms against the JAX shmap wrappers -----------------------------

F_S, B_S, K_S, E_S, C_S = 4, 2, 1024, 3, 3
FORMS = ("mix_uniform", "mix_rows", "mac", "dual_uniform", "dual_rows",
         "group")


def _shard_inputs(seed, uniform):
    rng = np.random.default_rng(seed)
    ring = rng.standard_normal((F_S, B_S, 2, K_S)).astype(np.float32)
    bank = rng.standard_normal((E_S, B_S, 2, K_S)).astype(np.float32)
    if uniform:
        idx = np.full(F_S, 1, np.int32)
        mask = np.tile((rng.uniform(size=B_S) > 0.2).astype(np.float32),
                       (F_S, 1))
        pidx = np.full(F_S, 2, np.int32)
        pmask = np.tile(np.ones(B_S, np.float32), (F_S, 1))
    else:
        idx = (np.arange(F_S) % E_S).astype(np.int32)
        mask = (rng.uniform(size=(F_S, B_S)) > 0.2).astype(np.float32)
        pidx = ((np.arange(F_S) + 1) % E_S).astype(np.int32)
        pmask = np.ones((F_S, B_S), np.float32)
        pmask[1, -1] = 0.0
    w = rng.standard_normal((C_S, F_S)).astype(np.float32)
    xnews = rng.standard_normal((F_S, 3, 2, K_S)).astype(np.float32)
    delay = np.array([0, 1, 0, 2], np.int32)
    return ring, bank, idx, mask, pidx, pmask, w, xnews, delay


def _jax_form(form, jm, a):
    ring, bank, idx, mask, pidx, pmask, w, xnews, delay = a
    t = jnp.int32(5)
    J = jnp.asarray
    if form.startswith("mix"):
        return np.asarray(jpm.pallas_spectral_mac_mix_shmap(
            jm, J(ring), J(bank), J(idx), J(mask), t, J(w),
            uniform=form == "mix_uniform", interpret=True))
    if form == "mac":
        return np.asarray(jpm.pallas_spectral_mac_shmap(
            jm, J(ring), J(bank), J(idx), J(mask), t, interpret=True))
    if form.startswith("dual"):
        yn, yo = jpm.pallas_spectral_mac_dual_shmap(
            jm, J(ring), J(bank), J(idx), J(mask), J(pidx), J(pmask), t,
            uniform=form == "dual_uniform", interpret=True)
        return np.concatenate([np.asarray(yn), np.asarray(yo)])
    R = K_S // 128
    ys = jpm.pallas_spectral_mac_group_shmap(
        jm, J(ring.reshape(F_S, B_S, 2, R, 128)),
        J(xnews.reshape(F_S, 3, 2, R, 128)),
        J(bank.reshape(E_S, B_S, 2, R, 128)), J(idx), J(mask), t,
        J(delay), interpret=True)
    return np.stack([np.asarray(y) for y in ys])


def _port_form(form, tmsh, a):
    ring, bank, idx, mask, pidx, pmask, w, xnews, delay = (
        torch.as_tensor(v) for v in a)
    t = torch.tensor(5, dtype=torch.int32)
    rows = np.arange(F_S)
    if tmsh is None:                        # the unsharded call
        r32 = torch.arange(F_S, dtype=torch.int32)
        if form.startswith("mix"):
            return tmm.mac_mix(ring, bank, idx, mask, t, w,
                               form == "mix_uniform")
        if form == "mac":
            return tm.mac(ring, bank, r32, idx, mask, t, False)
        if form.startswith("dual"):
            return torch.cat(td.mac_dual(ring, bank, r32, idx, mask, pidx,
                                         pmask, t, form == "dual_uniform"))
        return tg.mac_group(ring, xnews, bank, idx, mask, t, delay)
    sp = tmesh.split
    R, Bk = sp(tmsh, ring, 0, 3), sp(tmsh, bank, None, 3)
    I, M = sp(tmsh, idx, 0), sp(tmsh, mask, 0)
    if form.startswith("mix"):
        return ms.mac_mix_shard(tmsh, R, Bk, I, M, t, sp(tmsh, w, 1),
                                form == "mix_uniform")
    if form == "mac":
        return ms.mac_shard(tmsh, R, Bk, rows, I, M, t)
    if form.startswith("dual"):
        return torch.cat(ms.mac_dual_shard(
            tmsh, R, Bk, rows, I, M, sp(tmsh, pidx, 0), sp(tmsh, pmask, 0), t,
            form == "dual_uniform"))
    return ms.mac_group_shard(tmsh, R, sp(tmsh, xnews, 0, 3), Bk, I, M, t,
                              sp(tmsh, delay, 0))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("form", FORMS)
def test_shard_form_matches_jax_shmap(form, shape):
    jm, tmsh = _meshes(*shape)
    a = _shard_inputs(11, form.endswith("uniform"))
    got = _port_form(form, tmsh, a).numpy()
    want = _jax_form(form, jm, a)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # against the port's unsharded call
    one = _port_form(form, None, a)
    if shape[0] == 1 or not form.startswith("mix"):
        assert torch.equal(torch.as_tensor(got), one)
    else:
        assert np.abs(got - one.numpy()).max() <= 1e-5 * np.abs(got).max()


def test_shard_form_stage_subset_and_uneven_mesh():
    """A cascade's stage subset (rows in any order) and a mesh whose axes
    do not divide F or K: the per-shard MACs on the rows each shard
    holds give the unsharded call bit for bit."""
    rng = np.random.default_rng(12)
    F, B, K = 5, 3, 300
    ring = _f32(rng.standard_normal((F, B, 2, K)))
    bank = _f32(rng.standard_normal((2, B, 2, K)))
    idx = torch.tensor([0, 1, 1, 0, 1], dtype=torch.int32)
    mask = torch.ones(F, B)
    pidx = torch.tensor([1, 0, 0, 1, 1], dtype=torch.int32)
    t = torch.tensor(2, dtype=torch.int32)
    rows = np.array([4, 1, 3, 0])
    r32 = torch.as_tensor(rows, dtype=torch.int32)
    for f, sp in ((2, 2), (3, 1), (1, 3), (2, 4)):
        m = tmesh.make_mesh([CPU] * (f * sp), f, sp)
        S = tmesh.split
        R, Bk = S(m, ring, 0, 3), S(m, bank, None, 3)
        got = ms.mac_shard(m, R, Bk, rows, S(m, idx, 0), S(m, mask, 0), t)
        assert torch.equal(got, tm.mac(ring, bank, r32, idx, mask, t, False))
        yn, yo = ms.mac_dual_shard(m, R, Bk, rows, S(m, idx, 0),
                                   S(m, mask, 0), S(m, pidx, 0),
                                   S(m, mask, 0), t)
        wn, wo = td.mac_dual(ring, bank, r32, idx, mask, pidx, mask, t,
                             False)
        assert torch.equal(yn, wn) and torch.equal(yo, wo)
        assert torch.equal(tmesh.gather(R), ring)


@pytest.mark.parametrize("shape,K", [((2, 4), 128), ((2, 2), 512),
                                     ((1, 4), 1024)])
def test_sharded_graph_equals_single(shape, K):
    """``ShardedGraph`` (init_state, place, step) against the unsharded
    step block by block (tests/test_parallel.py:17-47 on the port): the
    per-shard stage loop where the shape does not shard (K = 128), the
    fused MAC + mix per shard where it does."""
    from brutefir_tpu_torch.graph import compile as tcomp
    from brutefir_tpu_torch.graph.spec import build_graph_spec
    from brutefir_tpu_torch.ops.partconv import np_c2p, preprocess_coeffs
    rng = np.random.default_rng(30)
    N, B, C = K, 4, 8
    taps = rng.standard_normal(N * B).astype(np.float32) * 0.1
    spec = build_graph_spec(N, B, C, C, [[] for _ in range(C)], [False] * C)
    bank = torch.as_tensor(np_c2p(np.stack([preprocess_coeffs(taps, N, B)])))
    eye = np.eye(C, dtype=np.float32)
    ctrl = tcomp.make_ctrl(spec, eye, eye, np.zeros(C, np.int32),
                           np.zeros(C, np.int32), np.ones((C, B), np.float32),
                           device=CPU)
    sg = tmesh.ShardedGraph(
        spec, tmesh.make_mesh([CPU] * (shape[0] * shape[1]), *shape))
    assert sg.kernel == (K >= 512)
    sctrl, sbank, _ = sg.place(ctrl, bank)
    st, sst = tcomp.init_state(spec, CPU), sg.init_state()
    for _ in range(6):
        x = torch.as_tensor(rng.standard_normal((C, N)).astype(np.float32))
        st, y1 = tcomp.step_impl(spec, st, ctrl, bank, x)
        sst, ys = sg.step(sst, sctrl, sbank, x)
        np.testing.assert_allclose(ys.numpy(), y1.numpy(), rtol=0, atol=1e-4)
    assert torch.equal(tmesh.gather(sst.ring), st.ring)


# --- make_mesh and auto_mesh against the JAX package --------------------------------

def _choice(m):
    return None if m is None else (m.shape["f"], m.shape["sp"],
                                   int(np.size(m.devices)))


@pytest.mark.parametrize("n", range(1, 9))
def test_auto_mesh_matches_jax(n):
    for fp in (0, 2, 3):
        for nf in (1, 2, 3, 4, 6, 8, 26):
            for nb in (128, 256, 512, 1024, 8192):
                for dt in (np.float32, np.float64):
                    want = _choice(jmesh.auto_mesh(
                        nf, nb, np.dtype(dt), devices=jax.devices()[:n],
                        env="auto", f_pref=fp))
                    got = _choice(tmesh.auto_mesh(
                        nf, nb, np.dtype(dt), devices=[CPU] * n,
                        env="auto", f_pref=fp))
                    assert got == want, (n, fp, nf, nb, dt)


@pytest.mark.parametrize("env", ["off", "none", "0", "1", "2x4", "2", "4x2",
                                 "1x8", "3x2", " Auto "])
def test_auto_mesh_env_matches_jax(env):
    want = _choice(jmesh.auto_mesh(26, 8192, np.dtype(np.float32),
                                   devices=jax.devices()[:8], env=env))
    got = _choice(tmesh.auto_mesh(26, 8192, np.dtype(np.float32),
                                  devices=[CPU] * 8, env=env))
    assert got == want


@pytest.mark.parametrize("env", ["2y3", "0x2", "4x4", "x", "-1x2", "2x-1"])
def test_mesh_env_malformed_is_typed_config_error(env):
    errs = []
    for fn, devs in ((jmesh.auto_mesh, jax.devices()[:8]),
                     (tmesh.auto_mesh, [CPU] * 8)):
        with pytest.raises((BFError, JaxBFError)) as ei:
            fn(4, 128, np.dtype(np.float32), devices=devs, env=env)
        assert ei.value.exit_code == BF_EXIT_INVALID_CONFIG
        errs.append(str(ei.value))
    assert errs[0] == errs[1]
    assert isinstance(ei.value, BFError)


def test_mesh_env_malformed_raises_before_any_device_query(monkeypatch):
    monkeypatch.setattr(tmesh, "default_devices", lambda *a: 1 / 0)
    with pytest.raises(BFError):
        tmesh.auto_mesh(4, 128, np.float32, env="2y3")


@pytest.mark.parametrize("n,f", [(6, 4), (4, 0), (2, 3)])
def test_make_mesh_errors_match_jax(n, f):
    msgs = []
    for fn, devs in ((jmesh.make_mesh, jax.devices()[:n]),
                     (tmesh.make_mesh, [CPU] * n)):
        with pytest.raises(ValueError) as ei:
            fn(devs, f_axis=f)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_default_devices(monkeypatch):
    """An automatic mesh spreads over every visible card for an engine on
    ``cuda``; an engine on the CPU or on a named card has only that."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert tmesh.default_devices(torch.device("cuda")) == [
        torch.device(f"cuda:{k}") for k in range(3)]
    assert tmesh.default_devices() == tmesh.default_devices("cuda")
    assert tmesh.default_devices("cuda:1") == [torch.device("cuda:1")]
    assert tmesh.default_devices(CPU) == [CPU]


def test_make_mesh_layout_and_shardable():
    m = tmesh.make_mesh([torch.device(f"cpu:{k}") for k in range(8)], 2)
    assert m.shape == {"f": 2, "sp": 4}
    assert [str(d) for d in m.devices[1]] == ["cpu:4", "cpu:5", "cpu:6",
                                              "cpu:7"]
    assert m.rows(26) == [(0, 13), (13, 26)]
    assert m.bins(8192)[3] == (6144, 8192)
    jm = jmesh.make_mesh(jax.devices()[:8], f_axis=2)
    for F in (2, 3, 26):
        for K in (256, 512, 1024, 8192):
            for dt in (np.float32, np.float64):
                assert (tmesh.shardable(m, F, K, dt)
                        == jpm.pallas_shardable(jm, F, K, dt))


# --- engines file to file --------------------------------------------------------

def _taps(tmp_path, n, length, seed):
    rng = np.random.default_rng(seed)
    for i in range(n):
        (tmp_path / f"c{i}.txt").write_text("\n".join(
            repr(float(v)) for v in rng.standard_normal(length) * 0.1))


def _config(tmp_path, name, C, N, B, fmt="S24_4LE", sets=None, extra="",
            filters=None, infile="in.raw"):
    sets = sets if sets is not None else [0] * C
    chans = ",".join(str(i) for i in range(C))
    coeffs = "\n".join(
        f'coeff {i} {{ filename: "{tmp_path / f"c{i}.txt"}"; '
        f'format: "TEXT"; }};' for i in range(max(sets) + 1 if sets else 1))
    dither = "dither: false;" if fmt.startswith("S") else ""
    filters = filters if filters is not None else "\n".join(
        f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; "
        f"coeff: {sets[i]}; }};" for i in range(C))
    return f"""
sampling_rate: 44100;
filter_length: {N},{B};
{coeffs}
input {chans} {{ device: "file" {{ path: "{tmp_path / infile}"; }}; sample: "{fmt}"; channels: {C}; }};
output {chans} {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "{fmt}"; channels: {C}; {dither} }};
{filters}
{extra}
"""


def _s24_input(tmp_path, frames, C, seed, level=2.0 ** 18):
    rng = np.random.default_rng(seed)
    x = np.clip(np.round(rng.standard_normal((frames, C)) * level),
                -(2 ** 23), 2 ** 23 - 1).astype("<i4")
    x.tofile(tmp_path / "in.raw")
    return x


def _port_cpu_mesh(monkeypatch):
    """The port's automatic mesh on the CPU: eight shards of the one
    CPU, as tests/conftest.py gives the JAX package 8 virtual devices."""
    monkeypatch.setattr(tmesh, "default_devices", lambda *a: [CPU] * 8)


def _run_pair(tmp_path, monkeypatch, text_of, env, run="run_offline",
              dtype="<i4"):
    """The JAX engine and the port's under BRUTEFIR_TPU_MESH=env, and the
    port's unsharded: (outputs, port engine)."""
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    monkeypatch.setenv("BRUTEFIR_TPU_MAC", "pallas")
    _port_cpu_mesh(monkeypatch)
    monkeypatch.setenv("BRUTEFIR_TPU_MESH", env)
    jc = jax_parse_config(text_of("out_jax.raw"))
    jc.quiet = True
    je = JaxEngine(jc)
    tc = parse_config(text_of("out_torch.raw"))
    tc.quiet = True
    te = Engine(tc, device=CPU)
    for e in (je, te):
        getattr(e, run)()
    monkeypatch.setenv("BRUTEFIR_TPU_MESH", "off")
    oc = parse_config(text_of("out_one.raw"))
    oc.quiet = True
    one = Engine(oc, device=CPU)
    assert one.mesh is None
    getattr(one, run)()
    ys = [np.fromfile(tmp_path / f"out_{k}.raw", dtype).astype(
        np.int64 if dtype == "<i4" else np.float64)
        for k in ("jax", "torch", "one")]
    return ys, te, je


ENGINE_CASES = {
    # name: (C, N, B, sets, env, what the port's step takes)
    "massive_like_uniform_2x2": (4, 512, 2, [0, 0, 0, 0], "2x2", "mix"),
    "per_filter_sets_2x1": (4, 512, 2, [0, 1, 1, 0], "2x1", "mix"),
    "per_filter_sets_1x2": (4, 512, 2, [0, 1, 1, 0], "1x2", "mix"),
    "dense_route_2x4": (4, 256, 2, [0, 1, 0, 1], "2x4", "loop"),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_sharded_matches_jax_and_unsharded(tmp_path, monkeypatch,
                                                  case):
    C, N, B, sets, env, route = ENGINE_CASES[case]
    _taps(tmp_path, 2, N * B, 3)
    frames = N * 11 + 37
    _s24_input(tmp_path, frames, C, 4)
    (yj, yt, y1), te, je = _run_pair(
        tmp_path, monkeypatch,
        lambda name: _config(tmp_path, name, C, N, B, sets=sets), env)
    f, sp = (int(v) for v in env.split("x"))
    assert te.mesh.shape == je.mesh.shape == {"f": f, "sp": sp}
    assert te._sharded.kernel == (route == "mix")
    assert yt.size == yj.size == y1.size == frames * C
    assert np.abs(yj).max() > 2 ** 18
    assert np.abs(yt - yj).max() <= 1
    assert np.abs(yt - y1).max() <= (0 if route == "loop" or f == 1 else 1)


def bench1_text(tmp_path, name, N, B):
    """The reference's bench1 topology: two inputs -> four filters -> two
    cascade filters -> two outputs."""
    filters = """
filter 0 { from_filters: 2, 5; to_outputs: 0; coeff: 0; };
filter 1 { from_filters: 3, 4; to_outputs: 1; coeff: 1; };
filter 2 { from_inputs: 0; to_filters: 0; coeff: 2; };
filter 3 { from_inputs: 0; to_filters: 1; coeff: 3; };
filter 4 { from_inputs: 1; to_filters: 1; coeff: 4; };
filter 5 { from_inputs: 1; to_filters: 0; coeff: 5; };
"""
    return _config(tmp_path, name, 2, N, B, sets=list(range(6)),
                   filters=filters)


@pytest.mark.parametrize("env", ["1x2", "2x2"])
def test_engine_cascade_sharded(tmp_path, monkeypatch, env):
    """bench1's cascade: stage subsets run the per-shard MAC on the rows
    each shard holds; bit-equal to the port unsharded, 1 LSB from the JAX
    sharded engine."""
    N, B = 256, 2
    _taps(tmp_path, 6, N * B, 5)
    frames = N * 9 + 11
    _s24_input(tmp_path, frames, 2, 6, level=2.0 ** 17)
    (yj, yt, y1), te, _ = _run_pair(
        tmp_path, monkeypatch, lambda name: bench1_text(tmp_path, name, N, B),
        env)
    assert te.mesh is not None and len(te.spec.stages) == 2
    assert yt.size == frames * 2
    assert np.array_equal(yt, y1)
    assert np.abs(yt - yj).max() <= 1


def _flip_script(C):
    """bench5's script: every filter to set 0 on even blocks, to set 1 on
    odd ones (one script line a block, tests/test_torch_crossfade.py)."""
    return "\n".join(" ".join(f"cfc {i} {s};" for i in range(C))
                     for s in (0, 1))


@pytest.mark.parametrize("env", ["2x1", "1x2"])
def test_engine_crossfade_script_sharded(tmp_path, monkeypatch, env):
    """A CLI script flipping every crossfading filter's set every block
    through ``run()``: the dual MAC per shard on crossfade blocks
    (the fused time-domain crossfade), against the JAX sharded engine and
    the port unsharded."""
    C, N, B = 4, 512, 2
    _taps(tmp_path, 2, N * B, 7)
    frames = N * 10 + 5
    _s24_input(tmp_path, frames, C, 8)
    filters = "\n".join(
        f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; coeff: 0; "
        f"crossfade: true; }};" for i in range(C))
    extra = (f'logic: "cli" {{ script: "{_flip_script(C)}"; '
             f'echo: false; }};')
    (yj, yt, y1), te, _ = _run_pair(
        tmp_path, monkeypatch,
        lambda name: _config(tmp_path, name, C, N, B, sets=[0, 1],
                             filters=filters, extra=extra), env, run="run")
    assert te._sharded.kernel
    assert yt.size == frames * C
    assert np.abs(yt - yj).max() <= 1
    assert np.abs(yt - y1).max() <= 1


@pytest.mark.parametrize("env", ["1x2", "2x2"])
def test_engine_grouped_dispatch_sharded(tmp_path, monkeypatch, env):
    """The grouped offline dispatch under BRUTEFIR_TPU_PAIR=force:4
    (tests/test_pair_step.py:446): ``mac_group_shard`` per shard, the mix
    outside, G = 4 in both packages."""
    import brutefir_tpu_torch.graph.compile as tc
    import brutefir_tpu.graph.compile as jc
    monkeypatch.setenv("BRUTEFIR_TPU_PAIR", "force:4")
    taken = {"jax": [], "torch": []}
    for key, mod in (("jax", jc), ("torch", tc)):
        orig = mod.group_size
        monkeypatch.setattr(
            mod, "group_size",
            lambda *a, _o=orig, _k=key, **k: taken[_k].append(_o(*a, **k))
            or taken[_k][-1])
    import brutefir_tpu_torch.runtime.device_io as tdio
    monkeypatch.setattr(tdio, "group_size", tc.group_size)
    C, N, B = 4, 512, 2
    _taps(tmp_path, 2, N * B, 9)
    frames = N * 16 + 30
    _s24_input(tmp_path, frames, C, 10)
    (yj, yt, y1), te, _ = _run_pair(
        tmp_path, monkeypatch,
        lambda name: _config(tmp_path, name, C, N, B, sets=[0, 1, 0, 1]),
        env)
    assert 4 in taken["torch"] and 4 in taken["jax"]
    assert yt.size == frames * C
    assert np.abs(yt - yj).max() <= 1
    assert np.abs(yt - y1).max() <= 1


def test_engine_float_le_sharded(tmp_path, monkeypatch):
    """FLOAT_LE outputs within 2e-4 of the JAX sharded engine
    (tests/test_parallel.py's tolerance) and of the port unsharded."""
    C, N, B = 4, 512, 2
    _taps(tmp_path, 2, N * B, 11)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((N * 7 + 3, C)).astype("<f4") * 0.3
    x.tofile(tmp_path / "in.raw")
    (yj, yt, y1), te, _ = _run_pair(
        tmp_path, monkeypatch,
        lambda name: _config(tmp_path, name, C, N, B, fmt="FLOAT_LE",
                             sets=[0, 1, 1, 0]), "2x2", dtype="<f4")
    assert yt.size == x.size
    np.testing.assert_allclose(yt, yj, rtol=0, atol=2e-4)
    np.testing.assert_allclose(yt, y1, rtol=0, atol=2e-4)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_engine_float64_sharded(tmp_path, shape):
    """``float_bits: 64`` with FLOAT64_LE devices (the host codec path)
    on a mesh: the per-shard float64 MAC, within 1e-12 of the peak of the
    port unsharded."""
    from brutefir_tpu_torch.runtime.engine import Engine
    C, N, B = 4, 256, 2
    _taps(tmp_path, 2, N * B, 13)
    rng = np.random.default_rng(14)
    (rng.standard_normal((N * 6 + 9, C)) * 0.3).astype("<f8").tofile(
        tmp_path / "in.raw")
    ys = []
    for name, mesh in (("one", None),
                       ("mesh", tmesh.make_mesh([CPU] * 2, *shape))):
        conf = parse_config(_config(tmp_path, f"{name}.raw", C, N, B,
                                    fmt="FLOAT64_LE", sets=[0, 1, 0, 1],
                                    extra="float_bits: 64;"))
        conf.quiet = True
        eng = Engine(conf, device=CPU, mesh=mesh)
        assert eng.dio is None and eng.state.ring.dtype == torch.float64
        eng.run()
        ys.append(np.fromfile(tmp_path / f"{name}.raw", "<f8"))
    assert ys[0].size == (N * 6 + 9) * C
    assert np.abs(ys[1] - ys[0]).max() <= 1e-12 * np.abs(ys[0]).max()


def test_run_offline_batched_under_mesh_equals_run(tmp_path, monkeypatch):
    """``run_offline`` batched under a mesh equals ``run()`` under it
    (tests/test_auto_mesh.py:117)."""
    from brutefir_tpu_torch.runtime.engine import Engine
    C, N, B = 4, 512, 2
    _taps(tmp_path, 2, N * B, 15)
    x = _s24_input(tmp_path, N * 8, C, 16, level=2.0 ** 20)
    ys = []
    for name, how in (("off", "run_offline"), ("run", "run")):
        conf = parse_config(_config(tmp_path, f"{name}.raw", C, N, B,
                                    sets=[0, 1, 1, 0]))
        conf.quiet = True
        eng = Engine(conf, device=CPU,
                     mesh=tmesh.make_mesh([CPU] * 4, f_axis=2))
        assert eng.dio is not None
        stats = (eng.run_offline(batch_blocks=4) if how == "run_offline"
                 else eng.run())
        assert stats["frames"] == N * 8
        ys.append(np.fromfile(tmp_path / f"{name}.raw", "<i4"))
    assert np.array_equal(ys[0], ys[1])
    assert ys[0].size == x.size


def test_engine_env_mesh_and_off(tmp_path, monkeypatch, capsys):
    """BRUTEFIR_TPU_MESH=FxS builds that mesh over the visible devices and
    says so on stderr; ``off`` and one device run unsharded; a value
    needing more devices than there are is a typed config error."""
    from brutefir_tpu_torch.runtime.engine import Engine
    _taps(tmp_path, 1, 256, 17)
    _s24_input(tmp_path, 300, 2, 18)
    text = _config(tmp_path, "o.raw", 2, 256, 1)
    _port_cpu_mesh(monkeypatch)
    monkeypatch.setenv("BRUTEFIR_TPU_MESH", "2x4")
    eng = Engine(parse_config(text), device=CPU)
    assert eng.mesh.shape == {"f": 2, "sp": 4}
    assert "Multi-device mesh: f=2 x sp=4 over 8 devices" in \
        capsys.readouterr().err
    monkeypatch.setenv("BRUTEFIR_TPU_MESH", "off")
    assert Engine(parse_config(text), device=CPU).mesh is None
    monkeypatch.setenv("BRUTEFIR_TPU_MESH", "4x4")
    with pytest.raises(BFError) as ei:
        Engine(parse_config(text), device=CPU)
    assert ei.value.exit_code == BF_EXIT_INVALID_CONFIG
    monkeypatch.setattr(tmesh, "default_devices", lambda *a: [CPU])
    monkeypatch.setenv("BRUTEFIR_TPU_MESH", "auto")
    assert Engine(parse_config(text), device=CPU).mesh is None


def test_update_bank_entry_writes_every_bank_shard(tmp_path):
    """The EQ's bank update under a mesh reaches every bin shard: the
    gathered bank equals the unsharded engine's after the same update."""
    from brutefir_tpu_torch.runtime.engine import Engine
    _taps(tmp_path, 2, 512 * 2, 19)
    _s24_input(tmp_path, 300, 4, 20)
    text = _config(tmp_path, "o.raw", 4, 512, 2, sets=[0, 1, 0, 1])
    one = Engine(parse_config(text), device=CPU)
    eng = Engine(parse_config(text), device=CPU,
                 mesh=tmesh.make_mesh([CPU] * 4, f_axis=2))
    H = np.random.default_rng(21).standard_normal((2, 2, 512)).astype(
        np.float32)
    old = eng.bank
    for e in (one, eng):
        e.update_bank_entry(1, H)
    assert eng.bank is not old
    assert torch.equal(tmesh.gather(eng.bank), one.bank)
    # the old bank (a block dispatched before the update) is untouched
    assert not torch.equal(tmesh.gather(old)[1], one.bank[1])
    assert torch.equal(tmesh.gather(old)[0], one.bank[0])


# --- BRUTEFIR_TPU_BATCH ------------------------------------------------------------

def test_batch_knob_changes_the_batch_not_the_bytes(tmp_path, monkeypatch,
                                                    capsys):
    """``main()`` reads BRUTEFIR_TPU_BATCH as the JAX __main__ does
    (blocks a batched dispatch, default 8; a bad value warns and takes
    8): the batch changes, the output bytes do not."""
    from brutefir_tpu_torch.__main__ import main
    from brutefir_tpu_torch.runtime.engine import Engine
    _taps(tmp_path, 2, 256 * 2, 22)
    _s24_input(tmp_path, 256 * 13 + 7, 2, 23)
    seen = []
    orig = Engine.run_offline

    def spy(self, *a, batch_blocks=8, **k):
        seen.append(batch_blocks)
        return orig(self, *a, batch_blocks=batch_blocks, **k)

    monkeypatch.setattr(Engine, "run_offline", spy)
    outs = {}
    for val in (None, "3", "1", "bad"):
        if val is None:
            monkeypatch.delenv("BRUTEFIR_TPU_BATCH", raising=False)
        else:
            monkeypatch.setenv("BRUTEFIR_TPU_BATCH", val)
        cfg = tmp_path / f"b{val}.conf"
        cfg.write_text(_config(tmp_path, f"o{val}.raw", 2, 256, 2,
                               sets=[0, 1]))
        assert main(["-quiet", "-nodefault", str(cfg)], device=CPU) == 0
        outs[val] = (tmp_path / f"o{val}.raw").read_bytes()
    assert seen == [8, 3, 1, 8]
    assert "BRUTEFIR_TPU_BATCH must be an integer; using 8" in \
        capsys.readouterr().err
    assert len(outs[None]) == (256 * 13 + 7) * 2 * 4
    assert outs["3"] == outs[None] == outs["1"] == outs["bad"]


# --- BRUTEFIR_TPU_WIRE_PACK24 -------------------------------------------------------

@pytest.mark.parametrize("pack", ["0", "1"])
def test_wire_pack24_switch_matches_jax(tmp_path, monkeypatch, pack):
    """S24_4LE input whose padding bytes are not the sign extension of
    bit 23: with BRUTEFIR_TPU_WIRE_PACK24=0 the whole word travels and
    the port's words equal the JAX engine's under the same switch (the
    reference's raw int32 read, docs/PARITY.md), and the packed run
    differs from both; with the switch on (the default) the port and the
    JAX engine both pack, as before."""
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    C, N = 2, 256
    # a dirac at 1/512: the out-of-spec words (up to 2^24, twice full
    # scale) stay in range at the output, and float32 rounds them alike
    (tmp_path / "c0.txt").write_text("0.001953125\n" + "0.0\n" * 3)
    rng = np.random.default_rng(24)
    x = np.clip(np.round(rng.standard_normal((N * 5 + 3, C)) * 2 ** 18),
                -(2 ** 23), 2 ** 23 - 1).astype("<i4")
    raw = x.view(np.uint8).reshape(-1, C, 4).copy()
    # every third frame's padding byte the opposite of bit 23's extension
    raw[::3, :, 3] = np.where(raw[::3, :, 2] & 0x80, 0x00, 0xFF)
    raw.tofile(tmp_path / "in.raw")
    monkeypatch.setenv("BRUTEFIR_TPU_MESH", "off")
    outs = {}
    for sw in (pack, "1" if pack == "0" else "0"):
        monkeypatch.setenv("BRUTEFIR_TPU_WIRE_PACK24", sw)
        for pkg, eng_cls, parse in (("jax", JaxEngine, jax_parse_config),
                                    ("torch", Engine, parse_config)):
            conf = parse(_config(tmp_path, f"{pkg}{sw}.raw", C, N, 1))
            conf.quiet = True
            eng = (eng_cls(conf) if pkg == "jax"
                   else eng_cls(conf, device=CPU))
            if pkg == "torch":
                assert eng.dio.in_wire == ["p24" if sw == "1" else "word"]
                assert eng.dio.out_wire == ["p24" if sw == "1" else "word"]
            eng.run_offline()
            outs[pkg, sw] = np.fromfile(tmp_path / f"{pkg}{sw}.raw",
                                        "<i4").astype(np.int64)
    assert np.abs(outs["torch", pack] - outs["jax", pack]).max() <= 1
    other = "1" if pack == "0" else "0"
    assert np.abs(outs["torch", pack] - outs["torch", other]).max() > 2 ** 14
    assert np.abs(outs["jax", pack] - outs["torch", other]).max() > 2 ** 14
