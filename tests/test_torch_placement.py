"""Manual ``filter { process: N; }`` placement on the port's mesh, against
the JAX package (tests/test_process_placement.py:96-201 on the port).

Process groups land on the 'f' axis: the engine permutes the filter rows
so each group holds its own contiguous shard rows, padding with inert
rows where groups differ in size, and the config-order control plane
(``change_coeff``, the CLI, the taps' filter ids) goes through the row
map. The port's automatic mesh spreads over eight shards of the one CPU
here, as tests/conftest.py gives the JAX package eight virtual devices;
both engines run under the same ``BRUTEFIR_TPU_MESH``. FLOAT_LE outputs
within 2e-3 of a float64 oracle (the JAX tests' bound), within 2e-4 of
the JAX engine and 1e-5 of the port unsharded.
"""

import numpy as np
import jax
import pytest
import scipy.signal
import torch

from brutefir_tpu.config import parse_config as jax_parse_config
from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.parallel import mesh as tmesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

CPU = torch.device("cpu")


def _cfg(tmp_path, rng, filters, C=4, N=128, B=2):
    tapsets = []
    coeffs = []
    for i in range(C):
        taps = (rng.standard_normal(N * B) * 0.1).astype(np.float32)
        tapsets.append(taps)
        tf = tmp_path / f"t{i}.txt"
        tf.write_text("\n".join(repr(float(v)) for v in taps))
        coeffs.append(f'coeff {i} {{ filename: "{tf}"; format: "TEXT"; }};')
    x = rng.standard_normal((C, N * 6)).astype(np.float32) * 0.5
    np.ascontiguousarray(x.T.astype("<f4")).tofile(tmp_path / "in.f32")
    chans = ",".join(str(i) for i in range(C))

    def text(name):
        return f"""
sampling_rate: 44100;
filter_length: {N},{B};
{chr(10).join(coeffs)}
input {chans} {{ device: "file" {{ path: "{tmp_path / 'in.f32'}"; }}; sample: "FLOAT_LE"; channels: {C}; }};
output {chans} {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "FLOAT_LE"; channels: {C}; }};
{filters}
"""
    return text, x, tapsets


def _filters(C, procs):
    return "\n".join(
        f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; coeff: {i}; "
        f"process: {procs[i]}; }};" for i in range(C))


def _engines(text, name, env, monkeypatch, quiet=True):
    """(JAX engine, port engine) for config ``text(name + pkg)`` under
    BRUTEFIR_TPU_MESH=env, the port's mesh over eight CPU shards."""
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    monkeypatch.setattr(tmesh, "default_devices", lambda *a: [CPU] * 8)
    monkeypatch.setenv("BRUTEFIR_TPU_MESH", env)
    jc = jax_parse_config(text(name + "_jax.f32"))
    tc = parse_config(text(name + "_torch.f32"))
    jc.quiet = tc.quiet = quiet
    return JaxEngine(jc), Engine(tc, device=CPU)


def _out(tmp_path, name, C):
    return np.fromfile(tmp_path / name, dtype="<f4").reshape(-1, C).T


def _oracle(x, taps):
    return scipy.signal.fftconvolve(x, taps)[: x.shape[0]]


def test_pinned_filters_land_on_their_shards(tmp_path, rng, monkeypatch):
    """4 filters pinned 2 + 2: a 2-way 'f' axis, each group on its own
    shard rows, the same rows as the JAX engine's; the audio on its
    oracle, the JAX engine's and the port unsharded's."""
    C = 4
    procs = [0, 1, 0, 1]
    text, x, tapsets = _cfg(tmp_path, rng, _filters(C, procs), C=C)
    je, te = _engines(text, "p", "auto", monkeypatch)
    assert te.mesh is not None and te.mesh.shape["f"] == 2
    assert te.spec_rows == je.spec_rows
    assert list(te.f2spec) == list(je.f2spec)
    f_n = te.mesh.shape["f"]
    gsize = len(te.spec_rows) // f_n
    for row, nf in enumerate(te.spec_rows):
        if nf >= 0:
            assert procs[nf] % f_n == row // gsize
    for nf, row in enumerate(te.f2spec):
        assert te.spec_rows[row] == nf
    je.run()
    te.run()
    y = _out(tmp_path, "p_torch.f32", C)
    for c in range(C):
        np.testing.assert_allclose(y[c], _oracle(x[c], tapsets[c]), rtol=0,
                                   atol=2e-3)
    np.testing.assert_allclose(y, _out(tmp_path, "p_jax.f32", C), rtol=0,
                               atol=2e-4)
    _, one = _engines(text, "one", "off", monkeypatch)
    assert one.mesh is None and one.spec_rows is None
    one.run()
    np.testing.assert_allclose(y, _out(tmp_path, "one_torch.f32", C),
                               rtol=0, atol=1e-5)


def test_uneven_groups_pad_inert_rows(tmp_path, rng, monkeypatch):
    """3 filters on processes {0, 0, 1}: groups of 2 + 1 pad to 2 + 2;
    the padding row is inert (zero mixes) and the audio is right."""
    C = 3
    procs = [0, 0, 1]
    text, x, tapsets = _cfg(tmp_path, rng, _filters(C, procs), C=C)
    je, te = _engines(text, "u", "auto", monkeypatch)
    assert te.mesh.shape["f"] == 2
    assert te.spec_rows == je.spec_rows == [0, 1, 2, -1]
    assert te.spec.n_filters == 4
    te.run()
    je.run()
    y = _out(tmp_path, "u_torch.f32", C)
    for c in range(C):
        np.testing.assert_allclose(y[c], _oracle(x[c], tapsets[c]), rtol=0,
                                   atol=2e-3)
    np.testing.assert_allclose(y, _out(tmp_path, "u_jax.f32", C), rtol=0,
                               atol=2e-4)
    ctrl = te.control.snapshot()
    assert float(ctrl.full.in_mix[3].abs().sum()) == 0.0
    assert float(ctrl.full.out_mix[:, 3].abs().sum()) == 0.0


def test_cascade_within_process_under_placement(tmp_path, rng, monkeypatch):
    """A from_filters cascade inside one process group: the filter mix
    goes through the row map and the cascade stays intact."""
    N, B = 128, 2
    taps0 = (rng.standard_normal(N) * 0.1).astype(np.float32)
    taps1 = (rng.standard_normal(N) * 0.1).astype(np.float32)
    (tmp_path / "c0.txt").write_text("\n".join(repr(float(v))
                                               for v in taps0))
    (tmp_path / "c1.txt").write_text("\n".join(repr(float(v))
                                               for v in taps1))
    x = rng.standard_normal((2, N * 6)).astype(np.float32) * 0.5
    np.ascontiguousarray(x.T.astype("<f4")).tofile(tmp_path / "cin.f32")

    def text(name):
        return f"""
sampling_rate: 44100;
filter_length: {N},{B};
coeff 0 {{ filename: "{tmp_path / 'c0.txt'}"; format: "TEXT"; }};
coeff 1 {{ filename: "{tmp_path / 'c1.txt'}"; format: "TEXT"; }};
input 0,1 {{ device: "file" {{ path: "{tmp_path / 'cin.f32'}"; }}; sample: "FLOAT_LE"; channels: 2; }};
output 0,1 {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "FLOAT_LE"; channels: 2; }};
filter 0 {{ from_inputs: 0; to_filters: 1; coeff: 0; process: 0; }};
filter 1 {{ from_filters: 0; to_outputs: 0; coeff: 1; process: 0; }};
filter 2 {{ from_inputs: 1; to_outputs: 1; coeff: 0; process: 1; }};
"""
    je, te = _engines(text, "c", "auto", monkeypatch)
    assert te.mesh.shape["f"] == 2 and len(te.spec.stages) == 2
    te.run()
    je.run()
    y = _out(tmp_path, "c_torch.f32", 2)
    np.testing.assert_allclose(y[0], _oracle(_oracle(x[0], taps0), taps1),
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(y[1], _oracle(x[1], taps0), rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(y, _out(tmp_path, "c_jax.f32", 2), rtol=0,
                               atol=2e-4)


def test_runtime_coeff_change_respects_row_map(tmp_path, rng, monkeypatch):
    """change_coeff speaks config filter indices; under placement the
    permuted row takes the change (filter 0 to no coefficient, a dirac)."""
    C = 3
    procs = [1, 0, 1]
    text, x, tapsets = _cfg(tmp_path, rng, _filters(C, procs), C=C)
    je, te = _engines(text, "r", "auto", monkeypatch)
    assert te.spec_rows == je.spec_rows and te.spec_rows[0] != 0
    for e in (je, te):
        e.control.change_coeff(0, -1)
        e.run()
    y = _out(tmp_path, "r_torch.f32", C)
    np.testing.assert_allclose(y[0], x[0], rtol=0, atol=2e-3)
    for c in (1, 2):
        np.testing.assert_allclose(y[c], _oracle(x[c], tapsets[c]), rtol=0,
                                   atol=2e-3)
    np.testing.assert_allclose(y, _out(tmp_path, "r_jax.f32", C), rtol=0,
                               atol=2e-4)


def _stderr_lines(capsys):
    return [ln for ln in capsys.readouterr().err.splitlines()
            if "process" in ln or "mesh" in ln]


@pytest.mark.parametrize("env", ["off", "1x2", "auto"])
def test_placement_messages_match_jax(tmp_path, rng, monkeypatch, capsys,
                                      env):
    """The stderr lines of placement: the single-device (or f = 1 mesh)
    warning, the mesh line and the placement line, as the JAX engine
    prints them."""
    text, _, _ = _cfg(tmp_path, rng, _filters(2, [0, 1]), C=2)
    monkeypatch.setattr(tmesh, "default_devices", lambda *a: [CPU] * 8)
    monkeypatch.setenv("BRUTEFIR_TPU_MESH", env)
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    capsys.readouterr()
    JaxEngine(jax_parse_config(text("m.f32")))
    want = _stderr_lines(capsys)
    Engine(parse_config(text("m.f32")), device=CPU)
    got = _stderr_lines(capsys)
    assert got == want and got
    if env != "auto":
        assert got[-1] == ("Warning: filter process: settings have no "
                           "effect (single device or no 'f' mesh axis to "
                           "place onto)")


class _Doubler:
    def output_freqd(self, buf, ch):
        buf *= 2.0


class _PostIds:
    def __init__(self):
        self.ids = []

    def post_convolve(self, buf, fid):
        self.ids.append(fid)


def test_freqd_hooks_degrade_auto_mesh(tmp_path, rng, monkeypatch, capsys):
    """An automatic mesh and a module with a frequency-domain hook: the
    engine steps down to one device with the JAX warning, and the hook's
    effect lands (tests/test_auto_mesh.py:217-233)."""
    text, x, tapsets = _cfg(tmp_path, rng, "\n".join(
        f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; coeff: {i}; }};"
        for i in range(2)), C=2)
    je, te = _engines(text, "d", "auto", monkeypatch, quiet=False)
    assert te.mesh is not None and je.mesh is not None
    capsys.readouterr()
    for e in (je, te):
        e.logic.append(_Doubler())
        e.run()
        assert e.mesh is None
    err = capsys.readouterr().err
    assert err.count("Multi-device mesh disabled: a logic module "
                     "registered frequency-domain hooks (single-device "
                     "only)") == 2
    y = _out(tmp_path, "d_torch.f32", 2)
    for c in range(2):
        np.testing.assert_allclose(y[c], 2 * _oracle(x[c], tapsets[c]),
                                   rtol=0, atol=4e-3)


@pytest.mark.parametrize("how", ["argument", "env"])
def test_freqd_hooks_reject_explicit_mesh(tmp_path, rng, monkeypatch, how):
    """An explicit mesh (``mesh=`` or ``BRUTEFIR_TPU_MESH=FxS``) does not
    step down: frequency-domain hooks raise EngineError."""
    from brutefir_tpu_torch.runtime.engine import Engine, EngineError
    text, _, _ = _cfg(tmp_path, rng, "\n".join(
        f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; coeff: {i}; }};"
        for i in range(2)), C=2)
    monkeypatch.setattr(tmesh, "default_devices", lambda *a: [CPU] * 8)
    conf = parse_config(text("x.f32"))
    conf.quiet = True
    if how == "argument":
        eng = Engine(conf, device=CPU,
                     mesh=tmesh.make_mesh([CPU] * 4, f_axis=2))
    else:
        monkeypatch.setenv("BRUTEFIR_TPU_MESH", "2x2")
        eng = Engine(conf, device=CPU)
    eng.logic.append(_Doubler())
    with pytest.raises(EngineError, match="single"):
        eng.attach_logic()


def test_row2conf_gives_post_convolve_config_filters(tmp_path, rng,
                                                     monkeypatch):
    """Under placement a ``post_convolve`` hook sees config filter
    numbers, in the order the JAX engine hands them, and never a padding
    row."""
    C = 3
    procs = [1, 0, 1]
    text, _, _ = _cfg(tmp_path, rng, _filters(C, procs), C=C)
    je, te = _engines(text, "t", "auto", monkeypatch)
    assert te.spec_rows == [1, -1, 0, 2]
    seen = {}
    for key, e in (("jax", je), ("torch", te)):
        mod = _PostIds()
        e.logic.append(mod)
        e.run()
        seen[key] = mod.ids
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][:3] == [1, 0, 2]
    assert set(seen["torch"]) == {0, 1, 2}
