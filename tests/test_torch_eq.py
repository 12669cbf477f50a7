"""The EQ logic module in brutefir_tpu_torch against the JAX package's, on
the CPU.

``control/eq.py`` is the JAX file line for line apart from its imports;
its render (numpy float64 cast to float32, then ``preprocess_coeffs``)
gives bank entries bit-equal to the JAX engine's. Engines run the same
config in both packages (the JAX engine on its default route, as
``tests/test_eq.py`` runs it): FLOAT_LE outputs agree within 2e-6 of the
output's peak (float32 sums in another order), and each matches the
float64 convolution with the rendered impulses within 1e-5 of the peak.
"""

import os
import socket

import numpy as np
import pytest
import torch

from brutefir_tpu.config import parse_config as jax_parse_config
from brutefir_tpu_torch.config import parse_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
ENGINE_TOL = 2e-6      # port vs JAX engine, of the output's peak
ORACLE_TOL = 1e-5      # either engine vs the float64 oracle, of the peak


def _code_lines(path):
    with open(path) as fh:
        return [ln for ln in fh.read().splitlines()
                if not ln.strip().startswith(("import ", "from "))]


def test_eq_module_is_a_copy_of_the_jax_one():
    """control/eq.py is framework-free: the port's is the JAX package's,
    line for line apart from import lines."""
    ours = _code_lines(os.path.join(REPO, "brutefir_tpu_torch", "control",
                                    "eq.py"))
    theirs = _code_lines(os.path.join(REPO, "brutefir_tpu", "control",
                                      "eq.py"))
    assert ours == theirs


def eq_config(d, eq_params, N=64, B=2, logic_extra="", n_coeffs=2,
              crossfade=False, out="out.f32", channels=1):
    """tests/test_eq.py's config: FLOAT_LE in and out, dirac coefficients
    in shared memory, filter c on coefficient 0."""
    coeffs = "".join(f'coeff {k} {{ filename: "dirac pulse"; '
                     f'shared_mem: true; }};\n' for k in range(n_coeffs))
    chans = ",".join(str(c) for c in range(channels))
    xf = " crossfade: true;" if crossfade else ""
    filters = "".join(
        f"filter {c} {{ from_inputs: {c}; to_outputs: {c}; coeff: 0;{xf} "
        "};\n" for c in range(channels))
    logic = f'"eq" {{ {eq_params} }}'
    if logic_extra:
        logic = f"{logic_extra}, {logic}"
    return f"""
sampling_rate: 44100;
filter_length: {N},{B};
logic: {logic};
{coeffs}input {chans} {{ device: "file" {{ path: "{d}/in.f32"; }}; sample: "FLOAT_LE"; channels: {channels}; }};
output {chans} {{ device: "file" {{ path: "{d}/{out}"; }}; sample: "FLOAT_LE"; channels: {channels}; }};
{filters}"""


def _input(d, frames, channels=1, seed=5):
    x = (np.random.default_rng(seed).standard_normal((frames, channels))
         * 0.25).astype("<f4")
    x.tofile(os.path.join(d, "in.f32"))
    return x


def _engines(text_of):
    """A JAX engine and a port engine (CPU) on ``text_of(out_name)``."""
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    jeng = JaxEngine(jax_parse_config(text_of("out_jax.f32")))
    teng = Engine(parse_config(text_of("out_torch.f32")), device=CPU)
    return jeng, teng


def _bank(eng):
    b = eng.bank
    return b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)


def _outputs(d, channels=1):
    yj = np.fromfile(os.path.join(d, "out_jax.f32"), "<f4")
    yt = np.fromfile(os.path.join(d, "out_torch.f32"), "<f4")
    return yj.reshape(-1, channels), yt.reshape(-1, channels)


def _conv(x, h):
    from scipy.signal import fftconvolve
    return fftconvolve(x.astype(np.float64), h.astype(np.float64))[:len(x)]


RENDER_CASES = {
    "mag": ('coeff: 0, 1; bands: 1000, 8000; magnitude: 1000/-3;',
            "0 mag 1000/-6", 64, 2),
    "phase": ('coeff: 0, 1; bands: "ISO octave"; phase: 1000/30;',
              "0 phase 1000/-45,4000/10", 128, 2),
    "third_octave": ('coeff: 0, 1; bands: "ISO 1/3 octave";',
                     "0 mag 63/3,1000/0,8000/-2", 256, 4),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_and_bank_entry_bit_equal_to_jax(tmp_path, case):
    """The impulse the EQ renders and the bank entries it writes, at
    attach and after a command, are bit-equal to the JAX package's."""
    params, cmd, N, B = RENDER_CASES[case]
    _input(tmp_path, N * 2)
    jeng, teng = _engines(lambda o: eq_config(tmp_path, params, N, B,
                                              out=o))
    np.testing.assert_array_equal(_bank(teng), _bank(jeng).reshape(
        teng.bank.shape))
    jeng.attach_logic()
    teng.attach_logic()
    jeq, teq = jeng.logic[0], teng.logic[0]
    for step in range(2):
        ji, ti = (m.render_impulse(m.equalisers[0]) for m in (jeq, teq))
        assert ti.dtype == ji.dtype == np.float32
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(
            _bank(teng), _bank(jeng).reshape(teng.bank.shape))
        assert teq.equalisers[0].active == jeq.equalisers[0].active
        if step == 0:
            assert jeq.command(cmd) == teq.command(cmd) == (True, "ok\n")
    # the rendered set is the active one: a dirac no longer
    a = teq.equalisers[0].coeff[teq.equalisers[0].active]
    assert not torch.equal(teng.bank[a], teng.bank[-1])


def _run_both(tmp_path, text_of, frames, channels=1):
    x = _input(tmp_path, frames, channels)
    jeng, teng = _engines(text_of)
    jeng.run()
    teng.run()
    yj, yt = _outputs(tmp_path, channels)
    assert yt.shape == yj.shape == x.shape
    peak = np.abs(yj).max()
    assert peak > 0
    assert np.abs(yt - yj).max() <= ENGINE_TOL * peak
    return x, yt, jeng, teng


@pytest.mark.parametrize("db", [0, -20])
def test_flat_and_attenuating_eq_match_jax(tmp_path, db):
    """tests/test_eq.py's first two cases: a flat EQ renders a pure
    taps/2-sample delay, a -20 dB one the same delay at 0.1."""
    N, B = 64, 2
    params = (f"coeff: 0, 1; bands: 1000, 8000; "
              f"magnitude: 1000/{db}, 8000/{db};")
    x, yt, _, _ = _run_both(tmp_path, lambda o: eq_config(
        tmp_path, params, N, B, out=o), N * 8)
    d = N * B // 2
    expect = 10 ** (db / 20) * np.concatenate(
        [np.zeros(d, np.float32), x[: len(x) - d, 0]])
    np.testing.assert_allclose(yt[:, 0], expect, rtol=0,
                               atol=2e-3 if db == 0 else 3e-3)


def test_runtime_commands_reply_as_jax(tmp_path):
    """``info``, ``mag`` and the error replies, command by command, are
    the JAX module's; the runs after them match."""
    N, B = 64, 2
    _input(tmp_path, N * 8)
    jeng, teng = _engines(lambda o: eq_config(
        tmp_path, 'coeff: 0, 1; bands: "ISO octave"; magnitude: 1000/0;',
        N, B, out=o))
    for eng in (jeng, teng):
        eng.setup()
        eng.attach_logic()
    replies = []
    for cmd in ("0 info", "0 mag 1000/-20", "0 info", "0 mag 1234/-3",
                "5 info", "1 phase 500/20", '"0" info', "x info",
                "0 bogus", "0 mag 2000/1,1000/2", "0 mag 1000"):
        rj, rt = jeng.logic[0].command(cmd), teng.logic[0].command(cmd)
        assert rt == rj, cmd
        replies.append(rt)
    assert replies[0][0] and "coefficient 0,1" in replies[0][1]
    assert replies[1] == (True, "ok\n") and " -20.0" in replies[2][1]
    assert not replies[3][0] and "invalid frequency band" in replies[3][1]
    assert not replies[4][0] and "not controlled" in replies[4][1]
    for eng in (jeng, teng):
        eng.run(setup=False)
        eng.teardown()
    yj, yt = _outputs(tmp_path)
    assert np.abs(yt - yj).max() <= ENGINE_TOL * np.abs(yj).max()


def test_double_buffer_swap_as_jax(tmp_path):
    """A re-render flips the active set and filters follow it through
    coeff_final, in the same sequence as the JAX module."""
    N, B = 64, 2
    _input(tmp_path, N * 8)
    jeng, teng = _engines(lambda o: eq_config(
        tmp_path, "coeff: 0, 1; bands: 1000, 8000;", N, B, out=o))
    seq = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        eng.attach_logic()
        m = eng.logic[0]
        eq = m.equalisers[0]
        s = [(eq.active, m._coeff_final(0, 0), m._coeff_final(0, 5))]
        for cmd in ("0 mag 1000/-6", "1 mag 8000/-3", "0 phase 1000/10"):
            assert m.command(cmd) == (True, "ok\n")
            s.append((eq.active, m._coeff_final(0, 0),
                      m._coeff_final(0, 1)))
        seq[name] = s
    assert seq["torch"] == seq["jax"]
    assert [a for a, _, _ in seq["torch"]] == [1, 0, 1, 0]
    np.testing.assert_array_equal(_bank(teng),
                                  _bank(jeng).reshape(teng.bank.shape))


def test_braced_multi_equaliser_syntax_as_jax(tmp_path):
    """The reference's brace-block syntax with two equalisers: the same
    sets in both packages, and the same output."""
    N, B = 64, 2
    params = ('{ coeff: 0, 1; bands: 1000, 8000; }; '
              '{ coeff: 2; bands: "ISO octave"; magnitude: 1000/-6; };')
    x, yt, jeng, teng = _run_both(tmp_path, lambda o: eq_config(
        tmp_path, params, N, B, n_coeffs=3, out=o), N * 4)
    tm, jm = teng.logic[0], jeng.logic[0]
    assert [e.coeff for e in tm.equalisers] == [[0, 1], [2, 2]]
    assert [e.coeff for e in tm.equalisers] == \
        [e.coeff for e in jm.equalisers]


def test_two_eq_modules_chain_as_jax(tmp_path):
    """Two eq logic modules keep both double-buffer redirects: the hook
    chain resolves as the JAX one, and 2-channel outputs match."""
    N, B = 64, 2
    text = eq_config(tmp_path, 'coeff: 2, 3; bands: "ISO octave"; '
                     'magnitude: 1000/-6;', N, B, n_coeffs=4, channels=2,
                     logic_extra='"eq" { coeff: 0, 1; bands: "ISO octave"; '
                                 'magnitude: 500/3; }')
    text = text.replace("filter 1 { from_inputs: 1; to_outputs: 1; "
                        "coeff: 0;", "filter 1 { from_inputs: 1; "
                        "to_outputs: 1; coeff: 2;")
    x, yt, jeng, teng = _run_both(
        tmp_path, lambda o: text.replace("out.f32", o), N * 6, channels=2)
    for f, c in ((0, 0), (1, 2), (0, 1), (1, 3)):
        assert teng.control.coeff_final_hook(f, c) == \
            jeng.control.coeff_final_hook(f, c)
    assert teng.control.coeff_final_hook(0, 0) in (0, 1)
    assert teng.control.coeff_final_hook(1, 2) in (2, 3)
    # each channel carries its own module's EQ
    assert not np.allclose(yt[:, 0] / np.abs(yt[:, 0]).max(),
                           yt[:, 1] / np.abs(yt[:, 1]).max(), atol=1e-3)


def _impulses(text, cmds):
    """The port's rendered impulse of the first EQ after each prefix of
    ``cmds`` (none, the first, the first two, ...)."""
    from brutefir_tpu_torch.runtime.engine import Engine
    eng = Engine(parse_config(text), device=CPU)
    eng.attach_logic()
    m = next(mod for mod in eng.logic if hasattr(mod, "equalisers"))
    hs = [m.render_impulse(m.equalisers[0])]
    for c in cmds:
        assert m.command(c)[0]
        hs.append(m.render_impulse(m.equalisers[0]))
    return hs


def test_mid_run_script_command_matches_jax_and_oracle(tmp_path):
    """``lmc eq 0 mag ...`` from a CLI script on block 4: both engines
    give the same output, the float64 convolution with the flat render
    before that block and with the new render from it on."""
    N, B = 64, 4
    params = 'coeff: 0, 1; bands: "ISO octave";'
    cmd = "0 mag 125/6,1000/-6,4000/-12"
    cli = f'"cli" {{ script: "sleep b3\nlmc eq {cmd}\nsleep b999"; ' \
          f'echo: false; }}'

    def text_of(o):
        return eq_config(tmp_path, params, N, B, logic_extra=cli, out=o)

    x, yt, _, _ = _run_both(tmp_path, text_of, N * 10 + 17)
    ha, hb = _impulses(text_of("unused.f32"), [cmd])
    ref = np.where(np.arange(len(x)) < 4 * N, _conv(x[:, 0], ha),
                   _conv(x[:, 0], hb))
    peak = np.abs(ref).max()
    assert np.abs(yt[:, 0] - ref).max() <= ORACLE_TOL * peak
    assert np.abs(_conv(x[:, 0], ha) - ref).max() > 0.05 * peak


def test_crossfade_with_eq_commands_on_successive_blocks(tmp_path,
                                                         monkeypatch):
    """A ``crossfade: true`` filter with EQ commands on blocks 3 and 4:
    each block ramps from the set its predecessor ran to the one just
    rendered (block 4's old set is the one block 3's command rendered),
    through the dual MAC, as in the JAX engine. Block 0 ramps too, from
    the config's dirac to the set the EQ rendered at attach."""
    import brutefir_tpu_torch.graph.compile as tc
    N, B = 64, 2
    params = "coeff: 0, 1; bands: 1000, 8000;"
    cmds = ["0 mag 1000/-6", "0 mag 1000/3,8000/-12"]
    cli = ('"cli" { script: "sleep b2\nlmc eq ' + cmds[0] + '\nlmc eq '
           + cmds[1] + '\nsleep b999"; echo: false; }')
    calls = {"dual": 0}
    orig = tc.mac_dual

    def spy(*a):
        calls["dual"] += 1
        return orig(*a)

    monkeypatch.setattr(tc, "mac_dual", spy)

    def text_of(o):
        return eq_config(tmp_path, params, N, B, logic_extra=cli,
                         crossfade=True, out=o)

    x, yt, _, _ = _run_both(tmp_path, text_of, N * 9)
    assert calls["dual"] == 3
    h = _impulses(text_of("unused.f32"), cmds)
    y = [_conv(x[:, 0], hk) for hk in h]
    ramp = np.arange(N) / (N - 1)
    ref = y[0].copy()
    ref[:N] = x[:N, 0] * (1 - ramp) + y[0][:N] * ramp
    ref[3 * N:4 * N] = y[0][3 * N:4 * N] * (1 - ramp) + y[1][3 * N:4 * N] * ramp
    ref[4 * N:5 * N] = y[1][4 * N:5 * N] * (1 - ramp) + y[2][4 * N:5 * N] * ramp
    ref[5 * N:] = y[2][5 * N:]
    assert np.abs(yt[:, 0] - ref).max() <= ORACLE_TOL * np.abs(ref).max()


def test_bank_update_leaves_a_dispatched_block_alone(tmp_path):
    """``update_bank_entry`` rebinds a new bank: the epoch a block was
    dispatched with keeps the old tensor, unchanged, and the next epoch
    carries the new entry."""
    from brutefir_tpu_torch.runtime.engine import Engine
    N, B = 64, 2
    _input(tmp_path, N * 2)
    eng = Engine(parse_config(eq_config(tmp_path, "coeff: 0, 1; bands: "
                                        "1000, 8000;", N, B)), device=CPU)
    epoch = eng._snapshot_epoch()
    old = epoch[5]
    kept = old.clone()
    H = np.random.default_rng(3).standard_normal((B, 2, N)).astype(
        np.float32)
    eng.update_bank_entry(1, H)
    assert eng.bank is not old and torch.equal(old, kept)
    assert torch.equal(eng._snapshot_epoch()[5][1], torch.as_tensor(H))
    assert torch.equal(eng.bank[0], kept[0])


def _socket_talk(path, lines):
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(30)
    s.connect(path)
    s.sendall(("".join(ln + "\n" for ln in lines) + "quit\n").encode())
    got = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break
        got += chunk
    s.close()
    return got.decode()


def test_lmc_eq_over_a_cli_socket_as_jax(tmp_path):
    """examples/room_correction_eq.conf's logic pair (a CLI on a Unix
    socket, then the EQ) at test scale: ``lmc eq 0 info`` and ``mag``
    over the socket get the JAX package's replies."""
    with open(os.path.join(REPO, "examples", "room_correction_eq.conf")) \
            as fh:
        example = fh.read()
    replies = {}
    for name in ("jax", "torch"):
        sock = str(tmp_path / f"{name[0]}.sock")
        text = (example.replace('"/tmp/brutefir.sock"', f'"{sock}"')
                .replace("filter_length: 8192, 8;", "filter_length: 64, 4;")
                .replace('"input.f32"', f'"{tmp_path / "in.f32"}"')
                .replace('"output.f32"', f'"{tmp_path / (name + ".f32")}"'))
        assert sock in text and "filter_length: 64, 4;" in text
        if name == "jax":
            from brutefir_tpu.runtime import Engine as JaxEngine
            eng = JaxEngine(jax_parse_config(text))
        else:
            from brutefir_tpu_torch.runtime.engine import Engine
            eng = Engine(parse_config(text), device=CPU)
        eng.attach_logic()
        try:
            replies[name] = _socket_talk(sock, [
                "lmc eq 0 info", "lmc eq 0 mag 63/3,1000/0,8000/-2",
                "lmc eq 0 info", "lmc eq 0 mag 64/1"])
        finally:
            eng.logic[0].close()
    assert replies["torch"] == replies["jax"]
    text = replies["torch"]
    assert text.count("coefficient 0,1:") == 2 and "ok\n" in text
    assert "Command failed: At least one invalid frequency band." in text
