"""The port's host codec against the reference-compiled goldens and the
JAX package's files.

- ``float_to_raw``, ``raw_to_float``, ``DitherTable`` / ``DitherState``
  and ``DelayLine`` of ``brutefir_tpu_torch.core`` give the bytes and
  overflow statistics of ``tests/golden/`` (generated by gcc-compiling
  the reference's own dither, codec and delay sources,
  tools/golden/harness.c): every codec case on the native C++ path and
  on the forced numpy path, as ``tests/test_golden_reference.py`` runs
  the JAX package's.
- The copies: ``core/codecs.py`` equals the JAX file apart from import
  lines and the module docstring, ``core/delayline.py`` apart from import
  lines, ``core/native/codec.cpp`` byte for byte.
- Native against numpy on seeded inputs with NaN, clipping and
  ``channel_selection`` gaps, every format both ways, with the dither.
- The per-process build: four processes building the codec into one
  fresh directory at once all load it; a failed build with a compiler
  present raises with the compiler's output; without a compiler the
  numpy paths run.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from brutefir_tpu_torch.core import codecs, native
from brutefir_tpu_torch.core.codecs import Overflow, float_to_raw, raw_to_float
from brutefir_tpu_torch.core.delayline import DelayLine
from brutefir_tpu_torch.core.dither import DitherTable
from brutefir_tpu_torch.core.sampleformat import parse_sample_format

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "golden")
with open(os.path.join(GOLD, "manifest.json")) as fh:
    MANIFEST = json.load(fh)

NBLOCK, NBLOCKS = 256, 8
NTOT = NBLOCK * NBLOCKS
# golden case name fragment -> sample format (tests/test_golden_reference.py)
FMT = {"s8": "S8", "s16le": "S16_LE", "s16be": "S16_BE", "s24_3le": "S24_LE",
       "s24_3be": "S24_BE", "s24_4le": "S24_4LE", "s32le": "S32_LE",
       "s32be": "S32_BE", "f32le": "FLOAT_LE", "f32be": "FLOAT_BE",
       "f64le": "FLOAT64_LE"}


def _cases(kind):
    return sorted(k for k, v in MANIFEST.items()
                  if isinstance(v, dict) and v.get("kind") == kind)


DITHER_CASES = _cases("dither")
ND_CASES = _cases("nodither")
R2R_CASES = _cases("raw2real")
DELAY_CASES = _cases("delay")


def _u8(name):
    return np.fromfile(os.path.join(GOLD, f"{name}.bin"), dtype=np.uint8)


def _f32(name):
    return np.fromfile(os.path.join(GOLD, f"{name}.bin"), dtype="<f4")


def _fmt(case):
    return parse_sample_format(FMT[case.split("_", 1)[1].removesuffix("_sp2")])


@pytest.fixture(params=["native", "numpy"])
def codec_mode(request, monkeypatch):
    """Each golden case on the native C++ path (when a compiler or a
    built library is here) and on the forced numpy path; on the native
    path the codec's own call counts show that it ran."""
    if request.param == "numpy":
        monkeypatch.setattr(codecs, "_native", lambda: None)
        monkeypatch.setattr(native, "available", lambda: False)
    native.reset_calls()
    yield request.param
    if request.param == "native" and native.available():
        assert sum(native.calls.values()) > 0
    else:
        assert sum(native.calls.values()) == 0


def _golden_table(key):
    p = MANIFEST[key]
    return DitherTable(p["n_channels"], p["sample_rate"], p["max_size"],
                       p["max_samples_per_loop"])


def test_randtab_bit_exact():
    p = MANIFEST["randtab_params"]
    t = _golden_table("randtab_params")
    assert t.spacing == p["spacing"] and t.size == len(_u8("randtab"))
    np.testing.assert_array_equal(t.tab.view(np.uint8), _u8("randtab"))
    for c in range(p["n_channels"]):
        assert t.new_state(c).randtab_ptr == MANIFEST[f"randtab_ptr_{c}"]


@pytest.mark.parametrize("case", DITHER_CASES)
def test_dithered_float_to_raw_bit_exact(case, codec_mode):
    """HP-TPDF dithered quantization through float_to_raw, 8 blocks of
    256: the raw bytes and the overflow statistics."""
    m = MANIFEST[case]
    fmt = _fmt(case)
    st = _golden_table("randtab_params").new_state(m["channel"])
    x, sp = _f32(f"{case}_in"), m["spacing"]
    ovf = Overflow(max=float(fmt.imax))
    step = NBLOCK * fmt.bytes * sp
    out = np.zeros(NTOT * fmt.bytes * sp, np.uint8)
    for b in range(NBLOCKS):
        float_to_raw(x[b * NBLOCK:(b + 1) * NBLOCK][None, :], fmt, sp, [0],
                     out[b * step:(b + 1) * step], [ovf], [st])
    np.testing.assert_array_equal(out, _u8(case))
    assert (ovf.n_overflows, ovf.intlargest, ovf.largest) == (
        m["n_overflows"], m["intlargest"], m["largest"])


def test_dither_table_wrap_bit_exact(codec_mode):
    """The table pointer's wrap (dither.h:28-38) over 40 blocks of an
    8002-byte table."""
    p, m = MANIFEST["wrap_params"], MANIFEST["dither_wrap_s16le"]
    t = _golden_table("wrap_params")
    assert t.size == p["randtab_size"]
    np.testing.assert_array_equal(t.tab.view(np.uint8), _u8("randtab_wrap"))
    st = t.new_state(0)
    fmt = parse_sample_format("S16_LE")
    base = _f32("base")
    ovf = Overflow(max=float(fmt.imax))
    out = np.zeros(40 * NBLOCK * 2, np.uint8)
    for b in range(40):
        idx = (b * NBLOCK + np.arange(NBLOCK)) % NTOT
        x = (np.float32(32767.0) * base[idx]) * np.float32(0.5)
        float_to_raw(x[None, :], fmt, 1, [0],
                     out[b * NBLOCK * 2:(b + 1) * NBLOCK * 2], [ovf], [st])
    np.testing.assert_array_equal(out, _u8("dither_wrap_s16le"))
    assert (ovf.n_overflows, ovf.intlargest) == (m["n_overflows"],
                                                 m["intlargest"])


@pytest.mark.parametrize("case", ND_CASES)
def test_no_dither_float_to_raw_bit_exact(case, codec_mode):
    """Mid-tread quantization and packing, every format."""
    m = MANIFEST[case]
    fmt = _fmt(case)
    sp = m["spacing"]
    ovf = Overflow(max=1.0 if fmt.is_float else float(fmt.imax))
    out = np.zeros(NTOT * fmt.bytes * sp, np.uint8)
    float_to_raw(_f32(f"{case}_in")[None, :], fmt, sp, [0], out, [ovf], None)
    np.testing.assert_array_equal(out, _u8(case))
    assert ovf.n_overflows == m["n_overflows"]
    assert ovf.largest == m["largest"]
    if not fmt.is_float:
        assert ovf.intlargest == m["intlargest"]


@pytest.mark.parametrize("case", R2R_CASES)
def test_raw_to_float_bit_exact(case, codec_mode):
    fmt = _fmt(case)
    rows = raw_to_float(_u8(f"{case}_raw"), fmt, NTOT, MANIFEST[case]["spacing"],
                        [0], np.float32)
    np.testing.assert_array_equal(rows[0].astype("<f4").view(np.uint8),
                                  _f32(case).view(np.uint8))


@pytest.mark.parametrize("case", DELAY_CASES)
def test_delay_line_bit_exact(case):
    """The host DelayLine against the reference's delay engine with its
    runtime-change quirks (delay.c:228-407)."""
    m = MANIFEST[case]
    frag = m["frag"]
    x = _f32(f"{case}_in")
    dl = DelayLine(m["initdelay"], m["maxdelay"])
    out = []
    for b, d in enumerate(m["sched"]):
        dl.set_delay(d)
        out.append(np.asarray(dl.process(x[b * frag:(b + 1) * frag]),
                              np.float32).copy())
    np.testing.assert_array_equal(np.concatenate(out).view(np.uint8),
                                  _f32(case).view(np.uint8))


# --- the copies -------------------------------------------------------------

def _code(path, docstring=False):
    """A Python file's lines other than its import lines (and, with
    ``docstring``, other than its module docstring)."""
    with open(path) as fh:
        text = fh.read()
    if docstring:
        doc = ast.get_docstring(ast.parse(text), clean=False)
        text = text.replace(f'"""{doc}"""', "", 1)
    return [ln for ln in text.splitlines()
            if not ln.strip().startswith(("import ", "from "))]


def _pair(*parts):
    return (os.path.join(REPO, "brutefir_tpu_torch", *parts),
            os.path.join(REPO, "brutefir_tpu", *parts))


def test_codecs_is_a_copy_of_the_jax_file():
    ours, theirs = _pair("core", "codecs.py")
    assert _code(ours, docstring=True) == _code(theirs, docstring=True)
    assert "quantize_no_dither" in "".join(_code(ours))


def test_delayline_is_a_copy_of_the_jax_file():
    ours, theirs = _pair("core", "delayline.py")
    assert _code(ours) == _code(theirs)


def test_codec_cpp_is_byte_equal_to_the_jax_file():
    ours, theirs = _pair("core", "native", "codec.cpp")
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


# --- native against numpy ---------------------------------------------------

ALL_FORMATS = ["S8", "S16_LE", "S16_BE", "S24_LE", "S24_BE", "S24_4LE",
               "S24_4BE", "S32_LE", "S32_BE", "FLOAT_LE", "FLOAT_BE",
               "FLOAT64_LE", "FLOAT64_BE"]


def _numpy_only(fn, *args):
    saved = codecs._native
    codecs._native = lambda: None
    try:
        return fn(*args)
    finally:
        codecs._native = saved


def _stats(ovfs):
    return [(o.n_overflows, o.intlargest, o.largest) for o in ovfs]


@pytest.mark.parametrize("name", ALL_FORMATS)
def test_native_encode_matches_numpy(name):
    """float_to_raw, native and numpy, on rows with NaN, clipping and
    near-half values into channels 0, 2 and 5 of 6 (gaps left as
    written): the same bytes, and the same overflow statistics."""
    if not native.available():
        pytest.skip("no native codec here")
    fmt = parse_sample_format(name)
    rng = np.random.default_rng(ALL_FORMATS.index(name))
    n, sel, open_ch = 333, [0, 2, 5], 6
    peak = 1.0 if fmt.is_float else float(fmt.imax)
    x = (rng.standard_normal((3, n)) * 0.4 * peak).astype(np.float32)
    x[0, :4] = [np.nan, 1.7 * peak, -1.7 * peak, 0.5]
    x[1, 5:9] = [-0.5, 1.5, -1.5, peak]
    x[2, 10] = np.nan
    if fmt.is_float:
        # a float format writes NaN as it is: no quantizer to hold
        x[0, 0] = x[2, 10] = 0.25
    outs, stats = [], []
    for run in (lambda f, *a: f(*a), _numpy_only):
        ovfs = [Overflow(max=peak) for _ in range(3)]
        out = np.full(n * open_ch * fmt.bytes, 0xA5, np.uint8)
        run(float_to_raw, x, fmt, open_ch, sel, out, ovfs, None)
        outs.append(out)
        stats.append(_stats(ovfs))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert stats[0] == stats[1]
    assert stats[0][0][0] > 0                     # clipping was counted


@pytest.mark.parametrize("name", ALL_FORMATS)
def test_native_decode_matches_numpy(name):
    """raw_to_float, native and numpy, selecting channels 4, 1 and 2 of
    5 from random bytes (finite values for the float formats): equal."""
    if not native.available():
        pytest.skip("no native codec here")
    fmt = parse_sample_format(name)
    rng = np.random.default_rng(100 + ALL_FORMATS.index(name))
    n, open_ch, sel = 257, 5, [4, 1, 2]
    if fmt.is_float:
        dt = np.dtype(np.float32 if fmt.bytes == 4 else np.float64)
        vals = rng.uniform(-2, 2, (n, open_ch)).astype(
            dt.newbyteorder("<" if fmt.little_endian else ">"))
        raw = np.frombuffer(vals.tobytes(), np.uint8).copy()
    else:
        raw = rng.integers(0, 256, n * open_ch * fmt.bytes).astype(np.uint8)
    native.reset_calls()
    a = raw_to_float(raw, fmt, n, open_ch, sel)
    assert native.calls["decode_f32"] == 1
    b = _numpy_only(raw_to_float, raw, fmt, n, open_ch, sel)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["S8", "S16_BE", "S24_BE", "S24_4BE"])
def test_native_dither_matches_numpy(name):
    """Two dithered channels and one plain into a 4-channel device, three
    blocks with a NaN and clipping: native and numpy give the same bytes,
    the same error feedback and table pointers, the same statistics."""
    if not native.available():
        pytest.skip("no native codec here")
    fmt = parse_sample_format(name)
    n = 512
    res = []
    for numpy_only in (False, True):
        table = DitherTable(2, 2000, 0, n)
        states = [table.new_state(0), None, table.new_state(1)]
        ovfs = [Overflow(max=float(fmt.imax)) for _ in range(3)]
        outs = []
        for b in range(3):
            x = (np.random.default_rng(b).standard_normal((3, n))
                 * 0.3 * fmt.imax).astype(np.float32)
            x[0, 7] = np.nan
            x[2, :3] = [1.5 * fmt.imax, -1.5 * fmt.imax, 0.5]
            out = np.zeros(n * 4 * fmt.bytes, np.uint8)
            if numpy_only:
                saved = native.available
                native.available = lambda: False
                try:
                    _numpy_only(float_to_raw, x, fmt, 4, [3, 0, 1], out,
                                ovfs, states)
                finally:
                    native.available = saved
            else:
                float_to_raw(x, fmt, 4, [3, 0, 1], out, ovfs, states)
            outs.append(out)
        res.append((outs, _stats(ovfs),
                    [(s.randtab_ptr, s.sf.tolist()) for s in states
                     if s is not None]))
    for a, b in zip(res[0][0], res[1][0]):
        np.testing.assert_array_equal(a, b)
    assert res[0][1:] == res[1][1:]


# --- the per-process build --------------------------------------------------

_BUILD = """
import sys
from pathlib import Path
import numpy as np
from brutefir_tpu_torch.core import native
from brutefir_tpu_torch.core.sampleformat import parse_sample_format
native.BUILD_DIR = Path(sys.argv[1])
fmt = parse_sample_format("S16_BE")
raw = np.arange(64, dtype=np.uint8)
out = native.decode_f32(raw, fmt, 32, 1, [0])
assert out.shape == (1, 32) and native.calls["decode_f32"] == 1
print(native.library_path())
"""


def test_concurrent_builds_all_load(tmp_path):
    """Four processes build the codec into one fresh directory at once:
    each compiles to a temporary name of its own and all four load the
    one library; no temporary file is left."""
    if not native.available():
        pytest.skip("no C++ compiler here")
    env = dict(os.environ, PYTHONPATH=REPO)
    d = tmp_path / "fresh"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(d)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=REPO)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    libs = {out.strip() for out, _ in outs}
    assert len(libs) == 1
    lib = libs.pop()
    assert os.path.dirname(lib) == str(d)
    assert os.listdir(d) == [os.path.basename(lib)]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    if not native.available():
        pytest.skip("no C++ compiler here")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ["-fno-such-flag-here"])
    monkeypatch.setattr(native, "_lib", None)
    assert native.available()
    fmt = parse_sample_format("S16_BE")
    with pytest.raises(native.NativeBuildError, match="no-such-flag"):
        raw_to_float(np.zeros(8, np.uint8), fmt, 4, 1, [0])
    assert os.listdir(tmp_path) == []            # the temporary went too


def test_no_compiler_runs_numpy(tmp_path, monkeypatch):
    """No built library and no compiler on PATH: available() is False and
    the numpy paths run, byte-identical to the goldens."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not native.available()
    native.reset_calls()
    case = "nd_s24_3be"
    fmt = _fmt(case)
    ovf = Overflow(max=float(fmt.imax))
    out = np.zeros(NTOT * fmt.bytes, np.uint8)
    float_to_raw(_f32(f"{case}_in")[None, :], fmt, 1, [0], out, [ovf])
    np.testing.assert_array_equal(out, _u8(case))
    assert sum(native.calls.values()) == 0
