"""S24_4LE words on the port's device-IO path: they cross between the host
and the device whole, as the file holds them, and the 24-bit handling
runs on the device (``runtime/device_io.py``).

- The wire: ``in_wire_dtype`` int32, ``in_wire_shape`` ``(open,)`` and
  ``wire_frame_bytes`` the file's frame bytes, under
  ``BRUTEFIR_TPU_WIRE_PACK24`` at 0 and at 1; ``read_block_dio`` hands
  over a view of the bytes read.
- The decode: the device's sign extension from bit 23 bit-equal to the
  3-byte reading of the low three bytes on the edge words, and the whole
  int32 word with the switch at 0.
- File to file, through ``run_offline`` and ``run()``: the output equal
  to the host codec path's (``Engine.dio = None``), and byte-equal to
  the same samples through S24_3LE devices, whose 3-byte words are
  joined and split on the device: with unused open channels, dither, and
  input words whose padding byte is not bit 23's extension.
"""

import numpy as np
import pytest
import torch

from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.config.model import IN, OUT

CPU = torch.device("cpu")
N = 256

# edge words: in range at both ends, the padding byte the opposite of
# bit 23's extension, bit 31 alone set
EDGES = np.array([0x007FFFFF, 0x00800000, 0xFF800000, 0xFFFFFFFF,
                  0x7F800000, 0xFF7FFFFF, 0x00FFFFFF, 0x80000000,
                  0x7FFFFFFF, 0x00000000, 0xFF000000, 0x01000001],
                 np.uint32).view(np.int32)


def _low3(w: np.ndarray) -> np.ndarray:
    """int32 words -> their low three bytes read as S24 (sign-extended
    from bit 23), the JAX package's 3-byte wire reading."""
    b = w.astype("<i4").view(np.uint8).reshape(w.shape + (4,))
    v = (b[..., 0].astype(np.int32) | (b[..., 1].astype(np.int32) << 8)
         | (b[..., 2].astype(np.int32) << 16))
    return v - ((v & 0x800000) << 1)


def _taps(tmp_path, seed=5):
    rng = np.random.default_rng(seed)
    (tmp_path / "c0.txt").write_text("\n".join(
        repr(float(v)) for v in rng.standard_normal(N * 2) * 0.1) + "\n")


def _config(tmp_path, name, fmt="S24_4LE", C=3, open_ch=None, sel=None,
            dither=False, infile="in.raw"):
    """C channels from ``infile`` to ``name``; each device opens
    ``open_ch`` channels and uses ``sel`` of them (all by default)."""
    open_ch = open_ch or C
    chans = ",".join(str(c) for c in range(C))
    used = (f"{open_ch}/{','.join(str(s) for s in sel)}" if sel
            else str(open_ch))
    filters = "".join(f"filter {c} {{ from_inputs: {c}; to_outputs: {c}; "
                      f"coeff: 0; }};\n" for c in range(C))
    return f"""
sampling_rate: 44100;
filter_length: {N},2;
coeff 0 {{ filename: "{tmp_path / 'c0.txt'}"; format: "TEXT"; }};
input {chans} {{ device: "file" {{ path: "{tmp_path / infile}"; }}; sample: "{fmt}"; channels: {used}; }};
output {chans} {{ device: "file" {{ path: "{tmp_path / name}"; }}; sample: "{fmt}"; channels: {used}; dither: {str(dither).lower()}; }};
{filters}"""


def _engine(text):
    from brutefir_tpu_torch.runtime.engine import Engine
    conf = parse_config(text)
    conf.quiet = True
    return Engine(conf, device=CPU)


def _run(eng, entry):
    return eng.run_offline() if entry == "run_offline" else eng.run()


def _samples(frames, open_ch, seed, level=2.0 ** 20):
    rng = np.random.default_rng(seed)
    return np.clip(np.round(rng.standard_normal((frames, open_ch)) * level),
                   -(2 ** 23), 2 ** 23 - 1).astype("<i4")


def _bytes3(w: np.ndarray) -> np.ndarray:
    """int32 words -> S24_3LE file bytes (the low three)."""
    return np.ascontiguousarray(
        w.astype("<i4").view(np.uint8).reshape(w.shape + (4,))[..., :3])


def _read3(path) -> np.ndarray:
    b = np.fromfile(path, np.uint8).reshape(-1, 3).astype(np.int32)
    v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    return v - ((v & 0x800000) << 1)


# --- the wire --------------------------------------------------------------------

@pytest.mark.parametrize("pack", ["0", "1"])
def test_massive_words_cross_whole(tmp_path, monkeypatch, pack):
    """examples/multichannel_massive.conf at test scale: one 26-channel
    S24_4LE device each way, int32 words of the file's 104 bytes a frame
    in and out, whatever the switch; only the decode's label follows
    it."""
    from test_torch_engine import _massive_small
    monkeypatch.setenv("BRUTEFIR_TPU_WIRE_PACK24", pack)
    _taps(tmp_path)
    eng = _engine(_massive_small(tmp_path, "out.raw"))
    dio = eng.dio
    assert dio.in_wire_dtype == [np.dtype(np.int32)]
    assert dio.in_wire_shape == [(26,)]
    assert dio.wire_frame_bytes[IN] == dio.wire_frame_bytes[OUT] == [104]
    assert dio.wire_frame_bytes[IN] == eng._in_framebytes
    label = "p24" if pack == "1" else "word"
    assert dio.in_wire == dio.out_wire == [label]


@pytest.mark.parametrize("fmt,bytes_", [("S24_4LE", 16), ("S24_3LE", 12),
                                        ("S16_LE", 8), ("S32_LE", 16),
                                        ("FLOAT_LE", 16)])
def test_wire_frame_bytes_are_the_file_frame(tmp_path, fmt, bytes_):
    """Every device format's words carry its file's frame bytes, an
    unused open channel included: nothing is repacked on the host."""
    _taps(tmp_path)
    eng = _engine(_config(tmp_path, "out.raw", fmt, C=3, open_ch=4,
                          sel=[0, 1, 3]))
    assert eng.dio.wire_frame_bytes == [[bytes_], [bytes_]]
    assert eng.dio.wire_frame_bytes[IN] == eng._in_framebytes


@pytest.mark.parametrize("pack", ["0", "1"])
def test_read_block_dio_is_a_view_of_the_read(tmp_path, monkeypatch, pack):
    """``read_block_dio`` returns the file's bytes as int32 words [N,
    open], a view of the bytes read (no copy), the EOF block zero
    padded."""
    monkeypatch.setenv("BRUTEFIR_TPU_WIRE_PACK24", pack)
    _taps(tmp_path)
    x = _samples(N + 40, 4, 1)
    x.tofile(tmp_path / "in.raw")
    eng = _engine(_config(tmp_path, "out.raw", C=3, open_ch=4,
                          sel=[0, 2, 3]))
    eng.setup()
    try:
        for k, frames in ((0, N), (1, 40)):
            (w,), got = eng.read_block_dio()
            assert got == frames
            assert w.dtype == np.int32 and w.shape == (N, 4)
            root = w
            while isinstance(root, np.ndarray):
                assert not root.flags.owndata
                root = root.base
            assert isinstance(root, (bytes, bytearray, memoryview))
            np.testing.assert_array_equal(w[:frames], x[k * N:k * N + frames])
            assert not w[frames:].any()
    finally:
        eng.teardown()


# --- the decode on the device ---------------------------------------------------------

def test_extend24_is_the_low_three_bytes_sign_extended():
    """``extend24`` on int32 words equals the 3-byte reading of their low
    three bytes on the edge words and across the int32 range; S24_3LE's
    ``join3`` / ``split3`` are inverse on 24-bit words."""
    from brutefir_tpu_torch.runtime.device_io import extend24, join3, split3
    rng = np.random.default_rng(2)
    w = np.concatenate([EDGES, rng.integers(-(2 ** 31), 2 ** 31, 4096,
                                            dtype=np.int64).astype(np.int32)])
    got = extend24(torch.from_numpy(w)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _low3(w))
    words = torch.from_numpy(_low3(w).reshape(-1, 4))
    b = split3(words)
    assert b.dtype == torch.uint8 and b.shape == (words.shape[0], 4, 3)
    np.testing.assert_array_equal(b.numpy(), _bytes3(words.numpy()))
    np.testing.assert_array_equal(extend24(join3(b)).numpy(), words.numpy())


@pytest.mark.parametrize("pack", ["0", "1"])
def test_input_half_decodes_the_edge_words(tmp_path, monkeypatch, pack):
    """The edge words through ``input_half`` of an S24_4LE device: by
    default their low three bytes sign-extended, bit-equal to the JAX
    package's 3-byte wire; with the switch at 0 the whole int32 word."""
    monkeypatch.setenv("BRUTEFIR_TPU_WIRE_PACK24", pack)
    _taps(tmp_path)
    eng = _engine(_config(tmp_path, "out.raw", C=3))
    rng = np.random.default_rng(3)
    w = rng.integers(-(2 ** 31), 2 ** 31, (N, 3),
                     dtype=np.int64).astype(np.int32)
    w[:EDGES.size, 0] = EDGES
    w[:EDGES.size, 1] = EDGES[::-1]
    x = eng.dio.input_half([torch.from_numpy(w)],
                           torch.ones(3, dtype=torch.float32)).numpy()
    want = _low3(w) if pack == "1" else w
    np.testing.assert_array_equal(x, want.T.astype(np.float32))


# --- file to file ------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["run_offline", "run"])
@pytest.mark.parametrize("pack", ["0", "1"])
def test_output_matches_the_host_codec_path(tmp_path, monkeypatch, entry,
                                            pack):
    """S24_4LE file to file on the device-IO path and on the host codec
    path (``Engine.dio = None``), with an unused open channel: the same
    words (the two paths share the step, and decode and quantize
    exactly), the unused channel's zero."""
    monkeypatch.setenv("BRUTEFIR_TPU_WIRE_PACK24", pack)
    _taps(tmp_path)
    frames = N * 11 + 37
    _samples(frames, 4, 4).tofile(tmp_path / "in.raw")
    outs = {}
    for path in ("dio", "host"):
        eng = _engine(_config(tmp_path, f"{path}.raw", C=3, open_ch=4,
                              sel=[0, 1, 3]))
        assert eng.dio is not None
        if path == "host":
            eng.dio = None
            eng._host_route()
        assert _run(eng, entry)["frames"] == frames
        outs[path] = np.fromfile(tmp_path / f"{path}.raw",
                                 "<i4").reshape(-1, 4).astype(np.int64)
    assert outs["dio"].shape == outs["host"].shape == (frames, 4)
    np.testing.assert_array_equal(outs["dio"], outs["host"])
    assert not outs["dio"][:, 2].any()
    assert np.abs(outs["dio"]).max() > 2 ** 19


@pytest.mark.parametrize("entry", ["run_offline", "run"])
@pytest.mark.parametrize("dither", [False, True])
def test_s24_4le_writes_the_s24_3le_samples(tmp_path, entry, dither):
    """The same samples as S24_4LE and as S24_3LE files (whose 3-byte path
    is unchanged), input words with padding bytes opposite to bit 23's
    extension, an unused open channel, with and without dither: the
    S24_4LE output is the S24_3LE output's words, sign-extended, byte for
    byte."""
    _taps(tmp_path)
    frames = N * 10 + 91
    x = _samples(frames, 4, 6)
    raw = x.view(np.uint8).reshape(frames, 4, 4).copy()
    # every third frame's padding byte the opposite of bit 23's extension
    raw[::3, :, 3] = np.where(raw[::3, :, 2] & 0x80, 0x00, 0xFF)
    raw.tofile(tmp_path / "in4.raw")
    _bytes3(x).tofile(tmp_path / "in3.raw")
    for fmt, inf in (("S24_4LE", "in4.raw"), ("S24_3LE", "in3.raw")):
        eng = _engine(_config(tmp_path, f"{fmt}.raw", fmt, C=3, open_ch=4,
                              sel=[0, 2, 3], dither=dither, infile=inf))
        assert eng.dio is not None
        assert _run(eng, entry)["frames"] == frames
    y4 = np.fromfile(tmp_path / "S24_4LE.raw", "<i4")
    y3 = _read3(tmp_path / "S24_3LE.raw")
    assert y4.size == y3.size == frames * 4
    np.testing.assert_array_equal(y4, y3)
    assert (tmp_path / "S24_4LE.raw").read_bytes() == y3.astype(
        "<i4").tobytes()
    assert np.abs(y4).max() > 2 ** 19


@pytest.mark.parametrize("pack", ["0", "1"])
def test_powersave_silence_follows_the_decode(tmp_path, monkeypatch, pack):
    """Powersave through ``run()`` on an S24_4LE input whose words are zero
    but for their padding byte: silent by the default decode, as the
    3-byte wire read them (every block resets the rti meter's ramp, the
    output is silence); with the switch at 0 the whole words are not."""
    monkeypatch.setenv("BRUTEFIR_TPU_WIRE_PACK24", pack)
    _taps(tmp_path)
    w = np.zeros((N * 6, 3), "<i4")
    w[::2] = np.int32(-(2 ** 24))        # 0xFF000000: only the padding byte
    w.tofile(tmp_path / "in.raw")
    text = _config(tmp_path, "out.raw", C=3).replace(
        "sampling_rate: 44100;", "sampling_rate: 44100;\npowersave: true;")
    eng = _engine(text)
    assert eng.conf.powersave
    assert eng._input_silent_words([w[:N]]) == (pack == "1")
    assert not eng._input_silent_words([w[:N] + 1])
    seen = []
    ramp = eng._update_full_proc
    eng._update_full_proc = lambda silent: seen.append(silent) or ramp(
        silent)
    eng.run()
    assert len(seen) >= 6
    assert all(seen[:6]) == (pack == "1") and any(seen[:6]) == (pack == "1")
    assert np.fromfile(tmp_path / "out.raw", "<i4").any() == (pack == "0")
