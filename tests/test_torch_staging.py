"""The offline pipeline's reused host buffers (``runtime/staging.py``):
the producer reads each block in place into a row of its stacks
(``FileDevice.readinto``, ``Engine.read_block_dio(into=...)``), the
writer fetches through ``Staging.fetch`` and hands the output devices
arrays of its pool (``Staging.encode``).

On the CPU: ``readinto`` against ``read`` byte for byte; in-place reads
against fresh ones; ``run_offline``'s output bytes equal to ``run()``'s
block by block, with the producer's stacks handed out dirty (as a reused
stack is), on the single-block route and the grouped one; a device that
keeps every buffer it was given finds each unchanged; the pool's counts.
On the card (marked ``cuda``; skipped here): every batch read into a
pinned stack, no pageable copy in a traced window, and ``run_offline``
byte-equal to ``run()``.

This file imports no jax, so it also runs on a machine without it:

    python -m pytest tests/test_torch_staging.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.config.model import IN, OUT
from brutefir_tpu_torch.io import IoDevice
from brutefir_tpu_torch.io.file_module import FileDevice
from brutefir_tpu_torch.runtime import staging as staging_mod
from brutefir_tpu_torch.runtime.staging import Staging

CPU = torch.device("cpu")
N = 256
C = 4
FRAME = 4 * C            # S24_4LE bytes a frame
BATCH = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# --- readinto ----------------------------------------------------------------

def _file_device(path, **params):
    """A FileDevice on ``path`` opened for input with ``params``."""
    from brutefir_tpu_torch.config.lexer import T, Token
    from brutefir_tpu_torch.core.sampleformat import parse_sample_format
    toks = [Token(T.FIELD, "path", 1), Token(T.STRING, str(path), 1),
            Token(T.EOS, ";", 1)]
    for k, v in params.items():
        kind = T.BOOLEAN if isinstance(v, bool) else T.REAL
        toks += [Token(T.FIELD, k, 1), Token(kind, v, 1),
                 Token(T.EOS, ";", 1)]
    dev = FileDevice(toks, IN, parse_sample_format("S24_4LE"), 44100, C)
    dev.init(N)
    return dev


# (file bytes, params, read sizes): a looped file across its wrap, a loop
# back to a skip offset, a skip, a short read at EOF and reads after it,
# a final partial frame
READS = {
    "loop_wrap": (1000, {"loop": True}, [384] * 6),
    "loop_skip": (1000, {"loop": True, "skip": 104}, [384, 1500, 7, 384]),
    "skip": (1000, {"skip": 123}, [384, 384, 384]),
    "eof_short": (1000, {}, [384, 384, 384, 384]),
    "partial_block": (1001, {}, [FRAME * 60, FRAME * 3, FRAME * 3]),
}


@pytest.mark.parametrize("case", sorted(READS))
def test_file_readinto_matches_read(tmp_path, case):
    """Two devices on one file, one read by ``read``, the other by
    ``readinto`` into a dirty buffer: the same bytes, counts and file
    positions at every call."""
    size, params, reads = READS[case]
    path = tmp_path / "in.raw"
    path.write_bytes(np.random.default_rng(3).integers(
        0, 256, size, np.uint8).tobytes())
    a, b = _file_device(path, **params), _file_device(path, **params)
    try:
        for n in reads:
            want = a.read(n)
            buf = bytearray(b"\xa5" * (n + 5))
            got = b.readinto(memoryview(buf)[:n])
            assert got == len(want)
            assert bytes(buf[:got]) == want
            assert buf[got:] == b"\xa5" * (n + 5 - got)
            assert a.curpos == b.curpos
    finally:
        a.close()
        b.close()


def test_default_readinto_copies_read():
    """A module without ``readinto`` (ALSA, JACK, the callback module):
    the default reads through ``read`` and copies, short reads short."""

    class Chunks(IoDevice):
        def __init__(self):
            super().__init__([], IN, None, 44100, 1)
            self.left = b"abcdefghij"

        def read(self, nbytes):
            out, self.left = self.left[:nbytes], self.left[nbytes:]
            return out

    dev = Chunks()
    buf = bytearray(6)
    assert dev.readinto(memoryview(buf)) == 6 and buf == b"abcdef"
    assert dev.readinto(memoryview(buf)) == 4 and buf[:4] == b"ghij"
    assert dev.readinto(memoryview(buf)) == 0


# --- engines -----------------------------------------------------------------

def _config(tmp_path, out_name, partitions=2, outs=1, loop=False):
    """C S24_4LE channels from in.raw to ``out_name`` (``outs`` output
    devices, the channels split between them), filter c from input c to
    output c, one coefficient of N x ``partitions`` taps."""
    rng = np.random.default_rng(5)
    (tmp_path / "c0.txt").write_text("\n".join(
        repr(float(v)) for v in rng.standard_normal(N * partitions) * 0.1)
        + "\n")
    chans = ",".join(str(c) for c in range(C))
    per = C // outs
    devs = "".join(
        f'output {",".join(str(c) for c in range(k * per, (k + 1) * per))} '
        f'{{ device: "file" {{ path: "{tmp_path / f"{out_name}.{k}"}"; }}; '
        f'sample: "S24_4LE"; channels: {per}; }};\n' for k in range(outs))
    filters = "".join(f"filter {c} {{ from_inputs: {c}; to_outputs: {c}; "
                      f"coeff: 0; }};\n" for c in range(C))
    return f"""
sampling_rate: 44100;
filter_length: {N},{partitions};
coeff 0 {{ filename: "{tmp_path / 'c0.txt'}"; format: "TEXT"; }};
input {chans} {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; loop: {str(loop).lower()}; }}; sample: "S24_4LE"; channels: {C}; }};
{devs}{filters}"""


def _input(tmp_path, frames, seed=11):
    rng = np.random.default_rng(seed)
    w = np.clip(np.round(rng.standard_normal((frames, C)) * 2.0 ** 20),
                -(2 ** 23), 2 ** 23 - 1).astype("<i4")
    w.tofile(tmp_path / "in.raw")


def _engine(text, device=CPU):
    from brutefir_tpu_torch.runtime.engine import Engine
    conf = parse_config(text)
    conf.quiet = True
    return Engine(conf, device=device)


class DirtyStacks(Staging):
    """Fresh stacks, as on the CPU, but full of stale words, as a reused
    stack is: every word the producer does not read has to be zeroed."""

    def stacks(self, layout):
        arrays, pset = super().stacks(layout)
        for a in arrays:
            a.reshape(-1).view(np.uint8)[:] = 0x5A
        return arrays, pset


def _outputs(tmp_path, name, outs=1) -> list:
    return [(tmp_path / f"{name}.{k}").read_bytes() for k in range(outs)]


def _route(monkeypatch, route):
    """Partitions for ``route``: "single" one block a step (G = 1), or
    "grouped" groups of 4 in the unfused form at one partition."""
    for var in ("BRUTEFIR_TPU_PAIR", "BRUTEFIR_TPU_GROUP_FORM"):
        monkeypatch.delenv(var, raising=False)
    if route == "single":
        return 2
    monkeypatch.setenv("BRUTEFIR_TPU_PAIR", f"force:{BATCH}")
    monkeypatch.setenv("BRUTEFIR_TPU_GROUP_FORM", "unfused")
    return 1


# input frames: 1, 2 and 5 whole batches, and EOF inside the third batch
# with a partial block
FRAMES = {"1_batch": BATCH * N, "2_batches": 2 * BATCH * N,
          "5_batches": 5 * BATCH * N, "eof_mid_batch": (2 * BATCH + 1) * N
          + 100}


@pytest.mark.parametrize("frames", sorted(FRAMES))
@pytest.mark.parametrize("route", ["single", "grouped"])
def test_run_offline_bytes_equal_run(tmp_path, monkeypatch, route, frames):
    """``run_offline`` in batches of 4, its stacks handed out dirty,
    writes the bytes ``run()`` writes block by block; the batch program
    takes the route asked for."""
    P = _route(monkeypatch, route)
    _input(tmp_path, FRAMES[frames])
    eng = _engine(_config(tmp_path, "offline", P))
    eng.staging = DirtyStacks(CPU)
    stats = eng.run_offline(batch_blocks=BATCH)
    if FRAMES[frames] >= BATCH * N:
        prog = eng.dio.programs()[("multi", BATCH, True, True)]
        assert prog.route == ((BATCH, "unfused") if route == "grouped"
                              else (1, "none"))
    batches = -(-(FRAMES[frames] + 1) // (BATCH * N))
    assert stats["staging"]["fresh_batches"] == batches
    assert stats["staging"]["pinned_batches"] == 0
    _engine(_config(tmp_path, "run", P)).run()
    got, want = _outputs(tmp_path, "offline"), _outputs(tmp_path, "run")
    assert len(want[0]) == FRAMES[frames] * FRAME
    assert got == want


@pytest.mark.parametrize("fill", [0, BATCH * N - 1, 3 * N + 17])
def test_read_in_place_matches_fresh_read(tmp_path, fill):
    """``read_block_dio(into=...)`` into dirty rows gives the words and
    frames of a fresh read, the padding after a short read zeroed."""
    _input(tmp_path, fill)
    a = _engine(_config(tmp_path, "a"))
    b = _engine(_config(tmp_path, "b"))
    a.setup()
    b.setup()
    try:
        for _ in range(BATCH + 1):
            want, fw = a.read_block_dio()
            rows = [np.full((N, C), 0x5A5A5A5A, np.int32)]
            got, fg = b.read_block_dio(into=rows)
            assert fg == fw
            assert got[0] is rows[0]
            np.testing.assert_array_equal(got[0], want[0])
    finally:
        a.teardown()
        b.teardown()


class KeepAll:
    """Wraps an output device's ``write`` to keep every buffer it is
    given beside a copy of its bytes at the time of the write."""

    def __init__(self, dev):
        self.kept = []
        self._write = dev.write
        dev.write = self.write

    def write(self, data):
        self.kept.append((data, bytes(data)))
        return self._write(data)


@pytest.mark.parametrize("entry", ["run_offline", "run"])
def test_kept_buffers_never_change(tmp_path, entry):
    """A device that keeps every buffer it was given finds each one as it
    was written once the run has ended, and the pool reused none."""
    _input(tmp_path, 5 * BATCH * N + 77)
    eng = _engine(_config(tmp_path, "out"))
    keep = KeepAll(eng.devices[OUT][0])
    stats = (eng.run_offline(batch_blocks=BATCH) if entry == "run_offline"
             else eng.run())
    assert len(keep.kept) > staging_mod.POOL_KEEP
    for data, at_write in keep.kept:
        assert len(data) == len(at_write)
        assert bytes(data) == at_write
    assert stats["staging"]["pool_reused"] == 0
    assert stats["staging"]["pool_new"] == len(keep.kept)
    assert b"".join(w for _, w in keep.kept) == _outputs(tmp_path, "out")[0]



def test_recorder_keeps_what_was_written(tmp_path):
    """The benchmark's own ``check.Recorder`` (its first and last writes
    and a reservoir of 2): each kept buffer equals the file's bytes at
    its stream position once the run has ended, though the pool reused
    arrays it let go."""
    from portbench import check
    _input(tmp_path, 6 * BATCH * N)
    eng = _engine(_config(tmp_path, "out", loop=True))
    rec = check.Recorder(eng.devices[OUT][0], FRAME, 2,
                         np.random.default_rng(7))
    rec.active = True
    stats = eng.run_offline(max_blocks=12 * BATCH, batch_blocks=BATCH)
    kept = rec.kept()
    rec.release()
    assert stats["staging"]["pool_reused"] > 0
    assert len(kept) >= 3
    out = _outputs(tmp_path, "out")[0]
    for pos, data in kept:
        assert bytes(data) == out[pos * FRAME: pos * FRAME + len(data)]


@pytest.mark.parametrize("entry", ["run_offline", "run"])
def test_pool_reuses_when_nothing_is_kept(tmp_path, entry):
    """Two output devices that keep nothing: at most ``POOL_KEEP`` new
    arrays a device, every other write from a reused one."""
    _input(tmp_path, 5 * BATCH * N + 77)
    eng = _engine(_config(tmp_path, "out", outs=2))
    writes = [0, 0]
    for k in range(2):
        dev = eng.devices[OUT][k]

        def counted(data, k=k, write=dev.write):
            writes[k] += 1
            return write(data)

        dev.write = counted
    stats = (eng.run_offline(batch_blocks=BATCH) if entry == "run_offline"
             else eng.run())
    s = stats["staging"]
    assert min(writes) > staging_mod.POOL_KEEP
    assert s["pool_new"] <= staging_mod.POOL_KEEP * 2
    assert s["pool_reused"] == sum(writes) - s["pool_new"]


def test_pool_follows_held_arrays():
    """``Staging.encode``: a held array (or a view of it) is never handed
    out again; once let go it is reused, its length the byte count; of
    the free arrays the pool keeps ``POOL_KEEP``, and it follows at most
    ``POOL_FOLLOW`` arrays."""
    keep = staging_mod.POOL_KEEP
    st = Staging(CPU)
    src = np.arange(24, dtype=np.int32).reshape(6, 4)
    held = [st.encode(0, src) for _ in range(keep + 2)]
    assert st.counts == dict(pinned_batches=0, fresh_batches=0,
                             pool_reused=0, pool_new=keep + 2)
    assert len({id(a) for a in held}) == keep + 2
    assert all(len(a) == src.nbytes and a.tobytes() == src.tobytes()
               for a in held)
    views = [a[:4] for a in held]
    del held
    b = st.encode(0, src)
    assert st.counts["pool_new"] == keep + 3
    del views, b
    c = st.encode(0, src[:3])
    assert st.counts["pool_reused"] == 1
    assert len(c) == src[:3].nbytes and c.tobytes() == src[:3].tobytes()
    assert len(st._pool[0]) == keep
    kept = [c] + [st.encode(0, src) for _ in range(staging_mod.POOL_FOLLOW)]
    assert len(st._pool[0]) == staging_mod.POOL_FOLLOW
    assert all(a.tobytes() == src.tobytes() for a in kept[1:])


def test_pool_reuses_beside_a_reservoir():
    """A device that keeps its first writes and then only its last, as
    ``check.Recorder``'s reservoir comes to: the arrays it holds stay
    out of use, and the later writes take turns in two arrays (the one
    the device holds as its last, and the one it let go)."""
    st = Staging(CPU)
    src = np.arange(1024, dtype=np.int32)
    first = [st.encode(0, src) for _ in range(12)]
    last = None
    for _ in range(50):
        last = st.encode(0, src)
    assert st.counts["pool_new"] == 14
    assert st.counts["pool_reused"] == 48
    assert all(a.tobytes() == src.tobytes() for a in first + [last])


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_card_stacks_are_pinned_and_bytes_equal_run(cuda, tmp_path):
    """On the card: every batch read in place into a pinned stack, and
    ``run_offline``'s bytes equal to ``run()``'s, EOF inside a batch
    (the reused stack's stale rows zeroed)."""
    frames = (3 * BATCH + 2) * N + 61
    _input(tmp_path, frames)
    eng = _engine(_config(tmp_path, "offline"), cuda)
    stats = eng.run_offline(batch_blocks=BATCH)
    assert stats["staging"]["pinned_batches"] == 4
    assert stats["staging"]["fresh_batches"] == 0
    assert stats["staging"]["pool_new"] <= staging_mod.POOL_KEEP
    _engine(_config(tmp_path, "run"), cuda).run()
    got, want = _outputs(tmp_path, "offline"), _outputs(tmp_path, "run")
    assert len(want[0]) == frames * FRAME
    assert got == want


@pytest.mark.cuda
def test_card_traced_window_has_no_pageable_copy(cuda, tmp_path):
    """A traced window of ``run_offline`` (past its warm-up, which made
    and captured the programs) records copies each way and none of them
    from or to pageable memory."""
    from portbench import trace
    _input(tmp_path, 4 * BATCH * N)
    eng = _engine(_config(tmp_path, "out", loop=True), cuda)
    eng.setup()
    eng.run_offline(max_blocks=3 * BATCH, batch_blocks=BATCH, setup=False)
    torch.cuda.synchronize()
    prof = trace.start()
    stats = eng.run_offline(max_blocks=9 * BATCH, batch_blocks=BATCH,
                            setup=False)
    torch.cuda.synchronize()
    prof.stop()
    eng.teardown()
    assert stats["staging"]["pinned_batches"] == 6
    copies = [name for _, kind, name, _, _ in trace.device_events(prof)
              if kind == "gpu_memcpy"]
    assert any("HtoD" in n for n in copies)
    assert any("DtoH" in n for n in copies)
    assert not [n for n in copies if "Pageable" in n]
