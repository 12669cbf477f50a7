"""PROCESSED and shared-memory coefficients in brutefir_tpu_torch against
the JAX package's loaders, on the CPU: the port's copies of
``processed_to_spectral``, ``spectral_to_processed`` and
``read_shm_processed`` and the PROCESSED branch of
``load_coeff_bank_entry`` give bank entries bit-equal to the JAX
package's (the twins of tests/test_config.py's PROCESSED and shm tests),
and refuse the same broken inputs with the same messages."""

import ctypes

import numpy as np
import pytest
import torch

from brutefir_tpu.config import coeffs as jc
from brutefir_tpu.config.model import CoeffDef as JaxCoeffDef
from brutefir_tpu_torch.config import coeffs as tc
from brutefir_tpu_torch.config import parse_config
from brutefir_tpu_torch.config.model import CoeffDef
from brutefir_tpu_torch.ops.partconv import np_p2c, preprocess_coeffs

N, B = 64, 2


def _spectra(seed, rows=3):
    """[rows, N+1] spectra with real DC and Nyquist bins."""
    rng = np.random.default_rng(seed)
    H = (rng.standard_normal((rows, N + 1))
         + 1j * rng.standard_normal((rows, N + 1))).astype(np.complex64)
    H[:, 0] = H[:, 0].real
    H[:, -1] = H[:, -1].real
    return H


def _processed_taps(seed):
    """The PROCESSED dump of seeded taps' partitions ([B, 2N] float32),
    and their packed bank rows."""
    taps = (np.random.default_rng(seed).standard_normal(N * B)
            * 0.3).astype(np.float32)
    Hp = preprocess_coeffs(taps, N, B)               # packed [B, N]
    H = np.concatenate([Hp.real[:, :1] + 0j, Hp[:, 1:], Hp.imag[:, :1] + 0j],
                       axis=1)                       # [B, N+1]
    return tc.spectral_to_processed(H).astype(np.float32), Hp


def test_processed_roundtrip_bit_equal_to_jax():
    """Both conversions give the JAX package's arrays bit for bit, and
    the round trip returns the spectra within float32 rounding."""
    H = _spectra(1)
    cbuf = tc.spectral_to_processed(H)
    np.testing.assert_array_equal(cbuf, jc.spectral_to_processed(H))
    assert cbuf.shape == (3, 2 * N)
    back = tc.processed_to_spectral(cbuf)
    np.testing.assert_array_equal(back, jc.processed_to_spectral(cbuf))
    np.testing.assert_allclose(back, H, rtol=0, atol=2e-4 * np.abs(H).max())
    # one partition, squeezed, and a float64 target
    np.testing.assert_array_equal(tc.spectral_to_processed(H[0]),
                                  jc.spectral_to_processed(H[0]))
    np.testing.assert_array_equal(
        tc.processed_to_spectral(cbuf[1], np.complex128),
        jc.processed_to_spectral(cbuf[1], np.complex128))


def test_processed_file_load_bit_equal_to_jax(tmp_path):
    """A PROCESSED coeff file loads to the JAX package's bank entry, which
    is the preprocessed taps within float32 rounding."""
    payload, Hp = _processed_taps(2)
    path = tmp_path / "c.proc"
    payload.tofile(path)
    kw = dict(name="p", intname=0, format="PROCESSED", filename=str(path),
              n_blocks=B)
    got = tc.load_coeff_bank_entry(CoeffDef(**kw), N, B + 1)
    np.testing.assert_array_equal(
        got, jc.load_coeff_bank_entry(JaxCoeffDef(**kw), N, B + 1))
    np.testing.assert_allclose(got[:B], Hp, rtol=0,
                               atol=2e-3 * np.abs(Hp).max())
    assert not got[B].any()                  # partitions past n_blocks


def test_processed_config_bank_matches_jax(tmp_path):
    """A config with a PROCESSED coefficient (with ``skip``) builds the
    JAX engine's bank in the port's Engine."""
    from brutefir_tpu.config import parse_config as jax_parse_config
    from brutefir_tpu.runtime import Engine as JaxEngine
    from brutefir_tpu_torch.runtime.engine import Engine
    payload, _ = _processed_taps(3)
    (tmp_path / "c.proc").write_bytes(b"\0" * 16 + payload.tobytes())
    (tmp_path / "in.raw").write_bytes(b"")
    text = f"""
sampling_rate: 44100;
filter_length: {N},{B};
coeff 0 {{ filename: "{tmp_path / 'c.proc'}"; format: "PROCESSED"; skip: 16; }};
input 0 {{ device: "file" {{ path: "{tmp_path / 'in.raw'}"; }}; sample: "S24_4LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{tmp_path / 'out.raw'}"; }}; sample: "S24_4LE"; channels: 1; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
"""
    teng = Engine(parse_config(text), device=torch.device("cpu"))
    jeng = JaxEngine(jax_parse_config(text))
    np.testing.assert_array_equal(
        teng.bank.numpy(), np.asarray(jeng.bank).reshape(teng.bank.shape))
    assert np.abs(np_p2c(teng.bank.numpy()[0])).max() > 0


def _shm_segment(data: bytes):
    libc = ctypes.CDLL(None, use_errno=True)
    libc.shmat.restype = ctypes.c_void_p
    shmid = libc.shmget(0, len(data), 0o1000 | 0o600)   # IPC_PRIVATE
    if shmid < 0:
        pytest.skip("SysV shm unavailable")
    ptr = libc.shmat(shmid, None, 0)
    ctypes.memmove(ptr, data, len(data))
    libc.shmdt(ctypes.c_void_p(ptr))
    return libc, shmid


def test_shm_processed_coefficients_bit_equal_to_jax():
    """``filename: shmid/offset/blocks`` triples: a segment read in two
    parts at offsets gives the JAX package's bank entry."""
    payload, Hp = _processed_taps(4)
    half = payload[:1].tobytes()
    libc, shmid = _shm_segment(b"\0" * 32 + half + b"\0" * 8
                               + payload[1:].tobytes())
    try:
        parts = [(shmid, 32, 1), (shmid, 32 + len(half) + 8, 1)]
        raw = tc.read_shm_processed(shmid, 32, 1, N)
        np.testing.assert_array_equal(
            raw, jc.read_shm_processed(shmid, 32, 1, N))
        kw = dict(name="shm", intname=0, format="PROCESSED", shm_parts=parts,
                  n_blocks=B, is_shared=True)
        got = tc.load_coeff_bank_entry(CoeffDef(**kw), N, B)
        np.testing.assert_array_equal(
            got, jc.load_coeff_bank_entry(JaxCoeffDef(**kw), N, B))
        np.testing.assert_allclose(got, Hp, rtol=0,
                                   atol=2e-3 * np.abs(Hp).max())
    finally:
        libc.shmctl(shmid, 0, None)                     # IPC_RMID


BROKEN = {
    "short_file": dict(n_blocks=B + 1),
    "nan": dict(nan=True),
    "shm_block_count": dict(shm=True),
    "no_segment": dict(bad_shmid=True),
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_broken_processed_inputs_raise_as_jax(tmp_path, case):
    """A length mismatch, a NaN, a shm block count that disagrees with
    ``blocks`` and a segment that does not exist raise the JAX package's
    error with its message."""
    opt = BROKEN[case]
    payload, _ = _processed_taps(5)
    if opt.get("nan"):
        payload[0, 3] = np.nan
    path = tmp_path / "c.proc"
    payload.tofile(path)
    kw = dict(name="p", intname=0, format="PROCESSED", filename=str(path),
              n_blocks=opt.get("n_blocks", B))
    libc = None
    if opt.get("shm"):
        libc, shmid = _shm_segment(payload.tobytes())
        kw.update(filename="", shm_parts=[(shmid, 0, 1)], is_shared=True)
    if opt.get("bad_shmid"):
        kw.update(filename="", shm_parts=[(-7, 0, B)], is_shared=True)
    try:
        errs = []
        for mod, cls in ((tc, CoeffDef), (jc, JaxCoeffDef)):
            with pytest.raises((ValueError, OSError)) as ei:
                mod.load_coeff_bank_entry(cls(**kw), N, B)
            errs.append((type(ei.value), str(ei.value)))
        assert errs[0] == errs[1]
    finally:
        if libc is not None:
            libc.shmctl(shmid, 0, None)
