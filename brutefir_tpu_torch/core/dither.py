"""High-passed TPDF dither with error feedback.

A copy of :mod:`brutefir_tpu.core.dither` (`dither.c:37-139`,
`dither_funs.h:7-68`, `dither.h:28-38`):

* a maximally equidistributed combined Tausworthe generator (GSL flavor)
  seeded with the fixed seed 0 (-> 1) fills a shared int8 random table sized
  ``n_channels * spacing + 1`` where spacing ~ 10 s of audio per channel;
* the TPDF dither value for sample n is ``randmap[tab[p+n] - tab[p+n-1]]``
  -- the difference of consecutive uniform bytes (triangular pdf) mapped
  through a table that also folds in the +0.5 mid-tread offset;
* quantization applies {1,-1} error feedback (first-order high pass) before
  adding dither, then truncates; feedback state persists across blocks.

On the device-IO path the engine quantizes on the device
(``ops/device_dither.py``); on the host codec path ``write_block`` runs
``DitherState.quantize``. The error-feedback recurrence is sequential per
sample: the native C++ codec (:mod:`brutefir_tpu_torch.core.native`) runs
it when available, else a Python loop (correct, slow) with the same
results.

``tausrand_table`` makes the same bytes as the JAX package's one-byte-a-
step loop, in parallel lanes: each of the generator's three components is
a linear map of its 32-bit state over GF(2), so the state L steps ahead is
a 32 x 32 bit matrix (the one-step matrix raised to L by squaring) applied
to it. Lanes start L steps apart and step together in numpy uint64.
"""

from __future__ import annotations

import math

import numpy as np

from .codecs import Overflow
from .sampleformat import SampleFormat

RANDTAB_SPACING = 10  # seconds (dither.c:21)
MIN_RANDTAB_SPACING = 1

_M32 = 0xFFFFFFFF
# per component (dither.c:37-58): (keep mask, left shift after it, inner
# left shift, right shift of the inner xor)
_TAUS = ((4294967294, 12, 13, 19),
         (4294967288, 4, 2, 25),
         (4294967280, 17, 3, 11))


def _taus_step(s, comp):
    """One step of component ``comp`` on uint64 state(s) < 2^32. Every
    left shift is masked to 32 bits BEFORE the xor and the right shift,
    as the C macro's uint32 arithmetic wraps (dither.c:47-58; the order
    is pinned by golden vectors in the JAX package's tests)."""
    keep, a, b, c = (np.uint64(v) for v in _TAUS[comp])
    m = np.uint64(_M32)
    return (((s & keep) << a) & m) ^ ((((s << b) & m) ^ s) >> c)


def _gf2_apply(cols: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The 32 x 32 GF(2) matrix with columns ``cols`` ([32] uint64, column
    k the image of bit k) applied to each uint64 in ``v``."""
    out = np.zeros_like(v)
    one = np.uint64(1)
    for k in range(32):
        out ^= ((v >> np.uint64(k)) & one) * cols[k]
    return out


def _gf2_power(cols: np.ndarray, n: int) -> np.ndarray:
    """The matrix ``cols`` raised to ``n`` (n >= 0) by squaring."""
    result = np.asarray([1 << k for k in range(32)], np.uint64)
    base = cols.copy()
    while n:
        if n & 1:
            result = _gf2_apply(base, result)
        n >>= 1
        if n:
            base = _gf2_apply(base, base)
    return result


def lane_length(n: int) -> int:
    """Bytes each lane of ``tausrand_table(n)`` makes: about 4 sqrt(n)
    lanes, so the per-step numpy calls and the lanes' width balance."""
    lanes = max(1, min(n, 4 * math.isqrt(max(n, 1))))
    return -(-n // lanes) if n else 0


def tausrand_table(n: int, seed: int = 0) -> np.ndarray:
    """n int8 values of the reference Tausworthe generator: the bytes of
    `dither.c:37-71` (tausinit + tausrand, the LCG seeding and six warm-up
    draws), made in parallel lanes of ``lane_length(n)`` steps."""
    if seed == 0:
        seed = 1
    s0 = (69069 * seed) & _M32
    s1 = (69069 * s0) & _M32
    s2 = (69069 * s1) & _M32
    if n <= 0:
        return np.empty(0, np.int8)
    L = lane_length(n)
    P = -(-n // L)
    states = []
    for comp, s in enumerate((s0, s1, s2)):
        step = np.asarray([int(_taus_step(np.uint64(1 << k), comp))
                           for k in range(32)], np.uint64)
        # the state before output byte 0: after the six warm-up draws
        lane = _gf2_apply(_gf2_power(step, 6), np.asarray([s], np.uint64))
        # lane j starts j * L steps later: double the lanes with the
        # matrices for L, 2L, 4L, ... steps
        jump = _gf2_power(step, L)
        while lane.size < P:
            lane = np.concatenate([lane, _gf2_apply(jump, lane)])
            jump = _gf2_apply(jump, jump)
        states.append(lane[:P])
    out = np.empty((L, P), np.uint8)
    byte = np.uint64(0xFF)
    for i in range(L):
        states = [_taus_step(s, comp) for comp, s in enumerate(states)]
        out[i] = (states[0] ^ states[1] ^ states[2]) & byte
    return out.T.reshape(-1)[:n].view(np.int8)   # (int8_t) wraps (dither.c:108)


def build_randmap(dtype=np.float32) -> np.ndarray:
    """The dither-difference -> float map of `dither.c:112-131`.

    Indexed by (tab[n] - tab[n-1]) + 256, covering [-256, 254].
    """
    m = np.empty(512, dtype=dtype)
    m[0] = -0.5  # index -256
    n = np.arange(-255, 254, dtype=np.float64)
    m[1:510] = (0.5 + 1.0 / 255.0 + n / 255.0).astype(dtype)
    m[510] = 1.5  # index 254
    # Index 255 *is* reachable (tab diff of 127 - (-128)) but the reference
    # allocates only [-256, 254] and reads past the end there
    # (dither.c:115-131) -- an upstream out-of-bounds read. We define it by
    # continuing the line so the TPDF stays bounded.
    m[511] = dtype(1.5 + 1.0 / 255.0)
    return m


class DitherTable:
    """Shared random table + per-channel pointers (`dither_init`)."""

    def __init__(self, n_channels: int, sample_rate: int, max_size: int,
                 max_samples_per_loop: int, dtype=np.float32):
        spacing = RANDTAB_SPACING * sample_rate
        minspacing = max(MIN_RANDTAB_SPACING * sample_rate, max_samples_per_loop)
        if spacing < minspacing:
            spacing = minspacing
        if max_size > 0 and n_channels * spacing > max_size:
            spacing = max_size // n_channels
        if spacing < minspacing:
            # the floor is whichever of the two minspacing terms binds
            raise ValueError(
                f"maximum dither table size {max_size} bytes is too small, "
                f"must at least be {n_channels * minspacing} bytes")
        self.size = n_channels * spacing + 1
        self.spacing = spacing
        self.tab = tausrand_table(self.size)
        self.randmap = build_randmap(dtype)
        self.dtype = dtype

    def new_state(self, channel_index: int) -> "DitherState":
        return DitherState(self, channel_index * self.spacing + 1)


class DitherState:
    """Per-channel dither state (`struct dither_state`, dither.h:17-22)."""

    def __init__(self, table: DitherTable, randtab_ptr: int):
        self.table = table
        self.randtab_ptr = randtab_ptr
        self.sf = np.zeros(2, dtype=table.dtype)  # error feedback [sf0, sf1]

    def _next_window(self, n: int) -> np.ndarray:
        """Advance the table pointer; return the dither floats for n samples.

        Mirrors dither_preloop_real2int_hp_tpdf (dither.h:28-38): on wrap,
        tab[0] takes the previous last value so the n-1 difference chain
        stays continuous.
        """
        t = self.table
        if self.randtab_ptr + n >= t.size:
            t.tab[0] = t.tab[self.randtab_ptr - 1]
            self.randtab_ptr = 1
        p = self.randtab_ptr
        self.randtab_ptr += n
        cur = t.tab[p : p + n].astype(np.int32)
        prev = t.tab[p - 1 : p + n - 1].astype(np.int32)
        return t.randmap[(cur - prev) + 256]

    def quantize(self, x: np.ndarray, fmt: SampleFormat, overflow: Overflow) -> np.ndarray:
        """HP-TPDF dithered mid-tread quantization (`dither_funs.h:7-68`)."""
        n = x.shape[0]
        d = self._next_window(n)
        if x.dtype == np.float32 and self.table.dtype == np.float32:
            # the numpy loop only where the native codec cannot run: a
            # failed build with a compiler present raises
            from . import native
            if native.available():
                return native.dither_quantize(
                    np.ascontiguousarray(x, np.float32), d, self.sf,
                    fmt, overflow)
        return self._quantize_py(x, d, fmt, overflow)

    def _quantize_py(self, x: np.ndarray, d: np.ndarray, fmt: SampleFormat,
                     overflow: Overflow) -> np.ndarray:
        rt = self.table.dtype
        imin, imax = fmt.imin, fmt.imax
        rmin, rmax = rt(imin), rt(imax)
        # bits==32 float32: rmax rounds UP to 2^31, so d == 2^31 would
        # pass `d > rmax` and overflow the int32 store (the reference's
        # cast there is UB -- same clip_hi rule as codec.cpp)
        clip_hi = (rmax if float(rmax) > imax
                   else np.nextafter(rmax, rt(np.inf)))
        sf0, sf1 = rt(self.sf[0]), rt(self.sf[1])
        out = np.empty(x.shape[0], dtype=np.int32)
        n_ovf = 0
        largest = overflow.largest
        intlargest = overflow.intlargest
        for i in range(x.shape[0]):
            # feedback difference first, then add -- the reference's
            # `real_sample += sf[0] - sf[1]` association; (x + sf0) - sf1
            # rounds differently in float32 (golden-vector verified)
            real = rt(x[i]) + (sf0 - sf1)
            sf1 = sf0
            dithered = real + rt(d[i])
            if dithered != dithered:
                # NaN: saturate + count + reset the feedback, like the
                # native path (codec.cpp) -- int(NaN) would raise
                out[i] = imin
                n_ovf += 1
                sf0 = rt(0.0)
                continue
            # clip peak compares `real` but stores `dithered` -- the
            # reference's exact accounting (dither_funs.h:38-39,52-53),
            # pinned by the golden-vector tests
            if dithered < 0:
                if dithered <= rmin:
                    s = imin
                    n_ovf += 1
                    if real < -largest:
                        largest = float(-dithered)
                else:
                    s = int(dithered) - 1
                    if -s > intlargest:
                        intlargest = -s
            else:
                if dithered >= clip_hi:
                    s = imax
                    n_ovf += 1
                    if real > largest:
                        largest = float(dithered)
                else:
                    s = int(dithered)
                    if s > intlargest:
                        intlargest = s
            sf0 = real - rt(s)
            out[i] = s
        self.sf[0], self.sf[1] = sf0, sf1
        overflow.n_overflows += n_ovf
        overflow.largest = largest
        overflow.intlargest = intlargest
        return out
