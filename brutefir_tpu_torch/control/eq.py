"""Dynamic equalizer logic module.

Reimplements `bflogic_eq.c` + `rendereq.h`: per-equalizer band definitions
(explicit lists or "ISO octave"/"ISO 1/3 octave" presets clipped to Nyquist),
magnitude/phase targets cosine-interpolated across the rfft bins of the full
filter length, a linear-phase term of taps/2 samples, inverse transform to an
impulse response, and per-partition re-preprocessing into a *double-buffered*
pair of coefficient sets hot-swapped through the coeff_final hook
(`bflogic_eq.c:105-120`, `bfrun.c:1574-1578`).

Runtime protocol (via ``lmc eq ...``):
    <coeff> mag   <freq>/<dB>[,...]
    <coeff> phase <freq>/<degrees>[,...]
    <coeff> info

Faithfulness notes: phase values convert with the reference's
``value / (180 * pi)`` (bflogic_eq.c:176) and print back with the inverse,
and band-match tolerance is the same relative 0.99-1.01 window.
"""

from __future__ import annotations

import math

import numpy as np

from ..config.lexer import T
from ..ops.partconv import preprocess_coeffs, np_c2p
from . import register_logic_module

MAX_BANDS = 128

ISO_OCTAVE = [31.5, 63, 125, 250, 500, 1000, 2000, 4000, 8000, 16000]
ISO_THIRD_OCTAVE = [20, 25, 31, 40, 50, 63, 80, 100, 125, 160, 200, 250,
                    315, 400, 500, 630, 800, 1000, 1250, 1600, 2000, 2500,
                    3150, 4000, 5000, 6300, 8000, 10000, 12500, 16000, 20000]


class _Eq:
    def __init__(self):
        self.coeff = [-1, -1]
        self.active = 0
        self.band_count = 0
        self.freq = None    # normalized (freq / sample_rate), incl. edges
        self.mag = None     # linear
        self.phase = None   # reference units: degrees / (180*pi)
        self.taps = 0


class EqModule:
    def __init__(self, params, engine):
        self.engine = engine
        self.conf = engine.conf
        self.sample_rate = self.conf.sampling_rate
        self.block_length = self.conf.filter_length
        self.debug_dump_filter = None
        self.equalisers = []
        self._parse_params(params)
        self._check_disjoint()
        # chain (not overwrite): a config may declare several eq logic
        # modules; each module's redirect passes through coefficients it
        # does not own, so composition is order-independent for the
        # disjoint sets each _check_disjoint enforces
        prev_hook = engine.control.coeff_final_hook

        def _chained(n, c, _prev=prev_hook, _mine=self._coeff_final):
            if _prev is not None:
                c = _prev(n, c)
            return _mine(n, c)

        engine.control.coeff_final_hook = _chained
        for eq in self.equalisers:
            self._render(eq)

    # --- config parsing ----------------------------------------------------
    def _parse_params(self, params):
        i = 0
        n = len(params)

        def need(kind, err):
            nonlocal i
            if i >= n or params[i].kind != kind:
                raise RuntimeError(f"EQ: parse error: {err}")
            t = params[i]
            i += 1
            return t

        def peek():
            return params[i] if i < n else None

        while i < n:
            t = params[i]
            if t.kind == T.LBRACE:
                # reference syntax: each equalizer is a brace block
                i += 1
                self._parse_eq_block(params, need, peek, braced=True)
                need(T.EOS, "expected end of statement (;)")
            elif t.kind == T.FIELD and t.value == "debug_dump_filter":
                i += 1
                path = need(T.STRING, "expected string").value
                if "%d" not in path:
                    raise RuntimeError("EQ: parse error: %d is missing in name")
                self.debug_dump_filter = path
                need(T.EOS, "expected end of statement (;)")
            elif t.kind == T.FIELD:
                # convenience form: bare fields define a single equalizer
                self._parse_eq_block(params, need, peek, braced=False)
            else:
                raise RuntimeError("EQ: parse error: expected field")

    def _parse_eq_block(self, params, need, peek, braced=True):
        conf = self.conf
        eq = _Eq()
        mag_pairs, phase_pairs, bands = [], [], None
        while True:
            t = peek()
            if t is None:
                if braced:
                    raise RuntimeError("EQ: parse error: unexpected end")
                break
            need(t.kind, "")  # consume
            if t.kind == T.RBRACE:
                break
            if t.kind != T.FIELD:
                raise RuntimeError("EQ: parse error: expected field")
            f = t.value
            if f == "bands":
                t = peek()
                if t is None:
                    raise RuntimeError("EQ: parse error: unexpected end")
                if t.kind == T.STRING:
                    need(T.STRING, "")
                    if t.value == "ISO octave":
                        bands = list(ISO_OCTAVE)
                    elif t.value == "ISO 1/3 octave":
                        bands = list(ISO_THIRD_OCTAVE)
                    else:
                        raise RuntimeError(
                            'EQ: parse error: expected "ISO octave" or '
                            '"ISO 1/3 octave"')
                    need(T.EOS, "expected end of statement (;)")
                    while len(bands) > 1 and bands[-1] >= self.sample_rate / 2:
                        bands.pop()
                else:
                    bands = [need(T.REAL, "expected real").value]
                    if bands[0] <= 0.0:
                        raise RuntimeError(
                            "EQ: parse error: band frequencies must be "
                            "larger than 0 Hz")
                    while peek() is not None and peek().kind == T.COMMA:
                        need(T.COMMA, "")
                        v = need(T.REAL, "expected real").value
                        if bands[-1] >= v:
                            raise RuntimeError(
                                "EQ: parse error: frequencies not sorted")
                        bands.append(v)
                    need(T.EOS, "expected end of statement (;)")
                if bands[-1] >= self.sample_rate / 2:
                    raise RuntimeError(
                        "EQ: parse error: band frequencies must be less "
                        "than sample rate / 2")
            elif f == "coeff":
                for k in range(2):
                    t = peek()
                    if t is None:
                        raise RuntimeError(
                            "EQ: parse error: unexpected end")
                    if t.kind == T.STRING:
                        need(T.STRING, "")
                        names = [c.name for c in conf.coeffs]
                        if t.value not in names:
                            raise RuntimeError("EQ: unknown coefficient name")
                        eq.coeff[k] = names.index(t.value)
                    elif t.kind == T.REAL:
                        need(T.REAL, "")
                        eq.coeff[k] = int(t.value)
                        if not (0 <= eq.coeff[k] < len(conf.coeffs)):
                            raise RuntimeError("EQ: invalid coefficient index")
                    else:
                        raise RuntimeError(
                            "EQ: parse error: expected integer or string")
                    if k == 0:
                        t = peek()
                        if t is None:
                            raise RuntimeError(
                                "EQ: parse error: unexpected end")
                        if t.kind == T.EOS:
                            need(T.EOS, "")
                            eq.coeff[1] = eq.coeff[0]
                            break
                        need(T.COMMA, "expected comma")
                    else:
                        need(T.EOS, "expected end of statement (;)")
            elif f == "magnitude":
                mag_pairs = self._parse_freq_val(params, need, peek)
            elif f == "phase":
                phase_pairs = self._parse_freq_val(params, need, peek)
            else:
                raise RuntimeError(f'EQ: parse error: unknown field "{f}"')
        if eq.coeff[0] == -1:
            raise RuntimeError("EQ: parse error: coeff not set")
        if bands is None:
            raise RuntimeError("EQ: parse error: bands not set")
        self._finalise(eq, mag_pairs, phase_pairs, bands)
        self.equalisers.append(eq)

    def _parse_freq_val(self, params, need, peek):
        pairs = []
        while True:
            fr = need(T.REAL, "expected real").value
            if fr < 0:
                raise RuntimeError("EQ: parse error: negative frequency")
            if fr > self.sample_rate / 2:
                raise RuntimeError(
                    "EQ: parse error: frequency larger than nykvist")
            if pairs and fr <= pairs[-1][0]:
                raise RuntimeError("EQ: parse error: frequencies not sorted")
            need(T.SLASH, "expected slash (/)")
            v = need(T.REAL, "expected real").value
            pairs.append((fr, v))
            t = peek()
            if t is not None and t.kind == T.COMMA:
                need(T.COMMA, "")
                continue
            need(T.EOS, "expected end of statement (;)")
            return pairs

    def _finalise(self, eq, mag_pairs, phase_pairs, bands):
        conf = self.conf
        freq = [0.0] + list(bands) + [self.sample_rate / 2.0]
        bc = len(freq)
        mag = [0.0] * bc
        phase = [0.0] * bc
        for fr, v in mag_pairs:
            if fr not in freq:
                raise RuntimeError(
                    f"EQ: {fr:.1f} Hz is not a band frequency")
            mag[freq.index(fr)] = v
        # a magnitude given AT 0 Hz or Nyquist is accepted but then
        # overwritten by this unconditional edge mirroring -- exactly the
        # reference's (quirky) behavior, bflogic_eq.c:146-158
        mag[0] = mag[1]
        mag[-1] = mag[-2]
        for fr, v in phase_pairs:
            if fr not in freq:
                raise RuntimeError(
                    f"EQ: {fr:.1f} Hz is not a band frequency")
            phase[freq.index(fr)] = v
        eq.freq = np.array(freq) / self.sample_rate
        eq.mag = np.power(10.0, np.array(mag) / 20.0)
        eq.phase = np.array(phase) / (180.0 * math.pi)  # reference units
        eq.band_count = bc
        for c in eq.coeff:
            if not conf.coeffs[c].is_shared:
                raise RuntimeError(
                    f"EQ: coefficient {c} must be in shared memory")
            total = self.block_length * conf.coeffs[c].n_blocks
            if total & (total - 1):
                raise RuntimeError(
                    f"EQ: coefficient {c} length is not a power of two")
        if conf.coeffs[eq.coeff[0]].n_blocks != conf.coeffs[eq.coeff[1]].n_blocks:
            raise RuntimeError(
                f"EQ: coefficient {eq.coeff[0]} and {eq.coeff[1]} must be "
                "the same length")
        eq.taps = self.block_length * conf.coeffs[eq.coeff[0]].n_blocks

    def _check_disjoint(self):
        seen = set()
        for eq in self.equalisers:
            pair = set(eq.coeff)
            if seen & pair:
                raise RuntimeError(
                    "EQ: at least two equalisers has at least one "
                    "coefficient set in common")
            seen |= pair

    # --- rendering (rendereq.h:20-102) --------------------------------------
    def render_impulse(self, eq) -> np.ndarray:
        """Render the EQ curve to a taps-length impulse response."""
        rd = self.engine.rd.type
        taps = eq.taps
        K = taps // 2 + 1
        k = np.arange(K, dtype=np.float64)
        curfreq = k / taps
        # piecewise cosine interpolation between band points
        idx = np.searchsorted(eq.freq, curfreq, side="left")
        idx = np.clip(idx, 1, eq.band_count - 1)
        f1, f2 = eq.freq[idx - 1], eq.freq[idx]
        t = (curfreq - f1) / (f2 - f1)
        cosw = np.cos(math.pi * t)
        m1, m2 = eq.mag[idx - 1], eq.mag[idx]
        p1, p2 = eq.phase[idx - 1], eq.phase[idx]
        mag = (m1 - m2) * 0.5 * cosw + (m1 + m2) * 0.5
        rad = -taps * math.pi * curfreq + ((p1 - p2) * 0.5 * cosw + (p1 + p2) * 0.5)
        spec = mag * np.exp(1j * rad)
        # DC and Nyquist bins are pure real in the reference render
        spec[0] = eq.mag[0]
        spec[-1] = eq.mag[-1]
        return np.fft.irfft(spec, n=taps).astype(rd)

    def _render(self, eq):
        impulse = self.render_impulse(eq)
        if self.debug_dump_filter is not None:
            path = self.debug_dump_filter.replace("%d", str(eq.coeff[0]))
            with open(path, "wt") as fh:
                for v in impulse:
                    fh.write(f"{v:.16e}\n")
        inactive = eq.coeff[1 - eq.active]
        n_blocks = self.conf.coeffs[inactive].n_blocks
        H = preprocess_coeffs(impulse, self.block_length, n_blocks,
                              1.0, self.engine.rd.type)
        full = np.zeros((self.conf.n_blocks, self.block_length), H.dtype)
        full[:n_blocks] = H
        self.engine.update_bank_entry(inactive, np_c2p(full))
        eq.active = 1 - eq.active
        self.engine.control.mark_dirty()

    def _coeff_final(self, filter_idx: int, coeff: int) -> int:
        for eq in self.equalisers:
            if coeff in eq.coeff:
                return eq.coeff[eq.active]
        return coeff

    # --- runtime commands (bflogic_command, bflogic_eq.c:706-855) -----------
    def command(self, params: str):
        cmd = params.strip()
        if cmd.startswith('"'):
            end = cmd.index('"', 1) if '"' in cmd[1:] else -1
            if end < 0:
                return False, "Invalid coefficient.\n"
            name = cmd[1:end]
            names = [c.name for c in self.conf.coeffs]
            if name not in names:
                return False, (f'Coefficient with name "{name}" does not '
                               "exist.\n")
            coeff = names.index(name)
            cmd = cmd[end + 1:].strip()
        else:
            parts = cmd.split(None, 1)
            try:
                coeff = int(parts[0])
            except (ValueError, IndexError):
                return False, "Invalid number.\n"
            cmd = parts[1] if len(parts) > 1 else ""
        eq = next((e for e in self.equalisers if coeff in e.coeff), None)
        if eq is None:
            return False, "The given coefficient is not controlled.\n"

        cmd = cmd.strip()
        if cmd.startswith("mag"):
            return self._change(eq, cmd[3:].strip(), is_mag=True)
        if cmd.startswith("phase"):
            return self._change(eq, cmd[5:].strip(), is_mag=False)
        if cmd.startswith("info"):
            return True, self._info(eq)
        return False, "Unknown command.\n"

    def _change(self, eq, lst: str, is_mag: bool):
        pairs = []
        for item in lst.split(","):
            item = item.strip()
            if not item:
                continue
            if "/" not in item:
                return False, "Invalid frequency/value list.\n"
            a, b = item.split("/", 1)
            try:
                pairs.append((float(a), float(b)))
            except ValueError:
                return False, "Invalid frequency/value list.\n"
        if any(pairs[i][0] >= pairs[i + 1][0] for i in range(len(pairs) - 1)):
            return False, "Frequency bands not sorted.\n"
        updates = []
        n = 0
        for fr, v in pairs:
            fn = fr / self.sample_rate
            while n < eq.band_count and not (
                    0.99 * eq.freq[n] < fn < 1.01 * eq.freq[n]):
                n += 1
            if n == eq.band_count:
                return False, "At least one invalid frequency band.\n"
            val = 10 ** (v / 20.0) if is_mag else v / (180.0 * math.pi)
            updates.append((n, val))
        with self.engine.control_mutex:
            for n, val in updates:
                if is_mag:
                    eq.mag[n] = val
                else:
                    eq.phase[n] = val
            self._render(eq)
        return True, "ok\n"

    def _info(self, eq):
        if eq.coeff[0] == eq.coeff[1]:
            lines = [f"coefficient {eq.coeff[0]}:"]
        else:
            lines = [f"coefficient {eq.coeff[0]},{eq.coeff[1]}:"]
        band = " band: "
        mag = "  mag: "
        phase = "phase: "
        for n in range(1, eq.band_count - 1):
            freq = eq.freq[n] * self.sample_rate
            band += f"{freq:6.1f}" if freq < 100 else f"{freq:6.0f}"
            mag += f"{20 * math.log10(eq.mag[n]):6.1f}"
            phase += f"{math.pi * 180 * eq.phase[n]:6.1f}"
        return "\n".join(lines + [band, mag, phase]) + "\n"


register_logic_module("eq", EqModule)
