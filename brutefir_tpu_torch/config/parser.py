"""Recursive-descent parser for the BruteFIR configuration language.

Grammar and validation mirror the reference parser (`bfconf.c`):
structure blocks (`coeff`/`input`/`output`/`filter`), top-level settings
(`parse_setting` bfconf.c:1414-1640), per-edge gain syntax
``ch/att``, ``ch/att/mult`` and ``ch//mult`` (bfconf.c:883-984), two-level
defaults-then-main-config layering, and the full post-parse validation:
duplicate names, dangling references, bidirectional filter-edge
consistency (bfconf.c:2733-2768) and filter-loop detection.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional

from ..core.sampleformat import parse_sample_format, UnknownSampleFormat
from .lexer import T, Token, tokenize, ConfigParseError
from .model import (
    IN, OUT, MINFILTERLEN, MAXFILTERLEN, BF_MAXCHANNELS, BF_MAXFILTERS,
    BF_MAXPROCESSES, BF_SAMPLE_SLOTS, BF_UNDEFINED_SUBDELAY,
    BFConfig, CoeffDef, IODevDef, FilterDef,
)


def from_db(db: float) -> float:
    return 10.0 ** (db / 20.0)


def _make_integer(v: float, line: int, filename: str) -> int:
    if v != math.floor(v):
        raise ConfigParseError("expected integer", line, filename)
    return int(v)


class _Parser:
    def __init__(self, text: str, filename: str, conf: BFConfig,
                 parse_default: bool, defaults: Optional[dict]):
        self.tokens = list(tokenize(text, filename))
        self.pos = 0
        self.filename = filename
        self.conf = conf
        self.parse_default = parse_default
        self.defaults = defaults or {}
        self.seen_settings = set()

    # --- token plumbing -------------------------------------------------
    def peek(self) -> Token:
        return self.tokens[self.pos]

    def next(self) -> Token:
        t = self.tokens[self.pos]
        if t.kind != T.EOF:
            self.pos += 1
        return t

    def error(self, msg: str, tok: Token = None):
        raise ConfigParseError(msg, (tok or self.peek()).line, self.filename)

    def expect(self, kind: T) -> Token:
        t = self.next()
        if t.kind != kind:
            self.error(f"expected {kind.name}, got {t.kind.name}", t)
        return t

    def make_int(self, tok: Token) -> int:
        return _make_integer(tok.value, tok.line, self.filename)

    # --- helpers --------------------------------------------------------
    def get_params(self) -> list:
        """Capture a brace-balanced token list for module preinit replay."""
        self.expect(T.LBRACE)
        out = []
        depth = 0
        while True:
            t = self.next()
            if t.kind == T.EOF:
                self.error("unexpected EOF in module parameters", t)
            if t.kind == T.LBRACE:
                depth += 1
            elif t.kind == T.RBRACE:
                if depth == 0:
                    return out
                depth -= 1
            out.append(t)

    def get_int_list(self, first: Token, ending: T) -> List[int]:
        vals = [self.make_int(first)]
        while True:
            t = self.next()
            if t.kind == ending:
                return vals
            if t.kind != T.COMMA:
                self.error(f"expected {ending.name} or COMMA", t)
            vals.append(self.make_int(self.expect(T.REAL)))

    def get_string_list(self, first: Token, ending: T) -> List[str]:
        vals = [first.value]
        while True:
            t = self.next()
            if t.kind == ending:
                return vals
            if t.kind != T.COMMA:
                self.error(f"expected {ending.name} or COMMA", t)
            vals.append(self.expect(T.STRING).value)

    def get_bool_list(self, ending: T) -> List[bool]:
        vals = []
        while True:
            vals.append(self.expect(T.BOOLEAN).value)
            t = self.next()
            if t.kind == ending:
                return vals
            if t.kind != T.COMMA:
                self.error(f"expected {ending.name} or COMMA", t)

    def repeat_test(self, bitset: set, key: str, tok: Token):
        if key in bitset:
            self.error(f"field '{key}' already set", tok)
        bitset.add(key)

    # --- top level ------------------------------------------------------
    def parse(self):
        handlers = {
            T.COEFF: self.handle_coeff,
            T.INPUT: lambda: self.handle_iodev(IN),
            T.OUTPUT: lambda: self.handle_iodev(OUT),
            T.FILTER: self.handle_filter,
        }
        while True:
            t = self.next()
            if t.kind == T.EOF:
                return
            if t.kind == T.FIELD:
                self.parse_setting(t)
            elif t.kind in handlers:
                handlers[t.kind]()
            else:
                self.error("unexpected token", t)

    # --- settings (bfconf.c:1414-1640) -----------------------------------
    def parse_setting(self, field_tok: Token):
        name = field_tok.value
        conf = self.conf
        self.repeat_test(self.seen_settings, name, field_tok)

        def int_setting():
            v = self.make_int(self.expect(T.REAL))
            self.expect(T.EOS)
            return v

        def bool_setting():
            v = self.expect(T.BOOLEAN).value
            self.expect(T.EOS)
            return v

        def str_setting():
            v = self.expect(T.STRING).value
            self.expect(T.EOS)
            return v

        if name == "sampling_rate":
            conf.sampling_rate = int_setting()
            if conf.sampling_rate <= 0:
                self.error("invalid sampling_rate", field_tok)
        elif name == "config_file":
            if not self.parse_default:
                self.error("cannot set config_file setting in this file", field_tok)
            conf.config_file = os.path.expanduser(str_setting())
        elif name == "logic":
            while True:
                mname = self.expect(T.STRING).value
                params = self.get_params()
                conf.logic_modules = [
                    (n, p) for (n, p) in conf.logic_modules if n != mname]
                conf.logic_modules.append((mname, params))
                t = self.next()
                if t.kind == T.EOS:
                    break
                if t.kind != T.COMMA:
                    self.error("expected EOS or COMMA", t)
        elif name == "overflow_warnings":
            conf.overflow_warnings = bool_setting()
        elif name == "show_progress":
            conf.show_progress = bool_setting()
        elif name == "n_processors":
            int_setting()  # deprecated, parsed and ignored
        elif name == "max_dither_table_size":
            conf.max_dither_table_size = int_setting()
        elif name == "filter_length":
            conf.filter_length = self.make_int(self.expect(T.REAL))
            t = self.next()
            if t.kind == T.COMMA:
                conf.n_blocks = self.make_int(self.expect(T.REAL))
                self.expect(T.EOS)
            elif t.kind == T.EOS:
                conf.n_blocks = 1
            else:
                self.error("expected EOS or COMMA", t)
            total = conf.n_blocks * conf.filter_length
            if (conf.filter_length & (conf.filter_length - 1)) != 0 or \
                    not (MINFILTERLEN <= total <= MAXFILTERLEN):
                self.error(
                    f"filter length is not within {MINFILTERLEN} - "
                    f"{MAXFILTERLEN} or not a power of 2", field_tok)
        elif name == "lock_memory":
            conf.lock_memory = bool_setting()
        elif name == "modules_path":
            conf.modules_path = os.path.expanduser(str_setting())
        elif name == "monitor_rate":
            conf.monitor_rate = bool_setting()
        elif name == "debug":
            conf.debug = bool_setting()
        elif name == "powersave":
            t = self.next()
            if t.kind == T.REAL:
                conf.analog_powersave = from_db(t.value)
                if conf.analog_powersave < 1.0:
                    conf.powersave = True
            elif t.kind == T.BOOLEAN:
                conf.analog_powersave = 1.0
                conf.powersave = t.value
            else:
                self.error("expected BOOLEAN or REAL", t)
            self.expect(T.EOS)
        elif name == "allow_poll_mode":
            conf.allow_poll_mode = bool_setting()
        elif name == "float_bits":
            bits = int_setting()
            if bits not in (32, 64):
                self.error("invalid float_bits, must be 32 or 64", field_tok)
            conf.realsize = bits // 8
        elif name == "convolver_config":
            conf.convolver_config = os.path.expanduser(str_setting())
        elif name == "benchmark":
            if self.parse_default:
                self.error("cannot set benchmark setting in this file", field_tok)
            conf.benchmark = bool_setting()
            if self.defaults.get("has_defaults") and conf.benchmark:
                self.error('the benchmark option requires the "-nodefault" switch',
                           field_tok)
        elif name == "sdf_length":
            conf.sdf_length = self.make_int(self.expect(T.REAL))
            if conf.sdf_length <= 0:
                conf.sdf_length = -1
            t = self.next()
            if t.kind == T.COMMA:
                conf.sdf_beta = self.expect(T.REAL).value
                self.expect(T.EOS)
            elif t.kind != T.EOS:
                self.error("expected EOS or COMMA", t)
            else:
                conf.sdf_beta = 9.0
        elif name == "safety_limit":
            v = self.expect(T.REAL).value
            conf.safety_limit = 10.0 ** (v / 20.0)
            if not math.isfinite(conf.safety_limit):
                self.error("invalid safety_limit", field_tok)
            self.expect(T.EOS)
        else:
            self.error(f"unrecognised setting name: {name}", field_tok)

    # --- name helper ------------------------------------------------------
    def get_string_or_int(self):
        t = self.next()
        if t.kind == T.REAL:
            return self.make_int(t), None
        if t.kind == T.STRING:
            return None, t.value
        self.error("expected STRING or REAL", t)

    # --- coeff (bfconf.c:724-881) -----------------------------------------
    def handle_coeff(self):
        conf = self.conf
        intname = len(conf.coeffs)
        proto = self.defaults.get("coeff")
        c = CoeffDef(**vars(proto)) if proto else CoeffDef(n_blocks=-1)
        if not self.parse_default:
            num, sname = self.get_string_or_int()
            if num is not None:
                if num != intname:
                    self.error("incorrect integer name")
                c.name = str(intname)
            else:
                c.name = sname
            c.intname = intname

        self.expect(T.LBRACE)
        bitset = set()
        while True:
            t = self.next()
            if t.kind == T.RBRACE:
                break
            if t.kind != T.FIELD:
                self.error("expected FIELD", t)
            f = t.value
            self.repeat_test(bitset, f, t)
            if f == "format":
                s = self.expect(T.STRING).value
                if s.upper() == "TEXT":
                    c.format, c.rawformat = "TEXT", None
                elif s.upper() == "PROCESSED":
                    c.format, c.rawformat = "PROCESSED", None
                else:
                    c.format = "RAW"
                    try:
                        c.rawformat = parse_sample_format(s, allow_auto=False)
                    except UnknownSampleFormat:
                        self.error("unknown sample format", t)
                self.expect(T.EOS)
            elif f == "attenuation":
                c.scale = from_db(-self.expect(T.REAL).value)
                self.expect(T.EOS)
            elif f == "filename":
                if self.parse_default:
                    self.error("cannot give coeff filename in default configuration", t)
                nt = self.next()
                if nt.kind == T.STRING:
                    c.filename = nt.value
                    self.expect(T.EOS)
                elif nt.kind == T.REAL:
                    c.filename = ""
                    c.shm_parts = []
                    while True:
                        shmid = self.make_int(nt)
                        self.expect(T.SLASH)
                        off = self.make_int(self.expect(T.REAL))
                        self.expect(T.SLASH)
                        blocks = self.make_int(self.expect(T.REAL))
                        c.shm_parts.append((shmid, off, blocks))
                        nt = self.next()
                        if nt.kind == T.EOS:
                            break
                        if nt.kind != T.COMMA:
                            self.error("expected EOS or COMMA", nt)
                        nt = self.expect(T.REAL)
                else:
                    self.error("expected STRING or REAL", nt)
            elif f == "blocks":
                c.n_blocks = self.make_int(self.expect(T.REAL))
                self.expect(T.EOS)
            elif f == "shared_mem":
                c.is_shared = self.expect(T.BOOLEAN).value
                self.expect(T.EOS)
            elif f == "skip":
                c.skip = self.make_int(self.expect(T.REAL))
                self.expect(T.EOS)
            else:
                self.error(f"unrecognised coeff field: {f}", t)
        self.expect(T.EOS)

        if self.parse_default:
            self.defaults["coeff"] = c
            return
        if not self.defaults.get("has_defaults"):
            if c.filename == "dirac pulse" and "format" not in bitset:
                c.format = "PROCESSED"
            # note: the reference's field_mandatory_test 0x05 would
            # demand an explicit format here under -nodefault, but its
            # own shipped configs (xtc_config etc.) omit it and rely on
            # the stock defaults file's TEXT default -- CoeffDef keeps
            # that default, and a raw file misread as TEXT now fails
            # with a clean "invalid floating point number" error
            if c.filename == "" and not c.shm_parts:
                self.error("coeff filename missing")
        elif c.filename == "" and not c.shm_parts:
            self.error("coeff filename missing")
        if c.format == "PROCESSED" and c.scale != 1.0:
            self.error("cannot have non-zero attenuation on processed format")
        if c.shm_parts and c.format != "PROCESSED":
            self.error("shared memory coefficients must be in processed format")
        if c.shm_parts:
            c.is_shared = True
        if c.skip > 0 and (c.filename == "dirac pulse" or c.shm_parts):
            # skip only works on files (bfconf.c:1897-1901)
            self.error(f'cannot use skip field for coeff "{c.name}" '
                       "(skip only works on files)")
        conf.coeffs.append(c)

    # --- filter (bfconf.c:986-1102) ----------------------------------------
    def parse_filter_edges(self, flt: FilterDef, io: int, isfilter: bool):
        if self.parse_default:
            self.error("cannot give filter connections in default configuration")
        entries = []
        while True:
            num, sname = self.get_string_or_int()
            scale = 1.0
            t = self.next()
            if t.kind == T.SLASH:
                if io == OUT and isfilter:
                    self.error("cannot scale filter outputs which are connected "
                               "to other filter inputs", t)
                t2 = self.next()
                if t2.kind == T.SLASH:         # ch//mult
                    scale *= self.expect(T.REAL).value
                    t = self.next()
                elif t2.kind == T.REAL:        # ch/att[/mult]
                    scale *= from_db(-t2.value)
                    t = self.next()
                    if t.kind == T.SLASH:
                        scale *= self.expect(T.REAL).value
                        t = self.next()
                else:
                    self.error("expected REAL", t2)
            entries.append((num, sname, scale))
            if t.kind == T.EOS:
                break
            if t.kind != T.COMMA:
                self.error("expected EOS or COMMA", t)

        if isfilter:
            if io == IN:
                flt.in_filter_names = entries
            else:
                flt.out_filter_names = entries
        else:
            if io == IN:
                flt.in_channel_names = entries
            else:
                flt.out_channel_names = entries

    def handle_filter(self):
        conf = self.conf
        intname = len(conf.filters)
        if intname == BF_MAXFILTERS:
            self.error("too many filters")
        proto = self.defaults.get("filter")
        if proto:
            flt = FilterDef(process=proto.process, delayblocks=proto.delayblocks,
                            crossfade=proto.crossfade)
        else:
            flt = FilterDef()
        if not self.parse_default:
            num, sname = self.get_string_or_int()
            if num is not None:
                if num != intname:
                    self.error("incorrect integer name")
                flt.name = str(intname)
            else:
                flt.name = sname
            flt.intname = intname

        self.expect(T.LBRACE)
        bitset = set()
        while True:
            t = self.next()
            if t.kind == T.RBRACE:
                break
            if t.kind != T.FIELD:
                self.error("expected FIELD", t)
            f = t.value
            # alias pairs share one repeat bit like the reference
            # (bfconf.c:1046-1055): "inputs"+"from_inputs" (or
            # "outputs"+"to_outputs") in one block is a repeat error,
            # not a silent overwrite
            _alias = {"inputs": "from_inputs", "outputs": "to_outputs"}
            self.repeat_test(bitset, _alias.get(f, f), t)
            if f == "process":
                flt.process = self.make_int(self.expect(T.REAL))
                if flt.process >= BF_MAXPROCESSES:
                    self.error(f"process is less than 0 or larger than "
                               f"{BF_MAXPROCESSES - 1}", t)
                if flt.process < 0:
                    flt.process = -1
                self.expect(T.EOS)
            elif f == "coeff":
                if self.parse_default:
                    self.error("cannot give filter coeff in default configuration", t)
                num, sname = self.get_string_or_int()
                if num is not None:
                    flt.coeff = num
                else:
                    flt.coeff_name = sname
                self.expect(T.EOS)
            elif f in ("from_inputs", "inputs"):
                self.parse_filter_edges(flt, IN, False)
            elif f in ("to_outputs", "outputs"):
                self.parse_filter_edges(flt, OUT, False)
            elif f == "from_filters":
                self.parse_filter_edges(flt, IN, True)
            elif f == "to_filters":
                self.parse_filter_edges(flt, OUT, True)
            elif f == "delay":
                flt.delayblocks = self.make_int(self.expect(T.REAL))
                if flt.delayblocks < 0:
                    flt.delayblocks = 0
                self.expect(T.EOS)
            elif f == "crossfade":
                flt.crossfade = self.expect(T.BOOLEAN).value
                self.expect(T.EOS)
            else:
                self.error(f"unrecognised filter field: {f}", t)
        self.expect(T.EOS)

        if self.parse_default:
            self.defaults["filter"] = flt
            return
        if not flt.out_channel_names and not flt.out_filter_names:
            self.error("no outputs for filter")
        if not flt.in_channel_names and not flt.in_filter_names:
            self.error("no inputs for filter")
        if flt.coeff < 0 and not flt.coeff_name and "coeff" not in bitset:
            self.error("filter coeff missing")
        conf.filters.append(flt)

    # --- input/output (bfconf.c:1104-1412) ----------------------------------
    def handle_iodev(self, io: int):
        conf = self.conf
        virtual_base = conf.n_channels[io]
        phys_base = conf.n_physical_channels[io]

        proto = self.defaults.get("iodev")
        proto = proto[io] if proto else None
        dev = IODevDef(io=io, phys_base=phys_base)
        if proto is not None:
            dev.device_name = proto.device_name
            dev.device_params = proto.device_params
            dev.sample_format = proto.sample_format
            dev.open_channels = proto.open_channels
            dev.used_channels = proto.used_channels
            dev.channel_selection = list(proto.channel_selection)
            dev.apply_dither = proto.apply_dither
        else:
            dev.open_channels = 0
            dev.used_channels = 0
            dev.channel_selection = []

        if not self.parse_default:
            num, sname = self.get_string_or_int()
            if num is not None:
                ints = self.get_int_list(Token(T.REAL, float(num), 0), T.LBRACE)
                for i, v in enumerate(ints):
                    if v != virtual_base + i:
                        self.error("incorrect integer name")
                dev.channel_intnames = ints
                dev.channel_names = [str(v) for v in ints]
            else:
                names = self.get_string_list(Token(T.STRING, sname, 0), T.LBRACE)
                dev.channel_names = names
                dev.channel_intnames = [virtual_base + i for i in range(len(names))]
            dev.virtual_channels = len(dev.channel_intnames)
            dev.virt2phys_local = list(range(dev.virtual_channels))
        else:
            self.expect(T.LBRACE)

        # ensure per-channel arrays exist up to the new channel range
        for arrs, init in ((conf.delay, 0), (conf.maxdelay, -1),
                           (conf.subdelay, 0), (conf.mute, False)):
            arr = arrs[io]
            while len(arr) < virtual_base + max(dev.virtual_channels, BF_MAXCHANNELS - virtual_base):
                arr.append(init)

        maxdelay_setting = -2
        indmaxd_count = 0
        bitset = set()
        while True:
            t = self.next()
            if t.kind == T.RBRACE:
                break
            if t.kind != T.FIELD:
                self.error("expected FIELD", t)
            f = t.value
            self.repeat_test(bitset, f, t)
            if f == "device":
                dev.device_name = self.expect(T.STRING).value
                if "/" in dev.device_name:
                    self.error("path separator not allowed in device name", t)
                dev.device_params = self.get_params()
                self.expect(T.EOS)
            elif f == "sample":
                s = self.expect(T.STRING).value
                try:
                    dev.sample_format = parse_sample_format(s, allow_auto=True)
                except UnknownSampleFormat:
                    self.error("unknown sample format", t)
                self.expect(T.EOS)
            elif f == "channels":
                first = self.expect(T.REAL)
                dev.open_channels = self.make_int(first)
                if not (1 <= dev.open_channels <= BF_MAXCHANNELS):
                    self.error("too few or too many channels", t)
                nt = self.next()
                if nt.kind == T.SLASH:
                    sel = self.get_int_list(self.expect(T.REAL), T.EOS)
                    if len(sel) > dev.open_channels:
                        self.error("channel amount mismatch", t)
                    if any(not (0 <= s < dev.open_channels) for s in sel):
                        self.error("channel out of range", t)
                    if len(set(sel)) != len(sel):
                        self.error("duplicate channel selection", t)
                    dev.channel_selection = sel
                    dev.used_channels = len(sel)
                elif nt.kind == T.EOS:
                    dev.used_channels = dev.open_channels
                    dev.channel_selection = list(range(dev.open_channels))
                else:
                    self.error("expected EOS or SLASH", nt)
                if not self.parse_default and dev.used_channels > dev.virtual_channels:
                    self.error("channel amount exceeds allocated", t)
            elif f == "delay":
                vals = self.get_int_list(self.expect(T.REAL), T.EOS)
                if len(vals) > len(conf.delay[io]) - virtual_base:
                    self.error("too many values in list", t)
                for i, v in enumerate(vals):
                    if v < 0:
                        self.error("negative delay", t)
                    conf.delay[io][virtual_base + i] = v
            elif f == "dither":
                if io == IN:
                    self.error("unrecognised input field: dither", t)
                dev.apply_dither = self.expect(T.BOOLEAN).value
                self.expect(T.EOS)
            elif f == "mute":
                vals = self.get_bool_list(T.EOS)
                if len(vals) > len(conf.mute[io]) - virtual_base:
                    self.error("too many values in list", t)
                for i, v in enumerate(vals):
                    conf.mute[io][virtual_base + i] = v
            elif f == "maxdelay":
                maxdelay_setting = self.make_int(self.expect(T.REAL))
                if maxdelay_setting < 0:
                    maxdelay_setting = -1
                self.expect(T.EOS)
            elif f == "individual_maxdelay":
                vals = self.get_int_list(self.expect(T.REAL), T.EOS)
                if len(vals) > len(conf.maxdelay[io]) - virtual_base:
                    self.error("too many values in list", t)
                indmaxd_count = len(vals)
                for i, v in enumerate(vals):
                    conf.maxdelay[io][virtual_base + i] = v if v >= 0 else -1
            elif f == "mapping":
                if self.parse_default:
                    self.error("unrecognised default io device field: mapping", t)
                vals = self.get_int_list(self.expect(T.REAL), T.EOS)
                if len(vals) != dev.virtual_channels:
                    self.error("channel amount mismatch", t)
                dev.virt2phys_local = vals
                bitset.add("__mapping__")
            elif f == "merge":
                if io == IN:
                    self.error("unrecognised input field: merge", t)
                self.expect(T.BOOLEAN)
                self.expect(T.EOS)
            elif f == "subdelay":
                vals = self.get_int_list(self.expect(T.REAL), T.EOS)
                if len(vals) > len(conf.subdelay[io]) - virtual_base:
                    self.error("too many values in list", t)
                for i, v in enumerate(vals):
                    if v <= -BF_SAMPLE_SLOTS:
                        conf.subdelay[io][virtual_base + i] = BF_UNDEFINED_SUBDELAY
                    else:
                        if v >= BF_SAMPLE_SLOTS:
                            self.error("too large subdelay", t)
                        conf.subdelay[io][virtual_base + i] = v
                        conf.use_subdelay[io] = True
            else:
                self.error(f"unrecognised {'input' if io == IN else 'output'} "
                           f"field: {f}", t)
        self.expect(T.EOS)

        if self.parse_default or not self.defaults.get("has_defaults"):
            # mandatory fields (field_mandatory_test 0x07,
            # bfconf.c:1370-1376) -- the reference runs this for the
            # defaults-file iodev too, BEFORE its !parse_default block;
            # returning first silently accepted an incomplete default
            for req in ("device", "sample", "channels"):
                if req not in bitset:
                    self.error(f'mandatory field "{req}" omitted in '
                               f'{"input" if io == IN else "output"}')

        if self.parse_default:
            iod = self.defaults.setdefault("iodev", [None, None])
            iod[io] = dev
            return
        if maxdelay_setting != -2:
            for i in range(indmaxd_count, dev.virtual_channels):
                conf.maxdelay[io][virtual_base + i] = maxdelay_setting
        for v in dev.virt2phys_local:
            if not (0 <= v < dev.used_channels):
                self.error("invalid channel mapping")
        if "__mapping__" in bitset and dev.virtual_channels <= dev.used_channels:
            self.error("virtual mapping only allowed when virtual channel "
                       "amount exceeds physical")
        for i in range(dev.virtual_channels):
            md = conf.maxdelay[io][virtual_base + i]
            if md >= 0 and conf.delay[io][virtual_base + i] > md:
                self.error("delay exceeds specified maximum delay")

        conf.iodevs[io].append(dev)
        conf.n_channels[io] += dev.virtual_channels
        conf.n_physical_channels[io] += dev.used_channels


def _link(conf: BFConfig):
    """Post-parse resolution and validation (bfconf.c:2443-2818)."""
    for io in (IN, OUT):
        if not conf.iodevs[io]:
            raise ConfigParseError(
                f"no {'inputs' if io == IN else 'outputs'} defined")
    if not conf.filters:
        raise ConfigParseError("no filters defined")
    if conf.benchmark and conf.powersave:
        raise ConfigParseError(
            "the benchmark and powersave setting cannot both be set to true")
    if conf.filter_length <= 0:
        raise ConfigParseError("filter_length not set")
    if conf.sampling_rate <= 0:
        raise ConfigParseError("sampling_rate not set")
    # Subdelay subsystem gate: any in-range `subdelay:` value (including
    # the stock defaults file's 0,0) marks use_subdelay, but without
    # sdf_length the subsystem is silently disabled, not an error
    # (bfconf.c:2796-2798); with sdf_length set, the full sinc must fit
    # in one filter block (bfconf.c:2799-2804).
    if conf.sdf_length < 0:
        conf.use_subdelay[IN] = False
        conf.use_subdelay[OUT] = False
    elif 2 * conf.sdf_length + 1 > conf.filter_length:
        raise ConfigParseError(
            "The filter_length must be larger than 2 x sdf_length + 1")

    # channel maps
    for io in (IN, OUT):
        names = [None] * conf.n_channels[io]
        v2p = [0] * conf.n_channels[io]
        nvp = [0] * conf.n_physical_channels[io]
        for dev in conf.iodevs[io]:
            for i, virtch in enumerate(dev.channel_intnames):
                physch = dev.phys_base + dev.virt2phys_local[i]
                names[virtch] = dev.channel_names[i]
                v2p[virtch] = physch
                nvp[physch] += 1
        p2v = [[] for _ in range(conf.n_physical_channels[io])]
        for dev in conf.iodevs[io]:
            for i, virtch in enumerate(dev.channel_intnames):
                physch = dev.phys_base + dev.virt2phys_local[i]
                p2v[physch].append(virtch)
        conf.channel_names[io].clear()
        conf.channel_names[io].extend(names)
        conf.virt2phys[io].clear()
        conf.virt2phys[io].extend(v2p)
        conf.n_virtperphys[io].clear()
        conf.n_virtperphys[io].extend(nvp)
        conf.phys2virt[io].clear()
        conf.phys2virt[io].extend(p2v)
        # trim per-channel arrays to the real channel count
        for arr in (conf.delay, conf.maxdelay, conf.subdelay, conf.mute):
            del arr[io][conf.n_channels[io]:]

    # duplicate names
    for kind, names in (("coefficient set", [c.name for c in conf.coeffs]),
                        ("filter", [f.name for f in conf.filters]),
                        ("channel", conf.channel_names[IN]),
                        ("channel", conf.channel_names[OUT])):
        if len(set(names)) != len(names):
            raise ConfigParseError(f"duplicate {kind} names")

    coeff_by_name = {c.name: c.intname for c in conf.coeffs}
    filter_by_name = {f.name: f.intname for f in conf.filters}
    chan_by_name = [
        {n: i for i, n in enumerate(conf.channel_names[IN])},
        {n: i for i, n in enumerate(conf.channel_names[OUT])},
    ]

    load_balance = None
    for f in conf.filters:
        # coefficient
        if f.coeff_name:
            if f.coeff_name not in coeff_by_name:
                raise ConfigParseError(
                    f'coeff with name "{f.coeff_name}" (in filter '
                    f'{f.intname}/"{f.name}") does not exist')
            f.coeff = coeff_by_name[f.coeff_name]
        elif f.coeff >= len(conf.coeffs):
            raise ConfigParseError(
                f'coeff index {f.coeff} in filter {f.intname}/"{f.name}" '
                f"is out of range")

        lb = f.process == -1
        if load_balance is None:
            load_balance = lb
        elif load_balance != lb:
            raise ConfigParseError(
                "cannot mix manual process settings with automatic")

        # channel edges
        for io, entries, attr in ((IN, f.in_channel_names, "in_channels"),
                                  (OUT, f.out_channel_names, "out_channels")):
            resolved = []
            seen = set()
            for num, sname, scale in entries:
                if sname is not None:
                    if sname not in chan_by_name[io]:
                        raise ConfigParseError(
                            f'{"input" if io == IN else "output"} channel with '
                            f'name "{sname}" (in filter {f.intname}/"{f.name}") '
                            f"does not exist")
                    ch = chan_by_name[io][sname]
                else:
                    if not (0 <= num < conf.n_channels[io]):
                        raise ConfigParseError(
                            f'{"input" if io == IN else "output"} channel index '
                            f'{num} in filter {f.intname}/"{f.name}" is out of range')
                    ch = num
                if ch in seen:
                    raise ConfigParseError(
                        f'duplicate channels in filter {f.intname}/"{f.name}"')
                seen.add(ch)
                resolved.append((ch, scale))
            setattr(f, attr, resolved)

        # filter edges
        for io, entries in ((IN, f.in_filter_names), (OUT, f.out_filter_names)):
            resolved = []
            seen = set()
            for num, sname, scale in entries:
                if sname is not None:
                    if sname not in filter_by_name:
                        raise ConfigParseError(
                            f'filter with name "{sname}" (in filter '
                            f'{f.intname}/"{f.name}") does not exist')
                    fi = filter_by_name[sname]
                else:
                    if not (0 <= num < len(conf.filters)):
                        raise ConfigParseError(
                            f'filter index {num} in filter {f.intname}/'
                            f'"{f.name}" is out of range')
                    fi = num
                if fi in seen:
                    raise ConfigParseError(
                        f'duplicate filters in filter {f.intname}/"{f.name}"')
                seen.add(fi)
                resolved.append((fi, scale))
            if io == IN:
                f.in_filters = resolved
            else:
                f.out_filters = [fi for fi, _ in resolved]

        if f.delayblocks > conf.n_blocks - 1:
            raise ConfigParseError(
                f'delay in filter {f.intname}/"{f.name}" is too large '
                f"(max allowed is {conf.n_blocks - 1} blocks)")

    # bidirectional filter-edge consistency (bfconf.c:2733-2768)
    for f in conf.filters:
        for k in f.out_filters:
            if all(src != f.intname for src, _ in conf.filters[k].in_filters):
                raise ConfigParseError(
                    f'output to filter {k}/"{conf.filters[k].name}" from filter '
                    f'{f.intname}/"{f.name}" must exist as input at the '
                    f"destination filter")
        for src, _ in f.in_filters:
            if f.intname not in conf.filters[src].out_filters:
                raise ConfigParseError(
                    f'input from filter {src}/"{conf.filters[src].name}" in '
                    f'filter {f.intname}/"{f.name}" must exist as output in '
                    f"the source filter")

    # loop detection (bfconf.c:2032-2048). The reference recurses with
    # no visited set; that is exponential on diamond DAGs and overflows
    # the stack on cycles not containing the probed filter -- same
    # accept/reject semantics here (can `start` reach itself?), but
    # iterative with a visited set so big legal DAGs stay fast and any
    # cycle yields the clean config error.
    def has_loop(start):
        seen = set()
        stack = list(conf.filters[start].out_filters)
        while stack:
            nxt = stack.pop()
            if nxt == start:
                return True
            if nxt not in seen:
                seen.add(nxt)
                stack.extend(conf.filters[nxt].out_filters)
        return False

    for f in conf.filters:
        if has_loop(f.intname):
            raise ConfigParseError(f"filter {f.intname} is involved in a loop")

    # manual process placement constraints (bfconf.c:2893-2931): filters
    # connected via filter edges must share a process, and one output
    # channel may only mix filters from a single process. (The engine
    # maps process groups onto the 'f' mesh axis; these configs would
    # actually work there thanks to the out-mix psum, but the reference
    # rejects them, so parity does too.)
    if conf.filters and all(f.process >= 0 for f in conf.filters):
        for f in conf.filters:
            for src, _ in f.in_filters:
                if conf.filters[src].process != f.process:
                    raise ConfigParseError(
                        "Connected filters must be processed within the "
                        "same process.")
        out_owner = {}
        for f in conf.filters:
            for ch, _ in f.out_channels:
                if out_owner.setdefault(ch, f.process) != f.process:
                    raise ConfigParseError(
                        "Mixed outputs must be processed within the same "
                        "process.")

    # coeff block counts (bfconf.c:2826-2833)
    for c in conf.coeffs:
        if c.n_blocks <= 0:
            c.n_blocks = conf.n_blocks
        elif c.n_blocks > conf.n_blocks:
            raise ConfigParseError(f"too many blocks in coeff {c.intname}")


DEFAULT_CONFIG_TEXT_HAS = ("float_bits", "sampling_rate", "filter_length",
                           "config_file")


def parse_config(
    text: str,
    filename: str = "<config>",
    defaults_text: Optional[str] = None,
) -> BFConfig:
    """Parse a config (optionally layered on a defaults file) and link it."""
    conf = BFConfig()
    defaults = {"has_defaults": defaults_text is not None}
    if defaults_text is not None:
        dp = _Parser(defaults_text, "<defaults>", conf, True, defaults)
        dp.parse()
        # mandatory defaults settings (get_defaults bits 0x05DB,
        # bfconf.c:1650; config_file only when the convolver needs one,
        # which the XLA-cache analog does not)
        for req in DEFAULT_CONFIG_TEXT_HAS:
            if req == "config_file":
                continue
            if req not in dp.seen_settings:
                raise ConfigParseError(
                    f'mandatory setting "{req}" missing in defaults')
        for io in (IN, OUT):
            if not defaults.get("iodev") or defaults["iodev"][io] is None:
                raise ConfigParseError(
                    f"no {'input' if io == IN else 'output'} defined in defaults")
        if "coeff" not in defaults:
            raise ConfigParseError("no coeff defined in defaults")
        defaults.setdefault("filter", FilterDef())
    p = _Parser(text, filename, conf, False, defaults)
    p.parse()
    _link(conf)
    return conf


def parse_config_file(path: str, defaults_path: Optional[str] = None) -> BFConfig:
    with open(path, "rt") as fh:
        text = fh.read()
    defaults_text = None
    if defaults_path is not None:
        with open(defaults_path, "rt") as fh:
            defaults_text = fh.read()
    return parse_config(text, path, defaults_text)
