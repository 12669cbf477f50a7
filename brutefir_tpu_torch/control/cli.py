"""CLI logic module: runtime control over sockets or block-paced scripts.

Reimplements `bflogic_cli.c`: the full command set (HELP_TEXT, lines 37-91;
dispatch 412-771), id resolution by index or quoted name with per-filter
edge-position lookup (get_id, 284-412), atomic commit of staged changes at
command-line boundaries, and *script mode* -- one script line executed per
block from the block_start hook, wrapping at the end, with ``sleep bN``
block pacing (block_start, 872-986; bench5 uses this for deterministic
crossfade benchmarking).

Parameters: ``port:`` int (TCP), a unix socket path, or a serial/character
device path (e.g. "/dev/ttyS0" -- raw 8N1 at ``line_speed:``, one
persistent session, like bflogic_cli.c's serial mode); ``script:`` string,
``echo:`` bool.
"""

from __future__ import annotations

import io
import math
import os
import socket
import threading
import time

from ..config.lexer import T
from ..config.model import IN, OUT, BF_SAMPLE_SLOTS
from . import register_logic_module


def _is_tty(path: str) -> bool:
    """A character device (serial port or pty) rather than a socket path."""
    import stat
    try:
        return stat.S_ISCHR(os.stat(path).st_mode)
    except OSError:
        return False

HELP_TEXT = """
Commands:

lf -- list filters.
lc -- list coeffient sets.
li -- list inputs.
lo -- list outputs.
lm -- list modules.

cfoa -- change filter output attenuation.
        cfoa <filter> <output> <attenuation|Mmultiplier>
cfia -- change filter input attenuation.
        cfia <filter> <input> <attenuation|Mmultiplier>
cffa -- change filter filter-input attenuation.
        cffa <filter> <filter-input> <attenuation|Mmultiplier>
cfc  -- change filter coefficients.
        cfc <filter> <coeff>
cfd  -- change filter delay. (may truncate coeffs!)
        cfd <filter> <delay blocks>
cod  -- change output delay.
        cod <output> <delay> [<subdelay>]
cid  -- change input delay.
        cid <input> <delay> [<subdelay>]
tmo  -- toggle mute output.
        tmo <output>
tmi  -- toggle mute input.
        tmi <input>
imc  -- issue input module command.
        imc <index> <command>
omc  -- issue output module command.
        omc <index> <command>
lmc  -- issue logic module command.
        lmc <module> <command>

sleep -- sleep for the given number of seconds [and ms], or blocks.
         sleep 10 (sleep 10 seconds).
         sleep b10 (sleep 10 blocks).
         sleep 0 300 (sleep 300 milliseconds).
abort -- terminate immediately.
tp    -- toggle prompt.
ppk   -- print peak info, channels/samples/max dB.
rpk   -- reset peak meters.
upk   -- toggle print peak info on changes.
rti   -- print current realtime index.
quit  -- close connection.
help  -- print this text.

Notes:

- When entering several commands on a single line,
  separate them with semicolons (;).
- Inputs/outputs/filters can be given as index
  numbers or as strings between quotes ("").

"""

FILTER_ID, COEFF_ID, INPUT_ID, OUTPUT_ID = 1, 2, 3, 4


def _parse_module_params(params):
    out = {}
    i = 0

    def need(kind):
        nonlocal i
        if i >= len(params) or params[i].kind != kind:
            raise RuntimeError("CLI: parse error in module parameters")
        t = params[i]
        i += 1
        return t

    while i < len(params):
        f = need(T.FIELD).value
        if f == "port":
            if i >= len(params):
                raise RuntimeError("CLI: parse error in module parameters")
            t = params[i]
            i += 1
            if t.kind == T.REAL:
                out["port"] = int(t.value)
            elif t.kind == T.STRING:
                out["port"] = t.value
            else:
                raise RuntimeError("CLI: invalid port")
        elif f == "line_speed":
            out["line_speed"] = int(need(T.REAL).value)
        elif f == "script":
            out["script"] = need(T.STRING).value
        elif f == "echo":
            out["echo"] = need(T.BOOLEAN).value
        else:
            raise RuntimeError(f"CLI: unknown field {f}")
        need(T.EOS)
    return out


class _SleepTask:
    __slots__ = ("do_sleep", "block_sleep", "blocks", "seconds", "useconds")

    def __init__(self):
        self.do_sleep = False
        self.block_sleep = False
        self.blocks = 0
        self.seconds = 0
        self.useconds = 0


class CliModule:
    def __init__(self, params, engine):
        self.engine = engine
        self.control = engine.control
        self.conf = engine.conf
        opts = _parse_module_params(params)
        self.script = opts.get("script")
        self.echo = opts.get("echo", True)
        self.port = opts.get("port")
        self.line_speed = opts.get("line_speed")
        self.print_prompt = False
        self._last_overflows = None
        # `upk` peak updates are tracked PER SESSION: each socket/serial
        # session registers its stream + write lock in _session_locks while
        # alive; `upk` toggles that stream's membership in _peak_sessions
        # (the reference has one session at a time -- bflogic_cli.c:803-805
        # -- so per-session is the faithful generalization for concurrent
        # clients). Script mode / lmc commands target stderr. The per-stream
        # lock serializes engine peak pushes against the session thread's
        # own prompt/response writes on the same TextIOWrapper.
        self._peak_lock = threading.Lock()
        self._session_locks = {}            # stream -> write lock
        self._peak_sessions = {}            # stream -> write lock (upk on)
        self._stderr_lock = threading.Lock()
        # script-mode cursor state
        self._lines = None
        self._line_idx = 0
        self._sleep_until_block = -1
        self._sleep_until_time = None
        self._quit = False
        self._server = None
        if self.script is not None:
            lines = [ln.strip() for ln in self.script.split("\n")]
            self._lines = [ln for ln in lines
                           if ln.strip("; \t\r") != ""]
            if not self._lines:
                raise RuntimeError("CLI: the script is empty")
        if self.port is not None:
            self._start_server()

    # ------- id resolution (get_id, bflogic_cli.c:284-412) ---------------
    def _get_id(self, out, tok: str, typ: int, rid: int = -1):
        tok = tok.strip()
        conf = self.conf
        if tok.startswith('"'):
            name = tok[1:].rstrip('"')
            if typ == FILTER_ID:
                ids = [f.intname for f in conf.filters if f.name == name]
                if not ids:
                    out.write(f'There is no filter with name "{name}".\n')
                    return None
                idx = ids[0]
            elif typ == COEFF_ID:
                ids = [c.intname for c in conf.coeffs if c.name == name]
                if not ids:
                    out.write(
                        f'There is no coefficient set with name "{name}".\n')
                    return None
                idx = ids[0]
            else:
                io_ = IN if typ == INPUT_ID else OUT
                names = conf.channel_names[io_]
                if name not in names:
                    out.write(f'There is no '
                              f'{"input" if io_ == IN else "output"} with '
                              f'name "{name}".\n')
                    return None
                idx = names.index(name)
        else:
            try:
                idx = int(tok)
            except ValueError:
                out.write("Invalid number.\n")
                return None
            if idx < 0 and typ != COEFF_ID:
                out.write(f"Negative number ({idx}) is not allowed.\n")
                return None
            if typ == FILTER_ID and idx >= len(conf.filters):
                out.write(f"Filter id {idx} is out of range.\n")
                return None
            if typ == COEFF_ID and idx >= len(conf.coeffs):
                out.write(f"Coefficient set id {idx} is out of range.\n")
                return None
            if typ in (INPUT_ID, OUTPUT_ID):
                io_ = IN if typ == INPUT_ID else OUT
                if idx >= conf.n_channels[io_]:
                    out.write(f'{"Input" if io_ == IN else "Output"} id '
                              f"{idx} is out of range.\n")
                    return None
        if rid != -1 and typ != COEFF_ID:
            flt = conf.filters[rid]
            if typ == FILTER_ID:
                edges = [src for src, _ in flt.in_filters]
            elif typ == INPUT_ID:
                edges = [ch for ch, _ in flt.in_channels]
            else:
                edges = [ch for ch, _ in flt.out_channels]
            if idx not in edges:
                out.write(f"id {idx} does not exist in the given filter.\n")
                return None
            return edges.index(idx)
        return idx

    @staticmethod
    def _split2(rest):
        """First token + remainder. A leading double quote scans to the
        closing quote so names containing spaces stay addressable, like
        the reference's get_id (bflogic_cli.c:295-299)."""
        rest = rest.lstrip()
        if rest.startswith('"'):
            end = rest.find('"', 1)
            if end != -1:
                return rest[: end + 1], rest[end + 1:].lstrip()
        parts = rest.split(None, 1)
        if len(parts) == 0:
            return "", ""
        if len(parts) == 1:
            return parts[0], ""
        return parts[0], parts[1]

    def _set_scale(self, out, scales, idx, arg, kind):
        # a missing value falls through to the float('') ValueError --
        # the reference's strtod failure message, not a silent no-op
        # (bflogic_cli.c:541-603; cffa uses the "input" wording)
        arg = arg.strip()
        if arg[:1] in ("M", "m"):
            try:
                scales[idx] = float(arg[1:])
            except ValueError:
                out.write(f"Invalid {kind} multiplier.\n")
                return
        else:
            try:
                att = float(arg)
            except ValueError:
                out.write(f"Invalid {kind} attenuation.\n")
                return
            mag = math.pow(10.0, -att / 20.0)
            scales[idx] = -mag if scales[idx] < 0 else mag
        self.control.mark_dirty()

    # ------- listings ------------------------------------------------------
    def _att_str(self, scale):
        a = -20.0 * math.log10(abs(scale)) if scale != 0 else float("inf")
        if a == 0.0:
            a = 0.0000001
        s = f"{a:.1f}"
        return s + ("/-1 " if scale < 0 else " ")

    def _cmd_lf(self, out):
        conf, ctrl = self.conf, self.control
        out.write("Filters:\n")
        for n, f in enumerate(conf.filters):
            fc = ctrl.fctrl[n]
            out.write(f'  {n}: "{f.name}"\n')
            if fc.coeff < 0:
                out.write(f"      coeff set: {fc.coeff} (no filter)\n")
            else:
                out.write(f"      coeff set: {fc.coeff}\n")
            out.write(f"      delay blocks: {fc.delayblocks} "
                      f"({fc.delayblocks * conf.filter_length} samples)\n")
            out.write("      from inputs:  " + "".join(
                f"{ch}/{self._att_str(fc.in_scales[i])}"
                for i, (ch, _) in enumerate(f.in_channels)) + "\n")
            out.write("      to outputs:   " + "".join(
                f"{ch}/{self._att_str(fc.out_scales[i])}"
                for i, (ch, _) in enumerate(f.out_channels)) + "\n")
            out.write("      from filters: " + "".join(
                f"{src}/{self._att_str(fc.fscales[i])}"
                for i, (src, _) in enumerate(f.in_filters)) + "\n")
            out.write("      to filters:   " + "".join(
                f"{dst} " for dst in f.out_filters) + "\n")
        out.write("\n")

    def _cmd_lc(self, out):
        out.write("Coefficient sets:\n")
        for n, c in enumerate(self.conf.coeffs):
            out.write(f'  {n}: "{c.name}" ({c.n_blocks} blocks)\n')
        out.write("\n")

    def _cmd_lio(self, out, io_):
        out.write("Input channels:\n" if io_ == IN else "Output channels:\n")
        for n in range(self.conf.n_channels[io_]):
            muted = "(muted)" if self.control.mute[io_][n] else ""
            out.write(f'  {n}: "{self.conf.channel_names[io_][n]}" '
                      f"(delay: {self.control.delay[io_][n]}:"
                      f"{self.control.subdelay[io_][n]}) {muted}\n")
        out.write("\n")

    def _cmd_lm(self, out):
        if self.engine.logic:
            out.write("Logic modules:\n")
            for n, (name, _) in enumerate(self.conf.logic_modules):
                out.write(f'  {n}: "{name}"\n')
            out.write("\n")
        for io_ in (IN, OUT):
            out.write("Input modules:\n" if io_ == IN else "Output modules:\n")
            for n, dev in enumerate(self.conf.iodevs[io_]):
                lo = dev.channel_intnames[0]
                hi = dev.channel_intnames[-1]
                out.write(f'  {n} ({lo} - {hi}): "{dev.device_name}"\n')
            out.write("\n")

    def _print_overflows(self, out):
        out.write("peak: ")
        for n, o in enumerate(self.engine.overflow):
            db = o.peak_db()   # one definition, shared with the engine
            out.write(f"{n}/{o.n_overflows}/"
                      + (f"{db:+.2f} " if math.isfinite(db) else "-Inf "))
        out.write("\n")

    # ------- command dispatch --------------------------------------------
    def _command(self, out, cmd: str, sleep_task: _SleepTask) -> bool:
        """Execute one command; returns False on quit."""
        ctrl = self.control
        eng = self.engine
        cmd = cmd.strip()
        if cmd == "lf":
            self._cmd_lf(out)
        elif cmd == "lc":
            self._cmd_lc(out)
        elif cmd == "li":
            self._cmd_lio(out, IN)
        elif cmd == "lo":
            self._cmd_lio(out, OUT)
        elif cmd == "lm":
            self._cmd_lm(out)
        elif cmd.startswith("cffa"):
            a, rest = self._split2(cmd[4:].strip())
            b, val = self._split2(rest)
            rid = self._get_id(out, a, FILTER_ID)
            if rid is not None:
                pos = self._get_id(out, b, FILTER_ID, rid)
                if pos is not None:
                    self._set_scale(out, ctrl.fctrl[rid].fscales, pos, val,
                                    "input")
        elif cmd.startswith("cfia"):
            a, rest = self._split2(cmd[4:].strip())
            b, val = self._split2(rest)
            rid = self._get_id(out, a, FILTER_ID)
            if rid is not None:
                pos = self._get_id(out, b, INPUT_ID, rid)
                if pos is not None:
                    self._set_scale(out, ctrl.fctrl[rid].in_scales, pos, val,
                                    "input")
        elif cmd.startswith("cfoa"):
            a, rest = self._split2(cmd[4:].strip())
            b, val = self._split2(rest)
            rid = self._get_id(out, a, FILTER_ID)
            if rid is not None:
                pos = self._get_id(out, b, OUTPUT_ID, rid)
                if pos is not None:
                    self._set_scale(out, ctrl.fctrl[rid].out_scales, pos, val,
                                    "output")
        elif cmd.startswith("cfc"):
            a, b = self._split2(cmd[3:].strip())
            rid = self._get_id(out, a, FILTER_ID)
            if rid is not None and b:
                cid = self._get_id(out, b.strip(), COEFF_ID)
                if cid is not None:
                    ctrl.change_coeff(rid, cid)
        elif cmd.startswith("cfd"):
            a, b = self._split2(cmd[3:].strip())
            rid = self._get_id(out, a, FILTER_ID)
            if rid is not None:
                try:
                    n = int(b.split()[0])
                except (ValueError, IndexError):
                    out.write("Invalid filter delay.\n")
                    return True
                if n < 0 or n > self.conf.n_blocks - 1:
                    out.write("Invalid filter delay.\n")
                else:
                    ctrl.change_filter_delay(rid, n)
        elif cmd.startswith("cid") or cmd.startswith("cod"):
            io_ = IN if cmd.startswith("cid") else OUT
            a, rest = self._split2(cmd[3:].strip())
            ch = self._get_id(out, a, INPUT_ID if io_ == IN else OUTPUT_ID)
            if ch is not None:
                parts = rest.split()
                if not parts:
                    out.write("Invalid delay.\n")
                    return True
                try:
                    d = int(parts[0])
                except ValueError:
                    out.write("Invalid delay.\n")
                    return True
                if d < 0 or not ctrl.set_delay(io_, ch, d):
                    out.write(f'Invalid {"input" if io_ == IN else "output"} '
                              "delay.\n")
                # the subdelay applies independently of the delay's
                # validity, like the reference (bflogic_cli.c cid/cod:
                # both fields parse and apply on their own)
                if len(parts) > 1:
                    try:
                        sd = int(parts[1])
                    except ValueError:
                        sd = BF_SAMPLE_SLOTS
                    if not (-BF_SAMPLE_SLOTS < sd < BF_SAMPLE_SLOTS) or \
                            not ctrl.set_subdelay(io_, ch, sd):
                        out.write(
                            f'Invalid {"input" if io_ == IN else "output"} '
                            "subdelay.\n")
        elif cmd.startswith("tmi") or cmd.startswith("tmo"):
            io_ = IN if cmd.startswith("tmi") else OUT
            ch = self._get_id(out, cmd[3:].strip(),
                              INPUT_ID if io_ == IN else OUTPUT_ID)
            if ch is not None:
                ctrl.set_mute(io_, ch, not ctrl.mute[io_][ch])
        elif cmd.startswith("imc") or cmd.startswith("omc"):
            io_ = IN if cmd.startswith("imc") else OUT
            a, rest = self._split2(cmd[3:].strip())
            try:
                idx = int(a)
            except ValueError:
                out.write("Command failed: invalid module index\n")
                return True
            if not (0 <= idx < len(eng.devices[io_])):
                out.write("Command failed: module index out of range\n")
                return True
            out.write(eng.devices[io_][idx].command(rest))
        elif cmd.startswith("lmc"):
            a, rest = self._split2(cmd[3:].strip())
            idx = None
            try:
                idx = int(a)
            except ValueError:
                for n, (name, _) in enumerate(self.conf.logic_modules):
                    if a == name:
                        idx = n
                        break
            if idx is None or not (0 <= idx < len(eng.logic)):
                out.write("Command failed: unknown module\n")
                return True
            ok, msg = eng.logic[idx].command(rest)
            if not ok:
                out.write(f"Command failed: {msg}\n")
            else:
                out.write(msg)
        elif cmd == "ppk":
            self._print_overflows(out)
        elif cmd == "rpk":
            for o in eng.overflow:
                o.reset()
        elif cmd == "upk":
            self._toggle_peak_updates(out)
        elif cmd == "tp":
            self.print_prompt = not self.print_prompt
        elif cmd == "rti":
            out.write(f"Realtime index: {eng.realtime_index:.3f}\n")
        elif cmd == "quit":
            return False
        elif cmd.startswith("sleep"):
            rest = cmd[5:].strip()
            if rest.startswith("b"):
                try:
                    sleep_task.blocks = int(rest[1:])
                    sleep_task.block_sleep = True
                    sleep_task.do_sleep = True
                except ValueError:
                    pass
            else:
                parts = rest.split()
                try:
                    sleep_task.seconds = int(parts[0]) if parts else 0
                    sleep_task.useconds = (int(parts[1]) * 1000
                                           if len(parts) > 1 else 0)
                    sleep_task.do_sleep = True
                except ValueError:
                    pass
        elif cmd.startswith("abort"):
            eng.stop()
        elif cmd == "help":
            out.write(HELP_TEXT)
        elif cmd:
            out.write(f'Unknown command "{cmd}", type "help" for help.\n')
        return True

    def run_line(self, out, line: str, sleep_task: _SleepTask) -> bool:
        """Execute a ';'-separated command line atomically."""
        ok = True
        with self.control_lock():
            for part in line.split(";"):
                part = part.strip()
                if not part:
                    continue
                if self.echo and self.script is not None:
                    out.write(part + "\n")
                if not self._command(out, part, sleep_task):
                    ok = False
        return ok

    def control_lock(self):
        return self.engine.control_mutex

    # ------- hooks ---------------------------------------------------------
    def block_start(self, block_index: int):
        """Script pacing: one non-empty script line per block, wrapping."""
        if self._lines is None or self._quit:
            self._maybe_print_peaks()
            return
        if self._sleep_until_block >= 0:
            if block_index <= self._sleep_until_block:
                return
            self._sleep_until_block = -1
        if self._sleep_until_time is not None:
            if time.monotonic() < self._sleep_until_time:
                return
            self._sleep_until_time = None
        line = self._lines[self._line_idx]
        self._line_idx = (self._line_idx + 1) % len(self._lines)
        st = _SleepTask()
        import sys
        if not self.run_line(sys.stderr, line, st):
            self._quit = True
        if st.do_sleep:
            if st.block_sleep:
                self._sleep_until_block = block_index + st.blocks
            else:
                self._sleep_until_time = (time.monotonic() + st.seconds
                                          + st.useconds / 1e6)
        self._maybe_print_peaks()

    def peak(self):
        """bfevents.peak analog: pushed by the engine on overflow change
        (check_overflows, bfrun.c:589-618); `upk` sessions print on push
        instead of waiting for the next block_start poll."""
        self._maybe_print_peaks()

    @property
    def print_peak_updates(self) -> bool:
        """True when any session (or script mode) has `upk` enabled."""
        with self._peak_lock:
            return bool(self._peak_sessions)

    def _toggle_peak_updates(self, out):
        """`upk` for the issuing session's stream; script/lmc -> stderr."""
        import sys
        with self._peak_lock:
            if out in self._session_locks:
                stream, lock = out, self._session_locks[out]
            else:
                stream, lock = sys.stderr, self._stderr_lock
            if stream in self._peak_sessions:
                del self._peak_sessions[stream]
            else:
                self._peak_sessions[stream] = lock

    def _register_session(self, stream) -> threading.Lock:
        lock = threading.Lock()
        with self._peak_lock:
            self._session_locks[stream] = lock
        return lock

    def _unregister_session(self, stream):
        with self._peak_lock:
            self._session_locks.pop(stream, None)
            self._peak_sessions.pop(stream, None)

    def _maybe_print_peaks(self):
        # callable from both the engine's peak-push thread and the
        # block_start poll: the overflow check-then-set must be atomic
        # or a change can print twice (both callers pass the compare)
        # or be swallowed (one assignment lands between the other's
        # compare and assignment)
        with self._peak_lock:
            targets = list(self._peak_sessions.items())
            if not targets:
                return
            cur = tuple(o.n_overflows for o in self.engine.overflow)
            changed = cur != self._last_overflows
            self._last_overflows = cur
        if changed:
            for stream, lock in targets:
                try:
                    with lock:
                        self._print_overflows(stream)
                        stream.flush()
                except (OSError, ValueError):
                    pass   # session closed mid-push

    def command(self, params: str):
        """lmc entry: execute a command string, return (ok, message)."""
        buf = io.StringIO()
        st = _SleepTask()
        self.run_line(buf, params, st)
        return True, buf.getvalue()

    # ------- socket / serial server ----------------------------------------
    def _start_server(self):
        if isinstance(self.port, int):
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(("127.0.0.1", self.port))
        else:
            path = os.path.expanduser(self.port)
            if _is_tty(path):
                # serial/character device (bflogic_cli.c's line_speed
                # path): one session over the raw tty, no accept loop
                th = threading.Thread(target=self._serial_loop,
                                      args=(path,), daemon=True)
                th.start()
                return
            if os.path.exists(path):
                os.unlink(path)
            srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            srv.bind(path)
        srv.listen(4)
        self._server = srv
        th = threading.Thread(target=self._accept_loop, daemon=True)
        th.start()

    def _serial_loop(self, path):
        """CLI over a serial/character device. The reference configures
        the line speed with cfsetispeed/cfsetospeed and raw mode
        (bflogic_cli.c); sessions persist across hangups — on EOF or
        'quit' the device is reopened for the next session."""
        while True:
            self._serial_session(path)
            time.sleep(0.5)        # hangup backoff; then a new session

    def _serial_session(self, path):
        import termios
        try:
            fd = os.open(path, os.O_RDWR | os.O_NOCTTY)
        except OSError:
            return
        try:
            attrs = termios.tcgetattr(fd)
            speed = getattr(termios, f"B{self.line_speed}",
                            termios.B9600) if self.line_speed else None
            # raw 8N1, no flow control; ICRNL so CR-terminated input from
            # a real serial terminal completes readline (the reference's
            # iflag = IGNPAR | ICRNL | ISTRIP, bflogic_cli.c:1277)
            attrs[0] = (termios.IGNPAR | termios.ICRNL
                        | termios.ISTRIP)        # iflag
            attrs[1] = 0                         # oflag
            attrs[2] = (termios.CS8 | termios.CREAD | termios.CLOCAL)
            attrs[3] = 0                         # lflag (raw, no echo)
            # blocking reads, one byte at a time (the reference's
            # c_cc[VMIN]=1, VTIME=0, bflogic_cli.c:1280-1281) -- an
            # inherited VMIN=0/VTIME=0 would turn every read into an
            # instant EOF and spin the reopen loop
            attrs[6][termios.VMIN] = 1
            attrs[6][termios.VTIME] = 0
            if speed is not None:
                attrs[4] = speed                 # ispeed
                attrs[5] = speed                 # ospeed
            termios.tcsetattr(fd, termios.TCSANOW, attrs)
        except termios.error:
            pass                                 # ptys reject some attrs
        # errors="replace": line noise / baud mismatch must not raise a
        # UnicodeDecodeError through the session thread
        f = io.TextIOWrapper(
            open(fd, "r+b", buffering=0), encoding="utf-8",
            errors="replace", newline="\n", write_through=True)
        wlock = self._register_session(f)
        try:
            while True:
                with wlock:
                    if self.print_prompt:
                        f.write("> ")
                        f.flush()
                line = f.readline()
                if not line:
                    return
                st = _SleepTask()
                with wlock:
                    cont = self.run_line(f, line.strip(), st)
                if st.do_sleep and not st.block_sleep:
                    time.sleep(st.seconds + st.useconds / 1e6)
                with wlock:
                    f.flush()
                if not cont:
                    return
        except OSError:
            return
        finally:
            # session close drops only THIS session's push target / upk
            # state, like the reference (bflogic_cli.c:1081)
            self._unregister_session(f)
            try:
                f.close()
            except OSError:
                pass

    def _accept_loop(self):
        while True:
            try:
                client, _ = self._server.accept()
            except OSError:
                return
            threading.Thread(target=self._client_loop, args=(client,),
                             daemon=True).start()

    def _client_loop(self, client: socket.socket):
        # errors="replace": arbitrary client bytes (8-bit telnet) answer
        # "Unknown command", they do not kill the session thread
        f = client.makefile("rw", newline="\n", encoding="utf-8",
                            errors="replace")
        wlock = self._register_session(f)
        try:
            while True:
                with wlock:
                    if self.print_prompt:
                        f.write("> ")
                        f.flush()
                line = f.readline()
                if not line:
                    return
                st = _SleepTask()
                with wlock:
                    cont = self.run_line(f, line.strip(), st)
                if st.do_sleep and not st.block_sleep:
                    time.sleep(st.seconds + st.useconds / 1e6)
                with wlock:
                    f.flush()
                if not cont:
                    return
        except (BrokenPipeError, ConnectionResetError):
            return
        finally:
            self._unregister_session(f)
            try:
                f.close()
                client.close()
            except OSError:
                pass

    def close(self):
        if self._server is not None:
            self._server.close()


register_logic_module("cli", CliModule)
