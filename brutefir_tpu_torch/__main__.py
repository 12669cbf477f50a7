"""Command-line entry point, twin of :mod:`brutefir_tpu.__main__`.

Usage: python -m brutefir_tpu_torch [-quiet] [-nodefault] [-daemon] [config file]

Same flags and exit codes as the JAX package. Without -nodefault the
two-level config applies: ``~/.brutefir_defaults`` (auto-created on first
run) is parsed first, then the main config. A config of file devices on
storage runs through ``Engine.run_offline`` (which falls back to the
per-block ``Engine.run`` for logic modules such as a CLI script); file
devices on live endpoints (pipes, FIFOs, ttys) run through
``Engine.run``, and so do ``benchmark: true;`` and ``debug: true;``
configs (the per-10-periods stage table, bfrun.c:2035-2078, and the event
timeline live there) and configs with a clocked device (alsa, oss, jack,
pulse, or an external module with ``uses_sample_clock``): they keep the
per-block pipeline and its fixed latency of 2N samples. A device's abort
exits with the reference's code, e.g. an ALSA buffer underflow with
``BF_EXIT_BUFFER_UNDERFLOW``.
"""

from __future__ import annotations

import os
import sys

from .config.defaults import ensure_defaults_file
from .config.parser import parse_config_file, ConfigParseError
from .errors import (BFError, BF_EXIT_OK, BF_EXIT_OTHER,
                     BF_EXIT_INVALID_CONFIG)
from .runtime.engine import Engine

USAGE = ("Usage: %s [-quiet] [-nodefault] [-daemon] [config file]\n")


def main(argv=None, device=None) -> int:
    """Run a config; returns the process exit code. ``device`` is the
    torch device to run on (None means ``cuda``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    quiet = nodefault = daemon = False
    config_file = None
    for a in argv:
        if a == "-quiet":
            quiet = True
        elif a == "-nodefault":
            nodefault = True
        elif a == "-daemon":
            daemon = True
        elif a.startswith("-"):
            sys.stderr.write(USAGE % "brutefir_tpu_torch")
            return BF_EXIT_INVALID_CONFIG
        elif config_file is None:
            config_file = a
        else:
            sys.stderr.write(USAGE % "brutefir_tpu_torch")
            return BF_EXIT_INVALID_CONFIG

    try:
        defaults_path = None
        if not nodefault:
            defaults_path = ensure_defaults_file()
        if config_file is None:
            if nodefault:
                sys.stderr.write("No configuration file given.\n")
                return BF_EXIT_INVALID_CONFIG
            with open(defaults_path) as fh:
                dtext = fh.read()
            probe = parse_config_probe(dtext)
            config_file = probe or os.path.expanduser("~/.brutefir_config")
        conf = parse_config_file(config_file, defaults_path)
        conf.quiet = quiet
    except ConfigParseError as e:
        sys.stderr.write(f"{e}\n")
        return BF_EXIT_INVALID_CONFIG
    except OSError as e:
        sys.stderr.write(f"{e}\n")
        return BF_EXIT_OTHER

    import signal

    def _exit_code(e) -> int:
        return getattr(e, "exit_code", BF_EXIT_OTHER)

    # daemonize BEFORE the engine exists (a CUDA context does not survive
    # fork); the parent exits with the code the child reports after its
    # initialization, through a readiness pipe
    daemon_w = None
    if daemon:
        r, w = os.pipe()
        if os.fork() != 0:
            os.close(w)
            status = os.read(r, 1)
            os.close(r)
            return status[0] if status else BF_EXIT_OTHER
        os.close(r)
        daemon_w = w
        try:
            os.setsid()
        except OSError:
            pass   # already a session leader

    def _report_ready(code: int):
        nonlocal daemon_w
        if daemon_w is not None:
            try:
                os.write(daemon_w, bytes([code & 0xFF]))
                os.close(daemon_w)
            except OSError:
                pass
            daemon_w = None

    try:
        eng = Engine(conf, device=device)
    except RuntimeError as e:   # BFError, NotImplementedError, no CUDA
        sys.stderr.write(f"{e}\n")
        _report_ready(_exit_code(e))
        return _exit_code(e)
    _report_ready(BF_EXIT_OK)

    # batching adds batch_blocks * N of latency and bursty writes, which a
    # peer on a live endpoint or a sound card would see: those run block
    # by block at the fixed 2N latency, and so do benchmark and debug
    # runs (their stage table and timeline live in run())
    batch_safe = (all(not inst.uses_sample_clock and inst.batch_safe
                      for io in (0, 1) for inst in eng.devices[io])
                  and not conf.benchmark and not conf.debug)

    def _stop(signum, frame):
        eng.stop()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    try:
        if batch_safe:
            # BRUTEFIR_TPU_BATCH: blocks a batched dispatch (the JAX
            # __main__.py:144-150; default 8)
            try:
                batch = int(os.environ.get("BRUTEFIR_TPU_BATCH", "8"))
            except ValueError:
                sys.stderr.write(
                    "BRUTEFIR_TPU_BATCH must be an integer; using 8\n")
                batch = 8
            stats = eng.run_offline(batch_blocks=batch)
        else:
            stats = eng.run()
    except BFError as e:
        # a typed abort keeps its code: BF_EXIT_BUFFER_UNDERFLOW for an
        # xrun without ignore_xrun, BF_EXIT_INVALID_INPUT for a NaN or an
        # invalid signal (bfmod.h:64-70)
        sys.stderr.write(f"{e}\n")
        return _exit_code(e)
    if not quiet:
        sys.stderr.write(
            f"Finished: {stats['blocks']} blocks, {stats['frames']} frames, "
            f"{stats['xrt']:.1f}x realtime.\n")
    return BF_EXIT_OK


def parse_config_probe(defaults_text: str):
    """Extract the config_file setting from the defaults file, if present."""
    from .config.lexer import tokenize, T
    toks = list(tokenize(defaults_text))
    for i, t in enumerate(toks):
        if t.kind == T.FIELD and t.value == "config_file":
            if i + 1 < len(toks) and toks[i + 1].kind == T.STRING:
                return os.path.expanduser(toks[i + 1].value)
    return None


if __name__ == "__main__":
    sys.exit(main())
