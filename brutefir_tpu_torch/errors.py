"""Typed runtime errors carrying the reference's exit-code contract.

The reference propagates ``BF_EXIT_*`` codes (bfmod.h:64-70) end-to-end
through ``bf_exit`` so supervisors can distinguish buffer underflows and
invalid-signal aborts from other failures. The rebuild's analog: every
abort-worthy exception is a ``BFError`` subclass carrying ``exit_code``;
``__main__`` maps it straight to the process exit status -- no message
sniffing.
"""

from __future__ import annotations

BF_EXIT_OK = 0
BF_EXIT_OTHER = 1
BF_EXIT_INVALID_CONFIG = 2
BF_EXIT_NO_MEMORY = 3
BF_EXIT_INVALID_INPUT = 4
BF_EXIT_BUFFER_UNDERFLOW = 5


class BFError(RuntimeError):
    """Base runtime error with a reference exit code (default OTHER)."""

    exit_code = BF_EXIT_OTHER

    def __init__(self, *args, exit_code: int | None = None):
        super().__init__(*args)
        if exit_code is not None:
            self.exit_code = exit_code
