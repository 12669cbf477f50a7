"""Logic modules (runtime control): the CLI command interface and the
dynamic EQ.

Twin of :mod:`brutefir_tpu.control`, which mirrors the reference's
dlopen'd .bflogic plugins (bfmod.h:282-320); modules here receive the
Engine (the bfaccess equivalent) directly. ``cli.py`` and ``eq.py`` are
verbatim copies of the JAX package's (they are framework-free). External
``bflogic_<name>.py`` modules are not ported yet (ROADMAP queue 1 item
4b).
"""

_REGISTRY = {}
_BUILTIN = ("cli", "eq")


def register_logic_module(name, factory):
    _REGISTRY[name] = factory


def check_logic_module(name: str) -> None:
    """Raise NotImplementedError for a logic module the port lacks."""
    if name not in _BUILTIN:
        raise NotImplementedError(
            f'logic module "{name}" is not ported yet (ROADMAP queue 1 '
            f'item 4b); the port has "cli" and "eq"')


def load_logic_module(name, params, engine):
    check_logic_module(name)
    if name not in _REGISTRY:
        if name == "cli":
            from . import cli  # noqa: F401
        else:
            from . import eq  # noqa: F401
    return _REGISTRY[name](params, engine)
