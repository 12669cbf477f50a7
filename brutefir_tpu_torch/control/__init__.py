"""Logic modules (runtime control): the CLI command interface.

Twin of :mod:`brutefir_tpu.control`, which mirrors the reference's
dlopen'd .bflogic plugins (bfmod.h:282-320); modules here receive the
Engine (the bfaccess equivalent) directly. ``cli.py`` is a verbatim copy
of the JAX package's (it is framework-free). The EQ module and external
``bflogic_<name>.py`` modules are not ported yet (ROADMAP queue 1 item 4).
"""

_REGISTRY = {}


def register_logic_module(name, factory):
    _REGISTRY[name] = factory


def check_logic_module(name: str) -> None:
    """Raise NotImplementedError for a logic module the port lacks."""
    if name != "cli":
        raise NotImplementedError(
            f'logic module "{name}" is not ported yet (ROADMAP queue 1 '
            f'item 4); the port has "cli"')


def load_logic_module(name, params, engine):
    check_logic_module(name)
    if name not in _REGISTRY:
        from . import cli  # noqa: F401
    return _REGISTRY[name](params, engine)
