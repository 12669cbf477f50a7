"""Logic modules (runtime control): the CLI command interface, the
dynamic EQ, and external ``bflogic_<name>.py`` modules.

Twin of :mod:`brutefir_tpu.control`, which mirrors the reference's
dlopen'd .bflogic plugins (bfmod.h:282-320); modules here receive the
Engine (the bfaccess equivalent) directly. ``cli.py`` and ``eq.py`` are
verbatim copies of the JAX package's (they are framework-free).

An external module is a file ``bflogic_<name>.py`` in a directory of the
config's ``modules_path``. It registers itself with
``from brutefir_tpu_torch.control import register_logic_module`` and
``register_logic_module(name, factory)``, where ``factory(params,
engine)`` returns the module instance; that import line is all that
differs from a module written for the JAX package. Its hooks (the
bfevents of bfmod.h:192-215) see numpy arrays only: see
``Engine.attach_logic``.
"""

_REGISTRY = {}


def register_logic_module(name, factory):
    _REGISTRY[name] = factory


def load_logic_module(name, params, engine, modules_path: str = ""):
    if name not in _REGISTRY:
        if name == "cli":
            from . import cli  # noqa: F401
        elif name == "eq":
            from . import eq  # noqa: F401
        else:
            _load_external(name, modules_path)
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise RuntimeError(f"unknown logic module: {name}") from None
    return factory(params, engine)


def _load_external(name: str, modules_path: str) -> None:
    """Search modules_path for bflogic_<name>.py -- the analog of the
    reference's dlopen'd .bflogic search (bfconf.c:2172-2198), mirroring
    the IO side's bfio_<name>.py mechanism. The module file must call
    register_logic_module(name, factory)."""
    import importlib.util
    import os
    for d in filter(None, (modules_path or "").split(":")):
        path = os.path.join(os.path.expanduser(d), f"bflogic_{name}.py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                f"bflogic_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            import sys
            sys.modules[spec.name] = mod  # importable/introspectable after
            spec.loader.exec_module(mod)
            return
