"""Import-path compatibility with the reference package, for the port
(port of evcouplings_tpu/compat.py).

Importing this module (or calling :func:`install_alias`) installs a
``sys.meta_path`` finder that resolves ``evcouplings`` and every
``evcouplings.*`` submodule to the matching ``evcouplings_torch``
module, so code written against debbiemarkslab/EVcouplings runs
unmodified on the port::

    import evcouplings_torch.compat  # noqa: F401  (installs the alias)

    from evcouplings.couplings import CouplingsModel   # -> the port
    from evcouplings.align import Alignment

The alias is an explicit opt-in: nothing is registered by merely
importing the package, so an environment that carries the real
reference package is never shadowed by accident.

One process never mixes two packages under the name: installing the
alias refuses (ImportError) when ``evcouplings`` already resolves to
something else, whether a package imported under that name (the real
reference, or the JAX package through its own alias) or another alias
finder on ``sys.meta_path`` that would resolve it. Unlike the JAX
package's alias, this one binds ``evcouplings`` to ``evcouplings_torch``
at once, so an alias installed later sees the name taken and refuses
in turn.

Module identity: ``evcouplings.x.y is evcouplings_torch.x.y`` — the
finder registers the same module object under both names, it does not
re-execute module code.
"""

import importlib
import importlib.abc
import importlib.machinery
import importlib.util
import sys

_ALIAS = "evcouplings"
_REAL = "evcouplings_torch"

# the interpreter's own finders: a real package they would find is only
# shadowed once imported, which the sys.modules check catches
_STANDARD_FINDERS = (importlib.machinery.PathFinder,
                     importlib.machinery.BuiltinImporter,
                     importlib.machinery.FrozenImporter)


class _AliasLoader(importlib.abc.Loader):
    """Loader that resolves an alias name to the real module object
    via the sys.modules self-replacement idiom (the import machinery
    re-reads sys.modules[spec.name] after exec_module, so the REAL
    module's __name__/__spec__ are never touched)."""

    def __init__(self, real_name):
        self.real_name = real_name

    def create_module(self, spec):
        return None     # default module object; replaced in exec

    def exec_module(self, module):
        real = importlib.import_module(self.real_name)
        sys.modules[module.__spec__.name] = real


class EvcouplingsAliasFinder(importlib.abc.MetaPathFinder):
    """Meta-path finder mapping evcouplings[.sub] -> evcouplings_torch[.sub]."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname != _ALIAS and not fullname.startswith(_ALIAS + "."):
            return None
        real = _REAL + fullname[len(_ALIAS):]
        try:
            real_spec = importlib.util.find_spec(real)
        except (ImportError, ValueError):
            return None
        if real_spec is None:
            return None
        spec = importlib.machinery.ModuleSpec(
            fullname, _AliasLoader(real),
            is_package=real_spec.submodule_search_locations is not None,
        )
        if real_spec.submodule_search_locations is not None:
            spec.submodule_search_locations = list(
                real_spec.submodule_search_locations
            )
        return spec


def _foreign_resolution():
    """What ``evcouplings`` resolves to other than this port, or None."""
    existing = sys.modules.get(_ALIAS)
    if existing is not None:
        if existing is sys.modules.get(_REAL):
            return None
        return "a different 'evcouplings' package is already imported " \
               "({!r})".format(getattr(existing, "__file__", None))
    for finder in sys.meta_path:
        if isinstance(finder, (EvcouplingsAliasFinder,) + _STANDARD_FINDERS):
            continue
        if finder.find_spec(_ALIAS, None) is not None:
            return "another finder on sys.meta_path resolves " \
                   "'evcouplings' ({!r})".format(finder)
    return None


def install_alias():
    """Install the evcouplings -> evcouplings_torch import alias.

    Idempotent. Refuses (ImportError) when ``evcouplings`` already
    resolves to another package (see the module docstring) rather than
    silently shadowing it.
    """
    foreign = _foreign_resolution()
    if foreign is not None:
        raise ImportError("{}; refusing to shadow it".format(foreign))
    if not any(
        isinstance(f, EvcouplingsAliasFinder) for f in sys.meta_path
    ):
        sys.meta_path.insert(0, EvcouplingsAliasFinder())
    sys.modules[_ALIAS] = importlib.import_module(_REAL)


def uninstall_alias():
    """Remove the finder and purge alias entries from sys.modules
    (the real evcouplings_torch modules stay imported)."""
    sys.meta_path[:] = [
        f for f in sys.meta_path
        if not isinstance(f, EvcouplingsAliasFinder)
    ]
    for name in list(sys.modules):
        if name == _ALIAS or name.startswith(_ALIAS + "."):
            mod = sys.modules[name]
            if mod is sys.modules.get(
                _REAL + name[len(_ALIAS):]
            ):
                del sys.modules[name]


install_alias()
