"""
Small generic helpers (the subset of evcouplings_tpu/utils/helpers.py
that the port's pipeline uses): an ordered default dict and fixed-width
sequence wrapping.
"""

import reprlib as _reprlib
from collections import OrderedDict


class DefaultOrderedDict(OrderedDict):
    """OrderedDict with defaultdict semantics (picklable)."""

    def __init__(self, default_factory=None, **kwargs):
        OrderedDict.__init__(self, **kwargs)
        self.default_factory = default_factory

    def __missing__(self, key):
        if self.default_factory is None:
            raise KeyError(key)
        result = self[key] = self.default_factory()
        return result

    def copy(self):
        return self.__copy__()

    def __copy__(self):
        # OrderedDict.copy() would silently DROP default_factory,
        # leaving a copy that raises KeyError where the original
        # auto-creates
        new = type(self)(self.default_factory)
        new.update(self)
        return new

    @_reprlib.recursive_repr()
    def __repr__(self):
        # classic OrderedDict list-of-pairs form (Python 3.12 changed
        # OrderedDict.__repr__ to the dict-literal style)
        if not self:
            return "{}()".format(type(self).__name__)
        return "{}({!r})".format(
            type(self).__name__, list(self.items())
        )


def wrap(text, width=80):
    """Wrap a (whitespace-free) string into fixed-width lines.

    Unlike textwrap, does not attempt to break at word boundaries — the
    input is a biological sequence.
    """
    return "\n".join(
        text[i:i + width] for i in range(0, len(text), width)
    )
