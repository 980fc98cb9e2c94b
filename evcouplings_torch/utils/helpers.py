"""
Small generic helpers (the subset of evcouplings_tpu/utils/helpers.py
that the port uses): an ordered default dict, fixed-width sequence
wrapping, range overlaps, runs of consecutive positions and jinja2
template rendering (the fold stage's CNS scripts).
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


def range_overlap(a, b):
    """Length of the overlap of two closed-open ranges (start, end);
    degenerate ranges (start >= end) are rejected."""
    from evcouplings_torch.utils.config import InvalidParameterError

    if a[0] >= a[1]:
        raise InvalidParameterError(
            "Start has to be smaller than end a[0] < a[1]")
    if b[0] >= b[1]:
        raise InvalidParameterError(
            "Start has to be smaller than end b[0] < b[1]")
    return max(0, min(a[1], b[1]) - max(a[0], b[0]))


def find_segments(data):
    """Find consecutive index segments in an iterable of positions.

    Returns a list of (start, end) tuples (inclusive bounds) for each run
    of consecutive integers.
    """
    data = list(data)
    if not data:
        return []

    segments = []
    start = prev = data[0]
    for x in data[1:]:
        if x == prev + 1:
            prev = x
        else:
            segments.append((start, prev))
            start = prev = x
    segments.append((start, prev))
    return segments


def render_template(template_file, mapping):
    """Render a jinja2 template file with the given mapping (jinja2 is
    imported here: only the fold stage needs it)."""
    import jinja2

    with open(template_file) as f:
        template = jinja2.Template(f.read())
    return template.render(mapping)
