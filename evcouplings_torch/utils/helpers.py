"""
Small generic helpers (port of evcouplings_tpu/utils/helpers.py): a
persistent dict (the batch submitters' job database), an ordered default
dict, fixed-width sequence wrapping, range overlaps, runs of consecutive
positions, jinja2 template rendering (the fold stage's CNS scripts), a
text progress bar and retry logic (the sql and mongodb trackers).
"""

import csv
import json
import os
import stat as _stat
import tempfile
import pickle
import reprlib as _reprlib
import time
from collections import OrderedDict


def _proc_umask():
    """The process umask from /proc/self/status (Linux) — a read-only,
    race-free lookup — or None where unavailable."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("Umask:"):
                    return int(line.split()[1], 8)
    except (OSError, ValueError, IndexError):
        pass
    return None


def _read_umask():
    """The process umask, read WITHOUT the set-and-restore dance where
    possible: os.umask(0) is process-global, so flipping it per call
    races against concurrent threads (another thread's file lands with
    no umask, or reads 0 back as the "real" umask and restores that).
    /proc/self/status exposes it read-only on Linux; elsewhere fall
    back to one flip at import time, before worker threads exist."""
    mask = _proc_umask()
    if mask is not None:
        return mask
    umask = os.umask(0)
    os.umask(umask)
    return umask


# non-Linux fallback only: taken once at import, before worker threads
# exist (the set-and-restore dance is not thread-safe). On Linux the
# current umask is re-read from /proc on every sync, so a later
# os.umask() change (e.g. daemonization with umask 0o077) is honored.
_UMASK = _read_umask()


def _current_umask():
    mask = _proc_umask()
    return mask if mask is not None else _UMASK


class PersistentDict(dict):
    """Persistent dictionary with an API compatible with shelve and anydbm.

    Data is kept in memory and written to disk on sync/close, in json
    (default), csv, or pickle format.
    """

    def __init__(self, filename, flag="c", mode=None, format="json",
                 *args, **kwds):
        self.flag = flag            # r=readonly, c=create, or n=new
        self.mode = mode            # None or an octal triple like 0644
        self.format = format       # 'csv', 'json', or 'pickle'
        self.filename = filename
        if flag == "n" and os.path.exists(filename):
            # "n" = always a NEW empty db: drop stale on-disk contents
            # now (empty dicts deliberately never sync — see sync() —
            # so the old file would be resurrected by the next open)
            try:
                os.remove(filename)
            except OSError:
                pass
        if flag != "n" and os.access(filename, os.R_OK):
            with open(filename,
                      "rb" if format == "pickle" else "r") as fileobj:
                self.load(fileobj)
        dict.__init__(self, *args, **kwds)

    def sync(self):
        """Write dict to disk"""
        if self.flag == "r":
            return
        # don't sync if empty (reference helpers.py:52-54 — callers
        # test emptiness by the file's absence/zero size)
        if not len(self):
            return
        # Unique temp name per writer: several submitters/threads/
        # processes may persist to the same db path concurrently (the
        # reference's TestUtilsBatch reuses one db across tests while
        # threads from a prior submitter are still draining). A shared
        # "<file>.tmp" lets one writer's os.replace steal another's
        # temp file (FileNotFoundError); mkstemp + atomic replace makes
        # concurrent syncs safe with last-writer-wins semantics.
        dirname = os.path.dirname(os.path.abspath(self.filename))
        fd, tempname = tempfile.mkstemp(
            prefix=os.path.basename(self.filename) + ".tmp",
            dir=dirname)
        # permissions are fixed on the TEMP fd, BEFORE the atomic
        # replace publishes it: a post-replace chmod left a window in
        # which concurrent readers of a shared job db saw mkstemp's
        # 0600. An existing db keeps its (possibly operator-tightened)
        # mode — like a plain open() rewrite would — and a fresh db
        # gets the umask default (re-read per sync on Linux).
        if self.mode is not None:
            target_mode = self.mode
        else:
            try:
                target_mode = _stat.S_IMODE(
                    os.stat(self.filename).st_mode
                )
            except OSError:
                target_mode = 0o666 & ~_current_umask()
        os.fchmod(fd, target_mode)
        fileobj = os.fdopen(
            fd, "wb" if self.format == "pickle" else "w")
        try:
            self.dump(fileobj)
        except Exception:
            fileobj.close()
            os.remove(tempname)
            raise
        fileobj.close()
        os.replace(tempname, self.filename)

    def close(self):
        self.sync()

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()

    def dump(self, fileobj):
        # empty dicts write nothing (reference helpers.py:80-82)
        if not self:
            return

        if self.format == "csv":
            csv.writer(fileobj).writerows(self.items())
        elif self.format == "json":
            # TEXT write — callers pass text-mode file objects
            # (reference helpers.py:87)
            json.dump(self, fileobj, separators=(",", ":"))
        elif self.format == "pickle":
            pickle.dump(dict(self), fileobj, 2)
        else:
            raise NotImplementedError("Unknown format: " + repr(self.format))

    def load(self, fileobj):
        # try formats from most restrictive to least restrictive
        for loader in (pickle.load, self._load_json, csv.reader):
            try:
                fileobj.seek(0)
                return self.update(loader(fileobj))
            except Exception:
                pass
        raise ValueError("File not in a supported format")

    @staticmethod
    def _load_json(fileobj):
        data = fileobj.read()
        if isinstance(data, bytes):
            data = data.decode()
        return json.loads(data)


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


class Progressbar:
    """Minimal text progress bar (stderr), API-compatible subset of
    the reference helper."""

    def __init__(self, total_size, bar_length=60):
        self.total_size = total_size
        self.bar_length = bar_length
        self.progress = 0

    def __iadd__(self, chunk):
        self.update(chunk)
        return self

    def update(self, chunk):
        import sys

        self.progress += chunk
        done = int(
            self.bar_length * min(self.progress, self.total_size)
            / max(self.total_size, 1)
        )
        sys.stderr.write(
            "\r[{}{}] {:.1%}".format(
                "=" * done, " " * (self.bar_length - done),
                min(self.progress / max(self.total_size, 1), 1.0)
            )
        )
        sys.stderr.flush()


def retry(func, retry_max_number=None, retry_wait=None,
          exceptions=None, retry_action=None, fail_action=None):
    """Retry a function call with an optional wait between attempts.

    Parameters
    ----------
    func : callable
        Zero-argument function to execute
    retry_max_number : int, optional
        Number of RETRIES after the initial attempt (reference
        helpers.py:279-324 counting: total attempts =
        retry_max_number + 1, so 0 means exactly one attempt).
        DELIBERATE DEVIATION from the reference: there None retries
        FOREVER; here None means a single attempt. An unreachable
        tracker DB must fail a job loudly rather than hang it (and
        its CI) indefinitely — callers that genuinely want unbounded
        retry can pass a large number explicitly.
    retry_wait : float, optional
        Seconds to sleep between attempts
    exceptions : tuple(Exception), optional
        Retry only on these exception types (default: Exception)
    retry_action : callable, optional
        Zero-argument function run after each failed attempt
    fail_action : callable, optional
        Zero-argument function run once upon final failure, before the
        exception is re-raised (reference helpers.py:279-321)
    """
    if exceptions is None:
        exceptions = (Exception,)

    if retry_max_number is not None and retry_max_number < 0:
        raise ValueError(
            "retry_max_number must be >= 0 (got {})".format(
                retry_max_number
            )
        )
    attempts = 1 if retry_max_number is None else retry_max_number + 1

    last_exc = None
    for attempt in range(attempts):
        try:
            return func()
        except exceptions as e:
            last_exc = e
            if retry_action is not None:
                retry_action()
            if retry_wait is not None and attempt < attempts - 1:
                time.sleep(retry_wait)

    if fail_action is not None:
        fail_action()
    raise last_exc
