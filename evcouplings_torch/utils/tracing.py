"""
Tracing / profiling hooks (port of evcouplings_tpu/utils/tracing.py).

- `span` — a named span of the program, recorded into a process-global
  registry and mirrored into the device trace as a
  `torch.profiler.record_function` range of the same name, only while a
  torch profiler is active: otherwise a span costs one flag check and
  builds and records nothing. Each record holds the span's name, its id,
  its parent's and its root's id, its start and end on `time.time_ns()`
  (the clock of the profiler's events), whether it closed on an
  exception, and its counts (`add_counts`). `span_records()` reads them.
- `stage_timer` — a span that always records: the pipeline stages (or
  any scope), dumped as a `<prefix>_runtime.csv` table by the pipeline
  runtime (`get_spans`, `write_span_table`).
- `device_trace` — a `torch.profiler` trace scope (Chrome trace JSON,
  CPU and, where there is one, CUDA activity) gated by the
  EVCOUPLINGS_TRACE_DIR environment variable or an explicit directory,
  so runs pay nothing unless tracing is requested. The pipeline runtime
  wraps each stage in one (the JAX package's runtime does not); the
  spans inside it are on while it traces.
"""

import contextlib
import itertools
import os
import threading
import time

import pandas as pd
import torch

TRACE_DIR_ENV = "EVCOUPLINGS_TRACE_DIR"

# whether a torch profiler is active (also under the low-level
# _enable_profiler, which torch.autograd.profiler._is_profiler_enabled
# does not see)
_profiler_enabled = torch._C._autograd._profiler_enabled

# process-global span registry: one record per closed span, in the order
# they closed; stage_timer's records carry "table": True
_SPANS = []
_IDS = itertools.count(1)
_OPEN = threading.local()        # .stack: this thread's open records
_OFF = contextlib.nullcontext()


def _stack():
    try:
        return _OPEN.stack
    except AttributeError:
        _OPEN.stack = []
        return _OPEN.stack


class _Span:
    """Context manager behind span and stage_timer: opens a record (and,
    while a profiler is active, a record_function range of its name) on
    enter, closes and registers it on exit."""

    __slots__ = ("record", "_range")

    def __init__(self, name, counts, table=False):
        self.record = {"name": name, "counts": counts}
        if table:
            self.record["table"] = True
        self._range = None

    def __enter__(self):
        stack = _stack()
        rec = self.record
        rec["id"] = next(_IDS)
        parent = stack[-1] if stack else None
        rec["parent"] = parent["id"] if parent else None
        rec["root"] = parent["root"] if parent else rec["id"]
        if _profiler_enabled():
            self._range = torch.autograd.profiler.record_function(rec["name"])
            self._range.__enter__()
        stack.append(rec)
        rec["start_ns"] = time.time_ns()
        return rec

    def __exit__(self, exc_type, exc, tb):
        rec = self.record
        rec["end_ns"] = time.time_ns()
        rec["error"] = exc_type is not None
        _stack().pop()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        _SPANS.append(rec)
        return False


def span(name, **counts):
    """A span named `name` with initial counts, recorded only while a
    torch profiler is active; a no-op context otherwise."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, counts)


def add_counts(**counts):
    """Add to the counts of this thread's innermost open span (nothing
    while no profiler is active)."""
    if not _profiler_enabled():
        return
    stack = _stack()
    if stack:
        own = stack[-1]["counts"]
        for key, value in counts.items():
            own[key] = own.get(key, 0) + value


def span_records():
    """The closed spans' records (stage_timer's included), oldest first
    by closing time: dicts of name, id, parent, root, start_ns, end_ns,
    error, counts."""
    return list(_SPANS)


def clear_spans():
    """Reset the collected spans (used between pipeline jobs)."""
    del _SPANS[:]


def get_spans():
    """stage_timer's spans as a DataFrame with scope/start/seconds
    columns (start in unix seconds)."""
    return pd.DataFrame(
        [(r["name"], r["start_ns"] / 1e9, (r["end_ns"] - r["start_ns"]) / 1e9)
         for r in _SPANS if r.get("table")],
        columns=["scope", "start", "seconds"])


def write_span_table(filename):
    """Persist stage_timer's spans as CSV; returns the path (or None if
    no spans were collected)."""
    spans = get_spans()
    if spans.empty:
        return None
    spans.to_csv(filename, index=False)
    return filename


@contextlib.contextmanager
def stage_timer(scope):
    """Record the wall-clock duration of a scope into the span registry,
    whether or not a profiler is active (and yield the running span dict
    for inspection: scope and start, then seconds once it closes)."""
    running = {"scope": scope}
    timer = _Span(scope, {}, table=True)
    try:
        with timer as rec:
            running["start"] = rec["start_ns"] / 1e9
            yield running
    finally:
        rec = timer.record
        running["seconds"] = (rec["end_ns"] - rec["start_ns"]) / 1e9


@contextlib.contextmanager
def device_trace(trace_dir=None, name="trace"):
    """torch.profiler trace scope, written as a Chrome trace
    (`<name>_<pid>_<unix ns>.json`) into the trace directory.

    If trace_dir is None, the EVCOUPLINGS_TRACE_DIR environment
    variable selects the output directory; when neither is set this is
    a no-op, so callers can wrap hot sections unconditionally (the
    pipeline wraps each stage).
    """
    trace_dir = trace_dir or os.environ.get(TRACE_DIR_ENV)
    if not trace_dir:
        yield
        return

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "{}_{}_{}.json".format(
        name, os.getpid(), time.time_ns())))
