"""
Tracing / profiling hooks (port of evcouplings_tpu/utils/tracing.py).

- `stage_timer` — wall-clock spans for pipeline stages (or any scope),
  collected into a process-global registry and dumped as a
  `<prefix>_runtime.csv` table by the pipeline runtime.
- `device_trace` — a `torch.profiler` trace scope (Chrome trace JSON,
  CPU and, where there is one, CUDA activity) gated by the
  EVCOUPLINGS_TRACE_DIR environment variable or an explicit directory,
  so runs pay nothing unless tracing is requested. The pipeline runtime
  wraps each stage in one (the JAX package's runtime does not).
- `annotate` — a named `torch.profiler.record_function` region so
  individual steps are attributable inside a trace.
"""

import contextlib
import os
import time

import pandas as pd

TRACE_DIR_ENV = "EVCOUPLINGS_TRACE_DIR"

# process-global span registry: list of (scope, start_unix, seconds)
_SPANS = []


def clear_spans():
    """Reset the collected timing spans (used between pipeline jobs)."""
    del _SPANS[:]


def get_spans():
    """Collected spans as a DataFrame with scope/start/seconds columns."""
    return pd.DataFrame(_SPANS, columns=["scope", "start", "seconds"])


def write_span_table(filename):
    """Persist collected spans as CSV; returns the path (or None if no
    spans were collected)."""
    if not _SPANS:
        return None
    get_spans().to_csv(filename, index=False)
    return filename


@contextlib.contextmanager
def stage_timer(scope):
    """Record the wall-clock duration of a scope into the span
    registry (and yield the running span dict for inspection)."""
    span = {"scope": scope, "start": time.time()}
    t0 = time.perf_counter()
    try:
        yield span
    finally:
        span["seconds"] = time.perf_counter() - t0
        _SPANS.append((scope, span["start"], span["seconds"]))


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

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "{}_{}_{}.json".format(
        name, os.getpid(), time.time_ns())))


def annotate(name):
    """Named profiler region for attributing work inside a trace; cheap
    enough to leave on always."""
    import torch

    return torch.profiler.record_function(name)
