"""The measured window of a run, as every runner keeps it.

Opened after set-up: the allocator's peak so far is kept and reset, the
traced run's profiler starts, and the deadline is set (a traced run's
window is capped at the traffic's `trace_seconds`). A unit of work (a fit,
a cycle of families) counts when it ends before the deadline: `mark()` at
its end moves the window's end there. A unit still running at the deadline
is abandoned by `callback`, which the program calls after each iteration.
"""

import time

import torch

from bench_port.harness import check_no_jax
from bench_port.trace import DeviceTrace


class Deadline(Exception):
    """Raised from the program's iteration callback once time is up."""


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Window:

    def __init__(self, cell):
        self.device = cell.device
        self.cuda = self.device.type == "cuda"
        sync(self.device)
        check_no_jax("after set-up,")
        self.setup_peak = 0
        if self.cuda:
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.seconds = cell.seconds
        if cell.trace:
            self.seconds = min(cell.seconds, cell.traffic["trace_seconds"])
        self.tracer = DeviceTrace() if cell.trace else None
        if self.tracer:
            self.tracer.start()
        self.t0 = self.t_end = time.perf_counter()
        self.t0_ns = self.t_end_ns = time.time_ns()
        self.setup_s = self.t0 - cell.t_start
        self.deadline = self.t0 + self.seconds

    def callback(self, record):
        if time.perf_counter() > self.deadline:
            raise Deadline

    def open(self):
        """Whether the deadline is still ahead."""
        return time.perf_counter() <= self.deadline

    def mark(self):
        """A unit ended now: True if it counts (it ended in time), and then
        the window's end moves here."""
        now = time.perf_counter()
        if now > self.deadline:
            return False
        self.t_end, self.t_end_ns = now, time.time_ns()
        return True

    def close(self, counted, what):
        """End the window: (seconds, reduced trace or None, the allocator's
        peak over the window). Raises when no unit counted."""
        sync(self.device)
        trace = None
        if self.tracer:
            self.tracer.stop()
            trace = self.tracer.summary(self.t0_ns, self.t_end_ns)
            self.tracer = None
        if not counted:
            raise RuntimeError("no {} completed within {} s".format(
                what, self.seconds))
        peak = 0
        if self.cuda:
            peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.empty_cache()
        return self.t_end - self.t0, trace, peak
